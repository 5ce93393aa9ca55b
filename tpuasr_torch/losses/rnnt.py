"""RNN-Transducer loss (port of ``tpuasr/losses/rnnt.py``).

- The joint's log-probs reduce to two lattice inputs, blank_lp [B, T, U+1]
  and label_lp [B, T, U].
- Padding: for t >= t_len, blank_lp := 0 (a free blank) and label_lp := -1e30,
  so every path drifts to the last frame; labels past u_len get -1e30; the
  likelihood is read per row at (T-1, u_len). -1e30 stands in for -inf.
- The lattice is `tpuasr_torch.ops.rnnt_lattice` (kernels #8/#9 on the
  card, the plain anti-diagonal lattice on the CPU), whose backward is the
  closed-form occupancy gradient.
- Infeasible rows (e.g. t_len = 0) give loss 0 and gradient 0.

`rnnt_loss_from_logits` is the materialized route (the joint's full
[B, T, U+1, V] logits), as `tpuasr/ops/rnnt_pallas.py:221-250` runs it on
an accelerator: an fp32 log-softmax, the blank and label gather, the masking,
the lattice, and the infeasible-row guard here with the caller.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops.rnnt_lattice import _NEG, mask_lattice_inputs, rnnt_lattice


def zero_infeasible(ll: torch.Tensor) -> torch.Tensor:
    """-ll, or 0 with gradient 0 where the row has no alignment."""
    nll = -ll
    return torch.where(ll > _NEG / 2, nll, nll.detach() * 0.0)


def rnnt_loss(log_probs: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
              u_lens: torch.Tensor, blank: int) -> torch.Tensor:
    """Per-utterance negative log-likelihood [B]; log_probs [B, T, U+1, V]
    log-softmaxed, labels [B, U]."""
    u = log_probs.shape[2] - 1
    blank_lp = log_probs[..., blank]
    label_lp = log_probs[:, :, :u].gather(
        3, labels.long()[:, None, :, None].expand(-1, log_probs.shape[1], -1, 1))[..., 0]
    blank_m, label_m, _, _ = mask_lattice_inputs(blank_lp, label_lp, t_lens, u_lens)
    return zero_infeasible(rnnt_lattice(blank_m, label_m, u_lens))


def rnnt_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
                          u_lens: torch.Tensor, blank: int,
                          reduction: str = "mean") -> torch.Tensor:
    """Raw joint logits [B, T, U+1, V] in, reduced loss out (log-softmax in
    fp32). CPU tensors take the plain lattice, CUDA tensors kernels #8/#9."""
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rnnt_loss_from_logits: unsupported device {logits.device}")
    nll = rnnt_loss(torch.log_softmax(logits.float(), dim=-1), labels, t_lens, u_lens, blank)
    if reduction == "none":
        return nll
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    raise ValueError(reduction)
