"""CTC loss (port of ``tpuasr/losses/ctc.py``).

States are the 2U+1 blank-interleaved labels; the skip transition enters an
odd state whose label differs from the one two back. `ctc_loss` is the plain
reference, a loop over T in torch ops whose gradient comes from autograd.
`ctc_loss_from_logits` is the training head: log-softmax in fp32, then the
lattice through `tpuasr_torch.ops.ctc_lattice` (TPU kernels #6/#7 ported to
CUDA on the card, their plain versions on the CPU). Both keep the
`zero_infinity` contract: an infeasible row gives loss 0 and gradient 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuasr_torch.losses.rnnt import zero_infeasible
from tpuasr_torch.ops.ctc import _NEG, _logaddexp, ctc_lattice


def lattice_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, U] -> [B, 2U+1] blank-interleaved state labels."""
    b, u = labels.shape
    lab = torch.full((b, 2 * u + 1), blank, dtype=labels.dtype, device=labels.device)
    lab[:, 1::2] = labels
    return lab


def lattice_inputs(log_probs, labels, label_lens, blank: int):
    """-> (lp_states [B, T, S] with -1e30 past 2·label_len, can_skip [B, S],
    final [B, S]) for log-probs [B, T, V] and labels [B, U]."""
    b, t, _ = log_probs.shape
    s = 2 * labels.shape[1] + 1
    lab = lattice_labels(labels.long(), blank)
    state = torch.arange(s, device=log_probs.device)[None, :]
    ll2 = 2 * label_lens.long()[:, None]
    lp_states = log_probs.gather(2, lab[:, None, :].expand(b, t, s))
    lp_states = torch.where((state <= ll2)[:, None, :], lp_states,
                            torch.full((), _NEG, dtype=lp_states.dtype,
                                       device=lp_states.device))
    lab_m2 = F.pad(lab, (2, 0), value=blank)[:, :s]
    can_skip = (lab != blank) & (lab != lab_m2) & (state >= 2)
    final = (state == ll2) | ((state == ll2 - 1) & (ll2 > 0))
    return lp_states, can_skip, final


def ctc_loss(log_probs: torch.Tensor, input_lens: torch.Tensor, labels: torch.Tensor,
             label_lens: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-utterance negative log-likelihood [B]; log_probs [B, T, V]
    log-softmaxed. Plain torch ops, gradient by autograd."""
    b, t, _ = log_probs.shape
    lp_states, can_skip, _ = lattice_inputs(log_probs, labels, label_lens, blank)
    s = lp_states.shape[2]
    neg = torch.full((), _NEG, dtype=lp_states.dtype, device=lp_states.device)
    alpha = torch.full((b, s), _NEG, dtype=lp_states.dtype, device=lp_states.device)
    alpha = torch.cat([lp_states[:, 0, :1],
                       torch.where(label_lens[:, None] > 0, lp_states[:, 0, 1:2], neg),
                       alpha[:, 2:]], dim=1)
    for i in range(1, t):
        a1 = F.pad(alpha, (1, 0), value=_NEG)[:, :s]
        a2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=_NEG)[:, :s], neg)
        new = _logaddexp(_logaddexp(alpha, a1), a2) + lp_states[:, i]
        alpha = torch.where((i < input_lens)[:, None], new, alpha)
    ul = label_lens.long()[:, None]
    last_blank = alpha.gather(1, 2 * ul)[:, 0]
    last_label = torch.where(ul[:, 0] > 0, alpha.gather(1, (2 * ul - 1).clamp(min=0))[:, 0],
                             neg)
    return zero_infeasible(_logaddexp(last_blank, last_label))


def ctc_loss_from_logits(logits: torch.Tensor, input_lens: torch.Tensor,
                         labels: torch.Tensor, label_lens: torch.Tensor, blank: int = 0,
                         reduction: str = "sum_over_batch") -> torch.Tensor:
    """The CTC head's loss (model/rnnt_model.py:40-60): log_softmax in fp32,
    then the lattice kernels; reduction "sum_over_batch" is
    CTCLoss(reduction='sum') / batch."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_states, can_skip, final = lattice_inputs(lp, labels, label_lens, blank)
    ll = ctc_lattice(lp_states.contiguous(), can_skip.contiguous(),
                     input_lens.to(torch.int32).contiguous(), final.contiguous())
    nll = zero_infeasible(ll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum_over_batch":
        return nll.sum() / nll.shape[0]
    raise ValueError(reduction)
