"""RNN-Transducer loss: the (T, U+1) lattice in plain PyTorch (port of
``tpuasr/losses/rnnt.py``).

- The joint's log-probs reduce to two lattice inputs, blank_lp [B, T, U+1]
  and label_lp [B, T, U].
- Padding: for t >= t_len, blank_lp := 0 (a free blank) and label_lp := -1e30,
  so every path drifts to the last frame; labels past u_len get -1e30; the
  likelihood is read per row at (T-1, u_len). -1e30 stands in for -inf.
- `_RNNTLattice` is a `torch.autograd.Function` whose backward is the
  closed-form occupancy gradient (`rnnt_occupancies`, one beta sweep), not
  autodiff through the recurrence.
- Infeasible rows (e.g. t_len = 0) give loss 0 and gradient 0.

The JAX package runs this lattice outside any kernel, as `lax.scan` over T
with an associative scan over U inside each frame. Here the recurrence
``alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] +
label[t, u-1])`` runs over anti-diagonals n = t + u instead: every cell of a
diagonal depends only on the diagonal before, so one vectorised step per
diagonal (T + U steps of a few launches each) replaces the T frames times
log2(U+1) scan levels. The values are the same recurrence's; the summation
order inside a cell is the sequential one.

`rnnt_loss_from_logits` is the materialized route (the joint's full
[B, T, U+1, V] logits): plain on the CPU. On the card the JAX package runs it
through TPU kernels #8/#9 (`tpuasr/ops/rnnt_pallas.py`), which are not
ported yet, so it raises there; the fused route
(`tpuasr_torch.ops.rnnt_fused`) is the one the card trains with.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG = -1.0e30


def _skew(x: torch.Tensor, n_diag: int) -> torch.Tensor:
    """[B, T, U1] -> [B, n_diag, U1] with out[n, u] = x[n - u, u] where
    0 <= n - u < T, else -1e30."""
    b, t, u1 = x.shape
    n = torch.arange(n_diag, device=x.device)[:, None]
    u = torch.arange(u1, device=x.device)[None, :]
    src = n - u
    valid = (src >= 0) & (src < t)
    out = x.gather(1, src.clamp(0, t - 1).expand(b, n_diag, u1))
    return torch.where(valid, out, torch.full((), _NEG, dtype=x.dtype, device=x.device))


def _unskew(d: torch.Tensor, t: int) -> torch.Tensor:
    """[B, N, U1] diagonals -> [B, t, U1] with out[t, u] = d[t + u, u]."""
    b, _, u1 = d.shape
    idx = (torch.arange(t, device=d.device)[:, None]
           + torch.arange(u1, device=d.device)[None, :])
    return d.gather(1, idx.expand(b, t, u1))


def rnnt_alphas(blank_lp: torch.Tensor, label_lp: torch.Tensor) -> torch.Tensor:
    """alpha [B, T, U+1]: alpha[t, u] = log P(t frames consumed, u labels
    emitted), alpha[0, 0] = 0; blank_lp [B, T, U+1], label_lp [B, T, U]."""
    b, t, u1 = blank_lp.shape
    n_diag = t + u1 - 1
    y = F.pad(label_lp, (0, 1), value=_NEG)  # gain from (t, u) to (t, u+1)
    bk, ls = _skew(blank_lp, n_diag), _skew(y, n_diag)
    n = torch.arange(n_diag, device=blank_lp.device)[:, None]
    u = torch.arange(u1, device=blank_lp.device)[None, :]
    valid = ((n - u) >= 0) & ((n - u) < t)
    neg = torch.full((), _NEG, dtype=blank_lp.dtype, device=blank_lp.device)
    a = torch.where(u[0] == 0, torch.zeros_like(neg), neg).expand(b, u1)
    diags = [a]
    for k in range(1, n_diag):
        from_blank = a + bk[:, k - 1]
        from_label = F.pad((a + ls[:, k - 1])[:, :-1], (1, 0), value=_NEG)
        a = torch.where(valid[k], torch.logaddexp(from_blank, from_label).clamp_min(_NEG), neg)
        diags.append(a)
    return _unskew(torch.stack(diags, dim=1), t)


def rnnt_betas(blank_lp: torch.Tensor, label_lp: torch.Tensor,
               u_lens: torch.Tensor) -> torch.Tensor:
    """beta [B, T, U+1]: beta[t, u] = log P(finishing from (t, u)), the
    terminal blank at (T-1, u_len) included; beta[0, 0] = log-likelihood."""
    b, t, u1 = blank_lp.shape
    n_diag = t + u1  # the diagonals of an extended lattice with row t = T
    y = F.pad(label_lp, (0, 1), value=_NEG)
    bk, ls = _skew(blank_lp, n_diag), _skew(y, n_diag)
    n = torch.arange(n_diag, device=blank_lp.device)[:, None]
    u = torch.arange(u1, device=blank_lp.device)[None, :]
    valid = ((n - u) >= 0) & ((n - u) < t)
    at_end = (n - u) == t
    neg = torch.full((), _NEG, dtype=blank_lp.dtype, device=blank_lp.device)
    # beta of the virtual row t = T: 0 after the terminal blank at u_len
    term = torch.where(u == u_lens.long()[:, None], torch.zeros_like(neg), neg)  # [B, U1]
    nxt = neg.expand(b, u1)
    diags = [None] * n_diag
    for k in range(n_diag - 1, -1, -1):
        via_blank = bk[:, k] + nxt
        via_label = ls[:, k] + F.pad(nxt[:, 1:], (0, 1), value=_NEG)
        cur = torch.where(valid[k], torch.logaddexp(via_blank, via_label).clamp_min(_NEG), neg)
        nxt = torch.where(at_end[k], term, cur)
        diags[k] = nxt
    return _unskew(torch.stack(diags, dim=1), t)


def rnnt_log_likelihood(alpha: torch.Tensor, blank_lp: torch.Tensor,
                        u_lens: torch.Tensor) -> torch.Tensor:
    """[B] log-likelihood: alpha at (T-1, u_len) plus the terminal blank."""
    idx = u_lens.long()[:, None]
    return (alpha[:, -1].gather(1, idx) + blank_lp[:, -1].gather(1, idx))[:, 0]


def rnnt_occupancies(blank_lp, label_lp, u_lens, alpha, ll):
    """-> (occ_blank [B, T, U+1], occ_label [B, T, U]): the posterior of
    each blank and label transition, d(ll)/d(blank_lp) and d(ll)/d(label_lp)
    (tpuasr/losses/rnnt.py:128-149)."""
    b, t, u1 = blank_lp.shape
    beta = rnnt_betas(blank_lp, label_lp, u_lens)
    beta_tp1 = F.pad(beta[:, 1:], (0, 0, 0, 1), value=_NEG)
    term = ((torch.arange(u1, device=beta.device)[None, None, :] == u_lens.long()[:, None, None])
            & (torch.arange(t, device=beta.device)[None, :, None] == t - 1))
    beta_tp1 = torch.where(term, torch.zeros((), dtype=beta.dtype, device=beta.device),
                           beta_tp1)
    lln = ll[:, None, None]
    occ_blank = torch.exp(torch.clamp(alpha + blank_lp + beta_tp1 - lln, max=0.0))
    occ_label = torch.exp(torch.clamp(alpha[:, :, :-1] + label_lp + beta[:, :, 1:] - lln,
                                      max=0.0))
    return occ_blank, occ_label


class _RNNTLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank_lp, label_lp, u_lens):
        alpha = rnnt_alphas(blank_lp, label_lp)
        ll = rnnt_log_likelihood(alpha, blank_lp, u_lens)
        ctx.save_for_backward(blank_lp, label_lp, u_lens, alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        blank_lp, label_lp, u_lens, alpha, ll = ctx.saved_tensors
        occ_blank, occ_label = rnnt_occupancies(blank_lp, label_lp, u_lens, alpha, ll)
        g3 = g[:, None, None]
        return g3 * occ_blank, g3 * occ_label, None


def mask_lattice_inputs(blank_lp, label_lp, t_lens, u_lens):
    """Free blanks past t_len, -1e30 labels past u_len or t_len ->
    (blank_m, label_m, pad_t [B, T, 1], label_valid [B, T, U])."""
    b, t, u = label_lp.shape
    pad_t = torch.arange(t, device=blank_lp.device)[None, :, None] >= t_lens[:, None, None]
    blank_m = torch.where(pad_t, torch.zeros((), dtype=blank_lp.dtype, device=blank_lp.device),
                          blank_lp)
    label_valid = ((torch.arange(u, device=label_lp.device)[None, None, :]
                    < u_lens[:, None, None]) & ~pad_t)
    label_m = torch.where(label_valid, label_lp,
                          torch.full((), _NEG, dtype=label_lp.dtype, device=label_lp.device))
    return blank_m, label_m, pad_t, label_valid


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
    return zero_infeasible(_RNNTLattice.apply(blank_m, label_m, u_lens))


def rnnt_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
                          u_lens: torch.Tensor, blank: int,
                          reduction: str = "mean") -> torch.Tensor:
    """Raw joint logits [B, T, U+1, V] in, reduced loss out (log-softmax in
    fp32). CPU tensors only: on the card this route needs TPU kernels #8/#9."""
    if logits.device.type != "cpu":
        raise NotImplementedError(
            "the materialized RNN-T loss runs through TPU kernels #8/#9 "
            "(tpuasr/ops/rnnt_pallas.py:173 _rnnt_forward, :197 _rnnt_bwd), not ported "
            "yet; train with model.fused_joint_loss=True")
    nll = rnnt_loss(torch.log_softmax(logits.float(), dim=-1), labels, t_lens, u_lens, blank)
    if reduction == "none":
        return nll
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    raise ValueError(reduction)
