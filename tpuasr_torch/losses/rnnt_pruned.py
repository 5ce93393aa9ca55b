"""Pruned RNN-T loss (port of ``tpuasr/losses/rnnt_pruned.py``): the joint
and the lattice restricted to a band of `s_range` label positions a frame,
so the joint's logits are [B, T, S, V] instead of [B, T, U+1, V].

The band follows the linear-alignment prior ``lo[t] = clip(round(t (U+1) /
T - S/2), 0, U+1-S)`` (`band_offsets`, the JAX package's own choice in
place of k2's gradient-derived ranges): monotonic, and a band of U+1 or more
positions is the full loss.

This is plain PyTorch on every device (the JAX package runs it as a
`lax.scan`, no TPU kernel), with gradients by autograd. The lattice is a
loop over frames; inside a frame the recurrence ``x_u = logaddexp(base_u,
x_{u-1} + y_u)`` is solved at once as ``x_u = logsumexp_j (base_j +
sum_{j<k<=u} y_k)`` over a [S, S] matrix of partial sums, built for every
frame before the loop from cumulative sums of the finite gains, with -1e30
wherever the span holds a masked gain (so no -1e30 is ever subtracted from
another). Alphas are clamped at -1e30, as the JAX log-add keeps them.
"""

from __future__ import annotations

import torch

from tpuasr_torch.losses.rnnt import zero_infeasible
from tpuasr_torch.ops.rnnt_lattice import _NEG


def band_offsets(t_lens: torch.Tensor, u_lens: torch.Tensor, t: int,
                 s_range: int) -> torch.Tensor:
    """lo [B, T] int64: the first label position of each frame's band
    (monotonic, clipped so that the band covers u = u_len at the last valid
    frame; padded frames keep the final band)."""
    dev = t_lens.device
    tt = torch.arange(t, device=dev, dtype=torch.float32)[None, :]
    tl = torch.clamp(t_lens[:, None].float(), min=1.0)
    ul = u_lens[:, None].float()
    tt = torch.minimum(tt, tl - 1.0)
    center = tt * (ul + 1.0) / tl
    lo = torch.round(center - s_range / 2.0).long()
    hi_cap = torch.clamp(u_lens[:, None].long() + 1 - s_range, min=0)
    return torch.minimum(torch.clamp(lo, min=0), hi_cap)


def _span_sums(y: torch.Tensor) -> torch.Tensor:
    """y [B, T, S] gains (y[..., u] enters x_u from x_{u-1}) -> M [B, T, S,
    S]: M[..., j, u] = sum of y[..., j+1 .. u] for j <= u, -1e30 where j > u
    or the span holds a gain at or below -1e30 / 2."""
    masked = y <= _NEG / 2
    c = torch.cumsum(torch.where(masked, torch.zeros_like(y), y), dim=-1)
    n = torch.cumsum(masked.int(), dim=-1)
    s = y.shape[-1]
    j = torch.arange(s, device=y.device)
    upper = j[:, None] <= j[None, :]  # [j, u]
    bad = (n[..., None, :] - n[..., :, None] > 0) | ~upper
    return torch.where(bad, torch.full_like(c[..., None], _NEG), c[..., None, :] - c[..., :, None])


def rnnt_loss_pruned(enc_p: torch.Tensor, pred_p: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
                     u_lens: torch.Tensor, blank: int, s_range: int = 16,
                     reduction: str = "mean") -> torch.Tensor:
    """Banded transducer loss. enc_p [B, T, D] and pred_p [B, U+1, D] the
    joint-projected encoder and predictor outputs, (w [D, V], bias [V]) the
    plain head, labels [B, U], lengths [B]."""
    b, t, d = enc_p.shape
    u1 = pred_p.shape[1]
    s = min(s_range, u1)
    dev = enc_p.device
    t_lens, u_lens = t_lens.to(dev).long(), u_lens.to(dev).long()

    lo = band_offsets(t_lens, u_lens, t, s)  # [B, T]
    s_idx = torch.arange(s, device=dev)
    idx = lo[:, :, None] + s_idx  # [B, T, S] label position u
    idx_c = torch.clamp(idx, max=u1 - 1)

    # the banded joint: tanh(enc + pred_band) @ w + bias -> fp32 log-softmax
    pred_band = torch.gather(pred_p, 1, idx_c.reshape(b, t * s, 1).expand(-1, -1, d))
    h = torch.tanh(enc_p[:, :, None] + pred_band.view(b, t, s, d))
    dt = h.dtype
    lp = torch.log_softmax((h @ w.to(dt) + bias.to(dt)).float(), dim=-1)

    blank_lp = lp[..., blank]
    lab = torch.gather(torch.nn.functional.pad(labels.to(dev).long(), (0, 1)), 1,
                       idx_c.reshape(b, t * s)).view(b, t, s)
    label_lp = lp.gather(-1, lab[..., None])[..., 0]

    # padded frames take free blanks; labels only where u < u_len on a valid frame
    neg = torch.full((), _NEG, device=dev)
    pad_t = torch.arange(t, device=dev)[None, :, None] >= t_lens[:, None, None]
    in_band = idx <= u_lens[:, None, None]
    blank_lp = torch.where(pad_t, torch.zeros((), device=dev),
                           torch.where(in_band, blank_lp, neg))
    label_lp = torch.where((idx < u_lens[:, None, None]) & ~pad_t, label_lp, neg)

    # alpha_t[s] = logaddexp(alpha_{t-1}[s + d_t] + blank_{t-1}[s + d_t],
    #                        alpha_t[s - 1] + label_t[s - 1])
    y = torch.nn.functional.pad(label_lp, (1, 0), value=_NEG)[..., :s]
    spans = _span_sums(y)  # [B, T, S, S]
    shift = torch.diff(lo, dim=1, prepend=lo[:, :1])  # d_t >= 0
    src = s_idx + shift[:, :, None]  # [B, T, S]
    ok = src < s
    src = torch.clamp(src, max=s - 1)

    def solve(base, tt):
        return torch.logsumexp(base[:, :, None] + spans[:, tt], dim=1).clamp(min=_NEG)

    base0 = torch.where((lo[:, :1] == 0) & (s_idx == 0), torch.zeros((), device=dev), neg)
    alpha = solve(base0, 0)
    for tt in range(1, t):
        moved = torch.gather(alpha + blank_lp[:, tt - 1], 1, src[:, tt])
        alpha = solve(torch.where(ok[:, tt], moved, neg), tt)

    # the corner u = u_len (band position u_len - lo[T-1]) and its final blank
    corner_s = torch.clamp(u_lens - lo[:, -1], 0, s - 1)[:, None]
    ll = (torch.gather(alpha, 1, corner_s) + torch.gather(blank_lp[:, -1], 1, corner_s))[:, 0]
    nll = zero_infeasible(ll)
    if reduction == "none":
        return nll
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    raise ValueError(reduction)
