"""Fused RNN-T joint + loss: the hand-written CUDA kernels
(``csrc/rnnt_fused.cu``) and their plain PyTorch versions.

Counterparts of ``tpuasr/ops/rnnt_fused_pallas.py``: `rnnt_fused_lp`
replaces `_fused_lp` (`_fused_fwd_kernel`, TPU kernel #4) and
`rnnt_fused_grads` replaces `_fused_grads` (`_fused_bwd_kernel`, #5).
`rnnt_loss_fused_mean` is the `torch.autograd.Function` of `_fused_fwd` /
`_fused_bwd` (:241-293): kernel #4, masking, the alphas, ll and the
feasibility guard forward; betas, occupancies, gb/gl and kernel #5 backward.
The lattice itself is plain PyTorch (`tpuasr_torch.losses.rnnt`), as the JAX
package runs it outside any kernel.

The kernel forward also returns each row's logsumexp, which the backward
reads instead of recomputing it over the vocabulary (the TPU kernel
recomputes the whole softmax). The wrappers run the kernels for tensors on
the card and the plain versions for tensors on the CPU; a CUDA tensor never
takes the plain path. Operands are fp32 (the caller casts, as
`rnnt_fused_pallas.py:139-143` does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuasr_torch.losses.rnnt import (
    _NEG, mask_lattice_inputs, rnnt_alphas, rnnt_log_likelihood, rnnt_occupancies,
)
from tpuasr_torch.ops import _build
MAX_JOIN_DIM = 256  # the backward kernel keeps one row of dW per thread


def _label_ids(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, U] -> [B, U+1]: column u's label, the blank for the last column."""
    return F.pad(labels.long(), (0, 1), value=blank)


def _joint(enc_p, pred_p, w, b):
    a = torch.tanh(enc_p[:, :, None, :] + pred_p[:, None, :, :])  # [B, T, U1, D]
    return a, a @ w + b  # logits [B, T, U1, V]


def rnnt_fused_lp_plain(enc_p, pred_p, w, b, labels, blank: int):
    """-> (blank_lp, label_lp, lse), each [B, T, U+1]: log-softmax of the
    joint's logits at the blank and at column u's label (the blank for the
    last column; 0 - lse for an id outside [0, V), as the one-hot of the TPU
    kernel gives), and the logsumexp. Materialises [B, T, U+1, V]."""
    _, x = _joint(enc_p, pred_p, w, b)
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    lab = _label_ids(labels, blank)
    ok = (lab >= 0) & (lab < v)
    label_x = x.gather(3, lab.clamp(0, v - 1)[:, None, :, None]
                       .expand(x.shape[0], x.shape[1], -1, 1))[..., 0]
    label_x = torch.where(ok[:, None, :], label_x, torch.zeros((), dtype=x.dtype, device=x.device))
    return x[..., blank] - lse, label_x - lse, lse


def rnnt_fused_grads_plain(enc_p, pred_p, w, b, labels, lse, gb, gl, blank: int):
    """-> (d_enc [B, T, D], d_pred [B, U+1, D], dW [D, V], db [V]) for the
    upstream gradients gb, gl [B, T, U+1] of blank_lp and label_lp:
    dX = gb·1[blank] + gl·1[label] − softmax·(gb + gl), da = dX·Wᵀ,
    djoined = da·(1 − a²). Materialises [B, T, U+1, V]."""
    a, x = _joint(enc_p, pred_p, w, b)
    v = x.shape[-1]
    dx = -torch.exp(x - lse[..., None]) * (gb + gl)[..., None]
    dx[..., blank] += gb
    lab = _label_ids(labels, blank)
    ok = ((lab >= 0) & (lab < v))[:, None, :]
    idx = lab.clamp(0, v - 1)[:, None, :, None].expand(x.shape[0], x.shape[1], -1, 1)
    dx = dx.scatter_add(3, idx, torch.where(ok, gl, torch.zeros_like(gl))[..., None])
    dj = (dx @ w.T) * (1.0 - a * a)
    return (dj.sum(2), dj.sum(1), torch.einsum("btud,btuv->dv", a, dx), dx.sum((0, 1, 2)))


def _check(enc_p, pred_p, w, b, labels, extra=()):
    if enc_p.device.type != "cuda":
        raise ValueError(f"rnnt_fused: unsupported device {enc_p.device}")
    bsz, t, d = enc_p.shape
    u1, v = pred_p.shape[1], w.shape[1]
    expect = {"enc_p": (bsz, t, d), "pred_p": (bsz, u1, d), "w": (d, v), "b": (v,),
              "labels": (bsz, u1 - 1)}
    named = {"enc_p": enc_p, "pred_p": pred_p, "w": w, "b": b, "labels": labels,
             **{name: x for name, x in extra}}
    for name, x in named.items():
        shape = expect.get(name, (bsz, t, u1))
        dtype = torch.int32 if name == "labels" else torch.float32
        if x.device != enc_p.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"rnnt_fused: {name} must be a contiguous {dtype} tensor on "
                             f"{enc_p.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"rnnt_fused: {name} shape {tuple(x.shape)}, expected {shape}")
    return bsz, t, u1, d, v


def rnnt_fused_lp(enc_p, pred_p, w, b, labels, blank: int):
    """Kernel #4: -> (blank_lp, label_lp, lse) [B, T, U+1] fp32. enc_p
    [B, T, D], pred_p [B, U+1, D], w [D, V], b [V] fp32; labels [B, U]
    int32 on the card. CPU tensors take the plain version."""
    if enc_p.device.type == "cpu":
        return rnnt_fused_lp_plain(enc_p, pred_p, w, b, labels, blank)
    bsz, t, u1, d, v = _check(enc_p, pred_p, w, b, labels)
    if not 0 <= blank < v:
        raise ValueError(f"rnnt_fused: blank {blank} outside [0, {v})")
    outs = [torch.empty((bsz, t, u1), dtype=torch.float32, device=enc_p.device)
            for _ in range(3)]
    if bsz and t and u1:
        with torch.cuda.device(enc_p.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("rnnt_fused_fwd", enc_p.data_ptr(), pred_p.data_ptr(), w.data_ptr(),
                          b.data_ptr(), labels.data_ptr(), *(o.data_ptr() for o in outs),
                          bsz, t, u1, d, v, blank, stream)
    return tuple(outs)


def rnnt_fused_grads(enc_p, pred_p, w, b, labels, lse, gb, gl, blank: int):
    """Kernel #5: -> (d_enc [B, T, D], d_pred [B, U+1, D], dW [D, V],
    db [V]) fp32. lse from kernel #4; gb, gl [B, T, U+1] fp32 (gl's last
    column 0). CPU tensors take the plain version."""
    if enc_p.device.type == "cpu":
        return rnnt_fused_grads_plain(enc_p, pred_p, w, b, labels, lse, gb, gl, blank)
    bsz, t, u1, d, v = _check(enc_p, pred_p, w, b, labels,
                              (("lse", lse), ("gb", gb), ("gl", gl)))
    if not 0 <= blank < v:
        raise ValueError(f"rnnt_fused: blank {blank} outside [0, {v})")
    if d > MAX_JOIN_DIM:
        raise ValueError(f"rnnt_fused: join dim {d} > {MAX_JOIN_DIM}")
    dev = enc_p.device
    outs = [torch.zeros((bsz, t, d), dtype=torch.float32, device=dev),
            torch.zeros((bsz, u1, d), dtype=torch.float32, device=dev),
            torch.zeros((d, v), dtype=torch.float32, device=dev),
            torch.zeros((v,), dtype=torch.float32, device=dev)]
    if bsz and t and u1:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("rnnt_fused_bwd", enc_p.data_ptr(), pred_p.data_ptr(), w.data_ptr(),
                          b.data_ptr(), labels.data_ptr(), lse.data_ptr(), gb.data_ptr(),
                          gl.data_ptr(), *(o.data_ptr() for o in outs), bsz, t, u1, d, v,
                          blank, stream)
    return tuple(outs)


class _RNNTFusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc_p, pred_p, w, b, labels, t_lens, u_lens, blank):
        dtypes = (enc_p.dtype, pred_p.dtype, w.dtype, b.dtype)
        enc, pred, w32, b32 = (x.float().contiguous() for x in (enc_p, pred_p, w, b))
        lab = labels.to(torch.int32).contiguous()
        blank_lp, label_full, lse = rnnt_fused_lp(enc, pred, w32, b32, lab, blank)
        blank_m, label_m, pad_t, label_valid = mask_lattice_inputs(
            blank_lp, label_full[:, :, :-1], t_lens, u_lens)
        alpha = rnnt_alphas(blank_m, label_m)
        ll = rnnt_log_likelihood(alpha, blank_m, u_lens)
        feasible = ll > _NEG / 2
        ctx.save_for_backward(enc, pred, w32, b32, lab, u_lens, lse, blank_m, label_m,
                              pad_t, label_valid, alpha, ll, feasible)
        ctx.blank, ctx.dtypes = blank, dtypes
        return torch.where(feasible, -ll, torch.zeros((), dtype=ll.dtype, device=ll.device))

    @staticmethod
    def backward(ctx, g):
        (enc, pred, w32, b32, lab, u_lens, lse, blank_m, label_m, pad_t, label_valid, alpha,
         ll, feasible) = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=enc.device)
        g = torch.where(feasible, g.float(), zero)[:, None, None]
        occ_blank, occ_label = rnnt_occupancies(blank_m, label_m, u_lens, alpha, ll)
        # d(nll)/d(raw lp) = -occupancy on unmasked entries, 0 on padding
        gb = torch.where(pad_t, zero, -g * occ_blank)
        gl = F.pad(torch.where(label_valid, -g * occ_label, zero), (0, 1))
        grads = rnnt_fused_grads(enc, pred, w32, b32, lab, lse, gb.contiguous(),
                                 gl.contiguous(), ctx.blank)
        return (*(gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)), None, None, None, None)


def rnnt_loss_fused_mean(enc_p, pred_p, w, b, labels, t_lens, u_lens,
                         blank: int) -> torch.Tensor:
    """Mean-reduced transducer loss of the tanh additive joint without the
    [B, T, U+1, V] logits: enc_p [B, T, D] and pred_p [B, U+1, D] (the
    pre-join projections), w [D, V], b [V], labels [B, U]."""
    return _RNNTFusedLoss.apply(enc_p, pred_p, w, b, labels, t_lens, u_lens, blank).mean()
