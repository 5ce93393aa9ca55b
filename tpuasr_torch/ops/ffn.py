"""Fused conformer feed-forward: the hand-written CUDA kernels
(``csrc/ffn.cu``) and their plain PyTorch versions.

Counterpart of ``tpuasr/ops/ffn_pallas.py`` (`fused_ffn`): for rows x [R, D]

    out = x + ff_scale * drop2(W2 . drop1(swish(W1 . LN(x) + b1)) + b2)

with the LayerNorm's scale and bias (eps 1e-6). `fused_ffn` is a
`torch.autograd.Function` whose forward is TPU kernel #10 (`_fused_ffn_fwd`,
`ffn_fwd`) and whose backward is #11 (`_fused_ffn_bwd`, `ffn_bwd`), which
recomputes the forward by tile: the [R, 4D] hidden activation is never
saved. Dropout is two uint8 keep-masks (1 = keep) drawn by the caller and
saved for the backward, so the backward applies exactly the forward's masks;
no masks means no dropout.

Weights use torch's layout: w1 [H, D], w2 [D, H] in x's type (the caller
casts them, as the JAX module casts its kernels to the compute type); the
LayerNorm scale/bias and b1/b2 stay fp32. Rounding points are `_fwd_kernel`
and `_bwd_kernel`'s: LN(x)*g + b rounds to x's type before W1; h, the swish
and the masks stay fp32; the activation rounds before W2; x + s*y is fp32
and rounds once. The wrappers run the kernels for tensors on the card and
the plain versions for tensors on the CPU; a CUDA tensor never takes the
plain path.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops import _build

_LN_EPS = 1e-6
KERNEL_D = (64, 256)  # csrc/ffn.cu's widths: the card tests' and the flagship's
KERNEL_H_MULTIPLE = 32  # the hidden dimension is walked in chunks of 32


def _ln_stats(x32: torch.Tensor):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return mu, torch.rsqrt(var + _LN_EPS)


def _dropped(v: torch.Tensor, mask, rate: float) -> torch.Tensor:
    if mask is None:
        return v
    return torch.where(mask != 0, v / (1.0 - rate), torch.zeros((), device=v.device))


def ffn_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate: float,
                  ff_scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel #10, a transcription of
    `_fwd_kernel` (ffn_pallas.py:54-69); same contract as `ffn_fwd`."""
    dt = x.dtype
    x32 = x.float()
    mu, rstd = _ln_stats(x32)
    xn = ((x32 - mu) * rstd * ln_scale.float() + ln_bias.float()).to(dt)
    h = xn.float() @ w1.float().t() + b1.float()
    a = _dropped(h * torch.sigmoid(h), mask1, rate)
    y = _dropped(a.to(dt).float() @ w2.float().t() + b2.float(), mask2, rate)
    return (x32 + ff_scale * y).to(dt)


def ffn_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, dout, rate: float,
                  ff_scale: float):
    """Plain PyTorch version of kernel #11, a transcription of
    `_bwd_kernel` (ffn_pallas.py:72-123); same contract as `ffn_bwd`."""
    dt = x.dtype
    x32 = x.float()
    g32 = ln_scale.float()
    mu, rstd = _ln_stats(x32)
    xhat = (x32 - mu) * rstd
    xn = (xhat * g32 + ln_bias.float()).to(dt).float()
    h = xn @ w1.float().t() + b1.float()
    sig = torch.sigmoid(h)
    ad = _dropped(h * sig, mask1, rate)
    do = dout.float()
    dy = _dropped(do * ff_scale, mask2, rate)
    dyc, adc = dy.to(dt).float(), ad.to(dt).float()
    dw2 = dyc.t() @ adc  # [D, H]
    db2 = dy.sum(0)
    da = _dropped(dyc @ w2.float(), mask1, rate)
    dh = da * (sig * (1.0 + h * (1.0 - sig)))
    dhc = dh.to(dt).float()
    dw1 = dhc.t() @ xn  # [H, D]
    db1 = dh.sum(0)
    dxn = dhc @ w1.float()
    dg = (dxn * xhat).sum(0)
    db = dxn.sum(0)
    dxhat = dxn * g32
    dln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (do + dln).to(dt), dg, db, dw1, db1, dw2, db2


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, dout=None):
    if x.dim() != 2:
        raise ValueError(f"fused_ffn: x must be [R, D], got {tuple(x.shape)}")
    r, d = x.shape
    h = w1.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_ffn: dtype {x.dtype} not supported")
    if d not in KERNEL_D or h % KERNEL_H_MULTIPLE or h == 0:
        raise ValueError(f"fused_ffn: D {d} must be 64 or 256 and H {h} a multiple of "
                         f"{KERNEL_H_MULTIPLE}")
    if (mask1 is None) != (mask2 is None):
        raise ValueError("fused_ffn: pass both keep-masks or neither")
    named = {"x": (x, (r, d), x.dtype), "w1": (w1, (h, d), x.dtype),
             "w2": (w2, (d, h), x.dtype), "ln_scale": (ln_scale, (d,), torch.float32),
             "ln_bias": (ln_bias, (d,), torch.float32), "b1": (b1, (h,), torch.float32),
             "b2": (b2, (d,), torch.float32)}
    if mask1 is not None:
        named["mask1"] = (mask1, (r, h), torch.uint8)
        named["mask2"] = (mask2, (r, d), torch.uint8)
    if dout is not None:
        named["dout"] = (dout, (r, d), x.dtype)
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_ffn: {name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_ffn: {name} must be contiguous on {x.device}")
    return r, d, h


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def ffn_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate: float,
            ff_scale: float) -> torch.Tensor:
    """Kernel #10: -> [R, D] in x's type. x [R, D] fp32 or bf16; ln_scale,
    ln_bias, b2 [D] and b1 [H] fp32; w1 [H, D], w2 [D, H] in x's type;
    mask1 [R, H] and mask2 [R, D] uint8 keep-masks, or both None (no
    dropout). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return ffn_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate,
                             ff_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    r, d, h = _check(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2)
    out = torch.empty_like(x)
    if r == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ffn_fwd", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                      w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      _ptr(mask1), _ptr(mask2), out.data_ptr(), r, d, h,
                      float(1.0 - rate), float(ff_scale), int(x.dtype == torch.bfloat16),
                      stream)
    return out


def ffn_bwd(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, dout, rate: float,
            ff_scale: float):
    """Kernel #11: -> (dx in x's type, then fp32 d ln_scale [D], d ln_bias
    [D], dw1 [H, D], db1 [H], dw2 [D, H], db2 [D], summed over the rows)
    for the output's gradient dout [R, D] in x's type. CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return ffn_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, dout, rate,
                             ff_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    r, d, h = _check(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, dout)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    # the kernel adds every block's partial sums into these
    dg, db, db2 = (torch.zeros(d, **f32) for _ in range(3))
    dw1, db1, dw2 = torch.zeros(h, d, **f32), torch.zeros(h, **f32), torch.zeros(d, h, **f32)
    if r > 0:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("ffn_bwd", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                          w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                          _ptr(mask1), _ptr(mask2), dout.data_ptr(), dx.data_ptr(),
                          dg.data_ptr(), db.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                          dw2.data_ptr(), db2.data_ptr(), r, d, h, float(1.0 - rate),
                          float(ff_scale), int(x.dtype == torch.bfloat16), stream)
    return dx, dg, db, dw1, db1, dw2, db2


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale):
        # x, the parameters and the masks; the hidden activation is recomputed
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2)
        ctx.rate, ctx.ff_scale = rate, ff_scale
        return ffn_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale)

    @staticmethod
    def backward(ctx, dout):
        x, g, b, w1, b1, w2, b2, m1, m2 = ctx.saved_tensors
        dx, dg, db, dw1, db1, dw2, db2 = ffn_bwd(x, g, b, w1, b1, w2, b2, m1, m2,
                                                 dout.contiguous(), ctx.rate, ctx.ff_scale)
        return (dx, dg.to(g.dtype), db.to(b.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None, None, None, None)


def fused_ffn(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate: float,
              ff_scale: float) -> torch.Tensor:
    """x + ff_scale * drop2(W2 . drop1(swish(W1 . LN(x) + b1)) + b2) for rows
    x [R, D], differentiable w.r.t. x and the six parameters (kernels #10
    forward and #11 backward on the card). Arguments as `ffn_fwd`; each
    gradient comes back in its input's type (bf16 weight gradients for bf16
    weights, as the JAX kernel returns them). CPU tensors take the plain
    versions."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    return _FusedFFN.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale)
