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
plain path. On the card the kernels tile the rows and slices of the hidden
dimension as `_ffn_plan` says and sum across blocks in a fixed order: two
calls on the same inputs give the same bits. The forward also stands as a
registered operator, `torch.ops.tpuasr.ffn_fwd` (`ffn_fwd_op`), which the
autograd Function calls, so `torch.export` keeps kernel #10 inside an
exported graph (`tpuasr_torch.export`).
"""

from __future__ import annotations

import functools

import torch

from tpuasr_torch.ops import _build

_LN_EPS = 1e-6
KERNEL_D = (64, 256)  # csrc/ffn.cu's widths: the card tests' and the flagship's
KERNEL_H_MULTIPLE = 32  # the hidden dimension is walked in chunks of 32
_ROWS = {torch.bfloat16: 64, torch.float32: 32}  # rows a block: tensor-core and fp32 routes
_LN_ROWS = 8  # rows a block of the backward's LN pass (a warp per row)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bwd_ws(r: int, d: int, h: int, slices: int, es: int, tiles: int) -> int:
    """Bytes of #11's scratch, laid out as `bwd_ws` in csrc/ffn.cu: xn, dyc
    [R, D] and the rounded activation and dh [R, H] in the compute type,
    the slices' partial dxn [S, R, D], and per row tile the partial db1,
    db2 (row side) and dg, db (LN pass), fp32; each part 256-byte aligned."""
    ln = _cdiv(r, _LN_ROWS) * d * 4
    parts = (r * d * es, r * d * es, r * h * es, r * h * es, slices * r * d * 4,
             tiles * h * 4, tiles * d * 4, ln, ln)
    return sum(_cdiv(n, 256) * 256 for n in parts)


# blocks of each kernel an SM takes in one wave. #11's row side: one (153 KB
# of shared memory bf16, 146 KB fp32). #10 fits two an SM (115 KB / 108 KB):
# fp32 takes two (its CUDA-core chunks gain from the second block), bf16 one,
# which measured faster at the training shape on an H100 (chip_smoke phase
# 3, "by H slices"): the slices' partial outputs cost S R D 4 bytes through
# L2 and a longer sum, more than a second block an SM wins back
_PER_SM = {("fwd", torch.bfloat16): 1, ("fwd", torch.float32): 2,
           ("bwd", torch.bfloat16): 1, ("bwd", torch.float32): 1}


def _slices(n_chunks: int, tiles: int, n_sm: int, per_sm: int) -> int:
    """H slices for `tiles` row tiles: as many as the card holds at once
    (tiles x slices <= n_sm x per_sm, so no block waits for a second wave),
    at least one and at most one a chunk, none empty."""
    want = min(n_chunks, max(1, n_sm * per_sm // tiles))
    return _cdiv(n_chunks, _cdiv(n_chunks, want))


def _plan_for(r: int, d: int, h: int, dtype: torch.dtype, fwd_slices: int,
              bwd_slices: int) -> dict:
    """The tiling with the given H slices for #10 and #11."""
    rows = _ROWS[dtype]
    tiles = _cdiv(r, rows)
    n_chunks = h // KERNEL_H_MULTIPLE
    es = 2 if dtype == torch.bfloat16 else 4
    return {"rows": rows, "tiles": tiles, "fwd_slices": fwd_slices,
            "bwd_slices": bwd_slices, "fwd_chunks": _cdiv(n_chunks, fwd_slices),
            "bwd_chunks": _cdiv(n_chunks, bwd_slices),
            "fwd_ws": fwd_slices * r * d * 4 if fwd_slices > 1 else 0,
            "bwd_ws": _bwd_ws(r, d, h, bwd_slices, es, tiles)}


def _ffn_plan(r: int, d: int, h: int, dtype: torch.dtype, n_sm: int) -> dict:
    """How #10/#11 tile R rows on a card of `n_sm` SMs: row tiles of 64
    (bf16, tensor cores) or 32 (fp32) rows, and the hidden dimension split
    into slices of chunks of 32 units, as many slices as let every block of
    the kernel be resident at once (`_PER_SM`); -> {"rows", "tiles",
    "fwd_slices", "bwd_slices", "fwd_chunks", "bwd_chunks" (chunks a
    slice), "fwd_ws", "bwd_ws"}: the grid is tiles x slices; the workspace
    bytes of the forward (the slices' partial outputs, none for one slice)
    and of the backward."""
    tiles = _cdiv(r, _ROWS[dtype])
    n_chunks = h // KERNEL_H_MULTIPLE
    return _plan_for(r, d, h, dtype, _slices(n_chunks, tiles, n_sm, _PER_SM["fwd", dtype]),
                     _slices(n_chunks, tiles, n_sm, _PER_SM["bwd", dtype]))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
        if t.data_ptr() % 16:
            raise ValueError(f"fused_ffn: {name} must start on a 16-byte boundary")
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
    plan = _ffn_plan(r, d, h, x.dtype, _sm_count(x.device.index))
    # the slices' partial outputs, summed in slice order by the kernel's epilogue
    ws = torch.empty(plan["fwd_ws"], dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ffn_fwd", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                      w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      _ptr(mask1), _ptr(mask2), out.data_ptr(), r, d, h,
                      float(1.0 - rate), float(ff_scale), int(x.dtype == torch.bfloat16),
                      ws.data_ptr(), ws.numel(), plan["fwd_slices"], stream)
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
    if r == 0:  # sums over no rows
        return (dx, torch.zeros(d, **f32), torch.zeros(d, **f32), torch.zeros(h, d, **f32),
                torch.zeros(h, **f32), torch.zeros(d, h, **f32), torch.zeros(d, **f32))
    # the kernels write every output once, each sum over the rows in a fixed order
    dg, db, db2 = (torch.empty(d, **f32) for _ in range(3))
    dw1, db1, dw2 = torch.empty(h, d, **f32), torch.empty(h, **f32), torch.empty(d, h, **f32)
    plan = _ffn_plan(r, d, h, x.dtype, _sm_count(x.device.index))
    ws = torch.empty(plan["bwd_ws"], dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ffn_bwd", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                      w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      _ptr(mask1), _ptr(mask2), dout.data_ptr(), dx.data_ptr(),
                      dg.data_ptr(), db.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                      dw2.data_ptr(), db2.data_ptr(), r, d, h, float(1.0 - rate),
                      float(ff_scale), int(x.dtype == torch.bfloat16), ws.data_ptr(),
                      ws.numel(), plan["bwd_slices"], stream)
    return dx, dg, db, dw1, db1, dw2, db2


@torch.library.custom_op(
    "tpuasr::ffn_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, Tensor b1, Tensor w2, "
           "Tensor b2, Tensor? mask1, Tensor? mask2, float rate, float ff_scale) -> Tensor")
def ffn_fwd_op(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale):
    """Kernel #10 as a registered operator, `torch.ops.tpuasr.ffn_fwd`, so
    that `torch.export` keeps the kernel inside an exported graph (a ctypes
    call on raw pointers cannot be traced). Its CUDA implementation is
    `ffn_fwd`, which launches the kernel and counts it; its CPU
    implementation is `ffn_fwd_plain`; its fake one gives the output's
    shape and type."""
    return ffn_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale)


ffn_fwd_op.register_kernel("cpu")(ffn_fwd_plain)


@ffn_fwd_op.register_fake
def _ffn_fwd_fake(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale):
    return torch.empty_like(x)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale):
        # x, the parameters and the masks; the hidden activation is recomputed
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2)
        ctx.rate, ctx.ff_scale = rate, ff_scale
        return ffn_fwd_op(x, ln_scale, ln_bias, w1, b1, w2, b2, mask1, mask2, rate, ff_scale)

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
