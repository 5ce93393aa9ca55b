"""The precision plan of the rel-pos attention kernels' fp32 route, on the CPU.

On the card, kernels #2 and #3 compute every fp32 product as 3xTF32 on
tensor cores (`csrc/relpos_attention.cu`, `mma.cuh:split_tf32`): each
operand x is split into hi = x with its low 13 mantissa bits cleared (TF32)
and lo = x - hi, cut to TF32 the same way as the mma reads it, and a product
is lo.hi + hi.lo + hi.hi summed in fp32 (lo.lo dropped). Here plain PyTorch
emulates those products at the kernels' rounding points: the forward's
scores [q+u | q+v].[k | p]^T (one product of depth 2 dk) and p.v; the
backward's s, dP = do.v^T, dq = ds.(k + p), dv = p^T.do and [dk | dp] =
ds^T.[q+u | q+v], from the forward's log-sum-exp L and D = rowsum(do * o),
with du and dvb from ds's column sums in plain fp32 (the kernels' own fp32
sums). On seeded numpy inputs, with padding and a fully masked query row,
the emulated forward stays within 1e-5 + 1e-5*|ref| of the JAX package's
fp32 `fused_relpos_attention` (the Pallas kernel in interpret mode, jitted)
and every emulated gradient within 1e-4 of its output's max of `jax.vjp`
of it: the tolerances the card's kernels are held to. One TF32 pass (hi.hi
alone) misses the forward's 1e-5 at every shape, which is why the route
takes three.
"""

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.ops.attention_pallas import fused_relpos_attention

torch.set_num_threads(1)  # six test workers share the cores

# (B, T = S, heads, dk, mask): a chunk mask with a fully masked query row,
# and the encoder's padding (one row of a batch cut) under a chunk mask
CASES = [(3, 21, 2, 32, "chunk"), (2, 40, 4, 16, "pad"), (2, 70, 2, 64, "pad")]
NAMES = ("dq", "dk", "dp", "dv", "du", "dvb")  # the Function's (q, k, p, v, u, v_bias) order


def _inputs(b, t, h, dk, kind):
    r = np.random.default_rng(b * t + dk)
    d = h * dk
    q, k, v, do = (r.standard_normal((b, t, d)).astype(np.float32) for _ in range(4))
    p = r.standard_normal((1, t, d)).astype(np.float32)
    ub, vb = (0.1 * r.standard_normal(d)).astype(np.float32), \
        (0.1 * r.standard_normal(d)).astype(np.float32)
    i = np.arange(t)
    chunk = (i[None, :, None] // 8 >= i[None, None, :] // 8)
    if kind == "chunk":
        mask = np.repeat(chunk & (i[None, None, :] >= i[None, :, None] - 12), b, axis=0)
    else:
        lens = np.linspace(t, t // 2, b).astype(int)
        mask = chunk & (i[None, None, :] < lens[:, None, None])
    mask[0, t - 1, :] = False  # a fully masked query row
    return (q, k, p, v, ub, vb, mask), do


@lru_cache(maxsize=None)
def _reference(case):
    """The JAX package's fp32 forward and its VJP on the case's inputs."""
    (q, k, p, v, ub, vb, mask), do = _inputs(*case)
    h, dk = case[2], case[3]
    fn = jax.jit(lambda *a: fused_relpos_attention(*a, jnp.asarray(mask), 1.0 / math.sqrt(dk), h))
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, p, v, ub, vb)))
    return np.asarray(out), tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _tf32(x):
    """x with its low 13 mantissa bits cleared, as `split_tf32` cuts hi."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _mm(a, b, passes):
    """a @ b over fp32 operands as the kernels' mma: passes 3 is 3xTF32
    (lo.hi + hi.lo + hi.hi, each product exact in fp32, fp32 sums), 1 one
    TF32 pass (hi.hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _heads(x, h):
    """[B|1, L, H*dk] -> fp32 [B|1, H, L, dk]."""
    x = torch.from_numpy(x)
    return x.reshape(x.shape[0], x.shape[1], h, -1).transpose(1, 2)


def _forward(case, passes):
    """The forward as the fp32 kernel forms it -> (out [B, T, D], L [B, H, T],
    and the operands the backward reuses)."""
    (q, k, p, v, ub, vb, mask), _ = _inputs(*case)
    b, t, h, dk, _ = case
    quv = torch.cat([_heads(q + ub, h), _heads(q + vb, h)], -1)  # [B, H, T, 2 dk]
    kp = torch.cat([_heads(k, h), _heads(p, h).expand(b, -1, -1, -1)], -1)
    vv = _heads(v, h)
    m = torch.from_numpy(mask)[:, None]  # [B, 1, T, S]
    x = (_mm(quv, kp.transpose(-1, -2), passes) / math.sqrt(dk)).masked_fill(~m, -torch.inf)
    top = x.amax(-1, keepdim=True)
    live = torch.isfinite(top)
    e = torch.exp(x - torch.where(live, top, 0.0))  # masked: exp(-inf) = 0
    l = e.sum(-1, keepdim=True)
    o = _mm(e, vv, passes) / torch.where(live, l, 1.0)
    lse = torch.where(live, top + torch.log(l), -torch.inf)[..., 0]
    return o.transpose(1, 2).reshape(b, t, h * dk), lse, (quv, kp, vv, m)


def _backward(case, passes=3):
    """The fp32 backward's products from the forward's output and L ->
    (dq, dk, dp, dv, du, dvb) in the Function's order."""
    (q, k, p, v, ub, vb, mask), do = _inputs(*case)
    b, t, h, dk, _ = case
    out, lse, (quv, kp, vv, m) = _forward(case, passes)
    scale = 1.0 / math.sqrt(dk)
    g = _heads(do, h)
    dsum = (g * _heads(out.numpy(), h)).sum(-1, keepdim=True)  # D = rowsum(do * o)
    s = _mm(quv, kp.transpose(-1, -2), passes)
    dpp = _mm(g, vv.transpose(-1, -2), passes)
    pr = torch.where(m, torch.exp(s * scale - torch.where(torch.isinf(lse), 0.0, lse)[..., None]),
                     0.0)
    ds = pr * (dpp - dsum) * scale
    ks = kp[..., :dk] + kp[..., dk:]  # k + p in fp32
    dq = _mm(ds, ks, passes)
    dv = _mm(pr.transpose(-1, -2), g, passes)
    dkp = _mm(ds.transpose(-1, -2), quv, passes)  # [B, H, S, 2 dk]
    col = ds.sum(2)  # [B, H, S]
    du = (col[..., None] * kp[..., :dk]).sum((0, 2))  # [H, dk]
    dvb = (col[..., None] * kp[..., dk:]).sum((0, 2))
    flat = lambda x: x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)
    return (flat(dq), flat(dkp[..., :dk]), flat(dkp[..., dk:]).sum(0, keepdim=True), flat(dv),
            du.reshape(-1), dvb.reshape(-1))


def test_tf32_cut_clears_thirteen_bits():
    x = torch.tensor([1.0 + 2.0 ** -10 + 2.0 ** -11, -3.0, 2.0 ** -20 * 1.999], dtype=torch.float32)
    hi = _tf32(x)
    assert torch.equal(hi, torch.tensor([1.0 + 2.0 ** -10, -3.0, 2.0 ** -20 * 1.998046875]))
    assert bool(((hi.view(torch.int32) & 8191) == 0).all())
    assert torch.equal(hi + (x - hi), x)  # the split itself is exact


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_forward_within_1e5(case):
    ref, _ = _reference(case)
    out, lse, _ = _forward(case, passes=3)
    err = np.abs(out.numpy() - ref)
    assert np.all(err <= 1e-5 + 1e-5 * np.abs(ref)), float(err.max())
    assert np.all(out.numpy()[0, case[1] - 1] == 0.0)  # the fully masked row
    assert bool(torch.isinf(lse[0, :, case[1] - 1]).all())


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_backward_within_1e4_of_max(case):
    _, grads = _reference(case)
    for name, x, ref in zip(NAMES, _backward(case), grads):
        assert tuple(x.shape) == ref.shape, name
        err = float(np.abs(x.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (name, err)
    assert bool((_backward(case)[0][0, case[1] - 1] == 0).all())  # no gradient: masked row


@pytest.mark.parametrize("case", CASES)
def test_one_tf32_pass_misses_1e5(case):
    ref, _ = _reference(case)
    out, _, _ = _forward(case, passes=1)
    assert not np.all(np.abs(out.numpy() - ref) <= 1e-5 + 1e-5 * np.abs(ref))
