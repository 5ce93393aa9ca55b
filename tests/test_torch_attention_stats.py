"""The row statistics that the rel-pos attention forward saves for its
backward, on the CPU.

`relpos_attention_plain(..., saved=True)` returns the fp32 output and each
query row's log-sum-exp of its unmasked scaled scores, held against a
float64 numpy log-sum-exp of the same numpy inputs (atol 2e-5: fp32 scores
against float64, scores of a few units); a fully masked row gives -inf. The
backward's identity rowsum(da * a) = rowsum(do * out) (out = a.v) holds on
the plain fp32 versions to 1e-5 of its largest value (fp32 sums in another
order). Autograd through `relpos_attention`, whose Function saves only the
inputs on the CPU (the statistics are for the bf16 kernels' backward),
equals `jax.vjp` of the Pallas `fused_relpos_attention` in interpret mode
(rtol 3e-5, atol 2e-5, as tests/test_fused_attention.py:54-58). Each case runs with a chunk mask
holding a fully masked query row and with a broadcast [B, 1, S] padding
mask, at B 3, T 21, H 2, D 32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.ops.attention_pallas import fused_relpos_attention
from tpuasr_torch.ops import (
    LAUNCHES, relpos_attention, relpos_attention_bwd_plain, relpos_attention_plain,
)

torch.set_num_threads(1)  # six test workers share the cores

B, T, H, D = 3, 21, 2, 32
DK = D // H
SCALE = 1.0 / math.sqrt(DK)
KINDS = ["full", "broadcast"]


def _inputs(seed, kind):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal((B, T, D)).astype(np.float32) for _ in range(4))
    p = r.standard_normal((1, T, D)).astype(np.float32)
    ub, vb = (r.standard_normal(D).astype(np.float32) * 0.1 for _ in range(2))
    if kind == "broadcast":  # [B, 1, S] padding mask
        mask = np.ones((B, 1, T), bool)
        mask[2, 0, 15:] = False
    else:
        i = np.arange(T)
        mask = (i[:, None] // 4 >= i[None, :] // 4) & (i[None, :] >= i[:, None] - 8)
        mask = np.repeat(mask[None], B, axis=0)
        mask[1, -1, :] = False  # fully masked query row
    return (q, k, p, v, ub, vb, mask), do


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_lse_matches_numpy_float64(kind):
    (q, k, p, v, ub, vb, mask), _ = _inputs(0, kind)
    f = lambda x: x.astype(np.float64).reshape(x.shape[0], x.shape[1], H, DK)
    scores = (np.einsum("bthd,bshd->bhts", f(q + ub), f(k))
              + np.einsum("bthd,pshd->bhts", f(q + vb), f(p))) * SCALE
    scores = np.where(mask[:, None], scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):  # a fully masked row: -inf - -inf
        ref = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))[..., 0]
    ref = np.where(np.isinf(top[..., 0]), -np.inf, ref)
    out, out32, lse = relpos_attention_plain(*_torch((q, k, p, v, ub, vb, mask)), SCALE, H,
                                             saved=True)
    assert out32 is out  # fp32: the output is already fp32
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, T)
    assert torch.equal(out, relpos_attention_plain(*_torch((q, k, p, v, ub, vb, mask)), SCALE,
                                                   H))
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isinf(ref))
    np.testing.assert_allclose(lse.numpy(), ref, rtol=0, atol=2e-5)
    if kind == "full":
        assert np.all(np.isneginf(lse.numpy()[1, :, -1]))


@pytest.mark.parametrize("kind", KINDS)
def test_rowsum_identity_on_the_plain_versions(kind):
    """D = rowsum(do * out) is the backward's rowsum(da * a)."""
    arrays, do_np = _inputs(1, kind)
    q, k, p, v, ub, vb, mask = _torch(arrays)
    do = torch.from_numpy(do_np)
    heads = lambda x: x.reshape(x.shape[0], x.shape[1], H, DK)
    scores = (torch.einsum("bthd,bshd->bhts", heads(q + ub), heads(k))
              + torch.einsum("bthd,pshd->bhts", heads(q + vb), heads(p))) * SCALE
    m = mask[:, None]
    a = torch.softmax(scores.masked_fill(~m, -1e9), -1).masked_fill(~m, 0.0)
    da = torch.einsum("bthd,bshd->bhts", heads(do), heads(v)).masked_fill(~m, 0.0)
    want = (da * a).sum(-1)  # [B, H, T]
    out = relpos_attention_plain(q, k, p, v, ub, vb, mask, SCALE, H)
    got = (heads(do) * heads(out)).sum(-1).permute(0, 2, 1)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    if kind == "full":
        assert bool((got[1, :, -1] == 0).all())


@pytest.mark.parametrize("kind", KINDS)
def test_autograd_through_the_function_matches_pallas_vjp(kind):
    (q, k, p, v, ub, vb, mask), do = _inputs(2, kind)
    fn = lambda q_, k_, p_, v_, u_, vb_: fused_relpos_attention(
        q_, k_, p_, v_, u_, vb_, jnp.asarray(mask), SCALE, H)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, p, v, ub, vb)))
    ref = vjp(jnp.asarray(do))
    leaves = [x.requires_grad_() for x in _torch((q, k, p, v, ub, vb))]
    before = dict(LAUNCHES)
    out = relpos_attention(*leaves, torch.from_numpy(mask), SCALE, H)
    saved = out.grad_fn.saved_tensors  # the inputs; no fp32 output, no lse
    assert len(saved) == 9 and saved[7] is None and saved[8] is None
    out.backward(torch.from_numpy(do))
    assert LAUNCHES == before  # CPU tensors: the plain versions only
    for name, x, r in zip(("q", "k", "p", "v", "u", "v_bias"), leaves, ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), rtol=3e-5, atol=2e-5,
                                   err_msg=name)


def test_plain_backward_ignores_the_saved_statistics():
    arrays, do = _inputs(3, "full")
    x = _torch(arrays)
    _, out32, lse = relpos_attention_plain(*x, SCALE, H, saved=True)
    args = (*x, torch.from_numpy(do), SCALE, H)
    for a, b in zip(relpos_attention_bwd_plain(*args, out32, lse),
                    relpos_attention_bwd_plain(*args)):
        assert torch.equal(a, b)


def test_forward_without_gradients_saves_nothing():
    x = _torch(_inputs(4, "full")[0])
    out = relpos_attention(*x, SCALE, H)  # no input requires a gradient
    assert out.grad_fn is None
    assert torch.equal(out, relpos_attention_plain(*x, SCALE, H))


def test_aligned_copies_only_what_is_off_16_bytes():
    """The kernels move 16-byte vectors, so the wrappers hand them a copy of
    an input that does not start on 16 bytes (ZeRO-3 packs the biases into
    one flat buffer with no padding) and every other input as it is."""
    from tpuasr_torch.ops.relpos_attention import _aligned

    flat = torch.arange(1 + 2 * D, dtype=torch.float32)
    whole, off = flat[:D], flat[1:1 + D]
    assert off.data_ptr() % 16 == 4
    a, b, none = _aligned(whole, off, None)
    assert a is whole and none is None
    assert b.data_ptr() % 16 == 0 and b.data_ptr() != off.data_ptr() and torch.equal(b, off)
