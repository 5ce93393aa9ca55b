"""The rel-pos attention backward == JAX on the CPU.

`relpos_attention_bwd_plain` (the plain version of kernel #3) against
`jax.vjp` of the Pallas `fused_relpos_attention` (interpret mode) at B 3,
T 21, H 2, D 32: a chunk mask with a fully masked query row (its dq must be
exactly zero) and a broadcast [B, 1, S] padding mask. Autograd through the
port's `relpos_attention` on the CPU is that plain backward, and agrees with
autograd through the plain forward; the port's module with `fused=True`
gives every parameter gradient of the JAX module with `fused=True`.
Tolerance rtol 3e-5, atol 2e-5, as tests/test_fused_attention.py:54-58:
fp32 sums in another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.nn.attention import RelPositionMultiHeadedAttention as JaxAttention
from tpuasr.ops.attention_pallas import fused_relpos_attention
from tpuasr_torch.convert import convert_params
from tpuasr_torch.nn.attention import RelPositionMultiHeadedAttention
from tpuasr_torch.ops import (
    LAUNCHES, relpos_attention, relpos_attention_bwd_plain, relpos_attention_plain,
)

torch.set_num_threads(1)  # six test workers share the cores

B, T, H, D = 3, 21, 2, 32
RTOL, ATOL = 3e-5, 2e-5
NAMES = ("dq", "dk", "dv", "dp", "du", "dvb")


def _mask(kind):
    if kind == "broadcast":  # [B, 1, S] padding mask
        m = np.ones((B, 1, T), bool)
        m[2, 0, 15:] = False
        return m
    i = np.arange(T)
    m = (i[None, :, None] // 4 >= i[None, None, :] // 4) & (i[None, None, :] >= i[None, :, None] - 8)
    m = np.repeat(m, B, axis=0)
    m[1, -1, :] = False  # fully masked query row
    return m


def _inputs(seed, kind):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, T, D)).astype(np.float32) for _ in range(3))
    p = r.standard_normal((1, T, D)).astype(np.float32)
    ub, vb = (r.standard_normal(D).astype(np.float32) * 0.1 for _ in range(2))
    do = r.standard_normal((B, T, D)).astype(np.float32)
    return (q, k, p, v, ub, vb, _mask(kind)), do


@pytest.mark.parametrize("kind", ["full", "broadcast"])
def test_plain_backward_matches_pallas_interpret(kind):
    (q, k, p, v, ub, vb, mask), do = _inputs(3, kind)
    scale = 1.0 / math.sqrt(D // H)
    fn = lambda q_, k_, p_, v_, u_, vb_: fused_relpos_attention(
        q_, k_, p_, v_, u_, vb_, jnp.asarray(mask), scale, H)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, p, v, ub, vb)))
    rq, rk, rp, rv, ru, rvb = vjp(jnp.asarray(do))
    t = torch.from_numpy
    got = relpos_attention_bwd_plain(t(q), t(k), t(p), t(v), t(ub), t(vb), t(mask), t(do),
                                     scale, H)
    for name, x, ref in zip(NAMES, got, (rq, rk, rv, rp, ru, rvb)):
        assert x.dtype == torch.float32 and tuple(x.shape) == ref.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    if kind == "full":
        assert np.all(got[0].numpy()[1, -1] == 0.0)  # fully masked row: no gradient


def test_autograd_is_the_plain_backward():
    (q, k, p, v, ub, vb, mask), do = _inputs(4, "full")
    scale = 1.0 / math.sqrt(D // H)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, p, v, ub, vb)]
    m, g = torch.from_numpy(mask), torch.from_numpy(do)
    before = dict(LAUNCHES)
    relpos_attention(*leaves, m, scale, H).backward(g)
    assert LAUNCHES == before  # CPU tensors: the plain versions only
    want = relpos_attention_bwd_plain(*(x.detach() for x in leaves), m, g, scale, H)
    # the Function's (q, k, p, v, u, v) order against (dq, dk, dv, dp, du, dvb)
    for x, w in zip(leaves, (want[0], want[1], want[3], want[2], want[4], want[5])):
        assert torch.equal(x.grad, w)
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, p, v, ub, vb)]
    relpos_attention_plain(*ref, m, scale, H).backward(g)  # autograd of the formula
    for x, r in zip(leaves, ref):
        np.testing.assert_allclose(x.grad.numpy(), r.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_fused_module_gradients_match_jax():
    r = np.random.default_rng(5)
    x = r.standard_normal((B, T, D)).astype(np.float32)
    pe = (r.standard_normal((1, T, D)) * 0.5).astype(np.float32)
    w = r.standard_normal((B, T, D)).astype(np.float32)
    mask = _mask("full")
    jmod = JaxAttention(H, D, 0.0, jnp.float32, fused=True)
    params = jmod.init(jax.random.PRNGKey(0), x, mask, pe)

    def loss(prm, xx):
        return jnp.sum(jmod.apply(prm, xx, mask, pe)[0] * w)

    ref_p, ref_x = jax.grad(loss, argnums=(0, 1))(params, x)
    mod = RelPositionMultiHeadedAttention(H, D, 0.0, fused=True, device="cpu")
    mod.load_state_dict(convert_params(jax.tree.map(np.asarray, params)))
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = mod(xt, torch.from_numpy(mask), torch.from_numpy(pe))
    (out * torch.from_numpy(w)).sum().backward()
    want = convert_params(jax.tree.map(np.asarray, ref_p))
    got = dict(mod.named_parameters())
    assert want.keys() == got.keys()
    for name, prm in got.items():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), rtol=RTOL, atol=ATOL)
