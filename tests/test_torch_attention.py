"""Port rel-pos attention == JAX on the CPU.

The kernel's plain version is held against the Pallas `fused_relpos_attention`
(interpret mode), and the port's module on converted weights against the JAX
module: its full-context path (the plain formula, or with `fused` the
kernel wrapper) against the matching JAX path, and its KV-cache path. T = 21 is deliberately not a
multiple of the Pallas kernel's 16-row tile, and one query row is fully
masked (it must give zeros). Tolerance rtol 2e-5, atol 2e-6 as in
tests/test_fused_attention.py:38-39: fp32 sums in another order.
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
from tpuasr_torch.ops import LAUNCHES, relpos_attention

B, T, H, D = 3, 21, 2, 32
RTOL, ATOL = 2e-5, 2e-6


def _mask():
    i = np.arange(T)
    m = (i[None, :, None] // 4 >= i[None, None, :] // 4) & (i[None, None, :] >= i[None, :, None] - 8)
    m = np.repeat(m, B, axis=0)
    m[1, -1, :] = False  # fully masked query row
    return m


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    x = r.standard_normal((B, T, D)).astype(np.float32)
    pe = (r.standard_normal((1, T, D)) * 0.5).astype(np.float32)
    return x, pe, _mask()


def _port_module(params, fused=False):
    mod = RelPositionMultiHeadedAttention(H, D, 0.0, fused=fused, device="cpu")
    mod.load_state_dict(convert_params(jax.tree.map(np.asarray, params)))
    return mod


@pytest.mark.parametrize("mask_rows", ["full", "broadcast"])
def test_plain_kernel_matches_pallas_interpret(mask_rows):
    r = np.random.default_rng(1)
    q, k, v = (r.standard_normal((B, T, D)).astype(np.float32) for _ in range(3))
    p = r.standard_normal((1, T, D)).astype(np.float32)
    ub, vb = (r.standard_normal(D).astype(np.float32) * 0.1 for _ in range(2))
    mask = _mask()
    if mask_rows == "broadcast":  # [B, 1, S] padding mask, read with stride 0
        mask = np.ones((B, 1, T), bool)
        mask[2, 0, 15:] = False
    scale = 1.0 / math.sqrt(D // H)
    ref = fused_relpos_attention(*(jnp.asarray(a) for a in (q, k, p, v, ub, vb, mask)),
                                 scale, H)
    t = torch.from_numpy
    got = relpos_attention(t(q), t(k), t(p), t(v), t(ub), t(vb), t(mask), scale, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    if mask_rows == "full":
        assert np.all(got.numpy()[1, -1] == 0.0)  # fully masked row -> zeros


@pytest.mark.parametrize("fused", [False, True])
def test_module_matches_jax(inputs, fused):
    x, pe, mask = inputs
    jmod = JaxAttention(H, D, 0.0, jnp.float32, fused=fused)
    params = jmod.init(jax.random.PRNGKey(0), x, mask, pe)
    ref, _ = jmod.apply(params, x, mask, pe)
    before = LAUNCHES["relpos_attention"]
    got, _ = _port_module(params, fused)(torch.from_numpy(x), torch.from_numpy(mask),
                                         torch.from_numpy(pe))
    assert LAUNCHES["relpos_attention"] == before  # CPU tensors: plain version only
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_cache_path_matches_jax():
    """Streaming step: right-aligned KV cache of capacity A, only the newest
    `valid` slots unmasked, PE over the A + chunk key window."""
    r = np.random.default_rng(2)
    a, chunk, valid = 8, 4, 5
    x = r.standard_normal((B, chunk, D)).astype(np.float32)
    kc, vc = (r.standard_normal((B, a, H, D // H)).astype(np.float32) for _ in range(2))
    pe = r.standard_normal((1, a + chunk, D)).astype(np.float32)
    j = np.arange(a + chunk)
    mask = np.broadcast_to(j >= a - valid, (B, chunk, a + chunk)).copy()
    jmod = JaxAttention(H, D, 0.0, jnp.float32)
    params = jmod.init(jax.random.PRNGKey(1), x, mask, pe, (kc, vc))
    ref, (rk, rv) = jmod.apply(params, x, mask, pe, (kc, vc))
    t = torch.from_numpy
    got, (gk, gv) = _port_module(params)(t(x), t(mask), t(pe), (t(kc), t(vc)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gk.detach().numpy(), np.asarray(rk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gv.detach().numpy(), np.asarray(rv), rtol=RTOL, atol=ATOL)
