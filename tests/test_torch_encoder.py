"""Port conformer encoder == JAX on the CPU, on converted weights.

Full-context and chunk-masked `encode` against both JAX attention paths
(unfused, and the fused Pallas kernel in interpret mode), and the streaming
`forward_chunk` window by window (outputs and caches), for both JAX
parameter layouts (scanned `layers/block` and unrolled `block{i}`), at fp32
atol 1e-4 (two stacked blocks of fp32 sums in another order). The same in
the flagship's compute type, bf16 (bf16 products, fp32 LayerNorm statistics
and softmax): max abs error 2**-4, four bf16 ulps of the output's top binade
[2, 4), since every product's output is rounded to bf16 at slightly
different points on the two sides, and mean abs error 2**-7. Plus the
port's own gate: chunked streaming == the chunk-masked full-context forward.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.config import to_dict
from tpuasr.models import Transducer as JaxTransducer
from tpuasr.nn.conformer import unstack_layer_params
from tpuasr.streaming.chunkwise import chunk_windows as jax_chunk_windows
from tpuasr_torch.config import ModelConfig, from_dict
from tpuasr_torch.convert import convert_params, load_jax_params
from tpuasr_torch.models import Transducer
from tpuasr_torch.streaming import chunk_windows, num_chunks

ATOL = 1e-4
BF16_MAX, BF16_MEAN = 2.0 ** -4, 2.0 ** -7
CHUNK, LEFT = 4, 2


def _jax_cfg(scan_layers=True, fused=False, dtype="float32"):
    mc = _flagship_config(tiny=True).model
    mc.compute_dtype = dtype
    mc.encoder = dataclasses.replace(mc.encoder, scan_layers=scan_layers,
                                     fused_attention=fused)
    return mc


def _close_bf16(got: torch.Tensor, ref):
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    err = np.abs(got.float().numpy() - np.asarray(ref).astype(np.float32))
    assert err.max() <= BF16_MAX and err.mean() <= BF16_MEAN, (err.max(), err.mean())


def _port(mc, params):
    model = Transducer(from_dict(ModelConfig, to_dict(mc)), device="cpu")
    return load_jax_params(model, params)


@pytest.fixture(scope="module")
def jax_model():
    mc = _jax_cfg()
    model = JaxTransducer(mc)
    b, t = 2, 67
    params = model.init(jax.random.PRNGKey(0), np.zeros((b, t, 80), np.float32),
                        np.full((b,), t, np.int32), np.zeros((b, 5), np.int32),
                        np.full((b,), 5, np.int32))
    params = jax.tree.map(np.asarray, params)
    unrolled = {"params": dict(params["params"])}
    unrolled["params"]["encoder"] = unstack_layer_params(
        params["params"]["encoder"], mc.encoder.num_blocks)
    return mc, params, jax.tree.map(np.asarray, unrolled)


@pytest.fixture(scope="module")
def feats():
    r = np.random.default_rng(0)
    return r.standard_normal((2, 67, 80)).astype(np.float32), np.array([67, 51], np.int32)


def test_both_layouts_convert_alike(jax_model):
    _, scanned, unrolled = jax_model
    a, b = convert_params(scanned), convert_params(unrolled)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert "encoder.blocks.1.conv_module.depthwise_conv.weight" in a


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
@pytest.mark.parametrize("chunk", [-1, CHUNK])
def test_encode_matches_jax(jax_model, feats, layout, chunk):
    mc, scanned, unrolled = jax_model
    params = scanned if layout == "scanned" else unrolled
    jmc = _jax_cfg(scan_layers=layout == "scanned")
    x, lens = feats
    ref, ref_lens = JaxTransducer(jmc).apply(params, x, lens, decoding_chunk_size=chunk,
                                             num_decoding_left_chunks=LEFT, method="encode")
    got, got_lens = _port(jmc, params).encode(torch.from_numpy(x), torch.from_numpy(lens),
                                              chunk, LEFT)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_fused_encode_matches_jax(jax_model, feats):
    """JAX's fused path, Pallas (interpret), vs the port's kernel wrapper
    (plain version on the CPU)."""
    _, params, _ = jax_model
    jmc = _jax_cfg(fused=True)
    x, lens = feats
    ref, _ = JaxTransducer(jmc).apply(params, x, lens, decoding_chunk_size=CHUNK,
                                      num_decoding_left_chunks=LEFT, method="encode")
    got, _ = _port(jmc, params).encode(torch.from_numpy(x), torch.from_numpy(lens),
                                       CHUNK, LEFT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("chunk", [-1, CHUNK])
def test_bf16_encode_matches_jax(jax_model, feats, chunk):
    """compute_dtype bfloat16 on both sides; JAX's fused path, whose scores
    and softmax are fp32 as in the port's kernel and its plain version."""
    _, params, _ = jax_model
    jmc = _jax_cfg(fused=True, dtype="bfloat16")
    x, lens = feats
    ref, _ = JaxTransducer(jmc).apply(params, x, lens, decoding_chunk_size=chunk,
                                      num_decoding_left_chunks=LEFT, method="encode")
    got, _ = _port(jmc, params).encode(torch.from_numpy(x), torch.from_numpy(lens),
                                       chunk, LEFT)
    _close_bf16(got, ref)


def test_bf16_forward_chunk_matches_jax(jax_model, feats):
    """bf16 streaming steps: outputs and the bf16 caches, window by window.
    The JAX cache path scores in bf16, the port's in fp32: within the same
    bf16 tolerance."""
    _, params, _ = jax_model
    jmc = _jax_cfg(dtype="bfloat16")
    jm, port = JaxTransducer(jmc), _port(jmc, params)
    x = feats[0][:1]
    n = num_chunks(x.shape[1], CHUNK, 4, 6)
    windows = chunk_windows(torch.from_numpy(x), CHUNK, 4, 6, n)
    jstate = jm.apply(params, 1, CHUNK, LEFT, method="init_encoder_state")
    pstate = port.init_encoder_state(1, CHUNK, LEFT)
    for i in range(n):
        ry, jstate = jm.apply(params, windows[i].numpy(), jstate, method="encode_chunk")
        gy, pstate = port.encode_chunk(windows[i], pstate)
        _close_bf16(gy, ry)
        for leaf in ("att_k", "att_v", "cnn"):
            _close_bf16(getattr(pstate, leaf), getattr(jstate, leaf))


def test_forward_chunk_matches_jax(jax_model, feats):
    mc, params, _ = jax_model
    jm = JaxTransducer(mc)
    port = _port(mc, params)
    x = feats[0][:1]
    n = num_chunks(x.shape[1], CHUNK, 4, 6)
    jw = np.asarray(jax_chunk_windows(x, CHUNK, 4, 6, n))
    pw = chunk_windows(torch.from_numpy(x), CHUNK, 4, 6, n)
    np.testing.assert_array_equal(pw.numpy(), jw)
    jstate = jm.apply(params, 1, CHUNK, LEFT, method="init_encoder_state")
    pstate = port.init_encoder_state(1, CHUNK, LEFT)
    for i in range(n):
        ry, jstate = jm.apply(params, jw[i], jstate, method="encode_chunk")
        gy, pstate = port.encode_chunk(pw[i], pstate)
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry), rtol=0, atol=ATOL)
        for leaf in ("att_k", "att_v", "cnn"):
            np.testing.assert_allclose(getattr(pstate, leaf).numpy(),
                                       np.asarray(getattr(jstate, leaf)), rtol=0, atol=ATOL)
        assert pstate.offset == int(jstate.offset)


def test_chunked_equals_chunk_masked(jax_model):
    """The streaming path equals the full-context chunk-masked forward
    (tests/test_streaming.py's gate, on the port alone)."""
    mc, params, _ = jax_model
    port = _port(mc, params)
    r = np.random.default_rng(3)
    t = 131  # 8 whole chunks of 4 encoder frames
    x = torch.from_numpy(r.standard_normal((2, t, 80)).astype(np.float32))
    full, full_lens = port.encode(x, torch.tensor([t, t]), CHUNK, LEFT)
    n = num_chunks(t, CHUNK, 4, 6)
    windows = chunk_windows(x, CHUNK, 4, 6, n)
    state = port.init_encoder_state(2, CHUNK, LEFT)
    outs = []
    for i in range(n):
        y, state = port.encode_chunk(windows[i], state)
        outs.append(y)
    ys = torch.cat(outs, dim=1)
    usable = min(int(full_lens[0]), n * CHUNK)
    np.testing.assert_allclose(ys[:, :usable].numpy(), full[:, :usable].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert state.offset == n * CHUNK
