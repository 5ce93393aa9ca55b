"""The port's serving export: loaded `torch.export` artifacts == the JAX
package's live functions and the port's eager decode on the CPU, at every
chunk index.

`tests/test_streaming.py`'s causal model (2 blocks, d32, chunk 4, 2 left
chunks, vocab 20, blank 5) with seeded port weights written into the flax
layout (`tests/test_torch_zoo.build`), the blank logit raised so that the
streams emit at some frames and not at others. Two streams of 150 and 117
feature frames give 9 chunks (LEFT + 7), so the offset passes the
attention cache's capacity and the shorter stream's decode gate closes
before the end. Every JAX function is jitted; `jax.export` is never called.

- the manifest names the four functions, with their files and device;
- a loaded `encoder_chunk` chained over every chunk: outputs within atol
  1e-5 of the JAX package's `encode_chunk` (fp32 sums in another order),
  the offsets equal;
- a loaded `process_chunk` (`n_steps` 3, 20 tokens) chained the same way:
  `hyp` and `hyp_len` identical to the JAX package's `process_chunk` and to
  the port's eager `streaming_greedy_decode`;
- `predictor_step` and `joint_step` on seeded inputs: within atol 1e-5 of
  JAX;
- with `encoder.fused_ffn=True` the exported `encoder_chunk` and
  `process_chunk` graphs hold kernel #10's registered operator, and the
  loaded artifacts give the eager fused model's outputs and tokens;
- a family encoder raises;
- `tpuasr_torch.tools.export_stream.main` with `--device cpu --verify`.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_streaming import BLANK, CHUNK, LEFT, causal_cfg
from tests.test_torch_zoo import build
from tpuasr.decode import rnnt_streaming as jax_streaming
from tpuasr_torch.config import Config, StreamingConfig
from tpuasr_torch.decode import streaming_greedy_decode
from tpuasr_torch.decode.rnnt_streaming import init_streaming_state
from tpuasr_torch.export import export_streaming, load_exported
from tpuasr_torch.models import Transducer, init_weights, stream_output_len
from tpuasr_torch.streaming import chunk_windows, num_chunks
from tpuasr_torch.tools import export_stream

torch.set_num_threads(1)  # six test workers share the cores

N_STEPS, MAX_TOKENS, BATCH, BLANK_BIAS = 3, 20, 2, 2.0
FUNCTIONS = {"encoder_chunk", "predictor_step", "joint_step", "process_chunk"}


def feats():
    r = np.random.default_rng(11)
    lens = np.array([150, 117], np.int32)
    x = (r.standard_normal((BATCH, 150, 80)) * 0.5).astype(np.float32)
    x[np.arange(150)[None, :] >= lens[:, None]] = 0.0
    return x, lens


def windows(x):
    """[n, B, window, 80] chunk windows of the features."""
    n = num_chunks(x.shape[1], CHUNK, 4, 6)
    assert n >= LEFT + 3  # the offset passes the cache capacity
    return chunk_windows(torch.from_numpy(x), CHUNK, 4, 6, n)


def stream_cfg(model_cfg) -> Config:
    cfg = Config()
    cfg.model = model_cfg
    cfg.streaming = StreamingConfig(chunk_size=CHUNK, num_left_chunks=LEFT, n_steps=N_STEPS)
    return cfg


def export_and_load(port, out_dir):
    manifest = export_streaming(port, stream_cfg(port.cfg), str(out_dir), batch=BATCH,
                                max_tokens=MAX_TOKENS)
    return manifest, load_exported(str(out_dir))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX model, flax variables, port model, manifest, loaded functions)."""
    jm, variables, port = build(causal_cfg(), seed=5, blank_bias=BLANK_BIAS)
    out = tmp_path_factory.mktemp("export")
    return (jm, variables, port, *export_and_load(port, out), out)


def test_manifest(exported):
    manifest, out = exported[3], exported[5]
    assert set(manifest["functions"]) == FUNCTIONS
    assert (manifest["batch"], manifest["chunk_size"], manifest["num_left_chunks"],
            manifest["window"]) == (BATCH, CHUNK, LEFT, (CHUNK - 1) * 4 + 7)
    assert json.load(open(out / "manifest.json")) == manifest
    for info in manifest["functions"].values():
        assert info["platforms"] == ["cpu"] and os.path.getsize(out / info["file"]) > 0


def test_encoder_chunk_artifact_matches_jax_at_every_chunk(exported):
    jm, variables, port, _, fns, _ = exported
    encode = jax.jit(lambda v, w, s: jm.apply(v, w, s, method="encode_chunk"))
    jstate = jm.apply(variables, BATCH, CHUNK, LEFT, method="init_encoder_state")
    pstate = port.init_encoder_state(BATCH, CHUNK, LEFT)
    for i, w in enumerate(windows(feats()[0])):
        want, jstate = encode(variables, w.numpy(), jstate)
        got, pstate = fns["encoder_chunk"](w, pstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=f"chunk {i}")
        assert int(pstate.offset) == int(jstate.offset) == (i + 1) * CHUNK
        np.testing.assert_allclose(pstate.att_k.numpy(), np.asarray(jstate.att_k), rtol=0,
                                   atol=1e-5, err_msg=f"chunk {i}")


def _chained(fns, port, x, lens):
    state = init_streaming_state(port, BATCH, CHUNK, LEFT, BLANK, MAX_TOKENS,
                                 stream_output_len(port.cfg.encoder, torch.from_numpy(lens)))
    for w in windows(x):
        state = fns["process_chunk"](w, state)
    return state


def test_process_chunk_artifact_matches_jax_and_eager(exported):
    jm, variables, port, _, fns, _ = exported
    x, lens = feats()
    got = _chained(fns, port, x, lens)
    step = jax.jit(lambda v, w, s: jax_streaming.process_chunk(jm, v, w, s, BLANK, N_STEPS))
    enc_lens = np.asarray(stream_output_len(port.cfg.encoder, torch.from_numpy(lens)))
    ref = jax_streaming.init_streaming_state(jm, variables, BATCH, CHUNK, LEFT, BLANK,
                                             MAX_TOKENS, enc_lens)
    for w in windows(x):
        ref = step(variables, w.numpy(), ref)
    np.testing.assert_array_equal(got.dec.hyp.numpy(), np.asarray(ref.dec.hyp))
    np.testing.assert_array_equal(got.dec.hyp_len.numpy(), np.asarray(ref.dec.hyp_len))
    eager_t, eager_l, _ = streaming_greedy_decode(port, torch.from_numpy(x),
                                                  torch.from_numpy(lens), CHUNK, LEFT, BLANK,
                                                  N_STEPS, MAX_TOKENS)
    assert torch.equal(got.dec.hyp[:, :MAX_TOKENS], eager_t)
    assert torch.equal(got.dec.hyp_len, eager_l)
    n = got.dec.hyp_len.numpy()
    assert n.min() > 0 and n.max() < MAX_TOKENS  # emits, and not at every step


def test_predictor_and_joint_artifacts_match_jax(exported):
    jm, variables, port, _, fns, _ = exported
    r = np.random.default_rng(12)
    toks = r.integers(0, 20, BATCH)
    h = (r.standard_normal((2, 1, BATCH, 16)) * 0.5).astype(np.float32)
    out, (nh, nc) = fns["predictor_step"](torch.from_numpy(toks),
                                          (torch.from_numpy(h[0]), torch.from_numpy(h[1])))
    want, (wh, wc) = jm.apply(variables, toks.astype(np.int32), (h[0], h[1]), None,
                              method="predict_step")
    for g, w in ((out, want), (nh, wh), (nc, wc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    e = r.standard_normal((BATCH, 32)).astype(np.float32)
    p = r.standard_normal((BATCH, 32)).astype(np.float32)
    np.testing.assert_allclose(fns["joint_step"](torch.from_numpy(e), torch.from_numpy(p)),
                               np.asarray(jm.apply(variables, e, p, method="joint_step")),
                               rtol=0, atol=1e-5)


def test_fused_ffn_artifacts_hold_kernel_10(exported, tmp_path):
    port = exported[2]
    cfg = dataclasses.replace(port.cfg, encoder=dataclasses.replace(port.cfg.encoder,
                                                                    fused_ffn=True))
    fused = Transducer(cfg, device="cpu")
    fused.load_state_dict(port.state_dict())
    manifest, fns = export_and_load(fused, tmp_path)
    for name in ("encoder_chunk", "process_chunk"):
        graph = torch.export.load(str(tmp_path / manifest["functions"][name]["file"])).graph
        ops = [n.target for n in graph.nodes if n.op == "call_function"]
        # two FFN branches (macaron and final) in each of the 2 blocks
        assert ops.count(torch.ops.tpuasr.ffn_fwd.default) == 4, name
    x, lens = feats()
    state = fused.init_encoder_state(BATCH, CHUNK, LEFT)
    eager = fused.init_encoder_state(BATCH, CHUNK, LEFT)
    for w in windows(x):
        got, state = fns["encoder_chunk"](w, state)
        want, eager = fused.encode_chunk(w, eager)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    got = _chained(fns, fused, x, lens)
    eager_t, eager_l, _ = streaming_greedy_decode(fused, torch.from_numpy(x),
                                                  torch.from_numpy(lens), CHUNK, LEFT, BLANK,
                                                  N_STEPS, MAX_TOKENS)
    assert torch.equal(got.dec.hyp[:, :MAX_TOKENS], eager_t)
    assert torch.equal(got.dec.hyp_len, eager_l)


def test_family_encoder_raises(tmp_path):
    cfg = Config()
    e = cfg.model.encoder
    e.encoder_type, e.output_size, e.attention_heads, e.linear_units = \
        "squeezeformer", 32, 2, 64
    e.num_blocks, e.cnn_module_kernel, e.causal = 2, 7, True
    model = init_weights(Transducer(cfg.model, device="cpu"), 0)
    with pytest.raises(ValueError, match="squeezeformer"):
        export_streaming(model, cfg, str(tmp_path))
    assert not os.listdir(tmp_path)


def test_export_stream_cli(tmp_path, capsys):
    out = tmp_path / "artifacts"
    manifest = export_stream.main([
        "--out", str(out), "--verify", "--max_tokens", "8", "--device", "cpu", "--set",
        "model.encoder.num_blocks=1", "model.encoder.output_size=32",
        "model.encoder.attention_heads=2", "model.encoder.linear_units=64",
        "model.encoder.cnn_module_kernel=3", "model.encoder.static_chunk_size=4",
        "streaming.chunk_size=4", "streaming.n_steps=2", "model.predictor.embed_size=16",
        "model.predictor.hidden_size=16", "model.predictor.output_size=32"])
    assert "verify: process_chunk artifact executed one chunk ok" in capsys.readouterr().out
    assert set(manifest["functions"]) == FUNCTIONS
    assert json.load(open(out / "manifest.json")) == manifest
    for info in manifest["functions"].values():
        assert os.path.getsize(out / info["file"]) > 0
