"""Port greedy decoding == JAX on the CPU, token for token.

Offline `rnnt_greedy_decode` (fed the JAX encoder's own output, and end to
end), `streaming_greedy_decode`, and `make_offline_decoder` from waves, on
converted weights of the tiny flagship (2 blocks, d32, vocab 64, blank 5,
16 kHz). Tokens and lengths must be identical. Plus the streaming gate of
tests/test_streaming.py on the port: streaming decode == offline greedy over
the chunk-masked full-context encoder. The Paraformer's greedy mode of
`make_offline_decoder`, refused before it was ported, decodes the same
waves to the model's own greedy hypotheses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tests.test_torch_paraformer import tiny as tiny_paraformer
from tpuasr.config import to_dict
from tpuasr.decode.rnnt_greedy import rnnt_greedy_decode as jax_greedy
from tpuasr.decode.rnnt_streaming import streaming_greedy_decode as jax_streaming
from tpuasr.eval.cer_eval import make_offline_decoder as jax_offline_decoder
from tpuasr.models import Transducer as JaxTransducer
from tpuasr_torch.audio import fbank_batch
from tpuasr_torch.config import Config, ModelConfig, from_dict
from tpuasr_torch.convert import load_jax_params
from tpuasr_torch.decode import rnnt_greedy_decode, streaming_greedy_decode
from tpuasr_torch.eval import make_offline_decoder
from tpuasr_torch.models import Transducer
from tpuasr_torch.streaming import num_chunks

BLANK, CHUNK, LEFT, N_STEPS, MAX_TOKENS = 5, 4, 2, 4, 50


@pytest.fixture(scope="module")
def models():
    cfg = _flagship_config(tiny=True)
    jm = JaxTransducer(cfg.model)
    b, t = 2, 131
    params = jm.init(jax.random.PRNGKey(0), np.zeros((b, t, 80), np.float32),
                     np.full((b,), t, np.int32), np.zeros((b, 5), np.int32),
                     np.full((b,), 5, np.int32))
    params = jax.tree.map(np.asarray, params)
    pcfg = from_dict(Config, to_dict(cfg))
    port = load_jax_params(Transducer(pcfg.model, device="cpu"), params)
    return cfg, jm, params, pcfg, port


@pytest.fixture(scope="module")
def feats():
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 131, 80)) * 0.5).astype(np.float32)
    return x, np.array([131, 99], np.int32)


def _same(got, ref):
    got_t, got_l = got
    ref_t, ref_l = ref
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))


def test_predictor_joint_ctc_match_jax(models, feats):
    """The sequence predictor, the full [B, T, U, V] joint, one joint step and the CTC head
    on converted weights (fp32, atol 1e-5)."""
    _, jm, params, _, port = models
    enc = feats[0][:, :9, :32] * 0.3  # stand-in encoder frames, D = 32
    tokens = np.array([[5, 7, 9, 11], [5, 60, 2, 0]], np.int32)
    pred = jm.apply(params, tokens, method="predict")
    logits = jm.apply(params, enc, pred, method="joint_full")
    ctc = jm.apply(params, enc, method="ctc_logits")
    step = jm.apply(params, enc[:, 3], pred[:, 2], method="joint_step")
    with torch.no_grad():
        g_pred = port.predictor(torch.from_numpy(tokens).long())
        g_logits = port.joint(torch.from_numpy(enc), g_pred)
    g_ctc = port.ctc_logits(torch.from_numpy(enc))
    g_step = port.joint_step(torch.from_numpy(enc[:, 3]), g_pred[:, 2])
    for got, ref in ((g_pred, pred), (g_logits, logits), (g_ctc, ctc), (g_step, step)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_bf16_predictor_joint_match_jax(models, feats):
    """compute_dtype bfloat16 on both sides: the sequence predictor, one
    predictor step and its state, the full joint and one joint step, fed
    bf16 encoder frames as `encode` gives them. Max abs error 2**-4 and mean
    2**-7, as for the bf16 encoder (tests/test_torch_encoder.py): bf16
    products whose outputs are rounded at slightly different points."""
    cfg, _, params, _, _ = models
    mc = dataclasses.replace(cfg.model, compute_dtype="bfloat16")
    jm = JaxTransducer(mc)
    port = load_jax_params(Transducer(from_dict(ModelConfig, to_dict(mc)), device="cpu"),
                           params)
    enc = (feats[0][:, :9, :32] * 0.3).astype(jnp.bfloat16)  # stand-in frames, D = 32
    tokens = np.array([[5, 7, 9, 11], [5, 60, 2, 0]], np.int32)
    pred = jm.apply(params, tokens, method="predict")
    state = jm.apply(params, 2, method="init_predictor_state")
    pred_step, state = jm.apply(params, tokens[:, 1], state, method="predict_step")
    refs = (pred, jm.apply(params, enc, pred, method="joint_full"),
            jm.apply(params, enc[:, 3], pred[:, 2], method="joint_step"), pred_step, *state)
    g_enc = torch.from_numpy(enc.astype(np.float32)).bfloat16()
    with torch.no_grad():
        g_pred = port.predictor(torch.from_numpy(tokens).long())
        g_logits = port.joint(g_enc, g_pred)
    g_pstep, g_state = port.predict_step(torch.from_numpy(tokens[:, 1]).long(),
                                         port.init_predictor_state(2))
    gots = (g_pred, g_logits, port.joint_step(g_enc[:, 3], g_pred[:, 2]), g_pstep, *g_state)
    for got, ref in zip(gots, refs, strict=True):
        assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
        err = np.abs(got.float().numpy() - np.asarray(ref).astype(np.float32))
        assert err.max() <= 2.0 ** -4 and err.mean() <= 2.0 ** -7, (err.max(), err.mean())


def test_greedy_on_jax_encoder_output(models, feats):
    _, jm, params, _, port = models
    x, lens = feats
    enc, enc_lens = jm.apply(params, x, lens, method="encode")
    ref = jax_greedy(jm, params, enc, enc_lens, BLANK, N_STEPS, MAX_TOKENS)
    got = rnnt_greedy_decode(port, torch.from_numpy(np.array(enc)),
                             torch.from_numpy(np.array(enc_lens)), BLANK, N_STEPS,
                             MAX_TOKENS)
    _same(got, ref)
    assert int(got[1].max()) > 0  # the random model emits


def test_greedy_end_to_end(models, feats):
    _, jm, params, _, port = models
    x, lens = feats
    enc, enc_lens = jm.apply(params, x, lens, decoding_chunk_size=CHUNK,
                             num_decoding_left_chunks=LEFT, method="encode")
    ref = jax_greedy(jm, params, enc, enc_lens, BLANK, N_STEPS, MAX_TOKENS)
    penc, plens = port.encode(torch.from_numpy(x), torch.from_numpy(lens), CHUNK, LEFT)
    _same(rnnt_greedy_decode(port, penc, plens, BLANK, N_STEPS, MAX_TOKENS), ref)


def test_streaming_matches_jax(models, feats):
    _, jm, params, _, port = models
    x, lens = feats
    ref_t, ref_l, _ = jax_streaming(jm, params, x, lens, CHUNK, LEFT, BLANK, N_STEPS,
                                    MAX_TOKENS)
    got_t, got_l, _ = streaming_greedy_decode(port, torch.from_numpy(x),
                                              torch.from_numpy(lens), CHUNK, LEFT, BLANK,
                                              N_STEPS, MAX_TOKENS)
    _same((got_t, got_l), (ref_t, ref_l))


def test_streaming_equals_offline_chunk_masked(models, feats):
    """Streaming decode == offline greedy over the chunk-masked full-context
    encoder output, with the offline lengths capped to what streaming sees."""
    _, _, _, _, port = models
    x, lens = feats
    full, full_lens = port.encode(torch.from_numpy(x), torch.from_numpy(lens), CHUNK, LEFT)
    n = num_chunks(x.shape[1], CHUNK, 4, 6)
    capped = torch.clamp(full_lens.long(), max=n * CHUNK)
    off = rnnt_greedy_decode(port, full, capped, BLANK, N_STEPS, MAX_TOKENS)
    st_t, st_l, _ = streaming_greedy_decode(port, torch.from_numpy(x), capped * 4 + 3,
                                            CHUNK, LEFT, BLANK, N_STEPS, MAX_TOKENS)
    assert torch.equal(st_l, off[1])
    assert torch.equal(st_t, off[0])


def test_offline_decoder_from_waves_matches_jax(models):
    cfg, jm, params, pcfg, port = models
    r = np.random.default_rng(1)
    waves = (r.standard_normal((2, 12000)) * 0.1).astype(np.float32)
    wave_lens = np.array([12000, 9000], np.int32)
    cfg.feature.use_pallas = False
    ref = jax_offline_decoder(jm, cfg, "rnnt_greedy", n_steps=N_STEPS,
                              max_tokens=MAX_TOKENS)(params, waves, wave_lens)
    got = make_offline_decoder(port, pcfg, "rnnt_greedy", n_steps=N_STEPS,
                               max_tokens=MAX_TOKENS)(waves, wave_lens)
    _same(got, ref)
    # the Paraformer's greedy mode, once refused, decodes the same waves
    para = tiny_paraformer("sanm")
    toks, lens = make_offline_decoder(para, pcfg, "paraformer_greedy")(waves, wave_lens)
    want = para.greedy_decode(*fbank_batch(waves, wave_lens, pcfg.feature, device="cpu"))
    assert torch.equal(toks, want[0]) and torch.equal(lens, want[1]) and int(lens.max()) > 0
