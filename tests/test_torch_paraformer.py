"""The Paraformer's modules, decoders and converter == JAX on the CPU.

Tiny models as tests/test_paraformer.py and tests/test_sanm.py build them
(d32, 2 heads, 2 encoder and 2 decoder blocks, FFN 64, vocab 24, max 8
tokens, no dropout; the SANM stack at LFR 3/2 and FSMN kernel 5 over 80
features), with the port's seeded weights written into the flax layout
through the converter's own index map (`flax_variables`), so JAX compiles
no init. The CIF head's bias is set to -1 so the counts (about a quarter of
the encoder frames) stay under max_tokens and the floors are exercised.

- `lfr` at (7, 6), (5, 4) and (1, 1) against JAX and the independent
  per-sequence reference of tests/test_sanm.py: exact;
- every flax leaf of both stacks (with the CTC and timestamp branches)
  converts once and lands on one port parameter, the timestamp branch's
  `ConvTranspose` kernel flipped;
- the SANM encoder and decoder forwards: atol 1e-5 (fp32 sums in another
  order);
- `cif_fire`, `cif_peaks` and `quantity_loss` on the boundary cases of
  tests/test_paraformer.py and on random weights (peaks also against the
  reference's sequential integrate / fire / subtract loop): embeddings
  atol 1e-5 (XLA's cumsum adds in another order, so a share moves by
  rounding), peaks exact;
- `CifPredictor` on its training (teacher-forced) and inference (tail
  frame) paths: embeddings atol 1e-5, counts rtol 1e-6, weights atol 1e-6;
- `TimestampPredictor`: atol 1e-6, and the unflipped kernel gives other
  weights (the check catches a missing flip);
- `nar_beam_search` on random logits with a finished row (length 0) and
  `cif_timestamps_from_peaks` on tests/test_longtail.py's cases: tokens
  identical, scores within 1e-5;
- `greedy_decode`, `greedy_decode_with_times` and `beam_decode` (beam 4) of
  both stacks: tokens, counts and peak frames identical, n-best tokens
  identical, scores within 1e-5 relative (sums of eight log-probs near -10,
  each from logits that differ by fp32 rounding).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sanm import lfr_reference
from tests.test_torch_zoo import flax_variables
from tpuasr.config import EncoderConfig as JaxEncoderConfig
from tpuasr.config import to_dict as jax_to_dict
from tpuasr.decode import paraformer_beam as jax_beam
from tpuasr.models import paraformer as jax_para
from tpuasr.nn import cif as jax_cif
from tpuasr.nn import sanm as jax_sanm
from tpuasr_torch.config import EncoderConfig, from_dict
from tpuasr_torch.convert import _convert_leaf, convert_params
from tpuasr_torch.decode import paraformer_beam
from tpuasr_torch.models import Paraformer, ParaformerConfig, init_weights
from tpuasr_torch.nn import cif, sanm

torch.set_num_threads(1)  # six test workers share the cores

V, MAX_TOKENS, CIF_BIAS = 24, 8, -1.0
ENC = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
           cnn_module_kernel=7, dropout_rate=0.0, positional_dropout_rate=0.0)
STACKS = {"conformer": {}, "sanm": dict(encoder_type="sanm", lfr_m=3, lfr_n=2, sanm_kernel=5)}


def jax_cfg(stack: str, **kw) -> jax_para.ParaformerConfig:
    return jax_para.ParaformerConfig(
        vocab_size=V, encoder=JaxEncoderConfig(**ENC), decoder_blocks=2, decoder_heads=2,
        decoder_ffn=64, max_tokens=MAX_TOKENS, cif_dropout=0.0, **STACKS[stack], **kw)


def port_cfg(jc: jax_para.ParaformerConfig) -> ParaformerConfig:
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name != "encoder"}
    return ParaformerConfig(**kw, encoder=from_dict(EncoderConfig, jax_to_dict(jc.encoder)))


def batch():
    """2 utterances (67 and 50 frames, the short one zero-padded), 5 and 3
    labels."""
    r = np.random.default_rng(7)
    feats = r.standard_normal((2, 67, 80)).astype(np.float32)
    feats[1, 50:] = 0.0
    texts = r.integers(6, V, (2, 5)).astype(np.int32)
    return feats, np.array([67, 50], np.int32), texts, np.array([5, 3], np.int32)


def build(jc, seed: int = 3):
    """(JAX model, flax variables, port model): the port's seeded weights,
    the CIF head's bias at CIF_BIAS, in both."""
    port = init_weights(Paraformer(port_cfg(jc), device="cpu"), seed)
    with torch.no_grad():
        port.predictor.cif_output.bias.fill_(CIF_BIAS)
    jm = jax_para.Paraformer(jc)
    return jm, flax_variables(jm, port, *batch()), port


def tiny(stack: str = "conformer", **kw):
    """A tiny port Paraformer of `stack` (seeded, the CIF bias at CIF_BIAS)
    and its config, for the decode-mode checks of other test files."""
    port = init_weights(Paraformer(port_cfg(jax_cfg(stack, **kw)), device="cpu"), 3)
    with torch.no_grad():
        port.predictor.cif_output.bias.fill_(CIF_BIAS)
    return port


@pytest.fixture(scope="module", params=list(STACKS))
def para(request):
    jc = jax_cfg(request.param, ctc_weight=0.3, timestamp_branch=True)
    return (jc, *build(jc))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("m,n", [(7, 6), (5, 4), (1, 1)])
def test_lfr_matches_jax_and_reference(m, n):
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 29, 4)).astype(np.float32)
    lens = np.array([29, 17, 5], np.int32)
    want, want_lens = jax.jit(jax_sanm.lfr, static_argnums=(2, 3))(x, lens, m, n)
    got, got_lens = sanm.lfr(*_t(x, lens), m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for i in range(3):
        ref = lfr_reference(x[i], int(lens[i]), m, n)
        assert int(got_lens[i]) == ref.shape[0]
        np.testing.assert_array_equal(got[i, : ref.shape[0]].numpy(), ref)


def test_every_flax_leaf_converts_once(para):
    jc, _, variables, port = para
    tree = variables["params"]
    keys = [_convert_leaf(tuple(p.key for p in path), x)[0]
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    sd = port.state_dict()
    assert len(keys) == len(set(keys)) and set(keys) == set(sd)
    got = convert_params({"params": tree})
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    kernel = tree["tp"]["tp_upsample_cnn"]["kernel"]  # [K, in, out]
    np.testing.assert_array_equal(sd["tp.tp_upsample_cnn.weight"].numpy(),
                                  kernel[::-1].transpose(1, 2, 0))
    assert ("encoder.layers.1.self_attn.fsmn.fsmn_block.weight" in sd) == \
        (jc.encoder_type == "sanm")


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_sanm_encoder_and_decoder_match_jax(part):
    r = np.random.default_rng(3)
    if part == "encoder":
        jm = jax_sanm.SanmEncoder(input_size=24, output_size=16, attention_heads=2,
                                  linear_units=32, num_blocks=3, kernel_size=5, sanm_shift=1,
                                  dropout_rate=0.0)
        port = init_weights(sanm.SanmEncoder(24, 16, 2, 32, 3, 5, 1, 0.0, device="cpu"), 4)
        args = (r.standard_normal((2, 12, 24)).astype(np.float32), np.array([12, 7], np.int32))
        want, want_mask = jm.apply(flax_variables(jm, port, *args), *args)
        got, got_mask = port(*_t(*args))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        valid = np.asarray(want_mask)
    else:
        jm = jax_sanm.SanmDecoder(vocab_size=11, n_feat=16, attention_heads=2, linear_units=32,
                                  num_blocks=2, kernel_size=5, dropout_rate=0.0)
        port = init_weights(sanm.SanmDecoder(11, 16, 2, 32, 2, 5, 0, 0.0, device="cpu"), 4)
        args = (r.standard_normal((2, 9, 16)).astype(np.float32), np.array([9, 6], np.int32),
                r.standard_normal((2, 5, 16)).astype(np.float32), np.array([5, 3], np.int32))
        want = jm.apply(flax_variables(jm, port, *args), *args)
        got = port(*_t(*args))
        valid = np.arange(5)[None, :] < args[3][:, None]
        assert port.norm3_tail.eps == port.layers[0].norm1.eps == 1e-12
        assert port.after_norm.eps == port.decoders3.norm.eps == 1e-6
    np.testing.assert_allclose(got.detach().numpy()[valid], np.asarray(want)[valid], rtol=0,
                               atol=1e-5)


def _sequential_peaks(alpha):
    """The reference's integrate / fire / subtract loop."""
    fires = np.zeros_like(alpha)
    for b in range(alpha.shape[0]):
        integrate = 0.0
        for t in range(alpha.shape[1]):
            integrate += alpha[b, t]
            if integrate >= 1.0:
                fires[b, t] = 1.0
                integrate -= 1.0
    return fires


@pytest.mark.parametrize("case", ["uniform", "boundary", "random"])
def test_cif_functions_match_jax(case):
    r = np.random.default_rng(1)
    if case == "uniform":  # each token integrates exactly two frames
        hidden = np.broadcast_to(np.arange(8, dtype=np.float32)[None, :, None], (1, 8, 4)).copy()
        alpha, k = np.full((1, 8), 0.5, np.float32), 4
    elif case == "boundary":  # a frame whose span crosses a boundary splits its weight
        hidden, alpha, k = np.ones((1, 3, 2), np.float32), np.array([[0.6, 0.6, 0.8]],
                                                                    np.float32), 2
    else:  # more mass than max_tokens: the overflow is dropped
        hidden = r.standard_normal((3, 40, 6)).astype(np.float32)
        alpha, k = r.uniform(0, 1, (3, 40)).astype(np.float32), 12
    want = np.asarray(jax_cif.cif_fire(jnp.asarray(hidden), jnp.asarray(alpha), k))
    got = cif.cif_fire(*_t(hidden, alpha), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == "uniform":
        np.testing.assert_allclose(got[0, :, 0], [0.5, 2.5, 4.5, 6.5], rtol=1e-6)
    if case == "boundary":
        np.testing.assert_allclose(got[0], 1.0, rtol=1e-6)
    peaks = cif.cif_peaks(*_t(alpha)).numpy()
    np.testing.assert_array_equal(peaks, np.asarray(jax_cif.cif_peaks(jnp.asarray(alpha))))
    if case == "random":
        np.testing.assert_array_equal(peaks, _sequential_peaks(alpha))
    counts, lens = alpha.sum(1) + 0.3, np.full(alpha.shape[0], k, np.int32)
    np.testing.assert_allclose(float(cif.quantity_loss(*_t(counts, lens))),
                               float(jax_cif.quantity_loss(jnp.asarray(counts), lens)), rtol=1e-6)
    np.testing.assert_allclose(float(cif.quantity_loss(*_t(np.array([3.0, 5.0]),
                                                          np.array([4, 5])))), 1.0 / 9.0,
                               rtol=1e-6)


@pytest.mark.parametrize("path", ["train", "tail"])
def test_cif_predictor_matches_jax(path):
    r = np.random.default_rng(2)
    hidden = r.standard_normal((3, 17, 16)).astype(np.float32)
    mask = np.arange(17)[None, :] < np.array([17, 11, 4])[:, None]
    jm = jax_cif.CifPredictor(16, dropout_rate=0.0)
    port = init_weights(cif.CifPredictor(16, dropout_rate=0.0, device="cpu"), 5)
    targets = np.array([6, 3, 1], np.int32) if path == "train" else None
    # the token count is static: the template's init takes it bound
    init = SimpleNamespace(init=lambda key, h, m: jm.init(key, h, m, MAX_TOKENS))
    variables = flax_variables(init, port, hidden, mask)
    want = jm.apply(variables, hidden, mask, MAX_TOKENS, target_lens=targets)
    got = port(*_t(hidden, mask), MAX_TOKENS,
               target_lens=None if targets is None else _t(targets)[0])
    for g, w, tol in zip(got, want, (1e-5, 0.0, 1e-6)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=tol)
    if path == "tail":
        assert got[2].shape == (3, 18)  # the tail frame


def test_timestamp_predictor_matches_jax():
    r = np.random.default_rng(4)
    hidden = r.standard_normal((2, 9, 8)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([9, 6])[:, None]
    jm = jax_cif.TimestampPredictor(8)
    port = init_weights(cif.TimestampPredictor(8, device="cpu"), 6)
    want = np.asarray(jm.apply(flax_variables(jm, port, hidden, mask), hidden, mask))
    got = port(*_t(hidden, mask)).detach().numpy()
    assert got.shape == (2, 27)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert float(np.abs(got).max()) > 0.01
    with torch.no_grad():  # without the converter's flip the taps run the other way
        port.tp_upsample_cnn.weight.copy_(port.tp_upsample_cnn.weight.flip(2))
        assert float(np.abs(port(*_t(hidden, mask)).numpy() - want).max()) > 1e-3


def test_nar_beam_search_and_timestamps_match_jax():
    r = np.random.default_rng(5)
    logits = r.standard_normal((3, 7, 13)).astype(np.float32)
    lens = np.array([7, 4, 0], np.int32)
    want_t, want_s = jax.jit(jax_beam.nar_beam_search, static_argnums=(2, 3))(logits, lens, 4, 3)
    got_t, got_s = paraformer_beam.nar_beam_search(*_t(logits, lens), 4, 3)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)
    greedy = logits.argmax(-1)
    for b in range(2):
        np.testing.assert_array_equal(got_t[b, 0, : lens[b]].numpy(), greedy[b, : lens[b]])
    assert (got_t[2, 0] == 3).all() and float(got_s[2, 0]) == 0.0  # a finished row: eos
    for peaks, frames in (([5, 10, 20], 24), ([5, 10], 40), ([2, 30, 40], 41), ([7], 9), ([], 5)):
        assert paraformer_beam.cif_timestamps_from_peaks(peaks, frames) == \
            jax_beam.cif_timestamps_from_peaks(peaks, frames)


def test_decode_matches_jax(para):
    jc, jm, variables, port = para
    feats, feat_lens = batch()[:2]
    x = _t(feats, feat_lens)
    want = jm.apply(variables, feats, feat_lens, method="greedy_decode_with_times")
    got = port.greedy_decode_with_times(*x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[1].min()) and int(got[1].max()) < MAX_TOKENS  # the counts are floors
    for g, w in zip(port.greedy_decode(*x), jm.apply(variables, feats, feat_lens,
                                                     method="greedy_decode")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_t, want_s, want_l = jm.apply(variables, feats, feat_lens, 4, method="beam_decode")
    got_t, got_s, got_l = port.beam_decode(*x, beam_size=4)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=0)
    valid = np.arange(MAX_TOKENS) < got_l.numpy()[:, None]
    np.testing.assert_array_equal(got_t[:, 0].numpy() * valid, got[0].numpy())  # top 1: greedy
