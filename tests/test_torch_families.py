"""The port's encoder families (squeezeformer, efficient conformer) == JAX on
the CPU, on the same weights.

At the JAX family tests' size (tests/test_streaming_families.py: 4 blocks,
d32, 2 heads, FFN 64, conv 7, vocab 20, blank 5), the port's seeded weights
written into the flax layout through the converter's own index map
(`tests.test_torch_zoo.flax_variables`, so no JAX init is compiled), fp32:

- `encode`, full context and chunk-masked (chunk 4 and 5, 2 left chunks: 5
  is a multiple of neither group size, so the grouped mask's first-frame
  rule and the padded groups are exercised), each family with and without
  its reduce/recover or stride pair, group sizes 2 and 3, the non-causal
  squeezeformer with its look-ahead "conv" time reduction: outputs atol
  1e-5, lengths identical.
- `forward_chunk` over a whole utterance, chunk by chunk: outputs, every
  layer's K/V and conv caches (their shapes per rate) atol 1e-5, the offset.
- The cached stream against the port's own chunk-masked full forward over
  the frames whole chunks cover (3e-4, as the JAX test), also with no left
  chunks (empty caches); the state shapes of the JAX test; a misaligned
  efficient-conformer chunk, an odd squeezeformer chunk and a non-causal
  stream refused.
- `chunked_prefix_encode` against JAX's (2e-3, as tests/test_prefix_
  recompute.py) and against the port's full forward; the non-causal
  squeezeformer transducer streamed by prefix recomputation.
- Greedy and beam decoding offline and streaming: tokens and lengths
  identical to JAX (the efficient conformer's streamed frames indexed at
  offset // 2); the RTF's first-emission loop gates at the output rate.
- `position_encoding` at a stride, near `max_len` (the rebase).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import BLANK, batch, build, flax_variables, jax_cfg
from tpuasr.decode import rnnt_beam as jax_beam
from tpuasr.decode.rnnt_greedy import rnnt_greedy_decode as jax_greedy
from tpuasr.decode.rnnt_streaming import streaming_beam_decode as jax_streaming_beam
from tpuasr.decode.rnnt_streaming import streaming_greedy_decode as jax_streaming_greedy
from tpuasr.nn import squeezeformer as jax_sq
from tpuasr.nn.embedding import PositionalEncodingTable as JaxPE
from tpuasr.streaming.chunkwise import chunk_windows as jax_chunk_windows
from tpuasr.streaming.prefix_recompute import chunked_prefix_encode as jax_prefix_encode
from tpuasr_torch.config import Config, EncoderConfig
from tpuasr_torch.decode import rnnt_beam_decode, rnnt_greedy_decode, streaming_greedy_decode
from tpuasr_torch.decode.rnnt_streaming import streaming_beam_decode
from tpuasr_torch.eval.rtf import first_emissions
from tpuasr_torch.models import init_weights
from tpuasr_torch.models.transducer import stream_output_factor, stream_output_len
from tpuasr_torch.nn import squeezeformer as port_sq
from tpuasr_torch.nn.embedding import PositionalEncodingTable
from tpuasr_torch.streaming import chunk_windows, chunked_prefix_encode, num_chunks

torch.set_num_threads(1)  # six test workers share the cores

ATOL, STREAM_TOL, PREFIX_TOL = 1e-5, 3e-4, 2e-3

SQ = dict(encoder_type="squeezeformer", attention_heads=2, num_blocks=4, use_dynamic_chunk=True,
          static_chunk_size=4, reduce_idx=(1,), recover_idx=(3,), time_reduction_type="stream")
EC = dict(encoder_type="efficient_conformer", attention_heads=2, num_blocks=4,
          use_dynamic_chunk=True, static_chunk_size=8, stride_layer_idx=(1,), group_size=2)
FAMILIES = {
    "sq": SQ,
    "sq_no_reduce": dict(SQ, reduce_idx=(), recover_idx=()),
    "sq_full_context": dict(SQ, causal=False, time_reduction_type="conv"),
    "ec_g2": EC,
    "ec_g3": dict(EC, group_size=3, static_chunk_size=12),
    "ec_no_stride": dict(EC, stride_layer_idx=()),
}
_BUILT = {}


def family(name, blank_bias: float = 0.0):
    """(JAX model, flax variables, port model) of FAMILIES[name]."""
    key = (name, blank_bias)
    if key not in _BUILT:
        _BUILT[key] = build(jax_cfg(FAMILIES[name]), blank_bias=blank_bias)
    return _BUILT[key]


def feats(t: int, b: int = 2, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, t, 80)) * scale).astype(np.float32)


@pytest.mark.parametrize("chunk", [-1, 4, 5])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_encode_matches_jax(name, chunk):
    jm, params, port = family(name)
    x, lens, _, _ = batch()
    ref, ref_lens = jm.apply(params, x, lens, decoding_chunk_size=chunk,
                             num_decoding_left_chunks=2, method="encode")
    got, got_lens = port.encode(torch.from_numpy(x), torch.from_numpy(lens), chunk, 2)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


STREAMED = {"sq": (4, 2, 83), "sq_no_reduce": (4, 2, 67), "ec_g2": (8, 2, 99),
            "ec_g3": (12, 1, 99)}


@pytest.mark.parametrize("name", list(STREAMED))
def test_forward_chunk_matches_jax(name):
    """A whole utterance chunk by chunk: outputs, each layer's caches at its
    own rate, and the full-rate offset."""
    chunk, left, t = STREAMED[name]
    jm, params, port = family(name)
    x = feats(t)
    n = num_chunks(t, chunk, 4, 6)
    jw = np.asarray(jax_chunk_windows(x, chunk, 4, 6, n))
    pw = chunk_windows(torch.from_numpy(x), chunk, 4, 6, n)
    jstate = jm.apply(params, 2, chunk, left, method="init_encoder_state")
    pstate = port.init_encoder_state(2, chunk, left)
    encode_chunk = jax.jit(lambda w, st: jm.apply(params, w, st, method="encode_chunk"))
    for i in range(n):
        ry, jstate = encode_chunk(jw[i], jstate)
        gy, pstate = port.encode_chunk(pw[i], pstate)
        assert gy.shape[1] == chunk // stream_output_factor(port.cfg.encoder)
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry), rtol=0, atol=ATOL)
        for (gk, gv), (rk, rv), gc, rc in zip(pstate.att, jstate.att, pstate.cnn, jstate.cnn,
                                              strict=True):
            for g, r in ((gk, rk), (gv, rv), (gc, rc)):
                assert g.shape == r.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)
        assert pstate.offset == int(jstate.offset) == (i + 1) * chunk


@pytest.mark.parametrize("name,chunk,left,t,b", [
    ("sq", 4, 2, 131, 2), ("sq", 4, 6, 131, 1), ("sq", 4, 0, 131, 2),
    ("sq_no_reduce", 4, 2, 131, 2), ("ec_g2", 8, 2, 131, 2), ("ec_g2", 8, 0, 131, 2),
    ("ec_g3", 12, 1, 147, 2),
])
def test_stream_equals_chunk_masked_full(name, chunk, left, t, b):
    """The port's cached stream == its chunk-masked full forward over the
    frames whole chunks cover (a partial last chunk sees in-chunk zero
    padding, tests/test_streaming_families.py:122-128)."""
    _, _, port = family(name)
    x = torch.from_numpy(feats(t, b, seed=1))
    full, _ = port.encode(x, torch.full((b,), t), chunk, left)
    n = num_chunks(t, chunk, 4, 6)
    state = port.init_encoder_state(b, chunk, left)
    outs = []
    for w in chunk_windows(x, chunk, 4, 6, n):
        y, state = port.encode_chunk(w, state)
        outs.append(y)
    ys = torch.cat(outs, 1)
    usable = min(n * chunk // stream_output_factor(port.cfg.encoder), full.shape[1])
    np.testing.assert_allclose(ys[:, :usable].numpy(), full[:, :usable].numpy(),
                               rtol=STREAM_TOL, atol=STREAM_TOL)
    if left == 0:
        assert all(k.shape[1] == 0 for k, _ in state.att)


def test_state_shapes_per_rate():
    """tests/test_streaming_families.py's shapes: squeezeformer layers 0 and
    3 at the full rate, 1-2 reduced; efficient conformer layers 0-1 before
    the stride, 2-3 after; conv caches kernel - 1 frames."""
    _, _, sq = family("sq")
    state = sq.init_encoder_state(3, 4, 2)
    assert [k.shape for k, _ in state.att] == [(3, 8, 2, 16), (3, 4, 2, 16), (3, 4, 2, 16),
                                               (3, 8, 2, 16)]
    assert all(c.shape == (3, 6, 32) for c in state.cnn) and state.offset == 0
    _, _, ec = family("ec_g2")
    state = ec.init_encoder_state(3, 8, 2)
    assert [k.shape for k, _ in state.att] == [(3, 16, 2, 16), (3, 16, 2, 16), (3, 8, 2, 16),
                                               (3, 8, 2, 16)]
    assert [ec.encoder.layer_factor(i) for i in range(4)] == [1, 1, 2, 2]
    assert [sq.encoder.layer_factor(i) for i in range(4)] == [1, 2, 2, 1]


def test_misaligned_chunks_refused():
    """The efficient conformer needs chunk % (factor * group_size) == 0 at
    every layer: 6 with group 2 after the stride is refused, naming the
    rule, as the JAX package asserts; squeezeformer's reduction needs an
    even chunk; a non-causal family streams by prefix recomputation only."""
    jm, params, ec = family("ec_g2")
    with pytest.raises(AssertionError):
        jm.apply(params, 1, 6, 2, method="init_encoder_state")
    with pytest.raises(ValueError, match=r"divisible by factor 2 \* group_size 2 for layer 2"):
        ec.init_encoder_state(1, 6, 2)
    _, _, g3 = family("ec_g3")
    with pytest.raises(ValueError, match="group_size 3"):
        g3.init_encoder_state(1, 8, 2)
    _, _, sq = family("sq")
    with pytest.raises(ValueError, match="even chunk"):
        sq.init_encoder_state(1, 5, 2)
    _, _, full = family("sq_full_context")
    with pytest.raises(ValueError, match="causal=True"):
        full.init_encoder_state(1, 4, 2)


def test_position_encoding_stride_matches_jax():
    """Windows at strides 1, 2 and 4, cold (negative offsets clamp to row 0)
    and near max_len (the window rebased to end at the table top)."""
    jpe, ppe = JaxPE(16, 100), PositionalEncodingTable(16, 100)
    for offset, size, stride in [(-8, 12, 1), (-8, 6, 2), (4, 10, 2), (60, 12, 4), (90, 12, 2),
                                 (95, 10, 1), (120, 3, 4)]:
        np.testing.assert_array_equal(
            ppe.position_encoding(offset, size, stride=stride).numpy(),
            np.asarray(jpe.position_encoding(jnp.int32(offset), size, stride=stride)),
            err_msg=str((offset, size, stride)))


def test_prefix_recompute_matches_jax():
    """tests/test_prefix_recompute.py's non-causal squeezeformer (2 blocks,
    no reduction): the port's increments == JAX's and == its full forward.
    JAX's encode_fn is one jitted shape: the prefix zero-padded to the
    utterance with its length masked, so the out_len(prefix) frames the
    loop reads are those of the prefix alone."""
    kw = dict(output_size=32, attention_heads=2, num_blocks=2, reduce_idx=(), recover_idx=(),
              cnn_module_kernel=7, dropout_rate=0.0, use_dynamic_chunk=True,
              static_chunk_size=4)
    jmod = jax_sq.SqueezeformerEncoder(jax_sq.SqueezeformerConfig(
        encoder_dim=32, feed_forward_expansion_factor=2, **kw))
    pmod = init_weights(port_sq.SqueezeformerEncoder(EncoderConfig(
        encoder_type="squeezeformer", linear_units=64, **kw)), 6)
    t = 131
    x, lens = feats(t, b=1, seed=2), np.array([t], np.int32)
    params = flax_variables(jmod, pmod, x, lens)
    padded = jax.jit(lambda f, l: jmod.apply(params, f, l, decoding_chunk_size=4,
                                             num_decoding_left_chunks=-1))
    out_len = jax_sq.DepthwiseConv2dSubsampling4.output_len
    lookahead = 2 * (4 - 1 + 3)
    ref = jax_prefix_encode(
        lambda f, l: padded(jnp.pad(f, ((0, 0), (0, t - f.shape[1]), (0, 0))), l),
        jnp.asarray(x), jnp.asarray(lens), 4, 4, 6, out_len, lookahead)
    encode = torch.no_grad()(lambda f, l: pmod(f, l, 4, -1))
    got = chunked_prefix_encode(encode, torch.from_numpy(x), torch.from_numpy(lens), 4, 4, 6,
                                port_sq.DepthwiseConv2dSubsampling4.output_len, lookahead)
    assert len(got) > 2 and [g.shape for g in got] == [tuple(r.shape) for r in ref]
    inc = torch.cat(got, 1).numpy()
    np.testing.assert_allclose(inc, np.concatenate([np.asarray(r) for r in ref], 1),
                               rtol=PREFIX_TOL, atol=PREFIX_TOL)
    full = encode(torch.from_numpy(x), torch.from_numpy(lens))[0].numpy()
    np.testing.assert_allclose(inc, full[:, :inc.shape[1]], rtol=PREFIX_TOL, atol=PREFIX_TOL)


def test_full_context_transducer_streams_by_prefix_recompute():
    """The non-causal squeezeformer with its look-ahead time reduction,
    which the caches refuse: its prefix-recomputed stream equals the
    chunk-masked full forward over every frame it emitted, and each chunk
    emits once the prefix reaches `lookahead` frames past a frame."""
    _, _, port = family("sq_full_context")
    t = 259
    x, lens = torch.from_numpy(feats(t, b=2, seed=3)), torch.tensor([t, 200])
    # conv k 7 sees 3 frames ahead and in-chunk attention chunk - 1 a block,
    # twice the span on the reduced-rate blocks; the reduction 2 more
    lookahead = 2 * 4 * (4 - 1 + 3) // 2 + 2
    out_len = lambda n: int(stream_output_len(port.cfg.encoder, torch.tensor(n)))
    got = chunked_prefix_encode(lambda f, l: port.encode(f, l, 4, -1), x, lens, 4, 4, 6, out_len,
                                lookahead)
    assert len(got) > 2 and got[0].shape[1] == 4 * (lookahead // 4 + 1) - lookahead
    inc = torch.cat(got, 1).numpy()
    full = port.encode(x, lens, 4, -1)[0].numpy()
    assert inc.shape == full.shape
    np.testing.assert_allclose(inc, full, rtol=PREFIX_TOL, atol=PREFIX_TOL)


# ---------------------------------------------------------------- decoding

DECODED = {"sq": 4, "ec_g2": 8}  # the family and its stream chunk
_DECODED = {}


def decoder_case(name):
    """(JAX model, variables, port, feats, lens, encoder output, lens): the
    blank's logit at 1.0 so that hypotheses both emit and take blanks."""
    if name not in _DECODED:
        jm, params, port = family(name, blank_bias=1.0)
        x, lens = feats(99, seed=5, scale=0.5), np.array([99, 75], np.int32)
        enc, enc_lens = jm.apply(params, x, lens, method="encode")
        _DECODED[name] = (jm, params, port, x, lens, np.array(enc), np.array(enc_lens))
    return _DECODED[name]


@pytest.mark.parametrize("name", list(DECODED))
def test_offline_decoding_matches_jax(name):
    jm, params, port, _, _, enc, enc_lens = decoder_case(name)
    e, el = jnp.asarray(enc), jnp.asarray(enc_lens)
    pe, pel = torch.from_numpy(enc), torch.from_numpy(enc_lens)
    ref_t, ref_l = jax_greedy(jm, params, e, el, BLANK, n_steps=3, max_tokens=40)
    got_t, got_l = rnnt_greedy_decode(port, pe, pel, BLANK, n_steps=3, max_tokens=40)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    assert (got_l > 0).all() and (got_l < 3 * pel).all()
    ref = jax_beam.rnnt_beam_decode(jm, params, e, el, BLANK, 4, 40, n_steps=2, ctc_weight=0.3)
    got = rnnt_beam_decode(port, pe, pel, BLANK, 4, 40, n_steps=2, ctc_weight=0.3)
    for g, r in zip(got[:4], ref[:4], strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(DECODED))
def test_streaming_decoding_matches_jax(name):
    """Streaming greedy and beam (CTC fusion 0.3) through the family's
    cached path: tokens identical to JAX; the final offset counts full-rate
    frames (4 chunks of 8 give 32 for the efficient conformer)."""
    chunk = DECODED[name]
    jm, params, port, x, lens, _, _ = decoder_case(name)
    px, pl = torch.from_numpy(x), torch.from_numpy(lens)
    ref_t, ref_l, rstate = jax_streaming_greedy(jm, params, x, lens, chunk, 2, BLANK, 3, 40)
    got_t, got_l, state = streaming_greedy_decode(port, px, pl, chunk, 2, BLANK, 3, 40)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    assert (got_l > 0).all()
    assert state.enc.offset == int(rstate.enc.offset) == num_chunks(99, chunk, 4, 6) * chunk
    ref = jax_streaming_beam(jm, params, x, lens, chunk, 2, BLANK, 4, 40, n_steps=2,
                             ctc_weight=0.3)
    got = streaming_beam_decode(port, px, pl, chunk, 2, BLANK, 4, 40, n_steps=2, ctc_weight=0.3)
    for g, r in zip(got[:2], ref[:2], strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_first_emissions_gate_at_the_output_rate():
    """The RTF's chunk loop gates each stream at its `stream_output_len`:
    the efficient conformer's [99, 75] frames are [12, 9] output frames."""
    _, _, port, x, lens, _, _ = decoder_case("ec_g2")
    np.testing.assert_array_equal(stream_output_len(port.cfg.encoder, torch.from_numpy(lens)),
                                  [12, 9])
    cfg = Config()
    cfg.model = port.cfg
    cfg.streaming = dataclasses.replace(cfg.streaming, chunk_size=8, num_left_chunks=2)
    first, _, chunk_audio = first_emissions(port, torch.from_numpy(x), lens, cfg)
    assert (first >= 0).all()
    assert chunk_audio == 8 * 4 * cfg.feature.hop_length / cfg.feature.sample_rate
