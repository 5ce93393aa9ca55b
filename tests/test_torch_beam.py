"""Port RNN-T beam search and the streaming eval pieces == JAX on the CPU.

The pieces whose behaviour XLA fixes and PyTorch does not: the uint32
rolling hash (bit for bit, wraparound included), the top-k order among
exact ties (the lower index first, with runs of -1e30), the first-occurrence
merge of duplicate candidates, and the beam state helpers on the LSTM's
[L, B, N, H] layout. Then `rnnt_beam_decode` on the JAX encoder's output of
the tiny flagship (2 blocks, d32, vocab 64, blank 5; converted weights,
the blank logit at 1.25 so hypotheses both emit and take blanks): beam 4
with one emission a frame, three emissions a frame with CTC fusion 0.3,
beam 3 with two, and a case at the cap. Tokens and lengths of every n-best
slot must be identical, log-probs within 1e-4 (fp32 sums in another
order). Beam 1 with one emission a frame equals greedy with one emission a
frame. `streaming_beam_decode` == JAX's, and == offline beam over the
chunk-masked full-context encoder (the streaming gate of greedy, applied
to the beam). The first-token delay's chunk loop finds each stream's first
emitting chunk as the JAX package's does; the timing functions take
mode "beam" and refuse the CPU; `tools/rtf_bench`'s parser has the JAX
tool's flags.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.config import to_dict
from tpuasr.decode import rnnt_beam as jax_beam
from tpuasr.decode import state_utils as jax_su
from tpuasr.decode.rnnt_streaming import init_streaming_state as jax_init_streaming_state
from tpuasr.decode.rnnt_streaming import process_chunk as jax_process_chunk
from tpuasr.decode.rnnt_streaming import streaming_beam_decode as jax_streaming_beam
from tpuasr.nn.subsampling import subsampled_len as jax_subsampled_len
from tpuasr.streaming.chunkwise import chunk_windows as jax_chunk_windows
from tpuasr.models import Transducer as JaxTransducer
from tpuasr_torch.config import Config, from_dict
from tpuasr_torch.convert import load_jax_params
from tpuasr_torch.decode import rnnt_beam, state_utils
from tpuasr_torch.decode import rnnt_greedy_decode, streaming_beam_decode
from tpuasr_torch.eval import first_emissions, measure_first_token_delay, measure_rtf
from tpuasr_torch.models import Transducer
from tpuasr_torch.streaming import num_chunks
from tpuasr_torch.tools import rtf_bench

torch.set_num_threads(1)  # six test workers share the cores

BLANK, CHUNK, LEFT, BLANK_BIAS = 5, 4, 2, 1.25


@pytest.fixture(scope="module")
def models():
    cfg = _flagship_config(tiny=True)
    jm = JaxTransducer(cfg.model)
    # jitted, on a short input: the same weights in a third of the time
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 32, 80), np.float32),
                              np.full((1,), 32, np.int32), np.zeros((1, 2), np.int32),
                              np.full((1,), 2, np.int32))
    params = jax.tree.map(np.array, params)
    # a random joint prefers a label at every step; this blank logit makes
    # hypotheses both emit and take blanks (0.3-1 tokens a frame)
    params["params"]["joint"]["ffn_out_bias"][BLANK] = BLANK_BIAS
    port = load_jax_params(Transducer(from_dict(Config, to_dict(cfg)).model, device="cpu"),
                           params)
    return cfg, jm, params, port


@pytest.fixture(scope="module")
def encoded(models):
    _, jm, params, _ = models
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 131, 80)) * 0.5).astype(np.float32)
    lens = np.array([131, 99], np.int32)
    enc, enc_lens = jm.apply(params, x, lens, method="encode")
    return x, lens, np.array(enc), np.array(enc_lens)


def test_extend_hash_matches_jax_bit_for_bit():
    r = np.random.default_rng(1)
    h = r.integers(0, 2**32, size=(3, 5, 2), dtype=np.uint64).astype(np.uint32)
    h[0, 0] = [0, 0]
    h[0, 1] = [2**32 - 1, 2**32 - 1]
    h[1, 2] = [2**32 - 1, 0]
    tok = r.integers(0, 412, size=(3, 5, 4)).astype(np.int32)
    tok[0, :, 0] = 0
    tok[2, :, 3] = 411
    ref = np.asarray(jax_beam._extend_hash(jnp.asarray(h)[:, :, None, :], jnp.asarray(tok)))
    got = rnnt_beam._extend_hash(torch.from_numpy(h.astype(np.int64))[:, :, None, :],
                                 torch.from_numpy(tok))
    assert ref.dtype == np.uint32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("shape,k", [((2, 4, 64), 4), ((3, 20), 4), ((1, 110), 10)])
def test_top_k_order_among_ties_matches_jax(shape, k):
    """Planted exact ties (a few distinct values, runs of -1e30 and a dead
    row that is -1e30 throughout): values and indices as jax.lax.top_k."""
    r = np.random.default_rng(sum(shape))
    x = r.choice(np.float32([-1.5, -0.25, -3.0, -1e30]), size=shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = np.float32(-1e30)
    x.reshape(-1, shape[-1])[-1, : shape[-1] // 2] = np.float32(-1e30)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = rnnt_beam.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def test_merge_duplicates_matches_jax():
    """Planted duplicate keys (several copies, the first not at index 0),
    keys equal but scalar keys different, -1e30 candidates among them."""
    r = np.random.default_rng(2)
    keys = r.integers(0, 3, size=(3, 20, 2)).astype(np.uint32)
    lens = r.integers(0, 2, size=(3, 20)).astype(np.int32)
    logp = r.standard_normal((3, 20)).astype(np.float32) * 3
    logp[:, ::5] = np.float32(-1e30)
    ref = np.asarray(jax_beam._merge_duplicates(jnp.asarray(keys), jnp.asarray(lens),
                                                jnp.asarray(logp)))
    got = rnnt_beam._merge_duplicates(torch.from_numpy(keys.astype(np.int64)),
                                      torch.from_numpy(lens).long(), torch.from_numpy(logp))
    assert (ref < -1e29).sum() > 20  # duplicates were squashed
    np.testing.assert_array_equal(got.numpy() < -1e29, ref < -1e29)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_beam_state_helpers_on_the_lstm_layout():
    """split / merge / gather / where over ([L, B*N, H], [L, B*N, H]), the
    batch on axis 1: the port's helpers against the JAX package's."""
    r = np.random.default_rng(3)
    l, b, n, h = 2, 3, 4, 5
    state = tuple(r.standard_normal((l, b * n, h)).astype(np.float32) for _ in range(2))
    sel = r.integers(0, n, size=(b, n)).astype(np.int32)
    mask = r.random((b, n)) < 0.5
    j_split = jax_su.split_beam_axis(tuple(map(jnp.asarray, state)), b, n, 1)
    p_split = state_utils.split_beam_axis(tuple(map(torch.from_numpy, state)), b, n, 1)
    other = tuple(x * 2 for x in p_split)
    pairs = [
        (j_split, p_split),
        (jax_su.merge_beam_axis(j_split, 1), state_utils.merge_beam_axis(p_split, 1)),
        (jax_su.gather_beam(j_split, jnp.asarray(sel), 1),
         state_utils.gather_beam(p_split, torch.from_numpy(sel).long(), 1)),
        (jax_su.where_beam(jnp.asarray(mask), j_split, tuple(x * 2 for x in j_split), 1),
         state_utils.where_beam(torch.from_numpy(mask), p_split, other, 1)),
    ]
    for ref, got in pairs:
        for x, y in zip(ref, got, strict=True):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def _same_nbest(got, ref):
    """Best and every n-best slot: tokens and lens identical, logp 1e-4."""
    for g, r in zip(got[:4], ref[:4], strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=0, atol=1e-4)


# (beam, n_steps, ctc_weight, max_tokens): one emission a frame; three
# with CTC fusion; beam 3 with two; at the cap (18 tokens would come)
BEAM_CASES = [(4, 1, 0.0, 50), (4, 3, 0.3, 50), (3, 2, 0.0, 40), (4, 1, 0.0, 12)]


@pytest.mark.parametrize("beam,n_steps,ctc_weight,max_tokens", BEAM_CASES)
def test_rnnt_beam_on_jax_encoder_output(models, encoded, beam, n_steps, ctc_weight,
                                         max_tokens):
    _, jm, params, port = models
    _, _, enc, enc_lens = encoded
    ref = jax_beam.rnnt_beam_decode(jm, params, jnp.asarray(enc), jnp.asarray(enc_lens),
                                    BLANK, beam, max_tokens, n_steps=n_steps,
                                    ctc_weight=ctc_weight)
    got = rnnt_beam.rnnt_beam_decode(port, torch.from_numpy(enc), torch.from_numpy(enc_lens),
                                     BLANK, beam, max_tokens, n_steps=n_steps,
                                     ctc_weight=ctc_weight)
    _same_nbest(got, ref)
    lens = got[3].numpy()
    if max_tokens == 12:
        assert (lens == max_tokens).any()  # the cap is reached
    else:
        assert 0 < lens.max() < max_tokens


def test_beam1_equals_greedy_one_step(models, encoded):
    """Beam 1 with one emission a frame is greedy with n_steps 1."""
    *_, port = models
    _, _, enc, enc_lens = encoded
    e, el = torch.from_numpy(enc.copy()), torch.from_numpy(enc_lens.copy())
    g_tok, g_len = rnnt_greedy_decode(port, e, el, BLANK, n_steps=1, max_tokens=20)
    b_tok, b_len, *_ = rnnt_beam.rnnt_beam_decode(port, e, el, BLANK, beam_size=1,
                                                  max_tokens=20)
    assert int(g_len.max()) > 0
    assert torch.equal(g_len, b_len)
    assert torch.equal(g_tok, b_tok)


@pytest.mark.parametrize("n_steps,ctc_weight", [(1, 0.0), (3, 0.3)])
def test_streaming_beam_matches_jax(models, encoded, n_steps, ctc_weight):
    _, jm, params, port = models
    x, lens, _, _ = encoded
    ref_t, ref_l, ref_st = jax_streaming_beam(jm, params, x, lens, CHUNK, LEFT, BLANK, 4, 40,
                                              n_steps, ctc_weight)
    got_t, got_l, st = streaming_beam_decode(port, torch.from_numpy(x), torch.from_numpy(lens),
                                             CHUNK, LEFT, BLANK, 4, 40, n_steps, ctc_weight)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(st.beam.tokens.numpy(), np.asarray(ref_st.beam.tokens))
    np.testing.assert_array_equal(st.beam.lens.numpy(), np.asarray(ref_st.beam.lens))
    np.testing.assert_allclose(st.beam.logp.numpy(), np.asarray(ref_st.beam.logp), rtol=0,
                               atol=1e-4)


def test_streaming_beam_equals_offline_chunk_masked(models, encoded):
    """Streaming beam == offline beam over the chunk-masked full-context
    encoder output, the offline lengths capped to what streaming sees."""
    *_, port = models
    x, lens, _, _ = encoded
    full, full_lens = port.encode(torch.from_numpy(x), torch.from_numpy(lens), CHUNK, LEFT)
    n = num_chunks(x.shape[1], CHUNK, 4, 6)
    capped = torch.clamp(full_lens.long(), max=n * CHUNK)
    off = rnnt_beam.rnnt_beam_decode(port, full, capped, BLANK, 4, 40, n_steps=2,
                                     ctc_weight=0.3)
    st_t, st_l, st = streaming_beam_decode(port, torch.from_numpy(x), capped * 4 + 3, CHUNK,
                                           LEFT, BLANK, 4, 40, n_steps=2, ctc_weight=0.3)
    assert int(st_l.max()) > 0
    assert torch.equal(st_l, off[1]) and torch.equal(st_t, off[0])
    assert torch.equal(st.beam.tokens, off[2]) and torch.equal(st.beam.lens, off[3])


def test_first_emission_chunks_match_jax(models):
    """measure_first_token_delay's chunk loop (`first_emissions`) on the
    CPU: each stream's first emitting chunk equals what the JAX package's
    loop finds (streams silent or constant at first, so they differ)."""
    cfg, jm, params, port = models
    pcfg = from_dict(Config, to_dict(cfg))
    pcfg.streaming.chunk_size, pcfg.streaming.num_left_chunks = CHUNK, LEFT
    r = np.random.default_rng(5)
    x = (r.standard_normal((3, 131, 80)) * 0.5).astype(np.float32)
    x[0, :40], x[1, :70] = 0.0, -1.0
    lens = np.array([131, 99, 60], np.int32)
    first, proc, chunk_audio = first_emissions(port, torch.from_numpy(x), torch.from_numpy(lens),
                                               pcfg, n_steps=4)
    # the JAX package's loop (tpuasr/eval/rtf.py measure_first_token_delay)
    n = num_chunks(131, CHUNK, 4, 6)
    windows = jax_chunk_windows(jnp.asarray(x), CHUNK, 4, 6, n)
    state = jax_init_streaming_state(jm, params, 3, CHUNK, LEFT, BLANK,
                                     enc_lens=jax_subsampled_len("conv2d", jnp.asarray(lens)))
    step = jax.jit(lambda xs, st: jax_process_chunk(jm, params, xs, st, BLANK, 4))
    ref = np.full(3, -1)
    for i in range(n):
        state = step(windows[i], state)
        ref[(np.asarray(state.dec.hyp_len) > 0) & (ref < 0)] = i
        if (ref >= 0).all():
            break
    assert sorted(set(ref.tolist())) == [0, 2, 4]
    np.testing.assert_array_equal(first, ref)
    assert chunk_audio == CHUNK * 4 * cfg.feature.hop_length / cfg.feature.sample_rate
    assert (proc[first >= 0] > 0).all()


def test_timing_takes_beam_and_refuses_the_cpu(models):
    cfg, *_, port = models
    pcfg = from_dict(Config, to_dict(cfg))
    feats = torch.zeros((1, 64, 80))
    for mode in ("greedy", "beam"):
        with pytest.raises(RuntimeError, match="times the card"):
            measure_rtf(port, feats, pcfg, mode=mode)
    with pytest.raises(ValueError):
        measure_rtf(port, feats, pcfg, mode="prefix")
    with pytest.raises(RuntimeError, match="times the card"):
        measure_first_token_delay(port, feats, torch.tensor([64]), pcfg)


def test_rtf_bench_takes_the_jax_flags(capsys):
    """The port's rtf_bench parser has the JAX tool's flags, with their
    types, nargs and defaults (read from tools/rtf_bench.py's source)."""
    src = Path(__file__).resolve().parents[1] / "tools" / "rtf_bench.py"
    ref = {}
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            ref[node.args[0].value] = (
                ast.literal_eval(kw["default"]) if "default" in kw else None,
                ast.unparse(kw["type"]) if "type" in kw else None,
                ast.literal_eval(kw["nargs"]) if "nargs" in kw else None)
    ap = rtf_bench.parser()
    got = {a.option_strings[0]: (a.default, a.type.__name__ if a.type else None, a.nargs)
           for a in ap._actions if a.option_strings and a.dest != "help"}
    assert got == ref
    args = ap.parse_args(["--seconds", "2", "--batch", "3", "--beam_size", "2", "--modes",
                          "greedy", "beam", "--set", "streaming.chunk_size=16"])
    assert (args.seconds, args.batch, args.beam_size, args.modes) == (2.0, 3, 2, ["greedy", "beam"])
    with pytest.raises(SystemExit) as e:
        ap.parse_args(["--help"])
    assert e.value.code == 0 and "--beam_size" in capsys.readouterr().out
