"""Port CTC decoders, context biasing, transducer rescoring and the new
offline decode modes == JAX on the CPU.

- `ctc_greedy_decode` with and without details (times, confidence) on log
  probs with planted repeats, blanks and a short row, and
  `remove_duplicates_and_blank`;
- the port's own `build_context_graph`: its tables equal the JAX
  package's for overlapping hotwords;
- `_first_occurrence_merge` on planted duplicate prefixes;
- `ctc_prefix_beam_search` plain, with a context graph (hotwords cut from
  the plain search's best prefixes, so the graph fires) and with
  `return_times` (the Viterbi peak-time algebra), on the tiny flagship's
  CTC head (2 blocks, d32, vocab 64, blank 5; converted weights) and on
  random log probs;
- `transducer_rescoring` of that n-best: choice and fused scores;
- `make_offline_decoder` from waves in rnnt_beam (with CTC fusion),
  ctc_greedy, ctc_prefix_beam and rnnt_rescoring against the JAX
  package's decoder; the Paraformer modes (a tiny Paraformer) give its
  own greedy and beam hypotheses.
Tokens, lengths and times identical; scores within 1e-4 (fp32 sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.config import to_dict
from tpuasr.decode import context_graph as jax_cg
from tpuasr.decode import ctc_prefix_beam as jax_pb
from tpuasr.decode.ctc_greedy import ctc_greedy_decode as jax_ctc_greedy
from tpuasr.decode.ctc_greedy import remove_duplicates_and_blank as jax_collapse
from tpuasr.decode.rnnt_rescoring import transducer_rescoring as jax_rescoring
from tpuasr.eval.cer_eval import make_offline_decoder as jax_offline_decoder
from tpuasr.models import Transducer as JaxTransducer
from tpuasr_torch.config import Config, from_dict
from tpuasr_torch.convert import load_jax_params
from tpuasr_torch.decode import (
    build_context_graph, ctc_greedy_decode, ctc_prefix_beam_search,
    remove_duplicates_and_blank, transducer_rescoring,
)
from tpuasr_torch.decode import ctc_prefix_beam
from tests.test_torch_paraformer import tiny as tiny_paraformer
from tpuasr_torch.audio import fbank_batch
from tpuasr_torch.eval import make_offline_decoder
from tpuasr_torch.models import Transducer

torch.set_num_threads(1)  # six test workers share the cores

BLANK, BLANK_BIAS, MAX_TOKENS = 5, 1.25, 24


@pytest.fixture(scope="module")
def models():
    cfg = _flagship_config(tiny=True)
    jm = JaxTransducer(cfg.model)
    # jitted, on a short input: the same weights in a third of the time
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 32, 80), np.float32),
                              np.full((1,), 32, np.int32), np.zeros((1, 2), np.int32),
                              np.full((1,), 2, np.int32))
    params = jax.tree.map(np.array, params)
    # emissions and blanks both occur in the transducer's searches
    params["params"]["joint"]["ffn_out_bias"][BLANK] = BLANK_BIAS
    pcfg = from_dict(Config, to_dict(cfg))
    port = load_jax_params(Transducer(pcfg.model, device="cpu"), params)
    return cfg, jm, params, pcfg, port


@pytest.fixture(scope="module")
def encoded(models):
    _, jm, params, _, _ = models
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 131, 80)) * 0.5).astype(np.float32)
    enc, enc_lens = jm.apply(params, x, np.array([131, 99], np.int32), method="encode")
    lp = jax.nn.log_softmax(jm.apply(params, enc, method="ctc_logits").astype(jnp.float32), -1)
    return np.array(enc), np.array(enc_lens), np.array(lp)


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_lp(seed, b=3, t=17, v=9):
    """Log probs with planted runs (repeats), blank frames and a short row."""
    r = np.random.default_rng(seed)
    logits = r.standard_normal((b, t, v)).astype(np.float32) * 2
    logits[0, 3:6, 4] += 8.0  # a run of one token
    logits[1, 2:9:2, BLANK % v] += 6.0  # blanks between
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    return lp, np.array([t, t - 5, 1], np.int32)


@pytest.mark.parametrize("with_details", [False, True])
def test_ctc_greedy_matches_jax(encoded, with_details):
    lp_r, lens_r = _random_lp(1)
    _, enc_lens, lp_m = encoded
    for lp, lens in ((lp_r, lens_r), (lp_m, enc_lens)):
        ref = jax_ctc_greedy(jnp.asarray(lp), jnp.asarray(lens), BLANK, with_details=with_details)
        got = ctc_greedy_decode(_t(lp), _t(lens), BLANK, with_details=with_details)
        assert len(got) == len(ref) == (4 if with_details else 2)
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        if with_details:
            np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=0, atol=1e-6)
    ids = [5, 5, 7, 7, 5, 3, 3, 3, 5, 9]
    assert remove_duplicates_and_blank(ids, BLANK) == jax_collapse(ids, BLANK) == [7, 3, 9]


def test_context_graph_tables_match_jax():
    words = [[3, 4], [4, 3, 4], [7], [3, 4, 9, 1]]
    ref = jax_cg.build_context_graph(words, vocab_size=12, context_score=1.5)
    got = build_context_graph(words, vocab_size=12, context_score=1.5)
    assert got.num_nodes == ref.num_nodes
    for name in ("next_state", "score_delta", "node_score", "finalize_score"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def test_first_occurrence_merge_matches_jax():
    r = np.random.default_rng(4)
    keys = r.integers(0, 3, size=(2, 20, 2)).astype(np.uint32)
    lens = r.integers(0, 2, size=(2, 20)).astype(np.int32)
    pb, pnb = (r.standard_normal((2, 20)).astype(np.float32) for _ in range(2))
    pb[:, ::3] = np.float32(-1e30)
    ref = jax_pb._first_occurrence_merge(*map(jnp.asarray, (keys, lens, pb, pnb)))
    got = ctc_prefix_beam._first_occurrence_merge(_t(keys.astype(np.int64)), _t(lens).long(),
                                                  _t(pb), _t(pnb))
    assert int(np.asarray(ref[3]).sum()) < 30  # duplicates were merged (40 candidates)
    for g, rr in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(rr))
    for g, rr in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=0, atol=1e-5)


def _hotwords(best_tok, best_len):
    """2-token spans of the best prefixes: a graph that fires."""
    words = []
    for toks, n in zip(np.asarray(best_tok), np.asarray(best_len)):
        words += [toks[i:i + 2].tolist() for i in range(0, int(n) - 1, 3)]
    return words


@pytest.mark.parametrize("source,graph,times", [
    ("random", False, False), ("model", False, False), ("model", True, False),
    ("random", False, True), ("model", True, True)])
def test_ctc_prefix_beam_matches_jax(encoded, source, graph, times):
    if source == "random":
        lp, lens = _random_lp(2)
        beam, vocab = 3, lp.shape[-1]
    else:
        _, lens, lp = encoded
        beam, vocab = 4, lp.shape[-1]
    cg = cg_j = None
    if graph:
        plain = ctc_prefix_beam_search(_t(lp), _t(lens), BLANK, beam, MAX_TOKENS)
        words = _hotwords(*plain[:2])
        cg = build_context_graph(words, vocab, 1.0)
        cg_j = jax_cg.build_context_graph(words, vocab, 1.0)
    ref = jax_pb.ctc_prefix_beam_search(jnp.asarray(lp), jnp.asarray(lens), BLANK, beam,
                                        MAX_TOKENS, context_graph=cg_j, return_times=times)
    got = ctc_prefix_beam_search(_t(lp), _t(lens), BLANK, beam, MAX_TOKENS, context_graph=cg,
                                 return_times=times)
    flat = lambda out: [*out[:-1], *out[-1]]
    g, r = flat(got), flat(ref)
    assert len(g) == len(r)
    score_at = 5 if times else 4
    for i, (x, y) in enumerate(zip(g, r)):
        if i == score_at:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    if graph:  # the bias moved the scores
        assert not np.allclose(got[-1][2].numpy(), plain[-1][2].numpy())


def test_transducer_rescoring_matches_jax(models, encoded):
    _, jm, params, _, port = models
    enc, enc_lens, lp = encoded
    _, _, (nb_tok, nb_len, nb_score) = ctc_prefix_beam_search(_t(lp), _t(enc_lens), BLANK, 4,
                                                              MAX_TOKENS)
    ref = jax_rescoring(jm, params, jnp.asarray(enc), jnp.asarray(enc_lens),
                        jnp.asarray(nb_tok.numpy().astype(np.int32)),
                        jnp.asarray(nb_len.numpy().astype(np.int32)),
                        jnp.asarray(nb_score.numpy()), BLANK)
    got = transducer_rescoring(port, _t(enc), _t(enc_lens), nb_tok, nb_len, nb_score, BLANK)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=0, atol=1e-4)
    # the transducer changed the CTC beam's ranking somewhere, or the check is empty
    assert not torch.equal(got[2].argsort(1), nb_score.argsort(1))


@pytest.mark.parametrize("mode,kw", [
    ("rnnt_beam", {"ctc_fusion_weight": 0.3}), ("ctc_greedy", {}), ("ctc_prefix_beam", {}),
    ("rnnt_rescoring", {})])
def test_offline_decoder_from_waves_matches_jax(models, mode, kw):
    cfg, jm, params, pcfg, port = models
    r = np.random.default_rng(1)
    waves = (r.standard_normal((2, 12000)) * 0.1).astype(np.float32)
    wave_lens = np.array([12000, 9000], np.int32)
    cfg.feature.use_pallas = False
    ref = jax_offline_decoder(jm, cfg, mode, max_tokens=MAX_TOKENS, **kw)(params, waves,
                                                                          wave_lens)
    got = make_offline_decoder(port, pcfg, mode, max_tokens=MAX_TOKENS, **kw)(waves, wave_lens)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert int(got[1].max()) > 0


def test_offline_decoder_later_modes_raise(models):
    """The modes once left for a later slice, the Paraformer's, now decode:
    from waves they give the model's own greedy and beam (n-best slot 0)
    hypotheses; an unknown mode still raises."""
    _, _, _, pcfg, port = models
    para = tiny_paraformer()
    r = np.random.default_rng(1)
    waves = (r.standard_normal((2, 12000)) * 0.1).astype(np.float32)
    wave_lens = np.array([12000, 9000], np.int32)
    feats, feat_lens = fbank_batch(waves, wave_lens, pcfg.feature, device="cpu")
    nb, _, nb_lens = para.beam_decode(feats, feat_lens, 3)
    for mode, want in (("paraformer_greedy", para.greedy_decode(feats, feat_lens)),
                       ("paraformer_beam", (nb[:, 0], nb_lens))):
        got = make_offline_decoder(para, pcfg, mode, beam_size=3)(waves, wave_lens)
        assert all(torch.equal(g, w) for g, w in zip(got, want)) and int(got[1].max()) > 0
    with pytest.raises(ValueError):
        make_offline_decoder(port, pcfg, "no_such_mode")
