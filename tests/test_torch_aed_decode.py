"""The AED workload's decoding, trainer and evaluation == JAX on the CPU.

The tiny model of tests/test_torch_aed.py with an R2L decoder, seeded port
weights in the flax layout; both decoders' <eos> logit raised by 0.2 and
the CTC head's blank logit by 2.0, so that attention hypotheses end at
different lengths, some at `max_len`, and CTC prefixes both emit and take
blanks; 4 utterances of 67, 60, 50 and 41 frames. Tokens and lengths exact; scores within 1e-4 (fp32 sums in another
order); confidences within 1e-5.

- `attention_beam_search` (beam 4, 10 steps) on the same encoder output,
  with the default prompt and with a 3-token prompt and a length penalty:
  the best hypothesis and every n-best slot's score (the port's n-best
  lists hold the best in its slot);
- `attention_rescoring` of the CTC prefix beam's n-best, L2R alone and
  fused with the R2L decoder, with confidences;
- `decode_aed` in all four methods with `return_times`, from features, and
  with the blank filter (`apply_non_blank_embedding`);
- `make_offline_decoder` in the attention modes from waves gives
  `decode_aed`'s hypotheses on the same features (<eos> logit -1.0 there:
  on fbank's dB features the raised one ends every hypothesis at once);
- `python -m tpuasr_torch.tools.train --workload aed` in this process (one
  epoch of 4 synthetic utterances, the log's loss_att and th_accuracy), then
  `evaluate --workload aed --mode attention_rescoring` on its checkpoint:
  every hypothesis equals `decode_aed` on the trained model in memory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_aed import V, flax_params, jax_cfg, port_model
from tpuasr.decode import attention_beam as jax_beam
from tpuasr.decode import dispatch as jax_dispatch
from tpuasr.models import asr_model as jax_asr
from tpuasr_torch.audio import fbank_batch
from tpuasr_torch.config import Config, load_yaml
from tpuasr_torch.data import synthetic_pipeline
from tpuasr_torch.decode import attention_beam_search, ctc_prefix_beam_search
from tpuasr_torch.decode.dispatch import decode_aed
from tpuasr_torch.decode.rnnt_beam import first_argmax
from tpuasr_torch.eval import make_offline_decoder
from tpuasr_torch.models import attention_rescoring
from tpuasr_torch.text import Tokenizer
from tpuasr_torch.tools import evaluate
from tpuasr_torch.tools.train import main as train_main
from tpuasr_torch.train import latest_path

torch.set_num_threads(1)  # six test workers share the cores

EOS_BIAS, BLANK_BIAS, BEAM, MAX_LEN = 0.2, 2.0, 4, 10
METHODS = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention", "attention_rescoring"]


def _bias(port, jc):
    with torch.no_grad():
        for dec in (port.decoder, port.r_decoder):
            dec.output_layer.bias[jc.eos_id] = EOS_BIAS
        port.ctc_lo.bias[jc.blank_id] = BLANK_BIAS
    return port


def batch():
    r = np.random.default_rng(8)
    lens = np.array([67, 60, 50, 41], np.int32)
    feats = r.standard_normal((4, 67, 80)).astype(np.float32)
    feats[np.arange(67)[None, :] >= lens[:, None]] = 0.0
    return feats, lens


@pytest.fixture(scope="module")
def models():
    jc = jax_cfg(r_decoder_blocks=2, reverse_weight=0.3)
    jm = jax_asr.ASRModel(jc)
    port = _bias(port_model(jc, seed=4), jc)
    return jc, jm, flax_params(jm, port), port


@pytest.fixture(scope="module")
def encoded(models):
    """The port's encoder output and CTC log-probs of `batch()`'s features
    (fed to both packages' searches)."""
    port = models[3]
    feats, feat_lens = (torch.from_numpy(x) for x in batch())
    enc, enc_lens = port.encode(feats, feat_lens)
    lp = torch.log_softmax(port.ctc_logits(enc), dim=-1)
    return enc, enc_lens, lp


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("prompted", [False, True], ids=["sos", "prompt_penalty"])
def test_attention_beam_search_matches_jax(models, encoded, prompted):
    jc, jm, params, port = models
    enc, enc_lens, _ = encoded
    kw = {}
    if prompted:
        prompt = np.array([[jc.sos_id, 7, 9], [jc.sos_id, 11, 7]] * 2, np.int32)
        kw = dict(prompt=prompt, length_penalty=0.6)
    # jitted: one compile instead of an eager dispatch per operation
    want = jax.jit(lambda p, e, el, pr: jax_beam.attention_beam_search(
        jm, p, e, el, jc.sos_id, jc.eos_id, BEAM, MAX_LEN, prompt=pr,
        length_penalty=kw.get("length_penalty", 0.0)))(
            params, _j(enc), _j(enc_lens), None if not kw else _j(kw["prompt"]))
    got = attention_beam_search(port, enc, enc_lens, jc.sos_id, jc.eos_id, BEAM, MAX_LEN,
                                **{k: (torch.from_numpy(v) if k == "prompt" else v)
                                   for k, v in kw.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-4)
    lens = got[1].numpy()
    assert lens.max() > 0 and lens.min() < MAX_LEN  # not vacuous: emits, and stops early
    # the n-best lists hold the best hypothesis in its slot
    nb_tok, nb_len = attention_beam_search(
        port, enc, enc_lens, jc.sos_id, jc.eos_id, BEAM, MAX_LEN, nbest=True,
        **{k: (torch.from_numpy(v) if k == "prompt" else v) for k, v in kw.items()})[3]
    rows, best = torch.arange(4), first_argmax(got[2], 1)
    assert torch.equal(nb_tok[rows, best], got[0]) and torch.equal(nb_len[rows, best], got[1])


@pytest.mark.parametrize("reverse_weight", [0.0, 0.3], ids=["l2r", "r2l_fused"])
def test_attention_rescoring_matches_jax(models, encoded, reverse_weight):
    _, jm, params, port = models
    enc, enc_lens, lp = encoded
    _, _, nbest = ctc_prefix_beam_search(lp, enc_lens, 5, BEAM, 12)
    want = jax.jit(lambda p, *a: jax_asr.attention_rescoring(
        jm, p, *a, ctc_weight=0.5, reverse_weight=reverse_weight, return_confidence=True))(
            params, _j(enc), _j(enc_lens),
            *(_j(x.int() if i < 2 else x) for i, x in enumerate(nbest)))
    got = attention_rescoring(port, enc, enc_lens, *nbest, ctc_weight=0.5,
                              reverse_weight=reverse_weight, return_confidence=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 2:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4 if i == 2 else 1e-5)
    assert (nbest[1] > 0).all()
    # the decoder moved the CTC ranking of some n-best list
    assert not torch.equal(got[2].argsort(dim=1, stable=True), nbest[2].argsort(dim=1, stable=True))


@pytest.mark.parametrize("blank_filter", [False, True], ids=["plain", "blank_filter"])
def test_decode_aed_matches_jax(models, blank_filter):
    jc, jm, params, port = models
    if blank_filter:
        jc = dataclasses.replace(jc, apply_non_blank_embedding=True)
        jm = jax_asr.ASRModel(jc)
        port = _bias(port_model(jc, seed=4), jc)
    feats, feat_lens = batch()
    want = jax.jit(lambda p, f, fl: jax_dispatch.decode_aed(
        jm, p, f, fl, METHODS, beam_size=BEAM, max_tokens=MAX_LEN, return_times=True))(
            params, feats, feat_lens)
    got = decode_aed(port, *(torch.from_numpy(x) for x in (feats, feat_lens)), METHODS,
                     beam_size=BEAM, max_tokens=MAX_LEN, return_times=True)
    assert set(got) == set(want) == set(METHODS)
    for m in METHODS:
        assert len(got[m]) == len(want[m]) == (2 if m == "attention" else 3), m
        for g, w in zip(got[m], want[m]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=m)
    assert all(int(got[m][1].min()) > 0 for m in METHODS)


@pytest.mark.parametrize("mode", ["attention", "attention_rescoring"])
def test_offline_decoder_gives_decode_aeds_hypotheses(models, mode):
    jc = models[0]
    port = _bias(port_model(jc, seed=4), jc)
    with torch.no_grad():  # fbank's dB features: the raised <eos> would end every hypothesis
        port.decoder.output_layer.bias[jc.eos_id] = -1.0
    r = np.random.default_rng(3)
    waves = (r.standard_normal((4, 30000)) * 0.1).astype(np.float32)
    wave_lens = np.array([30000, 27000, 24000, 21000], np.int32)
    cfg = Config()
    toks, lens = make_offline_decoder(port, cfg, mode, beam_size=BEAM, max_tokens=MAX_LEN,
                                      rescoring_ctc_weight=0.3)(waves, wave_lens)
    feats, feat_lens = fbank_batch(waves, wave_lens, cfg.feature, device="cpu")
    method = "attention" if mode == "attention" else "attention_rescoring"
    want = decode_aed(port, feats, feat_lens, [method], beam_size=BEAM, max_tokens=MAX_LEN,
                      ctc_weight=0.3)[method]
    assert torch.equal(toks, want[0]) and torch.equal(lens, want[1])
    assert int(lens.max()) > 0


TINY = ["model.encoder.num_blocks=1", "model.encoder.output_size=32",
        "model.encoder.attention_heads=2", "model.encoder.linear_units=64",
        "model.encoder.cnn_module_kernel=7", f"model.vocab_size={V}",
        "model.att_decoder.blocks=1", "model.att_decoder.heads=2", "model.att_decoder.ffn=64",
        "model.att_decoder.r_blocks=1", "data.batch_size=4", "train.log_dir=",
        "train.log_every=1"]


def test_trainer_and_evaluate_cli_aed(tmp_path, capsys):
    result = train_main(["--workload", "aed", "--device", "cpu", "--synthetic", "4",
                         "--epochs", "1", "--set", *TINY, f"train.save_dir={tmp_path}"])
    log = capsys.readouterr().out
    assert "loss_att" in log and "th_accuracy" in log
    assert all(np.isfinite(result.train_losses + result.dev_losses))
    assert result.state.step > 0 and int(result.state.skipped) == 0

    res = evaluate.main(["--checkpoint", latest_path(str(tmp_path)), "--workload", "aed",
                         "--mode", "attention_rescoring", "--synthetic", "4", "--device",
                         "cpu", "--max_samples", "8"])
    # the trained model in memory, on the evaluation's dev corpus
    model = result.state.model.eval()
    cfg = load_yaml(str(tmp_path / "train.yaml"))
    tok = Tokenizer(tokens=[f"syl{i}" for i in range(V - 6)])
    specials = set(tok.special_token_ids())
    hyps = []
    for b in synthetic_pipeline(cfg, 4, seed=1).batches(0):
        feats, feat_lens = fbank_batch(b["waves"], b["wave_lens"], cfg.feature, device="cpu")
        t, n = decode_aed(model, feats, feat_lens, ["attention_rescoring"],
                          beam_size=4, max_tokens=200)["attention_rescoring"]
        hyps += [" ".join(tok.decode([x for x in t[i, : n[i]].tolist() if x not in specials]))
                 for i in range(b["num_valid"])]
    assert [h for _, _, h in res.samples] == hyps and len(hyps) == 4
    assert res.counts.ref_len > 0
