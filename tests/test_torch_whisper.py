"""The port's Whisper model == JAX on the CPU, on converted weights.

`tests/test_whisper.py`'s tiny config (vocab 40, 2 conformer blocks and 2
decoder blocks at d32, 2 heads, FFN 64, no dropout), with seeded port
weights written into the flax layout by the converter's own index map (no
JAX init is compiled); the decoder's eot logit raised so that hypotheses
end at different lengths, some at the token limit. Every JAX function is
jitted.

- the flax tree of a `WhisperModel`, with and without its CTC head, loads
  into the port through `load_jax_params` (strict) and gives back the
  port's weights: exact;
- `prompt_tokens` for every task x language: exact;
- the loss dict (loss, loss_att and, with `ctc_weight` 0.3, loss_ctc)
  within rtol 1e-5, and every parameter's gradient within atol 1e-4 (fp32
  sums in another order), at `ctc_weight` 0 and 0.3;
- `whisper_greedy_decode` on a batch of mixed tasks and languages: tokens
  and lengths identical;
- `whisper_beam_decode` (beam 4, with and without a length penalty):
  tokens and lengths identical, the n-best scores within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import flax_variables
from tests.test_whisper import tiny_cfg
from tpuasr.config import to_dict as jax_to_dict
from tpuasr.models import whisper as jax_whisper
from tpuasr_torch.config import EncoderConfig, from_dict
from tpuasr_torch.convert import convert_params, load_jax_params
from tpuasr_torch.models import (
    TASK_TRANSCRIBE, TASK_TRANSLATE, TASK_VAD, WhisperConfig, WhisperModel,
    WhisperSpecialTokens, init_weights, whisper_beam_decode, whisper_greedy_decode,
)

torch.set_num_threads(1)  # six test workers share the cores

EOT_BIAS, MAX_TOKENS, BEAM = 1.6, 8, 4
LANGS = np.array([0, 1, 0, 1], np.int32)
TASKS = np.array([TASK_TRANSCRIBE, TASK_TRANSLATE, TASK_VAD, TASK_TRANSLATE], np.int32)


def jax_cfg(ctc_weight: float = 0.0) -> jax_whisper.WhisperConfig:
    return dataclasses.replace(tiny_cfg(), ctc_weight=ctc_weight)


def port_cfg(jc: jax_whisper.WhisperConfig) -> WhisperConfig:
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
          if f.name not in ("encoder", "special")}
    return WhisperConfig(**kw, special=WhisperSpecialTokens(**dataclasses.asdict(jc.special)),
                         encoder=from_dict(EncoderConfig, jax_to_dict(jc.encoder)))


def batch():
    """4 utterances (67, 60, 50 and 41 frames, zero-padded), 5, 3, 4 and 2
    labels."""
    r = np.random.default_rng(9)
    lens = np.array([67, 60, 50, 41], np.int32)
    feats = r.standard_normal((4, 67, 80)).astype(np.float32)
    feats[np.arange(67)[None, :] >= lens[:, None]] = 0.0
    texts = r.integers(12, 30, (4, 5)).astype(np.int32)
    return feats, lens, texts, np.array([5, 3, 4, 2], np.int32)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(x):
    return jnp.asarray(np.asarray(x))


def build(ctc_weight: float = 0.0, seed: int = 3):
    """(JAX config, JAX model, flax variables, port model): the port's seeded
    weights, the eot logit at EOT_BIAS, in both."""
    jc = jax_cfg(ctc_weight)
    port = init_weights(WhisperModel(port_cfg(jc), device="cpu"), seed)
    with torch.no_grad():
        port.decoder.output_layer.bias[jc.special.eot] = EOT_BIAS
    jm = jax_whisper.WhisperModel(jc)
    return jc, jm, flax_variables(jm, port, *batch()), port


@pytest.fixture(scope="module")
def models():
    return build()


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_flax_tree_loads_into_the_port(ctc_weight):
    jc, _, variables, port = build(ctc_weight)
    assert ("ctc_lo" in variables["params"]) == (ctc_weight > 0)
    fresh = load_jax_params(WhisperModel(port_cfg(jc), device="cpu"), variables)
    want = port.state_dict()
    assert fresh.state_dict().keys() == want.keys()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_prompt_tokens_match_jax(models):
    jc, jm, variables, port = models
    langs, tasks = (np.array(x, np.int32).ravel() for x in np.meshgrid(
        np.arange(jc.num_languages), [TASK_TRANSCRIBE, TASK_TRANSLATE, TASK_VAD]))
    want = jm.apply(variables, _j(langs), _j(tasks), method="prompt_tokens")
    got = port.prompt_tokens(*_t(langs, tasks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sp = jc.special
    assert got[tasks == TASK_VAD][:, 2:].eq(sp.no_speech).all()  # VAD's slot and tail


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_loss_and_every_gradient_match_jax(ctc_weight):
    jc, jm, variables, port = build(ctc_weight)
    data = batch()

    def loss_fn(p):
        out = jm.apply({"params": p}, *data, langs=LANGS, tasks=TASKS)
        return out["loss"], out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    out = port(*_t(*data), *_t(LANGS, TASKS))
    out["loss"].backward()
    assert set(out) == set(ref) == ({"loss", "loss_att", "loss_ctc"} if ctc_weight
                                    else {"loss", "loss_att"})
    for k in out:
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]), rtol=1e-5, err_msg=k)
    want = convert_params(jax.tree.map(np.asarray, grads))
    got = dict(port.named_parameters())
    assert want.keys() == got.keys()
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.fixture(scope="module")
def encoded(models):
    """The port's encoder output of `batch()`'s features, fed to both
    packages' searches."""
    feats, feat_lens = _t(*batch()[:2])
    return models[3].encode(feats, feat_lens)


def test_greedy_decode_matches_jax(models, encoded):
    jc, jm, variables, port = models
    enc, enc_lens = encoded
    want = jax.jit(lambda p, e, el, la, ta: jax_whisper.whisper_greedy_decode(
        jm, p, e, el, la, ta, max_tokens=MAX_TOKENS))(
            variables, _j(enc), _j(enc_lens), _j(LANGS), _j(TASKS))
    got = whisper_greedy_decode(port, enc, enc_lens, *_t(LANGS, TASKS), max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    lens = got[1].numpy()
    assert lens.max() == MAX_TOKENS and lens.min() < MAX_TOKENS  # emits, and stops early


@pytest.mark.parametrize("length_penalty", [0.0, 0.5])
def test_beam_decode_matches_jax(models, encoded, length_penalty):
    jc, jm, variables, port = models
    enc, enc_lens = encoded
    want = jax.jit(lambda p, e, el, la, ta: jax_whisper.whisper_beam_decode(
        jm, p, e, el, la, ta, beam_size=BEAM, max_tokens=MAX_TOKENS,
        length_penalty=length_penalty))(variables, _j(enc), _j(enc_lens), _j(LANGS), _j(TASKS))
    got = whisper_beam_decode(port, enc, enc_lens, *_t(LANGS, TASKS), beam_size=BEAM,
                              max_tokens=MAX_TOKENS, length_penalty=length_penalty)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-4)
    lens = got[1].numpy()
    assert lens.max() > 0 and lens.min() < MAX_TOKENS  # emits, and stops early
