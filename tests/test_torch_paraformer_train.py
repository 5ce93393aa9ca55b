"""The Paraformer's training step, glancing sampler and CLIs == JAX on the
CPU.

The tiny models of tests/test_torch_paraformer.py (converted weights, the
CIF head's bias at -1):

- both stacks with the CTC branch (weight 0.3) and the timestamp branch on,
  the glancing sampler on the same uniform scores on both sides (the JAX
  draw `jax.random.uniform` replaced by those scores for the call): the loss
  dict within 1e-5 relative and every gradient leaf within 1e-4 of its max
  |g| + 1e-7 (the key projections' biases, no gradient in exact arithmetic,
  within 1e-6 of the largest gradient entry: rounding noise);
- `_sample_embeds` on JAX's own draw (`jax.random.uniform(key, ys.shape)`
  fed to the port): exact;
- `make_train_step` passes the sampler its generator on training steps
  only: the same seed gives the same step, and the eval step's loss is the
  model's without the sampler;
- `python -m tpuasr_torch.tools.train --workload paraformer --device cpu`
  trains an epoch of the tiny hard corpus for each stack (finite losses, no
  skipped step, the stack in the saved train.yaml), and `evaluate
  --workload paraformer` decodes its checkpoint in paraformer_greedy and
  paraformer_beam to the JAX package's `evaluate_offline` result on the
  same weights (converted back to the flax layout): S/D/I/N and every
  (utt, REF, HYP) sample identical.
"""

import math

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_paraformer import batch, build, jax_cfg
from tests.test_torch_zoo import flax_variables
from tools.train import build_model as jax_build_model
from tpuasr.config import Config as JaxConfig
from tpuasr.config import from_dict as jax_from_dict
from tpuasr.data.corpus import synthetic_pipeline as jax_synthetic_pipeline
from tpuasr.eval import evaluate_offline as jax_evaluate_offline
from tpuasr.models import paraformer as jax_para
from tpuasr.text import Tokenizer as JaxTokenizer
from tpuasr_torch.audio import fbank_batch
from tpuasr_torch.config import Config, load_yaml, override, to_dict
from tpuasr_torch.convert import convert_params
from tpuasr_torch.data import synthetic_pipeline, tensors
from tpuasr_torch.tools import evaluate
from tpuasr_torch.tools.train import build_model, main as train_main
from tpuasr_torch.train import make_eval_step, make_optimizer, make_train_step, TrainState

torch.set_num_threads(1)  # six test workers share the cores

TINY = {"model.vocab_size": 32, "model.encoder.num_blocks": 2,
        "model.encoder.output_size": 32, "model.encoder.attention_heads": 2,
        "model.encoder.linear_units": 64, "model.encoder.cnn_module_kernel": 7,
        "model.att_decoder.blocks": 1, "model.att_decoder.heads": 2,
        "model.att_decoder.ffn": 64, "data.batch_size": 4, "data.synth_hard": True,
        "data.synth_min_tokens": 2, "data.synth_max_tokens": 4, "train.log_every": 1,
        "train.log_dir": ""}
SANM = {"model.encoder.encoder_type": "sanm"}


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("stack", ["conformer", "sanm"])
def test_loss_and_every_gradient_match_jax(stack, monkeypatch):
    jc = jax_cfg(stack, ctc_weight=0.3, timestamp_branch=True)
    jm, variables, port = build(jc)
    data = batch()
    scores = np.random.default_rng(9).uniform(size=(2, data[2].shape[1] + 1)).astype(np.float32)
    # the JAX model's draw, replaced by the scores both sides sample on
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jax.numpy.asarray(
        scores))

    def loss_fn(p):
        out = jm.apply({"params": p}, *data, rngs={"sampler": jax.random.PRNGKey(0)})
        return out["loss"], out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    port.train()
    out = port(*_t(*data), sampler_scores=_t(scores)[0])
    out["loss"].backward()
    assert set(out) == set(ref) == {"loss", "loss_ce", "loss_quantity", "loss_ctc",
                                    "loss_quantity_tp"}
    for k in out:
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]), rtol=1e-5, err_msg=k)
    want = convert_params(jax.tree.map(np.asarray, grads))
    got = dict(port.named_parameters())
    assert want.keys() == got.keys()
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in got.items():
        g, w = p.grad.numpy(), want[name].numpy()
        err = float(np.abs(g - w).max())
        if name.endswith("linear_k.bias"):  # shift-free: rounding noise
            assert err <= 1e-6 * scale, (name, err, scale)
        else:
            assert err <= 1e-4 * float(np.abs(w).max()) + 1e-7, (name, err)
    assert float(got["sampler_embed.weight"].grad.abs().max()) > 0  # the sampler replaced some


@pytest.mark.parametrize("stack", ["conformer", "sanm"])
def test_sample_embeds_on_jax_draw(stack):
    jc = jax_cfg(stack, sampling_ratio=0.75)
    jm, variables, port = build(jc)
    r = np.random.default_rng(11)
    t = 15 if stack == "conformer" else 34
    enc = r.standard_normal((3, t, 32)).astype(np.float32)
    enc_lens = np.array([t, t - 4, 6], np.int32)
    ys = r.integers(6, 24, (3, 6)).astype(np.int32)
    ys_lens = np.array([6, 4, 1], np.int32)
    acoustic = r.standard_normal((3, 6, 32)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want = jm.apply(variables, key, enc, enc_lens, ys, ys_lens, acoustic,
                    method=jax_para.Paraformer._sample_embeds)
    scores = np.asarray(jax.random.uniform(key, ys.shape))
    got = port._sample_embeds(*_t(enc, enc_lens, ys.astype(np.int64), ys_lens, acoustic,
                                  scores))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    replaced = ~np.isclose(np.asarray(want), acoustic).all(-1)
    valid = np.arange(6)[None, :] < ys_lens[:, None]
    assert replaced[valid].any() and (~replaced)[valid].any()


def _tiny_cfg(stack: str) -> Config:
    return override(Config(), {**TINY, **(SANM if stack == "sanm" else {})})


def test_train_step_gives_the_sampler_its_generator():
    cfg = _tiny_cfg("conformer")
    b = tensors(next(iter(synthetic_pipeline(cfg, 4, seed=0).batches(0))), "cpu")
    runs = []
    for seed in (5, 5, 6):
        model = build_model(cfg, "paraformer", "cpu")
        step = make_train_step(model, make_optimizer(cfg.optim), cfg)
        _, metrics = step(TrainState.create(model, make_optimizer(cfg.optim)), b, seed)
        runs.append(float(metrics["loss"]))
    assert runs[0] == runs[1] and all(math.isfinite(x) for x in runs)
    model = build_model(cfg, "paraformer", "cpu")
    got = make_eval_step(model, cfg)(b, 5)
    with torch.no_grad():  # eval(): no dropout, and no sampler without its generator
        feats, lens = fbank_batch(b["waves"], b["wave_lens"], cfg.feature, device="cpu")
        want = model(feats, lens, b["texts"], b["text_lens"])
    assert float(got["loss"]) == float(want["loss"]) and set(got) == set(want)


@pytest.fixture(scope="module", params=["conformer", "sanm"])
def trained(request, tmp_path_factory):
    """One epoch of the trainer CLI on the CPU -> (stack, save dir, result)."""
    stack = request.param
    d = tmp_path_factory.mktemp(f"paraformer_{stack}")
    sets = {**TINY, **(SANM if stack == "sanm" else {}), "train.save_dir": str(d)}
    run = train_main(["--workload", "paraformer", "--synthetic", "8", "--epochs", "1",
                      "--device", "cpu", "--set", *(f"{k}={v}" for k, v in sets.items())])
    return stack, d, run


def test_trainer_cli_trains_an_epoch(trained):
    stack, d, run = trained
    assert all(math.isfinite(x) for x in run.train_losses + run.dev_losses)
    assert int(run.state.skipped) == 0 and run.state.step > 0
    assert load_yaml(str(d / "train.yaml")).model.encoder.encoder_type == \
        ("sanm" if stack == "sanm" else "conformer")
    assert (type(run.state.model.encoder).__name__ == "SanmEncoder") == (stack == "sanm")


@pytest.mark.parametrize("mode", ["paraformer_greedy", "paraformer_beam"])
def test_evaluate_cli_matches_jax(trained, mode):
    stack, d, run = trained
    res = evaluate.main(["--checkpoint", str(d / "latest"), "--workload", "paraformer",
                         "--mode", mode, "--synthetic", "4", "--device", "cpu",
                         "--max_samples", "4"])
    cfg = load_yaml(str(d / "train.yaml"))
    jcfg = jax_from_dict(JaxConfig, to_dict(cfg))
    jcfg.feature.use_pallas = False
    jm = jax_build_model(jcfg, "paraformer")
    first = next(iter(synthetic_pipeline(cfg, 4, seed=1).batches(0)))
    feats = np.zeros((first["waves"].shape[0], 40, 80), np.float32)
    params = flax_variables(jm, run.state.model.cpu(), feats,
                            np.full(feats.shape[0], 40, np.int32),
                            np.asarray(first["texts"]), np.asarray(first["text_lens"]))
    tok = JaxTokenizer(tokens=[f"syl{i}" for i in range(cfg.model.vocab_size - 6)])
    want = jax_evaluate_offline(jm, params, jax_synthetic_pipeline(jcfg, 4, seed=1).batches(0),
                                jcfg, tok, mode=mode, max_samples=4)
    c, w = res.counts, want.counts
    assert (c.substitutions, c.deletions, c.insertions, c.ref_len) == \
        (w.substitutions, w.deletions, w.insertions, w.ref_len)
    assert res.samples == want.samples and c.ref_len > 0
