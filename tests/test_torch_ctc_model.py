"""The CTC workload's model and steps == JAX on the CPU.

- `Conv2dSubsampling4/6/8`: `output_len` and `subsampled_mask` equal the JAX
  package's at every T from 1 to 70, and the module's frame count is
  `output_len` wherever that is at least 1 (exact).
- `CTCModel` (hidden 32, 2 heads, 2 blocks, conv kernel 7, vocab 40) on
  converted weights, for conv2d8 and conv2d6, on a batch of 4 with odd,
  short and zero-padded T (101, 77, 40, 23 frames; 6, 4, 6, 2 labels; the
  40-frame row has fewer frames after subsampling than labels): out_lens
  exact; log-probs at every valid frame to atol 1e-5 (fp32, the same
  operations in another order); the loss to rtol 1e-5 and the per-row
  losses to atol 1e-4, the infeasible row 0 on both sides (zero_infinity);
  every gradient leaf to 1e-4 of the leaf's max |g| + 1e-6.
- On the fixtures: the CTCModel of tools/make_fixtures.py (16 kHz,
  PRNGKey(1234)) on fixtures/example1.npz: the port's fbank and model on
  converted weights give the JAX model's log-probs to atol 1e-3 at every
  valid frame (both fbanks plain fp32 "highest"; their dB outputs differ by
  ~1e-5 and two blocks carry it), and the output lengths stored in
  fixtures/example2.npz exactly (its float16 log-probs are not held: the
  JAX package itself now differs from them by up to 9e-3).
- The CTC train and eval steps against tools/train.py's `step_fn` and
  `eval_fn` (captured from `_train_ctc` with `train_loop` stubbed), fp32,
  no dropout (the positional dropout's rate set to 0 on both sides), two
  steps at lr 1e-2 with warmup 1, each from the JAX step's own start
  (weights and Adam state converted): loss and eval loss to rtol 1e-5,
  gradient norm to rtol 1e-4, Adam count, mu (the clipped gradient) to
  1e-3 of the larger of the leaf's max and the model's (the two fbanks
  differ by ~1e-5 dB, which flips a first-conv ReLU here and there: one
  bias entry of the first conv moves by 4e-4 of the model's max; its
  weight's gradient sums ~4e5 products of dB values near +-100 and is off
  by 3e-4 of its max), and the parameters' updates: within 1e-3 of a
  step where both moments agree to 1e-4 entry by entry (and |mu| >= 1e-7),
  within 2 steps elsewhere (an Adam step moves an entry by at most ~lr).
- With dropout (the default 0.1) the port's CTC step is a function of
  (seed, step): the same seed twice gives the same weights, another seed
  other ones.
- A CTCModel tree with scanned blocks (`scan_layers`) converts: log-probs
  to atol 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.train as jax_train_cli
import tpuasr.models.ctc_model as jax_ctc_module
import tpuasr.train.loop as jax_loop
import tpuasr_torch.models.ctc_model as port_ctc_module
from tpuasr.audio import fbank_batch as jax_fbank_batch
from tpuasr.config import Config as JaxConfig
from tpuasr.config import CTCModelConfig as JaxCTCConfig
from tpuasr.config import FeatureConfig as JaxFeatureConfig
from tpuasr.losses import ctc_loss_from_logits as jax_ctc_loss
from tpuasr.models import CTCModel as JaxCTCModel
from tpuasr.nn.subsampling import SUBSAMPLE_CLASSES as JAX_SUB
from tpuasr.nn.subsampling import subsampled_mask as jax_subsampled_mask
from tpuasr_torch.audio import fbank_batch
from tpuasr_torch.config import Config, CTCModelConfig, FeatureConfig
from tpuasr_torch.convert import convert_params, load_jax_params
from tpuasr_torch.data import BatchSpec, make_batch, synth_corpus, tensors
from tpuasr_torch.losses import ctc_loss_from_logits
from tpuasr_torch.models import CTCModel, init_weights
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES, subsampled_mask
from tpuasr_torch.train import (
    TrainState, make_ctc_eval_step, make_ctc_train_step, make_optimizer,
)
from tpuasr_torch.train.optim import FusedAdamState, flatten, unflatten

torch.set_num_threads(1)  # six test workers share the cores

TINY = dict(hidden_dim=32, attention_heads=2, num_blocks=2, kernel_size=7)
V, BLANK = 40, 5
_ENCODER_CFG = jax_ctc_module._encoder_cfg


@pytest.mark.parametrize("layer", sorted(SUBSAMPLE_CLASSES))
def test_subsampling_lengths_and_masks_match_jax(layer):
    sub = SUBSAMPLE_CLASSES[layer]
    module = sub(20, 8, device="cpu")
    for t in range(1, 71):
        assert sub.output_len(t) == JAX_SUB[layer].output_len(t), t
        lens = np.arange(1, t + 1, dtype=np.int32)[::-1][:5]
        mask = np.arange(t)[None, None, :] < lens[:, None, None]
        want = np.asarray(jax_subsampled_mask(mask, layer))  # numpy slices
        got = subsampled_mask(torch.from_numpy(mask), layer).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{layer} T {t}")
        assert got.shape[-1] == max(sub.output_len(t), 0) or sub.output_len(t) < 1
        if sub.output_len(t) >= 1:
            with torch.no_grad():
                assert module(torch.zeros(1, t, 20)).shape[1] == sub.output_len(t), t


def _batch():
    r = np.random.default_rng(7)
    lens = np.array([101, 77, 40, 23], np.int32)
    feats = r.standard_normal((4, 101, 80)).astype(np.float32)
    feats[np.arange(101)[None, :] >= lens[:, None]] = 0.0  # zero padding
    texts = r.integers(6, V, size=(4, 6)).astype(np.int32)
    texts[3, :2] = [7, 9]
    return feats, lens, texts, np.array([6, 4, 6, 2], np.int32)


@pytest.fixture(scope="module", params=["conv2d8", "conv2d6"])
def ctc_pair(request):
    jcfg = JaxCTCConfig(subsampling=request.param, **TINY)
    batch = _batch()
    model = JaxCTCModel(jcfg, V, BLANK)
    params = model.init(jax.random.PRNGKey(3), *batch)

    def fwd(p):
        lp, out_lens, loss = model.apply({"params": p}, *batch)
        return loss, (lp, out_lens)

    (loss, (lp, out_lens)), grads = jax.jit(jax.value_and_grad(fwd, has_aux=True))(
        params["params"])
    logits, _ = model.apply(params, batch[0], batch[1], method=JaxCTCModel.encode)
    rows = jax_ctc_loss(logits, out_lens, batch[2], batch[3], BLANK, "none")
    ref = {k: np.asarray(v) for k, v in dict(loss=loss, lp=lp, out_lens=out_lens,
                                              rows=rows).items()}
    port = load_jax_params(
        CTCModel(CTCModelConfig(subsampling=request.param, **TINY), V, BLANK, device="cpu"),
        jax.tree.map(np.asarray, params))
    return ref, jax.tree.map(np.asarray, grads), port, [torch.from_numpy(x) for x in batch]


def test_ctc_model_forward_matches_jax(ctc_pair):
    ref, _, port, batch = ctc_pair
    with torch.no_grad():
        lp, out_lens, loss = port(*batch)
        logits, _ = port.encode(*batch[:2])
        rows = ctc_loss_from_logits(logits, out_lens, batch[2], batch[3], BLANK, "none")
    np.testing.assert_array_equal(out_lens.numpy(), ref["out_lens"])
    assert out_lens[2] < batch[3][2]  # the infeasible row
    valid = np.arange(lp.shape[1])[None, :] < ref["out_lens"][:, None]
    assert lp.shape == ref["lp"].shape
    np.testing.assert_allclose(lp.numpy()[valid], ref["lp"][valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(rows.numpy(), ref["rows"], rtol=0, atol=1e-4)
    assert float(rows[2]) == float(ref["rows"][2]) == 0.0


def test_ctc_model_gradients_match_jax(ctc_pair):
    _, grads, port, batch = ctc_pair
    port.zero_grad(set_to_none=True)
    port(*batch)[2].backward()
    want = convert_params(grads)
    got = dict(port.named_parameters())
    assert want.keys() == got.keys()
    for name, p in got.items():
        g, w = p.grad.numpy(), want[name].numpy()
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= 1e-4 * scale + 1e-6, (name, err, scale)


def test_fixture_ctc_model_reproduces_jax():
    fx = np.load("fixtures/example1.npz")
    waves, wave_lens = fx["waves"].astype(np.float32), fx["wave_lens"]
    jfeats, jlens = jax_fbank_batch(waves, wave_lens,
                                    JaxFeatureConfig(sample_rate=16000, use_pallas=False))
    jcfg = JaxCTCConfig(**TINY)
    model = JaxCTCModel(jcfg, V, BLANK)
    params = model.init(jax.random.PRNGKey(1234), np.asarray(jfeats), np.asarray(jlens),
                        fx["texts"], fx["text_lens"])
    want, want_lens, _ = model.apply(params, np.asarray(jfeats), np.asarray(jlens))
    want, want_lens = np.asarray(want), np.asarray(want_lens)

    port = load_jax_params(CTCModel(CTCModelConfig(**TINY), V, BLANK, device="cpu"),
                           jax.tree.map(np.asarray, params))
    with torch.no_grad():
        feats, lens = fbank_batch(waves, wave_lens, FeatureConfig(sample_rate=16000),
                                  device="cpu")
        lp, out_lens, _ = port(feats, lens)
    np.testing.assert_array_equal(out_lens.numpy(), want_lens)
    valid = np.arange(lp.shape[1])[None, :] < want_lens[:, None]
    np.testing.assert_allclose(lp.numpy()[valid], want[valid], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(np.load("fixtures/example2.npz")["lens"], want_lens)


# ---------------------------------------------------------------- the steps

def _no_pos_dropout(fn):
    return lambda c: dataclasses.replace(fn(c), positional_dropout_rate=0.0)


def _step_batch(vocab: int) -> dict:
    utts = synth_corpus(4, vocab, seed=5, min_tokens=3, max_tokens=5, sample_rate=48000,
                        samples_per_token=24 * 512, chord=True)
    return make_batch(utts, BatchSpec(4, 7 * 24 * 512, 8))


@pytest.fixture(scope="module")
def jax_ctc_steps():
    """tools/train.py's CTC step_fn / eval_fn / initial state, captured
    from `_train_ctc` with `train_loop` stubbed; fp32, no dropout."""
    cfg = JaxConfig()
    cfg.ctc_model = JaxCTCConfig(**{**TINY, "num_blocks": 1, "dropout_rate": 0.0})
    cfg.model.vocab_size = V
    cfg.optim.lr, cfg.optim.warmup_steps = 1e-2, 1
    batch = _step_batch(V)
    captured = {}

    def stub(cfg, model, state, train_pipe, dev_pipe, step_fn, eval_fn, epochs):
        captured.update(state=state, step_fn=step_fn, eval_fn=eval_fn)
        return types.SimpleNamespace(train_losses=[])

    pipe = types.SimpleNamespace(batches=lambda epoch: iter([batch]))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_loop, "train_loop", stub)
    mp.setattr(jax_ctc_module, "_encoder_cfg", _no_pos_dropout(jax_ctc_module._encoder_cfg))
    try:
        jax_train_cli._train_ctc(cfg, None, pipe, pipe, types.SimpleNamespace(epochs=1))
        jb = {k: jnp.asarray(batch[k]) for k in ("waves", "wave_lens", "texts", "text_lens")}
        states, metrics = [captured["state"]], []
        for _ in range(2):
            st, m = captured["step_fn"](states[-1], jb, jax.random.PRNGKey(0))
            states.append(st)
            metrics.append({k: np.asarray(v) for k, v in m.items()})
        dev_loss = float(captured["eval_fn"](states[0].params, jb, jax.random.PRNGKey(0))["loss"])
    finally:
        mp.undo()
    return cfg, batch, states, metrics, dev_loss


def _port_state(model, names, jst) -> TrainState:
    """The JAX TrainState `jst` (params, Adam state, step) in the port."""
    load_jax_params(model, jax.tree.map(np.asarray, jst.params))
    flat = lambda tree: flatten(
        [convert_params(jax.tree.map(np.asarray, tree))[n] for n in names])
    o = jst.opt_state
    opt = FusedAdamState(torch.tensor(int(o.count), dtype=torch.int32), flat(o.mu), flat(o.nu),
                         flat(o.nu_max))
    return TrainState(model, opt, int(jst.step), float(jst.lr_scale),
                      torch.zeros((), dtype=torch.int32))


def test_ctc_train_and_eval_steps_match_jax(jax_ctc_steps, monkeypatch):
    jcfg, batch, states, metrics, dev_loss = jax_ctc_steps
    monkeypatch.setattr(port_ctc_module, "encoder_config",
                        _no_pos_dropout(port_ctc_module.encoder_config))
    cfg = Config()
    cfg.ctc_model = CTCModelConfig(**dataclasses.asdict(jcfg.ctc_model))
    cfg.model.vocab_size = V
    cfg.optim.lr, cfg.optim.warmup_steps = 1e-2, 1
    model = CTCModel(cfg.ctc_model, V, BLANK, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    tx = make_optimizer(cfg.optim)
    tb = tensors(batch, "cpu")
    _port_state(model, names, states[0])
    np.testing.assert_allclose(float(make_ctc_eval_step(model, cfg)(tb, 0)["loss"]), dev_loss,
                               rtol=1e-5)
    step = make_ctc_train_step(model, tx, cfg)
    lr_step = cfg.optim.lr  # warmup 1: every step is lr
    for i in (1, 2):  # each step from the JAX step's own start
        state = _port_state(model, names, states[i - 1])
        before = [p.detach().clone() for p in model.parameters()]
        state, m = step(state, tb, 0)
        ref, jst = metrics[i - 1], states[i]
        np.testing.assert_allclose(float(m["loss"]), float(ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref["grad_norm"]), rtol=1e-4)
        assert bool(m["finite"]) and bool(ref["finite"])
        assert int(state.opt_state.count) == int(jst.opt_state.count) == i
        assert state.step == int(jst.step) == i
        mu_ref, nu_ref, p_ref = (convert_params(jax.tree.map(np.asarray, t)) for t in (
            jst.opt_state.mu, jst.opt_state.nu, jst.params["params"]))
        top = max(float(np.abs(w.numpy()).max()) for w in mu_ref.values())
        for n, mu, nu, p, p0 in zip(names, unflatten(state.opt_state.mu, before),
                                    unflatten(state.opt_state.nu, before),
                                    model.parameters(), before):
            w, v = mu_ref[n].numpy(), nu_ref[n].numpy()
            mu_err, nu_err = np.abs(mu.numpy() - w), np.abs(nu.numpy() - v)
            assert mu_err.max() <= 1e-3 * max(np.abs(w).max(), top), n
            # where both moments agree to 1e-4, so must the update
            sure = (np.abs(w) >= 1e-7) & (mu_err <= 1e-4 * np.abs(w)) & (nu_err <= 1e-4 * v)
            diff = np.abs((p.detach() - p0).numpy() - (p_ref[n] - p0).numpy())
            assert (diff[sure] <= 1e-3 * lr_step).all(), (n, diff[sure].max())
            assert (diff <= 2 * lr_step + 1e-7).all(), (n, diff.max())


def test_ctc_train_step_dropout_follows_the_seed():
    cfg = Config()
    cfg.ctc_model = CTCModelConfig(**{**TINY, "num_blocks": 1})
    cfg.model.vocab_size = V
    tb = tensors(_step_batch(V), "cpu")
    outs = []
    for seed in (0, 0, 1):
        model = init_weights(CTCModel(cfg.ctc_model, V, BLANK, device="cpu"), 0)
        tx = make_optimizer(cfg.optim)
        state, m = make_ctc_train_step(model, tx, cfg)(TrainState.create(model, tx), tb, seed)
        outs.append((float(m["loss"]), torch.cat([p.detach().reshape(-1)
                                                  for p in model.parameters()])))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])
    assert outs[0][0] != outs[2][0]


def test_scanned_ctc_tree_converts(monkeypatch):
    """A CTCModel whose encoder stacks its blocks with `scan_layers`
    (a leading [L] axis, set through the JAX `_encoder_cfg`) converts as
    the transducer's does: the port's log-probs equal JAX's (atol 1e-5)."""
    monkeypatch.setattr(jax_ctc_module, "_encoder_cfg", lambda c: dataclasses.replace(
        _ENCODER_CFG(c), scan_layers=True))
    feats, lens, texts, text_lens = _batch()
    model = JaxCTCModel(JaxCTCConfig(**TINY), V, BLANK)
    params = model.init(jax.random.PRNGKey(5), feats, lens)
    assert "layers" in params["params"]["encoder"]
    want, want_lens, _ = (np.asarray(x) if x is not None else None
                          for x in model.apply(params, feats, lens))
    port = load_jax_params(CTCModel(CTCModelConfig(**TINY), V, BLANK, device="cpu"),
                           jax.tree.map(np.asarray, params))
    with torch.no_grad():
        lp, out_lens, _ = port(torch.from_numpy(feats), torch.from_numpy(lens))
    valid = np.arange(lp.shape[1])[None, :] < want_lens[:, None]
    np.testing.assert_allclose(lp.numpy()[valid], want[valid], rtol=0, atol=1e-5)
