"""The trainer's options on the CPU: gradient checkpointing, gradient
accumulation and attention dropout.

- `encoder.gradient_checkpointing`: a tiny transducer (2 causal blocks,
  d32, dropout 0.1, dynamic chunks) gives the same loss and gradients with
  the flag on and off from the same step generators, every leaf to 1e-6 of
  its max (the recompute replays the same operations on the CPU), once on
  the module route with attention dropout 0.1 and once through the
  kernels' autograd Functions (`fused_attention`, `fused_ffn`; their plain
  versions here); each block runs twice with the flag and once without.
  With the dropout generator's replay stubbed out, the recompute draws
  fresh masks and the gradients move by more than 1e-2 of a leaf's max:
  the first test would catch that.
- `optim.accum_steps=2` (`AccumulatingAdam`) against JAX's
  `make_optimizer` (optax.MultiSteps over the Adam chain) and the JAX
  step's select guard (tpuasr/train/step.py:127-138), on a tiny CTCModel's
  converted weights, over 5 micro-steps with the third non-finite and the
  plateau scale at 0.5 in the second cycle: after each micro-step the
  parameters, mu, nu, nu_max, the gradient mean, the Adam count and the
  micro-step count; rtol 1e-5 (fp32 elementwise math in the same order),
  parameters also atol 1e-8 (p + update rounds to p's ulp), moments also
  atol 1e-6 of the leaf's max (where b1 * mu and (1 - b1) * u cancel, the
  rounding of the terms is all that is left).
- A run of the CTC step with accum_steps=2 saved after its first
  micro-step and resumed gives the uninterrupted run's losses, weights and
  optimizer state exactly, and the weights stay as they were after each
  odd micro-step.
- Attention dropout: in eval the module equals the JAX module (rate 0.1,
  deterministic) to rtol 2e-5 / atol 2e-6; in training it is a function of
  its generator, drops within 5 sigma of the binomial rate 0.1 of 4,096
  probabilities and scales the kept ones by 1/0.9 (rtol 1e-6); with
  `fused` it takes the plain route (kernel #2's wrapper is not called).
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpuasr_torch.nn.attention as port_attention
import tpuasr_torch.nn.conformer as port_conformer
from tpuasr.config import CTCModelConfig as JaxCTCConfig
from tpuasr.config import OptimConfig as JaxOptimConfig
from tpuasr.models import CTCModel as JaxCTCModel
from tpuasr.nn.attention import RelPositionMultiHeadedAttention as JaxAttention
from tpuasr.train.optim import make_optimizer as jax_make_optimizer
from tpuasr_torch.config import Config, CTCModelConfig, ModelConfig, OptimConfig
from tpuasr_torch.convert import convert_params, load_jax_params
from tpuasr_torch.data import BatchSpec, make_batch, synth_corpus, tensors
from tpuasr_torch.models import CTCModel, Transducer, init_weights
from tpuasr_torch.nn.attention import RelPositionMultiHeadedAttention
from tpuasr_torch.ops.relpos_attention import relpos_attention_plain
from tpuasr_torch.train import (
    AccumulatingAdam, TrainState, make_ctc_train_step, make_optimizer, restore_checkpoint,
    save_checkpoint,
)
from tpuasr_torch.train.optim import unflatten
from tpuasr_torch.train.step import step_generators

torch.set_num_threads(1)  # six test workers share the cores

# ------------------------------------------------------- gradient checkpointing


def _transducer_cfg(route: str, remat: bool) -> ModelConfig:
    mc = ModelConfig(vocab_size=64)
    e = mc.encoder
    e.output_size, e.attention_heads, e.linear_units, e.num_blocks = 32, 2, 64, 2
    e.cnn_module_kernel, e.causal, e.use_dynamic_chunk, e.static_chunk_size = 7, True, True, 4
    e.gradient_checkpointing = remat
    if route == "module":
        e.attention_dropout_rate = 0.1
    else:
        e.fused_attention = e.fused_ffn = True
    mc.predictor.embed_size = mc.predictor.hidden_size = 16
    mc.predictor.output_size = 32
    return mc


def _grads(route: str, remat: bool):
    """(loss, {name: grad}, block forward calls) of one training forward."""
    model = init_weights(Transducer(_transducer_cfg(route, remat), device="cpu"), 0)
    model.train()
    r = np.random.default_rng(1)
    batch = (torch.from_numpy(r.standard_normal((2, 67, 80)).astype(np.float32)),
             torch.tensor([67, 51], dtype=torch.int32),
             torch.from_numpy(r.integers(6, 64, (2, 5))), torch.tensor([5, 3], dtype=torch.int32))
    calls = []
    for blk in model.encoder.blocks:
        fwd = blk.forward
        blk.forward = lambda *a, _f=fwd, **k: calls.append(1) or _f(*a, **k)
    chunk_gen, drop_gen = step_generators(3, 0, torch.device("cpu"))
    loss = model(*batch, chunk_gen=chunk_gen, dropout_gen=drop_gen)["loss"]
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}, len(calls)


@pytest.mark.parametrize("route", ["module", "kernels"])
def test_gradient_checkpointing_gives_the_same_gradients(route):
    loss0, g0, calls0 = _grads(route, False)
    loss1, g1, calls1 = _grads(route, True)
    assert (calls0, calls1) == (2, 4)  # each block recomputed once in the backward
    assert loss0 == loss1
    for n in g0:
        assert (g1[n] - g0[n]).abs().max() <= 1e-6 * g0[n].abs().max(), n


def test_unreplayed_generator_gives_other_gradients(monkeypatch):
    _, g0, _ = _grads("module", False)
    monkeypatch.setattr(port_conformer, "replay_generator",
                        lambda gen, state: contextlib.nullcontext())
    _, g1, calls = _grads("module", True)
    assert calls == 4
    worst = max(float((g1[n] - g0[n]).abs().max() / g0[n].abs().max().clamp(min=1e-30))
                for n in g0)
    assert worst > 1e-2


# ------------------------------------------------------- gradient accumulation

def _jax_multisteps_step(tx, grads, opt, params, lr_scale):
    """The JAX train step's path for a non-guarded optimizer
    (tpuasr/train/step.py:127-138)."""
    finite = jnp.isfinite(optax.global_norm(grads))
    updates, new_opt = tx.update(grads, opt, params)
    new_params = optax.apply_updates(params, jax.tree.map(lambda u: u * lr_scale, updates))
    sel = lambda a, b: jax.tree.map(lambda x, y: jnp.where(finite, x, y), a, b)
    return sel(new_params, params), sel(new_opt, opt)


def test_accumulation_matches_optax_multisteps():
    kw = dict(lr=1e-2, warmup_steps=2, accum_steps=2)
    jtx = jax_make_optimizer(JaxOptimConfig(**kw))
    assert isinstance(jtx, optax.MultiSteps)
    jcfg = JaxCTCConfig(hidden_dim=16, attention_heads=2, num_blocks=1, kernel_size=3)
    r = np.random.default_rng(2)
    feats = r.standard_normal((1, 40, 80)).astype(np.float32)
    params = JaxCTCModel(jcfg, 20, 5).init(jax.random.PRNGKey(0), feats,
                                           np.array([40], np.int32))["params"]
    model = load_jax_params(CTCModel(CTCModelConfig(**dataclasses.asdict(jcfg)), 20, 5,
                                     device="cpu"), jax.tree.map(np.asarray, params))
    names = [n for n, _ in model.named_parameters()]
    ps = list(model.parameters())
    tx = make_optimizer(OptimConfig(**kw))
    assert isinstance(tx, AccumulatingAdam)
    state = tx.init(ps)
    jopt = jtx.init(params)
    leaves, tree = jax.tree.flatten(params)
    jstep = jax.jit(lambda g, o, p, sc: _jax_multisteps_step(jtx, g, o, p, sc))
    # gradient scales: a cycle clipped (the mean's norm > 1), a non-finite
    # micro-step, a cycle unclipped at plateau scale 0.5
    for i, (scale, lr_scale) in enumerate([(0.5, 1.0), (0.3, 1.0), (np.nan, 1.0),
                                           (1e-3, 0.5), (2e-3, 0.5)]):
        g = [(r.standard_normal(x.shape) * scale).astype(np.float32) for x in leaves]
        jg = jax.tree.unflatten(tree, [jnp.asarray(x) for x in g])
        params, jopt = jstep(jg, jopt, params, jnp.float32(lr_scale))
        conv_g = convert_params(jax.tree.map(np.asarray, jg))
        finite = torch.tensor(bool(np.all([np.isfinite(x).all() for x in g])))
        state = tx.update_guarded([conv_g[n] for n in names], state, ps, finite, lr_scale)
        inner = next(s for s in jopt.inner_opt_state if hasattr(s, "nu_max"))
        assert int(state.mini_step) == int(jopt.mini_step), i
        assert int(state.count) == int(inner.count) == int(jopt.gradient_step), i
        for label, mine, ref in (("params", ps, params), ("mu", unflatten(state.mu, ps), inner.mu),
                                 ("nu", unflatten(state.nu, ps), inner.nu),
                                 ("nu_max", unflatten(state.nu_max, ps), inner.nu_max),
                                 ("acc", unflatten(state.acc, ps), jopt.acc_grads)):
            conv = convert_params(jax.tree.map(np.asarray, ref))
            for n, x in zip(names, mine):
                want = conv[n].numpy()
                atol = 1e-8 if label == "params" else 1e-6 * float(np.abs(want).max())
                np.testing.assert_allclose(x.detach().numpy(), want, rtol=1e-5, atol=atol,
                                           err_msg=f"micro-step {i} {label} {n}")
    assert int(state.count) == 2 and int(state.mini_step) == 0


def _ctc_run(save_dir, micro_steps, resume_after=None):
    cfg = Config()
    cfg.ctc_model = CTCModelConfig(hidden_dim=16, attention_heads=2, num_blocks=1,
                                   kernel_size=3)
    cfg.model.vocab_size = 20
    cfg.optim.accum_steps, cfg.optim.lr, cfg.optim.warmup_steps = 2, 1e-2, 1
    utts = synth_corpus(2, 20, seed=4, min_tokens=2, max_tokens=3, sample_rate=48000,
                        samples_per_token=24 * 512, chord=True)
    batch = tensors(make_batch(utts, BatchSpec(2, 5 * 24 * 512, 5)), "cpu")

    def fresh():
        model = init_weights(CTCModel(cfg.ctc_model, 20, 5, device="cpu"), 0)
        tx = make_optimizer(cfg.optim)
        return model, tx, TrainState.create(model, tx)

    model, tx, state = fresh()
    step = make_ctc_train_step(model, tx, cfg)
    losses, weights = [], [torch.cat([p.detach().reshape(-1) for p in model.parameters()])]
    for i in range(micro_steps):
        if i == resume_after:
            path = os.path.join(save_dir, "mid")
            save_checkpoint(path, state)
            model, tx, target = fresh()
            state = restore_checkpoint(path, target)
            step = make_ctc_train_step(model, tx, cfg)
        state, m = step(state, batch, 0)
        losses.append(float(m["loss"]))
        weights.append(torch.cat([p.detach().reshape(-1) for p in model.parameters()]))
    return losses, weights, state


def test_accumulation_resume_mid_cycle_is_exact(tmp_path):
    losses, weights, state = _ctc_run(tmp_path, 4)
    assert torch.equal(weights[1], weights[0]) and torch.equal(weights[3], weights[2])
    assert not torch.equal(weights[2], weights[1])
    r_losses, r_weights, r_state = _ctc_run(tmp_path, 4, resume_after=1)
    assert r_losses == losses
    assert all(torch.equal(a, b) for a, b in zip(weights, r_weights))
    for a, b in zip(state.opt_state, r_state.opt_state):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(r_state.opt_state.count) == 2 and r_state.step == 4


# ------------------------------------------------------------ attention dropout

B, T, H, D = 2, 21, 2, 32


def test_attention_dropout_eval_matches_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((B, T, D)).astype(np.float32)
    pe = (r.standard_normal((1, T, D)) * 0.5).astype(np.float32)
    mask = np.tril(np.ones((T, T), bool))[None].repeat(B, 0)
    jmod = JaxAttention(H, D, 0.1)
    params = jmod.init(jax.random.PRNGKey(0), x, mask, pe)
    want, _ = jmod.apply(params, x, mask, pe, deterministic=True)
    mod = RelPositionMultiHeadedAttention(H, D, 0.1, fused=True, device="cpu")
    mod.load_state_dict(convert_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got, _ = mod(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


def test_attention_dropout_in_training():
    s = 64
    r = np.random.default_rng(1)
    q, k = (torch.from_numpy(r.standard_normal((1, s, s)).astype(np.float32))
            for _ in range(2))
    p = torch.from_numpy(r.standard_normal((1, s, s)).astype(np.float32))
    v = torch.eye(s)[None]  # one head of width S: out = the probabilities
    zero = torch.zeros(s)
    mask = torch.ones((1, s, s), dtype=torch.bool)
    args = (q, k, p, v, zero, zero, mask, 0.125, 1)
    probs = relpos_attention_plain(*args)
    drawn = [relpos_attention_plain(*args, dropout_rate=0.1,
                                    gen=torch.Generator().manual_seed(seed))
             for seed in (7, 7, 8)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], drawn[2])
    dropped = drawn[0] == 0
    n = s * s
    assert abs(int(dropped.sum()) - 0.1 * n) <= 5 * (n * 0.1 * 0.9) ** 0.5
    torch.testing.assert_close(drawn[0][~dropped], probs[~dropped] / 0.9, rtol=1e-6, atol=0)


def test_fused_attention_with_dropout_takes_the_plain_route(monkeypatch):
    calls = []
    monkeypatch.setattr(port_attention, "relpos_attention",
                        lambda *a, **k: calls.append(1) or relpos_attention_plain(*a))
    x = torch.randn(B, T, D)
    pe = torch.randn(1, T, D)
    mask = torch.ones((B, T, T), dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    for rate, want in ((0.1, 0), (0.0, 1)):
        mod = RelPositionMultiHeadedAttention(H, D, rate, fused=True, device="cpu")
        mod(x, mask, pe, gen=gen)
        assert len(calls) == want, rate
