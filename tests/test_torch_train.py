"""The port's training slice == JAX on the CPU, on the tiny flagship
(`__graft_entry__._flagship_config(tiny=True)`: 2 causal conformer blocks,
d32, scanned JAX layout) with the fused joint loss, no dropout and a static
chunk of 4.

- The Transducer's training forward: the loss dict against JAX
  `model.apply` (fused loss through Pallas interpret mode, plain CTC);
  fp32, two blocks of sums in another order: atol 1e-4 on losses of ~20-40.
- Every parameter gradient against `jax.grad`, through the converter's
  mapping: max |diff| <= 1e-4 · max |g| of the leaf + 1e-6 (fp32 sums in
  another order through two blocks, the lattice and the fused joint).
- Two `GuardedAdam` steps (clipped, then unclipped) against JAX's
  `GuardedAdam.update_guarded` on the same gradients and global norm:
  parameters, mu, nu,
  nu_max and count, rtol 1e-5 (fp32 elementwise math in the same order);
  parameters also atol 1e-8, 1e-5 of a step of lr 1e-3, since p + update
  rounds to the ulp of p (7e-9 at |p| ~ 0.1).
- A non-finite step leaves parameters, moments and count untouched, in the
  optimizer and through `make_train_step`.
- The dynamic-chunk draw: given JAX's drawn integers, the port builds JAX's
  `add_optional_chunk_mask` mask exactly.
- `make_train_step`: the same seed and step give the same step, another seed
  a different one; `make_eval_step` is deterministic.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.config import OptimConfig as JaxOptimConfig
from tpuasr.config import to_dict
from tpuasr.models import Transducer as JaxTransducer
from tpuasr.nn.masks import add_optional_chunk_mask as jax_chunk_mask
from tpuasr.train.optim import GuardedAdam as JaxGuardedAdam
from tpuasr_torch.config import Config, ModelConfig, OptimConfig, from_dict
from tpuasr_torch.convert import convert_params, load_jax_params
from tpuasr_torch.models import Transducer, init_weights
from tpuasr_torch.nn.masks import (
    add_optional_chunk_mask, chunk_mask, draw_dynamic_chunk, dynamic_chunk_size,
)
from tpuasr_torch.train import TrainState, make_eval_step, make_optimizer, make_train_step
from tpuasr_torch.train.optim import unflatten

LOSS_ATOL, GRAD_REL, ADAM_RTOL = 1e-4, 1e-4, 1e-5


def _jax_cfg():
    mc = _flagship_config(tiny=True).model
    mc.fused_joint_loss = True
    mc.ctc_dropout_rate = 0.0
    mc.encoder = dataclasses.replace(mc.encoder, use_dynamic_chunk=False, static_chunk_size=4)
    return mc


@pytest.fixture(scope="module")
def setup():
    mc = _jax_cfg()
    r = np.random.default_rng(0)
    feats = r.standard_normal((2, 67, 80)).astype(np.float32)
    feat_lens = np.array([67, 51], np.int32)
    texts = r.integers(6, mc.vocab_size, size=(2, 5)).astype(np.int32)
    text_lens = np.array([5, 3], np.int32)
    model = JaxTransducer(mc)
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, texts, text_lens)
    loss_fn = lambda p: model.apply({"params": p}, feats, feat_lens, texts, text_lens)
    (_, ref), grads = jax.jit(jax.value_and_grad(lambda p: (loss_fn(p)["loss"], loss_fn(p)),
                                                 has_aux=True))(params["params"])
    np_params = jax.tree.map(np.asarray, params)
    port = load_jax_params(Transducer(from_dict(ModelConfig, to_dict(mc)), device="cpu"),
                           np_params)
    batch = tuple(torch.from_numpy(x) for x in (feats, feat_lens, texts, text_lens))
    return mc, np_params, jax.tree.map(np.asarray, grads), ref, port, batch


def test_training_forward_matches_jax(setup):
    _, _, _, ref, port, batch = setup
    port.train()  # no dropout rate is set: train() needs no generator
    got = port(*batch)
    assert set(got) == {"loss", "loss_rnnt", "loss_ctc"}
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)


def test_every_gradient_matches_jax(setup):
    _, _, grads, _, port, batch = setup
    port.train()
    port.zero_grad(set_to_none=True)
    port(*batch)["loss"].backward()
    want = convert_params(grads)
    got = dict(port.named_parameters())
    assert want.keys() == got.keys()
    for name, p in got.items():
        g, w = p.grad.numpy(), want[name].numpy()
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale + 1e-6, (name, err, scale)


def _adam_cfgs():
    kw = dict(lr=1e-3, warmup_steps=3)
    return JaxOptimConfig(**kw), OptimConfig(**kw)


def test_guarded_adam_matches_jax(setup):
    _, np_params, grads, _, _, _ = setup
    jcfg, cfg = _adam_cfgs()
    jtx = JaxGuardedAdam(jcfg)
    update = jax.jit(jtx.update_guarded)
    jp = jax.tree.map(jnp.asarray, np_params["params"])
    jstate = jtx.init(jp)
    model = load_jax_params(Transducer(from_dict(ModelConfig, to_dict(_jax_cfg())),
                                       device="cpu"), np_params)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    tx = make_optimizer(cfg)
    state = tx.init(params)
    gn = float(np.sqrt(sum(float(np.sum(np.square(g))) for g in jax.tree.leaves(grads))))
    for scale in (1.0, 0.5 / gn):  # clipped (gn ~ 10^2 > 1), then unclipped (0.5)
        jg = jax.tree.map(lambda g: jnp.asarray(g) * scale, grads)
        # one global norm for both: g/gn*clip + decay cancels for some
        # entries, where the norm's last bit (a sum in another order) would
        # show through the update
        jgn = optax.global_norm(jg)
        jp, jstate = update(jg, jstate, jp, jnp.bool_(True), grad_norm=jgn)
        conv = convert_params(jax.tree.map(np.asarray, jg))
        state = tx.update_guarded([conv[n] for n in names], state, params, torch.tensor(True),
                                  grad_norm=torch.tensor(np.asarray(jgn)))
    assert int(state.count) == int(jstate.count) == 2
    for label, mine, ref in (("params", params, jp), ("mu", unflatten(state.mu, params),
                                                        jstate.mu),
                             ("nu", unflatten(state.nu, params), jstate.nu),
                             ("nu_max", unflatten(state.nu_max, params), jstate.nu_max)):
        conv = convert_params(jax.tree.map(np.asarray, ref))
        for n, x in zip(names, mine):
            np.testing.assert_allclose(x.detach().numpy(), conv[n].numpy(), rtol=ADAM_RTOL,
                                       atol=1e-8 if label == "params" else 1e-12,
                                       err_msg=f"{label} {n}")


def test_nonfinite_step_changes_nothing(setup):
    _, np_params, grads, _, _, _ = setup
    model = load_jax_params(Transducer(from_dict(ModelConfig, to_dict(_jax_cfg())),
                                       device="cpu"), np_params)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    tx = make_optimizer(_adam_cfgs()[1])
    state = tx.init(params)
    conv = convert_params(grads)
    state = tx.update_guarded([conv[n] for n in names], state, params, torch.tensor(True))
    before = ([p.detach().clone() for p in params], state.mu.clone(), state.nu.clone(),
              state.nu_max.clone(), int(state.count))
    bad = [conv[n].clone() for n in names]
    bad[3].view(-1)[0] = float("nan")
    gn = torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in bad]))
    state = tx.update_guarded(bad, state, params, torch.isfinite(gn), grad_norm=gn)
    assert all(torch.equal(a, b) for a, b in zip(before[0], params))
    assert torch.equal(before[1], state.mu) and torch.equal(before[2], state.nu)
    assert torch.equal(before[3], state.nu_max) and int(state.count) == before[4] == 1


@pytest.mark.parametrize("use_left", [False, True])
def test_dynamic_chunk_draw_matches_jax(use_left):
    """Given JAX's drawn (c, left) integers, the port's chunk size, left
    budget and mask equal JAX's `add_optional_chunk_mask` (training draw)."""
    pad = np.ones((2, 1, 40), bool)
    pad[1, 0, 30:] = False
    for key in range(12):
        rng = jax.random.PRNGKey(key)
        t = 40 if key % 2 else 9
        p = pad[:, :, :t]
        ref = jax_chunk_mask(jnp.asarray(p), use_dynamic_chunk=True,
                             use_dynamic_left_chunk=use_left, decoding_chunk_size=0,
                             static_chunk_size=0, num_decoding_left_chunks=-1, rng=rng,
                             max_chunk_size=7)
        k1, k2 = jax.random.split(rng)
        c = int(jax.random.randint(k1, (), 1, max(t, 2)))
        left = int(jax.random.randint(k2, (), 0, 1 << 30))
        cs, nl = dynamic_chunk_size(c, left, t, 7, use_left)
        got = torch.from_numpy(p) & chunk_mask(t, cs, nl)[None]
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=str(key))
    # the port's own draw goes through the same two functions
    gen = torch.Generator().manual_seed(3)
    got = add_optional_chunk_mask(torch.from_numpy(pad), use_dynamic_chunk=True,
                                  decoding_chunk_size=0, static_chunk_size=0,
                                  num_decoding_left_chunks=-1, use_dynamic_left_chunk=use_left,
                                  chunk_gen=gen, max_chunk_size=7)
    cs, nl = dynamic_chunk_size(*draw_dynamic_chunk(torch.Generator().manual_seed(3), 40),
                                40, 7, use_left)
    assert torch.equal(got, torch.from_numpy(pad) & chunk_mask(40, cs, nl)[None])


def _train_setup():
    """The tiny flagship with dropout 0.1 everywhere and dynamic chunks."""
    cfg = Config()
    mc = from_dict(ModelConfig, to_dict(_flagship_config(tiny=True).model))
    mc.fused_joint_loss = True
    mc.encoder = dataclasses.replace(mc.encoder, dropout_rate=0.1,
                                     positional_dropout_rate=0.1, use_dynamic_left_chunk=True)
    cfg.model = mc
    cfg.feature.sample_rate = 16000
    model = init_weights(Transducer(mc, device="cpu"), 0)
    r = np.random.default_rng(1)
    batch = {"waves": torch.from_numpy((0.1 * r.standard_normal((2, 40 * 512)))
                                       .astype(np.float32)),
             "wave_lens": torch.tensor([40 * 512, 31 * 512]),
             "texts": torch.from_numpy(r.integers(6, mc.vocab_size, (2, 5))),
             "text_lens": torch.tensor([5, 2])}
    return cfg, model, batch


def _one_step(cfg, model, batch, seed):
    model = copy.deepcopy(model)
    tx = make_optimizer(cfg.optim)
    state, metrics = make_train_step(model, tx, cfg)(TrainState.create(model, tx), batch, seed)
    return state, metrics, [p.detach().clone() for p in model.parameters()]


def test_train_step_seeded():
    cfg, model, batch = _train_setup()
    s1, m1, p1 = _one_step(cfg, model, batch, 7)
    s2, m2, p2 = _one_step(cfg, model, batch, 7)
    _, m3, p3 = _one_step(cfg, model, batch, 8)
    assert bool(m1["finite"]) and s1.step == 1 and int(s1.opt_state.count) == 1
    assert set(m1) == {"loss", "loss_rnnt", "loss_ctc", "grad_norm", "finite",
                       "audio_seconds"}
    assert torch.equal(m1["loss"], m2["loss"]) and all(map(torch.equal, p1, p2))
    assert not torch.equal(m1["loss"], m3["loss"])
    assert not all(map(torch.equal, p1, p3))
    assert float(m1["audio_seconds"]) == pytest.approx(71 * 512 / 16000)


def test_train_step_skips_nonfinite_batch():
    cfg, model, batch = _train_setup()
    bad = dict(batch, waves=batch["waves"].clone())
    bad["waves"][0, 100] = float("nan")
    before = [p.detach().clone() for p in model.parameters()]
    tx = make_optimizer(cfg.optim)
    state, metrics = make_train_step(model, tx, cfg)(TrainState.create(model, tx), bad, 0)
    assert not bool(metrics["finite"]) and int(state.skipped) == 1
    assert int(state.opt_state.count) == 0 and state.step == 1
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert float(state.opt_state.mu.abs().sum()) == 0.0


def test_eval_step_is_deterministic():
    cfg, model, batch = _train_setup()
    step = make_eval_step(model, cfg)
    a, b = step(batch, 3), step(batch, 3)
    assert not model.training
    assert all(torch.equal(a[k], b[k]) for k in a)
