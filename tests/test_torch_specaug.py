"""The port's SpecAugment (`tpuasr_torch.audio.spec_augment`) against the
JAX package's (`tpuasr.audio.specaug.spec_augment`).

The two draw from different generators, so they are held to the same
semantics and the same distribution, not the same bits:
- masked values are exactly zero and every other value is untouched; the
  zeros form whole time rows and whole frequency columns;
- with one mask of each kind, the time stripe is at most max_t frames and
  starts at or before the utterance's last valid frame (starts are clamped
  to feat_len - 1), and the frequency stripe is at most max_f bins;
- widths reach both 0 and their maximum (drawn from 0 to max inclusive);
- the mean masked fraction over 200 seeds lies within 10 % of the JAX
  function's over 200 keys (a 200-seed mean spreads by about 1 %).
In the train step SpecAugment draws from a generator of its own: with
widths forced to 0 it changes nothing, not even a dropout mask, so the loss
equals the step's without it; with the default widths it changes the loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.audio.specaug import spec_augment as jax_spec_augment
from tpuasr_torch.audio import spec_augment
from tpuasr_torch.config import Config, ModelConfig
from tpuasr_torch.data import BatchSpec, make_batch, synth_corpus, tensors
from tpuasr_torch.models import Transducer, init_weights
from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

torch.set_num_threads(1)  # six test workers share the cores

B, T, F = 4, 120, 80
LENS = np.array([120, 90, 60, 10], np.int32)
SEEDS = 200


def _feats():
    return torch.from_numpy(1.0 + np.random.default_rng(0).random((B, T, F), np.float32))


def _runs(idx: np.ndarray) -> list[tuple[int, int]]:
    """Contiguous runs of sorted indices -> [(start, length)]."""
    runs = []
    for i in idx:
        if runs and i == runs[-1][0] + runs[-1][1]:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((int(i), 1))
    return runs


def test_stripes_zeros_widths_and_clamped_starts():
    feats = _feats()
    t_widths, f_widths = set(), set()
    for seed in range(SEEDS):
        gen = torch.Generator().manual_seed(seed)
        out = spec_augment(gen, feats, torch.from_numpy(LENS), 1, 1, max_t=30, max_f=12)
        zero = out == 0
        assert torch.equal(torch.where(zero, feats, out), feats)  # untouched elsewhere
        for b in range(B):
            rows = np.flatnonzero(zero[b].all(1).numpy())
            cols = np.flatnonzero(zero[b].all(0).numpy())
            # every zero lies in a zero row or a zero column
            assert torch.equal(zero[b], torch.from_numpy(
                np.isin(np.arange(T), rows)[:, None] | np.isin(np.arange(F), cols)[None, :]))
            tr, fr = _runs(rows), _runs(cols)
            assert len(tr) <= 1 and len(fr) <= 1
            if tr:
                assert tr[0][1] <= 30 and tr[0][0] <= LENS[b] - 1
                t_widths.add(tr[0][1])
            if fr:
                assert fr[0][1] <= 12
                f_widths.add(fr[0][1])
    assert 30 in t_widths and 12 in f_widths  # the maximum is drawn
    assert min(t_widths) <= 2 and min(f_widths) <= 1


def test_masked_fraction_matches_jax():
    feats = _feats()
    port = np.mean([float((spec_augment(torch.Generator().manual_seed(s), feats,
                                        torch.from_numpy(LENS)) == 0).float().mean())
                    for s in range(SEEDS)])
    fn = jax.jit(jax.vmap(lambda k: jax_spec_augment(k, jnp.asarray(feats.numpy()),
                                                     jnp.asarray(LENS))))
    ref = float((fn(jax.random.split(jax.random.PRNGKey(0), SEEDS)) == 0).mean())
    assert abs(port - ref) <= 0.1 * ref, (port, ref)


@pytest.fixture(scope="module")
def tiny():
    mc = ModelConfig(vocab_size=64)
    mc.encoder = dataclasses.replace(mc.encoder, output_size=32, attention_heads=2,
                                     linear_units=64, num_blocks=1, cnn_module_kernel=7,
                                     causal=True, static_chunk_size=4, use_dynamic_chunk=True)
    mc.predictor = dataclasses.replace(mc.predictor, embed_size=16, hidden_size=16,
                                       output_size=32)
    utts = synth_corpus(2, 64, seed=0, sample_rate=48000, samples_per_token=4 * 512)
    return mc, tensors(make_batch(utts, BatchSpec(2, 120 * 512, 12)), "cpu")


def _step_loss(mc, batch, **specaug) -> float:
    cfg = Config()
    cfg.model = mc
    cfg.specaug = dataclasses.replace(cfg.specaug, **specaug)
    model = init_weights(Transducer(mc, device="cpu"), seed=0)
    tx = make_optimizer(cfg.optim)
    _, metrics = make_train_step(model, tx, cfg)(TrainState.create(model, tx), batch, 11)
    return float(metrics["loss"])


def test_train_step_specaug_draws_apart(tiny):
    mc, batch = tiny
    off = _step_loss(mc, batch, enabled=False)
    assert _step_loss(mc, batch, enabled=True, max_t=0, max_f=0) == off
    assert _step_loss(mc, batch, enabled=True) != off
