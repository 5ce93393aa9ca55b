"""Train and eval steps (port of ``tpuasr/train/step.py``).

One step: waves -> log-mel fbank on the device (kernel #1, no gradient) ->
SpecAugment when `specaug.enabled` (training only) -> the model's hybrid
loss forward (the transducer's RNN-T + CTC or the AED model's CTC +
attention; dropout, dynamic chunk) -> backward -> global gradient norm,
finite flag -> the NaN-guarded `GuardedAdam` update (`AccumulatingAdam`
with optim.accum_steps > 1). The CTC workload's steps
(`make_ctc_train_step`, `make_ctc_eval_step`) take the same path without
SpecAugment and the chunk draw. Nothing in a step waits for the host: the
metrics stay device tensors.

Randomness comes from an explicit seed per call, folded with the step
count as `jax.random.fold_in(rng, state.step)` does (step.py:109): the same
seed and step give the same dropout masks and chunk draw on the same device,
another seed other ones. Dropout draws from a generator on the model's
device; the dynamic-chunk draw, two host integers, from a CPU generator, so
building the mask never syncs. SpecAugment draws from a third generator of
its own on the device, as the JAX step splits off a fourth key for it
(tpuasr/train/step.py:50), so turning it on changes no dropout mask or
chunk draw. A Paraformer's glancing sampler draws from a fourth generator
on the device, passed on training steps only (the JAX step gives its
"sampler" rng to training steps alone, so its dev pass does not sample).
The bits differ from JAX's (another generator); the distributions are the
same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpuasr_torch.audio import fbank_batch, spec_augment
from tpuasr_torch.config import Config
from tpuasr_torch.train.optim import FusedAdamState, GuardedAdam

_MASK63 = (1 << 63) - 1


def step_generators(seed: int, step: int, device: torch.device
                    ) -> tuple[torch.Generator, torch.Generator]:
    """(chunk generator on the CPU, dropout generator on `device`) for one
    step, seeded from (seed, step)."""
    base = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9) & _MASK63
    chunk = torch.Generator().manual_seed(base)
    drop = torch.Generator(device=device).manual_seed((base ^ 0x94D049BB133111EB) & _MASK63)
    return chunk, drop


def specaug_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """SpecAugment's generator on `device` for one step, seeded from (seed,
    step) apart from `step_generators`' two."""
    base = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9) & _MASK63
    return torch.Generator(device=device).manual_seed((base ^ 0x2545F4914F6CDD1D) & _MASK63)


def sampler_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The glancing sampler's generator on `device` for one step, seeded
    from (seed, step) apart from the other three."""
    base = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9) & _MASK63
    return torch.Generator(device=device).manual_seed((base ^ 0x3C6EF372FE94F82B) & _MASK63)


@dataclass
class TrainState:
    """The model (its parameters), the optimizer state, the host step
    count (it seeds the step's generators, so it never needs a sync), the
    plateau scale and the device count of NaN-skipped steps."""

    model: torch.nn.Module
    opt_state: FusedAdamState
    step: int
    lr_scale: float
    skipped: torch.Tensor

    @classmethod
    def create(cls, model: torch.nn.Module, tx: GuardedAdam) -> "TrainState":
        params = list(model.parameters())
        return cls(model, tx.init(params), 0, 1.0,
                   torch.zeros((), dtype=torch.int32, device=params[0].device))


def _features(model, cfg: Config, batch: dict):
    with torch.no_grad():
        return fbank_batch(batch["waves"], batch["wave_lens"], cfg.feature, device=model.device)


def _backward_and_update(state: TrainState, tx: GuardedAdam, loss: torch.Tensor):
    """loss.backward(), the global gradient norm, the finite flag and the
    guarded update; -> (new state, loss, grad norm, finite)."""
    model = state.model
    params = list(model.parameters())
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    with torch.no_grad():
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        loss = loss.detach()
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        opt_state = tx.update_guarded(grads, state.opt_state, params, finite,
                                      state.lr_scale, grad_norm)
    for p in params:
        p.grad = None
    return (TrainState(model, opt_state, state.step + 1, state.lr_scale,
                       state.skipped + (~finite).to(torch.int32)), loss, grad_norm, finite)


def make_train_step(model: torch.nn.Module, tx: GuardedAdam, cfg: Config) -> Callable:
    """-> train_step(state, batch, seed) -> (state, metrics). batch: waves
    [B, N] (float or int16 PCM), wave_lens, texts [B, U], text_lens on the
    model's device. The model is a Transducer, an ASRModel (the AED
    workload) or a Paraformer (given its sampler's generator). metrics:
    loss, the model's loss_rnnt, loss_ctc, loss_att and th_accuracy where
    it has them, grad_norm, finite, audio_seconds, all device tensors. The
    model is put in train() mode."""
    from tpuasr_torch.models.paraformer import Paraformer

    sa = cfg.specaug
    samples = isinstance(model, Paraformer)

    def train_step(state: TrainState, batch: dict, seed: int):
        chunk_gen, drop_gen = step_generators(seed, state.step, model.device)
        feats, feat_lens = _features(model, cfg, batch)
        if sa.enabled:
            feats = spec_augment(specaug_generator(seed, state.step, model.device), feats,
                                 feat_lens, sa.num_t_masks, sa.num_f_masks, sa.max_t, sa.max_f)
        model.train()
        for p in model.parameters():
            p.grad = None
        extra = {"sampler_gen": sampler_generator(seed, state.step, model.device)} \
            if samples else {}
        out = model(feats, feat_lens, batch["texts"], batch["text_lens"],
                    chunk_gen=chunk_gen, dropout_gen=drop_gen, **extra)
        new_state, loss, grad_norm, finite = _backward_and_update(state, tx, out["loss"])
        metrics = {"loss": loss, "grad_norm": grad_norm, "finite": finite,
                   "audio_seconds": batch["wave_lens"].sum() / cfg.feature.sample_rate}
        for k in ("loss_rnnt", "loss_ctc", "loss_att", "th_accuracy"):
            if k in out:
                metrics[k] = out[k].detach()
        return new_state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """-> eval_step(batch, seed) -> loss dict (no update, no dropout; the
    chunk draw still comes from the seed, as the JAX eval step passes its
    chunk rng). The model is put in eval() mode."""

    @torch.no_grad()
    def eval_step(batch: dict, seed: int):
        chunk_gen, _ = step_generators(seed, 0, model.device)
        feats, feat_lens = _features(model, cfg, batch)
        model.eval()
        return model(feats, feat_lens, batch["texts"], batch["text_lens"],
                     chunk_gen=chunk_gen)

    return eval_step


def make_ctc_train_step(model: torch.nn.Module, tx: GuardedAdam, cfg: Config) -> Callable:
    """The CTC workload's step (`CTCModel`; tools/train.py:251-300):
    -> train_step(state, batch, seed) -> (state, metrics). fbank (kernel #1
    on the card), no SpecAugment and no chunk draw, the model's CTC loss
    with dropout from the step's generator, the guarded update. metrics:
    loss, grad_norm, finite, audio_seconds, all device tensors."""

    def train_step(state: TrainState, batch: dict, seed: int):
        _, drop_gen = step_generators(seed, state.step, model.device)
        feats, feat_lens = _features(model, cfg, batch)
        model.train()
        for p in model.parameters():
            p.grad = None
        _, _, loss = model(feats, feat_lens, batch["texts"], batch["text_lens"],
                           dropout_gen=drop_gen)
        new_state, loss, grad_norm, finite = _backward_and_update(state, tx, loss)
        return new_state, {"loss": loss, "grad_norm": grad_norm, "finite": finite,
                           "audio_seconds": batch["wave_lens"].sum() / cfg.feature.sample_rate}

    return train_step


def make_ctc_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """-> eval_step(batch, seed) -> {"loss"}: the dev loss, no dropout
    (tools/train.py:313-318)."""

    @torch.no_grad()
    def eval_step(batch: dict, seed: int):
        feats, feat_lens = _features(model, cfg, batch)
        model.eval()
        return {"loss": model(feats, feat_lens, batch["texts"], batch["text_lens"])[2]}

    return eval_step
