"""Train and eval steps (port of ``tpuasr/train/step.py``).

One step: waves -> log-mel fbank on the device (kernel #1, no gradient) ->
the model's hybrid loss forward (dropout, dynamic chunk) -> backward ->
global gradient norm, finite flag -> the NaN-guarded `GuardedAdam` update.
Nothing in the step waits for the host: the metrics stay device tensors.

Randomness comes from an explicit seed per call, folded with the step
count as `jax.random.fold_in(rng, state.step)` does (step.py:109): the same
seed and step give the same dropout masks and chunk draw on the same device,
another seed other ones. Dropout draws from a generator on the model's
device; the dynamic-chunk draw, two host integers, from a CPU generator, so
building the mask never syncs. The bits differ from JAX's (another
generator); the distributions are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpuasr_torch.audio import fbank_batch
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


def _check(cfg: Config) -> None:
    if cfg.specaug.enabled:
        raise NotImplementedError("specaug.enabled: SpecAugment is not ported yet (ROADMAP)")


def make_train_step(model: torch.nn.Module, tx: GuardedAdam, cfg: Config) -> Callable:
    """-> train_step(state, batch, seed) -> (state, metrics). batch: waves
    [B, N] (float or int16 PCM), wave_lens, texts [B, U], text_lens on the
    model's device. metrics: loss, loss_rnnt, loss_ctc, grad_norm, finite,
    audio_seconds, all device tensors. The model is put in train() mode."""
    _check(cfg)

    def train_step(state: TrainState, batch: dict, seed: int):
        chunk_gen, drop_gen = step_generators(seed, state.step, model.device)
        feats, feat_lens = _features(model, cfg, batch)
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        out = model(feats, feat_lens, batch["texts"], batch["text_lens"],
                    chunk_gen=chunk_gen, dropout_gen=drop_gen)
        out["loss"].backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        with torch.no_grad():
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            loss = out["loss"].detach()
            finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
            opt_state = tx.update_guarded(grads, state.opt_state, params, finite,
                                          state.lr_scale, grad_norm)
        for p in params:
            p.grad = None
        new_state = TrainState(model, opt_state, state.step + 1, state.lr_scale,
                               state.skipped + (~finite).to(torch.int32))
        metrics = {"loss": loss, "grad_norm": grad_norm, "finite": finite,
                   "audio_seconds": batch["wave_lens"].sum() / cfg.feature.sample_rate}
        for k in ("loss_rnnt", "loss_ctc"):
            if k in out:
                metrics[k] = out[k].detach()
        return new_state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """-> eval_step(batch, seed) -> loss dict (no update, no dropout; the
    chunk draw still comes from the seed, as the JAX eval step passes its
    chunk rng). The model is put in eval() mode."""
    _check(cfg)

    @torch.no_grad()
    def eval_step(batch: dict, seed: int):
        chunk_gen, _ = step_generators(seed, 0, model.device)
        feats, feat_lens = _features(model, cfg, batch)
        model.eval()
        return model(feats, feat_lens, batch["texts"], batch["text_lens"],
                     chunk_gen=chunk_gen)

    return eval_step
