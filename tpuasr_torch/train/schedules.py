"""Learning-rate schedule family (port of ``tpuasr/train/schedules.py``).

Parity: wenet/utils/scheduler.py as plain ``step -> lr`` callables; a step
is an int or an integer tensor, the result an fp32 tensor on the step's
device:

- `warmup_lr`        — WarmupLR (:26): Noam shape scaled to peak at
                       `warmup_steps`: lr * w^0.5 * min(s^-0.5, s * w^-1.5)
- `linear_warmup`    — the course scripts' warmup (run.py:42-45):
                       lr * min(1, s / warmup)
- `noam_annealing`   — NoamAnnealing (:563): d_model^-0.5 shape
- `warmup_policy`    — WarmupPolicy (:79): linear warmup, then hold at lr
- `warmup_hold`      — WarmupHoldPolicy (:203): warmup → hold → inverse-sqrt
- `cosine_annealing` — CosineAnnealing (:502) with warmup + min_lr floor
- `square_annealing` — SquareAnnealing (:449)
- `square_root_annealing` — SquareRootAnnealing (:476)
- `noam_hold_annealing`   — NoamHoldAnnealing (:629) with decay_rate

s is step + 1 throughout, as the JAX package counts.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int | torch.Tensor], torch.Tensor]


def _s(step) -> torch.Tensor:
    """step + 1 as fp32."""
    return (torch.as_tensor(step) + 1).float()


def linear_warmup(lr: float, warmup_steps: int) -> Schedule:
    return lambda step: lr * torch.clamp(_s(step) / max(warmup_steps, 1), max=1.0)


def warmup_lr(lr: float, warmup_steps: int) -> Schedule:
    w = float(warmup_steps)

    def f(step):
        s = _s(step).clamp(min=1.0)
        return lr * w**0.5 * torch.minimum(s**-0.5, s * w**-1.5)

    return f


def noam_annealing(base_lr: float, warmup_steps: int, d_model: int) -> Schedule:
    norm, w = d_model**-0.5, float(warmup_steps)

    def f(step):
        s = _s(step).clamp(min=1.0)
        return base_lr * norm * torch.minimum(s**-0.5, s * w**-1.5)

    return f


def warmup_policy(lr: float, warmup_steps: int) -> Schedule:
    return linear_warmup(lr, warmup_steps)


def warmup_hold(lr: float, warmup_steps: int, hold_steps: int, min_lr: float = 0.0) -> Schedule:
    def f(step):
        s = _s(step)
        warm = lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        after = lr * torch.sqrt(max(warmup_steps + hold_steps, 1) / s.clamp(min=1.0))
        return torch.where(s <= warmup_steps + hold_steps, warm, after).clamp(min=min_lr)

    return f


def _annealing(lr: float, warmup_steps: int, max_steps: int, shape) -> Schedule:
    """Linear warmup to `lr`, then `shape(frac)` of the steps after it."""

    def f(step):
        s = _s(step)
        warm = lr * s / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(s <= warmup_steps, warm, shape(frac))

    return f


def cosine_annealing(lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    return _annealing(lr, warmup_steps, max_steps, lambda frac: min_lr + (lr - min_lr) * 0.5 * (
        1.0 + torch.cos(math.pi * frac)))


def square_annealing(lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    return _annealing(lr, warmup_steps, max_steps,
                      lambda frac: min_lr + (lr - min_lr) * (1.0 - frac) * (1.0 - frac))


def square_root_annealing(lr: float, warmup_steps: int, max_steps: int,
                          min_lr: float = 0.0) -> Schedule:
    return _annealing(lr, warmup_steps, max_steps,
                      lambda frac: min_lr + (lr - min_lr) * torch.sqrt(1.0 - frac))


def noam_hold_annealing(lr: float, warmup_steps: int, hold_steps: int, decay_rate: float = 0.5,
                        min_lr: float = 0.0) -> Schedule:
    def f(step):
        s = _s(step)
        warm = lr * s / max(warmup_steps, 1)
        anneal = lr * torch.pow(max(warmup_steps + hold_steps, 1) / s.clamp(min=1.0), decay_rate)
        hold = torch.full_like(s, lr)
        out = torch.where(s <= warmup_steps, warm,
                          torch.where(s <= warmup_steps + hold_steps, hold, anneal))
        return out.clamp(min=min_lr)

    return f


SCHEDULES = {
    "linear_warmup": linear_warmup,
    "warmuplr": warmup_lr,
    "noam": noam_annealing,
    "warmup_policy": warmup_policy,
    "warmup_hold": warmup_hold,
    "cosine_annealing": cosine_annealing,
    "square_annealing": square_annealing,
    "square_root_annealing": square_root_annealing,
    "noam_hold_annealing": noam_hold_annealing,
}


def get_schedule(name: str, **kwargs) -> Schedule:
    return SCHEDULES[name](**kwargs)
