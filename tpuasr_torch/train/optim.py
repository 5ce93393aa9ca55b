"""Optimizer (port of ``tpuasr/train/optim.py``).

The reference protocol (run.py:29-45, 110-113, rnnt_train.py:44-56,
rnnt_common.py:7-21): Adam(lr 1e-4, betas (0.9, 0.98), eps 1e-8, weight decay
1e-4, amsgrad), a linear warmup over 4000 steps, clipping at global norm
1.0, ReduceLROnPlateau(0.5, patience 2) on the test loss as a host-side
scale (`PlateauTracker`).

`GuardedAdam` is not ``torch.optim.Adam(amsgrad=True)``. It differs in three
ways, each the JAX package's (optax op order):
- amsgrad keeps the running max of the *bias-corrected* second moment;
- the step count advances only on finite steps;
- clipping is ``(g / gn) * clip`` when gn >= clip, then L2 decay is added
  into the gradient (torch Adam's weight_decay, not AdamW's).

The NaN guard stays on the device: `finite` is a 0-d bool tensor and every
select is a `torch.where`, so an update never waits for the host. The
moments live as flat fp32 vectors over the parameters in order, so one
update is a dozen elementwise launches whatever the number of parameters;
the update is in place (moments and parameters are overwritten, which the
JAX package's pure functions cannot do).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import torch

from tpuasr_torch.config import OptimConfig


class FusedAdamState(NamedTuple):
    """Adam state: count (int32 0-d tensor, advances only on applied
    steps) and the flat fp32 moments mu, nu and nu_max (the running max of
    the bias-corrected nu; None without amsgrad)."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    nu_max: Optional[torch.Tensor]


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Views of `flat` shaped like each tensor of `like`."""
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in like]), like)]


class GuardedAdam:
    """Adam(+amsgrad) with clip, warmup, L2 decay and the NaN skip-guard in
    one pass over flat vectors (tpuasr/train/optim.py:52-138)."""

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg

    def init(self, params: Sequence[torch.Tensor]) -> FusedAdamState:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        z = lambda: torch.zeros(n, dtype=torch.float32, device=dev)
        return FusedAdamState(torch.zeros((), dtype=torch.int32, device=dev), z(), z(),
                              z() if self.cfg.amsgrad else None)

    @torch.no_grad()
    def update_guarded(self, grads: Sequence[torch.Tensor], state: FusedAdamState,
                       params: Sequence[torch.Tensor], finite: torch.Tensor,
                       lr_scale: float | torch.Tensor = 1.0,
                       grad_norm: Optional[torch.Tensor] = None) -> FusedAdamState:
        """Apply one step in place to `params` (fp32 tensors) and to the
        state's moments; `finite` False leaves everything as it was. ->
        the new state (the same moment tensors, a new count)."""
        c = self.cfg
        b1, b2 = c.betas
        g = flatten(grads)
        p = flatten(params)
        if grad_norm is None:
            grad_norm = torch.linalg.vector_norm(g)
        count = state.count
        t = (count + 1).float()  # bias-correction step
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        # the schedule reads the pre-increment count (optax parity)
        warm = c.lr * torch.clamp((count.float() + 1) / max(c.warmup_steps, 1), max=1.0)
        # clip -> L2-into-gradient decay, optax op for op
        u = torch.where(grad_norm >= c.grad_clip, (g / grad_norm) * c.grad_clip, g)
        u = u + c.weight_decay * p
        mu = torch.where(finite, b1 * state.mu + (1 - b1) * u, state.mu)
        nu = torch.where(finite, b2 * state.nu + (1 - b2) * u * u, state.nu)
        if c.amsgrad:
            nu_max = torch.where(finite, torch.maximum(state.nu_max, nu / bc2), state.nu_max)
            denom = torch.sqrt(nu_max) + c.eps
        else:
            nu_max = None
            denom = torch.sqrt(nu / bc2) + c.eps
        upd = ((mu / bc1) / denom) * -warm
        p = torch.where(finite, p + upd * lr_scale, p)
        state.mu.copy_(mu)
        state.nu.copy_(nu)
        if nu_max is not None:
            state.nu_max.copy_(nu_max)
        torch._foreach_copy_(list(params), unflatten(p, params))
        return FusedAdamState(count + finite.to(torch.int32), state.mu, state.nu,
                              state.nu_max)


def make_optimizer(cfg: OptimConfig) -> GuardedAdam:
    if cfg.accum_steps > 1:
        raise NotImplementedError("optim.accum_steps > 1: gradient accumulation is not "
                                  "ported yet (ROADMAP)")
    return GuardedAdam(cfg)


@dataclass
class PlateauTracker:
    """Host-side ReduceLROnPlateau state (torch semantics: decay when the
    monitored loss fails to improve for `patience` evaluations)."""

    factor: float = 0.5
    patience: int = 2
    min_scale: float = 1e-3
    best: float = float("inf")
    bad_epochs: int = 0
    scale: float = 1.0

    def update(self, loss: float) -> float:
        if loss < self.best - 1e-8:
            self.best = loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale
