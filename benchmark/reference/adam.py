"""The configurations' optimizer, plain, per leaf: Adam (with `amsgrad`, the
running max of the bias-corrected second moment), clipping at a global
norm ((g / gn) * clip when gn >= clip), L2 decay added into the clipped
gradient, and a linear warm-up of the learning rate; optax's order of
operations."""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, optim: dict, params: dict):
        self.c = optim
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu_max = {k: torch.zeros_like(p) for k, p in params.items()}

    @staticmethod
    def global_norm(grads: dict) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack([g.double().norm() for g in grads.values()])
                                        ).float()

    def clipped(self, grads: dict) -> dict:
        gn = self.global_norm(grads)
        clip = self.c["grad_clip"]
        return {k: (g / gn) * clip if gn >= clip else g for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        c = self.c
        b1, b2 = c["betas"]
        t = self.count + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        lr = c["lr"] * min(t / max(c["warmup_steps"], 1), 1.0)
        for k, g in self.clipped(grads).items():
            p = params[k]
            u = g + c["weight_decay"] * p
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * u
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * u * u
            if c["amsgrad"]:
                self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / bc2)
                denom = torch.sqrt(self.nu_max[k]) + c["eps"]
            else:
                denom = torch.sqrt(self.nu[k] / bc2) + c["eps"]
            p.add_(((self.mu[k] / bc1) / denom) * -lr)
        self.count = t
