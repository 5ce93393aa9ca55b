"""Linear and layer-norm building blocks with the JAX package's numerics.

Parameters stay fp32 and products run in the type of their input, as flax
``Dense(dtype=compute_dtype)`` does; layer norms use flax's eps 1e-6 and
compute their statistics in fp32 whatever the compute type. `dropout` is
flax's, drawn from an explicit generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """nn.Linear (weight [out, in]) computing in the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x, self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with eps 1e-6, fp32 statistics, output in the input's type."""

    def __init__(self, d: int, device=None):
        super().__init__(d, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1/(1 - rate), in x's type. The keep mask is drawn
    from `gen` (a generator on x's device); no generator means deterministic
    (eval), as does rate 0."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
