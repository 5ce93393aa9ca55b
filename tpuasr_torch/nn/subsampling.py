"""Conv subsampling front-end (port of ``tpuasr/nn/subsampling.py``, the
``conv2d`` / rate-4 case): two unpadded k=3, s=2 Conv2d + Linear."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.nn.layers import Dense


class Conv2dSubsampling4(nn.Module):
    """[B, T, F] -> [B, T', D]; rate 4, right_context 6.

    The flax module runs NHWC and flattens [B, T', F', C] with C fastest;
    this one runs NCHW and permutes to [B, T', F', C] before the flatten, so
    the `out` weight keeps the JAX package's row order."""

    subsampling_rate = 4
    right_context = 6

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, odim, 3, stride=2, device=device)
        self.conv2 = nn.Conv2d(odim, odim, 3, stride=2, device=device)
        f_out = ((idim - 1) // 2 - 1) // 2
        self.out = Dense(odim * f_out, odim, device=device)

    @staticmethod
    def _conv(x, conv: nn.Conv2d):
        dt = x.dtype
        return F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(self._conv(x[:, None], self.conv1), self.conv2)  # [B, C, T', F']
        b, c, t, f = y.shape
        return self.out(y.permute(0, 2, 3, 1).reshape(b, t, f * c))

    @staticmethod
    def output_len(t):
        return (((t - 1) // 2) - 1) // 2


SUBSAMPLE_CLASSES = {"conv2d": Conv2dSubsampling4}


def subsampled_len(input_layer: str, t):
    return SUBSAMPLE_CLASSES[input_layer].output_len(t)


def subsampled_mask(mask: torch.Tensor, input_layer: str) -> torch.Tensor:
    """Subsample a [B, 1, T] mask the way wenet slices it ([2::2][2::2])."""
    if input_layer != "conv2d":
        raise NotImplementedError(f"input_layer {input_layer!r} (ROADMAP: later slices)")
    return mask[:, :, 2::2][:, :, 2::2]
