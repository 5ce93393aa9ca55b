"""Conv subsampling front-ends (port of ``tpuasr/nn/subsampling.py``, the
``conv2d`` / ``conv2d6`` / ``conv2d8`` cases): unpadded (VALID) Conv2d +
ReLU layers over [B, 1, T, F], then a Linear over the flattened (F', C)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.nn.layers import Dense


class _Conv2dSubsampling(nn.Module):
    """[B, T, F] -> [B, T', D] through the convs of `LAYERS` ((kernel,
    stride) each, named conv1, conv2, ...) and the `out` Dense.

    The flax module runs NHWC and flattens [B, T', F', C] with C fastest;
    this one runs NCHW and permutes to [B, T', F', C] before the flatten, so
    the `out` weight keeps the JAX package's row order."""

    LAYERS: tuple = ()

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        f_out, c_in = idim, 1
        for i, (k, s) in enumerate(self.LAYERS):
            setattr(self, f"conv{i + 1}", nn.Conv2d(c_in, odim, k, stride=s, device=device))
            f_out, c_in = (f_out - k) // s + 1, odim
        self.out = Dense(odim * f_out, odim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, dt = x[:, None], x.dtype
        for i, (_, s) in enumerate(self.LAYERS):
            conv = getattr(self, f"conv{i + 1}")
            y = F.relu(F.conv2d(y, conv.weight.to(dt), conv.bias.to(dt), stride=s))
        b, c, t, f = y.shape  # [B, C, T', F']
        return self.out(y.permute(0, 2, 3, 1).reshape(b, t, f * c))


class Conv2dSubsampling4(_Conv2dSubsampling):
    """Two k=3, s=2 convs; rate 4, right_context 6."""

    LAYERS = ((3, 2), (3, 2))
    subsampling_rate = 4
    right_context = 6

    @staticmethod
    def output_len(t):
        return (((t - 1) // 2) - 1) // 2


class Conv2dSubsampling6(_Conv2dSubsampling):
    """k=3, s=2 then k=5, s=3; rate 6, right_context 10."""

    LAYERS = ((3, 2), (5, 3))
    subsampling_rate = 6
    right_context = 10

    @staticmethod
    def output_len(t):
        return (((t - 1) // 2) - 2) // 3


class Conv2dSubsampling8(_Conv2dSubsampling):
    """Three k=3, s=2 convs; rate 8, right_context 14."""

    LAYERS = ((3, 2), (3, 2), (3, 2))
    subsampling_rate = 8
    right_context = 14

    @staticmethod
    def output_len(t):
        return ((((t - 1) // 2) - 1) // 2 - 1) // 2


SUBSAMPLE_CLASSES = {"conv2d": Conv2dSubsampling4, "conv2d6": Conv2dSubsampling6,
                     "conv2d8": Conv2dSubsampling8}


def subsampled_len(input_layer: str, t):
    return SUBSAMPLE_CLASSES[input_layer].output_len(t)


def subsampled_mask(mask: torch.Tensor, input_layer: str) -> torch.Tensor:
    """Subsample a [B, 1, T] mask the way wenet slices it (e.g. [2::2][2::2])."""
    if input_layer == "conv2d":
        return mask[:, :, 2::2][:, :, 2::2]
    if input_layer == "conv2d6":
        return mask[:, :, 2::2][:, :, 4::3]
    if input_layer == "conv2d8":
        return mask[:, :, 2::2][:, :, 2::2][:, :, 2::2]
    raise NotImplementedError(f"input_layer {input_layer!r} (ROADMAP: later slices)")
