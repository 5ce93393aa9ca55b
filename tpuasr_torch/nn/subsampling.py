"""Subsampling front ends (port of ``tpuasr/nn/subsampling.py``): the
``conv2d`` / ``conv2d6`` / ``conv2d8`` / ``conv2d_firered`` stacks of
unpadded (VALID) Conv2d + ReLU layers over [B, 1, T, F], then a Linear over
the flattened (F', C); ``linear`` (Linear + LayerNorm, rate 1); ``conv1d2``
(whisper's two gelu Conv1d, rate 2); ``stack2`` (two frames stacked,
LayerNorm + Linear). Each class states its `subsampling_rate` and
`right_context`, which size the streaming windows."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.nn.layers import Dense, LayerNorm, gelu


class _Conv2dSubsampling(nn.Module):
    """[B, T, F] -> [B, T', D] through the convs of `LAYERS` ((kernel,
    stride) each, named conv1, conv2, ..., with `CHANNELS` channels, odim
    when None) and the `out` Dense; the input first zero-padded by
    `PAD_RIGHT` frames at its end.

    The flax module runs NHWC and flattens [B, T', F', C] with C fastest;
    this one runs NCHW and permutes to [B, T', F', C] before the flatten, so
    the `out` weight keeps the JAX package's row order."""

    LAYERS: tuple = ()
    CHANNELS = None
    PAD_RIGHT = 0

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        ch = self.CHANNELS or odim
        f_out, c_in = idim, 1
        for i, (k, s) in enumerate(self.LAYERS):
            setattr(self, f"conv{i + 1}", nn.Conv2d(c_in, ch, k, stride=s, device=device))
            f_out, c_in = (f_out - k) // s + 1, ch
        self.out = Dense(ch * f_out, odim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.PAD_RIGHT:
            x = F.pad(x, (0, 0, 0, self.PAD_RIGHT))
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

    @staticmethod
    def window_for_chunk(chunk: int) -> int:
        return (chunk - 1) * 4 + 6 + 1


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


class FireRedConv2dSubsampling4(_Conv2dSubsampling):
    """FireRed's conv2d x4 (wenet firered/subsampling.py:22-74): the input
    zero-padded by right_context (6) frames before the convs, 32 conv
    channels; rate 4, right_context 6."""

    LAYERS = ((3, 2), (3, 2))
    CHANNELS = 32
    PAD_RIGHT = 6
    subsampling_rate = 4
    right_context = 6

    @staticmethod
    def output_len(t):
        return ((t + 5) // 2 - 1) // 2


class LinearNoSubsampling(nn.Module):
    """Linear + LayerNorm; rate 1, right_context 0."""

    subsampling_rate = 1
    right_context = 0

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        self.linear = Dense(idim, odim, device=device)
        self.norm = LayerNorm(odim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.linear(x))

    @staticmethod
    def output_len(t):
        return t


class Conv1dSubsampling2(nn.Module):
    """Whisper's front end (wenet subsampling.py:116-160): two Conv1d over
    time (k 3, pad 1; the second stride 2), each followed by gelu; rate 2,
    right_context 4."""

    subsampling_rate = 2
    right_context = 4

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(idim, odim, 3, padding=1, device=device)
        self.conv2 = nn.Conv1d(odim, odim, 3, stride=2, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, dt = x.transpose(1, 2), x.dtype
        for conv in (self.conv1, self.conv2):
            y = gelu(F.conv1d(y, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride,
                              padding=1))
        return y.transpose(1, 2)

    @staticmethod
    def output_len(t):
        return (t - 1) // 2 + 1


class StackNFramesSubsampling(nn.Module):
    """Two consecutive frames stacked, LayerNorm + Linear over [B, T/2, 2F]
    (wenet subsampling.py:338-394); rate 2, right_context 0."""

    subsampling_rate = 2
    right_context = 0
    stride = 2

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(idim * self.stride, device=device)
        self.out = Dense(idim * self.stride, odim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, f = x.shape
        s = self.stride
        y = x[:, :t // s * s].reshape(b, t // s, f * s)
        return self.out(self.norm(y))

    @staticmethod
    def output_len(t):
        return t // 2


SUBSAMPLE_CLASSES = {"linear": LinearNoSubsampling, "conv1d2": Conv1dSubsampling2,
                     "conv2d_firered": FireRedConv2dSubsampling4,
                     "conv2d": Conv2dSubsampling4, "conv2d6": Conv2dSubsampling6,
                     "conv2d8": Conv2dSubsampling8, "stack2": StackNFramesSubsampling}


def subsampled_len(input_layer: str, t):
    return SUBSAMPLE_CLASSES[input_layer].output_len(t)


def subsampled_mask(mask: torch.Tensor, input_layer: str) -> torch.Tensor:
    """Subsample a [B, 1, T] mask the way wenet slices it (e.g. [2::2][2::2])."""
    if input_layer == "linear":
        return mask
    if input_layer == "conv1d2":
        return mask[:, :, ::2]
    if input_layer == "conv2d_firered":
        # FireRed extends every valid length by right_context before the
        # mask's subsampling (firered subsampling.py:62-74)
        t = mask.shape[-1] + 6
        lens = mask.sum(-1, keepdim=True) + 6
        m = torch.arange(t, device=mask.device)[None, None, :] < lens
        return m[:, :, :-2:2][:, :, :-2:2]
    if input_layer == "stack2":
        return mask[:, :, 1::2][:, :, :mask.shape[-1] // 2]
    if input_layer == "conv2d":
        return mask[:, :, 2::2][:, :, 2::2]
    if input_layer == "conv2d6":
        return mask[:, :, 2::2][:, :, 4::3]
    if input_layer == "conv2d8":
        return mask[:, :, 2::2][:, :, 2::2][:, :, 2::2]
    raise ValueError(f"unknown input_layer {input_layer!r}")
