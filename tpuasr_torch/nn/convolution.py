"""Conformer convolution module (port of ``tpuasr/nn/convolution.py``, the
layer_norm variant).

Pointwise conv to 2C, GLU, depthwise conv over time, layer norm + swish,
pointwise back to C, with padded frames zeroed before and after. Causal: the
depthwise conv is left-padded by kernel-1 frames, or, streaming, extended by
a cache of the previous chunk's last kernel-1 *post-GLU* frames — the JAX
package's deliberate divergence from wenet (convolution.py:12-18), kept so
chunked streaming equals the chunk-masked full-context forward exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.nn.layers import Dense, LayerNorm


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 15, norm: str = "layer_norm",
                 causal: bool = False, device=None):
        super().__init__()
        if norm != "layer_norm":
            raise NotImplementedError(f"cnn_module_norm {norm!r} (ROADMAP: later slices)")
        if not causal and (kernel_size - 1) % 2:
            raise ValueError("a non-causal depthwise kernel must be odd")
        self.channels, self.kernel_size, self.causal = channels, kernel_size, causal
        self.pointwise_conv1 = Dense(channels, 2 * channels, device=device)
        # depthwise weight [C, 1, K] (the JAX package's kernel is [K, 1, C])
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size, groups=channels,
                                        device=device)
        self.norm = LayerNorm(channels, device=device)
        self.pointwise_conv2 = Dense(channels, channels, device=device)

    @property
    def lorder(self) -> int:
        return self.kernel_size - 1 if self.causal else 0

    def forward(self, x: torch.Tensor, mask_pad: Optional[torch.Tensor] = None,
                cache: Optional[torch.Tensor] = None):
        """x [B, T, C]; mask_pad [B, 1, T] True=valid; cache [B, lorder, C]
        -> (y [B, T, C], new cache or None)."""
        c = self.channels
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        y = self.pointwise_conv1(x)
        y = y[..., :c] * torch.sigmoid(y[..., c:])

        new_cache = None
        if self.causal:
            lorder = self.lorder
            if cache is None:
                y = F.pad(y, (0, 0, lorder, 0))
            else:
                y = torch.cat([cache.to(y.dtype), y], dim=1)
                new_cache = y[:, y.shape[1] - lorder:]
            pad = 0
        else:
            pad = (self.kernel_size - 1) // 2
        dt = y.dtype
        w = self.depthwise_conv
        y = F.conv1d(y.transpose(1, 2), w.weight.to(dt), w.bias.to(dt), padding=pad,
                     groups=c).transpose(1, 2)
        y = self.norm(y)
        y = y * torch.sigmoid(y)  # swish
        y = self.pointwise_conv2(y)
        if mask_pad is not None:
            y = y.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        return y, new_cache
