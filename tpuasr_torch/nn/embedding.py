"""Sinusoidal positional encodings with streaming offsets (port of
``tpuasr/nn/embedding.py``, the rel-pos subset)."""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoid_table(max_len: int, d_model: int, dtype=np.float32) -> np.ndarray:
    """[max_len, d_model]: pe[p, 2i]=sin(p/10000^(2i/d)), pe[p, 2i+1]=cos."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(dtype)


class PositionalEncodingTable:
    """PE table on one device, indexed by a host-side stream offset."""

    def __init__(self, d_model: int, max_len: int = 5000, device=None):
        self.d_model = d_model
        self.max_len = max_len
        self.xscale = math.sqrt(d_model)
        self.table = torch.from_numpy(sinusoid_table(max_len, d_model)).to(device)

    def position_encoding(self, offset: int, size: int) -> torch.Tensor:
        """PE window [1, size, d] for positions offset .. offset+size-1.

        Positions below zero clamp to 0 (callers mask those slots). When the
        window would end past `max_len`, it is rebased to end at the table
        top, so the relative geometry inside the window stays exact for
        arbitrarily long streams (tpuasr/nn/embedding.py:51-81)."""
        if 0 <= offset and offset + size <= self.max_len:
            return self.table[offset:offset + size][None]
        shift = max(offset + size - self.max_len, 0)
        pos = torch.arange(size, device=self.table.device) + (offset - shift)
        return self.table[pos.clamp(0, self.max_len - 1)][None]

    def rel(self, x: torch.Tensor, offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """rel_pos: (x * xscale, PE window) — the PE is consumed by attention."""
        pe = self.position_encoding(offset, x.shape[1]).to(x.dtype)
        return x * self.xscale, pe
