"""Positional encodings with streaming offsets (port of
``tpuasr/nn/embedding.py``): the sinusoid table of the rel-pos, abs-pos and
no-pos encoders, whisper's table, FireRed's bidirectional window and the
rotary (cos, sin) tables. The learnable table is the encoder's `learned_pe`
parameter."""

from __future__ import annotations

import math

import numpy as np
import torch


def whisper_sinusoid_table(max_len: int, d_model: int, dtype=np.float32) -> np.ndarray:
    """OpenAI-whisper encoder PE layout: concat(sin, cos) over half-dim
    timescales, xscale 1 (wenet embedding.py:150-165)."""
    half = d_model // 2
    inc = math.log(10000.0) / (half - 1)
    inv = np.exp(-inc * np.arange(half, dtype=np.float64))
    scaled = np.arange(max_len, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(dtype)


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

    def position_encoding(self, offset: int, size: int, stride: int = 1) -> torch.Tensor:
        """PE window [1, size, d] for positions offset, offset + stride, ...,
        offset + (size - 1) * stride.

        `stride` serves the reduced-rate layers of the encoder families,
        whose full-context forward samples ``pos_emb[:, ::f]``. Positions
        below zero clamp to 0 (callers mask those slots). When the window's
        span would end past `max_len`, it is rebased to end at the table
        top, so the relative geometry inside the window stays exact for
        arbitrarily long streams (tpuasr/nn/embedding.py:51-81). `offset` is
        an int or a 0-d integer tensor on the table's device (the streaming
        conformer's), which selects the rows without reading the device."""
        span = (size - 1) * stride + 1  # the window's extent in table rows
        if isinstance(offset, int):
            if 0 <= offset and offset + span <= self.max_len:
                return self.table[offset:offset + span:stride][None]
            shift = max(offset + span - self.max_len, 0)
        else:  # a 0-d tensor on the table's device: the same rows by a gather
            shift = (offset + span - self.max_len).clamp(min=0)
        pos = torch.arange(size, device=self.table.device) * stride + (offset - shift)
        return self.table[pos.clamp(0, self.max_len - 1)][None]

    def add_abs(self, x: torch.Tensor, offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """abs_pos: (x * xscale + PE window, PE window), the scale in x's
        type as the JAX package rounds it."""
        pe = self.position_encoding(offset, x.shape[1]).to(x.dtype)
        return x * torch.tensor(self.xscale, dtype=x.dtype) + pe, pe

    def rel(self, x: torch.Tensor, offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """rel_pos: (x * xscale, PE window) — the PE is consumed by attention."""
        pe = self.position_encoding(offset, x.shape[1]).to(x.dtype)
        return x * self.xscale, pe

    def rel_bidirectional(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Transformer-XL bidirectional PE window for FireRed's rel_shift
        attention: positions T-1 .. -(T-1) -> (x * xscale, pe [1, 2T-1, d]).
        sin(-p) = -sin(p) and cos(-p) = cos(p), so the negative half is the
        table with its sin (even) lanes negated."""
        t = x.shape[1]
        pos = self.table[:t].flip(0)  # positions T-1 .. 0
        sign = torch.ones(self.d_model, dtype=self.table.dtype, device=self.table.device)
        sign[0::2] = -1.0
        pe = torch.cat([pos, self.table[1:t] * sign])[None].to(x.dtype)
        return x * torch.tensor(self.xscale, dtype=x.dtype), pe

    def rope_window(self, offset: int, size: int, head_dim: int,
                    theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
        """Rotary (cos, sin) tables for positions offset .. offset+size-1,
        the non-interleaved half-split layout (wenet rope_utils' 'google'
        style) -> each [1, size, head_dim], fp32."""
        half = head_dim // 2
        inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2 / head_dim))
        inv = torch.from_numpy(inv.astype(np.float32)).to(self.table.device)
        pos = torch.arange(size, device=self.table.device, dtype=torch.float32) + offset
        ang = pos[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        return ang.cos()[None], ang.sin()[None]
