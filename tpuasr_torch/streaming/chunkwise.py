"""Chunk window arithmetic (port of ``tpuasr/streaming/chunkwise.py:23-53``).

Each chunk consumes ``stride = subsampling_rate * chunk_size`` new raw
feature frames, but the encoder sees an overlapping window of
``(chunk_size - 1) * subsampling_rate + right_context + 1`` frames (no
subsampling cache: wenet encoder.py:301-361).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def decoding_window(chunk_size: int, subsampling_rate: int, right_context: int) -> int:
    return (chunk_size - 1) * subsampling_rate + right_context + 1


def num_chunks(n_frames: int, chunk_size: int, subsampling_rate: int,
               right_context: int) -> int:
    """How many chunks a stream of n_frames raw frames yields."""
    context = right_context + 1
    if n_frames < context:
        return 0
    return math.ceil((n_frames - context + 1) / (subsampling_rate * chunk_size))


def chunk_windows(feats: torch.Tensor, chunk_size: int, subsampling_rate: int,
                  right_context: int, n_chunks: int) -> torch.Tensor:
    """[B, T, F] -> [n_chunks, B, window, F] overlapping windows, zero-padded
    past the end so every window has the same shape (a strided view of the
    padded features)."""
    window = decoding_window(chunk_size, subsampling_rate, right_context)
    stride = subsampling_rate * chunk_size
    need = (n_chunks - 1) * stride + window
    if need > feats.shape[1]:
        feats = F.pad(feats, (0, 0, 0, need - feats.shape[1]))
    # unfold: [B, n, F, window] -> [n, B, window, F]
    return feats[:, :need].unfold(1, window, stride).permute(1, 0, 3, 2)
