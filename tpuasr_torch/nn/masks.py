"""Attention / padding masks (port of ``tpuasr/nn/masks.py``).

Convention: boolean masks are True = attend/valid; padding masks from
`make_pad_mask` are True = PAD, as in the JAX package.
"""

from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True at padded positions."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return idx >= lengths[:, None]


def chunk_mask(size: int, chunk_size: int, num_left_chunks: int,
               device=None) -> torch.Tensor:
    """[size, size] block-chunk mask; True = attend.

    Row i attends columns [start, end) with end = (i//cs + 1) * cs and
    start = 0 if num_left_chunks < 0 else max((i//cs - L) * cs, 0)."""
    cs = max(chunk_size, 1)
    i = torch.arange(size, device=device)[:, None]
    j = torch.arange(size, device=device)[None, :]
    blk = i // cs
    end = (blk + 1) * cs
    if num_left_chunks < 0:
        start = torch.zeros_like(blk)
    else:
        start = torch.clamp((blk - num_left_chunks) * cs, min=0)
    return (j >= start) & (j < end)


def add_optional_chunk_mask(pad_mask: torch.Tensor, *, use_dynamic_chunk: bool,
                            decoding_chunk_size: int, static_chunk_size: int,
                            num_decoding_left_chunks: int) -> torch.Tensor:
    """[B, 1, T] pad mask (True = valid) -> [B, T, T] attention mask.

    Serving semantics of wenet add_optional_chunk_mask (mask.py:126-198):
    - use_dynamic_chunk with decoding_chunk_size < 0: full context;
    - decoding_chunk_size > 0: fixed chunk + num_decoding_left_chunks;
    - static_chunk_size > 0 (no dynamic): static chunk;
    - else: padding mask only, returned as a broadcast view (no copy).
    The training-time dynamic-chunk draw (decoding_chunk_size == 0 with
    use_dynamic_chunk) comes with the training slice."""
    b, _, t = pad_mask.shape
    if use_dynamic_chunk:
        if decoding_chunk_size == 0:
            raise NotImplementedError(
                "dynamic-chunk sampling is a training feature (ROADMAP: training slice)")
        if decoding_chunk_size < 0:
            return pad_mask.expand(b, t, t)
        cm = chunk_mask(t, decoding_chunk_size, num_decoding_left_chunks, pad_mask.device)
        return pad_mask & cm[None]
    if static_chunk_size > 0:
        cm = chunk_mask(t, static_chunk_size, num_decoding_left_chunks, pad_mask.device)
        return pad_mask & cm[None]
    return pad_mask.expand(b, t, t)
