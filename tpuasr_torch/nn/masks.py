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


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """[size, size] lower-triangular causal mask (True = attend)."""
    i = torch.arange(size, device=device)
    return i[None, :] <= i[:, None]


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


def draw_dynamic_chunk(gen: torch.Generator, t: int) -> tuple[int, int]:
    """The training-time chunk draw: (c ~ U[1, max(t, 2)), a left-budget
    draw ~ U[0, 2**30)), from `gen` (a CPU generator: the draw is two host
    integers, so building the mask never waits on the card)."""
    c = int(torch.randint(1, max(t, 2), (), generator=gen))
    left = int(torch.randint(0, 1 << 30, (), generator=gen))
    return c, left


def dynamic_chunk_size(c: int, left_draw: int, t: int, max_chunk_size: int,
                       use_dynamic_left_chunk: bool) -> tuple[int, int]:
    """(chunk size, left chunks) from one draw (tpuasr/nn/masks.py:84-98):
    full context if c > t//2, else c % max_chunk_size + 1; with a dynamic
    left budget, left_draw % max((t-1)//chunk, 1) chunks, unlimited (-1) for
    a full-context draw."""
    cs = t if c > t // 2 else c % max_chunk_size + 1
    if not use_dynamic_left_chunk:
        return cs, -1
    left = left_draw % max((t - 1) // max(cs, 1), 1)
    return cs, (-1 if cs >= t else left)


def add_optional_chunk_mask(pad_mask: torch.Tensor, *, use_dynamic_chunk: bool,
                            decoding_chunk_size: int, static_chunk_size: int,
                            num_decoding_left_chunks: int,
                            use_dynamic_left_chunk: bool = False,
                            chunk_gen: torch.Generator | None = None,
                            max_chunk_size: int = 25) -> torch.Tensor:
    """[B, 1, T] pad mask (True = valid) -> [B, T, T] attention mask.

    Semantics of wenet add_optional_chunk_mask (mask.py:126-198):
    - use_dynamic_chunk with decoding_chunk_size == 0 (training): a chunk
      size drawn from `chunk_gen` (`draw_dynamic_chunk`, `dynamic_chunk_size`);
    - use_dynamic_chunk with decoding_chunk_size < 0: full context;
    - decoding_chunk_size > 0: fixed chunk + num_decoding_left_chunks;
    - static_chunk_size > 0 (no dynamic): static chunk;
    - else: padding mask only, returned as a broadcast view (no copy)."""
    b, _, t = pad_mask.shape
    if use_dynamic_chunk:
        if decoding_chunk_size == 0:
            if chunk_gen is None:
                raise ValueError("dynamic-chunk training needs a chunk generator")
            cs, left = dynamic_chunk_size(*draw_dynamic_chunk(chunk_gen, t), t,
                                          max_chunk_size, use_dynamic_left_chunk)
            return pad_mask & chunk_mask(t, cs, left, pad_mask.device)[None]
        if decoding_chunk_size < 0:
            return pad_mask.expand(b, t, t)
        cm = chunk_mask(t, decoding_chunk_size, num_decoding_left_chunks, pad_mask.device)
        return pad_mask & cm[None]
    if static_chunk_size > 0:
        cm = chunk_mask(t, static_chunk_size, num_decoding_left_chunks, pad_mask.device)
        return pad_mask & cm[None]
    return pad_mask.expand(b, t, t)
