"""Fixed-capacity streaming caches of the multi-rate encoder families (port
of ``tpuasr/streaming/family_cache.py``): squeezeformer's U-Net
reduce/recover and the efficient conformer's mid-stack strides.

Both families stream with one contract: per-layer K/V caches of
`chunk * left_chunks / factor_i` frames at each layer's own frame rate, a
conv left-context cache of `kernel - 1` frames per layer, and one full-rate
offset. Where the rate changes inside the block stack stays in the family
encoders. The caches' shapes differ by layer, so the state is a tuple per
layer, not the conformer's stacked [L, ...] `EncoderStreamState`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class FamilyStreamState:
    """Per-layer fixed-shape streaming caches.

    att:    tuple over layers of (k, v), each [B, A_i, H, dk] at the layer's
            own rate, right-aligned (newest last), A_i = chunk * left / f_i.
    cnn:    tuple over layers of [B, kernel - 1, D] conv left context.
    offset: full-rate encoder frames consumed so far (shared by the batch),
            kept on the host so position windows and masks need no sync.
    """

    att: tuple
    cnn: tuple
    offset: int


def init_family_state(batch: int, chunk_size: int, num_left_chunks: int, num_blocks: int,
                      layer_factor, heads: int, dk: int, lorder: int, dim: int,
                      dtype: torch.dtype, device) -> FamilyStreamState:
    """Zeroed per-layer caches; `layer_factor(i)` is layer i's frame-rate
    downsampling factor."""
    a = chunk_size * max(num_left_chunks, 0)
    att, cnn = [], []
    for i in range(num_blocks):
        shape = (batch, a // layer_factor(i), heads, dk)
        att.append((torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device)))
        cnn.append(torch.zeros((batch, lorder, dim), dtype=dtype, device=device))
    return FamilyStreamState(att=tuple(att), cnn=tuple(cnn), offset=0)


def rate_view(pe, offset: int, a0: int, chunk: int, batch: int, factor: int,
              dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos_emb [1, a_f + chunk_f, D], att_mask [B, chunk_f, a_f + chunk_f])
    for the layers at downsampling `factor`.

    a0 is the full-rate cache capacity. The position window covers the
    cache and the chunk at their absolute positions, every factor-th row of
    the table; the mask hides the cache slots not filled yet (cold start:
    j >= a_f - min(off_f, a_f))."""
    a_f, chunk_f, off_f = a0 // factor, chunk // factor, offset // factor
    pos = pe.position_encoding((off_f - a_f) * factor, a_f + chunk_f, stride=factor).to(dtype)
    j = torch.arange(a_f + chunk_f, device=pos.device)
    att_mask = (j >= a_f - min(off_f, a_f))[None, None, :].expand(batch, chunk_f, a_f + chunk_f)
    return pos, att_mask


def roll_cache(k_full: torch.Tensor, v_full: torch.Tensor, a_i: int):
    """The trailing `a_i` frames of the concatenated cache + chunk K/V (the
    fixed-capacity rollover); empty caches for a_i = 0."""
    start = k_full.shape[1] - a_i
    return k_full[:, start:], v_full[:, start:]
