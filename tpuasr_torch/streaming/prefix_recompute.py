"""Simulated streaming by prefix recomputation (port of
``tpuasr/streaming/prefix_recompute.py``).

A loop that gives exact streaming outputs for any encoder family,
non-causal configurations without cached-chunk support among them (the
squeezeformer with its look-ahead "conv" time reduction, non-causal conv
modules): each chunk re-runs the chunk-masked full forward over the prefix
received so far and emits only the frames that are final. The chunk mask
keeps a frame from seeing future chunks, so its value is that of a cached
implementation; the cost is O(T²) instead of O(T × cache). The cached paths
(`ConformerEncoder.forward_chunk`, the families' per-rate caches) are the
serving ones; this stays the streaming path for what they do not cover and the
oracle they are held to.
"""

from __future__ import annotations

from typing import Callable

import torch


@torch.no_grad()
def chunked_prefix_encode(encode_fn: Callable, feats: torch.Tensor, feat_lens: torch.Tensor,
                          chunk_size: int, subsampling_rate: int, right_context: int,
                          out_len_fn: Callable[[int], int], lookahead: int = 0
                          ) -> list[torch.Tensor]:
    """-> the list of each chunk's new encoder frames [B, <= chunk +
    lookahead, D].

    encode_fn(feats [B, Tp, F], lens [B]) -> (ys [B, T', D], ...): the
    chunk-masked full forward. `lookahead`: encoder frames held back until
    their right context has arrived (a non-causal conv module makes a
    frame final only once the prefix reaches that far past it); 0 for a
    causal encoder. The last chunk flushes everything."""
    t = feats.shape[1]
    stride = chunk_size * subsampling_rate
    context = right_context + 1
    outs, emitted, cur = [], 0, stride
    while cur - stride < t - context + 1:
        prefix = min(cur + context - 1, t)
        ys = encode_fn(feats[:, :prefix], torch.clamp(feat_lens, max=prefix))[0]
        avail = min(out_len_fn(prefix), ys.shape[1])
        finalized = avail if prefix >= t else max(avail - lookahead, 0)
        if finalized > emitted:
            outs.append(ys[:, emitted:finalized])
            emitted = finalized
        cur += stride
    return outs
