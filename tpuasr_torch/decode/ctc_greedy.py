"""Batched CTC greedy decode (port of ``tpuasr/decode/ctc_greedy.py``):
argmax per frame, collapse repeats, drop blanks, the kept tokens compacted
by one scatter for the whole batch."""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.no_grad()
def ctc_greedy_decode(log_probs: torch.Tensor, lens: torch.Tensor, blank_id: int,
                      pad_id: int = 0, with_details: bool = False):
    """log_probs [B, T, V], lens [B] -> (tokens [B, T] padded with pad_id,
    token_lens [B]); with_details adds (times [B, T]: the frame of each
    emission, confidence [B]: the mean probability of the kept tokens)."""
    b, t, _ = log_probs.shape
    dev = log_probs.device
    ids = log_probs.argmax(dim=-1)  # [B, T], the first of equal maxima
    valid = torch.arange(t, device=dev)[None, :] < lens.to(dev)[:, None]
    prev = F.pad(ids, (1, 0), value=blank_id)[:, :t]
    keep = (ids != blank_id) & (ids != prev) & valid
    # kept tokens to their compacted slot, the rest to a trash column t
    col = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t)
    out = torch.full((b, t + 1), pad_id, dtype=ids.dtype, device=dev)
    out.scatter_(1, col, torch.where(keep, ids, pad_id))
    token_lens = keep.sum(dim=1)
    if not with_details:
        return out[:, :t], token_lens
    frame_idx = torch.arange(t, device=dev).expand(b, t)
    times = torch.zeros((b, t + 1), dtype=torch.long, device=dev)
    times.scatter_(1, col, torch.where(keep, frame_idx, 0))
    top_p = torch.exp(log_probs.amax(dim=-1))
    conf = torch.where(keep, top_p, 0.0).sum(dim=1) / torch.clamp(token_lens, min=1)
    return out[:, :t], token_lens, times[:, :t], conf


def remove_duplicates_and_blank(ids, blank_id: int) -> list[int]:
    """Host-side collapse of one frame-label sequence (wenet
    ctc_utils.py:23-33 parity)."""
    out, prev = [], None
    for i in ids:
        if i != blank_id and i != prev:
            out.append(int(i))
        prev = i
    return out
