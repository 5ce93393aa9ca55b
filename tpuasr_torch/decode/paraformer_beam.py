"""The positionwise batch beam over NAR (Paraformer) logits and CIF
timestamps (port of ``tpuasr/decode/paraformer_beam.py``).

Positions are independent given the fired embeddings, so the beam is a
top-k over the running scores plus each position's log-probs; a row past
its length extends every hypothesis by one zero-cost child, the token
forced to <eos> (wenet/paraformer/search.py:181-255 with
wenet/utils/mask.py:258-304). The position loop runs on the host over
dense tensors (tokens [B, N, U], scores [B, N]). `top_k` is
`tpuasr_torch.decode.rnnt_beam.top_k`, which puts the lower index first
among equal values as `jax.lax.top_k` does: at a finished row every beam
but the first sits at -1e30, so the choice among exact ties decides what
the n-best's dead slots hold.
"""

from __future__ import annotations

import torch

from tpuasr_torch.decode.rnnt_beam import top_k

_NEG = -1.0e30


@torch.no_grad()
def nar_beam_search(logits: torch.Tensor, lens: torch.Tensor, beam_size: int = 10,
                    eos_id: int = 3):
    """logits [B, U, V], lens [B] -> (tokens [B, N, U] int32, scores [B, N]
    descending)."""
    b, u, v = logits.shape
    n = beam_size
    dev = logits.device
    lens = lens.to(dev)
    lp = torch.log_softmax(logits.float(), dim=-1)
    # a finished row's one zero-cost child (its token forced to eos below)
    eos_only = torch.full((v,), _NEG, device=dev)
    eos_only[0] = 0.0

    scores, idx = top_k(lp[:, 0], n)
    fin0 = (lens <= 0)[:, None]
    first = torch.where(torch.arange(n, device=dev)[None, :] == 0, 0.0, _NEG)
    scores = torch.where(fin0, first, scores)
    tokens = torch.zeros((b, n, u), dtype=torch.long, device=dev)
    tokens[:, :, 0] = torch.where(fin0, eos_id, idx)
    for i in range(1, u):
        finished = (lens <= i)[:, None, None]
        ext = scores[:, :, None] + torch.where(finished, eos_only, lp[:, i][:, None, :])
        scores, top = top_k(ext.reshape(b, n * v), n)
        tokens = torch.gather(tokens, 1, (top // v)[..., None].expand(-1, -1, u))
        tokens[:, :, i] = torch.where(finished[:, :, 0], eos_id, top % v)
    return tokens.to(torch.int32), scores


def cif_timestamps_from_peaks(peaks, num_frames: int, frame_rate: float = 0.02):
    """(start, end) seconds per token from CIF fire frames (wenet
    paraformer/search.py:113-136): each fire shifted back half a frame; a
    token spans its fire to the next, at most MAX_TOKEN_DURATION frames; a
    tail of more than START_END_THRESHOLD frames after the last fire ends
    the last token at the midpoint and adds a trailing silence segment."""
    start_end_threshold = 5
    max_token_duration = 14
    fires = [p - 0.5 for p in peaks]
    times = []
    for i in range(len(fires) - 1):
        start = fires[i]
        end = fires[i + 1] if fires[i + 1] - fires[i] <= max_token_duration \
            else fires[i] + max_token_duration
        times.append([start * frame_rate, end * frame_rate])
    if times:
        if num_frames - fires[-1] > start_end_threshold:
            mid = (num_frames + fires[-1]) * 0.5
            times[-1][1] = mid * frame_rate
            times.append([mid * frame_rate, num_frames * frame_rate])
        else:
            times[-1][1] = num_frames * frame_rate
    return [tuple(t) for t in times]
