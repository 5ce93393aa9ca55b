"""Streaming decode with the streams split over the data ranks (port of
``tpuasr/parallel/decode.py``).

The streaming greedy and beam searches (`tpuasr_torch.decode.rnnt_streaming`)
carry a leading stream axis through every state (encoder caches, predictor
state, hypotheses), so splitting them over ranks is a split of rows, not a
new algorithm: each data rank decodes its block of streams with no
collective inside the search loops (a rank's early exit is its own), and
one all-gather returns the whole batch's tokens and lengths on every rank.
Partitioning an embarrassingly parallel computation changes no hypothesis.
"""

from __future__ import annotations

import torch

from tpuasr_torch.parallel.mesh import Mesh, shard_batch


def make_sharded_streaming_decode(model, mesh: Mesh, mode: str = "greedy", *, chunk_size: int,
                                  num_left_chunks: int, blank_id: int, beam_size: int = 4,
                                  n_steps: int = 0, max_tokens: int = 200,
                                  ctc_weight: float = 0.0, transducer_weight: float = 0.7):
    """-> decode(feats [B, T, F], feat_lens [B]) -> (tokens [B, max_tokens],
    lens [B]) for the whole batch on every rank, each data rank searching
    its contiguous block of B / data_size streams (B must divide by the
    data size). `mode`: "greedy" (`streaming_greedy_decode`, n_steps 0 =
    10) or "beam" (`streaming_beam_decode`, n_steps 0 = 1, per-frame CTC
    fusion with `ctc_weight`)."""
    from tpuasr_torch.decode.rnnt_streaming import (
        streaming_beam_decode, streaming_greedy_decode,
    )

    if mode == "greedy":
        def search(feats, feat_lens):
            return streaming_greedy_decode(model, feats, feat_lens, chunk_size,
                                           num_left_chunks, blank_id, n_steps=n_steps or 10,
                                           max_tokens=max_tokens)[:2]
    elif mode == "beam":
        def search(feats, feat_lens):
            return streaming_beam_decode(model, feats, feat_lens, chunk_size, num_left_chunks,
                                         blank_id, beam_size=beam_size, max_tokens=max_tokens,
                                         n_steps=n_steps or 1, ctc_weight=ctc_weight,
                                         transducer_weight=transducer_weight)[:2]
    else:
        raise ValueError(f"mode must be greedy|beam, got {mode!r}")

    @torch.no_grad()
    def decode(feats: torch.Tensor, feat_lens: torch.Tensor):
        local = shard_batch({"feats": feats, "feat_lens": feat_lens}, mesh)
        toks, lens = search(local["feats"], local["feat_lens"])
        rows = toks.shape[0]
        flat = torch.cat([toks.reshape(-1).long(), lens.reshape(-1).long()])
        out = mesh.gather(flat.to(model.device))
        per = out.view(mesh.data_size, -1)
        return (per[:, :toks.numel()].reshape(-1, toks.shape[1]),
                per[:, toks.numel():].reshape(mesh.data_size * rows))

    return decode
