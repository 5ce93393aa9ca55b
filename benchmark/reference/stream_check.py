"""The streaming cell's comparison: the served tokens against the reference's
logits along the path the greedy search took.

The reference computes each sampled stream's features, its chunk-masked
encoder output over the whole utterance (chunks of `chunk` frames, `left`
chunks back, no padding mask: the streaming encoder's view, whose
caches hold every frame it encoded), and the joint's logits at every
(frame, label prefix) of the served tokens. Greedy search decides at each
such point between the blank (next frame) and the next token. The frames at
which each token was emitted are known to the chunk (the call that
returned it), not inside it, so the path is the alignment of the served
tokens, each inside its chunk, whose widest gap is least: the gap of a
decision is the reference's best logit there minus the logit of what was
served. `gap` is that widest gap over the sampled streams, in logits; 0
when every decision was the reference's argmax.

A control in the program's place (the reference in a lower precision)
serves its own tokens: its lockstep greedy search over its own encoder
output (`greedy.greedy_paths`), each token known to its chunk as the
program's are, read by the same comparison.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.conformer import encoder, subsampled_len
from benchmark.reference.features import logmel
from benchmark.reference.precision import Precision
from benchmark.reference.transducer import joint_logits, predictor, project

INF = np.float32(np.inf)


def _need_frames(n_chunks: int, chunk: int, rate: int = 4, right: int = 6) -> int:
    return (n_chunks - 1) * rate * chunk + (chunk - 1) * rate + right + 1


def encode(P, cfg: dict, waves, n_chunks: int, prec: Precision):
    """[S, N] waves (the served buffer's rows) -> (enc [S, chunk * n, D],
    enc_lens [S] from the given lengths is the caller's)."""
    s = cfg["streaming"]
    feats = logmel(waves, cfg["feature"], prec)
    need = _need_frames(n_chunks, s["chunk_size"])
    feats = F.pad(feats, (0, 0, 0, max(0, need - feats.shape[1])))[:, :need]
    lens = torch.full((waves.shape[0],), need, device=waves.device)
    enc, _ = encoder(P, cfg["model"]["encoder"], feats, lens, s["chunk_size"],
                     s["num_left_chunks"], prec, masks=None, pad_masked=False)
    return enc


def gaps(P, cfg: dict, enc, enc_lens, tokens: list, block: int = 16):
    """Per stream: the fp32 reference's gap arrays at every (frame, prefix)
    of its served `tokens` -> list of dicts {"blank" [T, U+1], "tok" [T, U]}
    as numpy, T = the stream's valid frames, U its tokens; `enc` [S, T', D]
    the reference's encoder output."""
    blank = cfg["model"]["blank_id"]
    prec = Precision("fp32")
    out = []
    for i in range(0, len(tokens), block):
        toks = tokens[i:i + block]
        umax = max(max(len(t) for t in toks), 1)
        lab = torch.tensor([t + [blank] * (umax - len(t)) for t in toks], dtype=torch.long,
                           device=enc.device)
        tmax = int(enc_lens[i:i + block].max())
        pred = predictor(P, F.pad(lab, (1, 0), value=blank), prec)
        ep, pp = project(P, enc[i:i + block, :tmax], pred, prec)
        ref = joint_logits(P, ep, pp, prec)
        best = ref.max(-1).values
        g_blank = (best - ref[..., blank]).cpu().numpy()
        g_tok = (best[..., :umax] - ref[:, :, :umax].gather(
            3, lab[:, None, :, None].expand(-1, tmax, -1, 1))[..., 0]).cpu().numpy()
        for j, t in enumerate(toks):
            tl, u = int(enc_lens[i + j]), len(t)
            out.append({"blank": g_blank[j, :tl, :u + 1], "tok": g_tok[j, :tl, :u]})
    return out


def least_widest(gs: list, token_chunks: list, chunk: int, n_steps: int) -> list:
    """The minimax alignments of a block of streams' tokens, each token
    inside its chunk, at most `n_steps` emissions a frame (a frame that
    reaches them ends without a blank decision, as the search's does):
    -> per stream its widest gap (inf where no alignment keeps every token
    in its chunk)."""
    s = len(gs)
    t_max = max(g["blank"].shape[0] for g in gs)
    u1 = max(g["blank"].shape[1] for g in gs)
    j = n_steps + 1
    gb = np.zeros((s, t_max, u1), np.float32)
    gt = np.full((s, t_max, u1), INF, np.float32)
    ok = np.zeros((s, t_max, u1), bool)  # token u may be emitted at frame t
    for i, (g, tc) in enumerate(zip(gs, token_chunks)):
        tl, n = g["blank"].shape
        gb[i, :tl, :n] = g["blank"]
        gt[i, :tl, :n - 1] = g["tok"]
        ok[i, :tl, :n - 1] = np.asarray(tc)[None, :] == (np.arange(tl) // chunk)[:, None]
    # cost[s, u, k]: the least widest gap of a path at the current frame with
    # u tokens out, k of them emitted in this frame
    cost = np.full((s, u1, j), INF, np.float32)
    cost[:, 0, 0] = 0.0
    for t in range(t_max):
        for u in np.flatnonzero(ok[:, t].any(0)):
            cand = np.maximum(cost[:, u, :-1], gt[:, t, u, None])
            better = ok[:, t, u, None] & (cand < cost[:, u + 1, 1:])
            cost[:, u + 1, 1:] = np.where(better, cand, cost[:, u + 1, 1:])
        blank = np.maximum(cost.min(-1), gb[:, t])
        nxt = np.full_like(cost, INF)
        nxt[..., 0] = np.minimum(cost[..., -1], blank)  # the cap ends a frame without a blank
        cost = nxt
    # past a stream's last frame its gaps are 0 and it emits nothing: its
    # cost stands as it was at that frame
    return [float(cost[i, g["blank"].shape[1] - 1, 0]) for i, g in enumerate(gs)]


def read(gap_list: list, token_chunks: list, chunk: int, n_steps: int,
         block: int = 32) -> float:
    """-> the widest gap of the served tokens' least alignment, over the
    streams."""
    gap = 0.0
    for i in range(0, len(gap_list), block):
        gap = max([gap] + least_widest(gap_list[i:i + block], token_chunks[i:i + block], chunk,
                                       n_steps))
    return gap


def full(gap_list: list, tokens: list, max_tokens: int) -> None:
    """A hypothesis holding `max_tokens` is full: the search emits no more,
    so its last prefix's blank decisions are none (set to 0 in place)."""
    for g, t in zip(gap_list, tokens):
        if len(t) >= max_tokens:
            g["blank"][:, -1] = 0.0


def enc_lengths(wave_lens, hop: int):
    return subsampled_len(1 + wave_lens.long() // hop)
