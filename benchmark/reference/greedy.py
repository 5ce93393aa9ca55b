"""Plain batched greedy RNN-T search in lockstep and the fit of the joint's
blank bias by bisection (a frozen copy of the serving checks' bisection):
random weights emit at nearly every frame or never, so the blank logit's
bias is set where greedy search emits a stated number of tokens an
encoder frame."""

from __future__ import annotations

import torch

from benchmark.reference.precision import Precision
from benchmark.reference.transducer import project


def _lstm_step(P, tok, h, c, prec: Precision):
    x = P["predictor.embed.weight"][tok]
    g = prec.linear(x, P["predictor.wx.0.weight"], P["predictor.wx.0.bias"]) + \
        prec.matmul(h, P["predictor.wh.0"])
    i_, f_, g_, o_ = g.chunk(4, dim=-1)
    c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
    h = torch.sigmoid(o_) * torch.tanh(c)
    out = prec.linear(h, P["predictor.projection.weight"], P["predictor.projection.bias"])
    return out, h, c


@torch.no_grad()
def search(P, cfg: dict, enc, enc_lens, n_steps: int, prec: Precision,
           max_tokens: int | None = None):
    """Lockstep greedy over S streams -> (the emissions: [(frame, stream,
    token)] device tensors a step, tokens emitted a stream [S], the emission
    steps taken). A frame runs steps while any stream still emits, up to
    `n_steps`, a stream's frame ending at its first blank; the predictor
    advances on emission only; a stream holding `max_tokens` emits no
    more."""
    blank = cfg["model"]["blank_id"]
    s, t, _ = enc.shape
    hdim = P["predictor.wh.0"].shape[0]
    h = torch.zeros(s, hdim, device=enc.device)
    c = torch.zeros_like(h)
    tok = torch.full((s,), blank, dtype=torch.long, device=enc.device)
    enc_p, _ = project(P, enc, enc[:, :1], prec)
    count = torch.zeros(s, dtype=torch.long, device=enc.device)
    cap = max_tokens if max_tokens is not None else t * n_steps + 1
    w, b = P["joint.ffn_out_kernel"], P["joint.ffn_out_bias"]
    steps, emitted = 0, []
    for i in range(t):
        emitting = i < enc_lens
        for _ in range(n_steps):
            if not bool(emitting.any()):
                break
            steps += 1
            out, h2, c2 = _lstm_step(P, tok, h, c, prec)
            pp = prec.linear(out, P["joint.pred_ffn.weight"], P["joint.pred_ffn.bias"])
            best = (prec.matmul(torch.tanh(enc_p[:, i] + pp), w) + b).argmax(-1)
            emit = emitting & (best != blank) & (count < cap)
            h = torch.where(emit[:, None], h2, h)
            c = torch.where(emit[:, None], c2, c)
            tok = torch.where(emit, best, tok)
            count += emit.long()
            emitted.append((i, emit, best))
            emitting = emit
    return emitted, count, steps


def greedy_tokens(P, cfg: dict, enc, enc_lens, n_steps: int, prec: Precision):
    """-> (tokens emitted a stream [S], the emission steps taken)."""
    _, count, steps = search(P, cfg, enc, enc_lens, n_steps, prec)
    return count, steps


def greedy_paths(P, cfg: dict, enc, enc_lens, n_steps: int, prec: Precision,
                 max_tokens: int | None = None) -> tuple[list, list]:
    """-> (each stream's tokens, the encoder frame each was emitted at)."""
    emitted, _, _ = search(P, cfg, enc, enc_lens, n_steps, prec, max_tokens)
    tokens = [[] for _ in range(enc.shape[0])]
    frames = [[] for _ in range(enc.shape[0])]
    if emitted:
        emit = torch.stack([e for _, e, _ in emitted]).cpu().numpy()
        best = torch.stack([x for _, _, x in emitted]).cpu().numpy()
        for k, (i, _, _) in enumerate(emitted):
            for r in emit[k].nonzero()[0]:
                tokens[r].append(int(best[k, r]))
                frames[r].append(i)
    return tokens, frames


def fit_blank_bias(P, cfg: dict, enc, enc_lens, target: float, n_steps: int,
                   prec: Precision, iters: int = 12) -> tuple[float, float]:
    """Bisection of the blank bias on [0, 16] for `target` tokens an encoder
    frame; -> (bias, the rate there). Sets P's blank bias to it."""
    bias = P["joint.ffn_out_bias"]
    blank = cfg["model"]["blank_id"]
    frames = float(enc_lens.sum())

    def rate(x: float) -> float:
        bias[blank] = x
        return float(greedy_tokens(P, cfg, enc, enc_lens, n_steps, prec)[0].sum()) / frames

    lo, hi = 0.0, 16.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if rate(mid) > target else (lo, mid)
    return hi, rate(hi)
