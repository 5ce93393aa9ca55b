"""Batched CTC prefix beam search (port of
``tpuasr/decode/ctc_prefix_beam.py``).

The beam is dense tensors: prefixes [B, N, Umax], lens [B, N], the log
scores of each prefix ending in blank (pb) and in its last token (pnb),
a context-graph state and bias [B, N], and the prefix's rolling hashes
[B, N, 2] (`decode.rnnt_beam._extend_hash`). Per frame:
- stay candidates keep the prefix: pb' = (pb ⊕ pnb) + lp[blank],
  pnb' = pnb + lp[last] (a repeat merges into it);
- extend candidates append each of the frame's top-N non-blank tokens u:
  pnb' = (u == last ? pb : pb ⊕ pnb) + lp[u];
- equal prefixes (hashes and length) log-add into the first of them, and
  the N best by pb ⊕ pnb (+ hotword bias) survive, the lower index first
  among equals (`rnnt_beam.top_k`).
`_logaddexp` is the JAX module's own formula, kept so the scores agree to
fp32 rounding. With `context_graph` the extensions gather the graph's
next state and score delta, and the final ranking adds the finalize
correction. With `return_times` each prefix also carries the best single
path ending in blank and in non-blank with their emission frames (wenet
search.py's v_s / v_ns / times algebra), with the JAX module's one
deviation: a repeated token's time is the loudest frame of its run, not
the last.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpuasr_torch.decode.rnnt_beam import (
    _extend, _extend_hash, _first_occurrences, _last_token, _logadd_into_first, first_argmax,
    take_best, top_k,
)

_NEG = -1.0e30


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=_NEG)
    return m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe))


@dataclass
class PrefixBeam:
    tokens: torch.Tensor  # [B, N, Umax] int64
    lens: torch.Tensor  # [B, N]
    pb: torch.Tensor  # [B, N] log prob of the prefix ending in blank
    pnb: torch.Tensor  # [B, N] log prob of the prefix ending in its last token
    node: torch.Tensor  # [B, N] context-graph state (0 without a graph)
    bias: torch.Tensor  # [B, N] accumulated hotword bias
    seq_hash: torch.Tensor  # [B, N, 2] uint32 values in int64


def _first_occurrence_merge(keys, lens, pb, pnb):
    """Log-add the pb's and pnb's of equal prefixes (keys [B, C, K], lens
    [B, C]) into the first occurrence, the others -> -1e30; -> (pb, pnb,
    contrib [B, C(i), C(j)]: j merges into i, is_first [B, C])."""
    contrib, is_first = _first_occurrences(keys, lens)
    return (_logadd_into_first(contrib, is_first, pb), _logadd_into_first(contrib, is_first, pnb),
            contrib, is_first)


def _take(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """x [B, C, ...], sel [B, N] -> x[b, sel[b, j], ...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, sel]


@torch.no_grad()
def ctc_prefix_beam_search(log_probs: torch.Tensor, lens: torch.Tensor, blank_id: int,
                           beam_size: int = 10, max_tokens: int = 200, context_graph=None,
                           return_times: bool = False):
    """log_probs [B, T, V] (log-softmaxed), lens [B] -> (best tokens
    [B, max_tokens], best lens [B], (n-best tokens [B, N, max_tokens],
    lens [B, N], scores [B, N])); with `return_times`: (best tokens, best
    lens, best times [B, max_tokens], (n-best tokens, lens, scores, times
    [B, N, max_tokens]))."""
    b, t, _ = log_probs.shape
    n, umax, dev = beam_size, max_tokens, log_probs.device
    log_probs = log_probs.float()
    neg = lambda *shape: torch.full(shape, _NEG, device=dev)

    if context_graph is not None:
        cg_next = torch.as_tensor(context_graph.next_state, device=dev).long()
        cg_delta = torch.as_tensor(context_graph.score_delta, device=dev)
        cg_final = torch.as_tensor(context_graph.finalize_score, device=dev)
    pb0 = neg(b, n)
    pb0[:, 0] = 0.0
    beam = PrefixBeam(tokens=torch.zeros((b, n, umax), dtype=torch.long, device=dev),
                      lens=torch.zeros((b, n), dtype=torch.long, device=dev), pb=pb0,
                      pnb=neg(b, n), node=torch.zeros((b, n), dtype=torch.long, device=dev),
                      bias=torch.zeros((b, n), device=dev),
                      seq_hash=torch.zeros((b, n, 2), dtype=torch.long, device=dev))
    vit = None
    if return_times:
        v0 = neg(b, n)
        v0[:, 0] = 0.0  # the root: v_s = v_ns = 0, dead slots -1e30
        vit = {"v_s": v0, "v_ns": v0.clone(),
               "times_s": torch.zeros((b, n, umax), dtype=torch.long, device=dev),
               "times_ns": torch.zeros((b, n, umax), dtype=torch.long, device=dev),
               "cur": neg(b, n)}  # the log prob of the current last token
    valid = torch.arange(t, device=dev)[None, :] < lens.to(dev)[:, None]
    u_idx = torch.arange(umax, device=dev)

    for t_idx in range(t):
        lp, active = log_probs[:, t_idx], valid[:, t_idx]
        last = _last_token(beam.tokens, beam.lens, blank_id)  # [B, N]
        lp_last = torch.gather(lp, 1, last)  # [B, N]
        total = _logaddexp(beam.pb, beam.pnb)

        # stay candidates
        stay_pb = total + lp[:, blank_id][:, None]
        stay_pnb = torch.where(beam.lens > 0, beam.pnb + lp_last, _NEG)

        # extend candidates: the frame's top-N non-blank tokens
        lp_nb = lp.clone()
        lp_nb[:, blank_id] = _NEG
        top_lp, top_tok = top_k(lp_nb, n)  # [B, N]
        is_repeat = top_tok[:, None, :] == last[:, :, None]  # [B, N, k]
        base = torch.where(is_repeat, beam.pb[..., None], total[..., None])
        can_extend = beam.lens < umax
        ext_pnb = torch.where(can_extend[..., None], base + top_lp[:, None, :], _NEG)
        tok_nk = top_tok[:, None, :].expand(b, n, n)

        cat = lambda stay, ext: torch.cat([stay[:, :, None], ext], dim=2).reshape(
            b, n * (1 + n), *stay.shape[2:])
        cand_tokens = cat(beam.tokens, _extend(beam.tokens, beam.lens, tok_nk))
        cand_lens = cat(beam.lens, (beam.lens + 1)[:, :, None].expand(b, n, n))
        cand_pb = cat(stay_pb, neg(b, n, n))
        cand_pnb = cat(stay_pnb, ext_pnb)
        cand_hash = cat(beam.seq_hash, _extend_hash(beam.seq_hash[:, :, None, :], tok_nk))
        if context_graph is not None:
            cand_node = cat(beam.node, cg_next[beam.node[..., None], tok_nk])
            cand_bias = cat(beam.bias, beam.bias[..., None] + cg_delta[beam.node[..., None],
                                                                       tok_nk])
        else:
            cand_node = torch.zeros((b, n * (1 + n)), dtype=torch.long, device=dev)
            cand_bias = torch.zeros((b, n * (1 + n)), device=dev)

        if vit is not None:
            v_s, v_ns, cur = vit["v_s"], vit["v_ns"], vit["cur"]
            times_s, times_ns = vit["times_s"], vit["times_ns"]
            vbest = torch.maximum(v_s, v_ns)
            times_best = torch.where((v_s > v_ns)[..., None], times_s, times_ns)
            # stay by blank: the best path + blank, its times unchanged
            stay_v_s = vbest + lp[:, blank_id][:, None]
            # stay by repeat: the non-blank path repeats its last token, whose
            # peak frame moves here when this frame is the loudest of the run
            stay_v_ns = torch.where(beam.lens > 0, v_ns + lp_last, _NEG)
            slot = u_idx[None, None, :] == torch.clamp(beam.lens - 1, min=0)[..., None]
            stay_times_ns = torch.where(slot & (lp_last > cur)[..., None], t_idx, times_ns)
            stay_cur = torch.maximum(cur, lp_last)
            # extend: from the blank path when u == last, else from the best
            # path; u's time is this frame
            ext_v = torch.where(is_repeat, v_s[..., None], vbest[..., None])
            ext_v = torch.where(can_extend[..., None], ext_v + top_lp[:, None, :], _NEG)
            ext_base = torch.where(is_repeat[..., None], times_s[:, :, None, :],
                                   times_best[:, :, None, :])
            eslot = u_idx[None, None, None, :] == beam.lens[:, :, None, None]
            ext_times = torch.where(eslot, t_idx, ext_base.expand(b, n, n, umax))
            cand_v_s = cat(stay_v_s, neg(b, n, n))
            cand_v_ns = cat(stay_v_ns, ext_v)
            cand_times_s = cat(times_best, ext_times)
            cand_times_ns = cat(stay_times_ns, ext_times)
            cand_cur = cat(stay_cur, top_lp[:, None, :].expand(b, n, n))

        m_pb, m_pnb, contrib, is_first = _first_occurrence_merge(cand_hash, cand_lens, cand_pb,
                                                                 cand_pnb)
        _, sel = top_k(_logaddexp(m_pb, m_pnb) + cand_bias, n)
        keep = active[:, None]

        def pick(cand, old):
            new = _take(cand, sel)
            return torch.where(keep.view(b, 1, *([1] * (new.dim() - 2))), new, old)

        beam = PrefixBeam(tokens=pick(cand_tokens, beam.tokens), lens=pick(cand_lens, beam.lens),
                          pb=pick(m_pb, beam.pb), pnb=pick(m_pnb, beam.pnb),
                          node=pick(cand_node, beam.node), bias=pick(cand_bias, beam.bias),
                          seq_hash=pick(cand_hash, beam.seq_hash))
        if vit is not None:
            # the Viterbi merge is a max over contributors; times and cur
            # follow the (first) argmax contributor
            def vmerge(vs, times, tok_lp=None):
                cand = torch.where(contrib, vs[:, None, :], _NEG)
                src = first_argmax(cand, -1)  # [B, C]
                merged = _take(torch.where(is_first, cand.amax(-1), _NEG), sel)
                mt = _take(_take(times, src), sel)
                return merged, mt, (None if tok_lp is None else _take(_take(tok_lp, src), sel))

            nv_s, nt_s, _ = vmerge(cand_v_s, cand_times_s)
            nv_ns, nt_ns, ncur = vmerge(cand_v_ns, cand_times_ns, cand_cur)
            vit = {"v_s": torch.where(keep, nv_s, v_s), "v_ns": torch.where(keep, nv_ns, v_ns),
                   "times_s": torch.where(keep[..., None], nt_s, times_s),
                   "times_ns": torch.where(keep[..., None], nt_ns, times_ns),
                   "cur": torch.where(keep, ncur, cur)}

    score = _logaddexp(beam.pb, beam.pnb) + beam.bias
    if context_graph is not None:
        score = score + cg_final[beam.node]
    if return_times:
        nb_times = torch.where((vit["v_s"] > vit["v_ns"])[..., None], vit["times_s"],
                               vit["times_ns"])
        return (*take_best(score, beam.tokens, beam.lens, nb_times),
                (beam.tokens, beam.lens, score, nb_times))
    return (*take_best(score, beam.tokens, beam.lens), (beam.tokens, beam.lens, score))
