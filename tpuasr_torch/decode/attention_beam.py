"""Batched autoregressive attention beam search (port of
``tpuasr/decode/attention_beam.py``).

A B × N beam over the attention decoder (wenet search.py:250-366): the
self-attention caches are preallocated [L, B·N, Lmax, H, dk] buffers
written at the step index, the cross-attention K/V are projected once, and
a beam's reselection is one gather over the hypothesis axis. Finished
hypotheses are frozen: their only continuation is <eos> at no cost. A
forced prompt prefix is prefilled through the cache, and the final length
penalty divides by (tokens + prompt)^alpha, the reference's count.

As in the other beam searches of the port, `rnnt_beam.top_k` puts the lower
index first among equal values (exact ties are routine: at the first step
N - 1 beams sit at -1e30, a finished beam's row is -1e30 but for <eos>) and
`first_argmax` takes the first best, as `jnp.argmax`. The step loop runs on
the host and stops, one device sync a step, once every hypothesis is
finished and alive: from then on a step maps the beam to itself (each
hypothesis keeps its score through <eos>, the buffers already hold <eos>),
so the result is the JAX package's full `max_len` scan.
"""

from __future__ import annotations

import torch

from tpuasr_torch.decode.rnnt_beam import first_argmax, top_k

_NEG = -1.0e30


@torch.no_grad()
def attention_beam_search(model, enc_out: torch.Tensor, enc_lens: torch.Tensor, sos_id: int,
                          eos_id: int, beam_size: int = 10, max_len: int = 64,
                          prompt: torch.Tensor | None = None, length_penalty: float = 0.0,
                          nbest: bool = False):
    """enc_out [B, T, D], enc_lens [B] -> (best tokens [B, max_len] (no
    prompt, no <eos>, 0 past the length), best lens [B], n-best scores
    [B, N]). `prompt` [B, P]: the forced prefix (default [<sos>]). With
    `nbest` a fourth item, the n-best lists (tokens [B, N, max_len] laid
    out as the best's, lens [B, N]), to compare two runs slot by slot."""
    b, t, _ = enc_out.shape
    n, dev = beam_size, enc_out.device
    if prompt is None:
        prompt = torch.full((b, 1), sos_id, dtype=torch.long, device=dev)
    prompt = prompt.to(dev).long()
    p = prompt.shape[1]
    lmax = p + max_len

    # the memory of each utterance for its N hypotheses
    mem_lens = enc_lens.to(dev).repeat_interleave(n)
    mem_mask = (torch.arange(t, device=dev)[None, :] < mem_lens[:, None])[:, None, :]
    mem_k, mem_v = model.decoder_project_memory(enc_out.repeat_interleave(n, dim=0))
    kcache, vcache = model.decoder_init_cache(b * n, lmax)

    tokens = torch.full((b, n, lmax), eos_id, dtype=torch.long, device=dev)
    tokens[:, :, :p] = prompt[:, None, :]
    scores = torch.full((b, n), _NEG, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, n), dtype=torch.bool, device=dev)
    lens = torch.zeros((b, n), dtype=torch.long, device=dev)

    # the prompt prefix through the cache (all beams alike; its last
    # position is the first beam step's input)
    for i in range(p - 1):
        model.decoder_one_step(prompt[:, i].repeat_interleave(n), i, kcache, vcache, mem_k,
                               mem_v, mem_mask)

    rows = (torch.arange(b, device=dev) * n)[:, None]
    for pos in range(p - 1, lmax - 1):
        lp, kcache, vcache = model.decoder_one_step(
            tokens[:, :, pos].reshape(b * n), pos, kcache, vcache, mem_k, mem_v, mem_mask)
        lp = lp.view(b, n, -1)
        # a finished hypothesis continues by <eos> alone, at no cost
        eos_only = torch.full_like(lp, _NEG)
        eos_only[:, :, eos_id] = 0.0
        lp = torch.where(finished[..., None], eos_only, lp)

        top_lp, top_tok = top_k(lp, n)  # [B, N, N]
        new_scores, sel = top_k((scores[..., None] + top_lp).reshape(b, n * n), n)
        src = torch.div(sel, n, rounding_mode="floor")  # the originating hypothesis
        sel_tok = torch.gather(top_tok.reshape(b, n * n), 1, sel)

        tokens = torch.gather(tokens, 1, src[..., None].expand(-1, -1, lmax))
        finished = torch.gather(finished, 1, src)
        lens = torch.gather(lens, 1, src)
        # only positions <= pos were written: the rest is zeros in every row
        flat = (src + rows).reshape(-1)
        kcache[:, :, :pos + 1] = kcache[:, flat, :pos + 1]
        vcache[:, :, :pos + 1] = vcache[:, flat, :pos + 1]

        tokens[:, :, pos + 1] = sel_tok
        is_eos = sel_tok == eos_id
        lens = torch.where(finished | is_eos, lens, lens + 1)
        finished = finished | is_eos
        scores = new_scores
        if bool((finished & (scores > -1.0e29)).all()):
            break

    if length_penalty != 0.0:
        # score / (non-eos tokens + prompt)^alpha, the reference's count
        scores = scores / torch.pow((lens + p).clamp(min=1).to(scores.dtype), length_penalty)
    best = first_argmax(scores, 1)
    r = torch.arange(b, device=dev)
    best_tokens, best_lens = tokens[r, best, p:], lens[r, best]
    valid = torch.arange(max_len, device=dev)[None, :] < best_lens[:, None]
    out = (torch.where(valid, best_tokens, 0), best_lens, scores)
    if not nbest:
        return out
    valid = torch.arange(max_len, device=dev)[None, None, :] < lens[..., None]
    return out + ((torch.where(valid, tokens[:, :, p:], 0), lens),)
