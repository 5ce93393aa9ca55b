"""Batched frame-synchronous RNN-T beam search (port of
``tpuasr/decode/rnnt_beam.py``).

The hypotheses of B streams are dense tensors: tokens [B, N, Umax], lens
[B, N], logp [B, N], the LSTM state ([L, B, N, H], [L, B, N, H]) and two
rolling uint32 hashes of each token sequence [B, N, 2]. Per frame every
hypothesis proposes blank (its state frozen) and its top-k non-blank
extensions (its state advanced by one predictor step over the B*N rows);
candidates with the same (hashes, length, frame phase) merge by log-add
into the first of them, and the top N survive. With `n_steps > 1` a frame
takes up to n_steps such expansions, a done flag (the hypothesis took this
frame's blank) in the merge key; with `ctc_logp` the frame's CTC log-probs
are fused into the transducer's, ``log(tw e^rnnt + cw e^ctc)``.

What the JAX package gets from XLA, the port states itself, so that both
give the same hypotheses in every n-best slot:
- `top_k` puts the lower index first among equal values, as
  `jax.lax.top_k` does. Exact ties are routine: the N - 1 empty slots of
  the first frame and every squashed duplicate sit at -1e30, and which of
  them fill the n-best decides what its dead slots hold.
- `first_index` / `first_argmax` take the first match, as `jnp.argmax`
  does (and `torch.argmax` promises).
- The hashes are uint32 arithmetic with wraparound, emulated in int64:
  h * m mod 2^32 with the multiplier split into 16-bit halves, so no
  product passes 2^48.

The frame loop runs on the host; a frame's n_steps expansions stop, as the
JAX `while_loop` does, when every hypothesis has taken the frame's blank,
which the host learns by one device sync a sub-step. Frames no stream
covers are skipped (their carry would pass through unchanged). CUDA graphs
of the frame step are later work (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpuasr_torch.decode.state_utils import (
    gather_beam, merge_beam_axis, predictor_state_axis, split_beam_axis, where_beam,
)

_NEG = -1.0e30
_HASH_MULTS = (1000003, 2654435761)  # two independent rolling-hash streams
_U32 = 0xFFFFFFFF


@dataclass
class BeamCarry:
    tokens: torch.Tensor  # [B, N, Umax] int64
    lens: torch.Tensor  # [B, N] int64
    logp: torch.Tensor  # [B, N] fp32
    pred_state: tuple  # ([L, B, N, H], [L, B, N, H])
    seq_hash: torch.Tensor  # [B, N, 2] int64 holding uint32 values


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, descending, the lower index first
    among equal values (`jax.lax.top_k`'s order) -> (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def first_index(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along `dim` (the length where there is none)."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, device=mask.device).view(shape)
    return torch.where(mask, idx, n).amin(dim)


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along `dim`."""
    return first_index(x == x.amax(dim, keepdim=True), dim)


def _mul_u32(h: torch.Tensor, m: int) -> torch.Tensor:
    """h * m mod 2^32 for int64 h in [0, 2^32) and a uint32 constant m."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & _U32


def _extend_hash(h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """h [..., 2] (uint32 values in int64), tok [...] -> the hashes of the
    sequence + [tok], bit for bit the JAX package's uint32 ones."""
    t = ((tok.long() & _U32) + 1) & _U32
    lanes = [(_mul_u32(h[..., i], m) + t) & _U32 for i, m in enumerate(_HASH_MULTS)]
    return torch.stack(lanes, dim=-1)


def init_beam_carry(model, batch: int, beam: int, max_tokens: int) -> BeamCarry:
    dev = model.device
    ps = split_beam_axis(model.init_predictor_state(batch * beam), batch, beam,
                         predictor_state_axis(model))
    logp = torch.full((batch, beam), _NEG, device=dev)
    logp[:, 0] = 0.0
    return BeamCarry(
        tokens=torch.zeros((batch, beam, max_tokens), dtype=torch.long, device=dev),
        lens=torch.zeros((batch, beam), dtype=torch.long, device=dev),
        logp=logp, pred_state=ps,
        seq_hash=torch.zeros((batch, beam, 2), dtype=torch.long, device=dev))


def _first_occurrences(keys: torch.Tensor, lens: torch.Tensor):
    """Candidates with the same keys [B, C, K] and scalar key lens [B, C]
    -> (contrib [B, C(i), C(j)]: i is the first candidate equal to j,
    is_first [B, C])."""
    same = (keys[:, :, None, :] == keys[:, None, :, :]).all(-1)
    same = same & (lens[:, :, None] == lens[:, None, :])  # [B, C, C]
    idx = torch.arange(keys.shape[1], device=keys.device)
    first = first_index(same, dim=1)  # [B, C]: the first i equal to candidate j
    return first[:, None, :] == idx[None, :, None], first == idx[None, :]


def _logadd_into_first(contrib: torch.Tensor, is_first: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
    """Each first occurrence gets the log-add of its group's scores [B, C];
    the other candidates -> -1e30."""
    cand = torch.where(contrib, scores[:, None, :], _NEG)
    m_safe = torch.clamp(cand.amax(-1), min=_NEG)
    merged = m_safe + torch.log(torch.exp(cand - m_safe[..., None]).sum(-1))
    return torch.where(is_first, merged, _NEG)


def _merge_duplicates(keys: torch.Tensor, lens: torch.Tensor, logp: torch.Tensor):
    """Log-add candidates with the same keys [B, C, K] and scalar key lens
    [B, C] into the first of them; the others -> -1e30."""
    return _logadd_into_first(*_first_occurrences(keys, lens), logp)


def _last_token(tokens: torch.Tensor, lens: torch.Tensor, blank_id: int) -> torch.Tensor:
    """tokens [B, N, U], lens [B, N] -> each hypothesis' last token, blank
    for an empty one."""
    last = torch.gather(tokens, 2, torch.clamp(lens - 1, 0, tokens.shape[2] - 1)[..., None])
    return torch.where(lens > 0, last[..., 0], blank_id)


def take_best(scores: torch.Tensor, *xs: torch.Tensor) -> tuple:
    """scores [B, N] -> each x [B, N, ...] at each stream's highest score
    (the first of equals)."""
    best = first_argmax(scores, 1)
    rows = torch.arange(best.shape[0], device=best.device)
    return tuple(x[rows, best] for x in xs)


def _extend(tokens: torch.Tensor, lens: torch.Tensor, top_tok: torch.Tensor) -> torch.Tensor:
    """tokens [B, N, U], lens [B, N], top_tok [B, N, k] -> [B, N, k, U]:
    each copy with top_tok written at min(len, U - 1)."""
    u = tokens.shape[-1]
    onehot = F.one_hot(torch.clamp(lens, max=u - 1), u).to(tokens.dtype)[..., None, :]
    return tokens[..., None, :] * (1 - onehot) + top_tok[..., None] * onehot


def _log_weight(w: float) -> float:
    return float(torch.log(torch.tensor(max(w, 1e-10), dtype=torch.float32)))


@torch.no_grad()
def beam_frames(model, enc_frames: torch.Tensor, frame_valid: torch.Tensor,
                carry: BeamCarry, blank_id: int, n_steps: int = 1,
                ctc_logp: torch.Tensor | None = None,
                transducer_weight: float = 0.7, ctc_weight: float = 0.3) -> BeamCarry:
    """Advance the beam over F encoder frames: enc_frames [B, F, D],
    frame_valid [B, F] bool, ctc_logp [B, F, V] fp32 frame CTC log-probs
    (None: no fusion)."""
    b = enc_frames.shape[0]
    # each hypothesis proposes its top-k extensions, k = N
    n = k = carry.logp.shape[1]
    umax = carry.tokens.shape[2]
    st_axis = predictor_state_axis(model)
    dev = enc_frames.device
    enc_proj = model.joint.project_enc(enc_frames)
    log_tw, log_cw = _log_weight(transducer_weight), _log_weight(ctc_weight)
    # candidate c of hypothesis c // (1 + k): slot 0 its blank, 1..k its extensions
    cand_from_hyp = torch.arange(n, device=dev).repeat_interleave(1 + k)
    cand_is_blank = torch.arange(1 + k, device=dev).repeat(n) == 0
    cand_done = cand_is_blank.expand(b, -1)

    def expand_once(c: BeamCarry, done: torch.Tensor, enc_p_t, ctc_t):
        """One sub-step: `done` hypotheses pass through; the others propose
        blank (-> done) and their top-k extensions."""
        last = _last_token(c.tokens, c.lens, blank_id)
        pred_out, flat_state = model.predict_step(
            last.reshape(b * n), merge_beam_axis(c.pred_state, st_axis))
        adv_state = split_beam_axis(flat_state, b, n, st_axis)
        logits = model.joint.head_from_projected(
            enc_p_t[:, None, :] + model.joint.project_pred(pred_out.reshape(b, n, -1)))
        lp = torch.log_softmax(logits.float(), dim=-1)  # [B, N, V]
        if ctc_t is not None:
            lp = torch.logaddexp(log_tw + lp, log_cw + ctc_t[:, None, :])
        blank_logp = c.logp + torch.where(done, 0.0, lp[..., blank_id])
        lp_nb = lp.clone()
        lp_nb[..., blank_id] = _NEG
        top_lp, top_tok = top_k(lp_nb, k)  # [B, N, k]
        can_extend = (c.lens < umax) & ~done
        ext_logp = torch.where(can_extend[..., None], c.logp[..., None] + top_lp, _NEG)

        cand_tokens = torch.cat([c.tokens[:, :, None], _extend(c.tokens, c.lens, top_tok)],
                                dim=2).reshape(b, n * (1 + k), umax)
        cand_lens = torch.cat([c.lens[:, :, None], (c.lens + 1)[:, :, None].expand(-1, -1, k)],
                              dim=2).reshape(b, n * (1 + k))
        cand_logp = torch.cat([blank_logp[:, :, None], ext_logp], dim=2).reshape(b, n * (1 + k))
        cand_hash = torch.cat([c.seq_hash[:, :, None], _extend_hash(c.seq_hash[:, :, None],
                                                                     top_tok)],
                              dim=2).reshape(b, n * (1 + k), 2)
        # the done flag is in the key: a prefix at another frame phase never merges
        merged = _merge_duplicates(cand_hash, cand_lens * 2 + cand_done.long(), cand_logp)
        new_logp, sel = top_k(merged, n)  # [B, N]

        sel_blank = cand_is_blank[sel]
        sel_hyp = cand_from_hyp[sel]
        new_state = where_beam(sel_blank, gather_beam(c.pred_state, sel_hyp, st_axis),
                               gather_beam(adv_state, sel_hyp, st_axis), st_axis)
        out = BeamCarry(
            tokens=torch.gather(cand_tokens, 1, sel[..., None].expand(-1, -1, umax)),
            lens=torch.gather(cand_lens, 1, sel), logp=new_logp, pred_state=new_state,
            seq_hash=torch.gather(cand_hash, 1, sel[..., None].expand(-1, -1, 2)))
        return out, sel_blank

    covered = frame_valid.any(0).tolist()  # one sync: frames some stream covers
    for t in range(enc_frames.shape[1]):
        if not covered[t]:
            continue
        enc_p_t, active = enc_proj[:, t], frame_valid[:, t]
        ctc_t = None if ctc_logp is None else ctc_logp[:, t]
        done = torch.zeros((b, n), dtype=torch.bool, device=dev)
        new, done = expand_once(carry, done, enc_p_t, ctc_t)
        for _ in range(n_steps - 1):
            if bool(done.all()):
                break
            new, done = expand_once(new, done, enc_p_t, ctc_t)
        # streams whose frame this is not keep their carry
        keep = active[:, None]
        carry = BeamCarry(
            tokens=torch.where(keep[..., None], new.tokens, carry.tokens),
            lens=torch.where(keep, new.lens, carry.lens),
            logp=torch.where(keep, new.logp, carry.logp),
            pred_state=where_beam(keep.expand(b, n), new.pred_state, carry.pred_state,
                                  st_axis),
            seq_hash=torch.where(keep[..., None], new.seq_hash, carry.seq_hash))
    return carry


@torch.no_grad()
def rnnt_beam_decode(model, enc_out: torch.Tensor, enc_lens: torch.Tensor, blank_id: int,
                     beam_size: int = 4, max_tokens: int = 200, n_steps: int = 1,
                     ctc_weight: float = 0.0, transducer_weight: float = 0.7):
    """Offline beam search: enc_out [B, T, D], enc_lens [B] -> (best tokens
    [B, max_tokens], best lens [B], n-best tokens [B, N, max_tokens], n-best
    lens [B, N], n-best logp [B, N]). `ctc_weight > 0` fuses the model's CTC
    head into every frame."""
    b, t, _ = enc_out.shape
    carry = init_beam_carry(model, b, beam_size, max_tokens)
    valid = torch.arange(t, device=enc_out.device)[None, :] < enc_lens.to(enc_out.device)[:, None]
    ctc_logp = None
    if ctc_weight > 0:
        ctc_logp = torch.log_softmax(model.ctc_logits(enc_out).float(), dim=-1)
    carry = beam_frames(model, enc_out, valid, carry, blank_id, n_steps=n_steps,
                        ctc_logp=ctc_logp, transducer_weight=transducer_weight,
                        ctc_weight=ctc_weight)
    return (*take_best(carry.logp, carry.tokens, carry.lens), carry.tokens, carry.lens,
            carry.logp)
