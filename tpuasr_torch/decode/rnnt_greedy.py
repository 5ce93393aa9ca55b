"""Batched frame-synchronous RNN-T greedy search (port of
``tpuasr/decode/rnnt_greedy.py:30-133``).

Per frame, each stream emits up to `n_steps` non-blank tokens; the
predictor state advances only on emission; a frame ends for a stream at its
first blank. A stream whose hypothesis is full (`max_tokens`) stops
emitting; writes of non-emitting streams go to a trash slot at index
`max_tokens`.

The JAX package runs a `lax.while_loop` inside a `lax.scan`. Here the frame
loop is a host loop and the emission loop stops as soon as no stream emits,
which the host learns by reading one flag per emission step (one device
sync each). A fixed `n_steps` of masked iterations would need no sync but
does `n_steps` times the predictor work; both give identical tokens. CUDA
graphs of the step are later work.

`GreedyCarry` is the decode state, so the same core drives offline decode
(one call over a whole utterance) and chunk streaming (carried across
`process_chunk` calls).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpuasr_torch.decode.state_utils import predictor_state_axis, where_state


@dataclass
class GreedyCarry:
    """Greedy-decoder state for B parallel streams."""

    pred_state: tuple  # ([L, B, H], [L, B, H])
    last_token: torch.Tensor  # [B] int64
    hyp: torch.Tensor  # [B, max_tokens + 1] int64 (slot max_tokens = trash)
    hyp_len: torch.Tensor  # [B] int64


def init_greedy_carry(model, batch: int, blank_id: int, max_tokens: int) -> GreedyCarry:
    dev = model.device
    return GreedyCarry(
        pred_state=model.init_predictor_state(batch),
        last_token=torch.full((batch,), blank_id, dtype=torch.long, device=dev),
        hyp=torch.zeros((batch, max_tokens + 1), dtype=torch.long, device=dev),
        hyp_len=torch.zeros((batch,), dtype=torch.long, device=dev),
    )


@torch.no_grad()
def greedy_frames(model, enc_frames: torch.Tensor, frame_valid: torch.Tensor,
                  carry: GreedyCarry, blank_id: int, n_steps: int,
                  pad_id: int = 0) -> GreedyCarry:
    """Advance B streams over F encoder frames: enc_frames [B, F, D],
    frame_valid [B, F] bool (per-stream frame validity)."""
    b = enc_frames.shape[0]
    max_tokens = carry.hyp.shape[1] - 1
    st_axis = predictor_state_axis(model)
    rows = torch.arange(b, device=enc_frames.device)
    enc_proj = model.joint.project_enc(enc_frames)  # [B, F, Dj]
    pred_state, last_token = carry.pred_state, carry.last_token
    hyp, hyp_len = carry.hyp.clone(), carry.hyp_len

    for t in range(enc_frames.shape[1]):
        enc_p_t, active = enc_proj[:, t], frame_valid[:, t]
        emitting = active
        for _ in range(n_steps):
            if not bool(emitting.any()):
                break
            pred_out, new_state = model.predict_step(last_token, pred_state)
            logits = model.joint.head_from_projected(
                enc_p_t + model.joint.project_pred(pred_out))
            tok = logits.argmax(dim=-1)
            emit = emitting & (tok != blank_id) & active & (hyp_len < max_tokens)
            hyp[rows, torch.where(emit, hyp_len, max_tokens)] = torch.where(emit, tok, pad_id)
            pred_state = where_state(emit, new_state, pred_state, st_axis)
            last_token = torch.where(emit, tok, last_token)
            hyp_len = hyp_len + emit.long()
            emitting = emit
    return GreedyCarry(pred_state=pred_state, last_token=last_token, hyp=hyp,
                       hyp_len=hyp_len)


@torch.no_grad()
def rnnt_greedy_decode(model, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                       blank_id: int, n_steps: int = 10, max_tokens: int = 200,
                       pad_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline greedy: enc_out [B, T, D], enc_lens [B] ->
    (tokens [B, max_tokens], token_lens [B])."""
    b, t, _ = enc_out.shape
    carry = init_greedy_carry(model, b, blank_id, max_tokens)
    valid = torch.arange(t, device=enc_out.device)[None, :] < enc_lens.to(enc_out.device)[:, None]
    carry = greedy_frames(model, enc_out, valid, carry, blank_id, n_steps, pad_id)
    return carry.hyp[:, :max_tokens], carry.hyp_len
