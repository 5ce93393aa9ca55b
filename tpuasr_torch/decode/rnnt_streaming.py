"""Streaming RNN-T decode: chunked encoder + carried decoder state (port of
``tpuasr/decode/rnnt_streaming.py``).

`StreamingState` holds the encoder caches, the greedy carry and each
stream's encoder length; `process_chunk` encodes one chunk window and
greedily decodes its frames, so B streams advance in lockstep.
`StreamingBeamState` / `process_chunk_beam` do the same with the beam
carry of `decode.rnnt_beam` (per-hypothesis predictor states), with the
chunk's CTC log-probs fused into every frame when `ctc_weight > 0`.
`streaming_greedy_decode` and `streaming_beam_decode` run a whole
utterance chunk by chunk.

The encoder state's offset counts full-rate encoder frames (a 0-d tensor
on the device for the conformer, an int for the families); a chunk's
output frames are indexed `offset // stream_output_factor + j` (the
efficient conformer's strides leave chunk / factor output frames a chunk,
tpuasr/decode/rnnt_streaming.py:68-76), and each stream's decode is gated
at its `stream_output_len`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpuasr_torch.decode.rnnt_beam import BeamCarry, beam_frames, init_beam_carry, take_best
from tpuasr_torch.decode.rnnt_greedy import GreedyCarry, greedy_frames, init_greedy_carry
from tpuasr_torch.models.transducer import stream_output_factor, stream_output_len
from tpuasr_torch.nn.conformer import EncoderStreamState
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES
from tpuasr_torch.streaming.chunkwise import chunk_windows, num_chunks
from tpuasr_torch.streaming.family_cache import FamilyStreamState

_INT32_MAX = 2**31 - 1


@dataclass
class StreamingState:
    enc: EncoderStreamState | FamilyStreamState
    dec: GreedyCarry
    enc_lens: torch.Tensor  # [B] valid encoder frames per stream (decode gate)


def _enc_lens(model, batch: int, enc_lens) -> torch.Tensor:
    if enc_lens is None:
        return torch.full((batch,), _INT32_MAX, dtype=torch.long, device=model.device)
    return torch.as_tensor(enc_lens).to(model.device, torch.long)


def init_streaming_state(model, batch: int, chunk_size: int, num_left_chunks: int,
                         blank_id: int, max_tokens: int = 200, enc_lens=None
                         ) -> StreamingState:
    """Fresh streaming state (reset_streaming_cache parity)."""
    return StreamingState(enc=model.init_encoder_state(batch, chunk_size, num_left_chunks),
                          dec=init_greedy_carry(model, batch, blank_id, max_tokens),
                          enc_lens=_enc_lens(model, batch, enc_lens))


def _chunk_frames(model, chunk_feats: torch.Tensor, enc, enc_lens: torch.Tensor):
    """Encode one chunk window -> (output frames [B, chunk / f, D], their
    validity [B, chunk / f], the new encoder state); f is the encoder's
    `stream_output_factor` and the state's offset counts full-rate frames."""
    ys, enc_state = model.encode_chunk(chunk_feats, enc)
    first = enc.offset // stream_output_factor(model.cfg.encoder)
    frame_idx = first + torch.arange(ys.shape[1], device=ys.device)[None, :]
    return ys, frame_idx < enc_lens[:, None], enc_state


@torch.no_grad()
def process_chunk(model, chunk_feats: torch.Tensor, state: StreamingState,
                  blank_id: int, n_steps: int = 10, sync_free: bool = False
                  ) -> StreamingState:
    """Encode one chunk window [B, window, F] and greedily decode its frames;
    `sync_free` as `greedy_frames` (the exported `process_chunk`'s)."""
    ys, valid, enc_state = _chunk_frames(model, chunk_feats, state.enc, state.enc_lens)
    dec = greedy_frames(model, ys, valid, state.dec, blank_id, n_steps, sync_free=sync_free)
    return StreamingState(enc=enc_state, dec=dec, enc_lens=state.enc_lens)


def _windows(model, feats: torch.Tensor, feat_lens, chunk_size: int):
    """-> (chunk windows [n, B, window, F], encoder lengths [B])."""
    cfg = model.cfg.encoder
    sub = SUBSAMPLE_CLASSES[cfg.input_layer]
    n = num_chunks(feats.shape[1], chunk_size, sub.subsampling_rate, sub.right_context)
    enc_lens = stream_output_len(cfg, torch.as_tensor(feat_lens).to(model.device))
    windows = chunk_windows(feats.to(model.device), chunk_size, sub.subsampling_rate,
                            sub.right_context, n)
    return windows, enc_lens


@torch.no_grad()
def streaming_greedy_decode(model, feats: torch.Tensor, feat_lens, chunk_size: int,
                            num_left_chunks: int, blank_id: int, n_steps: int = 10,
                            max_tokens: int = 200):
    """Whole-utterance simulated streaming: feats [B, T, F] ->
    (tokens [B, max_tokens], token_lens [B], final state)."""
    windows, enc_lens = _windows(model, feats, feat_lens, chunk_size)
    state = init_streaming_state(model, feats.shape[0], chunk_size, num_left_chunks,
                                 blank_id, max_tokens, enc_lens)
    for w in windows:
        state = process_chunk(model, w, state, blank_id, n_steps)
    return state.dec.hyp[:, :max_tokens], state.dec.hyp_len, state


# ---------------------------------------------------------------------------
# streaming beam search
# ---------------------------------------------------------------------------


@dataclass
class StreamingBeamState:
    enc: EncoderStreamState | FamilyStreamState
    beam: BeamCarry
    enc_lens: torch.Tensor  # [B]


def init_streaming_beam_state(model, batch: int, chunk_size: int, num_left_chunks: int,
                              beam_size: int, max_tokens: int = 200, enc_lens=None
                              ) -> StreamingBeamState:
    return StreamingBeamState(enc=model.init_encoder_state(batch, chunk_size, num_left_chunks),
                              beam=init_beam_carry(model, batch, beam_size, max_tokens),
                              enc_lens=_enc_lens(model, batch, enc_lens))


@torch.no_grad()
def process_chunk_beam(model, chunk_feats: torch.Tensor, state: StreamingBeamState,
                       blank_id: int, n_steps: int = 1, ctc_weight: float = 0.0,
                       transducer_weight: float = 0.7) -> StreamingBeamState:
    """Encode one chunk window and advance the beam over its frames;
    `ctc_weight > 0` fuses the chunk's CTC log-probs into every frame."""
    ys, valid, enc_state = _chunk_frames(model, chunk_feats, state.enc, state.enc_lens)
    ctc_logp = None
    if ctc_weight > 0:
        ctc_logp = torch.log_softmax(model.ctc_logits(ys).float(), dim=-1)
    beam = beam_frames(model, ys, valid, state.beam, blank_id, n_steps=n_steps,
                       ctc_logp=ctc_logp, transducer_weight=transducer_weight,
                       ctc_weight=ctc_weight)
    return StreamingBeamState(enc=enc_state, beam=beam, enc_lens=state.enc_lens)


@torch.no_grad()
def streaming_beam_decode(model, feats: torch.Tensor, feat_lens, chunk_size: int,
                          num_left_chunks: int, blank_id: int, beam_size: int = 4,
                          max_tokens: int = 200, n_steps: int = 1, ctc_weight: float = 0.0,
                          transducer_weight: float = 0.7):
    """Whole-utterance simulated streaming beam search: feats [B, T, F] ->
    (best tokens [B, max_tokens], best lens [B], final state)."""
    windows, enc_lens = _windows(model, feats, feat_lens, chunk_size)
    state = init_streaming_beam_state(model, feats.shape[0], chunk_size, num_left_chunks,
                                      beam_size, max_tokens, enc_lens)
    for w in windows:
        state = process_chunk_beam(model, w, state, blank_id, n_steps, ctc_weight,
                                   transducer_weight)
    return (*take_best(state.beam.logp, state.beam.tokens, state.beam.lens), state)
