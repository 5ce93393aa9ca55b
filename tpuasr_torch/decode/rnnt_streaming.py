"""Streaming RNN-T greedy decode: chunked encoder + carried decoder state
(port of the greedy half of ``tpuasr/decode/rnnt_streaming.py:27-109``).

`StreamingState` holds the encoder caches, the greedy carry and each
stream's encoder length; `process_chunk` encodes one chunk window and
greedily decodes its frames, so B streams advance in lockstep. The beam
half comes with a later slice (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpuasr_torch.decode.rnnt_greedy import GreedyCarry, greedy_frames, init_greedy_carry
from tpuasr_torch.models.transducer import stream_output_len
from tpuasr_torch.nn.conformer import EncoderStreamState
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES
from tpuasr_torch.streaming.chunkwise import chunk_windows, num_chunks

_INT32_MAX = 2**31 - 1


@dataclass
class StreamingState:
    enc: EncoderStreamState
    dec: GreedyCarry
    enc_lens: torch.Tensor  # [B] valid encoder frames per stream (decode gate)


def init_streaming_state(model, batch: int, chunk_size: int, num_left_chunks: int,
                         blank_id: int, max_tokens: int = 200, enc_lens=None
                         ) -> StreamingState:
    """Fresh streaming state (reset_streaming_cache parity)."""
    enc = model.init_encoder_state(batch, chunk_size, num_left_chunks)
    dec = init_greedy_carry(model, batch, blank_id, max_tokens)
    if enc_lens is None:
        enc_lens = torch.full((batch,), _INT32_MAX, dtype=torch.long, device=model.device)
    return StreamingState(enc=enc, dec=dec,
                          enc_lens=torch.as_tensor(enc_lens).to(model.device, torch.long))


@torch.no_grad()
def process_chunk(model, chunk_feats: torch.Tensor, state: StreamingState,
                  blank_id: int, n_steps: int = 10) -> StreamingState:
    """Encode one chunk window [B, window, F] and greedily decode its frames."""
    ys, enc_state = model.encode_chunk(chunk_feats, state.enc)
    chunk = ys.shape[1]
    frame_idx = state.enc.offset + torch.arange(chunk, device=ys.device)[None, :]
    valid = frame_idx < state.enc_lens[:, None]
    dec = greedy_frames(model, ys, valid, state.dec, blank_id, n_steps)
    return StreamingState(enc=enc_state, dec=dec, enc_lens=state.enc_lens)


@torch.no_grad()
def streaming_greedy_decode(model, feats: torch.Tensor, feat_lens, chunk_size: int,
                            num_left_chunks: int, blank_id: int, n_steps: int = 10,
                            max_tokens: int = 200):
    """Whole-utterance simulated streaming: feats [B, T, F] ->
    (tokens [B, max_tokens], token_lens [B], final state)."""
    cfg = model.cfg.encoder
    sub = SUBSAMPLE_CLASSES[cfg.input_layer]
    b, t, _ = feats.shape
    n = num_chunks(t, chunk_size, sub.subsampling_rate, sub.right_context)
    enc_lens = stream_output_len(cfg, torch.as_tensor(feat_lens).to(model.device))
    windows = chunk_windows(feats.to(model.device), chunk_size, sub.subsampling_rate,
                            sub.right_context, n)
    state = init_streaming_state(model, b, chunk_size, num_left_chunks, blank_id,
                                 max_tokens, enc_lens)
    for i in range(n):
        state = process_chunk(model, windows[i], state, blank_id, n_steps)
    return state.dec.hyp[:, :max_tokens], state.dec.hyp_len, state
