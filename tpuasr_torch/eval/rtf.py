"""Real-time factor and first-token delay of streaming decode (port of
``tpuasr/eval/rtf.py``).

`measure_rtf`: wall clock around each chunk's `process_chunk` (greedy) or
`process_chunk_beam` (beam, with the same per-frame emission budget
`n_steps` as greedy), closed by ``torch.cuda.synchronize()`` so the time
includes the device's work, divided by the chunk's audio duration (chunk *
subsampling_rate * hop / sr), with mean/p50/p80/p90/p95/max. The first
`warmup_chunks` run untimed. After each chunk a trivial op on the card
(a 128-float reduction), synced the same way, is timed in the same
window: the dispatch-and-sync probe, so a shift of RTF between runs can be
told apart from a shift of the host's own latency.

A chunk covers chunk * subsampling_rate feature frames of audio whatever
the encoder family; the efficient conformer emits chunk / its
`stream_output_factor` frames for it.

`measure_first_token_delay`: audio seconds consumed before each stream's
first non-blank emission plus the processing time up to that chunk. The
chunk loop (`first_emissions`) runs on any device; the timing functions
refuse a model that is not on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpuasr_torch.config import Config
from tpuasr_torch.decode.rnnt_streaming import (
    init_streaming_beam_state, init_streaming_state, process_chunk, process_chunk_beam,
)
from tpuasr_torch.models.transducer import stream_output_len
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES
from tpuasr_torch.streaming.chunkwise import chunk_windows, num_chunks


@dataclass
class RtfStats:
    rtf_mean: float
    rtf_p50: float
    rtf_p80: float
    rtf_p90: float
    rtf_p95: float
    rtf_max: float
    chunk_audio_seconds: float
    n_chunks: int
    device: str
    # the probe's ms (a trivial op on the card, synced), timed in the same
    # window as the chunks
    probe_p50_ms: float = 0.0
    probe_mean_ms: float = 0.0

    @staticmethod
    def from_times(times, chunk_audio_seconds: float, device: str,
                   probe_times=None) -> "RtfStats":
        r = np.asarray(times) / chunk_audio_seconds
        p = np.asarray(probe_times) * 1e3 if probe_times else np.zeros(1)
        return RtfStats(
            float(r.mean()), float(np.percentile(r, 50)), float(np.percentile(r, 80)),
            float(np.percentile(r, 90)), float(np.percentile(r, 95)), float(r.max()),
            chunk_audio_seconds, len(times), device, float(np.percentile(p, 50)),
            float(p.mean()))


def _chunking(model, feats: torch.Tensor, cfg: Config):
    """-> (chunk windows [n, B, window, F] on the model's device, the audio
    seconds of a chunk)."""
    chunk = cfg.streaming.chunk_size
    sub = SUBSAMPLE_CLASSES[cfg.model.encoder.input_layer]
    n = num_chunks(feats.shape[1], chunk, sub.subsampling_rate, sub.right_context)
    windows = chunk_windows(torch.as_tensor(feats).to(model.device), chunk,
                            sub.subsampling_rate, sub.right_context, n)
    return windows, (chunk * sub.subsampling_rate * cfg.feature.hop_length
                     / cfg.feature.sample_rate)


def _require_card(model, what: str) -> None:
    if model.device.type != "cuda":
        raise RuntimeError(f"{what} times the card; the model is on {model.device}")


@torch.no_grad()
def measure_rtf(model, feats: torch.Tensor, cfg: Config, mode: str = "greedy",
                beam_size: int = 4, n_steps: int = 10, warmup_chunks: int = 2) -> RtfStats:
    """Per-chunk RTF of streaming `mode` ("greedy" or "beam") decode over
    feats [B, T, F]."""
    if mode not in ("greedy", "beam"):
        raise ValueError(mode)
    _require_card(model, "measure_rtf")
    c = cfg.model
    chunk, left = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks
    windows, chunk_audio_seconds = _chunking(model, feats, cfg)
    b = feats.shape[0]
    if mode == "greedy":
        fresh = lambda: init_streaming_state(model, b, chunk, left, c.blank_id)
        step = lambda w, st: process_chunk(model, w, st, c.blank_id, n_steps)
    else:
        fresh = lambda: init_streaming_beam_state(model, b, chunk, left, beam_size)
        step = lambda w, st: process_chunk_beam(model, w, st, c.blank_id, n_steps)
    probe_x = torch.ones(128, device=model.device)
    probe = lambda: (probe_x * probe_x).sum()

    warm = fresh()
    for i in range(min(warmup_chunks, len(windows))):
        warm = step(windows[i], warm)
    probe()
    torch.cuda.synchronize(model.device)

    state, times, probe_times = fresh(), [], []
    for w in windows:
        t0 = time.perf_counter()
        state = step(w, state)
        torch.cuda.synchronize(model.device)
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        probe()
        torch.cuda.synchronize(model.device)
        probe_times.append(time.perf_counter() - t0)
    return RtfStats.from_times(times, chunk_audio_seconds,
                               torch.cuda.get_device_name(model.device), probe_times)


@torch.no_grad()
def first_emissions(model, feats: torch.Tensor, feat_lens, cfg: Config, n_steps: int = 10,
                    sync=lambda: None):
    """Streaming greedy decode chunk by chunk until every stream has
    emitted -> (first_chunk [B]: the chunk of each stream's first non-blank
    emission, -1 if none; proc_time [B]: the seconds of processing up to
    and including that chunk; the audio seconds of a chunk). One untimed
    chunk runs first; `sync` closes each timed chunk."""
    c = cfg.model
    windows, chunk_audio = _chunking(model, feats, cfg)
    b = feats.shape[0]
    enc_lens = stream_output_len(c.encoder, torch.as_tensor(feat_lens).to(model.device))
    state = init_streaming_state(model, b, cfg.streaming.chunk_size,
                                 cfg.streaming.num_left_chunks, c.blank_id, enc_lens=enc_lens)
    process_chunk(model, windows[0], state, c.blank_id, n_steps)  # warm-up, discarded
    sync()
    first_chunk = np.full(b, -1, np.int64)
    proc_time = np.zeros(b, np.float64)
    elapsed = 0.0
    for i, w in enumerate(windows):
        t0 = time.perf_counter()
        state = process_chunk(model, w, state, c.blank_id, n_steps)
        sync()
        elapsed += time.perf_counter() - t0
        newly = (state.dec.hyp_len.cpu().numpy() > 0) & (first_chunk < 0)
        first_chunk[newly] = i
        proc_time[newly] = elapsed
        if np.all(first_chunk >= 0):
            break
    return first_chunk, proc_time, chunk_audio


def first_token_delay_stats(first_chunk, proc_time, chunk_audio: float) -> dict:
    """The delays of `first_emissions`' streams: (first_chunk + 1) chunks of
    audio plus the processing time, p50 and p90 over the streams that
    emitted."""
    emitted = first_chunk >= 0
    valid = ((first_chunk + 1) * chunk_audio + proc_time)[emitted]
    pct = lambda q: float(np.percentile(valid, q)) if valid.size else float("nan")
    return {"emitted_fraction": float(emitted.mean()), "p50_first_token_delay_s": pct(50),
            "p90_first_token_delay_s": pct(90), "chunk_audio_seconds": chunk_audio}


def measure_first_token_delay(model, feats: torch.Tensor, feat_lens, cfg: Config,
                              n_steps: int = 10) -> dict:
    """First-token delay of streaming greedy decode over feats [B, T, F]
    on the card."""
    _require_card(model, "measure_first_token_delay")
    return first_token_delay_stats(*first_emissions(
        model, feats, feat_lens, cfg, n_steps, sync=lambda: torch.cuda.synchronize(model.device)))
