"""Real-time factor of streaming greedy decode (port of
``tpuasr/eval/rtf.py:35-128``, greedy mode).

Wall clock around each chunk's `process_chunk`, closed by
``torch.cuda.synchronize()`` so the time includes the device's work, divided
by the chunk's audio duration (chunk * subsampling_rate * hop / sr), with
mean/p50/p80/p90/p95/max. The first `warmup_chunks` run untimed. This is a
device measurement: it refuses a model that is not on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpuasr_torch.config import Config
from tpuasr_torch.decode.rnnt_streaming import init_streaming_state, process_chunk
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

    @staticmethod
    def from_times(times, chunk_audio_seconds: float, device: str) -> "RtfStats":
        r = np.asarray(times) / chunk_audio_seconds
        return RtfStats(
            float(r.mean()), float(np.percentile(r, 50)), float(np.percentile(r, 80)),
            float(np.percentile(r, 90)), float(np.percentile(r, 95)), float(r.max()),
            chunk_audio_seconds, len(times), device)


@torch.no_grad()
def measure_rtf(model, feats: torch.Tensor, cfg: Config, mode: str = "greedy",
                n_steps: int = 10, warmup_chunks: int = 2) -> RtfStats:
    """Per-chunk RTF of streaming `mode` decode over feats [B, T, F]."""
    if mode == "beam":
        raise NotImplementedError("beam streaming is not ported yet (ROADMAP: beam search)")
    if mode != "greedy":
        raise ValueError(mode)
    if model.device.type != "cuda":
        raise RuntimeError("measure_rtf times the card; the model is on "
                           f"{model.device}")
    c = cfg.model
    chunk, left = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks
    sub = SUBSAMPLE_CLASSES[c.encoder.input_layer]
    b, t, _ = feats.shape
    n = num_chunks(t, chunk, sub.subsampling_rate, sub.right_context)
    windows = chunk_windows(feats.to(model.device), chunk, sub.subsampling_rate,
                            sub.right_context, n)
    chunk_audio_seconds = (chunk * sub.subsampling_rate * cfg.feature.hop_length
                           / cfg.feature.sample_rate)

    def fresh():
        return init_streaming_state(model, b, chunk, left, c.blank_id)

    warm = fresh()
    for i in range(min(warmup_chunks, n)):
        warm = process_chunk(model, windows[i], warm, c.blank_id, n_steps)
    torch.cuda.synchronize(model.device)

    state, times = fresh(), []
    for i in range(n):
        t0 = time.perf_counter()
        state = process_chunk(model, windows[i], state, c.blank_id, n_steps)
        torch.cuda.synchronize(model.device)
        times.append(time.perf_counter() - t0)
    return RtfStats.from_times(times, chunk_audio_seconds,
                               torch.cuda.get_device_name(model.device))
