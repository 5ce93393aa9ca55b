"""Static-shape batches on the host (port of ``tpuasr/data/pipeline.py``:
`BatchSpec`, `Utterance`, `wire_waves`, `make_batch`, `device_view`).

Every batch is padded to one (wave_samples, tokens) shape; feature
extraction happens on the device inside the train step, so the host only
loads waveforms. `tensors` moves a batch's arrays onto a device. The
length-bucketing pipeline is not ported yet (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class BatchSpec:
    """Static shape of one bucket: [B, wave_samples] audio + [B, tokens] text."""

    batch_size: int
    wave_samples: int
    tokens: int


def wire_waves(waves: np.ndarray, wire_dtype: str) -> np.ndarray:
    """Encode f32 waves for the host-to-device copy. int16 = round(x * 32768)
    clipped (the PCM convention the fbank decodes on the device)."""
    if wire_dtype == "int16" and waves.dtype != np.int16:
        return np.clip(np.rint(waves * 32768.0), -32768, 32767).astype(np.int16)
    if wire_dtype not in ("float32", "int16"):
        raise ValueError(f"unknown data.wire_dtype: {wire_dtype!r}")
    return waves


@dataclass
class Utterance:
    utt_id: str
    wave: np.ndarray | None  # float32 [N]; None until loaded
    tokens: np.ndarray  # int32 [U]
    wave_len: int

    @staticmethod
    def from_arrays(utt_id: str, wave: np.ndarray, tokens: Sequence[int]) -> "Utterance":
        return Utterance(utt_id, np.asarray(wave, np.float32),
                         np.asarray(tokens, np.int32), len(wave))


def make_batch(utts: list[Utterance], spec: BatchSpec, pad_id: int = 0) -> dict:
    """Zero-pad audio, pad_id-pad text to the spec's shape. The wave buffer
    follows the utterances' dtype (int16 for a corpus encoded for the int16
    wire)."""
    b = spec.batch_size
    wave_dtype = utts[0].wave.dtype if utts else np.float32
    waves = np.zeros((b, spec.wave_samples), wave_dtype)
    wave_lens = np.zeros((b,), np.int32)
    texts = np.full((b, spec.tokens), pad_id, np.int32)
    text_lens = np.zeros((b,), np.int32)
    ids = []
    for i, u in enumerate(utts):
        n = min(u.wave_len, spec.wave_samples)
        w = u.wave[:n]
        # mixed dtypes: convert with the PCM scale, never a raw cast
        if waves.dtype == np.int16 and w.dtype != np.int16:
            w = wire_waves(w, "int16")
        elif waves.dtype != np.int16 and w.dtype == np.int16:
            w = w.astype(waves.dtype) / 32768.0
        waves[i, :n] = w
        wave_lens[i] = n
        t = min(len(u.tokens), spec.tokens)
        texts[i, :t] = u.tokens[:t]
        text_lens[i] = t
        ids.append(u.utt_id)
    ids += [""] * (b - len(utts))
    return {
        "utt_ids": ids,
        "waves": waves,
        "wave_lens": wave_lens,
        "texts": texts,
        "text_lens": text_lens,
        # rows beyond len(utts) are padding only (a partial final batch)
        "num_valid": np.int32(len(utts)),
    }


DEVICE_KEYS = ("waves", "wave_lens", "texts", "text_lens")


def device_view(batch: dict) -> dict:
    """The batch's arrays only (drops utt_ids and host metadata)."""
    return {k: batch[k] for k in DEVICE_KEYS if k in batch}


def tensors(batch: dict, device) -> dict:
    """`device_view(batch)` as tensors on `device`, what `make_train_step`'s
    step takes."""
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for k, x in device_view(batch).items()}
