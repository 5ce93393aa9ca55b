"""Length-bucketed, static-shape batches on the host (port of
``tpuasr/data/pipeline.py``).

Every batch is padded to one of a few (wave_samples, tokens) buckets;
feature extraction happens on the device inside the train step, so the host
only loads waveforms. `LengthBucketPipeline` shuffles per epoch from
(seed, epoch) with numpy, so the same seed gives the JAX package's batches
bit for bit; per-host sharding takes the utterances with
``index % num_hosts == host_id``. `tensors` moves a batch's arrays onto a
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

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


class LengthBucketPipeline:
    """Buckets utterances by (wave length, token count) and yields
    static-shape batches in shuffled order (tpuasr/data/pipeline.py:105-182).

    A bucket's batch holds `batch_size` utterances, or with
    `batch_audio_frames` about batch_audio_frames // frames (rounded down to
    `batch_multiple`). An utterance longer than every bucket is skipped and
    counted in `last_skipped`; partial batches are emitted at the end of an
    epoch unless `drop_remainder`."""

    def __init__(
        self,
        utterances: Sequence,
        batch_size: int,
        frame_buckets: Sequence[int],
        token_buckets: Sequence[int],
        hop_length: int = 512,
        pad_id: int = 0,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        loader: Callable[[object], Utterance] | None = None,
        drop_remainder: bool = False,
        batch_audio_frames: int = 0,
        batch_multiple: int = 1,
    ):
        self._loader = loader or (lambda u: u)
        self._items = [u for i, u in enumerate(utterances) if i % num_hosts == host_id]
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.hop = hop_length
        self.batch_audio_frames = batch_audio_frames
        self.batch_multiple = max(1, batch_multiple)
        # bucket bounds in wave samples, so that 1 + n // hop is the frame bucket
        self.wave_buckets = sorted((fb - 1) * hop_length for fb in frame_buckets)
        self.token_buckets = sorted(token_buckets)
        self.last_skipped = 0

    def batch_size_for(self, wave_bucket: int) -> int:
        """Batch size of a bucket padded to `wave_bucket` samples."""
        if not self.batch_audio_frames:
            return self.batch_size
        frames = 1 + wave_bucket // self.hop
        n = max(1, self.batch_audio_frames // frames)
        return max(self.batch_multiple, n // self.batch_multiple * self.batch_multiple)

    def _bucket_of(self, wave_len: int, n_tokens: int) -> tuple[int, int] | None:
        wb = next((w for w in self.wave_buckets if wave_len <= w), None)
        tb = next((t for t in self.token_buckets if n_tokens <= t), None)
        if wb is None or tb is None:
            return None
        return wb, tb

    def _plan(self, epoch: int) -> Iterator[tuple[tuple[int, int], list[int]]]:
        """The epoch's batches as (bucket, item indices), from each item's
        wave length and token count alone (an `UtteranceMeta` holds both, so
        no WAV is read); sets `last_skipped` at the end."""
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self._items))
        pending: dict[tuple[int, int], list] = {}
        skipped = 0
        for idx in order:
            item = self._items[idx]
            key = self._bucket_of(item.wave_len, len(item.tokens))
            if key is None:
                skipped += 1
                continue
            pending.setdefault(key, []).append(idx)
            if len(pending[key]) == self.batch_size_for(key[0]):
                yield key, pending.pop(key)
        if not self.drop_remainder:
            for key, idxs in sorted(pending.items()):
                if idxs:
                    yield key, idxs
        self.last_skipped = skipped

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        for key, idxs in self._plan(epoch):
            yield self._emit([self._loader(self._items[i]) for i in idxs], key)

    def _emit(self, utts: list[Utterance], key: tuple[int, int]) -> dict:
        spec = BatchSpec(self.batch_size_for(key[0]), key[0], key[1])
        return make_batch(utts, spec, self.pad_id)

    def steps_per_epoch(self, epoch: int = 0) -> int:
        """The epoch's batch count, counted from the items' metadata."""
        return sum(1 for _ in self._plan(epoch))
