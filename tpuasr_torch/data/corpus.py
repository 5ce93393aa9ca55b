"""Corpus -> pipeline assembly (port of ``tpuasr/data/corpus.py``).

Bridges the BZNSYP readers (`tpuasr_torch.data.bznsyp`) to the static-shape
`LengthBucketPipeline`: `scan_split` reads each utterance's metadata once
(path, token ids, wave length from the WAV header); waveforms are decoded
when the pipeline loads the utterance, every epoch: on the float32 wire by
the native host runtime (`tpuasr_torch.utils.native.wav_read`: PCM
8/16/24/32-bit and IEEE float32), on the int16 wire by `read_wav` (16-bit
PCM passed through raw). The
synthetic stand-in corpus is built in memory and, for the int16 wire
format, encoded once at build time. `make_pipeline` takes either kind of
item.
"""

from __future__ import annotations

import wave as wave_mod
from dataclasses import dataclass

import numpy as np

from tpuasr_torch.config import Config
from tpuasr_torch.data.bznsyp import read_scp, read_text, read_wav
from tpuasr_torch.data.pipeline import LengthBucketPipeline, Utterance, wire_waves
from tpuasr_torch.data.synthetic import synth_corpus
from tpuasr_torch.text.tokenizer import Tokenizer
from tpuasr_torch.utils import native


@dataclass
class UtteranceMeta:
    utt_id: str
    path: str
    tokens: np.ndarray
    wave_len: int


def _wav_frames(path: str) -> int:
    with wave_mod.open(path, "rb") as w:
        return w.getnframes()


def scan_split(wav_scp: str, text_file: str, tokenizer: Tokenizer, root: str = "",
               add_sos_eos: bool = True) -> list[UtteranceMeta]:
    """Metadata of one split, in wav.scp's order (utterances without a
    transcript are left out). Text becomes
    tokenizer(["<sos>"] + syllables + ["<eos>"])."""
    wavs = read_scp(wav_scp, root)
    texts = read_text(text_file)
    items = []
    for utt, path in wavs.items():
        if utt not in texts:
            continue
        toks = texts[utt]
        if add_sos_eos:
            toks = ["<sos>"] + toks + ["<eos>"]
        items.append(UtteranceMeta(utt, path, np.asarray(tokenizer(toks), np.int32),
                                   _wav_frames(path)))
    return items


def _load(item, wire_dtype: str = "float32") -> Utterance:
    """An `Utterance` as it is, or a `UtteranceMeta`'s WAV decoded: float32
    in [-1, 1] by the native reader (at most its header's length), or for
    the int16 wire its raw 16-bit samples."""
    if isinstance(item, Utterance):
        return item
    if wire_dtype == "int16":
        wave, _ = read_wav(item.path, dtype="int16")
    else:
        wave, _ = native.wav_read(item.path, max_samples=item.wave_len)
    return Utterance(item.utt_id, wave, item.tokens, len(wave))


def make_pipeline(items, cfg: Config, host_id: int = 0,
                  num_hosts: int = 1) -> LengthBucketPipeline:
    """`Utterance`s or `UtteranceMeta`s -> the length-bucketed pipeline of
    cfg.data over shard `host_id` of `num_hosts` (the items with index %
    num_hosts == host_id: a data rank's rows)."""
    d = cfg.data
    return LengthBucketPipeline(
        items,
        batch_size=d.batch_size,
        frame_buckets=d.frame_buckets,
        token_buckets=d.token_buckets,
        hop_length=cfg.feature.hop_length,
        pad_id=0,
        seed=d.shuffle_seed,
        host_id=host_id,
        num_hosts=num_hosts,
        loader=lambda item: _load(item, d.wire_dtype),
        batch_audio_frames=d.batch_audio_frames,
        batch_multiple=d.batch_multiple,
    )


def synthetic_pipeline(cfg: Config, n_utts: int = 64, seed: int = 0, host_id: int = 0,
                       num_hosts: int = 1) -> LengthBucketPipeline:
    """The synthetic corpus (knobs: cfg.data.synth_*) as a pipeline over
    shard `host_id` of `num_hosts` (`make_pipeline`)."""
    d = cfg.data
    utts = synth_corpus(
        n_utts, cfg.model.vocab_size, seed=seed,
        min_tokens=d.synth_min_tokens, max_tokens=d.synth_max_tokens,
        sample_rate=cfg.feature.sample_rate,
        samples_per_token=d.synth_frames_per_token * cfg.feature.hop_length,
        chord=d.synth_chord, hard=d.synth_hard, snr_db=d.synth_snr_db,
        jitter_mel=d.synth_jitter_mel, gain_jitter_db=d.synth_gain_jitter_db,
        markov=d.synth_markov,
    )
    if d.wire_dtype == "int16":
        # encoded once here, never per step on the prefetch thread
        utts = [Utterance(u.utt_id, wire_waves(u.wave, "int16"), u.tokens, u.wave_len)
                for u in utts]
    return make_pipeline(utts, cfg, host_id, num_hosts)
