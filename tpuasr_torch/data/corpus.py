"""Corpus -> pipeline assembly (port of ``tpuasr/data/corpus.py``:
`make_pipeline`, `synthetic_pipeline`).

The synthetic stand-in corpus is built in memory and, for the int16 wire
format, encoded once at build time. Utterance metadata read from disk
(`scan_split` and the BZNSYP wav/text readers) waits for the tokenizer
(ROADMAP §1 item 4): `make_pipeline` takes in-memory `Utterance`s only and
raises NotImplementedError for anything else.
"""

from __future__ import annotations

from tpuasr_torch.config import Config
from tpuasr_torch.data.pipeline import LengthBucketPipeline, Utterance, wire_waves
from tpuasr_torch.data.synthetic import synth_corpus

CORPUS_TODO = ("the BZNSYP corpus readers (scan_split, wav/text readers) are not ported "
               "yet: ROADMAP §1 item 4 (tokenizer, eval and CLIs)")


def _load(item) -> Utterance:
    if isinstance(item, Utterance):
        return item
    raise NotImplementedError(CORPUS_TODO)


def make_pipeline(items, cfg: Config) -> LengthBucketPipeline:
    """In-memory `Utterance`s -> the length-bucketed pipeline of cfg.data."""
    d = cfg.data
    return LengthBucketPipeline(
        items,
        batch_size=d.batch_size,
        frame_buckets=d.frame_buckets,
        token_buckets=d.token_buckets,
        hop_length=cfg.feature.hop_length,
        pad_id=0,
        seed=d.shuffle_seed,
        loader=_load,
        batch_audio_frames=d.batch_audio_frames,
        batch_multiple=d.batch_multiple,
    )


def synthetic_pipeline(cfg: Config, n_utts: int = 64, seed: int = 0) -> LengthBucketPipeline:
    """The synthetic corpus (knobs: cfg.data.synth_*) as a pipeline."""
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
    return make_pipeline(utts, cfg)
