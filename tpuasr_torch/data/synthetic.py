"""Synthetic corpus for tests and benchmarks (port of
``tpuasr/data/synthetic.py``).

Waveforms whose spectral content encodes the token sequence, so a model can
learn the mapping without a corpus on disk. The same seed gives the JAX
package's corpus bit for bit. Two regimes:

- the clean corpus: each token is a pure-tone segment (or a two-tone chord
  with `chord=True`, every token acoustically unique), plus white noise;
- the hard corpus (`hard=True`): chord tones on a mel-uniform grid, where
  tokens sharing a high band with mel-adjacent low bands are confusable;
  each token instance jitters both tones by N(0, jitter_mel^2) in mel
  space; white noise at `snr_db`; a per-utterance gain jitter; token
  sequences from a fixed first-order Markov chain shared by all splits, a
  language prior a predictor can exploit and greedy CTC cannot.

`write_bznsyp_corpus` writes clean chord speech of given syllable sequences
to disk in the BZNSYP layout, so the corpus path (split, vocabulary, the
trainer's --data_root, the evaluation CLIs) runs without the corpus.
"""

from __future__ import annotations

import os
import wave as wave_mod

import numpy as np

from tpuasr_torch.data.pipeline import Utterance
from tpuasr_torch.text.tokenizer import EOS, SOS

_MEL = 2595.0


def _hz_to_mel(f):
    return _MEL * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / _MEL) - 1.0)


def hard_chord_table(vocab_size: int, sample_rate: int, first_content_id: int = 6) -> np.ndarray:
    """Mel-space (lo, hi) chord centres of every content token, [n, 2].

    Low bands span [200 Hz, 0.19 sr] and high bands [0.21 sr, 0.47 sr], both
    uniform in mel; content token c maps to (lo[c % L], hi[c // L]) with at
    most 7 high bands."""
    n = vocab_size - first_content_id
    h = min(7, max(1, (n + 7) // 8))
    l = int(np.ceil(n / h))
    lo_m = np.linspace(_hz_to_mel(200.0), _hz_to_mel(0.19 * sample_rate), max(l, 2))
    hi_m = np.linspace(_hz_to_mel(0.21 * sample_rate), _hz_to_mel(0.47 * sample_rate),
                       max(h, 2))
    c = np.arange(n)
    return np.stack([lo_m[c % l], hi_m[np.minimum(c // l, h - 1)]], axis=1)


def markov_successors(vocab_size: int, first_content_id: int = 6, k: int = 4,
                      seed: int = 1234) -> np.ndarray:
    """The preferred-successor table [n, k] (content-relative ids), seeded
    apart from the corpus so every split shares one language."""
    n = vocab_size - first_content_id
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=(n, k))


def sample_markov_tokens(rng: np.random.Generator, vocab_size: int, n_tokens: int,
                         first_content_id: int = 6, p_pref: float = 0.8,
                         table: np.ndarray | None = None) -> list[int]:
    if table is None:
        table = markov_successors(vocab_size, first_content_id)
    n = vocab_size - first_content_id
    cur = int(rng.integers(0, n))
    out = [cur]
    for _ in range(n_tokens - 1):
        if rng.random() < p_pref:
            cur = int(table[cur, rng.integers(0, table.shape[1])])
        else:
            cur = int(rng.integers(0, n))
        out.append(cur)
    return [t + first_content_id for t in out]


def synth_utterance(
    rng: np.random.Generator,
    vocab_size: int,
    n_tokens: int,
    sample_rate: int = 16000,
    samples_per_token: int = 1600,
    noise: float = 0.01,
    first_content_id: int = 6,
    chord: bool = False,
) -> tuple[np.ndarray, list[int]]:
    tokens = rng.integers(first_content_id, vocab_size, size=n_tokens).tolist()
    return speak_tokens(rng, tokens, vocab_size, sample_rate, samples_per_token, noise,
                        chord), tokens


def speak_tokens(rng: np.random.Generator, tokens: list[int], vocab_size: int,
                 sample_rate: int = 16000, samples_per_token: int = 1600, noise: float = 0.01,
                 chord: bool = False) -> np.ndarray:
    """`synth_utterance`'s waveform of the given tokens: a segment each,
    then white noise from `rng`."""
    segs = []
    t = np.arange(samples_per_token) / sample_rate
    for tok in tokens:
        if chord:
            # two simultaneous tones: the low band encodes tok % 97, the high
            # band tok // 97, so up to 97*97 tokens are acoustically unique
            lo = 100.0 + (tok % 97) * (0.20 * sample_rate - 200.0) / 97.0
            n_hi = max((vocab_size - 1) // 97, 1)
            hi = 0.24 * sample_rate + (tok // 97) * (0.20 * sample_rate) / n_hi
            seg = 0.5 * (np.sin(2 * np.pi * lo * t) + np.sin(2 * np.pi * hi * t))
        else:
            # the token's frequency band, well inside [100, 0.45*sr]
            f = 100.0 + (tok % 97) * (0.45 * sample_rate - 200.0) / 97.0
            seg = np.sin(2 * np.pi * f * t)
        segs.append(seg.astype(np.float32))
    wave = np.concatenate(segs) if segs else np.zeros(samples_per_token, np.float32)
    wave = wave + noise * rng.standard_normal(len(wave)).astype(np.float32)
    return wave.astype(np.float32)


def synth_utterance_hard(
    rng: np.random.Generator,
    vocab_size: int,
    n_tokens: int,
    sample_rate: int,
    samples_per_token: int,
    *,
    chord_table: np.ndarray,
    markov_table: np.ndarray | None,
    snr_db: float = 10.0,
    jitter_mel: float = 12.0,
    gain_jitter_db: float = 6.0,
    p_pref: float = 0.8,
    first_content_id: int = 6,
) -> tuple[np.ndarray, list[int]]:
    """One hard-corpus utterance (the protocol is the module docstring's)."""
    if markov_table is not None:
        tokens = sample_markov_tokens(rng, vocab_size, n_tokens, first_content_id, p_pref,
                                      markov_table)
    else:
        tokens = rng.integers(first_content_id, vocab_size, size=n_tokens).tolist()
    t = np.arange(samples_per_token) / sample_rate
    segs = []
    for tok in tokens:
        m = chord_table[tok - first_content_id] + rng.normal(0.0, jitter_mel, 2)
        lo, hi = _mel_to_hz(m)
        seg = 0.5 * (np.sin(2 * np.pi * lo * t) + np.sin(2 * np.pi * hi * t))
        segs.append(seg.astype(np.float32))
    sig = np.concatenate(segs) if segs else np.zeros(samples_per_token, np.float32)
    noise_std = float(np.sqrt(np.mean(sig.astype(np.float64) ** 2) / 10.0 ** (snr_db / 10.0)))
    wave = sig + noise_std * rng.standard_normal(len(sig)).astype(np.float32)
    # absolute level carries no information: normalise, then attenuate by a
    # random gain (applied to signal and noise, so the SNR stays)
    peak = float(np.max(np.abs(wave))) or 1.0
    gain_db = -3.0 - float(rng.uniform(0.0, gain_jitter_db))
    return (wave / peak * 10.0 ** (gain_db / 20.0)).astype(np.float32), tokens


def synth_corpus(
    n_utts: int,
    vocab_size: int,
    seed: int = 0,
    min_tokens: int = 3,
    max_tokens: int = 10,
    sample_rate: int = 16000,
    samples_per_token: int = 1600,
    add_sos_eos: bool = True,
    chord: bool = False,
    hard: bool = False,
    snr_db: float = 10.0,
    jitter_mel: float = 12.0,
    gain_jitter_db: float = 6.0,
    markov: bool = True,
) -> list[Utterance]:
    """n_utts utterances of min_tokens..max_tokens content tokens each;
    with add_sos_eos the token lists gain SOS and EOS around them."""
    rng = np.random.default_rng(seed)
    if hard:
        chord_table = hard_chord_table(vocab_size, sample_rate)
        markov_table = markov_successors(vocab_size) if markov else None
    utts = []
    for i in range(n_utts):
        n_tok = int(rng.integers(min_tokens, max_tokens + 1))
        if hard:
            wave, tokens = synth_utterance_hard(
                rng, vocab_size, n_tok, sample_rate, samples_per_token,
                chord_table=chord_table, markov_table=markov_table, snr_db=snr_db,
                jitter_mel=jitter_mel, gain_jitter_db=gain_jitter_db)
        else:
            wave, tokens = synth_utterance(rng, vocab_size, n_tok, sample_rate,
                                           samples_per_token, chord=chord)
        if add_sos_eos:
            tokens = [SOS] + tokens + [EOS]
        utts.append(Utterance.from_arrays(f"synth{i:06d}", wave, tokens))
    return utts


def write_bznsyp_corpus(root: str, transcripts: list[list[str]], sample_rate: int,
                        samples_per_token: int, seed: int = 0, tail_s: float = 0.25,
                        transcript: str = "ProsodyLabeling/000001-010000.txt") -> str:
    """A BZNSYP-layout corpus of synthetic speech under `root`; -> the
    transcript's path. Utterance i gets the id ``f"{i + 1:06d}"``, a line of
    placeholder hanzi and a line of its toned pinyin (`transcripts[i]`, the
    toneless syllables, each with a tone 1-4 drawn from `seed`) in the
    ProsodyLabeling transcript, and ``Wave/{id}.wav``: 16-bit PCM mono at
    `sample_rate`, the syllables spoken by the chord encoding of their ids in
    the vocabulary gen_vocab builds from all of them (sorted, after the six
    specials; `speak_tokens`), at half scale, then `tail_s` seconds of
    silence."""
    vocab = sorted({s for t in transcripts for s in t})
    ids = {s: i + 6 for i, s in enumerate(vocab)}
    rng = np.random.default_rng(seed)
    lines = []
    os.makedirs(os.path.join(root, "Wave"), exist_ok=True)
    for i, syls in enumerate(transcripts):
        utt = f"{i + 1:06d}"
        tones = rng.integers(1, 5, size=len(syls))
        lines += [f"{utt}\t{'合成' * len(syls)}#4。",
                  "\t" + " ".join(f"{s}{k}" for s, k in zip(syls, tones))]
        x = 0.5 * speak_tokens(rng, [ids[s] for s in syls], len(vocab) + 6, sample_rate,
                               samples_per_token, chord=True)
        x = np.concatenate([x, np.zeros(int(tail_s * sample_rate), np.float32)])
        pcm = np.clip(np.rint(x * 32768.0), -32768, 32767).astype("<i2")
        with wave_mod.open(os.path.join(root, "Wave", f"{utt}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())
    path = os.path.join(root, transcript)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path
