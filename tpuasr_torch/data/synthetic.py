"""Synthetic corpus for tests and benchmarks (port of
``tpuasr/data/synthetic.py``: `synth_utterance`, `synth_corpus`).

Waveforms whose spectral content encodes the token sequence: each token is
a pure-tone segment (or a two-tone chord with `chord=True`), plus white
noise. The same seed gives the JAX package's corpus bit for bit. The hard
corpus (`hard=True`: mel-grid chords, jitter, SNR, a Markov token chain) is
not ported yet and raises.
"""

from __future__ import annotations

import numpy as np

from tpuasr_torch.data.pipeline import Utterance
from tpuasr_torch.text.tokenizer import EOS, SOS


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
    return wave.astype(np.float32), tokens


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
) -> list[Utterance]:
    """n_utts utterances of min_tokens..max_tokens content tokens each;
    with add_sos_eos the token lists gain SOS and EOS around them."""
    if hard:
        raise NotImplementedError("synth_corpus(hard=True): the hard corpus is not ported "
                                  "yet (ROADMAP: the data pipeline)")
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(n_utts):
        n_tok = int(rng.integers(min_tokens, max_tokens + 1))
        wave, tokens = synth_utterance(rng, vocab_size, n_tok, sample_rate, samples_per_token,
                                       chord=chord)
        if add_sos_eos:
            tokens = [SOS] + tokens + [EOS]
        utts.append(Utterance.from_arrays(f"synth{i:06d}", wave, tokens))
    return utts
