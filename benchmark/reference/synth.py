"""The benchmark's inputs, made on the device from the seed: a frozen copy of
the synthetic corpus' arithmetic (each token a tone of its own, 0.01 white
noise; the training batch of 24-30 tokens an utterance with SOS and EOS
around them, padded to `tokens` labels and (frames - 1) * hop samples),
generated in bulk by a generator on the card.

Every seed gets the same sizes: the token counts of a training batch, and a
wave's stream durations, are fixed sets that the seed only permutes, so a
seed changes which rows are long and what they say, not how much work a
step or a wave is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SOS, EOS = 2, 3
FIRST_CONTENT = 6


def tone_hz(tok: torch.Tensor, sr: int) -> torch.Tensor:
    """The token's frequency: 100 Hz + (tok % 97) steps across 0.45 sr."""
    return 100.0 + (tok % 97).double() * (0.45 * sr - 200.0) / 97.0


def speak(gen: torch.Generator, tokens: torch.Tensor, n_tokens: torch.Tensor, n_samples: int,
          spt: int, sr: int, noise: float = 0.01) -> torch.Tensor:
    """tokens [B, K] -> [B, n_samples] fp32: a tone of `spt` samples a token
    for the first n_tokens[b] tokens, plus white noise, zero after the last
    token."""
    b = tokens.shape[0]
    dev = tokens.device
    n = torch.arange(n_samples, device=dev)
    k = (n // spt).clamp(max=tokens.shape[1] - 1)
    ph = (n % spt).double() / sr
    out = noise * torch.randn((b, n_samples), generator=gen, device=dev)
    for r in range(0, b, 128):  # [rows, N] in float64 a block at a time
        out[r:r + 128] += torch.sin(2.0 * math.pi * tone_hz(tokens[r:r + 128, k], sr) * ph).float()
    return torch.where(n[None, :] < (n_tokens * spt)[:, None], out, torch.zeros_like(out))


def permuted(gen: torch.Generator, values: np.ndarray, device) -> torch.Tensor:
    v = torch.as_tensor(values, device=device)
    return v[torch.randperm(len(values), generator=gen, device=device)]


def train_batches(gen: torch.Generator, p: dict, vocab: int, sr: int, hop: int) -> list[dict]:
    """`p["batches"]` batches of `p["batch"]` utterances: content-token counts
    spread evenly over [min_tokens, max_tokens] in each batch, permuted;
    tokens drawn from [first_token, vocab) (6 unless given), the labels
    wrapped in SOS and EOS unless `sos_eos` is false (a model that wraps
    them itself)."""
    b, frames, labels = p["batch"], p["frames"], p["tokens"]
    spt = (frames - 6) * hop // p["max_tokens"]
    n_samples = (frames - 1) * hop
    counts = np.array([p["min_tokens"] + i % (p["max_tokens"] - p["min_tokens"] + 1)
                       for i in range(b)], np.int64)
    dev = gen.device
    out = []
    for _ in range(p["batches"]):
        n_tok = permuted(gen, counts, dev)
        toks = torch.randint(p.get("first_token", FIRST_CONTENT), vocab, (b, p["max_tokens"]),
                             generator=gen, device=dev)
        waves = speak(gen, toks, n_tok, n_samples, spt, sr)
        texts = torch.zeros((b, labels), dtype=torch.int32, device=dev)
        pos = torch.arange(labels, device=dev)[None, :]
        wrap = int(p.get("sos_eos", True))
        body = torch.gather(toks, 1, (pos - wrap).clamp(0, p["max_tokens"] - 1).expand(b, -1)).int()
        if wrap:
            texts = torch.where(pos == 0, SOS, torch.where(
                pos <= n_tok[:, None], body, torch.where(pos == n_tok[:, None] + 1, EOS, texts)))
        else:
            texts = torch.where(pos < n_tok[:, None], body, texts)
        out.append({"waves": waves, "wave_lens": (n_tok * spt).int(), "texts": texts.int(),
                    "text_lens": (n_tok + 2 * wrap).int()})
    return out


def stream_durations(p: dict) -> np.ndarray:
    """A wave's durations in seconds: the quantiles (i + 0.5) / n of a
    log-normal truncated to [min_s, max_s] whose truncated mean is mean_s,
    with `sigma`; the longest set to max_s, so every wave takes as many chunk
    calls."""
    n, lo, hi, sigma = p["streams"], p["min_s"], p["max_s"], p["sigma"]
    q = (np.arange(n) + 0.5) / n

    def draw(mu):
        from statistics import NormalDist

        nd = NormalDist()
        a = nd.cdf((math.log(lo) - mu) / sigma)
        b = nd.cdf((math.log(hi) - mu) / sigma)
        return np.exp(mu + sigma * np.array([nd.inv_cdf(a + (b - a) * x) for x in q]))

    m0, m1 = math.log(lo), math.log(hi)
    for _ in range(60):  # the truncated mean rises with mu
        mid = 0.5 * (m0 + m1)
        m0, m1 = (mid, m1) if draw(mid).mean() < p["mean_s"] else (m0, mid)
    d = draw(0.5 * (m0 + m1))
    d[np.argmax(d)] = hi
    return d


def stream_waves(gen: torch.Generator, p: dict, vocab: int, sr: int) -> dict:
    """`p["waves"]` waves of `p["streams"]` streams as one pool:
    {"waves" [W, S, N], "lens" [W, S] samples}; each wave the durations of
    `stream_durations`, permuted, spoken at `p["token_s"]` seconds a token."""
    d = stream_durations(p)
    n_max = int(round(p["max_s"] * sr))
    spt = int(round(p["token_s"] * sr))
    k = -(-n_max // spt)
    dev = gen.device
    lens = np.minimum(np.round(d * sr).astype(np.int64), n_max)
    waves, out_lens = [], []
    for _ in range(p["waves"]):
        ln = permuted(gen, lens, dev)
        toks = torch.randint(FIRST_CONTENT, vocab, (p["streams"], k), generator=gen, device=dev)
        w = speak(gen, toks, torch.full_like(ln, k), n_max, spt, sr)
        n = torch.arange(n_max, device=dev)[None, :]
        waves.append(torch.where(n < ln[:, None], w, torch.zeros_like(w)))
        out_lens.append(ln)
    return {"waves": torch.stack(waves), "lens": torch.stack(out_lens)}
