"""Plain log-mel fbank: periodic hamming window, centre reflect padding, a
real DFT as two products against a cos / sin basis (float64 tables cast to
float32), power 2, HTK mel filters without normalisation, then
10 * log10(max(x, amin)). The published front end of the configurations
(torchaudio's MelSpectrogram + AmplitudeToDB); written from that
description, with no code of the program."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision


def _hamming(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * math.pi * k / n)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filters(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """[n_freqs, n_mels] triangular HTK filters over 0 .. sr/2."""
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    diff = pts[1:] - pts[:-1]
    slope = pts[None, :] - freqs[:, None]
    down = -slope[:, :-2] / diff[:-1]
    up = slope[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def tables(feat: dict, device) -> dict:
    """The window, the DFT basis and the filters of `feat` as fp32 tensors."""
    n, sr = feat["n_fft"], feat["sample_rate"]
    k = np.arange(n, dtype=np.float64)[:, None]
    f = np.arange(n // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * k * f / n
    mats = {"window": _hamming(n), "cos": np.cos(ang), "sin": -np.sin(ang),
            "mel": mel_filters(n // 2 + 1, feat["n_mels"], sr)}
    return {key: torch.from_numpy(v.astype(np.float32)).to(device) for key, v in mats.items()}


def logmel(waves: torch.Tensor, feat: dict, prec: Precision, rows: int = 64) -> torch.Tensor:
    """[B, N] fp32 waves -> [B, 1 + N // hop, n_mels], in blocks of `rows`
    waves."""
    tab = tables(feat, waves.device)
    n, hop = feat["n_fft"], feat["hop_length"]
    out = []
    for i in range(0, waves.shape[0], rows):
        x = F.pad(waves[i:i + rows, None].float(), (n // 2, n // 2), mode="reflect")[:, 0]
        frames = x.unfold(-1, n, hop) * tab["window"]
        re = prec.matmul(frames, tab["cos"])
        im = prec.matmul(frames, tab["sin"])
        mel = prec.matmul(re * re + im * im, tab["mel"])
        out.append(10.0 * torch.log10(torch.clamp(mel, min=feat.get("amin", 1e-10))))
    return torch.cat(out)
