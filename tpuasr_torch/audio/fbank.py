"""Log-mel fbank feature extraction (port of ``tpuasr/audio/fbank.py``).

Same contract as the reference front-end: n_fft 1024, hop 512, 80 HTK mels,
periodic hamming window, power 2, center reflect padding, no filterbank
norm, then ``10*log10(max(x, 1e-10))``. The DFT is two products against a
cos/sin basis built in float64 and cast to float32, as in the JAX package.
Frames go through `tpuasr_torch.ops.fbank_frames`: the CUDA kernel on the
card, its plain version on the CPU.
"""

from __future__ import annotations

import functools
from dataclasses import astuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuasr_torch.config import FeatureConfig
from tpuasr_torch.device import resolve_device
from tpuasr_torch.ops.fbank import fbank_frames


def hamming_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic hamming window (torch.hamming_window default)."""
    k = np.arange(n, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * k / n)
    return w.astype(dtype)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: float | None = None, dtype=np.float32) -> np.ndarray:
    """[n_freqs, n_mels] triangular HTK-mel filterbank, no normalization."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(dtype)


def dft_matrices(n_fft: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis as two [n_fft, n_fft//2+1] product operands."""
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int, center: bool) -> torch.Tensor:
    """[..., N] waveform -> [..., T, n_fft] frames (reflect-padded if center),
    a strided view of the (padded) signal."""
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    return x.unfold(-1, n_fft, hop_length)


@functools.lru_cache(maxsize=8)
def _operands(key: tuple, device: str) -> tuple[torch.Tensor, ...]:
    """(window, cos, sin, mel) as fp32 tensors on `device`."""
    cfg = FeatureConfig(*key)
    if cfg.win_length != cfg.n_fft:
        raise NotImplementedError("win_length != n_fft is not supported")
    if cfg.window != "hamming" or cfg.power != 2.0:
        raise NotImplementedError("only the periodic hamming window and power 2")
    cos, sin = dft_matrices(cfg.n_fft)
    mats = (hamming_window(cfg.n_fft), cos, sin,
            mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate))
    return tuple(torch.from_numpy(m).to(device) for m in mats)


def decode_wire(waves: torch.Tensor) -> torch.Tensor:
    """Undo the int16 wire format (PCM / 32768); other floats go to fp32."""
    if waves.dtype == torch.int16:
        return waves.to(torch.float32) * (1.0 / 32768.0)
    return waves.to(torch.float32)


def fbank(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """[N] float (or int16 PCM) waveform -> [T, n_mels] log-mel features."""
    return _logmel(decode_wire(waveform)[None], cfg)[0]


def _logmel(waves: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    window, cos, sin, mel = _operands(astuple(cfg), str(waves.device))
    frames = frame_signal(waves, cfg.n_fft, cfg.hop_length, cfg.center)  # [B, T, n_fft]
    b, t, n = frames.shape
    out = fbank_frames(frames.reshape(b * t, n).contiguous(), window, cos, sin, mel,
                       cfg.amin, cfg.fbank_precision)
    return out.reshape(b, t, -1)


def fbank_batch(waves, wave_lens, cfg: FeatureConfig, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, N] padded waveforms -> ([B, T, n_mels], feat_lens [B]) on `device`
    (default: the card). Padded samples produce garbage trailing frames;
    feat_lens marks the valid prefix (1 + len // hop)."""
    dev = resolve_device(device)
    waves = decode_wire(torch.as_tensor(waves).to(dev))
    wave_lens = torch.as_tensor(wave_lens).to(dev)
    return _logmel(waves, cfg), 1 + wave_lens // cfg.hop_length
