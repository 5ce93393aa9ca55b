"""Log-mel fbank over framed audio: the hand-written CUDA kernel
(``csrc/fbank.cu``) and its plain PyTorch version.

Counterpart of ``tpuasr/ops/fbank_pallas.py`` (`fbank_frames_pallas`). The
wrapper runs the kernel for tensors on the card and the plain version for
tensors on the CPU; a CUDA tensor never takes the plain path.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops import _build

PRECISIONS = ("highest", "default")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def fbank_frames_plain(frames, window, cos, sin, mel, amin: float = 1e-10,
                       precision: str = "highest") -> torch.Tensor:
    """[R, n_fft] fp32 frames -> [R, n_mels] log-mel (dB), plain PyTorch.

    "default" rounds each product's operands to bf16 and accumulates in fp32
    (matmul in fp32 of the rounded values), as the kernel does."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    bf = precision == "default"
    rnd = _round_bf16 if bf else (lambda x: x)
    fw = rnd(frames * window)
    re = fw @ rnd(cos)
    im = fw @ rnd(sin)
    spec = rnd(re * re + im * im)
    m = spec @ rnd(mel)
    return 10.0 * torch.log10(torch.clamp(m, min=amin))


def fbank_frames(frames, window, cos, sin, mel, amin: float = 1e-10,
                 precision: str = "highest") -> torch.Tensor:
    """[R, n_fft] fp32 frames -> [R, n_mels] fp32 log-mel.

    window [n_fft], cos/sin [n_fft, n_freq], mel [n_freq, n_mels], all fp32
    on the frames' device. CPU tensors take the plain version."""
    if frames.device.type == "cpu":
        return fbank_frames_plain(frames, window, cos, sin, mel, amin, precision)
    if frames.device.type != "cuda":
        raise ValueError(f"fbank_frames: unsupported device {frames.device}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    rows, n_fft = frames.shape
    n_freq, n_mels = mel.shape
    expect = {"window": (n_fft,), "cos": (n_fft, n_freq), "sin": (n_fft, n_freq),
              "mel": (n_freq, n_mels)}
    for name, t in (("frames", frames), ("window", window), ("cos", cos),
                    ("sin", sin), ("mel", mel)):
        if t.device != frames.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fbank_frames: {name} must be a contiguous fp32 tensor "
                             f"on {frames.device}")
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"fbank_frames: {name} shape {tuple(t.shape)}, "
                             f"expected {expect[name]}")
    out = torch.empty((rows, n_mels), dtype=torch.float32, device=frames.device)
    if rows == 0:
        return out
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("fbank", frames.data_ptr(), window.data_ptr(), cos.data_ptr(),
                      sin.data_ptr(), mel.data_ptr(), out.data_ptr(), rows, n_fft, n_freq,
                      n_mels, float(amin), int(precision == "default"), stream)
    return out
