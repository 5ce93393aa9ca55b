"""Kernel #1, the log-mel fbank (`fbank` entry: the "default" route's pack
and tensor-core kernels, the "highest" route's band and FFT kernels, or the
dense fp32 kernel). Its least work is a real FFT of each frame (2.5 N
log2 N), the power of each bin and the mel product, on the CUDA cores'
fp32 peak; the frames are read once and the features written once."""

import math

EVENTS = ("fbank_pack_kernel", "fbank_tc_kernel", "fbank_band_kernel", "fbank_fft_kernel",
          "fbank_kernel")


def shape(c: dict) -> dict:
    return {"frames": c["fbank_frames"], "n_fft": c["n_fft"], "n_mels": c["n_mels"]}


def ops(s: dict) -> float:
    n, bins = s["n_fft"], s["n_fft"] // 2 + 1
    return s["frames"] * (2.5 * n * math.log2(n) + 3 * bins + 2 * bins * s["n_mels"])


def nbytes(s: dict) -> float:
    return s["frames"] * (s["n_fft"] + s["n_mels"]) * 4


def bound_s(s: dict, peaks: dict) -> float:
    return max(ops(s) / peaks["float32"], nbytes(s) / peaks["hbm"])
