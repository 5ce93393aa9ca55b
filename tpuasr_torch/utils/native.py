"""ctypes binding of the port's native host runtime (port of
``tpuasr/utils/native.py``; the source is `tpuasr_torch/csrc/tpuasr_native.cc`).

- `wav_read`: one WAV decoded to float32 (PCM 8/16/24/32-bit and IEEE
  float32, the first channel), the corpus path's reader on the float32 wire
  (`tpuasr_torch.data.corpus`);
- `BatchLoader`: a thread pool decoding a batch of WAVs in parallel into one
  zero-padded buffer;
- `cer_counts_native`: the CER edit distance with its S/D/I backtrace.

The library is built by the host C++ compiler at first use
(`tpuasr_torch.ops._build.host_library`), never at import; a failed build
raises, and nothing falls back to the Python reader.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_F32P, _I32P, _I64P = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int32,
                                                    ctypes.c_int64))


def _load() -> ctypes.CDLL:
    """The library, built and its signatures declared on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from tpuasr_torch.ops._build import host_library

            lib = host_library("tpuasr_native")
            lib.tpuasr_wav_read.restype = ctypes.c_int64
            lib.tpuasr_wav_read.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64, _I32P,
                                            _I64P]
            lib.tpuasr_loader_create.restype = ctypes.c_void_p
            lib.tpuasr_loader_create.argtypes = [ctypes.c_int]
            lib.tpuasr_loader_destroy.restype = None
            lib.tpuasr_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.tpuasr_loader_load_batch.restype = ctypes.c_int
            lib.tpuasr_loader_load_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _F32P, _I64P,
                ctypes.c_int64]
            lib.tpuasr_cer_counts.restype = None
            lib.tpuasr_cer_counts.argtypes = [_I32P, ctypes.c_int32, _I32P, ctypes.c_int32,
                                              _I32P]
            _lib = lib
        return _lib


def wav_read(path: str, max_samples: int = 1 << 26) -> tuple[np.ndarray, int]:
    """Native WAV decode -> (float32 wave of at most `max_samples`,
    sample_rate); IOError when the file does not decode."""
    lib = _load()
    out = np.zeros(max_samples, np.float32)
    sr, total = ctypes.c_int32(0), ctypes.c_int64(0)
    n = lib.tpuasr_wav_read(str(path).encode(), out.ctypes.data_as(_F32P), max_samples,
                            ctypes.byref(sr), ctypes.byref(total))
    if n < 0:
        raise IOError(f"failed to decode {path}")
    return out[:n].copy(), int(sr.value)


class BatchLoader:
    """Thread-pool parallel WAV batch decoder writing into padded buffers."""

    def __init__(self, num_threads: int = 8):
        self._lib = _load()
        self._pool = self._lib.tpuasr_loader_create(num_threads)

    def load(self, paths: Sequence[str], max_samples: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (waves [N, max_samples] zero-padded, lens [N] int32); IOError
        when any file does not decode."""
        n = len(paths)
        waves = np.zeros((n, max_samples), np.float32)
        lens = np.zeros(n, np.int64)
        arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
        failures = self._lib.tpuasr_loader_load_batch(
            self._pool, arr, n, waves.ctypes.data_as(_F32P), lens.ctypes.data_as(_I64P),
            max_samples)
        if failures:
            raise IOError(f"{failures} wav files failed to decode")
        return waves, lens.astype(np.int32)

    def close(self) -> None:
        """Stop and join the pool's threads (also on garbage collection)."""
        if getattr(self, "_pool", None):
            self._lib.tpuasr_loader_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()


def cer_counts_native(ref: Sequence[int], hyp: Sequence[int]) -> tuple[int, int, int]:
    """C++ edit distance -> (S, D, I)."""
    lib = _load()
    r = np.ascontiguousarray(ref, np.int32)
    h = np.ascontiguousarray(hyp, np.int32)
    out = np.zeros(3, np.int32)
    lib.tpuasr_cer_counts(r.ctypes.data_as(_I32P), len(r), h.ctypes.data_as(_I32P), len(h),
                          out.ctypes.data_as(_I32P))
    return int(out[0]), int(out[1]), int(out[2])
