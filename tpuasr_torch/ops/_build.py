"""Build and load the port's CUDA kernels.

Each ``tpuasr_torch/csrc/<name>.cu`` has a plain C interface. At first use it
is compiled by ``nvcc`` for ``sm_90a`` into ``build/tpuasr_torch/`` at the
root of the checkout and loaded with ``ctypes``; the library's file name
carries a hash of its source and of the ``csrc/*.cuh`` headers it includes
(`mma.cuh`: the cp.async and tensor-core building blocks of the fbank,
attention, FFN, fused-joint and lattice kernels; `lattice.cuh`: what the
two lattices' warp routes share), so an edited source or header is rebuilt.
Nothing here runs at import time: the CPU tests import every module of the
port.

A source may hold several kernels (`fbank.cu`: the fp32 dense route, the
fp32 FFT route's band and FFT kernels, and the bf16 route's operand pack and
tensor-core kernel behind the same entry point; `ctc_lattice.cu`: the CTC
alpha and beta sweeps, each by a warp route and a block route;
`rnnt_fused.cu`: the fused joint forward and backward, whose entry points
launch two and four kernels; `rnnt_lattice.cu`: the RNN-T alpha and beta
sweeps, each by a warp route and a block route; `relpos_attention.cu`: the
attention forward and its backward, whose one entry point launches two
kernels; `ffn.cu`: the fused FFN forward and
backward), each with its own C entry point. Every wrapper counts its calls of an entry point in `LAUNCHES`,
so a run can show that its path went through the kernels; fbank's entry
also counts each of its three routes there, and each lattice entry its
two.

The port's native host runtime (`csrc/tpuasr_native.cc`: the WAV reader,
the thread-pool batch loader and the CER counts, `tpuasr_torch.utils.native`)
takes the host route, `host_library`: the host C++ compiler builds it into
the same directory, under the same source-hashed name and atomic rename.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuasr_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each kernel's source, C entry point and argument types (pointers and the
# stream as c_void_p, so ctypes never cuts them to 32 bits)
ENTRIES = {
    "fbank": ("fbank", "fbank_logmel", [_P] * 9 + [_I] * 4 + [_F] + [_I] * 11 + [_P]),
    "relpos_attention": ("relpos_attention", "relpos_attention_fwd",
                         [_P] * 10 + [_I] * 5 + [_LL] * 3 + [_F, _I, _P]),
    "relpos_attention_bwd": ("relpos_attention", "relpos_attention_bwd",
                             [_P] * 18 + [_I] * 5 + [_LL] * 3 + [_F, _I, _P]),
    "rnnt_fused_fwd": ("rnnt_fused", "rnnt_fused_fwd", [_P] * 9 + [_LL] + [_I] * 9 + [_P]),
    "rnnt_fused_bwd": ("rnnt_fused", "rnnt_fused_bwd", [_P] * 13 + [_LL] + [_I] * 9 + [_P]),
    "ctc_alpha": ("ctc_lattice", "ctc_alpha", [_P] * 6 + [_I] * 5 + [_P]),
    "ctc_beta_grad": ("ctc_lattice", "ctc_beta_grad", [_P] * 8 + [_I] * 5 + [_P]),
    "rnnt_alpha": ("rnnt_lattice", "rnnt_alpha", [_P] * 5 + [_I] * 6 + [_P]),
    "rnnt_beta_grad": ("rnnt_lattice", "rnnt_beta_grad", [_P] * 8 + [_I] * 6 + [_P]),
    "ffn_fwd": ("ffn", "ffn_fwd", [_P] * 10 + [_I] * 3 + [_F, _F, _I, _P, _LL, _I, _P]),
    "ffn_bwd": ("ffn", "ffn_bwd", [_P] * 17 + [_I] * 3 + [_F, _F, _I, _P, _LL, _I, _P]),
}
KERNELS = tuple(ENTRIES)
SOURCES = tuple(dict.fromkeys(src for src, _, _ in ENTRIES.values()))

# an entry point with several routes also counts each route's launches, so
# a run can show which one it took: fbank's "highest" by the dense fp32
# kernel, "default" (bf16 pack and tensor-core kernel) and "highest" by the
# fp32 FFT (band and FFT kernels); the CTC and RNN-T sweeps' warp route (a
# warp an utterance, S or U+1 <= 256) and block route (a block an utterance)
ROUTES = {"fbank": ("fbank_fp32", "fbank_tc", "fbank_fft"),
          "ctc_alpha": ("ctc_alpha_warp", "ctc_alpha_block"),
          "ctc_beta_grad": ("ctc_beta_grad_warp", "ctc_beta_grad_block"),
          "rnnt_alpha": ("rnnt_alpha_warp", "rnnt_alpha_block"),
          "rnnt_beta_grad": ("rnnt_beta_grad_warp", "rnnt_beta_grad_block")}

LAUNCHES = {name: 0 for name in KERNELS + tuple(r for rs in ROUTES.values() for r in rs)}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels are "
                       "built from tpuasr_torch/csrc at first use")


def _cxx() -> str:
    for cand in ("c++", "g++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH; the native host runtime "
                       "is built from tpuasr_torch/csrc at first use")


def host_library(name: str) -> ctypes.CDLL:
    """`csrc/<name>.cc` built by the host C++ compiler (HOST_CXX_FLAGS) at
    first use into `BUILD_DIR/lib<name>-<hash of the source>.so` and loaded.
    Processes that build it at once (test workers, ranks) each write their
    own temporary file and rename it into place. A failed build raises with the
    compiler's output."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = CSRC / f"{name}.cc"
            out = BUILD_DIR / f"lib{name}-{hashlib.sha1(src.read_bytes()).hexdigest()[:12]}.so"
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cxx = _cxx()
                proc = subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", str(tmp), str(src)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{cxx} failed for {name}.cc:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def _sources(name: str) -> list[Path]:
    """A kernel source and the csrc headers it includes (`#include "x.cuh"`)."""
    src = CSRC / f"{name}.cu"
    heads = re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)
    return [src] + [CSRC / h for h in heads]


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source and its headers, so
    an edit of either rebuilds it."""
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in _sources(name))).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one kernel; -> (Popen or None if built, target, tmp)."""
    out = _target(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: Path, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return log


def build_all() -> dict[str, str]:
    """Build every kernel source at once (one nvcc per source, all started
    together, all waited for) -> {source: compiler log} ('' when built)."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        logs, errors = {}, []
        for name in SOURCES:
            try:
                logs[name] = _finish(name, *started[name])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def _library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _finish(source, *_start(source))
            lib = ctypes.CDLL(str(_target(source)))
            lib.tpuasr_cuda_error_string.argtypes = [_I]
            lib.tpuasr_cuda_error_string.restype = ctypes.c_char_p
            for src, symbol, argtypes in ENTRIES.values():
                if src == source:
                    getattr(lib, symbol).argtypes = argtypes
                    getattr(lib, symbol).restype = _I
            _libs[source] = lib
        return lib


def launch(name: str, *args, route: str | None = None) -> None:
    """Call kernel `name`'s C entry point, raise on the CUDA error it
    returns (its cudaGetLastError() right after the launch: a refused launch
    never runs and no later sync reports it), and count the launch, under
    `route` too where the entry has routes (`ROUTES`)."""
    source, symbol, _ = ENTRIES[name]
    if route not in ROUTES.get(name, (None,)):
        raise ValueError(f"{name}: route {route!r}, expected one of {ROUTES.get(name)}")
    lib = _library(source)
    err = getattr(lib, symbol)(*args)
    if err != 0:
        msg = lib.tpuasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    if route is not None:
        LAUNCHES[route] += 1
