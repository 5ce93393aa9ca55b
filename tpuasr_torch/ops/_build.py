"""Build and load the port's CUDA kernels.

Each ``tpuasr_torch/csrc/<name>.cu`` has a plain C interface. At first use it
is compiled by ``nvcc`` for ``sm_90a`` into ``build/tpuasr_torch/`` at the
root of the checkout and loaded with ``ctypes``; the library's file name
carries a hash of its source, so an edited source is rebuilt. Nothing here
runs at import time: the CPU tests import every module of the port.

Every wrapper counts its kernel launches in `LAUNCHES`, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuasr_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each library's C entry point and its argument types (pointers and the
# stream as c_void_p, so ctypes never cuts them to 32 bits)
ENTRIES = {
    "fbank": ("fbank_logmel", [_P] * 6 + [_I] * 4 + [_F, _I, _P]),
    "relpos_attention": ("relpos_attention_fwd",
                         [_P] * 8 + [_I] * 5 + [_LL] * 3 + [_F, _I, _P]),
}
KERNELS = tuple(ENTRIES)

LAUNCHES = {name: 0 for name in KERNELS}

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


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
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
    """Build every kernel at once (one nvcc per source, all started
    together, all waited for) -> {name: compiler log} ('' when built)."""
    with _lock:
        started = {name: _start(name) for name in KERNELS}
        logs, errors = {}, []
        for name in KERNELS:
            try:
                logs[name] = _finish(name, *started[name])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def _library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(str(_target(name)))
            lib.tpuasr_cuda_error_string.argtypes = [_I]
            lib.tpuasr_cuda_error_string.restype = ctypes.c_char_p
            symbol, argtypes = ENTRIES[name]
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = _I
            _libs[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point, raise on the CUDA error it
    returns (its cudaGetLastError() right after the launch: a refused launch
    never runs and no later sync reports it), and count the launch."""
    lib = _library(name)
    err = getattr(lib, ENTRIES[name][0])(*args)
    if err != 0:
        msg = lib.tpuasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
