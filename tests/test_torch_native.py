"""The port's native host runtime (`tpuasr_torch/csrc/tpuasr_native.cc`,
`tpuasr_torch.utils.native`) against the JAX package's (`native/`,
`tpuasr.utils.native`), and the corpus path that reads through it.

The JAX library is built by `native/build.sh` from a copy of `native/` in
the test's tmp_path (the script builds beside itself, so two test workers
never share a build directory), and the JAX binding is pointed at it. The
port builds its own copy at first use (`ops._build.host_library`). Held,
all exactly:
- `wav_read` on WAVs written here with numpy: 8/16/24/32-bit PCM and IEEE
  float32, mono and stereo (the first channel), a LIST chunk of odd length
  before `data`, and `max_samples` cutting the read; against the JAX
  reader bit for bit, and against `read_wav` wherever `read_wav` reads;
- a 24-bit corpus (samples v * 256 of a 16-bit one) through the port's
  `make_pipeline` gives the JAX pipeline's batches and the 16-bit corpus's;
- `BatchLoader` equals a read per file, zero-padded;
- `cer_counts_native` equals `cer_details` and the JAX native counts on
  seeded random pairs.
Both readers skip only where no C++ compiler is on PATH.
"""

import shutil
import struct
import subprocess
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuasr_torch.data import make_pipeline, read_wav
from tpuasr_torch.data.corpus import UtteranceMeta
from tpuasr_torch.text.cer import cer_details
from tpuasr_torch.utils import native

torch.set_num_threads(1)  # six test workers share the cores

ROOT = Path(__file__).resolve().parents[1]
SR = 16000
FORMATS = [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32)]  # (WAVE format tag, bits)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX binding over its library, built by native/build.sh in a copy."""
    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("no C++ compiler on PATH")
    from tpuasr.utils import native as nat

    src = tmp_path_factory.mktemp("jax_native") / "native"
    src.mkdir()
    for f in ("build.sh", "CMakeLists.txt", "tpuasr_native.cc"):
        shutil.copy(ROOT / "native" / f, src / f)
    subprocess.run(["sh", str(src / "build.sh")], check=True, capture_output=True, timeout=300)
    lib = next(src.glob("build/*tpuasr_native*.so"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nat, "_lib", None)
        mp.setattr(nat, "_find_library", lambda: str(lib))
        assert nat.is_available()
        yield nat


def _pcm(x: np.ndarray, fmt: int, bits: int) -> bytes:
    """Interleaved samples [n, ch] (ints for PCM, floats for format 3) as
    little-endian bytes."""
    if fmt == 3:
        return x.astype("<f4").tobytes()
    if bits == 24:
        b = x.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return b.tobytes()
    return x.astype({8: np.uint8, 16: "<i2", 32: "<i4"}[bits]).tobytes()


def write_wav(path, x: np.ndarray, fmt: int, bits: int, sr: int = SR,
              list_chunk: bool = False) -> None:
    """A RIFF/WAVE file of x [n, ch] written by hand: fmt, an optional LIST
    chunk of odd length (with its pad byte), data."""
    ch = x.shape[1]
    raw = _pcm(x, fmt, bits)
    chunks = [b"fmt " + struct.pack("<IHHIIHH", 16, fmt, ch, sr, sr * ch * bits // 8,
                                    ch * bits // 8, bits)]
    if list_chunk:
        info = b"INFOISFT\x05\x00\x00\x00test\x00"
        chunks.append(b"LIST" + struct.pack("<I", len(info)) + info + b"\x00" * (len(info) & 1))
    chunks.append(b"data" + struct.pack("<I", len(raw)) + raw + b"\x00" * (len(raw) & 1))
    body = b"WAVE" + b"".join(chunks)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def samples(rng, n: int, ch: int, fmt: int, bits: int) -> np.ndarray:
    """Random samples over the format's whole range, extremes included."""
    if fmt == 3:
        x = rng.uniform(-1, 1, (n, ch)).astype(np.float32)
        x[0, 0], x[1, 0] = -1.0, 1.0
        return x
    if bits == 8:
        return rng.integers(0, 256, (n, ch))
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    x = rng.integers(lo, hi, (n, ch), endpoint=True)
    x[0, 0], x[1, 0] = lo, hi
    return x


@pytest.mark.parametrize("fmt,bits", FORMATS)
@pytest.mark.parametrize("ch,list_chunk", [(1, False), (2, True)])
def test_wav_read_matches_jax(jax_native, tmp_path, fmt, bits, ch, list_chunk):
    rng = np.random.default_rng(bits + 10 * fmt + ch)
    n = 1001
    path = str(tmp_path / "a.wav")
    write_wav(path, samples(rng, n, ch, fmt, bits), fmt, bits, 22050, list_chunk)
    for max_samples in (n, n + 7, 600):
        got, sr = native.wav_read(path, max_samples)
        want, sr_j = jax_native.wav_read(path, max_samples)
        assert sr == sr_j == 22050
        assert got.dtype == want.dtype == np.float32 and len(got) == min(n, max_samples)
        np.testing.assert_array_equal(got, want)
    if fmt == 1 and bits != 24:  # what read_wav reads: 8/16/32-bit PCM
        ref, sr_p = read_wav(path)
        assert sr_p == 22050
        np.testing.assert_array_equal(native.wav_read(path, n)[0], ref)


def test_wav_read_refuses_what_is_no_wav(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVX")
    with pytest.raises(IOError):
        native.wav_read(str(bad), 100)
    with pytest.raises(IOError):
        native.wav_read(str(tmp_path / "missing.wav"), 100)


def _corpus(tmp_path, bits: int) -> list:
    """Six utterances whose 16-bit samples v (the same for every `bits`) are
    written as v * 2**(bits - 16) -> (path, tokens, wave_len) each."""
    out = []
    r = np.random.default_rng(0)
    for i in range(6):
        n = 3000 + 1117 * i
        v = r.integers(-32768, 32767, (n, 1), endpoint=True)
        path = tmp_path / f"{bits}_{i}.wav"
        write_wav(path, v << (bits - 16), 1, bits)
        with wave.open(str(path), "rb") as w:
            wave_len = w.getnframes()
        out.append((str(path), r.integers(6, 60, 3 + i % 3).astype(np.int32), wave_len))
    return out


def test_24bit_corpus_batches_match_jax_and_16bit(jax_native, tmp_path):
    from tpuasr.config import Config as JaxConfig
    from tpuasr.data.corpus import UtteranceMeta as JaxUtteranceMeta
    from tpuasr.data.corpus import make_pipeline as jax_make_pipeline
    from tpuasr_torch.config import Config

    def cfgs():
        cfg, jcfg = Config(), JaxConfig()
        for c in (cfg, jcfg):
            c.data.batch_size, c.feature.hop_length = 2, 512
            c.data.frame_buckets, c.data.token_buckets = (8, 16, 32), (8,)
        return cfg, jcfg

    batches = {}
    for bits in (16, 24):
        items = _corpus(tmp_path, bits)
        cfg, jcfg = cfgs()
        port = list(make_pipeline([UtteranceMeta(f"u{i}", *it) for i, it in enumerate(items)],
                                  cfg).batches(0))
        ref = list(jax_make_pipeline([JaxUtteranceMeta(f"u{i}", *it)
                                      for i, it in enumerate(items)], jcfg).batches(0))
        assert len(port) == len(ref) > 1
        for got, want in zip(port, ref):
            assert got.keys() == want.keys()
            for k in want:
                if isinstance(want[k], np.ndarray):
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                else:
                    assert got[k] == want[k], k
        batches[bits] = port
    for a, b in zip(batches[16], batches[24]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="sample width 3"):  # what the corpus read before
        read_wav(str(tmp_path / "24_0.wav"))


def test_batch_loader_matches_per_file_reads(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i, (fmt, bits) in enumerate(FORMATS * 2):
        p = str(tmp_path / f"b{i}.wav")
        write_wav(p, samples(rng, 2000 + 613 * i, 1 + i % 2, fmt, bits), fmt, bits)
        paths.append(p)
    loader = native.BatchLoader(num_threads=3)
    try:
        for max_samples in (4000, 9000):
            waves, lens = loader.load(paths, max_samples)
            assert waves.shape == (len(paths), max_samples) and lens.dtype == np.int32
            for i, p in enumerate(paths):
                one, _ = native.wav_read(p, max_samples)
                assert lens[i] == len(one)
                np.testing.assert_array_equal(waves[i, :lens[i]], one)
                assert not waves[i, lens[i]:].any()
        with pytest.raises(IOError, match="1 wav files"):
            loader.load(paths[:2] + [str(tmp_path / "missing.wav")], 100)
    finally:
        loader.close()


def test_cer_counts_match_python_and_jax(jax_native):
    rng = np.random.default_rng(5)
    for _ in range(200):
        ref = rng.integers(0, 6, rng.integers(0, 14)).tolist()
        hyp = rng.integers(0, 6, rng.integers(0, 14)).tolist()
        got = native.cer_counts_native(ref, hyp)
        py = cer_details(ref, hyp)
        assert got == (py.substitutions, py.deletions, py.insertions)
        assert got == jax_native.cer_counts_native(ref, hyp)


def test_host_build_is_source_hashed(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output; the library's name
    carries its source's hash."""
    from tpuasr_torch.ops import _build

    lib = _build.host_library("tpuasr_native")
    assert lib is _build.host_library("tpuasr_native")
    built = list(_build.BUILD_DIR.glob("libtpuasr_native-*.so"))
    assert built and all(not p.name.endswith(".tmp") for p in built)
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed for broken.cc"):
        _build.host_library("broken")
    assert not list((tmp_path / "build").glob("*"))
