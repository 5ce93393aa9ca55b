"""Port fbank == JAX fbank on the CPU.

The port's `fbank_batch` (its kernel's plain version on CPU tensors) is
held against `tpuasr.audio.fbank_batch` (jnp path) and against the Pallas
kernel `fbank_frames_pallas` in interpret mode, at the tolerance of
tests/test_fbank.py:101 (rtol 1e-4, atol 1e-3 dB): the DFT's fp32 sums run
in another order, which moves low-energy bins by ~1e-3 dB after the log.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.audio import fbank_batch as jax_fbank_batch
from tpuasr.audio.fbank import _cfg_key, _operands, frame_signal
from tpuasr.config import FeatureConfig as JaxFeatureConfig
from tpuasr.ops.fbank_pallas import fbank_frames_pallas
from tpuasr_torch.audio import fbank_batch
from tpuasr_torch.audio.fbank import frame_signal as port_frame_signal
from tpuasr_torch.config import FeatureConfig
from tpuasr_torch.ops import fbank_frames, fbank_frames_plain

RTOL, ATOL = 1e-4, 1e-3
# "default" rounds the power spectrum to bf16 before the mel product: a bin
# whose fp32 power lands on the other side of a bf16 rounding boundary moves
# by one bf16 ulp (2**-7 relative at most), 10*log10(1 + 2**-7) = 0.034 dB
ATOL_BF16 = 4e-2


def _waves(kind, rng):
    if kind == "fixture":  # 48 kHz corpus waves, float16 on the wire
        d = np.load("fixtures/example1.npz")
        return d["waves"][:3], d["wave_lens"][:3], 48000
    if kind == "synthetic":
        w = (rng.standard_normal((3, 12000)) * 0.1).astype(np.float32)
        w[1, 7000:] = 0.0
        return w, np.array([12000, 7000, 9999], np.int32), 16000
    pcm = (rng.standard_normal((2, 9000)) * 3000).astype(np.int16)  # int16 wire
    return pcm, np.array([9000, 6000], np.int32), 16000


@pytest.mark.parametrize("kind", ["fixture", "synthetic", "int16"])
def test_fbank_batch_matches_jax(kind, rng):
    waves, lens, sr = _waves(kind, rng)
    ref, ref_lens = jax_fbank_batch(waves, lens, JaxFeatureConfig(sample_rate=sr,
                                                                  use_pallas=False))
    got, got_lens = fbank_batch(waves, lens, FeatureConfig(sample_rate=sr), device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_frame_signal_matches_jax(rng):
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    ref = np.asarray(frame_signal(x, 1024, 512, True))
    got = port_frame_signal(torch.from_numpy(x), 1024, 512, True)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_matches_pallas_interpret(rng):
    """The kernel's plain version == the Pallas kernel (interpret mode) on the
    same frames and operands."""
    cfg = JaxFeatureConfig(sample_rate=16000)
    ops = _operands(_cfg_key(cfg))
    wave = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    frames = np.asarray(frame_signal(wave, cfg.n_fft, cfg.hop_length, cfg.center))
    ref = np.asarray(fbank_frames_pallas(frames, ops.window, ops.cos, ops.sin, ops.mel,
                                         cfg.amin))
    t = lambda a: torch.from_numpy(np.array(a))
    got = fbank_frames(t(frames), t(ops.window), t(ops.cos), t(ops.sin), t(ops.mel),
                       cfg.amin)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_default_precision_rounds_operands_to_bf16(rng):
    """precision="default" == products of bf16-rounded operands accumulated
    in fp32 (the TPU's single bf16 pass), here built independently in jnp."""
    cfg = JaxFeatureConfig(sample_rate=16000)
    ops = _operands(_cfg_key(cfg))
    wave = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    frames = frame_signal(wave, cfg.n_fft, cfg.hop_length, cfg.center)
    rnd = lambda a: jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    fw = rnd(frames * ops.window)
    re = jnp.dot(fw, rnd(ops.cos), precision=hi)
    im = jnp.dot(fw, rnd(ops.sin), precision=hi)
    m = jnp.dot(rnd(re * re + im * im), rnd(ops.mel), precision=hi)
    ref = np.asarray(10.0 * jnp.log10(jnp.maximum(m, cfg.amin)))
    t = lambda a: torch.from_numpy(np.array(a))
    got = fbank_frames_plain(t(frames), t(ops.window), t(ops.cos), t(ops.sin), t(ops.mel),
                             cfg.amin, "default")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_BF16)
    with pytest.raises(ValueError):
        fbank_frames_plain(t(frames), t(ops.window), t(ops.cos), t(ops.sin), t(ops.mel),
                           cfg.amin, "high")
