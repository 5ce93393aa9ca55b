"""fbank's FFT route ("highest" at a power-of-two n_fft): its plan
(`_fbank_fft_plan`, plain Python) and a plain-PyTorch emulation of the
kernel's order of operations, on the CPU.

On the card csrc/fbank.cu's `fbank_fft_kernel` windows each frame in fp32,
packs it as z[n] = x[2n] + i x[2n+1], takes one n_fft / 2-point complex FFT
as radix-2 DIF stages grouped into passes (`_fft_groups`: a thread's 16
points in registers for a pass's stages, the points through padded shared
memory between passes, Z written in natural order after the last), with the
twiddles read from row 1 of the cos/sin basis; then the real split
X[k] = E - i W^k D, the power, and each mel filter's band of bins (from the
filter's first to its last nonzero, found from the mel matrix by
`fbank_band_kernel`) walked in ascending order. The emulation follows that
index layout, those formulas and that order in float32 and is held against
`fbank_frames_plain` (a dense fp32 DFT) and the JAX package's Pallas kernel
in interpret mode at the card tests' tolerance, rtol 1e-4 and atol 1e-3 dB
(tests/test_torch_fbank.py's): the FFT's sums run in another order than the
dense products', which moves low-energy bins by ~1e-3 dB after the log.
A silent frame lands on the -100 dB floor exactly.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fbank_fft.py

prints each route's max dB error against a float64 DFT on the same frames
(recorded in PERF.md, not gated).
"""

from dataclasses import astuple

import numpy as np
import pytest
import torch

from tpuasr.audio.fbank import _cfg_key
from tpuasr.audio.fbank import _operands as jax_operands
from tpuasr.config import FeatureConfig as JaxFeatureConfig
from tpuasr.ops.fbank_pallas import fbank_frames_pallas
from tpuasr_torch.audio.fbank import _operands, decode_wire, frame_signal
from tpuasr_torch.config import FeatureConfig
from tpuasr_torch.ops.fbank import (
    FBANK_SMEM, FFT_FRAMES, FFT_MAX_THREADS, _fbank_fft_plan, _fft_groups, _fft_pad, _fft_smem,
    fbank_frames_plain,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
N_SM = 132


def _cdiv(a, b):
    return -(-a // b)


def _brev(i: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def _layout(log2m: int, g: int, lo: int, bits: int):
    """csrc/fbank.cu's index layout of pass g: -> (base [T, 1] of thread t,
    part [1, 16] of register j); the point register j of thread t holds is
    base + part (their bits disjoint)."""
    t = torch.arange((1 << log2m) // 16)[:, None]
    j = torch.arange(16)[None, :]
    if g == 0:  # j's bit 3 is index bit 0: a float4 of the frame is j and j + 8
        return t << 1, ((j >> 3) & 1) | ((j & 7) << (log2m - 3))
    # j's spare bits at the top of the index, the thread's around the field
    base = (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + bits))
    return base, ((j & ((1 << bits) - 1)) << lo) | ((j >> bits) << (log2m - 4 + bits))


def _emulate_fft(frames, window, cos, sin, mel, amin):
    """The FFT route's arithmetic in float32, in the kernel's order."""
    rows, n_fft = frames.shape
    log2m = n_fft.bit_length() - 2
    m = 1 << log2m
    twr, twi = cos[1, :m + 1], sin[1, :m + 1]  # W^k, k <= M: row 1 of the basis
    fw = frames * window
    zr, zi = fw[:, 0::2].clone(), fw[:, 1::2].clone()  # z[n] = x[2n] + i x[2n+1]
    groups = _fft_groups(log2m)
    for g, (lo, bits) in enumerate(groups):
        base, part = _layout(log2m, g, lo, bits)
        idx = base + part  # [T, 16]
        assert torch.equal(idx.flatten().sort().values, torch.arange(m))  # each point once
        assert not bool((base & part).any())
        assert torch.equal(_fft_pad_t(idx), _fft_pad_t(base) + _fft_pad_t(part))
        vr, vi = zr[:, idx], zi[:, idx]  # [R, T, 16]
        for q in reversed(range(bits)):
            b = lo + q
            s = log2m - 1 - b
            for j0 in range(16):
                if j0 & (1 << q):
                    continue
                j1 = j0 | (1 << q)
                ar, ai, br, bi = vr[..., j0], vi[..., j0], vr[..., j1], vi[..., j1]
                dr, di = ar - br, ai - bi
                vr[..., j0], vi[..., j0] = ar + br, ai + bi
                if b:  # W^(2 (i mod 2**b) 2**s), from the table
                    e = (idx[:, j0] & ((1 << b) - 1)) << (s + 1)
                    wr, wi = twr[e], twi[e]
                    vr[..., j1], vi[..., j1] = dr * wr - di * wi, dr * wi + di * wr
                else:
                    vr[..., j1], vi[..., j1] = dr, di
        if g + 1 < len(groups):
            zr[:, idx], zi[:, idx] = vr, vi
        else:  # natural order: the point at index i is Z[bit reverse of i]
            nat = _brev(idx, log2m)
            assert torch.equal(nat, _brev(base, log2m) + _brev(part, log2m))
            zr[:, nat], zi[:, nat] = vr, vi
    # the real split, k = 0 .. M (Z[M] = Z[0])
    k = torch.arange(m + 1)
    kk = (m - k) & (m - 1)
    ar, ai, br, bi = zr[:, k % m], zi[:, k % m], zr[:, kk], zi[:, kk]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    dr, di = 0.5 * (ar - br), 0.5 * (ai + bi)
    wdr, wdi = dr * twr - di * twi, dr * twi + di * twr
    xr, xi = er + wdi, ei - wdr
    power = xr * xr + xi * xi  # [R, M + 1]
    # each filter's band, from its first to its last nonzero bin, walked in
    # ascending order (a bin outside every band adds nothing)
    nz = mel != 0
    f = torch.arange(mel.shape[0])[:, None]
    lo = torch.where(nz, f, mel.shape[0]).min(0).values
    hi = torch.where(nz, f, -1).max(0).values
    acc = torch.zeros(rows, mel.shape[1])
    for b in range(mel.shape[0]):
        inside = (lo <= b) & (b <= hi)
        acc = torch.where(inside, acc + power[:, b:b + 1] * mel[b], acc)
    return 10.0 * torch.log10(torch.clamp(acc, min=amin))


def _fft_pad_t(i: torch.Tensor) -> torch.Tensor:
    return i + (i >> 4) + (i >> 8)


def _features(kind: str, rng, n_fft: int = 1024, sr: int = 48000, n_mels: int = 80,
              hop: int | None = None):
    """-> (cfg, frames [R, n_fft], (window, cos, sin, mel)): the fixture's
    first three 48 kHz waves, or seeded noise with a silent tail (its last
    frames all zero)."""
    cfg = FeatureConfig(sample_rate=sr, n_fft=n_fft, win_length=n_fft, n_mels=n_mels,
                        hop_length=hop or n_fft // 2)
    if kind == "fixture":
        waves = decode_wire(torch.from_numpy(np.load("fixtures/example1.npz")["waves"][:3]))
    else:
        w = (rng.standard_normal((2, 40 * n_fft)) * 0.1).astype(np.float32)
        w[1, 20 * n_fft:] = 0.0
        waves = torch.from_numpy(w)
    frames = frame_signal(waves, cfg.n_fft, cfg.hop_length, cfg.center)
    return cfg, frames.reshape(-1, n_fft).contiguous(), _operands(astuple(cfg), "cpu")


# (kind, n_fft, sample rate, n_mels): the flagship's 48 kHz at 1024, 16 kHz
# at 512, 8 kHz at 64 with 16 filters
CASES = [("fixture", 1024, 48000, 80), ("synthetic", 1024, 48000, 80),
         ("synthetic", 512, 16000, 80), ("synthetic", 64, 8000, 16)]


@pytest.mark.parametrize("kind,n_fft,sr,n_mels", CASES)
def test_fft_order_matches_plain(kind, n_fft, sr, n_mels, rng):
    cfg, frames, ops = _features(kind, rng, n_fft, sr, n_mels)
    got = _emulate_fft(frames, *ops, cfg.amin)
    ref = fbank_frames_plain(frames, *ops, cfg.amin, "highest")
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    silent = (frames == 0).all(1)
    if kind == "synthetic":  # the silent tail: exactly the log floor
        assert bool(silent.any())
        assert bool((got[silent] == -100.0).all())


@pytest.mark.parametrize("kind,n_fft,sr,n_mels", CASES[:2] + CASES[3:])
def test_fft_order_matches_pallas_interpret(kind, n_fft, sr, n_mels, rng):
    """The emulation against the JAX package's Pallas kernel (interpret
    mode) on the same frames and operands."""
    cfg, frames, ops = _features(kind, rng, n_fft, sr, n_mels)
    jcfg = JaxFeatureConfig(sample_rate=sr, n_fft=n_fft, win_length=n_fft, n_mels=n_mels,
                            hop_length=cfg.hop_length)
    jops = jax_operands(_cfg_key(jcfg))
    for mine, theirs in zip(ops, (jops.window, jops.cos, jops.sin, jops.mel)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    ref = np.asarray(fbank_frames_pallas(frames.numpy(), jops.window, jops.cos, jops.sin,
                                         jops.mel, jcfg.amin))
    got = _emulate_fft(frames, *ops, cfg.amin)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def _wavefronts(addr: torch.Tensor) -> int:
    """Shared-memory wavefronts of a warp's 8-byte accesses, per half-warp
    (lanes 0-15, 16-31): distinct float2 words on one of 16 bank pairs."""
    worst = 1
    for half in addr[:32].split(16):
        for bank in range(16):
            worst = max(worst, len(set(half[half % 16 == bank].tolist())))
    return worst


@pytest.mark.parametrize("log2m", [8, 9, 10, 11, 12])
def test_fft_layout_spreads_shared_memory_banks(log2m):
    """The kernel's shared addresses at n_fft 512-8192 (a half-warp inside
    one frame), padded by `_fft_pad`: every pass's writes and reads of the
    points, the natural-order write after the last and every stage's
    twiddle reads take one wavefront a half-warp, but for the points of
    n_fft 512's second pass (two: around its 3-bit field, lanes 2 and 4
    land on one bank pair); the split's reads of Z[k] and Z[M - k] at most
    two."""
    m = 1 << log2m
    groups = _fft_groups(log2m)
    for g, (lo, bits) in enumerate(groups):
        base, part = _layout(log2m, g, lo, bits)
        idx = base + part
        for j in range(16):
            assert _wavefronts(_fft_pad_t(idx[:, j])) == (2 if (log2m, g) == (8, 1) else 1)
            if g + 1 == len(groups):
                assert _wavefronts(_fft_pad_t(_brev(idx[:, j], log2m))) == 1
        for q in range(bits):
            b = lo + q
            for j0 in range(16):
                if b and not j0 & (1 << q):
                    e = (idx[:, j0] & ((1 << b) - 1)) << (log2m - b)
                    assert _wavefronts(_fft_pad_t(e)) == 1, (g, q, j0)
    k = torch.arange(m // 16)[:, None] + torch.arange(16)[None, :] * (m // 16)
    for c in range(16):
        assert _wavefronts(_fft_pad_t(k[:, c])) == 1
        assert _wavefronts(_fft_pad_t((m - k[:, c]) & (m - 1))) <= 2


def test_fft_order_with_a_dense_mel(rng):
    """A mel matrix with no zero entry: every band is every bin."""
    cfg, frames, (window, cos, sin, _) = _features("synthetic", rng, 512, 16000, 40)
    mel = torch.from_numpy(rng.uniform(0.01, 1.0, (257, 40)).astype(np.float32))
    got = _emulate_fft(frames, window, cos, sin, mel, cfg.amin)
    ref = fbank_frames_plain(frames, window, cos, sin, mel, cfg.amin, "highest")
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows", [1, 15, 16, 17, 37, 4112, 9216])
@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_fbank_fft_plan_covers_every_row_once(rows, n_fft):
    plan = _fbank_fft_plan(rows, n_fft, n_fft // 2 + 1, 80, N_SM)
    assert plan["route"] == "fbank_fft"
    f, t = plan["frames_per_block"], plan["threads_per_frame"]
    m = n_fft // 2
    assert plan["log2m"] == m.bit_length() - 1 and plan["points"] == m
    assert t * plan["points_per_thread"] == m and plan["threads"] == f * t
    assert f in FFT_FRAMES and plan["threads"] % 32 == 0
    assert plan["threads"] <= FFT_MAX_THREADS
    assert plan["blocks"] == _cdiv(rows, f)  # block b: frames b F .. b F + F - 1
    assert (plan["blocks"] - 1) * f < rows <= plan["blocks"] * f
    assert sum(bits for _, bits in plan["passes"]) == plan["log2m"]
    assert [lo + bits for lo, bits in plan["passes"][1:]] == [lo for lo, _ in plan["passes"][:-1]]
    assert plan["passes"][-1][0] == 0 and all(2 <= bits <= 4 for _, bits in plan["passes"])
    assert plan["smem"] == sum(plan["smem_parts"].values()) <= FBANK_SMEM
    assert plan["smem_parts"] == _fft_smem(plan["log2m"], f, 80)
    # the points' padded indices stay inside a frame's part
    assert plan["smem_parts"]["points"] >= 8 * f * (_fft_pad(m - 1) + 1)
    assert plan["smem_parts"]["twiddles"] >= 8 * (_fft_pad(m) + 1)
    assert plan["waves"] == _cdiv(plan["blocks"], N_SM * plan["blocks_per_sm"])


def test_fbank_fft_plan_at_the_serving_shape():
    """The serving requests' 4,112 frames at n_fft 1024, 80 filters, on 132
    SMs: 512 points a frame, 32 threads (one warp) a frame, passes of 3, 4
    and 2 bits; 32 frames a block (129 blocks, one an SM, one wave: every
    smaller block shape takes two waves or more blocks on an SM), 211,876
    bytes of shared memory."""
    plan = _fbank_fft_plan(4112, 1024, 513, 80, N_SM)
    assert plan["route"] == "fbank_fft"
    assert (plan["points"], plan["threads_per_frame"], plan["passes"]) == (
        512, 32, [(6, 3), (2, 4), (0, 2)])
    assert (plan["frames_per_block"], plan["threads"], plan["blocks"]) == (32, 1024, 129)
    assert (plan["blocks_per_sm"], plan["waves"], plan["smem"]) == (1, 1, 211_876)
    assert plan["smem_parts"] == {"twiddles": 4_384, "points": 139_776, "power": 67_716}


@pytest.mark.parametrize("n_fft,n_freq", [(400, 201), (130, 66), (1024, 400), (32, 17)])
def test_fbank_fft_plan_sends_other_shapes_to_the_dense_kernel(n_fft, n_freq):
    plan = _fbank_fft_plan(4112, n_fft, n_freq, 80, N_SM)
    assert plan == {"route": "fbank_fp32", "frames_per_block": 16, "blocks": 257}


def test_fbank_fft_plan_refuses_what_shared_memory_cannot_hold():
    """n_fft 32,768: a frame's 16,384 complex points and the twiddles alone
    are ~280 KB, past a block's 227 KB. 16,384 still fits, a frame a block."""
    with pytest.raises(ValueError, match="shared memory"):
        _fbank_fft_plan(10, 32768, 16385, 80, N_SM)
    assert _fbank_fft_plan(10, 16384, 8193, 80, N_SM)["frames_per_block"] == 1


def _db_errors():
    """Max dB error of the FFT emulation and of the dense plain version
    against a float64 DFT of the same fp32 frames and operands."""
    rng = np.random.default_rng(0)
    for kind, n_fft, sr, n_mels in CASES:
        cfg, frames, ops = _features(kind, rng, n_fft, sr, n_mels)
        window, cos, sin, mel = (x.double() for x in ops)
        fw = frames.double() * window
        ref = 10.0 * torch.log10(torch.clamp(((fw @ cos) ** 2 + (fw @ sin) ** 2) @ mel,
                                             min=cfg.amin))
        fft = (_emulate_fft(frames, *ops, cfg.amin).double() - ref).abs().max()
        dense = (fbank_frames_plain(frames, *ops, cfg.amin).double() - ref).abs().max()
        print(f"{kind} n_fft {n_fft} ({frames.shape[0]} frames, {n_mels} filters): max dB "
              f"error against a float64 DFT: FFT order {float(fft):.3g}, dense plain "
              f"{float(dense):.3g}")


if __name__ == "__main__":
    _db_errors()
