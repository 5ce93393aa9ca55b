"""The bf16 fbank route's tiling (`_fbank_plan`, plain Python) and a
plain-PyTorch emulation of its operand pack and chunked bin loop, on the CPU.

On the card the "default" route (csrc/fbank.cu) packs cos/sin into one bf16
basis whose 64 columns a chunk hold the cos of 8 bins, then their sin, for
4 groups of 8 bins; it walks the bins in chunks of 32 and adds each chunk's
power . mel product into the output in chunk order. The emulation follows
that layout and order with the plan's padded sizes (bf16 operands in fp32
products) and is held against `fbank_frames_plain(..., "default")` at 4e-2
dB: fp32 sums in another order can move a power bin across a bf16 rounding
edge, one bf16 ulp, 10*log10(1 + 2**-7) = 0.034 dB. The plan: shared
memory within a block's limit, every row and bin covered once, the padded
sizes at the serving, bench.py, trainer and 16 kHz shapes.
"""

from dataclasses import astuple

import numpy as np
import pytest
import torch

from tpuasr_torch.audio.fbank import _operands
from tpuasr_torch.config import FeatureConfig
from tpuasr_torch.ops import LAUNCHES, _build
from tpuasr_torch.ops.fbank import (
    FBANK_SMEM, FBANK_TILES, _fbank_plan, _round_bf16, fbank_frames_plain,
)

torch.set_num_threads(1)


def _cdiv(a, b):
    return -(-a // b)


# rows, n_fft, sample rate, n_mels: the fixture requests (serving, 4,112
# frames), bench.py's batch (12 x 768), the trainer's buckets (12 x 256 and
# 12 x 512), 16 kHz (n_fft 512 and 400), a ragged tile, 160 filters
SHAPES = [(4112, 1024, 48000, 80), (9216, 1024, 48000, 80), (3072, 1024, 48000, 80),
          (6144, 1024, 48000, 80), (300, 512, 16000, 80), (65, 400, 16000, 80),
          (1, 130, 8000, 40), (70, 512, 16000, 160)]


@pytest.mark.parametrize("rows,n_fft,sr,n_mels", SHAPES)
def test_fbank_plan_covers_every_row_and_bin_once(rows, n_fft, sr, n_mels):
    n_freq, n_sm = n_fft // 2 + 1, 132
    plan = _fbank_plan(rows, n_fft, n_freq, n_mels, n_sm)
    br, kt = plan["frames_per_block"], plan["k_tile"]
    rm, wm, wn = plan["tiles"]
    assert plan["tiles"] in FBANK_TILES and plan["warps"] == wm * wn
    assert br == 16 * rm * wm and plan["smem"] <= FBANK_SMEM
    assert plan["k_pad"] % kt == 0 and n_fft <= plan["k_pad"] < n_fft + kt
    chunk = plan["bin_chunk"]
    assert plan["n_chunks"] == _cdiv(n_freq, chunk)
    assert plan["n_freq_pad"] % 16 == 0 and n_freq <= plan["n_freq_pad"] < n_freq + 16
    assert plan["half_last"] == int(plan["n_freq_pad"] < plan["n_chunks"] * chunk)
    assert plan["mel_slab"] == 80
    assert plan["n_mels_pad"] == plan["n_slabs"] * plan["mel_slab"] >= n_mels
    assert plan["n_mels_pad"] - n_mels < plan["mel_slab"]
    assert plan["blocks"] == _cdiv(rows, br) * plan["n_slabs"]
    hits = np.zeros((rows, plan["n_mels_pad"]), np.int64)  # (frame, mel column) per block
    for bx in range(_cdiv(rows, br)):
        for by in range(plan["n_slabs"]):
            hits[bx * br:(bx + 1) * br, by * plan["mel_slab"]:(by + 1) * plan["mel_slab"]] += 1
    assert (hits == 1).all()
    # a chunk's 64 columns: 8 cos, 8 sin, x 4; the last chunk's second half
    # skipped where the bins computed end at its first
    n_chunks = plan["n_chunks"]
    bins = np.zeros(n_chunks * chunk, np.int64)
    for ch in range(n_chunks):
        half = ch == n_chunks - 1 and plan["half_last"]
        for c in range(chunk if half else 2 * chunk):
            bins[ch * chunk + (c // 16) * 8 + c % 8] += 1
    assert (bins[:n_freq] == 2).all()  # each bin once as cos, once as sin
    assert plan["n_freq_pad"] == int((bins > 0).sum())
    assert plan["ws"] == {"basis": _cdiv(2 * n_chunks * plan["k_pad"] * 64, 256) * 256,
                          "mel": _cdiv(2 * n_chunks * chunk * plan["n_mels_pad"], 256) * 256}
    assert plan["ws_bytes"] == sum(plan["ws"].values())
    assert plan["waves"] == _cdiv(plan["blocks"], n_sm * plan["blocks_per_sm"])


def test_fbank_plan_at_the_bench_and_serving_shapes():
    """bench.py's 9,216 frames at n_fft 1024, 80 filters on 132 SMs: K 1024,
    528 bins computed (17 chunks, the last one's second half skipped), 80
    mel columns; 80 frames and 4 warps a block (116 blocks, one round: 80 +
    64 against 32-frame blocks' 3 x (32 + 64)), 219,648 bytes of shared
    memory; 2.3 MB of scratch. The serving requests' 4,112 frames and the
    trainer's 3,072: blocks of 32 (129 and 96, one round each)."""
    plan = _fbank_plan(9216, 1024, 513, 80, 132)
    assert (plan["k_pad"], plan["n_freq_pad"], plan["n_mels_pad"]) == (1024, 528, 80)
    assert (plan["tiles"], plan["warps"], plan["blocks"]) == ((5, 1, 4), 4, 116)
    assert (plan["smem"], plan["blocks_per_sm"], plan["waves"]) == (219_648, 1, 1)
    assert plan["ws"] == {"basis": 2_228_224, "mel": 87_040}
    assert plan["dft_flops"] == 116 * 80 * (4 * 1024 * 528 + 2 * 528 * 80)  # padded rows
    for rows, blocks in ((4112, 129), (3072, 96)):
        small = _fbank_plan(rows, 1024, 513, 80, 132)
        assert (small["tiles"], small["blocks"], small["smem"]) == ((2, 1, 4), blocks, 116_736)


def test_fbank_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        _fbank_plan(100, 8192, 4097, 80, 132)


def test_fbank_launch_counts_each_route():
    """fbank's entry point counts each of its three routes (the dense
    fp32 kernel, the bf16 tensor-core route, the fp32 FFT) beside its own
    count, and a launch names its route (checked before any library is
    loaded)."""
    assert {"fbank", "fbank_fp32", "fbank_tc", "fbank_fft"} <= set(LAUNCHES)
    assert _build.ROUTES["fbank"] == ("fbank_fp32", "fbank_tc", "fbank_fft")
    before = dict(LAUNCHES)
    for name, route in (("fbank", None), ("fbank", "fbank"), ("ffn_fwd", "fbank_tc"),
                        ("ffn_fwd", "fbank_fft")):
        with pytest.raises(ValueError, match="route"):
            _build.launch(name, route=route)
    assert LAUNCHES == before


def _emulate(frames, window, cos, sin, mel, amin, plan):
    """The bf16 route's pack and chunk loop in plain PyTorch (bf16 values in
    fp32 products), adding each chunk's mel product in chunk order."""
    rows, n_fft = frames.shape
    n_freq, n_mels = mel.shape
    k_pad, m_pad, nb = plan["k_pad"], plan["n_mels_pad"], plan["bin_chunk"]
    f_pad = plan["n_chunks"] * nb
    c, s = torch.zeros(k_pad, f_pad), torch.zeros(k_pad, f_pad)
    c[:n_fft, :n_freq], s[:n_fft, :n_freq] = cos, sin
    col = torch.arange(2 * nb)
    bin_of = (col // 16) * 8 + col % 8  # the column's bin in its chunk
    basis = _round_bf16(torch.stack([torch.where(col % 16 >= 8, s[:, ch * nb + bin_of],
                                                 c[:, ch * nb + bin_of])
                                     for ch in range(f_pad // nb)]))  # [chunks, k_pad, 64]
    melp = torch.zeros(f_pad, m_pad)
    melp[:n_freq, :n_mels] = mel
    melp = _round_bf16(melp)
    fw = torch.zeros(rows, k_pad)
    fw[:, :n_fft] = _round_bf16(frames * window)
    acc = torch.zeros(rows, m_pad)
    for ch in range(f_pad // nb):
        x = (fw @ basis[ch]).view(rows, 4, 2, 8)  # [group, cos | sin, bin]
        re, im = x[:, :, 0].reshape(rows, nb), x[:, :, 1].reshape(rows, nb)
        acc += _round_bf16(re * re + im * im) @ melp[ch * nb:(ch + 1) * nb]
    total = acc
    return 10.0 * torch.log10(torch.clamp(total[:, :n_mels], min=amin))


@pytest.mark.parametrize("rows,n_fft,sr,n_mels", [(37, 1024, 48000, 80), (9, 400, 16000, 80),
                                                  (5, 130, 8000, 40), (6, 512, 16000, 160)])
def test_packed_chunk_loop_matches_plain(rows, n_fft, sr, n_mels):
    cfg = FeatureConfig(sample_rate=sr, n_fft=n_fft, win_length=n_fft, n_mels=n_mels)
    ops = _operands(astuple(cfg), "cpu")
    r = np.random.default_rng(rows)
    frames = torch.from_numpy((0.1 * r.standard_normal((rows, n_fft))).astype(np.float32))
    frames[1] = 0.0  # a silent frame sits at the log floor
    plan = _fbank_plan(rows, n_fft, n_fft // 2 + 1, n_mels, 132)
    got = _emulate(frames, *ops, cfg.amin, plan)
    ref = fbank_frames_plain(frames, *ops, cfg.amin, "default")
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 4e-2
    assert bool((got[1] == -100.0).all())
