"""Log-mel fbank over framed audio: the hand-written CUDA kernels
(``csrc/fbank.cu``) and their plain PyTorch version.

Counterpart of ``tpuasr/ops/fbank_pallas.py`` (`fbank_frames_pallas`). The
wrapper runs a kernel for tensors on the card and the plain version for
tensors on the CPU; a CUDA tensor never takes the plain path.

Three routes on the card behind one entry point, each with a launch count
of its own beside the entry's ("fbank_fft", "fbank_fp32" and "fbank_tc" in
`LAUNCHES`):
- "highest" (exact fp32, serving's default) at an n_fft that is a power of
  two (from 64): an fp32 FFT in shared memory and registers on the CUDA
  cores, a frame per group of threads. A band kernel first finds each mel
  filter's first and last nonzero bin; the FFT kernel then windows the
  frames, takes one n_fft / 2-point complex FFT of each (radix-2 stages in
  registers, the passes between them through padded shared memory, the
  twiddles read from row 1 of the cos/sin basis), splits it into the real
  spectrum's power and walks each filter's band. `_fbank_fft_plan` picks the
  route by shape and owns this layout (frames and threads a block, passes,
  shared bytes); the wrapper passes it to the entry.
- "highest" at any other n_fft: the dense CUDA-core kernel, a thread per bin
  over tiles of 16 frames and the DFT as two dense products.
- "default" (bf16 operands, fp32 sums, what training runs): the DFT and the
  mel product as two chained bf16 `mma.sync` products in one block. A pack
  kernel first lays cos/sin out as one bf16 basis and mel as bf16, zero
  padded (into scratch the wrapper allocates); then each block keeps its
  windowed frames in shared memory and streams the basis tile by tile, the
  power of each chunk of 32 bins going through shared memory into the mel
  product. `_fbank_plan` owns that layout: it pads the sizes, sizes the
  scratch and the shared memory and picks the block's shape, and the
  wrapper passes all of it to the entry.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops import _build
from tpuasr_torch.ops.ffn import _sm_count

PRECISIONS = ("highest", "default")

FBANK_K_TILE = 128  # frame samples a stage of the bf16 route
FBANK_BIN_CHUNK = 32  # bins a chunk: 64 basis columns (cos and sin)
FBANK_STAGES = 2  # basis tiles in the cp.async ring
FBANK_MEL_SLAB = 80  # mel columns a slab: a grid row of blocks of its own
# a block's shape: (row groups of 16 frames a warp, warps over the frames,
# warps over a chunk's 4 bin groups); both 4 warps, one a sub-partition of
# the SM, each over all the block's frames and 8 bins of a chunk: 32 and 80
# frames (the fastest at 4,112 and at 9,216 frames of the shapes tried on an
# H100; chip_smoke.py phase 3 times both at both sizes)
FBANK_TILES = ((2, 1, 4), (5, 1, 4))
# a block takes about as long as (FBANK_BLOCK_FIXED + its frames) frames
# would at a fixed rate (a block's stages cost time whatever its frames;
# fitted to phase 3's times of both shapes at 4,112 and 9,216 frames)
FBANK_BLOCK_FIXED = 64
FBANK_SMEM = 232_448  # shared memory a block may use on an H100
FBANK_SM_SMEM = 233_472  # an SM's, of which each resident block reserves 1 KB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align(n: int) -> int:
    return _cdiv(n, 256) * 256


def _fbank_plan(rows: int, n_fft: int, n_freq: int, n_mels: int, n_sm: int,
                tiles: tuple[int, int, int] | None = None) -> dict:
    """How the bf16 route ("default") lays out and tiles its work on a
    card of `n_sm` SMs; the one owner of that layout, which the wrapper
    passes to csrc/fbank.cu's entry.

    K (frame samples) is padded to the 128-deep K tile; bins to chunks of
    32, of which the kernel computes the first n_freq rounded up to 16 (the
    last chunk's second half is skipped when it is all padding: "half_last");
    mel columns to slabs of 80, each slab a grid row of its own that repeats
    the DFT. A block's frames sit in shared
    memory as bf16 beside two 128 x 64 basis tiles, two chunks of mel rows
    and a chunk's power. Of the block shapes in FBANK_TILES (or the one
    given) whose shared memory fits, it takes the least time on the busiest
    SM, as blocks there x (FBANK_BLOCK_FIXED + frames a block), then the
    fewest blocks (each reads the whole basis from L2). Raises ValueError if
    none fits.
    -> {"tiles" (row groups a warp, warps over the frames, warps over the
    bins), "warps", "frames_per_block", "k_tile", "k_pad", "bin_chunk",
    "n_chunks", "n_freq_pad" (bins computed), "half_last", "mel_slab", "n_slabs",
    "n_mels_pad", "smem", "blocks", "blocks_per_sm", "waves", "ws" (bytes:
    basis [n_chunks][k_pad][64] and mel [32 n_chunks][n_mels_pad], bf16,
    256-byte aligned), "ws_bytes", "dft_flops" (the padded dense products
    this design does)}."""
    k_pad = _cdiv(n_fft, FBANK_K_TILE) * FBANK_K_TILE
    n_chunks = _cdiv(n_freq, FBANK_BIN_CHUNK)
    freq_pad = _cdiv(n_freq, FBANK_BIN_CHUNK // 2) * FBANK_BIN_CHUNK // 2  # bins computed
    slab = FBANK_MEL_SLAB
    n_slabs = _cdiv(n_mels, slab)
    cands = []
    for rm, wm, wn in FBANK_TILES if tiles is None else (tiles,):
        br = 16 * rm * wm
        # frames, the basis ring, two chunks of mel rows, a chunk's power
        smem = 2 * (br * (k_pad + 8) + FBANK_STAGES * FBANK_K_TILE * (2 * FBANK_BIN_CHUNK + 8)
                    + 2 * FBANK_BIN_CHUNK * (slab + 8) + br * (FBANK_BIN_CHUNK + 8))
        if smem > FBANK_SMEM:
            continue
        blocks = _cdiv(rows, br) * n_slabs
        cands.append((_cdiv(blocks, n_sm) * (FBANK_BLOCK_FIXED + br), blocks, rm, wm, wn, br,
                      smem))
    if not cands:
        raise ValueError(f"fbank: n_fft {n_fft}, {n_freq} bins and {n_mels} mel filters need "
                         f"more than the {FBANK_SMEM} bytes of shared memory a block may use "
                         f"(the bf16 route keeps a block's frames, 32 or more, of "
                         f"n_fft padded to {k_pad} in shared memory)")
    _, blocks, rm, wm, wn, br, smem = min(cands)
    per_sm = FBANK_SM_SMEM // (smem + 1024)
    ws = {"basis": _align(2 * n_chunks * k_pad * 2 * FBANK_BIN_CHUNK),
          "mel": _align(2 * n_chunks * FBANK_BIN_CHUNK * n_slabs * slab)}
    rows_pad = _cdiv(rows, br) * br
    return {"tiles": (rm, wm, wn), "warps": wm * wn, "frames_per_block": br,
            "k_tile": FBANK_K_TILE, "k_pad": k_pad, "bin_chunk": FBANK_BIN_CHUNK,
            "n_chunks": n_chunks, "n_freq_pad": freq_pad,
            "half_last": int(freq_pad < n_chunks * FBANK_BIN_CHUNK), "mel_slab": slab,
            "n_slabs": n_slabs, "n_mels_pad": n_slabs * slab, "smem": smem, "blocks": blocks,
            "blocks_per_sm": per_sm, "waves": _cdiv(blocks, n_sm * per_sm), "ws": ws,
            "ws_bytes": sum(ws.values()),
            "dft_flops": n_slabs * rows_pad * (4 * k_pad * freq_pad + 2 * freq_pad * slab)}


FFT_POINTS = 16  # complex points a thread of the FFT route holds in registers
FFT_MIN_LOG2M = 5  # at least 2**5 complex points a frame (n_fft 64): two passes of 3 and 2 bits
FFT_FRAMES = (1, 2, 4, 8, 16, 32)  # frames a block may take (a lane each in the mel product)
FFT_MAX_THREADS = 1024  # a block's threads
# a block of the FFT route takes about as long as (its frames +
# FFT_BLOCK_FIXED) frames would: each block stages the twiddles (about a
# frame's bytes) and walks the filters; and a second wave of blocks on an
# SM costs more than that (phase 3's times at each count of frames a block
# at 4,112 frames on an H100: 32 and 16 a block, one wave, fastest; 8 to 1,
# two waves, 1.3-1.7x slower)
FFT_BLOCK_FIXED = 1


def _fft_pad(i: int) -> int:
    """A padded shared-memory index of the FFT route (csrc/fbank.cu `fpad`)."""
    return i + (i >> 4) + (i >> 8)


def _fft_groups(log2m: int) -> list[tuple[int, int]]:
    """The FFT route's radix-2 DIF stages grouped into passes, top index bit
    first: [(lowest bit, bits)], 3 bits, then 4s, then the rest, never a
    pass of 1 bit (4 + 4 + ... + 1 go as 3 + 4 + ... + 2). A pass's stages
    run in registers; between passes the points go through shared memory
    (csrc/fbank.cu `group_bits`)."""
    rest = log2m - 3
    sizes = [4] * (rest // 4) + ([rest % 4] if rest % 4 else [])
    if sizes[-1] == 1:
        sizes[0], sizes[-1] = 3, 2
    groups, top = [(log2m - 3, 3)], log2m - 3
    for bits in sizes:
        groups.append((top - bits, bits))
        top -= bits
    return groups


def _fft_smem(log2m: int, frames: int, n_mels: int) -> dict:
    """The FFT route's shared memory in bytes, by part (csrc/fbank.cu
    `fft_smem`): the twiddles, the frames' complex points (then the block's
    log-mel) and the power."""
    m = 1 << log2m
    points, logmel = 8 * frames * _fft_pad(m), 4 * frames * (n_mels | 1)
    return {"twiddles": _cdiv(8 * (_fft_pad(m) + 1), 16) * 16,
            "points": _cdiv(max(points, logmel), 16) * 16,
            "power": 4 * (m + 1) * (frames | 1)}


def _fbank_fft_plan(rows: int, n_fft: int, n_freq: int, n_mels: int, n_sm: int,
                    frames: int | None = None) -> dict:
    """Which kernel precision "highest" runs, and how: the route is chosen by
    shape alone, and this is the one owner of the FFT route's layout, which
    the wrapper passes to csrc/fbank.cu's entry.

    n_fft a power of two from 64 with n_freq = n_fft / 2 + 1 (the real
    DFT's bins) takes the FFT ("fbank_fft"): M = n_fft / 2 complex points a
    frame, FFT_POINTS a thread, so M / 16 threads a frame; the passes of
    `_fft_groups`; F frames a block (FFT_FRAMES) with F x threads a frame
    a whole number of warps and at most 1,024. Of the F whose shared memory
    fits a block (or the one given), it takes the fewest waves (blocks over
    the SMs' resident blocks), then the least time on the busiest SM, as its
    blocks (rounded up over the SMs) x (F + FFT_BLOCK_FIXED), then the
    largest F. Raises ValueError when not even one frame's points and
    twiddles fit a block's shared memory. Any other shape takes the dense
    kernel ("fbank_fp32", 16 frames a block).
    -> {"route", "frames_per_block", "blocks"} and for "fbank_fft" also
    {"log2m", "points", "threads_per_frame", "points_per_thread", "passes"
    (`_fft_groups`), "threads", "smem", "smem_parts", "blocks_per_sm",
    "waves", "fft_flops" (the design's own FFT work: window, radix-2
    butterflies, real split and power)}. The kernel is built for 2**5 to
    2**13 points a frame, all that fit (n_fft 32,768 does not)."""
    log2m = n_fft.bit_length() - 2
    if n_fft & (n_fft - 1) or log2m < FFT_MIN_LOG2M or n_freq != n_fft // 2 + 1:
        return {"route": "fbank_fp32", "frames_per_block": 16, "blocks": _cdiv(rows, 16)}
    threads = (1 << log2m) // FFT_POINTS
    cands = []
    for f in FFT_FRAMES:
        if frames not in (None, f) or not 32 <= f * threads <= FFT_MAX_THREADS:
            continue
        smem = sum(_fft_smem(log2m, f, n_mels).values())
        if smem > FBANK_SMEM:
            continue
        blocks = _cdiv(rows, f)
        per_sm = min(2048 // (f * threads), 32, FBANK_SM_SMEM // (smem + 1024))
        cands.append((_cdiv(blocks, n_sm * per_sm), _cdiv(blocks, n_sm) * (f + FFT_BLOCK_FIXED),
                      -f, blocks, smem, per_sm))
    if not cands:
        raise ValueError(f"fbank: n_fft {n_fft} needs more than the {FBANK_SMEM} bytes of shared "
                         f"memory a block may use (the FFT route keeps a frame's "
                         f"{n_fft // 2} complex points and the twiddles in shared memory)")
    waves, _, neg_f, blocks, smem, per_sm = min(cands)
    f, m = -neg_f, 1 << log2m
    fft_flops = (n_fft + (m // 2) * (4 * log2m + 6 * (log2m - 1)) + 19 * (m + 1))
    return {"route": "fbank_fft", "frames_per_block": f, "blocks": blocks, "log2m": log2m,
            "points": m, "threads_per_frame": threads, "points_per_thread": FFT_POINTS,
            "passes": _fft_groups(log2m), "threads": f * threads, "smem": smem,
            "smem_parts": _fft_smem(log2m, f, n_mels), "blocks_per_sm": per_sm,
            "waves": waves, "fft_flops": rows * fft_flops}


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
    on the frames' device. CPU tensors take the plain version. On the card,
    "highest" at a power-of-two n_fft with n_freq = n_fft / 2 + 1 runs the
    FFT route (`_fbank_fft_plan`), which takes cos/sin to be the DFT basis
    `audio.fbank.dft_matrices` builds (the one `audio/fbank.py:_operands`
    passes): it reads its twiddles from their row 1, cos[1, k] + i sin[1, k]
    = exp(-2 pi i k / n_fft) for k <= n_fft / 2, and no other entry."""
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
    # each route's scratch (the bf16 route's packed basis and mel, the FFT
    # route's filter bands, written by the entry's first kernel) and its
    # plan's layout: k_pad, chunks, half_last, mel columns, shared memory,
    # the bf16 block's shape, the FFT's frames and threads a frame
    basis = melp = band = None
    layout = [0] * 10
    if precision == "default":
        route, code = "fbank_tc", 1
        plan = _fbank_plan(rows, n_fft, n_freq, n_mels, _sm_count(frames.device.index))
        ws = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=frames.device)
        basis, melp = ws.data_ptr(), ws.data_ptr() + plan["ws"]["basis"]
        layout[:8] = (plan["k_pad"], plan["n_chunks"], plan["half_last"], plan["n_mels_pad"],
                      plan["smem"], *plan["tiles"])
    else:
        plan = _fbank_fft_plan(rows, n_fft, n_freq, n_mels, _sm_count(frames.device.index))
        route, code = plan["route"], 0
        if route == "fbank_fft":
            code = 2
            if frames.data_ptr() % 16 or window.data_ptr() % 16:
                raise ValueError("fbank_frames: the FFT route loads frames and window 16 "
                                 "bytes a lane: both must start on a 16-byte boundary")
            scratch = torch.empty(8 * n_mels, dtype=torch.uint8, device=frames.device)
            band = scratch.data_ptr()
            layout[4] = plan["smem"]
            layout[8:] = (plan["frames_per_block"], plan["threads_per_frame"])
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("fbank", frames.data_ptr(), window.data_ptr(), cos.data_ptr(),
                      sin.data_ptr(), mel.data_ptr(), out.data_ptr(), basis, melp, band, rows,
                      n_fft, n_freq, n_mels, float(amin), code, *layout, stream, route=route)
    return out
