"""Log-mel fbank over framed audio: the hand-written CUDA kernels
(``csrc/fbank.cu``) and their plain PyTorch version.

Counterpart of ``tpuasr/ops/fbank_pallas.py`` (`fbank_frames_pallas`). The
wrapper runs a kernel for tensors on the card and the plain version for
tensors on the CPU; a CUDA tensor never takes the plain path.

Two routes on the card behind one entry point, each with a launch count of
its own beside the entry's ("fbank_fp32" and "fbank_tc" in `LAUNCHES`):
- "highest" (exact fp32, serving's default): a CUDA-core kernel, a
  thread per bin over tiles of 16 frames, bound by fp32 operations.
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
    bf16 = precision == "default"
    # the bf16 route's scratch parts (packed basis and mel, written by the
    # entry's pack kernel) and the plan's layout: k_pad, chunks, half_last,
    # mel columns, shared memory, the block's shape
    basis = melp = None
    layout = (0,) * 8
    if bf16:
        plan = _fbank_plan(rows, n_fft, n_freq, n_mels, _sm_count(frames.device.index))
        ws = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=frames.device)
        basis, melp = ws.data_ptr(), ws.data_ptr() + plan["ws"]["basis"]
        layout = (plan["k_pad"], plan["n_chunks"], plan["half_last"], plan["n_mels_pad"],
                  plan["smem"], *plan["tiles"])
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("fbank", frames.data_ptr(), window.data_ptr(), cos.data_ptr(),
                      sin.data_ptr(), mel.data_ptr(), out.data_ptr(), basis, melp, rows, n_fft,
                      n_freq, n_mels, float(amin), int(bf16), *layout, stream,
                      route="fbank_tc" if bf16 else "fbank_fp32")
    return out
