"""Fused RNN-T joint + loss: the hand-written CUDA kernels
(``csrc/rnnt_fused.cu``) and their plain PyTorch versions.

Counterparts of ``tpuasr/ops/rnnt_fused_pallas.py``: `rnnt_fused_lp`
replaces `_fused_lp` (`_fused_fwd_kernel`, TPU kernel #4) and
`rnnt_fused_grads` replaces `_fused_grads` (`_fused_bwd_kernel`, #5).
`rnnt_loss_fused_mean` is the `torch.autograd.Function` of `_fused_fwd` /
`_fused_bwd` (:241-293): kernel #4, masking, the alphas, ll and the
feasibility guard forward; the occupancies, gb/gl and kernel #5 backward.
The JAX package runs this lattice outside any kernel, as one compiled
`lax.scan` (`rnnt_fused_pallas.py:29`); here it is the same function through
`tpuasr_torch.ops.rnnt_lattice`: kernels #8/#9 on the card (the eager plain
lattice would be ~2,200 launches per step), the plain lattice on the CPU.

The kernel forward also returns each row's logsumexp, which the backward
reads instead of recomputing it over the vocabulary (the TPU kernel
recomputes the whole softmax). The wrappers run the kernels for tensors on
the card and the plain versions for tensors on the CPU; a CUDA tensor never
takes the plain path. Operands are fp32 (the caller casts, as
`rnnt_fused_pallas.py:139-143` does).

On the card #4 is two kernels behind one entry (csrc/rnnt_fused.cu): W laid
out once in fp32 tiles of 32 vocabulary columns (K zero-padded to 256),
then a block a tile of (frames x label positions) that forms tanh(enc +
pred) once and walks the vocabulary with 3xTF32 tensor-core products,
folding each tile into an online logsumexp: no atomics, so two calls give
the same bits.
`_joint_fwd_plan` chooses the tiles and owns the shared memory and the
scratch sizes; the entry checks them against the card's limit.

#5 is four kernels behind one entry: W split once into TF32 (hi, lo) pairs,
a row side over tiles of (frames x label positions) for d_enc and d_pred, a
vocabulary side over (vocabulary tile x every S-th row tile) for dW and db,
each writing partial sums into a workspace, and a sum that adds the
partials in a fixed order, so two calls on the same inputs give the same
bits. `_joint_bwd_plan` chooses the tiles and sizes the workspace.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuasr_torch.ops import _build
from tpuasr_torch.ops.ffn import _sm_count
from tpuasr_torch.ops.rnnt_lattice import (
    _NEG, mask_lattice_inputs, rnnt_alpha, rnnt_beta_grad,
)

MAX_JOIN_DIM = 256  # the kernels' tiles of a, W and the fragments hold D <= 256
JOINT_ROWS = 64  # rows (t, u) of a row-side block: tt * uc <= 64
JOINT_ROW_VT = 32  # vocabulary columns of a W tile (forward and row side)
JOINT_VOCAB_VT = 64  # vocabulary columns of a vocabulary-side block
JOINT_PART_CAP = 32 << 20  # partial d_enc + d_pred bytes: stay well inside the 50 MB L2
JOINT_STAGE = 8192  # floats for a tile's enc and pred rows: (tt + uc) * D padded to 32
JOINT_FWD_ROWS = 32  # rows (t, u) of a forward block: tt * uc <= 32
JOINT_FWD_PER_SM = 2  # forward blocks an SM holds (96 KB of shared memory, 128 registers)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align(n: int) -> int:
    return _cdiv(n, 256) * 256


def _row_tiles(t: int, u1: int, d: int, rows: int = JOINT_ROWS):
    """The tiles of (frames x label positions) a block may own, both
    directions: for each split of U+1 into n_uc chunks of uc, tt frames
    (tt * uc <= rows, and the tile's tt enc rows and uc pred rows fit the
    JOINT_STAGE floats they are copied into: tt + uc <= 32 at D 256)
    -> (n_uc, uc, tt, n_tc) each."""
    stage_rows = JOINT_STAGE // (32 * _cdiv(d, 32))  # tt + uc at most
    for n_uc in range(1, u1 + 1):
        uc = _cdiv(u1, n_uc)
        if uc > rows or uc >= stage_rows or _cdiv(u1, uc) != n_uc:
            continue
        tt = max(1, min(rows // uc, stage_rows - uc, t))
        yield n_uc, uc, tt, _cdiv(t, tt)


def _joint_fwd_plan(b: int, t: int, u1: int, d: int, v: int, n_sm: int) -> dict:
    """How kernel #4 lays out and tiles its work on a card of `n_sm` SMs
    (JOINT_FWD_PER_SM blocks an SM); the one owner of its shared memory and
    scratch, which the wrapper passes to csrc/rnnt_fused.cu's entry.

    K is zero-padded to MAX_JOIN_DIM whatever D (one kernel, its k-steps
    fixed at compile time). A block owns utterance b's frames t0.. t0+tt-1
    and label positions u0.. u0+uc-1 (`_row_tiles` at D MAX_JOIN_DIM, tt *
    uc <= JOINT_FWD_ROWS), 8 warps of 16 rows each over a quarter of K; grid
    (n_uc, n_tc, B). It takes the split with the fewest waves of blocks, then
    the fewest blocks (each reads all of W from L2). W goes to the blocks as
    fp32 tiles of 32 columns, split into TF32 pairs as each fragment is
    formed. Raises ValueError for D > MAX_JOIN_DIM.
    -> {"tt", "uc", "n_uc", "n_tc", "grid", "blocks", "waves", "vt" (columns
    a W tile), "n_vt", "smem" (bytes a block: two W tiles [MAX_JOIN_DIM, 32],
    two sets of four [32, 32] partial logits), "ws" (bytes, 256-byte aligned:
    w_tiles fp32 [n_vt, MAX_JOIN_DIM, 32]), "ws_bytes", "l2_w_bytes" (W's
    tile bytes times the blocks: what the blocks ask of L2 a call, counted
    from the plan)}."""
    if d > MAX_JOIN_DIM:
        raise ValueError(f"rnnt_fused: join dim {d} > {MAX_JOIN_DIM}")
    slots = n_sm * JOINT_FWD_PER_SM
    _, blocks, n_uc, uc, tt, n_tc = min(
        (_cdiv(b * n_uc * n_tc, slots), b * n_uc * n_tc, n_uc, uc, tt, n_tc)
        for n_uc, uc, tt, n_tc in _row_tiles(t, u1, MAX_JOIN_DIM, JOINT_FWD_ROWS))
    n_vt = _cdiv(v, JOINT_ROW_VT)
    w_bytes = 4 * n_vt * MAX_JOIN_DIM * JOINT_ROW_VT
    smem = 4 * (2 * MAX_JOIN_DIM * JOINT_ROW_VT + 2 * 4 * JOINT_FWD_ROWS * JOINT_ROW_VT)
    ws = {"w_tiles": _align(w_bytes)}
    return {"tt": tt, "uc": uc, "n_uc": n_uc, "n_tc": n_tc, "grid": (n_uc, n_tc, b),
            "blocks": blocks, "waves": _cdiv(blocks, slots), "vt": JOINT_ROW_VT, "n_vt": n_vt,
            "smem": smem, "ws": ws, "ws_bytes": sum(ws.values()),
            "l2_w_bytes": blocks * w_bytes}


def _joint_bwd_plan(b: int, t: int, u1: int, d: int, v: int, n_sm: int) -> dict:
    """How kernel #5 tiles its work on a card of `n_sm` SMs (every block of
    each side takes one SM: 224 KB of shared memory at D 256).

    Row side: a block owns utterance b's frames t0.. t0+tt-1 and label
    positions u0.. u0+uc-1 (tt * uc <= 64 rows, and its tt enc rows and uc
    pred rows fit the JOINT_STAGE floats both sides copy them into: tt + uc
    <= 32 at D 256); grid (n_uc, n_tc, B). Of the splits of U+1 into n_uc
    chunks it takes the one with the fewest waves of blocks, then the least
    partial-sum workspace, among those whose partials stay under
    JOINT_PART_CAP (the least workspace if none does).
    Vocabulary side: a block owns JOINT_VOCAB_VT columns and every S-th
    row-side tile from its index s (tiles in the order b, t-chunk, u-chunk),
    so a step reads tt enc rows and uc pred rows, not 64 of each, and the
    tiles skipped for having no gradient (padding) spread evenly; S as many
    as fill the card in one wave with the n_vt vocabulary tiles, at most
    one a tile.
    -> {"tt", "uc", "n_uc", "n_tc", "row_grid", "row_vt", "n_vt", "vocab_vt",
    "S", "vocab_grid", "ws" (bytes of each part, 256-byte aligned, in
    order: enc_part [B, n_uc, T, D], pred_part [B, n_tc, U+1, D], dw_part
    [S, D, V], db_part [S, V] fp32, w_split: W as TF32 (hi, lo) pairs in the
    row side's tiles, [V/32, D padded to 32, 32]), "ws_bytes"}."""
    cands = []
    for n_uc, uc, tt, n_tc in _row_tiles(t, u1, d):
        part = 4 * d * (b * n_uc * t + b * n_tc * u1)
        waves = _cdiv(b * n_uc * n_tc, n_sm)
        cands.append((part > JOINT_PART_CAP, waves, part, n_uc, uc, tt, n_tc))
    _, _, _, n_uc, uc, tt, n_tc = min(cands)
    n_tiles = b * n_uc * n_tc
    n_vt = _cdiv(v, JOINT_VOCAB_VT)
    s = max(1, min(n_sm // n_vt, n_tiles))
    ws = {"enc_part": _align(4 * b * n_uc * t * d), "pred_part": _align(4 * b * n_tc * u1 * d),
          "dw_part": _align(4 * s * d * v), "db_part": _align(4 * s * v),
          "w_split": _align(8 * _cdiv(v, JOINT_ROW_VT) * 32 * _cdiv(d, 32) * JOINT_ROW_VT)}
    return {"tt": tt, "uc": uc, "n_uc": n_uc, "n_tc": n_tc, "row_grid": (n_uc, n_tc, b),
            "row_vt": JOINT_ROW_VT, "n_vt": n_vt, "vocab_vt": JOINT_VOCAB_VT, "S": s,
            "vocab_grid": (n_vt, s), "ws": ws, "ws_bytes": sum(ws.values())}


def _label_ids(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, U] -> [B, U+1]: column u's label, the blank for the last column."""
    return F.pad(labels.long(), (0, 1), value=blank)


def _joint(enc_p, pred_p, w, b):
    a = torch.tanh(enc_p[:, :, None, :] + pred_p[:, None, :, :])  # [B, T, U1, D]
    return a, a @ w + b  # logits [B, T, U1, V]


def rnnt_fused_lp_plain(enc_p, pred_p, w, b, labels, blank: int):
    """-> (blank_lp, label_lp, lse), each [B, T, U+1]: log-softmax of the
    joint's logits at the blank and at column u's label (the blank for the
    last column; 0 - lse for an id outside [0, V), as the one-hot of the TPU
    kernel gives), and the logsumexp. Materialises [B, T, U+1, V]."""
    _, x = _joint(enc_p, pred_p, w, b)
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    lab = _label_ids(labels, blank)
    ok = (lab >= 0) & (lab < v)
    label_x = x.gather(3, lab.clamp(0, v - 1)[:, None, :, None]
                       .expand(x.shape[0], x.shape[1], -1, 1))[..., 0]
    label_x = torch.where(ok[:, None, :], label_x, torch.zeros((), dtype=x.dtype, device=x.device))
    return x[..., blank] - lse, label_x - lse, lse


def rnnt_fused_grads_plain(enc_p, pred_p, w, b, labels, lse, gb, gl, blank: int):
    """-> (d_enc [B, T, D], d_pred [B, U+1, D], dW [D, V], db [V]) for the
    upstream gradients gb, gl [B, T, U+1] of blank_lp and label_lp:
    dX = gb·1[blank] + gl·1[label] − softmax·(gb + gl), da = dX·Wᵀ,
    djoined = da·(1 − a²). Materialises [B, T, U+1, V]."""
    a, x = _joint(enc_p, pred_p, w, b)
    v = x.shape[-1]
    dx = -torch.exp(x - lse[..., None]) * (gb + gl)[..., None]
    dx[..., blank] += gb
    lab = _label_ids(labels, blank)
    ok = ((lab >= 0) & (lab < v))[:, None, :]
    idx = lab.clamp(0, v - 1)[:, None, :, None].expand(x.shape[0], x.shape[1], -1, 1)
    dx = dx.scatter_add(3, idx, torch.where(ok, gl, torch.zeros_like(gl))[..., None])
    dj = (dx @ w.T) * (1.0 - a * a)
    return (dj.sum(2), dj.sum(1), torch.einsum("btud,btuv->dv", a, dx), dx.sum((0, 1, 2)))


def _check(enc_p, pred_p, w, b, labels, extra=()):
    if enc_p.device.type != "cuda":
        raise ValueError(f"rnnt_fused: unsupported device {enc_p.device}")
    bsz, t, d = enc_p.shape
    u1, v = pred_p.shape[1], w.shape[1]
    expect = {"enc_p": (bsz, t, d), "pred_p": (bsz, u1, d), "w": (d, v), "b": (v,),
              "labels": (bsz, u1 - 1)}
    named = {"enc_p": enc_p, "pred_p": pred_p, "w": w, "b": b, "labels": labels,
             **{name: x for name, x in extra}}
    for name, x in named.items():
        shape = expect.get(name, (bsz, t, u1))
        dtype = torch.int32 if name == "labels" else torch.float32
        if x.device != enc_p.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"rnnt_fused: {name} must be a contiguous {dtype} tensor on "
                             f"{enc_p.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"rnnt_fused: {name} shape {tuple(x.shape)}, expected {shape}")
    return bsz, t, u1, d, v


def rnnt_fused_lp(enc_p, pred_p, w, b, labels, blank: int):
    """Kernel #4: -> (blank_lp, label_lp, lse) [B, T, U+1] fp32. enc_p
    [B, T, D], pred_p [B, U+1, D], w [D, V], b [V] fp32; labels [B, U]
    int32 on the card (D <= MAX_JOIN_DIM). CPU tensors take the plain
    version."""
    if enc_p.device.type == "cpu":
        return rnnt_fused_lp_plain(enc_p, pred_p, w, b, labels, blank)
    bsz, t, u1, d, v = _check(enc_p, pred_p, w, b, labels)
    if not 0 <= blank < v:
        raise ValueError(f"rnnt_fused: blank {blank} outside [0, {v})")
    if d > MAX_JOIN_DIM:
        raise ValueError(f"rnnt_fused: join dim {d} > {MAX_JOIN_DIM}")
    dev = enc_p.device
    outs = [torch.empty((bsz, t, u1), dtype=torch.float32, device=dev) for _ in range(3)]
    if bsz and t and u1:
        plan = _joint_fwd_plan(bsz, t, u1, d, v, _sm_count(dev.index))
        ws = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("rnnt_fused_fwd", enc_p.data_ptr(), pred_p.data_ptr(), w.data_ptr(),
                          b.data_ptr(), labels.data_ptr(), *(o.data_ptr() for o in outs),
                          ws.data_ptr(), ws.numel(), bsz, t, u1, d, v, blank, plan["tt"],
                          plan["uc"], plan["smem"], stream)
    return tuple(outs)


def rnnt_fused_grads(enc_p, pred_p, w, b, labels, lse, gb, gl, blank: int):
    """Kernel #5: -> (d_enc [B, T, D], d_pred [B, U+1, D], dW [D, V],
    db [V]) fp32. lse from kernel #4; gb, gl [B, T, U+1] fp32 (gl's last
    column 0). CPU tensors take the plain version."""
    if enc_p.device.type == "cpu":
        return rnnt_fused_grads_plain(enc_p, pred_p, w, b, labels, lse, gb, gl, blank)
    bsz, t, u1, d, v = _check(enc_p, pred_p, w, b, labels,
                              (("lse", lse), ("gb", gb), ("gl", gl)))
    if not 0 <= blank < v:
        raise ValueError(f"rnnt_fused: blank {blank} outside [0, {v})")
    if d > MAX_JOIN_DIM:
        raise ValueError(f"rnnt_fused: join dim {d} > {MAX_JOIN_DIM}")
    dev = enc_p.device
    shapes = ((bsz, t, d), (bsz, u1, d), (d, v), (v,))
    if not (bsz and t and u1):  # sums over no rows
        return tuple(torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes)
    # the kernels write every output once, each sum across blocks in a fixed order
    outs = [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]
    plan = _joint_bwd_plan(bsz, t, u1, d, v, _sm_count(dev.index))
    ws = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("rnnt_fused_bwd", enc_p.data_ptr(), pred_p.data_ptr(), w.data_ptr(),
                      b.data_ptr(), labels.data_ptr(), lse.data_ptr(), gb.data_ptr(),
                      gl.data_ptr(), *(o.data_ptr() for o in outs), ws.data_ptr(), ws.numel(),
                      bsz, t, u1, d, v, blank, plan["tt"], plan["uc"], plan["S"], stream)
    return tuple(outs)


class _RNNTFusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc_p, pred_p, w, b, labels, t_lens, u_lens, blank):
        dtypes = (enc_p.dtype, pred_p.dtype, w.dtype, b.dtype)
        enc, pred, w32, b32 = (x.float().contiguous() for x in (enc_p, pred_p, w, b))
        lab = labels.to(torch.int32).contiguous()
        blank_lp, label_full, lse = rnnt_fused_lp(enc, pred, w32, b32, lab, blank)
        blank_m, label_m, pad_t, label_valid = mask_lattice_inputs(
            blank_lp, label_full[:, :, :-1], t_lens, u_lens)
        ulen = u_lens.to(torch.int32).contiguous()
        alpha, ll = rnnt_alpha(blank_m, label_m, ulen)
        feasible = ll > _NEG / 2
        ctx.save_for_backward(enc, pred, w32, b32, lab, ulen, lse, blank_m, label_m,
                              pad_t, label_valid, alpha, ll, feasible)
        ctx.blank, ctx.dtypes = blank, dtypes
        return torch.where(feasible, -ll, torch.zeros((), dtype=ll.dtype, device=ll.device))

    @staticmethod
    def backward(ctx, g):
        (enc, pred, w32, b32, lab, ulen, lse, blank_m, label_m, pad_t, label_valid, alpha,
         ll, feasible) = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=enc.device)
        g = torch.where(feasible, g.float(), zero).contiguous()
        g_blank, g_label = rnnt_beta_grad(blank_m, label_m, ulen, alpha, ll, g)
        # d(nll)/d(raw lp) = -occupancy on unmasked entries, 0 on padding
        gb = torch.where(pad_t, zero, -g_blank)
        gl = F.pad(torch.where(label_valid, -g_label, zero), (0, 1))
        grads = rnnt_fused_grads(enc, pred, w32, b32, lab, lse, gb.contiguous(),
                                 gl.contiguous(), ctx.blank)
        return (*(gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)), None, None, None, None)


def rnnt_loss_fused_mean(enc_p, pred_p, w, b, labels, t_lens, u_lens,
                         blank: int) -> torch.Tensor:
    """Mean-reduced transducer loss of the tanh additive joint without the
    [B, T, U+1, V] logits: enc_p [B, T, D] and pred_p [B, U+1, D] (the
    pre-join projections), w [D, V], b [V], labels [B, U]."""
    return _RNNTFusedLoss.apply(enc_p, pred_p, w, b, labels, t_lens, u_lens, blank).mean()
