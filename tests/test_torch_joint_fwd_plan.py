"""The fused-joint forward's tiling (`_joint_fwd_plan`, plain Python) and a
plain-PyTorch emulation of its fold, on the CPU.

Kernel #4 on the card (csrc/rnnt_fused.cu) gives each block a tile of tt
frames x uc label positions (tt * uc <= 32 rows), with K (D) zero-padded to
MAX_JOIN_DIM. Its warps take the logits of 16 rows x 32 vocabulary columns
over a quarter of K each; the quarters' partial logits are summed in order, the bias added, and each thread folds
its 4 columns of every 32-column tile into a running max and sum, which the
8 lanes of a row combine at the end. The emulation below follows that
order (the products in fp32 on the CPU, not 3xTF32) and is held against
`rnnt_fused_lp_plain` at 1e-5, with V not a multiple of 32, the blank and
label picks, out-of-range label ids and the last column's blank.
"""

import numpy as np
import pytest
import torch

from tpuasr_torch.ops.rnnt_fused import (
    JOINT_FWD_PER_SM, JOINT_FWD_ROWS, JOINT_ROW_VT, JOINT_STAGE, MAX_JOIN_DIM, _joint,
    _joint_fwd_plan, _label_ids, rnnt_fused_lp_plain,
)

torch.set_num_threads(1)

SMEM = 232_448  # shared memory a block may use on an H100


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("b,t,u1,d,v", [
    (12, 191, 33, 256, 412), (12, 63, 17, 256, 412), (12, 127, 17, 256, 412),
    (2, 9, 1, 256, 412), (1, 1, 5, 256, 412), (1, 1, 1, 8, 3), (2, 7, 4, 72, 30),
    (3, 37, 6, 256, 97), (2, 10, 129, 256, 412), (4, 3, 200, 256, 412), (2, 70, 1, 256, 412),
])
def test_joint_fwd_plan_tiles_every_row_once(b, t, u1, d, v):
    n_sm = 132
    plan = _joint_fwd_plan(b, t, u1, d, v, n_sm)
    tt, uc, n_uc, n_tc = plan["tt"], plan["uc"], plan["n_uc"], plan["n_tc"]
    dp = MAX_JOIN_DIM  # K, whatever D
    assert 1 <= tt and 1 <= uc and tt * uc <= JOINT_FWD_ROWS
    assert (tt + uc) * dp <= JOINT_STAGE  # a tile's enc and pred rows fit where they are copied
    assert plan["grid"] == (n_uc, n_tc, b) and n_uc == _cdiv(u1, uc) and n_tc == _cdiv(t, tt)
    hits = np.zeros((t, u1), np.int64)
    for kt in range(n_tc):
        for ku in range(n_uc):
            hits[kt * tt:(kt + 1) * tt, ku * uc:(ku + 1) * uc] += 1
    assert (hits == 1).all()
    assert plan["blocks"] == b * n_uc * n_tc
    assert plan["waves"] == _cdiv(plan["blocks"], JOINT_FWD_PER_SM * n_sm)
    # two W tiles and two sets of four partial-logit tiles; two blocks an SM,
    # each within a block's limit (with its ~2 KB of static shared memory)
    assert plan["smem"] == 4 * (2 * dp * JOINT_ROW_VT + 2 * 4 * JOINT_FWD_ROWS * JOINT_ROW_VT)
    assert JOINT_FWD_PER_SM * (plan["smem"] + 2048 + 1024) <= 233_472
    assert plan["smem"] <= SMEM
    n_vt = _cdiv(v, JOINT_ROW_VT)
    assert plan["n_vt"] == n_vt
    w_bytes = 4 * n_vt * dp * JOINT_ROW_VT
    assert w_bytes <= plan["ws"]["w_tiles"] < w_bytes + 256 and plan["ws"]["w_tiles"] % 256 == 0
    assert plan["ws_bytes"] == sum(plan["ws"].values())
    assert plan["l2_w_bytes"] == plan["blocks"] * w_bytes


def test_joint_fwd_plan_at_the_bench_and_trainer_shapes():
    """bench.py's batch (B 12, T' 191, U+1 33, D 256, V 412) on 132 SMs:
    uc 2 x tt 16 (32 rows, every slot full), 17 x 12 x 12 = 2,448 blocks in
    10 waves of 264, 96 KB of shared memory a block, W's fp32 tiles 0.43 MB,
    1.04 GB of them read from L2 a call. The trainer's U+1 17: the same
    tiles, 2 and 4 waves at T' 63 and 127."""
    plan = _joint_fwd_plan(12, 191, 33, 256, 412, 132)
    assert (plan["uc"], plan["tt"], plan["n_uc"], plan["n_tc"]) == (2, 16, 17, 12)
    assert (plan["blocks"], plan["waves"], plan["smem"]) == (2448, 10, 98_304)
    assert plan["ws"] == {"w_tiles": 425_984}
    assert plan["l2_w_bytes"] == 1_042_808_832
    for t, blocks, waves in ((63, 432, 2), (127, 864, 4)):
        plan = _joint_fwd_plan(12, t, 17, 256, 412, 132)
        assert (plan["uc"], plan["tt"], plan["blocks"], plan["waves"]) == (2, 16, blocks, waves)


def test_joint_fwd_plan_refuses_a_join_dim_past_its_tiles():
    with pytest.raises(ValueError, match=f"join dim 320 > {MAX_JOIN_DIM}"):
        _joint_fwd_plan(2, 9, 4, 320, 412, 132)


def _emulate(enc, pred, w, bias, lab, blank, plan):
    """Kernel #4's arithmetic order, tile by tile, on the CPU."""
    b, t, d = enc.shape
    u1, v = pred.shape[1], w.shape[1]
    a, _ = _joint(enc, pred, w, torch.zeros(v))
    dp = MAX_JOIN_DIM  # K, whatever D
    n_vt = _cdiv(v, JOINT_ROW_VT)
    # W zero-padded to [Dp, 32 n_vt]; a zero-padded to Dp
    wp = torch.zeros(dp, JOINT_ROW_VT * n_vt)
    wp[:d, :v] = w
    ap = torch.zeros(b, t, u1, dp)
    ap[..., :d] = a
    ids = _label_ids(lab, blank)  # [B, U+1], the blank in the last column
    blank_lp = torch.empty(b, t, u1)
    label_lp = torch.empty(b, t, u1)
    lse = torch.empty(b, t, u1)
    q = dp // 4
    tt, uc = plan["tt"], plan["uc"]
    for bi in range(b):
        for t0 in range(0, t, tt):
            for u0 in range(0, u1, uc):
                rows = [(ti, ui) for ti in range(t0, min(t0 + tt, t))
                        for ui in range(u0, min(u0 + uc, u1))]
                ar = torch.stack([ap[bi, ti, ui] for ti, ui in rows])  # [rows, Dp]
                m = torch.full((len(rows), 8), -torch.inf)  # a lane's running max and sum
                s = torch.zeros(len(rows), 8)
                xb = torch.zeros(len(rows))
                xl = torch.zeros(len(rows))
                lab_r = torch.tensor([int(ids[bi, ui]) for _, ui in rows])
                for vt in range(n_vt):
                    cols = slice(vt * 32, vt * 32 + 32)
                    parts = [ar[:, k * q:(k + 1) * q] @ wp[k * q:(k + 1) * q, cols]
                             for k in range(4)]
                    x = parts[0] + parts[1] + parts[2] + parts[3]  # the quarters in order
                    vcol = torch.arange(vt * 32, vt * 32 + 32)
                    bv = torch.zeros(32)
                    bv[vcol < v] = bias[vcol[vcol < v]]
                    x = torch.where(vcol < v, x + bv, torch.tensor(-torch.inf))
                    hit = vcol == blank
                    if hit.any():
                        xb = x[:, hit][:, 0]
                    for r in range(len(rows)):
                        if 0 <= int(lab_r[r]) < v and vt * 32 <= int(lab_r[r]) < vt * 32 + 32:
                            xl[r] = x[r, int(lab_r[r]) - vt * 32]
                    lanes = x.view(len(rows), 8, 4)  # lane l holds columns 4 l .. 4 l + 3
                    mx = torch.maximum(m, lanes.max(-1).values)
                    keep = torch.where(m == -torch.inf, torch.zeros(()), s * torch.exp(m - mx))
                    terms = torch.where(lanes == -torch.inf, torch.zeros(()),
                                        torch.exp(lanes - mx[..., None]))
                    s = keep + terms.sum(-1)
                    m = mx
                mrow = m.max(-1).values
                srow = torch.where(m == -torch.inf, torch.zeros(()),
                                   s * torch.exp(m - mrow[:, None])).sum(-1)
                lrow = mrow + torch.log(srow)
                for r, (ti, ui) in enumerate(rows):
                    lse[bi, ti, ui] = lrow[r]
                    blank_lp[bi, ti, ui] = xb[r] - lrow[r]
                    label_lp[bi, ti, ui] = xl[r] - lrow[r]
    return blank_lp, label_lp, lse


@pytest.mark.parametrize("b,t,u,d,v,blank", [
    (2, 5, 3, 64, 97, 3),     # V 97: the last tile holds one column
    (1, 3, 2, 72, 30, 0),     # D 72 (K padded to 256), V 30 < 32, the blank in column 0
    (2, 17, 4, 32, 64, 63),   # ragged t-chunks, the blank in the last column
    (1, 2, 0, 16, 7, 5),      # U+1 1: only the last column, which reads the blank
])
def test_fold_in_the_kernels_order_matches_plain(b, t, u, d, v, blank):
    r = np.random.default_rng(11 * t + v)
    enc = torch.from_numpy(r.standard_normal((b, t, d)).astype(np.float32))
    pred = torch.from_numpy(r.standard_normal((b, u + 1, d)).astype(np.float32))
    w = torch.from_numpy((2.0 * r.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32))
    bias = torch.from_numpy((0.1 * r.standard_normal(v)).astype(np.float32))
    lab = torch.from_numpy(r.integers(0, v, (b, u)).astype(np.int32))
    if u:
        lab[0, 0] = v  # past V, into the last W tile's padding when V % 32: logit 0
        lab[-1, -1] = -1  # logit 0
    plan = _joint_fwd_plan(b, t, u + 1, d, v, 132)
    got = _emulate(enc, pred, w, bias, lab, blank, plan)
    ref = rnnt_fused_lp_plain(enc, pred, w, bias, lab, blank)
    for name, x, y in zip(("blank_lp", "label_lp", "lse"), got, ref):
        assert x.shape == y.shape, name
        assert float((x - y).abs().max()) <= 1e-5, name
