"""The fused-joint backward's tiling (`_joint_bwd_plan`, plain Python) and
a plain-PyTorch emulation of its partial sums, on the CPU.

Kernel #5 on the card (csrc/rnnt_fused.cu) splits its sums across blocks:
the row side writes djoined summed over each u-chunk (enc_part) and each
t-chunk (pred_part), the vocabulary side dW and db summed over each range of
flattened rows (dw_part, db_part), and a last kernel adds the partials in
the order 0, 1, ... The emulation below follows that index math with the
plan's tiles and is held against `rnnt_fused_grads_plain` (fp32, sums in
another order: 1e-5 of each output's max), at shapes with ragged t-, u- and
row chunks. The plan: tt * uc <= 64, every (t, u) in one chunk, the
vocabulary side as many blocks as one wave holds, U+1 up to
200 at D 256, the workspace at the flagship's training shape.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuasr_torch.ops.rnnt_fused import (
    JOINT_PART_CAP, JOINT_ROWS, JOINT_STAGE, _joint, _joint_bwd_plan, _label_ids,
    rnnt_fused_grads_plain, rnnt_fused_lp_plain,
)

torch.set_num_threads(1)


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("b,t,u1,d,v", [
    (12, 191, 33, 256, 412), (12, 63, 33, 256, 412), (12, 127, 33, 256, 412),
    (2, 9, 1, 256, 412), (2, 10, 129, 256, 412), (3, 70, 8, 256, 412), (2, 5, 41, 32, 97),
    (1, 13, 6, 64, 64), (4, 3, 200, 256, 412), (1, 1, 1, 8, 3), (2, 70, 1, 256, 412),
])
def test_joint_bwd_plan_tiles_every_row_once(b, t, u1, d, v):
    n_sm = 132
    plan = _joint_bwd_plan(b, t, u1, d, v, n_sm)
    tt, uc, n_uc, n_tc = plan["tt"], plan["uc"], plan["n_uc"], plan["n_tc"]
    assert 1 <= tt and 1 <= uc and tt * uc <= JOINT_ROWS
    assert (tt + uc) * 32 * _cdiv(d, 32) <= JOINT_STAGE
    assert plan["row_grid"] == (n_uc, n_tc, b) and n_uc == _cdiv(u1, uc) and n_tc == _cdiv(t, tt)
    hits = np.zeros((t, u1), np.int64)
    for kt in range(n_tc):
        for ku in range(n_uc):
            hits[kt * tt:(kt + 1) * tt, ku * uc:(ku + 1) * uc] += 1
    assert (hits == 1).all()
    n_tiles = b * n_uc * n_tc
    s = plan["S"]
    assert plan["vocab_grid"] == (plan["n_vt"], s) and plan["n_vt"] == _cdiv(v, plan["vocab_vt"])
    assert 1 <= s <= n_tiles  # every block has a tile
    assert plan["n_vt"] * s <= max(n_sm, plan["n_vt"])  # one wave
    if n_tiles >= n_sm // plan["n_vt"]:  # tiles enough: as many blocks as one wave holds
        assert plan["n_vt"] * (s + 1) > n_sm
    parts = {"enc_part": b * n_uc * t * d, "pred_part": b * n_tc * u1 * d,
             "dw_part": s * d * v, "db_part": s * v,
             "w_split": 2 * _cdiv(v, 32) * 32 * _cdiv(d, 32) * 32}
    for name, count in parts.items():
        assert 4 * count <= plan["ws"][name] < 4 * count + 256
        assert plan["ws"][name] % 256 == 0
    assert plan["ws_bytes"] == sum(plan["ws"].values())
    assert plan["ws"]["enc_part"] + plan["ws"]["pred_part"] <= JOINT_PART_CAP


def test_joint_bwd_plan_at_the_bench_shape():
    """bench.py's batch (B 12, T' 191, U+1 33, D 256, V 412) on 132 SMs:
    uc 7 x tt 9 (63 of 64 rows), 5 x 22 x 12 = 1,320 row-side blocks (10
    waves, the fewest of any split under the partial cap), 7 x 18 = 126
    vocabulary-side blocks, each every 18th of those tiles (73 or 74); 29.1
    MB of workspace."""
    plan = _joint_bwd_plan(12, 191, 33, 256, 412, 132)
    assert (plan["uc"], plan["tt"], plan["n_uc"], plan["n_tc"]) == (7, 9, 5, 22)
    assert (plan["n_vt"], plan["S"]) == (7, 18)
    assert plan["ws"] == {"enc_part": 11_735_040, "pred_part": 8_921_088,
                          "dw_part": 7_593_984, "db_part": 29_696, "w_split": 851_968}
    assert plan["ws_bytes"] == 29_131_776


@pytest.mark.parametrize("u1", [120, 129, 200])
def test_joint_bwd_plan_takes_long_label_sequences(u1):
    """No U+1 limit: today's shapes past the old kernel's shared-memory limit
    (U+1 120 at D 256) are tiled like any other."""
    plan = _joint_bwd_plan(2, 17, u1, 256, 412, 132)
    assert plan["uc"] <= JOINT_ROWS and plan["n_uc"] * plan["uc"] >= u1


def _inputs(b, t, u, d, v, blank, seed):
    r = np.random.default_rng(seed)
    enc = torch.from_numpy(r.standard_normal((b, t, d)).astype(np.float32))
    pred = torch.from_numpy(r.standard_normal((b, u + 1, d)).astype(np.float32))
    w = torch.from_numpy((r.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32))
    bias = torch.from_numpy((0.1 * r.standard_normal(v)).astype(np.float32))
    lab = torch.from_numpy(r.integers(0, v, (b, u)).astype(np.int32))
    _, _, lse = rnnt_fused_lp_plain(enc, pred, w, bias, lab, blank)
    gb = -torch.from_numpy(r.random((b, t, u + 1)).astype(np.float32))
    gl = F.pad(-torch.from_numpy(r.random((b, t, u)).astype(np.float32)), (0, 1))
    return enc, pred, w, bias, lab, lse, gb, gl


def _emulate(enc, pred, w, bias, lab, lse, gb, gl, blank, plan):
    """The card's partial sums with the plan's tiles, summed in its order."""
    b, t, d = enc.shape
    u1, v = pred.shape[1], w.shape[1]
    a, x = _joint(enc, pred, w, bias)
    dx = -torch.exp(x - lse[..., None]) * (gb + gl)[..., None]
    dx[..., blank] += gb
    ids = _label_ids(lab, blank)
    for bi in range(b):
        for u in range(u1):
            if 0 <= int(ids[bi, u]) < v:
                dx[bi, :, u, int(ids[bi, u])] += gl[bi, :, u]
    dj = (dx @ w.T) * (1.0 - a * a)
    tt, uc, n_uc, n_tc = plan["tt"], plan["uc"], plan["n_uc"], plan["n_tc"]
    enc_part = torch.empty(b, n_uc, t, d)
    pred_part = torch.empty(b, n_tc, u1, d)
    for ku in range(n_uc):  # a row-side block's column sums over its u, then its t
        enc_part[:, ku] = dj[:, :, ku * uc:(ku + 1) * uc].sum(2)
    for kt in range(n_tc):
        pred_part[:, kt] = dj[:, kt * tt:(kt + 1) * tt].sum(1)
    # the vocabulary side: block k takes every S-th row-side tile from k, in
    # the order (b, t-chunk, u-chunk), each a [rows, D] x [rows, V] step
    s = plan["S"]
    tiles = [(bi, kt, ku) for bi in range(b) for kt in range(n_tc) for ku in range(n_uc)]
    dw_part, db_part = torch.zeros(s, d, v), torch.zeros(s, v)
    for k in range(s):
        for bi, kt, ku in tiles[k::s]:
            ta = a[bi, kt * tt:(kt + 1) * tt, ku * uc:(ku + 1) * uc].reshape(-1, d)
            tx = dx[bi, kt * tt:(kt + 1) * tt, ku * uc:(ku + 1) * uc].reshape(-1, v)
            dw_part[k] += ta.T @ tx
            db_part[k] += tx.sum(0)

    def in_order(parts):
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    return (in_order(enc_part.unbind(1)), in_order(pred_part.unbind(1)), in_order(dw_part),
            in_order(db_part))


@pytest.mark.parametrize("b,t,u,d,v,n_sm", [
    (2, 9, 6, 32, 37, 132),    # one row-side block an utterance, two row ranges
    (2, 9, 12, 32, 37, 4),     # u-chunks of 7 and 6, four row ranges (a small card)
    (3, 11, 70, 16, 41, 132),  # U+1 71 > 64: u-chunks 9 x 7 + 8, t-chunks 7 + 4
])
def test_partial_sums_in_the_kernels_order_match_plain(b, t, u, d, v, n_sm):
    blank = 3
    args = _inputs(b, t, u, d, v, blank, 7 * t + u)
    plan = _joint_bwd_plan(b, t, u + 1, d, v, n_sm)
    got = _emulate(*args, blank, plan)
    ref = rnnt_fused_grads_plain(*args, blank)
    for name, x, y in zip(("d_enc", "d_pred", "dW", "db"), got, ref):
        assert x.shape == y.shape, name
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()), name
