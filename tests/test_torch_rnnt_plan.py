"""The RNN-T lattice's warp route (kernels #8/#9 on the card): its plan
(`_rnnt_plan`, plain Python) and a plain-PyTorch emulation of the kernels'
index math and arithmetic, on the CPU.

On the card csrc/rnnt_lattice.cu's warp route runs one warp per utterance
over the anti-diagonals n = t + u: lane l holds K = ceil((U+1) / 32)
columns in registers (l*K .. l*K+K-1), takes the left neighbour (t, u-1)
of alpha (the right one (t, u+1) of beta) from its own registers or, for
its first (last) column, by a warp shuffle from lane l-1 (l+1), and per
step takes the two-term log-add m + log(1 + e^-|x-y|), m = max(x, y)
clamped at -1e30. What a step reads comes from a shared-memory ring of four
chunks of C diagonals, slot n & (4C - 1) of P = 32K floats (a float a
column the warp holds), filled by rows of the source arrays (lane j:
diagonal n_lo + j % C, rows j / C + i * 32 / C) with the lattice's real
cells alone: chunks 0 and 1 before the sweep, chunk i + 2 a share (the
plan's K or K + 1 rows) a step during chunk i; the cells no fill copies keep the ring's start values
(-1e30; for beta's blank 0, the free blanks of the rows past T), so the
recurrence needs no mask; the columns past U read them too. A step stores
its outputs (the alpha tape, the gradients) at its real cells straight to
device memory. The emulation builds each chunk's rings with the kernels'
own index arithmetic and copy counts (the running offsets, the slots,
which cells are copied and that none is copied twice; every output cell
stored once, none read unset), runs the steps
in the kernels' order with their lane layout, shuffles and log-add (torch's exp
and log in place of the card's ex2 / lg2, whose error is far below the
tolerances), and is held against the plain versions (`rnnt_alpha_plain`,
`rnnt_beta_grad_plain`) at the bench shape (B 12, T' 191, U+1 33: K 2) and
at ragged cases, and against the JAX package's Pallas kernels in interpret
mode at tests/test_torch_rnnt_lattice.py's sizes.

Tolerances (chip_smoke.py phase 3's): alpha and ll 1e-3 + 1e-5*|ref| over
reachable cells (> -1e29), which must be the same cells: the log-add's
form rounds differently from the plain version's torch.logaddexp, and alpha
~ -1,000 at the bench shape carries an ulp of 6e-5 through every dependent
step; gradients 2e-3*|ref| + 1e-5: an exp of a log-domain sum carrying
alpha's and beta's errors of the same kind.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.ops.rnnt_pallas import _rnnt_bwd, _rnnt_forward
from tpuasr_torch.ops import LAUNCHES, _build, rnnt_alpha_plain, rnnt_beta_grad_plain
from tpuasr_torch.ops._lattice import CHUNK, MAX_K, SMEM, WARP
from tpuasr_torch.ops.rnnt_lattice import (
    _NEG, ENTRIES, _rnnt_plan, mask_lattice_inputs,
)

torch.set_num_threads(1)  # six test workers share the cores


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_rnnt_plan_routes_by_shape():
    """U+1 = 1 .. 1025, for each entry: K = ceil((U+1) / 32) columns a lane;
    the warp route up to K = 8 (U+1 256), the block route beyond; ring
    chunks a power of two up to 32 diagonals within the 48 KB a block takes
    without opting in (alpha: 8 chunks of 32K floats a diagonal, beta: 12),
    each step copying a share of K or K + 1 rows in, enough for a chunk's
    rows; the chunk the largest of 8 or more with a share of K, else the
    largest; the path's shapes (U+1 33 bench, 17 trainer, 1) take the warp
    route with a share of K."""
    assert WARP * MAX_K == 256
    for u1 in range(1, 1026):
        k = -(-u1 // 32)
        for name, chunks in (("alpha", 8), ("beta_grad", 12)):
            plan = _rnnt_plan(u1, name)
            assert plan["route"] == ("warp" if k <= MAX_K else "block")
            if k <= MAX_K:
                warp = _rnnt_plan(u1, name, route="warp")
                assert warp == plan and warp["k"] == k and WARP * k >= u1
                ch, q = warp["chunk"], warp["share"]
                assert ch & (ch - 1) == 0 and 2 <= ch <= CHUNK
                assert warp["smem"] == 4 * chunks * ch * 32 * k <= SMEM
                width = u1 if name == "alpha" else u1 - 1

                def share(c):  # rows a step copies so that C steps cover a chunk
                    return max(-(-(-(-(c + width) // (32 // c))) // c), k)

                assert q == share(ch) and q in (k, k + 1)  # the kernels take K or K + 1
                fits = [c for c in (32, 16, 8, 4, 2, 1) if 4 * chunks * c * 32 * k <= SMEM]
                best = [c for c in fits if c >= 8 and share(c) == k]
                assert ch == (best[0] if best else fits[0])
            else:
                with pytest.raises(ValueError, match="warp route"):
                    _rnnt_plan(u1, name, route="warp")
                assert plan["k"] == 0 and plan["smem"] <= SMEM
            assert _rnnt_plan(u1, name, route="block")["route"] == "block"
    for u1, k, chunk in ((33, 2, (16, 16)), (17, 1, (8, 16)), (1, 1, (16, 32)),
                         (256, 8, (4, 4))):
        for name, c in zip(ENTRIES, chunk):
            plan = _rnnt_plan(u1, name, route="warp")
            assert (plan["k"], plan["chunk"]) == (k, c)
    for u1 in (33, 17, 1):  # the path's shapes: the warp route, K rows a step
        for name in ENTRIES:
            plan = _rnnt_plan(u1, name)
            assert plan["route"] == "warp" and plan["share"] == -(-u1 // 32)
    for name in ENTRIES:
        assert _rnnt_plan(257, name)["route"] == "block"
    with pytest.raises(ValueError):
        _rnnt_plan(33, "alpha", route="lane")
    with pytest.raises(ValueError):
        _rnnt_plan(0, "alpha")
    with pytest.raises(ValueError, match="entry"):
        _rnnt_plan(33, "beta")


def test_rnnt_launch_counts_each_route():
    """Each RNN-T lattice entry counts its warp and block routes beside its
    own count, and a launch names its route (checked before any library is
    loaded)."""
    assert _build.ROUTES["rnnt_alpha"] == ("rnnt_alpha_warp", "rnnt_alpha_block")
    assert _build.ROUTES["rnnt_beta_grad"] == ("rnnt_beta_grad_warp", "rnnt_beta_grad_block")
    assert {"rnnt_alpha_warp", "rnnt_alpha_block", "rnnt_beta_grad_warp",
            "rnnt_beta_grad_block"} <= set(LAUNCHES)
    before = dict(LAUNCHES)
    for name, route in (("rnnt_alpha", None), ("rnnt_alpha", "rnnt_beta_grad_warp"),
                        ("rnnt_beta_grad", None), ("rnnt_beta_grad", "rnnt_alpha_block"),
                        ("rnnt_alpha", "ctc_alpha_warp")):
        with pytest.raises(ValueError, match="route"):
            _build.launch(name, route=route)
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

# what each input ring holds before its first fill (`ring_set`): the cells a
# fill never copies keep it, the columns past U too (beta's alpha ring is
# never set: NaN here, to show that no output reads a cell no fill copied)
RING_START = {"alpha": {"blank": _NEG, "label": _NEG},
              "beta": {"blank": 0.0, "label": _NEG, "alpha": float("nan")}}


def _fill(kind: str, n_lo: int, lc: int, p: int, t: int, u1: int, copies: int):
    """The copies of one chunk's fill (`FillAlpha` / `FillBeta`, `copies`
    calls), every lane and call at once, with the kernel's running offsets:
    -> {array: (ring index, source offset)}; no ring cell is copied twice."""
    c_n, r_step, u = 1 << lc, WARP >> lc, u1 - 1
    lane = np.arange(WARP)
    n = n_lo + (lane & (c_n - 1))
    if kind == "alpha":  # rows n_lo - U1 .. n_lo + C - 1, c = n - 1 - r
        r0 = n_lo - u1 + (lane >> lc)
        c0 = n - 1 - r0
    else:  # rows n_lo - U .. n_lo + C - 1, c = n - r
        r0 = n_lo - u + (lane >> lc)
        c0 = n - r0
    step = np.arange(copies)[:, None]  # [copies, 1]
    r, c = r0 + step * r_step, c0 - step * r_step
    d = ((n & ((4 << lc) - 1)) * p + c0) - step * r_step  # the kernel's running offsets
    ob = (r0 * u1 + c0) + step * (r_step * u)
    ol = (r0 * u + c0) + step * (r_step * (u - 1))
    row = (r >= 0) & (r < t)
    out = {}

    def put(name, where, dst, src):
        dst, src = (np.broadcast_to(x, r.shape)[where] for x in (dst, src))
        assert len(np.unique(dst)) == len(dst)  # no cell copied twice
        out[name] = (dst, src)

    if kind == "alpha":
        put("blank", row & (c >= 0) & (c < u1), d, ob)
        put("label", row & (c >= 0) & (c < u), d + 1, ol)
    else:
        real = row & (c >= 0) & (c < u1)
        put("blank", real, d, ob)
        put("alpha", real, d, ob)
        put("label", real & (c < u), d, ol)
    return out


def _apply(ring: torch.Tensor, copies, src: torch.Tensor) -> None:
    dst, off = copies
    ring[:, dst] = src.reshape(src.shape[0], -1)[:, off]


def _ring(b: int, kind: str, name: str, size: int) -> torch.Tensor:
    return torch.full((b, size), RING_START[kind][name])


def _fills(kind: str, lc: int, q: int, u1: int, n_chunks: int) -> list[int]:
    """How many rows a lane copies into each chunk, in the kernels' order:
    chunks 0 and 1 whole before the sweep, chunk i >= 2 by the plan's q
    rows a step of chunk i - 2 (alpha's chunk 0 counts diagonal 0's share,
    taken before the loop)."""
    c_n, r_step = 1 << lc, WARP >> lc
    fill_rows = -(-(c_n + (u1 if kind == "alpha" else u1 - 1)) // r_step)
    return [fill_rows if i < 2 else q * c_n for i in range(n_chunks)]


def _store(out: torch.Tensor, n: int, idx: torch.Tensor, v: torch.Tensor) -> None:
    """A step's stores: each lane's value of column u at the cell (n - u, u)
    of `out` [B, T, W] where that cell is real (0 <= n - u < T, u < W); a
    cell is stored once."""
    u = idx.reshape(-1)
    t = n - u
    real = (t >= 0) & (t < out.shape[1]) & (u < out.shape[2])
    cells = out[:, t[real], u[real]]
    assert bool(cells.isnan().all())
    out[:, t[real], u[real]] = v.reshape(v.shape[0], -1)[:, real]


def _logadd2(x, y):
    """m + log(1 + e^-|x-y|), m = max(x, y) clamped at -1e30, in the
    kernel's order."""
    m = torch.clamp(torch.maximum(x, y), min=_NEG)
    return m + torch.log(1.0 + torch.exp(-(x - y).abs()))


def _shfl(x: torch.Tensor, d: int) -> torch.Tensor:
    """A warp shuffle along the lane axis: lane l gets lane l - d's register
    (d < 0: lane l + |d|'s); a lane whose source is out of range keeps its
    own (`__shfl_up_sync` / `__shfl_down_sync`)."""
    src = torch.arange(WARP) - d
    src = torch.where((src >= 0) & (src < WARP), src, torch.arange(WARP))
    return x[:, src]


def _layout(u1: int):
    """-> (K, [32, K] column of each register)."""
    k = _rnnt_plan(u1, "alpha", route="warp")["k"]
    return k, torch.arange(WARP)[:, None] * k + torch.arange(k)[None, :]


def _read(ring: torch.Tensor, n: int, lc: int, p: int, idx: torch.Tensor) -> torch.Tensor:
    return ring[:, (n & ((4 << lc) - 1)) * p + idx]


def _emulate_alpha(blank, label, u_lens):
    """The warp route's forward: -> (alpha tape [B, T, U+1], ll [B])."""
    b, t, u1 = blank.shape
    plan = _rnnt_plan(u1, "alpha", route="warp")
    lc = plan["chunk"].bit_length() - 1
    k, idx = _layout(u1)
    p, n_diag, c_n = WARP * k, t + u1 - 1, 1 << lc
    n_chunks = -(-n_diag // c_n)
    fills = _fills("alpha", lc, plan["share"], u1, n_chunks)
    rb, rl = (_ring(b, "alpha", name, 4 * c_n * p) for name in ("blank", "label"))
    tape = torch.full((b, t, u1), float("nan"))  # every cell must be stored
    a = torch.where(idx == 0, 0.0, _NEG).expand(b, WARP, k).clone()
    tape[:, 0, 0] = 0.0  # alpha[0, 0]
    for ci in range(n_chunks):
        fill = _fill("alpha", ci * c_n, lc, p, t, u1, fills[ci])
        _apply(rb, fill["blank"], blank)
        _apply(rl, fill["label"], label)
        for n in range(max(ci * c_n, 1), min(ci * c_n + c_n, n_diag)):
            eb, el = _read(rb, n, lc, p, idx), _read(rl, n, lc, p, idx)
            left = _shfl(a[:, :, -1:], 1)  # lane 0: its own, plus column 0's -1e30
            a = _logadd2(a + eb, torch.cat([left, a[:, :, :-1]], dim=2) + el)
            _store(tape, n, idx, a)
    assert not bool(tape.isnan().any())
    ul = u_lens.long()
    ok = (ul >= 0) & (ul < u1)
    at = ul.clamp(0, u1 - 1)[:, None]
    ll = tape[:, -1].gather(1, at)[:, 0] + blank[:, -1].gather(1, at)[:, 0]
    return tape, torch.where(ok, ll, torch.full((), float("nan")))


def _emulate_beta_grad(blank, label, u_lens, alpha, ll, g):
    """The warp route's backward: -> (gblank [B, T, U+1], glabel [B, T, U])."""
    b, t, u1 = blank.shape
    plan = _rnnt_plan(u1, "beta_grad", route="warp")
    lc = plan["chunk"].bit_length() - 1
    k, idx = _layout(u1)
    p, top, c_n = WARP * k, t + u1 - 2, 1 << lc
    n_chunks = (top + c_n) // c_n
    fills = _fills("beta", lc, plan["share"], u1, n_chunks)
    rb, rl, ra = (_ring(b, "beta", name, 4 * c_n * p) for name in ("blank", "label", "alpha"))
    gblank = torch.full((b, t, u1), float("nan"))
    glabel = torch.full((b, t, u1 - 1), float("nan"))
    bt = torch.where(idx[None] == u_lens.long()[:, None, None], 0.0, _NEG)
    llb, gs = ll[:, None, None], g[:, None, None]
    for ci in range(n_chunks):
        n_lo = top - ci * c_n - c_n + 1  # the chunk: diagonals top - ci * C down to n_lo
        fill = _fill("beta", n_lo, lc, p, t, u1, fills[ci])
        _apply(rb, fill["blank"], blank)
        _apply(rl, fill["label"], label)
        _apply(ra, fill["alpha"], alpha)
        for n in range(top - ci * c_n, max(n_lo, 0) - 1, -1):
            eb, el, ea = (_read(x, n, lc, p, idx) for x in (rb, rl, ra))
            right = _shfl(bt[:, :, :1], -1)  # lane 31: its own
            x = eb + bt
            y = el + torch.cat([bt[:, :, 1:], right], dim=2)
            _store(gblank, n, idx, gs * torch.exp(torch.clamp(ea + x - llb, max=0.0)))
            _store(glabel, n, idx, gs * torch.exp(torch.clamp(ea + y - llb, max=0.0)))
            bt = _logadd2(x, y)
    assert not bool(gblank.isnan().any() or glabel.isnan().any())
    return gblank, glabel


def _check(got_a, got_ll, got_gb, got_gl, ref_a, ref_ll, ref_gb, ref_gl):
    live = ref_a > -1e29
    assert torch.equal(live, got_a > -1e29)
    assert torch.equal(ref_ll > -1e29, got_ll > -1e29)
    assert bool(((got_a - ref_a).abs() <= 1e-3 + 1e-5 * ref_a.abs())[live].all())
    assert bool(((got_ll - ref_ll).abs() <= 1e-3 + 1e-5 * ref_ll.abs()).all())
    for got, ref in ((got_gb, ref_gb), (got_gl, ref_gl)):
        assert got.shape == ref.shape
        assert bool(((got - ref).abs() <= 2e-3 * ref.abs() + 1e-5).all())


def _lattice(b, t, u, t_lens, u_lens, seed, v=32):
    """Masked blank [B, T, U+1] and label [B, T, U] log-probs as the losses
    hand them over (logits of std 2 over V entries: log-probs ~ -5), u_lens
    int32 and g [B]."""
    r = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(2 * r.standard_normal((b, t, u + 1, v))
                                            .astype(np.float32)), dim=-1)
    labels = torch.from_numpy(r.integers(1, v, (b, max(u, 1))))[:, :u]
    label = lp[:, :, :u].gather(3, labels[:, None, :, None].expand(b, t, u, 1))[..., 0]
    tl, ul = torch.as_tensor(t_lens), torch.as_tensor(u_lens, dtype=torch.int32)
    blank_m, label_m, _, _ = mask_lattice_inputs(lp[..., 0], label, tl, ul)
    g = torch.from_numpy(r.uniform(0.5, 1.5, b).astype(np.float32))
    return blank_m.contiguous(), label_m.contiguous(), ul, g


def _against_plain(case):
    blank, label, ul, g = case
    ra, rll = rnnt_alpha_plain(blank, label, ul)
    ea, ell = _emulate_alpha(blank, label, ul)
    rgb, rgl = rnnt_beta_grad_plain(blank, label, ul, ra, rll, g)
    egb, egl = _emulate_beta_grad(blank, label, ul, ra, rll, g)
    _check(ea, ell, egb, egl, ra, rll, rgb, rgl)
    return ea, ell, egb, egl


def test_warp_emulation_matches_plain_at_the_bench_shape():
    """B 12, T' 191, U+1 33 (K 2, chunks of 16 diagonals), t_len 150-191,
    u_len 26-32: the emulation against the plain versions."""
    r = np.random.default_rng(14)
    t_lens = np.concatenate([[191], r.integers(150, 192, 11)])
    u_lens = np.concatenate([[32], r.integers(26, 33, 11)])
    _, ell, _, _ = _against_plain(_lattice(12, 191, 32, t_lens, u_lens, seed=14))
    assert float(ell.min()) < -500  # |alpha| large enough that its ulp matters


# (B, T, U, t_lens, u_lens): a t_len = 0 row with labels (infeasible), a
# u_len = 0 row, T = 1, U+1 = 1 (K 1, 31 lanes past the lattice), U+1 32 (a
# full warp, K 1), U+1 = 256 (K 8, chunks of 4 diagonals), U+1 65 (K 3,
# alpha's chunks of 16), every row shorter than T
RAGGED = {
    "tlen0_ulen0": (4, 20, 5, [20, 0, 13, 7], [5, 4, 0, 3]),
    "t1": (3, 1, 4, [1, 1, 0], [4, 0, 2]),
    "u1_1": (3, 9, 0, [9, 4, 0], [0, 0, 0]),
    "u1_32": (2, 40, 31, [40, 33], [31, 12]),
    "u1_256": (2, 12, 255, [12, 9], [255, 40]),
    "u1_65": (2, 30, 64, [30, 21], [64, 50]),
    "all_short": (3, 24, 16, [20, 9, 17], [16, 3, 8]),
}


@pytest.mark.parametrize("kind", sorted(RAGGED))
def test_warp_emulation_matches_plain_ragged(kind):
    b, t, u, t_lens, u_lens = RAGGED[kind]
    case = _lattice(b, t, u, t_lens, u_lens, seed=len(kind))
    _, ell, _, _ = _against_plain(case)
    for row, (tl, ul) in enumerate(zip(t_lens, u_lens)):
        if tl == 0:  # free blanks only: feasible without labels, else not
            assert (float(ell[row]) == 0.0) if ul == 0 else (float(ell[row]) < -1e29)


@pytest.mark.parametrize("b,t,u", [(10, 9, 5), (3, 13, 1)])
def test_warp_emulation_matches_pallas_interpret(b, t, u):
    """The emulated warp route against `_rnnt_forward` / `_rnnt_bwd` of
    tpuasr/ops/rnnt_pallas.py in interpret mode, at
    tests/test_torch_rnnt_lattice.py's sizes, a t_len = 0 row with labels and
    a u_len = 0 row included."""
    r = np.random.default_rng(b * t + u)
    t_lens = r.integers(t // 2, t + 1, size=b)
    u_lens = r.integers(0, u + 1, size=b)
    t_lens[0], u_lens[0] = t, u
    t_lens[1], u_lens[1], u_lens[2] = 0, u, 0
    blank, label, ul, g = _lattice(b, t, u, t_lens, u_lens, seed=b * t + u, v=9)
    ll_ref, res = _rnnt_forward(jnp.asarray(blank.numpy()), jnp.asarray(label.numpy()),
                                jnp.asarray(ul.numpy()), True)
    alpha_ref = torch.from_numpy(np.array(res[3])[:b, :, :u + 1])
    gb_ref, gl_ref, _ = _rnnt_bwd(True, res, jnp.asarray(g.numpy()))
    ea, ell = _emulate_alpha(blank, label, ul)
    egb, egl = _emulate_beta_grad(blank, label, ul, ea, ell, g)
    _check(ea, ell, egb, egl, alpha_ref, torch.from_numpy(np.array(ll_ref)),
           torch.from_numpy(np.array(gb_ref)), torch.from_numpy(np.array(gl_ref)))
    assert float(ell[1]) < -1e29  # no frames, some labels: infeasible
