"""The CTC lattice's warp route (kernels #6/#7 on the card): its plan
(`_ctc_plan`, plain Python) and a plain-PyTorch emulation of the kernels'
arithmetic, on the CPU.

On the card csrc/ctc_lattice.cu's warp route runs one warp per utterance:
lane l holds K = ceil(S / 32) states in registers (l*K .. l*K+K-1), takes
s-1 and s-2 (s+1 and s+2 backward) from its own registers or by warp
shuffles from its neighbour, and per step takes the three-term log-add m +
e + log(1 + e^(x-m) + e^(y-m)), m = max(a, b, c) clamped at -1e30; padded
states (s >= S) are held at -1e30. The chain runs only for t < t_len: the alpha rows from
t_len on are the last live row, written after the chain; the gradient is 0
from t_len on, and the backward restarts at t_len - 1 from the final states
and emits frame t+1's gradient from registers carried over a step. ll is a
warp butterfly of the lanes' partial sums. The emulation follows that
layout, those shifts, that order and that arithmetic in float32 (torch's
exp and log in place of the card's ex2 / lg2, whose error is far below the
tolerances), and is held against the plain versions (`ctc_alpha_plain`,
`ctc_beta_grad_plain`) at the bench shape (B 12, T' 191, U 32: S 65, K 3)
and at ragged cases, and against the JAX package's Pallas kernel in
interpret mode at tests/test_torch_ctc.py's sizes.

Tolerances (chip_smoke.py phase 3's): alpha and ll 1e-3 + 1e-5*|ref| over
reachable cells, which must be the same cells: the three-term log-add
rounds once where the plain version's nested two-term log-adds round
twice, and alpha ~ -1,200 at the bench shape carries an ulp of 1.2e-4
through every dependent step; gradients 2e-3*|ref| + 1e-5: an exp of a
log-domain sum carrying beta's error of the same kind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.ops.ctc_pallas import ctc_loss_pallas
from tpuasr_torch.losses.ctc import lattice_inputs
from tpuasr_torch.losses.rnnt import zero_infeasible
from tpuasr_torch.ops import LAUNCHES, _build, ctc_alpha_plain, ctc_beta_grad_plain
from tpuasr_torch.ops.ctc import CTC_CHUNK, CTC_SMEM, CTC_WARP, CTC_WARP_MAX_K, _NEG, _ctc_plan

torch.set_num_threads(1)  # six test workers share the cores


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_ctc_plan_routes_by_shape():
    """S = 1 .. 1025: K = ceil(S / 32) states a lane; the warp route up to
    K = CTC_WARP_MAX_K (S 256), the block route beyond; ring chunks a power
    of two up to 32 frames within the 48 KB a block takes without opting
    in; the path's shapes (S 65 bench, 33 trainer, 11 ragged) take the warp
    route with 32-frame chunks."""
    assert CTC_WARP * CTC_WARP_MAX_K == 256 and CTC_WARP_MAX_K >= 8
    for s in range(1, 1026):
        plan = _ctc_plan(s)
        k = -(-s // 32)
        if s <= 256:
            assert plan["route"] == "warp" and plan["k"] == k and CTC_WARP * k >= s
            for name, arrays in (("alpha", 1), ("beta_grad", 2)):
                ch = plan["chunk"][name]
                assert ch & (ch - 1) == 0 and 1 <= ch <= CTC_CHUNK
                assert plan["smem"][name] == 4 * arrays * 2 * ch * s <= CTC_SMEM
                assert ch == CTC_CHUNK or 4 * arrays * 2 * 2 * ch * s > CTC_SMEM
        else:
            assert plan["route"] == "block" and plan["k"] == 0
            with pytest.raises(ValueError, match="warp route"):
                _ctc_plan(s, route="warp")
        assert _ctc_plan(s, route="block")["route"] == "block"
    for s, k in ((65, 3), (33, 2), (11, 1)):
        plan = _ctc_plan(s)
        assert (plan["route"], plan["k"], plan["chunk"]["alpha"], plan["chunk"]["beta_grad"]) \
            == ("warp", k, 32, 32)
    assert _ctc_plan(255)["chunk"] == {"alpha": 16, "beta_grad": 8}
    with pytest.raises(ValueError):
        _ctc_plan(65, route="lane")
    with pytest.raises(ValueError):
        _ctc_plan(0)


def test_ctc_launch_counts_each_route():
    """Each CTC entry counts its warp and block routes beside its own count,
    and a launch names its route (checked before any library is loaded)."""
    assert _build.ROUTES["ctc_alpha"] == ("ctc_alpha_warp", "ctc_alpha_block")
    assert _build.ROUTES["ctc_beta_grad"] == ("ctc_beta_grad_warp", "ctc_beta_grad_block")
    assert {"ctc_alpha_warp", "ctc_alpha_block", "ctc_beta_grad_warp",
            "ctc_beta_grad_block"} <= set(LAUNCHES)
    before = dict(LAUNCHES)
    for name, route in (("ctc_alpha", None), ("ctc_alpha", "ctc_beta_grad_warp"),
                        ("ctc_beta_grad", "ctc_alpha_block"), ("rnnt_alpha", "ctc_alpha_warp")):
        with pytest.raises(ValueError, match="route"):
            _build.launch(name, route=route)
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _states(k: int) -> torch.Tensor:
    """[32, K] state index of each lane's registers: lane l holds l*K ..
    l*K+K-1."""
    return torch.arange(CTC_WARP)[:, None] * k + torch.arange(k)[None, :]


def _regs(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, S] -> [B, 32, K]; -1e30 where a register holds no state."""
    s = x.shape[1]
    pad = torch.full((x.shape[0], 1), _NEG, dtype=x.dtype)
    return torch.cat([x, pad], dim=1)[:, idx.clamp(max=s)]


def _shfl(x: torch.Tensor, d: int) -> torch.Tensor:
    """A warp shuffle along the lane axis: lane l gets lane l - d's register
    (d < 0: lane l + |d|'s); a lane whose source is out of range keeps its
    own (`__shfl_up_sync` / `__shfl_down_sync`)."""
    src = torch.arange(CTC_WARP) - d
    src = torch.where((src >= 0) & (src < CTC_WARP), src, torch.arange(CTC_WARP))
    return x[:, src]


def _logadd3(a, b, c, e):
    """m + e + log(1 + e^(mid-m) + e^(lo-m)), m = max(a, b, c) clamped at
    -1e30, in the kernel's order."""
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    m = torch.maximum(hi, torch.clamp(c, min=_NEG))
    total = (1.0 + torch.exp(torch.minimum(hi, c) - m)) + torch.exp(lo - m)
    return (m + e) + torch.log(total)


def _below(a, lane):
    """s-1 and s-2 of every register (`from_below`); p2 still unmasked."""
    neg = torch.full_like(a[:, :, :1], _NEG)
    k = a.shape[2]
    u1 = _shfl(a[:, :, -1:], 1)
    u2 = _shfl(a[:, :, -2:-1], 1) if k >= 2 else _shfl(a[:, :, :1], 2)
    w1 = torch.where(lane >= 1, u1, neg)
    w2 = torch.where(lane >= (1 if k >= 2 else 2), u2, neg)
    p1 = torch.cat([w1, a[:, :, :-1]], dim=2)
    p2 = torch.cat([w2, w1, a[:, :, :-2]], dim=2)[:, :, :k]
    return p1, p2


def _above(b, lane):
    """s+1 and s+2 of every register (`from_above`); q2 still unmasked."""
    neg = torch.full_like(b[:, :, :1], _NEG)
    k = b.shape[2]
    d1 = _shfl(b[:, :, :1], -1)
    d2 = _shfl(b[:, :, 1:2], -1) if k >= 2 else _shfl(b[:, :, :1], -2)
    w1 = torch.where(lane <= 30, d1, neg)
    w2 = torch.where(lane <= (30 if k >= 2 else 29), d2, neg)
    q1 = torch.cat([b[:, :, 1:], w1], dim=2)
    q2 = torch.cat([b[:, :, 2:], w1, w2], dim=2)[:, :, -k:] if k >= 2 else w2
    return q1, q2


def _butterfly(v: torch.Tensor, op) -> torch.Tensor:
    """[B, 32] -> [B]: v = op(v, v[l ^ o]) for o = 16, 8, 4, 2, 1."""
    lane = torch.arange(CTC_WARP)
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[:, lane ^ o])
    return v[:, 0]


def _emulate_alpha(lp_states, skip, tlens, final):
    """The warp route's forward: -> (alpha tape [B, T, S], ll [B])."""
    b, t_max, s = lp_states.shape
    idx = _states(_ctc_plan(s)["k"])
    valid = (idx < s)[None]
    lane = torch.arange(CTC_WARP)[None, :, None]
    lp_r = _regs(lp_states.reshape(b * t_max, s), idx).reshape(b, t_max, CTC_WARP, -1)
    skips = _regs(skip.float(), idx).bool()
    finals = _regs(final.float(), idx).bool()
    neg = torch.full((), _NEG)
    tend = torch.clamp(tlens.long(), max=t_max).clamp(min=1)
    a = torch.where(valid & (idx < 2)[None], lp_r[:, 0], neg)
    tape = torch.full((b, t_max, CTC_WARP, idx.shape[1]), _NEG)
    tape[:, 0] = a
    for t in range(1, int(tend.max())):
        p1, p2 = _below(a, lane)
        new = _logadd3(a, p1, torch.where(skips, p2, neg), lp_r[:, t])
        live = (t < tend)[:, None, None]
        a = torch.where(live, torch.where(valid, new, neg), a)
        tape[:, t] = torch.where(live, a, tape[:, t])
    for r in range(b):  # frozen rows: the last live row, written after the chain
        tape[r, int(tend[r]):] = a[r]
    out = torch.empty_like(lp_states)
    out.reshape(b, t_max, -1)[..., idx[valid[0]]] = tape[..., valid[0]]
    fin = torch.where(finals, a, neg)
    m = _butterfly(fin.max(dim=2).values, torch.maximum)
    part = torch.zeros(b, CTC_WARP)
    for k in range(idx.shape[1]):
        part = part + torch.where(valid[..., k], torch.exp(fin[..., k] - m[:, None]), 0.0)
    ll = m + torch.log(_butterfly(part, torch.add))
    return out, ll


def _emulate_beta_grad(lp_states, skip, tlens, final, alpha, ll, g):
    """The warp route's backward: -> grad [B, T, S]."""
    b, t_max, s = lp_states.shape
    idx = _states(_ctc_plan(s)["k"])
    valid = (idx < s)[None]
    lane = torch.arange(CTC_WARP)[None, :, None]
    flat = lambda x: _regs(x.reshape(b * t_max, s), idx).reshape(b, t_max, CTC_WARP, -1)
    lp_r, al_r = flat(lp_states), flat(alpha)
    skip2 = torch.cat([skip, torch.zeros(b, 2, dtype=torch.bool)], dim=1)[:, 2:]
    skips2 = _regs(skip2.float(), idx).bool()
    finals = _regs(final.float(), idx).bool()
    neg = torch.full((), _NEG)
    tend = torch.clamp(tlens.long(), max=t_max)
    grad = torch.zeros(b, t_max, CTC_WARP, idx.shape[1])  # 0 from t_len on, written first
    beta = pe = pa = torch.full((b, CTC_WARP, idx.shape[1]), _NEG)

    def emit(rows, t, beta, pe, pa):
        gam = torch.clamp(pa + (beta - pe) - ll[:, None, None], max=0.0)
        grad[rows, t] = (g[:, None, None] * torch.exp(gam))[rows]

    for t in range(int(tend.max()) - 1, -1, -1):
        first = t == tend - 1  # the row's last frame: the final states
        chain = t < tend - 1
        if chain.any():
            q1, q2 = _above(beta, lane)
            new = _logadd3(beta, q1, torch.where(skips2, q2, neg), lp_r[:, t])
            emit(chain, t + 1, beta, pe, pa)  # frame t+1 from the carried registers
            beta = torch.where(chain[:, None, None], torch.where(valid, new, neg), beta)
        init = torch.where(finals, lp_r[:, t], neg)
        beta = torch.where(first[:, None, None], init, beta)
        on = (first | chain)[:, None, None]
        pe, pa = torch.where(on, lp_r[:, t], pe), torch.where(on, al_r[:, t], pa)
    emit(tend >= 1, 0, beta, pe, pa)
    out = torch.zeros_like(lp_states)
    out.reshape(b, t_max, -1)[..., idx[valid[0]]] = grad[..., valid[0]]
    return out


def _check(got_a, got_ll, got_g, ref_a, ref_ll, ref_g):
    live = ref_a > -1e29
    assert torch.equal(live, got_a > -1e29)
    assert torch.equal(ref_ll > -1e29, got_ll > -1e29)
    assert bool(((got_a - ref_a).abs() <= 1e-3 + 1e-5 * ref_a.abs())[live].all())
    assert bool(((got_ll - ref_ll).abs() <= 1e-3 + 1e-5 * ref_ll.abs()).all())
    assert bool(((got_g - ref_g).abs() <= 2e-3 * ref_g.abs() + 1e-5).all())


def _lattice(b, t, u, v, t_lens, u_lens, seed, blank=5):
    r = np.random.default_rng(seed)
    logits = torch.from_numpy(r.standard_normal((b, t, v)).astype(np.float32))
    labels = torch.from_numpy(r.integers(6, v, (b, u)))
    lp = torch.log_softmax(logits, dim=-1)
    lp_states, skip, final = lattice_inputs(lp, labels, torch.as_tensor(u_lens), blank)
    g = torch.from_numpy(r.uniform(0.5, 1.5, b).astype(np.float32))
    return lp_states.contiguous(), skip, torch.as_tensor(t_lens, dtype=torch.int32), final, g


def _against_plain(case):
    lp_states, skip, tlens, final, g = case
    assert _ctc_plan(lp_states.shape[2])["route"] == "warp"
    ra, rll = ctc_alpha_plain(lp_states, skip, tlens, final)
    ea, ell = _emulate_alpha(lp_states, skip, tlens, final)
    rg = ctc_beta_grad_plain(lp_states, skip, tlens, final, ra, rll, g)
    eg = _emulate_beta_grad(lp_states, skip, tlens, final, ra, rll, g)
    _check(ea, ell, eg, ra, rll, rg)
    past = torch.arange(lp_states.shape[1])[None, :] >= tlens.long()[:, None]
    assert bool((eg[past] == 0).all())
    return ea, rg, eg


def test_warp_emulation_matches_plain_at_the_bench_shape():
    """B 12, T' 191, U 32 (S 65, K 3), t_len 150-191, label_len 26-32, V
    412: the emulation against the plain versions."""
    r = np.random.default_rng(13)
    t_lens = np.concatenate([[191], r.integers(150, 192, 11)])
    u_lens = r.integers(26, 33, 12)
    _against_plain(_lattice(12, 191, 32, 412, t_lens, u_lens, seed=13))


# (B, T, U, t_lens, label lens): a t_len = 0 row, a t_len = 1 row, a
# label_len = 0 row, an infeasible row (6 labels in 4 frames), every row
# shorter than T; S 11 and 31 (K 1), 33 (K 2), 13, 1 (U 0) and 255 (K 8)
RAGGED = {
    "tlen0_tlen1": (4, 20, 5, [20, 0, 1, 13], [5, 4, 5, 3]),
    "label0": (3, 16, 5, [16, 16, 9], [5, 0, 2]),
    "infeasible": (3, 12, 6, [12, 4, 12], [6, 6, 0]),
    "all_short": (3, 24, 16, [20, 9, 17], [16, 3, 8]),
    "s1": (2, 9, 0, [9, 4], [0, 0]),
    "s31": (2, 40, 15, [40, 33], [15, 12]),
    "s255": (2, 30, 127, [30, 27], [14, 9]),
}


@pytest.mark.parametrize("kind", sorted(RAGGED))
def test_warp_emulation_matches_plain_ragged(kind):
    b, t, u, t_lens, u_lens = RAGGED[kind]
    case = _lattice(b, t, u, 97, t_lens, u_lens, seed=len(kind))
    ea, rg, eg = _against_plain(case)
    lp_states = case[0]
    for row, n in enumerate(t_lens):
        if n == 0:  # alpha's row 0 from the first frame's first two states, every row after it
            s_idx = torch.arange(lp_states.shape[2])
            row0 = torch.where(s_idx < 2, lp_states[row, 0], torch.full((), _NEG))
            assert torch.equal(ea[row], row0.expand_as(ea[row]))
            assert bool((eg[row] == 0).all())
    if kind == "infeasible":
        ll = _emulate_alpha(*case[:4])[1]
        assert float(ll[1]) < -1e29 and float(zero_infeasible(ll)[1]) == 0.0


class _Emulated(torch.autograd.Function):
    """The lattice's autograd Function with the emulated warp route in
    place of the kernels."""

    @staticmethod
    def forward(ctx, lp_states, skip, tlens, final):
        alpha, ll = _emulate_alpha(lp_states, skip, tlens, final)
        ctx.save_for_backward(lp_states, skip, tlens, final, alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        lp_states, skip, tlens, final, alpha, ll = ctx.saved_tensors
        return (_emulate_beta_grad(lp_states, skip, tlens, final, alpha, ll, g.float()),
                None, None, None)


def _small_case(kind: str):
    """tests/test_torch_ctc.py's cases: B 3, T 12, V 9, U 4."""
    b, t, v, u = 3, 12, 9, 4
    r = np.random.default_rng(sum(map(ord, kind)))
    blank = 5 if kind == "blank5" else 0
    logits = r.standard_normal((b, t, v)).astype(np.float32)
    labels = r.integers(1, v, size=(b, u)).astype(np.int32)
    if blank:
        labels[labels == blank] = 1
        labels[0, 1] = labels[0, 0]
    t_lens = np.full(b, t, np.int32)
    l_lens = np.array([u, u - 1, u - 2], np.int32)
    if kind == "short_t":
        t_lens[:] = [t, 7, 3]
    elif kind == "empty_label":
        l_lens[1] = 0
    elif kind == "infeasible":
        labels[1] = 3
        t_lens[1] = 4
    w = r.uniform(0.5, 2.0, b).astype(np.float32)
    return logits, labels, t_lens, l_lens, blank, w


@pytest.mark.parametrize("kind", ["blank0", "blank5", "short_t", "empty_label", "infeasible"])
def test_warp_emulation_matches_pallas_interpret(kind):
    """The emulated warp route through the loss (gather, lattice, the
    infeasible guard) against `ctc_loss_pallas(interpret=True)`: the loss
    and its gradient w.r.t. the log-probs, each row weighted differently."""
    logits, labels, t_lens, l_lens, blank, w = _small_case(kind)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)

    def pallas(x):
        return ctc_loss_pallas(x, t_lens, labels, l_lens, blank, interpret=True)

    ref = np.asarray(pallas(lp))
    ref_g = np.asarray(jax.grad(lambda x: jnp.sum(pallas(x) * w))(lp))
    x = torch.from_numpy(np.array(lp)).requires_grad_()
    lp_states, skip, final = lattice_inputs(x, torch.from_numpy(labels),
                                            torch.from_numpy(l_lens), blank)
    ll = _Emulated.apply(lp_states.contiguous(), skip, torch.from_numpy(t_lens), final)
    nll = zero_infeasible(ll)
    (nll * torch.from_numpy(w)).sum().backward()
    got, got_g = nll.detach().numpy(), x.grad.numpy()
    assert np.all(np.abs(got - ref) <= 1e-3 + 1e-5 * np.abs(ref))
    assert np.all(np.abs(got_g - ref_g) <= 2e-3 * np.abs(ref_g) + 1e-5)
    if kind == "infeasible":
        assert got[1] == 0.0 and np.all(got_g[1] == 0.0)
