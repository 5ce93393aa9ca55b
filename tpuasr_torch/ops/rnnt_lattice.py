"""RNN-T lattice over the masked blank/label log-probs: the hand-written CUDA
kernels (``csrc/rnnt_lattice.cu``) and their plain PyTorch versions.

Counterparts of ``tpuasr/ops/rnnt_pallas.py``: `rnnt_alpha` replaces
`_rnnt_forward` (`_alpha_kernel`, TPU kernel #8), `rnnt_beta_grad` replaces
`_rnnt_bwd` (`_beta_grad_kernel`, #9), and `rnnt_lattice` ties them together
as one `torch.autograd.Function` whose backward is the closed-form occupancy
gradient, not autodiff through the recurrence. Both RNN-T loss routes run
their lattice here: the materialized one (`tpuasr_torch.losses.rnnt`) and
the fused joint's (`tpuasr_torch.ops.rnnt_fused`). The masking before the
lattice and the infeasible-row guard after it stay with the callers.

Inputs: blank_lp [B, T, U+1] and label_lp [B, T, U] fp32 after the
free-blank padding (blank 0 past t_len, label -1e30 past u_len or t_len, so
every path drifts to the last frame), u_lens [B]; the likelihood is read per
row at (T-1, u_len). -1e30 stands in for -inf.

The plain version runs the recurrence
``alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] +
label[t, u-1])`` over anti-diagonals n = t + u: every cell of a diagonal
depends only on the diagonal before, so one vectorised step per diagonal
(T + U steps of a few launches each) replaces the JAX package's T frames
times log2(U+1) scan levels. The kernels sweep the same diagonals. The
wrappers run the kernels for tensors on the card and the plain versions for
tensors on the CPU; a CUDA tensor never takes the plain path.

Two routes on the card, chosen by U+1 alone (`_rnnt_plan`) and counted apart
(`LAUNCHES["rnnt_alpha_warp"]`, `"rnnt_alpha_block"`,
`"rnnt_beta_grad_warp"`, `"rnnt_beta_grad_block"`, beside each entry's own
count): up to U+1 = 256 the warp route, one warp per utterance with K =
ceil((U+1) / 32) columns a lane in registers; beyond it, up to 1024, the
block route, a thread per column. The plan also sizes each entry's
shared-memory rings (diagonals a chunk) and the rows of a chunk each step
copies in (its share); the wrapper passes K, the chunk and the share to the
entry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuasr_torch.ops import _build
from tpuasr_torch.ops._lattice import CHUNK, MAX_K, SMEM, WARP

_NEG = -1.0e30
MAX_COLUMNS = 1024  # U+1: the block route's one thread per column in one block
ENTRIES = ("alpha", "beta_grad")
# the warp route's shared memory in chunks of diagonals of 32K floats (a
# float a column the warp holds): alpha four chunks of blank and of label,
# beta four of blank, label and alpha
RING_CHUNKS = {"alpha": 8, "beta_grad": 12}


def _rnnt_plan(u1: int, entry: str, route: str | None = None) -> dict:
    """How the card runs `entry` ("alpha", #8, or "beta_grad", #9) of the
    RNN-T lattice for U+1 columns. The route follows from U+1 alone: "warp"
    (a warp an utterance, K = ceil((U+1) / 32) columns a lane) while K <=
    MAX_K (U+1 256), else "block" (a thread a column): chip_smoke.py phase
    3's sweep by route finds the warp route the faster of the two, or level,
    at every K for both entries (PERF.md §6). `route` sets it by hand, for
    timing one route against the other; the wrappers never pass it. ->
    {"route", "k" (0 on the block route),
    "chunk" (diagonals a ring chunk, a power of two up to CHUNK whose
    RING_CHUNKS[entry] chunks of 32K fp32 a diagonal fit SMEM), "share"
    (rows of a chunk's fill and flush a step copies, K or K + 1, enough for
    the chunk's C + U1 (beta: C + U) rows at 32 / C a copy), "smem" (shared
    bytes a block; the block route's static rows)}. The chunk is the largest
    of 8 or more that fits with a share of K, else the largest that fits: a
    step's copies sit beside its chain, so fewer rows a step count for more
    than fewer chunks, down to chunks short enough that their starts (a wait
    each) add up."""
    if entry not in ENTRIES:
        raise ValueError(f"rnnt lattice: no entry {entry!r}")
    if u1 < 1:
        raise ValueError(f"rnnt lattice: U+1 = {u1}")
    k = -(-u1 // WARP)
    route = route or ("warp" if k <= MAX_K else "block")
    if route == "block":
        return {"route": "block", "k": 0, "chunk": 0, "share": 0,
                "smem": 8 * (MAX_COLUMNS + (entry == "beta_grad"))}
    if route != "warp" or k > MAX_K:
        raise ValueError(f"rnnt lattice: route {route!r} cannot take U+1 = {u1} (the warp "
                         f"route holds up to {WARP * MAX_K} columns)")
    chunks = RING_CHUNKS[entry]
    fits = [c for c in (CHUNK >> i for i in range(6)) if 4 * chunks * c * WARP * k <= SMEM]
    width = u1 if entry == "alpha" else u1 - 1
    share = {c: max(-(-(-(-(c + width) // (WARP // c))) // c), k) for c in fits}
    # the largest chunk of 8 or more whose steps copy K rows each, else the
    # largest (a chunk's start costs a wait)
    c = next((c for c in fits if c >= 8 and share[c] == k), fits[0])
    return {"route": "warp", "k": k, "chunk": c, "share": share[c],
            "smem": 4 * chunks * c * WARP * k}


def _skew(x: torch.Tensor, n_diag: int) -> torch.Tensor:
    """[B, T, U1] -> [B, n_diag, U1] with out[n, u] = x[n - u, u] where
    0 <= n - u < T, else -1e30."""
    b, t, u1 = x.shape
    n = torch.arange(n_diag, device=x.device)[:, None]
    u = torch.arange(u1, device=x.device)[None, :]
    src = n - u
    valid = (src >= 0) & (src < t)
    out = x.gather(1, src.clamp(0, t - 1).expand(b, n_diag, u1))
    return torch.where(valid, out, torch.full((), _NEG, dtype=x.dtype, device=x.device))


def _unskew(d: torch.Tensor, t: int) -> torch.Tensor:
    """[B, N, U1] diagonals -> [B, t, U1] with out[t, u] = d[t + u, u]."""
    b, _, u1 = d.shape
    idx = (torch.arange(t, device=d.device)[:, None]
           + torch.arange(u1, device=d.device)[None, :])
    return d.gather(1, idx.expand(b, t, u1))


def rnnt_alphas(blank_lp: torch.Tensor, label_lp: torch.Tensor) -> torch.Tensor:
    """alpha [B, T, U+1]: alpha[t, u] = log P(t frames consumed, u labels
    emitted), alpha[0, 0] = 0; blank_lp [B, T, U+1], label_lp [B, T, U]."""
    b, t, u1 = blank_lp.shape
    n_diag = t + u1 - 1
    y = F.pad(label_lp, (0, 1), value=_NEG)  # gain from (t, u) to (t, u+1)
    bk, ls = _skew(blank_lp, n_diag), _skew(y, n_diag)
    n = torch.arange(n_diag, device=blank_lp.device)[:, None]
    u = torch.arange(u1, device=blank_lp.device)[None, :]
    valid = ((n - u) >= 0) & ((n - u) < t)
    neg = torch.full((), _NEG, dtype=blank_lp.dtype, device=blank_lp.device)
    a = torch.where(u[0] == 0, torch.zeros_like(neg), neg).expand(b, u1)
    diags = [a]
    for k in range(1, n_diag):
        from_blank = a + bk[:, k - 1]
        from_label = F.pad((a + ls[:, k - 1])[:, :-1], (1, 0), value=_NEG)
        a = torch.where(valid[k], torch.logaddexp(from_blank, from_label).clamp_min(_NEG), neg)
        diags.append(a)
    return _unskew(torch.stack(diags, dim=1), t)


def rnnt_betas(blank_lp: torch.Tensor, label_lp: torch.Tensor,
               u_lens: torch.Tensor) -> torch.Tensor:
    """beta [B, T, U+1]: beta[t, u] = log P(finishing from (t, u)), the
    terminal blank at (T-1, u_len) included; beta[0, 0] = log-likelihood."""
    b, t, u1 = blank_lp.shape
    n_diag = t + u1  # the diagonals of an extended lattice with row t = T
    y = F.pad(label_lp, (0, 1), value=_NEG)
    bk, ls = _skew(blank_lp, n_diag), _skew(y, n_diag)
    n = torch.arange(n_diag, device=blank_lp.device)[:, None]
    u = torch.arange(u1, device=blank_lp.device)[None, :]
    valid = ((n - u) >= 0) & ((n - u) < t)
    at_end = (n - u) == t
    neg = torch.full((), _NEG, dtype=blank_lp.dtype, device=blank_lp.device)
    # beta of the virtual row t = T: 0 after the terminal blank at u_len
    term = torch.where(u == u_lens.long()[:, None], torch.zeros_like(neg), neg)  # [B, U1]
    nxt = neg.expand(b, u1)
    diags = [None] * n_diag
    for k in range(n_diag - 1, -1, -1):
        via_blank = bk[:, k] + nxt
        via_label = ls[:, k] + F.pad(nxt[:, 1:], (0, 1), value=_NEG)
        cur = torch.where(valid[k], torch.logaddexp(via_blank, via_label).clamp_min(_NEG), neg)
        nxt = torch.where(at_end[k], term, cur)
        diags[k] = nxt
    return _unskew(torch.stack(diags, dim=1), t)


def rnnt_log_likelihood(alpha: torch.Tensor, blank_lp: torch.Tensor,
                        u_lens: torch.Tensor) -> torch.Tensor:
    """[B] log-likelihood: alpha at (T-1, u_len) plus the terminal blank."""
    idx = u_lens.long()[:, None]
    return (alpha[:, -1].gather(1, idx) + blank_lp[:, -1].gather(1, idx))[:, 0]


def rnnt_occupancies(blank_lp, label_lp, u_lens, alpha, ll):
    """-> (occ_blank [B, T, U+1], occ_label [B, T, U]): the posterior of
    each blank and label transition, d(ll)/d(blank_lp) and d(ll)/d(label_lp)
    (tpuasr/losses/rnnt.py:128-149)."""
    b, t, u1 = blank_lp.shape
    beta = rnnt_betas(blank_lp, label_lp, u_lens)
    beta_tp1 = F.pad(beta[:, 1:], (0, 0, 0, 1), value=_NEG)
    term = ((torch.arange(u1, device=beta.device)[None, None, :] == u_lens.long()[:, None, None])
            & (torch.arange(t, device=beta.device)[None, :, None] == t - 1))
    beta_tp1 = torch.where(term, torch.zeros((), dtype=beta.dtype, device=beta.device),
                           beta_tp1)
    lln = ll[:, None, None]
    occ_blank = torch.exp(torch.clamp(alpha + blank_lp + beta_tp1 - lln, max=0.0))
    occ_label = torch.exp(torch.clamp(alpha[:, :, :-1] + label_lp + beta[:, :, 1:] - lln,
                                      max=0.0))
    return occ_blank, occ_label


def rnnt_alpha_plain(blank_lp, label_lp, u_lens) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (alpha tape [B, T, U+1], ll [B]), plain PyTorch (`_alpha_kernel`)."""
    alpha = rnnt_alphas(blank_lp, label_lp)
    return alpha, rnnt_log_likelihood(alpha, blank_lp, u_lens)


def rnnt_beta_grad_plain(blank_lp, label_lp, u_lens, alpha, ll, g
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (g · occ_blank [B, T, U+1], g · occ_label [B, T, U]), plain
    PyTorch (`_beta_grad_kernel`)."""
    occ_blank, occ_label = rnnt_occupancies(blank_lp, label_lp, u_lens, alpha, ll)
    g3 = g[:, None, None]
    return g3 * occ_blank, g3 * occ_label


def _check(blank_lp, label_lp, u_lens, extra=()):
    if blank_lp.device.type != "cuda":
        raise ValueError(f"rnnt lattice: unsupported device {blank_lp.device}")
    if blank_lp.dim() != 3 or blank_lp.shape[1] == 0 or blank_lp.shape[2] == 0:
        raise ValueError(f"rnnt lattice: blank_lp must be [B, T>0, U+1>0], got "
                         f"{tuple(blank_lp.shape)}")
    b, t, u1 = blank_lp.shape
    if u1 > MAX_COLUMNS:
        raise ValueError(f"rnnt lattice: U+1 = {u1} > {MAX_COLUMNS} columns")
    named = (("blank_lp", blank_lp, torch.float32, (b, t, u1)),
             ("label_lp", label_lp, torch.float32, (b, t, u1 - 1)),
             ("u_lens", u_lens, torch.int32, (b,)),
             *((name, x, torch.float32, shape) for name, x, shape in extra))
    for name, x, dtype, shape in named:
        if x.device != blank_lp.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"rnnt lattice: {name} must be a contiguous {dtype} tensor on "
                             f"{blank_lp.device}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"rnnt lattice: {name} shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
    return b, t, u1


def rnnt_alpha(blank_lp, label_lp, u_lens) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel #8: -> (alpha tape [B, T, U+1], ll [B]) fp32. CPU tensors take
    the plain version; on the card u_lens must be int32 and every input
    contiguous."""
    if blank_lp.device.type == "cpu":
        return rnnt_alpha_plain(blank_lp, label_lp, u_lens)
    b, t, u1 = _check(blank_lp, label_lp, u_lens)
    alpha = torch.empty_like(blank_lp)
    ll = torch.empty(b, dtype=torch.float32, device=blank_lp.device)
    if b:
        plan = _rnnt_plan(u1, "alpha")
        with torch.cuda.device(blank_lp.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("rnnt_alpha", blank_lp.data_ptr(), label_lp.data_ptr(),
                          u_lens.data_ptr(), alpha.data_ptr(), ll.data_ptr(), b, t, u1,
                          plan["k"], plan["chunk"], plan["share"], stream,
                          route=f"rnnt_alpha_{plan['route']}")
    return alpha, ll


def rnnt_beta_grad(blank_lp, label_lp, u_lens, alpha, ll, g
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel #9: -> (g · occ_blank [B, T, U+1], g · occ_label [B, T, U])
    fp32 for the upstream gradient g [B] of ll. CPU tensors take the plain
    version."""
    if blank_lp.device.type == "cpu":
        return rnnt_beta_grad_plain(blank_lp, label_lp, u_lens, alpha, ll, g)
    b, t, u1 = _check(blank_lp, label_lp, u_lens,
                      (("alpha", alpha, tuple(blank_lp.shape)),
                       ("ll", ll, (blank_lp.shape[0],)), ("g", g, (blank_lp.shape[0],))))
    gblank = torch.empty_like(blank_lp)
    glabel = torch.empty_like(label_lp)
    if b:
        plan = _rnnt_plan(u1, "beta_grad")
        with torch.cuda.device(blank_lp.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("rnnt_beta_grad", blank_lp.data_ptr(), label_lp.data_ptr(),
                          u_lens.data_ptr(), alpha.data_ptr(), ll.data_ptr(), g.data_ptr(),
                          gblank.data_ptr(), glabel.data_ptr(), b, t, u1, plan["k"],
                          plan["chunk"], plan["share"], stream,
                          route=f"rnnt_beta_grad_{plan['route']}")
    return gblank, glabel


def mask_lattice_inputs(blank_lp, label_lp, t_lens, u_lens):
    """Free blanks past t_len, -1e30 labels past u_len or t_len ->
    (blank_m, label_m, pad_t [B, T, 1], label_valid [B, T, U])."""
    b, t, u = label_lp.shape
    pad_t = torch.arange(t, device=blank_lp.device)[None, :, None] >= t_lens[:, None, None]
    blank_m = torch.where(pad_t, torch.zeros((), dtype=blank_lp.dtype, device=blank_lp.device),
                          blank_lp)
    label_valid = ((torch.arange(u, device=label_lp.device)[None, None, :]
                    < u_lens[:, None, None]) & ~pad_t)
    label_m = torch.where(label_valid, label_lp,
                          torch.full((), _NEG, dtype=label_lp.dtype, device=label_lp.device))
    return blank_m, label_m, pad_t, label_valid


class _RNNTLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank_lp, label_lp, u_lens):
        alpha, ll = rnnt_alpha(blank_lp, label_lp, u_lens)
        ctx.save_for_backward(blank_lp, label_lp, u_lens, alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        blank_lp, label_lp, u_lens, alpha, ll = ctx.saved_tensors
        gblank, glabel = rnnt_beta_grad(blank_lp, label_lp, u_lens, alpha, ll,
                                        g.float().contiguous())
        return gblank, glabel, None


def rnnt_lattice(blank_lp, label_lp, u_lens) -> torch.Tensor:
    """[B] log-likelihood of each row's lattice, differentiable w.r.t.
    blank_lp and label_lp through kernels #8 (alpha) and #9 (beta +
    occupancy gradients) on the card. Operands are made fp32, contiguous
    and int32 (u_lens) here."""
    return _RNNTLattice.apply(blank_lp.float().contiguous(), label_lp.float().contiguous(),
                              u_lens.to(torch.int32).contiguous())
