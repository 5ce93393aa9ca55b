"""CTC lattice over per-state emission log-probs: the hand-written CUDA
kernels (``csrc/ctc_lattice.cu``) and their plain PyTorch versions.

Counterparts of ``tpuasr/ops/ctc_pallas.py``: `ctc_alpha` replaces
`_ctc_forward` (`_alpha_kernel`), `ctc_beta_grad` replaces `_ctc_bwd`
(`_beta_grad_kernel`), and `ctc_lattice` ties them together as one
`torch.autograd.Function` over `lp_states`. The label gather and the
log-softmax VJP upstream stay with autograd, as in the JAX package
(`ctc_pallas.py:12-13`); the infeasible-row guard stays with the caller
(`tpuasr_torch.losses.ctc`). The wrappers run the kernels for tensors on the
card and the plain versions for tensors on the CPU; a CUDA tensor never
takes the plain path.

Inputs: lp_states [B, T, S] fp32 (masked emission log-probs, -1e30 at
states past 2·label_len), skip [B, S] bool (the s-2 -> s transition is
allowed), tlens [B] int (frames of each row; rows are frozen from t_len on),
final [B, S] bool (the one or two final states).

Two routes on the card, chosen by S alone (`_ctc_plan`) and counted apart
(`LAUNCHES["ctc_alpha_warp"]`, `"ctc_alpha_block"`, `"ctc_beta_grad_warp"`,
`"ctc_beta_grad_block"`, beside each entry's own count): up to S = 256 (U
127) the warp route, one warp per utterance with K = ceil(S / 32) states a
lane in registers; beyond it the block route, a thread per state. The plan
also sizes the warp route's shared-memory ring (frames a chunk); the
wrapper passes K and the chunk to the entry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuasr_torch.ops import _build

_NEG = -1.0e30  # large-negative stand-in for -inf (keeps arithmetic NaN-free)

CTC_WARP = 32  # lanes of a warp
CTC_WARP_MAX_K = 8  # states a lane holds on the warp route: S <= 256
CTC_CHUNK = 32  # frames a ring chunk holds at most
CTC_SMEM = 48 * 1024  # shared memory a block takes without opting in


def _ring_chunk(s: int, arrays: int) -> int:
    """Frames a ring chunk holds: the largest power of two up to CTC_CHUNK
    whose two chunks of `arrays` [T, S] fp32 arrays fit CTC_SMEM."""
    ch = CTC_CHUNK
    while ch > 1 and 4 * arrays * 2 * ch * s > CTC_SMEM:
        ch //= 2
    return ch


def _ctc_plan(s: int, route: str | None = None) -> dict:
    """How the card runs the CTC lattice for S states. The route follows
    from S alone: "warp" (a warp an utterance, K = ceil(S / 32) states a
    lane) while K <= CTC_WARP_MAX_K, else "block" (a thread a state).
    `route` sets it by hand, for timing one route against the other; the
    wrappers never pass it. -> {"route", "k" (0 on the block route), "chunk"
    and "smem" ({"alpha", "beta_grad"}: frames a ring chunk, shared bytes a
    block)}."""
    if s < 1:
        raise ValueError(f"ctc lattice: S = {s}")
    k = -(-s // CTC_WARP)
    route = route or ("warp" if k <= CTC_WARP_MAX_K else "block")
    if route == "block":
        return {"route": "block", "k": 0, "chunk": {"alpha": 0, "beta_grad": 0},
                "smem": {"alpha": 8 * s, "beta_grad": 8 * s}}
    if route != "warp" or k > CTC_WARP_MAX_K:
        raise ValueError(f"ctc lattice: route {route!r} cannot take S = {s} (the warp route "
                         f"holds up to {CTC_WARP * CTC_WARP_MAX_K} states)")
    chunk = {"alpha": _ring_chunk(s, 1), "beta_grad": _ring_chunk(s, 2)}
    return {"route": "warp", "k": k, "chunk": chunk,
            "smem": {name: 4 * arrays * 2 * chunk[name] * s
                     for name, arrays in (("alpha", 1), ("beta_grad", 2))}}


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=_NEG)  # both -NEG: avoid -inf - -inf
    return m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe))


def _neg(ref: torch.Tensor) -> torch.Tensor:
    return torch.full((), _NEG, dtype=ref.dtype, device=ref.device)


def ctc_alpha_plain(lp_states, skip, tlens, final) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (alpha tape [B, T, S], ll [B]), plain PyTorch (`_alpha_kernel`)."""
    b, t_max, s = lp_states.shape
    neg = _neg(lp_states)
    s_idx = torch.arange(s, device=lp_states.device)
    alpha = torch.where(s_idx[None] < 2, lp_states[:, 0], neg)
    tape = [alpha]
    for t in range(1, t_max):
        a1 = F.pad(alpha, (1, 0), value=_NEG)[:, :s]
        a2 = torch.where(skip, F.pad(alpha, (2, 0), value=_NEG)[:, :s], neg)
        new = _logaddexp(_logaddexp(alpha, a1), a2) + lp_states[:, t]
        alpha = torch.where((t < tlens)[:, None], new, alpha)
        tape.append(alpha)
    fin = torch.where(final, alpha, neg)
    m = torch.clamp(fin.max(dim=1, keepdim=True).values, min=_NEG)
    ll = (m + torch.log(torch.exp(fin - m).sum(dim=1, keepdim=True)))[:, 0]
    return torch.stack(tape, dim=1), ll


def ctc_beta_grad_plain(lp_states, skip, tlens, final, alpha, ll, g) -> torch.Tensor:
    """-> g · d(ll)/d(lp_states) [B, T, S], plain PyTorch
    (`_beta_grad_kernel`): the reverse sweep restarts at t_len - 1 from the
    final states, and grad[t, s] = g · exp(alpha + beta - lp - ll) with
    beta including the emission at (t, s); padded frames get 0."""
    b, t_max, s = lp_states.shape
    neg = _neg(lp_states)
    skip_l2 = F.pad(skip, (0, 2), value=False)[:, 2:]  # s -> s+2 allowed
    tl = tlens[:, None]
    grad = torch.empty_like(lp_states)

    def emit(t, beta):
        lp_t = lp_states[:, t]
        gamma = alpha[:, t] + (beta - lp_t) - ll[:, None]
        grad[:, t] = torch.where(t < tl, g[:, None] * torch.exp(torch.clamp(gamma, max=0.0)),
                                 torch.zeros((), dtype=lp_states.dtype,
                                             device=lp_states.device))

    beta = torch.where(final, lp_states[:, t_max - 1], neg)
    emit(t_max - 1, beta)
    for t in range(t_max - 2, -1, -1):
        b1 = F.pad(beta, (0, 1), value=_NEG)[:, 1:]
        b2 = torch.where(skip_l2, F.pad(beta, (0, 2), value=_NEG)[:, 2:], neg)
        new = _logaddexp(_logaddexp(beta, b1), b2) + lp_states[:, t]
        new = torch.where(t == tl - 1, torch.where(final, lp_states[:, t], neg), new)
        beta = torch.where(t >= tl, beta, new)
        emit(t, beta)
    return grad


def _check(lp_states, skip, tlens, final):
    if lp_states.device.type != "cuda":
        raise ValueError(f"ctc lattice: unsupported device {lp_states.device}")
    if lp_states.dim() != 3 or lp_states.shape[1] == 0:
        raise ValueError(f"ctc lattice: lp_states must be [B, T>0, S], got "
                         f"{tuple(lp_states.shape)}")
    b, _, s = lp_states.shape
    for name, x, dtype, shape in (("lp_states", lp_states, torch.float32, lp_states.shape),
                                  ("skip", skip, torch.bool, (b, s)),
                                  ("tlens", tlens, torch.int32, (b,)),
                                  ("final", final, torch.bool, (b, s))):
        if x.device != lp_states.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"ctc lattice: {name} must be a contiguous {dtype} tensor on "
                             f"{lp_states.device}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"ctc lattice: {name} shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")


def ctc_alpha(lp_states, skip, tlens, final) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (alpha tape [B, T, S], ll [B]). CPU tensors take the plain version;
    on the card tlens must be int32 and every input contiguous."""
    if lp_states.device.type == "cpu":
        return ctc_alpha_plain(lp_states, skip, tlens, final)
    _check(lp_states, skip, tlens, final)
    b, t, s = lp_states.shape
    alpha = torch.empty_like(lp_states)
    ll = torch.empty(b, dtype=torch.float32, device=lp_states.device)
    if b == 0 or s == 0:
        return alpha, ll
    plan = _ctc_plan(s)
    with torch.cuda.device(lp_states.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ctc_alpha", lp_states.data_ptr(), skip.data_ptr(), tlens.data_ptr(),
                      final.data_ptr(), alpha.data_ptr(), ll.data_ptr(), b, t, s, plan["k"],
                      plan["chunk"]["alpha"], stream, route=f"ctc_alpha_{plan['route']}")
    return alpha, ll


def ctc_beta_grad(lp_states, skip, tlens, final, alpha, ll, g) -> torch.Tensor:
    """-> g · d(ll)/d(lp_states) [B, T, S] fp32. CPU tensors take the plain
    version."""
    if lp_states.device.type == "cpu":
        return ctc_beta_grad_plain(lp_states, skip, tlens, final, alpha, ll, g)
    _check(lp_states, skip, tlens, final)
    b, t, s = lp_states.shape
    for name, x, shape in (("alpha", alpha, (b, t, s)), ("ll", ll, (b,)), ("g", g, (b,))):
        if (x.device != lp_states.device or x.dtype != torch.float32
                or not x.is_contiguous() or tuple(x.shape) != shape):
            raise ValueError(f"ctc lattice: {name} must be a contiguous fp32 {shape} tensor "
                             f"on {lp_states.device}")
    grad = torch.empty_like(lp_states)
    if b == 0 or s == 0:
        return grad
    plan = _ctc_plan(s)
    with torch.cuda.device(lp_states.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ctc_beta_grad", lp_states.data_ptr(), skip.data_ptr(),
                      tlens.data_ptr(), final.data_ptr(), alpha.data_ptr(), ll.data_ptr(),
                      g.data_ptr(), grad.data_ptr(), b, t, s, plan["k"],
                      plan["chunk"]["beta_grad"], stream,
                      route=f"ctc_beta_grad_{plan['route']}")
    return grad


class _CTCLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_states, skip, tlens, final):
        alpha, ll = ctc_alpha(lp_states, skip, tlens, final)
        ctx.save_for_backward(lp_states, skip, tlens, final, alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        lp_states, skip, tlens, final, alpha, ll = ctx.saved_tensors
        grad = ctc_beta_grad(lp_states, skip, tlens, final, alpha, ll,
                             g.float().contiguous())
        return grad, None, None, None


def ctc_lattice(lp_states, skip, tlens, final) -> torch.Tensor:
    """[B] log-likelihood of each row's lattice, differentiable w.r.t.
    lp_states through kernels #6 (alpha) and #7 (beta + gradient)."""
    return _CTCLattice.apply(lp_states, skip, tlens, final)
