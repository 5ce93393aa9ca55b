"""Rel-pos self-attention: the hand-written CUDA kernels
(``csrc/relpos_attention.cu``) and their plain PyTorch versions.

Counterpart of ``tpuasr/ops/attention_pallas.py`` (`fused_relpos_attention`):
`relpos_attention` is a `torch.autograd.Function` whose forward is TPU kernel
#2 (`_fused_fwd`) and whose backward is #3 (`_fused_bwd`,
`relpos_attention_bwd`). The backward recomputes the scores rather than
saving them. On the card both input types run tensor-core kernels, bf16 on
bf16 `mma.sync` and fp32 on 3xTF32 `mma.sync` (three TF32 products a
product, about 21 bits: the forward keeps 1e-5); the forward there also
saves its output in fp32 (bf16: before the rounding to bf16; fp32: the
output itself) and each query row's log-sum-exp (fp32 [B, H, T]), which the
backward starts from. The fp32 backward sums dp, du and dvb in a fixed order,
so two calls give the same bits. The CPU runs the plain versions, and its
Function saves only the inputs. The wrappers run the kernels for tensors on
the card and the plain versions for tensors on the CPU; a CUDA tensor never
takes the plain path.
"""

from __future__ import annotations

import torch

from tpuasr_torch.nn.layers import dropout
from tpuasr_torch.ops import _build

_NEG_INF = -1.0e9
KERNEL_DKS = (16, 32, 64)
MAX_LEN_BF16 = 16384  # T and S of the bf16 kernels: their mask bits fit in shared memory


def _heads(x, n_head):
    """[B|1, L, D] -> fp32 [B|1, L, H, dk]."""
    return x.reshape(x.shape[0], x.shape[1], n_head, -1).float()


def _scores(qu, qv, kk, pp, scale):
    """fp32 [B, H, T, S] scaled scores ((q+u).k^T + (q+v).p^T) * scale."""
    return (torch.einsum("bthd,bshd->bhts", qu, kk)
            + torch.einsum("bthd,pshd->bhts", qv, pp)) * scale


def _probs(scores, mask):
    """fp32 [B, H, T, S] probabilities; a row with every key masked is 0."""
    m = mask[:, None]  # [B, 1, T|1, S]
    return torch.softmax(scores.masked_fill(~m, _NEG_INF), dim=-1).masked_fill(~m, 0.0)


def relpos_attention_plain(q, k, p, v, u_bias, v_bias, mask, scale: float, n_head: int,
                           saved: bool = False, dropout_rate: float = 0.0,
                           gen: torch.Generator | None = None):
    """Plain PyTorch version, same contract as `relpos_attention`.

    q+u and q+v are formed in the input type; scores and softmax in fp32;
    the probabilities are cast to v's type before the a.v product, which
    accumulates in fp32. With `saved`, -> (out, out32, lse), what the
    forward saves for the backward: out32 = a.v in fp32 with a unrounded,
    lse fp32 [B, H, T], each row's log-sum-exp of its unmasked scaled
    scores, -inf for a fully masked row. With a generator `gen` and a
    `dropout_rate` above 0 (the attention module's training route, which
    never asks for `saved`), the fp32 probabilities are dropped out
    (`tpuasr_torch.nn.layers.dropout`) before the cast."""
    b, t, d = q.shape
    scores = _scores(_heads(q + u_bias, n_head), _heads(q + v_bias, n_head), _heads(k, n_head),
                     _heads(p, n_head), scale)
    a = dropout(_probs(scores, mask), dropout_rate, gen)
    vv = v.reshape(b, -1, n_head, d // n_head)
    out = torch.einsum("bhts,bshd->bthd", a.to(v.dtype).float(), vv.float())
    out = out.reshape(b, t, d).to(q.dtype)
    if not saved:
        return out
    out32 = out if q.dtype == torch.float32 else \
        torch.einsum("bhts,bshd->bthd", a, vv.float()).reshape(b, t, d)
    return out, out32, torch.logsumexp(scores.masked_fill(~mask[:, None], -torch.inf), dim=-1)


def relpos_attention_bwd_plain(q, k, p, v, u_bias, v_bias, mask, do, scale: float,
                               n_head: int, out=None, lse=None):
    """-> (dq, dk, dv, dp [1, S, D], du [D], dvb [D]) for the output's
    gradient do (`out` and `lse`, what the kernel's forward saved, are taken
    and not read), plain PyTorch at the rounding points of `_bwd_kernel`
    (attention_pallas.py:87-132): do and v upcast, dv = a^T.do and
    da = do.v^T in fp32, ds = a * (da - rowsum(da * a)) * scale rounded to
    the input type before the dq, dk and dp products, k + p summed in the
    input type, du/dvb from the column sums of ds rounded to it. dq, dk, dv
    in the input type; dp, du and dvb summed over the batch in fp32 and cast
    to the parameters' types (`_fused_bwd` :215-217)."""
    b, t, d = q.shape
    s = k.shape[1]
    dt = q.dtype
    qu, qv = _heads(q + u_bias, n_head), _heads(q + v_bias, n_head)
    kk, pp, vv = _heads(k, n_head), _heads(p, n_head), _heads(v, n_head)
    a = _probs(_scores(qu, qv, kk, pp, scale), mask)
    g = _heads(do, n_head)
    dv = torch.einsum("bhts,bthd->bshd", a, g)
    da = torch.einsum("bthd,bshd->bhts", g, vv).masked_fill(~mask[:, None], 0.0)
    ds = a * (da - (da * a).sum(-1, keepdim=True)) * scale
    dsc = ds.to(dt).float()
    dq = torch.einsum("bhts,bshd->bthd", dsc, _heads(k + p, n_head))
    dk = torch.einsum("bhts,bthd->bshd", dsc, qu)
    dp = torch.einsum("bhts,bthd->shd", dsc, qv)
    col = ds.sum(2).to(dt).float()  # [B, H, S]
    du = torch.einsum("bhs,bshd->hd", col, kk)
    dvb = torch.einsum("bhs,shd->hd", col, pp[0])
    return (dq.reshape(b, t, d).to(dt), dk.reshape(b, s, d).to(dt), dv.reshape(b, s, d).to(dt),
            dp.reshape(1, s, d).to(p.dtype), du.reshape(d).to(u_bias.dtype),
            dvb.reshape(d).to(v_bias.dtype))


def _aligned(*xs):
    """The kernels move 16-byte vectors: a tensor whose data does not start
    on 16 bytes (a view into a packed buffer, as ZeRO-3's flat parameters
    are) is copied into storage of its own; the others pass as they are."""
    return tuple(x if x is None or x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def _check(q, k, p, v, u_bias, v_bias, mask, n_head, do=None, out32=None, lse=None):
    b, t, d = q.shape
    s = k.shape[1]
    if d % n_head or d // n_head not in KERNEL_DKS:
        raise ValueError(f"relpos_attention: head width {d}/{n_head} not in {KERNEL_DKS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"relpos_attention: dtype {q.dtype} not supported")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and max(t, s) > MAX_LEN_BF16:
        raise ValueError(f"relpos_attention: bf16 T and S at most {MAX_LEN_BF16}, got {t}, {s}")
    expect = {"q": (b, t, d), "k": (b, s, d), "v": (b, s, d), "p": (1, s, d),
              "u_bias": (d,), "v_bias": (d,), "do": (b, t, d)}
    named = {"q": q, "k": k, "v": v, "p": p, "u_bias": u_bias, "v_bias": v_bias, "do": do}
    for name, x in named.items():
        if x is None:
            continue
        if tuple(x.shape) != expect[name]:
            raise ValueError(f"relpos_attention: {name} shape {tuple(x.shape)}, "
                             f"expected {expect[name]}")
        if x.device != q.device or x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(f"relpos_attention: {name} must be contiguous {q.dtype} "
                             f"on {q.device}")
    for name, x, shape in (("out", out32, (b, t, d)), ("lse", lse, (b, n_head, t))):
        if x is not None and (tuple(x.shape) != shape or x.dtype != torch.float32
                              or x.device != q.device or not x.is_contiguous()
                              or x.data_ptr() % 16):
            raise ValueError(f"relpos_attention: {name} must be contiguous 16-byte aligned "
                             f"fp32 {shape} on {q.device}")
    if (mask.dtype != torch.bool or mask.device != q.device or mask.dim() != 3
            or mask.shape[0] != b or mask.shape[1] not in (1, t) or mask.shape[2] != s):
        raise ValueError(f"relpos_attention: mask must be bool [B, T|1, S] on {q.device}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    msb, mst, mss = mask.stride()
    return b, t, s, d, (msb, 0 if mask.shape[1] == 1 else mst, mss)


def _relpos_fwd(q, k, p, v, u_bias, v_bias, mask, scale, n_head, saved: bool = False):
    """Kernel #2, or the plain version for CPU tensors; with `saved`, ->
    (out, out32, lse) as `relpos_attention_plain` returns them, what the
    backward reads (fp32: out32 is out)."""
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, p, v, u_bias, v_bias, mask, scale, n_head, saved)
    q, k, p, v, u_bias, v_bias = _aligned(q, k, p, v, u_bias, v_bias)
    b, t, s, d, strides = _check(q, k, p, v, u_bias, v_bias, mask, n_head)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    out32 = lse = None
    if saved:
        out32 = torch.empty(b, t, d, dtype=torch.float32, device=q.device) if bf16 else out
        lse = torch.empty(b, n_head, t, dtype=torch.float32, device=q.device)
    if b and t:
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("relpos_attention", q.data_ptr(), k.data_ptr(), p.data_ptr(),
                          v.data_ptr(), u_bias.data_ptr(), v_bias.data_ptr(), mask.data_ptr(),
                          out.data_ptr(), ptr(out32) if bf16 else None, ptr(lse), b, t, s,
                          n_head, d // n_head, *strides, float(scale), int(bf16), stream)
    return (out, out32, lse) if saved else out


def relpos_attention_bwd(q, k, p, v, u_bias, v_bias, mask, do, scale: float, n_head: int,
                         out=None, lse=None):
    """Kernel #3: -> (dq, dk, dv, dp, du, dvb) as `relpos_attention_bwd_plain`
    returns them, for the output's gradient do [B, T, D] in q's type. The
    kernels start from the forward's fp32 output and log-sum-exp (`out`,
    `lse`: out32 and lse of `_relpos_fwd(..., saved=True)`); without them a
    call computes them first through kernel #2 (a launch of #2). CPU tensors
    take the plain version."""
    if q.device.type == "cpu":
        return relpos_attention_bwd_plain(q, k, p, v, u_bias, v_bias, mask, do, scale, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    bf16 = q.dtype == torch.bfloat16
    q, k, p, v, u_bias, v_bias, do = _aligned(q, k, p, v, u_bias, v_bias, do)
    b, t, s, d, strides = _check(q, k, p, v, u_bias, v_bias, mask, n_head, do, out, lse)
    empty = b == 0 or t == 0 or s == 0  # nothing attends: every gradient is 0
    dq, dk, dv = ((torch.zeros_like if empty else torch.empty_like)(x) for x in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    # dp, du and dvb in one buffer: one cast to the inputs' type instead of
    # three. The bf16 kernels add into it (zeroed); the fp32 ones sum their
    # partials (`part`) into it in a fixed order.
    acc = (torch.zeros if bf16 or empty else torch.empty)(s * d + 2 * d, **f32)
    dp, du, dvb = acc[:s * d], acc[s * d:-d], acc[-d:]
    if not empty:
        if out is None or lse is None:
            _, out, lse = _relpos_fwd(q, k, p, v, u_bias, v_bias, mask, scale, n_head, True)
        # each row's rowsum(do * out), and [q+u | q+v] for the key side
        stats = torch.empty(b, n_head, t, **f32)
        qc = torch.empty(b, n_head, t, 2 * d // n_head, dtype=q.dtype, device=q.device)
        # fp32: the key side's dp rows of each batch, and du | dvb of each
        # batch and tile of 64 keys
        part = None if bf16 else torch.empty(b * s * d + b * -(-s // 64) * 2 * d, **f32)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("relpos_attention_bwd", q.data_ptr(), k.data_ptr(), p.data_ptr(),
                          v.data_ptr(), u_bias.data_ptr(), v_bias.data_ptr(), mask.data_ptr(),
                          do.data_ptr(), out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), dp.data_ptr(), du.data_ptr(),
                          dvb.data_ptr(), stats.data_ptr(), qc.data_ptr(), ptr(part), b, t, s,
                          n_head, d // n_head, *strides, float(scale), int(bf16), stream)
    acc = acc.to(q.dtype)  # every input has q's type (_check)
    return dq, dk, dv, acc[:s * d].view(1, s, d), acc[s * d:-d], acc[-d:]


class _RelPosAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, p, v, u_bias, v_bias, mask, scale, n_head):
        args = (q, k, p, v, u_bias, v_bias, mask, scale, n_head)
        if q.is_cuda:  # what the kernels' backward starts from
            out, out32, lse = _relpos_fwd(*args, saved=True)
        else:
            out, out32, lse = _relpos_fwd(*args), None, None
        ctx.save_for_backward(q, k, p, v, u_bias, v_bias, mask, out32, lse)
        ctx.scale, ctx.n_head = scale, n_head
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, p, v, u_bias, v_bias, mask, out32, lse = ctx.saved_tensors
        dq, dk, dv, dp, du, dvb = relpos_attention_bwd(q, k, p, v, u_bias, v_bias, mask,
                                                       do.contiguous(), ctx.scale, ctx.n_head,
                                                       out32, lse)
        return dq, dk, dp, dv, du, dvb, None, None, None


def relpos_attention(q, k, p, v, u_bias, v_bias, mask, scale: float,
                     n_head: int) -> torch.Tensor:
    """-> [B, T, D] in q's type, differentiable w.r.t. q, k, p, v and the
    biases (kernels #2 forward and #3 backward on the card). q: [B, T, D];
    k/v: [B, S, D]; p: [1, S, D] (batch-shared positional projection);
    u_bias/v_bias: [D] (per-head slices); mask: [B, T|1, S] bool, True =
    attend (any strides); scale = 1/sqrt(dk). D = n_head * dk. CPU tensors
    take the plain versions. Without a gradient to compute (serving) the
    forward runs alone and saves nothing."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, p, v, u_bias, v_bias))):
        return _relpos_fwd(q, k, p, v, u_bias, v_bias, mask, scale, n_head)
    return _RelPosAttention.apply(q, k, p, v, u_bias, v_bias, mask, scale, n_head)
