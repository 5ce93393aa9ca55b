"""Rel-pos self-attention: the hand-written CUDA kernels
(``csrc/relpos_attention.cu``) and their plain PyTorch versions.

Counterpart of ``tpuasr/ops/attention_pallas.py`` (`fused_relpos_attention`):
`relpos_attention` is a `torch.autograd.Function` whose forward is TPU kernel
#2 (`_fused_fwd`) and whose backward is #3 (`_fused_bwd`,
`relpos_attention_bwd`), recomputing the scores rather than saving them. The
wrappers run the kernels for tensors on the card and the plain versions for
tensors on the CPU; a CUDA tensor never takes the plain path.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops import _build

_NEG_INF = -1.0e9
KERNEL_DKS = (16, 32, 64)


def _heads(x, n_head):
    """[B|1, L, D] -> fp32 [B|1, L, H, dk]."""
    return x.reshape(x.shape[0], x.shape[1], n_head, -1).float()


def _probs(qu, qv, kk, pp, mask, scale):
    """fp32 [B, H, T, S] probabilities; a row with every key masked is 0."""
    scores = (torch.einsum("bthd,bshd->bhts", qu, kk)
              + torch.einsum("bthd,pshd->bhts", qv, pp)) * scale
    m = mask[:, None]  # [B, 1, T|1, S]
    return torch.softmax(scores.masked_fill(~m, _NEG_INF), dim=-1).masked_fill(~m, 0.0)


def relpos_attention_plain(q, k, p, v, u_bias, v_bias, mask, scale: float,
                           n_head: int) -> torch.Tensor:
    """Plain PyTorch version, same contract as `relpos_attention`.

    q+u and q+v are formed in the input type; scores and softmax in fp32;
    the probabilities are cast to v's type before the a.v product, which
    accumulates in fp32."""
    b, t, d = q.shape
    a = _probs(_heads(q + u_bias, n_head), _heads(q + v_bias, n_head), _heads(k, n_head),
               _heads(p, n_head), mask, scale)
    vv = v.reshape(b, -1, n_head, d // n_head)
    out = torch.einsum("bhts,bshd->bthd", a.to(v.dtype).float(), vv.float())
    return out.reshape(b, t, d).to(q.dtype)


def relpos_attention_bwd_plain(q, k, p, v, u_bias, v_bias, mask, do, scale: float,
                               n_head: int):
    """-> (dq, dk, dv, dp [1, S, D], du [D], dvb [D]) for the output's
    gradient do, plain PyTorch at the rounding points of `_bwd_kernel`
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
    a = _probs(qu, qv, kk, pp, mask, scale)
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


def _check(q, k, p, v, u_bias, v_bias, mask, n_head, do=None):
    b, t, d = q.shape
    s = k.shape[1]
    if d % n_head or d // n_head not in KERNEL_DKS:
        raise ValueError(f"relpos_attention: head width {d}/{n_head} not in {KERNEL_DKS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"relpos_attention: dtype {q.dtype} not supported")
    expect = {"q": (b, t, d), "k": (b, s, d), "v": (b, s, d), "p": (1, s, d),
              "u_bias": (d,), "v_bias": (d,), "do": (b, t, d)}
    named = {"q": q, "k": k, "v": v, "p": p, "u_bias": u_bias, "v_bias": v_bias}
    if do is not None:
        named["do"] = do
    for name, x in named.items():
        if tuple(x.shape) != expect[name]:
            raise ValueError(f"relpos_attention: {name} shape {tuple(x.shape)}, "
                             f"expected {expect[name]}")
        if x.device != q.device or x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(f"relpos_attention: {name} must be contiguous {q.dtype} "
                             f"on {q.device}")
    if (mask.dtype != torch.bool or mask.device != q.device or mask.dim() != 3
            or mask.shape[0] != b or mask.shape[1] not in (1, t) or mask.shape[2] != s):
        raise ValueError(f"relpos_attention: mask must be bool [B, T|1, S] on {q.device}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    msb, mst, mss = mask.stride()
    return b, t, s, d, (msb, 0 if mask.shape[1] == 1 else mst, mss)


def _relpos_fwd(q, k, p, v, u_bias, v_bias, mask, scale, n_head):
    """Kernel #2, or the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, p, v, u_bias, v_bias, mask, scale, n_head)
    b, t, s, d, strides = _check(q, k, p, v, u_bias, v_bias, mask, n_head)
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("relpos_attention", q.data_ptr(), k.data_ptr(), p.data_ptr(),
                      v.data_ptr(), u_bias.data_ptr(), v_bias.data_ptr(), mask.data_ptr(),
                      out.data_ptr(), b, t, s, n_head, d // n_head, *strides,
                      float(scale), int(q.dtype == torch.bfloat16), stream)
    return out


def relpos_attention_bwd(q, k, p, v, u_bias, v_bias, mask, do, scale: float, n_head: int):
    """Kernel #3: -> (dq, dk, dv, dp, du, dvb) as `relpos_attention_bwd_plain`
    returns them, for the output's gradient do [B, T, D] in q's type. CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return relpos_attention_bwd_plain(q, k, p, v, u_bias, v_bias, mask, do, scale, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    b, t, s, d, strides = _check(q, k, p, v, u_bias, v_bias, mask, n_head, do)
    empty = b == 0 or t == 0 or s == 0  # nothing attends: every gradient is 0
    dq, dk, dv = ((torch.zeros_like if empty else torch.empty_like)(x) for x in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    dp, du, dvb = torch.zeros(1, s, d, **f32), torch.zeros(d, **f32), torch.zeros(d, **f32)
    if not empty:
        stats = torch.empty(b, n_head, t, 3, **f32)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("relpos_attention_bwd", q.data_ptr(), k.data_ptr(), p.data_ptr(),
                          v.data_ptr(), u_bias.data_ptr(), v_bias.data_ptr(), mask.data_ptr(),
                          do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          dp.data_ptr(), du.data_ptr(), dvb.data_ptr(), stats.data_ptr(), b, t,
                          s, n_head, d // n_head, *strides, float(scale),
                          int(q.dtype == torch.bfloat16), stream)
    return dq, dk, dv, dp.to(p.dtype), du.to(u_bias.dtype), dvb.to(v_bias.dtype)


class _RelPosAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, p, v, u_bias, v_bias, mask, scale, n_head):
        ctx.save_for_backward(q, k, p, v, u_bias, v_bias, mask)
        ctx.scale, ctx.n_head = scale, n_head
        return _relpos_fwd(q, k, p, v, u_bias, v_bias, mask, scale, n_head)

    @staticmethod
    def backward(ctx, do):
        q, k, p, v, u_bias, v_bias, mask = ctx.saved_tensors
        dq, dk, dv, dp, du, dvb = relpos_attention_bwd(q, k, p, v, u_bias, v_bias, mask,
                                                       do.contiguous(), ctx.scale, ctx.n_head)
        return dq, dk, dp, dv, du, dvb, None, None, None


def relpos_attention(q, k, p, v, u_bias, v_bias, mask, scale: float,
                     n_head: int) -> torch.Tensor:
    """-> [B, T, D] in q's type, differentiable w.r.t. q, k, p, v and the
    biases (kernels #2 forward and #3 backward on the card). q: [B, T, D];
    k/v: [B, S, D]; p: [1, S, D] (batch-shared positional projection);
    u_bias/v_bias: [D] (per-head slices); mask: [B, T|1, S] bool, True =
    attend (any strides); scale = 1/sqrt(dk). D = n_head * dk. CPU tensors
    take the plain versions."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    return _RelPosAttention.apply(q, k, p, v, u_bias, v_bias, mask, scale, n_head)
