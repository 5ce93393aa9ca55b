"""Rel-pos self-attention forward: the hand-written CUDA kernel
(``csrc/relpos_attention.cu``) and its plain PyTorch version.

Counterpart of the forward of ``tpuasr/ops/attention_pallas.py``
(`fused_relpos_attention`); the backward comes with the training slice.
The wrapper runs the kernel for tensors on the card and the plain version for
tensors on the CPU; a CUDA tensor never takes the plain path.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops import _build

_NEG_INF = -1.0e9
KERNEL_DKS = (16, 32, 64)


def relpos_attention_plain(q, k, p, v, u_bias, v_bias, mask, scale: float,
                           n_head: int) -> torch.Tensor:
    """Plain PyTorch version, same contract as `relpos_attention`.

    q+u and q+v are formed in the input type; scores and softmax in fp32;
    the probabilities are cast to v's type before the a.v product, which
    accumulates in fp32."""
    b, t, d = q.shape
    s = k.shape[1]
    dk = d // n_head
    qu = (q + u_bias).reshape(b, t, n_head, dk).float()
    qv = (q + v_bias).reshape(b, t, n_head, dk).float()
    kk = k.reshape(b, s, n_head, dk).float()
    pp = p.reshape(1, s, n_head, dk).float()
    scores = (torch.einsum("bthd,bshd->bhts", qu, kk)
              + torch.einsum("bthd,pshd->bhts", qv, pp)) * scale
    m = mask[:, None]  # [B, 1, T|1, S]
    a = torch.softmax(scores.masked_fill(~m, _NEG_INF), dim=-1).masked_fill(~m, 0.0)
    vv = v.reshape(b, s, n_head, dk)
    out = torch.einsum("bhts,bshd->bthd", a.to(v.dtype).float(), vv.float())
    return out.reshape(b, t, d).to(q.dtype)


def relpos_attention(q, k, p, v, u_bias, v_bias, mask, scale: float,
                     n_head: int) -> torch.Tensor:
    """-> [B, T, D] in q's type. q: [B, T, D]; k/v: [B, S, D]; p: [1, S, D]
    (batch-shared positional projection); u_bias/v_bias: [D] (per-head
    slices); mask: [B, T|1, S] bool, True = attend (any strides); scale =
    1/sqrt(dk). D = n_head * dk. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, p, v, u_bias, v_bias, mask, scale, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    b, t, d = q.shape
    s = k.shape[1]
    if d % n_head or d // n_head not in KERNEL_DKS:
        raise ValueError(f"relpos_attention: head width {d}/{n_head} not in {KERNEL_DKS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"relpos_attention: dtype {q.dtype} not supported")
    expect = {"q": (b, t, d), "k": (b, s, d), "v": (b, s, d), "p": (1, s, d),
              "u_bias": (d,), "v_bias": (d,)}
    named = {"q": q, "k": k, "v": v, "p": p, "u_bias": u_bias, "v_bias": v_bias}
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
    if mask.shape[1] == 1:
        mst = 0
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("relpos_attention", q.data_ptr(), k.data_ptr(), p.data_ptr(),
                      v.data_ptr(), u_bias.data_ptr(), v_bias.data_ptr(), mask.data_ptr(),
                      out.data_ptr(), b, t, s, n_head, d // n_head, msb, mst, mss,
                      float(scale), int(q.dtype == torch.bfloat16), stream)
    return out
