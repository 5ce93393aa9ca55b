"""Multi-head attention with wenet-style relative positional bias (port of
``tpuasr/nn/attention.py:28-140``).

Transformer-XL u/v biases with `rel_shift` disabled, so the positional term
is ``(q + pos_bias_v) . linear_pos(PE_keys)^T`` over the absolute positions
of the keys. The streaming cache is a fixed-capacity right-aligned (k, v)
window [B, A, H, dk]; this module concatenates the chunk to it and returns
the [B, A + T1, H, dk] window for the caller to trim.

The full-context path (no cache) follows `fused`, the encoder's
`fused_attention` switch, as `tpuasr/nn/attention.py:111-140` does:
- True: `tpuasr_torch.ops.relpos_attention`, the hand-written kernel for
  tensors on the card (forward only: it raises when a gradient is asked for)
  and its plain version on the CPU;
- False: the plain formula `relpos_attention_plain` in torch ops, with
  autograd (the training path until the kernel's backward is ported).
The cache path takes the plain formula too. It scores and softmaxes in fp32
and rounds the probabilities to v's type before a.v, in every compute type.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tpuasr_torch.nn.layers import Dense
from tpuasr_torch.ops.relpos_attention import relpos_attention, relpos_attention_plain


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 fused: bool = False, device=None):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by n_head {n_head}")
        if dropout_rate != 0.0:
            raise NotImplementedError("attention dropout is not ported "
                                      "(encoder.attention_dropout_rate must be 0)")
        self.n_head, self.d_k, self.fused = n_head, n_feat // n_head, fused
        self.linear_q = Dense(n_feat, n_feat, device=device)
        self.linear_k = Dense(n_feat, n_feat, device=device)
        self.linear_v = Dense(n_feat, n_feat, device=device)
        self.linear_out = Dense(n_feat, n_feat, device=device)
        self.linear_pos = Dense(n_feat, n_feat, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, pos_emb: torch.Tensor,
                cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None):
        """x [B, T1, D]; mask [B, T1|1, T2] bool, True = attend; pos_emb
        [1, T2, D] PE of the key positions; cache ([B, A, H, dk], [B, A, H, dk])
        or None -> (out [B, T1, D], (k, v) windows [B, T2, H, dk])."""
        b, t1, d = x.shape
        h, dk = self.n_head, self.d_k
        q = self.linear_q(x)
        k = self.linear_k(x).view(b, t1, h, dk)
        v = self.linear_v(x).view(b, t1, h, dk)
        if cache is not None:
            k = torch.cat([cache[0].to(k.dtype), k], dim=1)  # [B, A+T1, H, dk]
            v = torch.cat([cache[1].to(v.dtype), v], dim=1)
        t2 = k.shape[1]
        p = self.linear_pos(pos_emb)
        attend = relpos_attention if self.fused and cache is None else relpos_attention_plain
        out = attend(q, k.reshape(b, t2, d), p.reshape(1, t2, d),
                     v.reshape(b, t2, d), self.pos_bias_u.to(q.dtype).reshape(-1),
                     self.pos_bias_v.to(q.dtype).reshape(-1), mask, 1.0 / math.sqrt(dk), h)
        return self.linear_out(out), (k, v)
