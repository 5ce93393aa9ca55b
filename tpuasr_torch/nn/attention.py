"""Multi-head self-attention (port of ``tpuasr/nn/attention.py``): the
rel-pos attention of the flagship and the attention zoo (plain MHA with
grouped K/V heads, Shaw's learned relative positions, RoPE, FireRed's
Transformer-XL attention).

Rel-pos attention (``tpuasr/nn/attention.py:28-140``):
Transformer-XL u/v biases with `rel_shift` disabled, so the positional term
is ``(q + pos_bias_v) . linear_pos(PE_keys)^T`` over the absolute positions
of the keys. The streaming cache is a fixed-capacity right-aligned (k, v)
window [B, A, H, dk]; this module concatenates the chunk to it and returns
the [B, A + T1, H, dk] window for the caller to trim.

The full-context path (no cache) follows `fused`, the encoder's
`fused_attention` switch, under the gating of `tpuasr/nn/attention.py:111-112`
(no cache, no attention dropout; the module always has a mask and a
batch-shared positional projection p):
- True: `tpuasr_torch.ops.relpos_attention`, an autograd Function whose
  forward and backward are the hand-written kernels #2 and #3 for tensors on
  the card and their plain versions on the CPU; it serves and trains;
- False, or a dropout rate above 0: the plain formula
  `relpos_attention_plain` in torch ops, with autograd.
The cache path takes the plain formula too. It scores and softmaxes in fp32
and rounds the probabilities to v's type before a.v, in every compute type.
With a dropout generator (training) and a rate above 0, the probabilities
are dropped out as flax's ``nn.Dropout`` does (tpuasr/nn/attention.py:136-138),
the keep mask [B, H, T1, T2] drawn from that generator.

The zoo (``tpuasr/nn/attention.py:143-347``) is plain PyTorch in every
route: none of it reaches a TPU kernel. Its scores and softmax are fp32,
the probabilities rounded to v's type before a.v, as above; its caches are
the same right-aligned windows, K/V at `n_kv_head` heads for MHA and RoPE
(GQA; the heads repeated for the scores), RoPE's keys cached already
rotated. FireRed's attention is full-context only and raises on a cache,
as the JAX package asserts.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.ops.relpos_attention import _probs, relpos_attention, relpos_attention_plain


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 fused: bool = False, device=None):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by n_head {n_head}")
        self.n_head, self.d_k, self.fused = n_head, n_feat // n_head, fused
        self.dropout_rate = dropout_rate
        self.linear_q = Dense(n_feat, n_feat, device=device)
        self.linear_k = Dense(n_feat, n_feat, device=device)
        self.linear_v = Dense(n_feat, n_feat, device=device)
        self.linear_out = Dense(n_feat, n_feat, device=device)
        self.linear_pos = Dense(n_feat, n_feat, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, pos_emb: torch.Tensor,
                cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                gen: Optional[torch.Generator] = None):
        """x [B, T1, D]; mask [B, T1|1, T2] bool, True = attend; pos_emb
        [1, T2, D] PE of the key positions; cache ([B, A, H, dk], [B, A, H, dk])
        or None; gen: the dropout generator, None for none -> (out [B, T1, D],
        (k, v) windows [B, T2, H, dk])."""
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
        args = (q, k.reshape(b, t2, d), p.reshape(1, t2, d), v.reshape(b, t2, d),
                self.pos_bias_u.to(q.dtype).reshape(-1), self.pos_bias_v.to(q.dtype).reshape(-1),
                mask, 1.0 / math.sqrt(dk), h)
        if self.fused and cache is None and self.dropout_rate == 0.0:
            out = relpos_attention(*args)
        else:
            out = relpos_attention_plain(*args, dropout_rate=self.dropout_rate, gen=gen)
        return self.linear_out(out), (k, v)


def repeat_kv(z: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, Hkv, dk] -> [B, T, H, dk], each K/V head repeated for its
    group of query heads (wenet attention.py:217-243)."""
    hkv = z.shape[2]
    if hkv == n_head:
        return z
    if n_head % hkv:
        raise ValueError(f"n_head {n_head} not a multiple of n_kv_head {hkv}")
    return z.repeat_interleave(n_head // hkv, dim=2)


def _attend(q, k, v, mask, extra, gen, rate: float):
    """softmax((q.k^T + extra) / sqrt(dk)) . v over [B, T, H, dk] heads
    (k and v already at q's head count); extra: fp32 [B|1, H|1, T1, T2]
    position scores or None -> [B, T1, H * dk] in q's type."""
    b, t1, h, dk = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if extra is not None:
        scores = scores + extra
    scores = scores / math.sqrt(dk)
    if mask is None:
        a = torch.softmax(scores, dim=-1)
    else:
        a = _probs(scores, mask)
    a = dropout(a, rate, gen)
    out = torch.einsum("bhts,bshd->bthd", a.to(v.dtype).float(), v.float())
    return out.reshape(b, t1, h * dk).to(q.dtype)


class _ZooAttention(nn.Module):
    """q/k/v/out projections of the zoo: K/V at `n_kv_head` heads."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 n_kv_head: int = 0, device=None):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by n_head {n_head}")
        self.n_head, self.d_k = n_head, n_feat // n_head
        self.n_kv_head = n_kv_head or n_head
        self.dropout_rate = dropout_rate
        kv = self.n_kv_head * self.d_k
        self.linear_q = Dense(n_feat, n_feat, device=device)
        self.linear_k = Dense(n_feat, kv, device=device)
        self.linear_v = Dense(n_feat, kv, device=device)
        self.linear_out = Dense(n_feat, n_feat, device=device)

    def _qkv(self, xq, xk, xv):
        b, t1, _ = xq.shape
        hk, dk = self.n_kv_head, self.d_k
        return (self.linear_q(xq).view(b, t1, self.n_head, dk),
                self.linear_k(xk).view(b, t1, hk, dk), self.linear_v(xv).view(b, t1, hk, dk))

    @staticmethod
    def _cat(cache, k, v):
        if cache is None:
            return k, v
        return torch.cat([cache[0].to(k.dtype), k], dim=1), torch.cat([cache[1].to(v.dtype), v],
                                                                       dim=1)


class MultiHeadedAttention(_ZooAttention):
    """Scaled dot-product MHA (the abs-pos encoders; pos_emb ignored), with
    `n_kv_head` < n_head for GQA (MQA at 1); tpuasr/nn/attention.py:153-184."""

    def forward(self, x, mask, pos_emb=None, cache=None, gen=None):
        q, k, v = self._qkv(x, x, x)
        k, v = self._cat(cache, k, v)
        h = self.n_head
        out = _attend(q, repeat_kv(k, h), repeat_kv(v, h), mask, None, gen, self.dropout_rate)
        return self.linear_out(out), (k, v)


class ShawRelPositionMultiHeadedAttention(_ZooAttention):
    """Shaw-style learned relative positions (arXiv:1803.02155;
    tpuasr/nn/attention.py:187-236): scores[i, j] += q_i .
    rel_k[clip(j - i, -max_left, max_right)], the queries being the last T1
    positions of the T2-long key window, so the cached window needs no
    offset."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 max_left_rel_pos: int = 64, max_right_rel_pos: int = 8, device=None):
        super().__init__(n_head, n_feat, dropout_rate, device=device)
        self.max_left, self.max_right = max_left_rel_pos, max_right_rel_pos
        self.rel_k_embed = nn.Parameter(torch.zeros(max_left_rel_pos + max_right_rel_pos + 1,
                                                    self.d_k, device=device))

    def forward(self, x, mask, pos_emb=None, cache=None, gen=None):
        q, k, v = self._qkv(x, x, x)
        k, v = self._cat(cache, k, v)
        t1, t2 = q.shape[1], k.shape[1]
        qpos = torch.arange(t1, device=x.device)[:, None] + (t2 - t1)
        rel = (torch.arange(t2, device=x.device)[None, :] - qpos).clamp(-self.max_left,
                                                                         self.max_right)
        rel_k = self.rel_k_embed.to(q.dtype)[rel + self.max_left]  # [T1, T2, dk]
        extra = torch.einsum("bthd,tsd->bhts", q.float(), rel_k.float())
        out = _attend(q, k, v, mask, extra, gen, self.dropout_rate)
        return self.linear_out(out), (k, v)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, non-interleaved half split: x [B, T, H, dk], cos and
    sin [1|B, T, dk]."""
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + rotate_half(x) * sin


class RopeMultiHeadedAttention(_ZooAttention):
    """RoPE attention (tpuasr/nn/attention.py:252-285): the window's q and k
    rotated by their absolute positions before the scores; cached keys carry
    their own rotation, so a chunk needs only its own angles. pos_emb is
    (cos, sin), each [1, T1, dk]. GQA through `n_kv_head`."""

    def forward(self, x, mask, pos_emb, cache=None, gen=None):
        cos, sin = pos_emb
        q, k, v = self._qkv(x, x, x)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        k, v = self._cat(cache, k, v)
        h = self.n_head
        out = _attend(q, repeat_kv(k, h), repeat_kv(v, h), mask, None, gen, self.dropout_rate)
        return self.linear_out(out), (k, v)


def rel_shift_bidirectional(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift: x [B, H, T, 2T-1] scored against the
    window of positions T-1 .. -(T-1) -> [B, H, T, T], out[..., i, j] the
    entry of relative position i - j."""
    b, h, t, p = x.shape
    xp = torch.nn.functional.pad(x, (1, 0)).reshape(b, h, p + 1, t)
    return xp[:, :, 1:].reshape(b, h, t, p)[..., : p // 2 + 1]


class FireRedRelPositionAttention(nn.Module):
    """FireRed's Transformer-XL attention (tpuasr/nn/attention.py:301-347):
    layer norms on the inputs of the q/k/v projections, u/v positional
    biases and the bidirectional window with rel_shift. Full context only."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by n_head {n_head}")
        self.n_head, self.d_k = n_head, n_feat // n_head
        self.dropout_rate = dropout_rate
        for name in ("q", "k", "v"):
            setattr(self, f"layer_norm_{name}", LayerNorm(n_feat, device=device))
            setattr(self, f"linear_{name}", Dense(n_feat, n_feat, device=device))
        self.linear_out = Dense(n_feat, n_feat, device=device)
        self.linear_pos = Dense(n_feat, n_feat, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))

    def forward(self, x, mask, pos_emb, cache=None, gen=None):
        if cache is not None:
            raise NotImplementedError("FireRed attention is full-context only (the JAX "
                                      "package asserts so too)")
        b, t, _ = x.shape
        h, dk = self.n_head, self.d_k
        q = self.linear_q(self.layer_norm_q(x)).view(b, t, h, dk)
        k = self.linear_k(self.layer_norm_k(x)).view(b, t, h, dk)
        v = self.linear_v(self.layer_norm_v(x)).view(b, t, h, dk)
        p = self.linear_pos(pos_emb).view(pos_emb.shape[0], -1, h, dk)  # [1, 2T-1, H, dk]
        q_u = q + self.pos_bias_u.to(q.dtype)
        q_v = q + self.pos_bias_v.to(q.dtype)
        bd = rel_shift_bidirectional(torch.einsum("bthd,pshd->bhts", q_v.float(), p.float()))
        out = _attend(q_u, k, v, mask, bd, gen, self.dropout_rate)
        return self.linear_out(out), None
