"""SANM (self-attention with FSMN memory) layers and the LFR front end, the
Paraformer's released stack (port of ``tpuasr/nn/sanm.py``).

- `lfr`: low-frame-rate stacking, one clamped-index gather: frame t' is the
  m frames around n·t', out-of-range indices clamped to the first / last
  valid frame (the reference's edge padding), with the reference's exact
  length arithmetic.
- `FsmnBlock`: the memory block, a depthwise 1-D convolution over the
  masked values (left pad (k-1)//2 + shift), plus the input, masked.
- `SanmAttention`: fused q/k/v projection, FSMN memory over v, ``att +
  fsmn``; `SanmCrossAttention`: fused k/v projection of the encoder
  memory. Both attend in plain PyTorch (the JAX module's einsum and softmax
  run outside any Pallas kernel): scores in the compute type, masked with
  -1e9, the softmax, the masked probabilities zeroed again.
- `SanmEncoder`: whisper sinusoids at the LFR width (rows 1..t) over the
  input scaled by sqrt(output_size), then pre-norm blocks; block 0 projects
  the LFR width down and drops its attention residual.
- `SanmDecoder`: blocks of FFN -> FSMN memory -> cross-attention, the
  `decoders3` tail FFN without a residual, after_norm, the output
  projection. Its block and tail norms use eps 1e-12 (`after_norm` and the
  FFN's inner norm flax's 1e-6), as the JAX module sets them.

Dropout draws from an explicit generator (`tpuasr_torch.nn.layers.dropout`):
none means deterministic. Parameters stay fp32; the encoder casts its input
to the compute type after the positional table, so every product runs in
it, as flax's ``Dense(dtype=...)`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.nn.embedding import whisper_sinusoid_table
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.masks import make_pad_mask

_NEG = -1.0e9


def lfr(x: torch.Tensor, x_lens: torch.Tensor, m: int = 7, n: int = 6):
    """Low-frame-rate stacking: [B, T, D], [B] -> ([B, T_out, m*D], new lens
    [B]). T_out is a static bound at least every new length."""
    b, t, d = x.shape
    left = (m - 1) // 2
    t_out = (left + t + m - 1) // n + 1
    dev = x.device
    idx = (torch.arange(t_out, device=dev) * n)[:, None] + torch.arange(m, device=dev)[None, :]
    idx = idx - left
    lens = x_lens.to(dev).long()
    idx = torch.minimum(idx[None].clamp(min=0), (lens - 1).clamp(min=0)[:, None, None])
    frames = torch.gather(x, 1, idx.reshape(b, -1, 1).expand(-1, -1, d))
    stacked = frames.reshape(b, t_out, m * d)
    # the reference's length arithmetic (wenet/paraformer/layers.py:45-57)
    n_lfr = -(-lens // n)
    prepad = lens + left
    right = torch.clamp(m - (prepad - n * (n_lfr - 1)), min=0)
    return stacked, ((prepad + right) // n).to(x_lens.dtype)


def _depthwise(conv: nn.Conv1d, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """A depthwise (or grouped) conv over time in x's type: x [B, T, C],
    padded by `left` / `right` frames of zeros -> [B, T', C]."""
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    y = F.conv1d(F.pad(x.transpose(1, 2), (left, right)), conv.weight.to(dt), bias,
                 groups=conv.groups)
    return y.transpose(1, 2)


class FsmnBlock(nn.Module):
    """y = dropout(conv(x · mask) + x · mask) · mask, the conv depthwise and
    bias-free (wenet/paraformer/attention.py:64-85)."""

    def __init__(self, n_feat: int, kernel_size: int, sanm_shift: int = 0,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.left = (kernel_size - 1) // 2 + sanm_shift
        self.right = kernel_size - 1 - self.left
        self.dropout_rate = dropout_rate
        # weight [C, 1, K] (flax's kernel is [K, 1, C])
        self.fsmn_block = nn.Conv1d(n_feat, n_feat, kernel_size, groups=n_feat, bias=False,
                                    device=device)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, gen=None) -> torch.Tensor:
        """x [B, T, D], pad_mask [B, T] True = valid."""
        valid = pad_mask[..., None]
        x = torch.where(valid, x, 0)
        y = _depthwise(self.fsmn_block, x, self.left, self.right)
        return torch.where(valid, dropout(y + x, self.dropout_rate, gen), 0)


def _attend(q, k, v, mask, rate: float, gen) -> torch.Tensor:
    """q [B, Tq, H, dk], k/v [B, Tk, H, dk], mask [B, Tq|1, Tk] (True =
    attend) -> [B, Tq, H*dk]."""
    b, tq, _, d_k = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k) / torch.sqrt(
        torch.tensor(float(d_k), dtype=q.dtype))
    keep = mask[:, None]
    scores = scores.masked_fill(~keep, _NEG)
    attn = torch.where(keep, torch.softmax(scores, dim=-1), 0)
    attn = dropout(attn, rate, gen)
    return torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, tq, -1)


class SanmAttention(nn.Module):
    """Self-attention + FSMN memory over v, one fused q/k/v projection from
    `in_size` (the LFR width in encoder block 0) to 3 · n_feat
    (wenet/paraformer/attention.py:8-114)."""

    def __init__(self, n_head: int, in_size: int, n_feat: int, kernel_size: int,
                 sanm_shift: int = 0, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.h, self.n_feat, self.dropout_rate = n_head, n_feat, dropout_rate
        self.linear_q_k_v = Dense(in_size, 3 * n_feat, device=device)
        self.fsmn = FsmnBlock(n_feat, kernel_size, sanm_shift, dropout_rate, device)
        self.linear_out = Dense(n_feat, n_feat, device=device)

    def forward(self, x, att_mask, pad_mask, gen=None) -> torch.Tensor:
        """x [B, T, in], att_mask [B, 1|T, T], pad_mask [B, T] -> [B, T, D]."""
        b, t = x.shape[:2]
        q, k, v = self.linear_q_k_v(x).split(self.n_feat, dim=-1)
        fsmn = self.fsmn(v, pad_mask, gen)
        heads = lambda z: z.reshape(b, t, self.h, -1)
        att = _attend(heads(q), heads(k), heads(v), att_mask, self.dropout_rate, gen)
        return self.linear_out(att) + fsmn


class SanmCrossAttention(nn.Module):
    """Cross-attention with a fused k/v projection of the encoder memory
    (wenet/paraformer/attention.py:161-217)."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.h, self.n_feat, self.dropout_rate = n_head, n_feat, dropout_rate
        self.linear_q = Dense(n_feat, n_feat, device=device)
        self.linear_k_v = Dense(n_feat, 2 * n_feat, device=device)
        self.linear_out = Dense(n_feat, n_feat, device=device)

    def forward(self, x, memory, mem_mask, gen=None) -> torch.Tensor:
        """x [B, U, D], memory [B, T, D], mem_mask [B, 1, T] -> [B, U, D]."""
        b, u = x.shape[:2]
        t = memory.shape[1]
        q = self.linear_q(x).reshape(b, u, self.h, -1)
        k, v = self.linear_k_v(memory).split(self.n_feat, dim=-1)
        att = _attend(q, k.reshape(b, t, self.h, -1), v.reshape(b, t, self.h, -1), mem_mask,
                      self.dropout_rate, gen)
        return self.linear_out(att)


class Ffn(nn.Module):
    """The encoder's position-wise FFN: w_2(dropout(relu(w_1(x))))."""

    def __init__(self, n_feat: int, hidden: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.w_1 = Dense(n_feat, hidden, device=device)
        self.w_2 = Dense(hidden, n_feat, device=device)

    def forward(self, x, gen=None) -> torch.Tensor:
        return self.w_2(dropout(torch.relu(self.w_1(x)), self.dropout_rate, gen))


class FfnDecoderSanm(nn.Module):
    """The decoder's FFN: w_2(norm(dropout(relu(w_1(x))))), w_2 bias-free,
    the norm at flax's eps 1e-6 (wenet/paraformer/layers.py:96-121)."""

    def __init__(self, n_feat: int, hidden: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.w_1 = Dense(n_feat, hidden, device=device)
        self.norm = LayerNorm(hidden, device=device)
        self.w_2 = Dense(hidden, n_feat, bias=False, device=device)

    def forward(self, x, gen=None) -> torch.Tensor:
        y = dropout(torch.relu(self.w_1(x)), self.dropout_rate, gen)
        return self.w_2(self.norm(y))


class SanmEncoderLayer(nn.Module):
    """Pre-norm block; with `in_size` other than n_feat (block 0) it projects
    the input width down and drops the attention residual
    (wenet/paraformer/layers.py:124-178)."""

    def __init__(self, n_head: int, n_feat: int, hidden: int, kernel_size: int,
                 sanm_shift: int = 0, dropout_rate: float = 0.0, in_size: int = 0,
                 device=None):
        super().__init__()
        width = in_size or n_feat
        self.residual = width == n_feat
        self.dropout_rate = dropout_rate
        self.norm1 = LayerNorm(width, device=device)
        self.self_attn = SanmAttention(n_head, width, n_feat, kernel_size, sanm_shift,
                                       dropout_rate, device)
        self.norm2 = LayerNorm(n_feat, device=device)
        self.feed_forward = Ffn(n_feat, hidden, dropout_rate, device)

    def forward(self, x, att_mask, pad_mask, gen=None) -> torch.Tensor:
        att = dropout(self.self_attn(self.norm1(x), att_mask, pad_mask, gen),
                      self.dropout_rate, gen)
        x = x + att if self.residual else att
        return x + dropout(self.feed_forward(self.norm2(x), gen), self.dropout_rate, gen)


class SanmEncoder(nn.Module):
    """LFR-width input -> whisper sinusoids -> SANM blocks -> after_norm
    (wenet/paraformer/layers.py:181-297). Full context; one output frame
    per LFR frame."""

    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, kernel_size: int = 11,
                 sanm_shift: int = 0, dropout_rate: float = 0.1, max_len: int = 5000,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.output_size, self.dropout_rate, self.dtype = output_size, dropout_rate, dtype
        # rows 1..t of the table at the input width (paraformer/embedding.py:4-14)
        self.register_buffer("pe", torch.from_numpy(whisper_sinusoid_table(max_len, input_size))
                             .to(device), persistent=False)
        layer = lambda in_size: SanmEncoderLayer(
            attention_heads, output_size, linear_units, kernel_size, sanm_shift, dropout_rate,
            in_size, device)
        self.layers = nn.ModuleList([layer(input_size)]
                                    + [layer(0) for _ in range(1, num_blocks)])
        self.after_norm = LayerNorm(output_size, device=device)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor, gen=None):
        """[B, T, input_size], [B] -> ([B, T, output_size], pad mask [B, T]
        True = valid)."""
        t = xs.shape[1]
        xs = xs * torch.tensor(math.sqrt(self.output_size), dtype=xs.dtype) \
            + self.pe[1:t + 1].to(xs.dtype)
        xs = dropout(xs, self.dropout_rate, gen).to(self.dtype)
        pad_mask = ~make_pad_mask(xs_lens.to(xs.device), t)
        att_mask = pad_mask[:, None, :]
        for layer in self.layers:
            xs = layer(xs, att_mask, pad_mask, gen)
        return self.after_norm(xs), pad_mask


class SanmDecoderLayer(nn.Module):
    """FFN -> FSMN memory (the residual from the block's input) ->
    cross-attention (wenet/paraformer/layers.py:313-378); norms at eps
    1e-12."""

    def __init__(self, n_head: int, n_feat: int, hidden: int, kernel_size: int,
                 sanm_shift: int = 0, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm1 = LayerNorm(n_feat, device=device, eps=1e-12)
        self.feed_forward = FfnDecoderSanm(n_feat, hidden, dropout_rate, device)
        self.norm2 = LayerNorm(n_feat, device=device, eps=1e-12)
        # DummyMultiHeadSANM: the FSMN block alone (paraformer/attention.py:117-158)
        self.self_attn = FsmnBlock(n_feat, kernel_size, sanm_shift, dropout_rate, device)
        self.norm3 = LayerNorm(n_feat, device=device, eps=1e-12)
        self.src_attn = SanmCrossAttention(n_head, n_feat, dropout_rate, device)

    def forward(self, tgt, tgt_pad, memory, mem_mask, gen=None) -> torch.Tensor:
        y = self.norm2(self.feed_forward(self.norm1(tgt), gen))
        mem = self.self_attn(torch.where(tgt_pad[..., None], y, 0), tgt_pad, gen)
        x = tgt + dropout(mem, self.dropout_rate, gen)
        cross = self.src_attn(self.norm3(x), memory, mem_mask, gen)
        return x + dropout(cross, self.dropout_rate, gen)


class SanmDecoder(nn.Module):
    """The bidirectional NAR decoder over CIF embeddings
    (wenet/paraformer/layers.py:381-494): no token embedding and no
    positional table; the block stack, the `decoders3` FFN without a
    residual, after_norm, the output projection."""

    def __init__(self, vocab_size: int, n_feat: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, kernel_size: int = 11,
                 sanm_shift: int = 0, dropout_rate: float = 0.1, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            SanmDecoderLayer(attention_heads, n_feat, linear_units, kernel_size, sanm_shift,
                             dropout_rate, device) for _ in range(num_blocks))
        self.norm3_tail = LayerNorm(n_feat, device=device, eps=1e-12)
        self.decoders3 = FfnDecoderSanm(n_feat, linear_units, dropout_rate, device)
        self.after_norm = LayerNorm(n_feat, device=device)
        self.output_layer = Dense(n_feat, vocab_size, device=device)

    def forward(self, memory, mem_lens, embeds, embed_lens, gen=None) -> torch.Tensor:
        """memory [B, T, D], embeds [B, U, D] -> logits [B, U, V] in the
        embeddings' type."""
        u = embeds.shape[1]
        tgt_pad = ~make_pad_mask(embed_lens.to(embeds.device), u)
        mem_mask = ~make_pad_mask(mem_lens.to(memory.device), memory.shape[1])[:, None, :]
        x = embeds
        for layer in self.layers:
            x = layer(x, tgt_pad, memory, mem_mask, gen)
        x = self.decoders3(self.norm3_tail(x), gen)
        return self.output_layer(self.after_norm(x))
