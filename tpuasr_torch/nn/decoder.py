"""Transformer attention decoder and the label-smoothing loss (port of
``tpuasr/nn/decoder.py``).

A pre-norm stack of self-attention, cross-attention over the encoder
output and a ReLU FFN over the embedded targets (absolute sinusoidal
positions), with causal and padding masks; dropout on each residual branch
and inside the FFN, drawn from an explicit generator. The attention is
plain PyTorch (the JAX module's einsum and softmax run outside any Pallas
kernel): scores in the compute type, masked with -1e9 in that type, the
softmax, then the masked probabilities zeroed again, so a padded query row
gives zeros rather than NaN.

Autoregressive decoding: `init_ar_cache` makes per-layer self-attention
buffers [L, B, Lmax, H, dk] that `forward_one_step` writes in place at the
step's position; `project_memory` projects the cross-attention K/V of every
layer once per utterance.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuasr_torch.nn.embedding import PositionalEncodingTable
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.masks import make_pad_mask, subsequent_mask

_NEG = -1.0e9


class _Attention(nn.Module):
    """Projected attention with separate q and kv entry points, so AR
    decoding can cache the projected K/V."""

    def __init__(self, n_head: int, n_feat: int, device=None):
        super().__init__()
        self.h, self.d_k, self.n_feat = n_head, n_feat // n_head, n_feat
        self.linear_q = Dense(n_feat, n_feat, device=device)
        self.linear_k = Dense(n_feat, n_feat, device=device)
        self.linear_v = Dense(n_feat, n_feat, device=device)
        self.linear_out = Dense(n_feat, n_feat, device=device)

    def project_q(self, q_in: torch.Tensor) -> torch.Tensor:
        return self.linear_q(q_in).view(q_in.shape[0], -1, self.h, self.d_k)

    def project_kv(self, kv_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = kv_in.shape[0]
        return (self.linear_k(kv_in).view(b, -1, self.h, self.d_k),
                self.linear_v(kv_in).view(b, -1, self.h, self.d_k))

    def attend(self, q, k, v, mask) -> torch.Tensor:
        """q [B, Tq, H, dk], k/v [B, Tk, H, dk], mask [B, Tq|1, Tk] (True =
        attend) -> [B, Tq, D]."""
        b, tq = q.shape[:2]
        scores = torch.einsum("bthd,bshd->bhts", q, k) / torch.sqrt(
            torch.tensor(float(self.d_k), dtype=q.dtype))
        keep = mask[:, None]
        scores = scores.masked_fill(~keep, _NEG)
        attn = torch.where(keep, torch.softmax(scores, dim=-1), 0)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, tq, self.n_feat)
        return self.linear_out(out)

    def forward(self, q_in, kv_in, mask) -> torch.Tensor:
        return self.attend(self.project_q(q_in), *self.project_kv(kv_in), mask)


class DecoderLayer(nn.Module):
    def __init__(self, n_head: int, n_feat: int, ffn_dim: int, dropout_rate: float = 0.1,
                 device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm1 = LayerNorm(n_feat, device=device)
        self.norm2 = LayerNorm(n_feat, device=device)
        self.norm3 = LayerNorm(n_feat, device=device)
        self.self_attn = _Attention(n_head, n_feat, device)
        self.src_attn = _Attention(n_head, n_feat, device)
        self.ffn1 = Dense(n_feat, ffn_dim, device=device)
        self.ffn2 = Dense(ffn_dim, n_feat, device=device)

    def _ffn(self, y, gen=None):
        return self.ffn2(dropout(torch.relu(self.ffn1(y)), self.dropout_rate, gen))

    def forward(self, x, self_mask, memory, memory_mask, gen=None):
        d = lambda y: dropout(y, self.dropout_rate, gen)
        y1 = self.norm1(x)
        x = x + d(self.self_attn(y1, y1, self_mask))
        x = x + d(self.src_attn(self.norm2(x), memory, memory_mask))
        return x + d(self._ffn(self.norm3(x), gen))

    def step(self, x_t, pos: int, kcache, vcache, mem_k, mem_v, mem_mask):
        """One AR step: x_t [B, 1, D]; kcache/vcache [B, Lmax, H, dk], written
        in place at `pos`; mem_k/mem_v the projected cross K/V -> y_t."""
        b, lmax = kcache.shape[:2]
        y = self.norm1(x_t)
        q = self.self_attn.project_q(y)
        k_t, v_t = self.self_attn.project_kv(y)
        kcache[:, pos] = k_t[:, 0]
        vcache[:, pos] = v_t[:, 0]
        step_mask = (torch.arange(lmax, device=x_t.device) <= pos)[None, None, :]
        x_t = x_t + self.self_attn.attend(q, kcache, vcache, step_mask.expand(b, 1, lmax))
        y = self.norm2(x_t)
        x_t = x_t + self.src_attn.attend(self.src_attn.project_q(y), mem_k, mem_v, mem_mask)
        return x_t + self._ffn(self.norm3(x_t))

    def project_memory(self, memory):
        return self.src_attn.project_kv(memory)


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, n_feat: int = 256, n_head: int = 4,
                 ffn_dim: int = 1024, num_blocks: int = 6, dropout_rate: float = 0.1,
                 max_len: int = 5000, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.n_feat, self.n_head, self.num_blocks = n_feat, n_head, num_blocks
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.embed = nn.Embedding(vocab_size, n_feat, device=device)
        self.embed.init_std = n_feat ** -0.5  # flax nn.Embed's default (`init_weights`)
        self.pe = PositionalEncodingTable(n_feat, max_len, device)
        self.layers = nn.ModuleList(
            DecoderLayer(n_head, n_feat, ffn_dim, dropout_rate, device)
            for _ in range(num_blocks))
        self.after_norm = LayerNorm(n_feat, device=device)
        self.output_layer = Dense(n_feat, vocab_size, device=device)

    def forward(self, memory, memory_lens, ys_in, ys_lens, gen=None, inputs_embeds=None,
                causal: bool = True) -> torch.Tensor:
        """Teacher-forced forward: memory [B, T, D] (the encoder output),
        memory_lens [B], ys_in [B, L] (targets with <sos> prepended), ys_lens
        [B] -> logits [B, L, V] in the compute type. `inputs_embeds` [B, L, D]
        replaces the token embedding (Paraformer's acoustic embeddings);
        `causal=False` gives bidirectional self-attention. gen: the dropout
        generator, None for none."""
        if inputs_embeds is not None:
            x, _ = self.pe.add_abs(inputs_embeds / self.pe.xscale, 0)
        else:
            x, _ = self.pe.add_abs(self.embed(ys_in.long()).to(self.dtype), 0)
        l = x.shape[1]
        x = dropout(x, self.dropout_rate, gen)
        tgt_pad = ~make_pad_mask(ys_lens, l)  # [B, L] True = valid
        self_mask = tgt_pad[:, None, :]
        if causal:
            self_mask = self_mask & subsequent_mask(l, x.device)[None]
        else:
            self_mask = self_mask & tgt_pad[:, :, None]
        mem_mask = ~make_pad_mask(memory_lens, memory.shape[1])[:, None, :]
        for layer in self.layers:
            x = layer(x, self_mask, memory, mem_mask, gen)
        return self.output_layer(self.after_norm(x))

    # ------------------------------------------------ AR one-step decoding

    def init_ar_cache(self, batch: int, lmax: int):
        """Per-layer self-attention K/V buffers [L, B, Lmax, H, dk] x 2."""
        shape = (self.num_blocks, batch, lmax, self.n_head, self.n_feat // self.n_head)
        dev = self.after_norm.weight.device
        return (torch.zeros(shape, dtype=self.dtype, device=dev),
                torch.zeros(shape, dtype=self.dtype, device=dev))

    def project_memory(self, memory):
        """Cross-attention K/V of every layer: ([L, B, T, H, dk], [L, B, T, H, dk])."""
        ks, vs = zip(*(layer.project_memory(memory) for layer in self.layers))
        return torch.stack(ks), torch.stack(vs)

    def forward_one_step(self, tokens, pos: int, kcache, vcache, mem_k, mem_v, mem_mask):
        """tokens [B] (the current input), pos the 0-based step, kcache and
        vcache [L, B, Lmax, H, dk] (written in place at `pos`), mem_k/mem_v
        [L, B, T, H, dk], mem_mask [B, 1, T] -> (log-probs fp32 [B, V],
        kcache, vcache)."""
        x = self.embed(tokens.long()).to(self.dtype)[:, None, :]  # [B, 1, D]
        pe = self.pe.position_encoding(pos, 1).to(x.dtype)
        x = x * torch.tensor(self.pe.xscale, dtype=x.dtype) + pe
        for i, layer in enumerate(self.layers):
            x = layer.step(x, pos, kcache[i], vcache[i], mem_k[i], mem_v[i], mem_mask)
        logits = self.output_layer(self.after_norm(x))[:, 0]
        return torch.log_softmax(logits.float(), dim=-1), kcache, vcache


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor,
                         smoothing: float = 0.1, normalize_length: bool = False
                         ) -> torch.Tensor:
    """KL divergence to the label-smoothed targets over the valid positions
    (wenet label_smoothing_loss.py): logits [B, L, V], targets [B, L],
    lengths [B]; the sum over the batch divided by B, or by the token count
    with `normalize_length`. The smoothed distribution's entropy is a
    float64 constant, as the JAX function computes it."""
    b, l, v = logits.shape
    lp = torch.log_softmax(logits.float(), dim=-1)
    conf = 1.0 - smoothing
    low = smoothing / (v - 1)
    true_lp = torch.gather(lp, 2, targets.long()[..., None])[..., 0]
    entropy = float(-(conf * np.log(max(conf, 1e-12))
                      + (v - 1) * low * np.log(max(low, 1e-12))))
    kl = -(conf * true_lp + low * (lp.sum(dim=-1) - true_lp)) - entropy
    mask = torch.arange(l, device=logits.device)[None, :] < lengths[:, None]
    total = torch.where(mask, kl, 0.0).sum()
    return total / (lengths.sum() if normalize_length else b)
