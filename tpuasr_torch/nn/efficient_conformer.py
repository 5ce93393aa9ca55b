"""EfficientConformer encoder: full-context / chunk-masked forward and cached
chunk streaming (port of ``tpuasr/nn/efficient_conformer.py``).

wenet's efficient conformer (SURVEY §2.4): progressive downsampling by
*strided* conformer layers at `stride_layer_idx` (the conv module's
depthwise conv takes stride 2 and the residual is average-pooled to match)
and **grouped** rel-pos attention: consecutive frames are concatenated in
groups of `group_size` along the head dim, so attention costs group_size²
less at long T.

Routing follows the JAX package: the grouped attention is plain einsums
(tpuasr/nn/efficient_conformer.py:122-134) and the FFNs are the plain
position-wise FFN, so the port's plain versions run whatever
`encoder.fused_attention` and `encoder.fused_ffn` say. Scores and softmax
are fp32 and the probabilities are rounded to v's type before a.v, as in
the port's other attentions. The grouped attention drops no probabilities.

Streaming keeps one fixed-capacity cache per layer at that layer's own
frame rate (`tpuasr_torch.streaming.family_cache`): pre-stride layers hold
`chunk * left` key/value slots, post-stride layers `/ stride`; the strided
layer's causal conv cache is post-GLU at its *input* rate. Groups are
anchored at absolute frame 0, so a chunk must be divisible by factor ×
group_size at every layer (`init_stream_state` refuses others); with
`causal=True` chunked output equals the chunk-masked full forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.nn.conformer import PositionwiseFeedForward, _checkpointed_block
from tpuasr_torch.nn.convolution import ConvolutionModule
from tpuasr_torch.nn.embedding import PositionalEncodingTable
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.masks import add_optional_chunk_mask, make_pad_mask
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES, subsampled_mask
from tpuasr_torch.ops.relpos_attention import _probs
from tpuasr_torch.streaming.family_cache import (
    FamilyStreamState, init_family_state, rate_view, roll_cache,
)


# the strided layers' stride: `tpuasr/models/transducer.py:116` reads
# getattr(enc_cfg, "stride", 2) and EncoderConfig has no such field
STRIDE = 2


def _pad_time(z: torch.Tensor, t_pad: int) -> torch.Tensor:
    """z [B, T, ...] zero-padded at the end of T to t_pad."""
    return F.pad(z, (0, 0) * (z.dim() - 2) + (0, t_pad - z.shape[1]))


class GroupedRelPositionAttention(nn.Module):
    """Rel-pos attention over frame groups: q/k/v/pos zero-padded along T to
    a multiple of g and regrouped from [B, T, H, dk] to [B, T/g, H, g*dk],
    u/v biases [H, g*dk], scale 1/sqrt(dk*g). The mask is grouped by its
    first frame: keys `pad(mask)[:, :, ::g]`, and queries `[:, ::g, :]` for
    a query-dependent mask. Grouping is anchored at index 0 of the given
    tensors; streaming passes windows that start at a multiple of g."""

    def __init__(self, n_head: int, n_feat: int, group_size: int = 3, device=None):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by n_head {n_head}")
        self.n_head, self.d_k, self.group_size = n_head, n_feat // n_head, group_size
        self.linear_q = Dense(n_feat, n_feat, device=device)
        self.linear_k = Dense(n_feat, n_feat, device=device)
        self.linear_v = Dense(n_feat, n_feat, device=device)
        self.linear_out = Dense(n_feat, n_feat, device=device)
        self.linear_pos = Dense(n_feat, n_feat, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k * group_size, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k * group_size, device=device))

    def _group(self, z: torch.Tensor, t_pad: int) -> torch.Tensor:
        """[B, T, H, dk] -> [B, t_pad / g, H, g * dk]."""
        b, g, h, dk = z.shape[0], self.group_size, self.n_head, self.d_k
        z = _pad_time(z, t_pad).reshape(b, t_pad // g, g, h, dk)
        return z.transpose(2, 3).reshape(b, t_pad // g, h, g * dk)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None, pos_emb: torch.Tensor,
                cache: tuple[torch.Tensor, torch.Tensor] | None = None, gen=None):
        """x [B, Tq, D]; mask [B, Tq|1, Tk] True = attend; pos_emb [1, Tk, D];
        cache ([B, A, H, dk], [B, A, H, dk]) or None -> (out [B, Tq, D],
        (k, v) windows [B, Tk, H, dk]). `gen` is unused: no dropout here."""
        b, t_q, _ = x.shape
        h, dk, g = self.n_head, self.d_k, self.group_size
        q = self.linear_q(x).view(b, t_q, h, dk)
        k = self.linear_k(x).view(b, t_q, h, dk)
        v = self.linear_v(x).view(b, t_q, h, dk)
        if cache is not None:
            k = torch.cat([cache[0].to(k.dtype), k], dim=1)
            v = torch.cat([cache[1].to(v.dtype), v], dim=1)
        t_k = k.shape[1]
        p = self.linear_pos(pos_emb).view(pos_emb.shape[0], t_k, h, dk)
        tq_pad, tk_pad = -(-t_q // g) * g, -(-t_k // g) * g
        qg = self._group(q, tq_pad)
        kg, vg, pg = (self._group(z, tk_pad) for z in (k, v, p))
        ac = torch.einsum("bthd,bshd->bhts", (qg + self.pos_bias_u.to(qg.dtype)).float(),
                          kg.float())
        bd = torch.einsum("bthd,pshd->bhts", (qg + self.pos_bias_v.to(qg.dtype)).float(),
                          pg.float())
        scores = (ac + bd) / math.sqrt(dk * g)
        if mask is None:
            a = torch.softmax(scores, dim=-1)
        else:
            m = F.pad(mask, (0, tk_pad - t_k))[:, :, ::g]
            if m.shape[1] > 1:  # a query-dependent [B, Tq, Tk] mask
                m = F.pad(m, (0, 0, 0, tq_pad - t_q))[:, ::g, :]
            a = _probs(scores, m)
        out = torch.einsum("bhts,bshd->bthd", a.to(vg.dtype).float(), vg.float()).to(q.dtype)
        out = out.reshape(b, tq_pad // g, h, g, dk).transpose(2, 3).reshape(b, tq_pad, h * dk)
        return self.linear_out(out[:, :t_q]), (k, v)


class StridedConvModule(nn.Module):
    """The conformer conv module with a strided depthwise conv (T halved at
    stride 2): padded input frames zeroed, pointwise to 2C, GLU, the
    depthwise conv (causal: left-padded by kernel-1 frames, or extended by a
    cache of the previous chunk's last kernel-1 post-GLU frames at the
    module's *input* rate; otherwise symmetric padding), LayerNorm, swish,
    pointwise back to C. The output is not masked (the JAX module's)."""

    def __init__(self, channels: int, kernel_size: int, stride: int, causal: bool = False,
                 device=None):
        super().__init__()
        if not causal and (kernel_size - 1) % 2:
            raise ValueError("a non-causal depthwise kernel must be odd")
        self.channels, self.kernel_size, self.stride, self.causal = (channels, kernel_size,
                                                                     stride, causal)
        self.pointwise_conv1 = Dense(channels, 2 * channels, device=device)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size, stride=stride,
                                        groups=channels, device=device)
        self.norm = LayerNorm(channels, device=device)
        self.pointwise_conv2 = Dense(channels, channels, device=device)

    def forward(self, x: torch.Tensor, mask_pad: torch.Tensor | None = None,
                cache: torch.Tensor | None = None):
        c = self.channels
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        y = self.pointwise_conv1(x)
        y = y[..., :c] * torch.sigmoid(y[..., c:])
        new_cache = None
        if self.causal:
            lorder = self.kernel_size - 1
            if cache is None:
                y = F.pad(y, (0, 0, lorder, 0))
            else:
                y = torch.cat([cache.to(y.dtype), y], dim=1)
                new_cache = y[:, y.shape[1] - lorder:]
            pad = 0
        else:
            pad = (self.kernel_size - 1) // 2
        dt, w = y.dtype, self.depthwise_conv
        y = F.conv1d(y.transpose(1, 2), w.weight.to(dt), w.bias.to(dt), stride=self.stride,
                     padding=pad, groups=c).transpose(1, 2)
        y = self.norm(y)
        return self.pointwise_conv2(y * torch.sigmoid(y)), new_cache


class EfficientConformerBlock(nn.Module):
    """½FF (macaron) → grouped attention → conv module (strided: the
    residual is the average pool of the zero-padded input, cut to the conv's
    length) → ½FF → final LN, pre-norm residuals."""

    def __init__(self, c: EncoderConfig, strided: bool = False, device=None):
        super().__init__()
        d = c.output_size
        self.dropout_rate, self.strided = c.dropout_rate, strided
        ffn = lambda: PositionwiseFeedForward(d, c.linear_units, c.dropout_rate,
                                              c.activation_type, device)
        self.ff_macaron, self.ff = ffn(), ffn()
        self.self_attn = GroupedRelPositionAttention(c.attention_heads, d, c.group_size, device)
        if strided:
            self.conv_module = StridedConvModule(d, c.cnn_module_kernel, STRIDE, c.causal,
                                                 device)
        else:
            self.conv_module = ConvolutionModule(d, c.cnn_module_kernel, "layer_norm", c.causal,
                                                 device=device)
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff", "norm_final"):
            setattr(self, name, LayerNorm(d, device=device))

    def forward(self, x, att_mask, pos_emb, mask_pad=None, att_cache=None, cnn_cache=None,
                gen=None):
        drop = lambda y: dropout(y, self.dropout_rate, gen)
        x = x + 0.5 * drop(self.ff_macaron(self.norm_ff_macaron(x), gen))
        y, new_att_cache = self.self_attn(self.norm_mha(x), att_mask, pos_emb, att_cache)
        x = x + drop(y)
        y, new_cnn_cache = self.conv_module(self.norm_conv(x), mask_pad, cnn_cache)
        if self.strided:
            b, t, d = x.shape
            t_pad = -(-t // STRIDE) * STRIDE
            residual = _pad_time(x, t_pad).reshape(b, t_pad // STRIDE, STRIDE, d).mean(2)
            x = residual[:, :y.shape[1]] + drop(y)
        else:
            x = x + drop(y)
        x = x + 0.5 * drop(self.ff(self.norm_ff(x), gen))
        return self.norm_final(x), new_att_cache, new_cnn_cache


def efficient_output_len(c: EncoderConfig, t):
    """Output frames of t input frames: the front end's, then a ceil
    division by the stride for each strided layer."""
    base = SUBSAMPLE_CLASSES[c.input_layer].output_len(t)
    for _ in c.stride_layer_idx:
        base = (base + STRIDE - 1) // STRIDE
    return base


class EfficientConformerEncoder(nn.Module):
    def __init__(self, c: EncoderConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.embed = SUBSAMPLE_CLASSES[c.input_layer](c.input_size, c.output_size, device)
        self.pe = PositionalEncodingTable(c.output_size, c.max_len, device)
        self.blocks = nn.ModuleList(
            EfficientConformerBlock(c, strided=i in c.stride_layer_idx, device=device)
            for i in range(c.num_blocks))
        self.after_norm = LayerNorm(c.output_size, device=device)

    @property
    def device(self) -> torch.device:
        return self.after_norm.weight.device

    def layer_factor(self, i: int) -> int:
        """The downsampling factor of layer i's *input* relative to the
        embedding's output: x stride for each strided layer before i."""
        f = 1
        for s in self.cfg.stride_layer_idx:
            if i > s:
                f *= STRIDE
        return f

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor, decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_gen: torch.Generator | None = None,
                gen: torch.Generator | None = None):
        """Full/chunk-masked forward (tpuasr/nn/efficient_conformer.py:
        270-296): xs [B, T, F], xs_lens [B] -> (ys [B, T', D], pad mask
        [B, 1, T'] at the output rate)."""
        c = self.cfg
        t = xs.shape[1]
        masks = ~make_pad_mask(xs_lens, t)[:, None, :]
        ys = self.embed(xs.to(self.dtype))
        masks = subsampled_mask(masks, c.input_layer)
        ys, pos_emb = self.pe.rel(ys, 0)
        if c.use_dynamic_chunk and decoding_chunk_size == 0 and chunk_gen is None:
            decoding_chunk_size = -1
        chunk_masks = add_optional_chunk_mask(
            masks, use_dynamic_chunk=c.use_dynamic_chunk, decoding_chunk_size=decoding_chunk_size,
            static_chunk_size=c.static_chunk_size,
            num_decoding_left_chunks=num_decoding_left_chunks, chunk_gen=chunk_gen)
        remat = c.gradient_checkpointing and torch.is_grad_enabled()
        s = STRIDE
        for i, blk in enumerate(self.blocks):
            if remat:
                ys = _checkpointed_block(blk, ys, chunk_masks, pos_emb, masks, gen)
            else:
                ys = blk(ys, chunk_masks, pos_emb, masks, gen=gen)[0]
            if i in c.stride_layer_idx:
                t_out = ys.shape[1]
                masks = masks[:, :, ::s][:, :, :t_out]
                chunk_masks = chunk_masks[:, ::s, ::s][:, :t_out, :t_out]
                pos_emb = pos_emb[:, ::s][:, :t_out]
        return self.after_norm(ys), masks

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    def init_stream_state(self, batch: int, chunk_size: int,
                          num_left_chunks: int) -> FamilyStreamState:
        """Zeroed per-layer caches. Cached streaming needs causal convs and a
        chunk divisible by factor × group_size at every layer, so the stride
        grid and the attention's group grid stay absolutely aligned."""
        c = self.cfg
        if not c.causal:
            raise ValueError("efficient-conformer streaming requires causal=True (a "
                             "non-causal encoder streams by prefix recomputation)")
        for i in range(c.num_blocks):
            f = self.layer_factor(i)
            if chunk_size % (f * c.group_size):
                raise ValueError(f"chunk {chunk_size} must be divisible by factor {f} * "
                                 f"group_size {c.group_size} for layer {i}")
        return init_family_state(batch, chunk_size, num_left_chunks, c.num_blocks,
                                 self.layer_factor, c.attention_heads,
                                 c.output_size // c.attention_heads, c.cnn_module_kernel - 1,
                                 c.output_size, self.dtype, self.device)

    def forward_chunk(self, xs: torch.Tensor, state: FamilyStreamState
                      ) -> tuple[torch.Tensor, FamilyStreamState]:
        """One streaming step (tpuasr/nn/efficient_conformer.py:328-369): xs
        [B, window, F] -> ([B, chunk / total stride, D], new state)."""
        c = self.cfg
        ys = self.embed(xs.to(self.dtype))
        b, chunk, _ = ys.shape
        ys = ys * torch.tensor(self.pe.xscale, dtype=ys.dtype)
        a0 = state.att[0][0].shape[1]
        view = lambda f: rate_view(self.pe, state.offset, a0, chunk, b, f, ys.dtype)
        new_att, new_cnn = [], []
        factor = 1
        pos_emb, att_mask = view(1)
        for i, blk in enumerate(self.blocks):
            k_cache, v_cache = state.att[i]
            ys, (k_full, v_full), cnn = blk(ys, att_mask, pos_emb, att_cache=(k_cache, v_cache),
                                            cnn_cache=state.cnn[i])
            new_att.append(roll_cache(k_full, v_full, k_cache.shape[1]))
            new_cnn.append(cnn if cnn is not None else state.cnn[i])
            if i in c.stride_layer_idx:
                factor *= STRIDE
                pos_emb, att_mask = view(factor)
        return self.after_norm(ys), FamilyStreamState(att=tuple(new_att), cnn=tuple(new_cnn),
                                                      offset=state.offset + chunk)
