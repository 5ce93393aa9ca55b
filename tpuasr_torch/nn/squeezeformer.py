"""Squeezeformer encoder: full-context / chunk-masked forward and cached
chunk streaming (port of ``tpuasr/nn/squeezeformer.py``).

wenet's squeezeformer (SURVEY §2.4): a U-Net-style temporal reduction
(the frame rate halved at `reduce_idx`, recovered at `recover_idx` by a
learned upsample plus the skip connection), post-norm blocks in MHSA → FFN
→ conv → FFN order with an adaptive scale and bias before each submodule,
a depthwise-conv subsampling and rel-pos attention. It reads the
`EncoderConfig` as `tpuasr/models/transducer.py:49-72` maps it: the block
width is the output width (so the JAX module's `final_proj` never exists),
the FFN expands by max(linear_units // output_size, 1), every block has
its adaptive scales, and `input_layer` is not read (the front end is
always the depthwise one).

Routing follows the JAX package: the block builds its rel-pos attention
without `fused` (tpuasr/nn/squeezeformer.py:169-171) and the plain
position-wise FFN, so the port's plain attention and FFN run whatever
`encoder.fused_attention` and `encoder.fused_ffn` say. The attention is
built with the encoder's `dropout_rate`: in training a squeezeformer drops
attention probabilities at that rate, which the conformer does not; the
keep masks come from the encoder's dropout generator.

Streaming keeps one fixed-capacity cache per layer at that layer's own
frame rate (`tpuasr_torch.streaming.family_cache`): full-rate layers hold
`chunk * left` key/value slots, reduced-rate layers half. It needs
`causal=True`, the chunk-local `time_reduction_type="stream"` and an even
chunk; under those, chunked output equals the chunk-masked full forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.nn.attention import RelPositionMultiHeadedAttention
from tpuasr_torch.nn.conformer import PositionwiseFeedForward, _checkpointed_block
from tpuasr_torch.nn.convolution import ConvolutionModule
from tpuasr_torch.nn.embedding import PositionalEncodingTable
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.masks import add_optional_chunk_mask, make_pad_mask
from tpuasr_torch.streaming.family_cache import (
    FamilyStreamState, init_family_state, rate_view, roll_cache,
)


def _masked(x: torch.Tensor, mask_pad: torch.Tensor | None) -> torch.Tensor:
    """x [B, T, D] with the frames where mask_pad [B, 1, T] is False zeroed."""
    return x if mask_pad is None else x.masked_fill(~mask_pad.transpose(1, 2), 0.0)


class AdaptiveScale(nn.Module):
    """x * weight + bias, elementwise (wenet's adaptive_scale). The flax
    leaves `scale`/`bias` land here as `weight`/`bias`, the converter's
    rule for every `scale`."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class DepthwiseConv2dSubsampling4(nn.Module):
    """Conv2d 3x3 stride 2 + ReLU, depthwise conv2d 3x3 stride 2 + ReLU,
    then a linear over the NHWC flatten (permuted to [B, T', F', C] first,
    as `tpuasr_torch.nn.subsampling` does); rate 4, right context 6."""

    subsampling_rate = 4
    right_context = 6

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        self.pw_conv = nn.Conv2d(1, odim, 3, stride=2, device=device)
        self.dw_conv = nn.Conv2d(odim, odim, 3, stride=2, groups=odim, device=device)
        f = ((idim - 3) // 2 + 1 - 3) // 2 + 1
        self.out = Dense(odim * f, odim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.relu(F.conv2d(x[:, None], self.pw_conv.weight.to(dt), self.pw_conv.bias.to(dt),
                            stride=2))
        y = F.relu(F.conv2d(y, self.dw_conv.weight.to(dt), self.dw_conv.bias.to(dt), stride=2,
                            groups=y.shape[1]))
        b, c, t, f = y.shape
        return self.out(y.permute(0, 2, 3, 1).reshape(b, t, f * c))

    @staticmethod
    def output_len(t):
        return (((t - 1) // 2) - 1) // 2


class TimeReductionLayer(nn.Module):
    """Halve the frame rate: padded frames zeroed, a depthwise conv over time
    (kernel `kernel`, stride 2, `pad` frames each side) and a pointwise conv;
    the output masked at mask_pad[:, :, ::2]. Kernel 5 / pad 2 looks ahead
    two frames (full context only); kernel 1 / pad 0 is the chunk-local
    stream variant (`TimeReductionLayerStream`)."""

    kernel, pad = 5, 2

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dw = nn.Conv1d(dim, dim, self.kernel, stride=2, padding=self.pad, groups=dim,
                            device=device)
        self.pw = nn.Conv1d(dim, dim, 1, device=device)

    def forward(self, x: torch.Tensor, mask_pad: torch.Tensor | None):
        dt = x.dtype
        y = _masked(x, mask_pad).transpose(1, 2)
        y = F.conv1d(y, self.dw.weight.to(dt), self.dw.bias.to(dt), stride=2, padding=self.pad,
                     groups=y.shape[1])
        y = F.conv1d(y, self.pw.weight.to(dt), self.pw.bias.to(dt)).transpose(1, 2)
        if mask_pad is None:
            return y, None
        new_mask = mask_pad[:, :, ::2]
        return _masked(y, new_mask), new_mask


class TimeReductionLayerStream(TimeReductionLayer):
    """Chunk-local time reduction: depthwise conv k 1, stride 2, then
    pointwise; no receptive field across frames, so chunked == full."""

    kernel, pad = 1, 0


class SqueezeformerBlock(nn.Module):
    """Post-norm MHSA → FFN → conv → FFN, an adaptive scale before each
    submodule, each residual `LN(x + drop(branch))`."""

    def __init__(self, c: EncoderConfig, device=None):
        super().__init__()
        d = c.output_size
        self.dropout_rate = c.dropout_rate
        hidden = d * max(c.linear_units // d, 1)  # the JAX build's expansion factor
        self.self_attn = RelPositionMultiHeadedAttention(c.attention_heads, d, c.dropout_rate,
                                                         device=device)
        self.ffn1 = PositionwiseFeedForward(d, hidden, c.dropout_rate, c.activation_type, device)
        self.conv = ConvolutionModule(d, c.cnn_module_kernel, "layer_norm", c.causal,
                                      device=device)
        self.ffn2 = PositionwiseFeedForward(d, hidden, c.dropout_rate, c.activation_type, device)
        for i in range(1, 5):
            setattr(self, f"ln{i}", LayerNorm(d, device=device))
        for name in ("scale_att", "scale_ffn1", "scale_conv", "scale_ffn2"):
            setattr(self, name, AdaptiveScale(d, device))

    def forward(self, x, att_mask, pos_emb, mask_pad=None, att_cache=None, cnn_cache=None,
                gen=None):
        drop = lambda y: dropout(y, self.dropout_rate, gen)
        y, new_att_cache = self.self_attn(self.scale_att(x), att_mask, pos_emb, att_cache, gen)
        x = self.ln1(x + drop(y))
        x = self.ln2(x + drop(self.ffn1(self.scale_ffn1(x), gen)))
        y, new_cnn_cache = self.conv(self.scale_conv(x), mask_pad, cnn_cache)
        x = self.ln3(x + drop(y))
        x = self.ln4(x + drop(self.ffn2(self.scale_ffn2(x), gen)))
        return x, new_att_cache, new_cnn_cache


class SqueezeformerEncoder(nn.Module):
    def __init__(self, c: EncoderConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        d = c.output_size
        self.embed = DepthwiseConv2dSubsampling4(c.input_size, d, device)
        self.pe = PositionalEncodingTable(d, c.max_len, device)
        self.preln = LayerNorm(d, device=device)
        self.blocks = nn.ModuleList(SqueezeformerBlock(c, device) for _ in range(c.num_blocks))
        if c.reduce_idx:
            cls = TimeReductionLayerStream if c.time_reduction_type == "stream" \
                else TimeReductionLayer
            self.time_reduction = cls(d, device)
        if c.recover_idx:
            self.time_recover = Dense(d, d, device=device)

    @property
    def device(self) -> torch.device:
        return self.preln.weight.device

    def layer_factor(self, i: int) -> int:
        """The frame-rate downsampling factor of layer i's attention (wenet
        calculate_downsampling_factor): x2 from each reduce index on, /2
        from each recover index on."""
        f = 1
        for rd in self.cfg.reduce_idx or ():
            if i >= rd:
                f *= 2
        for rc in self.cfg.recover_idx or ():
            if i >= rc:
                f //= 2
        return max(f, 1)

    def _recover(self, ys: torch.Tensor, rec_ys: torch.Tensor) -> torch.Tensor:
        """rec_ys + time_recover(each frame of ys repeated twice, cut to
        rec_ys' length)."""
        up = ys.repeat_interleave(2, dim=1)[:, :rec_ys.shape[1]]
        return rec_ys + self.time_recover(up)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor, decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_gen: torch.Generator | None = None,
                gen: torch.Generator | None = None):
        """Full/chunk-masked forward (tpuasr/nn/squeezeformer.py:250-291):
        xs [B, T, F], xs_lens [B] -> (ys [B, T', D], pad mask [B, 1, T']).
        chunk_gen: a CPU generator for the dynamic-chunk draw; gen: the
        dropout generator on the model's device, None for none."""
        c = self.cfg
        t = xs.shape[1]
        masks = ~make_pad_mask(xs_lens, t)[:, None, :]
        ys = self.embed(xs.to(self.dtype))
        masks = masks[:, :, 2::2][:, :, 2::2]
        ys, pos_emb = self.pe.rel(ys, 0)
        if c.use_dynamic_chunk and decoding_chunk_size == 0 and chunk_gen is None:
            decoding_chunk_size = -1
        chunk_masks = add_optional_chunk_mask(
            masks, use_dynamic_chunk=c.use_dynamic_chunk, decoding_chunk_size=decoding_chunk_size,
            static_chunk_size=c.static_chunk_size,
            num_decoding_left_chunks=num_decoding_left_chunks, chunk_gen=chunk_gen)
        ys = self.preln(ys)
        remat = c.gradient_checkpointing and torch.is_grad_enabled()
        stack = []  # (ys, chunk_masks, pos_emb, masks) at each reduction
        for i, blk in enumerate(self.blocks):
            if i in c.reduce_idx:
                stack.append((ys, chunk_masks, pos_emb, masks))
                ys, masks = self.time_reduction(ys, masks)
                chunk_masks = chunk_masks[:, ::2, ::2]
                pos_emb = pos_emb[:, ::2]
            if i in c.recover_idx and stack:
                rec_ys, chunk_masks, pos_emb, masks = stack.pop()
                ys = _masked(self._recover(ys, rec_ys), masks)
            if remat:
                ys = _checkpointed_block(blk, ys, chunk_masks, pos_emb, masks, gen)
            else:
                ys = blk(ys, chunk_masks, pos_emb, masks, gen=gen)[0]
        return ys, masks

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    def init_stream_state(self, batch: int, chunk_size: int,
                          num_left_chunks: int) -> FamilyStreamState:
        """Zeroed per-layer caches. Cached streaming needs causal convs, the
        chunk-local "stream" time reduction and an even chunk (the reduced
        rate advances by chunk / 2 a step)."""
        c = self.cfg
        if not c.causal:
            raise ValueError("squeezeformer streaming requires causal=True (a non-causal "
                             "encoder streams by prefix recomputation)")
        if c.reduce_idx and c.time_reduction_type != "stream":
            raise ValueError("squeezeformer streaming requires time_reduction_type='stream'")
        if c.reduce_idx and chunk_size % 2:
            raise ValueError(f"squeezeformer streaming with a time reduction needs an even "
                             f"chunk, not {chunk_size}")
        return init_family_state(batch, chunk_size, num_left_chunks, c.num_blocks,
                                 self.layer_factor, c.attention_heads,
                                 c.output_size // c.attention_heads, c.cnn_module_kernel - 1,
                                 c.output_size, self.dtype, self.device)

    def forward_chunk(self, xs: torch.Tensor, state: FamilyStreamState
                      ) -> tuple[torch.Tensor, FamilyStreamState]:
        """One streaming step (tpuasr/nn/squeezeformer.py:315-367): xs
        [B, window, F], window = (chunk - 1) * 4 + 7 -> ([B, chunk, D],
        new state)."""
        c = self.cfg
        ys = self.embed(xs.to(self.dtype))
        b, chunk, _ = ys.shape
        ys = self.preln(ys * torch.tensor(self.pe.xscale, dtype=ys.dtype))
        a0 = state.att[0][0].shape[1] * self.layer_factor(0)
        view = lambda f: rate_view(self.pe, state.offset, a0, chunk, b, f, ys.dtype)
        new_att, new_cnn, stack = [], [], []
        factor = 1
        pos_emb, att_mask = view(1)
        for i, blk in enumerate(self.blocks):
            if i in c.reduce_idx:
                stack.append((ys, pos_emb, att_mask, factor))
                ys, _ = self.time_reduction(ys, None)
                factor *= 2
                pos_emb, att_mask = view(factor)
            if i in c.recover_idx and stack:
                rec_ys, pos_emb, att_mask, factor = stack.pop()
                ys = self._recover(ys, rec_ys)
            k_cache, v_cache = state.att[i]
            ys, (k_full, v_full), cnn = blk(ys, att_mask, pos_emb, att_cache=(k_cache, v_cache),
                                            cnn_cache=state.cnn[i])
            new_att.append(roll_cache(k_full, v_full, k_cache.shape[1]))
            new_cnn.append(cnn if cnn is not None else state.cnn[i])
        return ys, FamilyStreamState(att=tuple(new_att), cnn=tuple(new_cnn),
                                     offset=state.offset + chunk)
