"""Conformer encoder: full-context / chunk-masked forward and the
fixed-shape streaming `forward_chunk` (port of ``tpuasr/nn/conformer.py``).

Layer order (wenet encoder_layer.py:130-265): ½FF (macaron) → rel-pos MHA →
conv module → ½FF → final LN, pre-norm residuals. Streaming keeps the JAX
package's fixed-capacity right-aligned caches — att_k/att_v [L, B, A, H, dk]
with A = chunk * num_left_chunks, cnn [L, B, lorder, D] — and a stream
offset, so chunked output equals the full-context chunk-masked forward.
The blocks are unrolled (`blocks.{i}`); `tpuasr_torch.convert` reads both
the unrolled and the scanned JAX parameter layouts.

Training: `forward` takes a chunk generator (the dynamic-chunk draw, on the
host) and a dropout generator (on the model's device). Dropout sits where
the JAX package has it: the FFN's inner activation, each block's residual
branches (attention, conv, both FFNs) and the positional dropout of the
scaled embedding; without a dropout generator (eval) there is none.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.nn.attention import RelPositionMultiHeadedAttention
from tpuasr_torch.nn.convolution import ConvolutionModule
from tpuasr_torch.nn.embedding import PositionalEncodingTable
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.masks import add_optional_chunk_mask, make_pad_mask
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES, subsampled_mask


def check_supported(c: EncoderConfig) -> None:
    """Raise for encoder options this slice of the port does not build."""
    wanted = {
        "encoder_type": "conformer", "input_layer": "conv2d",
        "pos_enc_layer_type": "rel_pos", "cnn_module_norm": "layer_norm",
        "activation_type": "swish", "mlp_type": "position_wise_feed_forward",
    }
    for key, value in wanted.items():
        if getattr(c, key) != value:
            raise NotImplementedError(
                f"encoder.{key}={getattr(c, key)!r}: only {value!r} is ported so far "
                "(ROADMAP: modules after the main path)")
    if c.attention_type not in ("", "rel_pos"):
        raise NotImplementedError(f"encoder.attention_type={c.attention_type!r} "
                                  "(ROADMAP: attention zoo)")
    if c.n_kv_head not in (0, c.attention_heads):
        raise NotImplementedError(f"encoder.n_kv_head={c.n_kv_head}: grouped K/V heads "
                                  "(ROADMAP: attention zoo)")
    if not (c.normalize_before and c.macaron_style and c.use_cnn_module):
        raise NotImplementedError("only the pre-norm macaron conformer block is ported")
    if c.fused_ffn:
        raise NotImplementedError("encoder.fused_ffn: the fused FFN kernels (TPU kernels "
                                  "#10/#11) are not ported yet (ROADMAP)")


class PositionwiseFeedForward(nn.Module):
    """w_1 → swish → dropout → w_2 (tpuasr/nn/conformer.py:62-74)."""

    def __init__(self, idim: int, hidden: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.w_1 = Dense(idim, hidden, device=device)
        self.w_2 = Dense(hidden, idim, device=device)

    def forward(self, x, gen=None):
        y = self.w_1(x)
        return self.w_2(dropout(y * torch.sigmoid(y), self.dropout_rate, gen))


class ConformerBlock(nn.Module):
    def __init__(self, c: EncoderConfig, device=None):
        super().__init__()
        d = c.output_size
        self.dropout_rate = c.dropout_rate
        self.feed_forward_macaron = PositionwiseFeedForward(d, c.linear_units,
                                                            c.dropout_rate, device)
        self.norm_ff_macaron = LayerNorm(d, device=device)
        self.feed_forward = PositionwiseFeedForward(d, c.linear_units, c.dropout_rate, device)
        self.self_attn = RelPositionMultiHeadedAttention(
            c.attention_heads, d, c.attention_dropout_rate, fused=c.fused_attention,
            device=device)
        self.norm_mha = LayerNorm(d, device=device)
        self.norm_ff = LayerNorm(d, device=device)
        self.conv_module = ConvolutionModule(d, c.cnn_module_kernel, c.cnn_module_norm,
                                             c.causal, device=device)
        self.norm_conv = LayerNorm(d, device=device)
        self.norm_final = LayerNorm(d, device=device)

    def forward(self, x, att_mask, pos_emb, mask_pad=None, att_cache=None, cnn_cache=None,
                gen=None):
        """gen: the dropout generator, None for no dropout (tpuasr/nn/
        conformer.py:210-280: x + drop(branch) for every residual)."""
        drop = lambda y: dropout(y, self.dropout_rate, gen)
        x = x + 0.5 * drop(self.feed_forward_macaron(self.norm_ff_macaron(x), gen))
        x_att, new_att_cache = self.self_attn(self.norm_mha(x), att_mask, pos_emb, att_cache)
        x = x + drop(x_att)
        y, new_cnn_cache = self.conv_module(self.norm_conv(x), mask_pad, cnn_cache)
        x = x + drop(y)
        x = x + 0.5 * drop(self.feed_forward(self.norm_ff(x), gen))
        return self.norm_final(x), new_att_cache, new_cnn_cache


@dataclass
class EncoderStreamState:
    """Fixed-shape streaming caches for one batch of streams.

    att_k/att_v: [L, B, A, H, dk] right-aligned (newest last), A = capacity.
    cnn:         [L, B, lorder, D] post-GLU left context per conv module.
    offset:      encoder frames consumed so far (shared by the batch), kept
                 on the host so PE windows and masks need no device sync.
    """

    att_k: torch.Tensor
    att_v: torch.Tensor
    cnn: torch.Tensor
    offset: int


class ConformerEncoder(nn.Module):
    """Conv-subsampled stack of conformer blocks."""

    def __init__(self, c: EncoderConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        check_supported(c)
        self.cfg, self.dtype = c, dtype
        self.embed = SUBSAMPLE_CLASSES[c.input_layer](c.input_size, c.output_size, device)
        self.pe = PositionalEncodingTable(c.output_size, c.max_len, device)
        self.blocks = nn.ModuleList(ConformerBlock(c, device) for _ in range(c.num_blocks))
        self.after_norm = LayerNorm(c.output_size, device=device)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor, decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_gen: torch.Generator | None = None,
                gen: torch.Generator | None = None):
        """Full/chunk-masked forward: xs [B, T, F], xs_lens [B] ->
        (ys [B, T', D], pad mask [B, 1, T'] True=valid).

        chunk_gen: a CPU generator for the dynamic-chunk draw (training);
        gen: the dropout generator on the model's device, None for none."""
        c = self.cfg
        t = xs.shape[1]
        masks = ~make_pad_mask(xs_lens, t)[:, None, :]
        ys = self.embed(xs.to(self.dtype))
        masks = subsampled_mask(masks, c.input_layer)
        ys, pos_emb = self.pe.rel(ys, 0)
        ys = dropout(ys, c.positional_dropout_rate, gen)
        # a dynamic-chunk model without a chunk policy or generator runs with
        # full context (tpuasr/nn/conformer.py:482)
        if c.use_dynamic_chunk and decoding_chunk_size == 0 and chunk_gen is None:
            decoding_chunk_size = -1
        chunk_masks = add_optional_chunk_mask(
            masks, use_dynamic_chunk=c.use_dynamic_chunk,
            decoding_chunk_size=decoding_chunk_size,
            static_chunk_size=c.static_chunk_size,
            num_decoding_left_chunks=num_decoding_left_chunks,
            use_dynamic_left_chunk=c.use_dynamic_left_chunk, chunk_gen=chunk_gen,
            max_chunk_size=c.max_chunk_size)
        for blk in self.blocks:
            ys, _, _ = blk(ys, chunk_masks, pos_emb, masks, gen=gen)
        return self.after_norm(ys), masks

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    def init_stream_state(self, batch: int, chunk_size: int,
                          num_left_chunks: int) -> EncoderStreamState:
        """Zeroed fixed-shape caches for `batch` parallel streams."""
        c = self.cfg
        dev = self.after_norm.weight.device
        dk = c.output_size // c.attention_heads
        a = chunk_size * max(num_left_chunks, 0)
        lorder = c.cnn_module_kernel - 1 if c.causal else 0
        att = (c.num_blocks, batch, a, c.attention_heads, dk)
        return EncoderStreamState(
            att_k=torch.zeros(att, dtype=self.dtype, device=dev),
            att_v=torch.zeros(att, dtype=self.dtype, device=dev),
            cnn=torch.zeros((c.num_blocks, batch, lorder, c.output_size), dtype=self.dtype,
                            device=dev),
            offset=0,
        )

    def forward_chunk(self, xs: torch.Tensor, state: EncoderStreamState
                      ) -> tuple[torch.Tensor, EncoderStreamState]:
        """One streaming step: xs [B, window, F] raw feature window, window =
        (chunk - 1) * subsampling_rate + right_context + 1 (overlapping
        windows, no subsampling cache) -> ([B, chunk, D], new state)."""
        a = state.att_k.shape[2]
        ys = self.embed(xs.to(self.dtype))
        b, chunk, _ = ys.shape
        ys = ys * self.pe.xscale
        pos_emb = self.pe.position_encoding(state.offset - a, a + chunk).to(ys.dtype)
        valid = min(state.offset, a)
        j = torch.arange(a + chunk, device=ys.device)
        att_mask = (j >= a - valid)[None, None, :].expand(b, chunk, a + chunk)

        new_ks, new_vs, new_cnns = [], [], []
        for i, blk in enumerate(self.blocks):
            ys, (k_full, v_full), cnn_new = blk(
                ys, att_mask, pos_emb, att_cache=(state.att_k[i], state.att_v[i]),
                cnn_cache=state.cnn[i])
            new_ks.append(k_full[:, chunk:])  # the newest A frames
            new_vs.append(v_full[:, chunk:])
            new_cnns.append(cnn_new if cnn_new is not None else state.cnn[i])
        ys = self.after_norm(ys)
        return ys, EncoderStreamState(
            att_k=torch.stack(new_ks), att_v=torch.stack(new_vs),
            cnn=torch.stack(new_cnns), offset=state.offset + chunk)
