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
branches (attention, conv, both FFNs), the attention probabilities (at
`attention_dropout_rate`) and the positional dropout of the scaled
embedding; without a dropout generator (eval) there is none.
`encoder.gradient_checkpointing=True` recomputes each block in the backward
(`_checkpointed_block`), with its dropout draws replayed, so the gradients
are those without it (the JAX package rematerialises the whole forward,
tpuasr/train/step.py:101-104; `jax.checkpoint` replays the same keys).

`encoder.fused_ffn=True` runs both FFN branches, in `forward` and in
`forward_chunk`, through `tpuasr_torch.ops.fused_ffn` (kernels #10/#11 on
the card) as `tpuasr/nn/conformer.py:224-258` does. Its dropout keep-masks
are drawn from the block's generator in the module chain's order and
shapes (the inner activation [B*T, 4D], then the residual [B*T, D]), so the
fused route and the module route make the same keep decisions; the kernel's
backward reads the saved masks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.nn.attention import RelPositionMultiHeadedAttention
from tpuasr_torch.nn.convolution import ConvolutionModule
from tpuasr_torch.nn.embedding import PositionalEncodingTable
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.masks import add_optional_chunk_mask, make_pad_mask
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES, subsampled_mask
from tpuasr_torch.ops.ffn import fused_ffn


def check_supported(c: EncoderConfig) -> None:
    """Raise for encoder options this slice of the port does not build."""
    wanted = {
        "encoder_type": "conformer", "pos_enc_layer_type": "rel_pos",
        "cnn_module_norm": "layer_norm", "activation_type": "swish",
        "mlp_type": "position_wise_feed_forward",
    }
    for key, value in wanted.items():
        if getattr(c, key) != value:
            raise NotImplementedError(
                f"encoder.{key}={getattr(c, key)!r}: only {value!r} is ported so far "
                "(ROADMAP: modules after the main path)")
    if c.input_layer not in SUBSAMPLE_CLASSES:
        raise NotImplementedError(
            f"encoder.input_layer={c.input_layer!r}: only {sorted(SUBSAMPLE_CLASSES)} are "
            "ported so far (ROADMAP: modules after the main path)")
    if c.attention_type not in ("", "rel_pos"):
        raise NotImplementedError(f"encoder.attention_type={c.attention_type!r} "
                                  "(ROADMAP: attention zoo)")
    if c.n_kv_head not in (0, c.attention_heads):
        raise NotImplementedError(f"encoder.n_kv_head={c.n_kv_head}: grouped K/V heads "
                                  "(ROADMAP: attention zoo)")
    if not (c.normalize_before and c.macaron_style and c.use_cnn_module):
        raise NotImplementedError("only the pre-norm macaron conformer block is ported")


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
        self.fused_ffn = c.fused_ffn
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

    def _ffn_branch(self, ffn: PositionwiseFeedForward, norm: LayerNorm, x, gen):
        """x + 0.5 * drop(ffn(norm(x))): the fused FFN (kernels #10/#11) or
        the module chain; the same parameters either way."""
        rate = self.dropout_rate
        if not self.fused_ffn:
            return x + 0.5 * dropout(ffn(norm(x), gen), rate, gen)
        b, t, d = x.shape
        m1 = m2 = None
        if gen is not None and rate > 0.0:
            # the module chain's draws, in its order and shapes: the inner
            # activation's mask, then the residual's
            m1 = (torch.rand((b * t, ffn.w_1.out_features), generator=gen, device=x.device)
                  >= rate).to(torch.uint8)
            m2 = (torch.rand((b * t, d), generator=gen, device=x.device) >= rate
                  ).to(torch.uint8)
        dt = x.dtype
        y = fused_ffn(x.reshape(b * t, d).contiguous(), norm.weight, norm.bias,
                      ffn.w_1.weight.to(dt), ffn.w_1.bias, ffn.w_2.weight.to(dt), ffn.w_2.bias,
                      m1, m2, rate, 0.5)
        return y.reshape(b, t, d)

    def forward(self, x, att_mask, pos_emb, mask_pad=None, att_cache=None, cnn_cache=None,
                gen=None):
        """gen: the dropout generator, None for no dropout (tpuasr/nn/
        conformer.py:210-280: x + drop(branch) for every residual)."""
        drop = lambda y: dropout(y, self.dropout_rate, gen)
        x = self._ffn_branch(self.feed_forward_macaron, self.norm_ff_macaron, x, gen)
        x_att, new_att_cache = self.self_attn(self.norm_mha(x), att_mask, pos_emb, att_cache,
                                              gen)
        x = x + drop(x_att)
        y, new_cnn_cache = self.conv_module(self.norm_conv(x), mask_pad, cnn_cache)
        x = x + drop(y)
        x = self._ffn_branch(self.feed_forward, self.norm_ff, x, gen)
        return self.norm_final(x), new_att_cache, new_cnn_cache


@contextlib.contextmanager
def replay_generator(gen: torch.Generator | None, state: torch.Tensor | None):
    """Within: `gen` set back to `state`, so its draws repeat those made from
    it; on exit, `gen` where it was."""
    if gen is None:
        yield
        return
    outer = gen.get_state()
    gen.set_state(state)
    try:
        yield
    finally:
        gen.set_state(outer)


def _checkpointed_block(blk: ConformerBlock, x, att_mask, pos_emb, mask_pad, gen):
    """blk's training forward under `torch.utils.checkpoint` (non-reentrant):
    the backward recomputes the block's activations from its input instead
    of keeping them. The recompute replays the forward's randomness: it runs
    with the dropout generator set back to its state on entry to the block
    (`replay_generator`; checkpoint's own `preserve_rng_state` covers only
    the default generators), and it reads the step's chunk and pad masks,
    drawn once before the blocks. The kernels' autograd Functions (#2/#3,
    #10/#11) run inside it as in the forward."""
    start = None if gen is None else gen.get_state()
    replays = []

    def run(x):
        if not replays:  # the forward: the generator is at `start` already
            replays.append(True)
            return blk(x, att_mask, pos_emb, mask_pad, gen=gen)[0]
        with replay_generator(gen, start):
            return blk(x, att_mask, pos_emb, mask_pad, gen=gen)[0]

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


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
        remat = c.gradient_checkpointing and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                ys = _checkpointed_block(blk, ys, chunk_masks, pos_emb, masks, gen)
            else:
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
