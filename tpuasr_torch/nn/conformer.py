"""Conformer encoder: full-context / chunk-masked forward and the
fixed-shape streaming `forward_chunk` (port of ``tpuasr/nn/conformer.py``).

Layer order (wenet encoder_layer.py:130-265): ½FF (macaron) → self-attention
→ conv module → ½FF → final LN, pre-norm residuals. Every option of the JAX
block builds: the attention by `attention_type_of` (rel_pos, mha with
grouped K/V heads, shaw_rel_pos, rope, firered_rel_pos), the positional
encodings (rel_pos, abs_pos, no_pos, abs_pos_whisper, abs_pos_learnable),
the FFN by `mlp_type` (position-wise, gated, MoE), the swish / relu / gelu
activations, the conv module's norms, and the block without its macaron
FFN (FFN scale 1) or without its conv module. Streaming keeps the JAX
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
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.nn.attention import (
    FireRedRelPositionAttention, MultiHeadedAttention, RelPositionMultiHeadedAttention,
    RopeMultiHeadedAttention, ShawRelPositionMultiHeadedAttention,
)
from tpuasr_torch.nn.convolution import ConvolutionModule
from tpuasr_torch.nn.embedding import PositionalEncodingTable, whisper_sinusoid_table
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout, gelu
from tpuasr_torch.nn.masks import add_optional_chunk_mask, make_pad_mask
from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES, subsampled_mask
from tpuasr_torch.ops.ffn import fused_ffn


ACTIVATIONS = {"swish": lambda x: x * torch.sigmoid(x), "relu": torch.relu, "gelu": gelu}


def attention_type_of(c: EncoderConfig) -> str:
    """The attention family: `attention_type`, else rel_pos for the rel_pos
    encoding and mha for the others (tpuasr/nn/conformer.py:52-59)."""
    if c.attention_type:
        return c.attention_type
    return "rel_pos" if c.pos_enc_layer_type == "rel_pos" else "mha"


ENCODER_TYPES = ("conformer", "firered", "squeezeformer", "efficient_conformer")


def check_supported(c: EncoderConfig) -> None:
    """Raise for the encoder options the port does not build, each with why.
    Every family of `ENCODER_TYPES` builds (`tpuasr_torch.models.transducer.
    build_encoder`); squeezeformer and efficient_conformer read their own
    fields and the activation and, as in the JAX package, none of the
    conformer block's options."""
    if c.encoder_type not in ENCODER_TYPES:
        raise ValueError(f"unknown encoder_type {c.encoder_type!r}")
    if c.encoder_type == "squeezeformer":
        if c.time_reduction_type not in ("conv", "stream"):
            raise ValueError(f"unknown time_reduction_type {c.time_reduction_type!r}")
    elif c.encoder_type == "efficient_conformer":
        if c.input_layer not in SUBSAMPLE_CLASSES:
            raise ValueError(f"unknown input_layer {c.input_layer!r}")
    else:
        check_conformer(c)
    if c.activation_type not in ACTIVATIONS:
        raise ValueError(f"unknown activation_type {c.activation_type!r}")


def check_conformer(c: EncoderConfig) -> None:
    """Raise for the conformer block's options the port does not build."""
    if not c.normalize_before:
        raise NotImplementedError(
            "encoder.normalize_before=False: the JAX block ignores the field (always "
            "pre-norm, tpuasr/nn/conformer.py:210-281), so there is no post-norm block to "
            "port; leave it True")
    if c.input_layer not in SUBSAMPLE_CLASSES:
        raise ValueError(f"unknown input_layer {c.input_layer!r}")
    if attention_type_of(c) not in ATTENTIONS:
        raise ValueError(f"unknown attention_type {c.attention_type!r}")
    if c.mlp_type not in MLP_CLASSES:
        raise ValueError(f"unknown mlp_type {c.mlp_type!r}")
    if c.activation_type not in ACTIVATIONS:
        raise ValueError(f"unknown activation_type {c.activation_type!r}")


class PositionwiseFeedForward(nn.Module):
    """w_1 → activation → dropout → w_2 (tpuasr/nn/conformer.py:62-74)."""

    def __init__(self, idim: int, hidden: int, dropout_rate: float = 0.0,
                 activation: str = "swish", device=None):
        super().__init__()
        self.dropout_rate, self.act = dropout_rate, ACTIVATIONS[activation]
        self.w_1 = Dense(idim, hidden, device=device)
        self.w_2 = Dense(hidden, idim, device=device)

    def forward(self, x, gen=None):
        return self.w_2(dropout(self.act(self.w_1(x)), self.dropout_rate, gen))


class GatedVariantsMLP(nn.Module):
    """Gated MLP (wenet positionwise_feed_forward.py:124-159;
    tpuasr/nn/conformer.py:77-93): w_2(drop(gelu(gate(x)) * w_1(x))), the
    gate bias-free; gelu whatever `activation_type`, as in the JAX block."""

    def __init__(self, idim: int, hidden: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.gate = Dense(idim, hidden, bias=False, device=device)
        self.w_1 = Dense(idim, hidden, device=device)
        self.w_2 = Dense(hidden, idim, device=device)

    def forward(self, x, gen=None):
        fuse = gelu(self.gate(x)) * self.w_1(x)
        return self.w_2(dropout(fuse, self.dropout_rate, gen))


class MoEFFNLayer(nn.Module):
    """Top-k routed mixture of experts (wenet positionwise_feed_forward.py:
    61-121; tpuasr/nn/conformer.py:96-137) computed densely as the JAX
    package does: the router's top k logits (ties to the lower index, as
    `jax.lax.top_k`), their softmax in fp32 as the combine weights, and
    every expert run on every token as one batched product over the raw
    [E, D, H] / [E, H, D] weights."""

    def __init__(self, idim: int, hidden: int, dropout_rate: float = 0.0, n_expert: int = 8,
                 n_expert_activated: int = 2, activation: str = "swish", device=None):
        super().__init__()
        self.dropout_rate, self.act = dropout_rate, ACTIVATIONS[activation]
        self.n_expert, self.k = n_expert, n_expert_activated
        self.gate = Dense(idim, n_expert, bias=False, device=device)
        self.w1 = nn.Parameter(torch.zeros(n_expert, idim, hidden, device=device))
        self.w2 = nn.Parameter(torch.zeros(n_expert, hidden, idim, device=device))

    def forward(self, x, gen=None):
        dt = x.dtype
        router = self.gate(x)
        top, idx = torch.sort(router, dim=-1, descending=True, stable=True)
        top, idx = top[..., :self.k], idx[..., :self.k]
        weights = torch.softmax(top.float(), dim=-1).to(dt)
        combine = (weights[..., None] * F.one_hot(idx, self.n_expert).to(dt)).sum(-2)  # [..., E]
        h = self.act(torch.einsum("...d,edh->...eh", x, self.w1.to(dt)))
        h = dropout(h, self.dropout_rate, gen)
        y = torch.einsum("...eh,eho->...eo", h, self.w2.to(dt))
        return (combine[..., None] * y).sum(-2)


MLP_CLASSES = {"position_wise_feed_forward": PositionwiseFeedForward,
               "gated": GatedVariantsMLP, "moe": MoEFFNLayer}

ATTENTIONS = {"rel_pos", "mha", "shaw_rel_pos", "rope", "firered_rel_pos"}


def _attention(c: EncoderConfig, device):
    """The block's self-attention by `attention_type_of` (tpuasr/nn/
    conformer.py:174-198); n_kv_head serves mha and rope."""
    kind, d, h, rate = attention_type_of(c), c.output_size, c.attention_heads, \
        c.attention_dropout_rate
    if kind == "rel_pos":
        return RelPositionMultiHeadedAttention(h, d, rate, fused=c.fused_attention,
                                               device=device)
    if kind == "shaw_rel_pos":
        return ShawRelPositionMultiHeadedAttention(h, d, rate, device=device)
    if kind == "firered_rel_pos":
        return FireRedRelPositionAttention(h, d, rate, device=device)
    cls = RopeMultiHeadedAttention if kind == "rope" else MultiHeadedAttention
    return cls(h, d, rate, n_kv_head=c.n_kv_head, device=device)


def _ffn(c: EncoderConfig, device):
    d, hidden, rate = c.output_size, c.linear_units, c.dropout_rate
    if c.mlp_type == "moe":
        return MoEFFNLayer(d, hidden, rate, c.n_expert, c.n_expert_activated,
                           c.activation_type, device)
    if c.mlp_type == "gated":
        return GatedVariantsMLP(d, hidden, rate, device)
    return PositionwiseFeedForward(d, hidden, rate, c.activation_type, device)


class ConformerBlock(nn.Module):
    """(½FF macaron) → self-attention → (conv module) → FF → (final LN), each
    a pre-norm residual; the FFN scale is ½ with the macaron FFN and 1
    without it, and the final LN exists only with the conv module, as in
    the JAX block (tpuasr/nn/conformer.py:147-280)."""

    def __init__(self, c: EncoderConfig, device=None):
        super().__init__()
        d = c.output_size
        self.dropout_rate = c.dropout_rate
        self.ff_scale = 0.5 if c.macaron_style else 1.0
        # the fused FFN (kernels #10/#11) computes the swish position-wise FFN
        # alone (tpuasr/nn/conformer.py:229-232)
        self.fused_ffn = (c.fused_ffn and c.mlp_type == "position_wise_feed_forward"
                          and c.activation_type == "swish")
        if c.macaron_style:
            self.feed_forward_macaron = _ffn(c, device)
            self.norm_ff_macaron = LayerNorm(d, device=device)
        self.feed_forward = _ffn(c, device)
        self.self_attn = _attention(c, device)
        self.norm_mha = LayerNorm(d, device=device)
        self.norm_ff = LayerNorm(d, device=device)
        self.use_cnn_module = c.use_cnn_module
        if c.use_cnn_module:
            self.conv_module = ConvolutionModule(d, c.cnn_module_kernel, c.cnn_module_norm,
                                                 c.causal, device=device)
            self.norm_conv = LayerNorm(d, device=device)
            self.norm_final = LayerNorm(d, device=device)

    def _ffn_branch(self, ffn: nn.Module, norm: LayerNorm, x, gen):
        """x + ff_scale * drop(ffn(norm(x))): the fused FFN (kernels #10/#11)
        or the module chain; the same parameters either way."""
        rate = self.dropout_rate
        if not self.fused_ffn:
            return x + self.ff_scale * dropout(ffn(norm(x), gen), rate, gen)
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
                      m1, m2, rate, self.ff_scale)
        return y.reshape(b, t, d)

    def forward(self, x, att_mask, pos_emb, mask_pad=None, att_cache=None, cnn_cache=None,
                gen=None):
        """gen: the dropout generator, None for no dropout (tpuasr/nn/
        conformer.py:210-280: x + drop(branch) for every residual)."""
        drop = lambda y: dropout(y, self.dropout_rate, gen)
        if hasattr(self, "feed_forward_macaron"):
            x = self._ffn_branch(self.feed_forward_macaron, self.norm_ff_macaron, x, gen)
        x_att, new_att_cache = self.self_attn(self.norm_mha(x), att_mask, pos_emb, att_cache,
                                              gen)
        x = x + drop(x_att)
        new_cnn_cache = None
        if self.use_cnn_module:
            y, new_cnn_cache = self.conv_module(self.norm_conv(x), mask_pad, cnn_cache)
            x = x + drop(y)
        x = self._ffn_branch(self.feed_forward, self.norm_ff, x, gen)
        if self.use_cnn_module:
            x = self.norm_final(x)
        return x, new_att_cache, new_cnn_cache


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
    offset:      [] int64 on the caches' device: encoder frames consumed so
                 far (shared by the batch), as the JAX state holds it. The PE
                 windows and the cache mask are gathered and compared at it
                 on the device, so a chunk reads nothing back to the host,
                 and `torch.export` traces it as an input, not a constant.
    """

    att_k: torch.Tensor
    att_v: torch.Tensor
    cnn: torch.Tensor
    offset: torch.Tensor


class ConformerEncoder(nn.Module):
    """Conv-subsampled stack of conformer blocks. It reads no `encoder_type`:
    the AED and CTC models build it for every value, as the JAX package
    does; the transducer picks the family (`build_encoder`)."""

    def __init__(self, c: EncoderConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        check_conformer(c)
        self.cfg, self.dtype = c, dtype
        self.embed = SUBSAMPLE_CLASSES[c.input_layer](c.input_size, c.output_size, device)
        self.pe = PositionalEncodingTable(c.output_size, c.max_len, device)
        if c.pos_enc_layer_type == "abs_pos_learnable":
            # whisper-decoder-style learned positions (tpuasr/nn/conformer.py:399-404)
            self.learned_pe = nn.Parameter(torch.zeros(c.max_len, c.output_size,
                                                       device=device))
        elif c.pos_enc_layer_type == "abs_pos_whisper":
            self.whisper_pe = torch.from_numpy(
                whisper_sinusoid_table(c.max_len, c.output_size)).to(device)
        self.blocks = nn.ModuleList(ConformerBlock(c, device) for _ in range(c.num_blocks))
        self.after_norm = LayerNorm(c.output_size, device=device)

    def _abs_pe_window(self, offset, size: int) -> torch.Tensor:
        """[1, size, D] rows offset .. offset+size-1 (clamped to the table) of
        the whisper or the learned table; both have xscale 1."""
        table = getattr(self, "learned_pe", None)
        if table is None:
            table = self.whisper_pe
        idx = (torch.arange(size, device=table.device) + offset).clamp(0, self.cfg.max_len - 1)
        return table[idx][None]

    def _scaled(self, ys: torch.Tensor) -> torch.Tensor:
        return ys * torch.tensor(self.pe.xscale, dtype=ys.dtype)

    def _positions(self, ys: torch.Tensor):
        """The full-context forward's positional branch (tpuasr/nn/
        conformer.py:460-477) -> (ys, pos_emb)."""
        c, t = self.cfg, ys.shape[1]
        kind = attention_type_of(c)
        if kind == "rope":
            return self._scaled(ys), self.pe.rope_window(0, t, c.output_size // c.attention_heads)
        if kind == "firered_rel_pos":
            return self.pe.rel_bidirectional(ys)
        if c.pos_enc_layer_type == "rel_pos":
            return self.pe.rel(ys, 0)
        if c.pos_enc_layer_type == "no_pos":
            return self._scaled(ys), self.pe.position_encoding(0, t).to(ys.dtype)
        if c.pos_enc_layer_type in ("abs_pos_whisper", "abs_pos_learnable"):
            pe = self._abs_pe_window(0, t).to(ys.dtype)
            return ys + pe, pe
        return self.pe.add_abs(ys, 0)

    def _chunk_positions(self, ys: torch.Tensor, offset: torch.Tensor, a: int):
        """forward_chunk's positional branch (tpuasr/nn/conformer.py:549-567)
        for a chunk at `offset` (a 0-d tensor) behind a cache of capacity
        `a` -> (ys, pos_emb)."""
        c, chunk = self.cfg, ys.shape[1]
        kind = attention_type_of(c)
        if kind == "firered_rel_pos":
            raise NotImplementedError("FireRed attention is full-context only: forward_chunk "
                                      "refuses it, as the JAX package does")
        if kind == "rope":
            # cached keys carry their own rotation: the chunk's angles alone
            return self._scaled(ys), self.pe.rope_window(offset, chunk,
                                                         c.output_size // c.attention_heads)
        window = lambda: self.pe.position_encoding(offset - a, a + chunk).to(ys.dtype)
        if c.pos_enc_layer_type in ("rel_pos", "no_pos"):
            return self._scaled(ys), window()
        if c.pos_enc_layer_type in ("abs_pos_whisper", "abs_pos_learnable"):
            pe = self._abs_pe_window(offset, chunk).to(ys.dtype)
            return ys + pe, pe
        return self.pe.add_abs(ys, offset)[0], window()

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
        ys, pos_emb = self._positions(ys)
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
        h = c.attention_heads
        if attention_type_of(c) in ("mha", "rope") and c.n_kv_head:
            h = c.n_kv_head  # GQA caches K/V at the K/V head count
        a = chunk_size * max(num_left_chunks, 0)
        lorder = c.cnn_module_kernel - 1 if c.causal else 0
        att = (c.num_blocks, batch, a, h, dk)
        return EncoderStreamState(
            att_k=torch.zeros(att, dtype=self.dtype, device=dev),
            att_v=torch.zeros(att, dtype=self.dtype, device=dev),
            cnn=torch.zeros((c.num_blocks, batch, lorder, c.output_size), dtype=self.dtype,
                            device=dev),
            offset=torch.zeros((), dtype=torch.long, device=dev),
        )

    def forward_chunk(self, xs: torch.Tensor, state: EncoderStreamState
                      ) -> tuple[torch.Tensor, EncoderStreamState]:
        """One streaming step: xs [B, window, F] raw feature window, window =
        (chunk - 1) * subsampling_rate + right_context + 1 (overlapping
        windows, no subsampling cache) -> ([B, chunk, D], new state)."""
        a = state.att_k.shape[2]
        ys = self.embed(xs.to(self.dtype))
        b, chunk, _ = ys.shape
        ys, pos_emb = self._chunk_positions(ys, state.offset, a)
        valid = state.offset.clamp(max=a)
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
