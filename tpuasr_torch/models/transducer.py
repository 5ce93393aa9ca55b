"""RNN-Transducer model (port of ``tpuasr/models/transducer.py:109-303``).

Offline and streaming are one model with two serving paths: `encode` (full
or chunk-masked context) and `encode_chunk` (fixed-shape caches), both under
`no_grad`. `forward` is the training forward: the hybrid loss
`transducer_weight · rnnt + ctc_weight · ctc` -> {"loss", "loss_rnnt",
"loss_ctc"}, with dropout when the module is in `train()` mode and a dropout
generator is given. Its RNN-T routes:
- `fused_joint_loss=True`: `tpuasr_torch.ops.rnnt_loss_fused_mean` (kernels
  #4/#5 on the card), so [B, T, U+1, V] never exists;
- `fused_joint_loss=False` (the JAX default): the joint's full logits in the
  compute type and `rnnt_loss_from_logits`;
- `rnnt_prune_range > 0`: `tpuasr_torch.losses.rnnt_loss_pruned`, the joint
  on a band of that many label positions a frame (plain PyTorch on every
  device, as the JAX package's is no TPU kernel); it takes precedence over
  the fused loss.
The fused and the pruned routes compute the plain head alone (tanh . W +
b): a HAT or post-join joint takes the materialized route whatever the two
switches say (tpuasr/models/transducer.py:237, :260). The fused and the
materialized routes run the lattice through kernels #8/#9 on the card and
the plain lattice on the CPU. With `shard_joint` and a mesh's model axis
of more than one rank (`vocab_shard`), the materialized route splits the
logits over the vocabulary (`tpuasr_torch.losses.rnnt_loss_sharded_joint`:
the plain head, a post-join linear's and the HAT's), as JAX constrains them
to `P("data", None, None, "model")` (tpuasr/models/transducer.py:282-288);
the fused and pruned routes return before that constraint in JAX and ignore
the axis here too.

The encoder comes from `build_encoder`, by `encoder.encoder_type`, as
`tpuasr/models/transducer.py:30-96` builds it: the conformer; firered (the
conformer stack with FireRed's front end `conv2d_firered` and attention
`firered_rel_pos`, full-context only); squeezeformer and
efficient_conformer (`tpuasr_torch.nn.squeezeformer`,
`tpuasr_torch.nn.efficient_conformer`: plain attention and FFNs whatever
the fused switches say, as in the JAX package; their streams keep per-layer
caches at each layer's frame rate, `tpuasr_torch.streaming.family_cache`).
The efficient conformer's strides leave `stream_output_factor` encoder
frames of a chunk for each output frame.
The module owns its weights; they come from `init_weights` (seeded) or from
a JAX checkpoint through `tpuasr_torch.convert`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from tpuasr_torch.config import EncoderConfig, ModelConfig
from tpuasr_torch.device import resolve_device
from tpuasr_torch.losses import (
    ctc_loss_from_logits, rnnt_loss_from_logits, rnnt_loss_pruned, rnnt_loss_sharded_joint,
)
from tpuasr_torch.nn.attention import (
    FireRedRelPositionAttention, RelPositionMultiHeadedAttention,
)
from tpuasr_torch.nn.conformer import ConformerEncoder, EncoderStreamState, check_supported
from tpuasr_torch.nn.convolution import BatchNormEval, RMSNorm
from tpuasr_torch.nn.efficient_conformer import (
    STRIDE, EfficientConformerEncoder, GroupedRelPositionAttention, efficient_output_len,
)
from tpuasr_torch.nn.joint import TransducerJoint
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.predictor import PREDICTOR_CLASSES
from tpuasr_torch.nn.squeezeformer import AdaptiveScale, SqueezeformerEncoder
from tpuasr_torch.nn.subsampling import subsampled_len
from tpuasr_torch.ops.rnnt_fused import rnnt_loss_fused_mean
from tpuasr_torch.streaming.family_cache import FamilyStreamState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def family_config(enc_cfg: EncoderConfig) -> EncoderConfig:
    """The conformer configuration an encoder family builds: FireRed is the
    conformer stack with its padded front end and Transformer-XL attention
    (tpuasr/models/transducer.py:37-47)."""
    if enc_cfg.encoder_type == "firered":
        return dataclasses.replace(enc_cfg, input_layer="conv2d_firered",
                                   attention_type="firered_rel_pos")
    return enc_cfg


def build_encoder(enc_cfg: EncoderConfig, dtype: torch.dtype, device) -> nn.Module:
    """The encoder of `enc_cfg.encoder_type` (tpuasr/models/transducer.py:
    30-96): conformer | firered | squeezeformer | efficient_conformer."""
    check_supported(enc_cfg)
    if enc_cfg.encoder_type == "squeezeformer":
        return SqueezeformerEncoder(enc_cfg, dtype, device)
    if enc_cfg.encoder_type == "efficient_conformer":
        return EfficientConformerEncoder(enc_cfg, dtype, device)
    return ConformerEncoder(family_config(enc_cfg), dtype, device)


def encoder_output_len(enc_cfg: EncoderConfig, feat_lens):
    """Encoder frame count for padded inputs, per family
    (tpuasr/models/transducer.py:99-106): the efficient conformer's
    (`efficient_output_len`: a ceil division per stride), else the front
    end's."""
    if enc_cfg.encoder_type == "efficient_conformer":
        return efficient_output_len(enc_cfg, feat_lens)
    return subsampled_len(family_config(enc_cfg).input_layer, feat_lens)


def stream_output_factor(enc_cfg: EncoderConfig) -> int:
    """Encoder frames of a streaming chunk per output frame
    (tpuasr/models/transducer.py:109-118): the product of the efficient
    conformer's strides, 1 for the other families."""
    if enc_cfg.encoder_type == "efficient_conformer":
        return STRIDE ** len(enc_cfg.stride_layer_idx)
    return 1


def stream_output_len(enc_cfg: EncoderConfig, feat_lens):
    """Output frame count at the encoder's final rate in streaming
    (tpuasr/models/transducer.py:121-125): the front end's length, divided
    by `stream_output_factor` rounding up."""
    f = stream_output_factor(enc_cfg)
    return (subsampled_len(enc_cfg.input_layer, feat_lens) + f - 1) // f


def add_blank(texts: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, U] -> [B, U+1] with the blank prepended (the predictor's input)."""
    return torch.nn.functional.pad(texts, (1, 0), value=blank_id)


class CTCHead(nn.Module):
    """Dropout + linear CTC head; the linear computes in fp32 like the JAX
    package's dtype-less Dense (model/rnnt_model.py:11-80)."""

    def __init__(self, idim: int, vocab_size: int, dropout_rate: float = 0.1, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ctc_lo = Dense(idim, vocab_size, device=device)

    def forward(self, enc_out: torch.Tensor, gen=None) -> torch.Tensor:
        return self.ctc_lo(dropout(enc_out, self.dropout_rate, gen).float())


class Transducer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in {sorted(DTYPES)}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        self.encoder = build_encoder(cfg.encoder, self.dtype, dev)
        self.predictor = PREDICTOR_CLASSES[cfg.predictor.predictor_type](
            cfg.predictor, cfg.vocab_size, self.dtype, dev)
        self.joint = TransducerJoint(cfg.joint, cfg.encoder.output_size,
                                     cfg.predictor.output_size, cfg.vocab_size, cfg.blank_id,
                                     dev)
        self.ctc = (CTCHead(cfg.encoder.output_size, cfg.vocab_size, cfg.ctc_dropout_rate, dev)
                    if cfg.ctc_weight > 0 else None)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -------------------------------------------------- encoder entry points

    @torch.no_grad()
    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               decoding_chunk_size: int = 0, num_decoding_left_chunks: int = -1):
        """-> (enc_out [B, T', D], enc_lens [B])."""
        ys, _ = self.encoder(feats, feat_lens, decoding_chunk_size, num_decoding_left_chunks)
        return ys, encoder_output_len(self.cfg.encoder, feat_lens)

    @torch.no_grad()
    def encode_chunk(self, xs: torch.Tensor, state: EncoderStreamState | FamilyStreamState):
        """One streaming chunk -> ([B, chunk / stream_output_factor, D], new
        encoder state); the family's own cached path."""
        return self.encoder.forward_chunk(xs, state)

    def init_encoder_state(self, batch: int, chunk_size: int, num_left_chunks: int
                           ) -> EncoderStreamState | FamilyStreamState:
        """The family's zeroed stream caches (the conformer's stacked
        `EncoderStreamState`, the families' per-layer `FamilyStreamState`)."""
        return self.encoder.init_stream_state(batch, chunk_size, num_left_chunks)

    # -------------------------------------------------- predictor / joint

    @torch.no_grad()
    def predict_step(self, tokens, state, padding=None):
        return self.predictor.forward_step(tokens, state, padding)

    def init_predictor_state(self, batch: int):
        return self.predictor.init_state(batch)

    @torch.no_grad()
    def joint_step(self, enc_t, pred_u):
        return self.joint.step(enc_t, pred_u)

    @torch.no_grad()
    def ctc_logits(self, enc_out):
        if self.ctc is None:
            raise ValueError("model has no CTC head (ctc_weight == 0)")
        return self.ctc(enc_out)

    # -------------------------------------------------- training forward

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor, texts: torch.Tensor,
                text_lens: torch.Tensor, chunk_gen: torch.Generator | None = None,
                dropout_gen: torch.Generator | None = None, vocab_shard=None) -> dict:
        """Hybrid loss forward -> {"loss", "loss_rnnt", "loss_ctc"}.

        loss = transducer_weight * rnnt(mean) + ctc_weight * ctc(sum)/B
        (model/component/transducer.py:122-128, 161-189). feats [B, T, F],
        texts [B, U] (padded), lengths [B]. chunk_gen: a CPU generator for
        the dynamic-chunk draw (none: full context). dropout_gen: a generator
        on the model's device, used only in train() mode. vocab_shard: the
        mesh's model axis (`Mesh.vocab_shard`), read with `shard_joint`."""
        c = self.cfg
        gen = dropout_gen if self.training else None
        if gen is None and self.training and self._has_dropout():
            raise ValueError("a model in train() mode needs a dropout generator "
                             "(or eval() for no dropout)")
        enc_out, _ = self.encoder(feats, feat_lens, chunk_gen=chunk_gen, gen=gen)
        enc_lens = encoder_output_len(c.encoder, feat_lens)
        pred_out = self.predictor(add_blank(texts.long(), c.blank_id), gen=gen)
        plain = self.joint.plain_head
        sharded = c.shard_joint and vocab_shard is not None and vocab_shard.size > 1
        if plain and c.rnnt_prune_range > 0:
            w, b = self.joint.head_params()
            loss_rnnt = rnnt_loss_pruned(
                self.joint.project_enc(enc_out), self.joint.project_pred(pred_out), w, b,
                texts, enc_lens, text_lens, c.blank_id, c.rnnt_prune_range, "mean")
        elif plain and c.fused_joint_loss:
            w, b = self.joint.head_params()
            loss_rnnt = rnnt_loss_fused_mean(
                self.joint.project_enc(enc_out), self.joint.project_pred(pred_out), w, b,
                texts, enc_lens, text_lens, c.blank_id)
        elif sharded:
            loss_rnnt = rnnt_loss_sharded_joint(
                self.joint, self.joint.project_enc(enc_out), self.joint.project_pred(pred_out),
                texts, enc_lens, text_lens, c.blank_id, vocab_shard, "mean")
        else:
            loss_rnnt = rnnt_loss_from_logits(self.joint(enc_out, pred_out), texts, enc_lens,
                                              text_lens, c.blank_id, "mean")
        out = {"loss_rnnt": loss_rnnt}
        loss = c.transducer_weight * loss_rnnt
        if self.ctc is not None:
            loss_ctc = ctc_loss_from_logits(self.ctc(enc_out, gen), enc_lens, texts, text_lens,
                                            c.blank_id, "sum_over_batch")
            loss = loss + c.ctc_weight * loss_ctc
            out["loss_ctc"] = loss_ctc
        out["loss"] = loss
        return out

    def _has_dropout(self) -> bool:
        e, p = self.cfg.encoder, self.cfg.predictor
        rates = [e.dropout_rate, e.positional_dropout_rate, p.embed_dropout,
                 p.dropout if p.num_layers > 1 else 0.0,
                 self.cfg.ctc_dropout_rate if self.ctc is not None else 0.0]
        return any(r > 0 for r in rates)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights with the JAX package's initializer scales:
    lecun-normal dense/conv kernels (raw parameters in the JAX layout [...,
    in, out], the joint head, the MoE experts, the embedding predictor's
    pos_embed: fan-in all axes but the last), zero biases, unit layer, RMS
    and batch norms and squeezeformer's adaptive scales, xavier u/v biases
    (the grouped attention's [H, g*dk] too) and recurrent matrices, unit-normal
    embeddings (the attention decoder's: std 1/sqrt(d), flax nn.Embed's
    default), std 0.02 for Shaw's table and the learned positions. Values
    are drawn on the CPU, so a seed gives the same weights on every device.
    Batch norms' running statistics (buffers) stay at mean 0, variance 1."""
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    def xavier(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return (torch.rand(shape, generator=g) * 2.0 - 1.0) * lim

    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (LayerNorm, RMSNorm, BatchNormEval, AdaptiveScale)):
                new = torch.ones(p.shape) if name == "weight" else torch.zeros(p.shape)
            elif isinstance(mod, nn.Embedding):
                new = normal(p.shape, getattr(mod, "init_std", 1.0))
            elif name == "bias" or name == "ffn_out_bias":
                new = torch.zeros(p.shape)
            elif (isinstance(mod, (RelPositionMultiHeadedAttention, FireRedRelPositionAttention,
                                   GroupedRelPositionAttention))
                  and name.startswith("pos_bias")):
                new = xavier(p.shape)
            elif isinstance(mod, nn.ParameterList) or name in ("fwd_wh", "bwd_wh"):
                new = xavier(p.shape)  # the predictor's wh.{l}, the BLSTM's: [H, 4H]
            elif name in ("rel_k_embed", "learned_pe"):
                new = normal(p.shape, 0.02)
            elif name in ("ffn_out_kernel", "w1", "w2", "pos_embed"):  # the JAX layout
                new = normal(p.shape, 1.0 / math.sqrt(p[..., 0].numel()))
            else:  # torch layout [out, in, ...]: fan_in = in * receptive field
                new = normal(p.shape, 1.0 / math.sqrt(p[0].numel()))
            p.copy_(new)
    return model
