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
  compute type and `rnnt_loss_from_logits`.
Both routes run the lattice through kernels #8/#9 on the card and the plain
lattice on the CPU.
The module owns its weights; they come from `init_weights` (seeded) or from
a JAX checkpoint through `tpuasr_torch.convert`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpuasr_torch.config import EncoderConfig, ModelConfig
from tpuasr_torch.device import resolve_device
from tpuasr_torch.losses import ctc_loss_from_logits, rnnt_loss_from_logits
from tpuasr_torch.nn.attention import RelPositionMultiHeadedAttention
from tpuasr_torch.nn.conformer import ConformerEncoder, EncoderStreamState
from tpuasr_torch.nn.joint import TransducerJoint
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout
from tpuasr_torch.nn.predictor import RNNPredictor
from tpuasr_torch.nn.subsampling import subsampled_len
from tpuasr_torch.ops.rnnt_fused import rnnt_loss_fused_mean

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def stream_output_len(enc_cfg: EncoderConfig, feat_lens):
    """Encoder output frame count for feature lengths (conformer: the
    subsampled length)."""
    return subsampled_len(enc_cfg.input_layer, feat_lens)


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
        if cfg.rnnt_prune_range > 0:
            raise NotImplementedError("model.rnnt_prune_range > 0: the pruned RNN-T loss is "
                                      "not ported yet (ROADMAP: after the main path)")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        self.encoder = ConformerEncoder(cfg.encoder, self.dtype, dev)
        self.predictor = RNNPredictor(cfg.predictor, cfg.vocab_size, self.dtype, dev)
        self.joint = TransducerJoint(cfg.joint, cfg.encoder.output_size,
                                     cfg.predictor.output_size, cfg.vocab_size, dev)
        self.ctc = (CTCHead(cfg.encoder.output_size, cfg.vocab_size, cfg.ctc_dropout_rate, dev)
                    if cfg.ctc_weight > 0 else None)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.joint.ffn_out_bias.device

    # -------------------------------------------------- encoder entry points

    @torch.no_grad()
    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               decoding_chunk_size: int = 0, num_decoding_left_chunks: int = -1):
        """-> (enc_out [B, T', D], enc_lens [B])."""
        ys, _ = self.encoder(feats, feat_lens, decoding_chunk_size, num_decoding_left_chunks)
        return ys, stream_output_len(self.cfg.encoder, feat_lens)

    @torch.no_grad()
    def encode_chunk(self, xs: torch.Tensor, state: EncoderStreamState):
        """One streaming chunk -> ([B, chunk, D], new encoder state)."""
        return self.encoder.forward_chunk(xs, state)

    def init_encoder_state(self, batch: int, chunk_size: int,
                           num_left_chunks: int) -> EncoderStreamState:
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
                dropout_gen: torch.Generator | None = None) -> dict:
        """Hybrid loss forward -> {"loss", "loss_rnnt", "loss_ctc"}.

        loss = transducer_weight * rnnt(mean) + ctc_weight * ctc(sum)/B
        (model/component/transducer.py:122-128, 161-189). feats [B, T, F],
        texts [B, U] (padded), lengths [B]. chunk_gen: a CPU generator for
        the dynamic-chunk draw (none: full context). dropout_gen: a generator
        on the model's device, used only in train() mode."""
        c = self.cfg
        gen = dropout_gen if self.training else None
        if gen is None and self.training and self._has_dropout():
            raise ValueError("a model in train() mode needs a dropout generator "
                             "(or eval() for no dropout)")
        enc_out, _ = self.encoder(feats, feat_lens, chunk_gen=chunk_gen, gen=gen)
        enc_lens = stream_output_len(c.encoder, feat_lens)
        pred_out = self.predictor(add_blank(texts.long(), c.blank_id), gen=gen)
        if c.fused_joint_loss:
            w, b = self.joint.head_params()
            loss_rnnt = rnnt_loss_fused_mean(
                self.joint.project_enc(enc_out), self.joint.project_pred(pred_out), w, b,
                texts, enc_lens, text_lens, c.blank_id)
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
    lecun-normal dense/conv kernels, zero biases, unit layer norms, xavier
    u/v biases and recurrent matrices, unit-normal embeddings (the attention
    decoder's: std 1/sqrt(d), flax nn.Embed's default). Values are
    drawn on the CPU, so a seed gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    def xavier(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return (torch.rand(shape, generator=g) * 2.0 - 1.0) * lim

    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, LayerNorm):
                new = torch.ones(p.shape) if name == "weight" else torch.zeros(p.shape)
            elif isinstance(mod, nn.Embedding):
                new = normal(p.shape, getattr(mod, "init_std", 1.0))
            elif name == "bias" or name == "ffn_out_bias":
                new = torch.zeros(p.shape)
            elif isinstance(mod, RelPositionMultiHeadedAttention) and name.startswith("pos_bias"):
                new = xavier(p.shape)
            elif isinstance(mod, nn.ParameterList):  # predictor wh.{l}: [H, 4H]
                new = xavier(p.shape)
            elif name == "ffn_out_kernel":  # [D, V]
                new = normal(p.shape, 1.0 / math.sqrt(p.shape[0]))
            else:  # torch layout [out, in, ...]: fan_in = in * receptive field
                new = normal(p.shape, 1.0 / math.sqrt(p[0].numel()))
            p.copy_(new)
    return model
