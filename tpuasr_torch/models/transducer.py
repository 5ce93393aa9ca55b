"""RNN-Transducer model, serving half (port of
``tpuasr/models/transducer.py:109-211``).

Offline and streaming are one model with two call paths: `encode` (full or
chunk-masked context) and `encode_chunk` (fixed-shape caches). The module
owns its weights; they come from `init_weights` (seeded) or from a JAX
checkpoint through `tpuasr_torch.convert`. The loss forward comes with the
training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpuasr_torch.config import EncoderConfig, ModelConfig
from tpuasr_torch.device import resolve_device
from tpuasr_torch.nn.attention import RelPositionMultiHeadedAttention
from tpuasr_torch.nn.conformer import ConformerEncoder, EncoderStreamState
from tpuasr_torch.nn.joint import TransducerJoint
from tpuasr_torch.nn.layers import Dense, LayerNorm
from tpuasr_torch.nn.predictor import RNNPredictor
from tpuasr_torch.nn.subsampling import subsampled_len

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def stream_output_len(enc_cfg: EncoderConfig, feat_lens):
    """Encoder output frame count for feature lengths (conformer: the
    subsampled length)."""
    return subsampled_len(enc_cfg.input_layer, feat_lens)


class CTCHead(nn.Module):
    """Linear CTC head; computes in fp32 like the JAX package's
    dtype-less Dense."""

    def __init__(self, idim: int, vocab_size: int, device=None):
        super().__init__()
        self.ctc_lo = Dense(idim, vocab_size, device=device)

    def forward(self, enc_out: torch.Tensor) -> torch.Tensor:
        return self.ctc_lo(enc_out.float())


class Transducer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in {sorted(DTYPES)}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        self.encoder = ConformerEncoder(cfg.encoder, self.dtype, dev)
        self.predictor = RNNPredictor(cfg.predictor, cfg.vocab_size, self.dtype, dev)
        self.joint = TransducerJoint(cfg.joint, cfg.encoder.output_size,
                                     cfg.predictor.output_size, cfg.vocab_size, dev)
        self.ctc = (CTCHead(cfg.encoder.output_size, cfg.vocab_size, dev)
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


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights with the JAX package's initializer scales:
    lecun-normal dense/conv kernels, zero biases, unit layer norms, xavier
    u/v biases and recurrent matrices, unit-normal embeddings. Values are
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
                new = normal(p.shape, 1.0)
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
