"""Paraformer: non-autoregressive ASR with the CIF aligner (port of
``tpuasr/models/paraformer.py``).

encoder -> CIF predictor (frame weights, integrate-and-fire acoustic
embeddings; teacher-forced count scaling in training, the tail-threshold
frame at inference) -> the glancing sampler in training (a first decode
without gradient or dropout, then ratio · #wrong valid positions of the
acoustic embeddings replaced by the targets' embeddings) -> a bidirectional
NAR decoder over the encoder memory -> label-smoothed CE + the quantity
loss, optionally a CTC branch on the encoder output and the timestamp
branch's quantity loss. Decoding is one pass: count = floor(sum of the
fired weights), a token per fired position by argmax, times from the CIF
peaks; n-best by `tpuasr_torch.decode.paraformer_beam.nar_beam_search`.

Two stacks: `encoder_type="conformer"` (the port's conformer encoder,
kernels #2/#3 with `encoder.fused_attention`, #10/#11 with
`encoder.fused_ffn`, and the `TransformerDecoder` through `inputs_embeds`
with `causal=False`) and `encoder_type="sanm"` (LFR m/n + the SANM encoder
and decoder, plain PyTorch). Features come from fbank (kernel #1) in the
train step and the decoders; the CTC branch runs the lattice kernels #6/#7
on the card.

The sampler's uniform scores come from a generator the train step passes
(`sampler_gen`) or are given (`sampler_scores` [B, U+1 with <eos>]): the
JAX package draws them with `jax.random.uniform`, which torch cannot
reproduce, so tests feed both sides the same draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.device import resolve_device
from tpuasr_torch.losses import ctc_loss_from_logits
from tpuasr_torch.models.transducer import DTYPES
from tpuasr_torch.nn.cif import CifPredictor, TimestampPredictor, cif_peaks, quantity_loss
from tpuasr_torch.nn.conformer import ConformerEncoder
from tpuasr_torch.nn.decoder import TransformerDecoder, label_smoothing_loss
from tpuasr_torch.nn.layers import Dense
from tpuasr_torch.nn.masks import make_pad_mask
from tpuasr_torch.nn.sanm import SanmDecoder, SanmEncoder, lfr
from tpuasr_torch.nn.subsampling import subsampled_len


@dataclass
class ParaformerConfig:
    vocab_size: int = 412
    ignore_id: int = -1
    lsm_weight: float = 0.1
    quantity_weight: float = 1.0
    decoder_blocks: int = 6
    decoder_heads: int = 4
    decoder_ffn: int = 1024
    max_tokens: int = 64
    compute_dtype: str = "float32"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    # conformer (the TransformerDecoder over the fired embeddings) | sanm
    encoder_type: str = "conformer"
    lfr_m: int = 7  # LFR stack size (wenet/paraformer/layers.py:25)
    lfr_n: int = 6  # LFR stride
    sanm_kernel: int = 11
    sanm_shift: int = 0
    sampler: bool = True  # the glancing sampler (training steps with a sampler generator)
    sampling_ratio: float = 0.75
    add_eos: bool = True  # <eos> appended to the predictor's and decoder's targets
    eos_id: int = 3
    ctc_weight: float = 0.0  # > 0: a CTC branch over the encoder output
    ctc_blank: int = 5
    timestamp_branch: bool = False  # the upsampled BLSTM weight head + its quantity loss
    cif_tail_threshold: float = 0.45
    cif_dropout: float = 0.1


class Paraformer(nn.Module):
    def __init__(self, cfg: ParaformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in {sorted(DTYPES)}")
        if cfg.encoder_type not in ("conformer", "sanm"):
            raise ValueError(f"unknown Paraformer encoder_type {cfg.encoder_type!r}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        e = cfg.encoder
        d = e.output_size
        if cfg.encoder_type == "sanm":
            self.encoder = SanmEncoder(e.input_size * cfg.lfr_m, d, e.attention_heads,
                                       e.linear_units, e.num_blocks, cfg.sanm_kernel,
                                       cfg.sanm_shift, e.dropout_rate, e.max_len, self.dtype,
                                       dev)
            self.decoder = SanmDecoder(cfg.vocab_size, d, cfg.decoder_heads, cfg.decoder_ffn,
                                       cfg.decoder_blocks, cfg.sanm_kernel, cfg.sanm_shift,
                                       e.dropout_rate, dev)
        else:
            self.encoder = ConformerEncoder(e, self.dtype, dev)
            self.decoder = TransformerDecoder(cfg.vocab_size, d, cfg.decoder_heads,
                                              cfg.decoder_ffn, cfg.decoder_blocks,
                                              e.dropout_rate, e.max_len, self.dtype, dev)
            # the fired embeddings replace the token embedding, which the flax
            # module therefore never creates
            self.decoder.embed = None
        self.predictor = CifPredictor(d, dropout_rate=cfg.cif_dropout,
                                      tail_threshold=cfg.cif_tail_threshold, device=dev)
        if cfg.sampler:
            self.sampler_embed = nn.Embedding(cfg.vocab_size, d, device=dev)
            self.sampler_embed.init_std = d ** -0.5  # flax nn.Embed's default
        if cfg.ctc_weight > 0.0:
            self.ctc_lo = Dense(d, cfg.vocab_size, device=dev)
        if cfg.timestamp_branch:
            self.tp = TimestampPredictor(d, device=dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.predictor.cif_output.weight.device

    # ------------------------------------------------------------- pieces

    def _encode(self, feats, feat_lens, chunk_gen=None, gen=None):
        """-> (enc [B, T', D], enc_lens [B])."""
        c = self.cfg
        if c.encoder_type == "sanm":
            stacked, lens = lfr(feats, feat_lens, c.lfr_m, c.lfr_n)
            return self.encoder(stacked, lens, gen)[0], lens
        ys, _ = self.encoder(feats, feat_lens, chunk_gen=chunk_gen, gen=gen)
        return ys, subsampled_len(c.encoder.input_layer, feat_lens)

    @torch.no_grad()
    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """Serving: -> (enc [B, T', D], enc_lens [B])."""
        return self._encode(feats, feat_lens)

    def _decode_embeds(self, enc, enc_lens, embeds, embed_lens, gen=None) -> torch.Tensor:
        """The NAR decoder over the embeddings -> logits [B, U, V]."""
        if self.cfg.encoder_type == "sanm":
            return self.decoder(enc, enc_lens, embeds, embed_lens, gen)
        return self.decoder(enc, enc_lens, None, embed_lens, gen, inputs_embeds=embeds,
                            causal=False)

    def _sample_embeds(self, enc, enc_lens, ys, ys_lens, acoustic, scores) -> torch.Tensor:
        """The glancing sampler (wenet/paraformer/paraformer.py:236-275):
        decode once from the acoustic embeddings (no gradient, no dropout),
        count each row's wrong positions, and replace the `sampling_ratio`
        share of them, the valid positions of lowest `scores` [B, U]
        (uniform draws), by the targets' embeddings."""
        u = ys.shape[1]
        tgt_mask = torch.arange(u, device=ys.device)[None, :] < ys_lens[:, None]
        with torch.no_grad():
            pred = self._decode_embeds(enc, enc_lens, acoustic, ys_lens).argmax(dim=-1)
        same = ((pred == ys) & tgt_mask).sum(dim=1)
        target_num = ((ys_lens - same).float() * self.cfg.sampling_ratio).long()
        scores = torch.where(tgt_mask, scores.to(ys.device), 2.0)  # padding never chosen
        rank = torch.argsort(torch.argsort(scores, dim=1, stable=True), dim=1, stable=True)
        replace = rank < target_num[:, None]
        tok = self.sampler_embed(torch.where(tgt_mask, ys, 0)).to(acoustic.dtype)
        sem = torch.where(replace[..., None], tok, acoustic)
        return torch.where(tgt_mask[..., None], sem, 0)

    # ------------------------------------------------------------- training

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor, texts: torch.Tensor,
                text_lens: torch.Tensor, chunk_gen: torch.Generator | None = None,
                dropout_gen: torch.Generator | None = None,
                sampler_gen: torch.Generator | None = None,
                sampler_scores: torch.Tensor | None = None) -> dict:
        """-> {"loss", "loss_ce", "loss_quantity"} (+ "loss_ctc",
        "loss_quantity_tp"). feats [B, T, F], texts [B, U] (bare ids,
        padded), lengths [B]. dropout_gen: a generator on the model's
        device, used only in train() mode; the sampler runs (with
        cfg.sampler) when given `sampler_gen` (a generator on the model's
        device drawing the [B, U+1] scores) or `sampler_scores`, as the JAX
        model samples only with a "sampler" rng, which its train step alone
        passes."""
        c = self.cfg
        gen = dropout_gen if self.training else None
        if gen is None and self.training and self._has_dropout():
            raise ValueError("a model in train() mode needs a dropout generator "
                             "(or eval() for no dropout)")
        texts, text_lens = texts.long(), text_lens.long()
        enc, enc_lens = self._encode(feats, feat_lens, chunk_gen, gen)
        enc_lens = enc_lens.to(enc.device)
        mask = ~make_pad_mask(enc_lens, enc.shape[1])

        ys, ys_lens = texts, text_lens
        if c.add_eos:  # the targets + <eos> feed the predictor and the decoder
            ys = torch.nn.functional.pad(texts, (0, 1))
            eos_slot = torch.arange(ys.shape[1], device=ys.device)[None, :] == text_lens[:, None]
            ys = torch.where(eos_slot, c.eos_id, ys)
            ys_lens = text_lens + 1

        embeds, pred_count, _ = self.predictor(enc, mask, ys.shape[1], target_lens=ys_lens,
                                               gen=gen)
        if c.sampler and (sampler_gen is not None or sampler_scores is not None):
            if sampler_scores is None:
                sampler_scores = torch.rand(ys.shape, generator=sampler_gen, device=ys.device)
            embeds = self._sample_embeds(enc, enc_lens, ys, ys_lens, embeds, sampler_scores)
        logits = self._decode_embeds(enc, enc_lens, embeds, ys_lens, gen)
        loss_ce = label_smoothing_loss(logits, ys, ys_lens, c.lsm_weight)
        loss_qty = quantity_loss(pred_count, ys_lens)
        loss = loss_ce + c.quantity_weight * loss_qty
        out = {"loss_ce": loss_ce, "loss_quantity": loss_qty}
        if c.ctc_weight > 0.0:
            loss_ctc = ctc_loss_from_logits(self.ctc_lo(enc), enc_lens, texts, text_lens,
                                            c.ctc_blank)
            loss = loss + c.ctc_weight * loss_ctc
            out["loss_ctc"] = loss_ctc
        if c.timestamp_branch:
            loss_tp = quantity_loss(self.tp(enc, mask).sum(dim=1), ys_lens)
            loss = loss + loss_tp
            out["loss_quantity_tp"] = loss_tp
        out["loss"] = loss
        return out

    def _has_dropout(self) -> bool:
        e = self.cfg.encoder
        return any(r > 0 for r in (e.dropout_rate, e.positional_dropout_rate,
                                   e.attention_dropout_rate, self.cfg.cif_dropout))

    # ------------------------------------------------------------- decoding

    @torch.no_grad()
    def _predict(self, feats, feat_lens):
        """-> (enc, enc_lens, logits [B, K, V], lens [B] int32, the fired
        weights [B, T'+1]), K = cfg.max_tokens."""
        k = self.cfg.max_tokens
        enc, enc_lens = self._encode(feats, feat_lens)
        enc_lens = enc_lens.to(enc.device)
        mask = ~make_pad_mask(enc_lens, enc.shape[1])
        embeds, pred_count, alphas = self.predictor(enc, mask, k)
        lens = pred_count.to(torch.int32).clamp(0, k)
        return enc, enc_lens, self._decode_embeds(enc, enc_lens, embeds, lens), lens, alphas

    def _greedy(self, logits, lens):
        k = self.cfg.max_tokens
        valid = torch.arange(k, device=lens.device)[None, :] < lens[:, None]
        tokens = torch.where(valid, logits.argmax(dim=-1).to(torch.int32), 0)
        return tokens, valid

    @torch.no_grad()
    def greedy_decode(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """One NAR pass -> (tokens [B, max_tokens] int32, lens [B] int32)."""
        _, _, logits, lens, _ = self._predict(feats, feat_lens)
        return self._greedy(logits, lens)[0], lens

    @torch.no_grad()
    def greedy_decode_with_times(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """-> (tokens, lens, times [B, max_tokens] int32): each token's CIF
        fire frame (an encoder frame; wenet paraformer/search.py:166-178)."""
        k = self.cfg.max_tokens
        _, _, logits, lens, alphas = self._predict(feats, feat_lens)
        tokens, valid = self._greedy(logits, lens)
        pk = cif_peaks(alphas) > 0  # [B, T'+1]
        b, t = pk.shape
        tok_idx = torch.cumsum(pk.long(), dim=1) - 1  # the token a fire frame closes
        slot = torch.where(pk, tok_idx.clamp(max=k - 1), k)
        frames = torch.arange(t, device=pk.device)[None, :].expand(b, t)
        times = torch.full((b, k + 1), t, dtype=torch.long, device=pk.device)
        times = times.scatter_reduce(1, slot, frames, "amin")
        return tokens, lens, torch.where(valid, times[:, :k], 0).to(torch.int32)

    @torch.no_grad()
    def beam_decode(self, feats: torch.Tensor, feat_lens: torch.Tensor, beam_size: int = 10):
        """The positionwise beam over the NAR logits -> (n-best tokens [B, N,
        max_tokens] int32, scores [B, N] descending, lens [B] int32)."""
        from tpuasr_torch.decode.paraformer_beam import nar_beam_search

        _, _, logits, lens, _ = self._predict(feats, feat_lens)
        tokens, scores = nar_beam_search(logits, lens, beam_size, self.cfg.eos_id)
        return tokens, scores, lens
