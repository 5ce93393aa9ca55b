"""Hybrid CTC/attention encoder-decoder, the AED workload (port of
``tpuasr/models/asr_model.py``).

The conformer encoder, a linear CTC head and a transformer attention
decoder (optionally a second, right-to-left one); the loss is
``ctc_weight · ctc + (1 - ctc_weight) · att`` with label smoothing over
<sos>/<eos>-wrapped targets (wenet asr_model.py:35-338). The encoder runs
the port's kernels as the transducer's does (#2/#3 with
`encoder.fused_attention`, #10/#11 with `encoder.fused_ffn`), the CTC loss
the lattice kernels #6/#7 on the card (`ctc_loss_from_logits`); the decoder
is plain PyTorch. `attention_rescoring` rescores the CTC prefix beam's
n-best with one batched teacher-forced decoder pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.decode.rnnt_beam import first_argmax
from tpuasr_torch.device import resolve_device
from tpuasr_torch.losses import ctc_loss_from_logits
from tpuasr_torch.models.transducer import DTYPES
from tpuasr_torch.nn.conformer import ConformerEncoder
from tpuasr_torch.nn.decoder import TransformerDecoder, label_smoothing_loss
from tpuasr_torch.nn.layers import Dense
from tpuasr_torch.nn.subsampling import subsampled_len


@dataclass
class AEDConfig:
    vocab_size: int = 412
    blank_id: int = 5
    sos_id: int = 2
    eos_id: int = 3
    ctc_weight: float = 0.3
    lsm_weight: float = 0.1
    decoder_blocks: int = 6
    decoder_heads: int = 4
    decoder_ffn: int = 1024
    # r_decoder_blocks > 0: a right-to-left decoder trained on the reversed
    # targets, loss (1 - reverse_weight) · l2r + reverse_weight · r2l;
    # rescoring fuses both directions' scores
    r_decoder_blocks: int = 0
    reverse_weight: float = 0.3
    # feed the decoder only the frames whose CTC argmax is not blank (needs
    # ctc_weight > 0)
    apply_non_blank_embedding: bool = False
    compute_dtype: str = "float32"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)


def filter_blank_embedding(ctc_scores: torch.Tensor, enc_out: torch.Tensor,
                           enc_lens: torch.Tensor, blank_id: int):
    """Move the frames whose CTC argmax is not blank to the front, in order
    (a stable partition), and zero the tail: ctc_scores [B, T, V] (any
    monotone score), enc_out [B, T, D], enc_lens [B] -> (enc_out, the new
    lengths). Shapes stay; the lengths shrink and must be used downstream."""
    top1 = ctc_scores.argmax(dim=-1)  # the first of equal maxima
    pos = torch.arange(enc_out.shape[1], device=enc_out.device)[None, :]
    keep = (top1 != blank_id) & (pos < enc_lens[:, None])
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    new_out = torch.gather(enc_out, 1, order[..., None].expand(-1, -1, enc_out.shape[2]))
    new_lens = keep.sum(dim=1).to(enc_lens.dtype)
    new_out = torch.where((pos < new_lens[:, None])[..., None], new_out, 0)
    return new_out, new_lens


def th_accuracy(logits: torch.Tensor, targets: torch.Tensor, lens: torch.Tensor):
    """Teacher-forced token accuracy over the positions below `lens`."""
    pred = logits.argmax(dim=-1)
    valid = torch.arange(targets.shape[1], device=targets.device)[None, :] < lens[:, None]
    correct = (valid & (pred == targets)).sum()
    return correct.float() / valid.sum().clamp(min=1)


def _reverse_padded(tokens: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix, the padding left in place."""
    idx = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    lens = lens.to(tokens.device).long()[:, None]
    src = torch.where(idx < lens, lens - 1 - idx, idx)
    return torch.gather(tokens, 1, src)


def _wrap_targets(texts, text_lens, sos_id: int, eos_id: int):
    """[B, U] tokens -> (<sos> y [B, U+1], y <eos> [B, U+1])."""
    b, u = texts.shape
    ys_in = torch.nn.functional.pad(texts, (1, 0), value=sos_id)
    eos_slot = torch.arange(u + 1, device=texts.device)[None, :] == text_lens[:, None]
    ys_out = torch.nn.functional.pad(texts, (0, 1), value=0)
    return ys_in, torch.where(eos_slot, eos_id, ys_out)


class ASRModel(nn.Module):
    def __init__(self, cfg: AEDConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in {sorted(DTYPES)}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        e = cfg.encoder
        self.encoder = ConformerEncoder(e, self.dtype, dev)
        dec = lambda blocks: TransformerDecoder(
            cfg.vocab_size, e.output_size, cfg.decoder_heads, cfg.decoder_ffn, blocks,
            e.dropout_rate, e.max_len, self.dtype, dev)
        self.decoder = dec(cfg.decoder_blocks)
        self.r_decoder = dec(cfg.r_decoder_blocks) if cfg.r_decoder_blocks > 0 else None
        self.ctc_lo = Dense(e.output_size, cfg.vocab_size, device=dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.ctc_lo.weight.device

    # -------------------------------------------------- serving entry points

    @torch.no_grad()
    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               decoding_chunk_size: int = 0, num_decoding_left_chunks: int = -1):
        """-> (enc_out [B, T', D], enc_lens [B])."""
        ys, _ = self.encoder(feats, feat_lens, decoding_chunk_size, num_decoding_left_chunks)
        return ys, subsampled_len(self.cfg.encoder.input_layer, feat_lens)

    def ctc_logits(self, enc_out: torch.Tensor) -> torch.Tensor:
        """The CTC head in fp32, as the JAX package's dtype-less Dense."""
        return self.ctc_lo(enc_out.float())

    @torch.no_grad()
    def decoder_scores(self, enc_out, enc_lens, ys_in, ys_lens):
        """Teacher-forced decoder logits [B, L, V]."""
        return self.decoder(enc_out, enc_lens, ys_in, ys_lens)

    @torch.no_grad()
    def r_decoder_scores(self, enc_out, enc_lens, ys_in, ys_lens):
        """Teacher-forced right-to-left decoder logits [B, L, V]."""
        return self.r_decoder(enc_out, enc_lens, ys_in, ys_lens)

    # the autoregressive surface of decode/attention_beam.py
    @torch.no_grad()
    def decoder_project_memory(self, memory):
        return self.decoder.project_memory(memory)

    def decoder_init_cache(self, batch: int, lmax: int):
        return self.decoder.init_ar_cache(batch, lmax)

    @torch.no_grad()
    def decoder_one_step(self, tokens, pos: int, kcache, vcache, mem_k, mem_v, mem_mask):
        return self.decoder.forward_one_step(tokens, pos, kcache, vcache, mem_k, mem_v,
                                             mem_mask)

    # -------------------------------------------------- training forward

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor, texts: torch.Tensor,
                text_lens: torch.Tensor, chunk_gen: torch.Generator | None = None,
                dropout_gen: torch.Generator | None = None) -> dict:
        """-> {"loss", "loss_ctc", "loss_att", "th_accuracy"}. feats [B, T, F],
        texts [B, U] (bare ids, padded), lengths [B]. chunk_gen: a CPU
        generator for the dynamic-chunk draw (none: full context);
        dropout_gen: a generator on the model's device, used only in train()
        mode."""
        c = self.cfg
        gen = dropout_gen if self.training else None
        if gen is None and self.training and self._has_dropout():
            raise ValueError("a model in train() mode needs a dropout generator "
                             "(or eval() for no dropout)")
        texts = texts.long()
        enc_out, _ = self.encoder(feats, feat_lens, chunk_gen=chunk_gen, gen=gen)
        enc_lens = subsampled_len(c.encoder.input_layer, feat_lens)

        # the CTC branch first: with apply_non_blank_embedding its logits
        # choose the decoder's frames
        ctc_logits = self.ctc_logits(enc_out)
        loss_ctc = ctc_loss_from_logits(ctc_logits, enc_lens, texts, text_lens, c.blank_id,
                                        "sum_over_batch")
        att_enc, att_lens = enc_out, enc_lens
        if c.apply_non_blank_embedding:
            if c.ctc_weight == 0.0:
                raise ValueError("apply_non_blank_embedding requires a trained CTC head "
                                 "(ctc_weight > 0)")
            att_enc, att_lens = filter_blank_embedding(ctc_logits.detach(), enc_out, enc_lens,
                                                       c.blank_id)

        ys_in, ys_out = _wrap_targets(texts, text_lens, c.sos_id, c.eos_id)
        ys_lens = text_lens + 1
        dec_logits = self.decoder(att_enc, att_lens, ys_in, ys_lens, gen)
        loss_att = label_smoothing_loss(dec_logits, ys_out, ys_lens, c.lsm_weight)
        acc = th_accuracy(dec_logits.detach(), ys_out, ys_lens)
        if self.r_decoder is not None and c.reverse_weight > 0:
            r_in, r_out = _wrap_targets(_reverse_padded(texts, text_lens), text_lens,
                                        c.sos_id, c.eos_id)
            r_logits = self.r_decoder(att_enc, att_lens, r_in, ys_lens, gen)
            loss_r = label_smoothing_loss(r_logits, r_out, ys_lens, c.lsm_weight)
            loss_att = (1.0 - c.reverse_weight) * loss_att + c.reverse_weight * loss_r
        loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_att
        return {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att, "th_accuracy": acc}

    def _has_dropout(self) -> bool:
        e = self.cfg.encoder
        return any(r > 0 for r in (e.dropout_rate, e.positional_dropout_rate,
                                   e.attention_dropout_rate))


@torch.no_grad()
def attention_rescoring(model: ASRModel, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                        nbest_tokens: torch.Tensor, nbest_lens: torch.Tensor,
                        nbest_ctc_scores: torch.Tensor, ctc_weight: float = 0.5,
                        reverse_weight: float = 0.0, return_confidence: bool = False):
    """Pick the best CTC n-best hypothesis by att_logp(hyp) + ctc_weight ·
    ctc_score (wenet search.py:369-453): enc_out [B, T, D], nbest_tokens
    [B, N, U], nbest_lens and nbest_ctc_scores [B, N] -> (tokens [B, U],
    lens [B], fused scores [B, N]). With `reverse_weight` > 0 and an R2L
    decoder, att_logp fuses both directions. Empty slots (ctc score <=
    -1e29) stay at -1e30. With `return_confidence` also the chosen
    hypothesis' confidence exp(att / (len + 1)) [B] and its token
    confidences [B, U] (exp of each token's log-prob, averaged over both
    directions when fused; 0 past its length)."""
    c = model.cfg
    b, n, u = nbest_tokens.shape
    dev = enc_out.device
    flat_tok = nbest_tokens.reshape(b * n, u).long()
    flat_len = nbest_lens.reshape(b * n).long()
    enc_rep = enc_out.repeat_interleave(n, dim=0)
    lens_rep = enc_lens.repeat_interleave(n, dim=0)
    u_idx = torch.arange(u + 1, device=dev)[None, :]

    def score_dir(tokens, decoder):
        """-> (hypothesis scores [B, N], each position's token log-prob
        [B, N, U+1])."""
        ys_in, tgt = _wrap_targets(tokens, flat_len, c.sos_id, c.eos_id)
        logits = decoder(enc_rep, lens_rep, ys_in, flat_len + 1)
        lp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = torch.gather(lp, 2, tgt[..., None])[..., 0]
        scores = torch.where(u_idx <= flat_len[:, None], tok_lp, 0.0).sum(dim=1)
        return scores.view(b, n), tok_lp.view(b, n, u + 1)

    att_score, fw_lp = score_dir(flat_tok, model.decoder_scores)
    tok_conf = torch.exp(fw_lp[:, :, :u])
    if reverse_weight > 0 and model.r_decoder is not None:
        r_score, bw_lp = score_dir(_reverse_padded(flat_tok, flat_len), model.r_decoder_scores)
        att_score = (1.0 - reverse_weight) * att_score + reverse_weight * r_score
        # backward position j scored token len-1-j: un-reverse, then average
        bw_conf = _reverse_padded(torch.exp(bw_lp[:, :, :u]).reshape(b * n, u), flat_len)
        tok_conf = (tok_conf + bw_conf.view(b, n, u)) / 2.0

    total = att_score + ctc_weight * nbest_ctc_scores
    total = torch.where(nbest_ctc_scores > -1.0e29, total, -1.0e30)
    best = first_argmax(total, 1)
    rows = torch.arange(b, device=dev)
    tokens, lens = nbest_tokens[rows, best], nbest_lens[rows, best]
    if not return_confidence:
        return tokens, lens, total
    confidence = torch.exp(att_score[rows, best] / (lens + 1))
    valid = torch.arange(u, device=dev)[None, :] < lens[:, None]
    return tokens, lens, total, confidence, torch.where(valid, tok_conf[rows, best], 0.0)
