"""Offline evaluation: batched decode -> corpus CER with S/D/I breakdown
(port of ``tpuasr/eval/cer_eval.py``).

`make_offline_decoder` decodes waves on the model's device: fbank, the
full-context encoder, then one search: the transducer's `rnnt_greedy`,
`rnnt_beam` (optionally with per-frame CTC fusion) or `rnnt_rescoring` (the
CTC prefix-beam n-best rescored by the transducer through the RNN-T
lattice); the AED model's `attention` (attention beam search) or
`attention_rescoring` (the CTC prefix-beam n-best rescored by the attention
decoder, fused with the R2L decoder when the model has one, over the
blank-filtered frames when it was trained on them); `ctc_greedy` or
`ctc_prefix_beam` for either model. The CTC modes need the model's CTC head
(a transducer's `ctc_weight > 0`). `evaluate_offline` runs it over a
pipeline's batches and sums S/D/I over the valid rows, with every special
id stripped from reference and hypothesis alike, keeping the first
`max_samples` (utt, REF, HYP) texts. A `Paraformer` decodes in
`paraformer_greedy` (one NAR pass) or `paraformer_beam` (the positionwise
beam, its n-best's first slot).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

from tpuasr_torch.audio.fbank import fbank_batch
from tpuasr_torch.config import Config
from tpuasr_torch.decode.attention_beam import attention_beam_search
from tpuasr_torch.decode.ctc_greedy import ctc_greedy_decode
from tpuasr_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from tpuasr_torch.decode.rnnt_beam import rnnt_beam_decode
from tpuasr_torch.decode.rnnt_greedy import rnnt_greedy_decode
from tpuasr_torch.decode.dispatch import rescoring_inputs
from tpuasr_torch.decode.rnnt_rescoring import transducer_rescoring
from tpuasr_torch.models.asr_model import attention_rescoring
from tpuasr_torch.text.cer import CerCounts, cer_details

MODES = ("rnnt_greedy", "rnnt_beam", "ctc_greedy", "ctc_prefix_beam", "rnnt_rescoring",
         "attention", "attention_rescoring", "paraformer_greedy", "paraformer_beam")


@dataclass
class EvalResult:
    counts: CerCounts
    samples: list = field(default_factory=list)  # (utt_id, ref, hyp)

    @property
    def cer(self) -> float:
        return self.counts.cer


def _strip_specials(ids, tokenizer):
    specials = set(tokenizer.special_token_ids())
    return [i for i in ids if i not in specials]


def make_offline_decoder(model, cfg: Config, mode: str, beam_size: int = 4,
                         n_steps: int = 10, max_tokens: int = 200,
                         ctc_fusion_weight: float = 0.0, rescoring_ctc_weight: float = 0.5):
    """-> decode(waves [B, N], wave_lens [B]) -> (tokens, token_lens [B]),
    run on the model's device. Tokens are [B, max_tokens], or [B, T'] for
    `ctc_greedy` ([B, model.cfg.max_tokens] for the Paraformer modes).
    `ctc_fusion_weight` is `rnnt_beam`'s per-frame CTC fusion;
    `rescoring_ctc_weight` is `attention_rescoring`'s CTC weight;
    `rnnt_rescoring` fuses with cfg.model's transducer_weight and
    ctc_weight; `paraformer_beam` searches `beam_size` hypotheses."""
    if mode not in MODES:
        raise ValueError(mode)
    if mode.startswith("paraformer"):
        @torch.no_grad()
        def decode_nar(waves, wave_lens):
            feats, feat_lens = fbank_batch(waves, wave_lens, cfg.feature, device=model.device)
            if mode == "paraformer_greedy":
                return model.greedy_decode(feats, feat_lens)
            nb_toks, _, tok_lens = model.beam_decode(feats, feat_lens, beam_size)
            return nb_toks[:, 0], tok_lens

        return decode_nar
    c = cfg.model
    blank_id = model.cfg.blank_id

    @torch.no_grad()
    def decode(waves, wave_lens):
        feats, feat_lens = fbank_batch(waves, wave_lens, cfg.feature, device=model.device)
        enc, enc_lens = model.encode(feats, feat_lens)
        ctc_lp = lambda: torch.log_softmax(model.ctc_logits(enc).float(), dim=-1)
        if mode == "rnnt_greedy":
            return rnnt_greedy_decode(model, enc, enc_lens, blank_id, n_steps, max_tokens)
        if mode == "rnnt_beam":
            toks, tok_lens, *_ = rnnt_beam_decode(
                model, enc, enc_lens, blank_id, beam_size, max_tokens,
                ctc_weight=ctc_fusion_weight, transducer_weight=c.transducer_weight)
            return toks, tok_lens
        if mode == "ctc_greedy":
            return ctc_greedy_decode(ctc_lp(), enc_lens, blank_id)
        if mode == "attention":
            toks, tok_lens, _ = attention_beam_search(model, enc, enc_lens, model.cfg.sos_id,
                                                      model.cfg.eos_id, beam_size, max_tokens)
            return toks, tok_lens
        lp = ctc_lp()
        toks, tok_lens, (nb_tok, nb_len, nb_score) = ctc_prefix_beam_search(
            lp, enc_lens, blank_id, beam_size, max_tokens)
        if mode == "ctc_prefix_beam":
            return toks, tok_lens
        if mode == "attention_rescoring":
            r_enc, r_lens, rw = rescoring_inputs(model, lp, enc, enc_lens)
            toks, tok_lens, _ = attention_rescoring(model, r_enc, r_lens, nb_tok, nb_len,
                                                    nb_score, rescoring_ctc_weight,
                                                    reverse_weight=rw)
            return toks, tok_lens
        toks, tok_lens, _ = transducer_rescoring(
            model, enc, enc_lens, nb_tok, nb_len, nb_score, blank_id,
            transducer_weight=c.transducer_weight, ctc_weight=c.ctc_weight)
        return toks, tok_lens

    return decode


def evaluate_offline(model, batches: Iterable[dict], cfg: Config, tokenizer,
                     mode: str = "rnnt_greedy", beam_size: int = 4, n_steps: int = 10,
                     max_tokens: int = 200, max_samples: int = 5,
                     ctc_fusion_weight: float = 0.0, rescoring_ctc_weight: float = 0.5
                     ) -> EvalResult:
    """Decode every batch (the pipeline's dicts: waves, wave_lens, texts,
    text_lens, num_valid, utt_ids) in `mode` -> corpus S/D/I/N and the first
    `max_samples` (utt_id, REF, HYP) texts."""
    decode_fn = make_offline_decoder(model, cfg, mode, beam_size=beam_size, n_steps=n_steps,
                                     max_tokens=max_tokens,
                                     ctc_fusion_weight=ctc_fusion_weight,
                                     rescoring_ctc_weight=rescoring_ctc_weight)
    total = CerCounts(0, 0, 0, 0)
    samples = []
    for batch in batches:
        toks, tok_lens = decode_fn(batch["waves"], batch["wave_lens"])
        toks, tok_lens = toks.cpu().numpy(), tok_lens.cpu().numpy()
        texts = np.asarray(batch["texts"])
        text_lens = np.asarray(batch["text_lens"])
        n_valid = int(batch.get("num_valid", toks.shape[0]))
        for i in range(n_valid):
            ref = _strip_specials(texts[i, : text_lens[i]].tolist(), tokenizer)
            hyp = _strip_specials(toks[i, : tok_lens[i]].tolist(), tokenizer)
            total = total + cer_details(ref, hyp)
            if len(samples) < max_samples:
                utt = batch.get("utt_ids", [str(i)] * (i + 1))[i]
                samples.append((utt, " ".join(tokenizer.decode(ref)),
                                " ".join(tokenizer.decode(hyp))))
    return EvalResult(total, samples)
