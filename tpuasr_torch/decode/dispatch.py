"""Multi-method AED decode (port of ``tpuasr/decode/dispatch.py``): any of
CTC greedy, CTC prefix beam, attention beam search and attention rescoring
over one encoder pass (wenet ASRModel.decode, asr_model.py:262-338)."""

from __future__ import annotations

from typing import Sequence

import torch

from tpuasr_torch.decode.attention_beam import attention_beam_search
from tpuasr_torch.decode.ctc_greedy import ctc_greedy_decode
from tpuasr_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from tpuasr_torch.decode.rnnt_beam import first_argmax
from tpuasr_torch.models.asr_model import attention_rescoring, filter_blank_embedding


def rescoring_inputs(model, lp: torch.Tensor, enc: torch.Tensor, enc_lens: torch.Tensor):
    """-> (the encoder output and lengths the decoder rescores over, the R2L
    fusion weight): the blank-filtered frames when the decoder was trained
    on them (the updated lengths kept), and the model's reverse_weight when
    it has a right-to-left decoder, else 0. The one rule of `decode_aed` and
    `make_offline_decoder`."""
    cfg = model.cfg
    if cfg.apply_non_blank_embedding:
        enc, enc_lens = filter_blank_embedding(lp, enc, enc_lens, cfg.blank_id)
    return enc, enc_lens, cfg.reverse_weight if cfg.r_decoder_blocks > 0 else 0.0


@torch.no_grad()
def decode_aed(model, feats: torch.Tensor, feat_lens: torch.Tensor,
               methods: Sequence[str] = ("ctc_greedy_search",), beam_size: int = 10,
               max_tokens: int = 64, ctc_weight: float = 0.5, context_graph=None,
               return_times: bool = False) -> dict:
    """-> {method: (tokens [B, U], lens [B])} for any of ctc_greedy_search,
    ctc_prefix_beam_search, attention and attention_rescoring. With
    `return_times` the CTC-derived methods return (tokens, lens, times): each
    token's frame (greedy: its emission; prefix beam and rescoring: the
    Viterbi peak carried through the n-best, rescoring's from the selected
    slot)."""
    cfg = model.cfg
    methods = set(methods)
    enc, enc_lens = model.encode(feats, feat_lens)
    results: dict = {}
    lp = None
    if {"ctc_greedy_search", "ctc_prefix_beam_search", "attention_rescoring"} & methods:
        lp = torch.log_softmax(model.ctc_logits(enc).float(), dim=-1)

    if "ctc_greedy_search" in methods:
        out = ctc_greedy_decode(lp, enc_lens, cfg.blank_id, with_details=return_times)
        results["ctc_greedy_search"] = out[:3] if return_times else out
    nbest = nb_times = None
    if {"ctc_prefix_beam_search", "attention_rescoring"} & methods:
        out = ctc_prefix_beam_search(lp, enc_lens, cfg.blank_id, beam_size, max_tokens,
                                     context_graph=context_graph, return_times=return_times)
        if return_times:
            best_tok, best_len, best_times, (*nbest, nb_times) = out
            best = (best_tok, best_len, best_times)
        else:
            best_tok, best_len, nbest = out
            best = (best_tok, best_len)
        if "ctc_prefix_beam_search" in methods:
            results["ctc_prefix_beam_search"] = best
    if "attention" in methods:
        tok, lens, _ = attention_beam_search(model, enc, enc_lens, cfg.sos_id, cfg.eos_id,
                                             beam_size, max_tokens)
        results["attention"] = (tok, lens)
    if "attention_rescoring" in methods:
        r_enc, r_lens, rw = rescoring_inputs(model, lp, enc, enc_lens)
        tok, lens, total = attention_rescoring(model, r_enc, r_lens, *nbest, ctc_weight,
                                               reverse_weight=rw)
        if return_times:
            # the times follow the selected hypothesis (search.py:448-451)
            best = first_argmax(total, 1)
            times = nb_times[torch.arange(best.shape[0], device=best.device), best]
            results["attention_rescoring"] = (tok, lens, times)
        else:
            results["attention_rescoring"] = (tok, lens)
    return results
