"""Offline decoding of waves (port of ``make_offline_decoder`` from
``tpuasr/eval/cer_eval.py:43-138``, the rnnt_greedy mode).

Waves go through fbank, the full-context encoder and greedy search on the
model's device. Corpus CER (tokenizer, CER counts) and the other decode
modes come with later slices.
"""

from __future__ import annotations

import torch

from tpuasr_torch.audio.fbank import fbank_batch
from tpuasr_torch.config import Config
from tpuasr_torch.decode.rnnt_greedy import rnnt_greedy_decode

# decode modes of the JAX package and the ROADMAP item that ports each
LATER_MODES = {
    "rnnt_beam": "beam search (rnnt_beam.py)",
    "ctc_greedy": "CTC decoders",
    "ctc_prefix_beam": "CTC decoders",
    "rnnt_rescoring": "CTC decoders and rnnt_rescoring.py",
    "attention": "AED (asr_model.py, decoder.py, attention_beam.py)",
    "attention_rescoring": "AED (asr_model.py, decoder.py, attention_beam.py)",
    "paraformer_greedy": "Paraformer",
    "paraformer_beam": "Paraformer",
}


def make_offline_decoder(model, cfg: Config, mode: str, n_steps: int = 10,
                         max_tokens: int = 200):
    """-> decode(waves [B, N], wave_lens [B]) -> (tokens [B, max_tokens],
    token_lens [B]), run on the model's device."""
    if mode in LATER_MODES:
        raise NotImplementedError(
            f"decode mode {mode!r} is not ported yet (ROADMAP: {LATER_MODES[mode]})")
    if mode != "rnnt_greedy":
        raise ValueError(mode)
    blank_id = model.cfg.blank_id

    @torch.no_grad()
    def decode(waves, wave_lens):
        feats, feat_lens = fbank_batch(waves, wave_lens, cfg.feature, device=model.device)
        enc, enc_lens = model.encode(feats, feat_lens)
        return rnnt_greedy_decode(model, enc, enc_lens, blank_id, n_steps, max_tokens)

    return decode
