"""Streaming evaluation: chunked greedy and beam CER and the beam's relative
improvement (port of ``tpuasr/eval/streaming_eval.py``).

B streams decode at once: fbank of the batch on the model's device, then
`streaming_greedy_decode` and `streaming_beam_decode` chunk by chunk, each
stream's decode gated at its own encoder length.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from tpuasr_torch.audio.fbank import fbank_batch
from tpuasr_torch.config import Config
from tpuasr_torch.decode.rnnt_streaming import streaming_beam_decode, streaming_greedy_decode
from tpuasr_torch.eval.cer_eval import _strip_specials
from tpuasr_torch.text.cer import CerCounts, cer_details


@dataclass
class StreamingEvalResult:
    greedy: CerCounts
    beam: CerCounts
    samples: list = field(default_factory=list)  # (utt, ref, greedy_hyp, beam_hyp)

    @property
    def relative_improvement(self) -> float:
        g, b = self.greedy.cer, self.beam.cer
        return (g - b) / max(g, 1e-9)


def evaluate_streaming(model, batches: Iterable[dict], cfg: Config, tokenizer,
                       beam_size: int = 4, n_steps: int = 10, max_tokens: int = 200,
                       max_samples: int = 5, run_beam: bool = True) -> StreamingEvalResult:
    """Streaming greedy (and beam) decode of every batch with
    cfg.streaming's chunk and left chunks -> both corpus CERs and the first
    `max_samples` (utt, REF, GREEDY, BEAM) texts."""
    c = cfg.model
    chunk, left = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks
    g_total = CerCounts(0, 0, 0, 0)
    b_total = CerCounts(0, 0, 0, 0)
    samples = []
    for batch in batches:
        feats, feat_lens = fbank_batch(batch["waves"], batch["wave_lens"], cfg.feature,
                                       device=model.device)
        g_toks, g_lens, _ = streaming_greedy_decode(model, feats, feat_lens, chunk, left,
                                                    c.blank_id, n_steps, max_tokens)
        g_toks, g_lens = g_toks.cpu().numpy(), g_lens.cpu().numpy()
        if run_beam:
            b_toks, b_lens, _ = streaming_beam_decode(model, feats, feat_lens, chunk, left,
                                                      c.blank_id, beam_size, max_tokens)
            b_toks, b_lens = b_toks.cpu().numpy(), b_lens.cpu().numpy()
        texts = np.asarray(batch["texts"])
        text_lens = np.asarray(batch["text_lens"])
        n_valid = int(batch.get("num_valid", g_toks.shape[0]))
        for i in range(n_valid):
            ref = _strip_specials(texts[i, : text_lens[i]].tolist(), tokenizer)
            g_hyp = _strip_specials(g_toks[i, : g_lens[i]].tolist(), tokenizer)
            g_total = g_total + cer_details(ref, g_hyp)
            b_hyp = None
            if run_beam:
                b_hyp = _strip_specials(b_toks[i, : b_lens[i]].tolist(), tokenizer)
                b_total = b_total + cer_details(ref, b_hyp)
            if len(samples) < max_samples:
                utt = batch.get("utt_ids", [str(i)] * (i + 1))[i]
                samples.append((
                    utt,
                    " ".join(tokenizer.decode(ref)),
                    " ".join(tokenizer.decode(g_hyp)),
                    " ".join(tokenizer.decode(b_hyp)) if b_hyp is not None else "",
                ))
    return StreamingEvalResult(g_total, b_total, samples)
