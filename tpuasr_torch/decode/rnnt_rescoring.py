"""Transducer rescoring of a CTC prefix-beam n-best (port of
``tpuasr/decode/rnnt_rescoring.py``): CTC proposes the prefixes, the
transducer scores them, and the fused score
``tw * log p_rnnt + cw * ctc_score`` picks each stream's hypothesis.

The n-best flattens to B*N rows, and one pass of the joint's full logits
and the RNN-T lattice scores them all: `rnnt_loss_from_logits(...,
"none")`, which on the card runs the lattice's forward, kernel #8, alone
(no gradient is asked for). The rows keep the n-best's width (U =
max_tokens), as the JAX package's do."""

from __future__ import annotations

import torch

from tpuasr_torch.decode.rnnt_beam import take_best
from tpuasr_torch.losses import rnnt_loss_from_logits
from tpuasr_torch.models.transducer import add_blank

_NEG = -1.0e30


@torch.no_grad()
def transducer_rescoring(model, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                         nbest_tokens: torch.Tensor, nbest_lens: torch.Tensor,
                         nbest_scores: torch.Tensor, blank_id: int,
                         transducer_weight: float = 0.7, ctc_weight: float = 0.3):
    """enc_out [B, T, D], enc_lens [B], the n-best tokens [B, N, U], lens
    [B, N] and CTC beam scores [B, N] -> (tokens [B, U], lens [B], fused
    scores [B, N]); an empty n-best slot (score -1e30) stays at -1e30."""
    b, n, u = nbest_tokens.shape
    flat_tok = nbest_tokens.reshape(b * n, u)
    flat_len = nbest_lens.reshape(b * n)
    enc_rep = enc_out.repeat_interleave(n, dim=0)
    lens_rep = enc_lens.to(enc_out.device).repeat_interleave(n, dim=0)
    pred = model.predictor(add_blank(flat_tok, blank_id))
    nll = rnnt_loss_from_logits(model.joint(enc_rep, pred), flat_tok, lens_rep, flat_len,
                                blank_id, "none").reshape(b, n)
    total = transducer_weight * (-nll) + ctc_weight * nbest_scores
    total = torch.where(nbest_scores > _NEG / 2, total, _NEG)
    return (*take_best(total, nbest_tokens, nbest_lens), total)
