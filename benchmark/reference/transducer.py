"""Plain RNN-T pieces in float32: the LSTM predictor, the tanh additive joint,
the RNN-T loss by the alpha recursion over the (frame, label) lattice, the
CTC loss by its alpha recursion, and the hybrid training loss
0.7 * mean(RNN-T) + 0.3 * sum(CTC) / B with its dropout (Graves 2012;
ESPnet / WeNet's hybrid CTC-transducer loss)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.conformer import drop, encoder
from benchmark.reference.precision import Precision

NEG = -1e30


def predictor(P, tokens, prec: Precision):
    """[B, U+1] (blank first) -> [B, U+1, D]: embedding, one LSTM layer
    (gates i, f, g, o of x . Wx + b + h . Wh), a linear projection."""
    x = P["predictor.embed.weight"][tokens]
    xp = prec.linear(x, P["predictor.wx.0.weight"], P["predictor.wx.0.bias"])
    wh = P["predictor.wh.0"]
    b, u, _ = xp.shape
    h = torch.zeros(b, wh.shape[0], device=x.device)
    c = torch.zeros_like(h)
    outs = []
    for i in range(u):
        i_, f_, g_, o_ = (xp[:, i] + prec.matmul(h, wh)).chunk(4, dim=-1)
        c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
        h = torch.sigmoid(o_) * torch.tanh(c)
        outs.append(h)
    return prec.linear(torch.stack(outs, 1), P["predictor.projection.weight"],
                       P["predictor.projection.bias"])


def joint_logits(P, enc_p, pred_p, prec: Precision):
    """(enc_p [B, T, D], pred_p [B, U1, D]) pre-joined -> [B, T, U1, V]."""
    a = torch.tanh(enc_p[:, :, None] + pred_p[:, None])
    return prec.matmul(a, P["joint.ffn_out_kernel"]) + P["joint.ffn_out_bias"]


def project(P, enc, pred, prec: Precision):
    return (prec.linear(enc, P["joint.enc_ffn.weight"], P["joint.enc_ffn.bias"]),
            prec.linear(pred, P["joint.pred_ffn.weight"], P["joint.pred_ffn.bias"]))


def rnnt_nll(logits, labels, t_lens, u_lens, blank: int):
    """Per-utterance -log P(y | x): alpha[t, u] = logaddexp(alpha[t-1, u] +
    blank[t-1, u], alpha[t, u-1] + label[t, u-1]), the likelihood
    alpha[T-1, U] + blank[T-1, U]. A frame's column recursion is solved in
    closed form: alpha[t, u] = L[u] + logcumsumexp(c - L)[u], L the running
    sum of the frame's label log-probs and c the blank arrivals."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    b, t, u1, _ = lp.shape
    blank_lp = lp[..., blank]
    label_lp = lp[:, :, :u1 - 1].gather(
        3, labels.long()[:, None, :u1 - 1, None].expand(b, t, u1 - 1, 1))[..., 0]
    zero = torch.zeros(b, t, 1, device=lp.device)
    cum = torch.cat([zero, label_lp.cumsum(-1)], dim=-1)  # [B, T, U1]
    arrive = torch.full((b, u1), NEG, device=lp.device)
    arrive[:, 0] = 0.0
    alphas = []
    for i in range(t):
        a = cum[:, i] + torch.logcumsumexp(arrive - cum[:, i], dim=-1)
        alphas.append(a)
        arrive = a + blank_lp[:, i]
    alpha = torch.stack(alphas, 1)  # [B, T, U1]
    rows = torch.arange(b, device=lp.device)
    tl, ul = t_lens.long() - 1, u_lens.long()
    return -(alpha[rows, tl, ul] + blank_lp[rows, tl, ul])


def ctc_nll(logits, t_lens, labels, u_lens, blank: int):
    """Per-utterance CTC -log P(y | x) over the 2U+1 blank-interleaved states
    (a skip into a label state whose label differs from the one two back)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    b, t, _ = lp.shape
    u = labels.shape[1]
    s = 2 * u + 1
    lab = torch.full((b, s), blank, dtype=torch.long, device=lp.device)
    lab[:, 1::2] = labels.long()
    state = torch.arange(s, device=lp.device)[None]
    ls = lp.gather(2, lab[:, None].expand(b, t, s))
    ls = torch.where((state <= 2 * u_lens.long()[:, None])[:, None], ls, torch.full_like(ls, NEG))
    skip = (lab != blank) & (lab != F.pad(lab, (2, 0), value=blank)[:, :s]) & (state >= 2)
    neg = torch.full((b, s), NEG, device=lp.device)
    alpha = torch.where(state <= 1, ls[:, 0], neg)
    for i in range(1, t):
        a1 = F.pad(alpha, (1, 0), value=NEG)[:, :s]
        a2 = torch.where(skip, F.pad(alpha, (2, 0), value=NEG)[:, :s], neg)
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + ls[:, i]
        alpha = torch.where((i < t_lens)[:, None], new, alpha)
    ul = u_lens.long()[:, None]
    end = torch.logaddexp(alpha.gather(1, 2 * ul)[:, 0],
                          torch.where(ul[:, 0] > 0, alpha.gather(1, (2 * ul - 1).clamp(min=0))[:, 0],
                                      torch.full_like(ul[:, 0], NEG, dtype=torch.float32)))
    return -end


def train_loss(P, cfg: dict, feats, feat_lens, texts, text_lens, chunk: int, left: int,
               masks, prec: Precision, batch: int):
    """The hybrid loss of these rows, each term divided by the whole batch's
    `batch` rows, so that the rows' blocks sum to the step's loss; ->
    (loss, rnnt part, ctc part) summed over the rows."""
    m = cfg["model"]
    enc, enc_lens = encoder(P, m["encoder"], feats, feat_lens, chunk, left, prec, masks)
    blank = m["blank_id"]
    pred = predictor(P, F.pad(texts.long(), (1, 0), value=blank), prec)
    enc_p, pred_p = project(P, enc, pred, prec)
    rnnt = rnnt_nll(joint_logits(P, enc_p, pred_p, prec), texts, enc_lens, text_lens, blank)
    ctc_in = drop(enc, None if masks is None else masks["ctc"], m["ctc_dropout_rate"])
    ctc = ctc_nll(prec.linear(ctc_in, P["ctc.ctc_lo.weight"], P["ctc.ctc_lo.bias"]), enc_lens,
                  texts, text_lens, blank)
    rnnt, ctc = rnnt.sum() / batch, ctc.sum() / batch
    return m["transducer_weight"] * rnnt + m["ctc_weight"] * ctc, rnnt, ctc
