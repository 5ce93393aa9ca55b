"""Plain hybrid CTC / attention model in float32 (WeNet's U2++: a conformer
encoder, a CTC head, a left-to-right and a right-to-left transformer
decoder over the <sos> / <eos>-wrapped targets, label smoothing): the loss
ctc_weight * sum(CTC) / B + (1 - ctc_weight) * ((1 - reverse_weight) *
KL(l2r) + reverse_weight * KL(r2l)), each KL summed over the valid target
positions and divided by B.

The decoder layer: pre-norm self-attention (causal and padding mask),
cross-attention over the encoder output (its padding mask), a ReLU FFN,
dropout on each residual branch and inside the FFN; the embedding scaled by
sqrt(D) plus a sinusoid table, dropped out; a final LayerNorm and the
output linear.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.conformer import drop, encoder, ln, sinusoid
from benchmark.reference.precision import Precision
from benchmark.reference.transducer import ctc_nll


def _attend(P, pre, x_q, x_kv, mask, heads, prec):
    b, tq, d = x_q.shape
    dk = d // heads
    q = prec.linear(x_q, P[pre + ".linear_q.weight"], P[pre + ".linear_q.bias"])
    k = prec.linear(x_kv, P[pre + ".linear_k.weight"], P[pre + ".linear_k.bias"])
    v = prec.linear(x_kv, P[pre + ".linear_v.weight"], P[pre + ".linear_v.bias"])
    s = prec.einsum("bthd,bshd->bhts", q.view(b, tq, heads, dk),
                    k.view(b, -1, heads, dk)) / math.sqrt(dk)
    m = mask[:, None]
    a = torch.softmax(s.masked_fill(~m, -1e9), dim=-1).masked_fill(~m, 0.0)
    out = prec.einsum("bhts,bshd->bthd", a, v.view(b, -1, heads, dk)).reshape(b, tq, d)
    return prec.linear(out, P[pre + ".linear_out.weight"], P[pre + ".linear_out.bias"])


def decoder(P, pre: str, blocks: int, heads: int, rate: float, memory, mem_lens, ys_in,
            ys_lens, masks, prec: Precision):
    """Teacher-forced logits [B, L, V]; `masks`: this decoder's keep-masks
    (embedding, then per layer self, src, ffn inner, ffn residual) or None."""
    b, l = ys_in.shape
    d = memory.shape[-1]
    it = iter(masks) if masks is not None else None
    nxt = (lambda: None) if it is None else (lambda: next(it))
    x = P[pre + ".embed.weight"][ys_in] * math.sqrt(d) + sinusoid(l, d, memory.device)
    x = drop(x, nxt(), rate)
    pos = torch.arange(l, device=memory.device)
    valid = pos[None, :] < ys_lens[:, None]
    self_mask = valid[:, None, :] & (pos[None, :] <= pos[:, None])[None]
    mem_mask = (torch.arange(memory.shape[1], device=memory.device)[None, :]
                < mem_lens[:, None])[:, None, :]
    for i in range(blocks):
        q = f"{pre}.layers.{i}"
        y = ln(P, q + ".norm1", x)
        x = x + drop(_attend(P, q + ".self_attn", y, y, self_mask, heads, prec), nxt(), rate)
        x = x + drop(_attend(P, q + ".src_attn", ln(P, q + ".norm2", x), memory, mem_mask,
                             heads, prec), nxt(), rate)
        h = F.relu(prec.linear(ln(P, q + ".norm3", x), P[q + ".ffn1.weight"], P[q + ".ffn1.bias"]))
        h = prec.linear(drop(h, nxt(), rate), P[q + ".ffn2.weight"], P[q + ".ffn2.bias"])
        x = x + drop(h, nxt(), rate)
    return prec.linear(ln(P, pre + ".after_norm", x), P[pre + ".output_layer.weight"],
                       P[pre + ".output_layer.bias"])


def smoothed_kl(logits, targets, lens, smoothing: float):
    """Per-row KL to the label-smoothed targets, summed over the valid
    positions."""
    v = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1)
    conf, low = 1.0 - smoothing, smoothing / (v - 1)
    true_lp = lp.gather(2, targets[..., None])[..., 0]
    entropy = -(conf * np.log(conf) + (v - 1) * low * np.log(low))
    kl = -(conf * true_lp + low * (lp.sum(-1) - true_lp)) - entropy
    valid = torch.arange(targets.shape[1], device=lp.device)[None, :] < lens[:, None]
    return torch.where(valid, kl, 0.0).sum(1)


def wrap(texts, lens, sos: int, eos: int):
    """[B, U] -> (<sos> y, y <eos>), each [B, U+1]."""
    ys_in = F.pad(texts, (1, 0), value=sos)
    ys_out = F.pad(texts, (0, 1), value=0)
    eos_at = torch.arange(texts.shape[1] + 1, device=texts.device)[None, :] == lens[:, None]
    return ys_in, torch.where(eos_at, eos, ys_out)


def reverse(texts, lens):
    """Each row's valid prefix reversed, the padding in place."""
    i = torch.arange(texts.shape[1], device=texts.device)[None, :]
    n = lens.long()[:, None]
    return texts.gather(1, torch.where(i < n, n - 1 - i, i))


def train_loss(P, cfg: dict, feats, feat_lens, texts, text_lens, chunk: int, left: int,
               masks, prec: Precision, batch: int):
    """The rows' hybrid loss, each term over the whole batch's `batch` rows
    -> (loss, ctc part, attention part)."""
    m = cfg["model"]
    e, dcfg = m["encoder"], m["att_decoder"]
    enc, enc_lens = encoder(P, e, feats, feat_lens, chunk, left, prec, masks)
    texts = texts.long()
    ctc = ctc_nll(prec.linear(enc, P["ctc_lo.weight"], P["ctc_lo.bias"]), enc_lens, texts,
                  text_lens, m["blank_id"]).sum() / batch
    ys_lens = text_lens.long() + 1
    sos, eos, rate = m["sos_id"], m["eos_id"], e["dropout_rate"]
    dm = (lambda k: None) if masks is None else (lambda k: masks[k])
    ys_in, ys_out = wrap(texts, text_lens.long(), sos, eos)
    logits = decoder(P, "decoder", dcfg["blocks"], dcfg["heads"], rate, enc, enc_lens, ys_in,
                     ys_lens, dm("decoder"), prec)
    att = smoothed_kl(logits, ys_out, ys_lens, dcfg["lsm_weight"]).sum() / batch
    rw = dcfg["reverse_weight"]
    if dcfg["r_blocks"] > 0 and rw > 0:
        r_in, r_out = wrap(reverse(texts, text_lens), text_lens.long(), sos, eos)
        r_logits = decoder(P, "r_decoder", dcfg["r_blocks"], dcfg["heads"], rate, enc,
                           enc_lens, r_in, ys_lens, dm("r_decoder"), prec)
        r_att = smoothed_kl(r_logits, r_out, ys_lens, dcfg["lsm_weight"]).sum() / batch
        att = (1.0 - rw) * att + rw * r_att
    w = m["ctc_weight"]
    return w * ctc + (1.0 - w) * att, ctc, att
