"""Plain conformer encoder in float32: Conv2dSubsampling4, the scaled
embedding with a sinusoid table, and blocks of macaron FFN, rel-pos
self-attention, causal conv module and FFN, each a pre-norm residual, a
final LayerNorm per block and after the stack (WeNet's conformer with the
Transformer-XL u / v biases and no rel-shift: the positional term is
(q + v) . linear_pos(PE) over the keys' absolute positions).

Parameters come as one dict keyed by the names the benchmark gives the
weights (``encoder.blocks.3.self_attn.linear_q.weight``). `masks` holds the
step's dropout keep-masks (`draws.conformer_masks`'s block), already
cut to the rows computed; None means no dropout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

EPS = 1e-6


def ln(P, pre, x):
    return F.layer_norm(x, (x.shape[-1],), P[pre + ".weight"], P[pre + ".bias"], EPS)


def swish(x):
    return x * torch.sigmoid(x)


def drop(x, keep, rate):
    return x if keep is None else torch.where(keep.view(x.shape), x / (1.0 - rate),
                                              torch.zeros_like(x))


def sinusoid(t: int, d: int, device) -> torch.Tensor:
    pos = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((t, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def subsample(P, x, prec: Precision):
    """[B, T, F] -> [B, ((T - 1) // 2 - 1) // 2, D]: two 3x3 stride-2 convs
    with ReLU over [B, 1, T, F], then a linear over (F', C) flattened with C
    fastest."""
    e = "encoder.embed."
    y = F.relu(prec.conv2d(x[:, None], P[e + "conv1.weight"], P[e + "conv1.bias"], 2))
    y = F.relu(prec.conv2d(y, P[e + "conv2.weight"], P[e + "conv2.bias"], 2))
    b, c, t, f = y.shape
    return prec.linear(y.permute(0, 2, 3, 1).reshape(b, t, f * c), P[e + "out.weight"],
                       P[e + "out.bias"])


def subsampled_len(t):
    return ((t - 1) // 2 - 1) // 2


def ffn_branch(P, pre, norm, x, k1, k2, rate, scale, prec):
    h = ln(P, norm, x)
    h = swish(prec.linear(h, P[pre + ".w_1.weight"], P[pre + ".w_1.bias"]))
    h = drop(h, k1, rate)
    h = prec.linear(h, P[pre + ".w_2.weight"], P[pre + ".w_2.bias"])
    return x + scale * drop(h, k2, rate)


def attention(P, pre, x, mask, pe, heads, prec, keep=None, rate=0.0):
    """x [B, T, D], mask [B, T, T] (True = attend), pe [T, D] -> [B, T, D];
    `keep` [B, H, T, T] drops the probabilities out at `rate`."""
    b, t, d = x.shape
    dk = d // heads
    q = prec.linear(x, P[pre + ".linear_q.weight"], P[pre + ".linear_q.bias"])
    k = prec.linear(x, P[pre + ".linear_k.weight"], P[pre + ".linear_k.bias"])
    v = prec.linear(x, P[pre + ".linear_v.weight"], P[pre + ".linear_v.bias"])
    p = prec.linear(pe, P[pre + ".linear_pos.weight"])
    qu = (q + P[pre + ".pos_bias_u"].reshape(-1)).view(b, t, heads, dk)
    qv = (q + P[pre + ".pos_bias_v"].reshape(-1)).view(b, t, heads, dk)
    s = (prec.einsum("bthd,bshd->bhts", qu, k.view(b, t, heads, dk))
         + prec.einsum("bthd,shd->bhts", qv, p.view(t, heads, dk))) / math.sqrt(dk)
    m = mask[:, None]
    a = drop(torch.softmax(s.masked_fill(~m, -1e9), dim=-1).masked_fill(~m, 0.0), keep, rate)
    out = prec.einsum("bhts,bshd->bthd", a, v.view(b, t, heads, dk)).reshape(b, t, d)
    return prec.linear(out, P[pre + ".linear_out.weight"], P[pre + ".linear_out.bias"])


def conv_module(P, pre, x, pad, kernel, prec):
    """Pointwise to 2D, GLU, causal depthwise conv (kernel - 1 zeros on the
    left), LayerNorm, swish, pointwise back; padded frames zeroed before and
    after. pad: [B, T, 1] True = valid, or None."""
    d = x.shape[-1]
    if pad is not None:
        x = x * pad
    y = prec.linear(x, P[pre + ".pointwise_conv1.weight"], P[pre + ".pointwise_conv1.bias"])
    y = y[..., :d] * torch.sigmoid(y[..., d:])
    y = F.pad(y.transpose(1, 2), (kernel - 1, 0))
    y = prec.conv1d(y, P[pre + ".depthwise_conv.weight"], P[pre + ".depthwise_conv.bias"],
                    d).transpose(1, 2)
    y = swish(ln(P, pre + ".norm", y))
    y = prec.linear(y, P[pre + ".pointwise_conv2.weight"], P[pre + ".pointwise_conv2.bias"])
    return y if pad is None else y * pad


def block(P, i, x, mask, pad, pe, cfg, masks, prec):
    pre = f"encoder.blocks.{i}"
    r, heads, k = cfg["dropout_rate"], cfg["attention_heads"], cfg["cnn_module_kernel"]
    mk = (lambda key: None) if masks is None else (lambda key: masks.get(key))
    x = ffn_branch(P, pre + ".feed_forward_macaron", pre + ".norm_ff_macaron", x,
                   mk("mac1"), mk("mac2"), r, 0.5, prec)
    x = x + drop(attention(P, pre + ".self_attn", ln(P, pre + ".norm_mha", x), mask, pe,
                           heads, prec, mk("attp"), cfg.get("attention_dropout_rate", 0.0)),
                 mk("att"), r)
    x = x + drop(conv_module(P, pre + ".conv_module", ln(P, pre + ".norm_conv", x), pad, k,
                             prec), mk("conv"), r)
    x = ffn_branch(P, pre + ".feed_forward", pre + ".norm_ff", x, mk("ff1"), mk("ff2"), r, 0.5,
                   prec)
    return ln(P, pre + ".norm_final", x)


def encoder(P, cfg: dict, feats, feat_lens, chunk: int, left: int, prec: Precision,
            masks=None, pad_masked: bool = True):
    """feats [B, T, F] -> (enc [B, T', D], enc_lens [B]). The attention mask
    is the chunk mask (`chunk` frames a chunk, `left` chunks back, -1 all)
    and, with `pad_masked`, the keys' padding; the conv module zeroes padded
    frames with it too. `masks`: the step's keep-masks for these rows."""
    from benchmark.reference.draws import chunk_mask

    x = subsample(P, feats, prec)
    b, t, d = x.shape
    lens = subsampled_len(feat_lens.long())
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]  # [B, T]
    x = drop(x * math.sqrt(d), None if masks is None else masks["pos"], cfg["dropout_rate"])
    cm = chunk_mask(t, chunk, left, x.device)[None]
    mask = (cm & valid[:, None, :]) if pad_masked else cm.expand(b, t, t)
    pad = valid[..., None].to(x.dtype) if pad_masked else None
    pe = sinusoid(t, d, x.device)
    for i in range(cfg["num_blocks"]):
        x = block(P, i, x, mask, pad, pe, cfg, None if masks is None else masks["blocks"][i],
                  prec)
    return ln(P, "encoder.after_norm", x), lens
