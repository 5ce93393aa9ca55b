"""CIF, the continuous integrate-and-fire aligner, and the timestamp branch
(port of ``tpuasr/nn/cif.py``).

With frame weights alpha_t <= 1, the cumsum c = cumsum(alpha) gives each
frame to at most two adjacent tokens, floor(c_{t-1}) and floor(c_{t-1}) + 1,
split at the integer boundary. The JAX package adds the two shares by two
scatter-adds; here they form a weight matrix [B, K+1, T] (row k: each
frame's share of token k, row K the overflow) and one batched product gives
the embeddings, in fp32 whatever the compute type. The product sums in one
fixed order, so two identical forwards on the card give the same bits
(scatter-adds on CUDA take atomics in any order). Peaks are floor-crossings
of the cumsum. These floors (the peaks, the inference count floor(sum a))
are not continuous: where a sum lies within rounding of an integer, another
order of summation (the card's cumsum against XLA's) can move them by one,
while the embeddings, whose shares change continuously across a boundary,
agree to rounding.

Clamps at zero are `torch.maximum`, as `jnp.clip` is (a tie splits the
gradient), so gradients match the JAX package's also where a share is
exactly zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.nn.layers import Dense, dropout


def cif_weights(alpha: torch.Tensor, max_tokens: int, threshold: float = 1.0) -> torch.Tensor:
    """alpha [B, T] (length-masked weights in [0, 1]) -> [B, K+1, T] fp32:
    row k holds each frame's share of token k, row K (= max_tokens) the
    overflow past the last token. A frame starts in token floor(c_{t-1})
    (c = cumsum(alpha / threshold)) and gives the rest of its weight past
    the next integer to the next token."""
    c = torch.cumsum(alpha.float() / threshold, dim=1)
    c_prev = F.pad(c, (1, 0))[:, : alpha.shape[1]]
    k_lo = torch.floor(c_prev).long()
    boundary = (k_lo + 1).to(c.dtype)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    w_lo = torch.maximum(torch.minimum(c, boundary) - c_prev, zero)
    w_hi = torch.maximum(c - boundary, zero)
    slots = torch.arange(max_tokens + 1, device=alpha.device)[None, :, None]
    lo = k_lo.clamp(max=max_tokens)[:, None, :]
    hi = (k_lo + 1).clamp(max=max_tokens)[:, None, :]
    return (torch.where(slots == lo, w_lo[:, None, :], 0.0)
            + torch.where(slots == hi, w_hi[:, None, :], 0.0))


def cif_fire(hidden: torch.Tensor, alpha: torch.Tensor, max_tokens: int,
             threshold: float = 1.0) -> torch.Tensor:
    """hidden [B, T, D] (encoder frames), alpha [B, T] -> acoustic
    embeddings [B, max_tokens, D] in hidden's type: token k = sum_t
    w(t, k) · hidden[t]."""
    w = cif_weights(alpha, max_tokens, threshold)
    return torch.bmm(w, hidden.float())[:, :max_tokens].to(hidden.dtype)


def cif_peaks(alpha: torch.Tensor, threshold: float = 1.0) -> torch.Tensor:
    """Fire positions [B, T], 1.0 where cumsum(alpha)/threshold crosses an
    integer (the reference's integrate / fire / subtract loop while alpha <=
    threshold)."""
    c = torch.cumsum(alpha / threshold, dim=1)
    c_prev = F.pad(c, (1, 0))[:, : alpha.shape[1]]
    return (torch.floor(c) > torch.floor(c_prev)).to(alpha.dtype)


def quantity_loss(pred_count: torch.Tensor, target_lens: torch.Tensor) -> torch.Tensor:
    """Token-count L1 loss, summed and divided by the total target count
    (wenet/paraformer/paraformer.py:188-196)."""
    tgt = target_lens.float()
    return (pred_count - tgt).abs().sum() / tgt.sum().clamp(min=1.0)


class CifPredictor(nn.Module):
    """The weight head and the fire (wenet/paraformer/cif.py:24-146):
    depthwise conv -> + residual -> dropout -> relu -> linear -> sigmoid ->
    relu(a · smooth_factor - noise_threshold) -> mask. Training rescales
    the weights so that exactly the target counts fire; inference appends a
    zero frame with `tail_threshold` of weight at each row's end, so the
    trailing partial integral fires, and counts floor(sum). The head
    computes in fp32 whatever the encoder's type (the flax module has no
    dtype, so its products promote to its fp32 parameters)."""

    def __init__(self, idim: int, l_order: int = 1, r_order: int = 1, threshold: float = 1.0,
                 dropout_rate: float = 0.1, smooth_factor: float = 1.0,
                 noise_threshold: float = 0.0, tail_threshold: float = 0.45,
                 residual: bool = True, cnn_groups: int = 0, device=None):
        super().__init__()
        self.l_order, self.r_order, self.threshold = l_order, r_order, threshold
        self.dropout_rate, self.smooth_factor = dropout_rate, smooth_factor
        self.noise_threshold, self.tail_threshold = noise_threshold, tail_threshold
        self.residual = residual
        groups = idim if cnn_groups == 0 else cnn_groups
        self.cif_conv = nn.Conv1d(idim, idim, l_order + r_order + 1, groups=groups,
                                  device=device)
        self.cif_output = Dense(idim, 1, device=device)

    def alpha(self, hidden: torch.Tensor, mask: torch.Tensor, gen=None) -> torch.Tensor:
        """[B, T, D], [B, T] True = valid -> frame weights [B, T] >= 0, fp32."""
        h = hidden.float()
        y = F.conv1d(F.pad(h.transpose(1, 2), (self.l_order, self.r_order)),
                     self.cif_conv.weight, self.cif_conv.bias,
                     groups=self.cif_conv.groups).transpose(1, 2)
        if self.residual:
            y = y + h
        y = torch.relu(dropout(y, self.dropout_rate, gen))
        a = torch.sigmoid(self.cif_output(y)[..., 0])
        a = torch.relu(a * self.smooth_factor - self.noise_threshold)
        return torch.where(mask, a, 0.0)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor, max_tokens: int,
                target_lens: torch.Tensor | None = None, gen=None):
        """-> (embeds [B, max_tokens, D] in hidden's type, count [B] fp32,
        the fired weights [B, T], or [B, T+1] with the tail frame)."""
        a = self.alpha(hidden, mask, gen)
        count = a.sum(dim=1)
        fire_hidden = hidden
        if target_lens is not None:
            a_fire = a * (target_lens.float() / count.clamp(min=1e-6))[:, None]
        elif self.tail_threshold > 0.0:
            b, _, d = hidden.shape
            m = mask.to(a.dtype)
            one = torch.ones((b, 1), dtype=a.dtype, device=a.device)
            tail = torch.cat([one, m], 1) - torch.cat([m, 0 * one], 1)
            a_fire = torch.cat([a, 0 * one], 1) + tail * self.tail_threshold
            fire_hidden = torch.cat([hidden, hidden.new_zeros((b, 1, d))], 1)
            count = torch.floor(a_fire.sum(dim=1))
        else:
            a_fire = a
        return cif_fire(fire_hidden, a_fire, max_tokens, self.threshold), count, a_fire


class TimestampPredictor(nn.Module):
    """The timestamp branch (wenet/paraformer/paraformer.py:59-103): x3
    transposed-conv upsampling -> a BLSTM -> a sigmoid weight head ->
    tp_alphas. In fp32 (the flax module has no dtype). The transposed conv
    is torch's, whose taps run in the opposite order to flax's
    `ConvTranspose` (`transpose_kernel=False`): the converter flips the
    kernel. The BLSTM is a loop over the upsampled frames, both directions
    at once: per direction an input projection with a bias (`{d}_wx`) and a
    bias-free recurrent matrix (`{d}_wh`, [H, 4H], the JAX layout), gates
    i, f, g, o."""

    def __init__(self, idim: int, upsample_times: int = 3, smooth_factor2: float = 0.25,
                 noise_threshold2: float = 0.01, device=None):
        super().__init__()
        self.idim, self.upsample_times = idim, upsample_times
        self.smooth_factor2, self.noise_threshold2 = smooth_factor2, noise_threshold2
        # weight [in, out, K]
        self.tp_upsample_cnn = nn.ConvTranspose1d(idim, idim, upsample_times,
                                                  stride=upsample_times, device=device)
        self.fwd_wx = Dense(idim, 4 * idim, device=device)
        self.fwd_wh = nn.Parameter(torch.empty(idim, 4 * idim, device=device))
        self.bwd_wx = Dense(idim, 4 * idim, device=device)
        self.bwd_wh = nn.Parameter(torch.empty(idim, 4 * idim, device=device))
        self.tp_output = Dense(2 * idim, 1, device=device)

    def _blstm(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H] -> [B, T, 2H]: the forward pass and the reversed one."""
        xp = torch.stack([self.fwd_wx(x), self.bwd_wx(x.flip(1))])  # [2, B, T, 4H]
        wh = torch.stack([self.fwd_wh, self.bwd_wh])  # [2, H, 4H]
        hs = x.new_zeros((2, x.shape[0], self.idim))
        cs = torch.zeros_like(hs)
        outs = []
        for i in range(x.shape[1]):
            gates = xp[:, :, i] + torch.bmm(hs, wh)
            ig, fg, g, og = gates.chunk(4, dim=-1)
            cs = torch.sigmoid(fg) * cs + torch.sigmoid(ig) * torch.tanh(g)
            hs = torch.sigmoid(og) * torch.tanh(cs)
            outs.append(hs)
        out = torch.stack(outs, dim=2)  # [2, B, T, H]
        return torch.cat([out[0], out[1].flip(1)], dim=-1)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, T, D], [B, T] -> tp_alphas [B, T · upsample_times] fp32."""
        up = self.tp_upsample_cnn(hidden.float().transpose(1, 2)).transpose(1, 2)
        a = torch.sigmoid(self.tp_output(self._blstm(up))[..., 0])
        a = torch.relu(a * self.smooth_factor2 - self.noise_threshold2)
        return torch.where(mask.repeat_interleave(self.upsample_times, dim=1), a, 0.0)
