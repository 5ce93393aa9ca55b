"""RNN-T additive joint (port of ``tpuasr/nn/joint.py:24-108``): optional
pre-join linears on the encoder and predictor outputs, add, an optional
post-join linear, the activation (tanh, relu or flax's tanh-approximate
gelu), the output head.

The plain head keeps the JAX package's raw parameters ``ffn_out_kernel
[D, V]`` and ``ffn_out_bias [V]``, which the fused joint loss (kernels
#4/#5) and the pruned loss read through `head_params`. With `hat_joint` the
head is the HAT factorization (wenet/transducer/joint.py:51-106): a
log-sigmoid blank head on tanh of the sum, and a token head over the V-1
other classes, log-softmaxed and shifted by log(max(1 - p_blank, 1e-6)),
the blank column inserted at `blank_id`. Its output is already a
normalized log-distribution (a log-softmax over it changes nothing but
rounding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.config import JointConfig
from tpuasr_torch.nn.layers import Dense, gelu

ACT = {"tanh": torch.tanh, "relu": torch.relu, "gelu": gelu}


class TransducerJoint(nn.Module):
    def __init__(self, cfg: JointConfig, enc_dim: int, pred_dim: int, vocab_size: int,
                 blank_id: int = 0, device=None):
        super().__init__()
        if cfg.joint_mode != "add":
            raise NotImplementedError(f"joint_mode {cfg.joint_mode!r}: the JAX joint reads "
                                      "the field nowhere and always adds")
        if cfg.activation not in ACT:
            raise ValueError(f"joint activation {cfg.activation!r} not in {sorted(ACT)}")
        self.cfg, self.blank_id = cfg, blank_id
        d = cfg.join_dim
        if cfg.prejoin_linear:
            self.enc_ffn = Dense(enc_dim, d, device=device)
            self.pred_ffn = Dense(pred_dim, d, device=device)
        if cfg.postjoin_linear:
            self.post_ffn = Dense(d, d, device=device)
        if cfg.hat_joint:
            self.blank_pred = Dense(d, 1, device=device)
            self.token_pred = Dense(d, vocab_size - 1, device=device)
        else:
            self.ffn_out_kernel = nn.Parameter(torch.zeros(d, vocab_size, device=device))
            self.ffn_out_bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    @property
    def plain_head(self) -> bool:
        """True when the head is the bare tanh . W + b that the fused and the
        pruned losses compute themselves (tpuasr/models/transducer.py:237,
        :260: neither HAT nor a post-join linear)."""
        return not (self.cfg.hat_joint or self.cfg.postjoin_linear)

    def head_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(kernel [D, V], bias [V]) of the plain output projection."""
        if self.cfg.hat_joint:
            raise ValueError("a HAT joint has no single output projection")
        return self.ffn_out_kernel, self.ffn_out_bias

    def project_enc(self, enc_out: torch.Tensor) -> torch.Tensor:
        return self.enc_ffn(enc_out) if self.cfg.prejoin_linear else enc_out

    def project_pred(self, pred_out: torch.Tensor) -> torch.Tensor:
        return self.pred_ffn(pred_out) if self.cfg.prejoin_linear else pred_out

    def head_from_projected(self, joined: torch.Tensor) -> torch.Tensor:
        """[..., D] pre-activation sum -> [..., V] logits (HAT: log-probs,
        fp32)."""
        c = self.cfg
        if c.postjoin_linear:
            joined = self.post_ffn(joined)
        act = ACT[c.activation](joined)
        if not c.hat_joint:
            dt = act.dtype
            return act @ self.ffn_out_kernel.to(dt) + self.ffn_out_bias.to(dt)
        blank_lp = F.logsigmoid(self.blank_pred(torch.tanh(joined)).float())  # [..., 1]
        scale = torch.log(torch.clamp(1.0 - torch.exp(blank_lp), min=1e-6))
        label_lp = torch.log_softmax(self.token_pred(act).float(), dim=-1) + scale
        i = self.blank_id
        return torch.cat([label_lp[..., :i], blank_lp, label_lp[..., i:]], dim=-1)

    def forward(self, enc_out: torch.Tensor, pred_out: torch.Tensor) -> torch.Tensor:
        """([B, T, E], [B, U, P]) -> [B, T, U, V] logits."""
        joined = self.project_enc(enc_out)[:, :, None] + self.project_pred(pred_out)[:, None]
        return self.head_from_projected(joined)

    def step(self, enc_t: torch.Tensor, pred_u: torch.Tensor) -> torch.Tensor:
        """([B, E], [B, P]) -> [B, V] logits for one (frame, token) pair."""
        return self.head_from_projected(self.project_enc(enc_t) + self.project_pred(pred_u))
