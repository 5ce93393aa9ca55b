"""RNN-T additive joint (port of ``tpuasr/nn/joint.py:24-108``, the tanh
variant): pre-join linears on encoder and predictor outputs, add, tanh,
output head. The head keeps the JAX package's raw parameters
``ffn_out_kernel [D, V]`` and ``ffn_out_bias [V]``."""

from __future__ import annotations

import torch
from torch import nn

from tpuasr_torch.config import JointConfig
from tpuasr_torch.nn.layers import Dense


class TransducerJoint(nn.Module):
    def __init__(self, cfg: JointConfig, enc_dim: int, pred_dim: int, vocab_size: int,
                 device=None):
        super().__init__()
        if cfg.hat_joint or cfg.postjoin_linear or not cfg.prejoin_linear:
            raise NotImplementedError("HAT / postjoin joints (ROADMAP: modules after "
                                      "the main path)")
        if cfg.joint_mode != "add" or cfg.activation != "tanh":
            raise NotImplementedError("only the additive tanh joint is ported")
        self.cfg = cfg
        self.enc_ffn = Dense(enc_dim, cfg.join_dim, device=device)
        self.pred_ffn = Dense(pred_dim, cfg.join_dim, device=device)
        self.ffn_out_kernel = nn.Parameter(torch.zeros(cfg.join_dim, vocab_size, device=device))
        self.ffn_out_bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def project_enc(self, enc_out: torch.Tensor) -> torch.Tensor:
        return self.enc_ffn(enc_out)

    def project_pred(self, pred_out: torch.Tensor) -> torch.Tensor:
        return self.pred_ffn(pred_out)

    def head_from_projected(self, joined: torch.Tensor) -> torch.Tensor:
        """[..., D] pre-activation sum -> [..., V] logits."""
        act = torch.tanh(joined)
        dt = act.dtype
        return act @ self.ffn_out_kernel.to(dt) + self.ffn_out_bias.to(dt)

    def forward(self, enc_out: torch.Tensor, pred_out: torch.Tensor) -> torch.Tensor:
        """([B, T, E], [B, U, P]) -> [B, T, U, V] logits."""
        joined = self.project_enc(enc_out)[:, :, None] + self.project_pred(pred_out)[:, None]
        return self.head_from_projected(joined)

    def step(self, enc_t: torch.Tensor, pred_u: torch.Tensor) -> torch.Tensor:
        """([B, E], [B, P]) -> [B, V] logits for one (frame, token) pair."""
        return self.head_from_projected(self.project_enc(enc_t) + self.project_pred(pred_u))
