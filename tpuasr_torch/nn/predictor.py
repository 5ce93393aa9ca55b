"""LSTM predictor for RNN-T (port of ``tpuasr/nn/predictor.py:25-125``).

Embedding → LSTM → linear projection. The cell is written out, as in the
JAX package: `wx_l` is a Dense with bias ([E, 4H] there, [4H, E] here),
`wh_l` a bias-free [H, 4H] matrix, gates in the order i, f, g, o.
`forward_step` advances one token; a padding mask freezes the state of
finished streams (the ApplyPadding contract, wenet predictor.py:185-210).
Training: `forward` drops out the embeddings (`embed_dropout`) and the
outputs of every LSTM layer but the last (`dropout`), as
`tpuasr/nn/predictor.py:61-97` does, when given a dropout generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuasr_torch.config import PredictorConfig
from tpuasr_torch.nn.layers import Dense, dropout


def _lstm_step(h, c, x_proj, wh):
    """One cell step. x_proj [B, 4H] (input projection + bias); wh [H, 4H]."""
    gates = x_proj + h @ wh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


class RNNPredictor(nn.Module):
    # decode-state convention: the batch axis of each state leaf
    state_batch_axis = 1  # ([L, B, H], [L, B, H])

    def __init__(self, cfg: PredictorConfig, vocab_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if cfg.predictor_type != "rnn":
            raise NotImplementedError(f"predictor_type {cfg.predictor_type!r} "
                                      "(ROADMAP: modules after the main path)")
        self.cfg, self.dtype = cfg, dtype
        h = cfg.hidden_size
        self.embed = nn.Embedding(vocab_size, cfg.embed_size, device=device)
        self.wx = nn.ModuleList(
            Dense(cfg.embed_size if l == 0 else h, 4 * h, device=device)
            for l in range(cfg.num_layers))
        self.wh = nn.ParameterList(
            nn.Parameter(torch.zeros(h, 4 * h, device=device)) for _ in range(cfg.num_layers))
        self.projection = Dense(h, cfg.output_size, device=device)

    def init_state(self, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        shape = (c.num_layers, batch, c.hidden_size)
        dev = self.embed.weight.device
        return (torch.zeros(shape, dtype=self.dtype, device=dev),
                torch.zeros(shape, dtype=self.dtype, device=dev))

    def forward(self, tokens: torch.Tensor, state: Optional[tuple] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, U] (blank-prepended labels) -> [B, U, output_size]; gen: the
        dropout generator, None for no dropout."""
        b, u = tokens.shape
        x = dropout(self.embed(tokens).to(self.dtype), self.cfg.embed_dropout, gen)
        hs, cs = self.init_state(b) if state is None else state
        for l in range(self.cfg.num_layers):
            x_proj = self.wx[l](x)  # [B, U, 4H]
            wh = self.wh[l].to(x_proj.dtype)
            h, c = hs[l], cs[l]
            outs = []
            for i in range(u):
                h, c = _lstm_step(h, c, x_proj[:, i], wh)
                outs.append(h)
            x = torch.stack(outs, dim=1)
            if l < self.cfg.num_layers - 1:
                x = dropout(x, self.cfg.dropout, gen)
        return self.projection(x)

    def forward_step(self, tokens: torch.Tensor, state: tuple[torch.Tensor, torch.Tensor],
                     padding: Optional[torch.Tensor] = None):
        """One decode step: tokens [B] -> ([B, output_size], new state).
        Rows where `padding` is true keep their previous state."""
        x = self.embed(tokens).to(self.dtype)
        hs, cs = state
        new_h, new_c = [], []
        for l in range(self.cfg.num_layers):
            x_proj = self.wx[l](x)
            h, c = _lstm_step(hs[l], cs[l], x_proj, self.wh[l].to(x_proj.dtype))
            if padding is not None:
                keep = padding.to(torch.bool)[:, None]
                h = torch.where(keep, hs[l], h)
                c = torch.where(keep, cs[l], c)
            new_h.append(h)
            new_c.append(c)
            x = h
        return self.projection(x), (torch.stack(new_h), torch.stack(new_c))
