"""RNN-T predictors (port of ``tpuasr/nn/predictor.py``): the LSTM and the
stateless embedding and causal-conv predictors.

The LSTM (``tpuasr/nn/predictor.py:25-125``):
Embedding → LSTM → linear projection. The cell is written out, as in the
JAX package: `wx_l` is a Dense with bias ([E, 4H] there, [4H, E] here),
`wh_l` a bias-free [H, 4H] matrix, gates in the order i, f, g, o.
`forward_step` advances one token; a padding mask freezes the state of
finished streams (the ApplyPadding contract, wenet predictor.py:185-210).
Training: `forward` drops out the embeddings (`embed_dropout`) and the
outputs of every LSTM layer but the last (`dropout`), as
`tpuasr/nn/predictor.py:61-97` does, when given a dropout generator.

The stateless predictors (``tpuasr/nn/predictor.py:126-242``) see the last
`history_size + 1` token embeddings; their state is the trailing
`history_size` embeddings ([B, history, E],), batch at axis 0, so the
decoders' state helpers (`tpuasr_torch.decode.state_utils`) take them
through `state_batch_axis` as they take the LSTM's (h, c).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.config import PredictorConfig
from tpuasr_torch.nn.layers import Dense, LayerNorm, dropout


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


class _StatelessPredictor(nn.Module):
    """What the embedding and conv predictors share: the embedding, the
    history state, the window of `history_size + 1` embeddings and the
    padding keep of `forward_step`."""

    state_batch_axis = 0  # ([B, history, E],)

    def __init__(self, cfg: PredictorConfig, vocab_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if cfg.output_size != cfg.embed_size:
            raise ValueError(f"{cfg.predictor_type} predictor: output_size "
                             f"{cfg.output_size} != embed_size {cfg.embed_size}")
        self.cfg, self.dtype = cfg, dtype
        self.context_size = cfg.history_size + 1
        self.embed = nn.Embedding(vocab_size, cfg.embed_size, device=device)
        self.norm = LayerNorm(cfg.embed_size, device=device)

    def init_state(self, batch: int) -> tuple[torch.Tensor]:
        c = self.cfg
        return (torch.zeros((batch, c.history_size, c.embed_size), dtype=self.dtype,
                            device=self.embed.weight.device),)

    def _act(self, y):
        """swish, or relu for any other `activation` (the JAX package's rule)."""
        return y * torch.sigmoid(y) if self.cfg.activation == "swish" else torch.relu(y)

    def forward(self, tokens: torch.Tensor, state: Optional[tuple] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, U] (blank-prepended labels) -> [B, U, E], each position from
        the window of its own and the `history_size` embeddings before it
        (zeros, or `state`, before the first)."""
        b, _ = tokens.shape
        x = dropout(self.embed(tokens).to(self.dtype), self.cfg.embed_dropout, gen)
        hist = (self.init_state(b) if state is None else state)[0]
        return self._windows(torch.cat([hist.to(x.dtype), x], dim=1))

    def forward_step(self, tokens: torch.Tensor, state: tuple[torch.Tensor],
                     padding: Optional[torch.Tensor] = None):
        """One decode step: tokens [B] -> ([B, E], new state). Rows where
        `padding` is true keep their previous history."""
        x = self.embed(tokens).to(self.dtype)[:, None]
        ctx = torch.cat([state[0].to(x.dtype), x], dim=1)  # [B, ctx, E]
        out = self._windows(ctx)[:, 0]
        new_hist = ctx[:, 1:]
        if padding is not None:
            new_hist = torch.where(padding.to(torch.bool)[:, None, None], state[0], new_hist)
        return out, (new_hist,)


class EmbeddingPredictor(_StatelessPredictor):
    """Stateless N-gram predictor (arXiv:2109.07513; tpuasr/nn/predictor.py:
    126-189): a multi-head positional attention over the window, ffn, layer
    norm, activation. `pos_embed` keeps the JAX package's raw [H, E, ctx]."""

    def __init__(self, cfg: PredictorConfig, vocab_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(cfg, vocab_size, dtype, device)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.n_head, cfg.embed_size,
                                                  self.context_size, device=device))
        self.ffn = Dense(cfg.embed_size, cfg.embed_size, device=device)

    def _windows(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, history + U, E] -> [B, U, E]."""
        ctx = self.context_size
        windows = x.unfold(1, ctx, 1).transpose(-1, -2)  # [B, U, ctx, E]
        pos = self.pos_embed.to(x.dtype)
        weight = torch.einsum("buce,hec->buhc", windows, pos)
        out = torch.einsum("buhc,buce->buhe", weight, windows).sum(-2)
        out = out / (self.cfg.n_head * ctx)
        return self._act(self.norm(self.ffn(out)))


class ConvPredictor(_StatelessPredictor):
    """Causal depthwise-conv predictor (tpuasr/nn/predictor.py:192-236): a
    bias-free depthwise VALID conv over the window's `history_size + 1`
    taps, layer norm, activation."""

    def __init__(self, cfg: PredictorConfig, vocab_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(cfg, vocab_size, dtype, device)
        e = cfg.embed_size
        # depthwise weight [E, 1, ctx] (the JAX package's kernel is [ctx, 1, E])
        self.conv = nn.Conv1d(e, e, self.context_size, groups=e, bias=False, device=device)

    def _windows(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.conv.weight.to(x.dtype),
                     groups=self.cfg.embed_size).transpose(1, 2)
        return self._act(self.norm(y))


PREDICTOR_CLASSES = {"rnn": RNNPredictor, "embedding": EmbeddingPredictor,
                     "conv": ConvPredictor}
