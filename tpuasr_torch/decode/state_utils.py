"""Predictor-state helpers for batched decoding (port of
``tpuasr/decode/state_utils.py:15-67``).

A state is a tuple of leaves with the batch at `axis` (the LSTM predictor:
([L, B, H], [L, B, H]), axis 1). Beam search keeps B x N hypotheses: the
leaves then hold (..., B, N, ...) at `axis`, or B*N flattened there for the
predictor step."""

from __future__ import annotations

import torch


def predictor_state_axis(model) -> int:
    return type(model.predictor).state_batch_axis


def where_state(mask_b: torch.Tensor, new_state, old_state, axis: int):
    """Per-stream select over a tuple of state leaves: mask_b [B] True ->
    the new leaf values."""

    def sel(n, o):
        shape = [1] * n.dim()
        shape[axis] = mask_b.shape[0]
        return torch.where(mask_b.view(shape), n, o)

    return tuple(sel(n, o) for n, o in zip(new_state, old_state))


def split_beam_axis(state, b: int, n: int, axis: int):
    """Leaves with B*N flattened at `axis` -> (..., B, N, ...)."""
    return tuple(x.reshape(x.shape[:axis] + (b, n) + x.shape[axis + 1:]) for x in state)


def merge_beam_axis(state, axis: int):
    """Leaves with (..., B, N, ...) at `axis` -> B*N flattened."""
    return tuple(x.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 2:]) for x in state)


def gather_beam(state, sel: torch.Tensor, axis: int):
    """Reindex hypotheses: leaves (..., B, N, ...), sel [B, N] -> leaf[..., b,
    sel[b, j], ...] at slot (b, j). `torch.gather` does not broadcast its
    index as `take_along_axis` does, so the index is expanded to the leaf."""

    def g(x):
        idx = sel.reshape((1,) * axis + tuple(sel.shape) + (1,) * (x.dim() - axis - 2))
        return torch.gather(x, axis + 1, idx.expand(x.shape[:axis] + sel.shape
                                                    + x.shape[axis + 2:]))

    return tuple(g(x) for x in state)


def where_beam(mask: torch.Tensor, new_state, old_state, axis: int):
    """Select per (B, N) slot: mask [B, N] True -> the new leaf values."""

    def sel(n, o):
        return torch.where(mask.reshape((1,) * axis + tuple(mask.shape)
                                        + (1,) * (n.dim() - axis - 2)), n, o)

    return tuple(sel(n, o) for n, o in zip(new_state, old_state))
