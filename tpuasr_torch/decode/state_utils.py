"""Predictor-state helpers for batched decoding (port of
``tpuasr/decode/state_utils.py:15-30``)."""

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
