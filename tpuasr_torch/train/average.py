"""Checkpoint averaging and partial initialization (port of
``tpuasr/train/average.py``).

Parity: the wenet average_model tool and `load_trained_modules`
(wenet/utils/checkpoint.py:96-117: initialize a subset of modules from a
pretrained checkpoint by name-prefix filtering). A parameter tree here is
a state_dict (dotted name -> tensor), the port's checkpoints hold one under
"model" (`tpuasr_torch.train.checkpoint`).
"""

from __future__ import annotations

from typing import Sequence

import torch


def average_params(state_dicts: Sequence[dict]) -> dict:
    """Uniform average of N state_dicts, summed in float64 and cast back
    to each entry's type."""
    if not state_dicts:
        raise ValueError("nothing to average")
    n = float(len(state_dicts))
    return {k: (sum(sd[k].double() for sd in state_dicts) / n).to(v.dtype)
            for k, v in state_dicts[0].items()}


def average_checkpoints(paths: Sequence[str]) -> dict:
    """The average of the model state_dicts of several checkpoint files."""
    return average_params([torch.load(p, map_location="cpu", weights_only=True)["model"]
                           for p in paths])


def load_partial(params: dict, pretrained: dict, prefixes: Sequence[str]
                 ) -> tuple[dict, list[str]]:
    """Copy the entries of `pretrained` into `params` whose name starts with
    any of `prefixes` (e.g. ["encoder"]) and whose shape matches ->
    (new state_dict, the copied names)."""
    out, copied = {}, []
    for name, v in params.items():
        src = pretrained.get(name)
        if (any(name.startswith(p) for p in prefixes) and src is not None
                and src.shape == v.shape):
            out[name] = src
            copied.append(name)
        else:
            out[name] = v
    return out, copied
