"""Device selection: the port runs on the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the card. A CUDA request on a machine without a card raises;
    it never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
