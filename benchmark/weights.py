"""Seeded weights, made on the device in two calls of a generator on the card
and handed alike to the program and to the reference.

The scales are the configurations' initializer's: lecun-normal kernels
(std 1 / sqrt(fan-in); the joint's output kernel [D, V] is stored
in-by-out), zero biases, unit LayerNorm scales, xavier-uniform
Transformer-XL biases and LSTM recurrent matrices, unit-normal embeddings.
Where the configuration gives the joint's blank bias (`blank_bias`), the
output kernel's blank column is zero and the blank logit is that constant:
random weights would otherwise move the blank logit by a seed's own
offset, and with it how often greedy search emits, so that the seed would
change the work of a streaming run.
"""

from __future__ import annotations

import math

import torch

_SALT = 0x5EED_0F_3E16


def _kind(name: str, shape) -> tuple[str, float]:
    """(normal | uniform | ones | zeros, scale) of one leaf, by its name."""
    module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    if "norm" in module.rsplit(".", 1)[-1]:  # a LayerNorm's scale and shift
        return ("ones", 1.0) if leaf == "weight" else ("zeros", 0.0)
    if leaf in ("bias", "ffn_out_bias"):
        return "zeros", 0.0
    if leaf in ("pos_bias_u", "pos_bias_v") or name.startswith("predictor.wh."):
        return "uniform", math.sqrt(6.0 / (shape[0] + shape[1]))
    if name.endswith("embed.weight") and len(shape) == 2 and "predictor" in name:
        return "normal", 1.0
    if leaf == "ffn_out_kernel":
        return "normal", 1.0 / math.sqrt(shape[0])
    return "normal", 1.0 / math.sqrt(math.prod(shape[1:]))


def make(seed: int, leaves: list, config: dict, device) -> dict:
    """{name: fp32 tensor} for the (name, shape) `leaves`, in their order."""
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ _SALT) & ((1 << 63) - 1))
    kinds = [(n, tuple(s), *_kind(n, tuple(s))) for n, s in leaves]
    count = {k: sum(math.prod(s) for _, s, kk, _ in kinds if kk == k)
             for k in ("normal", "uniform")}
    pools = {"normal": torch.randn(count["normal"], generator=gen, device=device),
             "uniform": torch.rand(count["uniform"], generator=gen, device=device) * 2.0 - 1.0}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale in kinds:
        n = math.prod(shape)
        if kind in pools:
            out[name] = pools[kind][at[kind]:at[kind] + n].view(shape) * scale
            at[kind] += n
        else:
            out[name] = torch.full(shape, 1.0 if kind == "ones" else 0.0, device=device)
    bias = config["model"].get("blank_bias")
    if bias is not None and "joint.ffn_out_bias" in out:
        out["joint.ffn_out_bias"][config["model"]["blank_id"]] = float(bias)
        out["joint.ffn_out_kernel"][:, config["model"]["blank_id"]] = 0.0
    return out
