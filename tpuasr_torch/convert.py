"""Convert a JAX (flax) Transducer, CTCModel or ASRModel parameter tree into
the port's state_dict.

Input: the flax params as nested dicts of numpy arrays (with or without the
top-level "params" key), e.g. ``jax.tree.map(np.asarray, params)``; this
module imports nothing of JAX. The layout differences it resolves:

- flax ``Dense`` kernels are [in, out]; ``nn.Linear`` weights are [out, in];
- the subsampling convs (``conv1``..``conv3`` of conv2d / conv2d6 /
  conv2d8) are HWIO [k, k, in, out]; torch's are OIHW (the NHWC flatten
  order is handled by the module: it permutes to [B, T', F', C] before the
  flatten, so the `out` weight is only transposed);
- the depthwise conv kernel is [K, 1, C]; torch's is [C, 1, K];
- flax ``LayerNorm`` params are ``scale``/``bias`` (eps 1e-6, set by the
  port's LayerNorm); ``nn.Embed`` is ``embedding``;
- the predictor's ``wx_l``/``wh_l`` become ``wx.{l}``/``wh.{l}`` (wh keeps
  its [H, 4H] layout, the cell is written out); the joint head's raw
  ``ffn_out_kernel [D, V]`` and ``pos_bias_u/v [H, dk]`` keep theirs;
- encoder blocks come either unrolled (``block{i}``) or scanned
  (``layers/block`` with a leading [L] axis); both become ``blocks.{i}``;
- the attention decoders' layers ``layer{i}`` become ``layers.{i}``.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# flax's numbered submodules -> the port's ModuleList / ParameterList names
_LISTS = {"block": "blocks", "layer": "layers", "wx_": "wx", "wh_": "wh"}


def _convert_leaf(path: tuple, x: np.ndarray) -> tuple[str, np.ndarray]:
    *parents, leaf = path
    if leaf == "kernel":
        if parents[-1] == "depthwise_conv":
            x = x.transpose(2, 1, 0)  # [K, 1, C] -> [C, 1, K]
        elif x.ndim == 4:
            x = x.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif x.ndim == 2:
            x = x.T  # [in, out] -> [out, in]
        else:
            raise ValueError(f"unexpected kernel {'/'.join(path)} of shape {x.shape}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    names = []
    for p in (*parents, leaf):
        m = re.fullmatch(r"(block|layer|wx_|wh_)(\d+)", p)
        names.append(f"{_LISTS[m.group(1)]}.{m.group(2)}" if m else p)
    return ".".join(names), x


def convert_params(params: dict) -> dict[str, torch.Tensor]:
    """flax Transducer, CTCModel or ASRModel params (nested numpy dicts) ->
    port state_dict."""
    params = params.get("params", params)
    flat = _flatten(params)
    out = {}
    for path, x in flat.items():
        if path[:3] == ("encoder", "layers", "block"):  # scanned: leading [L]
            for i in range(x.shape[0]):
                key, v = _convert_leaf(("encoder", f"block{i}") + path[3:], x[i])
                out[key] = torch.from_numpy(np.array(v))
        else:
            key, v = _convert_leaf(path, x)
            out[key] = torch.from_numpy(np.array(v))
    return out


def load_jax_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load converted flax params into `model` (strict: every parameter of
    the port must be present and nothing left over)."""
    model.load_state_dict(convert_params(params), strict=True)
    return model
