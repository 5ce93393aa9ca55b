"""Convert a JAX (flax) Transducer, CTCModel, ASRModel or Paraformer
parameter tree into the port's state_dict.

Input: the flax params as nested dicts of numpy arrays (with or without the
top-level "params" key), e.g. ``jax.tree.map(np.asarray, params)``, or the
whole variables dict, whose ``batch_stats`` collection (the conv modules'
batch-norm running ``mean``/``var``) lands in the buffers of those names;
this module imports nothing of JAX. The layout differences it resolves:

- flax ``Dense`` kernels are [in, out]; ``nn.Linear`` weights are [out, in];
- the subsampling convs (``conv1``..``conv3`` of conv2d / conv2d6 /
  conv2d8) are HWIO [k, k, in, out]; torch's are OIHW (the NHWC flatten
  order is handled by the module: it permutes to [B, T', F', C] before the
  flatten, so the `out` weight is only transposed);
- 1-D conv kernels (the conv modules' and the conv predictor's depthwise
  [K, 1, C], conv1d2's [K, in, out]) become torch's [out, in, K];
- flax ``LayerNorm``, ``RMSNorm`` and ``BatchNorm`` params are
  ``scale``/``bias``; ``nn.Embed`` is ``embedding``;
- raw parameters keep the JAX layout: the joint head's ``ffn_out_kernel``,
  the MoE experts' ``w1 [E, D, H]`` / ``w2 [E, H, D]``, the embedding
  predictor's ``pos_embed [H, E, ctx]``, Shaw's ``rel_k_embed`` and the
  encoder's ``learned_pe``;
- the predictor's ``wx_l``/``wh_l`` become ``wx.{l}``/``wh.{l}`` (wh keeps
  its [H, 4H] layout, the cell is written out); the joint head's raw
  ``ffn_out_kernel [D, V]`` and ``pos_bias_u/v [H, dk]`` keep theirs;
- encoder blocks come either unrolled (``block{i}``) or scanned
  (``layers/block`` with a leading [L] axis); both become ``blocks.{i}``
  (the squeezeformer and efficient-conformer families come unrolled only:
  the JAX package never scans them);
- the encoder families' leaves need no rule of their own: squeezeformer's
  depthwise front end (``embed/pw_conv``, ``embed/dw_conv``: HWIO [3, 3, 1,
  C] -> OIHW [C, 1, 3, 3]), ``time_reduction/{dw,pw}`` (1-D kernels),
  ``time_recover`` and the adaptive scales ``scale_*``,
  whose ``scale`` leaf becomes ``weight`` as every flax ``scale`` does;
  the efficient conformer's grouped ``pos_bias_u/v [H, g*dk]`` keep their
  layout;
- the attention decoders' layers ``layer{i}`` become ``layers.{i}``, as do
  the SANM encoder's and decoder's;
- the Paraformer's timestamp branch: flax's ``ConvTranspose``
  (``tp_upsample_cnn``, ``transpose_kernel=False``) runs its taps in the
  opposite order to ``torch.nn.ConvTranspose1d``, so its [K, in, out]
  kernel is flipped along K and becomes [in, out, K]; the BLSTM's raw
  ``fwd_wh`` / ``bwd_wh`` [H, 4H] keep their layout. The CIF head
  (``predictor/cif_conv``, ``cif_output``), ``sampler_embed`` and
  ``ctc_lo`` need no rule of their own.
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
    if leaf == "kernel" and parents[-1:] == ["tp_upsample_cnn"]:
        x = x[::-1].transpose(1, 2, 0)  # flax ConvTranspose [K, in, out] -> [in, out, K]
        leaf = "weight"
    elif leaf == "kernel":
        if x.ndim == 3:
            x = x.transpose(2, 1, 0)  # [K, in, out] -> [out, in, K]
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
    """flax Transducer, CTCModel, ASRModel or Paraformer params (nested numpy
    dicts), or their variables with a `batch_stats` collection -> port
    state_dict."""
    flat = _flatten(params.get("params", params))
    if "params" in params:
        flat.update(_flatten(params.get("batch_stats", {})))
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
