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


# the port's list names -> flax's numbered prefixes (the inverse of _LISTS)
_FLAX_LISTS = {v: k for k, v in _LISTS.items()}


def _flax_leaf(module: torch.nn.Module, mname: str, pname: str, x: np.ndarray
               ) -> tuple[tuple, np.ndarray]:
    """The flax path and array of `module`'s own tensor `pname` (the
    inverse of `_convert_leaf`)."""
    comps = []
    for c in (mname.split(".") if mname else []) + [pname]:
        if c.isdigit() and comps and comps[-1] in _FLAX_LISTS:
            comps[-1] = _FLAX_LISTS[comps[-1]] + c
        else:
            comps.append(c)
    if pname != "weight":
        return tuple(comps), x
    nn = torch.nn
    if isinstance(module, nn.ConvTranspose1d):
        if comps[-2:-1] != ["tp_upsample_cnn"]:
            raise ValueError(f"{mname}: a ConvTranspose1d the converter has no rule for")
        leaf, x = "kernel", x.transpose(2, 0, 1)[::-1]  # [in, out, K] -> flax [K, in, out]
    elif isinstance(module, nn.Linear):
        leaf, x = "kernel", x.T
    elif isinstance(module, nn.Conv1d):
        leaf, x = "kernel", x.transpose(2, 1, 0)  # [out, in, K] -> [K, in, out]
    elif isinstance(module, nn.Conv2d):
        leaf, x = "kernel", x.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif isinstance(module, nn.Embedding):
        leaf = "embedding"
    elif x.ndim == 1:  # LayerNorm, RMSNorm, BatchNormEval, AdaptiveScale
        leaf = "scale"
    else:
        raise ValueError(f"{mname}: a {type(module).__name__} weight of shape {x.shape} the "
                         f"converter has no rule for")
    return tuple(comps[:-1]) + (leaf,), np.ascontiguousarray(x)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _flax_tree(model: torch.nn.Module, tensors: dict | None = None) -> dict:
    """The nested flax tree of `tensors` ({port parameter name: tensor
    shaped like it}), or with None of the model's persistent buffers (the
    batch norms' running statistics)."""
    tree: dict = {}
    for mname, mod in model.named_modules():
        if tensors is None:
            own = [(b, t) for b, t in mod.named_buffers(recurse=False)
                   if b not in mod._non_persistent_buffers_set]
        else:
            own = [(p, tensors[f"{mname}.{p}" if mname else p])
                   for p, _ in mod.named_parameters(recurse=False)]
        for name, t in own:
            path, x = _flax_leaf(mod, mname, name, _numpy(t))
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = x
    return tree


def flax_params(model: torch.nn.Module) -> dict:
    """The port model's weights as flax variables in the unrolled layout:
    {"params": tree} plus {"batch_stats": tree} of the batch norms' running
    mean and var when the model has them; `convert_params` of the result
    gives back `model.state_dict()` exactly."""
    out = {"params": _flax_tree(model, dict(model.named_parameters()))}
    stats = _flax_tree(model)
    if stats:
        out["batch_stats"] = stats
    return out


MOMENTS = ("mu", "nu", "nu_max")
TRAIN_STATE_KEYS = {"params", "opt_state", "step", "lr_scale", "skipped"}


def flax_train_state(state) -> dict:
    """A port `TrainState` (whole, not a ZeRO slice) as the JAX package's
    `TrainState` tree: params (flax variables), opt_state {count, mu, nu
    [, nu_max]} with each moment in the params' flax layout, step, lr_scale
    and skipped as numpy scalars."""
    from tpuasr_torch.train.optim import unflatten

    if state.zero is not None:
        raise ValueError("flax_train_state takes a whole state: gather a ZeRO slice first "
                         "(parallel.zero.whole_state)")
    model, opt = state.model, state.opt_state
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    if opt.acc is not None:
        raise ValueError("the JAX package's GuardedAdam state has no gradient accumulation "
                         "(optim.accum_steps > 1 trains through optax.MultiSteps there)")
    opt_tree = {"count": _numpy(opt.count).astype(np.int32)}
    for k in MOMENTS:
        flat = getattr(opt, k)
        if flat is not None:
            opt_tree[k] = _flax_tree(model, dict(zip(names, unflatten(flat, params))))
    return {"params": flax_params(model), "opt_state": opt_tree,
            "step": np.asarray(state.step, np.int32),
            "lr_scale": np.asarray(state.lr_scale, np.float32),
            "skipped": _numpy(torch.as_tensor(state.skipped)).astype(np.int32)}


def convert_train_state(tree: dict, target):
    """A JAX `TrainState` tree (numpy leaves: `tpuasr_torch.train.orbax`)
    -> a port `TrainState` in the layout of `target` (e.g.
    `TrainState.create(model, optimizer)`): the weights load into its model
    in place (strict), the moments go through the parameters' leaf map and
    are flattened in `model.parameters()` order, count, step, lr_scale and
    skipped carry over. A leaf left over or missing raises, as does an optimizer state
    that is not the GuardedAdam layout (optax.MultiSteps, for one); with the
    port's gradient accumulation on, the cycle starts anew (the target's
    zero acc and mini_step)."""
    from tpuasr_torch.train.step import TrainState

    if set(tree) != TRAIN_STATE_KEYS:
        raise ValueError(f"not a JAX TrainState tree: keys {sorted(tree)}, expected "
                         f"{sorted(TRAIN_STATE_KEYS)}")
    model = target.model
    model.load_state_dict(convert_params(tree["params"]), strict=True)
    opt = tree["opt_state"]
    want = {"count", "mu", "nu"} | ({"nu_max"} if target.opt_state.nu_max is not None else set())
    if set(opt) != want:
        raise ValueError(f"the checkpoint's optimizer state holds {sorted(opt)}, the port's "
                         f"GuardedAdam (amsgrad {target.opt_state.nu_max is not None}) "
                         f"wants {sorted(want)}")
    named = dict(model.named_parameters())
    dev = next(iter(named.values())).device
    moments = {}
    for k in MOMENTS:
        if k not in opt:
            continue
        conv = convert_params(opt[k])
        if conv.keys() != named.keys():
            raise ValueError(f"opt_state.{k} does not mirror the model's parameters: missing "
                             f"{sorted(named.keys() - conv.keys())}, left over "
                             f"{sorted(conv.keys() - named.keys())}")
        for n, p in named.items():
            if conv[n].shape != p.shape:
                raise ValueError(f"opt_state.{k}: {n} is {tuple(conv[n].shape)}, the "
                                 f"parameter {tuple(p.shape)}")
        moments[k] = torch.cat([conv[n].reshape(-1).float() for n in named]).to(dev)
    i32 = lambda x: torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)
    return TrainState(model, target.opt_state._replace(count=i32(opt["count"]), **moments),
                      int(np.asarray(tree["step"])), float(np.asarray(tree["lr_scale"])),
                      i32(tree["skipped"]))
