"""Checkpoint and resume (port of ``tpuasr/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file holding the model's state_dict, the
`FusedAdamState` (count and the flat moments; with `optim.accum_steps` > 1
also the gradient mean and the micro-step count, so a run resumed in the
middle of an accumulation cycle goes on exactly), the host step count, the
plateau scale and the count of skipped steps, all as CPU tensors so a card
checkpoint restores on the CPU and back; a JSON info file beside it
(``<path>.json``) carries the epoch, losses and plateau state, as the JAX
package writes one beside its orbax directory.

`restore_checkpoint` also takes the JAX package's checkpoints: an orbax
directory (``save_dir/latest``, ``save_dir/epoch_NNNN``; read with
tensorstore, `tpuasr_torch.train.orbax`) or the ``.npz`` that
``python -m tpuasr_torch.tools.orbax_to_npz`` writes of one where
tensorstore is installed (read with numpy alone, as on the card), either
layer layout; `tpuasr_torch.convert.convert_train_state` maps the tree.
Their info JSON sits at ``<path>.json`` too, and `find_effective_config`
finds their train.yaml.

A checkpoint holds whole vectors whatever the world size that wrote it:
`train_loop` gathers the ZeRO slices to rank 0 before a save
(`parallel.zero.whole_state`), and a resumed run restores the whole state and
slices it again for its own world size (`parallel.zero.shard_train_state`).
"""

from __future__ import annotations

import json
import os

import torch

from tpuasr_torch.train.optim import FusedAdamState
from tpuasr_torch.train.step import TrainState


def save_checkpoint(path: str, state: TrainState, info: dict | None = None) -> None:
    """Write `state` to the file `path` (atomically: a reader never sees
    half a file) and `info` to ``path + ".json"``."""
    cpu = lambda t: None if t is None else t.detach().cpu()
    payload = {
        "model": {k: cpu(v) for k, v in state.model.state_dict().items()},
        "opt_state": {k: cpu(v) for k, v in state.opt_state._asdict().items()},
        "step": int(state.step),
        "lr_scale": float(state.lr_scale),
        "skipped": int(state.skipped),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if info is not None:
        with open(path + ".json", "w") as f:
            json.dump(info, f, indent=2, default=float)


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Load a checkpoint (the port's file, a JAX orbax directory or its
    npz) into `target`'s model (in place) and return a TrainState with its
    optimizer state, step, plateau scale and skipped count, on the model's
    device."""
    from tpuasr_torch.train.orbax import read_checkpoint

    model = target.model
    tree = read_checkpoint(path)
    if tree is not None:
        from tpuasr_torch.convert import convert_train_state

        return convert_train_state(tree, target)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["model"])
    dev = next(model.parameters()).device
    # a checkpoint written before gradient accumulation holds no acc / mini_step
    opt = {k: None if ck["opt_state"].get(k) is None else ck["opt_state"][k].to(dev)
           for k in FusedAdamState._fields}
    for k, v in opt.items():
        ref = getattr(target.opt_state, k)
        if (v is None) != (ref is None) or (v is not None and v.shape != ref.shape):
            raise ValueError(f"checkpoint {path}: optimizer state {k} does not match the "
                             f"model's ({None if v is None else tuple(v.shape)} vs "
                             f"{None if ref is None else tuple(ref.shape)})")
    return TrainState(model, FusedAdamState(**opt), int(ck["step"]), float(ck["lr_scale"]),
                      torch.tensor(int(ck["skipped"]), dtype=torch.int32, device=dev))


def load_info(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def find_effective_config(ckpt_path: str) -> str | None:
    """The config the loop saved beside a checkpoint (save_dir/train.yaml),
    looked for in the checkpoint's own directory entry, then its parent;
    None if absent."""
    ckpt_path = os.path.abspath(ckpt_path)
    for base in (ckpt_path, os.path.dirname(ckpt_path)):
        for name in ("train.yaml", "config.yaml"):
            cand = os.path.join(base, name)
            if os.path.exists(cand):
                return cand
    return None


def latest_path(save_dir: str) -> str:
    return os.path.join(save_dir, "latest")


def epoch_path(save_dir: str, epoch: int) -> str:
    return os.path.join(save_dir, f"epoch_{epoch:04d}")
