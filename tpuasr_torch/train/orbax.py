"""Read the JAX package's checkpoints without JAX.

The JAX package saves a `TrainState` with orbax's `StandardCheckpointer`
(``tpuasr/train/checkpoint.py:save_checkpoint``): a directory holding
``_METADATA`` (a JSON whose ``tree_metadata`` maps each leaf's key path,
written as a Python tuple literal, to its metadata), ``manifest.ocdbt``,
``d/`` and ``ocdbt.process_<i>/``. Each leaf is a zarr array (v2, or v3
with ``use_zarr3``) compressed with zstd, kept inside an OCDBT key-value
store (``use_ocdbt``) or as plain files under the directory, at the key
path joined by dots. `read_orbax` reads them with `tensorstore` alone,
imported when it is called; it imports neither JAX nor orbax. This reader
was held against the files of orbax 0.11.32 (jax 0.9.0).

A machine without tensorstore (the card's) reads the same tree from an
``.npz`` of "/"-joined keys that a machine with tensorstore writes:

    python -m tpuasr_torch.tools.orbax_to_npz SAVE_DIR/latest OUT.npz

`read_npz` reads that file with numpy alone. `read_checkpoint` picks the
reader from the path, and `tpuasr_torch.convert.convert_train_state` turns
the tree into the port's `TrainState`.
"""

from __future__ import annotations

import ast
import json
import os

import numpy as np

ORBAX_VERSION = "0.11.32"  # the writer this reader was held against

NPZ_ROUTE = ("install tensorstore, or convert the checkpoint where it is installed: "
             "python -m tpuasr_torch.tools.orbax_to_npz CKPT_DIR OUT.npz, then pass OUT.npz")


def is_orbax_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "_METADATA"))


def is_npz(path: str) -> bool:
    return path.endswith(".npz") and os.path.isfile(path)


def leaf_paths(path: str) -> tuple[list[tuple[str, ...]], dict]:
    """-> (every leaf's key path, the layout flags) from the directory's
    ``_METADATA``; raises ValueError for a layout this reader does not know."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    tree = meta.get("tree_metadata")
    if not isinstance(tree, dict) or not tree:
        raise ValueError(f"{path}: _METADATA has no tree_metadata (not an orbax "
                         f"StandardCheckpointer directory of orbax {ORBAX_VERSION}'s layout)")
    flags = {"use_ocdbt": meta.get("use_ocdbt"), "use_zarr3": meta.get("use_zarr3")}
    if not all(isinstance(v, bool) for v in flags.values()):
        raise ValueError(f"{path}: _METADATA lacks use_ocdbt / use_zarr3: {flags}")
    paths = []
    for key, entry in tree.items():
        keys = ast.literal_eval(key)
        kinds = {k.get("key_type") for k in entry.get("key_metadata", [])}
        value = entry.get("value_metadata", {}).get("value_type")
        if (not isinstance(keys, tuple) or not all(isinstance(k, str) for k in keys)
                or kinds != {2} or value not in ("np.ndarray", "jax.Array")):
            raise ValueError(f"{path}: leaf {key} has a layout this reader does not know "
                             f"(key types {sorted(kinds)}, value type {value!r}; only "
                             f"dict keys and arrays, as orbax {ORBAX_VERSION} writes a "
                             f"TrainState)")
        paths.append(keys)
    return paths, flags


def read_orbax(path: str, only: str | None = None) -> dict:
    """The nested numpy tree of the orbax checkpoint directory `path`; with
    `only` the subtree under that top-level key alone (e.g. "params": a
    server reads no optimizer moments)."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(f"reading the orbax checkpoint {path} needs tensorstore: "
                          f"{NPZ_ROUTE}") from e
    path = os.path.abspath(path)
    paths, flags = leaf_paths(path)
    paths = [k for k in paths if only is None or k[0] == only]
    array_format = "zarr3" if flags["use_zarr3"] else "zarr"
    tree: dict = {}
    for keys in paths:
        name = ".".join(keys) + "/"
        if flags["use_ocdbt"]:
            kvstore = {"driver": "ocdbt", "base": f"file://{path}/", "path": name}
        else:
            kvstore = {"driver": "file", "path": os.path.join(path, name)}
        arr = ts.open({"driver": array_format, "kvstore": kvstore}, open=True).result()
        _insert(tree, keys, np.asarray(arr.read().result()))
    return tree


def _insert(tree: dict, keys, value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def write_npz(path: str, tree: dict) -> None:
    """`tree` as an uncompressed npz of "/"-joined keys (atomically)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flatten_tree(tree))
    os.replace(tmp, path)


def read_npz(path: str, only: str | None = None) -> dict:
    """The nested numpy tree of an npz that `write_npz` wrote (with `only`,
    the subtree under that top-level key alone, the other arrays unread)."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            keys = key.split("/")
            if only is None or keys[0] == only:
                _insert(tree, keys, z[key])
    return tree


def read_checkpoint(path: str, only: str | None = None) -> dict | None:
    """The JAX tree of `path` (with `only`, its subtree under that key) when
    it is an orbax directory or an npz of one, else None (a port
    checkpoint, or nothing)."""
    if is_orbax_dir(path):
        return read_orbax(path, only)
    if is_npz(path):
        return read_npz(path, only)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory without _METADATA: neither an orbax "
                         f"checkpoint nor the port's checkpoint file")
    return None
