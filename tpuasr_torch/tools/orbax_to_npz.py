"""Write a JAX orbax checkpoint as an npz that the port reads with numpy
alone (on a machine without tensorstore, such as the card's):

    python -m tpuasr_torch.tools.orbax_to_npz SAVE_DIR/latest OUT.npz

Run it where tensorstore is installed (JAX is not needed). The npz holds
the checkpoint's `TrainState` tree under "/"-joined keys
(``params/params/encoder/...``, ``opt_state/mu/...``, ``step``, ...); the
info JSON beside the checkpoint (``SAVE_DIR/latest.json``) is copied to
``OUT.npz.json`` and the train.yaml that `find_effective_config` finds for
it to beside the npz, so that `evaluate`, `eval_streaming`,
`decode_stream`, `export_stream`, `rtf_bench` and `train --resume` take
``OUT.npz`` with no other flag.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


def main(argv=None) -> str:
    """Convert -> the npz's path."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="a JAX orbax checkpoint directory")
    ap.add_argument("out", help="the .npz to write")
    args = ap.parse_args(argv)

    from tpuasr_torch.train.checkpoint import find_effective_config
    from tpuasr_torch.train.orbax import flatten_tree, is_orbax_dir, read_orbax, write_npz

    if not args.out.endswith(".npz"):
        raise ValueError(f"{args.out}: the output must end in .npz (the port's CLIs tell "
                         f"the npz route by it)")
    if not is_orbax_dir(args.checkpoint):
        raise ValueError(f"{args.checkpoint} is not an orbax checkpoint directory (no "
                         f"_METADATA)")
    tree = read_orbax(args.checkpoint)
    write_npz(args.out, tree)
    print(f"wrote {len(flatten_tree(tree))} arrays of {args.checkpoint} to {args.out}")
    info = os.path.abspath(args.checkpoint) + ".json"
    if os.path.exists(info):
        shutil.copyfile(info, args.out + ".json")
        print(f"copied {info} to {args.out}.json")
    cfg = find_effective_config(args.checkpoint)
    if cfg:
        dst = os.path.join(os.path.dirname(os.path.abspath(args.out)), os.path.basename(cfg))
        if os.path.abspath(cfg) != dst:
            shutil.copyfile(cfg, dst)
        print(f"copied {cfg} to {dst}")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
