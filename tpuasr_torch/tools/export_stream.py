"""Export the streaming serving surface as `torch.export` artifacts (port of
``tools/export_stream.py``).

    python -m tpuasr_torch.tools.export_stream --out DIR [--checkpoint exp/latest] \\
        [--batch 16] [--max_tokens 200] [--verify] [--config cfg.yaml] \\
        [--set k=v ...] [--device cuda|cpu]

Loads the port's checkpoint, a JAX orbax directory or its npz (or, without
one, the online_rnnt model with seeded weights, a smoke run) with the
config saved beside it, traces
encoder_chunk / predictor_step / joint_step / the fused process_chunk for
`--batch` parallel streams on the device (`tpuasr_torch.export`), and writes
one ``.pt2`` file each and manifest.json to --out. `--verify` reloads the
artifacts and runs one zero-input chunk through process_chunk. The
artifacts run on the device they were traced on.
"""

from __future__ import annotations

import argparse

from tpuasr_torch.tools.common import add_config_args


def main(argv=None) -> dict:
    """Export -> the manifest."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None,
                    help="the port's checkpoint, a JAX orbax directory or its npz (omit "
                         "for seeded weights, a smoke run)")
    ap.add_argument("--out", required=True, help="output artifact directory")
    ap.add_argument("--batch", type=int, default=1,
                    help="number of parallel streams baked into the export")
    ap.add_argument("--max_tokens", type=int, default=200)
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifacts and run one zero-input chunk")
    add_config_args(ap)
    args = ap.parse_args(argv)

    import torch

    from tpuasr_torch.decode.rnnt_streaming import init_streaming_state
    from tpuasr_torch.device import resolve_device
    from tpuasr_torch.export import export_streaming, load_exported
    from tpuasr_torch.tools.common import eval_config, restore_model
    from tpuasr_torch.tools.train import build_model

    device = resolve_device(args.device)
    cfg = eval_config(args.checkpoint, args.config, args.set, device)
    if args.checkpoint:
        model = restore_model(cfg, "online_rnnt", device, args.checkpoint)
    else:
        model = build_model(cfg, "online_rnnt", device).eval()
    manifest = export_streaming(model, cfg, args.out, batch=args.batch,
                                max_tokens=args.max_tokens)
    print(f"exported {sorted(manifest['functions'])} -> {args.out} "
          f"(batch={manifest['batch']}, window={manifest['window']}, on {device.type})")

    if args.verify:
        fns = load_exported(args.out)
        win = torch.zeros((args.batch, manifest["window"], cfg.model.encoder.input_size),
                          device=device)
        state = init_streaming_state(model, args.batch, cfg.streaming.chunk_size,
                                     cfg.streaming.num_left_chunks, cfg.model.blank_id,
                                     args.max_tokens)
        out = fns["process_chunk"](win, state)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if int(out.enc.offset) != cfg.streaming.chunk_size:
            raise RuntimeError(f"verify: the process_chunk artifact advanced the stream to "
                               f"{int(out.enc.offset)}, not {cfg.streaming.chunk_size}")
        print("verify: process_chunk artifact executed one chunk ok")
    return manifest


if __name__ == "__main__":
    main()
