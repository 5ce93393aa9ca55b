"""RTF / per-chunk latency benchmark (port of ``tools/rtf_bench.py``):
mean/p50/p80/p90/p95/max RTF of streaming greedy and beam decode on the
card, over random features, beside the dispatch-and-sync probe.

    python -m tpuasr_torch.tools.rtf_bench [--checkpoint CKPT] [--config cfg.yaml]
        [--set streaming.chunk_size=32 ...] [--seconds 30] [--batch 1]
        [--beam_size 4] [--modes greedy beam]

The model is the online_rnnt workload of `tpuasr_torch.tools.train`
(`build_model`, seeded weights); `--checkpoint` loads the model weights of
a checkpoint the port's trainer saved (`torch.save`), of a JAX orbax
directory or of its npz (`tools/orbax_to_npz.py`), with the train.yaml
beside it unless --config is given. Both modes run with
`streaming.n_steps` emissions a frame.
"""

from __future__ import annotations

import argparse
import sys


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None,
                    help="optional; seeded random weights if omitted (timing only)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--beam_size", type=int, default=4)
    ap.add_argument("--modes", nargs="*", default=["greedy", "beam"])
    return ap


def main(argv=None) -> dict:
    """Run the benchmark -> {mode: RtfStats}."""
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from tpuasr_torch.config import Config, layer_yaml, override
    from tpuasr_torch.device import resolve_device
    from tpuasr_torch.eval import measure_rtf
    from tpuasr_torch.tools.common import restore_model
    from tpuasr_torch.tools.train import build_model, parse_overrides
    from tpuasr_torch.train import find_effective_config

    config = args.config
    if config is None and args.checkpoint:
        config = find_effective_config(args.checkpoint)
    cfg = layer_yaml(Config(), config) if config else Config()
    cfg = override(cfg, parse_overrides(args.set))
    if args.checkpoint:
        model = restore_model(cfg, "online_rnnt", resolve_device(None), args.checkpoint)
    else:
        model = build_model(cfg, "online_rnnt", resolve_device(None))

    rng = np.random.default_rng(0)
    t = int(args.seconds * cfg.feature.sample_rate / cfg.feature.hop_length)
    feats = torch.from_numpy(rng.standard_normal((args.batch, t, 80)).astype(np.float32))
    out = {}
    for mode in args.modes:
        s = measure_rtf(model, feats, cfg, mode=mode, beam_size=args.beam_size,
                        n_steps=cfg.streaming.n_steps)
        print(f"[{mode}] chunks={s.n_chunks} chunk_audio={s.chunk_audio_seconds:.2f}s "
              f"RTF mean={s.rtf_mean:.4f} p50={s.rtf_p50:.4f} p80={s.rtf_p80:.4f} "
              f"p90={s.rtf_p90:.4f} p95={s.rtf_p95:.4f} max={s.rtf_max:.4f} "
              f"| probe p50={s.probe_p50_ms:.2f}ms mean={s.probe_mean_ms:.2f}ms on {s.device}")
        out[mode] = s
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
