"""Streaming evaluation CLI (port of ``tools/eval_streaming.py``): chunked
greedy and beam CER over the dev or test split and the beam's relative
improvement, with REF/GREEDY/BEAM samples.

    python -m tpuasr_torch.tools.eval_streaming --checkpoint exp/latest \\
        [--split dev|test] [--beam_size 4] [--synthetic N --seed S] \\
        [--data_root DIR] [--config cfg.yaml] [--set k=v ...] [--device cuda|cpu]

The model is the online_rnnt workload's; chunk and left chunks come from
cfg.streaming.
"""

from __future__ import annotations

import argparse
import sys

from tpuasr_torch.tools.common import add_config_args


def main(argv=None):
    """Evaluate -> the StreamingEvalResult (also printed)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--split", choices=["dev", "test"], default="dev")
    ap.add_argument("--beam_size", type=int, default=4)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--seed", type=int, default=1,
                    help="synthetic corpus seed (the trainer's pipes use 0, dev 1)")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--max_samples", type=int, default=5, help="samples to print")
    add_config_args(ap)
    args = ap.parse_args(argv)

    from tpuasr_torch.device import resolve_device
    from tpuasr_torch.eval import evaluate_streaming
    from tpuasr_torch.tools.common import eval_config, eval_split, restore_model

    device = resolve_device(args.device)
    cfg = eval_config(args.checkpoint, args.config, args.set, device)
    tokenizer, pipe = eval_split(cfg, args.split, args.synthetic, args.seed, args.data_root)
    model = restore_model(cfg, "online_rnnt", device, args.checkpoint)

    res = evaluate_streaming(model, pipe.batches(0), cfg, tokenizer, beam_size=args.beam_size,
                             max_samples=args.max_samples)
    print(f"streaming greedy CER {100 * res.greedy.cer:.2f}%")
    print(f"streaming beam-{args.beam_size} CER {100 * res.beam.cer:.2f}%")
    print(f"relative improvement {100 * res.relative_improvement:.2f}%")
    for utt, ref, g, b in res.samples:
        print(f"  [{utt}] REF:    {ref}")
        print(f"  [{utt}] GREEDY: {g}")
        print(f"  [{utt}] BEAM:   {b}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
