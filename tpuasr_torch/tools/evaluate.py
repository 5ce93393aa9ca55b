"""Offline evaluation CLI (port of ``tools/evaluate.py``): decode the dev or
test split and print corpus CER with its S/D/I/N breakdown and REF/HYP
samples.

    python -m tpuasr_torch.tools.evaluate --checkpoint exp/latest \\
        [--workload online_rnnt|rnnt|aed|paraformer] [--mode rnnt_greedy|rnnt_beam|
        ctc_greedy|ctc_prefix_beam|rnnt_rescoring|attention|attention_rescoring|
        paraformer_greedy|paraformer_beam] \\
        [--split dev|test] [--beam_size 4] \\
        [--ctc_fusion_weight W] [--synthetic N --seed S] [--data_root DIR] \\
        [--config cfg.yaml] [--set k=v ...] [--device cuda|cpu]

The checkpoint is the port's (`tpuasr_torch.tools.train`), a JAX orbax
directory or the npz of one (`tpuasr_torch.tools.orbax_to_npz`); the
train.yaml beside it gives the architecture unless --config is given. The transducer workloads
decode in the rnnt modes and the CTC ones; the aed workload (an `ASRModel`
checkpoint) in ctc_greedy, ctc_prefix_beam, attention and
attention_rescoring; the paraformer workload in paraformer_greedy and
paraformer_beam (--beam_size hypotheses, the n-best's first slot).
"""

from __future__ import annotations

import argparse
import sys

from tpuasr_torch.tools.common import add_config_args

CTC_MODES = ("ctc_greedy", "ctc_prefix_beam")  # the CTC head of either model
# the modes each workload decodes in (the transducer workloads: the rest)
WORKLOAD_MODES = {"aed": CTC_MODES + ("attention", "attention_rescoring"),
                  "paraformer": ("paraformer_greedy", "paraformer_beam")}
TRANSDUCER_MODES = ("rnnt_greedy", "rnnt_beam", "rnnt_rescoring") + CTC_MODES
MODES = ["ctc_greedy", "rnnt_greedy", "rnnt_beam", "rnnt_rescoring", "ctc_prefix_beam",
         "attention", "attention_rescoring", "paraformer_greedy", "paraformer_beam"]


def main(argv=None):
    """Evaluate -> the EvalResult (also printed)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--workload", choices=["rnnt", "online_rnnt", "aed", "paraformer"],
                    default="rnnt")
    ap.add_argument("--mode", choices=MODES, default="rnnt_greedy")
    ap.add_argument("--split", choices=["dev", "test"], default="dev")
    ap.add_argument("--beam_size", type=int, default=4)
    ap.add_argument("--ctc_fusion_weight", type=float, default=0.0,
                    help="rnnt_beam: per-frame CTC shallow fusion weight")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--seed", type=int, default=1,
                    help="synthetic corpus seed (the trainer's pipes use 0, dev 1)")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--max_samples", type=int, default=5, help="REF/HYP pairs to print")
    add_config_args(ap)
    args = ap.parse_args(argv)

    from tpuasr_torch.device import resolve_device
    from tpuasr_torch.eval import evaluate_offline
    from tpuasr_torch.tools.common import eval_config, eval_split, restore_model

    allowed = WORKLOAD_MODES.get(args.workload, TRANSDUCER_MODES)
    if args.mode not in allowed:
        raise ValueError(f"mode {args.mode!r} does not decode the {args.workload} workload "
                         f"({', '.join(allowed)})")
    device = resolve_device(args.device)
    cfg = eval_config(args.checkpoint, args.config, args.set, device)
    tokenizer, pipe = eval_split(cfg, args.split, args.synthetic, args.seed, args.data_root)
    model = restore_model(cfg, args.workload, device, args.checkpoint)

    res = evaluate_offline(model, pipe.batches(0), cfg, tokenizer, mode=args.mode,
                           beam_size=args.beam_size, max_samples=args.max_samples,
                           ctc_fusion_weight=args.ctc_fusion_weight)
    c = res.counts
    print(f"CER {100 * c.cer:.2f}%  (S={c.substitutions} D={c.deletions} "
          f"I={c.insertions} N={c.ref_len})")
    for utt, ref, hyp in res.samples:
        print(f"  [{utt}] REF: {ref}")
        print(f"  [{utt}] HYP: {hyp}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
