"""Fit the joint's blank bias of a served model once, with the reference
alone: the weights of `--weights-seed`, the streaming cell's audio of each
`--audio-seeds` (`--streams` streams each), the reference's chunk-masked
encoder in fp32 and its lockstep greedy search, and the bisection of
`reference.greedy.fit_blank_bias` on the pooled streams for `--target`
tokens an encoder frame. Prints the bias, and each audio seed's tokens and
emission steps an encoder frame at it; the cell's workload file keeps the
bias as `blank_bias`.

    python3 benchmark/tools/fit_blank_bias.py --workload online_rnnt.stream.s1024 \\
        --weights-seed 1 --audio-seeds 1 2 3 4 --streams 256 --target 0.24
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    import torch

    from benchmark import program, weights
    from benchmark.harness import load_json
    from benchmark.reference import greedy, stream_check, synth
    from benchmark.reference.precision import Precision

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="online_rnnt.stream.s1024")
    ap.add_argument("--weights-seed", type=int, default=1)
    ap.add_argument("--audio-seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--target", type=float, default=0.24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    p = load_json(ROOT, "benchmark", "workloads", args.workload + ".json")
    cfg = load_json(ROOT, "benchmark", "configs", p["config"] + ".json")
    feat, s = cfg["feature"], cfg["streaming"]
    w = weights.make(args.weights_seed, program.leaves_of(cfg), cfg, dev)
    encs, lens = [], []
    for seed in args.audio_seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        pool = synth.stream_waves(gen, dict(p, waves=1, streams=args.streams),
                                  cfg["model"]["vocab_size"], feat["sample_rate"])
        waves = pool["waves"][0]
        frames = 1 + waves.shape[-1] // feat["hop_length"]
        n = -(-(frames - 7 + 1) // (4 * s["chunk_size"]))
        with torch.no_grad():
            encs.append(torch.cat([stream_check.encode(w, cfg, waves[i:i + 32], n, Precision())
                                   for i in range(0, waves.shape[0], 32)]))
        lens.append(stream_check.enc_lengths(pool["lens"][0], feat["hop_length"]))
    bias, rate = greedy.fit_blank_bias(w, cfg, torch.cat(encs), torch.cat(lens), args.target,
                                       s["n_steps"], Precision())
    out = {"weights_seed": args.weights_seed, "blank_bias": bias, "rate": rate, "seeds": []}
    for seed, enc, ln in zip(args.audio_seeds, encs, lens):  # the work at the fitted bias
        tokens, steps = greedy.greedy_tokens(w, cfg, enc, ln, s["n_steps"], Precision())
        out["seeds"].append({"audio_seed": seed, "tokens_per_frame": float(tokens.sum()) /
                             float(ln.sum()), "steps_per_frame": steps / enc.shape[1]})
    print(json.dumps(out))


if __name__ == "__main__":
    sys.path[0] = ROOT
    main()
