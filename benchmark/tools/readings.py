"""The readings that a cell's limits are set from: for each seed, the
numbers that decide `correct` read from the program as the cell runs it,
from the control (the reference in the next lower precision in the
program's place) and, for a training cell, from the program with half of
each batch left out (the mean taken over the rest). One process, the
cell's own sizes:

    python3 benchmark/tools/readings.py --workload online_rnnt.train.b128 --seeds 1 2 3
    python3 benchmark/tools/readings.py --workload online_rnnt.stream.s1024 --seeds 1 2 3

Prints one JSON line a seed. A state left unchanged reads 1 on a training
cell's `grad` and `change` by their measure and needs no run. The program
runs with the backend flags it sets itself (`--cudnn-tf32 off` turns
cuDNN's TF32 off for it, a second witness); the reference turns TF32 off
around its own computation.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


@contextlib.contextmanager
def half_batch():
    """The training step given the first half of each batch's rows."""
    import tpuasr_torch.train as train

    make = train.make_train_step

    def faulty(*a, **k):
        step = make(*a, **k)
        return lambda state, batch, seed: step(
            state, {n: v[:v.shape[0] // 2] for n, v in batch.items()}, seed)

    train.make_train_step = faulty
    try:
        yield
    finally:
        train.make_train_step = make


def cell_of(workload: str, seed: int, device):
    from benchmark import harness

    root = harness.ROOT
    man = harness.load_json(root, "BENCHMARK.json")
    cell = {w["name"]: w for w in man["workloads"]}[workload]
    params = harness.load_json(root, "benchmark", "workloads", workload + ".json")
    config = harness.load_json(root, "benchmark", "configs", cell["config"] + ".json")
    h = harness.Harness(man, cell, params, config, seed, 0.0, False, device)
    return harness.load_module("traffic", cell["traffic"]).Cell(h), config


def train_readings(workload: str, seed: int, device, look: bool = False) -> dict:
    """{side: its numbers} for the program, half the batch and the control;
    with `look`, also each side's worst leaves (`grad`, `change`)."""
    from benchmark import weights
    from benchmark.reference import train_check
    from benchmark.reference.precision import Precision

    sides = {}
    for name, patch in (("program", contextlib.nullcontext), ("half_batch", half_batch)):
        with patch():
            c, config = cell_of(workload, seed, device)
            c.setup()
        c.release()
        w = weights.make(seed, c.leaves, config, device)
        sides[name] = train_check.program_side(c.losses, c.mu1, c.p3, w, config["optim"])
        batches, leaves, rows = c.batches, c.leaves, c.p["ref_rows"]
        del c
    w = weights.make(seed, leaves, config, device)
    ref = train_check.follow(config, w, batches, seed, Precision("fp32"), rows)
    dtype = config["modes"]["train"]["model.compute_dtype"]
    sides["control"] = train_check.follow(config, w, batches, seed, Precision(CONTROL[dtype]),
                                          rows)
    out = {k: train_check.compare(v, ref) for k, v in sides.items()}
    if look:  # (leaf, its gap, its reference norm over the median leaf's)
        for n, names in (("grad", list(ref["grad"])), ("change", train_check.moved(ref))):
            norm = {k: float(ref[n][k].double().norm()) for k in names}
            med = sorted(norm.values())[len(norm) // 2]
            for k, v in sides.items():
                gaps = train_check.leaf_gaps(v[n], ref[n], names)
                out[k].setdefault("worst", {})[n] = [
                    (leaf, g, norm[leaf] / med)
                    for leaf, g in sorted(gaps.items(), key=lambda kv: -kv[1])[:3]]
    return out


def stream_readings(workload: str, seed: int, device) -> dict:
    c, config = cell_of(workload, seed, device)
    c.setup()
    rate = c.rate()
    c.release()
    dtype = config["modes"]["serve"]["model.compute_dtype"]
    r = c.readings(controls=(CONTROL[dtype],))
    return {"program": {"gap": r["gap"]}, "control": {"gap": r["ctl"][0]},
            "tokens_per_frame": rate}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cudnn-tf32", choices=("default", "off"), default="default",
                    help="off: the program's cuDNN convolutions without TF32 (a witness)")
    ap.add_argument("--look", action="store_true", help="print each side's worst leaves")
    args = ap.parse_args(argv)
    if args.cudnn_tf32 == "off":
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    from benchmark.harness import load_json

    kind = {w["name"]: w for w in load_json(ROOT, "BENCHMARK.json")["workloads"]}[args.workload]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = (train_readings(args.workload, seed, dev, args.look) if kind["traffic"] == "train"
               else stream_readings(args.workload, seed, dev))
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t0, **out}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.path[0] = ROOT
    main()
