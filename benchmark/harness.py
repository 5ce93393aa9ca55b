"""The benchmark's runner: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell is found by name: the cell's entry in
`BENCHMARK.json`, its parameters in `benchmark/workloads/<cell>.json`, its
configuration in `benchmark/configs/<config>.json`, its traffic kind in
`benchmark/traffic/<kind>.py`, each per-layer metric in
`benchmark/metrics/<metric>.py`, each hand kernel's work in
`benchmark/kernels/<entry>.py` and the configuration's FLOP count in
`benchmark/flops/<config>.py`. A traffic kind is a `Cell` class with
`setup`, `window`, `traced`, `release` and `check`; `run` calls them in
that order, times set-up, reads the device's peak memory once the window
has closed and before the check, and prints one JSON line.

With `--trace 1` a bounded part after the window (the cell's `traced`
units) runs under torch.profiler, the card's activity alone; its trace is
written under TMPDIR, reduced in memory and deleted. The program runs with
the backend flags it sets itself; the reference turns TF32 off around its
own computation (`reference.precision.exact`).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpuasr")
PEAKS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12, "hbm": 3.35e12}


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of its own (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def launches() -> dict:
    from tpuasr_torch.ops import LAUNCHES

    return dict(LAUNCHES)


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


class Harness:
    """What a traffic kind's Cell is given: the run's arguments, the cell's
    parameters and configuration, the device."""

    def __init__(self, manifest: dict, cell: dict, params: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device):
        self.manifest, self.cell, self.params, self.config = manifest, cell, params, config
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.flops = load_module("flops", cell["config"])
        self.spans = None  # while a part is profiled: its host spans, [(name, start, end)]

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the benchmark's own, timed on the host's clock (s)
        while a part is profiled."""
        if self.spans is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))


def profile(fn, h: Harness):
    """Run fn() under torch.profiler -> (fn's result, the reduced trace or
    None: on the CPU, or when the trace holds no device work).

    The profiler records the card's activity alone: recording the host's
    operators as well slowed a training step 2-3 fold, and the device's
    idle share with it. The benchmark's spans are timed on the host's clock
    (`Harness.span`) and put on the trace's by one anchor, the return of the
    synchronize after fn(), which follows the last device interval by
    microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    from benchmark.reference import trace as tr

    if not torch.cuda.is_available():
        return fn(), None
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    h.spans = []
    try:
        with _profile(activities=[ProfilerActivity.CUDA]) as prof:
            # 50 ms of idle host on each side: a trace loses kernels that run
            # at the very edges of its window (the port's profiling tool saw
            # a step's first kernels go missing without them)
            torch.cuda.synchronize()
            time.sleep(0.05)
            out = fn()
            torch.cuda.synchronize()
            anchor = time.perf_counter()
            time.sleep(0.05)
        spans, h.spans = h.spans, None
        prof.export_chrome_trace(path)
        trace = tr.load(path)
        if not trace["device"] or not spans:
            return out, None
        shift = max(e for _, _, e in trace["device"]) - 1e6 * anchor
        trace["spans"] = [(n, 1e6 * s + shift, 1e6 * e + shift) for n, s, e in spans]
        return out, tr.reduce(trace)
    finally:
        h.spans = None
        os.unlink(path)


def kernel_bound(units: list, reduced: dict | None, peaks: dict, log) -> dict | None:
    """Σ over the traced units' hand-kernel launches of each launch's bound
    (max(ops / peak, bytes / HBM), from benchmark/kernels/<entry>.py) and Σ
    of those kernels' device time in the trace; None where a launched kernel
    has no work file, or the trace holds fewer of its events than it was
    launched."""
    from tpuasr_torch.ops import KERNELS

    if reduced is None:
        return None
    bound, counts, files = 0.0, {}, {}
    for ctx, delta in units:
        for entry, n in delta.items():
            if entry not in KERNELS:
                continue  # a route's own counter
            if entry not in files:
                path = os.path.join(HERE, "kernels", entry + ".py")
                if not os.path.exists(path):
                    log(f"kernel_roofline: no work file for {entry}")
                    return None
                files[entry] = load_module("kernels", entry)
            k = files[entry]
            bound += n * k.bound_s(k.shape(ctx), peaks)
            counts[entry] = counts.get(entry, 0) + n
    if not counts:
        return None
    fam = reduced["families"]
    device = 0.0
    for entry, n in counts.items():
        ev = sum(fam.get(f, [0.0, 0])[1] for f in files[entry].EVENTS)
        if ev < n:
            log(f"kernel_roofline: {entry} launched {n} times, {ev} events in the trace")
            return None
        device += sum(fam.get(f, [0.0, 0])[0] for f in files[entry].EVENTS)
    return {"bound_s": bound, "device_s": device, "launches": counts}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def metric_entries(manifest: dict, cell: str, section: str) -> list:
    """The metrics of `section` that `cell` reports: those whose `workloads`
    name it, or, without the key, those of every cell that reports the
    end-to-end metric they move (per-layer) / every cell (end-to-end)."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def reports(m):
        return "workloads" not in m or cell in m["workloads"]

    if section == "end_to_end":
        return [m for m in manifest["end_to_end"] if reports(m)]
    return [m for m in manifest["per_layer"]
            if reports(m) and ("workloads" in m or reports(e2e[m["moves"]]))]


def run(argv=None, require_cuda: bool = True, device=None) -> dict | None:
    """One run -> the result's dict (None where no result may be printed);
    `require_cuda=False` and a `device` run it elsewhere (the CPU tests)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)

    manifest = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}")
        return None
    cell = cells[args.workload]
    params = load_json(ROOT, "benchmark", "workloads", args.workload + ".json")
    config = load_json(ROOT, "benchmark", "configs", cell["config"] + ".json")
    if params["config"] != cell["config"] or params["traffic"] != cell["traffic"]:
        log(f"{args.workload}: its file names {params['config']}/{params['traffic']}, "
            f"BENCHMARK.json {cell['config']}/{cell['traffic']}")
        return None

    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() = "
                f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}")
            return None
        device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
    device = torch.device(device or "cpu")

    h = Harness(manifest, cell, params, config, args.seed, args.seconds, bool(args.trace),
                device)
    kind = load_module("traffic", cell["traffic"])
    c = kind.Cell(h)
    c.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = process_age()
    e2e, record = c.window(args.seconds)
    layer = {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                "count": cell["chips"]}
    breakdown = None
    if args.trace:
        t0 = time.perf_counter()
        units, reduced = profile(c.traced, h)
        log(f"traced part: {len(units)} units, {time.perf_counter() - t0:.3f} s with the "
            f"profiler's start and export, traced window "
            f"{reduced['window_s'] if reduced else None} s")
        record["trace"] = reduced
        record["kernels"] = kernel_bound(units, reduced, PEAKS, log)
        if reduced is not None:
            dev_info["busy_s"] = reduced["busy_s"]
            dev_info["window_s"] = reduced["window_s"]
            breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
        for m in metric_entries(manifest, args.workload, "per_layer"):
            value = load_module("metrics", m["name"]).read(record)
            if value is not None:
                layer[m["name"]] = {"value": value, "unit": m["unit"]}
        if record.get("kernels"):
            log(f"kernel launches in the traced window: {record['kernels']['launches']}")
    dev_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0)
    log(f"card: {power_limit() if device.type == 'cuda' else 'cpu'}")
    c.release()
    checks, correct = [], False
    try:
        checks = c.check()
        correct = all(v <= lim for _, v, lim in checks) and bool(checks)
    except Exception:  # a check that cannot finish is a run that is not correct
        log(traceback.format_exc())
    e2e["setup_s"] = setup_s
    if args.trace:
        metrics = layer
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metric_entries(manifest, args.workload, "end_to_end")
                   if m["name"] in e2e}
    found = forbidden_modules()
    if found:
        log(f"modules of the JAX package or JAX are loaded: {found}")
        return None
    result = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    for k, v in record.get("notes", {}).items():
        log(f"{k}: {v}")
    for name, v, lim in checks:
        log(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    return result


def main(argv=None) -> int:
    result = run(argv)
    if result is None:
        return 2
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0

