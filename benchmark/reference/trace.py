"""The reduction of a profiler trace to the per-layer numbers: device busy
time as the union of the device's intervals (kernels, copies, sets), the
idle time split by the benchmark's host spans it falls in (timed by the
harness and put on the trace's clock), and device
time by kernel family (`kernel_family`: a frozen copy of the port's
profiling tool's naming)."""

from __future__ import annotations

import collections
import json
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_family(name: str) -> str:
    """`(anonymous namespace)::fbank_tc_kernel<5, 1, 4>(...)` -> fbank_tc_kernel."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def union(intervals: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def load(path: str) -> dict:
    """A Chrome trace -> {"device": [(family, start_us, end_us)], "spans": []};
    the caller adds the benchmark's host spans, (name, start_us, end_us) on
    the trace's clock."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [(kernel_family(e["name"]), float(e.get("ts", 0.0)),
            float(e.get("ts", 0.0)) + float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    return {"device": dev, "spans": []}


def reduce(tr: dict, top: int = 10) -> dict | None:
    """-> {"window_s", "busy_s", "families": {family: [s, events]},
    "device_ops": top families, "idle_gaps": idle seconds by the span the
    host was in}; the window runs from the first span's start to the last
    span's or device interval's end. None without device events or spans."""
    if not tr["device"] or not tr["spans"]:
        return None
    tr = dict(tr, spans=sorted(tr["spans"], key=lambda s: s[1]))
    t0 = tr["spans"][0][1]
    t1 = max(max(e for _, _, e in tr["device"]), max(e for _, _, e in tr["spans"]))
    busy = union([[max(s, t0), min(e, t1)] for _, s, e in tr["device"] if e > t0 and s < t1])
    fam = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in tr["device"]:
        fam[name][0] += (e - s) / 1e6
        fam[name][1] += 1
    idle = collections.Counter()
    prev = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            _split_gap(idle, tr["spans"], prev, s)
        prev = max(prev, e)
    ops = sorted(fam.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": sum(e - s for s, e in busy) / 1e6,
            "families": {k: v for k, v in fam.items()},
            "device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}


def _split_gap(idle, spans: list, g0: float, g1: float) -> None:
    """Add the idle interval [g0, g1) to `idle` by the benchmark spans it
    overlaps (they follow one another), the rest under "none"."""
    covered = 0.0
    for name, s, e in spans:
        if s >= g1:
            break
        o = min(e, g1) - max(s, g0)
        if o > 0:
            idle[name] += o / 1e6
            covered += o
    if g1 - g0 - covered > 0:
        idle["none"] += (g1 - g0 - covered) / 1e6
