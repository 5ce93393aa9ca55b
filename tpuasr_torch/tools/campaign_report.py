"""Summarize a training campaign's log into a markdown report (port of
``tools/campaign_report.py``):

    python -m tpuasr_torch.tools.campaign_report exp/campaign/log.txt [--every 1]

Parses the epoch boundary lines (``epoch N train_loss X dev_loss Y lr_scale
Z``) and the step lines (``epoch N step S loss L (A audio-s/s)``) that the
port's `train_loop` and the JAX package's write through `MetricsWriter`,
the AED workload's ``loss_att`` / ``th_accuracy`` between the loss and the
rate included, and prints the loss curve as a markdown table with the wall
seconds of each epoch, the plateau decays and the throughput at the end of
the run. Logs of a resumed campaign are read in order and the last line of
a repeated epoch is kept.
"""

from __future__ import annotations

import argparse
import re
import sys
from datetime import datetime

BOUND = re.compile(
    r"\[([\d: -]+)\] epoch (\d+) train_loss ([\d.na]+)"
    r"(?: dev_loss ([\d.na]+) lr_scale ([\d.]+))?")
STEP = re.compile(
    r"\[([\d: -]+)\] epoch (\d+) step (\d+) loss ([\d.na]+)(?: \w+ [\d.na]+)* "
    r"\(([\d.]+) audio-s/s\)")


def _time(t: str) -> datetime:
    return datetime.strptime(t, "%Y-%m-%d %H:%M:%S")


def parse(path: str) -> tuple[list[dict], list[dict]]:
    """-> (epoch boundary rows, step rows) of the log at `path`."""
    epochs, steps = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            m = BOUND.search(line)
            if m:
                t, e, tr, dv, sc = m.groups()
                epochs.append(dict(time=_time(t), epoch=int(e), train=float(tr),
                                   dev=float(dv) if dv else None,
                                   scale=float(sc) if sc else None))
                continue
            m = STEP.search(line)
            if m:
                t, e, s, loss, a = m.groups()
                steps.append(dict(time=_time(t), epoch=int(e), step=int(s), loss=float(loss),
                                  audio_sps=float(a)))
    return epochs, steps


def report(epochs: list[dict], steps: list[dict], every: int = 1) -> list[str]:
    """The markdown lines of the report."""
    last = {}
    for e in epochs:  # a resumed run replays its checkpoint's epoch: keep the last
        last[e["epoch"]] = e
    rows = [last[k] for k in sorted(last)]
    out = ["| epoch | train_loss | dev_loss | lr_scale | wall (s) |", "|---|---|---|---|---|"]
    walls = [(b["time"] - a["time"]).total_seconds() for a, b in zip(rows, rows[1:])]
    median_wall = sorted(walls)[len(walls) // 2] if walls else 0
    prev_t, decays = None, []
    for r in rows:
        wall = (r["time"] - prev_t).total_seconds() if prev_t else None
        prev_t = r["time"]
        # across a resume the gap spans the downtime, and logs out of order
        # give negatives: mark them instead of reporting a wall
        if wall is not None and (wall < 0 or wall > 5 * max(median_wall, 1)):
            wall = None
        if r["scale"] is not None and (not decays or r["scale"] < decays[-1][1]):
            decays.append((r["epoch"], r["scale"]))
        if r["epoch"] % every and r is not rows[-1]:
            continue
        dv = f'{r["dev"]:.4f}' if r["dev"] is not None else "-"
        sc = f'{r["scale"]:.4f}' if r["scale"] is not None else "-"
        w = f"{wall:.0f}" if wall is not None else "-"
        out.append(f'| {r["epoch"]} | {r["train"]:.4f} | {dv} | {sc} | {w} |')
    events = [f"epoch {e}: lr_scale -> {s:.4g}" for e, s in decays[1:]]
    if events:
        out += ["", "plateau decays: " + "; ".join(events)]
    if steps:
        tail = [s["audio_sps"] for s in steps[-8:]]
        span = (steps[-1]["time"] - steps[0]["time"]).total_seconds()
        out += ["", "throughput (cumulative audio-s/s, last windows): "
                + ", ".join(f"{x:.1f}" for x in tail),
                f"logged span: {span / 60:.1f} min over {len(last)} epochs, "
                f"final step {steps[-1]['step']}"]
    return out


def main(argv=None) -> list[str]:
    """Print the report of the logs -> its lines."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("log", nargs="+", help="log.txt path(s), concatenated in order")
    ap.add_argument("--every", type=int, default=1, help="emit every Nth epoch row")
    args = ap.parse_args(argv)
    epochs, steps = [], []
    for p in args.log:
        e, s = parse(p)
        epochs += e
        steps += s
    if not epochs:
        sys.exit("no epoch boundary lines found")
    lines = report(epochs, steps, args.every)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
