"""Predict multi-host scaling efficiency from the collectives the port's
train step issues (port of ``tools/scaling_predict.py``).

The JAX tool compiles the sharded step over a virtual (hosts x chips)
device mesh and reads the collectives out of XLA's HLO. Here the step runs
for real on chips x hosts ranks (torch.distributed over gloo: on the CPU by
default, on CUDA tensors with `--device cuda`), one step a layout, and rank
0 records every collective it issues (`tpuasr_torch.parallel.scaling.
record_collectives`: op, payload bytes, the group's ranks). The records are
costed with the ring / hierarchical model of `parallel.scaling` over NVLink
inside a host and the hosts' NICs, extrapolated to `--hosts-extrapolate`
hosts (rank r on host r // chips). Only the link speeds are assumptions:
`--nvlink-gbps` (default 450 GB/s a GPU one way, NVLink 4) and `--nic-gbps`
(default 400 GB/s a host, a DGX H100's 8 x 400 Gb/s NICs).

    python -m tpuasr_torch.tools.scaling_predict --chips 4 --hosts 2 \\
        [--layouts dp zero1 zero3 dptp] [--hosts-extrapolate 2 4 8] \\
        [--compute-ms MS] [--batch-per-device 12] [--frames 768] [--tokens 40] \\
        [--device cpu|cuda] [--set model.encoder.num_blocks=2 ...] [--json]

The model is the JAX tool's: the flagship transducer in bf16, causal, with
dynamic chunks (static 32), `--set` pairs on top. Layouts: dp (ZeRO "none"),
zero1, zero3 (over every rank), dptp (mesh.model_parallel_size 2 with
`model.shard_joint`). `--compute-ms` is the one-device step the efficiency
divides by; without it rank 0 times a step of the same batch on one rank
(no mesh, after a warm-up step; the device is named beside it, and a CPU
time is no device figure). Every rank of a card run shares cuda:0 when
the machine has fewer cards than ranks (gloo: NCCL refuses two ranks on one
card). The full-width model needs the card: on the CPU pass a cut
`--set` (a few blocks, narrow widths).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

LAYOUTS = ("dp", "zero1", "zero3", "dptp")
WAIT_S = 1800  # every rank's whole run
PG_TIMEOUT_S = 600


def layout_config(base, layout: str):
    """A copy of `base` set up for `layout` -> (cfg, zero stage, model ranks)."""
    import copy

    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    cfg = copy.deepcopy(base)
    mp = 2 if layout == "dptp" else 1
    cfg.model.shard_joint = layout == "dptp"
    cfg.mesh.model_parallel_size = mp
    cfg.mesh.zero_stage = layout if layout in ("zero1", "zero3") else "none"
    return cfg, cfg.mesh.zero_stage, mp


def base_config(sets=()):
    """The JAX tool's model (the flagship in bf16, causal, dynamic chunks,
    static chunk 32) with the dotted `sets` on top."""
    from tpuasr_torch.config import Config, override, resolve
    from tpuasr_torch.tools.train import parse_overrides

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.encoder.causal = True
    cfg.model.encoder.use_dynamic_chunk = True
    cfg.model.encoder.static_chunk_size = 32
    return resolve(override(cfg, parse_overrides(sets)))


def local_batch(cfg, rows: int, frames: int, tokens: int, device, seed: int = 0) -> dict:
    """One rank's rows: seeded noise of `frames` hops, `tokens` labels."""
    import numpy as np
    import torch

    samples = frames * cfg.feature.hop_length
    rng = np.random.default_rng(seed)
    return {"waves": torch.from_numpy((0.1 * rng.standard_normal((rows, samples)))
                                      .astype(np.float32)).to(device),
            "wave_lens": torch.full((rows,), samples, dtype=torch.int32, device=device),
            "texts": torch.full((rows, tokens), 7, dtype=torch.int32, device=device),
            "text_lens": torch.full((rows,), tokens, dtype=torch.int32, device=device)}


def _step(cfg, device, stage: str, mesh=None):
    """A seeded model's train state in `stage`'s layout and its step."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.parallel import shard_train_state
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    model = init_weights(Transducer(cfg.model, device=device), 0)
    tx = make_optimizer(cfg.optim)
    state = TrainState.create(model, tx)
    if mesh is not None:
        state = shard_train_state(state, mesh, stage)
    return state, make_train_step(model, tx, cfg, mesh)


def record_layout(base, layout: str, device, rows: int, frames: int, tokens: int) -> list:
    """One real train step of `layout` on this rank (every rank of the
    process group calls it alike) -> the collectives this rank issued."""
    from tpuasr_torch.parallel import make_mesh, record_collectives

    cfg, stage, mp = layout_config(base, layout)
    mesh = make_mesh(mp, device)
    state, step = _step(cfg, device, stage, mesh)
    batch = local_batch(cfg, rows, frames, tokens, device, seed=mesh.data_rank)
    with record_collectives() as got:
        step(state, batch, 1)
    return got


def time_one_rank(base, device, rows: int, frames: int, tokens: int, n: int = 3) -> float:
    """The median wall (ms, synced) of `n` steps of `base` on one rank with
    no mesh, after a warm-up step."""
    import statistics

    import torch

    state, step = _step(base, device, "none")
    batch = local_batch(base, rows, frames, tokens, device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    state, _ = step(state, batch, 0)
    walls = []
    for i in range(n):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch, i + 1)
        float(m["loss"])
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def prediction_rows(colls: list, chips: int, hosts: int, hosts_extrapolate, compute_ms: float,
                    nvlink_gbps: float, nic_gbps: float) -> list[dict]:
    """`predict` of the recorded (chips x hosts) layout's collectives at each
    extrapolated host count."""
    from tpuasr_torch.parallel.scaling import predict, rescale_for_hosts

    return [predict(rescale_for_hosts(colls, chips, hosts, h), chips, h, compute_ms,
                    nvlink_gbps, nic_gbps) for h in hosts_extrapolate]


def table(results: dict, compute_ms: float, timed_on: str, nvlink_gbps: float,
          nic_gbps: float) -> str:
    """The JAX tool's table: per layout, per host count, the ICI (NVLink)
    and DCN (NIC) megabytes and milliseconds a step and the efficiency with
    no overlap and with full overlap."""
    lines = [f"compute = {compute_ms:.3f} ms/step ({timed_on}); ICI = NVLink "
             f"{nvlink_gbps} GB/s/GPU, DCN = NICs {nic_gbps} GB/s/host (both assumptions)"]
    for layout, r in results.items():
        lines.append(f"\n== {layout} ({r['n_collectives']} collectives: "
                     f"{', '.join(r['ops'])}) ==")
        lines.append(f"{'hosts':>6} {'ICI MB':>8} {'DCN MB':>8} {'t_ici ms':>9} "
                     f"{'t_dcn ms':>9} {'eff(no-ovl)':>12} {'eff(ovl)':>9}")
        for row in r["rows"]:
            lines.append(f"{row['hosts']:>6} {row['ici_mb']:>8.2f} {row['dcn_mb']:>8.2f} "
                         f"{row['t_ici_ms']:>9.3f} {row['t_dcn_ms']:>9.3f} "
                         f"{row['eff_no_overlap']:>12.1%} {row['eff_full_overlap']:>9.1%}")
    return "\n".join(lines)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chips", type=int, default=4, help="GPUs a host")
    ap.add_argument("--hosts", type=int, default=2, help="hosts of the recorded layout")
    ap.add_argument("--layouts", nargs="*", default=list(LAYOUTS), choices=LAYOUTS)
    ap.add_argument("--hosts-extrapolate", type=int, nargs="*", default=[2, 4, 8])
    ap.add_argument("--compute-ms", type=float, default=None,
                    help="the one-device step (default: timed on rank 0)")
    ap.add_argument("--batch-per-device", type=int, default=12)
    ap.add_argument("--frames", type=int, default=768)
    ap.add_argument("--tokens", type=int, default=40)
    ap.add_argument("--nvlink-gbps", type=float, default=None,
                    help="GB/s a GPU one way inside a host (default: NVLink 4's 450)")
    ap.add_argument("--nic-gbps", type=float, default=None,
                    help="GB/s a host across hosts (default: 8 x 400 Gb/s, 400)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--set", nargs="*", default=[], help="dotted config overrides k=v")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap


def _rank_main(args) -> None:
    """One rank: every layout's recorded step; rank 0 also times the
    one-rank step (the others wait) and writes the results."""
    import torch

    from tpuasr_torch.parallel import init_distributed
    from tpuasr_torch.parallel.mesh import barrier

    world = args.chips * args.hosts
    backend = device = None
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        device = f"cuda:{args.rank % cards}"
        backend = "gloo" if cards < world else "nccl"
    else:
        device = "cpu"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _, rank, dev = init_distributed(device, store_path=os.path.join(args.store, "store"),
                                    rank=args.rank, world_size=world, backend=backend,
                                    timeout_s=PG_TIMEOUT_S)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    base = base_config(args.set)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "layouts": {}}
    for layout in args.layouts:
        got = record_layout(base, layout, dev, args.batch_per_device, args.frames, args.tokens)
        out["layouts"][layout] = [(c.op, c.payload, c.groups) for c in got]
    if rank == 0 and args.compute_ms is None:
        out["compute_ms"] = time_one_rank(base, dev, args.batch_per_device, args.frames,
                                          args.tokens)
    barrier()
    if rank == 0:
        Path(args.store, "rank0.json").write_text(json.dumps(out))
    barrier()
    torch.distributed.destroy_process_group()


def _launch(args, argv: list[str]) -> dict:
    """Start chips x hosts ranks of this tool, wait for all (at most WAIT_S;
    a failed rank stops the others) -> rank 0's results."""
    world = args.chips * args.hosts
    with tempfile.TemporaryDirectory(prefix="scaling-") as store:
        procs = [subprocess.Popen([sys.executable, "-m", "tpuasr_torch.tools.scaling_predict",
                                   *argv, "--rank", str(r), "--store", store],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        deadline = time.monotonic() + WAIT_S
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            logs = [p.communicate()[0] for p in procs]
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n"
                                   f"{logs[r][-4000:]}")
        return json.loads(Path(store, "rank0.json").read_text())


def main(argv=None) -> dict:
    """Run the ranks and print the table -> {layout: its rows}."""
    from tpuasr_torch.parallel.scaling import NIC_GBPS, NVLINK_GBPS, Collective

    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return {}
    nvlink = NVLINK_GBPS if args.nvlink_gbps is None else args.nvlink_gbps
    nic = NIC_GBPS if args.nic_gbps is None else args.nic_gbps
    res = _launch(args, argv)
    compute_ms = args.compute_ms if args.compute_ms is not None else res["compute_ms"]
    timed_on = ("given" if args.compute_ms is not None
                else f"measured on one rank, {res['device']}")
    results = {}
    for layout, rec in res["layouts"].items():
        colls = [Collective(op, payload, groups) for op, payload, groups in rec]
        results[layout] = {
            "n_collectives": len(colls), "ops": sorted({c.op for c in colls}),
            "payload_bytes": sum(c.payload for c in colls),
            "rows": prediction_rows(colls, args.chips, args.hosts, args.hosts_extrapolate,
                                    compute_ms, nvlink, nic)}
    if args.json:
        print(json.dumps({"compute_ms": compute_ms, "timed_on": timed_on,
                          "nvlink_gbps": nvlink, "nic_gbps": nic, "layouts": results},
                         indent=1))
    else:
        print(table(results, compute_ms, timed_on, nvlink, nic))
    return results


if __name__ == "__main__":
    main()
