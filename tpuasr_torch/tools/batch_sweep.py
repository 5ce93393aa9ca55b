"""The flagship's training step at several batch sizes, at one utterance
shape (port of ``tools/batch_sweep.py``):

    python -m tpuasr_torch.tools.batch_sweep --frames 256 --tokens 14 --batches 12 24 48 \\
        [--steps 30] [--sample_rate 48000] [--set k=v ...] [--device cuda|cpu]

For each batch size `train_bench` builds the Transducer with seeded weights
and the step `make_train_step` builds, at the trainer's fast path on the
card (bf16, the fused joint loss, the rel-pos attention kernels, fbank
precision "default", causal, dynamic chunks, static chunk 32), places
random waves and labels on the device (the copy is not timed: the loop
overlaps it with `prefetch_to_device`), runs one step (the first: kernel
builds and the allocator's warm-up, printed as "first"), then `--steps`
steps, each synced, and one step under torch.profiler; it prints the
median ms a step, audio-s/s and the profiled step's device busy ms, then
each batch's throughput against the first one's. The JAX tool dispatches
its steps back to back and syncs once; a synced step's median is what
chip_smoke.py's phases 6b-6d read through the same `train_bench`. The JAX
tool's compilation cache has no counterpart.
"""

from __future__ import annotations

import argparse
import re
import sys

from tpuasr_torch.tools.profile_trace import (
    bench_cfg, profiled_step, synced_ms, train_setup,
)

# the port's own kernels, by the names of csrc/*.cu (anonymous namespaces)
OWN_KERNEL = re.compile(r"\(anonymous namespace\)::((?:fbank|relpos|rnnt|ctc|ffn)_\w+)")


def fast_path_cfg(sample_rate: int = 48000, sets=()):
    """tools/train.py's card defaults (bf16, the fused joint loss, the
    attention kernels, fbank "default"), causal with dynamic chunks and a
    static chunk of 32, at `sample_rate`; the dotted `sets` on top."""
    return bench_cfg(True, [f"feature.sample_rate={sample_rate}", *sets])


def random_batch(cfg, b: int, frames: int, tokens: int, rng, device) -> dict:
    """`b` random waves of (frames - 1) * hop samples (0.1 x N(0, 1)) and
    `tokens` random labels each, full length, on `device`."""
    import numpy as np
    import torch

    n = (frames - 1) * cfg.feature.hop_length
    host = {"waves": (rng.standard_normal((b, n)) * 0.1).astype(np.float32),
            "wave_lens": np.full(b, n, np.int32),
            "texts": rng.integers(6, cfg.model.vocab_size, (b, tokens)).astype(np.int32),
            "text_lens": np.full(b, tokens, np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def train_bench(cfg, batch: dict, device, n_steps: int = 10, warmup: int = 2,
                seed: int = 0) -> dict:
    """`warmup` + `n_steps` steps of `cfg`'s Transducer (seeded weights)
    on `batch`, each synced, then one profiled step (`profiled_step`); ->
    {"losses", "finite", "step_ms" (the timed steps'), "step_ms_median",
    "warmup_ms", "audio_seconds_per_step", "audio_s_per_s",
    "max_memory_allocated" (None off the card), "launches" (what the kernel
    wrappers' counts grew by over the timed and warm-up steps),
    "profiled_step_wall_ms",
    "profiled_step_device_busy_ms", "profiled_step_device_ops",
    "top_device_items" (the ten largest: [name, count, ms]),
    "port_kernels" ({the port's kernel: [ms, launches]} in the profiled
    step), "state"}."""
    import torch

    from tpuasr_torch.ops import LAUNCHES

    state, step = train_setup(cfg, device, seed)
    audio_s = float(batch["wave_lens"].sum()) / cfg.feature.sample_rate
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    losses, finite, ms = [], [], []
    for _ in range(warmup + n_steps):
        (state, metrics), dt = synced_ms(device, lambda: step(state, batch, seed))
        finite.append(bool(metrics["finite"]))
        losses.append(float(metrics["loss"]))
        ms.append(dt)
    warm, ms = ms[:warmup], ms[warmup:]
    launches = {k: n - before[k] for k, n in LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    state, busy, wall, kern = profiled_step(step, state, batch, seed)
    own = {}  # name -> [ms, launches], template instances summed
    for e in kern:
        m = OWN_KERNEL.search(e.key)
        if m:
            tot = own.setdefault(m.group(1), [0.0, 0])
            tot[0] += e.self_device_time_total / 1e3
            tot[1] += e.count
    med = sorted(ms)[len(ms) // 2]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    return {"losses": losses, "finite": finite, "step_ms": ms, "step_ms_median": med,
            "warmup_ms": warm, "audio_seconds_per_step": audio_s,
            "audio_s_per_s": audio_s / med * 1e3,
            "max_memory_allocated": peak, "launches": launches,
            "profiled_step_wall_ms": wall, "profiled_step_device_busy_ms": busy,
            "profiled_step_device_ops": sum(e.count for e in kern),
            "top_device_items": [[e.key, e.count, e.self_device_time_total / 1e3]
                                 for e in top],
            "port_kernels": own, "state": state}


def main(argv=None) -> list[dict]:
    """Sweep -> one result a batch size (also printed): {"batch", "ms" (the
    median), "audio_s_per_s", "first_s", "loss" (the last timed step's),
    "device_busy_ms"}."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=256,
                    help="padded feature frames an utterance (the campaign's bucket: 256; "
                         "bench.py's shape: 768)")
    ap.add_argument("--tokens", type=int, default=14)
    ap.add_argument("--batches", type=int, nargs="*", default=[12, 24, 48])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--sample_rate", type=int, default=48000)
    ap.add_argument("--set", nargs="*", default=[], help="dotted overrides k=v")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from tpuasr_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = fast_path_cfg(args.sample_rate, args.set)
    rng = np.random.default_rng(0)
    results = []
    for b in args.batches:
        batch = random_batch(cfg, b, args.frames, args.tokens, rng, device)
        t = train_bench(cfg, batch, device, n_steps=args.steps, warmup=1)
        r = {"batch": b, "ms": t["step_ms_median"], "audio_s_per_s": t["audio_s_per_s"],
             "first_s": t["warmup_ms"][0] / 1e3, "loss": t["losses"][-1],
             "device_busy_ms": t["profiled_step_device_busy_ms"]}
        results.append(r)
        print(f"B={b:3d}: {r['ms']:8.2f} ms/step  {r['audio_s_per_s']:9.1f} audio-s/s "
              f"(first step {r['first_s']:.1f}s, {b * args.frames} frames/step; device busy "
              f"{r['device_busy_ms']:.2f} ms of a profiled step)", flush=True)
    base = results[0]
    for r in results[1:]:
        print(f"B={r['batch']} vs B={base['batch']}: "
              f"{r['audio_s_per_s'] / base['audio_s_per_s']:.2f}x throughput "
              f"({r['ms'] / base['ms']:.2f}x step time for "
              f"{r['batch'] / base['batch']:.0f}x batch)")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
