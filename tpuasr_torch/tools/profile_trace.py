"""A `torch.profiler` trace of N flagship training steps (port of
``tools/profile_trace.py``), written as a Chrome trace (open it in
chrome://tracing or Perfetto), then the device time a step and the top
kernel families read back from that file:

    python -m tpuasr_torch.tools.profile_trace [--out exp/trace] [--steps 5] [--fused] \\
        [--batch 12] [--frames 768] [--set k=v ...] [--device cuda|cpu]

The step is `make_train_step` at bench.py's configuration (48 kHz, bf16,
causal, dynamic chunks, static chunk 32) on bench.py's batch (`bench_batch`:
12 utterances of 24-30 tokens, 768 frames); --fused turns on the rel-pos
attention kernels, the fused joint loss and fbank precision "default", as
bench.py runs. One warm-up step runs under the profiler before the N
recorded ones. The JAX tool's XLA-only flags are dropped: --scan and
--scan_unroll (the port's encoder is never scanned), --hlo (no compiled
program to dump) and --no_donate (no buffer donation in PyTorch).

`profiled_step` (one step's device busy ms from the profiler's own
averages) and `bench_batch` are the helpers that chip_smoke.py uses too.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def synced_ms(device, fn):
    """(fn(), host ms) with the device drained before and after."""
    import torch

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def bench_cfg(fused: bool, sets=()):
    """bench.py's configuration (bench.py:51-76): 48 kHz, bf16, causal,
    dynamic chunks, static chunk 32; `fused`: the attention kernels, the
    fused joint loss and fbank precision "default"; the dotted `sets` on
    top."""
    from tpuasr_torch.config import Config, override
    from tpuasr_torch.tools.train import parse_overrides

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    enc = cfg.model.encoder
    enc.causal, enc.use_dynamic_chunk, enc.static_chunk_size = True, True, 32
    cfg.model.fused_joint_loss = enc.fused_attention = fused
    if fused:
        cfg.feature.fbank_precision = "default"
    return override(cfg, parse_overrides(sets))


def bench_batch(cfg, device, batch: int = 12, frames: int = 768, tokens: int = 32) -> dict:
    """bench.py's batch (bench.py:83-90) through the port's `synth_corpus`
    and `make_batch`: `batch` utterances of 24-30 content tokens plus SOS
    and EOS, (frames - 6) * hop // 30 samples a token, padded to
    (frames - 1) * hop samples and `tokens` labels; as tensors on
    `device`."""
    from tpuasr_torch.data import BatchSpec, make_batch, synth_corpus, tensors

    hop = cfg.feature.hop_length
    utts = synth_corpus(batch, cfg.model.vocab_size, seed=0, min_tokens=24, max_tokens=30,
                        sample_rate=cfg.feature.sample_rate,
                        samples_per_token=(frames - 6) * hop // 30)
    return tensors(make_batch(utts, BatchSpec(batch, (frames - 1) * hop, tokens)), device)


def train_setup(cfg, device, seed: int = 0):
    """-> (TrainState, the step) of the Transducer of `cfg` with seeded
    weights on `device`."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    model = init_weights(Transducer(cfg.model, device=device), seed)
    tx = make_optimizer(cfg.optim)
    return TrainState.create(model, tx), make_train_step(model, tx, cfg)


def profiled_step(step, state, batch, seed: int = 0) -> tuple:
    """One training step under torch.profiler; -> (state, the device's busy
    ms, the step's wall ms, the device items of `key_averages`). One step
    under the profiler's warm-up (traced, not kept), then the profiled step
    with 50 ms of idle host on each side: the trace drops kernels that run
    near the edges of its window (a window opened just before a step lost
    the step's first kernels, fbank's, more often than not; with the
    warm-up alone it still lost the first or the last ones now and then;
    with the gaps as well, never in the trials)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    device = state.model.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for i in range(2):
            time.sleep(0.05 * i)
            (state, _), wall = synced_ms(device, lambda: step(state, batch, seed))
            time.sleep(0.05 * i)
            prof.step()
    # the schedule's step marker also shows on the device's timeline: not a kernel
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
    return state, sum(e.self_device_time_total for e in kern) / 1e3, wall, kern


def trace_steps(step, state, batch, n_steps: int, path: str, seed: int = 0):
    """Run one warm-up step and `n_steps` recorded steps under
    torch.profiler, the Chrome trace written to `path`; -> (state, the
    recorded steps' host ms, dispatched back to back and synced once at the
    end). The window closes 50 ms after the device drained, and opens 50 ms
    after the warm-up (`profiled_step`'s margins)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    device = state.model.device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=n_steps, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        (state, _), _ = synced_ms(device, lambda: step(state, batch, seed))
        prof.step()
        time.sleep(0.05)
        t0 = time.perf_counter()
        for i in range(n_steps):
            state, _ = step(state, batch, seed)
            if i < n_steps - 1:
                prof.step()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.05)
        prof.step()
    return state, ms


def kernel_family(name: str) -> str:
    """A device event's name without its namespace wrapper, return type,
    template arguments and parameters: `(anonymous namespace)::
    fbank_tc_kernel<5, 1, 4>(...)` -> fbank_tc_kernel."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def report_device_time(trace_path: str, n_steps: int, audio_s_per_step: float, out=None):
    """Parse the Chrome trace at `trace_path` and print the device time a
    step (the sum of its kernel, copy and set events over `n_steps`) and
    the top kernel families by device time, as the JAX tool reads its XLA
    trace; -> {"ms_per_step", "audio_s_per_s", "families": {family: [ms a
    step, launches a step]}}, or None when the trace holds no device event
    (a CPU run)."""
    out = out or sys.stdout
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    fam_ms: collections.Counter = collections.Counter()
    fam_n: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            fam = kernel_family(e["name"])
            fam_ms[fam] += e.get("dur", 0) / 1e3
            fam_n[fam] += 1
    n = max(n_steps, 1)
    per_step = sum(fam_ms.values()) / n
    if per_step <= 0.0:
        print(f"no device events in {trace_path}; skipping the device-time report", file=out)
        return None
    print(f"device time: {per_step:.3f} ms/step ({audio_s_per_step / per_step * 1e3:.0f} "
          f"audio-s/s device-limited)", file=out)
    print("top kernel families (device ms per step):", file=out)
    for fam, ms in fam_ms.most_common(12):
        print(f"  {ms / n:7.3f} ms x{fam_n[fam] / n:<6g} {fam[:80]}", file=out)
    return {"ms_per_step": per_step, "audio_s_per_s": audio_s_per_step / per_step * 1e3,
            "families": {f: [fam_ms[f] / n, fam_n[f] / n] for f in fam_ms}}


def main(argv=None):
    """Trace -> the device-time report (None on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="exp/trace")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--frames", type=int, default=768)
    ap.add_argument("--set", nargs="*", default=[], help="dotted overrides k=v")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from tpuasr_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = bench_cfg(args.fused, args.set)
    batch = bench_batch(cfg, device, args.batch, args.frames)
    state, step = train_setup(cfg, device)
    path = os.path.join(args.out, "trace.json")
    state, ms = trace_steps(step, state, batch, args.steps, path)
    print(f"trace of {args.steps} steps ({ms / args.steps:.1f} ms a step, synced host wall "
          f"under the profiler) written to {path}")
    audio_s = float(batch["wave_lens"].sum()) / cfg.feature.sample_rate
    return report_device_time(path, args.steps, audio_s)


if __name__ == "__main__":
    main(sys.argv[1:])
