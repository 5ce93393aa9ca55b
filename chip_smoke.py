#!/usr/bin/env python3
"""Drive the PyTorch port (`tpuasr_torch`) through its serving path, its
training step and its trainer on one NVIDIA card, and hold its hand-written
kernels against their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. Device: require CUDA; print torch's CUDA version, nvcc's version and the
   card's name and power limit (nvidia-smi).
2. Build: compile every kernel source of tpuasr_torch/csrc at once (one nvcc
   per source, started together) and print the time and ptxas' register
   and spill lines, each labelled with its kernel.
3. Kernels against their plain versions on the card, at the flagship's
   shapes: fbank on the 16 waves of fixtures/example1.npz (48 kHz) and on
   a seeded 8 s batch, in both precisions, and on the training batch of
   phase 6b (bench.py's 12 waves, 9,216 frames) in precision "default"
   (the tensor-core route: its plan and own work at each shape, its time
   at each block shape the kernel builds on the fixture and the training
   batch, and at the training batch two calls bit-identical and its device
   time by kernel); "highest" takes the FFT route at n_fft 1024 (its plan
   and own work, each route's error against a float64 DFT; at the fixture
   two calls bit-identical, silent frames at -100 dB, its device time by
   kernel, its time at each count of frames a block, the dense kernel
   timed on the same frames and torch.fft.rfft of the windowed frames
   timed as one stage);
   rel-pos attention forward (#2) at [4, 187, 256] (8 s after subsampling)
   and [16, 63, 256] (the fixture requests), fp32 and bf16, with a fully
   masked row; the attention forward and backward (#2/#3) at the training
   shape ([12, 191, 256] bf16, a dynamic-chunk mask), at an fp32 ragged
   shape with a fully masked row and with a [B, 1, S] mask (the bf16
   forward writing its fp32 output and each row's log-sum-exp, held against
   the plain ones; #3 timed alone on what the forward saved; at the
   training shape both bf16 kernels and the plain bf16 versions against the
   fp32 plain version on the same bf16 values, and #3's two kernels
   profiled); the fused RNN-T
   joint forward and backward (#4/#5), the RNN-T lattice (#8/#9) and the
   CTC alpha and beta sweeps (#6/#7) at the training step's shapes (B 12,
   T' 191, U+1 33, S 65, D 256, V 412) and at a ragged shape with a
   t_len = 0 and a label_len = 0 row (#6/#7 also at the trainer's T' 63 and
   127, U+1 17, on the warp route the plan takes and on the block route,
   each with its time per dependent step, two calls bit-identical, its
   device time by kernel and both routes timed in turns; #4 and #5 also
   twice at each,
   bit-identical, and their device time by kernel at the training shape:
   #4's W tiles and rows, #5's row side, vocabulary side and sum; #4's plan
   and the bytes of W its blocks read from L2 at each shape, and #4 held
   and timed at the trainer's shapes too, T' 63 and 127 at U+1 17; #4/#5's
   bound at the 3xTF32 floor, the fp32 CUDA-core figure beside it); the
   fused FFN forward and backward
   (#10/#11) at the training shape (12 x 191 rows, D 256, H 1024, bf16,
   keep-masks at rate 0.1, scale 0.5: two calls bit-identical, each call's
   device time by kernel, and timed at other counts of H slices), at the
   serving shape (4 x 187 rows, no masks) and at a streaming chunk (4 x 32
   rows), fp32 and (#10) bf16. Max abs
   error, its tolerance and the reason, kernel ms, plain ms, bound, and the
   ms of one PyTorch call computing the same function where there is one
   (attention: `scaled_dot_product_attention` on [q+u | q+v], [k | p], v,
   and its backward; CTC: `torch.nn.functional.ctc_loss` forward, and its
   backward; the fused joint, the RNN-T lattice and the fused FFN: none).
   Kernels are timed by CUDA events; the plain lattices, the plain attention
   backward and FFNs, F.ctc_loss and the SDPA backward by the profiler
   (`timing`). One function, `_held`, holds each kernel's tolerance, bound
   and library call, for this phase and for phase 8.
4. Offline serving: the full-width flagship (12 causal conformer blocks,
   d256, 4 heads, FFN 1024, conv 31, LSTM-256 predictor, tanh joint over
   412 tokens, `fused_attention=True`) with seeded random weights, through
   `make_offline_decoder("rnnt_greedy")`. The blank logit is raised until
   greedy search emits as many tokens per encoder frame as the fixture's
   transcripts hold (texts/text_lens), so the emission loop runs as often as
   it would for real speech. fp32 on the card against the same model and
   requests on the CPU (plain versions): features, encoder output and
   tokens. The same weights with `fused_ffn=True` (kernel #10 in every FFN)
   must give the card's fp32 tokens. Then bf16: the card's encoder output
   against the same bf16 model on the CPU, latency, and token agreement with
   fp32. After phase 5, outside the serving run's launch counts: the fp32
   request batch's device busy ms with fbank "highest" by the FFT route and
   by the dense kernel, in turns.
5. Streaming serving: `streaming_greedy_decode` (chunk 32, 6 left chunks)
   must give the tokens of offline greedy over the chunk-masked full-context
   encoder, with `fused_ffn` off and on; `measure_rtf` greedy p50/p90.
6. Training, `fused_attention=True` (kernels #2/#3 in every layer):
   a. card against CPU: the full-width fp32 flagship on a batch of 2 x 256
      feature frames x 16 tokens, no dropout, static chunk 32, once per
      RNN-T loss route (`fused_joint_loss=True`, bench.py's, and False, the
      JAX default) and once more with `fused_joint_loss=True` and
      `fused_ffn=True`: the loss dict, the gradient norm, every gradient leaf
      (max error relative to the leaf's max |g|); the GuardedAdam step alone
      (the CPU's optimizer on the card's gradients: count, moments, weights)
      and end to end (each side's update; no entry whose sign is certain
      moves the other way);
   b. bench.py's configuration (bench.py:51-90): its batch, built by the
      port's copies of `synth_corpus` and `make_batch` (12 utterances of
      24-30 tokens plus SOS and EOS, 768 frames), bf16, fbank precision
      "default", dropout 0.1, dynamic chunk, `fused_joint_loss=True`, ten
      steps of `make_train_step`: every loss finite, synced step ms, audio
      seconds per second, peak memory, and the device's busy time against
      wall from torch.profiler over one step (after one warm-up step under
      the profiler, with 50 ms of idle host on each side of the step: the
      trace drops kernels near its window's edges), with the port's
      kernels in it by name, fbank's pack and tensor-core kernels among
      them. Kernels #1-#9 must launch, fbank once a step and always by its
      tensor-core route (its route counts); then, outside the run's launch
      counts, a fresh model's profiled step's device busy ms with the CTC
      lattice by its block route and by its warp route, in turns;
   c. the same with `fused_joint_loss=False` (the joint's full logits and
      the materialized loss), four steps: kernels #1-#3 and #6-#9 must
      launch;
   d. 6b with `fused_ffn=True` (bench.py's TPUASR_FUSED_FFN=1): ten steps
      after two; kernels #1-#11 must launch, #10/#11 24 times a step; its
      step ms, audio-s/s, device busy ms, device operations and peak memory
      beside 6b's.
8. The trainer on the card, through `tpuasr_torch.tools.train` (in this
   process): the full-width online_rnnt with its card defaults (bf16, the
   fused joint loss and attention kernels, fbank "default") and
   `fused_ffn=True`, SpecAugment on, the hard synthetic corpus (48
   utterances, batch 12, prefetch depth 2, a 6-utterance dev split), 2
   epochs into a temporary save dir under build/; then `--resume
   .../latest` for a third epoch, which must start at the saved epoch and
   step. Every loss finite; kernels #1-#11 must launch (fbank by its
   tensor-core route alone). The run records
   the arguments of each kernel's first call at each signature (the
   buckets' shapes, the training steps and the dev pass) and counts the
   calls, which must equal the run's launches; then each kernel is held
   against its plain version on those arguments, with phase 3's
   tolerances, bound and library call, and timed.
7. The kernels line: one JSON object with an entry per kernel and run
   (the serving run of phases 4-5, the training runs of phases 6b, 6c and
   6d, the trainer run of phase 8; counts reset just before each and read
   just after): that run's launches (fbank's: those of the route the
   record times, the FFT for serving, which takes that route alone, and the
   tensor-core route for training, which never takes the FFT), and the
   error, times and bound at the
   shape that run gives the kernel (phase 3's bench-shape records for 6b-6d;
   for the trainer the signature it launched most, with every signature's
   record under "shapes"). The CTC entries carry their run's launches by
   route under "routes": each training run must take the warp route alone.

Each phase prints its seconds.
TF32 is off throughout (cuBLAS and cuDNN), so every fp32 comparison is fp32.
The last line is {"ok": true, "device": {...}}. The script imports nothing
of JAX: the machine with the card need not have it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_FP32 = 67e12    # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor cores, FLOP/s
PEAK_TF32 = 494.7e12  # H100 SXM dense TF32 tensor cores, FLOP/s (3xTF32: three passes)
HBM_BPS = 3.35e12    # H100 SXM HBM3, bytes/s
SEED = 0
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: longer than any timed enqueue
CHUNK, LEFT = 32, 6


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card to drive")
    sys.path.insert(0, str(ROOT))
    try:
        import tpuasr_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script: {e}")
    require((ROOT / "fixtures" / "example1.npz").exists(), "fixtures/example1.npz missing")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- 1
    print("== phase 1: device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off (matmul, cudnn)")
    from tpuasr_torch.ops._build import _nvcc

    nv = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print("nvcc:", nv.stdout.strip().splitlines()[-1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)

    # ---------------------------------------------------------------- 2
    print("== phase 2: build")
    from tpuasr_torch.ops import build_all

    t0 = time.perf_counter()
    logs = build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = _kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")

    # ---------------------------------------------------------------- 3
    t_phase = _phase("3: kernels against their plain versions", t0)
    data = _requests()
    bench = _bench_batch(torch, dev)
    checks = _kernel_checks(torch, dev, data, bench)
    checks.update(_attention_train_checks(torch, dev, bench))
    train_checks, fwd_plans = _train_kernel_checks(torch, dev, bench)
    checks.update(train_checks)
    checks.update(_ffn_checks(torch, dev))

    # ---------------------------------------------------------------- 4-5
    from tpuasr_torch.ops import KERNELS, LAUNCHES, reset_launch_counts

    t_phase = _phase("4-5: serving", t_phase)
    reset_launch_counts()
    serving, (gpu32, cfg32) = _serve(torch, dev, data)
    runs = {"serving": dict(LAUNCHES)}
    print(f"launches on the serving run: {runs['serving']}")
    require(runs["serving"]["ffn_bwd"] == 0, "the serving run launched the FFN backward")
    require(runs["serving"]["fbank_fft"] == runs["serving"]["fbank"] > 0,
            "the serving run did not take fbank's FFT route (precision \"highest\") alone")
    serving["offline_device_busy_ms_by_fbank_route"] = _fbank_route_ab(
        torch, gpu32, cfg32, *data["fixture"])
    del gpu32

    # ---------------------------------------------------------------- 6
    training = {"rnnt_fused_fwd_plans": fwd_plans}  # counted from the shapes, not measured
    for fused, ffn in ((True, False), (False, False), (True, True)):
        t_phase = _phase(f"6a: training step, card against CPU (fp32, fused_joint_loss="
                         f"{fused}, fused_ffn={ffn})", t_phase)
        training[f"card_vs_cpu_fused_joint_loss_{fused}" + ("_fused_ffn" if ffn else "")] = \
            _train_card_vs_cpu(torch, dev, fused, ffn)
    t_phase = _phase("6b: training at bench.py's configuration", t_phase)
    training["bench"], runs["training"] = _train_bench(torch, dev, bench, True)
    print(f"launches on the training run: {runs['training']}")
    training["bench"]["device_busy_ms_by_ctc_route"] = _ctc_route_ab(torch, dev, bench)
    t_phase = _phase("6c: training through the materialized loss", t_phase)
    training["bench_materialized"], runs["training_materialized"] = _train_bench(
        torch, dev, bench, False, n_steps=4, warmup=1)
    print(f"launches on the materialized training run: {runs['training_materialized']}")
    t_phase = _phase("6d: training at bench.py's configuration with fused_ffn=True", t_phase)
    training["bench_fused_ffn"], runs["training_fused_ffn"] = _train_bench(
        torch, dev, bench, True, fused_ffn=True)
    print(f"launches on the fused-FFN training run: {runs['training_fused_ffn']}")
    _compare_steps(training["bench"], training["bench_fused_ffn"])
    steps_6d = len(training["bench_fused_ffn"]["losses"])
    for name in KERNELS:
        require(runs["training_fused_ffn"][name] > 0, f"the 6d run never launched {name}")
    for name in ("ffn_fwd", "ffn_bwd"):
        require(runs["training_fused_ffn"][name] == 24 * steps_6d,
                f"6d launched {name} {runs['training_fused_ffn'][name]} times, not 24 per step")

    # ---------------------------------------------------------------- 8
    t_phase = _phase("8: the trainer (tpuasr_torch.tools.train), 2 epochs and a resume",
                     t_phase)
    training["trainer"], runs["trainer"], seen = _trainer(torch)
    print(f"launches on the trainer run: {runs['trainer']}")
    for name in KERNELS:
        require(runs["trainer"][name] > 0, f"the trainer never launched {name}")
    require(runs["trainer"]["fbank_tc"] == runs["trainer"]["fbank"]
            and runs["trainer"]["fbank_fft"] == 0,
            "the trainer did not take fbank's tensor-core route (precision \"default\") alone")
    print("kernels against their plain versions on the trainer's own inputs:")
    trainer_records = _trainer_kernel_records(torch, seen, runs["trainer"])

    # ---------------------------------------------------------------- 7
    # one entry per kernel and run that launches it, with the record taken
    # at the shape that run gives it: 6b, 6c and 6d give the same shapes
    # (bench.py's batch, phase 3's records); the trainer's records are taken
    # on its own inputs, at the signature it launched most, every
    # signature's under "shapes"
    _phase("7: the kernels line", t_phase)
    fused = ("training", "training_fused_ffn", "trainer")  # the fused joint loss
    every = fused[:1] + ("training_materialized",) + fused[1:]
    # (kernel, runs, record, launch count): fbank's records count the route
    # they time, "highest" by the FFT for serving and the tensor-core route
    # for training
    plan = [("fbank", ("serving",), "fbank", "fbank_fft"),
            ("fbank", every, "fbank_training", "fbank_tc"),
            ("relpos_attention", ("serving",), "attention"),
            ("relpos_attention", every, "attention_training"),
            ("relpos_attention_bwd", every, "attention_bwd"),
            ("rnnt_fused_fwd", fused, "rnnt_fused_fwd"),
            ("rnnt_fused_bwd", fused, "rnnt_fused_bwd"),
            ("ctc_alpha", every, "ctc_alpha"), ("ctc_beta_grad", every, "ctc_beta_grad"),
            ("rnnt_alpha", every, "rnnt_alpha"), ("rnnt_beta_grad", every, "rnnt_beta_grad"),
            ("ffn_fwd", ("serving",), "ffn_fwd_serving"),
            ("ffn_fwd", fused[1:], "ffn_fwd"), ("ffn_bwd", fused[1:], "ffn_bwd")]
    kernels = []
    for name, run_names, check, *count in plan:
        count = count[0] if count else name
        for run in run_names:
            launches = runs[run][count]
            require(launches > 0, f"the {run} run never launched {count}")
            rec = trainer_records[name] if run == "trainer" else checks[check]
            entry = dict(rec, run=run, launches=launches,
                         **{f"launches_{r}": runs[r][count] for r in runs})
            if name in ("ctc_alpha", "ctc_beta_grad"):  # the training runs: the warp route alone
                entry["routes"] = {f"{name}_{r}": runs[run][f"{name}_{r}"] for r in ("warp", "block")}
                require(entry["routes"][f"{name}_warp"] == launches
                        and entry["routes"][f"{name}_block"] == 0,
                        f"the {run} run did not take {name}'s warp route alone: {entry['routes']}")
            kernels.append(entry)
    require(runs["training_materialized"]["rnnt_fused_fwd"] == 0,
            "the materialized run launched the fused joint")
    print(f"phases took {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"kernels": kernels}))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def _phase(name: str, since: float) -> float:
    """Print the last phase's seconds and the next phase's name; -> now."""
    now = time.perf_counter()
    print(f"(previous phase: {now - since:.1f} s)")
    print(f"== phase {name}")
    return now


def _requests() -> dict:
    """The fixture requests (16 waves, 48 kHz, float16 on the wire, and
    their transcripts' token counts) and a seeded synthetic 8 s batch of 4
    requests."""
    import numpy as np

    fx = np.load(ROOT / "fixtures" / "example1.npz")
    r = np.random.default_rng(SEED)
    n = 8 * 48000
    t = np.arange(n) / 48000.0
    waves = np.stack([0.1 * np.sin(2 * np.pi * (200 + 150 * i) * t) * (1 + 0.5 * np.sin(t))
                      + 0.02 * r.standard_normal(n) for i in range(4)]).astype(np.float32)
    return {"fixture": (fx["waves"], fx["wave_lens"]), "text_lens": fx["text_lens"],
            "synthetic": (waves, np.array([n, int(6.5 * 48000), n, 5 * 48000], np.int32))}


def _time_ms(torch, fn, iters: int = 30, warmup: int = 3, method: str = "events") -> float:
    """Mean device time of fn over `iters` calls.

    method "events": CUDA events around the calls, queued behind a sleep
    kernel that holds the stream while the host enqueues all of them, so the
    events time the device's work back to back and not the host's launch
    rate (the wrappers take longer to launch than the small kernels run).
    The sleep is sized from one timed enqueue, and the run fails if the
    host's enqueue outlasted it. method "profiler": torch.profiler's sum of
    the device's kernel time per call, for calls that cannot be queued
    behind a sleep (they wait for the device, or 30 of them enqueue more
    launches than the launch queue holds: the plain CTC and RNN-T lattices
    loop over frames or diagonals, the plain attention backward is ~40
    launches, and F.ctc_loss copies its host lengths to the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if method == "profiler":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / iters
    require(method == "events", f"unknown timing method {method}")
    t0 = time.perf_counter()
    fn()
    one = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = max(SLEEP_CYCLES, int(3 * iters * one * 2e9))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    require(host_ms < sleep_ms, f"the host took {host_ms:.1f} ms to enqueue {iters} calls, "
                                f"longer than the {sleep_ms:.1f} ms sleep: the events would "
                                f"time the host")
    return ev[1].elapsed_time(ev[2]) / iters


def _kernel_checks(torch, dev, data, bench) -> dict:
    """fbank (#1) on the serving requests and on the training batch, and the
    attention forward (#2) at the serving shapes; -> {"fbank",
    "fbank_training", "attention"}: the records at the serving run's and
    the training run's calls."""
    from dataclasses import astuple

    from tpuasr_torch.audio.fbank import _operands, decode_wire, frame_signal
    from tpuasr_torch.config import FeatureConfig
    from tpuasr_torch.nn.masks import chunk_mask
    from tpuasr_torch.ops import fbank_frames, relpos_attention
    from tpuasr_torch.ops.fbank import _fbank_plan
    from tpuasr_torch.ops.ffn import _sm_count

    out = {}
    cfg = FeatureConfig()
    window, cos, sin, mel = _operands(astuple(cfg), str(dev))
    n_fft, n_freq, n_mels = cfg.n_fft, cfg.n_fft // 2 + 1, cfg.n_mels
    both = (("highest", PEAK_FP32), ("default", PEAK_BF16))
    # the serving requests in both precisions, and the training step's
    # batch (phase 6b: bench.py's 12 waves) in the precision it trains with
    for src, wire, precs in (("fixture", data["fixture"][0], both),
                             ("synthetic", data["synthetic"][0], both),
                             ("bench", bench["waves"], both[1:])):
        waves = decode_wire(torch.as_tensor(wire).to(dev))
        frames = frame_signal(waves, n_fft, cfg.hop_length, cfg.center)
        frames = frames.reshape(-1, n_fft).contiguous()
        for prec, peak in precs:
            args = dict(frames=frames, window=window, cos=cos, sin=sin, mel=mel,
                        amin=cfg.amin, precision=prec)
            rec = _hold(torch, "fbank", args, f"{src} {prec}")
            rows = frames.shape[0]
            if prec == "highest":  # the FFT route: its plan, work, bits, split and yardsticks
                rec.update(_fbank_fft_checks(torch, args, src == "fixture"))
            else:  # the tensor-core route's own work: padded bins, K and rows
                plan = _fbank_plan(rows, n_fft, n_freq, n_mels, _sm_count(dev.index))
                work = plan["dft_flops"]
                print(f"  the bf16 route's own work ({plan['k_pad']} K in tiles of "
                      f"{plan['k_tile']}, {plan['n_freq_pad']} bins, {plan['n_mels_pad']} mel "
                      f"columns) {work / 1e9:.2f} GFLOP = {work / peak * 1e3:.4f} ms at the bf16 "
                      f"peak; plan: {plan['frames_per_block']} frames and {plan['warps']} "
                      f"warps a block (tiles {plan['tiles']}), "
                      f"{plan['blocks']} blocks, {plan['blocks_per_sm']} an SM, "
                      f"{plan['waves']} waves, {plan['smem']} B shared, "
                      f"{plan['ws_bytes']} B scratch")
                if src != "synthetic":  # the plan's choice at 4,112 and 9,216 frames
                    rec["by_block_shape"] = _fbank_tiles(torch, args)
                if src == "bench":
                    a, b = fbank_frames(*args.values()), fbank_frames(*args.values())
                    require(torch.equal(a, b), "two calls of fbank's bf16 route differ")
                    print("  two calls bit-identical")
                    split = _device_split(torch, lambda: fbank_frames(*args.values()))
                    print("  device ms by kernel: " + "; ".join(
                        f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(),
                                                                    key=lambda x: -x[1])))
            if src == "fixture" and prec == "highest":  # the serving run's call
                out["fbank"] = rec
            if src == "bench":  # the training run's call
                out["fbank_training"] = rec

    g = torch.Generator().manual_seed(SEED)
    for b, t, lens in ((4, 187, (187, 150, 187, 100)), (16, 63, None)):
        h, dk = 4, 64
        d = h * dk
        valid = torch.ones(b, t, dtype=torch.bool) if lens is None else \
            torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
        mask = valid[:, None, :] & chunk_mask(t, CHUNK, LEFT)[None]  # [B, T, T]
        mask[1, 5] = False  # a fully masked query row gives zeros
        mask = mask.to(dev)
        base = [torch.randn(*shape, generator=g) for shape in
                ((b, t, d), (b, t, d), (1, t, d), (b, t, d))]
        ub, vb = 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, p, v = (x.to(dev, dtype) for x in base)
            args = dict(q=q, k=k, p=p, v=v, u_bias=ub.to(dev, dtype), v_bias=vb.to(dev, dtype),
                        mask=mask, scale=1.0 / math.sqrt(dk), n_head=h)
            rec = _hold(torch, "relpos_attention", args, "serving")
            require(bool((relpos_attention(*args.values())[1, 5] == 0).all()),
                    "a fully masked query row did not give zeros")
            if b == 4 and dtype == torch.bfloat16:  # the flagship's 8 s bf16 call
                out["attention"] = rec
    return out


def _fbank_fft_checks(torch, args, serving: bool) -> dict:
    """fbank's FFT route ("highest" at n_fft 1024) on `args`: print the
    plan and the design's own work (the FFT from the plan, the mel product
    over each filter's band of this mel matrix) and each route's max dB error
    against a float64 DFT on the card, and time it at each count of frames
    a block the plan could take; at the serving requests also two calls
    bit-identical, the device time by kernel, the dense kernel on the same
    frames (held against plain too) and torch.fft.rfft (cuFFT) of the
    windowed frames alone, one stage of the function; -> the measured
    numbers."""
    import tpuasr_torch.ops.fbank as fbank_mod
    from tpuasr_torch.ops.ffn import _sm_count

    frames, window, cos, sin, mel = (args[k] for k in ("frames", "window", "cos", "sin", "mel"))
    (rows, n_fft), (n_freq, n_mels) = frames.shape, mel.shape
    fft_plan, n_sm = fbank_mod._fbank_fft_plan, _sm_count(frames.device.index)
    plan = fft_plan(rows, n_fft, n_freq, n_mels, n_sm)
    require(plan["route"] == "fbank_fft", f"n_fft {n_fft} did not take the FFT route")
    nz = mel != 0
    f = torch.arange(n_freq, device=mel.device)[:, None]
    widths = (torch.where(nz, f, -1).max(0).values - torch.where(nz, f, n_freq).min(0).values
              + 1).clamp(min=0)
    work = plan["fft_flops"] + rows * (2 * int(widths.sum()) + 2 * n_mels)
    print(f"  the FFT design's own work {work / 1e6:.1f} MFLOP = {work / PEAK_FP32 * 1e3:.5f} ms "
          f"at the fp32 peak (FFT, split and power {plan['fft_flops'] / 1e6:.1f}, the mel "
          f"product over {int(widths.sum())} band bins of {n_freq * n_mels}); plan (counted, "
          f"not measured): {plan['frames_per_block']} frames of {plan['threads_per_frame']} "
          f"threads a block, {plan['points']} points a frame, {plan['points_per_thread']} a "
          f"thread, passes (lowest bit, bits) {plan['passes']}, {plan['blocks']} blocks, "
          f"{plan['blocks_per_sm']} an SM, {plan['waves']} waves, {plan['smem']} B shared")
    out = {}
    fw = frames.double() * window.double()
    exact = 10.0 * torch.log10(torch.clamp(((fw @ cos.double()) ** 2 + (fw @ sin.double()) ** 2)
                                           @ mel.double(), min=args["amin"]))
    out["fp64_max_db_err"] = {
        "fft": float((fbank_mod.fbank_frames(*args.values()).double() - exact).abs().max()),
        "plain": float((fbank_mod.fbank_frames_plain(*args.values()).double() - exact)
                       .abs().max())}
    print(f"  max dB error against a float64 DFT on the card: FFT kernel "
          f"{out['fp64_max_db_err']['fft']:.3g}, plain (fp32 products) "
          f"{out['fp64_max_db_err']['plain']:.3g}")
    by_frames = {}
    try:
        for fb in fbank_mod.FFT_FRAMES:
            try:
                fft_plan(rows, n_fft, n_freq, n_mels, n_sm, frames=fb)
            except ValueError:
                continue
            fbank_mod._fbank_fft_plan = lambda *a, fb=fb: fft_plan(*a, frames=fb)
            by_frames[fb] = _time_ms(torch, lambda: fbank_mod.fbank_frames(*args.values()))
    finally:
        fbank_mod._fbank_fft_plan = fft_plan
    out["by_frames_per_block_ms"] = by_frames
    print("  by frames a block (the plan's "
          f"{plan['frames_per_block']}), ms: " + "; ".join(f"{k}: {v:.4f}"
                                                         for k, v in by_frames.items()))
    if not serving:
        return out
    a, b = fbank_mod.fbank_frames(*args.values()), fbank_mod.fbank_frames(*args.values())
    require(torch.equal(a, b), "two calls of fbank's FFT route differ")
    require(bool((a[(frames == 0).all(1)] == -100.0).all()), "a silent frame is not at -100 dB")
    print("  two calls bit-identical; silent frames at -100 dB")
    split = _device_split(torch, lambda: fbank_mod.fbank_frames(*args.values()))
    out["device_split_ms"] = split
    print("  device ms by kernel (profiler): " + "; ".join(
        f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1])))
    try:  # the dense kernel at the same frames: the route a non-power-of-two takes
        fbank_mod._fbank_fft_plan = lambda r, *a: {"route": "fbank_fp32"}
        dense = fbank_mod.fbank_frames(*args.values())
        dense_err = float((dense - fbank_mod.fbank_frames_plain(*args.values())).abs().max())
        require(dense_err <= 2e-2, f"the dense kernel is {dense_err} dB off plain")
        out["dense_kernel_ms"] = _time_ms(torch, lambda: fbank_mod.fbank_frames(*args.values()))
    finally:
        fbank_mod._fbank_fft_plan = fft_plan
    print(f"  the dense kernel on the same frames (route fbank_fp32): "
          f"{out['dense_kernel_ms']:.4f} ms, max_abs_err against plain {dense_err:.3g}")
    fw32 = frames * window
    out["cufft_rfft_stage_ms"] = _time_ms(torch, lambda: torch.fft.rfft(fw32))
    print(f"  torch.fft.rfft (cuFFT) of the windowed frames alone, one stage of the function "
          f"(no window, power, mel or log): {out['cufft_rfft_stage_ms']:.4f} ms")
    return out


def _fbank_tiles(torch, args) -> dict:
    """fbank's bf16 route at each block shape the kernel builds (the plan
    fixed to it), to check the plan's choice; -> {"<frames a block>f <warps
    over the frames>x<warps over the bins>w": ms}."""
    import tpuasr_torch.ops.fbank as fbank_mod

    real, ms = fbank_mod._fbank_plan, {}
    try:
        for t in fbank_mod.FBANK_TILES:
            fbank_mod._fbank_plan = lambda *a, t=t: real(*a, tiles=t)
            ms["{}f {}x{}w".format(16 * t[0] * t[1], t[1], t[2])] = _time_ms(
                torch, lambda: fbank_mod.fbank_frames(*args.values()))
    finally:
        fbank_mod._fbank_plan = real
    print("  by block shape (frames, warps over them x over the bins), ms: "
          + "; ".join(f"{k}: {v:.4f}" for k, v in ms.items()))
    return ms


def _joint_fwd_plan_line(torch, enc, pred, w, tag) -> dict:
    """Print kernel #4's plan at these operands' shape (its tiles, blocks and
    the bytes of W's tiles its blocks ask of L2 a call, counted from the
    plan: no number here is measured); -> the plan's numbers."""
    from tpuasr_torch.ops.ffn import _sm_count
    from tpuasr_torch.ops.rnnt_fused import _joint_fwd_plan

    (b, t, d), u1, v = enc.shape, pred.shape[1], w.shape[1]
    plan = _joint_fwd_plan(b, t, u1, d, v, _sm_count(enc.device.index))
    print(f"rnnt_fused_fwd {tag} plan: tt {plan['tt']} x uc {plan['uc']}, grid {plan['grid']} "
          f"({plan['blocks']} blocks, {plan['waves']} waves), {plan['smem']} B shared a block, "
          f"W's tiles asked of L2 {plan['l2_w_bytes'] / 1e9:.3f} GB a call (blocks x W's "
          f"tile bytes, counted from the plan, not measured)")
    return {k: plan[k] for k in ("tt", "uc", "blocks", "waves", "smem", "l2_w_bytes")}


def _attention_train_checks(torch, dev, bench) -> dict:
    """Kernels #2 and #3 against their plain versions at the training shape
    (phase 6b's encoder: [12, 191, 256] bf16, its padding and a drawn
    dynamic chunk), at an fp32 ragged shape with a fully masked query row,
    and with a [B, 1, S] padding mask; -> {"attention_training",
    "attention_bwd"}: the records at the training shape."""
    import numpy as np

    from tpuasr_torch.nn.masks import chunk_mask, draw_dynamic_chunk, dynamic_chunk_size
    from tpuasr_torch.ops import relpos_attention_bwd
    from tpuasr_torch.ops.relpos_attention import _relpos_fwd

    out = {}
    h, dk = 4, 64
    d = h * dk
    t_bench = int(_enc_len(np.array([(BENCH_FRAMES - 1) * HOP]))[0])
    lens = torch.as_tensor(_enc_len(bench["wave_lens"].cpu().numpy()))
    for seed in range(100):  # a draw that chunks (about half give full context)
        cs, left = dynamic_chunk_size(*draw_dynamic_chunk(torch.Generator().manual_seed(seed),
                                                          t_bench), t_bench, 25, False)
        if cs < t_bench:
            break
    pad = torch.arange(t_bench)[None, None, :] < lens[:, None, None]  # [B, 1, T]
    ragged = (torch.arange(37)[None, :] < torch.tensor([37, 20, 30])[:, None])[:, None, :]
    ragged = ragged & chunk_mask(37, 8, 2)[None]
    ragged[1, 5] = False  # a fully masked query row
    bcast = torch.ones(4, 1, 60, dtype=torch.bool)
    bcast[3, 0, 41:] = False
    cases = (("training", torch.bfloat16, pad & chunk_mask(t_bench, cs, left)[None]),
             ("ragged", torch.float32, ragged), ("broadcast", torch.bfloat16, bcast))
    print(f"training-shape mask: the encoder's padding and a dynamic chunk of {cs} frames "
          f"(left chunks {left})")
    g = torch.Generator().manual_seed(SEED + 5)
    for tag, dtype, mask in cases:
        b, t = mask.shape[0], mask.shape[2]
        q, k, v, do = (torch.randn(b, t, d, generator=g).to(dev, dtype) for _ in range(4))
        p = torch.randn(1, t, d, generator=g).to(dev, dtype)
        u_, v_ = ((0.1 * torch.randn(d, generator=g)).to(dev, dtype) for _ in range(2))
        args = dict(q=q, k=k, p=p, v=v, u_bias=u_, v_bias=v_, mask=mask.to(dev),
                    scale=1.0 / math.sqrt(dk), n_head=h)
        bf16 = dtype == torch.bfloat16
        rec = _hold(torch, "relpos_attention", dict(args, saved=bf16), tag)
        # #3 alone: the bf16 forward's saved fp32 output and log-sum-exp made
        # once, as the autograd Function hands them over (fp32 saves nothing)
        saved = _relpos_fwd(*args.values(), saved=True)[1:] if bf16 else (None, None)
        bwd_args = dict(list(args.items())[:7] + [("do", do)] + list(args.items())[7:],
                        out=saved[0], lse=saved[1])
        rec_b = _hold(torch, "relpos_attention_bwd", bwd_args, tag)
        if tag == "ragged":
            dq = relpos_attention_bwd(*bwd_args.values())[0]
            require(bool((dq[1, 5] == 0).all()), "a fully masked query row got a gradient")
        if tag == "training":
            rec["vs_fp32"], rec_b["vs_fp32"] = _vs_fp32(torch, args, do, saved)
            split = _device_split(torch, lambda: relpos_attention_bwd(*bwd_args.values()))
            print("#3 at the training shape, device ms a call by kernel (profiler): " + "; ".join(
                f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1])))
            rec_b["device_split_ms"] = split
            out["attention_training"], out["attention_bwd"] = rec, rec_b
    return out


def _vs_fp32(torch, a, do, saved) -> tuple[dict, dict]:
    """The bf16 kernels #2/#3 and the plain bf16 versions, each against the
    fp32 plain version on the same bf16 values: -> ({"kernel",
    "kernel_saved", "plain"}: the error over the output's max; #2 without
    and with its saved fp32 output, and "differ": the outputs on which those
    two differ) for the forward, and per output for the backward."""
    from tpuasr_torch.ops.relpos_attention import (
        _relpos_fwd, relpos_attention_bwd, relpos_attention_bwd_plain, relpos_attention_plain,
    )

    up = lambda v: v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else v
    f32 = [up(v) for v in a.values()]
    bf = list(a.values())
    rel = lambda x, r: float((x.float() - r).abs().max() / r.abs().max().clamp(min=1e-30))
    ref = relpos_attention_plain(*f32)
    alone, saving = _relpos_fwd(*bf), _relpos_fwd(*bf, saved=True)[0]
    fwd = {"kernel": rel(alone, ref), "kernel_saved": rel(saving, ref),
           "plain": rel(relpos_attention_plain(*bf), ref),
           "differ": int((alone != saving).sum())}
    sc, h = a["scale"], a["n_head"]
    names = ("dq", "dk", "dv", "dp", "du", "dvb")
    refs = relpos_attention_bwd_plain(*f32[:7], do.float(), sc, h)
    kern = relpos_attention_bwd(*bf[:7], do, sc, h, *saved)
    plain = relpos_attention_bwd_plain(*bf[:7], do, sc, h)
    bwd = {n: {"kernel": rel(x, r), "plain": rel(y, r)}
           for n, x, y, r in zip(names, kern, plain, refs)}
    print(f"bf16 against the fp32 plain version on the same bf16 values (error / the "
          f"output's max): #2 kernel {fwd['kernel']:.3g} (saving for the backward "
          f"{fwd['kernel_saved']:.3g}; {fwd['differ']} of {saving.numel()} outputs differ "
          f"between the two), plain bf16 {fwd['plain']:.3g}; #3 "
          + ", ".join(f"{n} kernel {v['kernel']:.3g} plain {v['plain']:.3g}"
                      for n, v in bwd.items()))
    return fwd, bwd


def _device_split(torch, fn, iters: int = 10) -> dict:
    """torch.profiler's device ms a call of fn, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _ffn_checks(torch, dev) -> dict:
    """Kernels #10/#11 against their plain versions at the shapes the paths
    give them: the training steps of phase 6d (12 x 191 rows, bf16,
    keep-masks at rate 0.1, ff_scale 0.5), offline serving (4 x 187 rows, fp32,
    no masks) and a streaming chunk (4 streams x 32 frames, fp32), and #10 at
    the serving and streaming shapes in bf16 (bf16 serving with
    `fused_ffn=True` takes the tensor-core route); at the training shape two
    calls of each must give the same bits, each call's device time is split
    by kernel, and both are timed at other counts of H slices than the
    plan's; -> the records {"ffn_fwd", "ffn_bwd"} at the training shape,
    {"ffn_fwd_serving"} at the serving shape (fp32) and
    {"ffn_fwd_serving_bf16", "ffn_fwd_streaming_bf16"}."""
    import numpy as np

    from tpuasr_torch.ops import ffn_bwd, ffn_fwd

    out = {}
    d, h, rate, scale = 256, 1024, 0.1, 0.5
    rows = BENCH_B * int(_enc_len(np.array([(BENCH_FRAMES - 1) * HOP]))[0])
    g = torch.Generator().manual_seed(SEED + 17)
    rn = lambda *shape: torch.randn(*shape, generator=g)
    for tag, r, dtype, masks in (("training", rows, torch.bfloat16, True),
                                 ("serving", 4 * 187, torch.float32, False),
                                 ("streaming", 4 * CHUNK, torch.float32, False),
                                 ("serving_bf16", 4 * 187, torch.bfloat16, False),
                                 ("streaming_bf16", 4 * CHUNK, torch.bfloat16, False)):
        args = dict(x=rn(r, d).to(dev, dtype), ln_scale=(1.0 + 0.1 * rn(d)).to(dev),
                    ln_bias=(0.1 * rn(d)).to(dev), w1=(rn(h, d) / d ** 0.5).to(dev, dtype),
                    b1=(0.1 * rn(h)).to(dev), w2=(rn(d, h) / h ** 0.5).to(dev, dtype),
                    b2=(0.1 * rn(d)).to(dev), mask1=None, mask2=None)
        if masks:
            args["mask1"] = (torch.rand(r, h, generator=g) >= rate).to(torch.uint8).to(dev)
            args["mask2"] = (torch.rand(r, d, generator=g) >= rate).to(torch.uint8).to(dev)
        do = rn(r, d).to(dev, dtype)
        fwd_args = dict(args, rate=rate, ff_scale=scale)
        bwd_args = dict(args, dout=do, rate=rate, ff_scale=scale)
        rec = _hold(torch, "ffn_fwd", fwd_args, tag)
        if tag.endswith("bf16"):
            out[f"ffn_fwd_{tag}"] = rec
            continue
        rec_b = _hold(torch, "ffn_bwd", bwd_args, tag)
        if tag == "serving":
            out["ffn_fwd_serving"] = rec
        if tag != "training":
            continue
        for name, fn, a in (("ffn_fwd", ffn_fwd, fwd_args), ("ffn_bwd", ffn_bwd, bwd_args)):
            first, again = fn(*a.values()), fn(*a.values())
            torch.cuda.synchronize()
            first, again = ((x,) if isinstance(x, torch.Tensor) else x for x in (first, again))
            require(all(torch.equal(x, y) for x, y in zip(first, again)),
                    f"two calls of {name} on the same inputs differ")
            split = _device_split(torch, lambda: fn(*a.values()))
            print(f"{name} at the training shape: two calls bit-identical; device ms a call "
                  f"by kernel (profiler): " + "; ".join(
                      f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(),
                                                                   key=lambda x: -x[1])))
            (rec if name == "ffn_fwd" else rec_b)["device_split_ms"] = split
        rec["slices_ms"], rec_b["slices_ms"] = _ffn_slices(torch, r, fwd_args, bwd_args)
        out["ffn_fwd"], out["ffn_bwd"] = rec, rec_b
    return out


def _ffn_slices(torch, r, fwd_args, bwd_args) -> tuple[dict, dict]:
    """#10 and #11 at the training shape timed with the hidden dimension
    split into other counts of slices than the plan's; -> ({slices: ms}
    forward, {slices: ms} backward)."""
    from tpuasr_torch.ops import ffn as ffn_mod

    x, h = fwd_args["x"], fwd_args["w1"].shape[0]
    d, n_chunks = x.shape[1], h // ffn_mod.KERNEL_H_MULTIPLE
    plan = ffn_mod._ffn_plan(r, d, h, x.dtype, ffn_mod._sm_count(x.device.index))
    real = ffn_mod._ffn_plan
    fwd, bwd = {}, {}
    try:
        for want in (1, 2, 3, 4, 7, 8, 11, 16):
            s = ffn_mod._slices(n_chunks, 1, want, 1)
            ffn_mod._ffn_plan = lambda r_, d_, h_, dt, n_sm, s=s: ffn_mod._plan_for(
                r_, d_, h_, dt, s, s)
            fwd[s] = _time_ms(torch, lambda: ffn_mod.ffn_fwd(*fwd_args.values()))
            bwd[s] = _time_ms(torch, lambda: ffn_mod.ffn_bwd(*bwd_args.values()))
    finally:
        ffn_mod._ffn_plan = real
    print(f"#10 / #11 at the training shape by H slices ({plan['tiles']} row tiles; the "
          f"plan's {plan['fwd_slices']} / {plan['bwd_slices']}), ms: "
          + "; ".join(f"{s}: {fwd[s]:.4f} / {bwd[s]:.4f}" for s in fwd))
    return fwd, bwd


def _record(torch, name, source, replaces, err, flops, peak, nbytes, kernel, plain,
            library, plain_iters: int = 30, plain_timing: str = "events") -> dict:
    """One kernel's record for the kernels line. The kernel is always timed
    by events; `plain_timing` says how its plain version and the library
    call are timed, and `timing` records it beside the numbers."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": err, "ms": _time_ms(torch, kernel),
        "plain_ms": _time_ms(torch, plain, plain_iters, method=plain_timing),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None if library is None else _time_ms(torch, library,
                                                            method=plain_timing),
        "timing": {"ms": "events", "plain_ms": plain_timing,
                   "library_ms": None if library is None else plain_timing},
    }


# kernel -> (module, the wrapper that launches it, its plain version, the
# kernel's source, the TPU kernel it replaces)
WRAPPERS = {
    "fbank": ("tpuasr_torch.ops.fbank", "fbank_frames", "fbank_frames_plain",
              "tpuasr_torch/csrc/fbank.cu", "tpuasr/ops/fbank_pallas.py:25"),
    "relpos_attention": ("tpuasr_torch.ops.relpos_attention", "_relpos_fwd",
                         "relpos_attention_plain", "tpuasr_torch/csrc/relpos_attention.cu",
                         "tpuasr/ops/attention_pallas.py:72"),
    "relpos_attention_bwd": ("tpuasr_torch.ops.relpos_attention", "relpos_attention_bwd",
                             "relpos_attention_bwd_plain",
                             "tpuasr_torch/csrc/relpos_attention.cu",
                             "tpuasr/ops/attention_pallas.py:87"),
    "rnnt_fused_fwd": ("tpuasr_torch.ops.rnnt_fused", "rnnt_fused_lp", "rnnt_fused_lp_plain",
                       "tpuasr_torch/csrc/rnnt_fused.cu", "tpuasr/ops/rnnt_fused_pallas.py:38"),
    "rnnt_fused_bwd": ("tpuasr_torch.ops.rnnt_fused", "rnnt_fused_grads",
                       "rnnt_fused_grads_plain", "tpuasr_torch/csrc/rnnt_fused.cu",
                       "tpuasr/ops/rnnt_fused_pallas.py:71"),
    "ctc_alpha": ("tpuasr_torch.ops.ctc", "ctc_alpha", "ctc_alpha_plain",
                  "tpuasr_torch/csrc/ctc_lattice.cu", "tpuasr/ops/ctc_pallas.py:56"),
    "ctc_beta_grad": ("tpuasr_torch.ops.ctc", "ctc_beta_grad", "ctc_beta_grad_plain",
                      "tpuasr_torch/csrc/ctc_lattice.cu", "tpuasr/ops/ctc_pallas.py:83"),
    "rnnt_alpha": ("tpuasr_torch.ops.rnnt_lattice", "rnnt_alpha", "rnnt_alpha_plain",
                   "tpuasr_torch/csrc/rnnt_lattice.cu", "tpuasr/ops/rnnt_pallas.py:88"),
    "rnnt_beta_grad": ("tpuasr_torch.ops.rnnt_lattice", "rnnt_beta_grad",
                       "rnnt_beta_grad_plain", "tpuasr_torch/csrc/rnnt_lattice.cu",
                       "tpuasr/ops/rnnt_pallas.py:111"),
    "ffn_fwd": ("tpuasr_torch.ops.ffn", "ffn_fwd", "ffn_fwd_plain", "tpuasr_torch/csrc/ffn.cu",
                "tpuasr/ops/ffn_pallas.py:169"),
    "ffn_bwd": ("tpuasr_torch.ops.ffn", "ffn_bwd", "ffn_bwd_plain", "tpuasr_torch/csrc/ffn.cu",
                "tpuasr/ops/ffn_pallas.py:190"),
}


def _hold(torch, name, args, tag, ctc_inputs=None) -> dict:
    """Kernel `name` against its plain version on `args` (`_held`): print
    the result under `tag` and fail outside the tolerance; -> the record,
    with the inputs' shapes and the tolerance."""
    rec, tol, ok, inputs = _held(torch, name, args, ctc_inputs or {})
    print(f"{name} {tag} {inputs}: max_abs_err {rec['max_abs_err']:.3g} (tol {tol}) ms "
          f"{rec['ms']:.4f} plain_ms ({rec['timing']['plain_ms']}) {rec['plain_ms']:.4f} "
          f"library_ms {rec['library_ms']} bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']})")
    require(ok, f"{name} disagrees with its plain version ({tag}: {inputs})")
    return dict(rec, inputs=inputs, tol=tol)


def _held(torch, name, a, ctc_inputs) -> tuple[dict, str, bool, str]:
    """Kernel `name` against its plain version on the arguments `a`
    (argument name -> value, in the wrapper's order), with the kernel's
    tolerance and why, its bound (the function's least work and bytes on
    these inputs) and the PyTorch call that computes the same function where
    there is one; -> (record, tolerance, within it, the inputs' shapes).
    `ctc_inputs` ({key: [calls, lattice_inputs' arguments]}) holds the CTC
    log-probs and labels behind a CTC kernel's inputs, for F.ctc_loss."""
    import importlib

    import torch.nn.functional as F

    modname, wrapper, plain_name, source, replaces = WRAPPERS[name]
    mod = importlib.import_module(modname)
    kernel, plain = getattr(mod, wrapper), getattr(mod, plain_name)
    args = tuple(a.values())
    got = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    got, ref = ((x,) if isinstance(x, torch.Tensor) else tuple(x) for x in (got, ref))
    stats_err = None
    if name == "relpos_attention" and len(got) == 3:  # saved=True: (out, out32, lse)
        stats_err = _stats_err(torch, got[1:], ref[1:])
        got, ref = got[:1], ref[:1]
    diffs = [(x.float() - y.float()).abs() for x, y in zip(got, ref)]
    err = max(float(d.max()) for d in diffs)
    rels = [float(d.max()) / max(float(y.float().abs().max()), 1e-30) for d, y in zip(diffs, ref)]
    inputs = ", ".join(f"{k} {str(v.dtype)[6:]}{list(v.shape)}" for k, v in a.items()
                       if isinstance(v, torch.Tensor) and v.dim() >= 2)
    inputs += "".join(f", {k} None" for k, v in a.items() if v is None)
    library, plain_iters, timing, bound_fp32 = None, 30, "events", None

    if name == "fbank":
        rows, n_fft = a["frames"].shape
        n_freq, n_mels = a["mel"].shape
        # a bin far below its frame's loudest bin is a sum of 1024 terms that
        # cancel, so fp32 sums in another order move it by up to ~1e-2 dB;
        # with bf16 operands a power bin may also round to the neighbouring
        # bf16 value, 10*log10(1 + 2**-7) = 0.034 dB
        tol = 2e-2 if a["precision"] == "highest" else 5e-2
        ok = err <= tol
        why = f"{tol} dB: fp32 sums in another order, cancelling bins" + (
            "" if a["precision"] == "highest" else ", and one bf16 ulp of a power bin")
        # the least work: a real FFT per frame (2.5 n log2 n), the window,
        # |X|^2, the mel product over the filters' nonzeros, max and log;
        # bytes: the frames, window and mel matrix in, the log-mel out
        flops = rows * (2.5 * n_fft * math.log2(n_fft) + n_fft + 3 * n_freq
                        + 2 * int((a["mel"] != 0).sum()) + 2 * n_mels)
        peak, nbytes = PEAK_FP32, 4 * (rows * n_fft + n_fft + n_freq * n_mels + rows * n_mels)
    elif name in ("relpos_attention", "relpos_attention_bwd"):
        q, k, p, v, mask, h = a["q"], a["k"], a["p"], a["v"], a["mask"], a["n_head"]
        b, t, d = q.shape
        s, dk, es = k.shape[1], d // h, q.element_size()
        fp32 = q.dtype == torch.float32
        pairs = int(mask.expand(b, t, s).sum())  # unmasked (query, key) pairs per head
        peak = PEAK_FP32 if fp32 else PEAK_BF16
        # library yardstick: SDPA on [q+u | q+v], [k | p], v
        heads = lambda x: x.view(x.shape[0], -1, h, dk).transpose(1, 2)
        sq = torch.cat([heads(q + a["u_bias"]), heads(q + a["v_bias"])], dim=-1)
        sk = torch.cat([heads(k), heads(p).expand(b, -1, -1, -1)], dim=-1)
        sdpa = dict(attn_mask=mask[:, None], scale=a["scale"])
        if name == "relpos_attention":
            tol = 1e-5 if fp32 else 1e-2
            ok = all(bool((dd <= tol + tol * y.float().abs()).all()) for dd, y in zip(diffs, ref))
            why = f"{tol} + {tol}*|ref|: " + (
                "fp32 sums in another order" if fp32 else
                "bf16 roundings of the output and the probabilities at other points, 2**-8 each")
            flops = pairs * h * 6 * dk  # scores 4 dk, a.v 2 dk per pair
            nbytes = es * (2 * b * t * d + 2 * b * s * d + s * d + 2 * d) + mask.numel()
            if stats_err is not None:  # the fp32 output and each row's log-sum-exp out
                ok = ok and stats_err[1]
                why += (f"; saved fp32 output and lse max_abs_err {stats_err[0]:.3g} (tol 1e-4 + "
                        f"1e-5*|ref|, a fully masked row's lse -inf on both sides: fp32 sums "
                        f"in another order, bf16 p in two bf16 parts, 16 bits)")
                nbytes += 4 * (b * h * t + b * t * d)
                timing = "profiler"  # 30 plain calls with the logsumexp outlast the sleep
            library = lambda: F.scaled_dot_product_attention(sq, sk, heads(v), **sdpa)
        else:
            tol = 1e-4 if fp32 else 2.0 ** -6
            ok = max(rels) <= tol
            why = f"{tol:.3g} of each output's max|ref|: " + (
                "fp32 sums in another order, dp/du/dvb added with atomics in an order that "
                "changes between runs" if fp32 else
                "ds rounds to bf16 before the products, a value on a rounding edge may round "
                "the other way, and the outputs round to bf16")
            # scores 4 dk, da, dv and dq 2 dk each, dk|dp 4 dk; bytes: q, k, v,
            # p, do, the biases, the mask and the forward's saved fp32 output and
            # log-sum-exp in, dq, dk, dv, fp32 dp, du, dvb out
            flops = pairs * h * 14 * dk
            nbytes = (es * (3 * b * t * d + 4 * b * s * d + s * d + 2 * d)
                      + 4 * (b * t * d + s * d + 2 * d + b * h * t) + mask.numel())
            lib_in = [x.detach().requires_grad_() for x in (sq, sk, heads(v))]
            lib_out = F.scaled_dot_product_attention(*lib_in, **sdpa)
            lib_g = heads(a["do"])
            library = lambda: torch.autograd.grad(lib_out, lib_in, lib_g, retain_graph=True)
            plain_iters, timing = 10, "profiler"
    elif name in ("rnnt_fused_fwd", "rnnt_fused_bwd"):
        enc, pred, w = a["enc_p"], a["pred_p"], a["w"]
        b, t, d = enc.shape
        u1, v = pred.shape[1], w.shape[1]
        rows = b * t * u1
        io = b * t * d + b * u1 * d + d * v + v
        # the bound at the card's own floor for fp32 products: 3xTF32 (three
        # TF32 passes a product); the fp32 CUDA-core figure beside it
        if name == "rnnt_fused_fwd":
            tol = 5e-4
            ok = err <= tol
            why = (f"{tol}: 3xTF32 products (about 21 bits) and fp32 sums of {d} in another "
                   f"order on logits up to ~10, ~1e-5 expected; the online logsumexp (ex2.approx "
                   f"terms) against torch's; the same bits in every run")
            work, nbytes = 2.0 * rows * d * v, 4 * (io + b * (u1 - 1) + 3 * rows)
        else:
            tol = 1e-4
            ok = max(rels) <= tol
            why = (f"{tol} of each output's max|ref|: 3xTF32 products (about 21 bits) and "
                   f"fp32 sums in another order, the same order in every run")
            work, nbytes = 6.0 * rows * d * v, 4 * (2 * io + b * (u1 - 1) + 3 * rows)
        flops, peak = 3 * work, PEAK_TF32
        bound_fp32 = max(work / PEAK_FP32, nbytes / HBM_BPS) * 1e3
        why += f"; bound at the fp32 CUDA-core peak {bound_fp32:.4f} ms"
    elif name in ("rnnt_alpha", "ctc_alpha"):
        (ga, gll), (ra, rll) = got, ref
        live = ra > -1e29
        ok = torch.equal(live, ga > -1e29) and torch.equal(rll > -1e29, gll > -1e29)
        err = max(float((ga - ra)[live].abs().max()), float((gll - rll).abs().max()))
        ok = ok and bool(((ga - ra).abs() <= 1e-3 + 1e-5 * ra.abs())[live].all())
        ok = ok and bool(((gll - rll).abs() <= 1e-3 + 1e-5 * rll.abs()).all())
        why = ("1e-3 + 1e-5*|ref| over reachable cells, which must match: fp32 log-adds "
               "whose exp/log1p may differ from torch's by an ulp (CTC's warp route: one "
               "three-term log-add, ex2/lg2, rounded once where plain rounds twice), over every "
               "dependent step")
        peak, plain_iters, timing = PEAK_FP32, 5, "profiler"
        if name == "rnnt_alpha":
            b, t, u1 = a["blank_lp"].shape
            flops, nbytes = 10.0 * b * t * u1, 4 * (2 * b * t * u1 + b * t * (u1 - 1) + 2 * b)
        else:
            b, t, s = a["lp_states"].shape
            active = int(torch.clamp(a["tlens"], 0, t).sum()) * s
            flops, nbytes = 13.0 * active, 4 * (2 * b * t * s + 2 * b) + 2 * b * s
            library = _ctc_library(torch, a, ctc_inputs, backward=False)
    elif name in ("rnnt_beta_grad", "ctc_beta_grad"):
        ok = all(bool((dd <= 2e-3 * y.abs() + 1e-5).all()) for dd, y in zip(diffs, ref))
        why = "2e-3*|ref| + 1e-5: exp of a log-domain sum carrying alpha's error"
        peak, plain_iters, timing = PEAK_FP32, 5, "profiler"
        if name == "rnnt_beta_grad":
            b, t, u1 = a["blank_lp"].shape
            cells = b * t * u1
            flops, nbytes = 20.0 * cells, 4 * (4 * cells + 2 * b * t * (u1 - 1) + 3 * b)
        else:
            b, t, s = a["lp_states"].shape
            active = int(torch.clamp(a["tlens"], 0, t).sum()) * s
            flops, nbytes = 19.0 * active, 4 * (3 * b * t * s + 3 * b) + 2 * b * s
            library = _ctc_library(torch, a, ctc_inputs, backward=True)
    else:  # ffn_fwd, ffn_bwd
        x, h = a["x"], a["w1"].shape[0]
        r, d = x.shape
        fp32 = x.dtype == torch.float32
        es, peak = x.element_size(), PEAK_FP32 if fp32 else PEAK_BF16
        masks = 0 if a["mask1"] is None else r * (h + d)
        timing = "profiler"  # a plain FFN enqueues too many launches for the sleep
        if name == "ffn_fwd":
            tol = 1e-5 if fp32 else 2.0 ** -7
            why = "fp32 sums in another order" if fp32 else (
                "the same bf16 rounding points, but a sum in another order can cross a bf16 "
                "rounding edge (one ulp is 2**-8 relative)")
            # x, out, both weights, LN scale/bias and biases, the masks
            flops = 4.0 * r * d * h
            nbytes = es * (2 * r * d + 2 * d * h) + 4 * (3 * d + h) + masks
        else:
            tol = 1e-4 if fp32 else 2.0 ** -6
            why = ("fp32 sums in another order (the same order in every run)" if fp32 else
                   "dy, the activation and dh round to bf16 before the products, a value on "
                   "a rounding edge may round the other way; dx rounds to bf16")
            # five products; x, do, the weights and masks in, dx and the fp32
            # weight and vector gradients out
            flops = 10.0 * r * d * h
            nbytes = (es * (3 * r * d + 2 * d * h) + 4 * (2 * d + h) + masks
                      + 4 * (2 * d * h + 3 * d + h))
        ok = max(rels) <= tol
        why = f"{tol:.3g} of each output's max|ref|: {why}"
    if not ok and len(rels) > 1:
        why += f"; error / max|ref| per output: {', '.join(f'{r:.3g}' for r in rels)}"
    rec = _record(torch, name, source, replaces, err, flops, peak, nbytes,
                  lambda: kernel(*args), lambda: plain(*args), library, plain_iters, timing)
    if stats_err is not None:
        rec["saved_max_abs_err"] = stats_err[0]
    if bound_fp32 is not None:
        rec["bound_fp32_ms"] = bound_fp32
    return rec, why, bool(ok), inputs


def _stats_err(torch, got, ref) -> tuple[float, bool]:
    """What the forward saves for the backward (the fp32 output and each
    row's log-sum-exp) against the plain version's: -> (max abs error, every
    entry within 1e-4 + 1e-5*|ref| and a fully masked row's lse -inf on both
    sides)."""
    err, ok = 0.0, True
    for x, r in zip(got, ref):
        live = torch.isfinite(r)
        ok = ok and torch.equal(live, torch.isfinite(x)) and bool((x[~live] == -torch.inf).all())
        d = (x - r).abs()[live]
        if d.numel():
            err = max(err, float(d.max()))
            ok = ok and bool((d <= 1e-4 + 1e-5 * r[live].abs()).all())
    return err, ok


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol in a
    source's anonymous namespace (`_ZN<n><namespace><n>relpos_fwd_kernelIfLi64EEEv...`
    -> `relpos_fwd_kernel<float, 64>`), else the symbol."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    n = m and re.match(r"\d+", mangled[m.end(1) + int(m.group(1)):])
    if not n:
        return mangled
    start = m.end(1) + int(m.group(1)) + n.end()
    name, rest = mangled[start:start + int(n.group())], mangled[start + int(n.group()):]
    if not rest.startswith("I"):
        return name
    args, tok = [], re.compile(r"f|13__nv_bfloat16|L[ib]\d+E")  # the sources' kinds
    pos = 1
    while (t := tok.match(rest, pos)) is not None:
        args.append({"f": "float", "13__nv_bfloat16": "bf16"}.get(t.group(), t.group()[2:-1]))
        pos = t.end()
    return f"{name}<{', '.join(args)}>"


def _ctc_library(torch, a, ctc_inputs, backward: bool):
    """F.ctc_loss (forward, or its backward on a retained graph) on the
    log-probs and labels whose lattice inputs are the CTC kernel's `a`, or
    None when `ctc_inputs` holds none."""
    import torch.nn.functional as F

    b, t, s = a["lp_states"].shape
    match = [x for _, x in ctc_inputs.values()
             if tuple(x["log_probs"].shape[:2]) == (b, t) and 2 * x["labels"].shape[1] + 1 == s]
    if not match:
        return None
    x = match[0]
    lp = x["log_probs"].detach().transpose(0, 1)
    # a batch's padding rows have no frames (encoder length -1 clamps to 0)
    lens = (x["labels"].long(), tuple(max(int(n), 0) for n in a["tlens"]),
            tuple(int(n) for n in x["label_lens"]))
    kw = dict(blank=x["blank"], reduction="sum", zero_infinity=True)
    if not backward:
        return lambda: F.ctc_loss(lp, *lens, **kw)
    lp = lp.requires_grad_()
    loss = F.ctc_loss(lp, *lens, **kw)
    return lambda: torch.autograd.grad(loss, lp, retain_graph=True)


def _flagship(dtype: str, fused_ffn: bool = False):
    """The reference flagship (__graft_entry__._flagship_config on an
    accelerator): causal dynamic-chunk conformer, static chunk 32, the
    rel-pos attention kernel on the full-context path; with `fused_ffn` the
    FFNs through kernel #10."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    enc = cfg.model.encoder
    enc.causal, enc.use_dynamic_chunk, enc.static_chunk_size = True, True, 32
    enc.fused_attention, enc.fused_ffn = True, fused_ffn
    return cfg


def _model(torch, cfg, device, blank_bias: float = 0.0):
    from tpuasr_torch.models import Transducer, init_weights

    model = init_weights(Transducer(cfg.model, device=device), SEED)
    with torch.no_grad():
        model.joint.ffn_out_bias[cfg.model.blank_id] = blank_bias
    return model


def _fit_blank_bias(torch, model, cfg, waves, wave_lens, text_lens) -> float:
    """Set the blank logit (bisection on [0, 16]) so that greedy search on
    the requests emits as many tokens per encoder frame as their
    transcripts hold; -> the bias. A random model otherwise emits up to
    n_steps tokens per frame, and the greedy loop's cost scales with that."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import rnnt_greedy_decode

    feats, flens = fbank_batch(waves, wave_lens, cfg.feature, device=model.device)
    enc, elens = model.encode(feats, flens)
    target = float(text_lens.sum()) / float(elens.sum())
    bias = model.joint.ffn_out_bias
    blank = cfg.model.blank_id

    def rate(b: float) -> float:
        with torch.no_grad():
            bias[blank] = b
        _, lens = rnnt_greedy_decode(model, enc, elens, blank)
        return float(lens.sum()) / float(elens.sum())

    free = rate(0.0)
    lo, hi = 0.0, 16.0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if rate(mid) > target else (lo, mid)
    got = rate(hi)
    print(f"blank logit bias {hi:.4f}: {got:.4f} tokens per encoder frame, target "
          f"{target:.4f} from the transcripts ({int(text_lens.sum())} tokens over "
          f"{int(elens.sum())} frames); {free:.4f} with no bias")
    return hi


def _serve(torch, dev, data) -> tuple[dict, tuple]:
    """Phases 4-5; -> (the serving records, the fp32 flagship and its config
    with the fitted blank logit)."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import rnnt_greedy_decode, streaming_greedy_decode
    from tpuasr_torch.eval import make_offline_decoder, measure_rtf
    from tpuasr_torch.streaming import num_chunks

    print("== phase 4: offline serving (make_offline_decoder rnnt_greedy)")
    cfg32 = _flagship("float32")
    waves, wave_lens = data["fixture"]
    gpu32 = _model(torch, cfg32, dev)
    bias = _fit_blank_bias(torch, gpu32, cfg32, waves, wave_lens, data["text_lens"])
    cpu32 = _model(torch, cfg32, "cpu", bias)
    dec_gpu = make_offline_decoder(gpu32, cfg32, "rnnt_greedy")
    toks_g, lens_g = dec_gpu(waves, wave_lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_g, lens_g = dec_gpu(waves, wave_lens)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    toks_c, lens_c = make_offline_decoder(cpu32, cfg32, "rnnt_greedy")(waves, wave_lens)

    feats_g, flen_g = fbank_batch(waves, wave_lens, cfg32.feature, device=dev)
    feats_c, flen_c = fbank_batch(waves, wave_lens, cfg32.feature, device="cpu")
    feat_err = float((feats_g.cpu() - feats_c).abs().max())
    enc_g, _ = gpu32.encode(feats_g, flen_g)
    enc_c, _ = cpu32.encode(feats_c, flen_c)
    enc_err = float((enc_g.cpu() - enc_c).abs().max())
    same = torch.equal(toks_g.cpu(), toks_c) and torch.equal(lens_g.cpu(), lens_c)
    print(f"fp32 card vs CPU on {len(wave_lens)} requests: feature max_abs_err "
          f"{feat_err:.3g} dB (tol 2e-2: fp32 DFT sums in another order, cancelling "
          f"bins), encoder "
          f"max_abs_err {enc_err:.3g} (tol 2e-3: fp32 sums in another order through 12 "
          f"blocks, unit-scale output), tokens identical: {same} "
          f"(emitted {int(lens_g.sum())}); card latency {ms32:.1f} ms")
    require(feat_err <= 2e-2 and enc_err <= 2e-3, "card and CPU encoder outputs differ")
    require(same, "fp32 tokens on the card differ from the CPU run")
    stages = _offline_stages(torch, gpu32, cfg32, waves, wave_lens, ms32)

    # the same weights with the FFNs through kernel #10
    cfg32f = _flagship("float32", fused_ffn=True)
    gpu32f = _model(torch, cfg32f, dev, bias)
    require(all(torch.equal(a, b) for a, b in zip(gpu32.state_dict().values(),
                                                  gpu32f.state_dict().values())),
            "the fused-FFN model's weights differ")
    dec_f = make_offline_decoder(gpu32f, cfg32f, "rnnt_greedy")
    dec_f(waves, wave_lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_f, lens_f = dec_f(waves, wave_lens)
    torch.cuda.synchronize()
    ms32f = (time.perf_counter() - t0) * 1e3
    enc_f, _ = gpu32f.encode(feats_g, flen_g)
    enc_ferr = float((enc_f - enc_g).abs().max())
    same_f = torch.equal(toks_f, toks_g) and torch.equal(lens_f, lens_g)
    print(f"fp32 fused_ffn=True vs False on the card, {len(wave_lens)} requests: encoder "
          f"max_abs_err {enc_ferr:.3g} (tol 2e-3, as card vs CPU), tokens identical: {same_f}; "
          f"latency {ms32f:.1f} ms (fused_ffn=False {ms32:.1f} ms)")
    require(enc_ferr <= 2e-3, "the fused-FFN encoder output differs")
    require(same_f, "fp32 tokens with fused_ffn=True differ from fused_ffn=False")

    cfg16 = _flagship("bfloat16")
    gpu16, cpu16 = _model(torch, cfg16, dev, bias), _model(torch, cfg16, "cpu", bias)
    # the same fp32 features into both bf16 encoders: the check is the
    # encoder's, and the noise it is held to is bf16's own (bf16 vs fp32)
    enc16_g, _ = gpu16.encode(feats_c.to(dev), flen_c.to(dev))
    enc16_c, _ = cpu16.encode(feats_c, flen_c)
    d_card = (enc16_g.float().cpu() - enc16_c.float()).abs()
    d_noise = (enc16_c.float() - enc_c).abs()
    print(f"bf16 encoder, card vs CPU on {len(wave_lens)} requests: max_abs_err "
          f"{float(d_card.max()):.4g}, mean {float(d_card.mean()):.4g}; bf16's own noise "
          f"(CPU bf16 vs CPU fp32): max {float(d_noise.max()):.4g}, mean "
          f"{float(d_noise.mean()):.4g} (tol: 2x that noise; the two runs round partly at "
          f"other points, e.g. the attention kernel rounds unnormalised probabilities and "
          f"the plain version normalised ones, so their difference is itself bf16 noise)")
    require(enc16_g.dtype == torch.bfloat16 and enc16_c.dtype == torch.bfloat16,
            "the bf16 encoders did not compute in bf16")
    require(float(d_card.max()) <= 2 * float(d_noise.max())
            and float(d_card.mean()) <= 2 * float(d_noise.mean()),
            "the card's bf16 encoder output differs from the CPU's by more than bf16 noise")
    dec16 = make_offline_decoder(gpu16, cfg16, "rnnt_greedy")
    serving = {"offline_fp32_ms_16req": ms32, "offline_fp32_stages": stages,
               "offline_fp32_fused_ffn_ms_16req": ms32f,
               "fused_ffn_encoder_max_abs_err": enc_ferr,
               "blank_logit_bias": bias, "bf16_card_vs_cpu_encoder_max_abs_err":
               float(d_card.max()), "bf16_vs_fp32_encoder_max_abs_err": float(d_noise.max())}
    for src in ("fixture", "synthetic"):
        w, wl = data[src]
        dec16(w, wl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t16, l16 = dec16(w, wl)
        torch.cuda.synchronize()
        ms16 = (time.perf_counter() - t0) * 1e3
        ref_t, ref_l = (toks_g, lens_g) if src == "fixture" else \
            make_offline_decoder(gpu32, cfg32, "rnnt_greedy")(w, wl)
        n = torch.maximum(l16, ref_l)
        pos = torch.arange(t16.shape[1], device=dev)[None] < n[:, None]
        agree = float(((t16 == ref_t) & pos).sum() / pos.sum().clamp(min=1))
        print(f"bf16 offline on {src} ({len(wl)} requests, "
              f"{float(wl.max()) / 48000:.2f} s longest): latency {ms16:.1f} ms, "
              f"token agreement with fp32 {agree:.3f}")
        serving[f"offline_bf16_ms_{src}"] = ms16
        serving[f"bf16_fp32_token_agreement_{src}"] = agree

    print(f"== phase 5: streaming serving (chunk {CHUNK}, {LEFT} left chunks)")
    for src, (model, ffn) in itertools.product(("fixture", "synthetic"),
                                               ((gpu32, False), (gpu32f, True))):
        w, wl = data[src]
        feats, flens = fbank_batch(w, wl, cfg32.feature, device=dev)
        full, full_lens = model.encode(feats, flens, CHUNK, LEFT)
        n = num_chunks(feats.shape[1], CHUNK, 4, 6)
        # streaming sees whole chunks and never masks padding: decode the
        # frames of the whole chunks inside each request's valid length
        whole = torch.clamp(full_lens.long(), max=n * CHUNK) // CHUNK * CHUNK
        off_t, off_l = rnnt_greedy_decode(model, full, whole, cfg32.model.blank_id)
        st_t, st_l, _ = streaming_greedy_decode(model, feats, whole * 4 + 3, CHUNK, LEFT,
                                                cfg32.model.blank_id)
        ok = torch.equal(st_t, off_t) and torch.equal(st_l, off_l)
        print(f"streaming == chunk-masked offline on {src}, fused_ffn={ffn} "
              f"({int(whole.sum())} frames, {int(st_l.sum())} tokens): {ok}")
        require(ok, f"streaming tokens differ from chunk-masked offline ({src}, "
                    f"fused_ffn={ffn})")

    feats16, _ = fbank_batch(*data["synthetic"], cfg16.feature, device=dev)
    for label, model, cfg in (("bf16", gpu16, cfg16), ("fp32", gpu32, cfg32)):
        st = measure_rtf(model, feats16, cfg, "greedy")
        print(f"streaming RTF {label} (4 streams, {st.n_chunks} chunks of "
              f"{st.chunk_audio_seconds:.3f} s): p50 {st.rtf_p50:.5f} p90 {st.rtf_p90:.5f} "
              f"on {st.device}")
        serving[f"rtf_p50_{label}"] = st.rtf_p50
        serving[f"rtf_p90_{label}"] = st.rtf_p90
    serving["stream_bf16_chunk_stages"] = _stream_stages(torch, gpu16, cfg16, feats16)
    return serving, (gpu32, cfg32)


def _synced_ms(torch, fn):
    """(fn(), host ms) with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _count_steps(model):
    """Count predictor steps (= emission-loop iterations, one host sync
    each) by wrapping the model's predict_step; -> (counter, restore)."""
    steps = [0]
    step = model.predict_step

    def counted(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    model.predict_step = counted
    return steps, lambda: delattr(model, "predict_step")


def _decode_busy(torch, dec, waves, wave_lens) -> tuple[float, list]:
    """The device's busy ms over one offline decode (torch.profiler), and
    its device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dec(waves, wave_lens)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kern) / 1e3, kern


def _fbank_route_ab(torch, model, cfg, waves, wave_lens) -> dict:
    """The offline fp32 request batch's device busy ms with "highest" fbank
    by the FFT route and by the dense kernel (the plan fixed to it), in
    turns (FFT, dense, dense, FFT) in this process, after the serving run's
    launches are read; -> {route: [ms, ms]}."""
    import tpuasr_torch.ops.fbank as fbank_mod
    from tpuasr_torch.eval import make_offline_decoder

    dec = make_offline_decoder(model, cfg, "rnnt_greedy")
    real, busy = fbank_mod._fbank_fft_plan, {"fbank_fft": [], "fbank_fp32": []}
    try:
        for route in ("fbank_fft", "fbank_fp32", "fbank_fp32", "fbank_fft"):
            fbank_mod._fbank_fft_plan = real if route == "fbank_fft" else \
                (lambda r, *a: {"route": "fbank_fp32"})
            dec(waves, wave_lens)  # warm
            busy[route].append(_decode_busy(torch, dec, waves, wave_lens)[0])
    finally:
        fbank_mod._fbank_fft_plan = real
    mean = {k: sum(v) / len(v) for k, v in busy.items()}
    print(f"offline fp32 request batch, device busy ms by fbank route (in turns FFT, dense, "
          f"dense, FFT): FFT {busy['fbank_fft']}, the dense kernel {busy['fbank_fp32']}; "
          f"means {mean['fbank_fft']:.3f} / {mean['fbank_fp32']:.3f}, change "
          f"{mean['fbank_fft'] - mean['fbank_fp32']:+.3f} ms")
    return busy


def _offline_stages(torch, model, cfg, waves, wave_lens, wall_ms) -> dict:
    """Where the offline request time goes: host ms of fbank, encoder and
    greedy search (each closed by a sync), the greedy loop's emission steps,
    and the device's busy time from the profiler over one whole decode."""
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.decode import rnnt_greedy_decode
    from tpuasr_torch.eval import make_offline_decoder

    steps, restore = _count_steps(model)
    try:
        (feats, flens), t_fb = _synced_ms(
            torch, lambda: fbank_batch(waves, wave_lens, cfg.feature, device=model.device))
        (enc, elens), t_enc = _synced_ms(torch, lambda: model.encode(feats, flens))
        _, t_dec = _synced_ms(torch, lambda: rnnt_greedy_decode(model, enc, elens,
                                                                cfg.model.blank_id))
    finally:
        restore()
    busy_ms, kern = _decode_busy(torch, make_offline_decoder(model, cfg, "rnnt_greedy"),
                                 waves, wave_lens)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    print(f"offline fp32 stages: fbank {t_fb:.2f} ms, encode {t_enc:.2f} ms, greedy "
          f"{t_dec:.2f} ms over {steps[0]} emission steps (one host sync each); device "
          f"busy {busy_ms:.2f} ms (profiler) of a {wall_ms:.1f} ms request batch")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return {"fbank_ms": t_fb, "encode_ms": t_enc, "greedy_ms": t_dec,
            "emission_steps": steps[0], "device_busy_ms": busy_ms}


def _stream_stages(torch, model, cfg, feats) -> dict:
    """Per-chunk host ms of the chunk encoder and of greedy search."""
    from tpuasr_torch.decode import greedy_frames, init_streaming_state
    from tpuasr_torch.streaming import chunk_windows, num_chunks

    chunk, left, blank = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks, \
        cfg.model.blank_id
    n = num_chunks(feats.shape[1], chunk, 4, 6)
    windows = chunk_windows(feats, chunk, 4, 6, n)
    state = init_streaming_state(model, feats.shape[0], chunk, left, blank)
    enc_state, dec = state.enc, state.dec
    t_enc, t_dec = [], []
    steps, restore = _count_steps(model)
    try:
        for i in range(n):
            (ys, enc_state), te = _synced_ms(torch, lambda: model.encode_chunk(windows[i],
                                                                               enc_state))
            valid = torch.ones(ys.shape[:2], dtype=torch.bool, device=ys.device)
            dec, td = _synced_ms(torch, lambda: greedy_frames(model, ys, valid, dec, blank,
                                                              cfg.streaming.n_steps))
            t_enc.append(te)
            t_dec.append(td)
    finally:
        restore()
    res = {"encode_chunk_ms_median": sorted(t_enc)[n // 2],
           "greedy_ms_median": sorted(t_dec)[n // 2], "emission_steps": steps[0],
           "chunks": n}
    print(f"streaming bf16 per chunk (median of {n}): encode_chunk "
          f"{res['encode_chunk_ms_median']:.2f} ms, greedy {res['greedy_ms_median']:.2f} ms; "
          f"{steps[0]} emission steps in all")
    return res


# ---------------------------------------------------------------------------
# training: kernels #4-#9 and phase 6
# ---------------------------------------------------------------------------

BENCH_B, BENCH_FRAMES, BENCH_TOKENS = 12, 768, 32  # bench.py:78-80
HOP, SR = 512, 48000


def _bench_batch(torch, dev) -> dict:
    """bench.py's batch (bench.py:83-90) through the port's copies of
    `synth_corpus` and `make_batch`: 12 utterances of 24-30 content tokens
    plus SOS and EOS, (frames - 6) * hop // 30 samples per token, padded to
    (frames - 1) * hop samples and 32 tokens; as tensors on `dev`."""
    from tpuasr_torch.config import Config
    from tpuasr_torch.data import BatchSpec, make_batch, synth_corpus, tensors

    cfg = Config()
    utts = synth_corpus(BENCH_B, cfg.model.vocab_size, seed=0, min_tokens=24, max_tokens=30,
                        sample_rate=cfg.feature.sample_rate,
                        samples_per_token=(BENCH_FRAMES - 6) * cfg.feature.hop_length // 30)
    spec = BatchSpec(BENCH_B, (BENCH_FRAMES - 1) * cfg.feature.hop_length, BENCH_TOKENS)
    batch = tensors(make_batch(utts, spec), dev)
    print(f"bench.py's batch: {BENCH_B} waves of {spec.wave_samples} samples, "
          f"{float(batch['wave_lens'].sum()) / SR:.2f} s of audio, label lengths "
          f"{batch['text_lens'].tolist()}")
    return batch


def _enc_len(wave_lens):
    """Encoder frames of waves: fbank frames 1 + n // hop, then rate-4
    subsampling."""
    f = 1 + wave_lens // HOP
    return ((f - 1) // 2 - 1) // 2


def _train_kernel_checks(torch, dev, bench) -> tuple[dict, dict]:
    """Kernels #4-#9 against their plain versions at the training step's
    shapes (and a ragged shape with a t_len = 0 and a label_len = 0 row);
    -> ({name: record at the bench shape}, {shape: #4's plan there})."""
    import numpy as np
    import torch.nn.functional as F

    from tpuasr_torch.losses.ctc import lattice_inputs
    from tpuasr_torch.ops import (
        ctc_alpha_plain, ctc_beta_grad, rnnt_alpha_plain, rnnt_beta_grad_plain, rnnt_fused_grads,
        rnnt_fused_lp,
    )
    from tpuasr_torch.ops.rnnt_lattice import mask_lattice_inputs

    out, plans = {}, {}  # plans: #4's at each shape, kept out of the kernels line
    blank = 5
    wave_lens = bench["wave_lens"].cpu().numpy()
    bench_t = int(_enc_len(np.array([(BENCH_FRAMES - 1) * HOP]))[0])
    shapes = (("bench", BENCH_B, bench_t, BENCH_TOKENS, 256, 412, _enc_len(wave_lens),
               bench["text_lens"].cpu().numpy()),
              ("ragged", 3, 37, 5, 256, 97, np.array([37, 0, 20]), np.array([5, 3, 0])))
    g = torch.Generator().manual_seed(SEED)
    for tag, b, t, u, d, v, t_lens, u_lens in shapes:
        enc = torch.randn(b, t, d, generator=g).to(dev)
        pred = torch.randn(b, u + 1, d, generator=g).to(dev)
        w = (torch.randn(d, v, generator=g) / math.sqrt(d)).to(dev)
        bias = (0.1 * torch.randn(v, generator=g)).to(dev)
        lab = torch.randint(0, v - 1, (b, u), generator=g)
        lab = (lab + (lab >= blank).long()).to(torch.int32).to(dev)  # never the blank
        tl = torch.as_tensor(t_lens, dtype=torch.int32).to(dev)
        ul = torch.as_tensor(u_lens, dtype=torch.int32).to(dev)
        recs = {}
        joint = dict(enc_p=enc, pred_p=pred, w=w, b=bias, labels=lab)

        # #4: blank/label log-probs and the logsumexp; #8 / #9: the lattice
        # over the fused route's masked log-probs (the materialized route
        # hands the lattice the same [B, T, U+1] inputs)
        recs["rnnt_fused_fwd"] = _hold(torch, "rnnt_fused_fwd", dict(joint, blank=blank), tag)
        blank_lp, label_full, lse = rnnt_fused_lp(enc, pred, w, bias, lab, blank)
        again = rnnt_fused_lp(enc, pred, w, bias, lab, blank)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip((blank_lp, label_full, lse), again)),
                f"two calls of rnnt_fused_lp on the same inputs differ ({tag})")
        plans[tag] = _joint_fwd_plan_line(torch, enc, pred, w, tag)
        msg = f"rnnt_fused_fwd {tag}: two calls bit-identical"
        if tag == "bench":
            split = _device_split(torch, lambda: rnnt_fused_lp(enc, pred, w, bias, lab, blank))
            recs["rnnt_fused_fwd"]["device_split_ms"] = split
            msg += "; device ms a call by kernel (profiler): " + "; ".join(
                f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1]))
        print(msg)
        if tag == "bench":
            for tt in (63, 127):  # the trainer's T' at its batch of 12, U+1 17
                trainer = dict(enc_p=enc[:, :tt].contiguous(), pred_p=pred[:, :17].contiguous(),
                               w=w, b=bias, labels=lab[:, :16].contiguous(), blank=blank)
                rec = _hold(torch, "rnnt_fused_fwd", trainer, f"T'{tt}")
                plans[f"T'{tt}"] = _joint_fwd_plan_line(torch, trainer["enc_p"],
                                                        trainer["pred_p"], w, f"T'{tt}")
                recs["rnnt_fused_fwd"][f"trainer_shape_t{tt}"] = rec
        bm, lm, pad_t, lv = mask_lattice_inputs(blank_lp, label_full[:, :, :-1], tl, ul)
        lattice = dict(blank_lp=bm, label_lp=lm, u_lens=ul)
        recs["rnnt_alpha"] = _hold(torch, "rnnt_alpha", lattice, tag)
        ra, rll = rnnt_alpha_plain(bm, lm, ul)
        gvec = (0.5 + torch.rand(b, generator=g)).to(dev)
        recs["rnnt_beta_grad"] = _hold(torch, "rnnt_beta_grad", dict(
            lattice, alpha=ra.contiguous(), ll=rll.contiguous(), g=gvec), tag)

        # #5: gradients from the lattice's occupancies (mean over B)
        zero = torch.zeros((), device=dev)
        occ_b, occ_l = rnnt_beta_grad_plain(bm, lm, ul, ra, rll, torch.ones(b, device=dev))
        gb = torch.where(pad_t, zero, -occ_b / b).contiguous()
        gl = F.pad(torch.where(lv, -occ_l / b, zero), (0, 1)).contiguous()
        bwd = dict(joint, lse=lse, gb=gb, gl=gl, blank=blank)
        recs["rnnt_fused_bwd"] = _hold(torch, "rnnt_fused_bwd", bwd, tag)
        first, again = rnnt_fused_grads(*bwd.values()), rnnt_fused_grads(*bwd.values())
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(first, again)),
                f"two calls of rnnt_fused_bwd on the same inputs differ ({tag})")
        msg = f"rnnt_fused_bwd {tag}: two calls bit-identical"
        if tag == "bench":
            split = _device_split(torch, lambda: rnnt_fused_grads(*bwd.values()))
            recs["rnnt_fused_bwd"]["device_split_ms"] = split
            msg += "; device ms a call by kernel (profiler): " + "; ".join(
                f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1]))
        print(msg)

        # #6 / #7: the CTC lattice over log-softmaxed logits, on each route;
        # at the bench shape also at the trainer's shapes (T' 63 / 127, U+1
        # 17)
        lp = torch.log_softmax(torch.randn(b, t, v, generator=g).to(dev), dim=-1)
        ctc_shapes = [(tag, lp, lab, ul, tl)]
        if tag == "bench":
            ctc_shapes += [(f"T'{tt}", lp[:, :tt], lab[:, :16].contiguous(),
                            torch.clamp(ul, max=16), torch.clamp(tl, max=tt)) for tt in (63, 127)]
        for shape, lp_s, lab_s, ul_s, tl_s in ctc_shapes:
            lp_states, skip, final = lattice_inputs(lp_s, lab_s, ul_s, blank)
            ctc = dict(lp_states=lp_states.contiguous(), skip=skip, tlens=tl_s, final=final)
            ra, rll = ctc_alpha_plain(*ctc.values())
            beta = dict(ctc, alpha=ra.contiguous(), ll=rll.contiguous(),
                        g=(0.5 + torch.rand(b, generator=g)).to(dev))
            # F.ctc_loss on the same log-probs and labels (not at the ragged
            # shape, whose t_len = 0 row it is not asked to take)
            lib = {} if shape == "ragged" else {
                0: [1, dict(log_probs=lp_s, labels=lab_s, label_lens=ul_s, blank=blank)]}
            pair = _ctc_routes(torch, ctc, beta, shape, lib)
            if shape == tag:
                recs.update(pair)
            else:
                for name in pair:
                    recs[name][f"trainer_shape_t{shape[2:]}"] = pair[name]
            if shape == "ragged":
                require(bool((ctc_beta_grad(*beta.values())[1] == 0).all()),
                        "ctc_beta_grad: a t_len = 0 row has gradient")
        if tag == "bench":
            out = recs
    return out, plans


@contextlib.contextmanager
def _ctc_plan_as(route: str):
    """Run the CTC wrappers on `route` (the wrappers choose by shape alone)."""
    from tpuasr_torch.ops import ctc as ctc_mod

    real = ctc_mod._ctc_plan
    ctc_mod._ctc_plan = lambda s: real(s, route=route)
    try:
        yield
    finally:
        ctc_mod._ctc_plan = real


def _ctc_routes(torch, ctc, beta, tag, lib) -> dict:
    """#6 / #7 at one shape, held against their plain versions on the route
    the plan takes (the warp route at every shape of the path) and on the
    block route; -> {name: the plan's route's record}, each with its time
    per dependent step (ms / the longest t_len), two calls bit-identical,
    its device time by kernel, and the block route's record and both routes
    timed in turns (block, warp, warp, block)."""
    from tpuasr_torch.ops import ctc as ctc_mod

    s = ctc["lp_states"].shape[2]
    route = ctc_mod._ctc_plan(s)["route"]
    steps = max(int(ctc["tlens"].max()), 1)
    ghz = _sm_ghz(torch)
    out = {}
    for name, args in (("ctc_alpha", ctc), ("ctc_beta_grad", beta)):
        fn = getattr(ctc_mod, name)
        call = lambda: fn(*args.values())
        rec = _hold(torch, name, args, f"{tag}, {route} route", lib)
        first, again = call(), call()
        torch.cuda.synchronize()
        first, again = ((x,) if isinstance(x, torch.Tensor) else x for x in (first, again))
        require(all(torch.equal(x, y) for x, y in zip(first, again)),
                f"two calls of {name} on the same inputs differ ({tag})")
        split = _device_split(torch, call)
        with _ctc_plan_as(route="block"):
            block = _hold(torch, name, args, f"{tag}, block route", lib)
            block_split = _device_split(torch, call)
        turns = {"block": [], route: []}
        for r in ("block", route, route, "block"):
            with _ctc_plan_as(route=r):
                turns[r].append(_time_ms(torch, call))
        rec.update(plan_route=route, us_per_step=rec["ms"] / steps * 1e3, steps=steps,
                   sm_ghz=ghz, cycles_per_step=rec["ms"] / steps * ghz * 1e6,
                   bits_identical=True, device_split_ms=split, turns_ms=turns,
                   block_route=dict(block, us_per_step=block["ms"] / steps * 1e3,
                                    device_split_ms=block_split))
        print(f"{name} {tag}: {route} route {rec['ms']:.4f} ms, {rec['us_per_step']:.4f} us a "
              f"dependent step ({steps} steps; {rec['cycles_per_step']:.0f} cycles at the "
              f"{ghz:.3f} GHz a sleep kernel shows); block route {block['ms']:.4f} ms, "
              f"{rec['block_route']['us_per_step']:.4f} us a step; in turns (block, {route}, "
              f"{route}, block) {turns['block'][0]:.4f} {turns[route][0]:.4f} "
              f"{turns[route][1]:.4f} {turns['block'][1]:.4f}; two calls bit-identical; "
              f"device ms a call by kernel (profiler): " + "; ".join(
                  f"{ms:.4f} {key[:60]}" for key, ms in sorted(split.items(), key=lambda x: -x[1])))
        out[name] = rec
    return out


def _sm_ghz(torch) -> float:
    """The SM clock, GHz: a sleep kernel of SLEEP_CYCLES cycles timed by
    CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    torch.cuda.synchronize()
    return SLEEP_CYCLES / ev[0].elapsed_time(ev[1]) / 1e6


def _train_cfg(dtype: str, dropout: bool, fused_joint_loss: bool = True,
               fused_ffn: bool = False):
    """The flagship as bench.py trains it (bench.py:51-76): causal, static
    chunk 32, the rel-pos attention kernels, the fused joint loss (or with
    `fused_joint_loss=False` the materialized one), the fused FFN kernels with
    `fused_ffn` (bench.py's TPUASR_FUSED_FFN=1); with `dropout`, the JAX
    defaults (0.1) and dynamic chunks, else no dropout and the static
    chunk."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    cfg.model.fused_joint_loss = fused_joint_loss
    enc = cfg.model.encoder
    enc.causal, enc.static_chunk_size, enc.fused_attention = True, 32, True
    enc.fused_ffn = fused_ffn
    enc.use_dynamic_chunk = dropout
    if not dropout:
        enc.dropout_rate = enc.positional_dropout_rate = 0.0
        cfg.model.ctc_dropout_rate = 0.0
        cfg.model.predictor.dropout = 0.0
    return cfg


def _train_card_vs_cpu(torch, dev, fused_joint_loss: bool, fused_ffn: bool = False) -> dict:
    """Phase 6a: one forward, backward and GuardedAdam step of the fp32
    flagship on the card and on the CPU, same weights and batch."""
    import numpy as np

    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.train import make_optimizer

    cfg = _train_cfg("float32", dropout=False, fused_joint_loss=fused_joint_loss,
                     fused_ffn=fused_ffn)
    r = np.random.default_rng(SEED + 11)
    b, t, u = 2, 256, 16  # the shape of __graft_entry__.entry()
    host = (torch.from_numpy(r.standard_normal((b, t, 80)).astype(np.float32)),
            torch.tensor([t, 200], dtype=torch.int32),
            torch.from_numpy(r.integers(6, cfg.model.vocab_size, (b, u))),
            torch.tensor([u, 11], dtype=torch.int32))
    tx = make_optimizer(cfg.optim)
    res = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = init_weights(Transducer(cfg.model, device=device), SEED)
        model.train()
        out = model(*(x.to(device) for x in host))
        out["loss"].backward()
        params = list(model.parameters())
        p0 = [p.detach().cpu().clone() for p in params]
        grads = [p.grad.detach().clone() for p in params]
        gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        st = tx.update_guarded(grads, tx.init(params), params, torch.isfinite(gn), 1.0, gn)
        res[side] = {"losses": {k: float(v.detach()) for k, v in out.items()},
                     "gn": float(gn), "grads": [g.cpu() for g in grads], "p0": p0,
                     "p1": [p.detach().cpu() for p in params],
                     "state": [None if x is None else x.cpu() for x in st]}
    card, cpu = res["card"], res["cpu"]
    (lc, gc, grads_c), (lh, gh, grads_h) = ((x["losses"], x["gn"], x["grads"])
                                            for x in (card, cpu))
    require(all(torch.equal(x, y) for x, y in zip(card["p0"], cpu["p0"])),
            "the card's and the CPU's initial weights differ")
    names = [n for n, _ in init_weights(Transducer(cfg.model, device="cpu"),
                                        SEED).named_parameters()]
    loss_ok = all(abs(lc[k] - lh[k]) <= 1e-4 * abs(lh[k]) + 1e-4 for k in lh)
    scale = max(float(g.abs().max()) for g in grads_h)
    # the key projection's bias gets no gradient in exact arithmetic (it adds
    # q.b_k to every score of a query: softmax is shift-invariant), so its
    # gradient is rounding noise on both sides; it is held to that instead
    shift_free = [i for i, n in enumerate(names) if n.endswith("self_attn.linear_k.bias")]
    noise = max(max(float(grads_c[i].abs().max()), float(grads_h[i].abs().max()))
                for i in shift_free)
    rels = [float((a - b_).abs().max() / b_.abs().max().clamp(min=1e-30))
            for a, b_ in zip(grads_c, grads_h)]
    held = [i for i in range(len(names)) if i not in shift_free]
    order = sorted(held, key=lambda i: -rels[i])
    worst = order[0]
    print(f"fp32 training step (fused_joint_loss={fused_joint_loss}, fused_ffn={fused_ffn}), "
          f"card vs CPU on "
          f"[2, 256, 80] x 16 tokens: losses card "
          f"{lc} cpu {lh} (tol 1e-4 relative); grad norm {gc:.6g} vs {gh:.6g} (tol 1e-4 "
          f"relative); gradient error / the leaf's max|g|, the three worst: "
          f"{[(names[i], f'{rels[i]:.3g}') for i in order[:3]]} (tol 1e-3: fp32 sums in "
          f"another order through 12 blocks, the attention backward's atomics, the "
          f"fused joint's 3xTF32 products, the lattice); "
          f"the {len(shift_free)} key-projection biases (zero gradient in exact arithmetic) "
          f"reach {noise:.3g} against a largest gradient entry of {scale:.4g} (tol 1e-6 of "
          f"it: rounding noise)")
    require(loss_ok and abs(gc - gh) <= 1e-4 * gh, "card and CPU training losses differ")
    require(rels[worst] <= 1e-3, "card and CPU gradients differ")
    require(noise <= 1e-6 * scale, "a key-projection bias has more than rounding noise")
    adam = _adam_card_vs_cpu(torch, tx, card, cpu)
    return {"losses_card": lc, "losses_cpu": lh, "grad_norm_card": gc, "grad_norm_cpu": gh,
            "worst_grad_rel_err": rels[worst], **adam}


def _adam_card_vs_cpu(torch, tx, card: dict, cpu: dict) -> dict:
    """The GuardedAdam step of phase 6a, held two ways.

    1. The optimizer alone: the CPU's GuardedAdam on the card's own
       gradients, grad norm and initial weights must give the card's count,
       moments and weights. The same fp32 operations on the same inputs:
       mu and nu within 4 ulps (4 eps relative); nu_max and the weights'
       update within 1e-5 relative, because the bias correction 1 - b2**t
       cancels (one ulp of 0.98 is 3e-6 of 0.02, and powf may be off by
       two); the weights also within one ulp of their own, where p + update
       rounds.
    2. The step end to end, each side from its own gradients: the update
       p_after - p_before. A first Adam step moves an entry by
       -lr*warmup * u / (|u| + eps), u the clipped, decayed gradient
       (mu / (1 - b1) after a first step), so where u is not near zero the
       update is +-lr*warmup by u's sign. Not near zero: |u| at least ten
       times the largest card-vs-CPU difference of u in its leaf (so the
       two sides' u have one sign) and >= 1e-6 (100 x Adam's eps). There
       the two updates must agree within 1e-2 of a step plus one ulp of
       the weight, where p + update rounds, and no entry may move by the
       other sign. Near zero, any two first steps lie within two steps of
       each other."""
    c = tx.cfg
    step = c.lr * min(1.0, 1.0 / max(c.warmup_steps, 1))
    eps32 = torch.finfo(torch.float32).eps

    # 1. the optimizer alone, on the card's inputs
    ps = [p.clone() for p in card["p0"]]
    ref = tx.update_guarded(card["grads"], tx.init(ps), ps, torch.tensor(True), 1.0,
                            torch.tensor(card["gn"], dtype=torch.float32))
    count_c, mu_c, nu_c, nm_c = card["state"]
    rel = lambda a, b_: float(((a - b_).abs() / b_.abs().clamp(min=1e-30)).max())
    m_err = {"mu": rel(mu_c, ref.mu), "nu": rel(nu_c, ref.nu)}
    if nm_c is not None:
        m_err["nu_max"] = rel(nm_c, ref.nu_max)
    p_bad = sum(int(((a - b_).abs() > eps32 * b_.abs() + 1e-5 * step).sum())
                for a, b_ in zip(card["p1"], ps))
    print(f"GuardedAdam alone (the CPU's on the card's gradients): count card "
          f"{int(count_c)} cpu {int(ref.count)}; moments' max relative error "
          f"{ {k: f'{v:.3g}' for k, v in m_err.items()} } (tol mu, nu 4 ulps = "
          f"{4 * eps32:.3g}, nu_max 1e-5: the bias correction cancels); weights off by "
          f"more than one ulp + 1e-5 of a step: {p_bad}")
    require(int(count_c) == int(ref.count) == 1, "the card's Adam count is not 1 after a "
                                                 "finite step, or differs from the CPU's")
    require(m_err["mu"] <= 4 * eps32 and m_err["nu"] <= 4 * eps32
            and m_err.get("nu_max", 0.0) <= 1e-5,
            "the card's Adam moments differ from the CPU's on the same inputs")
    require(p_bad == 0, "the card's Adam update differs from the CPU's on the same inputs")

    # 2. the step end to end, each side from its own gradients
    sizes = [p.numel() for p in cpu["p0"]]
    u_c, u_h = ((x["state"][1] / (1.0 - c.betas[0])).split(sizes) for x in (card, cpu))
    sure_n = near_n = flips_sure = flips_near = bad_sure = bad_near = 0
    worst = 0.0
    for p0, p1c, p1h, uc, uh in zip(cpu["p0"], card["p1"], cpu["p1"], u_c, u_h):
        dc, dh = (p1c - p0).double().reshape(-1), (p1h - p0).double().reshape(-1)
        ulp = eps32 * p1h.double().abs().reshape(-1)
        sure = uh.abs() >= max(10 * float((uc - uh).abs().max()), 1e-6)
        diff = (dc - dh).abs()
        flip = dc * dh < 0
        sure_n += int(sure.sum())
        near_n += int((~sure).sum())
        flips_sure += int((flip & sure).sum())
        flips_near += int((flip & ~sure).sum())
        bad_sure += int(((diff > 1e-2 * step + ulp) & sure).sum())
        bad_near += int(((diff > 2 * step + ulp) & ~sure).sum())
        if bool(sure.any()):
            worst = max(worst, float(((diff - ulp).clamp(min=0))[sure].max()) / step)
    print(f"GuardedAdam step end to end (step = lr*warmup = {step:.3g}): {sure_n} entries "
          f"with u not near zero: updates apart by more than 1e-2 step + 1 ulp: {bad_sure}, "
          f"worst excess {worst:.3g} step, other sign: {flips_sure} (tol 0); {near_n} near "
          f"zero: apart by more than 2 steps + 1 ulp: {bad_near}, other sign: {flips_near}")
    require(bad_sure == 0 and flips_sure == 0,
            "card and CPU updates differ where the gradient's sign is certain")
    require(bad_near == 0, "card and CPU updates differ by more than two steps")
    return {"adam_moment_rel_err": m_err, "adam_entries_sure": sure_n,
            "adam_entries_near_zero": near_n, "adam_sign_flips_sure": flips_sure,
            "adam_sign_flips_near_zero": flips_near, "adam_update_worst_excess_steps": worst}


def _train_bench(torch, dev, batch, fused_joint_loss: bool, n_steps: int = 10,
                 warmup: int = 2, fused_ffn: bool = False) -> tuple[dict, dict]:
    """Phases 6b/6c/6d: bench.py's configuration (6c: the materialized loss;
    6d: the fused FFN) on bench.py's batch through `make_train_step`; ->
    (stats, kernel launches during the steps)."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.ops import LAUNCHES, reset_launch_counts
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = _train_cfg("bfloat16", dropout=True, fused_joint_loss=fused_joint_loss,
                     fused_ffn=fused_ffn)
    cfg.feature.fbank_precision = "default"
    model = init_weights(Transducer(cfg.model, device=dev), SEED)
    tx = make_optimizer(cfg.optim)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, cfg)
    audio_s = float(batch["wave_lens"].sum()) / SR
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, ms = [], []
    for i in range(warmup + n_steps):
        (state, metrics), dt = _synced_ms(torch, lambda: step(state, batch, SEED))
        require(bool(metrics["finite"]), f"training step {i} was not finite")
        losses.append(float(metrics["loss"]))
        if i >= warmup:
            ms.append(dt)
    launches = dict(LAUNCHES)
    require(launches["fbank_tc"] == warmup + n_steps and launches["fbank_fp32"] == 0
            and launches["fbank_fft"] == 0,
            f"{warmup + n_steps} steps launched fbank's tensor-core route "
            f"{launches['fbank_tc']} times, its dense fp32 route {launches['fbank_fp32']} times "
            f"and its FFT route {launches['fbank_fft']} times, not once a step and never")
    peak = torch.cuda.max_memory_allocated()
    state, busy, wall, kern = _profiled_step(torch, step, state, batch)
    n_kern = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    ms_sorted = sorted(ms)
    med = ms_sorted[len(ms) // 2]
    stats = {"losses": losses, "step_ms": ms, "step_ms_median": med,
             "audio_seconds_per_step": audio_s, "audio_s_per_s": audio_s / med * 1e3,
             "max_memory_allocated": peak, "profiled_step_wall_ms": wall,
             "profiled_step_device_busy_ms": busy, "profiled_step_device_ops": n_kern,
             "skipped": int(state.skipped), "steps": state.step,
             "top_device_items": [[e.key, e.count, e.self_device_time_total / 1e3] for e in top]}
    route = "fused joint loss" if fused_joint_loss else "materialized loss (full logits)"
    route += ", fused FFN" if fused_ffn else ""
    print(f"bench.py's configuration, {route} (batch {BENCH_B} x {BENCH_FRAMES} frames, "
          f"{audio_s:.2f} s of audio per step, bf16, dropout 0.1, dynamic chunk, fused "
          f"attention): losses {[round(x, 4) for x in losses]}; step ms median {med:.1f} "
          f"(min {ms_sorted[0]:.1f}, max {ms_sorted[-1]:.1f}, {n_steps} steps after {warmup}); "
          f"{stats['audio_s_per_s']:.1f} audio-s/s; peak memory {peak / 2**30:.2f} GiB; "
          f"profiled step: device busy {busy:.2f} ms of {wall:.1f} ms wall "
          f"({100 * (1 - busy / wall):.0f}% idle), {n_kern} device operations")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:90]}")
    # the port's own kernels in the step, by name (csrc/*.cu: anonymous
    # namespaces, names from the sources' prefixes)
    own = {}  # name -> [ms, launches], template instances summed
    for e in kern:
        m = re.search(r"\(anonymous namespace\)::((?:fbank|relpos|rnnt|ctc|ffn)_\w+)", e.key)
        if m:
            tot = own.setdefault(m.group(1), [0.0, 0])
            tot[0] += e.self_device_time_total / 1e3
            tot[1] += e.count
    stats["port_kernels_ms"] = {k: v[0] for k, v in own.items()}
    print("  the port's kernels in the step, ms: " + "; ".join(
        f"{k} {v[0]:.4f} ({v[1]}x)" for k, v in sorted(own.items(), key=lambda x: -x[1][0])))
    for name in ("fbank_pack_kernel", "fbank_tc_kernel"):
        require(own.get(name, [0, 0])[1] == 1, f"the profiled step ran {name} "
                                               f"{own.get(name, [0, 0])[1]} times, not once")
    require(all(math.isfinite(x) for x in losses), "a training loss is not finite")
    require(int(state.skipped) == 0, "a training step was skipped")
    return stats, launches


def _profiled_step(torch, step, state, batch) -> tuple:
    """One training step under torch.profiler; -> (state, the device's busy
    ms, the step's wall ms, the device items). One step under the
    profiler's warm-up (traced, not kept), then the profiled step with 50 ms
    of idle host on each side: the trace drops kernels that run near the
    edges of its window (a window opened just before a step lost the step's
    first kernels, fbank's, more often than not; with the warm-up alone it
    still lost the first or the last ones now and then; with the gaps as
    well, never in the trials)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for i in range(2):
            time.sleep(0.05 * i)
            (state, _), wall = _synced_ms(torch, lambda: step(state, batch, SEED))
            time.sleep(0.05 * i)
            prof.step()
    # the schedule's step marker also shows on the device's timeline: not a kernel
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
    return state, sum(e.self_device_time_total for e in kern) / 1e3, wall, kern


def _ctc_route_ab(torch, dev, batch) -> dict:
    """6b's training step's device busy ms with the CTC lattice by its
    block route and by its warp route (the plan fixed to each), in turns
    (block, warp, warp, block), after the training runs' launches are read;
    -> {route: [ms, ms], "ctc_ms": {route: [the lattice kernels' ms, ...]}}."""
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = _train_cfg("bfloat16", dropout=True)
    cfg.feature.fbank_precision = "default"
    model = init_weights(Transducer(cfg.model, device=dev), SEED)
    tx = make_optimizer(cfg.optim)
    state, step = TrainState.create(model, tx), make_train_step(model, tx, cfg)
    busy, own = {"block": [], "warp": []}, {"block": [], "warp": []}
    for route in ("block", "warp", "warp", "block"):
        with _ctc_plan_as(route=route):
            state, ms, _, kern = _profiled_step(torch, step, state, batch)
        busy[route].append(ms)
        own[route].append(sum(e.self_device_time_total for e in kern
                              if re.search(r"::ctc_\w+_kernel", e.key)) / 1e3)
    mean = {k: sum(v) / len(v) for k, v in busy.items()}
    print(f"6b's step, device busy ms by CTC route (in turns block, warp, warp, block): block "
          f"{busy['block']}, warp {busy['warp']}; means {mean['block']:.3f} / "
          f"{mean['warp']:.3f}, change {mean['warp'] - mean['block']:+.3f} ms; the CTC kernels' "
          f"own ms: block {own['block']}, warp {own['warp']}")
    return dict(busy, ctc_ms=own)


def _compare_steps(base: dict, fused: dict) -> None:
    """Print 6d's step numbers beside 6b's (two calls of one script on one
    card; the host's spread between them is up to ~30% for the step)."""
    keys = (("step_ms_median", "step ms (median)"), ("audio_s_per_s", "audio-s/s"),
            ("profiled_step_device_busy_ms", "device busy ms"),
            ("profiled_step_device_ops", "device operations"),
            ("max_memory_allocated", "peak memory bytes"))
    print("6d (fused_ffn=True) beside 6b (fused_ffn=False): " + "; ".join(
        f"{label} {fused[k]:.6g} vs {base[k]:.6g}" for k, label in keys))


def _trainer(torch) -> tuple[dict, dict, dict]:
    """Phase 8: `tpuasr_torch.tools.train` on the card, 2 epochs, then a
    resume from "latest" for a third; -> (stats, kernel launches over both
    runs, the kernels' recorded calls: `_recording`)."""
    import tempfile

    from tpuasr_torch.config import load_yaml
    from tpuasr_torch.data import synthetic_pipeline
    from tpuasr_torch.ops import LAUNCHES, reset_launch_counts
    from tpuasr_torch.tools.train import main as train_main
    from tpuasr_torch.train import latest_path, load_info

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="trainer-", dir=ROOT / "build") as save_dir, \
            _recording(torch) as seen:
        sets = ["model.encoder.fused_ffn=True", "specaug.enabled=True", "data.synth_hard=True",
                "data.batch_size=12", "data.num_prefetch=2", f"train.save_dir={save_dir}",
                "train.log_dir=", "train.log_every=1"]
        reset_launch_counts()
        (first, ms_first) = _synced_ms(torch, lambda: train_main(
            ["--workload", "online_rnnt", "--synthetic", "48", "--epochs", "2", "--set",
             *sets]))
        info = load_info(latest_path(save_dir))
        cfg = load_yaml(str(Path(save_dir) / "train.yaml"))
        require(cfg.model.encoder.fused_ffn and cfg.specaug.enabled and cfg.data.synth_hard
                and cfg.model.compute_dtype == "bfloat16" and cfg.model.fused_joint_loss,
                "the trainer's effective config is not the one asked for")
        require(info["epoch"] == 1 and info["step"] == first.state.step,
                f"the checkpoint after 2 epochs holds epoch {info['epoch']} step "
                f"{info['step']}, the run ended at step {first.state.step}")
        steps_e2 = synthetic_pipeline(cfg, 48, seed=0).steps_per_epoch(2)
        (second, ms_second) = _synced_ms(torch, lambda: train_main(
            ["--workload", "online_rnnt", "--synthetic", "48", "--epochs", "3", "--resume",
             latest_path(save_dir)]))
        launches = dict(LAUNCHES)
        info3 = load_info(latest_path(save_dir))
    losses = first.train_losses + first.dev_losses + second.train_losses + second.dev_losses
    print(f"trainer: 2 epochs of {first.state.step // 2} steps ({ms_first / 1e3:.1f} s), "
          f"train losses {first.train_losses}, dev losses {first.dev_losses}; resumed at "
          f"epoch {info3['epoch']} from step {info['step']}: {len(second.train_losses)} epoch of "
          f"{second.state.step - info['step']} steps ({ms_second / 1e3:.1f} s, checkpoint "
          f"load and save included), train loss {second.train_losses}, dev loss "
          f"{second.dev_losses}, lr scale {second.state.lr_scale}")
    require(len(second.train_losses) == 1 and info3["epoch"] == 2,
            "the resumed run did not continue at the saved epoch")
    require(second.state.step == info["step"] + steps_e2,
            f"the resumed run ended at step {second.state.step}, not the saved "
            f"{info['step']} + {steps_e2}")
    require(all(math.isfinite(x) for x in losses), "a trainer loss is not finite")
    require(int(second.state.skipped) == 0, "a trainer step was skipped")
    return {"train_losses": first.train_losses + second.train_losses,
            "dev_losses": first.dev_losses + second.dev_losses,
            "steps": second.state.step, "first_run_s": ms_first / 1e3,
            "resumed_run_s": ms_second / 1e3}, launches, seen


# ---------------------------------------------------------------------------
# phase 8's kernel records: each kernel against its plain version on the
# inputs the trainer gave it
# ---------------------------------------------------------------------------

# the CTC loss's log-probs and labels, for F.ctc_loss on the CTC kernels' inputs
CTC_INPUTS = ("tpuasr_torch.losses.ctc", "lattice_inputs")


@contextlib.contextmanager
def _recording(torch):
    """While a run goes through the port, keep for each kernel the arguments
    of its wrapper's first call at each signature (every tensor's type and
    shape, every other argument's value) and count the calls at each. Every
    attribute of a port module bound to a wrapper (or to CTC_INPUTS) is
    swapped for a recording one and restored on exit; -> {kernel:
    {signature: [calls, {argument: value}]}}, filled as the run goes."""
    import importlib
    import inspect

    seen, swaps = {}, []

    def recorder(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            key = tuple((str(v.dtype), tuple(v.shape)) if isinstance(v, torch.Tensor) else v
                        for v in bound.arguments.values())
            calls = seen.setdefault(name, {})
            if key not in calls:
                calls[key] = [0, {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                                  for k, v in bound.arguments.items()}]
            calls[key][0] += 1
            return fn(*args, **kwargs)

        return call

    targets = {name: (mod, fn) for name, (mod, fn, *_) in WRAPPERS.items()}
    targets["ctc_inputs"] = CTC_INPUTS
    try:
        for name, (mod, attr) in targets.items():
            fn = getattr(importlib.import_module(mod), attr)
            rec = recorder(name, fn)
            for mname, m in list(sys.modules.items()):
                if mname.split(".")[0] == "tpuasr_torch":
                    for a, val in list(vars(m).items()):
                        if val is fn:
                            setattr(m, a, rec)
                            swaps.append((m, a, fn))
        yield seen
    finally:
        for m, a, fn in swaps:
            setattr(m, a, fn)


def _trainer_kernel_records(torch, seen, launches) -> dict:
    """Phase 8's kernel checks: every kernel the trainer launched, against
    its plain version on the arguments the trainer gave it at each
    signature (the buckets' shapes, training and dev pass); the recorded
    calls must be the run's launches, no more and no fewer. -> {kernel: the
    record at the signature launched most, with "shapes": every
    signature's}."""
    out = {}
    for name in WRAPPERS:
        calls = seen.get(name, {})
        n = sum(c for c, _ in calls.values())
        require(n == launches[name], f"the trainer launched {name} {launches[name]} times but "
                                     f"its wrapper was called {n} times")
        shapes = [dict(_hold(torch, name, args, f"trainer, {count} calls at",
                             seen.get("ctc_inputs")), calls=count)
                  for count, args in sorted(calls.values(), key=lambda x: -x[0])]
        out[name] = dict(shapes[0], shapes=[
            {k: s[k] for k in ("inputs", "calls", "max_abs_err", "tol", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")} for s in shapes])
    return out


if __name__ == "__main__":
    try:
        device = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device}))
