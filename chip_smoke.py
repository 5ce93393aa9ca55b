#!/usr/bin/env python3
"""Drive the PyTorch port (`tpuasr_torch`) through its serving path and its
training step on one NVIDIA card, and hold its hand-written kernels against
their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. Device: require CUDA; print torch's CUDA version, nvcc's version and the
   card's name and power limit (nvidia-smi).
2. Build: compile every kernel source of tpuasr_torch/csrc at once (one nvcc
   per source, started together) and print the time and ptxas' register
   lines.
3. Kernels against their plain versions on the card, at the flagship's
   shapes: fbank on the 16 waves of fixtures/example1.npz (48 kHz) and on
   a seeded 8 s batch, in both precisions, and on the training batch of
   phase 6b (12 waves, 9,216 frames) in precision "default"; rel-pos attention at
   [4, 187, 256] (8 s after subsampling) and [16, 63, 256] (the fixture
   requests), fp32 and bf16, with a fully masked row; the fused RNN-T joint
   forward and backward (#4/#5) and the CTC alpha and beta sweeps (#6/#7)
   at the training step's shapes (B 12, T' 191, U+1 33, S 65, D 256,
   V 412) and at a ragged shape with a t_len = 0 and a label_len = 0 row.
   Max abs error, its tolerance and the reason, kernel ms, plain ms, bound,
   and the ms of one PyTorch call computing the same function where there
   is one (attention: `scaled_dot_product_attention` on [q+u | q+v],
   [k | p], v; CTC: `torch.nn.functional.ctc_loss` forward, and its
   backward; the fused joint: none). Kernels are timed by CUDA events;
   the plain CTC sweeps and F.ctc_loss by the profiler (`timing`).
4. Offline serving: the full-width flagship (12 causal conformer blocks,
   d256, 4 heads, FFN 1024, conv 31, LSTM-256 predictor, tanh joint over
   412 tokens, `fused_attention=True`) with seeded random weights, through
   `make_offline_decoder("rnnt_greedy")`. The blank logit is raised until
   greedy search emits as many tokens per encoder frame as the fixture's
   transcripts hold (texts/text_lens), so the emission loop runs as often as
   it would for real speech. fp32 on the card against the same model and
   requests on the CPU (plain versions): features, encoder output and
   tokens. Then bf16: the card's encoder output against the same bf16 model
   on the CPU, latency, and token agreement with fp32.
5. Streaming serving: `streaming_greedy_decode` (chunk 32, 6 left chunks)
   must give the tokens of offline greedy over the chunk-masked full-context
   encoder; `measure_rtf` greedy p50/p90.
6. Training (`fused_joint_loss=True`, `fused_attention=False`):
   a. card against CPU: the full-width fp32 flagship on a batch of 2 x 256
      feature frames x 16 tokens, no dropout, static chunk 32: the loss
      dict, the gradient norm, every gradient leaf (max error relative to
      the leaf's max |g|); the GuardedAdam step alone (the CPU's optimizer
      on the card's gradients: count, moments, weights) and end to end
      (each side's update; no entry whose sign is certain moves the other
      way);
   b. the bench protocol (bench.py): batch 12 x 768 frames of seeded 48 kHz
      waves with 24-30 tokens each, bf16, fbank precision "default",
      dropout 0.1, dynamic chunk, ten steps of `make_train_step`: every
      loss finite, synced step ms, audio seconds per second, peak memory,
      and the device's busy time against wall from torch.profiler over one
      step. Kernels #1 and #4-#7 must launch during this run.
7. The kernels line: one JSON object with an entry per kernel and run
   (the serving run of phases 4-5, the training run of phase 6b; counts
   reset just before each and read just after): that run's launches, and
   the error, times and bound at the shape that run gives the kernel.

TF32 is off throughout (cuBLAS and cuDNN), so every fp32 comparison is fp32.
The last line is {"ok": true, "device": {...}}. The script imports nothing
of JAX: the machine with the card need not have it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_FP32 = 67e12    # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor cores, FLOP/s
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---------------------------------------------------------------- 3
    print("== phase 3: kernels against their plain versions")
    data = _requests()
    checks = _kernel_checks(torch, dev, data)
    checks.update(_train_kernel_checks(torch, dev))

    # ---------------------------------------------------------------- 4-5
    from tpuasr_torch.ops import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    serving = _serve(torch, dev, data)
    serve_launches = dict(LAUNCHES)
    print(f"launches on the serving run: {serve_launches}")

    # ---------------------------------------------------------------- 6
    print("== phase 6a: training step, card against CPU (fp32)")
    training = {"card_vs_cpu": _train_card_vs_cpu(torch, dev)}
    print("== phase 6b: training at the bench protocol")
    training["bench"], train_launches = _train_bench(torch, dev)
    print(f"launches on the training run: {train_launches}")

    # ---------------------------------------------------------------- 7
    # one entry per kernel and run that launches it, with the record taken
    # at the shape that run gives it: fbank appears twice (the serving
    # requests in fp32, the training batch in "default" precision)
    kernels = []
    for name, run, check in (("fbank", "serving", "fbank"),
                             ("fbank", "training", "fbank_training"),
                             ("relpos_attention", "serving", "attention"),
                             ("rnnt_fused_fwd", "training", "rnnt_fused_fwd"),
                             ("rnnt_fused_bwd", "training", "rnnt_fused_bwd"),
                             ("ctc_alpha", "training", "ctc_alpha"),
                             ("ctc_beta_grad", "training", "ctc_beta_grad")):
        launches = (serve_launches if run == "serving" else train_launches)[name]
        require(launches > 0, f"the {run} run never launched {name}")
        kernels.append(dict(checks[check], run=run, launches=launches,
                            launches_serving=serve_launches[name],
                            launches_training=train_launches[name]))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"kernels": kernels}))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


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
    behind a sleep (they wait for the device, or enqueue more launches than
    the launch queue holds: the plain CTC sweeps loop over frames, and
    F.ctc_loss copies its host lengths to the card)."""
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


def _kernel_checks(torch, dev, data) -> dict:
    from dataclasses import astuple

    import torch.nn.functional as F

    from tpuasr_torch.audio.fbank import _operands, decode_wire, frame_signal
    from tpuasr_torch.config import FeatureConfig
    from tpuasr_torch.nn.masks import chunk_mask
    from tpuasr_torch.ops import (
        fbank_frames, fbank_frames_plain, relpos_attention, relpos_attention_plain,
    )

    out = {}
    cfg = FeatureConfig()
    ops = _operands(astuple(cfg), str(dev))
    n_fft, n_freq, n_mels = cfg.n_fft, cfg.n_fft // 2 + 1, cfg.n_mels
    both = (("highest", PEAK_FP32), ("default", PEAK_BF16))
    # the serving requests in both precisions, and the training step's
    # batch (phase 6b: bench.py's 12 waves) in the precision it trains with
    for src, wire, precs in (("fixture", data["fixture"][0], both),
                             ("synthetic", data["synthetic"][0], both),
                             ("bench", _bench_batch(torch, dev)["waves"], both[1:])):
        waves = decode_wire(torch.as_tensor(wire).to(dev))
        frames = frame_signal(waves, n_fft, cfg.hop_length, cfg.center)
        frames = frames.reshape(-1, n_fft).contiguous()
        rows = frames.shape[0]
        for prec, peak in precs:
            got = fbank_frames(frames, *ops, cfg.amin, prec)
            torch.cuda.synchronize()
            ref = fbank_frames_plain(frames, *ops, cfg.amin, prec)
            err = (got - ref).abs()
            # a bin far below its frame's loudest bin is a sum of 1024
            # terms that cancel, so fp32 sums in another order move it by
            # up to ~1e-2 dB; with bf16 operands a power bin may also round
            # to the neighbouring bf16 value, 10*log10(1 + 2**-7) = 0.034 dB
            tol = 2e-2 if prec == "highest" else 5e-2
            why = ("fp32 sums in another order, cancelling bins" if prec == "highest"
                   else "that plus one bf16 ulp of a power bin")
            ok = bool((err <= tol).all())
            at = int(err.argmax())
            print(f"  error quantiles 50/99/99.9%: "
                  f"{[round(float(x), 6) for x in err.flatten().quantile(torch.tensor([0.5, 0.99, 0.999], device=dev))]}"
                  f" dB; worst bin {float(ref.flatten()[at]):.1f} dB in a frame whose "
                  f"loudest bin is {float(ref[at // n_mels].max()):.1f} dB")
            # the least work for this function: a real FFT per frame
            # (2.5 n log2 n flops), the window, |X|^2, the mel product over
            # the filters' nonzeros only (about two per bin), max and log;
            # bytes: the frames in, the window and mel matrix, the log-mel out
            # (an FFT needs no DFT basis)
            nnz = int((ops[3] != 0).sum())
            flops = rows * (2.5 * n_fft * math.log2(n_fft) + n_fft + 3 * n_freq + 2 * nnz
                            + 2 * n_mels)
            nbytes = 4 * (rows * n_fft + n_fft + n_freq * n_mels + rows * n_mels)
            # this design's own work: the DFT as two dense products
            design_ms = rows * (4 * n_fft * n_freq + 2 * n_freq * n_mels) / peak * 1e3
            rec = _record(
                torch, "fbank", "tpuasr_torch/csrc/fbank.cu",
                "tpuasr/ops/fbank_pallas.py:25", float(err.max()), flops, PEAK_FP32, nbytes,
                lambda: fbank_frames(frames, *ops, cfg.amin, prec),
                lambda: fbank_frames_plain(frames, *ops, cfg.amin, prec), None)
            print(f"fbank {src} rows={rows} precision={prec}: max_abs_err "
                  f"{rec['max_abs_err']:.3g} dB (tol {tol} dB: {why}) ms {rec['ms']:.4f} "
                  f"plain_ms {rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.5f} "
                  f"({rec['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP of "
                  f"FFT and sparse mel); the dense-DFT design's own work "
                  f"{rows * (4 * n_fft * n_freq + 2 * n_freq * n_mels) / 1e9:.2f} GFLOP "
                  f"= {design_ms:.4f} ms at the {'fp32' if prec == 'highest' else 'bf16'} peak")
            require(ok, f"fbank kernel disagrees with its plain version ({src}, {prec})")
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
        for dtype, tol, why in ((torch.float32, 1e-5, "fp32 sums in another order"),
                                (torch.bfloat16, 1e-2, "bf16 roundings of the output "
                                 "and the probabilities at other points, 2**-8 each")):
            q, k, p, v = (x.to(dev, dtype) for x in base)
            u_, v_ = ub.to(dev, dtype), vb.to(dev, dtype)
            scale = 1.0 / math.sqrt(dk)
            args = (q, k, p, v, u_, v_, mask, scale, h)
            got = relpos_attention(*args)
            torch.cuda.synchronize()
            ref = relpos_attention_plain(*args)
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            within = bool((diff <= tol + tol * ref.float().abs()).all())
            zero_row = bool((got[1, 5] == 0).all())
            # library yardstick: one SDPA call on [q+u | q+v], [k | p], v
            heads = lambda x: x.view(x.shape[0], -1, h, dk).transpose(1, 2)
            sq = torch.cat([heads(q + u_), heads(q + v_)], dim=-1)
            sk = torch.cat([heads(k), heads(p).expand(b, -1, -1, -1)], dim=-1)
            sv, smask = heads(v), mask[:, None]
            valid_pairs = int(mask.sum())
            flops = valid_pairs * h * 6 * dk  # 2*(2dk) score + 2*dk a.v per pair
            es = q.element_size()
            nbytes = es * (4 * b * t * d + t * d + 2 * d) + mask.numel()
            rec = _record(
                torch, "relpos_attention", "tpuasr_torch/csrc/relpos_attention.cu",
                "tpuasr/ops/attention_pallas.py:72", err, flops,
                PEAK_FP32 if dtype == torch.float32 else PEAK_BF16, nbytes,
                lambda: relpos_attention(*args), lambda: relpos_attention_plain(*args),
                lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=smask,
                                                       scale=scale))
            print(f"relpos_attention [{b}, {t}, {d}] {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3g} (tol {tol} + {tol}*|ref|: {why}) ms {rec['ms']:.4f} plain_ms "
                  f"{rec['plain_ms']:.4f} library_ms {rec['library_ms']:.4f} "
                  f"bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']})")
            require(within, f"attention kernel disagrees with its plain version "
                                f"([{b}, {t}, {d}] {dtype})")
            require(zero_row, "a fully masked query row did not give zeros")
            if b == 4 and dtype == torch.bfloat16:  # the flagship's 8 s bf16 call
                out["attention"] = rec
    return out


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


def _flagship(dtype: str):
    """The reference flagship (__graft_entry__._flagship_config on an
    accelerator): causal dynamic-chunk conformer, static chunk 32, the
    rel-pos attention kernel on the full-context path."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    enc = cfg.model.encoder
    enc.causal, enc.use_dynamic_chunk, enc.static_chunk_size = True, True, 32
    enc.fused_attention = True
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


def _serve(torch, dev, data) -> dict:
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
    for src in ("fixture", "synthetic"):
        w, wl = data[src]
        feats, flens = fbank_batch(w, wl, cfg32.feature, device=dev)
        full, full_lens = gpu32.encode(feats, flens, CHUNK, LEFT)
        n = num_chunks(feats.shape[1], CHUNK, 4, 6)
        # streaming sees whole chunks and never masks padding: decode the
        # frames of the whole chunks inside each request's valid length
        whole = torch.clamp(full_lens.long(), max=n * CHUNK) // CHUNK * CHUNK
        off_t, off_l = rnnt_greedy_decode(gpu32, full, whole, cfg32.model.blank_id)
        st_t, st_l, _ = streaming_greedy_decode(gpu32, feats, whole * 4 + 3, CHUNK, LEFT,
                                                cfg32.model.blank_id)
        ok = torch.equal(st_t, off_t) and torch.equal(st_l, off_l)
        print(f"streaming == chunk-masked offline on {src} ({int(whole.sum())} frames, "
              f"{int(st_l.sum())} tokens): {ok}")
        require(ok, f"streaming tokens differ from chunk-masked offline ({src})")

    feats16, _ = fbank_batch(*data["synthetic"], cfg16.feature, device=dev)
    for label, model, cfg in (("bf16", gpu16, cfg16), ("fp32", gpu32, cfg32)):
        st = measure_rtf(model, feats16, cfg, "greedy")
        print(f"streaming RTF {label} (4 streams, {st.n_chunks} chunks of "
              f"{st.chunk_audio_seconds:.3f} s): p50 {st.rtf_p50:.5f} p90 {st.rtf_p90:.5f} "
              f"on {st.device}")
        serving[f"rtf_p50_{label}"] = st.rtf_p50
        serving[f"rtf_p90_{label}"] = st.rtf_p90
    serving["stream_bf16_chunk_stages"] = _stream_stages(torch, gpu16, cfg16, feats16)
    return serving


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


def _offline_stages(torch, model, cfg, waves, wave_lens, wall_ms) -> dict:
    """Where the offline request time goes: host ms of fbank, encoder and
    greedy search (each closed by a sync), the greedy loop's emission steps,
    and the device's busy time from the profiler over one whole decode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    dec = make_offline_decoder(model, cfg, "rnnt_greedy")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dec(waves, wave_lens)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
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
# training: kernels #4-#7 and phase 6
# ---------------------------------------------------------------------------

BENCH_B, BENCH_FRAMES, BENCH_TOKENS = 12, 768, 32  # bench.py's protocol
HOP, SR = 512, 48000


def _bench_lengths(r):
    """Token counts (24-30) and wave lengths of bench.py's synthetic batch:
    (frames - 6) * hop // 30 samples per token, padded to (frames-1) * hop."""
    ntok = r.integers(24, 31, size=BENCH_B)
    per_token = (BENCH_FRAMES - 6) * HOP // 30
    return ntok, ntok * per_token


def _enc_len(wave_lens):
    """Encoder frames of waves: fbank frames 1 + n // hop, then rate-4
    subsampling."""
    f = 1 + wave_lens // HOP
    return ((f - 1) // 2 - 1) // 2


def _rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30))


def _train_kernel_checks(torch, dev) -> dict:
    """Kernels #4-#7 against their plain versions at the training step's
    shapes (and a ragged shape); -> {name: record at the bench shape}."""
    import numpy as np
    import torch.nn.functional as F

    from tpuasr_torch.losses.ctc import lattice_inputs
    from tpuasr_torch.losses.rnnt import (
        mask_lattice_inputs, rnnt_alphas, rnnt_log_likelihood, rnnt_occupancies,
    )
    from tpuasr_torch.ops import (
        ctc_alpha, ctc_alpha_plain, ctc_beta_grad, ctc_beta_grad_plain, rnnt_fused_grads,
        rnnt_fused_grads_plain, rnnt_fused_lp, rnnt_fused_lp_plain,
    )

    out = {}
    blank = 5
    r = np.random.default_rng(SEED + 7)
    ntok, wave_lens = _bench_lengths(r)
    bench_t = int(_enc_len(np.array([(BENCH_FRAMES - 1) * HOP]))[0])
    shapes = (("bench", BENCH_B, bench_t, BENCH_TOKENS, 256, 412, _enc_len(wave_lens), ntok),
              ("ragged", 3, 37, 5, 256, 97, np.array([37, 0, 20]), np.array([5, 3, 0])))
    g = torch.Generator().manual_seed(SEED)
    for tag, b, t, u, d, v, t_lens, u_lens in shapes:
        u1 = u + 1
        enc = torch.randn(b, t, d, generator=g).to(dev)
        pred = torch.randn(b, u1, d, generator=g).to(dev)
        w = (torch.randn(d, v, generator=g) / math.sqrt(d)).to(dev)
        bias = (0.1 * torch.randn(v, generator=g)).to(dev)
        lab = torch.randint(0, v - 1, (b, u), generator=g)
        lab = (lab + (lab >= blank).long()).to(torch.int32).to(dev)  # never the blank
        tl = torch.as_tensor(t_lens, dtype=torch.int32).to(dev)
        ul = torch.as_tensor(u_lens, dtype=torch.int32).to(dev)
        rows = b * t * u1

        # #4: blank/label log-probs and the logsumexp
        got = rnnt_fused_lp(enc, pred, w, bias, lab, blank)
        torch.cuda.synchronize()
        ref = rnnt_fused_lp_plain(enc, pred, w, bias, lab, blank)
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        tol = 5e-4
        flops = 2.0 * rows * d * v
        nbytes = 4 * (b * t * d + b * u1 * d + d * v + v + b * u + 3 * rows)
        rec = _record(torch, "rnnt_fused_fwd", "tpuasr_torch/csrc/rnnt_fused.cu",
                      "tpuasr/ops/rnnt_fused_pallas.py:38", err, flops, PEAK_FP32, nbytes,
                      lambda: rnnt_fused_lp(enc, pred, w, bias, lab, blank),
                      lambda: rnnt_fused_lp_plain(enc, pred, w, bias, lab, blank), None)
        print(f"rnnt_fused_fwd {tag} [B {b}, T {t}, U+1 {u1}, D {d}, V {v}]: max_abs_err "
              f"{err:.3g} (tol {tol}: fp32 sums of {d} products in another order on logits "
              f"up to ~10, ~1e-5 expected; the online logsumexp against torch's) ms {rec['ms']:.4f} plain_ms "
              f"{rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']}: "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); library_ms none (no single "
              f"PyTorch call fuses joint, log-softmax and gather)")
        require(err <= tol, f"rnnt_fused_fwd disagrees with its plain version ({tag})")
        if tag == "bench":
            out["rnnt_fused_fwd"] = rec

        # #5: gradients from the real lattice's occupancies (mean over B)
        blank_lp, label_full, lse = got
        bm, lm, pad_t, lv = mask_lattice_inputs(blank_lp, label_full[:, :, :-1], tl, ul)
        alpha = rnnt_alphas(bm, lm)
        occ_b, occ_l = rnnt_occupancies(bm, lm, ul, alpha, rnnt_log_likelihood(alpha, bm, ul))
        zero = torch.zeros((), device=dev)
        gb = torch.where(pad_t, zero, -occ_b / b).contiguous()
        gl = F.pad(torch.where(lv, -occ_l / b, zero), (0, 1)).contiguous()
        args = (enc, pred, w, bias, lab, lse, gb, gl, blank)
        got = rnnt_fused_grads(*args)
        torch.cuda.synchronize()
        ref = rnnt_fused_grads_plain(*args)
        rels = [_rel_err(x, y) for x, y in zip(got, ref)]
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        tol = 1e-4
        flops = 3 * 2.0 * rows * d * v
        nbytes = 4 * (2 * (b * t * d + b * u1 * d + d * v + v) + b * u + 3 * rows)
        rec = _record(torch, "rnnt_fused_bwd", "tpuasr_torch/csrc/rnnt_fused.cu",
                      "tpuasr/ops/rnnt_fused_pallas.py:71", err, flops, PEAK_FP32, nbytes,
                      lambda: rnnt_fused_grads(*args), lambda: rnnt_fused_grads_plain(*args),
                      None)
        print(f"rnnt_fused_bwd {tag}: max_abs_err {err:.3g}; error / max|ref| for d_enc, "
              f"d_pred, dW, db {[f'{x:.2e}' for x in rels]} (tol {tol} relative: fp32 sums "
              f"in another order, added with atomics in an order that changes between "
              f"runs) ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} bound_ms "
              f"{rec['bound_ms']:.5f} ({rec['bound_by']}: {flops / 1e9:.2f} GFLOP); "
              f"library_ms none")
        require(max(rels) <= tol, f"rnnt_fused_bwd disagrees with its plain version ({tag})")
        if tag == "bench":
            out["rnnt_fused_bwd"] = rec

        # #6 / #7: the CTC lattice over log-softmaxed logits
        logits = torch.randn(b, t, v, generator=g).to(dev)
        lp = torch.log_softmax(logits, dim=-1)
        lp_states, skip, final = lattice_inputs(lp, lab, ul, blank)
        lp_states = lp_states.contiguous()
        s = lp_states.shape[2]
        ga, gll = ctc_alpha(lp_states, skip, tl, final)
        torch.cuda.synchronize()
        ra, rll = ctc_alpha_plain(lp_states, skip, tl, final)
        live = ra > -1e29
        require(torch.equal(live, ga > -1e29) and torch.equal(rll > -1e29, gll > -1e29),
                f"ctc_alpha: reachable states differ from the plain version ({tag})")
        err = max(float((ga - ra)[live].abs().max()), float((gll - rll).abs().max()))
        ok = bool(((ga - ra).abs() <= 1e-3 + 1e-5 * ra.abs())[live].all())
        ok = ok and bool(((gll - rll).abs() <= 1e-3 + 1e-5 * rll.abs()).all())
        active = int(torch.clamp(tl, max=t).sum()) * s
        nbytes = 4 * (2 * b * t * s + b + b) + 2 * b * s
        lib_in = (lp.transpose(0, 1), lab.long(), tuple(int(x) for x in t_lens),
                  tuple(int(x) for x in u_lens))
        rec = _record(torch, "ctc_alpha", "tpuasr_torch/csrc/ctc_lattice.cu",
                      "tpuasr/ops/ctc_pallas.py:56", err, 13.0 * active, PEAK_FP32, nbytes,
                      lambda: ctc_alpha(lp_states, skip, tl, final),
                      lambda: ctc_alpha_plain(lp_states, skip, tl, final),
                      (lambda: F.ctc_loss(*lib_in, blank=blank, reduction="sum",
                                          zero_infinity=True)) if tag == "bench" else None,
                      plain_iters=5, plain_timing="profiler")
        print(f"ctc_alpha {tag} [B {b}, T {t}, S {s}]: max_abs_err {err:.3g} over reachable "
              f"states (tol 1e-3 + 1e-5*|ref|: fp32 log-adds whose exp/log1p may differ from "
              f"torch's by an ulp, over {t} steps on values up to ~1e3) ms {rec['ms']:.4f} "
              f"plain_ms (profiler) {rec['plain_ms']:.4f} library_ms (F.ctc_loss forward, "
              f"profiler) "
              f"{rec['library_ms']} bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']}; "
              f"the {t} dependent steps bind in fact)")
        require(ok, f"ctc_alpha disagrees with its plain version ({tag})")
        if tag == "bench":
            out["ctc_alpha"] = rec

        gvec = torch.ones(b, device=dev)
        bargs = (lp_states, skip, tl, final, ra.contiguous(), rll.contiguous(), gvec)
        got = ctc_beta_grad(*bargs)
        torch.cuda.synchronize()
        ref = ctc_beta_grad_plain(*bargs)
        diff = (got - ref).abs()
        err = float(diff.max())
        ok = bool((diff <= 2e-3 * ref.abs() + 1e-5).all())
        lib = None
        if tag == "bench":  # F.ctc_loss's backward alone, on a retained graph
            lp_req = lp.detach().transpose(0, 1).requires_grad_()
            lib_loss = F.ctc_loss(lp_req, *lib_in[1:], blank=blank, reduction="sum",
                                  zero_infinity=True)
            lib = lambda: torch.autograd.grad(lib_loss, lp_req, retain_graph=True)
        rec = _record(torch, "ctc_beta_grad", "tpuasr_torch/csrc/ctc_lattice.cu",
                      "tpuasr/ops/ctc_pallas.py:83", err, 19.0 * active, PEAK_FP32,
                      4 * (3 * b * t * s + 3 * b) + 2 * b * s,
                      lambda: ctc_beta_grad(*bargs), lambda: ctc_beta_grad_plain(*bargs), lib,
                      plain_iters=5, plain_timing="profiler")
        print(f"ctc_beta_grad {tag}: max_abs_err {err:.3g} (tol 2e-3*|ref| + 1e-5: the "
              f"gradient is exp of a log-domain sum carrying alpha's error) ms "
              f"{rec['ms']:.4f} plain_ms (profiler) {rec['plain_ms']:.4f} library_ms "
              f"(F.ctc_loss backward, profiler) {rec['library_ms']} bound_ms {rec['bound_ms']:.6f} "
              f"({rec['bound_by']})")
        require(ok, f"ctc_beta_grad disagrees with its plain version ({tag})")
        if tag == "ragged":
            require(bool((got[1] == 0).all()), "ctc_beta_grad: a t_len = 0 row has gradient")
        if tag == "bench":
            out["ctc_beta_grad"] = rec
    return out


def _train_cfg(dtype: str, dropout: bool):
    """The flagship as the bench trains it: causal, static chunk 32, fused
    joint loss, the plain attention formula (its kernel's backward is not
    ported); with `dropout`, the JAX defaults (0.1) and dynamic chunks, else
    no dropout and the static chunk."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    cfg.model.fused_joint_loss = True
    enc = cfg.model.encoder
    enc.causal, enc.static_chunk_size, enc.fused_attention = True, 32, False
    enc.use_dynamic_chunk = dropout
    if not dropout:
        enc.dropout_rate = enc.positional_dropout_rate = 0.0
        cfg.model.ctc_dropout_rate = 0.0
        cfg.model.predictor.dropout = 0.0
    return cfg


def _train_card_vs_cpu(torch, dev) -> dict:
    """Phase 6a: one forward, backward and GuardedAdam step of the fp32
    flagship on the card and on the CPU, same weights and batch."""
    import numpy as np

    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.train import make_optimizer

    cfg = _train_cfg("float32", dropout=False)
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
    print(f"fp32 training step, card vs CPU on [2, 256, 80] x 16 tokens: losses card "
          f"{lc} cpu {lh} (tol 1e-4 relative); grad norm {gc:.6g} vs {gh:.6g} (tol 1e-4 "
          f"relative); gradient error / the leaf's max|g|, the three worst: "
          f"{[(names[i], f'{rels[i]:.3g}') for i in order[:3]]} (tol 1e-3: fp32 sums in "
          f"another order through 12 blocks, the lattice and the fused joint's atomics); "
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


def _bench_batch(torch, dev) -> dict:
    """bench.py's batch shape from a seed: 12 waves of 24-30 tokens at
    (frames-6)*hop//30 samples each, padded to (frames-1)*hop samples, and
    the token ids padded with 0 to 32 slots."""
    import numpy as np

    r = np.random.default_rng(SEED + 3)
    ntok, wave_lens = _bench_lengths(r)
    n = (BENCH_FRAMES - 1) * HOP
    waves = np.zeros((BENCH_B, n), np.float32)
    texts = np.zeros((BENCH_B, BENCH_TOKENS), np.int64)
    for i in range(BENCH_B):
        tt = np.arange(wave_lens[i]) / SR
        tone = 200.0 + 25.0 * r.integers(0, 40, size=ntok[i]).repeat(wave_lens[i] // ntok[i])
        tone = np.pad(tone, (0, wave_lens[i] - tone.size), mode="edge")
        waves[i, :wave_lens[i]] = 0.1 * np.sin(2 * np.pi * tone * tt) \
            + 0.01 * r.standard_normal(wave_lens[i])
        texts[i, :ntok[i]] = r.integers(6, 412, size=ntok[i])
    return {"waves": torch.from_numpy(waves).to(dev),
            "wave_lens": torch.from_numpy(wave_lens.astype(np.int64)).to(dev),
            "texts": torch.from_numpy(texts).to(dev),
            "text_lens": torch.from_numpy(ntok.astype(np.int64)).to(dev)}


def _train_bench(torch, dev, n_steps: int = 10, warmup: int = 2) -> tuple[dict, dict]:
    """Phase 6b: the bench protocol through `make_train_step`; -> (stats,
    kernel launches during the steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.ops import LAUNCHES, reset_launch_counts
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = _train_cfg("bfloat16", dropout=True)
    cfg.feature.fbank_precision = "default"
    model = init_weights(Transducer(cfg.model, device=dev), SEED)
    tx = make_optimizer(cfg.optim)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, cfg)
    batch = _bench_batch(torch, dev)
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
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, metrics), wall = _synced_ms(torch, lambda: step(state, batch, SEED))
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    n_kern = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    ms_sorted = sorted(ms)
    med = ms_sorted[len(ms) // 2]
    stats = {"losses": losses, "step_ms": ms, "step_ms_median": med,
             "audio_seconds_per_step": audio_s, "audio_s_per_s": audio_s / med * 1e3,
             "max_memory_allocated": peak, "profiled_step_wall_ms": wall,
             "profiled_step_device_busy_ms": busy, "profiled_step_device_ops": n_kern,
             "skipped": int(state.skipped), "steps": state.step}
    print(f"bench-protocol training (batch {BENCH_B} x {BENCH_FRAMES} frames, "
          f"{audio_s:.2f} s of audio per step, bf16, dropout 0.1, dynamic chunk): losses "
          f"{[round(x, 4) for x in losses]}; step ms median {med:.1f} (min {ms_sorted[0]:.1f}, "
          f"max {ms_sorted[-1]:.1f}, {n_steps} steps after {warmup}); "
          f"{stats['audio_s_per_s']:.1f} audio-s/s; peak memory {peak / 2**30:.2f} GiB; "
          f"profiled step: device busy {busy:.2f} ms of {wall:.1f} ms wall "
          f"({100 * (1 - busy / wall):.0f}% idle), {n_kern} device operations")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:90]}")
    require(all(math.isfinite(x) for x in losses), "a training loss is not finite")
    return stats, launches


if __name__ == "__main__":
    try:
        device = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device}))
