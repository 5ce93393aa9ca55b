#!/usr/bin/env python3
"""Drive the PyTorch port (`tpuasr_torch`) through its serving path on one
NVIDIA card and hold its hand-written kernels against their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. Device: require CUDA; print torch's CUDA version, nvcc's version and the
   card's name and power limit (nvidia-smi).
2. Build: compile every kernel of tpuasr_torch/csrc at once (one nvcc per
   source, started together) and print the time and ptxas' register lines.
3. Kernels against their plain versions on the card, at the flagship's
   shapes: fbank on the 16 waves of fixtures/example1.npz (48 kHz) and on
   a seeded 8 s batch, in both precisions; rel-pos attention at
   [4, 187, 256] (8 s after subsampling) and [16, 63, 256] (the fixture
   requests), fp32 and bf16, with a fully masked row. Max abs error, its
   tolerance and the reason, kernel ms, plain ms, and for attention the ms
   of one `scaled_dot_product_attention` call on [q+u | q+v], [k | p], v.
4. Offline serving: the full-width flagship (12 causal conformer blocks,
   d256, 4 heads, FFN 1024, conv 31, LSTM-256 predictor, tanh joint over
   412 tokens) with seeded random weights, through
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
6. The kernels line: one JSON object with every kernel's launches on the
   serving run of phases 4-5 (counts reset just before), error, times and
   bound.

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

    # ---------------------------------------------------------------- 4-5
    from tpuasr_torch.ops import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    serving = _serve(torch, dev, data)
    launches = dict(LAUNCHES)
    print(f"launches on the serving run: {launches}")

    # ---------------------------------------------------------------- 6
    kernels = []
    for name, rec in (("fbank", checks["fbank"]), ("relpos_attention", checks["attention"])):
        require(launches[name] > 0, f"the serving run never launched the {name} kernel")
        kernels.append(dict(rec, launches=launches[name]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": serving}))
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


def _time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` calls, by CUDA events. A sleep
    kernel holds the stream while the host enqueues all the calls, so the
    events time the device's work back to back and not the host's launch
    rate (the wrappers take longer to launch than the small kernels run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    require(host_ms < ev[0].elapsed_time(ev[1]),
            f"the stream-holding sleep ({ev[0].elapsed_time(ev[1]):.1f} ms) ended before "
            f"the host had enqueued the timed calls ({host_ms:.1f} ms)")
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
    for src in ("fixture", "synthetic"):
        waves = decode_wire(torch.as_tensor(data[src][0]).to(dev))
        frames = frame_signal(waves, n_fft, cfg.hop_length, True).reshape(-1, n_fft).contiguous()
        rows = frames.shape[0]
        for prec, peak in (("highest", PEAK_FP32), ("default", PEAK_BF16)):
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
            library) -> dict:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": err, "ms": _time_ms(torch, kernel),
        "plain_ms": _time_ms(torch, plain),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None if library is None else _time_ms(torch, library),
    }


def _flagship(dtype: str):
    """The reference flagship (__graft_entry__._flagship_config on an
    accelerator): causal dynamic-chunk conformer, static chunk 32."""
    from tpuasr_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    enc = cfg.model.encoder
    enc.causal, enc.use_dynamic_chunk, enc.static_chunk_size = True, True, 32
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


if __name__ == "__main__":
    try:
        device = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device}))
