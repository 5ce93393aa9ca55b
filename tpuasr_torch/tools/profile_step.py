"""The flagship's training step split into its stages (port of
``tools/profile_step.py``): fbank, the encoder forward, the predictor
forward, the joint forward, the RNN-T loss forward, the whole forward and
the whole gradient, each in ms and audio-s/s:

    python -m tpuasr_torch.tools.profile_step [--batch 12] [--frames 256] [--tokens 30] \\
        [--iters 10] [--set k=v ...] [--device cuda|cpu]

The JAX tool's configuration: the default Config at 16 kHz in bf16, causal
with dynamic chunks and a static chunk of 32 (no fused kernels: the joint's
full logits and the RNN-T loss on them, fbank precision "highest"), on 12
random waves of (frames - 1) x 512 samples and 30 random labels each,
seeded weights. Each stage runs once, then `--iters` times back to back
(the whole gradient half as often), synced before and after (CUDA
synchronisation); the stages' inputs are the previous stages' outputs.
"""

from __future__ import annotations

import argparse
import sys

from tpuasr_torch.tools.profile_trace import synced_ms


def profile_cfg(sets=()):
    """profile_step's configuration: the default Config at 16 kHz in bf16,
    causal, dynamic chunks, static chunk 32; the dotted `sets` on top."""
    from tpuasr_torch.config import Config, override
    from tpuasr_torch.tools.train import parse_overrides

    cfg = Config()
    cfg.feature.sample_rate = 16000
    cfg.model.compute_dtype = "bfloat16"
    enc = cfg.model.encoder
    enc.causal, enc.use_dynamic_chunk, enc.static_chunk_size = True, True, 32
    return override(cfg, parse_overrides(sets))


def timeit(device, fn, n: int = 10) -> float:
    """Seconds a call of `fn`: one call, then `n` back to back, synced."""
    synced_ms(device, fn)
    _, ms = synced_ms(device, lambda: [fn() for _ in range(n)])
    return ms / 1e3 / n


def stages(cfg, device, b: int = 12, frames: int = 256, u: int = 30, iters: int = 10) -> dict:
    """-> {stage: seconds a call} and the audio seconds of the batch."""
    import numpy as np
    import torch

    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.losses import rnnt_loss_from_logits
    from tpuasr_torch.models import Transducer, add_blank, init_weights
    from tpuasr_torch.models.transducer import encoder_output_len
    from tpuasr_torch.tools.batch_sweep import random_batch

    batch = random_batch(cfg, b, frames, u, np.random.default_rng(0), device)
    waves, wave_lens, texts, text_lens = (batch[k] for k in ("waves", "wave_lens", "texts",
                                                             "text_lens"))
    model = init_weights(Transducer(cfg.model, device=device), 0).eval()
    blank = cfg.model.blank_id

    def features():
        return fbank_batch(waves, wave_lens, cfg.feature, device=device)

    t = {"fbank": timeit(device, features, iters)}
    feats, feat_lens = features()
    with torch.no_grad():
        t["encoder fwd"] = timeit(device, lambda: model.encoder(feats, feat_lens)[0], iters)
        enc = model.encoder(feats, feat_lens)[0]
        enc_lens = encoder_output_len(cfg.model.encoder, feat_lens)
        ys_in = add_blank(texts.long(), blank)
        t["predictor fwd"] = timeit(device, lambda: model.predictor(ys_in), iters)
        pred = model.predictor(ys_in)
        t["joint fwd"] = timeit(device, lambda: model.joint(enc, pred), iters)
        logits = model.joint(enc, pred)
        t["rnnt loss fwd"] = timeit(device, lambda: rnnt_loss_from_logits(
            logits, texts, enc_lens, text_lens, blank, "mean"), iters)

    def full():
        f, fl = features()
        return model(f, fl, texts, text_lens)["loss"]

    def grad():
        model.zero_grad(set_to_none=True)
        full().backward()

    with torch.no_grad():
        t["full fwd"] = timeit(device, full, iters)
    t["full grad"] = timeit(device, grad, max(iters // 2, 1))
    return t, b * waves.shape[1] / cfg.feature.sample_rate


def main(argv=None) -> dict:
    """Profile -> {stage: seconds a call} (also printed)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=30)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--set", nargs="*", default=[], help="dotted overrides k=v")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from tpuasr_torch.device import resolve_device

    device = resolve_device(args.device)
    t, audio_s = stages(profile_cfg(args.set), device, args.batch, args.frames, args.tokens,
                        args.iters)
    print(f"audio per batch: {audio_s:.1f}s")
    for name, s in t.items():
        print(f"{name:15s} {s * 1e3:8.2f} ms   ({audio_s / s:9.0f} audio-s/s)")
    return t


if __name__ == "__main__":
    main(sys.argv[1:])
