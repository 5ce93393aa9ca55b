"""Traffic kind `train`: the trainer's step dispatched back to back.

Parameters (`benchmark/workloads/<cell>.json`): `batch` utterances of
`min_tokens`-`max_tokens` tokens, `frames` feature frames and `tokens`
labels a batch; `batches` distinct batches made on the device at set-up
and cycled; `checked_steps` (3) first steps that the reference follows;
`trace_steps` steps under the profiler after the window; `ref_rows` rows a
block of the reference; `limits` of the comparison; `first_token` (the
lowest label id drawn) and `sos_eos` (the labels wrapped in SOS / EOS) for
a model whose labels differ.

Set-up builds one training step (`tpuasr_torch.train.make_train_step`,
its model with the benchmark's weights and `GuardedAdam`), runs its first
steps through the same call on the first batches (they warm every shape the
window uses) and keeps what the comparison reads: each step's loss, the
optimizer's first moment after one step and the parameters after the last.
The window then dispatches the step back to back, as the trainer's loop
does, with no host read between steps, and ends with one synchronize.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import program, weights
from benchmark.harness import PEAKS, launch_delta, launches
from benchmark.reference import draws, synth, train_check
from benchmark.reference.precision import Precision

DATA_SALT = 0x7A11DA7A


class Cell:
    def __init__(self, h):
        self.h, self.p, self.dev = h, h.params, h.device
        m = h.config["model"]
        self.feat = h.config["feature"]
        self.enc = m["encoder"]

    # ------------------------------------------------------------ set-up

    def setup(self):
        from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

        h, p = self.h, self.p
        if self.dev.type == "cuda":
            from tpuasr_torch.ops import build_all

            build_all()
        self.cfg, model = program.build_model(h.config, "train", h.seed, self.dev)
        self.leaves = program.leaves(model)
        tx = make_optimizer(self.cfg.optim)
        self.state = TrainState.create(model, tx)
        self.step = make_train_step(model, tx, self.cfg)
        gen = torch.Generator(device=self.dev).manual_seed((h.seed ^ DATA_SALT) & (2**63 - 1))
        sr, hop = self.feat["sample_rate"], self.feat["hop_length"]
        self.batches = synth.train_batches(gen, p, h.config["model"]["vocab_size"], sr, hop)
        self.wave_lens = [b["wave_lens"].cpu().numpy() for b in self.batches]
        self.audio = [float(w.sum()) / sr for w in self.wave_lens]
        self.losses = []
        for i in range(p["checked_steps"]):
            with self.h.span("step"):
                self.state, met = self.step(self.state, self.batches[i], h.seed)
            self.losses.append(met["loss"])
            if i == 0:
                self.mu1 = self.state.opt_state.mu.clone()
        self.p3 = torch.cat([q.detach().reshape(-1).float() for q in model.parameters()])
        self.n = p["checked_steps"]
        self.skipped0 = int(self.state.skipped)

    def ctx(self, i: int) -> dict:
        """Step i's shapes: its batch's, and its attended pairs under its
        dynamic-chunk draw and the rows' padding."""
        p, e = self.p, self.enc
        hop = self.feat["hop_length"]
        frames = 1 + (p["frames"] - 1) * hop // hop
        t = ((frames - 1) // 2 - 1) // 2
        lens = ((1 + self.wave_lens[i % len(self.batches)] // hop) - 1) // 2
        lens = (lens - 1) // 2
        chunk, _ = draws.chunk_draw(self.h.seed, i, t, e["max_chunk_size"])
        ends = np.minimum((np.arange(t) // chunk + 1) * chunk, t)
        pairs = int(np.minimum(ends[None, :], lens[:, None]).sum())
        m = self.h.config["model"]
        return {"unit": "step", "b": p["batch"], "frames": frames, "t_enc": t,
                "u1": p["tokens"] + 1, "pairs": pairs, "dtype": self.cfg.model.compute_dtype,
                "d": e["output_size"], "heads": e["attention_heads"], "ffn": e["linear_units"],
                "v": m["vocab_size"], "join": m.get("joint", {}).get("join_dim"),
                "n_fft": self.feat["n_fft"], "n_mels": self.feat["n_mels"],
                "fbank_frames": p["batch"] * frames, "ffn_rows": p["batch"] * t,
                "dropout": e["dropout_rate"] > 0}

    # ------------------------------------------------------------ window

    def _one(self):
        i = self.n
        with self.h.span("step"):
            self.state, _ = self.step(self.state, self.batches[i % len(self.batches)],
                                      self.h.seed)
        self.n += 1
        return i

    def window(self, seconds: float):
        disp, order = [], []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            order.append(self._one())
            disp.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        audio = sum(self.audio[i % len(self.batches)] for i in order)
        flops = sum(self.h.flops.train_step(self.h.config, self.ctx(i)) for i in order)
        skipped = int(self.state.skipped) - self.skipped0
        record = {"unit": "step", "dispatch_s": disp, "model_flops": flops, "window_s": wall,
                  "peak_flops": PEAKS[self.cfg.model.compute_dtype], "attempted": len(order),
                  "failed": skipped,
                  "notes": {"steps": len(order), "window_s": wall, "audio_s": audio}}
        return {"train_audio_s_per_s": audio / wall}, record

    def traced(self):
        units = []
        for _ in range(self.p["trace_steps"]):
            before = launches()
            i = self._one()
            units.append((self.ctx(i), launch_delta(before, launches())))
        return units

    # ------------------------------------------------------------ check

    def release(self):
        self.batches = self.batches[:self.p["checked_steps"]]
        del self.state, self.step
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The program's three numbers against the fp32 reference."""
        h = self.h
        w = weights.make(h.seed, self.leaves, h.config, self.dev)
        ref = train_check.follow(h.config, w, self.batches, h.seed, Precision("fp32"),
                                 self.p["ref_rows"])
        return train_check.compare(
            train_check.program_side(self.losses, self.mu1, self.p3, w, h.config["optim"]), ref)

    def check(self):
        """The numbers that the cell's `limits` name; a number without a
        limit (no reading of the control or of a fault separates it from
        sound runs) is printed and not compared."""
        nums = self.readings()
        lim = self.p["limits"]
        for k in sorted(set(nums) - set(lim)):
            print(f"reading {k} {nums[k]!r} (not compared)", file=sys.stderr)
        return [(k, nums[k], lim[k]) for k in nums if k in lim]
