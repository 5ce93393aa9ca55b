"""Traffic kind `stream`: concurrent streams decoded in lockstep waves by
greedy streaming search, in a closed loop (a wave starts when the last one
ends; a chunk call when the previous call's tokens are on the host).

Parameters: `streams` a wave; durations from `min_s` to `max_s`, a
log-normal truncated there with `sigma` and the truncated mean `mean_s`
(a fixed set that the seed permutes; `reference.synth.stream_durations`);
`token_s` seconds a spoken token; `waves` waves of audio made on the
device at set-up and cycled; `max_tokens` a stream; `sample` streams of
the last wave that the reference checks; `limits`; `weights_seed` and
`blank_bias`: the served model. A server serves one model, and random
weights set how much the search works (they emit in runs that the blank
bias switches on and off steeply, by each draw's own amount), so the
weights come from `weights_seed` and not from `--seed`, which draws the
audio; the bias was fitted once for them by the reference's greedy search
(`benchmark/tools/fit_blank_bias.py`).

A wave: `fbank_batch` over the wave's padded audio and `chunk_windows`,
`init_streaming_state`, then `process_chunk` for each chunk, greedy with
the configuration's `n_steps`, each call's `hyp` and `hyp_len` read back.
Streams that end early keep their rows (a server without slot refill).
Set-up runs one whole wave, which builds the kernels and warms every
shape. The window closes after the call that crosses `--seconds`; that
wave then runs on, untimed, to its end, and is the one checked. With
`--trace 1` one more wave runs under the profiler.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from benchmark import program, weights
from benchmark.harness import PEAKS, launch_delta, launches
from benchmark.reference import greedy, stream_check, synth
from benchmark.reference.precision import Precision, exact

DATA_SALT = 0x57EA3D
RATE, RIGHT = 4, 6  # Conv2dSubsampling4's rate and right context


class Cell:
    def __init__(self, h):
        self.h, self.p, self.dev = h, h.params, h.device
        self.feat = h.config["feature"]
        self.s = h.config["streaming"]

    def setup(self):
        h = self.h
        if self.dev.type == "cuda":
            from tpuasr_torch.ops import build_all

            build_all()
        self.config = copy.deepcopy(h.config)
        self.config["model"]["blank_bias"] = self.p["blank_bias"]
        self.wseed = self.p["weights_seed"]
        self.cfg, self.model = program.build_model(self.config, "serve", self.wseed, self.dev)
        self.leaves = program.leaves(self.model)
        gen = torch.Generator(device=self.dev).manual_seed((h.seed ^ DATA_SALT) & (2**63 - 1))
        pool = synth.stream_waves(gen, self.p, h.config["model"]["vocab_size"],
                                  self.feat["sample_rate"])
        self.waves, self.lens = pool["waves"], pool["lens"]
        self.lens_host = self.lens.cpu().numpy()
        hop, c = self.feat["hop_length"], self.s["chunk_size"]
        self.frames = 1 + self.waves.shape[-1] // hop
        self.enc_host = ((self.lens_host // hop) // 2 - 1) // 2  # the streams' encoder frames
        from tpuasr_torch.streaming import num_chunks

        self.n_chunks = num_chunks(self.frames, c, RATE, RIGHT)
        self.wave_no = 0
        self.calls = None  # no window open
        self.last = self._wave()

    def _wave(self, units=None) -> dict:
        """One wave; while a window is open (`self.calls`), each call's
        (latency s, active streams, valid audio s, decisions, rows, index);
        with `units`, (shapes, launches) of the fbank and of each call. ->
        the wave's index, its served tokens and each call's hyp_len."""
        from tpuasr_torch.audio import fbank_batch
        from tpuasr_torch.decode import init_streaming_state, process_chunk
        from tpuasr_torch.models.transducer import stream_output_len
        from tpuasr_torch.streaming import chunk_windows

        w = self.wave_no % self.waves.shape[0]
        self.wave_no += 1
        cfg, s = self.cfg, self.s
        blank = cfg.model.blank_id
        sr, hop, c = self.feat["sample_rate"], self.feat["hop_length"], s["chunk_size"]
        stride = c * RATE * hop  # the samples a chunk consumes
        lens, enc = self.lens_host[w], self.enc_host[w]
        rows = len(lens)
        before = launches()
        with self.h.span("fbank"):
            feats, flens = fbank_batch(self.waves[w], self.lens[w], cfg.feature, device=self.dev)
            windows = chunk_windows(feats, c, RATE, RIGHT, self.n_chunks)
        with self.h.span("init_state"):
            state = init_streaming_state(self.model, rows, c, s["num_left_chunks"], blank,
                                         self.p["max_tokens"],
                                         stream_output_len(cfg.model.encoder, flens))
        if units is not None:
            units.append((self.ctx(0, rows, 0), launch_delta(before, launches())))
        hyp_lens = [np.zeros(rows, np.int64)]
        for k in range(self.n_chunks):
            before = launches()
            t0 = time.perf_counter()
            with self.h.span("process_chunk"):
                state = process_chunk(self.model, windows[k], state, blank, s["n_steps"])
            with self.h.span("readback"):
                hyp = state.dec.hyp.cpu()
                hl = state.dec.hyp_len.cpu().numpy()
            t1 = time.perf_counter()
            decisions = int(np.clip(enc - k * c, 0, c).sum() + (hl - hyp_lens[-1]).sum())
            hyp_lens.append(hl)
            if units is not None:
                units.append((self.ctx(k, rows, decisions), launch_delta(before, launches())))
            if self.calls is not None:
                audio = float(np.clip(lens - k * stride, 0, stride).sum()) / sr
                self.calls.append((t1 - t0, int((lens > k * stride).sum()), audio, decisions,
                                   rows, k))
                if t1 >= self.end:
                    self.window_end, self.calls_done, self.calls = t1, self.calls, None
        return {"wave": w, "hyp": hyp.numpy(), "hyp_lens": np.stack(hyp_lens)}

    def ctx(self, k: int, rows: int, decisions: int) -> dict:
        """Call k's shapes (k = 0 also serves the wave's fbank)."""
        c = self.s["chunk_size"]
        e = self.h.config["model"]["encoder"]
        return {"unit": "chunk", "rows": rows, "chunk": c, "window": (c - 1) * RATE + RIGHT + 1,
                "keys": min(k * c, c * self.s["num_left_chunks"]) + c, "decisions": decisions,
                "dtype": self.cfg.model.compute_dtype, "d": e["output_size"],
                "ffn": e["linear_units"], "ffn_rows": rows * c, "dropout": False,
                "n_fft": self.feat["n_fft"], "n_mels": self.feat["n_mels"],
                "fbank_frames": rows * self.frames}

    def window(self, seconds: float):
        self.calls, t0 = [], time.perf_counter()
        self.end = t0 + seconds
        while self.calls is not None:
            self.last = self._wave()
        calls, wall = self.calls_done, self.window_end - t0
        audio = sum(x[2] for x in calls)
        lat = np.concatenate([np.full(x[1], x[0]) for x in calls])
        flops = sum(self.h.flops.stream_call(self.h.config, self.ctx(x[5], x[4], x[3]))
                    for x in calls)
        record = {"unit": "chunk", "model_flops": flops, "window_s": wall,
                  "peak_flops": PEAKS["tf32"], "attempted": int(len(lat)), "failed": 0,
                  "notes": {"calls": len(calls), "window_s": wall, "audio_s": audio,
                            "stream_chunks": len(lat), "tokens_per_frame": self.rate()}}
        return ({"stream_audio_s_per_s": audio / wall,
                 "chunk_latency_p95_ms": 1e3 * float(np.percentile(lat, 95))}, record)

    def rate(self) -> float:
        """Tokens emitted an encoder frame in the last wave."""
        return float(self.last["hyp_lens"][-1].sum()) / float(self.enc_host[self.last["wave"]].sum())

    def traced(self):
        units = []
        self.last = self._wave(units)
        return units

    # ------------------------------------------------------------ check

    def release(self):
        w = self.last["wave"]
        self.wave = self.waves[w]
        del self.model, self.waves, self.lens
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def sample(self) -> np.ndarray:
        """`sample` streams of the checked wave, drawn from the seed, the
        longest among them."""
        lens = self.lens_host[self.last["wave"]]
        n = min(self.p["sample"], len(lens))
        longest = int(np.argmax(lens))
        rest = np.delete(np.arange(len(lens)), longest)
        rng = np.random.default_rng(self.h.seed & (2**63 - 1))
        return np.sort(np.concatenate([[longest], rng.choice(rest, n - 1, replace=False)]))

    def readings(self, controls=()) -> dict:
        """{"gap": the program's widest gap, "ctl": each control's}: the
        sampled streams' served tokens against the fp32 reference, and each
        control's own greedy tokens on the same streams by the same
        comparison; TF32 off for the reference."""
        h, rec, c = self.h, self.last, self.s["chunk_size"]
        n_steps, cap = self.s["n_steps"], self.p["max_tokens"]
        rows = self.sample()
        w = weights.make(self.wseed, self.leaves, self.config, self.dev)
        hop = self.feat["hop_length"]
        lens = torch.as_tensor(self.lens_host[rec["wave"]][rows], device=self.dev)
        enc_lens = stream_check.enc_lengths(lens, hop)
        tokens, chunks = [], []
        for r in rows:
            n = int(rec["hyp_lens"][-1][r])
            tokens.append([int(x) for x in rec["hyp"][r, :n]])
            chunks.append(np.searchsorted(rec["hyp_lens"][1:, r], np.arange(n), side="right"))
        sides = [(tokens, chunks, [])]
        ctl = [([], [], [], Precision(m)) for m in controls]
        blk = self.p["ref_rows"]
        with torch.no_grad(), exact():
            for i in range(0, len(rows), blk):
                idx = torch.as_tensor(rows[i:i + blk], device=self.dev)
                el = enc_lens[i:i + blk]
                enc = stream_check.encode(w, self.config, self.wave[idx], self.n_chunks,
                                          Precision("fp32"))
                sides[0][2].extend(stream_check.gaps(w, self.config, enc, el, tokens[i:i + blk]))
                for toks, chs, gs, pr in ctl:
                    e = stream_check.encode(w, self.config, self.wave[idx], self.n_chunks, pr)
                    t, f = greedy.greedy_paths(w, self.config, e, el, n_steps, pr, cap)
                    toks += t
                    chs += [np.asarray(x, np.int64) // c for x in f]
                    gs.extend(stream_check.gaps(w, self.config, enc, el, t))
        out = []
        for toks, chs, gs in sides + [x[:3] for x in ctl]:
            stream_check.full(gs, toks, cap)
            out.append(stream_check.read(gs, chs, c, n_steps))
        return {"gap": out[0], "ctl": out[1:]}

    def check(self):
        return [("gap", self.readings()["gap"], self.p["limits"]["gap"])]
