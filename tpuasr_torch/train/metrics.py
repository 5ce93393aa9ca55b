"""Metric logging (port of ``tpuasr/train/metrics.py``): an append-only
text log and, when `torch.utils.tensorboard` imports, TensorBoard scalars.

Scalar names are the JAX package's: train/loss, train/loss_ctc,
train/loss_rnnt, train/grad_norm, train/steps_per_second,
train/audio_seconds_per_second, dev/loss, cv/loss,
train/learning_rate_scale. At several ranks only rank 0's writer is
enabled (tpuasr/train/metrics.py:19): the others write and print nothing.
"""

from __future__ import annotations

import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str, text_log: str | None = None, enabled: bool = True):
        self.enabled = enabled
        self.tb = None
        self.text = None
        if not enabled:
            return
        if log_dir:  # empty = console only (no event files)
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except ImportError:  # no tensorboard package: text log only
                pass
        if text_log:
            os.makedirs(os.path.dirname(text_log) or ".", exist_ok=True)
            self.text = open(text_log, "a", encoding="utf-8")

    def scalar(self, name: str, value: float, step: int) -> None:
        if self.tb is not None:
            self.tb.add_scalar(name, float(value), step)

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        for k, v in values.items():
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def log(self, msg: str) -> None:
        if not self.enabled:
            return
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        if self.text is not None:
            self.text.write(line + "\n")
            self.text.flush()

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        if self.text is not None:
            self.text.close()


class StepTimer:
    """Steps per second and audio seconds per second since `reset`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.audio_seconds = 0.0

    def tick(self, audio_seconds: float = 0.0):
        self.steps += 1
        self.audio_seconds += audio_seconds

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def steps_per_second(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def audio_seconds_per_second(self) -> float:
        return self.audio_seconds / max(self.elapsed, 1e-9)
