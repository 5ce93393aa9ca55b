"""Device prefetch: build the next batches and copy them to the device while
the current step runs (port of ``tpuasr/data/prefetch.py``).

A daemon thread pulls host batches, encodes the waves for the wire
(`wire_waves`: int16 halves the bytes) and copies them to the card through
pinned host memory on a copy stream of its own, `depth` batches ahead. Each
copy records an event; the consumer's stream waits on that event before the
batch is handed over (and the tensors are marked as used on the consumer's
stream), so a step can never read a half-copied batch, whatever stream it
runs on. `depth <= 0` does the same work on the caller's thread, with no
thread and no copy stream. On the CPU the batch is only made into tensors.
An error on the thread is raised in the consumer once the batches before it
have been yielded.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from tpuasr_torch.data.pipeline import device_view, wire_waves
from tpuasr_torch.device import resolve_device

_SENTINEL = object()


def prefetch_to_device(batches: Iterable[dict], depth: int = 2, device=None,
                       wire_dtype: str = "float32", sample_rate: int = 48000
                       ) -> Iterator[tuple[float, dict]]:
    """Yield ``(audio_seconds, device_batch)`` with up to ``depth`` batches
    in flight on a background thread. device_batch holds the
    `device_view` arrays as tensors on `device` (default: the card)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if cuda and depth > 0 else None

    def encode_and_put(b: dict):
        audio_s = float(np.sum(b["wave_lens"])) / sample_rate
        db = dict(device_view(b))
        db["waves"] = wire_waves(db["waves"], wire_dtype)  # a no-op for pre-encoded corpora
        host = {k: torch.from_numpy(np.ascontiguousarray(x)) for k, x in db.items()}
        if not cuda:
            return audio_s, host, None
        with torch.cuda.device(dev), torch.cuda.stream(
                copy_stream or torch.cuda.current_stream(dev)):
            out = {k: x.pin_memory().to(dev, non_blocking=True) for k, x in host.items()}
            done = torch.cuda.Event()
            done.record()
        return audio_s, out, done

    def hand_over(item) -> tuple[float, dict]:
        audio_s, out, done = item
        if done is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            for t in out.values():
                t.record_stream(stream)
        return audio_s, out

    if depth <= 0:
        for b in batches:
            yield hand_over(encode_and_put(b))
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()

    def offer(item) -> bool:
        """Put `item` unless the consumer has gone; -> whether it was put."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not offer(encode_and_put(b)):
                    return
        except BaseException as e:  # raised in the consumer below
            err.append(e)
        finally:
            offer(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True, name="tpuasr-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield hand_over(item)
    finally:
        # the consumer stopped early (an error in the step, a break): let the
        # worker end
        stop.set()
        t.join(timeout=60.0)
    if err:
        raise err[0]
