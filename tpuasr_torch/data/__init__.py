"""Host-side data: static-shape batches and the synthetic corpus."""

from tpuasr_torch.data.pipeline import (
    BatchSpec, Utterance, device_view, make_batch, tensors, wire_waves,
)
from tpuasr_torch.data.synthetic import synth_corpus, synth_utterance

__all__ = ["BatchSpec", "Utterance", "device_view", "make_batch", "synth_corpus",
           "synth_utterance", "tensors", "wire_waves"]
