"""Host-side data: the BZNSYP readers, length-bucketed static-shape batches
from a corpus on disk or the synthetic corpus, and the device prefetcher."""

from tpuasr_torch.data.bznsyp import read_wav
from tpuasr_torch.data.corpus import UtteranceMeta, make_pipeline, scan_split, synthetic_pipeline
from tpuasr_torch.data.pipeline import (
    BatchSpec, LengthBucketPipeline, Utterance, device_view, make_batch, tensors, wire_waves,
)
from tpuasr_torch.data.prefetch import prefetch_to_device
from tpuasr_torch.data.synthetic import synth_corpus, synth_utterance, synth_utterance_hard

__all__ = ["BatchSpec", "LengthBucketPipeline", "Utterance", "UtteranceMeta", "device_view",
           "make_batch", "make_pipeline", "prefetch_to_device", "read_wav", "scan_split",
           "synth_corpus", "synth_utterance", "synth_utterance_hard", "synthetic_pipeline",
           "tensors", "wire_waves"]
