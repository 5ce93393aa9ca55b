"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from tpuasr_torch.ops._build import LAUNCHES, build_all, reset_launch_counts
from tpuasr_torch.ops.fbank import fbank_frames, fbank_frames_plain
from tpuasr_torch.ops.relpos_attention import relpos_attention, relpos_attention_plain

__all__ = [
    "LAUNCHES", "build_all", "reset_launch_counts",
    "fbank_frames", "fbank_frames_plain",
    "relpos_attention", "relpos_attention_plain",
]
