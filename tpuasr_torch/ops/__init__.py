"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from tpuasr_torch.ops._build import LAUNCHES, build_all, reset_launch_counts
from tpuasr_torch.ops.ctc import (
    ctc_alpha, ctc_alpha_plain, ctc_beta_grad, ctc_beta_grad_plain, ctc_lattice,
)
from tpuasr_torch.ops.fbank import fbank_frames, fbank_frames_plain
from tpuasr_torch.ops.relpos_attention import relpos_attention, relpos_attention_plain
from tpuasr_torch.ops.rnnt_fused import (
    rnnt_fused_grads, rnnt_fused_grads_plain, rnnt_fused_lp, rnnt_fused_lp_plain,
    rnnt_loss_fused_mean,
)

__all__ = [
    "LAUNCHES", "build_all", "reset_launch_counts",
    "ctc_alpha", "ctc_alpha_plain", "ctc_beta_grad", "ctc_beta_grad_plain", "ctc_lattice",
    "fbank_frames", "fbank_frames_plain",
    "relpos_attention", "relpos_attention_plain",
    "rnnt_fused_grads", "rnnt_fused_grads_plain", "rnnt_fused_lp", "rnnt_fused_lp_plain",
    "rnnt_loss_fused_mean",
]
