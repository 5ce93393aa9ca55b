"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from tpuasr_torch.ops._build import KERNELS, LAUNCHES, build_all, reset_launch_counts
from tpuasr_torch.ops.ctc import (
    ctc_alpha, ctc_alpha_plain, ctc_beta_grad, ctc_beta_grad_plain, ctc_lattice,
)
from tpuasr_torch.ops.fbank import fbank_frames, fbank_frames_plain
from tpuasr_torch.ops.ffn import ffn_bwd, ffn_bwd_plain, ffn_fwd, ffn_fwd_plain, fused_ffn
from tpuasr_torch.ops.relpos_attention import (
    relpos_attention, relpos_attention_bwd, relpos_attention_bwd_plain, relpos_attention_plain,
)
from tpuasr_torch.ops.rnnt_fused import (
    rnnt_fused_grads, rnnt_fused_grads_plain, rnnt_fused_lp, rnnt_fused_lp_plain,
    rnnt_loss_fused_mean,
)
from tpuasr_torch.ops.rnnt_lattice import (
    rnnt_alpha, rnnt_alpha_plain, rnnt_beta_grad, rnnt_beta_grad_plain, rnnt_lattice,
)

__all__ = [
    "KERNELS", "LAUNCHES", "build_all", "reset_launch_counts",
    "ctc_alpha", "ctc_alpha_plain", "ctc_beta_grad", "ctc_beta_grad_plain", "ctc_lattice",
    "fbank_frames", "fbank_frames_plain",
    "ffn_bwd", "ffn_bwd_plain", "ffn_fwd", "ffn_fwd_plain", "fused_ffn",
    "relpos_attention", "relpos_attention_bwd", "relpos_attention_bwd_plain",
    "relpos_attention_plain",
    "rnnt_fused_grads", "rnnt_fused_grads_plain", "rnnt_fused_lp", "rnnt_fused_lp_plain",
    "rnnt_loss_fused_mean",
    "rnnt_alpha", "rnnt_alpha_plain", "rnnt_beta_grad", "rnnt_beta_grad_plain", "rnnt_lattice",
]
