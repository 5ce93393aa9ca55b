"""Training losses: CTC and RNN-T (plain lattices and the kernel routes) and
the pruned RNN-T loss."""

from tpuasr_torch.losses.ctc import ctc_loss, ctc_loss_from_logits
from tpuasr_torch.losses.rnnt import (
    rnnt_loss, rnnt_loss_from_logits, rnnt_loss_sharded, rnnt_loss_sharded_joint,
)
from tpuasr_torch.losses.rnnt_pruned import band_offsets, rnnt_loss_pruned

__all__ = ["band_offsets", "ctc_loss", "ctc_loss_from_logits", "rnnt_loss",
           "rnnt_loss_from_logits", "rnnt_loss_pruned", "rnnt_loss_sharded",
           "rnnt_loss_sharded_joint"]
