"""Training losses: CTC and RNN-T (plain lattices and the kernel routes)."""

from tpuasr_torch.losses.ctc import ctc_loss, ctc_loss_from_logits
from tpuasr_torch.losses.rnnt import rnnt_loss, rnnt_loss_from_logits

__all__ = ["ctc_loss", "ctc_loss_from_logits", "rnnt_loss", "rnnt_loss_from_logits"]
