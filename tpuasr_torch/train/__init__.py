"""Training: the guarded Adam optimizer and the train / eval steps."""

from tpuasr_torch.train.optim import (
    FusedAdamState, GuardedAdam, PlateauTracker, make_optimizer,
)
from tpuasr_torch.train.step import TrainState, make_eval_step, make_train_step

__all__ = ["FusedAdamState", "GuardedAdam", "PlateauTracker", "TrainState",
           "make_eval_step", "make_optimizer", "make_train_step"]
