"""Training: the guarded Adam optimizer (and its gradient accumulation),
the train / eval steps of both workloads, checkpoints, metrics, the epoch
loop, learning-rate schedules and checkpoint averaging."""

from tpuasr_torch.train.checkpoint import (
    epoch_path, find_effective_config, latest_path, load_info, restore_checkpoint,
    save_checkpoint,
)
from tpuasr_torch.train.loop import LoopResult, run_epoch, run_eval, train_loop
from tpuasr_torch.train.metrics import MetricsWriter, StepTimer
from tpuasr_torch.train.optim import (
    AccumulatingAdam, FusedAdamState, GuardedAdam, PlateauTracker, make_optimizer,
)
from tpuasr_torch.train.step import (
    TrainState, make_ctc_eval_step, make_ctc_train_step, make_eval_step, make_train_step,
)

__all__ = ["AccumulatingAdam", "FusedAdamState", "GuardedAdam", "LoopResult", "MetricsWriter",
           "PlateauTracker", "StepTimer", "TrainState", "epoch_path", "find_effective_config",
           "latest_path", "load_info", "make_ctc_eval_step", "make_ctc_train_step",
           "make_eval_step", "make_optimizer", "make_train_step", "restore_checkpoint",
           "run_epoch", "run_eval", "save_checkpoint", "train_loop"]
