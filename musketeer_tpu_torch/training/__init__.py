from .checkpoint import (
    CheckpointManager, export_pt, import_pt, load_checkpoint, save_checkpoint, wait_for_saves,
)
from .metrics import MetricsLogger, SmoothedMeter, named_scope, profile_trace
from .train_state import TrainState, ema_update, init_train_state, make_optimizer
from .train_step import TaskBatch, make_train_step
from .trainer import EarlyStopper, train_loop

__all__ = ["CheckpointManager", "EarlyStopper", "MetricsLogger", "SmoothedMeter", "TaskBatch",
           "TrainState", "ema_update", "export_pt", "import_pt", "init_train_state",
           "load_checkpoint", "make_optimizer", "make_train_step", "named_scope",
           "profile_trace", "save_checkpoint", "train_loop", "wait_for_saves"]
