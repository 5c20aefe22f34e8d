from .train_state import TrainState, ema_update, init_train_state, make_optimizer
from .train_step import TaskBatch, make_train_step

__all__ = ["TaskBatch", "TrainState", "ema_update", "init_train_state", "make_optimizer",
           "make_train_step"]
