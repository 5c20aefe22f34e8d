from .label_smoothed_ce import CELossOut, label_smoothed_ce
from .scst import compute_rewards, make_scst_fns, scst_loss, scst_train_step
from .clip_scst import clip_rewards, clip_scst_train_step

__all__ = ["CELossOut", "label_smoothed_ce", "compute_rewards", "make_scst_fns", "scst_loss",
           "scst_train_step", "clip_rewards", "clip_scst_train_step"]
