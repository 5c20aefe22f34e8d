from .label_smoothed_ce import CELossOut, label_smoothed_ce

__all__ = ["CELossOut", "label_smoothed_ce"]
