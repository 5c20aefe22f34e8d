from .cider import CiderD
from .eval_utils import (
    box_iou_accuracy, build_candidate_arrays, debin_boxes, merge_results,
    score_candidates,
)

__all__ = [
    "CiderD", "box_iou_accuracy", "build_candidate_arrays", "debin_boxes",
    "merge_results", "score_candidates",
]
