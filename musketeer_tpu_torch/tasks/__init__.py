from .base import Task, batch_to_taskbatch, iter_batches
from .tasks import (
    TASK_REGISTRY, AllCandTask, CaptionTask, GigawordTask, GlueTask,
    ImageClassifyTask, RefcocoTask, SnliVeTask, VqaTask,
)

__all__ = [
    "Task", "batch_to_taskbatch", "iter_batches", "TASK_REGISTRY", "AllCandTask",
    "CaptionTask", "GigawordTask", "GlueTask", "ImageClassifyTask", "RefcocoTask",
    "SnliVeTask", "VqaTask",
]
