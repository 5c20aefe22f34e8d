from .base import Task, batch_to_taskbatch, iter_batches
from .musketeer import MusketeerDataLoader, SubTaskSpec
from .tasks import (
    TASK_REGISTRY, AllCandTask, CaptionTask, GigawordTask, GlueTask,
    ImageClassifyTask, RefcocoTask, SnliVeTask, VqaTask,
)

__all__ = [
    "Task", "batch_to_taskbatch", "iter_batches", "MusketeerDataLoader", "SubTaskSpec",
    "TASK_REGISTRY", "AllCandTask",
    "CaptionTask", "GigawordTask", "GlueTask", "ImageClassifyTask", "RefcocoTask",
    "SnliVeTask", "VqaTask",
]
