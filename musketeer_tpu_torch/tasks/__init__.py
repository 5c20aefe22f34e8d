from .base import Task, batch_to_taskbatch, iter_batches
from .detection import DetectionTask
from .image_gen import ImageGenTask
from .musketeer import MusketeerDataLoader, SubTaskSpec
from .tasks import (
    TASK_REGISTRY, AllCandTask, CaptionTask, GigawordTask, GlueTask,
    ImageClassifyTask, RefcocoTask, SnliVeTask, VqaTask,
)

# image_gen and detection register here, as in the JAX package
TASK_REGISTRY["image_gen"] = ImageGenTask
TASK_REGISTRY["detection"] = DetectionTask

__all__ = [
    "Task", "batch_to_taskbatch", "iter_batches", "MusketeerDataLoader", "SubTaskSpec",
    "TASK_REGISTRY", "AllCandTask",
    "CaptionTask", "DetectionTask", "GigawordTask", "GlueTask", "ImageClassifyTask", "ImageGenTask",
    "RefcocoTask", "SnliVeTask", "VqaTask",
]
