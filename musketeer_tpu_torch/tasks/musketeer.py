"""The Musketeer composite task: joint multi-task training over up to 9 tasks
(port of ``musketeer_tpu/tasks/musketeer.py``).

The reference's zip-of-datasets with equal sampling (ref:
data/mm_data/musketeer_data.py:184-319, tasks/mm_tasks/musketeer_task.py:
344-613), as the JAX package implements it:

- each step pulls ``batch_size`` samples from every sub-dataset in a seeded
  per-epoch order, modulo its (possibly equal-sampling-truncated) length; an
  epoch is as long as the largest sub-dataset;
- each task's micro-batches collate separately and stack on a leading
  accumulation axis; the train step consumes the dict of ``TaskBatch``es;
- with ``compress_transport`` images travel as uint8 with their [2, 3]
  dequantization affine, constraint masks bit-packed
  (``train_step.dequantize_batch`` expands them on the device);
- a spec's ``sample_patch_num`` (the reference's 196 for the head task) gives
  its batches a ``sample_patch_order``, each sample's patches drawn from the
  epoch's ``RandomState`` as the JAX loader draws them.

The batches are CPU tensors; the prefetch thread (``training/prefetch.py``)
or the train loop copies them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..data.file_dataset import FileDataset
from ..data.task_data import Example, collate
from ..data.transforms import norm_constants
from ..tokenization import OFAVocab
from ..training.train_step import TaskBatch
from .base import batch_to_taskbatch
from .tasks import TASK_REGISTRY, Task

@dataclass
class SubTaskSpec:
    name: str
    file_path: str  # TSV (may be comma-separated epoch round-robin paths)
    batch_size: int = 2
    src_len: Optional[int] = None  # static bucket lengths (None = per-batch)
    tgt_len: Optional[int] = None
    # train-time image patch subsampling (ref: sample_patch_num=196,
    # label_smoothed_cross_entropy.py:177-181)
    sample_patch_num: Optional[int] = None
    task_kwargs: Dict[str, Any] = field(default_factory=dict)


class MusketeerDataLoader:
    """Joint loader: one step = a dict of per-task collated batches."""

    def __init__(
        self,
        vocab: OFAVocab,
        specs: Sequence[SubTaskSpec],
        description: str = "tep",
        eq_sampling: int = 0,
        subset_sampling: Optional[str] = None,  # 'vg'|'caption' anchor
        seed: int = 7,
        shard_id: int = 0,
        num_shards: int = 1,
        update_freq: int = 1,
        compress_transport: bool = True,
    ):
        self.vocab = vocab
        self.specs = list(specs)
        self.seed = seed
        self.update_freq = update_freq
        self.compress_transport = compress_transport
        self.tasks: Dict[str, Task] = {}
        self.builders = {}
        self.datasets: Dict[str, FileDataset] = {}
        self.epoch_paths: Dict[str, List[str]] = {}
        for spec in self.specs:
            task = TASK_REGISTRY[spec.name](vocab, description=description, **spec.task_kwargs)
            self.tasks[spec.name] = task
            builder = task.builder("train")
            # uint8-direct transport: builders whose post-resize chain is
            # exactly `normalize` emit raw uint8 pixels; builders with
            # float-domain augmentation ignore the flag (requantized below)
            if compress_transport and getattr(builder, "uint8_safe", True):
                builder.transport_uint8 = True
            self.builders[spec.name] = builder
            # round-robin epoch paths (ref: musketeer_task.py:358-460)
            self.epoch_paths[spec.name] = spec.file_path.split(",")
            self.datasets[spec.name] = FileDataset(
                self.epoch_paths[spec.name][0], shard_id=shard_id, num_shards=num_shards)
        self.shard_id = shard_id
        self.num_shards = num_shards

        # equal sampling truncation (ref: musketeer_data.py:184-220)
        if subset_sampling in ("vg", "caption"):
            anchor = {"vg": "refcoco", "caption": "caption"}[subset_sampling]
            sample_size = self.datasets[anchor].row_count
        else:
            sample_size = eq_sampling if eq_sampling > 0 else None
        if sample_size is not None:
            for ds in self.datasets.values():
                ds.row_count = min(ds.row_count, sample_size)

        self.main_len = max(ds.row_count for ds in self.datasets.values())
        self.epoch = 1

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for spec in self.specs:
            paths = self.epoch_paths[spec.name]
            path = paths[(epoch - 1) % len(paths)]
            if path != self.datasets[spec.name].file_path:
                self.datasets[spec.name].close()
                self.datasets[spec.name] = FileDataset(
                    path, shard_id=self.shard_id, num_shards=self.num_shards)

    def close(self) -> None:
        for ds in self.datasets.values():
            ds.close()

    def steps_per_epoch(self) -> int:
        per_micro = max(s.batch_size for s in self.specs)
        return self.main_len // (per_micro * self.update_freq)

    def epoch_iterator(self, shuffle: bool = True,
                       skip_steps: int = 0) -> Iterator[Dict[str, TaskBatch]]:
        """Yields one dict of accumulation-stacked TaskBatches (CPU tensors)
        per optimizer step.

        ``skip_steps`` fast-forwards the deterministic sample order without
        building examples (mid-epoch resume, ref: trainer.py:566-626)."""
        rng = np.random.RandomState(self.seed + self.epoch)
        order = {
            name: (rng.permutation(ds.row_count) if shuffle else np.arange(ds.row_count))
            for name, ds in self.datasets.items()
        }
        cursors = {s.name: skip_steps * self.update_freq * s.batch_size for s in self.specs}

        def next_examples(name, n) -> List[Example]:
            ds = self.datasets[name]
            c = cursors[name]
            idx = [order[name][(c + j) % ds.row_count] for j in range(n)]
            cursors[name] = c + n
            build = self.builders[name]
            return [build(cols) for cols in ds.get_batch(idx)]

        for _ in range(max(0, self.steps_per_epoch() - skip_steps)):
            step_batches: Dict[str, List[Dict]] = {s.name: [] for s in self.specs}
            for _ in range(self.update_freq):
                for spec in self.specs:
                    exs = next_examples(spec.name, spec.batch_size)
                    b = collate(exs, pad_id=self.vocab.pad, src_len=spec.src_len,
                                tgt_len=spec.tgt_len)
                    if self.compress_transport:
                        b = _compress_batch(b, self.builders[spec.name])
                    if spec.sample_patch_num and "patch_images" in b:
                        # each sample's patches, drawn from the epoch's stream
                        # as the JAX loader draws them
                        n = (b["patch_images"].shape[1] // 16) ** 2
                        k = min(spec.sample_patch_num, n)
                        b["sample_patch_order"] = np.stack(
                            [rng.permutation(n)[:k] for _ in range(spec.batch_size)]
                        ).astype(np.int32)
                    step_batches[spec.name].append(b)
            yield {
                name: _stack_micro([batch_to_taskbatch(b, "cpu") for b in micro_list])
                for name, micro_list in step_batches.items()
            }


def _compress_batch(b: Dict, builder) -> Dict:
    """Shrink the host→device transfer (``train_step.dequantize_batch`` is the
    in-step inverse): normalized float32 images → raw uint8 + the [2, 3]
    dequantization affine (exact: the pixels started as uint8 and sit on the
    1/255 grid); bool constraint masks → little-endian packed bits."""
    imgs = b.get("patch_images")
    if imgs is not None and getattr(builder, "uint8_safe", True):
        norm = norm_constants(getattr(builder, "imagenet_stats", False))
        if imgs.dtype == np.uint8:
            # the builder emitted raw pixels (transport_uint8): attach the affine
            b["patch_norm"] = norm
        elif imgs.dtype == np.float32:
            p = np.clip(np.rint((imgs - norm[1]) / norm[0]), 0, 255)
            b["patch_images"] = p.astype(np.uint8)
            b["patch_norm"] = norm
    cm = b.get("constraint_masks")
    if cm is not None and cm.dtype == np.bool_ and cm.shape[-1] % 8 == 0:
        b["constraint_masks"] = np.packbits(cm, axis=-1, bitorder="little")
    return b


def _stack_micro(batches: List[TaskBatch]) -> TaskBatch:
    """Per-microbatch TaskBatches → one with a leading accumulation axis."""
    return TaskBatch(*[None if vals[0] is None else torch.stack(vals) for vals in zip(*batches)])
