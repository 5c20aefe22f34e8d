"""Task abstraction (port of ``musketeer_tpu/tasks/base.py``).

A Task owns its example builder (data), its generator settings, optional
constrained-decoding assets (tries, candidate sets), and an ``evaluate``
method that runs the task's metric over a dataset. The JAX package jits the
device work of each; here it runs eagerly under ``torch.inference_mode()``
on the device of the parameters the caller built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import GenerationConfig, ModelConfig
from ..data.task_data import BuilderBase, Example, collate
from ..tokenization import OFAVocab
from ..training.train_step import TaskBatch


def params_device(params) -> torch.device:
    """The device of a parameter tree (the first tree of an ensemble list)."""
    tree = params[0] if isinstance(params, (list, tuple)) else params
    return tree["embed_tokens"].device


def to_device(a: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A collated numpy array → a tensor on ``device`` (ids as int64)."""
    if dtype is None and a.dtype.kind == "i":
        dtype = torch.long
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def batch_to_taskbatch(batch: Dict[str, Any], device, accum: bool = False) -> TaskBatch:
    """collate() dict → TaskBatch on ``device`` (optionally adding a leading accum axis)."""

    def get(key):
        v = batch.get(key)
        if v is None:
            return None
        t = to_device(np.asarray(v), device)
        return t[None] if accum else t

    return TaskBatch(
        src_tokens=get("src_tokens"),
        prev_output_tokens=get("prev_output_tokens"),
        target=get("target"),
        patch_images=get("patch_images"),
        patch_masks=get("patch_masks"),
        constraint_masks=get("constraint_masks"),
        conf=get("conf"),
        code_masks=get("code_masks"),
        sample_patch_order=get("sample_patch_order"),
        patch_norm=get("patch_norm"),
    )


def iter_batches(
    dataset,
    builder: Callable[[Sequence[str]], Example],
    batch_size: int,
    pad_id: int,
    src_len: Optional[int] = None,
    tgt_len: Optional[int] = None,
    limit: Optional[int] = None,
    drop_last: bool = False,
):
    """Sequential batching over a FileDataset through a builder."""
    n = len(dataset) if limit is None else min(limit, len(dataset))
    buf: List[Example] = []
    for i in range(n):
        buf.append(builder(dataset[i]))
        if len(buf) == batch_size:
            yield collate(buf, pad_id=pad_id, src_len=src_len, tgt_len=tgt_len)
            buf = []
    if buf and not drop_last:
        yield collate(buf, pad_id=pad_id, src_len=src_len, tgt_len=tgt_len)


class Task:
    """Base task: subclasses set `name` and implement builder()/evaluate()."""

    name: str = ""

    def __init__(self, vocab: OFAVocab, description: str = "tep", **kw):
        self.vocab = vocab
        self.description = description
        self.kw = kw

    # -- data ------------------------------------------------------------
    def builder(self, split: str = "train") -> BuilderBase:
        raise NotImplementedError

    # -- generation -------------------------------------------------------
    def generation_config(self) -> GenerationConfig:
        return GenerationConfig()

    def set_generation_overrides(self, **kw) -> None:
        """Override fields of this task's generation config (the reference's
        eval-time ``--model-overrides`` / --beam flags, evaluate.py:60-63).
        Shadows ``generation_config`` on the instance."""
        base = self.generation_config
        self.generation_config = lambda: dataclasses.replace(base(), **kw)

    # -- evaluation --------------------------------------------------------
    def evaluate(
        self, params, model_cfg: ModelConfig, dataset, batch_size: int = 8,
        limit: Optional[int] = None,
    ) -> Dict[str, float]:
        raise NotImplementedError
