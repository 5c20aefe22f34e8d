"""Pretraining task registry entries (port of ``musketeer_tpu/tasks/pretrain.py``;
ref: tasks/pretrain_tasks/unify_task.py).

The reference exposes pretraining through a single UnifyTask that mixes
image-text pairs, matching, pure text, pure image, grounding, and detection
sub-streams. Here each stream is a registered task, so the joint
``MusketeerDataLoader`` (which already mixes tasks per step with per-task
batch sizes) reproduces the mixture — idiomatic for the multi-task loader
instead of one dataset class with internal branching.
"""

from __future__ import annotations

from ..config import GenerationConfig
from ..data.pretrain import (
    ImageTextMatchingBuilder, ImageTextPairBuilder, PureImageBuilder,
    TextInfillingBuilder, VisualGroundingBuilder,
)
from .base import Task


class TextInfillingTask(Task):
    name = "text_infilling"

    def builder(self, split: str = "train"):
        return TextInfillingBuilder(
            self.vocab, description=self.description, split=split, **self.kw
        )


class ImageTextPairTask(Task):
    name = "image_text_pair"

    def builder(self, split: str = "train"):
        return ImageTextPairBuilder(
            self.vocab, description=self.description, split=split, **self.kw
        )

    def generation_config(self) -> GenerationConfig:
        return GenerationConfig(beam_size=5, max_len_b=16, no_repeat_ngram_size=3)


class ImageTextMatchingTask(Task):
    name = "image_text_matching"

    def builder(self, split: str = "train"):
        return ImageTextMatchingBuilder(
            self.vocab, description=self.description, split=split, **self.kw
        )


class PureImageTask(Task):
    name = "pure_image"

    def builder(self, split: str = "train"):
        return PureImageBuilder(
            self.vocab, description=self.description, split=split, **self.kw
        )

    def generation_config(self) -> GenerationConfig:
        # code generation: constrained to the code-token band by gen_code
        return GenerationConfig(beam_size=1, max_len_b=256, min_len=256,
                                gen_code=True)


class VisualGroundingTask(Task):
    name = "visual_grounding"

    def builder(self, split: str = "train"):
        return VisualGroundingBuilder(
            self.vocab, description=self.description, split=split, **self.kw
        )

    def generation_config(self) -> GenerationConfig:
        v = self.vocab
        return GenerationConfig(
            beam_size=5, max_len_b=4, min_len=4,
            gen_box=True, constraint_range=(v.bin_start, v.vocab_size),
        )
