"""Detection dataset builder, COCO multi-object targets (a copy of
``musketeer_tpu/data/detection.py``).

ref: data/cv_data/detection_dataset.py:305-420. Row format:
``image_id \t image(b64) \t 'x0,y0,x1,y1,cat_id,cat&&...'``; targets are
shuffled ``[<bin>×4, label-tokens]`` sequences with conf=2.0 weighting
(ref :332).

The reference's ``__getitem__`` falls through ``process_detection`` without a
return (detection_dataset.py:418-420), so its joint training silently gets
no detection samples (SURVEY.md §5, "known quirks"). The JAX package does
not reproduce that, and neither does the port: this builder returns the
example, and a joint run without detection is the reference's effective
behaviour.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .task_data import BuilderBase, Example
from .transforms import decode_base64_image, positioning_resize


class DetectionBuilder(BuilderBase):
    task = "detection"

    def __init__(self, *a, num_bins: int = 1000, max_image_size: int = 512,
                 seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self.num_bins = num_bins
        self.max_image_size = max_image_size
        self.rng = np.random.RandomState(seed)

    def __call__(self, row: Sequence[str]) -> Example:
        image_id, image_b64, label = row[0], row[1], row[2]
        image = decode_base64_image(image_b64)
        boxes, labels = [], []
        for item in label.strip().split("&&"):
            x0, y0, x1, y1, cat_id, cat = item.strip().split(",", 5)
            boxes.append([float(x0), float(y0), float(x1), float(y1)])
            labels.append(cat)
        boxes = np.asarray(boxes, np.float32)
        order = (
            self.rng.permutation(len(boxes))
            if self.split == "train" and len(boxes) > 1
            else np.arange(len(boxes))
        )
        boxes, labels = boxes[order], [labels[i] for i in order]

        # train-time box-aware flip (ref: detection_dataset.py:167-172
        # RandomHorizontalFlip before the square resize)
        if self.split == "train" and self.rng.rand() < 0.5:
            from .augment import horizontal_flip  # PIL, imported where it is used

            image, boxes = horizontal_flip(image.convert("RGB"), boxes)

        patch, boxes_norm, w_r, h_r = positioning_resize(
            image, boxes, self.patch_image_size, self.max_image_size,
            self.imagenet_stats, as_uint8=self.transport_uint8,
        )
        tgt_ids = []
        for i, b in enumerate(boxes_norm):
            quant = np.round(b * (self.num_bins - 1)).astype(int)
            tgt_ids.extend(self.vocab.bin_token(int(q)) for q in quant)
            tgt_ids.extend(self.enc(f" {labels[i]}"))
        tgt = np.asarray(tgt_ids, np.int32)[: self.max_tgt_length * 6]

        src = self.wrap_src(self.enc(self.prompt()))
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=image_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True, conf=2.0,
            extras={
                "boxes": boxes, "labels": labels,
                "w_resize_ratio": w_r, "h_resize_ratio": h_r,
            },
        )
