"""OFA pretraining mixture builders (a copy of ``musketeer_tpu/data/pretrain.py``;
ref: data/pretrain_data/unify_dataset.py).

The reference's UnifyDataset mixes example types: image-text pairs (caption /
QA / visual grounding with pos-neg matching), pure text with BART-style span
infilling, pure-image VQGAN-code infilling, and grounded detection (ref
:110-637; masking :488-594). Musketeer itself never pretrains (the dataset is
only imported by detection_task.py:12), so these builders cover the
capability surface; detection lives in data/detection.py. Each builder draws
from its own seeded numpy ``RandomState`` (and RandAugment from Python's
``random``), as the JAX package's do, so the same seeds give the same
examples in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .task_data import BuilderBase, Example, pre_caption
from .transforms import decode_base64_image, patch_resize, positioning_resize


class TextInfillingBuilder(BuilderBase):
    """Pure-text span infilling (BART-style whole-word masking).

    Source = text with whole-word spans replaced by <mask>; target = original.
    Span lengths ~ Poisson(lambda); total masked fraction ≈ mask_ratio
    (ref: unify_dataset.py:488-594).
    """

    task = "text_infilling"

    def __init__(self, *a, mask_ratio: float = 0.3, poisson_lambda: float = 3.0,
                 seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self.mask_ratio = mask_ratio
        self.poisson_lambda = poisson_lambda
        self.rng = np.random.RandomState(seed)

    def _mask_words(self, words: List[str]) -> List[str]:
        n = len(words)
        n_mask = max(1, int(round(n * self.mask_ratio)))
        masked = words[:]
        budget = n_mask
        guard = 0
        while budget > 0 and guard < 100:
            guard += 1
            span = max(1, int(self.rng.poisson(self.poisson_lambda)))
            span = min(span, budget)
            start = int(self.rng.randint(0, n))
            if masked[start] == "<mask>":
                continue
            for i in range(start, min(start + span, n)):
                if masked[i] != "<mask>":
                    masked[i] = "<mask>"
                    budget -= 1
        # collapse adjacent masks into one token (span infilling)
        out: List[str] = []
        for w in masked:
            if w == "<mask>" and out and out[-1] == "<mask>":
                continue
            out.append(w)
        return out

    def __call__(self, row: Sequence[str]) -> Example:
        text = row[0].strip().lower()
        words = text.split()
        if len(words) > self.max_tgt_length:
            words = words[: self.max_tgt_length]
            text = " ".join(words)
        masked_words = self._mask_words(words)
        # encode word-by-word so <mask> maps to the dictionary symbol
        src_ids: List[int] = []
        for w in masked_words:
            if w == "<mask>":
                src_ids.append(self.vocab.mask_index)
            else:
                src_ids.extend(self.enc(f" {w}"))
        src_prompt = self.enc(' what is the complete text of " ')
        src_suffix = self.enc(' "?')
        src = self.wrap_src(
            np.concatenate([src_prompt, np.asarray(src_ids, np.int32), src_suffix])
        )
        tgt = self.enc(f" {text}")
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=text[:24], src_ids=src, target_ids=target, prev_ids=prev,
        )


class ImageTextPairBuilder(BuilderBase):
    """Image-text pair pretraining example (caption-style).

    Train split applies the reference's patch_resize_transform
    (ref: unify_dataset.py:208-214): shortest-side RandomResize over scales
    [patch..480] capped at 672 → CenterCrop(patch) → RandAugment(2, 7, OFA
    op list) → normalize. Eval keeps the deterministic square resize."""

    task = "image_text_pair"

    def __init__(self, *a, seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self._aug_np = np.random.RandomState(seed)
        from .augment import OFA_RANDAUG_OPS, RandAugment

        self._randaug = RandAugment(2, 7, ops=OFA_RANDAUG_OPS)

    def _train_patch(self, image) -> np.ndarray:
        from .augment import resize_shortest_side
        from .transforms import center_crop, normalize

        S = self.patch_image_size
        size = int(self._aug_np.randint(S, max(481, S + 1)))
        img, _ = resize_shortest_side(image.convert("RGB"), None, size, 672)
        img = center_crop(img, S)
        img = self._randaug(img)
        return normalize(np.asarray(img, np.float32) / 255.0, self.imagenet_stats)

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, caption = row[0], row[1], row[2]
        image = decode_base64_image(image_b64)
        if self.split == "train":
            patch = self._train_patch(image)
        else:
            patch = patch_resize(
                image, self.patch_image_size, self.imagenet_stats
            )
        src = self.wrap_src(self.enc(" what does the image describe?"))
        tgt = self.enc(f" {caption.strip()}", length=self.max_tgt_length)
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True,
        )


# small default pool for negative-object substitution; pass ``objects=`` with
# the reference's full object list for production pretraining
_DEFAULT_OBJECTS = (
    "man", "woman", "dog", "cat", "car", "bus", "tree", "chair", "table",
    "bird", "horse", "boat", "plane", "bottle", "cup", "phone", "clock",
)


class ImageTextMatchingBuilder(BuilderBase):
    """Binary image-text matching: ``does the image describe " {} "?`` → yes/no.

    ref: unify_dataset.py:280-281 (prompt), :239-249 (negative caption by
    swapping a ground-truth object for a random pool object), :345-360
    (pos/neg examples with " yes"/" no" targets). Row format:
    ``uniq_id \\t image(b64) \\t caption [\\t gt_objects('&&'-joined)]``.
    The reference flips a coin per sample; here ``p_negative`` controls the
    mix and the per-builder RNG keeps epochs deterministic.
    """

    task = "image_text_matching"

    def __init__(self, *a, objects: Optional[Sequence[str]] = None,
                 p_negative: float = 0.5, seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self.objects = list(objects) if objects else list(_DEFAULT_OBJECTS)
        self.p_negative = p_negative
        self.rng = np.random.RandomState(seed)

    def _negative_caption(self, caption: str, gt_objects: str) -> str:
        gts = [o for o in gt_objects.strip().split("&&") if o]
        if gts and self.rng.rand() > 0.4:
            gt = gts[int(self.rng.randint(len(gts)))]
            neg = self.objects[int(self.rng.randint(len(self.objects)))]
            if neg == gt:
                neg = self.objects[-1] if gt != self.objects[-1] else self.objects[0]
            if gt in caption:
                return caption.replace(gt, neg)
        # no usable gt object: swap a random word for a random pool object
        words = caption.split()
        if words:
            words[int(self.rng.randint(len(words)))] = (
                self.objects[int(self.rng.randint(len(self.objects)))]
            )
        return " ".join(words)

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, caption = row[0], row[1], row[2]
        gt_objects = row[3] if len(row) > 3 else ""
        patch = patch_resize(
            decode_base64_image(image_b64), self.patch_image_size, self.imagenet_stats
        )
        negative = self.split == "train" and self.rng.rand() < self.p_negative
        cap = pre_caption(
            self._negative_caption(caption, gt_objects) if negative else caption,
            self.max_src_length,
        )
        src = self.wrap_src(self.enc(f' does the image describe " {cap} "?'))
        tgt = self.enc(" no" if negative else " yes")
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True,
        )


class PureImageBuilder(BuilderBase):
    """Masked-middle image → VQGAN code infilling (ref: unify_dataset.py:396-423).

    Row: ``image_id \\t image(b64) \\t 'c0 c1 ...'`` (pre-extracted VQGAN
    codes, as in the reference's pure_image TSVs). The image is resized to
    ``2*code_image_size``, the central square ([0.5c, 1.5c) on both axes,
    ref :197-198) is zeroed post-normalization (ref :399-400), and the
    target is the code-token sequence with ``code_mask=True`` so the decoder
    uses image relative-position bias. conf=2.0 (ref :401 weighting).
    """

    task = "pure_image"

    def __init__(self, *a, code_image_size: int = 128, **kw):
        super().__init__(*a, **kw)
        self.code_image_size = code_image_size

    def __call__(self, row: Sequence[str]) -> Example:
        image_id, image_b64, code = row[0], row[1], row[2]
        S = self.code_image_size * 2
        patch = np.array(
            patch_resize(decode_base64_image(image_b64), S, self.imagenet_stats)
        )
        lo, hi = S // 4, (3 * S) // 4
        patch[lo:hi, lo:hi, :] = 0.0
        src = self.wrap_src(self.enc(" what is the image in the middle part?"))
        codes = np.asarray(
            [self.vocab.code_token(int(c)) for c in code.strip().split()], np.int32
        )
        target, prev = self.seq2seq_targets(codes)
        return Example(
            id=image_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True, code_mask=True, conf=2.0,
        )


class VisualGroundingBuilder(BuilderBase):
    """Pretrain visual grounding pair (ref: unify_dataset.py:294-349).

    Row: ``uniq_id \\t image(b64) \\t caption \\t 'x0,y0,x1,y1'``. Two modes
    (the reference emits BOTH examples per row, :337-348):

    - ``mode='grounding'``: ``which region does the text " {} " describe?``
      → 4 ``<bin_k>`` tokens,
    - ``mode='region_caption'``: ``what does the region describe? region:``
      + bins → caption.
    """

    task = "visual_grounding"

    def __init__(self, *a, num_bins: int = 1000, max_image_size: int = 512,
                 mode: str = "grounding", seed: int = 0, **kw):
        super().__init__(*a, **kw)
        assert mode in ("grounding", "region_caption"), mode
        self.num_bins = num_bins
        self.max_image_size = max_image_size
        self.mode = mode
        self.rng = np.random.RandomState(seed)

    def _train_transform(self, image, box):
        """Shortest-side RandomResize (patch..480, cap 672) + box-centered
        crop to the patch size (ref: unify_dataset.py:229-234
        visual_grounding_transform = RandomResize(scales, 672) +
        ObjectCenterCrop(patch))."""
        from .augment import object_center_crop, resize_shortest_side
        from .transforms import normalize

        S = self.patch_image_size
        size = int(self.rng.randint(S, max(481, S + 1)))
        img, box = resize_shortest_side(image.convert("RGB"), box, size, 672)
        img, box = object_center_crop(img, box, S, S)
        patch = normalize(
            np.asarray(img, np.float32) / 255.0, self.imagenet_stats
        )
        return patch, box / self.max_image_size

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, caption, region = row[0], row[1], row[2], row[3]
        image = decode_base64_image(image_b64)
        box = np.asarray(
            [[float(v) for v in region.strip().split(",")]], np.float32
        )
        if self.split == "train":
            patch, boxes_norm = self._train_transform(image, box)
            w_r = h_r = 1.0
        else:
            patch, boxes_norm, w_r, h_r = positioning_resize(
                image, box, self.patch_image_size, self.max_image_size,
                self.imagenet_stats,
            )
        quant = np.round(boxes_norm[0] * (self.num_bins - 1)).astype(int)
        region_tokens = " ".join(f"<bin_{int(v)}>" for v in quant)

        if self.mode == "grounding":
            cap = pre_caption(caption, self.max_src_length)
            src = self.wrap_src(
                self.enc(f' which region does the text " {cap} " describe?')
            )
            tgt = self.enc(region_tokens, use_bpe=False)
        else:
            prefix = self.enc("  what does the region describe? region:")
            bins = self.enc(region_tokens, use_bpe=False)
            src = self.wrap_src(np.concatenate([prefix, bins]).astype(np.int32))
            tgt = self.enc(f" {pre_caption(caption, self.max_tgt_length)}")
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True,
            extras={"w_resize_ratio": w_r, "h_resize_ratio": h_r},
        )
