"""Per-task example builders: TSV row → model features (port of
``musketeer_tpu/data/task_data.py``: the eval builders and ``collate``).

Host-side (numpy/PIL) feature construction reproducing the reference
datasets' text/target semantics (citations per builder), as the JAX package
does. Row formats (TSV columns):
  caption:        uniq_id, image(b64), caption            (caption_dataset.py:179)
  refcoco:        uniq_id, image(b64), text, region(x0,y0,x1,y1) (refcoco_dataset.py:137)
  vqa_gen:        uniq_id, image(b64), question, ref ("conf|!+ans&&…"), [predict_objects] (vqa_gen_dataset.py:96-151)
  snli_ve:        uniq_id, image(b64), hypothesis, caption, label (snli_ve_dataset.py:150)
  image_classify: uniq_id, image(b64), label-name         (image_classify_dataset.py)
  gigaword:       source, target                           (summary_dataset.py:130-160)
  image_gen:      uniq_id, caption, codes                  (image_gen_dataset.py:120-185)
  glue (cola…):   task-specific text columns + label
"""

from __future__ import annotations

import re
import string
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..tokenization import OFAVocab
from . import prompts as P
from .transforms import decode_base64_image, patch_resize, positioning_resize

_PUNCT_TABLE = str.maketrans({k: None for k in string.punctuation})


def pre_question(q: str, max_words: Optional[int] = None) -> str:
    """ref: data/ofa_dataset.py:45-61."""
    q = q.lower().lstrip(",.!?*#:;~").replace("-", " ").replace("/", " ")
    q = re.sub(r"\s{2,}", " ", q).rstrip("\n").strip(" ")
    words = q.split(" ")
    if max_words is not None and len(words) > max_words:
        q = " ".join(words[:max_words])
    return q


def pre_caption(c: str, max_words: Optional[int] = None) -> str:
    """ref: data/ofa_dataset.py:63-79."""
    c = (
        c.lower()
        .lstrip(",.!?*#:;~")
        .replace("-", " ")
        .replace("/", " ")
        .replace("<person>", "person")
    )
    c = re.sub(r"\s{2,}", " ", c).rstrip("\n").strip(" ")
    words = c.split(" ")
    if max_words is not None and len(words) > max_words:
        c = " ".join(words[:max_words])
    return c


@dataclass
class Example:
    id: str
    src_ids: np.ndarray  # int32, incl. bos/eos
    target_ids: Optional[np.ndarray] = None  # int32, ends with eos
    prev_ids: Optional[np.ndarray] = None  # int32, starts with bos/prompt
    patch_image: Optional[np.ndarray] = None  # [S,S,3] f32, or uint8 when transport_uint8
    patch_mask: bool = False
    constraint_mask: Optional[np.ndarray] = None  # [T_tgt, V] bool
    conf: float = 1.0
    code_mask: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


class BuilderBase:
    task: str = ""

    def __init__(
        self,
        vocab: OFAVocab,
        description: str = "tep",
        split: str = "train",
        max_src_length: int = 512,
        max_tgt_length: int = 30,
        patch_image_size: int = 480,
        imagenet_stats: bool = False,
    ):
        self.vocab = vocab
        self.description = description
        self.split = split
        self.max_src_length = max_src_length
        self.max_tgt_length = max_tgt_length
        self.patch_image_size = patch_image_size
        self.imagenet_stats = imagenet_stats
        # False when the builder's output holds float-domain augmentation
        # values off the uint8 pixel grid; the loader's uint8 transport would
        # clip them (tasks/musketeer.py::_compress_batch checks)
        self.uint8_safe = True
        # set by MusketeerDataLoader when the uint8 transport is on: builders
        # whose post-resize chain is exactly `normalize` emit raw uint8
        # pixels (bit-identical after the in-step dequantization)
        self.transport_uint8 = False

    def enc(self, text: str, length=None, use_bpe=True) -> np.ndarray:
        return self.vocab.encode_text(text, length=length, use_bpe=use_bpe)

    def wrap_src(self, ids: np.ndarray) -> np.ndarray:
        return np.concatenate([[self.vocab.bos], ids, [self.vocab.eos]]).astype(np.int32)

    def seq2seq_targets(self, tgt_ids: np.ndarray):
        target = np.concatenate([tgt_ids, [self.vocab.eos]]).astype(np.int32)
        prev = np.concatenate([[self.vocab.bos], tgt_ids]).astype(np.int32)
        return target, prev

    def prompt(self) -> str:
        return P.get_prompt(self.task, self.description)


class CaptionBuilder(BuilderBase):
    """ref: data/mm_data/caption_dataset.py:135-215."""

    task = "caption"

    def __init__(self, *a, scst: bool = False, **kw):
        super().__init__(*a, **kw)
        self.scst = scst

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, caption = row[0], row[1], row[2]
        patch = patch_resize(
            decode_base64_image(image_b64), self.patch_image_size,
            self.imagenet_stats, as_uint8=self.transport_uint8,
        )
        if self.split == "train" and not self.scst:
            caption = caption.translate(_PUNCT_TABLE).strip()
            tgt_caption = " ".join(caption.strip().split()[: self.max_tgt_length])
        else:
            caption = " ".join(caption.strip().split())
            tgt_caption = "&&".join(
                c.translate(_PUNCT_TABLE).strip() for c in caption.split("&&")
            )
        src = self.wrap_src(self.enc(self.prompt()))
        tgt = self.enc(f" {tgt_caption}")
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True,
            extras={"caption_refs": caption},
        )


class RefcocoBuilder(BuilderBase):
    """ref: data/mm_data/refcoco_dataset.py:136-178."""

    task = "refcoco"

    def __init__(self, *a, num_bins: int = 1000, max_image_size: int = 512, **kw):
        super().__init__(*a, **kw)
        self.num_bins = num_bins
        self.max_image_size = max_image_size

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, text, region = row[0], row[1], row[2], row[3]
        image = decode_base64_image(image_b64)
        box = np.asarray([[float(v) for v in region.strip().split(",")]], np.float32)
        patch, boxes_norm, w_ratio, h_ratio = positioning_resize(
            image, box, self.patch_image_size, self.max_image_size,
            self.imagenet_stats, as_uint8=self.transport_uint8,
        )
        quant = np.round(boxes_norm[0] * (self.num_bins - 1)).astype(int)
        region_tokens = " ".join(f"<bin_{int(v)}>" for v in quant)
        src_caption = pre_caption(text, self.max_src_length)
        src = self.wrap_src(self.enc(self.prompt().format(src_caption)))
        tgt = self.enc(region_tokens, use_bpe=False)
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True,
            extras={
                "w_resize_ratio": w_ratio,
                "h_resize_ratio": h_ratio,
                "region_coord": box[0],
            },
        )


def parse_ref_dict(ref: str) -> Dict[str, float]:
    """'conf|!+ans&&…' → {ans: conf} (ref: vqa_gen_dataset.py:143)."""
    return {item.split("|!+")[1]: float(item.split("|!+")[0]) for item in ref.split("&&")}


class VqaBuilder(BuilderBase):
    """ref: data/mm_data/vqa_gen_dataset.py:96-199."""

    task = "vqa_gen"

    def __init__(
        self, *a,
        prompt_type: str = "prev_output",
        trie=None,  # DenseTrie for per-position constraint masks
        max_object_length: int = 30,
        add_object: bool = False,
        **kw,
    ):
        super().__init__(*a, **kw)
        self.prompt_type = prompt_type
        self.trie = trie
        self.add_object = add_object
        self.max_object_length = max_object_length

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, question, ref = row[0], row[1], row[2], row[3]
        predict_objects = row[4] if len(row) > 4 else None
        patch = patch_resize(
            decode_base64_image(image_b64), self.patch_image_size,
            self.imagenet_stats, as_uint8=self.transport_uint8,
        )
        question = pre_question(question, self.max_src_length)
        question = question + "?" if not question.endswith("?") else question
        src = self.enc(self.prompt().format(question))
        ref_dict = parse_ref_dict(ref)
        answer = max(ref_dict, key=ref_dict.get)
        conf = ref_dict[answer]
        tgt = self.enc(f" {answer}")
        if self.add_object and predict_objects:
            objs = " ".join(predict_objects.strip().split("&&")[: self.max_object_length])
            src = np.concatenate([src, self.enc(f" object: {objs}")])
        src = self.wrap_src(src)

        prev, target = self._decoder_io(src, tgt)
        cm = self._constraint_mask(target, tgt) if self.trie is not None else None
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True, conf=conf, constraint_mask=cm,
            extras={"ref_dict": ref_dict},
        )

    def _decoder_io(self, src, tgt):
        """prompt_type none/src/prev_output (ref: vqa_gen_dataset.py:154-173)."""
        v = self.vocab
        if self.prompt_type == "none":
            prev = np.concatenate([[v.bos], tgt])
        elif self.prompt_type == "src":
            prev = np.concatenate([src, tgt])
        elif self.prompt_type == "prev_output":
            prev = np.concatenate([src[:-1], tgt])
        else:
            raise NotImplementedError(self.prompt_type)
        target = np.concatenate([prev[1:], [v.eos]]).astype(np.int32)
        target[: -len(tgt) - 1] = v.pad  # only the answer span is supervised
        return prev.astype(np.int32), target

    def _constraint_mask(self, target, tgt):
        """Per-position allowed-vocab mask over the answer span
        (ref: vqa_gen_dataset.py:183-190), walked on the HOST via the
        trie's numpy tables — per-example device dispatches here were the
        dominant cost of the input pipeline (~50 ms/example profiled)."""
        T = len(target)
        cm = np.zeros((T, self.vocab.padded_size), bool)
        start = T - len(tgt) - 1
        node = 0
        for i in range(start, T):
            cm[i] = self.trie.allowed_mask_np(node)
            if i < T - 1:
                node = self.trie.transition_np(node, int(target[i]))
        return cm


class SnliVeBuilder(BuilderBase):
    """ref: data/mm_data/snli_ve_dataset.py:148-257."""

    task = "snli_ve"
    LABEL_MAP = {"contradiction": "no", "entailment": "yes", "neutral": "maybe"}

    def __init__(self, *a, prompt_type: str = "prev_output", trie=None, add_caption: bool = True, **kw):
        super().__init__(*a, **kw)
        self.prompt_type = prompt_type
        self.trie = trie
        self.add_caption = add_caption

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, hypothesis, caption, label = (
            row[0], row[1], row[2], row[3], row[4],
        )
        label = self.LABEL_MAP[label]
        patch = patch_resize(
            decode_base64_image(image_b64), self.patch_image_size,
            self.imagenet_stats, as_uint8=self.transport_uint8,
        )
        hypothesis = pre_caption(hypothesis, self.max_src_length)
        caption = pre_caption(caption, self.max_src_length)
        src = self.enc(self.prompt().format(caption, hypothesis))
        src = self.wrap_src(src)
        tgt = self.enc(f" {label}")
        prev, target = VqaBuilder._decoder_io(self, src, tgt)
        cm = (
            VqaBuilder._constraint_mask(self, target, tgt)
            if self.trie is not None
            else None
        )
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True, constraint_mask=cm,
            extras={"ref_dict": {label: 1.0}},
        )


class ImageClassifyBuilder(BuilderBase):
    """ref: data/cv_data/image_classify_dataset.py — 480² bicubic resize at
    eval; the train split runs the reference's timm pipeline
    (image_classify_dataset.py:68-90): RandomResizedCrop → hflip →
    ColorJitter(0.4) → RandAugment(2, 7, OFA op list) → normalize →
    RandomErasing(p=0.25, 'pixel'), drawn from Python's ``random`` and numpy
    as the JAX package draws them (``data/augment.py``)."""

    task = "image_classify"

    def __init__(self, *a, trie=None, prompt_type: str = "prev_output",
                 seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self.trie = trie
        self.prompt_type = prompt_type
        import random as _random

        self._aug_rng = _random.Random(seed)
        from .augment import OFA_RANDAUG_OPS, RandAugment

        self._randaug = RandAugment(2, 7, ops=OFA_RANDAUG_OPS)
        # uint8_safe stays True: _train_patch clamps the erasing noise to the
        # pixel gamut, so the uint8 transport represents the patch to half a
        # pixel step

    def _train_patch(self, image) -> np.ndarray:
        from PIL import Image as PILImage

        from .augment import color_jitter, random_erasing, random_resized_crop
        from .transforms import normalize

        rng = self._aug_rng
        img = random_resized_crop(image.convert("RGB"), self.patch_image_size, rng=rng)
        if rng.random() < 0.5:
            img = img.transpose(PILImage.FLIP_LEFT_RIGHT)
        img = color_jitter(img, 0.4, rng=rng)
        img = self._randaug(img)
        arr = normalize(np.asarray(img, np.float32) / 255.0, self.imagenet_stats)
        arr = random_erasing(arr, 0.25, rng=rng)
        # the erasing noise clamped to the pixel gamut (the JAX package's
        # deviation from timm, kept: ref image_classify_dataset.py:68-90)
        lo = normalize(np.zeros((3,), np.float32), self.imagenet_stats)
        hi = normalize(np.ones((3,), np.float32), self.imagenet_stats)
        return np.clip(arr, lo, hi)

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, image_b64, label = row[0], row[1], row[2]
        image = decode_base64_image(image_b64)
        if self.split == "train":
            patch = self._train_patch(image)
        else:
            patch = patch_resize(image, self.patch_image_size, self.imagenet_stats)
        src = self.wrap_src(self.enc(self.prompt()))
        tgt = self.enc(f" {label}")
        prev, target = VqaBuilder._decoder_io(self, src, tgt)
        cm = (
            VqaBuilder._constraint_mask(self, target, tgt)
            if self.trie is not None
            else None
        )
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            patch_image=patch, patch_mask=True, constraint_mask=cm,
            extras={"label": label},
        )


class GigawordBuilder(BuilderBase):
    """ref: data/nlg_data/summary_dataset.py:130-176 (text-only)."""

    task = "gigaword"

    def __init__(self, *a, noise_ratio: float = 0.0, seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self.noise_ratio = noise_ratio
        self.rng = np.random.RandomState(seed)

    def __call__(self, row: Sequence[str]) -> Example:
        source, target_text = row[0], row[1]
        source = source.strip().lower()
        target_text = target_text.strip().lower()
        src = self.wrap_src(
            self.enc(self.prompt().format(source), length=self.max_src_length)
        )
        tgt = self.enc(f" {target_text}", length=self.max_tgt_length)
        target, prev = self.seq2seq_targets(tgt)
        if self.noise_ratio > 0 and self.split == "train" and len(tgt) > 0:
            # decoder-input noising: random token swap (ref :163-168)
            noise = self.rng.rand(len(tgt)) < self.noise_ratio
            rand_tok = self.rng.randint(4, self.vocab.vocab_size, len(tgt))
            noised = np.where(noise, rand_tok, tgt).astype(np.int32)
            prev = np.concatenate([[self.vocab.bos], noised]).astype(np.int32)
        return Example(
            id=row[0][:32], src_ids=src, target_ids=target, prev_ids=prev,
            extras={"target_text": target_text},
        )


class ImageGenBuilder(BuilderBase):
    """ref: data/mm_data/image_gen_dataset.py:120-185. Row: uniq_id, caption,
    VQGAN code ids; the target is the codes shifted into the ``<code_k>``
    band, and ``code_mask`` puts the decoder on image positions.
    ``code_image_size`` is accepted and unused, as in the JAX builder."""

    task = "image_gen"

    def __init__(self, *a, code_image_size: int = 256, **kw):
        super().__init__(*a, **kw)

    def __call__(self, row: Sequence[str]) -> Example:
        uniq_id, text, code = row[0], row[1], row[2]
        caption = pre_caption(text, self.max_src_length)
        src = self.wrap_src(self.enc(self.prompt().format(caption)))
        codes = np.asarray([int(c) for c in code.strip().split()], np.int64)
        tgt = (codes + self.vocab.code_start).astype(np.int32)  # (ref :137-140)
        target, prev = self.seq2seq_targets(tgt)
        return Example(
            id=uniq_id, src_ids=src, target_ids=target, prev_ids=prev,
            code_mask=True, extras={"caption": caption},
        )


class GlueBuilder(BuilderBase):
    """GLUE NLU tasks (ref: data/nlu_data/*_dataset.py). Single- or
    pair-sentence prompts with yes/no(/maybe) targets + trie masks."""

    # per-task: (columns, prompt template, label map)
    # templates/labels verbatim from ref: data/nlu_data/*_dataset.py:85-110
    TASK_DEFS = {
        "cola": (1, ' is the text " {} " grammatically correct?', {"0": "no", "1": "yes"}),
        "sst2": (1, ' is the sentiment of text " {} " positive or negative?', {"0": "negative", "1": "positive"}),
        "mrpc": (2, ' does text1 " {} " and text2 " {} " have the same semantics?', {"0": "no", "1": "yes"}),
        "qqp": (2, ' is question " {} " and question " {} " equivalent?', {"0": "no", "1": "yes"}),
        "qnli": (2, ' does " {} " contain the answer to question " {} "?', {"0": "no", "1": "yes", "not_entailment": "no", "entailment": "yes"}),
        "rte": (2, ' can text1 " {} " imply text2 " {} "?', {"not_entailment": "no", "entailment": "yes"}),
        "mnli": (2, ' can text1 " {} " imply text2 " {} "?', {"0": "maybe", "1": "yes", "2": "no", "contradiction": "no", "entailment": "yes", "neutral": "maybe"}),
    }

    def __init__(self, glue_task: str, *a, trie=None, prompt_type: str = "prev_output", **kw):
        super().__init__(*a, **kw)
        assert glue_task in self.TASK_DEFS, glue_task
        self.task = glue_task
        self.glue_task = glue_task
        self.trie = trie
        self.prompt_type = prompt_type

    def prompt(self) -> str:  # GLUE tasks use their own templates
        return self.TASK_DEFS[self.glue_task][1]

    def __call__(self, row: Sequence[str]) -> Example:
        n_text, template, label_map = self.TASK_DEFS[self.glue_task]
        texts = [pre_question(t, self.max_src_length) for t in row[:n_text]]
        label = label_map[row[n_text].strip()]
        src = self.wrap_src(self.enc(template.format(*texts)))
        tgt = self.enc(f" {label}")
        prev, target = VqaBuilder._decoder_io(self, src, tgt)
        cm = (
            VqaBuilder._constraint_mask(self, target, tgt)
            if self.trie is not None
            else None
        )
        return Example(
            id="-".join(texts)[:24], src_ids=src, target_ids=target, prev_ids=prev,
            constraint_mask=cm, extras={"label": label},
        )


# ---------------------------------------------------------------------------
# collation
# ---------------------------------------------------------------------------

def _pad_to(arr: np.ndarray, length: int, value: int) -> np.ndarray:
    out = np.full((length,), value, arr.dtype)
    out[: len(arr)] = arr[:length]
    return out


def collate(
    examples: List[Example],
    pad_id: int = 1,
    src_len: Optional[int] = None,
    tgt_len: Optional[int] = None,
    pad_multiple: int = 8,
) -> Dict[str, Any]:
    """Examples → fixed-shape numpy batch dict (TaskBatch-compatible keys).

    Lengths are padded to `pad_multiple` buckets to bound the number of
    compiled shapes (SURVEY.md §7: multi-task step without recompilation).
    """

    def bucket(n):
        return -(-n // pad_multiple) * pad_multiple

    S = src_len or bucket(max(len(e.src_ids) for e in examples))
    has_tgt = examples[0].target_ids is not None
    T = (
        tgt_len
        or (bucket(max(len(e.target_ids) for e in examples)) if has_tgt else 0)
    )

    batch: Dict[str, Any] = {
        "id": [e.id for e in examples],
        "src_tokens": np.stack([_pad_to(e.src_ids, S, pad_id) for e in examples]),
        "nsentences": len(examples),
    }
    if examples[0].patch_image is not None:
        batch["patch_images"] = np.stack([e.patch_image for e in examples])
        batch["patch_masks"] = np.asarray([e.patch_mask for e in examples])
    if has_tgt:
        batch["target"] = np.stack(
            [_pad_to(e.target_ids, T, pad_id) for e in examples]
        )
        batch["prev_output_tokens"] = np.stack(
            [_pad_to(e.prev_ids, T, pad_id) for e in examples]
        )
        batch["ntokens"] = int(sum((e.target_ids != pad_id).sum() for e in examples))
    if examples[0].constraint_mask is not None:
        V = examples[0].constraint_mask.shape[-1]
        cms = np.zeros((len(examples), T, V), bool)
        for i, e in enumerate(examples):
            cms[i, : len(e.constraint_mask)] = e.constraint_mask[:T]
        batch["constraint_masks"] = cms
    if any(e.conf != 1.0 for e in examples):
        batch["conf"] = np.asarray([e.conf for e in examples], np.float32)
    if examples[0].code_mask:
        batch["code_masks"] = np.asarray([e.code_mask for e in examples])
    batch["extras"] = [e.extras for e in examples]
    return batch
