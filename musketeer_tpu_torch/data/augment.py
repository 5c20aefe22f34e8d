"""Train-time image augmentation: RandAugment + box-aware geometric ops (a
copy of ``musketeer_tpu/data/augment.py``: its draws use Python's ``random``
and numpy, so the same seeds give the same pixels in both packages).

Host-side PIL/numpy counterparts of the reference's augmentation stacks:
RandAugment op zoo (ref: utils/vision_helper.py:10-338, used by
image_classify_dataset.py:85-90) and the box-propagating flip/crop/jitter
transforms (ref: utils/transforms.py:15-262, LargeScaleJitter :271-384).
Standard published algorithms, implemented fresh.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps


# ---------------------------------------------------------------------------
# RandAugment
# ---------------------------------------------------------------------------

def _autocontrast(img, _):
    return ImageOps.autocontrast(img)


def _equalize(img, _):
    return ImageOps.equalize(img)


def _invert(img, _):
    return ImageOps.invert(img)


def _rotate(img, m):
    return img.rotate((m / 30) * 30 * random.choice([-1, 1]))


def _posterize(img, m):
    return ImageOps.posterize(img, max(1, int(8 - (m / 30) * 4)))


def _solarize(img, m):
    return ImageOps.solarize(img, int(256 - (m / 30) * 256))


def _color(img, m):
    return ImageEnhance.Color(img).enhance(1 + (m / 30) * random.choice([-1, 1]) * 0.9)


def _contrast(img, m):
    return ImageEnhance.Contrast(img).enhance(1 + (m / 30) * random.choice([-1, 1]) * 0.9)


def _brightness(img, m):
    return ImageEnhance.Brightness(img).enhance(1 + (m / 30) * random.choice([-1, 1]) * 0.9)


def _sharpness(img, m):
    return ImageEnhance.Sharpness(img).enhance(1 + (m / 30) * random.choice([-1, 1]) * 0.9)


def _shear_x(img, m):
    v = (m / 30) * 0.3 * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, m):
    v = (m / 30) * 0.3 * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x(img, m):
    v = (m / 30) * 0.45 * img.size[0] * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0))


def _translate_y(img, m):
    v = (m / 30) * 0.45 * img.size[1] * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v))


def _identity(img, _):
    return img


RANDAUG_OPS = [
    _autocontrast, _equalize, _invert, _rotate, _posterize, _solarize,
    _color, _contrast, _brightness, _sharpness,
    _shear_x, _shear_y, _translate_x, _translate_y,
]

# the exact op list the reference's train stacks request (RandomAugment(2, 7,
# augs=['Identity', 'AutoContrast', 'Equalize', 'Brightness', 'Sharpness',
# 'ShearX', 'ShearY', 'TranslateX', 'TranslateY', 'Rotate']) — ref:
# data/cv_data/image_classify_dataset.py:85-90, unify_dataset.py:208-211)
OFA_RANDAUG_OPS = [
    _identity, _autocontrast, _equalize, _brightness, _sharpness,
    _shear_x, _shear_y, _translate_x, _translate_y, _rotate,
]


class RandAugment:
    """n random ops at magnitude m (Cubuk et al.; ref vision_helper zoo)."""

    def __init__(
        self, n: int = 2, m: int = 9, seed: Optional[int] = None,
        ops: Optional[List] = None,
    ):
        self.n = n
        self.m = m
        self.ops = ops if ops is not None else RANDAUG_OPS
        if seed is not None:
            random.seed(seed)

    def __call__(self, img: Image.Image) -> Image.Image:
        for op in random.sample(self.ops, self.n):
            img = op(img, self.m)
        return img


def random_resized_crop(
    img: Image.Image,
    size: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    rng: Optional[random.Random] = None,
) -> Image.Image:
    """torchvision/timm RandomResizedCrop: random area+aspect window →
    bicubic resize to (size, size). Used by the reference's ImageNet train
    transform (timm create_transform, image_classify_dataset.py:68-79)."""
    rng = rng or random
    w, h = img.size
    area = w * h
    import math

    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(log_r)
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            box = (left, top, left + cw, top + ch)
            return img.resize((size, size), Image.BICUBIC, box=box)
    # fallback: center crop of the constrained aspect
    s = min(w, h)
    left, top = (w - s) // 2, (h - s) // 2
    return img.resize((size, size), Image.BICUBIC, box=(left, top, left + s, top + s))


def color_jitter(
    img: Image.Image, strength: float = 0.4,
    rng: Optional[random.Random] = None,
) -> Image.Image:
    """Brightness/contrast/saturation jitter, each factor uniform in
    [1-s, 1+s] (torchvision ColorJitter(0.4), the reference's timm
    color_jitter=0.4)."""
    rng = rng or random
    enh = [ImageEnhance.Brightness, ImageEnhance.Contrast, ImageEnhance.Color]
    order = list(range(3))
    rng.shuffle(order)
    for i in order:
        f = rng.uniform(max(0.0, 1 - strength), 1 + strength)
        img = enh[i](img).enhance(f)
    return img


def random_erasing(
    arr: np.ndarray,  # [H, W, 3] float (already normalized)
    p: float = 0.25,
    scale: Tuple[float, float] = (0.02, 1 / 3),
    ratio: Tuple[float, float] = (0.3, 3.3),
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """timm RandomErasing mode='pixel': with prob p replace a random patch
    with unit-gaussian pixels (ref timm re_prob=0.25, re_mode='pixel',
    image_classify_dataset.py:74-76)."""
    rng = rng or random
    if rng.random() >= p:
        return arr
    import math

    H, W = arr.shape[:2]
    area = H * W
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(log_r)
        eh = int(round(math.sqrt(target / ar)))
        ew = int(round(math.sqrt(target * ar)))
        if 0 < eh < H and 0 < ew < W:
            top = rng.randint(0, H - eh)
            left = rng.randint(0, W - ew)
            out = arr.copy()
            np_rng = np.random.RandomState(rng.randint(0, 2**31 - 1))
            out[top : top + eh, left : left + ew] = np_rng.randn(
                eh, ew, arr.shape[2]
            ).astype(arr.dtype)
            return out
    return arr


# ---------------------------------------------------------------------------
# box-aware geometric ops (boxes: [N, 4] x0 y0 x1 y1 pixels)
# ---------------------------------------------------------------------------

def horizontal_flip(
    img: Image.Image, boxes: Optional[np.ndarray] = None
) -> Tuple[Image.Image, Optional[np.ndarray]]:
    img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if boxes is not None and len(boxes):
        w = img.size[0]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def random_crop(
    img: Image.Image, boxes: Optional[np.ndarray], out_w: int, out_h: int,
    rng: Optional[random.Random] = None,
) -> Tuple[Image.Image, Optional[np.ndarray]]:
    rng = rng or random
    w, h = img.size
    out_w, out_h = min(out_w, w), min(out_h, h)
    left = rng.randint(0, w - out_w) if w > out_w else 0
    top = rng.randint(0, h - out_h) if h > out_h else 0
    img = img.crop((left, top, left + out_w, top + out_h))
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] - left, 0, out_w)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] - top, 0, out_h)
    return img, boxes


def resize_shortest_side(
    img: Image.Image,
    boxes: Optional[np.ndarray],
    size: int,
    max_size: Optional[int] = None,
) -> Tuple[Image.Image, Optional[np.ndarray]]:
    """Shortest-side resize with aspect ratio, each dim capped at max_size
    (ref: utils/transforms.py:95-140 get_size_with_aspect_ratio — the cap
    clamps dims independently, intentionally allowing mild distortion)."""
    w, h = img.size
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    if max_size is not None:
        ow, oh = min(ow, max_size), min(oh, max_size)
    out = img.resize((ow, oh), Image.BICUBIC)
    if boxes is not None and len(boxes):
        boxes = boxes * np.asarray(
            [ow / w, oh / h, ow / w, oh / h], np.float32
        )
    return out, boxes


def object_center_crop(
    img: Image.Image,
    boxes: np.ndarray,  # [N, 4]; window centered on boxes[0]
    out_w: int,
    out_h: int,
) -> Tuple[Image.Image, np.ndarray]:
    """Crop an (out_w, out_h) window centered on the first box, shifted to
    stay inside the image (ref: utils/transforms.py:176-194 ObjectCenterCrop
    with delete=False). Boxes are offset and clipped to the window."""
    w, h = img.size
    cx = (float(boxes[0][0]) + float(boxes[0][2])) / 2
    cy = (float(boxes[0][1]) + float(boxes[0][3])) / 2
    left = max(cx - out_w / 2 + min(w - cx - out_w / 2, 0), 0)
    top = max(cy - out_h / 2 + min(h - cy - out_h / 2, 0), 0)
    left, top = int(left), int(top)
    img = img.crop((left, top, left + out_w, top + out_h))
    boxes = boxes.copy()
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] - left, 0, out_w)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] - top, 0, out_h)
    return img, boxes


def large_scale_jitter(
    img: Image.Image,
    boxes: Optional[np.ndarray],
    out_size: int,
    scale_range: Tuple[float, float] = (0.1, 2.0),
    rng: Optional[random.Random] = None,
) -> Tuple[Image.Image, Optional[np.ndarray]]:
    """Random global rescale then crop/pad to out_size (ref: transforms.py
    LargeScaleJitter :271-384)."""
    rng = rng or random
    w, h = img.size
    scale = rng.uniform(*scale_range) * out_size / max(w, h)
    nw, nh = max(1, int(round(w * scale))), max(1, int(round(h * scale)))
    img = img.resize((nw, nh), Image.BICUBIC)
    if boxes is not None and len(boxes):
        boxes = boxes * np.asarray([nw / w, nh / h, nw / w, nh / h], np.float32)
    img, boxes = random_crop(img, boxes, out_size, out_size, rng)
    # pad to square if smaller
    if img.size != (out_size, out_size):
        canvas = Image.new("RGB", (out_size, out_size))
        canvas.paste(img, (0, 0))
        img = canvas
    return img, boxes
