"""Host-side image preprocessing (PIL + numpy), box-aware (port of
``musketeer_tpu/data/transforms.py``).

Produces normalized NHWC float32 arrays, or raw uint8 pixels with the affine
that normalizes them (``norm_constants``) for the joint loader's uint8
transport, as the JAX package does:

- square bicubic resize + mean/std 0.5 normalize (ref: caption_dataset.py:69-74),
- the "positioning transform" for grounding tasks: resize to
  (patch_size, patch_size) with per-axis ratios, boxes scaled by the ratios
  then divided by ``max_image_size`` (ref: refcoco_dataset.py:69-73;
  utils/transforms.py:100-134, 227-251).

PIL is imported inside the functions that decode or resize an image, so the
tasks import on a machine without it.
"""

from __future__ import annotations

import base64
import io
from typing import Tuple

import numpy as np

MEAN = np.asarray([0.5, 0.5, 0.5], np.float32)
STD = np.asarray([0.5, 0.5, 0.5], np.float32)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def decode_base64_image(b64: str):
    """urlsafe base64 → ``PIL.Image.Image``."""
    from PIL import Image

    return Image.open(io.BytesIO(base64.urlsafe_b64decode(b64)))


def normalize(arr: np.ndarray, imagenet_stats: bool = False) -> np.ndarray:
    mean, std = (IMAGENET_MEAN, IMAGENET_STD) if imagenet_stats else (MEAN, STD)
    return (arr - mean) / std


def norm_constants(imagenet_stats: bool = False) -> np.ndarray:
    """[2, 3] (scale row, bias row) such that for uint8 pixels p:
    p * scale + bias == normalize(p / 255) (up to fp rounding).

    The uint8 image transport: PIL's resize output is uint8, so raw bytes plus
    this affine carry what the normalized float32 carries at a quarter of the
    host→device bytes (``train_step.dequantize_batch`` applies it on the
    device)."""
    mean, std = (IMAGENET_MEAN, IMAGENET_STD) if imagenet_stats else (MEAN, STD)
    mean = np.broadcast_to(np.asarray(mean, np.float32), (3,))
    std = np.broadcast_to(np.asarray(std, np.float32), (3,))
    return np.stack([1.0 / (255.0 * std), -mean / std]).astype(np.float32)


def patch_resize(image, size: int, imagenet_stats: bool = False,
                 as_uint8: bool = False) -> np.ndarray:
    """Square bicubic resize → normalized NHWC float32 [size, size, 3], or raw
    uint8 pixels when ``as_uint8`` (pair with :func:`norm_constants`)."""
    from PIL import Image

    img = image.convert("RGB").resize((size, size), Image.BICUBIC)
    if as_uint8:
        return np.asarray(img, np.uint8)
    arr = np.asarray(img, np.float32) / 255.0
    return normalize(arr, imagenet_stats)


def positioning_resize(
    image,
    boxes: np.ndarray,  # [N, 4] x0 y0 x1 y1 in original pixels
    patch_size: int,
    max_image_size: int = 512,
    imagenet_stats: bool = False,
    as_uint8: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Grounding-task resize.

    Returns (patch [S,S,3], boxes_norm [N,4] in bin units ([0,1] of
    max_image_size), w_ratio, h_ratio). The reference's RandomResize with
    max_size==size always lands on exactly (S, S), so the per-axis ratios are
    S/w and S/h.
    """
    from PIL import Image

    image = image.convert("RGB")
    w, h = image.size
    img = image.resize((patch_size, patch_size), Image.BICUBIC)
    arr = (
        np.asarray(img, np.uint8)
        if as_uint8
        else normalize(np.asarray(img, np.float32) / 255.0, imagenet_stats)
    )
    w_ratio = patch_size / w
    h_ratio = patch_size / h
    scaled = boxes.astype(np.float32) * np.asarray(
        [w_ratio, h_ratio, w_ratio, h_ratio], np.float32
    )
    boxes_norm = scaled / max_image_size
    return arr, boxes_norm, w_ratio, h_ratio


def center_crop(image, size: int):
    """The central ``size × size`` square of a ``PIL.Image.Image``."""
    w, h = image.size
    left = (w - size) // 2
    top = (h - size) // 2
    return image.crop((left, top, left + size, top + size))
