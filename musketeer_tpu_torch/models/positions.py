"""Relative-position bucket tables, restated from ``musketeer_tpu.models.positions``.

Numpy, computed once per shape and cached. The port keeps its own copy so
that it runs where the JAX package is absent;
``tests/test_torch_port_boundary.py`` holds every table equal to the JAX
package's, element for element.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def make_token_bucket_position(bucket_size: int, max_position: int = 1024) -> np.ndarray:
    """[max_position, max_position] int32 bucket ids for 1D text rel-pos."""
    context_pos = np.arange(max_position, dtype=np.int64)[:, None]
    memory_pos = np.arange(max_position, dtype=np.int64)[None, :]
    relative_pos = context_pos - memory_pos
    sign = np.sign(relative_pos)
    mid = bucket_size // 2
    abs_pos = np.where(
        (relative_pos < mid) & (relative_pos > -mid), mid - 1, np.abs(relative_pos)
    )
    log_pos = (
        np.ceil(
            np.log(abs_pos / mid) / math.log((max_position - 1) / mid) * (mid - 1)
        )
        + mid
    )
    log_pos = log_pos.astype(np.int64)
    bucket_pos = np.where(abs_pos <= mid, relative_pos, log_pos * sign)
    return (bucket_pos + bucket_size - 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def make_image_bucket_position(bucket_size: int, num_relative_distance: int) -> np.ndarray:
    """[bucket²+1, bucket²+1] int32 bucket ids for 2D image rel-pos (slot 0 = cls)."""
    coords = np.stack(
        np.meshgrid(np.arange(bucket_size), np.arange(bucket_size), indexing="ij")
    ).reshape(2, -1)
    relative = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    relative[:, :, 0] += bucket_size - 1
    relative[:, :, 1] += bucket_size - 1
    relative[:, :, 0] *= 2 * bucket_size - 1
    n = bucket_size * bucket_size + 1
    table = np.zeros((n, n), dtype=np.int64)
    table[1:, 1:] = relative.sum(-1)
    table[0, 0:] = num_relative_distance - 3
    table[0:, 0] = num_relative_distance - 2
    table[0, 0] = num_relative_distance - 1
    return table.astype(np.int32)


def encoder_image_position_ids(h: int, w: int, image_bucket_size: int) -> np.ndarray:
    """[h*w] ids into ``embed_image_positions`` for an h×w patch grid (0 = cls)."""
    idx = (
        np.arange(w, dtype=np.int32)[None, :]
        + np.arange(h, dtype=np.int32)[:, None] * image_bucket_size
        + 1
    )
    return idx.reshape(-1)


def decoder_image_position_idx(code_image_size: int, image_bucket_size: int,
                               max_target_positions: int = 1024) -> np.ndarray:
    """Decoder target-side image position ids: [0] (bos), the window² grid ids,
    then id 1024 out to 1026 entries (ref: unify_transformer.py:1211-1216)."""
    window = code_image_size // 8
    grid = (
        np.arange(window, dtype=np.int64)[None, :].repeat(window, 0)
        + np.arange(window, dtype=np.int64)[:, None] * image_bucket_size
        + 1
    )
    return np.concatenate([[0], grid.reshape(-1), [1024] * 769]).astype(np.int32)
