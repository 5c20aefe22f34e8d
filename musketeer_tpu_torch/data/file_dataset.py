"""TSV dataset reader with per-host sharding and random row access (port of
``musketeer_tpu/data/file_dataset.py``, its pure-Python reader).

A byte-offset index is built once (cached beside the file as
``<file>.idx.npy``) and rows are read by seeking to their offset; shard
``shard_id`` of ``num_shards`` holds rows ``shard_id::num_shards``.
``row_count`` stays mutable for equal-sampling truncation, as in the JAX
package. The JAX package's native (C++) reader is not ported: ``get_batch``
reads row by row.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


class FileDataset:
    def __init__(
        self,
        file_path: str,
        selected_col_ids: Optional[Sequence[int]] = None,
        dtypes=None,
        separator: str = "\t",
        cached_index: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        if not os.path.exists(file_path):
            raise FileNotFoundError(f"Error: The local datafile {file_path} not exists!")
        self.file_path = file_path
        self.separator = separator
        self.selected_col_ids = (
            list(selected_col_ids) if selected_col_ids is not None else None
        )
        self.shard_id = shard_id
        self.num_shards = num_shards

        self._offsets = self._build_or_load_index(cached_index)
        self.total_row_count = len(self._offsets)
        self._shard_rows = np.arange(shard_id, self.total_row_count, num_shards)
        self.row_count = len(self._shard_rows)  # mutable (eq-sampling truncation)
        self._fh = None

    def _build_or_load_index(self, cached: bool) -> np.ndarray:
        idx_path = self.file_path + ".idx.npy"
        if cached and os.path.exists(idx_path) and os.path.getmtime(
            idx_path
        ) >= os.path.getmtime(self.file_path):
            return np.load(idx_path)
        offsets: List[int] = []
        pos = 0
        with open(self.file_path, "rb") as f:
            for line in f:
                offsets.append(pos)
                pos += len(line)
        arr = np.asarray(offsets, np.int64)
        if cached:
            try:
                np.save(idx_path, arr)
            except OSError:
                pass  # read-only data dir; index rebuilt next time
        return arr

    def __len__(self) -> int:
        return self.row_count

    def _file(self):
        if self._fh is None:
            self._fh = open(self.file_path, "rb")
        return self._fh

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __getitem__(self, index: int) -> List[str]:
        row = self._shard_rows[index % self.row_count]
        f = self._file()
        f.seek(self._offsets[row])
        line = f.readline().decode("utf-8").rstrip("\n")
        cols = line.split(self.separator)
        if self.selected_col_ids is not None:
            cols = [cols[i] for i in self.selected_col_ids]
        return cols

    def get_batch(self, indices: Sequence[int]) -> List[List[str]]:
        """The rows at shard-local ``indices``, as ``__getitem__`` reads them."""
        return [self[int(i)] for i in indices]

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fh"] = None  # file handles don't pickle (dataloader workers)
        return state
