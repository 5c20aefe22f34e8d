"""TSV dataset reader with per-host sharding and random row access (port of
``musketeer_tpu/data/file_dataset.py``).

A byte-offset index is built once (cached beside the file as
``<file>.idx.npy``) and rows are read by seeking to their offset; shard
``shard_id`` of ``num_shards`` holds rows ``shard_id::num_shards``.
``row_count`` stays mutable for equal-sampling truncation, as in the JAX
package. Where g++ exists, the index comes from the native reader's mmap
scan and ``get_batch`` reads a whole batch in one C call
(``musketeer_tpu_torch/native``); without it both fall back to the
row-by-row Python reader, which gives the same rows.
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
        self._native = None  # the NativeTsv of batched reads (False: unavailable)

    def _build_or_load_index(self, cached: bool) -> np.ndarray:
        idx_path = self.file_path + ".idx.npy"
        if cached and os.path.exists(idx_path) and os.path.getmtime(
            idx_path
        ) >= os.path.getmtime(self.file_path):
            return np.load(idx_path)
        arr = self._native_index()
        if arr is None:
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

    def _native_index(self) -> Optional[np.ndarray]:
        """The line offsets from the native mmap scan, or None without g++."""
        from ..native import NativeTsv, available

        if not available():
            return None
        nt = NativeTsv(self.file_path)
        try:
            return nt.offsets()
        finally:
            nt.close()

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
        if self._native:
            self._native.close()
            self._native = None

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
        """The rows at shard-local ``indices``, as ``__getitem__`` reads them:
        one native call for the batch, row by row without g++."""
        rows = self._shard_rows[np.asarray(indices, np.int64) % self.row_count]
        lines = self._native_rows(rows)
        if lines is None:
            return [self[int(i)] for i in indices]
        out = []
        for line in lines:
            cols = line.rstrip("\r\n").split(self.separator)
            if self.selected_col_ids is not None:
                cols = [cols[i] for i in self.selected_col_ids]
            out.append(cols)
        return out

    def _native_rows(self, rows: np.ndarray) -> Optional[List[str]]:
        if self._native is None:
            from ..native import NativeTsv, available

            self._native = NativeTsv(self.file_path) if available() else False
        return self._native.rows(rows) if self._native else None

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fh"] = None  # file handles don't pickle (dataloader workers)
        state["_native"] = None  # nor do native handles
        return state
