"""ctypes bindings for the native data-path library (``tsv_reader.cpp``; port
of ``musketeer_tpu/native``).

Compiled with g++ at first use into ``native/build/<hash of the source and
flags>/libtsv.so`` (listed in ``.gitignore``; nothing is written beside the
source). Without a toolchain ``available()`` is False and the callers keep
the pure-Python reader, which gives the same rows: this is host code, not a
device path.

``NativeTsv.batch_calls`` counts the batched row reads (one C call for a
whole batch) since it was last set to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "tsv_reader.cpp"
BUILD_ROOT = _DIR / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libtsv.so"


def _build() -> Optional[Path]:
    lib = _lib_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"libtsv.{os.getpid()}.so")  # concurrent builders rename atomically
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        return None
    return lib


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _build()
        if path is None:
            _failed = True
            return None
        lib = ctypes.CDLL(str(path))
        P64 = ctypes.POINTER(ctypes.c_int64)
        sigs = {
            "tsv_open": (ctypes.c_void_p, [ctypes.c_char_p]),
            "tsv_num_rows": (ctypes.c_int64, [ctypes.c_void_p]),
            "tsv_close": (None, [ctypes.c_void_p]),
            "tsv_rows_total_len": (ctypes.c_int64, [ctypes.c_void_p, P64, ctypes.c_int64]),
            "tsv_read_rows": (ctypes.c_int64, [ctypes.c_void_p, P64, ctypes.c_int64,
                                               ctypes.c_char_p, ctypes.c_int64, P64]),
            "tsv_copy_offsets": (ctypes.c_int64, [ctypes.c_void_p, P64, ctypes.c_int64]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


class NativeTsv:
    """mmap-indexed TSV file via the C++ library."""

    batch_calls = 0  # batched reads (``rows``) since the count was last set to 0

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native tsv library unavailable (no g++)")
        self._lib = lib
        self._h = lib.tsv_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.n_rows = lib.tsv_num_rows(self._h)

    def rows(self, indices) -> List[str]:
        """The rows at ``indices`` (file rows, not shard-local), read in one C
        call; each without its line ending."""
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        if n == 0:
            return []
        idx_p = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        total = self._lib.tsv_rows_total_len(self._h, idx_p, n)
        if total < 0:
            raise IndexError(f"bad row in batch: {idx}")
        buf = ctypes.create_string_buffer(max(int(total), 1))
        lens = np.empty(n, np.int64)
        got = self._lib.tsv_read_rows(self._h, idx_p, n, buf, total,
                                      lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if got < 0:
            raise IndexError(f"bad row in batch: {idx}")
        NativeTsv.batch_calls += 1
        raw = buf.raw
        out, o = [], 0
        for ln in lens:
            out.append(raw[o:o + ln].decode("utf-8"))
            o += int(ln)
        return out

    def offsets(self) -> np.ndarray:
        out = np.empty(self.n_rows, np.int64)
        self._lib.tsv_copy_offsets(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                   self.n_rows)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.tsv_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

