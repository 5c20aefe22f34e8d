"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

At first use every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc``
per source, all running at once) and linked into one shared library with a
plain C interface, under ``csrc/build/<hash of the sources and flags>/``
(listed in ``.gitignore``), and loaded with ``ctypes``; ptxas's report of
each kernel's registers, shared memory and spills is kept beside it in
``ptxas.log`` (``ptxas_log``). Each C entry
point launches on the stream it is given and returns ``cudaGetLastError()``;
``check`` raises on a non-zero code. A CUDA machine without ``nvcc`` is an
error: the wrappers never fall back to their plain versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libmusketeer_tpu_torch_kernels.so"
PTXAS_LOG = "ptxas.log"

# ctypes argument kinds: every pointer and the stream are c_void_p
PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_int64
FLOAT = ctypes.c_float


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cu*"))


def _run_all(cmds) -> list:
    """Run the commands at once; raise with every failure's stderr after all
    end, else return each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    failed = [f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{err}"
              for cmd, p, err in zip(cmds, procs, errs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def _build_dir() -> Path:
    _, hashed = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in hashed:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def ptxas_log() -> Path:
    """ptxas's report of the built library (registers, shared memory, spills)."""
    return _build_dir() / PTXAS_LOG


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    cu, _ = _sources()
    out_dir = _build_dir()
    so = out_dir / LIB_NAME
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = find_nvcc(), os.getpid()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in cu]
        errs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(cu, objs)])
        (out_dir / PTXAS_LOG).write_text(
            "".join(f"== {src.name}\n{err}" for src, err in zip(cu, errs)))
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(so))
    lib.mk_cuda_error_string.argtypes = [INT]
    lib.mk_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def kernel_function(name: str, argtypes: tuple):
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().mk_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# The instances of the attention kernels (K1, K3, K4, K5, K6, K7), on either
# core (csrc/common.cuh::with_head_dim): tile widths of 32, 64, 80, 128, 192
# and 256 columns, and past ``MAX_INSTANCE`` the deep route. A head dim D of 1
# to ``MAX_INSTANCE`` runs on the smallest instance that covers it
# (``head_instance``), its tiles' columns past D zeros; any D past it runs on
# the deep route (``DEEP``): D streams through the products in chunks of
# ``DEEP_CHUNK`` columns (``deep_chunks``; the last zero-filled past D) and
# each output's columns split into blocks of ``DEEP_CHUNK`` (up to three a CTA
# in the bf16 K1/K3/K4/K5 kernels), so that a CTA's shared memory and
# registers do not grow with D (the wrappers count those launches in
# ``.deep``). Past ``WIDE_HEAD_DIM`` up to ``MAX_INSTANCE`` (the instances 192
# and 256) the bf16 K1/K3/K4/K5 kernels run on the pair route: the deep
# route's CTA with both column blocks of 128 in one CTA, so that each score
# tile is built once for the whole output (the wrappers count those launches
# in ``.pair``); K6 and K7 there take shallower rings (``.wide``). The
# wrappers hand the kernels a D that is a multiple of 8 (K6's int8 cache: of
# 16), copying any other into a zero-padded buffer first (``pad_head``). The
# plain versions take any head dim.
HEAD_DIMS = (32, 64, 80, 128, 192, 256)
MAX_INSTANCE = HEAD_DIMS[-1]
WIDE_HEAD_DIM = 128
DEEP = 0  # the deep route's instance tag (csrc/common.cuh::DEEP)
DEEP_CHUNK = 128  # its chunk width, and that of an output's column block


def check_head_dim(name: str, head_dim: int) -> None:
    """Raise NotImplementedError unless the kernels take ``head_dim``: any head
    dim from 1 upward. The CUDA route of each attention wrapper calls it
    before it checks its tensors' devices."""
    if head_dim < 1:
        raise NotImplementedError(f"{name}: head dim {head_dim}; the kernels take head dims "
                                  "from 1 upward")


def head_instance(head_dim: int, unit: int = 8) -> int:
    """The instance (tile width) a head dim runs on: the smallest of
    ``HEAD_DIMS`` that covers ``head_dim`` rounded up to ``unit``, or ``DEEP``
    past ``MAX_INSTANCE``."""
    return next((n for n in HEAD_DIMS if n >= -(-head_dim // unit) * unit), DEEP)


def deep_chunks(head_dim: int) -> int:
    """The chunks of ``DEEP_CHUNK`` columns the deep route takes a head dim in
    (csrc/common.cuh::deep_chunks), the last zero-filled past it."""
    return -(-head_dim // DEEP_CHUNK)


def col_halves(head_dim: int) -> int:
    """The column blocks of 128 that the tensor-core attention core (K1, K3,
    K5) and K4 split a head dim's outputs into: 1 up to ``WIDE_HEAD_DIM``,
    else ``deep_chunks`` (2 on the pair route up to ``MAX_INSTANCE``, one CTA
    owning both; past it the bf16 kernels of the deep route group up to three
    in a CTA, ``flash_attention_infer.deep_groups``, and the fp32 ones,
    csrc/flash_deep.cuh, take one a CTA)."""
    return 1 if head_dim <= WIDE_HEAD_DIM else deep_chunks(head_dim)


def pair_route(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether a call of K1, K3, K4 or K5 at ``head_dim`` runs on the pair
    route: bf16 at head dims past ``WIDE_HEAD_DIM`` up to ``MAX_INSTANCE``
    (the instances 192 and 256)."""
    return dtype == torch.bfloat16 and head_instance(head_dim) > WIDE_HEAD_DIM


def pad_head(t: torch.Tensor, unit: int = 8) -> torch.Tensor:
    """``t`` itself where its last dimension is a multiple of ``unit``, else a
    copy zero-padded to the next multiple: rows of whole 16-byte units for
    the TMA copies and vector loads (bf16: 8 elements; the int8 cache: 16).
    The zeros add nothing to any product over the head dim."""
    D = t.shape[-1]
    if D % unit == 0:
        return t
    out = t.new_zeros((*t.shape[:-1], -(-D // unit) * unit))
    out[..., :D] = t
    return out


# the row tiles (wgmma N) of the weight-streaming tensor-core core
# (csrc/skinny_gemm_sm90.cuh): rows are padded to the smallest that covers
# them; more rows than the last loop over row tiles
ROW_TILES = (16, 32, 48, 80)
SMEM_MAX = 232448  # a block's shared memory on sm_90


def route(name: str, device: torch.device, dtype: torch.dtype, tensors: dict) -> str:
    """Which version a kernel wrapper runs: ``"plain"`` (the PyTorch version) for
    CPU tensors; on CUDA, ``"fma"`` (the fp32 kernels on the CUDA cores) for
    fp32 and ``"sm90"`` (the tensor-core kernels, fed by TMA) for bf16. On
    that route ``tensors`` (bf16, or an int8 weight or cache) must start on
    16-byte boundaries with rows (last dimension) of a multiple of 16 bytes,
    as TMA and the 16-byte loads need; anything else raises: no route falls
    back to another."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {dtype} not in (torch.float32, torch.bfloat16)")
    for arg, t in tensors.items():
        if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary and have rows of "
                             f"a multiple of 16 bytes (the bf16 tensor-core route's TMA copies)")
    return "sm90"


def row_tile(rows: int) -> int:
    """The smallest row tile of ``ROW_TILES`` that covers ``rows`` (else the largest)."""
    return next((n for n in ROW_TILES if rows <= n), ROW_TILES[-1])


def sm_count(device: torch.device) -> int:
    """The card's SM count (the split and grid plans of the tensor-core products)."""
    return _sm_count(torch.device(device).index or 0)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def require_cuda(name: str, tensors: dict, dtypes) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one allowed dtype."""
    first = next(iter(tensors.values()))
    if first.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {first.dtype} not in {dtypes}")
    for arg, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
