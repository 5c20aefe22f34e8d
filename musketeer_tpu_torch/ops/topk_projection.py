"""K2: the tied output projection fused with its softmax statistics.

Port of ``musketeer_tpu/ops/topk_projection.py::project_with_stats`` (Pallas
``_proj_kernel`` + ``_proj_body``). One pass over the ``[Vp, D]`` embedding
gives, for every row of ``features``:

- logits ``[N, Vp]`` in the features' dtype, columns ≥ ``vocab_size`` set to −1e9;
- the max of every 128-token block, ``bmax [N, Vp/128]`` fp32;
- the exact logsumexp ``Z [N]`` fp32, combined outside the kernel from the
  per-block max and sum of exponentials.

bmax and the sums come from the fp32 logits, before the cast; only the stored
logits are rounded. ``project_with_stats`` runs the plain PyTorch version for
CPU tensors and a CUDA kernel (``csrc/topk_projection.cu``) for CUDA tensors,
picked by dtype (``_build.route``): bf16 on the weight-streaming tensor-core
core (``csrc/skinny_gemm_sm90.cuh``: a persistent grid, h in shared memory,
W by TMA, wgmma), its launches also counted in
``project_with_stats.launches_sm90``; fp32 on the FMA kernel. Where no row
tile's h fits in shared memory (``proj_plan``), h's chunks stream beside each
W stage instead (``.streamed``; K2-q8: ``.streamed_q8``), with the sums over
D in the same order. Unaligned bf16
inputs raise; it never falls back from one version to another.

K2-q8 (``_proj_kernel_q8``) is the same function over the int8 serving
projection (``models/ofa.py::quantize_output_proj``): ``w`` int8 ``[Vp, D]``
with fp32 row scales ``w_scale [Vp]``. The logits are the fp32 dot of the
features with ``w`` (converted to the features' dtype, exact for |w| ≤ 127)
times the row scale, before the padding mask and the statistics. It routes
as K2 does: bf16 features on the same persistent tensor-core kernel
(``proj_q8_sm90_kernel``: int8 W stages by TMA, widened in registers into
wgmma's A operand, the row scales in the epilogue), fp32 on the FMA kernel.
Its launches are counted apart, in ``project_with_stats.launches_q8`` (either
route) and ``.launches_q8_sm90`` (the tensor cores).

``select_candidate_blocks`` (plain PyTorch, as in the JAX package) then picks
the top ``nb_sel`` blocks per row and gathers their logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e9
BLK = 128  # block-max granularity
_DTYPES = (torch.float32, torch.bfloat16)
_SIG = (_build.PTR,) * 5 + (_build.INT,) * 4 + (_build.PTR,)
_SIG_SM90 = (_build.PTR,) * 5 + (_build.INT,) * 7 + (_build.PTR,)
_SIG_Q8 = (_build.PTR,) * 6 + (_build.INT,) * 4 + (_build.PTR,)
_SIG_Q8_SM90 = (_build.PTR,) * 6 + (_build.INT,) * 7 + (_build.PTR,)


def _logsumexp_from_blocks(bmax: torch.Tensor, bsum: torch.Tensor) -> torch.Tensor:
    """Exact row logsumexp from per-block (max, sum exp(x - max)) partials."""
    mstar = bmax.amax(dim=1)
    return mstar + torch.log(torch.sum(bsum * torch.exp(bmax - mstar[:, None]), dim=1))


def _block_stats_plain(features, w, w_scale, vocab_size) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    N, Vp = features.shape[0], w.shape[0]
    logits = features.float() @ w.float().t()  # fp32 sums of exact bf16 (or int8) products
    if w_scale is not None:
        logits = logits * w_scale.float()[None, :]
    if vocab_size < Vp:
        logits[:, vocab_size:] = NEG_INF
    blocks = logits.view(N, Vp // BLK, BLK)
    bmax = blocks.amax(dim=-1)
    bsum = torch.exp(blocks - bmax[..., None]).sum(dim=-1)
    return logits.to(features.dtype), bmax, bsum


def project_plain(features: torch.Tensor, w: torch.Tensor,
                  w_scale: Optional[torch.Tensor] = None, vocab_size: Optional[int] = None):
    """The plain PyTorch version of K2 and K2-q8 (the CPU path and the kernels' reference)."""
    vs = w.shape[0] if vocab_size is None else vocab_size
    logits, bmax, bsum = _block_stats_plain(features, w, w_scale, vs)
    return logits, bmax, _logsumexp_from_blocks(bmax, bsum)


def _proj_smem(n_tile: int, D: int, q8: bool = False, stream: bool = False) -> int:
    """Shared memory of the tensor-core kernel (``proj_smem``): the 4-stage
    ring of 16 KB W stages (bf16 128 × 64, or int8 128 × 128), the h rows (in
    64-deep chunks; int8: whole 128-deep stages; ``stream``: only each
    stage's chunks of the depth, beside its W tile), the logits transpose,
    the reductions, the mbarriers."""
    if stream:
        nch = 4 * (2 if q8 else 1)
    else:
        nch = 2 * -(-D // 128) if q8 else -(-D // 64)
    return 1024 + 4 * 16384 + nch * n_tile * 128 + 2 * n_tile * (BLK + 8) + 20 * n_tile + 72


def proj_plan(rows: int, D: int, n_sm: int, Vp: int, q8: bool = False,
              budget: int = _build.SMEM_MAX) -> Tuple[int, int, bool]:
    """(row tile, CTAs, stream) of the tensor-core kernel (int8 ``w`` if
    ``q8``) in ``budget`` bytes of shared memory: h staged whole at the row
    tile that covers ``rows``, or at the largest whose h rows fit; where none
    fits, h streamed beside the W stages (``stream``) at the largest row tile
    up to that cover that fits (one tile over 80 rows: W read once). One CTA
    per SM."""
    tiles = [n for n in _build.ROW_TILES if n <= _build.row_tile(rows)]
    for stream in (False, True):
        fits = [n for n in tiles if _proj_smem(n, D, q8, stream) <= budget]
        if fits:
            return fits[-1], min(n_sm, Vp // BLK), stream
    raise ValueError(f"project_with_stats: {budget} bytes of shared memory hold no W stages")


def _route(device: torch.device, features: torch.Tensor, w: torch.Tensor) -> str:
    """The version ``project_with_stats`` runs (``_build.route``): ``"plain"`` on
    the CPU, ``"fma"`` for fp32 features, ``"sm90"`` for bf16 ones, whose ``w``
    (bf16 or int8) must then be TMA-aligned too."""
    return _build.route("project_with_stats", device, features.dtype,
                        {"features": features, "w": w})


def project_with_stats(
    features: torch.Tensor,  # [N, D] post-LN decoder features
    w: torch.Tensor,  # [Vp, D] tied embedding: features' dtype, or int8
    w_scale: Optional[torch.Tensor] = None,  # [Vp] fp32 row scales of an int8 w
    vocab_size: Optional[int] = None,  # real vocab (< Vp when padded)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (logits [N, Vp], block_max [N, Vp/128] fp32, Z [N] fp32)."""
    name = "project_with_stats"
    N, D = features.shape
    Vp = w.shape[0]
    if w.dim() != 2 or w.shape[1] != D or Vp % BLK:
        raise ValueError(f"{name}: w {tuple(w.shape)} must be [Vp % {BLK} == 0, {D}]")
    q8 = w.dtype == torch.int8
    if q8 != (w_scale is not None) or (q8 and tuple(w_scale.shape) != (Vp,)):
        raise ValueError(f"{name}: an int8 w needs w_scale [{Vp}], and only an int8 w takes one")
    vs = Vp if vocab_size is None else vocab_size
    dev = features.device
    kind = _route(dev, features, w)
    if kind == "plain":
        return project_plain(features, w, w_scale, vs)
    _build.require_cuda(name, {"features": features}, _DTYPES)
    if q8:
        _build.require_cuda(name, {"w": w}, (torch.int8,))
        _build.require_cuda(name, {"w_scale": w_scale}, (torch.float32,))
        if not (w.device == w_scale.device == dev):
            raise ValueError(f"{name}: w and w_scale must be on {dev}")
    else:
        _build.require_cuda(name, {"features": features, "w": w}, _DTYPES)
    logits = torch.empty((N, Vp), dtype=features.dtype, device=dev)
    bmax = torch.empty((N, Vp // BLK), dtype=torch.float32, device=dev)
    bsum = torch.empty_like(bmax)
    stream = _build.stream_of(features)
    outs = (logits.data_ptr(), bmax.data_ptr(), bsum.data_ptr())
    streamed = False
    with torch.cuda.device(dev):
        if kind == "sm90":
            n_tile, ctas, streamed = proj_plan(N, D, _build.sm_count(dev), Vp, q8)
        if q8 and kind == "sm90":
            err = _build.kernel_function("mk_project_with_stats_q8_sm90", _SIG_Q8_SM90)(
                features.data_ptr(), w.data_ptr(), w_scale.data_ptr(), *outs, N, D, Vp, vs,
                n_tile, ctas, int(streamed), stream)
        elif q8:
            err = _build.kernel_function("mk_project_with_stats_q8", _SIG_Q8)(
                features.data_ptr(), w.data_ptr(), w_scale.data_ptr(), *outs, N, D, Vp, vs,
                stream)
        elif kind == "sm90":
            err = _build.kernel_function("mk_project_with_stats_sm90", _SIG_SM90)(
                features.data_ptr(), w.data_ptr(), *outs, N, D, Vp, vs, n_tile, ctas,
                int(streamed), stream)
        else:
            err = _build.kernel_function("mk_project_with_stats", _SIG)(
                features.data_ptr(), w.data_ptr(), *outs, N, D, Vp, vs, stream)
    _build.check(err, name)
    if q8:
        project_with_stats.launches_q8 += 1
        project_with_stats.launches_q8_sm90 += kind == "sm90"
        project_with_stats.streamed_q8 += streamed
    else:
        project_with_stats.launches += 1
        project_with_stats.launches_sm90 += kind == "sm90"
        project_with_stats.streamed += streamed
    return logits, bmax, _logsumexp_from_blocks(bmax, bsum)


project_with_stats.launches = 0  # K2, either route
project_with_stats.launches_sm90 = 0  # K2 on the tensor-core route (bf16)
project_with_stats.launches_q8 = 0  # K2-q8, either route
project_with_stats.launches_q8_sm90 = 0  # K2-q8 on the tensor-core route (bf16)
project_with_stats.streamed = 0  # K2's tensor-core launches with h streamed beside W
project_with_stats.streamed_q8 = 0  # K2-q8's


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; equal values keep index order (``lax.top_k``'s rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_candidate_blocks(
    logits: torch.Tensor,  # [N, Vp]
    bmax: torch.Tensor,  # [N, Vp/BLK]
    nb_sel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``nb_sel`` 128-token blocks per row → (values, token ids), each [N, nb_sel·BLK]."""
    N, Vp = logits.shape
    _, bidx = top_k_stable(bmax, nb_sel)
    blk = logits.view(N, Vp // BLK, BLK)
    g = torch.gather(blk, 1, bidx[:, :, None].expand(N, nb_sel, BLK))
    ids = bidx[:, :, None] * BLK + torch.arange(BLK, device=logits.device)
    return g.reshape(N, nb_sel * BLK), ids.reshape(N, nb_sel * BLK)
