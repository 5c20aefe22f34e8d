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
CPU tensors and the CUDA kernel (``csrc/topk_projection.cu``) for CUDA
tensors; it never falls back from one to the other.

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
_SIG = (_build.INT,) + (_build.PTR,) * 5 + (_build.INT,) * 4 + (_build.PTR,)


def _logsumexp_from_blocks(bmax: torch.Tensor, bsum: torch.Tensor) -> torch.Tensor:
    """Exact row logsumexp from per-block (max, sum exp(x - max)) partials."""
    mstar = bmax.amax(dim=1)
    return mstar + torch.log(torch.sum(bsum * torch.exp(bmax - mstar[:, None]), dim=1))


def _block_stats_plain(features, w, vocab_size) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    N, Vp = features.shape[0], w.shape[0]
    logits = features.float() @ w.float().t()  # fp32 sums of exact bf16 products
    if vocab_size < Vp:
        logits[:, vocab_size:] = NEG_INF
    blocks = logits.view(N, Vp // BLK, BLK)
    bmax = blocks.amax(dim=-1)
    bsum = torch.exp(blocks - bmax[..., None]).sum(dim=-1)
    return logits.to(features.dtype), bmax, bsum


def project_plain(features: torch.Tensor, w: torch.Tensor,
                  vocab_size: Optional[int] = None):
    """The plain PyTorch version of K2 (the CPU path and the kernel's reference)."""
    vs = w.shape[0] if vocab_size is None else vocab_size
    logits, bmax, bsum = _block_stats_plain(features, w, vs)
    return logits, bmax, _logsumexp_from_blocks(bmax, bsum)


def project_with_stats(
    features: torch.Tensor,  # [N, D] post-LN decoder features
    w: torch.Tensor,  # [Vp, D] tied embedding, features' dtype
    vocab_size: Optional[int] = None,  # real vocab (< Vp when padded)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (logits [N, Vp], block_max [N, Vp/128] fp32, Z [N] fp32)."""
    N, D = features.shape
    Vp = w.shape[0]
    if w.dim() != 2 or w.shape[1] != D or Vp % BLK:
        raise ValueError(f"project_with_stats: w {tuple(w.shape)} must be [Vp % {BLK} == 0, {D}]")
    vs = Vp if vocab_size is None else vocab_size
    if features.device.type == "cpu":
        return project_plain(features, w, vs)
    if features.device.type != "cuda":
        raise ValueError(f"project_with_stats: unsupported device {features.device}")
    _build.require_cuda("project_with_stats", {"features": features, "w": w}, _DTYPES)
    logits = torch.empty((N, Vp), dtype=features.dtype, device=features.device)
    bmax = torch.empty((N, Vp // BLK), dtype=torch.float32, device=features.device)
    bsum = torch.empty_like(bmax)
    fn = _build.kernel_function("mk_project_with_stats", _SIG)
    with torch.cuda.device(features.device):
        err = fn(
            int(features.dtype == torch.bfloat16), features.data_ptr(), w.data_ptr(),
            logits.data_ptr(), bmax.data_ptr(), bsum.data_ptr(), N, D, Vp, vs,
            _build.stream_of(features),
        )
    _build.check(err, "project_with_stats")
    project_with_stats.launches += 1
    return logits, bmax, _logsumexp_from_blocks(bmax, bsum)


project_with_stats.launches = 0


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
