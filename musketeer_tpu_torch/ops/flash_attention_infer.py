"""K1: forward-only attention with decomposed positional bias.

Port of ``musketeer_tpu/ops/flash_attention_infer.py::flash_attention_inference``
(Pallas ``_kernel``). Computes, per (batch, head),

    softmax(q·kᵀ + pos_q·pos_kᵀ + rel + causal/pad masks) · v

with the JAX kernel's numerics: scores in fp32, masks as the finite −1e9 (a
fully masked row therefore gives the mean of v, not zeros), the
probabilities rounded to v's dtype before the P·v product and the
normalisation after it; ``skip_max`` drops the max-subtract and floors the
denominator at 1e-38. ``rel`` is ``[H, Tr ≥ T, Sr ≥ S]`` and may be wider than
the stream (only its top-left ``[T, S]`` is read); ``rel=None`` is cross
attention.

``flash_attention_inference`` runs the plain PyTorch version for CPU tensors
and the CUDA kernel (``csrc/flash_attention_infer.cu``) for CUDA tensors: bf16
on the tensor-core core (``csrc/flash_fwd_sm90.cuh``, wgmma fed by TMA), fp32
on the FMA core (``csrc/flash_fwd.cuh``), each compiled at the tile widths
``_build.HEAD_DIMS`` (32, 64, 80, 128, 192, 256): a head dim of 1 to 256
runs on the smallest that covers it, any head dim past 256 on the deep
route (``_build.DEEP``: the head dim streamed through the products in
chunks of 128, ``csrc/flash_fwd_sm90.cuh::Layout<DEEP>`` and
``csrc/flash_deep.cuh``; counted in ``.deep``), one that is not a multiple
of 8 on zero-padded copies of the streams (``_build.pad_head``; counted in
``.padded``), one past 128 with the output's columns split into blocks of
128 over the grid (bf16; counted in ``.col_split``). It never falls back
from one to another. It has no backward and refuses
inputs that autograd tracks: the model reaches it through
``ops/flash_attention_bwd.py::flash_attention``, which sends differentiated
calls to K3/K4 instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e9
_DTYPES = (torch.float32, torch.bfloat16)
_SIG = (_build.INT,) + (_build.PTR,) * 8 + (_build.INT,) * 4 + (_build.I64,) * 2 \
    + (_build.INT,) * 3 + (_build.PTR,)


def sm90_smem(D: int, bwd: bool = False) -> int:
    """Shared memory of a CTA of the tensor-core attention core at head dim D,
    on its instance DP (``_build.head_instance``; ``Layout<DP>::SMEM_BYTES``
    in ``csrc/flash_fwd_sm90.cuh``: K1, K3, K5), or with ``bwd`` of K4's
    launches (``BwdLayout<DP>::SMEM`` in ``csrc/flash_bwd_sm90.cuh``): 64-row
    bf16 tiles of 128 DP bytes, two resident (q, pos_q; K4 three) and a ring
    of stages (3 up to DP 128; past it 2, K4's 1) of k, pos_k and v (past
    128 the CTA's 128 columns of v; K4's three whole tiles), the mbarriers,
    1 KB of alignment slack; K4 also each stage's lse and dsum rows and two
    staged rel tiles of 64 rows of 72 bf16. On the deep route (``Layout<DEEP>``,
    ``BwdDeep``), whatever D: a ring of 6 slots of two 64 x 128 chunks, its
    mbarriers (the forward also the unused q barrier), the slack; K4 also
    the two rel tiles."""
    dp = _build.head_instance(D)
    if dp == _build.DEEP:
        ring, rel = 6 * 2 * 64 * _build.DEEP_CHUNK * 2, 2 * 64 * 72 * 2
        return ring + rel + 8 * 2 * 6 + 1024 if bwd else ring + 8 * (2 * 6 + 1) + 1024
    tile, split = 64 * dp * 2, dp > _build.SPLIT_HEAD_DIM
    if not bwd:
        stages, vtile = (2, 64 * 128 * 2) if split else (3, tile)
        return 2 * tile + stages * (2 * tile + vtile) + 8 * (2 * stages + 1) + 1024
    stages = 1 if split else 3
    return (3 * tile + stages * (3 * tile + 2 * 64 * 4) + 2 * 64 * 72 * 2
            + 8 * (2 * stages + 1) + 1024)


def check_shapes(name: str, q, k, v, pos_q, pos_k, rel, kpad) -> None:
    B, H, T, D = q.shape
    S = k.shape[2]
    for arg, t, shape in (("pos_q", pos_q, (B, H, T, D)), ("k", k, (B, H, S, D)),
                          ("v", v, (B, H, S, D)), ("pos_k", pos_k, (B, H, S, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {shape}")
    if tuple(kpad.shape) != (B, S) or kpad.dtype != torch.bool:
        raise ValueError(f"{name}: kpad must be bool [{B}, {S}]")
    if rel is not None and (rel.dim() != 3 or rel.shape[0] != H
                            or rel.shape[1] < T or rel.shape[2] < S):
        raise ValueError(f"{name}: rel {tuple(rel.shape)} must be [{H}, >={T}, >={S}]")


def cuda_args(name: str, q, k, v, pos_q, pos_k, rel, kpad,
              rel_f32: bool = False, tma: bool = False) -> Tuple[Optional[int], int, int]:
    """Validate CUDA inputs of the attention kernels → (rel pointer, head and row strides).
    Any head dim from 1 upward (``_build.check_head_dim``).
    ``rel_f32``: the kernel also reads an fp32 rel (K5), not only one in q's dtype.
    ``tma``: bf16 streams go to the tensor-core kernels (K1, K3, K4, K5), whose
    TMA copies need 16-byte aligned bases (a head dim that is not a multiple
    of 8 runs on fresh zero-padded copies, ``padded_streams``)."""
    _build.check_head_dim(name, q.shape[-1])
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _build.require_cuda(name, {"q": q, "k": k, "v": v, "pos_q": pos_q, "pos_k": pos_k}, _DTYPES)
    # rel may be a row-strided view; only its rows must be contiguous
    rel_dtypes = (q.dtype, torch.float32) if rel_f32 else (q.dtype,)
    if rel is not None and (rel.device != q.device or rel.dtype not in rel_dtypes
                            or rel.stride(2) != 1):
        raise ValueError(f"{name}: rel must be on q's device, in one of {rel_dtypes}, "
                         "with contiguous rows")
    if kpad.device != q.device or not kpad.is_contiguous():
        raise ValueError(f"{name}: kpad must be contiguous on q's device")
    if tma and q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0 and any(
            t.data_ptr() % 16 for t in (q, k, v, pos_q, pos_k)):
        raise ValueError(f"{name}: bf16 q, k, v, pos_q and pos_k must start on 16-byte "
                         "boundaries (TMA)")
    if rel is None:
        return None, 0, 0
    return rel.data_ptr(), rel.stride(0), rel.stride(1)


def padded_streams(*streams):
    """The streams as the kernels take them: each itself where the head dim is
    a multiple of 8, else a copy zero-padded to the next multiple
    (``_build.pad_head``), whose zero columns add nothing to q·k, pos_q·pos_k
    or P·v; the caller slices its outputs back to the head dim."""
    return [None if t is None else _build.pad_head(t) for t in streams]


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the plain versions sum it: in fp32, or in fp64 where it is fp64
    already (the function evaluated in fp64: a reference for the fp32 kernels
    where the fp32 plain version's own rounding is as large as the check's
    tolerance)."""
    return t if t.dtype == torch.float64 else t.float()


def attention_scores(q, k, pos_q, pos_k, rel, kpad, causal: bool) -> torch.Tensor:
    """fp32 (fp64: ``widen``) scores ``[B, H, T, S]`` with the bias added and
    the masks at −1e9."""
    T, S = q.shape[2], k.shape[2]
    # bf16 products are exact in fp32: this matches the TPU kernel's
    # fp32-accumulated dots
    w = widen(q) @ widen(k).transpose(-1, -2)
    w = w + widen(pos_q.to(q.dtype)) @ widen(pos_k.to(q.dtype)).transpose(-1, -2)
    if rel is not None:
        w = w + widen(rel[:, :T, :S].to(q.dtype))[None]
    if causal:
        cmask = torch.arange(S, device=q.device)[None, :] > torch.arange(T, device=q.device)[:, None]
        w = w.masked_fill(cmask, NEG_INF)
    return w.masked_fill(kpad[:, None, None, :], NEG_INF)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pos_q: torch.Tensor, pos_k: torch.Tensor, rel: Optional[torch.Tensor],
    kpad: torch.Tensor, causal: bool = False, skip_max: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of K1 (the CPU path and the kernel's reference)."""
    w = attention_scores(q, k, pos_q, pos_k, rel, kpad, causal)
    if skip_max:
        e = torch.exp(w)
        denom = e.sum(-1, keepdim=True).clamp_min(1e-38)
    else:
        e = torch.exp(w - w.amax(-1, keepdim=True))
        denom = e.sum(-1, keepdim=True)
    acc = widen(e.to(v.dtype)) @ widen(v)
    return (acc / denom).to(q.dtype)


def flash_attention_inference(
    q: torch.Tensor,      # [B, H, T, D] (pre-scaled)
    k: torch.Tensor,      # [B, H, S, D]
    v: torch.Tensor,      # [B, H, S, D]
    pos_q: torch.Tensor,  # [B, H, T, D] (pre-scaled)
    pos_k: torch.Tensor,  # [B, H, S, D]
    rel: Optional[torch.Tensor],  # [H, Tr >= T, Sr >= S] additive bias, or None
    kpad: torch.Tensor,   # [B, S] bool, True = masked key
    causal: bool = False,
    skip_max: bool = False,
) -> torch.Tensor:
    """→ [B, H, T, D] in q's dtype. Plain version on CPU, CUDA kernel on CUDA."""
    name = "flash_attention_inference"
    check_shapes(name, q, k, v, pos_q, pos_k, rel, kpad)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, pos_q, pos_k, rel)):
        # the kernel writes through raw pointers: its result would carry no
        # gradient, and on the card training would silently get zeros
        raise RuntimeError(f"{name} has no backward; differentiate through "
                           "ops.flash_attention_bwd.flash_attention")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pos_q, pos_k, rel, kpad, causal, skip_max)
    rel_ptr, rel_hs, rel_rs = cuda_args(name, q, k, v, pos_q, pos_k, rel, kpad, tma=True)
    B, H, T, D = q.shape
    S = k.shape[2]
    q, k, v, pos_q, pos_k = padded_streams(q, k, v, pos_q, pos_k)
    out = torch.empty_like(q)
    fn = _build.kernel_function("mk_flash_attention_infer", _SIG)
    with torch.cuda.device(q.device):
        err = fn(
            int(q.dtype == torch.bfloat16),
            q.data_ptr(), pos_q.data_ptr(), k.data_ptr(), pos_k.data_ptr(), v.data_ptr(),
            rel_ptr, kpad.data_ptr(), out.data_ptr(), B, H, T, S, rel_hs, rel_rs,
            int(causal), int(skip_max), q.shape[-1], _build.stream_of(q),
        )
    _build.check(err, name)
    flash_attention_inference.launches += 1
    flash_attention_inference.col_split += _build.col_halves(D) > 1 and q.dtype == torch.bfloat16
    flash_attention_inference.deep += _build.head_instance(D) == _build.DEEP
    if out.shape[-1] != D:  # ran on zero-padded copies
        flash_attention_inference.padded += 1
        out = out[..., :D].contiguous()
    return out


flash_attention_inference.launches = 0
flash_attention_inference.padded = 0  # the launches that ran on zero-padded copies
flash_attention_inference.col_split = 0  # the bf16 launches split into column blocks (D > 128)
flash_attention_inference.deep = 0  # the launches on the deep route (D > 256), either dtype
