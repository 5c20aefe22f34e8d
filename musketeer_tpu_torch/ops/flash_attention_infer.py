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
chunks of 128, the output in blocks of 128, up to three a CTA sharing each
score tile, ``csrc/flash_fwd_sm90.cuh::fwd_deep`` (``deep_plan``) and
``csrc/flash_deep.cuh``; counted in ``.deep``), one that is not a multiple
of 8 on zero-padded copies of the streams (``_build.pad_head``; counted in
``.padded``), one of 129 to 256 in bf16 on the pair route (the deep route's
CTA with both column blocks of 128 in one CTA, each score tile built once
for the whole output; counted in ``.pair``). It never falls back
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


# The CTA past head dim 128 (csrc/flash_fwd_sm90.cuh: fwd_deep;
# flash_bwd_sm90.cuh: bwd_kv_deep, bwd_q_deep): a producer warpgroup, a builder
# warpgroup that builds each score tile (K4: S and dP) once, and W block
# warpgroups, one per column block of 128 a CTA owns, fed by a ring of score
# slots of two 64 x 128 bf16 chunks (a score product's pair) and one of
# slots of W chunks (the blocks' operands), with P (K4: P^T or dW^T; dW's
# high and low parts) handed over in two buffers of 64 x 64 bf16 tiles. The
# deep route (past 256) has ``DEEP_BLOCKS`` block warpgroups (``DW``), a
# score ring of ``DEEP_SCORE_STAGES`` and a block ring of
# ``DEEP_BLOCK_STAGES`` slots; where the head dim has at most
# ``DEEP_RESIDENT_NK`` chunks (D <= 384) the forward keeps q's and pos_q's
# chunks resident, streams the key side alone through a ring of
# ``DEEP_KEY_STAGES`` single chunks, and its block ring is one slot deep.
# The pair route (129 to 256) has ``PAIR_BLOCKS`` (``PW``: both blocks of the
# output), K4's score ring ``PAIR_SCORE_STAGES`` slots, block rings of
# ``PAIR_BLOCK_STAGES``, and its forward keeps q and pos_q resident (2 chunks
# each) beside a key ring of ``PAIR_KEY_STAGES``; where the last chunk holds
# at most 64 columns (D <= 192) it is one 64-column box, half a chunk.
DEEP_BLOCKS = 3
DEEP_SCORE_STAGES = 3
DEEP_BLOCK_STAGES = 2
DEEP_RESIDENT_NK = 3
DEEP_KEY_STAGES = 4
PAIR_BLOCKS = 2
PAIR_SCORE_STAGES = 4
PAIR_BLOCK_STAGES = 2
PAIR_KEY_STAGES = 5
_CTA = {  # the rings of a CTA of W block warpgroups: score, block, key, block beside q, resident
    DEEP_BLOCKS: (DEEP_SCORE_STAGES, DEEP_BLOCK_STAGES, DEEP_KEY_STAGES, 1, DEEP_RESIDENT_NK),
    PAIR_BLOCKS: (PAIR_SCORE_STAGES, PAIR_BLOCK_STAGES, PAIR_KEY_STAGES, PAIR_BLOCK_STAGES, 2),
}
_CHUNK = 64 * _build.DEEP_CHUNK * 2  # bytes of a 64-row chunk of 128 bf16 columns
_PTILE = 64 * 64 * 2  # bytes of a 64 x 64 bf16 A tile
_REL_TILE = 64 * 72 * 2  # a staged rel tile of K4's key-major kernel


def cta_blocks(D: int) -> int:
    """The block warpgroups of the bf16 CTA past head dim 128 at head dim D:
    ``PAIR_BLOCKS`` up to ``_build.MAX_INSTANCE``, else ``DEEP_BLOCKS``."""
    return PAIR_BLOCKS if D <= _build.MAX_INSTANCE else DEEP_BLOCKS


def _deep_smem(kind: str, W: int = DEEP_BLOCKS) -> int:
    """Shared memory of a CTA of W blocks (``DeepFwd<W, kResident>::SMEM``,
    ``DeepBwd<W, kQ>::SMEM``): the two rings, two A buffers (one tile;
    ``"bwd_q"``: two), the forward's rows (two buffers of 64 rescale factors,
    64 denominators, fp32) or the key-major kernel's rel tile, the mbarriers
    and 1 KB of alignment slack; ``"fwd_resident"`` q's and pos_q's chunks,
    the key ring, the block ring beside q and q's mbarrier in place of the
    rings."""
    score, block, key, res_block, res_nk = _CTA[W]
    if kind == "fwd_resident":
        return (2 * res_nk * _CHUNK + key * _CHUNK + res_block * W * _CHUNK + 2 * _PTILE
                + 3 * 64 * 4 + 8 * (2 * key + 2 * res_block + 4 + 1) + 1024)
    rings = score * 2 * _CHUNK + block * W * _CHUNK
    extra = {"fwd": 2 * _PTILE + 3 * 64 * 4, "bwd_kv": 2 * _PTILE + _REL_TILE,
             "bwd_q": 2 * 2 * _PTILE}[kind]
    return rings + extra + 8 * (2 * score + 2 * block + 4) + 1024


def deep_groups(D: int) -> list:
    """The column blocks of 128 each CTA past head dim 128 owns at head dim D,
    group by group: ``cta_blocks(D)`` each, the last group the rest (the pair
    route: one group of both)."""
    nch, W = _build.deep_chunks(D), cta_blocks(D)
    return [min(W, nch - j) for j in range(0, nch, W)]


def deep_plan(D: int, kernel: str = "K1", B: int = 16, H: int = 1, T: int = 908,
              S: int = 908) -> dict:
    """The plan of the bf16 kernels past head dim 128 for ``kernel`` ("K1"
    (K3 alike), "K5" or "K4") at head dim D and streams [B, H, T or S, D]:
    the route (``"pair"`` up to 256, else ``"deep"``), the column blocks a
    CTA owns (``blocks``, ``cta_blocks``) and the last group's
    (``last_blocks``), the 64-column boxes of the last chunk
    (``last_boxes``: 1 on the pair route up to D 192), the CTAs per query
    tile (K4: per key tile of the key-major launch, over its three
    gradients, and per q tile of the query-major one, over two), how many
    times each (q tile, key tile)'s score tile is built (``score_builds``;
    K5 two passes; K4 S over its five gradients and dP over the four that
    need it, ``dp_builds``), against one block a CTA (``*_one_block``: the
    column-split design that ran head dims 129 to 256 before the pair
    route), whether the forward keeps q and pos_q resident (``resident``),
    the bytes the producers stream into shared memory per call (``bytes``;
    one block a CTA, nothing resident: ``bytes_one_block``), and the shared
    memory of a CTA (``smem``; K4 the larger of its kernels')."""
    groups, nch, W = deep_groups(D), _build.deep_chunks(D), cta_blocks(D)
    pair = W == PAIR_BLOCKS
    lb = 1 if pair and -(-D // 8) * 8 - _build.DEEP_CHUNK * (nch - 1) <= 64 else 2
    G, nq, nk = len(groups), -(-T // 64), -(-S // 64)
    row = (nch - 1) * _CHUNK + lb * _CHUNK // 2  # a 64-row tile of one stream, in chunks
    blk = lambda j: _CHUNK if j < nch - 1 else lb * _CHUNK // 2  # noqa: E731  (block j)
    starts = [W * i for i in range(G)]
    gblk = [sum(blk(j) for j in range(s0, s0 + nb)) for s0, nb in zip(starts, groups)]
    vall = sum(blk(j) for j in range(nch))
    out = dict(route="pair" if pair else "deep", blocks=W, last_blocks=groups[-1], nch=nch,
               last_boxes=lb)
    if kernel in ("K1", "K5"):
        passes, resident = (2 if kernel == "K5" else 1), nch <= _CTA[W][4]
        if resident:  # q's and pos_q's chunks once, the key side's per key tile
            nbytes = nq * sum(2 * row + nk * (passes * 2 * row + v) for v in gblk)
        else:
            nbytes = nq * sum(nk * (passes * 4 * row + v) for v in gblk)
        one = nq * nk * (nch * passes * 4 * row + vall)
        out.update(ctas_per_tile=G, score_builds=passes * G, score_builds_one_block=passes * nch,
                   resident=resident,
                   smem=_deep_smem("fwd_resident" if resident else "fwd", W))
    elif kernel == "K4":
        kv = nk * nq * sum(4 * row + (2 * row if g else 0) + v for g in range(3) for v in gblk)
        qm = nq * nk * 2 * sum(6 * row + v for v in gblk)
        nbytes = kv + qm
        one = nk * nq * (nch * 16 * row + 3 * vall) + nq * nk * (nch * 12 * row + 2 * vall)
        out.update(ctas_per_key_tile=3 * G, ctas_per_q_tile=2 * G, score_builds=5 * G,
                   dp_builds=4 * G, score_builds_one_block=5 * nch, dp_builds_one_block=4 * nch,
                   smem=max(_deep_smem("bwd_kv", W), _deep_smem("bwd_q", W)),
                   smem_kv=_deep_smem("bwd_kv", W), smem_q=_deep_smem("bwd_q", W))
    else:
        raise ValueError(f"deep_plan: kernel {kernel!r} not in ('K1', 'K5', 'K4')")
    out.update(bytes=B * H * nbytes, bytes_one_block=B * H * one)
    return out


def sm90_smem(D: int, bwd: bool = False) -> int:
    """Shared memory of a CTA of the tensor-core attention core at head dim D,
    on its instance DP (``_build.head_instance``; ``Layout<DP>::SMEM_BYTES``
    in ``csrc/flash_fwd_sm90.cuh``: K1, K3, K5), or with ``bwd`` of K4's
    launches (``BwdLayout<DP>::SMEM`` in ``csrc/flash_bwd_sm90.cuh``): 64-row
    bf16 tiles of 128 DP bytes, two resident (q, pos_q; K4 three) and a ring
    of 3 stages of k, pos_k and v (K4: q, pos_q and dO), the mbarriers, 1 KB
    of alignment slack; K4 also each stage's lse and dsum rows and two staged
    rel tiles of 64 rows of 72 bf16. Past 128, on the pair and the deep
    route, ``deep_plan``'s ``smem`` (the forward's with q resident up to D
    384; K4 the larger of its two kernels')."""
    dp = _build.head_instance(D)
    if dp == _build.DEEP or dp > _build.WIDE_HEAD_DIM:
        return deep_plan(D, "K4" if bwd else "K1")["smem"]
    tile = 64 * dp * 2
    if not bwd:
        return 2 * tile + 3 * 3 * tile + 8 * 7 + 1024
    return 3 * tile + 3 * (3 * tile + 2 * 64 * 4) + 2 * 64 * 72 * 2 + 8 * 7 + 1024


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
    flash_attention_inference.pair += _build.pair_route(D, q.dtype)
    flash_attention_inference.deep += _build.head_instance(D) == _build.DEEP
    if out.shape[-1] != D:  # ran on zero-padded copies
        flash_attention_inference.padded += 1
        out = out[..., :D].contiguous()
    return out


flash_attention_inference.launches = 0
flash_attention_inference.padded = 0  # the launches that ran on zero-padded copies
flash_attention_inference.pair = 0  # the bf16 launches on the pair route (D 129 to 256)
flash_attention_inference.deep = 0  # the launches on the deep route (D > 256), either dtype
