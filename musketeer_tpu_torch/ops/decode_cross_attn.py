"""K6: one decode step of beam-shared cross-attention over the int8 K/V cache.

Port of ``musketeer_tpu/ops/decode_cross_attn.py::decode_cross_attention_int8``
(Pallas ``_kernel``). The serving option ``quantize_cross_kv``
(``models/ofa.py``) stores the cross K/V as int8 with one fp32 scale per
(layer, sample, head, position); the scales factor out of both contractions:

    w   = (q·k_i8ᵀ)·k_scale + bias          fp32, pads → −1e9
    m   = max(max_s w, −1e8)                 (clamped)
    p   = exp(w − m) / max(Σ exp(w − m), 1e-38) · v_scale
    out = p.to(q.dtype) · v_i8               fp32 sums → q's dtype

A sample's Kb beams are the query rows of one product with its K/V, which is
read once for all of them. A fully padded sample gives exact zeros (clamped
max, floored denominator). The 1e-38 floor is subnormal in fp32: the kernel
is built without flushing subnormals; XLA:CPU flushes it, so the JAX kernel
gives NaN on such a sample in the CPU tests (ROADMAP §3).

``decode_cross_attention_int8`` runs the plain PyTorch version for CPU
tensors and a CUDA kernel (``csrc/decode_cross_attn.cu``) for CUDA tensors,
picked by q's dtype (``_build.route``): bf16 on the tensor cores (the K/V
tiles by TMA, widened to bf16 in registers and shared memory, ``mma.sync``,
two CTAs an SM; launched with programmatic dependent launch, so its K/V
copies start before the previous kernel on the stream ends: that kernel must
not write the cache), its launches also counted in
``decode_cross_attention_int8.launches_sm90``; fp32 on the FMA kernel
(``csrc/cross_attn.cuh``). Both are compiled at the tile widths
``_build.HEAD_DIMS`` (32, 64, 80, 128, 192, 256): a head dim up to 256 runs
on the smallest that covers it, one that is not a multiple of 16 (an int8
row of whole 16-byte units) on zero-padded copies of q and the cache
(counted in ``.padded``), one past 128 on a shallower ring of int8 tiles,
one CTA an SM (counted in ``.wide``), any head dim past 256 on the deep
route (counted in ``.deep``): each key row streamed in chunks of 128 dims,
the score summed over them, and the output's columns split into blocks of
128 over the grid (a CTA per (head, sample, beam tile, block), the instance
128's tiles and ring); unaligned inputs raise; it never falls back from one
version to another. Any beam count and S: ``plan``
picks beam tiles of 16 (``.beam_tiled``) and, past the whole score row's
fit in shared memory, scores in chunks over two passes (``.chunked``).
"""

from __future__ import annotations

import torch

from . import _build
from .decode_stack import BEAM_TILE, cross_plan, cross_stages, tile_width

NEG_INF = -1e9
_DTYPES = (torch.float32, torch.bfloat16)
_SIG = (_build.PTR,) * 8 + (_build.INT,) * 4 + (_build.I64,) * 2 + (_build.INT,) * 2 + (_build.PTR,)


def sm90_smem(Kb: int, S: int, D: int = 64) -> int:
    """Shared memory of the tensor-core kernel's whole-row route
    (``smem_bytes``) at head dim D, on its instance DP
    (``_build.head_instance``; the deep route: 128, its chunks'), for a beam
    tile of min(Kb, 16) beams: the ring of ``cross_stages`` 64 x DP int8
    tiles, two 64 x DP bf16 value tiles, the mbarriers, the fp32 scores
    ``[kb, S']`` and the k_scale, v_scale and bias rows, the bf16
    probabilities ``[kb, S' + 8]`` (S' = S rounded up to 64)."""
    kb, sp, dp = min(Kb, BEAM_TILE), -(-S // 64) * 64, tile_width(_build.head_instance(D, 16))
    st = cross_stages(dp)
    return (1024 + st * 64 * dp + 2 * 128 * dp + 16 * st + 4 * (kb * sp + 3 * sp)
            + 2 * kb * (sp + 8))


def plan(Kb: int, S: int, D: int, fp32: bool, budget: int = _build.SMEM_MAX) -> dict:
    """K6's route (``decode_stack.cross_plan`` with this kernel's shared memory):
    ``beam_tiles`` of up to 16 beams, ``chunk`` the keys of a score chunk (S:
    the whole row). The bf16 route's chunks are its 64-key tiles, with the
    scale and bias rows read a tile at a time."""
    return cross_plan(Kb, S, D, fp32, budget, smem=sm90_smem)


def _route(device: torch.device, q: torch.Tensor, k_i8: torch.Tensor, v_i8: torch.Tensor) -> str:
    """The version ``decode_cross_attention_int8`` runs (``_build.route``):
    ``"plain"`` on the CPU, ``"fma"`` for fp32 q, ``"sm90"`` for bf16 q, whose
    q and int8 cache must then be TMA-aligned too."""
    return _build.route("decode_cross_attention_int8", device, q.dtype,
                        {"q": q, "k_i8": k_i8, "v_i8": v_i8})


def _check(q, k_i8, v_i8, k_scale, v_scale, bias, enc_pad) -> None:
    name = "decode_cross_attention_int8"
    if q.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be [B, H, Kb, D]")
    B, H, _, D = q.shape
    S = k_i8.shape[2]
    for arg, t, shape in (("k_i8", k_i8, (B, H, S, D)), ("v_i8", v_i8, (B, H, S, D)),
                          ("k_scale", k_scale, (B, H, S)), ("v_scale", v_scale, (B, H, S)),
                          ("bias", bias, (B, H, S)), ("enc_pad", enc_pad, (B, S))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {shape}")
    if k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8 or enc_pad.dtype != torch.bool:
        raise ValueError(f"{name}: k_i8 and v_i8 must be int8, enc_pad bool")


def decode_cross_attention_int8_plain(q, k_i8, v_i8, k_scale, v_scale, bias, enc_pad):
    """The plain PyTorch version of K6 (the CPU path and the kernel's reference)."""
    w = q.float() @ k_i8.float().transpose(-1, -2)  # [B, H, Kb, S]; int8 · q exact in fp32
    w = w * k_scale.float()[:, :, None, :] + bias.float()[:, :, None, :]
    w = w.masked_fill(enc_pad[:, None, None, :], NEG_INF)
    m = w.amax(dim=-1, keepdim=True).clamp_min(-1e8)
    e = torch.exp(w - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-38)
    p = (e / denom) * v_scale.float()[:, :, None, :]
    return (p.to(q.dtype).float() @ v_i8.float()).to(q.dtype)


def decode_cross_attention_int8(
    q: torch.Tensor,        # [B, H, Kb, D] pre-scaled, compute dtype
    k_i8: torch.Tensor,     # [B, H, S, D] int8
    v_i8: torch.Tensor,     # [B, H, S, D] int8
    k_scale: torch.Tensor,  # [B, H, S] fp32
    v_scale: torch.Tensor,  # [B, H, S] fp32
    bias: torch.Tensor,     # [B, H, S] fp32 this step's cross-pos bias row (rows contiguous)
    enc_pad: torch.Tensor,  # [B, S] bool, True = padded key
) -> torch.Tensor:
    """→ [B, H, Kb, D] in q's dtype. Plain version on CPU, CUDA kernel on CUDA."""
    name = "decode_cross_attention_int8"
    _check(q, k_i8, v_i8, k_scale, v_scale, bias, enc_pad)
    if q.device.type == "cpu":
        return decode_cross_attention_int8_plain(q, k_i8, v_i8, k_scale, v_scale, bias, enc_pad)
    D = q.shape[-1]
    _build.check_head_dim(name, D)
    # the int8 rows as whole 16-byte units (TMA, 16-byte loads), q alike
    q, k_i8, v_i8 = (_build.pad_head(t, 16) for t in (q, k_i8, v_i8))
    kind = _route(q.device, q, k_i8, v_i8)
    _build.require_cuda(name, {"q": q}, _DTYPES)
    _build.require_cuda(name, {"k_i8": k_i8, "v_i8": v_i8}, (torch.int8,))
    _build.require_cuda(name, {"k_scale": k_scale, "v_scale": v_scale}, (torch.float32,))
    _build.require_cuda(name, {"enc_pad": enc_pad}, (torch.bool,))
    # bias may be a view of the [B, H, Tmax, S] table: only its rows must be contiguous
    if bias.dtype != torch.float32 or bias.stride(2) != 1:
        raise ValueError(f"{name}: bias must be fp32 with contiguous rows")
    if len({t.device for t in (q, k_i8, v_i8, k_scale, v_scale, bias, enc_pad)}) != 1:
        raise ValueError(f"{name}: all inputs must be on one device")
    if k_i8.data_ptr() % 16 or v_i8.data_ptr() % 16:
        raise ValueError(f"{name}: k_i8 and v_i8 must start on 16-byte boundaries (vector loads)")
    B, H, Kb, Dp = q.shape
    S = k_i8.shape[2]
    route = plan(Kb, S, Dp, fp32=kind != "sm90")
    out = torch.empty_like(q)
    entry = "mk_decode_cross_attn_int8_sm90" if kind == "sm90" else "mk_decode_cross_attn_int8"
    with torch.cuda.device(q.device):
        err = _build.kernel_function(entry, _SIG)(
            q.data_ptr(), k_i8.data_ptr(), v_i8.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), bias.data_ptr(), enc_pad.data_ptr(), out.data_ptr(), B, H, Kb,
            S, bias.stride(0), bias.stride(1), Dp, route["chunk"], _build.stream_of(q),
        )
    _build.check(err, name)
    decode_cross_attention_int8.launches += 1
    decode_cross_attention_int8.launches_sm90 += kind == "sm90"
    decode_cross_attention_int8.beam_tiled += route["beam_tiles"] > 1
    decode_cross_attention_int8.chunked += route["chunk"] < S
    decode_cross_attention_int8.wide += _build.head_instance(Dp, 16) > _build.WIDE_HEAD_DIM
    decode_cross_attention_int8.deep += _build.head_instance(Dp, 16) == _build.DEEP
    if Dp != D:  # ran on zero-padded copies
        decode_cross_attention_int8.padded += 1
        out = out[..., :D].contiguous()
    return out


decode_cross_attention_int8.launches = 0  # either route
decode_cross_attention_int8.launches_sm90 = 0  # the tensor-core route (bf16)
decode_cross_attention_int8.padded = 0  # the launches that ran on zero-padded copies
decode_cross_attention_int8.beam_tiled = 0  # the launches at more than 16 beams (beam tiles)
decode_cross_attention_int8.chunked = 0  # the launches whose scores ran in chunks
decode_cross_attention_int8.wide = 0  # the launches on an instance past 128 (a shallower ring)
decode_cross_attention_int8.deep = 0  # the launches on the deep route (D > 256)
