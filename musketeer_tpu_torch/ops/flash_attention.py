"""K5: the JAX package's first-generation attention entry points.

Port of ``musketeer_tpu/ops/flash_attention.py``: ``flash_attention_bias``
(Pallas ``_attn_kernel`` and ``_causal_attn_kernel``), ``flash_cross_attention``
(``_attn_kernel_norel``) and the XLA oracle ``attention_reference``. They
compute, per (batch, head),

    softmax(q·kᵀ + pos_q·pos_kᵀ (+ rel[h]) (+ causal) + kpad masks) · v

with the TPU kernels' numerics, which differ from K1's
(``flash_attention_infer.py``) in three ways:

- the probabilities are normalised in fp32, ``p = e / Σe``, and then rounded
  to v's dtype before P·v (K1 rounds ``e`` and divides after P·v);
- the JAX wrappers pad the keys to ``Sp`` (a multiple of ``block_q`` for
  ``flash_attention_bias``, of 128 for ``flash_cross_attention``), masked at
  −1e9 with zero v, so a row whose every real key is masked gives
  ``Σ v[:S] / Sp``, not the mean of v over S;
- ``rel``, ``pos_q`` and ``pos_k`` are read in their own dtypes (K1 casts them
  to q's).

The wrappers' padding of the head dim to 128 adds zeros to every dot and
changes nothing. ``attention_reference`` is the JAX package's test oracle:
the same scores, a plain softmax over the S real keys, P rounded to v's dtype.

Each wrapper runs its plain PyTorch version for CPU tensors and the CUDA
kernel (``csrc/flash_attention.cu``) for CUDA tensors, never falling back
from one to another, and counts its launches. bf16 streams run on the
tensor-core core that K1 also uses (``csrc/flash_fwd_sm90.cuh``), fp32 on the
FMA kernel, both compiled at the tile widths ``_build.HEAD_DIMS`` (32, 64,
80, 128, 192, 256): a head dim up to 256 runs on the smallest that covers
it, one past 256 on the deep route, the head dim streamed through the
products in chunks of 128, the output in blocks of 128 sharing each score
tile three a CTA (``csrc/flash_fwd_sm90.cuh::fwd_deep``,
``csrc/flash_deep.cuh``; counted in ``.deep``), one that is not a multiple
of 8 on zero-padded copies (counted in ``.padded``), one of 129 to 256 in
bf16 on the pair route, both column blocks of 128 in one CTA sharing each
score tile (counted in ``.pair``). Like K1 they have no backward and refuse
inputs that autograd tracks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash_attention_infer import check_shapes, cuda_args, padded_streams, widen

NEG_INF = -1e9
_SIG = (_build.INT,) * 2 + (_build.PTR,) * 8 + (_build.INT,) * 5 + (_build.I64,) * 2 \
    + (_build.INT,) * 2 + (_build.PTR,)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _scores(q, k, pos_q, pos_k, rel, kpad, causal: bool) -> torch.Tensor:
    """fp32 (fp64: ``widen``) scores ``[B, H, T, S]``: each product and rel in
    its own dtype, masks at −1e9."""
    T, S = q.shape[2], k.shape[2]
    w = widen(q) @ widen(k).transpose(-1, -2) + widen(pos_q) @ widen(pos_k).transpose(-1, -2)
    if rel is not None:
        w = w + widen(rel)[None]
    if causal:
        cmask = torch.arange(S, device=q.device)[None, :] > torch.arange(T, device=q.device)[:, None]
        w = w.masked_fill(cmask, NEG_INF)
    return w.masked_fill(kpad[:, None, None, :], NEG_INF)


def _attend_plain(q, k, v, pos_q, pos_k, rel, kpad, causal: bool, Sp: int) -> torch.Tensor:
    """The TPU kernels' function over S real keys and ``Sp − S`` padded ones."""
    S = k.shape[2]
    w = _scores(q, k, pos_q, pos_k, rel, kpad, causal)
    m = w.amax(-1, keepdim=True)
    if Sp > S:  # the padded keys: score −1e9, v zero
        m = m.clamp_min(NEG_INF)
    e = torch.exp(w - m)
    denom = e.sum(-1, keepdim=True) + (Sp - S) * torch.exp(NEG_INF - m)
    p = (e / denom).to(v.dtype)
    return (widen(p) @ widen(v)).to(q.dtype)


def flash_attention_bias_plain(q, k, v, pos_q, pos_k, rel, kpad, causal: bool = False,
                               block_q: int = 128) -> torch.Tensor:
    """The plain version of ``flash_attention_bias`` (the CPU path and the kernel's reference)."""
    return _attend_plain(q, k, v, pos_q, pos_k, rel, kpad, causal, _round_up(k.shape[2], block_q))


def flash_cross_attention_plain(q, k, v, pos_q, pos_k, kpad, block_q: int = 128) -> torch.Tensor:
    """The plain version of ``flash_cross_attention``; ``block_q`` pads only the
    query rows, which are cut off again, so it changes nothing."""
    return _attend_plain(q, k, v, pos_q, pos_k, None, kpad, False, _round_up(k.shape[2], 128))


def attention_reference(q, k, v, pos_q, pos_k, rel, kpad, causal: bool = False) -> torch.Tensor:
    """The JAX package's reference for numerics tests (same math, materialized
    bias, softmax over the S real keys) → ``[B, H, T, D]`` in v's dtype."""
    p = torch.softmax(_scores(q, k, pos_q, pos_k, rel, kpad, causal), dim=-1).to(v.dtype)
    return (widen(p) @ widen(v)).to(v.dtype)


def _check(name: str, q, k, v, pos_q, pos_k, rel, kpad) -> None:
    check_shapes(name, q, k, v, pos_q, pos_k, rel, kpad)
    H, T, S = q.shape[1], q.shape[2], k.shape[2]
    if rel is not None and tuple(rel.shape) != (H, T, S):
        raise ValueError(f"{name}: rel {tuple(rel.shape)} must be [{H}, {T}, {S}]")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, pos_q, pos_k, rel)):
        raise RuntimeError(f"{name} has no backward (as in the JAX package)")


def _launch(name: str, q, k, v, pos_q, pos_k, rel: Optional[torch.Tensor], kpad,
            causal: bool, Sp: int) -> torch.Tensor:
    """Validate CUDA inputs and launch K5 → ``[B, H, T, D]`` in q's dtype. rel is
    read in its own dtype, q's or fp32; any other raises, never cast."""
    rel_ptr, rel_hs, rel_rs = cuda_args(name, q, k, v, pos_q, pos_k, rel, kpad, rel_f32=True,
                                        tma=True)
    B, H, T, D = q.shape
    S = k.shape[2]
    q, k, v, pos_q, pos_k = padded_streams(q, k, v, pos_q, pos_k)
    out = torch.empty_like(q)
    fn = _build.kernel_function("mk_flash_attention_k5", _SIG)
    with torch.cuda.device(q.device):
        err = fn(
            int(q.dtype == torch.bfloat16), int(rel is not None and rel.dtype == torch.float32),
            q.data_ptr(), pos_q.data_ptr(), k.data_ptr(), pos_k.data_ptr(), v.data_ptr(),
            rel_ptr, kpad.data_ptr(), out.data_ptr(), B, H, T, S, Sp, rel_hs, rel_rs,
            int(causal), q.shape[-1], _build.stream_of(q),
        )
    _build.check(err, name)
    return out


def _sliced(fn, out: torch.Tensor, D: int) -> torch.Tensor:
    """K5's output cut back to the head dim where it ran on zero-padded copies;
    the launch counted in ``fn.pair`` where it ran on the pair route, in
    ``fn.deep`` where it ran on the deep route."""
    fn.pair += _build.pair_route(D, out.dtype)
    fn.deep += _build.head_instance(D) == _build.DEEP
    if out.shape[-1] == D:
        return out
    fn.padded += 1
    return out[..., :D].contiguous()


def flash_attention_bias(
    q: torch.Tensor,      # [B, H, S, D] (already scaled)
    k: torch.Tensor,      # [B, H, S, D]
    v: torch.Tensor,      # [B, H, S, D]
    pos_q: torch.Tensor,  # [B, H, S, D] (already pos-scaled)
    pos_k: torch.Tensor,  # [B, H, S, D]
    rel: torch.Tensor,    # [H, S, S]
    kpad: torch.Tensor,   # [B, S] bool, True = padded key
    causal: bool = False,
    block_q: int = 128,
) -> torch.Tensor:
    """→ [B, H, S, D] in q's dtype. Plain version on CPU, CUDA kernel on CUDA."""
    name = "flash_attention_bias"
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"{name}: self-attention needs q and k of one length, "
                         f"got {q.shape[2]} and {k.shape[2]}")
    _check(name, q, k, v, pos_q, pos_k, rel, kpad)
    if q.device.type == "cpu":
        return flash_attention_bias_plain(q, k, v, pos_q, pos_k, rel, kpad, causal, block_q)
    out = _launch(name, q, k, v, pos_q, pos_k, rel, kpad, causal, _round_up(k.shape[2], block_q))
    flash_attention_bias.launches += 1
    return _sliced(flash_attention_bias, out, q.shape[-1])


def flash_cross_attention(
    q: torch.Tensor,      # [B, H, T, D] (already scaled)
    k: torch.Tensor,      # [B, H, S, D]
    v: torch.Tensor,      # [B, H, S, D]
    pos_q: torch.Tensor,  # [B, H, T, D] (pos-scaled)
    pos_k: torch.Tensor,  # [B, H, S, D]
    kpad: torch.Tensor,   # [B, S] bool, True = padded key
    block_q: int = 128,
) -> torch.Tensor:
    """→ [B, H, T, D] in q's dtype. Plain version on CPU, CUDA kernel on CUDA."""
    name = "flash_cross_attention"
    _check(name, q, k, v, pos_q, pos_k, None, kpad)
    if q.device.type == "cpu":
        return flash_cross_attention_plain(q, k, v, pos_q, pos_k, kpad, block_q)
    out = _launch(name, q, k, v, pos_q, pos_k, None, kpad, False, _round_up(k.shape[2], 128))
    flash_cross_attention.launches += 1
    return _sliced(flash_cross_attention, out, q.shape[-1])


flash_attention_bias.launches = 0
flash_cross_attention.launches = 0
flash_attention_bias.padded = 0  # the launches that ran on zero-padded copies
flash_cross_attention.padded = 0
flash_attention_bias.pair = 0  # the bf16 launches on the pair route (D 129 to 256)
flash_cross_attention.pair = 0
flash_attention_bias.deep = 0  # the launches on the deep route (D > 256)
flash_cross_attention.deep = 0
