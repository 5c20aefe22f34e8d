"""K3 and K4: differentiable attention with decomposed positional bias.

Port of ``musketeer_tpu/ops/flash_attention_bwd.py``: the training forward
``_fwd`` (Pallas ``_fwd_kernel``, here K3) that also returns the per-row
logsumexp, the fused backward ``_bwd`` (``_bwd_kernel_fused``, here K4) that
rebuilds P from it and gives all six gradients

    dW = P ∘ (dO·vᵀ − rowsum(dO ∘ O))
    dq = dW·k      dpos_q = dW·pos_k      dk = dWᵀ·q      dpos_k = dWᵀ·pos_q
    dv = Pᵀ·dO     drel = Σ_b dW

and the custom VJP around them (``flash_attention_bias_trainable``), here the
autograd Function ``FlashAttentionTrainable``. ``flash_attention`` is what the
model calls: like the JAX custom VJP, whose primal is K1 and whose
differentiated trace runs K3/K4, it runs K1 when autograd tracks none of the
inputs and the Function otherwise.

K3 keeps K1's numerics (fp32 scores, −1e9 masks, P rounded to v's dtype before
P·v, normalisation after it, the 1e-38 floor under ``skip_max``) and returns
``lse = m + log(l)`` (``log(max(l, 1e-38))`` under ``skip_max``) in fp32. K4
forms P and dW in fp32, as the TPU kernel does, and rounds each gradient once
to its input's dtype; drel (Σ_b of the unrounded dW) comes out in fp32 and is
cast to rel's dtype here. ``rel=None`` (cross attention) has no drel.

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernels (``csrc/flash_attention_bwd.cu``) for CUDA tensors, never falling back
from one to the other, and counts its launches (one per call, however many
CUDA kernels the call runs). The dtype picks the core: bf16 runs on Hopper's
tensor cores (K3 on ``csrc/flash_fwd_sm90.cuh``, K4 on
``csrc/flash_bwd_sm90.cuh``), whose products take bf16 operands, so K4 rounds
P and dW to bf16 once as the operands of its dv and dk|dpos_k products and
takes dq|dpos_q on dW's high and low bf16 parts; fp32 runs on the FMA
kernels in full fp32. The tensor-core kernels read their streams by TMA, so
bf16 q, k, v, pos_q, pos_k (and K4's o and do) must start on 16-byte
boundaries; the wrappers raise otherwise. Both cores are compiled at the
tile widths ``_build.HEAD_DIMS`` (32, 64, 80, 128, 192, 256): a head dim up
to 256 runs on the smallest that covers it, one that is not a multiple of 8
on zero-padded copies (``flash_attention_infer.padded_streams``; counted in
``.padded``); K4's key-major work is two launches at 80 and three at 128,
its query-major work two at 128 (``csrc/flash_bwd_sm90.cuh``); from 129 to
256 the bf16 launches of both run on the pair route (counted in ``.pair``):
the deep route's CTA below with both column blocks of 128 of an output in
one CTA, so that K3 builds each score tile once and K4 S 5 times and dP 4
times per (key tile, q tile), in two launches. Any head dim past 256 runs
on the deep route (``_build.DEEP``; counted in ``.deep``): the head dim streamed
through the products in chunks of 128 and each output's columns in blocks
of 128, up to three a CTA, whose builder warpgroup builds each score (and
dP) tile once for them (``csrc/flash_fwd_sm90.cuh::fwd_deep``,
``csrc/flash_bwd_sm90.cuh``'s ``bwd_kv_deep`` and ``bwd_q_deep``, two
launches; ``flash_attention_infer.deep_plan``; fp32 ``csrc/flash_deep.cuh``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention_infer import (
    attention_scores,
    check_shapes,
    cuda_args,
    flash_attention_inference,
    padded_streams,
    widen,
)

_P, _I, _L = _build.PTR, _build.INT, _build.I64
_FWD_SIG = (_I,) + (_P,) * 9 + (_I,) * 4 + (_L,) * 2 + (_I,) * 3 + (_P,)
_BWD_SIG = (_I,) + (_P,) * 17 + (_I,) * 4 + (_L,) * 2 + (_I,) * 2 + (_P,)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              Optional[torch.Tensor]]


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' references)
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, pos_q, pos_k, rel, kpad, causal: bool = False,
                              skip_max: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3 → (o [B, H, T, D] in q's dtype, lse [B, H, T] fp32)."""
    w = attention_scores(q, k, pos_q, pos_k, rel, kpad, causal)
    if skip_max:
        e = torch.exp(w)
        denom = e.sum(-1, keepdim=True).clamp_min(1e-38)
        lse = torch.log(denom)
    else:
        m = w.amax(-1, keepdim=True)
        e = torch.exp(w - m)
        denom = e.sum(-1, keepdim=True)
        lse = m + torch.log(denom)
    acc = widen(e.to(v.dtype)) @ widen(v)
    return (acc / denom).to(q.dtype), lse[..., 0]


def flash_attention_bwd_plain(q, k, v, pos_q, pos_k, rel, kpad, o, lse, do,
                              causal: bool = False, need_drel: bool = True) -> Grads:
    """The plain version of K4 → (dq, dk, dv, dpos_q, dpos_k, drel [H, T, S] fp32 or None)."""
    p = torch.exp(attention_scores(q, k, pos_q, pos_k, rel, kpad, causal) - lse[..., None])
    dof = widen(do)
    dp = dof @ widen(v).transpose(-1, -2)
    dw = p * (dp - (dof * widen(o)).sum(-1, keepdim=True))
    dwt = dw.transpose(-1, -2)
    return (
        (dw @ widen(k)).to(q.dtype),
        (dwt @ widen(q)).to(k.dtype),
        (p.transpose(-1, -2) @ dof).to(v.dtype),
        (dw @ widen(pos_k)).to(pos_q.dtype),
        (dwt @ widen(pos_q)).to(pos_k.dtype),
        dw.sum(0) if need_drel and rel is not None else None,
    )


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_attention_fwd(q, k, v, pos_q, pos_k, rel, kpad, causal: bool = False,
                        skip_max: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 → (o, lse). Plain version on CPU, CUDA kernel on CUDA."""
    name = "flash_attention_fwd"
    check_shapes(name, q, k, v, pos_q, pos_k, rel, kpad)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, pos_q, pos_k, rel, kpad, causal, skip_max)
    rel_ptr, rel_hs, rel_rs = cuda_args(name, q, k, v, pos_q, pos_k, rel, kpad, tma=True)
    B, H, T, D = q.shape
    S = k.shape[2]
    q, k, v, pos_q, pos_k = padded_streams(q, k, v, pos_q, pos_k)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = _build.kernel_function("mk_flash_attention_fwd", _FWD_SIG)
    with torch.cuda.device(q.device):
        err = fn(
            int(q.dtype == torch.bfloat16),
            q.data_ptr(), pos_q.data_ptr(), k.data_ptr(), pos_k.data_ptr(), v.data_ptr(),
            rel_ptr, kpad.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, T, S,
            rel_hs, rel_rs, int(causal), int(skip_max), q.shape[-1], _build.stream_of(q),
        )
    _build.check(err, name)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.pair += _build.pair_route(D, q.dtype)
    flash_attention_fwd.deep += _build.head_instance(D) == _build.DEEP
    if out.shape[-1] != D:  # ran on zero-padded copies
        flash_attention_fwd.padded += 1
        out = out[..., :D].contiguous()
    return out, lse


def flash_attention_bwd(q, k, v, pos_q, pos_k, rel, kpad, o, lse, do,
                        causal: bool = False, need_drel: bool = True) -> Grads:
    """K4 → (dq, dk, dv, dpos_q, dpos_k, drel [H, T, S] fp32 or None).

    Plain version on CPU, CUDA kernels on CUDA."""
    name = "flash_attention_bwd"
    check_shapes(name, q, k, v, pos_q, pos_k, rel, kpad)
    need_drel = need_drel and rel is not None
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, pos_q, pos_k, rel, kpad, o, lse, do,
                                         causal, need_drel)
    rel_ptr, rel_hs, rel_rs = cuda_args(name, q, k, v, pos_q, pos_k, rel, kpad, tma=True)
    B, H, T, D = q.shape
    S = k.shape[2]
    _build.require_cuda(name, {"q": q, "o": o, "do": do}, (q.dtype,))
    _build.require_cuda(name, {"lse": lse}, (torch.float32,))
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, H, T):
        raise ValueError(f"{name}: o and do must be [B, H, T, D] like q, lse [B, H, T]")
    if q.dtype == torch.bfloat16 and D % 8 == 0 and (o.data_ptr() % 16 or do.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 o and do must start on 16-byte boundaries (TMA)")
    q, k, v, pos_q, pos_k, o, do = padded_streams(q, k, v, pos_q, pos_k, o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dpq, dpk = torch.empty_like(pos_q), torch.empty_like(pos_k)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    drel = None
    if need_drel:  # bf16: each batch row's dW, then their sum in the first
        drel = torch.empty((B, H, T, S), dtype=torch.float32, device=q.device) \
            if q.dtype == torch.bfloat16 else \
            torch.zeros((H, T, S), dtype=torch.float32, device=q.device)
    fn = _build.kernel_function("mk_flash_attention_bwd", _BWD_SIG)
    with torch.cuda.device(q.device):
        err = fn(
            int(q.dtype == torch.bfloat16),
            q.data_ptr(), pos_q.data_ptr(), k.data_ptr(), pos_k.data_ptr(), v.data_ptr(),
            rel_ptr, kpad.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dpq.data_ptr(), dk.data_ptr(), dpk.data_ptr(),
            dv.data_ptr(), drel.data_ptr() if drel is not None else None,
            B, H, T, S, rel_hs, rel_rs, int(causal), q.shape[-1], _build.stream_of(q),
        )
    _build.check(err, name)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.pair += _build.pair_route(D, q.dtype)
    flash_attention_bwd.deep += _build.head_instance(D) == _build.DEEP
    if drel is not None and drel.dim() == 4:
        drel = drel[0]
    if q.shape[-1] != D:  # ran on zero-padded copies
        flash_attention_bwd.padded += 1
        dq, dk, dv, dpq, dpk = (g[..., :D].contiguous() for g in (dq, dk, dv, dpq, dpk))
    return dq, dk, dv, dpq, dpk, drel


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_fwd.padded = 0  # the launches that ran on zero-padded copies
flash_attention_bwd.padded = 0
flash_attention_fwd.pair = 0  # the bf16 launches on the pair route (D 129 to 256)
flash_attention_bwd.pair = 0
flash_attention_fwd.deep = 0  # the launches on the deep route (D > 256), either dtype
flash_attention_bwd.deep = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FlashAttentionTrainable(torch.autograd.Function):
    """Forward K3, backward K4 (the JAX package's ``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_k, rel, kpad, causal, skip_max):
        o, lse = flash_attention_fwd(q, k, v, pos_q, pos_k, rel, kpad, causal, skip_max)
        ctx.save_for_backward(q, k, v, pos_q, pos_k, rel, kpad, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_q, pos_k, rel, kpad, o, lse = ctx.saved_tensors
        # lse is the same value with or without skip_max, so K4 ignores it
        dq, dk, dv, dpq, dpk, drel = flash_attention_bwd(
            q, k, v, pos_q, pos_k, rel, kpad, o, lse, do.contiguous(), ctx.causal,
            ctx.needs_input_grad[5])
        if drel is not None:
            T, S = drel.shape[1:]
            drel = F.pad(drel, (0, rel.shape[2] - S, 0, rel.shape[1] - T)).to(rel.dtype)
        return dq, dk, dv, dpq, dpk, drel, None, None, None


def flash_attention(q, k, v, pos_q, pos_k, rel, kpad, causal: bool = False,
                    skip_max: bool = False) -> torch.Tensor:
    """Attention with decomposed bias for the model: K1 when autograd tracks no
    input (or grad mode is off), else K3 forward and K4 backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, pos_q, pos_k, rel)):
        return FlashAttentionTrainable.apply(q, k, v, pos_q, pos_k, rel, kpad, causal, skip_max)
    return flash_attention_inference(q, k, v, pos_q, pos_k, rel, kpad, causal, skip_max)
