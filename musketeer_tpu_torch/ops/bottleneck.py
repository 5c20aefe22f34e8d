"""K8: the fused ResNet bottleneck block (frozen BN, stride 1, no downsample).

Port of ``musketeer_tpu/ops/bottleneck.py``: ``fused_bottleneck`` and its
custom VJP, whose forward is the Pallas ``_kernel`` (through
``_fused_forward``). It computes the stride-1 "rest" blocks of every ResNet
stage in one pass,

    relu(x + bn3(conv3(relu(bn2(conv2₃ₓ₃(relu(bn1(conv1(x)))))))))

with frozen BN folded to per-channel fp32 affines ``y·g + b`` (``fold_bn``)
and the TPU kernel's roundings: each convolution sums in fp32 from
compute-dtype inputs and rounds to the compute dtype, the affine runs in fp32
and rounds (after the relu where there is one), conv2's nine taps are summed
before a single rounding, conv2's zero padding applies to h1 after bn1 and
relu, and the residual ``x + y`` is added in the compute dtype. This is the
folded form, not ``models/resnet.py::_bn``'s ``(x − mean)·inv + bias``: the
two differ by fp32 rounding before each cast.

``fused_bottleneck(x, p)`` takes x ``[B, H, W, C]`` in the JAX package's NHWC
layout (``x.permute(0, 2, 3, 1)`` of the port's channels_last NCHW
activations, with no copy) and the port's block dict, as ``from_jax`` builds
it (``resnet["layerN"][i]``) or ``params.block_from_jax`` carries one JAX
block across: OIHW convolutions, fp32 BN ``scale``/``bias``/``mean``/``var``.
Its forward picks its version by ``_build.route``: the plain PyTorch version
for CPU tensors, the FMA kernel (``csrc/bottleneck.cu``) for fp32 CUDA
tensors, the tensor-core kernel (``csrc/bottleneck_sm90.cuh``: implicit GEMM
on ``wgmma`` fed by TMA, h1 and h2 in shared memory; ``sm90_plan``) for bf16
ones, never falling back from one to another. It counts its launches
(``fused_bottleneck.launches``, and ``.launches_sm90`` for the tensor-core
route). Its backward recomputes the block
through ``models/resnet.py::_bottleneck`` with the BN statistics tracked and
differentiates that, as the JAX custom VJP does through its XLA block: there
is no backward kernel, so x and every leaf of the block get the unfused
block's gradients.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..models.resnet import BN_EPS, _bottleneck
from ..params import BN_KEYS
from . import _build

Params = Dict[str, Any]

_DTYPES = (torch.float32, torch.bfloat16)
_SIG = (_build.INT,) + (_build.PTR,) * 6 + (_build.INT,) * 7 + (_build.PTR,)
# the tensor-core kernel's tile (output rows × columns), halo pixels, ring
# stages and their bytes (csrc/bottleneck_sm90.cuh)
SM90_TILE = (16, 8)
SM90_HALO = (SM90_TILE[0] + 2) * (SM90_TILE[1] + 2)
SM90_MAX_STAGES = 8
SM_SMEM = 233472  # shared memory of an SM on sm_90
_WSTAGE = 128 * 64 * 2  # a ring stage: 128 weight rows × 64 deep, bf16
_XSLOT = 192 * 64 * 2  # one of conv1's two x chunk slots: the halo's 180 rows, padded to 192
# the block's leaves in the order the autograd Function takes them
_LEAVES = ("conv1", "conv2", "conv3") + tuple(
    f"bn{i}/{k}" for i in (1, 2, 3) for k in BN_KEYS)


def fold_bn(bn: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen BN → per-channel fp32 (g, b) with ``bn(y) = y·g + b``."""
    g = bn["scale"] * torch.rsqrt(bn["var"] + BN_EPS)
    b = bn["bias"] - bn["mean"] * g
    return g.float(), b.float()


def _weights(p: Params, dtype: torch.dtype):
    """OIHW convolutions → w1 [C, Wd], w2 [3, 3, Wd, Wd] (HWIO), w3 [Wd, C] in ``dtype``."""
    w1 = p["conv1"][:, :, 0, 0].t().to(dtype).contiguous()
    w2 = p["conv2"].permute(2, 3, 1, 0).to(dtype).contiguous()
    w3 = p["conv3"][:, :, 0, 0].t().to(dtype).contiguous()
    return w1, w2, w3


def _bn_vector(p: Params) -> torch.Tensor:
    """The block's three frozen BNs as one fp32 vector: scale, var, bias and
    mean, each of bn1, bn2, bn3 (``mk_fold_bn``'s input)."""
    return torch.cat([p[f"bn{i}"][k] for k in ("scale", "var", "bias", "mean")
                      for i in (1, 2, 3)]).float()


def _affines(p: Params) -> torch.Tensor:
    """The three folded BNs as the kernels take them, one fp32 vector on the
    card: g1, g2, g3, then b1, b2, b3, folded by one kernel launch
    (``fold_bn``'s arithmetic, element by element)."""
    bn = _bn_vector(p)
    n = bn.numel() // 4
    aff = torch.empty(2 * n, dtype=torch.float32, device=bn.device)
    fn = _build.kernel_function("mk_fold_bn", (_build.PTR, _build.PTR, _build.INT, _build.PTR))
    with torch.cuda.device(bn.device):
        _build.check(fn(bn.data_ptr(), aff.data_ptr(), n, _build.stream_of(bn)), "fold_bn")
    return aff


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def sm90_smem(Wd: int, stages: int) -> int:
    """Shared memory of the tensor-core kernel (``smem_bytes``): h1 [Wd'/8][180][8]
    and the region h2 [Wd'/8][128][8] shares with conv1's two x slots, each
    rounded to 1 KB (Wd' = Wd rounded up to 64), the ring's 16 KB stages, the
    affines in fp32 and the 22 mbarriers, with 1 KB of alignment slack."""
    wdp = _round_up(Wd, 64)
    h1 = _round_up(SM90_HALO * wdp * 2, 1024)
    region = _round_up(max(SM90_TILE[0] * SM90_TILE[1] * wdp * 2, 2 * _XSLOT), 1024)
    affines = 16 * wdp + 2 * 2 * 128 * 4  # g1, b1, g2, b2; each warpgroup's g3, b3 pass slice
    return 1024 + h1 + region + stages * _WSTAGE + affines + 8 * (2 * SM90_MAX_STAGES + 6)


def sm90_plan(B: int, H: int, W: int, C: int, Wd: int) -> Dict[str, Any]:
    """The tensor-core kernel's launch: ``nb`` columns a conv2 pass (128, or
    64 where Wd ≤ 64, which runs two CTAs an SM), the most ring ``stages``
    (≤ 8, ≥ 2) whose ``smem`` fits a block's share of the SM's shared
    memory, and the ``grid`` of 16 × 8 pixel
    tiles (W tiles, H tiles, B). Raises where even two stages do not fit
    (Wd > 256) or a width is not a multiple of 8."""
    if C % 8 or Wd % 8:
        raise ValueError(f"fused_bottleneck: C {C} and Wd {Wd} must be multiples of 8 "
                         "(16-byte rows for TMA)")
    ctas = 2 if Wd <= 64 else 1  # CTAs an SM (the kernel's launch bounds)
    room = min(_build.SMEM_MAX, SM_SMEM // ctas - 1024)  # 1 KB of each CTA's is the system's
    fits = [n for n in range(SM90_MAX_STAGES, 1, -1) if sm90_smem(Wd, n) <= room]
    if not fits:
        raise ValueError(f"fused_bottleneck: Wd {Wd} leaves h1 and h2 no room in shared memory "
                         f"({sm90_smem(Wd, 2)} > {_build.SMEM_MAX} bytes)")
    th, tw = SM90_TILE
    return dict(nb=64 if Wd <= 64 else 128, stages=fits[0], smem=sm90_smem(Wd, fits[0]),
                grid=(-(-W // tw), -(-H // th), B))


def sm90_weights(p: Params) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OIHW convolutions → the tensor-core kernel's K-major B operands in bf16:
    w1 [Wd, C] and w3 [C, Wd] (conv1's and conv3's own layout, a view where
    they are bf16 already), w2 [3, 3, Wd, Wd] (tap, out, in)."""
    Wd, C = p["conv1"].shape[:2]
    bf = torch.bfloat16
    w1 = p["conv1"].reshape(Wd, C).to(bf).contiguous()
    w2 = p["conv2"].permute(2, 3, 0, 1).to(bf).contiguous()
    w3 = p["conv3"].reshape(C, Wd).to(bf).contiguous()
    return w1, w2, w3


def _route(device: torch.device, x: torch.Tensor, weights: Tuple[torch.Tensor, ...] = ()) -> str:
    """The version ``fused_bottleneck`` runs (``_build.route``): ``"plain"`` on
    the CPU, ``"fma"`` for fp32 x, ``"sm90"`` for bf16 x, whose x and laid-out
    weights (``sm90_weights``, where given) must then be TMA-aligned."""
    return _build.route("fused_bottleneck", device, x.dtype,
                        {"x": x, **{f"w{i + 1}": w for i, w in enumerate(weights)}})


def _check(x: torch.Tensor, p: Params) -> None:
    name = "fused_bottleneck"
    if "downsample_conv" in p:
        raise ValueError(f"{name}: the fused block has no downsample branch")
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [B, H, W, C]")
    C, Wd = x.shape[3], p["conv1"].shape[0]
    for arg, shape in (("conv1", (Wd, C, 1, 1)), ("conv2", (Wd, Wd, 3, 3)),
                       ("conv3", (C, Wd, 1, 1))):
        if tuple(p[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(p[arg].shape)} != {shape}")


def fused_bottleneck_plain(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The plain version of K8 (the CPU path and the kernel's reference):
    x [B, H, W, C] → [B, H, W, C] in x's dtype."""
    cdt = x.dtype
    H, W = x.shape[1:3]
    w1, w2, w3 = (w.float() for w in _weights(p, cdt))
    (g1, b1), (g2, b2), (g3, b3) = (fold_bn(p[f"bn{i}"]) for i in (1, 2, 3))

    def bn(acc, g, b):  # the fp32 sum rounded to the compute dtype, then the affine
        return acc.to(cdt).float() * g + b

    h1 = torch.relu(bn(x.float() @ w1, g1, b1)).to(cdt)
    h1 = F.pad(h1, (0, 0, 1, 1, 1, 1)).float()  # conv2's zero padding, after bn1 and relu
    acc = sum(h1[:, dy:dy + H, dx:dx + W] @ w2[dy, dx] for dy in range(3) for dx in range(3))
    h2 = torch.relu(bn(acc, g2, b2)).to(cdt)
    y = bn(h2.float() @ w3, g3, b3).to(cdt)
    return torch.relu(x + y)


def _forward(x: torch.Tensor, p: Params) -> torch.Tensor:
    """K8's forward: plain version on the CPU, the FMA kernel for fp32 CUDA
    tensors, the tensor-core kernel for bf16 ones."""
    name = "fused_bottleneck"
    kind = _route(x.device, x)
    if kind == "plain":
        return fused_bottleneck_plain(x, p)
    _build.require_cuda(name, {"x": x}, _DTYPES)
    B, H, W, C = x.shape
    Wd = p["conv1"].shape[0]
    nb = stages = 0
    if kind == "sm90":
        plan = sm90_plan(B, H, W, C, Wd)
        nb, stages = plan["nb"], plan["stages"]
        w1, w2, w3 = sm90_weights(p)
        _route(x.device, x, (w1, w2, w3))
    else:
        w1, w2, w3 = _weights(p, x.dtype)
    aff = _affines(p)
    if aff.device != x.device or w1.device != x.device:
        raise ValueError(f"{name}: the block's parameters must be on x's device")
    out = torch.empty_like(x)
    fn = _build.kernel_function("mk_fused_bottleneck", _SIG)
    with torch.cuda.device(x.device):
        err = fn(int(kind == "sm90"), x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                 aff.data_ptr(), out.data_ptr(), B, H, W, C, Wd, nb, stages, _build.stream_of(x))
    _build.check(err, name)
    fused_bottleneck.launches += 1
    if kind == "sm90":
        fused_bottleneck.launches_sm90 += 1
    return out


def _flat(p: Params) -> List[torch.Tensor]:
    return [p[n] if "/" not in n else p[n.split("/")[0]][n.split("/")[1]] for n in _LEAVES]


def _unflat(leaves) -> Params:
    p: Params = {}
    for n, t in zip(_LEAVES, leaves):
        if "/" in n:
            bn, k = n.split("/")
            p.setdefault(bn, {})[k] = t
        else:
            p[n] = t
    return p


class FusedBottleneck(torch.autograd.Function):
    """Forward K8; backward the unfused block's, recomputed (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, x, *leaves):
        ctx.save_for_backward(x, *leaves)
        return _forward(x, _unflat(leaves))

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            # every leaf requires grad, so _bn takes the JAX arithmetic and
            # mean and var get the JAX step's gradients
            x, *leaves = inputs
            out = _bottleneck(x.permute(0, 3, 1, 2), _unflat(leaves)).permute(0, 2, 3, 1)
            grads = torch.autograd.grad(out, inputs, g)
        return tuple(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad))


def fused_bottleneck(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Fused frozen-BN bottleneck (stride 1, no downsample): x [B, H, W, C] (NHWC)
    and the port's block dict → [B, H, W, C] in x's dtype."""
    _check(x, p)
    return FusedBottleneck.apply(x, *_flat(p))


fused_bottleneck.launches = 0
fused_bottleneck.launches_sm90 = 0
