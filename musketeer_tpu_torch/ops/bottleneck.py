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
Its forward runs the plain PyTorch version for CPU tensors and the CUDA
kernel (``csrc/bottleneck.cu``) for CUDA tensors, never falling back from one
to the other, and counts its launches. Its backward recomputes the block
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
_SIG = (_build.INT,) + (_build.PTR,) * 6 + (_build.INT,) * 5 + (_build.PTR,)
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
    """K8's forward: plain version on CPU, the CUDA kernel on CUDA."""
    name = "fused_bottleneck"
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _build.require_cuda(name, {"x": x}, _DTYPES)
    w1, w2, w3 = _weights(p, x.dtype)
    aff = torch.cat([t for i in (1, 2, 3) for t in fold_bn(p[f"bn{i}"])])
    if aff.device != x.device or w1.device != x.device:
        raise ValueError(f"{name}: the block's parameters must be on x's device")
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    fn = _build.kernel_function("mk_fused_bottleneck", _SIG)
    with torch.cuda.device(x.device):
        err = fn(int(x.dtype == torch.bfloat16), x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 w3.data_ptr(), aff.data_ptr(), out.data_ptr(), B, H, W, C, w1.shape[1],
                 _build.stream_of(x))
    _build.check(err, name)
    fused_bottleneck.launches += 1
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
