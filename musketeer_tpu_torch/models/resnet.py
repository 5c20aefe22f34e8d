"""ResNet image embedder with frozen or batch-statistics BatchNorm (port of
``models/resnet.py``).

conv 7×7/s2 → maxpool 3/2/1 → layer1..3 (stride 16, 1024 channels, no layer4).
The JAX package computes the stem as a space-to-depth conv, a TPU layout
trick with the same sums; here it is the plain 7×7 / stride 2 / pad 3 conv.
Convolutions are cuDNN (``F.conv2d``) in ``channels_last``, with the weights
cast to the activations' dtype where they are used (a no-op on an inference
tree, whose weights are stored in the compute dtype).

BatchNorm uses the stored statistics and runs in fp32, as the JAX package
does; ``train=True`` (the encoder's ``train_bn``) normalises with the batch's
own statistics instead, the mean and biased variance over batch and space, as
``_bn(train=True)`` does, and leaves the stored ones as they are. When autograd tracks the statistics (a training tree), it is written
as the JAX arithmetic ``(x − mean)·rsqrt(var + eps)·scale + bias``, so that
``mean`` and ``var`` get the JAX step's gradients: the JAX package keeps them
as leaves of the parameter tree and its optimizer moves them (ROADMAP §3).
Otherwise it is the single fused ``F.batch_norm``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

BN_EPS = 1e-5


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    # explicit torch-style padding kernel//2, as the JAX package pads
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bn(x: torch.Tensor, p: Params, train: bool = False) -> torch.Tensor:
    """BatchNorm with fp32 statistics and arithmetic, output in x's dtype:
    the stored statistics, or with ``train`` the batch's."""
    if train:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        inv = (torch.rsqrt(var + BN_EPS) * p["scale"])[:, None, None]
        return ((xf - mean[:, None, None]) * inv + p["bias"][:, None, None]).to(x.dtype)
    if torch.is_grad_enabled() and p["mean"].requires_grad:
        inv = (torch.rsqrt(p["var"] + BN_EPS) * p["scale"])[:, None, None]
        out = (x.float() - p["mean"][:, None, None]) * inv + p["bias"][:, None, None]
        return out.to(x.dtype)
    return F.batch_norm(x, p["mean"], p["var"], p["scale"], p["bias"],
                        training=False, eps=BN_EPS)


def _bottleneck(x: torch.Tensor, p: Params, stride: int = 1, train: bool = False) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, p["conv1"]), p["bn1"], train))
    out = F.relu(_bn(_conv(out, p["conv2"], stride), p["bn2"], train))
    out = _bn(_conv(out, p["conv3"]), p["bn3"], train)
    identity = x
    if "downsample_conv" in p:
        identity = _bn(_conv(x, p["downsample_conv"], stride), p["downsample_bn"], train)
    return F.relu(identity + out)


# (stage, stride of its first block)
STAGES = ((1, 1), (2, 2), (3, 2))


def stem(params: Params, images: torch.Tensor, train: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC) → conv 7×7/s2, BN, relu, maxpool: [B, 64, H/4, W/4]
    (NCHW, channels_last)."""
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = F.relu(_bn(_conv(x, params["conv1"], stride=2), params["bn1"], train))
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def resnet_forward(params: Params, images: torch.Tensor, train: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC) → features [B, H/16, W/16, 1024] (NHWC);
    ``train`` normalises with batch statistics."""
    x = stem(params, images, train)
    for s, stride in STAGES:
        blocks = params[f"layer{s}"]
        x = _bottleneck(x, blocks[0], stride, train)
        for p in blocks[1:]:
            x = _bottleneck(x, p, train=train)
    return x.permute(0, 2, 3, 1)
