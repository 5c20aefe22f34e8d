"""ResNet image embedder in frozen-BN inference mode (port of ``models/resnet.py``).

conv 7×7/s2 → maxpool 3/2/1 → layer1..3 (stride 16, 1024 channels, no layer4).
The JAX package computes the stem as a space-to-depth conv, a TPU layout
trick with the same sums; here it is the plain 7×7 / stride 2 / pad 3 conv.
Convolutions are cuDNN (``F.conv2d``) in ``channels_last``; BatchNorm uses the
stored statistics and runs in fp32, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

BN_EPS = 1e-5


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    # explicit torch-style padding kernel//2, as the JAX package pads
    return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Frozen BatchNorm; fp32 statistics and arithmetic, output in x's dtype."""
    return F.batch_norm(x, p["mean"], p["var"], p["scale"], p["bias"],
                        training=False, eps=BN_EPS)


def _bottleneck(x: torch.Tensor, p: Params, stride: int = 1) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = F.relu(_bn(_conv(out, p["conv2"], stride), p["bn2"]))
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    identity = x
    if "downsample_conv" in p:
        identity = _bn(_conv(x, p["downsample_conv"], stride), p["downsample_bn"])
    return F.relu(identity + out)


def resnet_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC) → features [B, H/16, W/16, 1024] (NHWC)."""
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = F.relu(_bn(_conv(x, params["conv1"], stride=2), params["bn1"]))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for s, stride in ((1, 1), (2, 2), (3, 2)):
        blocks = params[f"layer{s}"]
        x = _bottleneck(x, blocks[0], stride)
        for p in blocks[1:]:
            x = _bottleneck(x, p)
    return x.permute(0, 2, 3, 1)
