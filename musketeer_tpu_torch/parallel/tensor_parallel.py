"""Tensor parallelism over the mesh's ``model`` axis (Megatron style).

What GSPMD does for the JAX package with the ``MODEL`` entries of
``parallel/mesh.py::_RULES``, written out with two autograd functions over
the model group:

- ``copy_to_model``: identity forward, all-reduce backward. A replicated
  tensor enters the model region through it: the input of a column-split
  linear (``q/k/v_proj``, ``fc1``), and every replicated tensor a rank reads
  only its heads of (the positional projections, the rel tables, ``c_attn``,
  the prompts), so that each rank's gradient of it is the whole one;
- ``reduce_from_model``: all-reduce forward, identity backward. The partial
  products of a row-split linear (``out_proj``, ``fc2``) leave the region
  through it, before the bias is added once.

With them every model rank computes the same replicated activations and the
same loss, holds the whole gradient of every replicated leaf and the exact
gradient of its own shard of a split one, so no gradient is summed over
``model``. ``layer_norm`` normalises an activation whose last dim is split
over the model ranks (NormFormer's ``ffn_layernorm`` over fc1's hidden
units): its mean and variance are sums all-reduced over the group.

Every function is the identity where no mesh splits the model
(``parallel.mesh.get_mesh``), so the model calls them unconditionally.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import MODEL, get_mesh


def model_split() -> Tuple[Optional[object], int, int]:
    """(group, size, index) of the model axis the forward splits over:
    (None, 1, 0) without one."""
    active = get_mesh()
    if active is None or not active.model_split or active.mesh.shape[MODEL] == 1:
        return None, 1, 0
    mesh = active.mesh
    return mesh.group(MODEL), mesh.shape[MODEL], mesh.index(MODEL)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    group, size, _ = model_split()
    return x if size == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    group, size, _ = model_split()
    return x if size == 1 else _ReduceFromModel.apply(x, group)


def local_heads(x: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """This rank's ``heads`` heads of a replicated tensor with all of them
    along ``dim`` (through ``copy_to_model``); ``x`` where they are all."""
    if x.shape[dim] == heads:
        return x
    _, size, index = model_split()
    if x.shape[dim] != heads * size:
        raise ValueError(f"{x.shape[dim]} heads do not split into {size} blocks of {heads}")
    return copy_to_model(x).narrow(dim, index * heads, heads)


def row_linear(p, x: torch.Tensor) -> torch.Tensor:
    """A row-split linear: this rank's slice of the input features times its
    columns of ``w``, summed over the model ranks, plus the whole bias."""
    y = reduce_from_model(F.linear(x, p["w"].to(x.dtype)))
    return y + p["b"].to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over a last dim split over the model ranks (``p``'s scale and
    bias are this rank's block), computed in fp32 and returned in x's dtype:
    the mean and the variance from sums all-reduced over the group (both
    directions of the sum all-reduce: ``copy_to_model`` of
    ``reduce_from_model``)."""
    _, size, _ = model_split()
    if size == 1:
        return F.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"], eps).to(x.dtype)
    xf = x.float()
    n = xf.shape[-1] * size
    total = lambda t: copy_to_model(reduce_from_model(t.sum(-1, keepdim=True)))
    mean = total(xf) / n
    xc = xf - mean
    var = total(xc * xc) / n
    return (xc * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)
