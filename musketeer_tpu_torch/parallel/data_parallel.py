"""Data-parallel and FSDP training over the mesh's ``data`` and ``fsdp`` axes.

``DataParallel`` is one rank's part of an N-rank run that computes what the
JAX package computes on an N-device mesh of one host with the same global
batch: each rank takes its block of every task batch (``mesh.batch_block``),
and the step normalises by global counts, ranks drop-worst/drop-best over the
global batch, sums the gradients over ranks and takes one global norm.

State layout. Every leaf that ``mesh.leaf_spec`` shards on ``fsdp`` is held
as this rank's contiguous 1/fsdp block along that dim: the fp32 parameters,
both AdamW moments and the EMA shadow alike (the optimizer and the EMA are
elementwise, so they run on the blocks unchanged). A leaf whose dim does not
divide (the 1765-row ``embed_image_positions``) stays replicated, as
``_fit_spec`` says. The step gathers the whole parameter tree once per
update for the forward and reduce-scatters the gradients back to the
blocks; replicated leaves' gradients are all-reduced in one flat buffer.
With ``fsdp`` 1 nothing is sharded and gathering is the identity (DDP).

Collectives run on the process group's backend: NCCL for CUDA tensors, gloo
for CPU tensors (``init_distributed``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..training.train_state import TrainState, global_norm, named_leaves
from .mesh import DATA, FSDP, Mesh, fsdp_dim


def init_distributed(device: torch.device) -> Optional[int]:
    """Join the process group that ``torchrun`` describes (``env://``; NCCL for
    a CUDA ``device``, gloo for the CPU) and return this process's local rank,
    or None when the process was not launched as a rank."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    elif device.type == "cpu":
        dist.init_process_group("gloo")
    else:
        raise ValueError(f"no process-group backend for device {device}")
    return local


def _map_named(fn, tree, prefix: str = ""):
    """``tree`` with ``fn(path, leaf)`` applied to every leaf, with
    ``named_leaves``' paths."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        stage = ".resnet.layer" in f".{prefix}"
        return [_map_named(fn, v, f"{prefix}.{'first' if i == 0 else 'rest'}" if stage else prefix)
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    # convolutions stay channels_last, as params.from_jax lays them out
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t.contiguous()


class DataParallel:
    """This rank's part of a ``data × fsdp`` run (see the module docstring);
    ``params`` is the full parameter tree (or any tree of its shapes)."""

    def __init__(self, mesh: Mesh, params):
        if mesh.size(DATA, FSDP) != mesh.world:
            raise NotImplementedError("the port shards over the data and fsdp axes only")
        self.mesh = mesh
        # a path names one shape (a layer list's entries share theirs), so one dim
        self.dims: Dict[str, Optional[int]] = {
            path: fsdp_dim(path, t.shape, mesh) for path, t in named_leaves(params)}
        self.leaf_dims = [self.dims[path] for path, _ in named_leaves(params)]
        self.nf = mesh.shape[FSDP]
        self.fi = mesh.index(FSDP)
        self.batch_group = mesh.group(DATA, FSDP)
        self.fsdp_group = mesh.group(FSDP)
        self.data_group = mesh.group(DATA)
        self.distributed = self.batch_group is not None

    # -- the batch -----------------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks that share the batch (in place; returned)."""
        if self.distributed:
            dist.all_reduce(t, group=self.batch_group)
        return t

    def gather_rows(self, x: torch.Tensor, copies: int = 1) -> torch.Tensor:
        """A flat per-position vector of this rank's block (``copies`` R-Drop
        copies of it back to back) → the global batch's, in its order: copy by
        copy, each the ranks' blocks in rank order."""
        if not self.distributed:
            return x
        W = self.mesh.size(DATA, FSDP)
        dt = x.dtype
        x = x.to(torch.float32) if dt == torch.bool else x
        out = x.new_empty(W * x.numel())
        dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=self.batch_group)
        out = out.reshape(W, copies, -1).transpose(0, 1).reshape(-1)
        return out.to(dt)

    def local_rows(self, x: torch.Tensor, copies: int = 1) -> torch.Tensor:
        """``gather_rows``' inverse: this rank's positions of a global vector."""
        if not self.distributed:
            return x
        W = self.mesh.size(DATA, FSDP)
        return x.reshape(copies, W, -1)[:, self.mesh.index(DATA, FSDP)].reshape(-1)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.batch_group)

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.batch_group)
        return box[0]

    # -- the state -----------------------------------------------------------

    def shard(self, tree):
        """A full tree (the port's layout) → this rank's blocks of it: copies
        (replicated leaves copied whole) that require grad where the leaves do."""
        def one(path, t):
            d = self.dims[path]
            x = t.detach()
            if d is not None:
                n = x.shape[d] // self.nf
                x = x.narrow(d, self.fi * n, n)
            return _contiguous(x.clone()).requires_grad_(t.requires_grad)

        return _map_named(one, tree)

    def gather(self, tree, requires_grad: bool = False):
        """This rank's blocks → the full tree on every rank (``tree`` itself
        when nothing is sharded). With ``requires_grad`` each full leaf is a
        new autograd leaf (the step's forward)."""
        if self.nf == 1:
            return tree

        def one(path, t):
            d = self.dims[path]
            if d is None:
                full = t.detach()
            else:
                x = t.detach().movedim(d, 0).contiguous()
                out = x.new_empty((self.nf * x.shape[0],) + x.shape[1:])
                dist.all_gather_into_tensor(out, x, group=self.fsdp_group)
                full = _contiguous(out.movedim(0, d))
            return full.requires_grad_(True) if requires_grad else full

        return _map_named(one, tree)

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Full-size gradients (``named_leaves`` order) → the sum over all
        ranks, each in its block's shape:
        reduce-scattered over ``fsdp`` then all-reduced over ``data`` for a
        sharded leaf, all-reduced over both for a replicated one."""
        if not self.distributed:
            return grads
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        rep = []
        for i, (d, g) in enumerate(zip(self.leaf_dims, grads)):
            if d is None:
                rep.append(i)
                continue
            x = g.movedim(d, 0).contiguous()
            r = x.new_empty((x.shape[0] // self.nf,) + x.shape[1:])
            dist.reduce_scatter_tensor(r, x, group=self.fsdp_group)
            if self.mesh.shape[DATA] > 1:
                dist.all_reduce(r, group=self.data_group)
            out[i] = _contiguous(r.movedim(0, d))
        if rep:
            flat = _flatten_dense_tensors([grads[i] for i in rep])
            dist.all_reduce(flat, group=self.batch_group)
            for i, t in zip(rep, _unflatten_dense_tensors(flat, [grads[i] for i in rep])):
                out[i] = t
        return out

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """‖g‖ over the full gradient, from this rank's blocks: the sharded
        leaves' squares summed over ``fsdp`` (in fp64), the replicated ones
        once. Every rank gets the same value."""
        if self.nf == 1 or not self.distributed:
            return global_norm(grads)
        sharded = [d is not None for d in self.leaf_dims]
        sq = [n.square() for n in torch._foreach_norm(list(grads), 2, dtype=torch.float64)]
        zero = sq[0].new_zeros(())
        s = torch.stack([q for q, f in zip(sq, sharded) if f] or [zero]).sum()
        dist.all_reduce(s, group=self.fsdp_group)
        r = torch.stack([q for q, f in zip(sq, sharded) if not f] or [zero]).sum()
        return (s + r).sqrt().float()

    def gather_state(self, state: TrainState) -> TrainState:
        """The full training state (every rank takes part; ``state`` itself
        when nothing is sharded)."""
        if self.nf == 1:
            return state
        opt = state.opt_state
        return state._replace(
            params=self.gather(state.params),
            opt_state={"count": opt["count"], "mu": self.gather(opt["mu"]),
                       "nu": self.gather(opt["nu"])},
            ema_params=None if state.ema_params is None else self.gather(state.ema_params))

    def shard_state(self, state: TrainState) -> TrainState:
        """A full training state → this rank's (``state`` itself when nothing
        is sharded)."""
        if self.nf == 1:
            return state
        opt = state.opt_state
        return state._replace(
            params=self.shard(state.params),
            opt_state={"count": opt["count"], "mu": self.shard(opt["mu"]),
                       "nu": self.shard(opt["nu"])},
            ema_params=None if state.ema_params is None else self.shard(state.ema_params))

    def state_bytes(self, state: TrainState, full: bool = False) -> int:
        """Bytes of this rank's parameters, moments and EMA (``full``: of one
        rank's unsharded state)."""
        scale = [self.nf if full and d is not None else 1 for d in self.leaf_dims]
        return state_bytes(state, scale)


def state_bytes(state: TrainState, scale=None) -> int:
    """Bytes of a training state's parameters, moments and EMA (each leaf's
    times ``scale``'s entry, ``named_leaves`` order)."""
    trees = [state.params, state.opt_state["mu"], state.opt_state["nu"]]
    if state.ema_params is not None:
        trees.append(state.ema_params)
    n = len(named_leaves(state.params))
    scale = scale or [1] * n
    return sum(t.numel() * t.element_size() * k for tree in trees
               for (_, t), k in zip(named_leaves(tree), scale))
