"""Training over the whole mesh: the data, fsdp, model, pipe and seq axes.

``DataParallel`` is one rank's part of an N-rank run that computes what the
JAX package computes on an N-device mesh of one host with the same global
batch: each rank takes its block of every task batch (``mesh.batch_block``,
over ``data × fsdp``), and the step normalises by global counts, ranks
drop-worst/drop-best over the global batch, sums the gradients over ranks
and takes one global norm. The ranks of one ``model × pipe × seq`` block
share a batch block and compute one replicated loss (the model's forward
splits over those axes under ``mesh.set_mesh``).

State layout, as ``mesh.leaf_spec`` says. Every leaf the rules shard on
``fsdp`` is held as this rank's contiguous 1/fsdp block along that dim, and
every leaf they shard on ``model`` as its 1/model block along that one: the
fp32 parameters, both AdamW moments and the EMA shadow alike (the optimizer
and the EMA are elementwise, so they run on the blocks unchanged). A leaf
whose dim does not divide (the 1765-row ``embed_image_positions``) stays
replicated, as ``_fit_spec`` says. ``seq`` holds the whole state: the rules
have no entry for it. ``pipe`` holds it whole too, which the JAX package does
not: its ``param_shardings`` puts a layer stack's ``L`` axis on ``pipe``, so
a JAX stage holds only its own layers' parameters, moments and EMA. Here
every pipe rank holds and updates every layer (a stage's gradients are zero
on the layers it does not run, and the sum over ``pipe`` below gives every
rank all of them); a deliberate difference, which costs a rank the state of
the layers it does not own (ROADMAP §3).

The step gathers the fsdp blocks once per update for the forward. Of the
model-sharded leaves, the ones the model computes on split (``q/k/v_proj``,
``out_proj.w``, ``fc1``, ``fc2.w``, ``ffn_layernorm``) stay this rank's
block, and ``embed_tokens``, which the model uses whole, is gathered over
``model`` too. Gradients: the model axis's Megatron functions give every
model rank the whole gradient of each leaf it uses whole and the exact
gradient of its block of a split one, so nothing is summed over ``model``
(of ``embed_tokens``'s whole gradient a rank keeps its block). Over ``pipe``
and ``seq`` each rank's loss counts 1/(pipe·seq) of the replicated loss, and
every gradient is summed over them: a stage's layers' gradients live on its
ranks, a rank of the ring holds its positions' part. Over ``data`` the
gradients are summed, over ``fsdp`` reduce-scattered to the blocks (summed
where a leaf is replicated). With every axis but ``data`` at 1 this is DDP.

Collectives run on the process group's backend: NCCL for CUDA tensors, gloo
for CPU tensors (``init_distributed``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..training.train_state import TrainState, global_norm, named_leaves
from .mesh import DATA, FSDP, MODEL, PIPE, SEQ, Mesh, sharded_dim


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


# the leaves the rules shard on model that the model computes on whole
_MODEL_GATHERED = ("embed_tokens",)

_SUM_AFTER_FSDP = (DATA, PIPE, SEQ)  # a block's gradient, after the fsdp reduce-scatter
_SUM_REPLICATED = (DATA, FSDP, PIPE, SEQ)


def _block(x: torch.Tensor, d: int, n: int, i: int) -> torch.Tensor:
    k = x.shape[d] // n
    return x.narrow(d, i * k, k)


class DataParallel:
    """This rank's part of a run over the whole mesh (see the module
    docstring); ``params`` is the full parameter tree (or any tree of its
    shapes)."""

    def __init__(self, mesh: Mesh, params):
        self.mesh = mesh
        self.nf, self.fi = mesh.shape[FSDP], mesh.index(FSDP)
        self.nm, self.mi = mesh.shape[MODEL], mesh.index(MODEL)
        # a path names one shape (a layer list's entries share theirs), so one
        # (fsdp dim, model dim) per path
        self.dims: Dict[str, tuple] = {}
        for path, t in named_leaves(params):
            self.dims[path] = (sharded_dim(path, t.shape, mesh, FSDP),
                               sharded_dim(path, t.shape, mesh, MODEL))
        self.leaf_dims = [self.dims[path] for path, _ in named_leaves(params)]
        self.gathered = {p for p in self.dims if p in _MODEL_GATHERED}
        self.leaf_gathered = [path in self.gathered for path, _ in named_leaves(params)]
        if self.nm > 1:
            split = [p for p, (_, m) in self.dims.items() if m is not None and p not in self.gathered]
            want = [p for p, t in named_leaves(params) if re.search(
                r"(q|k|v)_proj\.(w|b)$|out_proj\.w$|fc1\.(w|b)$|fc2\.w$|ffn_layernorm", p)
                and ".layers." in f".{p}"]
            if sorted(set(split)) != sorted(set(want)):
                raise ValueError(f"model = {self.nm} does not split every head and FFN leaf "
                                 "(the heads, the FFN width and the embedding width must divide)")
        self.batch_group = mesh.group(DATA, FSDP)
        self.fsdp_group = mesh.group(FSDP)
        self.model_group = mesh.group(MODEL)
        self.distributed = mesh.world > 1
        # each rank's share of the loss its model x pipe x seq block replicates
        self.loss_scale = 1.0 / mesh.size(PIPE, SEQ)

    # -- the batch -----------------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks that split the batch (in place; returned)."""
        if self.mesh.size(DATA, FSDP) > 1:
            dist.all_reduce(t, group=self.batch_group)
        return t

    def gather_rows(self, x: torch.Tensor, copies: int = 1) -> torch.Tensor:
        """A flat per-position vector of this rank's block (``copies`` R-Drop
        copies of it back to back) → the global batch's, in its order: copy by
        copy, each the ranks' blocks in rank order."""
        W = self.mesh.size(DATA, FSDP)
        if W == 1:
            return x
        dt = x.dtype
        x = x.to(torch.float32) if dt == torch.bool else x
        out = x.new_empty(W * x.numel())
        dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=self.batch_group)
        out = out.reshape(W, copies, -1).transpose(0, 1).reshape(-1)
        return out.to(dt)

    def local_rows(self, x: torch.Tensor, copies: int = 1) -> torch.Tensor:
        """``gather_rows``' inverse: this rank's positions of a global vector."""
        W = self.mesh.size(DATA, FSDP)
        if W == 1:
            return x
        return x.reshape(copies, W, -1)[:, self.mesh.index(DATA, FSDP)].reshape(-1)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        if self.mesh.size(*axes) > 1:
            dist.all_reduce(t, group=self.mesh.group(*axes))
        return t

    # -- the state -----------------------------------------------------------

    def shard(self, tree):
        """A full tree (the port's layout) → this rank's blocks of it: copies
        (replicated leaves copied whole) that require grad where the leaves do."""
        def one(path, t):
            fd, md = self.dims[path]
            x = t.detach()
            if fd is not None:
                x = _block(x, fd, self.nf, self.fi)
            if md is not None:
                x = _block(x, md, self.nm, self.mi)
            return _contiguous(x.clone()).requires_grad_(t.requires_grad)

        return _map_named(one, tree)

    def _gather_dim(self, x: torch.Tensor, d: int, n: int, group) -> torch.Tensor:
        x = x.movedim(d, 0).contiguous()
        out = x.new_empty((n * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return _contiguous(out.movedim(0, d))

    def gather(self, tree, requires_grad: bool = False, full: bool = False):
        """This rank's blocks → the tree the forward computes on: the fsdp
        blocks gathered, and over ``model`` the leaves the model uses whole
        (every model-sharded leaf with ``full``: the whole tree, on every
        rank). ``tree`` itself when nothing is to gather. With
        ``requires_grad`` each gathered leaf is a new autograd leaf (the
        step's forward)."""
        if self.nf == 1 and (self.nm == 1 or not (full or self.gathered)):
            return tree

        def one(path, t):
            fd, md = self.dims[path]
            x = t.detach()
            if fd is not None:
                x = self._gather_dim(x, fd, self.nf, self.fsdp_group)
            if md is not None and (full or path in self.gathered):
                x = self._gather_dim(x, md, self.nm, self.model_group)
            return x.requires_grad_(True) if requires_grad else x

        return _map_named(one, tree)

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The forward tree's gradients (``named_leaves`` order) → the sum over
        the ranks (see the module docstring), each in its block's shape."""
        if not self.distributed:
            return grads
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        buckets: Dict[tuple, List[int]] = {_SUM_AFTER_FSDP: [], _SUM_REPLICATED: []}
        for i, ((fd, md), g) in enumerate(zip(self.leaf_dims, grads)):
            if md is not None and self.leaf_gathered[i]:
                g = _block(g, md, self.nm, self.mi)
            if fd is None:
                out[i] = g.contiguous()
                buckets[_SUM_REPLICATED].append(i)
                continue
            x = g.movedim(fd, 0).contiguous()
            r = x.new_empty((x.shape[0] // self.nf,) + x.shape[1:])
            dist.reduce_scatter_tensor(r, x, group=self.fsdp_group)
            out[i] = _contiguous(r.movedim(0, fd))
            buckets[_SUM_AFTER_FSDP].append(i)
        for axes, idx in buckets.items():
            if not idx or self.mesh.size(*axes) == 1:
                continue
            flat = self._sum(_flatten_dense_tensors([out[i] for i in idx]), axes)
            for i, t in zip(idx, _unflatten_dense_tensors(flat, [out[i] for i in idx])):
                out[i] = t
        return out

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """‖g‖ over the full gradient, from this rank's blocks: each leaf's
        squares summed (in fp64) over the ranks that hold its other blocks
        (fsdp, model or both), a replicated one's counted once. Every rank
        gets the same value."""
        if (self.nf == 1 and self.nm == 1) or not self.distributed:
            return global_norm(grads)
        sq = [n.square() for n in torch._foreach_norm(list(grads), 2, dtype=torch.float64)]
        zero = sq[0].new_zeros(())
        total = zero
        for axes in ((), (FSDP,), (MODEL,), (FSDP, MODEL)):
            part = [q for q, (fd, md) in zip(sq, self.leaf_dims)
                    if ((fd is not None), (md is not None)) == (FSDP in axes, MODEL in axes)]
            s = torch.stack(part or [zero]).sum()
            total = total + (self._sum(s, axes) if axes else s)
        return total.sqrt().float()

    def gather_state(self, state: TrainState) -> TrainState:
        """The full training state (every rank takes part; ``state`` itself
        when nothing is sharded)."""
        if self.nf == 1 and self.nm == 1:
            return state
        g = lambda tree: self.gather(tree, full=True)
        opt = state.opt_state
        return state._replace(
            params=g(state.params),
            opt_state={"count": opt["count"], "mu": g(opt["mu"]), "nu": g(opt["nu"])},
            ema_params=None if state.ema_params is None else g(state.ema_params))

    def shard_state(self, state: TrainState) -> TrainState:
        """A full training state → this rank's (``state`` itself when nothing
        is sharded)."""
        if self.nf == 1 and self.nm == 1:
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
        scale = [(self.nf if fd is not None else 1) * (self.nm if md is not None else 1)
                 if full else 1 for fd, md in self.leaf_dims]
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
