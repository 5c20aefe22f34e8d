"""Training over the whole mesh: the data, fsdp, model, pipe and seq axes.

``DataParallel`` is one rank's part of an N-rank run that computes what the
JAX package computes on an N-device mesh of one host with the same global
batch: each rank takes its block of every task batch (``mesh.batch_block``,
over ``data × fsdp``), and the step normalises by global counts, ranks
drop-worst/drop-best over the global batch, sums the gradients over ranks
and takes one global norm. The ranks of one ``model × pipe × seq`` block
share a batch block and compute one replicated loss (the model's forward
splits over those axes under ``mesh.set_mesh``).

State layout, as ``mesh.leaf_spec`` says, which is the JAX
``param_shardings``' layout. Every leaf the rules shard on ``fsdp`` is held
as this rank's contiguous 1/fsdp block along that dim, and every leaf they
shard on ``model`` as its 1/model block along that one: the fp32
parameters, both AdamW moments and the EMA shadow alike (the optimizer and
the EMA are elementwise, so they run on the blocks unchanged). A leaf whose
dim does not divide (the 1765-row ``embed_image_positions``) stays
replicated, as ``_fit_spec`` says. Over ``pipe`` a rank holds only its
stage's layers of each stack (``mesh.stage_layers``: JAX's contiguous L/P
block, or the stage's chunks under the interleaved schedule) and their rows
of the four ``[L, Vb, H]`` rel-pos tables; a stack whose L does not divide
stays whole. ``seq`` holds the whole state: the rules have no entry for it.

The step gathers the fsdp blocks once per update for the forward. Of the
model-sharded leaves, the ones the model computes on split (``q/k/v_proj``,
``out_proj.w``, ``fc1``, ``fc2.w``, ``ffn_layernorm``) stay this rank's
block, and ``embed_tokens``, which the model uses whole, is gathered over
``model`` too. Gradients: the model axis's Megatron functions give every
model rank the whole gradient of each leaf it uses whole and the exact
gradient of its block of a split one, so nothing is summed over ``model``
(of ``embed_tokens``'s whole gradient a rank keeps its block). Over ``pipe``
and ``seq`` each rank's loss counts 1/(pipe·seq) of the replicated loss. A
stage's layers get their whole gradient over ``pipe`` in the model's
backward (the pipeline's, or ``pipeline.gather_layers``' reduce-scatter),
and are summed over ``data`` and ``seq`` only; every other gradient is
summed over ``pipe`` and ``seq`` (a rank of the ring holds its positions'
part). Over ``data`` the gradients are summed, over ``fsdp``
reduce-scattered to the blocks (summed where a leaf is replicated). With
every axis but ``data`` at 1 this is DDP.

Checkpoints and validation read the whole tree: ``gather(full=True)`` and
``gather_state`` gather the blocks and the stages' layers.

Collectives run on the process group's backend: NCCL for CUDA tensors, gloo
for CPU tensors (``init_distributed``).
"""

from __future__ import annotations

import os
import re
from fractions import Fraction
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..training.train_state import TrainState, global_norm, named_leaves
from .mesh import (
    DATA, FSDP, MODEL, PIPE, SEQ, Mesh, _is_layer_stacked, leaf_spec, sharded_dim, stage_layers,
)
from .pipeline import gather_layers


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
_STACKS = ("encoder", "decoder")  # the layer stacks, by their subtree


def _stack_of(path: str) -> Optional[str]:
    """The layer stack a layer-stacked leaf belongs to (its subtree), else None."""
    return path.split(".", 1)[0] if _is_layer_stacked(path) else None


def _pipe_map(tree, owned: Dict[str, List[int]], layers_fn, table_fn):
    """``tree`` with each stack of ``owned``: its layer list through
    ``layers_fn(side, list)`` and each rel-pos table through
    ``table_fn(side, table)`` (shallow copies; the rest shared)."""
    if not owned:
        return tree
    out = dict(tree)
    for side in owned:
        sub = dict(tree[side])
        sub["layers"] = layers_fn(side, sub["layers"])
        for k in [k for k in sub if k.endswith("rel_pos_table")]:
            sub[k] = table_fn(side, sub[k])
        out[side] = sub
    return out


def _block(x: torch.Tensor, d: int, n: int, i: int) -> torch.Tensor:
    k = x.shape[d] // n
    return x.narrow(d, i * k, k)


class DataParallel:
    """This rank's part of a run over the whole mesh (see the module
    docstring); ``params`` is the full parameter tree (or any tree of its
    shapes), ``cfg`` the model's config, which a mesh with more than one pipe
    stage needs (each stack's interleave fixes the layers a stage holds)."""

    def __init__(self, mesh: Mesh, params, cfg=None):
        self.mesh = mesh
        self.nf, self.fi = mesh.shape[FSDP], mesh.index(FSDP)
        self.nm, self.mi = mesh.shape[MODEL], mesh.index(MODEL)
        self.np = mesh.shape[PIPE]
        # each stack that splits over pipe: every stage's layers, this one's
        self.stages: Dict[str, List[List[int]]] = {}
        layers = {side: len(params[side]["layers"]) for side in _STACKS
                  if side in params and "layers" in params[side]}
        if self.np > 1:
            if cfg is None:
                raise ValueError("a mesh with pipe > 1 needs the model config (the stages' layers)")
            for side, L in layers.items():
                stages = stage_layers(cfg, L, self.np)
                if stages is not None:
                    self.stages[side] = stages
        self.owned = {side: st[mesh.coords[PIPE]] for side, st in self.stages.items()}
        # a path names one shape (a layer list's entries share theirs), so one
        # (fsdp dim, model dim, held by its stage) per path
        self.dims: Dict[str, tuple] = {}
        for path, t in named_leaves(params):
            side = _stack_of(path)
            L = layers.get(side) if ".layers." in path else None
            off = 0 if L is None else 1  # leaf_spec's dim 0 is then the layer list
            fd, md, pd = (sharded_dim(path, t.shape, mesh, axis, L) for axis in (FSDP, MODEL, PIPE))
            if (pd == 0) != (side in self.owned):
                raise AssertionError(f"{path}: leaf_spec {leaf_spec(path, t.shape, mesh, L)} "
                                     f"against the stages {self.stages.get(side)}")
            self.dims[path] = (None if fd is None else fd - off, None if md is None else md - off,
                               pd == 0)
        held = [path for path, _ in named_leaves(self._select_layers(params))]
        self.leaf_dims = [self.dims[path] for path in held]
        self.gathered = {p for p in self.dims if p in _MODEL_GATHERED}
        self.leaf_gathered = [path in self.gathered for path in held]
        if self.nm > 1:
            split = [p for p, (_, m, _) in self.dims.items()
                     if m is not None and p not in self.gathered]
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

    def _select_layers(self, tree):
        """A tree with whole stacks → this stage's layers of each split stack
        (entries shared; no copy)."""
        return _pipe_map(tree, self.owned, lambda side, ls: [ls[i] for i in self.owned[side]],
                         lambda side, t: t)

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
        def rows(side, t):
            idx = torch.as_tensor(self.owned[side], device=t.device)
            return t.detach()[idx].requires_grad_(t.requires_grad)

        def one(path, t):
            fd, md, _ = self.dims[path]
            x = t.detach()
            if fd is not None:
                x = _block(x, fd, self.nf, self.fi)
            if md is not None:
                x = _block(x, md, self.nm, self.mi)
            return _contiguous(x.clone()).requires_grad_(t.requires_grad)

        return _map_named(one, _pipe_map(tree, self.owned,
                                         lambda side, ls: [ls[i] for i in self.owned[side]], rows))

    def _gather_dim(self, x: torch.Tensor, d: int, n: int, group) -> torch.Tensor:
        x = x.movedim(d, 0).contiguous()
        out = x.new_empty((n * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return _contiguous(out.movedim(0, d))

    def _gather_stages(self, tree):
        """Each split stack's stage layers and table rows → the whole stack,
        on every rank (one all-gather a stack over ``pipe``)."""
        out = dict(tree)
        for side, stages in self.stages.items():
            sub = dict(tree[side])
            names = [k for k in sub if k.endswith("rel_pos_table")]
            layers, tables = gather_layers(sub["layers"], [sub[k] for k in names], self.mesh,
                                           stages)
            sub["layers"] = layers
            sub.update(zip(names, tables))
            out[side] = sub
        return out

    def gather(self, tree, requires_grad: bool = False, full: bool = False):
        """This rank's blocks → the tree the forward computes on: the fsdp
        blocks gathered, and over ``model`` the leaves the model uses whole
        (every model-sharded leaf with ``full``, and every stage's layers:
        the whole tree, on every rank). ``tree`` itself when nothing is to
        gather. With ``requires_grad`` each gathered leaf is a new autograd
        leaf (the step's forward, which keeps this stage's layers)."""
        stages = full and bool(self.stages)
        if self.nf == 1 and (self.nm == 1 or not (full or self.gathered)) and not stages:
            return tree

        def one(path, t):
            fd, md, _ = self.dims[path]
            x = t.detach()
            if fd is not None:
                x = self._gather_dim(x, fd, self.nf, self.fsdp_group)
            if md is not None and (full or path in self.gathered):
                x = self._gather_dim(x, md, self.nm, self.model_group)
            return x.requires_grad_(True) if requires_grad and not stages else x

        out = _map_named(one, tree)
        if stages:
            with torch.no_grad():
                out = self._gather_stages(out)
            if requires_grad:
                out = _map_named(lambda _, x: x.requires_grad_(True), out)
        return out

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The forward tree's gradients (``named_leaves`` order) → the sum over
        the ranks (see the module docstring), each in its block's shape."""
        if not self.distributed:
            return grads
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        buckets: Dict[tuple, List[int]] = {}
        for i, ((fd, md, staged), g) in enumerate(zip(self.leaf_dims, grads)):
            if md is not None and self.leaf_gathered[i]:
                g = _block(g, md, self.nm, self.mi)
            if fd is None:
                out[i] = g.contiguous()
                axes = _SUM_REPLICATED
            else:
                x = g.movedim(fd, 0).contiguous()
                r = x.new_empty((x.shape[0] // self.nf,) + x.shape[1:])
                dist.reduce_scatter_tensor(r, x, group=self.fsdp_group)
                out[i] = _contiguous(r.movedim(0, fd))
                axes = _SUM_AFTER_FSDP
            if staged:  # a stage's layer: its whole gradient over pipe is here
                axes = tuple(a for a in axes if a != PIPE)
            buckets.setdefault(axes, []).append(i)
        for axes, idx in buckets.items():
            if self.mesh.size(*axes) == 1:
                continue
            flat = self._sum(_flatten_dense_tensors([out[i] for i in idx]), axes)
            for i, t in zip(idx, _unflatten_dense_tensors(flat, [out[i] for i in idx])):
                out[i] = t
        return out

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """‖g‖ over the full gradient, from this rank's blocks: each leaf's
        squares summed (in fp64) over the ranks that hold its other blocks
        (fsdp, model, and pipe for a stage's layers), a replicated one's
        counted once. Every rank gets the same value."""
        if (self.nf == 1 and self.nm == 1 and not self.stages) or not self.distributed:
            return global_norm(grads)
        sq = [n.square() for n in torch._foreach_norm(list(grads), 2, dtype=torch.float64)]
        parts: Dict[tuple, List[torch.Tensor]] = {}
        for q, (fd, md, staged) in zip(sq, self.leaf_dims):
            axes = tuple(a for a, on in ((FSDP, fd is not None), (MODEL, md is not None),
                                         (PIPE, staged)) if on)
            parts.setdefault(axes, []).append(q)
        total = sq[0].new_zeros(())
        for axes in sorted(parts, key=len):
            s = torch.stack(parts[axes]).sum()
            total = total + (self._sum(s, axes) if axes else s)
        return total.sqrt().float()

    def gather_state(self, state: TrainState) -> TrainState:
        """The full training state (every rank takes part; ``state`` itself
        when nothing is sharded)."""
        if self.nf == 1 and self.nm == 1 and not self.stages:
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
        if self.nf == 1 and self.nm == 1 and not self.stages:
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
                 * (self.np if staged else 1) if full else 1 for fd, md, staged in self.leaf_dims]
        return state_bytes(state, scale)


def reckoned_state_bytes(params, mesh: Mesh, trees: int) -> int:
    """Bytes of one rank's state at its place on ``mesh`` as ``leaf_spec``
    reckons it from the full tree ``params`` alone: each leaf's bytes over the
    sizes of the axes its spec splits it over, ``trees`` times (the
    parameters, two moments, and the EMA)."""
    layers = {side: len(params[side]["layers"]) for side in _STACKS
              if side in params and "layers" in params[side]}
    total = Fraction(0)
    for path, t in named_leaves(params):
        L = layers.get(_stack_of(path)) if ".layers." in path else None
        split = 1
        for axes in leaf_spec(path, t.shape, mesh, L):
            for a in (axes,) if isinstance(axes, str) else tuple(axes or ()):
                split *= mesh.shape[a]
        total += Fraction(t.numel() * t.element_size(), split)
    return int(trees * total)


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
