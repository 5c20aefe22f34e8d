"""The mesh's five named axes over ``torch.distributed`` ranks, and the
parameter sharding rules (port of ``musketeer_tpu/parallel/mesh.py``).

Axes, as in the JAX package:
  data  — batch sharding (DDP: each rank takes its block of every batch and
          the gradients are summed over ranks)
  fsdp  — parameter and optimizer-state sharding (ZeRO/FSDP): each leaf the
          rules shard on ``fsdp`` is held as 1/fsdp per rank
  model — tensor parallelism (Megatron): attention heads and the FFN's
          hidden units split over ranks (``tensor_parallel.py``)
  pipe  — pipeline parallelism: the layer stacks split into stages, GPipe or
          interleaved (``pipeline.py``)
  seq   — sequence parallelism: ring attention over the sequence's chunks
          (``ring_attention.py``)

The ranks of one ``model × pipe × seq`` block share a batch block
(``batch_block``) and compute one replicated loss. ``set_mesh`` makes a mesh
the one the model's forward splits over, as ``jax.set_mesh`` does for the
JAX model; ``get_mesh`` reads it.

``make_mesh`` lays ranks out as the JAX ``make_mesh`` lays out devices: rank
r sits at the row-major coordinate of r in ``(data, fsdp, model, pipe,
seq)``. The batch axis is split over ``(data, fsdp)`` jointly, as
``P((DATA, FSDP))`` splits it over devices (``batch_block``).

``_RULES``, ``param_spec``, ``_fit_spec`` and ``_is_layer_stacked`` are the
JAX package's, with specs as tuples of axis names (None: not sharded)
instead of ``PartitionSpec``s; they read the JAX layout (stacked ``[L, ...]``
layers, ``[din, dout]`` linears, HWIO convolutions). ``leaf_spec`` gives the
spec that the JAX ``param_shardings`` gives, for a leaf of the port's tree in
the port's layout: a layer stack's ``L`` axis on ``pipe`` (each stage holds
its own layers, and its rows of the four ``[L, Vb, H]`` rel-pos tables), the
other dims as the rules say. ``stage_layers`` says which layers each stage
holds: JAX's contiguous ``L/P`` block, or under the interleaved schedule the
stage's ``V`` chunks of ``L/(P·V)``, the layers it runs (the same bytes; JAX
holds the block and permutes the layers inside each step).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..config import MeshConfig

DATA, FSDP, MODEL, PIPE, SEQ = "data", "fsdp", "model", "pipe", "seq"
AXES = (DATA, FSDP, MODEL, PIPE, SEQ)

Spec = Tuple  # one entry per dim: None, an axis name, or a tuple of axis names


class Mesh:
    """This rank's place on the five axes, and a process group per set of
    axes (None where the set spans one rank, and without a process group)."""

    def __init__(self, sizes: Sequence[int], rank: int, groups: Dict[frozenset, object]):
        self.shape: Dict[str, int] = dict(zip(AXES, sizes))
        self.rank = rank
        self.world = math.prod(sizes)
        self.coords: Dict[str, int] = dict(zip(AXES, np.unravel_index(rank, tuple(sizes))))
        self._groups = groups
        # the pipeline's clock and last collective on this rank (read when a run hangs)
        self.progress: Dict[str, object] = {}

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's row-major index over ``axes`` (in the mesh's axis order)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only along
        ``axes``; None where they are this rank alone."""
        return self._groups.get(_key(self.shape, axes))

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords`` replaced."""
        c = {**self.coords, **coords}
        return int(np.ravel_multi_index(tuple(c[a] for a in AXES), tuple(self.shape[a] for a in AXES)))


def _key(shape: Dict[str, int], axes) -> frozenset:
    """A set of axes by the axes in it that span more than one rank (two sets
    that differ only by axes of size 1 name the same group)."""
    return frozenset(a for a in axes if shape[a] > 1)


# the sets of axes the port communicates over: each axis, the batch (data x
# fsdp), the norm's (a leaf's squares over the axes that split it: fsdp, model
# and pipe), and the gradient sums' (data x pipe x seq after fsdp's
# reduce-scatter, data x fsdp x pipe x seq for a replicated leaf; a stage's
# layer leaves without pipe)
_GROUP_AXES = ((DATA,), (FSDP,), (MODEL,), (PIPE,), (SEQ,), (DATA, FSDP), (FSDP, MODEL),
               (FSDP, PIPE), (MODEL, PIPE), (FSDP, MODEL, PIPE),
               (DATA, PIPE, SEQ), (DATA, FSDP, PIPE, SEQ), (DATA, SEQ), (DATA, FSDP, SEQ))


def make_mesh(cfg: MeshConfig = MeshConfig(), world: Optional[int] = None) -> Mesh:
    """The mesh over the process group's ranks (one rank without one), with
    ``cfg.axis_sizes(world)``; every rank must call it, in the same order."""
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    sizes = cfg.axis_sizes(world)
    rank = dist.get_rank() if initialized else 0
    shape = dict(zip(AXES, sizes))
    groups: Dict[frozenset, object] = {}
    if initialized:
        ranks = np.arange(world).reshape(sizes)
        for key in dict.fromkeys(_key(shape, axes) for axes in _GROUP_AXES):
            if not key:
                continue
            keep = [i for i, a in enumerate(AXES) if a in key]
            rest = [i for i in range(len(AXES)) if i not in keep]
            blocks = ranks.transpose(rest + keep).reshape(-1, math.prod(sizes[i] for i in keep))
            for block in blocks:
                g = dist.new_group(block.tolist())  # collective: every rank makes every group
                if rank in block:
                    groups[key] = g
    return Mesh(sizes, rank, groups)


class Active:
    """What the model's forward splits over: ``mesh``; ``model_split``, that
    the parameter tree holds this rank's model shard (a gathered tree runs
    replicated over ``model``); ``batch_local``, that the batch is this rank's
    block (a validation batch is the same on every rank)."""

    def __init__(self, mesh: Mesh, model_split: bool = True, batch_local: bool = True):
        self.mesh = mesh
        self.model_split = model_split
        self.batch_local = batch_local


_ACTIVE: list = [None]


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh], model_split: bool = True,
             batch_local: bool = True) -> Iterator[None]:
    """Within the block, ``get_mesh()`` is ``mesh`` (None: no mesh)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = None if mesh is None else Active(mesh, model_split, batch_local)
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def get_mesh() -> Optional[Active]:
    return _ACTIVE[0]


def batch_block(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of a batch axis of ``n`` rows, as
    ``P((DATA, FSDP))`` gives device r its block."""
    parts = mesh.size(DATA, FSDP)
    if n % parts:
        raise ValueError(f"batch of {n} rows does not split over data x fsdp = {parts} ranks")
    k = n // parts
    i = mesh.index(DATA, FSDP)
    return slice(i * k, (i + 1) * k)


_NO_BATCH_AXIS = ("patch_norm",)  # [A, 2, 3]: one affine per micro-batch


def shard_batches(batches, mesh: Mesh):
    """The joint loader's step (task → TaskBatch with a leading accumulation
    axis A and the batch axis second) → this rank's block of every batch."""
    out = {}
    for name, b in batches.items():
        block = batch_block(b.src_tokens.shape[1], mesh)
        out[name] = type(b)(*[x if x is None or f in _NO_BATCH_AXIS else x[:, block]
                              for f, x in zip(b._fields, b)])
    return out


# ---------------------------------------------------------------------------
# parameter sharding rules (the JAX package's, in the JAX layout)
# ---------------------------------------------------------------------------
# Rules are matched against the flattened param path. First match wins.
# Layer-stacked leaves have a leading L axis, which the rules never shard
# (param_shardings puts it on pipe: leaf_spec below).
#
# Tensor-parallel choices (standard Megatron layout):
#   attention q/k/v: out dim (heads) on MODEL;   out_proj: in dim on MODEL
#   fc1: out dim on MODEL;                        fc2: in dim on MODEL
#   embed_tokens: vocab dim on FSDP (all-gathered once per step)
# FSDP shards the largest remaining dim of every big leaf.

_RULES = [
    # path regex, spec builder (takes ndim incl. any leading L axis)
    (r"embed_tokens$", lambda nd: (FSDP, MODEL)),
    (r"(self_attn|encoder_attn)\.(q|k|v)_proj\.w$", lambda nd: _stacked(nd, (None, FSDP, MODEL))),
    (r"(self_attn|encoder_attn)\.(q|k|v)_proj\.b$", lambda nd: _stacked(nd, (None, MODEL))),
    (r"(self_attn|encoder_attn)\.out_proj\.w$", lambda nd: _stacked(nd, (None, MODEL, FSDP))),
    (r"fc1\.w$", lambda nd: _stacked(nd, (None, FSDP, MODEL))),
    (r"fc1\.b$", lambda nd: _stacked(nd, (None, MODEL))),
    (r"fc2\.w$", lambda nd: _stacked(nd, (None, MODEL, FSDP))),
    (r"ffn_layernorm\.(scale|bias)$", lambda nd: _stacked(nd, (None, MODEL))),
    # big non-layer matrices: shard on fsdp
    (r"(pos_q_linear|pos_k_linear|self_pos_q_linear|self_pos_k_linear|"
     r"cross_pos_q_linear|cross_pos_k_linear|image_proj)\.w$", lambda nd: (FSDP, None)),
    (r"embed_positions$|embed_image_positions$", lambda nd: (FSDP, None)),
    (r"rel_pos_table$", lambda nd: (None, FSDP, None)),
    # resnet convs: shard output channels on fsdp where big
    (r"conv\d$|downsample_conv$|conv1$", lambda nd: _conv_spec(nd)),
]


def _stacked(ndim: int, spec: Spec) -> Spec:
    """Use `spec` if the leaf has the leading layer axis, else drop it."""
    if ndim == len(spec):
        return spec
    assert ndim == len(spec) - 1
    return tuple(spec[1:])


def _conv_spec(ndim: int) -> Spec:
    if ndim == 4:  # HWIO
        return (None, None, None, FSDP)
    if ndim == 5:  # stacked L,HWIO
        return (None, None, None, None, FSDP)
    return ()


def param_spec(path: str, ndim: int) -> Spec:
    for pat, builder in _RULES:
        if re.search(pat, path):
            spec = builder(ndim)
            if len(spec) <= ndim:
                return spec
    return ()  # replicate small leaves


def _fit_spec(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Drop sharding on dims the mesh can't divide evenly (e.g. the 1765-row
    embed_image_positions table) — replication is always correct."""
    out = []
    for i, axes in enumerate(spec):
        if axes is None:
            out.append(None)
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        size = int(np.prod([mesh.shape[n] for n in names]))
        out.append(axes if shape[i] % size == 0 else None)
    return tuple(out)


def _is_layer_stacked(path: str) -> bool:
    """Leaves whose leading axis is the transformer layer axis (a port leaf
    with ``.layers.`` is one entry of such a leaf)."""
    return ".layers." in path or path.endswith("rel_pos_table")


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------

def _owned(L: int, P: int, V: int, d: int) -> List[List[int]]:
    """Stage ``d``'s layer indices, chunk by chunk (V chunks of L/(P·V))."""
    Lc = L // (P * V)
    return [list(range((v * P + d) * Lc, (v * P + d + 1) * Lc)) for v in range(V)]


def stack_interleave(cfg, n_layers: int, stages: int, M: Optional[int] = None) -> int:
    """The interleave V that a stack of ``n_layers`` runs under ``cfg``'s
    pipeline over ``stages`` with ``M`` microbatches (default
    ``cfg.pipeline_microbatches``): ``cfg.pipeline_interleave`` where the
    interleaved schedule's conditions hold (layers divisible by stages·V,
    microbatches ≤ stages), else 1 (GPipe)."""
    V = cfg.pipeline_interleave
    M = cfg.pipeline_microbatches if M is None else M
    if V <= 1 or n_layers % (stages * V) or M > stages:
        return 1
    return V


def stage_layers(cfg, n_layers: int, stages: int) -> Optional[List[List[int]]]:
    """Each pipe stage's layers of a stack of ``n_layers`` (stage d's at [d]),
    in the order the stage runs them: its V chunks (``stack_interleave``; V =
    1 without microbatches, where no pipeline runs: JAX's contiguous
    ``L/P`` block). None where the stack does not split over the stages
    (L % P ≠ 0), which replicates it, as ``_fit_spec`` does."""
    V = stack_interleave(cfg, n_layers, stages) if cfg.pipeline_microbatches > 0 else 1
    if n_layers % (stages * V):
        return None
    return [[i for chunk in _owned(n_layers, stages, V, d) for i in chunk]
            for d in range(stages)]


# ---------------------------------------------------------------------------
# the port's layout
# ---------------------------------------------------------------------------

def _per_layer(path: str) -> bool:
    """A leaf of the port's tree that is one entry of a JAX stacked leaf (a
    transformer layer, or a ResNet stage's ``rest`` block)."""
    return ".layers." in path or ".rest." in path


def _is_linear(path: str, ndim: int) -> bool:
    return path.endswith(".w") and ndim == 2


def jax_shape(path: str, shape) -> Tuple[int, ...]:
    """The JAX layout's shape of a port leaf (without the layer axis):
    linears ``[dout, din]`` → ``[din, dout]``, convolutions OIHW → HWIO."""
    shape = tuple(shape)
    if _is_linear(path, len(shape)):
        return shape[::-1]
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return shape


def _to_port(path: str, spec: Spec, ndim: int) -> Spec:
    if _is_linear(path, ndim):
        return spec[::-1]
    if ndim == 4:
        h, w, i, o = spec
        return (o, i, h, w)
    return spec


def leaf_spec(path: str, shape, mesh: Mesh, layers: Optional[int] = None) -> Spec:
    """The spec of the port's leaf at ``path`` (``named_leaves``' paths) with
    ``shape``: the JAX leaf's ``param_spec``, fitted to the mesh as
    ``param_shardings`` fits it, in the port's layout. A layer-stacked leaf's
    ``L`` axis goes on ``pipe`` where the mesh has it: a rel-pos table's dim
    0, or for a leaf of a layer list (``.layers.``, one entry of the JAX
    ``[L, ...]`` leaf) the list itself, given as ``layers`` (the stack's L):
    the spec then starts with the list's entry. Without ``layers`` such a
    leaf's spec is one entry's (a mesh of one pipe stage only)."""
    jshape = jax_shape(path, shape)
    stacked = _per_layer(path)
    nd = len(jshape) + stacked
    spec = tuple(param_spec(path, nd))
    spec = spec + (None,) * (nd - len(spec))
    if mesh.shape[PIPE] > 1 and _is_layer_stacked(path):
        spec = (PIPE,) + spec[1:]  # pipeline stages own layer blocks (param_shardings)
    if not stacked:
        return _to_port(path, _fit_spec(spec, jshape, mesh), len(jshape))
    if layers is None:
        if spec[0] is not None:
            raise ValueError(f"{path}: the layer axis is on pipe; give the stack's layers")
        return _to_port(path, _fit_spec(spec[1:], jshape, mesh), len(jshape))
    fitted = _fit_spec(spec, (layers,) + jshape, mesh)
    return (fitted[0],) + _to_port(path, fitted[1:], len(jshape))


def sharded_dim(path: str, shape, mesh: Mesh, axis: str,
                layers: Optional[int] = None) -> Optional[int]:
    """The dim of the port's leaf that ``axis`` shards, or None (replicated
    over it, or the axis is one rank); counted as ``leaf_spec(path, shape,
    mesh, layers)`` counts them (with ``layers``, 0 is a layer list's axis)."""
    if mesh.shape[axis] == 1:
        return None
    for d, axes in enumerate(leaf_spec(path, shape, mesh, layers)):
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        if axis in names:
            return d
    return None
