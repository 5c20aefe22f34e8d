"""GPipe and interleaved pipelines over the mesh's ``pipe`` axis (port of
``musketeer_tpu/parallel/pipeline.py``).

Schedule (M microbatches, P stages): at clock t, stage s runs its L/P layers
on microbatch t − s when 0 ≤ t − s < M; M + P − 1 clocks in all, a bubble of
(P − 1)/(M + P − 1). With ``interleave`` V > 1 (Megatron's interleaved
schedule) the L layers split into P·V chunks of L/(P·V), stage d owns chunks
d, d + P, …, d + (V − 1)·P, and microbatch m runs chunk c = v·P + d at clock
m + c: M + P·V − 1 clocks of chunk size, M ≤ P. These are the JAX schedules,
clock for clock. A stage holds only its own layers (``mesh.stage_layers``,
``data_parallel.py``): JAX's stage holds its contiguous L/P block and
permutes the stacked layers into device-major order inside each step; here
a stage holds its V chunks, in the order it runs them, so that no step moves
a layer between stages.

Between clocks a stage sends its output to the next over ``torch.distributed``
point-to-point (``batch_isend_irecv``, each send matched by the neighbour's
receive of the same clock, so both sides post the same pairs in the same
order). Only the stream ``payload`` flows from stage to stage; ``side``
(per-microbatch inputs every layer reads, such as masks and positional
projections) and ``consts`` are replicated, and each stage reads them where
the JAX schedule carries them along. The output is the last stage's,
broadcast to every stage, as the JAX ``psum`` of the stages' buffers (zero
but on the last stage) replicates it.

The backward is the reverse schedule in the same autograd function: clock by
clock from the last, each active stage takes its output's gradient (the last
stage from the broadcast's, summed over the stages; the others from the next
stage), runs the backward of its layers and sends its input's gradient to the
previous stage. A stage's layers get their whole gradient on the stage;
``side`` and ``consts`` get each stage's part of theirs: summed over the
``pipe`` ranks, they are the whole. With ``remat`` the forward keeps only
each clock's input and the backward recomputes the stage, as the JAX
schedule's ``jax.checkpoint`` of a stage.

``gather_layers`` is the other way a stack runs over ``pipe``: where the
pipeline's gate is closed, every stage gathers the whole stack (all-gather
in the forward, reduce-scatter of the gradients to their stages in the
backward), as JAX's GSPMD gathers a sharded stack for a plain layer loop.

``mesh.progress`` records the pipeline's clock and the collective it last
posted on this rank; a run that hangs reads it (``dryrun``'s reports).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.utils import _pytree as pytree

from .mesh import PIPE, Mesh


def _tensor_leaves(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _rebuild(tree, tensors: Sequence[torch.Tensor]):
    """``tree`` with its tensor leaves replaced, in order, by ``tensors``."""
    leaves, spec = pytree.tree_flatten(tree)
    it = iter(tensors)
    return pytree.tree_unflatten([next(it) if isinstance(x, torch.Tensor) else x
                                  for x in leaves], spec)


class _Schedule:
    """One stage's clocks: ``work(t)`` → (microbatch, chunk) or None; whether
    the stage takes its input from the microbatches (``injects``), whether its
    chunk is the pipeline's last (``last``) or sends its output on (``sends``)."""

    def __init__(self, M: int, P: int, V: int, d: int):
        self.M, self.P, self.V, self.d = M, P, V, d
        self.n_clock = M + P * V - 1

    def work(self, t: int, d: Optional[int] = None):
        d = self.d if d is None else d
        td = t - d
        if td < 0:
            return None
        m, v = td % self.P, td // self.P
        if self.V == 1:
            m, v = td, 0
        if m >= self.M or v >= self.V:
            return None
        return m, v

    def injects(self, t: int) -> bool:
        """Does this stage read its input from the microbatches at clock t?"""
        w = self.work(t)
        return w is not None and self.d == 0 and w[1] == 0

    def last(self, t: int, d: Optional[int] = None) -> bool:
        """Is the chunk of stage d at clock t the pipeline's last?"""
        d = self.d if d is None else d
        w = self.work(t, d)
        return w is not None and d == self.P - 1 and w[1] == self.V - 1

    def sends(self, t: int, d: Optional[int] = None) -> bool:
        """Does stage d send its clock-t output to the next stage?"""
        return self.work(t, d) is not None and not self.last(t, d)


def _sendable(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()


def _exchange(group, send_to: Optional[int], sends: Sequence[torch.Tensor],
              recv_from: Optional[int], likes: Sequence[torch.Tensor]):
    """Send ``sends`` to global rank ``send_to`` and receive tensors shaped as
    ``likes`` from ``recv_from`` (either may be None), posted together →
    the received tensors (None without a receive)."""
    ops, bufs = [], []
    if send_to is not None:
        ops += [dist.P2POp(dist.isend, _sendable(x), send_to, group) for x in sends]
    if recv_from is not None:
        bufs = [torch.empty_like(_sendable(x)) for x in likes]
        ops += [dist.P2POp(dist.irecv, b, recv_from, group) for b in bufs]
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return None if recv_from is None else [b.to(x.dtype) for b, x in zip(bufs, likes)]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st, *tensors):
        pay = tensors[:st.n_pay]
        # the leaves the stage graphs are recorded against
        alias = lambda t: t.detach().requires_grad_(st.grad and t.is_floating_point())
        targets = [alias(t) for t in tensors[st.n_pay:]]
        ctx.st, ctx.targets, ctx.records = st, targets, {}
        sched, mesh = st.sched, st.mesh
        out = [torch.zeros_like(x) for x in pay]
        incoming = None
        for t in range(sched.n_clock):
            mesh.progress.update(phase="forward", clock=t)
            w = sched.work(t)
            y = None
            if w is not None:
                m, v = w
                x_in = [alias(x) for x in ([x[m] for x in pay] if sched.injects(t) else incoming)]
                with torch.set_grad_enabled(st.grad and not st.remat):
                    y = _run(st, m, v, x_in, targets)
                if st.grad:
                    ctx.records[t] = (x_in, None if st.remat else y)
                y = [a.detach() for a in y]
                if sched.last(t):
                    for o, a in zip(out, y):
                        o[m] = a
            incoming = _step(mesh, sched, t, y, pay)
        if sched.P > 1:  # the last stage's outputs on every stage
            last = mesh.rank_at(**{PIPE: sched.P - 1})
            mesh.progress.update(phase="forward", clock=sched.n_clock,
                                 collective=f"broadcast from rank {last}")
            for o in out:
                buf = _sendable(o)
                dist.broadcast(buf, last, group=mesh.group(PIPE))
                o.copy_(buf.to(o.dtype))
        ctx.out_like = [(o.shape, o.dtype) for o in out]
        return tuple(out)

    @staticmethod
    def backward(ctx, *g_out):
        st, targets = ctx.st, ctx.targets
        sched, mesh = st.sched, st.mesh
        g_out = [torch.zeros(s, dtype=dt, device=targets[0].device if targets else None)
                 if g is None else g.contiguous().clone()
                 for g, (s, dt) in zip(g_out, ctx.out_like)]
        if sched.P > 1:  # the stages' shares of the output's gradient, summed on the last
            last = mesh.rank_at(**{PIPE: sched.P - 1})
            mesh.progress.update(phase="backward", clock=sched.n_clock,
                                 collective=f"reduce to rank {last}")
            for g in g_out:
                dist.reduce(g, last, group=mesh.group(PIPE))
        g_targets: List[Optional[torch.Tensor]] = [None] * len(targets)
        g_pay = [torch.zeros_like(g) for g in g_out]
        g_next = None  # the gradient of this stage's output at the clock, from the next stage
        for t in range(sched.n_clock - 1, -1, -1):
            mesh.progress.update(phase="backward", clock=t)
            w = sched.work(t)
            g_in = None
            if w is not None:
                m, v = w
                x_in, y = ctx.records.pop(t)
                if y is None:  # remat: the stage again, with its graph
                    with torch.enable_grad():
                        y = _run(st, m, v, x_in, targets)
                gy = [g[m] for g in g_out] if sched.last(t) else g_next
                pairs = [(a, b) for a, b in zip(y, gy) if a.requires_grad]
                wrt = [x for x in list(x_in) + targets if x.requires_grad]
                grads = dict(zip(map(id, wrt), torch.autograd.grad(
                    [a for a, _ in pairs], wrt, [b for _, b in pairs], allow_unused=True)
                    if pairs and wrt else [None] * len(wrt)))
                g_in = [grads.get(id(x)) for x in x_in]
                g_in = [torch.zeros_like(x) if g is None else g for g, x in zip(g_in, x_in)]
                for i, x in enumerate(targets):
                    g = grads.get(id(x))
                    if g is not None:
                        g_targets[i] = g if g_targets[i] is None else g_targets[i] + g
                if sched.injects(t):
                    for gp, g in zip(g_pay, g_in):
                        gp[m] += g.to(gp.dtype)
            g_next = _step_back(mesh, sched, t, g_in, g_out)
        need = ctx.needs_input_grad[1:]
        grads = g_pay + g_targets
        return (None, *[g if n else None for g, n in zip(grads, need)])


class _Setup:
    """What the pipeline's forward and backward share: the stream's tensors
    come first among the function's inputs, then ``n_side`` side inputs,
    ``n_const`` constants and the stage's layers' tensors (the targets)."""

    def __init__(self, body, mesh, sched, remat, grad, counts, trees):
        self.body, self.mesh, self.sched, self.remat, self.grad = body, mesh, sched, remat, grad
        self.n_pay, self.n_side, self.n_const = counts
        self.pay_tree, self.side_tree, self.const_tree, self.layer_trees = trees


def _run(st: _Setup, m: int, v: int, x_in, targets):
    """The stage's chunk v on microbatch m: its layers' ``body`` in turn."""
    side = targets[:st.n_side]
    consts = targets[st.n_side:st.n_side + st.n_const]
    it = iter(targets[st.n_side + st.n_const:])
    pl = _rebuild(st.pay_tree, x_in)
    side = _rebuild(st.side_tree, [x[m] for x in side])
    consts = _rebuild(st.const_tree, consts)
    chunks = [_rebuild(tree, [next(it) for _ in _tensor_leaves(tree)]) for tree in st.layer_trees]
    Lc = len(chunks) // st.sched.V
    for layer in chunks[v * Lc:(v + 1) * Lc]:
        pl = st.body(pl, layer, consts, side)
    return _tensor_leaves(pl)


def _neighbour(mesh: Mesh, sched: _Schedule, step: int) -> int:
    return mesh.rank_at(**{PIPE: (sched.d + step) % sched.P})


def _step(mesh, sched: _Schedule, t: int, y, like):
    """After clock t: send this stage's output on, receive the next clock's input."""
    if sched.P == 1:  # one stage: the carry stays here
        return y if sched.sends(t) else None
    send_to = _neighbour(mesh, sched, 1) if sched.sends(t) else None
    recv_from = _neighbour(mesh, sched, -1) if sched.sends(t, (sched.d - 1) % sched.P) else None
    mesh.progress["collective"] = f"send to rank {send_to}, receive from rank {recv_from}"
    return _exchange(mesh.group(PIPE), send_to, y or [], recv_from, [x[0] for x in like])


def _step_back(mesh, sched: _Schedule, t: int, g_in, like):
    """After clock t's backward: send the gradient of this stage's clock-t input
    to the stage it came from, receive the gradient of its clock t − 1 output."""
    came = sched.work(t) is not None and not sched.injects(t)
    if sched.P == 1:
        return g_in if came else None
    send_to = _neighbour(mesh, sched, -1) if came else None
    recv_from = _neighbour(mesh, sched, 1) if t >= 1 and sched.sends(t - 1) else None
    mesh.progress["collective"] = f"send to rank {send_to}, receive from rank {recv_from}"
    return _exchange(mesh.group(PIPE), send_to, g_in or [], recv_from, [x[0] for x in like])


def pipeline_scan(
    body: Callable[[Any, Any, Any, Any], Any],  # (payload, layer, consts, side) -> payload
    payload_mb: Any,  # pytree of tensors [M, ...]: the stream, stage to stage
    layers: Sequence[Any],  # this stage's L/P layers (pytrees), chunk by chunk
    mesh: Mesh,
    consts: Any = None,  # replicated stage-invariant pytree
    remat: bool = False,
    interleave: int = 1,
    side_mb: Any = None,  # pytree of tensors [M, ...]: per-microbatch inputs every layer reads
) -> Any:
    """Run ``body`` over the stack's L layers as a pipeline over ``mesh``'s
    pipe axis → the payload ``[M, ...]`` after the last layer, on every stage.

    ``layers`` are this stage's: ``mesh.stage_layers``' list of it, that is
    its V chunks of L/(P·V) layers in turn (``interleave`` V; M ≤ P with V >
    1). Every pipe rank calls this in the same order. ``body`` gets the
    microbatch's ``side`` entries without the M axis."""
    M = _tensor_leaves(payload_mb)[0].shape[0]
    P, d = mesh.shape[PIPE], mesh.coords[PIPE]
    V = interleave
    if not layers or len(layers) % V:
        raise ValueError(f"a stage's {len(layers)} layers do not split into {V} chunks")
    if V > 1 and M > P:
        raise ValueError(f"interleaved schedule needs microbatches {M} <= stages {P}")
    consts = () if consts is None else consts
    side_mb = {} if side_mb is None else side_mb
    pay, side, cst = (_tensor_leaves(t) for t in (payload_mb, side_mb, consts))
    lay = [x for tree in layers for x in _tensor_leaves(tree)]
    tensors = [*pay, *side, *cst, *lay]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if P > 1 and not getattr(mesh, "_pipe_ready", False):
        # NCCL: a group's first call must be every rank's, and a clock's
        # sends and receives are a pair's only
        mesh.progress["collective"] = "the pipe group's first all-reduce"
        dist.all_reduce(torch.zeros(1, device=pay[0].device), group=mesh.group(PIPE))
        mesh._pipe_ready = True
    pay_tree = pytree.tree_map(lambda x: x[0] if isinstance(x, torch.Tensor) else x, payload_mb)
    st = _Setup(body, mesh, _Schedule(M, P, V, d), remat, grad, (len(pay), len(side), len(cst)),
                (pay_tree, side_mb, consts, list(layers)))
    return _rebuild(payload_mb, _Pipeline.apply(st, *tensors))


class _GatherStages(torch.autograd.Function):
    """Every stage's tensors → all of them, stage by stage; the backward sums
    the stages' gradients of each stage's tensors onto that stage."""

    @staticmethod
    def forward(ctx, mesh, *held):
        stages = mesh.shape[PIPE]
        ctx.mesh, ctx.stages, ctx.like = mesh, stages, [t.detach() for t in held]
        flat = _flatten_dense_tensors(ctx.like)
        out = flat.new_empty(stages * flat.numel())
        mesh.progress["collective"] = "all-gather of a layer stack"
        dist.all_gather_into_tensor(out, flat, group=mesh.group(PIPE))
        n = flat.numel()
        return tuple(t for d in range(stages)
                     for t in _unflatten_dense_tensors(out[d * n:(d + 1) * n], ctx.like))

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        out = flat.new_empty(flat.numel() // ctx.stages)
        ctx.mesh.progress["collective"] = "reduce-scatter of a layer stack's gradients"
        dist.reduce_scatter_tensor(out, flat, group=ctx.mesh.group(PIPE))
        return (None, *_unflatten_dense_tensors(out, ctx.like))


def gather_layers(layers: Sequence[Any], tables: Sequence[torch.Tensor], mesh: Mesh,
                  stages: Sequence[Sequence[int]]):
    """This stage's ``layers`` (pytrees) and rows of ``tables`` (``[L/P, ...]``)
    → the whole stack's: every layer in order and the tables' ``L`` rows, on
    every pipe rank; ``stages`` is each stage's layer list
    (``mesh.stage_layers``). Differentiable: each stage's gradients are
    summed over the pipe ranks onto the stage that holds the layer."""
    P = mesh.shape[PIPE]
    leaves = [x for tree in layers for x in _tensor_leaves(tree)] + list(tables)
    if len({t.dtype for t in leaves}) > 1:
        raise ValueError("a layer stack's leaves must share one dtype to be gathered")
    out = _GatherStages.apply(mesh, *leaves)
    per_stage = len(leaves)
    order = [i for stage in stages for i in stage]  # the gathered layers' indices
    full: List[Any] = [None] * len(order)
    rows: List[List[torch.Tensor]] = [[] for _ in tables]
    for d in range(P):
        part = iter(out[d * per_stage:(d + 1) * per_stage])
        for k, tree in enumerate(layers):
            full[stages[d][k]] = _rebuild(tree, [next(part) for _ in _tensor_leaves(tree)])
        for j in range(len(tables)):
            rows[j].append(next(part))
    inv = torch.argsort(torch.tensor(order))
    full_tables = [torch.cat(r)[inv.to(r[0].device)] for r in rows]
    return full, full_tables
