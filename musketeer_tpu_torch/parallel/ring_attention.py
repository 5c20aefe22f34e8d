"""Ring attention over the mesh's ``seq`` axis (port of
``musketeer_tpu/parallel/ring_attention.py``), and the sequence-sharding
operators around it.

Each of the P ranks of the ring holds a chunk ``[B, H, S/P, D]`` of q, k, v
(and of the decomposed positional streams ``pos_q``/``pos_k``) and the rows
of ``rel`` for its queries, ``[H, S/P, S]``; ``kpad [B, S]`` is whole on every
rank. At hop i a rank holds the K/V/pos_k chunk of rank ``src = idx − i`` and
merges the partial attention of its queries against it into the online-
softmax triple (running max m, normaliser l, weighted sum acc), exactly as
the JAX kernel does: masked logits are ``NEG_INF``, a row whose max is still
at or below ``NEG_INF/2`` is not shifted, and the result is
``acc / max(l, 1e-38)``; ``causal`` compares global positions. The chunk
then hops to the next rank (``batch_isend_irecv``). The products are
``torch.matmul`` in fp32, as the JAX ``einsum``s with fp32 accumulation.

The backward, in the same autograd function, is the reverse ring: the K/V
chunks go round again with their gradient accumulators, each rank adding
its queries' part (from the saved m and l, ``P = exp(w − m)/l``), and after P
hops every accumulator is back with its chunk's owner.

Around the layer stack the stream is split into chunks and gathered again:
``seq_chunk`` takes this rank's chunk of a replicated tensor (the gradient of
the rest is zero here) and ``seq_gather`` all-gathers the chunks (its
backward reduce-scatters: every rank holds a share of the replicated
tensor's gradient, and the shares sum to it), so that the gradients of
every parameter are summed over the ``seq`` ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DATA, SEQ, get_mesh

NEG_INF = -1e9


def _hop(group, dst: int, src: int, tensors):
    """Send ``tensors`` to ``dst`` and receive their like from ``src``."""
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, src, group) for b in bufs]
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    return bufs


def _logits(qf, kc, pqf, pkc, rel, kpad, src: int, Sl: int, causal: bool, q0: int):
    """The fp32 logits of the local queries against the chunk of rank ``src``."""
    w = qf @ kc.float().transpose(-1, -2)
    if pqf is not None:
        w = w + pqf @ pkc.float().transpose(-1, -2)
    if rel is not None:
        w = w + rel[:, :, src * Sl:(src + 1) * Sl].float()[None]
    w = w.masked_fill(kpad[:, None, None, src * Sl:(src + 1) * Sl], NEG_INF)
    if causal:
        q_glob = q0 + torch.arange(qf.shape[2], device=qf.device)
        k_glob = src * Sl + torch.arange(Sl, device=qf.device)
        w = w.masked_fill(k_glob[None, :] > q_glob[:, None], NEG_INF)
    return w


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_k, rel, kpad, ring):
        group, Pn, idx, nxt, prv, causal = ring
        B, H, Sl, D = q.shape
        qf = q.float()
        pqf = None if pos_q is None else pos_q.float()
        m = q.new_full((B, H, Sl), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((B, H, Sl), dtype=torch.float32)
        acc = q.new_zeros((B, H, Sl, D), dtype=torch.float32)
        kc, vc, pkc = k, v, pos_k
        for i in range(Pn):
            src = (idx - i) % Pn
            w = _logits(qf, kc, pqf, pkc, rel, kpad, src, Sl, causal, idx * Sl)
            m_new = torch.maximum(m, w.amax(-1))
            # all-masked rows keep m at NEG_INF; guard the exp shift
            shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(w - shift[..., None])
            scale = torch.exp(m - shift)
            l = l * scale + p.sum(-1)
            acc = acc * scale[..., None] + p @ vc.float()
            m = m_new
            if i < Pn - 1:
                moving = [kc, vc] + ([] if pkc is None else [pkc])
                moved = _hop(group, nxt, prv, moving)
                kc, vc = moved[0], moved[1]
                pkc = None if pkc is None else moved[2]
        out = acc / torch.clamp(l, min=1e-38)[..., None]
        ctx.ring = ring
        ctx.save_for_backward(q, k, v, pos_q, pos_k, rel, kpad, m, l, out)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pos_q, pos_k, rel, kpad, m, l, out = ctx.saved_tensors
        group, Pn, idx, nxt, prv, causal = ctx.ring
        B, H, Sl, D = q.shape
        qf, gf = q.float(), g.float()
        pqf = None if pos_q is None else pos_q.float()
        shift = torch.where(m <= NEG_INF / 2, 0.0, m)
        inv_l = 1.0 / torch.clamp(l, min=1e-38)
        delta = (gf * out).sum(-1)  # Σ_j P_ij dP_ij
        dq = torch.zeros_like(qf)
        dpq = None if pos_q is None else torch.zeros_like(qf)
        drel = None if rel is None else torch.zeros(rel.shape, dtype=torch.float32,
                                                    device=rel.device)
        kc, vc, pkc = k, v, pos_k
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        dpk = None if pos_k is None else torch.zeros_like(dk)
        for i in range(Pn):
            src = (idx - i) % Pn
            w = _logits(qf, kc, pqf, pkc, rel, kpad, src, Sl, causal, idx * Sl)
            p = torch.exp(w - shift[..., None]) * inv_l[..., None]
            dv += p.transpose(-1, -2) @ gf
            dw = p * (gf @ vc.float().transpose(-1, -2) - delta[..., None])
            dq += dw @ kc.float()
            dk += dw.transpose(-1, -2) @ qf
            if pqf is not None:
                dpq += dw @ pkc.float()
                dpk += dw.transpose(-1, -2) @ pqf
            if drel is not None:
                drel[:, :, src * Sl:(src + 1) * Sl] += dw.sum(0)
            # the chunk and its accumulators move on; after the last hop only
            # the accumulators, which then reach the chunk's owner
            moving = [dk, dv] + ([] if dpk is None else [dpk])
            if i < Pn - 1:
                moving = moving + [kc, vc] + ([] if pkc is None else [pkc])
            moved = _hop(group, nxt, prv, moving) if Pn > 1 else moving
            n = 2 + (dpk is not None)
            dk, dv = moved[0], moved[1]
            dpk = moved[2] if dpk is not None else None
            if i < Pn - 1:
                kc, vc = moved[n], moved[n + 1]
                pkc = moved[n + 2] if pkc is not None else None
        cast = lambda t, like: None if t is None else t.to(like.dtype)
        return (cast(dq, q), cast(dk, k), cast(dv, v), cast(dpq, pos_q), cast(dpk, pos_k),
                cast(drel, rel), None, None)


def _ring_of(mesh, causal: bool):
    Pn, idx = mesh.shape[SEQ], mesh.coords[SEQ]
    return (mesh.group(SEQ), Pn, idx, mesh.rank_at(**{SEQ: (idx + 1) % Pn}),
            mesh.rank_at(**{SEQ: (idx - 1) % Pn}), causal)


def ring_attention(
    q: torch.Tensor,  # [B, H, S/P, D] (pre-scaled), this rank's chunk
    k: torch.Tensor,  # [B, H, S/P, D]
    v: torch.Tensor,  # [B, H, S/P, D]
    pos_q: Optional[torch.Tensor],  # [B, H, S/P, D] or None
    pos_k: Optional[torch.Tensor],  # [B, H, S/P, D] or None
    rel: Optional[torch.Tensor],  # [H, S/P, S]: this rank's query rows, or None
    kpad: Optional[torch.Tensor],  # [B, S] bool, True = masked key, whole
    mesh,
    causal: bool = False,
) -> torch.Tensor:
    """Sequence-parallel attention of this rank's query chunk over the ring
    of ``mesh``'s ``seq`` ranks → ``[B, H, S/P, D]`` in q's dtype.

    Where the batch is the same on every ``data`` rank (a validation batch,
    ``get_mesh().batch_local`` False) and ``data`` divides it, each data
    rank's ring takes its block of the rows and the blocks are gathered
    after, as the JAX kernel shards the batch over ``data``; a ragged batch
    runs whole on every ring."""
    B, H, Sl, D = q.shape
    Pn = mesh.shape[SEQ]
    if kpad is None:
        kpad = torch.zeros((B, Sl * Pn), dtype=torch.bool, device=q.device)
    if (pos_q is None) != (pos_k is None):
        raise ValueError("pos_q and pos_k come together")
    active = get_mesh()
    nd = mesh.shape[DATA]
    if active is not None and not active.batch_local and nd > 1 and B % nd == 0:
        rows = slice(mesh.coords[DATA] * (B // nd), (mesh.coords[DATA] + 1) * (B // nd))
        pick = lambda t: None if t is None else t[rows]
        out = _Ring.apply(q[rows], k[rows], v[rows], pick(pos_q), pick(pos_k), rel, kpad[rows],
                          _ring_of(mesh, causal))
        return gather(out, 0, mesh.group(DATA), nd)
    return _Ring.apply(q, k, v, pos_q, pos_k, rel, kpad, _ring_of(mesh, causal))


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; backward: reduce-scatter (the
    ranks' shares of the gathered tensor's gradient, summed, to the owner)."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0],) + xs.shape[1:])
        dist.all_gather_into_tensor(out, xs, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gs = g.movedim(ctx.dim, 0).contiguous()
        r = gs.new_empty((gs.shape[0] // ctx.n,) + gs.shape[1:])
        dist.reduce_scatter_tensor(r, gs, group=ctx.group)
        return r.movedim(0, ctx.dim), None, None, None


def gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``x`` along ``dim``, concatenated in rank order."""
    return x if n == 1 else _Gather.apply(x, dim, group, n)


def seq_chunk(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a replicated tensor split over ``seq``."""
    Pn = mesh.shape[SEQ]
    n = x.shape[dim] // Pn
    return x.narrow(dim, mesh.coords[SEQ] * n, n)


def seq_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The ``seq`` ranks' chunks along ``dim``, concatenated (differentiable)."""
    return gather(x, dim, mesh.group(SEQ), mesh.shape[SEQ])
