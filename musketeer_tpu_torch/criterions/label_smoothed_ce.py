"""Label-smoothed cross-entropy with OFA's extensions (port of
``musketeer_tpu/criterions/label_smoothed_ce.py``).

Static shapes and mask arithmetic, as in the JAX package:

- per-position ``constraint_masks`` restrict the softmax support (logits
  masked to −1e9) and the smoothing support (eps spread over the allowed set);
- ``constraint_range``: the band [0, 4) + [start, end);
- ``conf``: per-sample weights multiplying the log-probabilities;
- drop-worst: after N updates keep the (1 − ratio) fraction of kept
  positions with the lowest loss (a stable sort, as ``jnp.argsort``), chosen
  on the first R-Drop copy and mirrored to the second;
- drop-best: then keep the (1 − ratio) fraction with the highest loss;
- the encouraging-loss bonus log(1 − p), linear above ``log_end``;
- R-Drop: symmetric KL between the two halves of the batch.

Under data parallelism (``comm``, a ``parallel.DataParallel``) each rank
holds its block of the task batch; drop-worst and drop-best then rank the
global batch's positions (gathered from every rank) and keep this rank's
part of the global choice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e9


class CELossOut(NamedTuple):
    loss: torch.Tensor  # scalar: sum over kept positions (+ the R-Drop term)
    nll_loss: torch.Tensor  # scalar
    ntokens: torch.Tensor  # scalar: kept positions


def _band(V: int, constraint_range, device) -> torch.Tensor:
    cs, ce = constraint_range
    band = torch.arange(V, device=device)
    return (band < 4) | ((band >= cs) & (band < ce))


def _rank(values: torch.Tensor) -> torch.Tensor:
    """Position of each element in a stable ascending sort."""
    order = torch.argsort(values, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(values.numel(), device=values.device)
    return rank


def _kept_lowest(values: torch.Tensor, keep: torch.Tensor, ratio: float, comm=None,
                 copies: int = 1) -> torch.Tensor:
    """``keep`` and, among the kept, the ⌊Σkeep·(1 − ratio)⌋ lowest ``values``
    (a stable sort); over the global batch when ``comm`` is given."""
    if comm is not None and comm.distributed:
        kept = _kept_lowest(comm.gather_rows(values.detach(), copies),
                            comm.gather_rows(keep, copies), ratio)
        return comm.local_rows(kept, copies)
    kth = torch.floor(keep.sum().float() * (1.0 - ratio))
    return (_rank(values) < kth) & keep


def label_smoothed_ce(
    logits: torch.Tensor,  # [B, T, V] raw logits
    targets: torch.Tensor,  # [B, T] int
    epsilon: float,
    pad_id: int = 1,
    constraint_masks: Optional[torch.Tensor] = None,  # [B, T, V] bool
    constraint_range: Optional[tuple] = None,  # (start, end)
    conf: Optional[torch.Tensor] = None,  # [B] per-sample weight
    drop_worst_ratio: float = 0.0,
    drop_worst_active: Optional[bool] = None,  # update > drop_worst_after
    drop_best_ratio: float = 0.0,
    drop_best_active: Optional[bool] = None,  # update > drop_best_after
    use_rdrop: bool = False,
    reg_alpha: float = 1.0,
    ignore_eos: bool = False,
    eos_id: int = 2,
    vocab_size: Optional[int] = None,  # real vocab (< V when layout-padded)
    encouraging_log_end: Optional[float] = None,  # enables the encouraging loss
    comm=None,  # parallel.DataParallel: rank positions over the global batch
) -> CELossOut:
    B, T, V = logits.shape
    Vr = vocab_size if vocab_size is not None else V
    device = logits.device
    logits = logits.float()

    if constraint_masks is not None:
        logits = logits.masked_fill(~constraint_masks, NEG_INF)
    if constraint_range is not None:
        logits = logits.masked_fill(~_band(V, constraint_range, device), NEG_INF)

    lprobs = torch.log_softmax(logits, dim=-1)
    if conf is not None:
        lprobs = lprobs * conf[:, None, None]

    lp = lprobs.reshape(-1, V)
    tgt = targets.reshape(-1).long()
    keep = tgt != pad_id
    if ignore_eos:
        keep = keep & (tgt != eos_id)

    nll = -lp.gather(1, tgt[:, None])[:, 0]
    if constraint_masks is not None:
        cm = constraint_masks.reshape(-1, V)
        smooth = -torch.where(cm, lp, 0.0).sum(-1)
        eps_i = epsilon / (cm.sum(-1).float() - 1 + 1e-6)
    elif constraint_range is not None:
        cs, ce = constraint_range
        smooth = -torch.where(_band(V, constraint_range, device), lp, 0.0).sum(-1)
        eps_i = epsilon / (4 + (ce - cs) - 1 + 1e-6)
    else:
        # smoothing support = the real vocab only (padding columns hold −1e9 logits)
        smooth = -lp[:, :Vr].sum(-1)
        eps_i = epsilon / (Vr - 1)

    loss_per_pos = (1.0 - epsilon - eps_i) * nll + eps_i * smooth

    weights = keep.float()
    if drop_worst_ratio > 0.0 and (drop_worst_active is None or drop_worst_active):
        n = (B // 2) * T if use_rdrop else B * T
        k1 = keep[:n]
        l1 = torch.where(k1, loss_per_pos[:n], float("inf"))
        kept = _kept_lowest(l1, k1, drop_worst_ratio, comm)
        weights = (torch.cat([kept, kept]) if use_rdrop else kept).float()

    if drop_best_ratio > 0.0 and (drop_best_active is None or drop_best_active):
        cur = weights > 0
        lb = torch.where(cur, loss_per_pos, float("-inf"))
        weights = _kept_lowest(-lb, cur, drop_best_ratio, comm, 2 if use_rdrop else 1).float()

    ntokens = weights.sum()
    loss = (loss_per_pos * weights).sum()
    nll_loss = (nll * weights).sum()

    if encouraging_log_end is not None:
        le = encouraging_log_end
        probs = torch.exp(lp)
        bonus = torch.log(torch.clamp(1.0 - probs, min=1e-5))
        if le != 1.0:
            y_le = torch.log(torch.tensor(1.0 - le, dtype=torch.float32))
            bonus_lin = (probs - le) / (le - 1.0) + y_le
            bonus = torch.where(probs > le, bonus_lin, bonus)
        tgt_bonus = bonus.gather(1, tgt[:, None])[:, 0]
        c_nll = (tgt_bonus * weights).sum()
        c_smooth = (bonus[:, :Vr].sum(-1) * weights).sum()
        loss = loss + c_nll * (1.0 - epsilon) + (epsilon / Vr) * c_smooth

    if use_rdrop:
        half = B // 2
        p = lprobs[:half].reshape(-1, V)
        q = lprobs[half:].reshape(-1, V)
        if constraint_range is not None:
            sel = _band(V, constraint_range, device)
            p = p.masked_fill(~sel, NEG_INF)
            q = q.masked_fill(~sel, NEG_INF)
        w2 = weights.reshape(B, T)[:half].reshape(-1)
        # symmetric KL: (KL(q‖p) + KL(p‖q)) / 2 summed over kept positions
        kl = 0.5 * ((q.exp() * (q - p)).sum(-1) + (p.exp() * (p - q)).sum(-1))
        loss = loss + reg_alpha * (kl * w2).sum()

    return CELossOut(loss=loss, nll_loss=nll_loss, ntokens=ntokens)
