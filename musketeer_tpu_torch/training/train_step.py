"""The joint multi-task training step (port of ``musketeer_tpu/training/train_step.py``).

Each task's summed loss is normalised by its own kept-token count and the
normalised losses are added (the reference criterion's recursion). Two
packings keep the step's forwards few, with per-task losses exact:

- ``pack_vision``: one ResNet pass over all same-resolution images; each task
  gets its slice as ``resnet_feats``;
- ``pack_text``: tasks whose token shapes (and feature shapes, once the stem
  has run) agree share one transformer forward; the criterion then runs per
  task on its rows.

A batch with ``sample_patch_order`` runs its encoder on the XLA branch and
one with ``code_masks`` sets ``code_masks_all`` (the JAX step's gates), and
``generator`` draws every dropout mask, attention dropout's too.

``make_train_step`` returns ``step(state, batches, generator)``: gradients
summed over the leading accumulation axis A and divided by A, the global
norm, and the optimizer update, skipped (params, optimizer state and step
left as they were) when the norm is not finite. Where the JAX step is one
jitted program, this one runs eagerly; it updates the state in place.

With ``parallel`` (a ``parallel.DataParallel``) the step is one rank's part
of a run over the whole mesh, given this rank's block of every batch: it
gathers the parameters (FSDP, and over ``model`` the leaves the model uses
whole), runs the forward and backward with the mesh active
(``parallel.mesh.set_mesh``: the model splits heads and FFN over ``model``,
layer stacks over ``pipe``, sequences over ``seq``), counts each task's kept
tokens over the data × fsdp ranks before the backward (each task's loss is
divided by its global count), ranks drop-worst and drop-best over the global
batch, counts the loss that a model × pipe × seq block replicates once,
sums the gradients over the ranks (reduce-scattered to the blocks under
FSDP), and takes the global norm, so that every rank makes the same update
and the same skip decision. The loss and metrics it returns are the global
ones.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config import CriterionConfig, ModelConfig, OptimConfig
from ..criterions.label_smoothed_ce import CELossOut, label_smoothed_ce
from ..models import ofa
from ..models.resnet import resnet_forward
from ..parallel.mesh import set_mesh
from .train_state import TrainState, ema_update, global_norm, make_optimizer, named_leaves


class TaskBatch(NamedTuple):
    """One task's (micro)batch. Tensors may carry a leading accumulation axis."""

    src_tokens: torch.Tensor  # [..., B, Ts]
    prev_output_tokens: torch.Tensor  # [..., B, Tt]
    target: torch.Tensor  # [..., B, Tt]
    patch_images: Optional[torch.Tensor] = None  # [..., B, H, W, 3] float or uint8
    patch_masks: Optional[torch.Tensor] = None  # [..., B]
    constraint_masks: Optional[torch.Tensor] = None  # [..., B, Tt, V] bool or bit-packed uint8
    conf: Optional[torch.Tensor] = None  # [..., B]
    code_masks: Optional[torch.Tensor] = None  # [..., B]
    sample_patch_order: Optional[torch.Tensor] = None  # [..., B, P]
    resnet_feats: Optional[torch.Tensor] = None  # [..., B, h, w, C], set by the stem packing
    patch_norm: Optional[torch.Tensor] = None  # [..., 2, 3] (scale, bias) of uint8 images


def dequantize_batch(b: TaskBatch, dtype: torch.dtype) -> TaskBatch:
    """Expand the compressed transport: uint8 images → ``p · scale + bias`` in
    ``dtype``; bit-packed constraint masks (little-endian ``np.packbits``) → bool."""
    if b.patch_images is not None and b.patch_images.dtype == torch.uint8:
        if b.patch_norm is None:
            raise ValueError("uint8 patch_images need patch_norm")
        norm = b.patch_norm.float()
        sc = norm[..., 0, :].reshape(norm.shape[:-2] + (1, 1, 1, 3))
        bi = norm[..., 1, :].reshape(norm.shape[:-2] + (1, 1, 1, 3))
        b = b._replace(patch_images=(b.patch_images.float() * sc + bi).to(dtype), patch_norm=None)
    cm = b.constraint_masks
    if cm is not None and cm.dtype == torch.uint8:
        shifts = torch.arange(8, dtype=torch.uint8, device=cm.device)
        bits = (cm[..., None] >> shifts) & 1
        b = b._replace(constraint_masks=bits.reshape(cm.shape[:-1] + (cm.shape[-1] * 8,)).bool())
    return b


def _constraint_range(crit_cfg: CriterionConfig):
    if crit_cfg.constraint_start is None:
        return None
    return crit_cfg.constraint_start, crit_cfg.constraint_end


def _ce_options(model_cfg: ModelConfig, crit_cfg: CriterionConfig, update_num: int,
                train: bool) -> dict:
    return dict(
        epsilon=crit_cfg.label_smoothing,
        pad_id=model_cfg.pad,
        constraint_range=_constraint_range(crit_cfg),
        drop_worst_ratio=crit_cfg.drop_worst_ratio if train else 0.0,
        drop_worst_active=update_num > crit_cfg.drop_worst_after,
        drop_best_ratio=crit_cfg.drop_best_ratio if train else 0.0,
        drop_best_active=update_num > crit_cfg.drop_best_after,
        use_rdrop=crit_cfg.use_rdrop and train,
        reg_alpha=crit_cfg.reg_alpha,
        vocab_size=model_cfg.vocab_size,
        encouraging_log_end=crit_cfg.encouraging_log_end,
    )


def _dup(a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The R-Drop copy: the batch twice along its first axis."""
    return None if a is None else torch.cat([a, a], dim=0)


def task_loss(params, model_cfg: ModelConfig, crit_cfg: CriterionConfig, batch: TaskBatch,
              generator: Optional[torch.Generator], update_num: int,
              train: bool = True, comm=None) -> CELossOut:
    """One task's (loss_sum, nll_sum, ntokens)."""
    batch = dequantize_batch(batch, ofa.compute_dtype(model_cfg))
    if crit_cfg.use_rdrop and train:
        batch = TaskBatch(*[_dup(a) for a in batch])
    logits = ofa.forward(
        params, model_cfg, batch.src_tokens, batch.prev_output_tokens,
        patch_images=batch.patch_images, patch_masks=batch.patch_masks,
        code_masks=batch.code_masks, sample_patch_order=batch.sample_patch_order,
        generator=generator, deterministic=not train, resnet_feats=batch.resnet_feats,
        # task batches are homogeneous: a batch with code masks (image
        # generation, pure image) has every row a code target, which keeps
        # the decoder on the flash branch, as in the JAX step
        code_masks_all=batch.code_masks is not None,
    )
    return label_smoothed_ce(logits, batch.target, constraint_masks=batch.constraint_masks,
                             conf=batch.conf, comm=comm,
                             **_ce_options(model_cfg, crit_cfg, update_num, train))


def _pack_key(batch: TaskBatch):
    """Grouping key of the packed forward, or None if the batch does not pack
    (raw images, code targets and patch subsampling keep their own forwards,
    as in the JAX step): token shapes, constraint masks or not, and the
    stem's feature shape."""
    if (batch.patch_images is not None or batch.code_masks is not None
            or batch.sample_patch_order is not None):
        return None
    return (
        tuple(batch.src_tokens.shape),
        tuple(batch.prev_output_tokens.shape),
        batch.constraint_masks is not None,
        None if batch.resnet_feats is None else tuple(batch.resnet_feats.shape),
        None if batch.patch_masks is None else tuple(batch.patch_masks.shape),
    )


def packed_text_loss(params, model_cfg: ModelConfig, crit_cfg: CriterionConfig,
                     group: Dict[str, TaskBatch], generator: Optional[torch.Generator],
                     update_num: int, comm=None) -> Tuple[List[str], List[CELossOut]]:
    """ONE forward for G same-shape tasks; the criterion runs per task on its
    rows, so drop-worst ranking, R-Drop halves and token counts stay per task."""
    names = sorted(group)
    G = len(names)
    bs = [group[n] for n in names]
    B = bs[0].src_tokens.shape[0]
    if any(b.src_tokens.shape[0] != B for b in bs):
        raise ValueError("packed tasks must share a batch size")

    def cat(field: str) -> Optional[torch.Tensor]:
        xs = [getattr(b, field) for b in bs]
        return None if xs[0] is None else torch.cat(xs, dim=0)

    src, prev, tgt = cat("src_tokens"), cat("prev_output_tokens"), cat("target")
    cm, feats, pmask = cat("constraint_masks"), cat("resnet_feats"), cat("patch_masks")
    conf = None
    if any(b.conf is not None for b in bs):
        # per-sample weights: members without them get neutral ones
        conf = torch.cat([b.conf if b.conf is not None
                          else torch.ones((B,), dtype=torch.float32, device=src.device)
                          for b in bs])
    dup = crit_cfg.use_rdrop
    if dup:
        src, prev, tgt, cm, conf, feats, pmask = map(_dup, (src, prev, tgt, cm, conf, feats, pmask))

    logits = ofa.forward(params, model_cfg, src, prev, generator=generator,
                         deterministic=generator is None, resnet_feats=feats, patch_masks=pmask)

    R = 2 if dup else 1

    def per_task(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """[R·G·B, ...] → [G, R·B, ...], each task's R-Drop halves together."""
        if x is None:
            return None
        x = x.reshape((R, G, B) + x.shape[1:]).transpose(0, 1)
        return x.reshape((G, R * B) + x.shape[3:])

    logits_g, tgt_g, cm_g, conf_g = map(per_task, (logits, tgt, cm, conf))
    opts = _ce_options(model_cfg, crit_cfg, update_num, True)
    opts["use_rdrop"] = dup
    outs = [label_smoothed_ce(logits_g[g], tgt_g[g],
                              constraint_masks=None if cm_g is None else cm_g[g],
                              conf=None if conf_g is None else conf_g[g], comm=comm, **opts)
            for g in range(G)]
    return names, outs


def _pack_vision_stem(params, model_cfg: ModelConfig,
                      batches: Dict[str, TaskBatch]) -> Dict[str, TaskBatch]:
    """ONE ResNet pass for all same-resolution vision batches; each task's
    feature slice rides in ``TaskBatch.resnet_feats``."""
    groups: Dict[tuple, list] = {}
    for name, b in batches.items():
        if b.patch_images is not None and b.resnet_feats is None:
            groups.setdefault(tuple(b.patch_images.shape[1:]), []).append(name)
    out = dict(batches)
    dtype = ofa.compute_dtype(model_cfg)
    for _, names in sorted(groups.items(), key=str):
        if len(names) < 2:
            continue
        imgs = torch.cat([batches[n].patch_images for n in names], dim=0)
        feats = resnet_forward(params["encoder"]["resnet"], imgs.to(dtype))
        off = 0
        for n in names:
            sz = batches[n].patch_images.shape[0]
            out[n] = batches[n]._replace(resnet_feats=feats[off:off + sz], patch_images=None)
            off += sz
    return out


def multitask_loss(params, model_cfg: ModelConfig, crit_cfg: CriterionConfig,
                   batches: Dict[str, TaskBatch], generator: Optional[torch.Generator],
                   update_num: int, pack_text: bool = True,
                   pack_vision: bool = True,
                   comm=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Σ_task loss_t / ntokens_t, and per-task metrics. With ``comm`` the
    batches are this rank's blocks and ntokens_t is the global count: the
    result is this rank's part of the global loss (the parts add up to it)."""
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    dt = ofa.compute_dtype(model_cfg)
    # expand the transport before the stem packing concatenates images
    batches = {n: dequantize_batch(b, dt) for n, b in batches.items()}
    if pack_vision:
        batches = _pack_vision_stem(params, model_cfg, batches)
    ordered = sorted(batches.items())

    groups: Dict[object, Dict[str, TaskBatch]] = {}
    singles = []
    if pack_text:
        for name, batch in ordered:
            key = _pack_key(batch)
            if key is None:
                singles.append((name, batch))
            else:
                groups.setdefault(key, {})[name] = batch
        # groups of one gain nothing: run them the plain way
        for key in list(groups):
            if len(groups[key]) == 1:
                singles.extend(groups.pop(key).items())
    else:
        singles = ordered

    def add(name: str, out: CELossOut) -> None:
        nonlocal total
        ntok = torch.clamp(out.ntokens, min=1.0)
        norm = out.loss / ntok
        total = total + norm
        metrics[f"loss/{name}"] = norm
        metrics[f"nll/{name}"] = out.nll_loss / ntok

    outs = [(name, task_loss(params, model_cfg, crit_cfg, batch, generator, update_num,
                             comm=comm))
            for name, batch in singles]
    # ordered by the key's text, as the JAX step's str(item) orders them (the
    # keys differ within that prefix); str() of an item would print tensors
    for _, group in sorted(groups.items(), key=lambda kv: str(kv[0])):
        outs += zip(*packed_text_loss(params, model_cfg, crit_cfg, group, generator, update_num,
                                      comm=comm))
    if comm is not None:  # every task's kept tokens over all ranks, in one collective
        ntok = comm.all_reduce(torch.stack([o.ntokens for _, o in outs]))
        outs = [(n, o._replace(ntokens=t)) for (n, o), t in zip(outs, ntok)]
    for name, out in outs:
        add(name, out)
    metrics["loss/total"] = total
    return total, metrics


def make_train_step(model_cfg: ModelConfig, crit_cfg: CriterionConfig, optim_cfg: OptimConfig,
                    ema_decay: float = 0.0, pack_text: bool = True, pack_vision: bool = True,
                    parallel=None):
    """Build the train step: ``(state, batches, generator) → (state, metrics)``.

    Every tensor in ``batches`` has a leading accumulation axis A (A = 1 for
    no accumulation). ``generator`` (None: no dropout) draws the dropout and
    drop-path masks on the batches' device. The step changes ``state``'s
    parameters and optimizer state in place and returns the state with its
    step advanced (or as it was, after a non-finite gradient). ``parallel``
    (a ``parallel.DataParallel``) makes it one rank's step of a run over the
    whole mesh (see the module docstring)."""
    tx = make_optimizer(optim_cfg)
    norm = global_norm if parallel is None else parallel.global_norm

    def step(state: TrainState, batches: Dict[str, TaskBatch],
             generator: Optional[torch.Generator] = None):
        params = (state.params if parallel is None
                  else parallel.gather(state.params, requires_grad=True))
        ps = [p for _, p in named_leaves(params)]
        for p in ps:
            p.grad = None
        A = next(iter(batches.values())).src_tokens.shape[0]
        loss_sum = 0.0
        scale = 1.0 if parallel is None else parallel.loss_scale
        # the backward too: a recomputed layer (remat) splits as its forward did
        with set_mesh(None if parallel is None else parallel.mesh):
            for a in range(A):
                micro = {n: TaskBatch(*[None if x is None else x[a] for x in b])
                         for n, b in batches.items()}
                loss, metrics = multitask_loss(params, model_cfg, crit_cfg, micro, generator,
                                               state.step, pack_text, pack_vision, comm=parallel)
                (loss if scale == 1.0 else loss * scale).backward()
                loss_sum = loss_sum + loss.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
        if parallel is not None:
            grads = parallel.reduce_grads(grads)
            keys = sorted(metrics)
            summed = parallel.all_reduce(
                torch.stack([metrics[k].detach() for k in keys] + [loss_sum]))
            metrics = dict(zip(keys, summed[:-1]))
            loss_sum = summed[-1]
        if A > 1:
            torch._foreach_div_(grads, float(A))
        gnorm = norm(grads)
        finite = bool(torch.isfinite(gnorm))
        if finite:
            tx.update(state.params, grads, state.opt_state, norm=norm)
        for p in ps:
            p.grad = None
        if state.ema_params is not None:
            ema_update(state.ema_params, state.params, ema_decay)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss_sum / A
        out["gnorm"] = gnorm
        out["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0)
        return state._replace(step=state.step + int(finite)), out

    return step
