"""Training state and optimizer (port of ``musketeer_tpu/training/train_state.py``).

fp32 master parameters (``params.trainable``) and the JAX package's optax
chain, restated:

1. freeze masks: gradients of frozen leaves set to zero, before the clip;
2. global-norm clip with optax's formula: ``g / ‖g‖ · max`` when ‖g‖ ≥ max;
3. AdamW: optax's ``scale_by_adam`` (bias-corrected moments, eps outside the
   square root), decoupled weight decay ``+ wd · p`` on every leaf, then
   ``−lr(count)``;
4. freeze masks on the updates (weight decay would move frozen leaves).

The optimizer keeps its own update count for the schedule and the bias
correction, separate from ``TrainState.step`` (optax does the same). Unlike
the functional JAX step, ``AdamW.update`` and ``ema_update`` change the
parameters and the optimizer state in place, which saves a copy of each.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import OptimConfig
from ..params import map_leaves
from .lr_schedule import polynomial_decay_schedule

Params = Dict[str, Any]


class TrainState(NamedTuple):
    step: int  # updates applied (num_updates)
    params: Params  # fp32 masters that require grad
    opt_state: Dict[str, Any]  # {"count": int, "mu": tree, "nu": tree}
    ema_params: Optional[Params]  # fp32 EMA shadow


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, leaf) pairs, with the JAX tree's paths: a layer list is
    the JAX package's stacked leaf (no index), a ResNet stage's first block
    is ``first`` and the others ``rest``."""
    out: List[Tuple[str, torch.Tensor]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += named_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        resnet_stage = ".resnet.layer" in f".{prefix}"
        for i, v in enumerate(tree):
            sub = f"{prefix}.{'first' if i == 0 else 'rest'}" if resnet_stage else prefix
            out += named_leaves(v, sub)
    else:
        out.append((prefix, tree))
    return out


def frozen_flags(params: Params, prefixes: Sequence[str]) -> List[bool]:
    """Per leaf (``named_leaves`` order): does its path start with a prefix?"""
    return [any(path == p or path.startswith(p + ".") for p in prefixes)
            for path, _ in named_leaves(params)]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) in fp32, each leaf's norm taken in fp64: an fp32 norm of a
    large leaf drifts by ~1e-4 relative on the CPU (optax's sum does not)."""
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


class AdamW:
    """The JAX package's optimizer chain (see the module docstring), in place."""

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = polynomial_decay_schedule(cfg)

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
        return {"count": 0, "mu": map_leaves(zeros, params), "nu": map_leaves(zeros, params)}

    @torch.no_grad()
    def update(self, params: Params, grads: List[torch.Tensor], opt_state: Dict[str, Any],
               norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm) -> None:
        """Apply one update to ``params`` and ``opt_state`` in place; ``grads``
        are aligned with ``named_leaves(params)`` and may be modified. ``norm``
        takes the clip's norm (a sharded state's global norm under FSDP)."""
        cfg = self.cfg
        names = named_leaves(params)
        ps = [p for _, p in names]
        mu = [m for _, m in named_leaves(opt_state["mu"])]
        nu = [v for _, v in named_leaves(opt_state["nu"])]
        frozen = frozen_flags(params, cfg.freeze_params) if cfg.freeze_params else None
        if frozen:
            grads = [torch.zeros_like(g) if f else g for g, f in zip(grads, frozen)]
        if cfg.clip_norm > 0:
            gn = float(norm(grads))
            if not gn < cfg.clip_norm:
                grads = torch._foreach_div(grads, gn)
                torch._foreach_mul_(grads, cfg.clip_norm)
        count = opt_state["count"] + 1
        torch._foreach_mul_(mu, cfg.adam_b1)
        torch._foreach_add_(mu, grads, alpha=1 - cfg.adam_b1)
        torch._foreach_mul_(nu, cfg.adam_b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - cfg.adam_b2)
        mu_hat = torch._foreach_div(mu, 1 - cfg.adam_b1 ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - cfg.adam_b2 ** count))
        torch._foreach_add_(denom, cfg.adam_eps)
        upd = torch._foreach_div(mu_hat, denom)
        if cfg.weight_decay:
            torch._foreach_add_(upd, ps, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(count - 1))
        if frozen:
            upd = [u for u, f in zip(upd, frozen) if not f]
            ps = [p for p, f in zip(ps, frozen) if not f]
        torch._foreach_add_(ps, upd)
        opt_state["count"] = count


def make_optimizer(cfg: OptimConfig) -> AdamW:
    return AdamW(cfg)


def init_train_state(params: Params, optim_cfg: OptimConfig, ema_decay: float = 0.0) -> TrainState:
    opt_state = make_optimizer(optim_cfg).init(params)
    ema = map_leaves(lambda p: p.detach().clone(), params) if ema_decay > 0 else None
    return TrainState(step=0, params=params, opt_state=opt_state, ema_params=ema)


@torch.no_grad()
def ema_update(ema_params: Params, params: Params, decay: float) -> Params:
    """ema ← decay · ema + (1 − decay) · params, in place; returns ``ema_params``."""
    es = [e for _, e in named_leaves(ema_params)]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, [p for _, p in named_leaves(params)], alpha=1.0 - decay)
    return ema_params
