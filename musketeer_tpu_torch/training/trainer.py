"""Training driver: epoch loop, validate-and-save, early stopping (port of
``musketeer_tpu/training/trainer.py``).

The train.py layer of the reference (ref: train.py:56-433) around the joint
step: for each epoch, step through the loader (prefetched on a thread, which
also copies each batch to the parameters' device) → validate (on the EMA
shadow when EMA is on) → checkpoint policy → early stop on patience (ref:
train.py:238-263). Mid-epoch validation and saves on update intervals,
``max_update`` and ``stop_time_hours`` stop the loop; a restart resumes from
``checkpoint_last`` at the same iterator position.

Each update's dropout generator is seeded from ``(cfg.seed, update)``, the
counterpart of the JAX loop's ``jax.random.fold_in(rng, host_step)``, so a
resumed run draws what a straight run draws; a rank of a multi-rank run
folds in the index of its batch block, so that the ranks of one block draw
alike.

With ``parallel`` (a ``parallel.DataParallel``) the loop is one rank's part
of a run over the whole mesh: every rank reads the loader's whole global
batch, as the JAX package's one host does, and keeps its block of it
(``parallel.shard_batches``). Checkpoints hold the full state, gathered
from the blocks and written by rank 0 between two barriers; a resume reads
the full state on every rank and keeps its blocks, so a checkpoint of any
layout resumes at any other. Every rank validates the gathered parameters
(the whole tree: replicated over ``model``) with the mesh active, as the JAX
loop validates inside its mesh, so that an encoder's pipeline or ring runs
over its ranks, and no rank waits in a collective (and into its backend's
timeout) while another validates; the metric, like every stop decision, is
rank 0's on every rank. Rank 0 alone logs and writes TensorBoard.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import TrainConfig
from .checkpoint import CheckpointManager, load_state, save_state, wait_for_saves
from .metrics import MetricsLogger
from .prefetch import PrefetchIterator, move_to
from .train_state import TrainState
from .train_step import make_train_step
from ..parallel.mesh import DATA, FSDP, set_mesh, shard_batches

logger = logging.getLogger("musketeer_tpu_torch")


class EarlyStopper:
    """ref: train.py:238-263 should_stop_early."""

    def __init__(self, patience: int, maximize: bool):
        self.patience = patience
        self.maximize = maximize
        self.best: Optional[float] = None
        self.num_runs = 0

    def should_stop(self, metric: Optional[float]) -> bool:
        if metric is None or self.patience <= 0:
            return False
        better = self.best is None or (metric > self.best if self.maximize else metric < self.best)
        if better:
            self.best = metric
            self.num_runs = 0
            return False
        self.num_runs += 1
        return self.num_runs >= self.patience


def step_generator(seed: int, update: int, device, batch_index: int = 0) -> torch.Generator:
    """The dropout generator of update ``update`` for the ranks that hold batch
    block ``batch_index`` (``mesh.index(DATA, FSDP)``; 0 is the one-process
    run's): a function of the three alone. Its seed is a hash of all three,
    so that no (seed, block) pair shares its stream with another's and every
    bit of ``seed`` reaches the low 32 bits, the only ones the CPU's mt19937
    generator keeps. Ranks that share a block (the model, pipe and seq axes)
    draw the same masks on the activations they replicate."""
    value = int(np.random.SeedSequence([seed, update, batch_index]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def train_loop(
    cfg: TrainConfig,
    model_cfg,
    state: TrainState,
    loader,  # MusketeerDataLoader or anything with set_epoch/epoch_iterator
    validate_fn: Optional[Callable[[TrainState], float]] = None,
    save_dir: Optional[str] = None,
    log_interval: int = 10,
    max_epoch: Optional[int] = None,
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
    resume: bool = True,
    tb_dir: Optional[str] = None,
    parallel=None,
) -> TrainState:
    """Train ``state`` on ``loader``'s batches; returns the final state.

    The batches go to the device of ``state``'s parameters. ``on_metrics``
    gets (updates, host metrics) every ``log_interval`` updates. ``parallel``
    (a ``parallel.DataParallel``; ``state`` then this rank's) runs one rank
    of a data × fsdp run (see the module docstring)."""
    device = state.params["embed_tokens"].device
    rank = 0 if parallel is None else parallel.mesh.rank
    block = 0 if parallel is None else parallel.mesh.index(DATA, FSDP)
    lead = rank == 0
    step_fn = make_train_step(model_cfg, cfg.criterion, cfg.optim, ema_decay=cfg.ema_decay,
                              parallel=parallel)
    if tb_dir is None and save_dir is not None:
        tb_dir = os.path.join(save_dir, "tb")
    mlog = MetricsLogger(tb_dir if lead else None)
    stopper = EarlyStopper(cfg.patience, cfg.maximize_best_checkpoint_metric)
    ckpt_mgr = CheckpointManager(
        save_dir,
        best_checkpoint_metric=cfg.best_checkpoint_metric,
        maximize_best_checkpoint_metric=cfg.maximize_best_checkpoint_metric,
        keep_best_checkpoints=cfg.keep_best_checkpoints,
        save_interval_updates=cfg.save_interval_updates,
        async_save=cfg.async_save,
    ) if save_dir and lead else None

    def save(st: TrainState, *args, **kw) -> None:
        """The checkpoint policy on the full state (rank 0 writes)."""
        if save_dir is not None:
            save_state(st, lambda full: ckpt_mgr.step(full, *args, **kw), parallel)

    def agreed(value):
        return value if parallel is None else parallel.broadcast_object(value)

    # auto-resume from checkpoint_last (ref: train.py:176-181, trainer.py:566-626:
    # the state and the iterator position)
    start_epoch, skip_steps = 1, 0
    if resume and save_dir is not None and os.path.isfile(os.path.join(save_dir, "checkpoint_last")):
        state, meta = load_state(save_dir, state, parallel)
        if meta.get("end_of_epoch", True):
            start_epoch = int(meta.get("epoch", 0)) + 1
        else:
            start_epoch = int(meta.get("epoch", 1))
            skip_steps = int(meta.get("steps_in_epoch", 0))
        if ckpt_mgr is not None:
            ckpt_mgr.restore_policy(meta)
        stopper.best = meta.get("best_val")
        if lead:
            logger.info("resumed from %s: update %d, epoch %d, skip %d steps",
                        os.path.join(save_dir, "checkpoint_last"), state.step, start_epoch,
                        skip_steps)

    max_epoch = max_epoch or cfg.max_epoch or 1
    train_t0 = time.time()
    host_step = int(state.step)

    def out_of_time() -> bool:
        # wall-clock budget (ref: train.py:387-397 stop_time_hours), rank 0's clock
        return cfg.stop_time_hours > 0 and agreed(
            (time.time() - train_t0) / 3600.0 > cfg.stop_time_hours)

    def run_validate(st: TrainState) -> Optional[float]:
        if validate_fn is None:
            return None
        # validate on the EMA shadow when EMA is on: best-checkpoint selection
        # follows the EMA metric (ref: trainer.py:1042-1101)
        if cfg.ema_decay > 0 and st.ema_params is not None:
            st = st._replace(params=st.ema_params)
        if parallel is None:
            return validate_fn(st)
        # every rank validates the gathered parameters (no rank waits in a
        # collective while another validates); rank 0's metric is the one kept
        st = st._replace(params=parallel.gather(st.params, full=True))
        with set_mesh(parallel.mesh, model_split=False, batch_local=False):
            return agreed(validate_fn(st))

    epoch = start_epoch
    while epoch <= max_epoch:
        loader.set_epoch(epoch)
        t0 = time.time()
        n_steps = skip_steps
        broke_early = False
        it = loader.epoch_iterator(skip_steps=skip_steps) if skip_steps else loader.epoch_iterator()
        prefetch = None
        if parallel is not None:
            it = (shard_batches(b, parallel.mesh) for b in it)
        if cfg.prefetch_depth > 0:
            it = prefetch = PrefetchIterator(it, cfg.prefetch_depth, device=device)
        else:
            it = (move_to(b, device) for b in it)
        try:
            for batches in it:
                state, metrics = step_fn(state, batches,
                                         step_generator(cfg.seed, host_step, device, block))
                n_steps += 1
                host_step += 1
                num_updates = host_step
                if (n_steps - skip_steps) % log_interval == 0:
                    ups = (n_steps - skip_steps) / (time.time() - t0)
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                    mlog.log_step(num_updates, host_metrics)
                    ppl = mlog.averages().get("ppl")
                    if lead:
                        logger.info("epoch %d step %d updates %d loss %.4f gnorm %.3f ups %.2f%s",
                                    epoch, n_steps, num_updates, host_metrics["loss"],
                                    host_metrics["gnorm"], ups,
                                    f" ppl {ppl:.2f}" if ppl is not None else "")
                    if on_metrics is not None:
                        on_metrics(num_updates, host_metrics)
                # mid-epoch validate / save on update intervals
                # (ref: train.py:366-433 validate_and_save)
                iv_val = (cfg.validate_interval_updates > 0
                          and num_updates % cfg.validate_interval_updates == 0)
                iv_save = (cfg.save_interval_updates > 0
                           and num_updates % cfg.save_interval_updates == 0)
                if iv_val or iv_save:
                    vm = run_validate(state) if iv_val else None
                    save(state, epoch, num_updates, vm, end_of_epoch=False,
                         steps_in_epoch=n_steps)
                    if iv_val and stopper.should_stop(vm):
                        logger.info("early stop at update %d (patience %d)", num_updates,
                                    cfg.patience)
                        wait_for_saves()
                        return state
                if cfg.max_update and num_updates >= cfg.max_update:
                    broke_early = True
                    break
                if out_of_time():
                    logger.info("stop_time_hours reached (%.2fh)", cfg.stop_time_hours)
                    broke_early = True
                    break
        finally:
            if prefetch is not None:  # idempotent; stops the producer on a break
                prefetch.close()
        skip_steps = 0

        if broke_early:
            # stopped mid-epoch: record the iterator position so that a restart
            # continues where this run left off (ref: trainer.py:566-626)
            save(state, epoch, host_step, None, end_of_epoch=False, steps_in_epoch=n_steps)
            break

        val_metric = run_validate(state)
        save(state, epoch, host_step, val_metric, end_of_epoch=True)
        if stopper.should_stop(val_metric):
            logger.info("early stop at epoch %d (patience %d)", epoch, cfg.patience)
            break
        if cfg.max_update and host_step >= cfg.max_update:
            break
        if out_of_time():
            break
        epoch += 1
    wait_for_saves()  # flush asynchronous checkpoint writes before returning
    return state
