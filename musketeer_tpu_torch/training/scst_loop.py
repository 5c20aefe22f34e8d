"""SCST / CLIP-SCST training loop (port of ``musketeer_tpu/training/scst_loop.py``):
the reference's reward-criterion fine-tuning as ``cli train --criterion
scst|clip_scst`` (ref: criterions/scst_loss.py:80-223,
clip_scst_loss.py:109-140).

Its own loop beside ``trainer.train_loop``, since an SCST update is sample →
host-side reward (CIDEr-D or CLIP) → policy-gradient step, as in the JAX
package: the epoch order from ``np.random.RandomState(seed + epoch)``, each
update's sampling generator a function of ``(seed, updates)`` alone (as
``jax.random.fold_in(PRNGKey(seed), updates)`` is), keep-best on
``mean_reward`` at each epoch's end.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from ..config import GenerationConfig, ModelConfig, OptimConfig
from ..data.file_dataset import FileDataset
from ..data.task_data import CaptionBuilder, ImageGenBuilder, collate
from .checkpoint import CheckpointManager, wait_for_saves
from .train_state import init_train_state, make_optimizer
from .trainer import step_generator

logger = logging.getLogger("musketeer_tpu_torch.scst")


def scst_training(
    vocab,
    model_cfg: ModelConfig,
    params,  # trainable fp32 masters (params.trainable) on the run's device
    data_path: str,
    criterion: str = "scst",  # 'scst' | 'clip_scst'
    optim: Optional[OptimConfig] = None,
    batch_size: int = 2,
    sample_beams: int = 5,
    max_len_b: int = 16,
    max_epoch: int = 1,
    max_update: int = 0,
    save_dir: Optional[str] = None,
    description: str = "tep",
    patch_image_size: int = 480,
    limit: Optional[int] = None,
    log_interval: int = 10,
    seed: int = 7,
    image_gen_task=None,  # required for clip_scst (carries CLIP + VQGAN)
    shard_id: int = 0,
    num_shards: int = 1,
):
    """Run reward fine-tuning; returns the final TrainState.

    scst: caption TSVs (id, image_b64, 'ref1&&ref2&&...'): K sampled captions
    an image, CIDEr-D reward, leave-one-out baseline (ref: scst_loss.py:139-180).
    clip_scst: image_gen TSVs (id, caption, codes): K sampled code sequences,
    frozen-VQGAN decode, frozen-CLIP reward (ref: clip_scst_loss.py:109-140).
    """
    from ..criterions.clip_scst import clip_scst_train_step
    from ..criterions.scst import make_scst_fns, scst_train_step

    if criterion not in ("scst", "clip_scst"):
        raise ValueError(f"criterion {criterion!r}: scst or clip_scst")
    optim = optim or OptimConfig()
    tx = make_optimizer(optim)
    state = init_train_state(params, optim)
    device = params["embed_tokens"].device

    gen_code = criterion == "clip_scst"
    if gen_code:
        if image_gen_task is None:
            raise ValueError("clip_scst needs an ImageGenTask with CLIP + VQGAN weights "
                             "(cli: --clip-pt and --vqgan-pt)")
        image_gen_task.sampling_times = sample_beams
        gen_cfg = image_gen_task.generation_config()
        builder = ImageGenBuilder(vocab, description=description,
                                  code_image_size=image_gen_task.code_image_size)
    else:
        gen_cfg = GenerationConfig(beam_size=sample_beams, max_len_b=max_len_b, min_len=1,
                                   sampling=True)
        builder = CaptionBuilder(vocab, description=description, split="train", scst=True,
                                 patch_image_size=patch_image_size)

    sample_fn, grad_fn = make_scst_fns(model_cfg, gen_cfg, tx, gen_code=gen_code)

    ds = FileDataset(data_path, shard_id=shard_id, num_shards=num_shards)
    n_rows = ds.row_count if limit is None else min(limit, ds.row_count)
    if n_rows < batch_size:
        raise ValueError(f"{n_rows} rows < batch {batch_size}")
    ckpt_mgr = (CheckpointManager(save_dir, best_checkpoint_metric="mean_reward",
                                  maximize_best_checkpoint_metric=True)
                if save_dir else None)

    updates = 0
    t0 = time.time()
    reward_meter = []
    try:
        for epoch in range(1, max_epoch + 1):
            order = np.random.RandomState(seed + epoch).permutation(n_rows)
            for start in range(0, n_rows - batch_size + 1, batch_size):
                idx = [int(order[start + j]) for j in range(batch_size)]
                batch = collate([builder(cols) for cols in ds.get_batch(idx)], pad_id=vocab.pad)
                rng = step_generator(seed, updates, device, 0)  # one rank: batch block 0
                if gen_code:
                    state, metrics = clip_scst_train_step(state, vocab, image_gen_task, grad_fn,
                                                          batch, model_cfg, rng)
                    reward = metrics["mean_clip_reward"]
                else:
                    state, metrics = scst_train_step(state, vocab, sample_fn, grad_fn, batch, rng,
                                                     max_len=max_len_b)
                    reward = metrics["mean_reward"]
                updates += 1
                reward_meter.append(float(reward))
                if updates % log_interval == 0:
                    logger.info("%s epoch %d update %d loss %.4f mean_reward %.4f ups %.2f",
                                criterion, epoch, updates, float(metrics["scst_loss"]),
                                float(np.mean(reward_meter[-log_interval:])),
                                updates / (time.time() - t0))
                if max_update and updates >= max_update:
                    break
            mean_r = float(np.mean(reward_meter)) if reward_meter else 0.0
            if ckpt_mgr is not None:
                ckpt_mgr.step(state, epoch, updates, mean_r, end_of_epoch=True)
            if max_update and updates >= max_update:
                break
    finally:
        ds.close()
    wait_for_saves()
    logger.info("%s done: %d updates, mean reward %.4f", criterion, updates,
                float(np.mean(reward_meter)) if reward_meter else 0.0)
    return state


def run_scst_cli(args, device):
    """``cli train --criterion scst|clip_scst`` (parsed CLI args) on ``device``."""
    from ..cli import _seeded_params
    from ..config import ARCH_PRESETS
    from ..params import trainable
    from ..tokenization import default_vocab
    from .checkpoint import import_pt, load_state_dict

    # one program: sample → host reward → PG step; the mesh, pipeline and
    # accumulation flags belong to the label-smoothed step and are not wired here
    ignored = [
        name for name, dflt in (
            ("fsdp", 1), ("model_parallel", 1), ("pipeline", 1), ("seq_parallel", 1),
            ("microbatches", 0), ("update_freq", 1), ("ema_decay", 0.0),
        )
        if getattr(args, name, dflt) != dflt
    ]
    if ignored:
        logger.warning(
            "--criterion %s ignores %s (reward fine-tuning runs the plain data-parallel loop; "
            "ref fine-tunes SCST the same way)",
            args.criterion, ", ".join(f"--{n.replace('_', '-')}" for n in ignored))

    vocab = default_vocab()
    if args.restore_pt:
        # the architecture inferred from the checkpoint's tensor shapes
        params, model_cfg = import_pt(args.restore_pt, None, device=device)
    else:
        model_cfg = ARCH_PRESETS[args.arch]()
        params = _seeded_params(model_cfg, 7, device, torch.float32)  # the JAX loop's PRNGKey(7)
    model_cfg = dataclasses.replace(model_cfg, use_flash_attention=not args.no_flash)

    items = [it.split("=", 1) for it in args.tasks.split(",")]
    if len(items) != 1:
        raise ValueError(f"--criterion {args.criterion} fine-tunes ONE task (caption for scst, "
                         f"image_gen for clip_scst); got {args.tasks}")
    task_name, data_path = items[0]

    image_gen_task = None
    if args.criterion == "clip_scst":
        if task_name != "image_gen":
            raise ValueError("clip_scst runs on image_gen data")
        if not (args.clip_pt and args.vqgan_pt):
            raise ValueError("clip_scst needs --clip-pt and --vqgan-pt checkpoints")
        from ..models.clip import convert_clip_state_dict
        from ..models.vqgan import convert_vqgan_state_dict
        from ..tasks.image_gen import ImageGenTask

        clip_params, clip_cfg = convert_clip_state_dict(load_state_dict(args.clip_pt),
                                                        device=device)
        vq_params, vq_cfg = convert_vqgan_state_dict(load_state_dict(args.vqgan_pt),
                                                     gumbel=args.gumbel, device=device)
        image_gen_task = ImageGenTask(
            vocab, description=args.description,
            code_image_size=model_cfg.code_image_size,
            clip_params=clip_params, clip_cfg=clip_cfg,
            vqgan_params=vq_params, vqgan_cfg=vq_cfg,
        )
    elif task_name != "caption":
        raise ValueError("scst runs on caption data")

    return scst_training(
        vocab, model_cfg, trainable(params), data_path,
        criterion=args.criterion,
        optim=OptimConfig(
            lr=args.lr, warmup_updates=args.warmup_updates,
            total_updates=args.total_updates, clip_norm=args.clip_norm,
            freeze_params=("embed_tokens",)
            if (args.freeze_encoder_embedding or args.freeze_decoder_embedding) else (),
        ),
        batch_size=args.batch_size,
        sample_beams=args.scst_sample_beams,
        max_len_b=args.scst_max_len_b,
        max_epoch=args.max_epoch or 1,
        max_update=args.max_update,
        save_dir=args.save_dir,
        description=args.description,
        patch_image_size=args.patch_image_size,
        limit=args.limit,
        image_gen_task=image_gen_task,
    )
