"""Command-line entry points of the port: train / evaluate / evaluate-all /
convert / vqgan-encode (port of ``musketeer_tpu/cli.py``, with its flags and
defaults).

Usage:
  python -m musketeer_tpu_torch.cli train --tasks caption=path.tsv,vqa_gen=path2.tsv \\
      --arch ofa_base --description tep --save-dir ckpts [...]
  python -m musketeer_tpu_torch.cli train --criterion scst --tasks caption=refs.tsv [...]
  python -m musketeer_tpu_torch.cli train --criterion clip_scst --tasks image_gen=codes.tsv \\
      --clip-pt clip.pt --vqgan-pt vqgan.ckpt [...]
  python -m musketeer_tpu_torch.cli evaluate --task caption --data path.tsv \\
      --ckpt ckpts/checkpoint_best [--pt reference.pt]
  python -m musketeer_tpu_torch.cli convert --pt ofa_base.pt --out ckpts/converted
  python -m musketeer_tpu_torch.cli vqgan-encode --vqgan vqgan.ckpt --data images.tsv \\
      --out codes.tsv

Every command runs on ``--device`` (default ``cuda``, which must exist: the
port never falls back to the CPU unasked; ``--device cpu`` runs the kernels'
plain versions). The model config follows the JAX CLI's: ``evaluate`` and
``evaluate-all`` keep the preset's (or the ``.pt``'s) ``use_flash_attention``,
False, so they run the XLA attention branch as the JAX package's do; ``train``
sets it from ``--no-flash``. ``train --criterion scst|clip_scst`` runs the
reward fine-tuning loop (``training/scst_loop.py``).

``train`` runs one process per rank under ``torchrun`` (``env://``; NCCL for
``--device cuda``, each rank on the card of its local rank, gloo for
``--device cpu``): the ranks form the mesh's five axes and together compute
the step of one process on the same ``--batch-size``. ``--fsdp F`` shards
the state over F of them, ``--model-parallel M`` splits heads and FFN over
M (Megatron), ``--pipeline P --microbatches N`` splits the layer stacks into
P stages (GPipe; ``--pipeline-interleave V``: the interleaved schedule),
``--seq-parallel S`` runs ring attention over S; the rest form the data
axis. The model options follow the JAX CLI's: without ``--microbatches``
the pipe ranks run replicated, and the JAX gates that turn an axis off (the
SP gate under dropout, the pipeline gate under in-layer regularisation)
turn it off here. ``--remat`` checkpoints each encoder and decoder layer
(a pipeline stage under ``--microbatches``). ``--criterion scst|clip_scst``
runs on one rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

logger = logging.getLogger("musketeer_tpu_torch.cli")

TEXT_TASKS = ("gigaword", "cola", "sst2", "mrpc", "qqp", "qnli", "rte", "mnli")


def _add_common(p):
    p.add_argument("--arch", default="ofa_base")
    p.add_argument("--description", default="tep", choices=["base", "tep", "onehot"])
    p.add_argument("--patch-image-size", type=int, default=480)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda, which must be present)")


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def _preset(arch: str):
    """The preset as it is: ``use_flash_attention`` False, the XLA branch, as
    the JAX CLI's ``evaluate`` runs it."""
    from .config import ARCH_PRESETS

    return ARCH_PRESETS[arch]()


def _seeded_params(model_cfg, seed: int, device, dtype):
    """The port's seeded init (drawn on the CPU, so that every device gets
    the same numbers), as an inference or fp32 tree on ``device``."""
    import torch

    from .params import from_jax, init_ofa_params

    tree = init_ofa_params(model_cfg, torch.Generator().manual_seed(seed), "cpu")
    return from_jax(tree, model_cfg, device, dtype)


def _task_kwargs(name: str, patch_image_size: int) -> dict:
    return {} if name in TEXT_TASKS else {"patch_image_size": patch_image_size}


def _make_task(name: str, vocab, description: str, kw: dict):
    from .tasks import TASK_REGISTRY

    return TASK_REGISTRY[name](vocab, description=description, **kw)


def cmd_train(args):
    import torch

    from .parallel import init_distributed

    if args.criterion in ("scst", "clip_scst"):
        # reward fine-tuning (ref: criterions/scst_loss.py, clip_scst_loss.py;
        # BASELINE configs[4]); it warns on the flags it ignores, as the JAX CLI's
        from .training.scst_loop import run_scst_cli

        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise NotImplementedError(f"--criterion {args.criterion} runs on one rank")
        return run_scst_cli(args, _device(args.device))
    device = _device(args.device)
    local_rank = init_distributed(device)
    if local_rank is not None and device.type == "cuda":
        device = torch.device("cuda", local_rank)
    try:
        world = torch.distributed.get_world_size() if local_rank is not None else 1
        split = args.fsdp * args.model_parallel * args.pipeline * args.seq_parallel
        if world % split:
            raise ValueError(f"--fsdp x --model-parallel x --pipeline x --seq-parallel = {split} "
                             f"needs a multiple of {split} ranks, have {world} "
                             "(launch with torchrun --nproc_per_node=N)")
        return _train(args, device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, device):
    import torch

    from .config import CriterionConfig, MeshConfig, OptimConfig, TrainConfig
    from .params import trainable
    from .parallel import DataParallel, make_mesh
    from .tasks import MusketeerDataLoader, SubTaskSpec
    from .tokenization import default_vocab
    from .training import init_train_state, train_loop
    from .training.checkpoint import import_pt

    vocab = default_vocab()
    model_cfg = _preset(args.arch)
    specs = []
    for item in args.tasks.split(","):
        name, path = item.split("=", 1)
        specs.append(SubTaskSpec(name, path, batch_size=args.batch_size,
                                 src_len=args.src_bucket, tgt_len=args.tgt_bucket,
                                 task_kwargs=_task_kwargs(name, args.patch_image_size)))
    loader = MusketeerDataLoader(vocab, specs, description=args.description,
                                 eq_sampling=args.eq_sampling, update_freq=args.update_freq)
    cfg = TrainConfig(
        arch=args.arch,
        update_freq=args.update_freq,
        ema_decay=args.ema_decay,
        patience=args.patience,
        max_epoch=args.max_epoch,
        max_update=args.max_update,
        optim=OptimConfig(
            lr=args.lr, warmup_updates=args.warmup_updates,
            total_updates=args.total_updates, clip_norm=args.clip_norm,
            # embeddings are shared, so either flag freezes the one tensor
            # (ref: unify_transformer.py:380-384)
            freeze_params=("embed_tokens",)
            if (args.freeze_encoder_embedding or args.freeze_decoder_embedding) else (),
        ),
        stop_time_hours=args.stop_time_hours,
        prefetch_depth=args.prefetch_depth,
        async_save=args.async_save,
        save_interval_updates=args.save_interval_updates,
        validate_interval_updates=args.validate_interval_updates,
        keep_best_checkpoints=args.keep_best_checkpoints,
        criterion=CriterionConfig(
            label_smoothing=args.label_smoothing,
            drop_worst_ratio=args.drop_worst_ratio,
            drop_worst_after=args.drop_worst_after,
            drop_best_ratio=args.drop_best_ratio,
            drop_best_after=args.drop_best_after,
            encouraging_log_end=args.log_end,
            use_rdrop=args.use_rdrop,
        ),
        mesh=MeshConfig(data=-1, fsdp=args.fsdp, model=args.model_parallel,
                        pipe=args.pipeline, seq=args.seq_parallel),
    )
    if args.restore_pt:
        params, model_cfg = import_pt(args.restore_pt, model_cfg, device=device)
        logger.info("restored reference checkpoint %s", args.restore_pt)
    else:
        params = _seeded_params(model_cfg, cfg.seed, device, torch.float32)
    # training runs the flash branch unless --no-flash (the JAX CLI's default);
    # the JAX gates still send what its kernels lack (attention dropout,
    # patch subsampling, prompts, mixed code masks) to the XLA branch
    model_cfg = dataclasses.replace(model_cfg, use_flash_attention=not args.no_flash,
                                    remat=args.remat, unroll_layers=args.unroll_layers)
    if args.microbatches:
        model_cfg = dataclasses.replace(model_cfg, pipeline_microbatches=args.microbatches,
                                        pipeline_interleave=args.pipeline_interleave)
    elif args.pipeline_interleave > 1:
        logger.warning("--pipeline-interleave=%d is ignored without --microbatches "
                       "(the interleaved schedule only exists on the pipelined path)",
                       args.pipeline_interleave)
    if args.seq_parallel > 1:
        model_cfg = dataclasses.replace(model_cfg, seq_parallel=True)
    # the mesh over the ranks (one without a process group); every rank reads
    # the whole global batch, as the JAX package's one host does, and keeps its block
    mesh = make_mesh(cfg.mesh)
    parallel = DataParallel(mesh, params, model_cfg) if torch.distributed.is_initialized() else None
    lead = mesh.rank == 0

    validate_fn = None
    if args.valid_data:
        from .data import FileDataset

        # by default Musketeer monitors SNLI-VE only (ref: musketeer_task.py:545-559)
        vname = args.valid_task or "snli_ve"
        vtask = _make_task(vname, vocab, args.description,
                           _task_kwargs(vname, args.patch_image_size))
        vds = FileDataset(args.valid_data)  # read by every rank

        def validate_fn(state):
            m = vtask.evaluate(state.params, model_cfg, vds, batch_size=args.batch_size,
                               limit=args.valid_limit)
            metric = m.get("acc", m.get("cider", m.get("acc@0.5", 0.0)))
            if lead:
                logger.info("valid %s: %s", vname,
                            {k: v for k, v in m.items() if k not in ("pairs", "predictions")})
            return float(metric)

    params = trainable(params)
    if parallel is not None:
        params = parallel.shard(params)
    state = init_train_state(params, cfg.optim, ema_decay=cfg.ema_decay)
    if parallel is not None:
        logger.info("rank %d of %d (%s, mesh %s): %d bytes of state, %d on one rank",
                    mesh.rank, mesh.world, torch.distributed.get_backend(), mesh.shape,
                    parallel.state_bytes(state), parallel.state_bytes(state, full=True))
    try:
        state = train_loop(cfg, model_cfg, state, loader, validate_fn=validate_fn,
                           save_dir=args.save_dir, max_epoch=args.max_epoch,
                           resume=not args.no_resume, parallel=parallel)
    finally:
        loader.close()
    if lead:
        logger.info("done at update %d", state.step)
    return state


def _inference_tree(params, model_cfg, device):
    """An fp32 tree → the inference tree in the config's compute dtype on ``device``."""
    from .models.ofa import compute_dtype
    from .params import map_leaves, to_inference

    return map_leaves(lambda t: t.to(device), to_inference(params, compute_dtype(model_cfg)))


def _import_pt(path: str, device):
    """A ``.pt`` → (inference tree on ``device``, its inferred config)."""
    from .training.checkpoint import import_pt

    params, model_cfg = import_pt(path, device="cpu")  # cast, then moved to ``device``
    return _inference_tree(params, model_cfg, device), model_cfg


def _eval_params(args, model_cfg, device):
    """(params, model_cfg) for evaluate: a ``--pt`` ensemble, a ``--ckpt``
    training state (its EMA shadow with ``--use-ema``), or the seeded init."""
    from .models.ofa import compute_dtype
    from .training.checkpoint import load_checkpoint

    if args.pt:
        # comma-separated checkpoints → ensemble decoding (ref:
        # utils/checkpoint_utils.py:405-495; lprobs averaged per step)
        plist = []
        for path in (p for p in args.pt.split(",") if p):
            params, model_cfg = _import_pt(path, device)
            plist.append(params)
        if len(plist) > 1:
            if args.task not in ("caption", "refcoco", "gigaword"):
                raise ValueError("ensemble eval supports the generation tasks "
                                 f"(caption/refcoco/gigaword); {args.task} scores fixed "
                                 "candidates: run single-model")
            logger.info("ensemble of %d checkpoints", len(plist))
        return (plist[0] if len(plist) == 1 else plist), model_cfg
    if args.ckpt:
        state, _ = load_checkpoint(os.path.dirname(args.ckpt) or ".", None,
                                   os.path.basename(args.ckpt), device="cpu")
        if args.use_ema:
            if state.ema_params is None:
                raise ValueError("--use-ema: the checkpoint has no EMA shadow "
                                 "(trained without --ema-decay)")
            params = state.ema_params
        else:
            params = state.params
        return _inference_tree(params, model_cfg, device), model_cfg
    logger.warning("no checkpoint given; evaluating random init")
    return _seeded_params(model_cfg, 0, device, compute_dtype(model_cfg)), model_cfg


def cmd_evaluate(args):
    from .data import FileDataset
    from .models import ofa
    from .tokenization import default_vocab

    device = _device(args.device)
    vocab = default_vocab()
    params, model_cfg = _eval_params(args, _preset(args.arch), device)
    if args.int8_output_proj:
        params = ([ofa.quantize_output_proj(p) for p in params] if isinstance(params, list)
                  else ofa.quantize_output_proj(params))

    task_kw = _task_kwargs(args.task, args.patch_image_size)
    if args.answers_file:
        with open(args.answers_file) as f:
            task_kw["answers"] = [line.strip() for line in f if line.strip()]
    task = _make_task(args.task, vocab, args.description, task_kw)
    gen_overrides = {}
    if args.beam is not None:
        gen_overrides["beam_size"] = args.beam
    if args.max_len_b is not None:
        gen_overrides["max_len_b"] = args.max_len_b
    if args.diverse_groups:
        gen_overrides["diverse_beam_groups"] = args.diverse_groups
        gen_overrides["diversity_strength"] = args.diversity_strength
    if args.int8_kv_cache:
        gen_overrides["int8_cross_kv"] = True
    if gen_overrides:
        task.set_generation_overrides(**gen_overrides)
    dataset = FileDataset(args.data)
    try:
        if args.zero_shot:
            if not hasattr(task, "evaluate_zero_shot"):
                raise ValueError(f"task {args.task} has no zero-shot path")
            metrics = task.evaluate_zero_shot(params, model_cfg, dataset,
                                              batch_size=args.batch_size, limit=args.limit)
        elif args.beam_search_vqa_eval:
            if not hasattr(task, "evaluate_beam"):
                raise ValueError(f"task {args.task} has no beam-search eval path")
            metrics = task.evaluate_beam(params, model_cfg, dataset,
                                         batch_size=args.batch_size, limit=args.limit)
        else:
            metrics = task.evaluate(params, model_cfg, dataset, batch_size=args.batch_size,
                                    limit=args.limit)
    finally:
        dataset.close()
    preds = metrics.pop("predictions", None)
    metrics.pop("pairs", None)
    if args.results_json and preds is not None:
        # per-example predictions (the reference's test_predict.json)
        with open(args.results_json, "w") as f:
            json.dump([{"image_id": k, "caption": v} for k, v in preds.items()], f)
        logger.info("wrote %d predictions to %s", len(preds), args.results_json)
    out = {"task": args.task, **metrics}
    print(json.dumps(out))
    return out


def cmd_evaluate_all(args):
    """Every task of one checkpoint in one invocation (the reference's
    per-task evaluate.sh sweep). --tasks caption=path.tsv,refcoco=path.tsv,..."""
    from .data import FileDataset
    from .models import ofa
    from .models.ofa import compute_dtype
    from .tokenization import default_vocab

    device = _device(args.device)
    vocab = default_vocab()
    if args.pt:
        params, model_cfg = _import_pt(args.pt, device)
    else:
        logger.warning("no checkpoint given; evaluating random init")
        model_cfg = _preset(args.arch)
        params = _seeded_params(model_cfg, 0, device, compute_dtype(model_cfg))
    if args.int8_output_proj:
        params = ofa.quantize_output_proj(params)

    results = {}
    for item in args.tasks.split(","):
        name, path = item.split("=", 1)
        task = _make_task(name, vocab, args.description, _task_kwargs(name, args.patch_image_size))
        if args.int8_kv_cache:
            task.set_generation_overrides(int8_cross_kv=True)
        ds = FileDataset(path)
        try:
            m = task.evaluate(params, model_cfg, ds, batch_size=args.batch_size, limit=args.limit)
        finally:
            ds.close()
        m.pop("predictions", None)
        m.pop("pairs", None)
        results[name] = m
        logger.info("%s: %s", name, m)
    print(json.dumps(results))
    return results


def cmd_convert(args):
    """A reference ``.pt`` → a training-state checkpoint (``--out``) that
    ``train`` resumes from and ``evaluate --ckpt`` reads."""
    from .config import OptimConfig
    from .training import init_train_state
    from .training.checkpoint import import_pt, save_checkpoint

    device = _device(args.device)
    params, model_cfg = import_pt(args.pt, device=device)
    state = init_train_state(params, OptimConfig())
    save_checkpoint(os.path.dirname(args.out) or ".", state, os.path.basename(args.out),
                    {"source_pt": args.pt, "arch_embed_dim": model_cfg.embed_dim})
    logger.info("converted %s -> %s", args.pt, args.out)


def cmd_vqgan_encode(args):
    """Images → VQGAN code TSV rows (id, image, codes): the data preparation the
    reference assumes was done offline (its pure_image / image_gen TSVs carry
    code strings, ref: data/mm_data/image_gen_dataset.py)."""
    import numpy as np
    import torch

    from .data import FileDataset
    from .data.transforms import decode_base64_image
    from .models.vqgan import convert_vqgan_state_dict, encode_codes
    from .training.checkpoint import load_state_dict

    device = _device(args.device)
    params, vcfg = convert_vqgan_state_dict(load_state_dict(args.vqgan), gumbel=args.gumbel,
                                            device=device)
    if "encoder" not in params:
        raise ValueError("checkpoint has no encoder weights")
    ds = FileDataset(args.data)
    S = args.image_size
    n_written = 0
    try:
        with open(args.out, "w") as out, torch.inference_mode():
            for start in range(0, len(ds), args.batch_size):
                rows = ds.get_batch(list(range(start, min(start + args.batch_size, len(ds)))))
                imgs = np.stack([
                    np.asarray(decode_base64_image(r[1]).resize((S, S)), np.float32) / 127.5 - 1.0
                    for r in rows
                ])
                ids = encode_codes(params, vcfg, torch.from_numpy(imgs).to(device)).cpu().numpy()
                for r, row_ids in zip(rows, ids):
                    out.write(f"{r[0]}\t{r[1]}\t{' '.join(str(int(c)) for c in row_ids.reshape(-1))}\n")
                    n_written += 1
    finally:
        ds.close()
    if n_written > 0:
        logger.info("wrote %d code rows (%dx%d grid) to %s", n_written, ids.shape[1],
                    ids.shape[2], args.out)
    else:
        logger.info("wrote 0 code rows to %s (empty input)", args.out)
    return n_written


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("musketeer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train")
    _add_common(pt)
    pt.add_argument("--tasks", required=True, help="name=path.tsv[,name=path...]")
    pt.add_argument("--save-dir", default=None)
    pt.add_argument("--no-resume", action="store_true",
                    help="do not auto-restore checkpoint_last from --save-dir")
    pt.add_argument("--save-interval-updates", type=int, default=0,
                    help="mid-epoch checkpoint every N updates")
    pt.add_argument("--validate-interval-updates", type=int, default=0,
                    help="mid-epoch validation every N updates")
    pt.add_argument("--keep-best-checkpoints", type=int, default=-1)
    pt.add_argument("--async-save", action="store_true", help="background checkpoint writes")
    pt.add_argument("--restore-pt", default=None)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--warmup-updates", type=int, default=1000)
    pt.add_argument("--total-updates", type=int, default=30000)
    pt.add_argument("--max-epoch", type=int, default=1)
    pt.add_argument("--max-update", type=int, default=0)
    pt.add_argument("--update-freq", type=int, default=1)
    pt.add_argument("--clip-norm", type=float, default=1.0)
    pt.add_argument("--label-smoothing", type=float, default=0.1)
    pt.add_argument("--drop-worst-ratio", type=float, default=0.0)
    pt.add_argument("--drop-worst-after", type=int, default=0)
    pt.add_argument("--drop-best-ratio", type=float, default=0.0)
    pt.add_argument("--drop-best-after", type=int, default=0)
    pt.add_argument("--log-end", type=float, default=None,
                    help="enable encouraging loss with this log_end")
    pt.add_argument("--criterion", default="label_smoothed",
                    choices=["label_smoothed", "scst", "clip_scst"],
                    help="label_smoothed: multi-task CE (default); scst: CIDEr-reward "
                         "policy gradient on caption data; clip_scst: CLIP-reward policy "
                         "gradient on image_gen data")
    pt.add_argument("--scst-sample-beams", type=int, default=5,
                    help="sampled chains per example for SCST rewards")
    pt.add_argument("--scst-max-len-b", type=int, default=16,
                    help="max sampled caption length (scst)")
    pt.add_argument("--clip-pt", default=None, help="CLIP .pt checkpoint (clip_scst reward model)")
    pt.add_argument("--vqgan-pt", default=None,
                    help="VQGAN .pt/.ckpt checkpoint (clip_scst decoder)")
    pt.add_argument("--gumbel", action="store_true", help="--vqgan-pt is a GumbelVQ checkpoint")
    pt.add_argument("--use-rdrop", action="store_true")
    pt.add_argument("--freeze-encoder-embedding", action="store_true",
                    help="freeze the (shared) token embedding")
    pt.add_argument("--freeze-decoder-embedding", action="store_true",
                    help="freeze the (shared) token embedding / tied output projection")
    pt.add_argument("--stop-time-hours", type=float, default=0.0)
    pt.add_argument("--prefetch-depth", type=int, default=2,
                    help="background batch-prefetch queue depth (0 = off)")
    pt.add_argument("--no-flash", action="store_true",
                    help="train on the XLA attention branch (plain PyTorch products) "
                         "instead of the K3/K4 kernels")
    pt.add_argument("--remat", action="store_true",
                    help="activation checkpointing: each encoder and decoder layer's "
                         "activations are recomputed in the backward")
    pt.add_argument("--unroll-layers", action="store_true",
                    help="kept in the config for the JAX CLI's sake: the port's layer "
                         "loops are Python loops, always unrolled")
    pt.add_argument("--pipeline", type=int, default=1)
    pt.add_argument("--microbatches", type=int, default=0)
    pt.add_argument("--pipeline-interleave", type=int, default=1)
    pt.add_argument("--seq-parallel", type=int, default=1)
    pt.add_argument("--ema-decay", type=float, default=0.0)
    pt.add_argument("--patience", type=int, default=-1)
    pt.add_argument("--eq-sampling", type=int, default=0)
    pt.add_argument("--fsdp", type=int, default=1,
                    help="ranks (of torchrun's) that shard the parameters, AdamW state "
                         "and EMA; the rest of the ranks form the data axis")
    pt.add_argument("--model-parallel", type=int, default=1)
    pt.add_argument("--src-bucket", type=int, default=None)
    pt.add_argument("--tgt-bucket", type=int, default=None)
    pt.add_argument("--valid-task", default=None,
                    help="validation task (default snli_ve, the reference quirk)")
    pt.add_argument("--valid-data", default=None, help="validation TSV")
    pt.add_argument("--valid-limit", type=int, default=None)
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("evaluate")
    _add_common(pe)
    pe.add_argument("--task", required=True)
    pe.add_argument("--data", required=True)
    pe.add_argument("--ckpt", default=None)
    pe.add_argument("--pt", default=None,
                    help="reference fairseq .pt checkpoint; comma-separate several for "
                         "ensemble decoding (generation tasks)")
    pe.add_argument("--answers-file", default=None)
    pe.add_argument("--use-ema", action="store_true",
                    help="evaluate the EMA shadow params from the checkpoint")
    pe.add_argument("--beam-search-vqa-eval", action="store_true",
                    help="trie-constrained beam-search VQA eval instead of allcand scoring")
    pe.add_argument("--zero-shot", action="store_true",
                    help="zero-shot eval path (vqa_gen: no trie, open generation)")
    pe.add_argument("--beam", type=int, default=None)
    pe.add_argument("--max-len-b", type=int, default=None)
    pe.add_argument("--diverse-groups", type=int, default=0)
    pe.add_argument("--diversity-strength", type=float, default=0.5)
    pe.add_argument("--results-json", default=None,
                    help="dump per-example predictions (test_predict.json style)")
    pe.add_argument("--int8-output-proj", action="store_true",
                    help="serve with the int8 output projection (K2-q8)")
    pe.add_argument("--int8-kv-cache", action="store_true",
                    help="serve with an int8 cross-attention K/V cache")
    pe.set_defaults(fn=cmd_evaluate)

    pa = sub.add_parser("evaluate-all")
    _add_common(pa)
    pa.add_argument("--tasks", required=True, help="name=path.tsv[,name=path...]")
    pa.add_argument("--pt", default=None)
    pa.add_argument("--int8-output-proj", action="store_true")
    pa.add_argument("--int8-kv-cache", action="store_true")
    pa.set_defaults(fn=cmd_evaluate_all)

    pv = sub.add_parser("vqgan-encode")
    pv.add_argument("--vqgan", required=True, help="taming VQGAN .pt/.ckpt")
    pv.add_argument("--gumbel", action="store_true")
    pv.add_argument("--data", required=True, help="TSV: id \\t image_b64 [...]")
    pv.add_argument("--out", required=True, help="output TSV: id, image, codes")
    pv.add_argument("--image-size", type=int, default=256)
    pv.add_argument("--batch-size", type=int, default=16)
    pv.add_argument("--device", default="cuda",
                    help="torch device to encode on (default cuda, which must be present)")
    pv.set_defaults(fn=cmd_vqgan_encode)

    pc = sub.add_parser("convert")
    pc.add_argument("--pt", required=True)
    pc.add_argument("--out", required=True)
    pc.add_argument("--device", default="cuda",
                    help="torch device to convert on (default cuda, which must be present)")
    pc.set_defaults(fn=cmd_convert)
    return parser


def main(argv=None):
    """Parse ``argv`` and run the command; returns what the command returns
    (the final TrainState of ``train``, the metrics of the evaluations)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
