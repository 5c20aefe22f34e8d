"""Multi-rank runs on the CPU: gloo ranks spawned from one process.

``run_ranks`` runs a ``Job`` (the joint step on given parameters and
batches, optionally resumed from or saved to a checkpoint) on ``world``
ranks over a ``data × fsdp`` layout (``run_layouts``: several jobs and
layouts in turn on the same ranks) and returns rank 0's record: each
step's loss, gradient norm, metrics and seconds, the full state at the end,
the bytes of state each rank holds and, on cards, each rank's peak memory.
The ranks are gloo processes on the CPU, or NCCL processes with rank r on
card r (``device="cuda"``; their fp32 products in full fp32, no TF32).
``run_job`` runs the same job in this process without a process group.
``dryrun_multirank(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: one full multi-task step of a small
model over an ``n``-rank ``data × fsdp`` layout, checked against the
one-process run. ``run_cli_ranks`` runs ``cli.main`` on gloo ranks, as
``torchrun`` would launch it.

Each rank runs on one intra-op thread; ranks find each other at
``tcp://localhost:<a free port>``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import CriterionConfig, MeshConfig, ModelConfig, OptimConfig
from ..params import map_leaves
from ..training.checkpoint import load_state, save_checkpoint, save_state
from ..training.train_state import init_train_state, named_leaves
from ..training.train_step import make_train_step
from ..training.trainer import step_generator
from ..training.prefetch import move_to
from .data_parallel import DataParallel, state_bytes
from .mesh import make_mesh, shard_batches

_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass
class Job:
    """The joint step on ``params`` (an fp32 trainable tree in the port's
    layout) over each of ``steps`` (task → full global TaskBatch, with the
    accumulation axis); the state starts at ``update``. ``load_dir`` resumes
    from ``checkpoint_last`` there first; ``save_dir`` saves the state after
    the first step there."""

    model_cfg: ModelConfig
    crit_cfg: CriterionConfig
    optim_cfg: OptimConfig
    params: Any
    steps: List[Dict[str, Any]]
    update: int = 0
    ema_decay: float = 0.0
    seed: Optional[int] = None  # dropout generator seed (None: no dropout)
    load_dir: Optional[str] = None
    save_dir: Optional[str] = None
    keep_state: bool = True  # False: the record holds no tensors (timing runs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_job(job: Job, parallel: Optional[DataParallel] = None,
            device="cpu") -> Dict[str, Any]:
    """Run ``job`` on ``device`` in this process: alone, or as one rank of
    ``parallel``'s mesh (this rank's block of every batch). Returns the
    record (see the module docstring); the full state under ``parallel``."""
    device = torch.device(device)
    # the step updates in place: the job's tree is copied, or its blocks
    params = job.params if parallel is None else parallel.shard(job.params)
    params = map_leaves(lambda t: t.detach().to(device, copy=True).requires_grad_(True), params)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = init_train_state(params, job.optim_cfg, ema_decay=job.ema_decay)._replace(
        step=job.update)
    if job.load_dir is not None:
        state, _ = load_state(job.load_dir, state, parallel)
    step = make_train_step(job.model_cfg, job.crit_cfg, job.optim_cfg, ema_decay=job.ema_decay,
                           parallel=parallel)
    rank = 0 if parallel is None else parallel.mesh.rank
    metrics, secs = [], []
    for i, batches in enumerate(job.steps):
        if parallel is not None:
            batches = shard_batches(batches, parallel.mesh)
        batches = move_to(batches, device)
        gen = None if job.seed is None else step_generator(job.seed, state.step, device, rank)
        t0 = time.perf_counter()
        state, m = step(state, batches, gen)
        metrics.append({k: float(v) for k, v in m.items()})  # float() waits for the step
        secs.append(time.perf_counter() - t0)
        if i == 0 and job.save_dir is not None:
            save_state(state, lambda full: save_checkpoint(job.save_dir, full), parallel)
    rec = {"step": state.step, "metrics": metrics, "secs": secs, "state_bytes": state_bytes(state),
           "peak": torch.cuda.max_memory_allocated(device) if cuda else None}
    if job.keep_state:
        if parallel is not None:
            state = parallel.gather_state(state)
        leaves = lambda tree: [t.detach().to("cpu", copy=True) for _, t in named_leaves(tree)]
        rec.update(params=leaves(state.params), mu=leaves(state.opt_state["mu"]),
                   nu=leaves(state.opt_state["nu"]),
                   ema=None if state.ema_params is None else leaves(state.ema_params))
    return rec


def _rank_main(rank: int, world: int, port: int, runs: List[Tuple[int, Job]], out: str,
               device_type: str) -> None:
    torch.set_num_threads(1)
    kw = {}
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        backend, kw["device_id"] = "nccl", device
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=_TIMEOUT, **kw)
    try:
        records = []
        for fsdp, job in runs:
            mesh = make_mesh(MeshConfig(data=-1, fsdp=fsdp))
            rec = run_job(job, DataParallel(mesh, job.params), device)
            per_rank = [None] * world
            dist.all_gather_object(per_rank, (rec["peak"], rec["state_bytes"]))
            rec["peaks"] = [p for p, _ in per_rank]
            rec["rank_state_bytes"] = [b for _, b in per_rank]
            records.append(rec)
        if rank == 0:
            torch.save(records, out)
    finally:
        dist.destroy_process_group()


def run_layouts(world: int, runs: List[Tuple[int, Job]],
                device_type: str = "cpu") -> List[Dict[str, Any]]:
    """Run each ``(fsdp, job)`` of ``runs`` in turn on the same ``world``
    ranks (gloo on the CPU, or NCCL with ``device_type="cuda"``, rank r on
    card r), ``fsdp`` of them sharding the state (the rest the data axis);
    rank 0's records."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "records.pt")
        torch.multiprocessing.spawn(
            _rank_main, args=(world, _free_port(), runs, out, device_type), nprocs=world,
            join=True)
        return torch.load(out, weights_only=False)


def run_ranks(world: int, fsdp: int, job: Job, device_type: str = "cpu") -> Dict[str, Any]:
    """``run_layouts`` of the one run ``(fsdp, job)``."""
    return run_layouts(world, [(fsdp, job)], device_type)[0]


def _cli_main(rank: int, world: int, port: int, argv: List[str]) -> None:
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    from ..cli import main

    main(argv)


def run_cli_ranks(world: int, argv: List[str]) -> None:
    """``cli.main(argv)`` on ``world`` ranks, each with the environment
    ``torchrun --nproc_per_node=world`` gives it (``--device cpu``: gloo)."""
    torch.multiprocessing.spawn(_cli_main, args=(world, _free_port(), argv), nprocs=world,
                                join=True)


def demo_job(n: int) -> Job:
    """One update of a small ``ofa_tiny`` on three tasks (an image task and
    two text tasks that share a packed forward), two micro-batches each, with
    R-Drop and an active drop-worst, and no dropout."""
    from ..config import ofa_tiny
    from ..params import from_jax, init_ofa_params, trainable
    from ..training.train_step import TaskBatch

    cfg = dataclasses.replace(ofa_tiny(), dtype="float32", encoder_layers=1, decoder_layers=1,
                              resnet_layers=(1, 1, 1), use_flash_attention=True)
    tree = init_ofa_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = trainable(from_jax(tree, cfg, "cpu", torch.float32))
    rs = np.random.RandomState(0)
    B = 2 * n

    def batch(Ts, Tt, image):
        tok = lambda T: torch.from_numpy(rs.randint(4, 1000, (2, B, T)))
        kw = {}
        if image:
            kw = dict(patch_images=torch.from_numpy(rs.rand(2, B, 32, 32, 3).astype(np.float32)),
                      patch_masks=torch.ones(2, B, dtype=torch.bool))
        return TaskBatch(src_tokens=tok(Ts), prev_output_tokens=tok(Tt), target=tok(Tt), **kw)

    steps = [{"caption": batch(8, 5, True), "gigaword": batch(10, 4, False),
              "text_infilling": batch(10, 4, False)}]
    return Job(cfg, CriterionConfig(label_smoothing=0.1, use_rdrop=True, drop_worst_ratio=0.2),
               OptimConfig(lr=1e-4, warmup_updates=0, total_updates=10), params, steps,
               ema_decay=0.9)


def dryrun_multirank(n: int = 4, fsdp: Optional[int] = None,
                     device_type: str = "cpu") -> Dict[str, float]:
    """One full multi-task step over an ``n``-rank layout (``fsdp`` of the
    ranks, by default 2 where ``n`` is even, the rest ``data``) on gloo, or
    on NCCL with ``device_type="cuda"`` (n cards), against the one-process
    run on the CPU or card 0: loss, gradient norm and metrics to 1e-5
    relative, the parameters, AdamW moments and EMA after the update to
    1e-5 of the tree's largest value. Returns the multi-rank run's loss and
    gradient norm."""
    job = demo_job(n)
    if fsdp is None:
        fsdp = 2 if n % 2 == 0 else 1
    got = run_ranks(n, fsdp, job, device_type)
    want = run_job(job, device="cuda:0" if device_type == "cuda" else "cpu")
    for k, v in want["metrics"][0].items():
        g = got["metrics"][0][k]
        if abs(g - v) > 1e-5 * max(abs(v), 1e-12):
            raise AssertionError(f"dryrun_multirank({n}): {k} {g} against one rank's {v}")
    for key in ("params", "mu", "nu", "ema"):
        tol = 1e-5 * max(float(b.abs().max()) for b in want[key])
        for a, b in zip(got[key], want[key]):
            if float((a - b).abs().max()) > tol:
                raise AssertionError(f"dryrun_multirank({n}): {key} differs from one rank's")
    m = got["metrics"][0]
    backend = "NCCL" if device_type == "cuda" else "gloo"
    print(f"dryrun_multirank OK: {n} {backend} ranks, mesh data={n // fsdp} fsdp={fsdp}, "
          f"loss={m['loss']:.6f}, gnorm={m['gnorm']:.6f}")
    return {"loss": m["loss"], "gnorm": m["gnorm"]}
