"""Multi-rank runs on the CPU: gloo ranks spawned from one process.

``run_ranks`` runs a ``Job`` (the joint step on given parameters and
batches, optionally resumed from or saved to a checkpoint) on ``world``
ranks over a layout of the mesh's five axes (``run_layouts``: several jobs
and layouts in turn on the same ranks) and returns rank 0's record: each
step's loss, gradient norm, metrics and seconds, the full state at the end,
the bytes of state each rank holds (and as ``leaf_spec`` reckons them), the
attention kernels' launches over the steps and, on cards, each rank's peak
memory.
The ranks are gloo processes on the CPU, or NCCL processes with rank r on
card r (``device="cuda"``; their fp32 products in full fp32, no TF32).
``run_job`` runs the same job in this process without a process group.
``dryrun_multirank(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: one full multi-task step of a small
model over an ``n``-rank ``data × fsdp`` layout and, with ``layouts``, over
the model, pipe and seq axes (``AXES_LAYOUTS``), each checked against the
one-process run. ``run_cli_ranks`` runs ``cli.main`` on gloo ranks, as
``torchrun`` would launch it; ``run_fn`` runs any function on ranks.

Each rank runs on one intra-op thread; ranks find each other at
``tcp://localhost:<a free port>``. A spawn ends its ranks after its timeout,
so that a rank left waiting in a collective fails the caller, not hangs it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import faulthandler
import os
import socket
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
from .data_parallel import DataParallel, reckoned_state_bytes, state_bytes
from .mesh import DATA, FSDP, make_mesh, shard_batches

_TIMEOUT = datetime.timedelta(seconds=300)
_WATCH = 60.0  # seconds: a reported step that runs longer prints where the rank waits, so often


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
    report: Optional[str] = None  # a tag: each rank prints its steps and peak memory as it goes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _report(job: Job, parallel: Optional[DataParallel], device: torch.device, what: str) -> None:
    """With ``job.report``, one line of this rank's progress and its peak
    memory so far (on a card), printed at once: a rank that fails or is
    ended still shows how far it came."""
    if job.report is None:
        return
    rank = 0 if parallel is None else parallel.mesh.rank
    peak = (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if device.type == "cuda" else "")
    print(f"[{job.report} rank {rank}] {what}{peak}", flush=True)


def _attention_launches() -> Dict[str, int]:
    """The attention kernels' launch counts so far in this process (K1, K3,
    K4; a call on CPU tensors runs the plain version and counts nothing)."""
    from ..ops import flash_attention_bwd as kb
    from ..ops import flash_attention_infer as k1

    return {"K1": k1.flash_attention_inference.launches, "K3": kb.flash_attention_fwd.launches,
            "K4": kb.flash_attention_bwd.launches}


@contextlib.contextmanager
def _watch(job: Job, parallel: Optional[DataParallel], what: str):
    """With ``job.report``: while the block runs longer than ``_WATCH``
    seconds, print every ``_WATCH`` seconds where this rank is (the
    pipeline's clock and the collective it last posted, and every thread's
    stack), so that a run that hangs shows where each rank waits."""
    if job.report is None:
        yield
        return
    done = threading.Event()
    t0 = time.perf_counter()

    def watch():
        while not done.wait(_WATCH):
            rank, progress = (0, {}) if parallel is None else (parallel.mesh.rank,
                                                                dict(parallel.mesh.progress))
            print(f"[{job.report} rank {rank}] {what} running for "
                  f"{time.perf_counter() - t0:.0f} s; pipeline {progress}", flush=True)
            faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
            sys.stdout.flush()

    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    try:
        yield
    finally:
        done.set()
        thread.join()


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
    trees = 3 + (state.ema_params is not None)
    reckoned = (state_bytes(state) if parallel is None
                else reckoned_state_bytes(job.params, parallel.mesh, trees))
    _report(job, parallel, device, f"state {state_bytes(state) / 2**30:.3f} GiB (leaf_spec "
            f"reckons {reckoned / 2**30:.3f} GiB)")
    step = make_train_step(job.model_cfg, job.crit_cfg, job.optim_cfg, ema_decay=job.ema_decay,
                           parallel=parallel)
    block = 0 if parallel is None else parallel.mesh.index(DATA, FSDP)
    metrics, secs = [], []
    launches0 = _attention_launches()
    for i, batches in enumerate(job.steps):
        if parallel is not None:
            batches = shard_batches(batches, parallel.mesh)
        batches = move_to(batches, device)
        gen = None if job.seed is None else step_generator(job.seed, state.step, device, block)
        t0 = time.perf_counter()
        with _watch(job, parallel, f"step {i}"):
            state, m = step(state, batches, gen)
            metrics.append({k: float(v) for k, v in m.items()})  # float() waits for the step
        secs.append(time.perf_counter() - t0)
        _report(job, parallel, device, f"step {i}: loss {metrics[-1]['loss']:.6f}, "
                f"{secs[-1]:.2f} s")
        if i == 0 and job.save_dir is not None:
            save_state(state, lambda full: save_checkpoint(job.save_dir, full), parallel)
    rec = {"step": state.step, "metrics": metrics, "secs": secs, "state_bytes": state_bytes(state),
           "reckoned_bytes": reckoned,
           "launches": {k: n - launches0[k] for k, n in _attention_launches().items()},
           "peak": torch.cuda.max_memory_allocated(device) if cuda else None}
    if job.keep_state:
        if parallel is not None:
            state = parallel.gather_state(state)
        leaves = lambda tree: [t.detach().to("cpu", copy=True) for _, t in named_leaves(tree)]
        rec.update(params=leaves(state.params), mu=leaves(state.opt_state["mu"]),
                   nu=leaves(state.opt_state["nu"]),
                   ema=None if state.ema_params is None else leaves(state.ema_params))
    return rec


def spawn(fn, args: tuple, world: int, timeout: float = _TIMEOUT.total_seconds()) -> None:
    """``fn(rank, *args)`` in ``world`` processes; raises if one fails, and
    ends them all after ``timeout`` seconds (a rank left waiting in a
    collective for one that raised must not hang its caller)."""
    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=world, join=False,
                                                start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def _init_rank(rank: int, world: int, port: int, device_type: str, timeout: float):
    """Join the ranks' process group (one intra-op thread; NCCL with rank r on
    card r, fp32 products in full fp32, or gloo) → this rank's device."""
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
                            world_size=world, timeout=datetime.timedelta(seconds=timeout), **kw)
    return device


def _fn_main(rank: int, world: int, port: int, fn, args, mesh_cfg: MeshConfig, out: str,
             device_type: str, timeout: float) -> None:
    device = _init_rank(rank, world, port, device_type, timeout)
    try:
        result = fn(make_mesh(mesh_cfg), device, *args)
        torch.save(result, f"{out}.{rank}")
    except BaseException:
        # a rank that raises ends at once, so that the spawn sees it fail and
        # ends the rest: tearing the group down would wait on its peers,
        # which wait in a collective for this rank (NCCL)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def run_fn(world: int, fn, *args, mesh: MeshConfig = MeshConfig(), device_type: str = "cpu",
           timeout: float = 120.0) -> List[Any]:
    """``fn(mesh, device, *args)`` on ``world`` ranks laid out as ``mesh``
    (gloo, or NCCL with ``device_type="cuda"``) → each rank's result, in rank
    order. ``fn`` must be importable by name (a module-level function); a
    rank that has not finished after ``timeout`` seconds fails the call."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        spawn(_fn_main, (world, _free_port(), fn, args, mesh, out, device_type, timeout), world,
              timeout + 30)
        return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


def _layout(layout) -> MeshConfig:
    """A layout: a ``MeshConfig``, or an int, the fsdp size of a data × fsdp one."""
    return layout if isinstance(layout, MeshConfig) else MeshConfig(data=-1, fsdp=layout)


def _layouts_rank(mesh, device, runs) -> List[Dict[str, Any]]:
    records = []
    for layout, job in runs:
        mesh = make_mesh(_layout(layout))
        rec = run_job(job, DataParallel(mesh, job.params, job.model_cfg), device)
        per_rank = [None] * mesh.world
        dist.all_gather_object(per_rank, (rec["peak"], rec["state_bytes"], rec["reckoned_bytes"],
                                          rec["launches"]))
        rec["peaks"], rec["rank_state_bytes"], rec["rank_reckoned_bytes"], rec["rank_launches"] = (
            [r[i] for r in per_rank] for i in range(4))
        records.append(rec if mesh.rank == 0 else None)
    return records


def run_layouts(world: int, runs: List[Tuple[Any, Job]],
                device_type: str = "cpu", timeout: float = _TIMEOUT.total_seconds()
                ) -> List[Dict[str, Any]]:
    """Run each ``(layout, job)`` of ``runs`` in turn on the same ``world``
    ranks (gloo on the CPU, or NCCL with ``device_type="cuda"``, rank r on
    card r): a layout is a ``MeshConfig`` or the fsdp size of a data × fsdp
    one; rank 0's records."""
    return run_fn(world, _layouts_rank, runs, device_type=device_type, timeout=timeout)[0]


def run_ranks(world: int, fsdp, job: Job, device_type: str = "cpu") -> Dict[str, Any]:
    """``run_layouts`` of the one run ``(fsdp, job)`` (a layout)."""
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
    spawn(_cli_main, (world, _free_port(), argv), world)


def demo_job(n: int, layers: int = 1, **model) -> Job:
    """One update of a small ``ofa_tiny`` (``layers`` + ``layers`` layers, the
    config's other fields from ``model``) on three tasks (an image task and
    two text tasks that share a packed forward), two micro-batches of 2n rows
    each, with R-Drop and an active drop-worst, and no dropout."""
    from ..config import ofa_tiny
    from ..params import from_jax, init_ofa_params, trainable
    from ..training.train_step import TaskBatch

    cfg = dataclasses.replace(ofa_tiny(), dtype="float32", encoder_layers=layers,
                              decoder_layers=layers, resnet_layers=(1, 1, 1),
                              use_flash_attention=True, **model)
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


_NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                   encoder_drop_path_rate=0.0, decoder_drop_path_rate=0.0)

# the layouts over the model, pipe and seq axes that dryrun_multirank runs on
# four ranks (model 2 x fsdp 2 is __graft_entry__.dryrun_multichip(4)'s), with
# the model options each needs: 4 + 4 layers, dropout off (the SP gate)
AXES_LAYOUTS: Dict[str, Tuple[MeshConfig, Dict[str, Any]]] = {
    "model2_fsdp2": (MeshConfig(fsdp=2, model=2), {}),
    "model4": (MeshConfig(model=4), {}),
    "pipe4": (MeshConfig(pipe=4), dict(pipeline_microbatches=4)),
    "data2_pipe2_interleave2": (MeshConfig(pipe=2),
                                dict(pipeline_microbatches=2, pipeline_interleave=2)),
    "seq4": (MeshConfig(seq=4), dict(seq_parallel=True)),
}


def axes_job(name: Optional[str], n: int = 4, **model) -> Job:
    """``demo_job`` on 4 + 4 layers with dropout off and layout ``name``'s
    options (None: none), the config's other fields from ``model``."""
    return demo_job(n, layers=4, **_NO_DROPOUT, **(AXES_LAYOUTS[name][1] if name else {}),
                    **model)


def _check(what: str, got: Dict[str, Any], want: Dict[str, Any]) -> None:
    """Loss, gradient norm and metrics to 1e-5 relative; the parameters,
    AdamW moments and EMA after the update to 1e-5 of the tree's largest value."""
    for k, v in want["metrics"][0].items():
        g = got["metrics"][0][k]
        if abs(g - v) > 1e-5 * max(abs(v), 1e-12):
            raise AssertionError(f"{what}: {k} {g} against one rank's {v}")
    for key in ("params", "mu", "nu", "ema"):
        tol = 1e-5 * max(float(b.abs().max()) for b in want[key])
        for a, b in zip(got[key], want[key]):
            if float((a - b).abs().max()) > tol:
                raise AssertionError(f"{what}: {key} differs from one rank's")


def dryrun_multirank(n: int = 4, fsdp: Optional[int] = None,
                     device_type: str = "cpu", layouts: Sequence[str] = ()) -> Dict[str, Any]:
    """One full multi-task step over an ``n``-rank layout (``fsdp`` of the
    ranks, by default 2 where ``n`` is even, the rest ``data``) on gloo, or
    on NCCL with ``device_type="cuda"`` (n cards), against the one-process
    run on the CPU or card 0 (``_check``'s bounds); then, on the same ranks
    (n = 4), each of ``layouts`` (names of ``AXES_LAYOUTS``: the model, pipe
    and seq axes) against the one-process run of ``axes_job`` (a layout's
    options act only over a mesh, so one run serves them all). Returns each
    run's loss and gradient norm, by layout ("data_fsdp" first)."""
    job = demo_job(n)
    if fsdp is None:
        fsdp = 2 if n % 2 == 0 else 1
    if layouts and n != 4:
        raise ValueError("the model, pipe and seq layouts run on 4 ranks")
    runs = [(fsdp, job)] + [(AXES_LAYOUTS[name][0], axes_job(name)) for name in layouts]
    recs = run_layouts(n, runs, device_type)
    one = "cuda:0" if device_type == "cuda" else "cpu"
    backend = "NCCL" if device_type == "cuda" else "gloo"
    wants = [run_job(job, device=one)]
    if layouts:
        wants += [run_job(axes_job(None), device=one)] * len(layouts)
    out = {}
    for name, (layout, _), got, want in zip(["data_fsdp", *layouts], runs, recs, wants):
        _check(f"dryrun_multirank({n}) {name}", got, want)
        m = got["metrics"][0]
        sizes = dict(zip(("data", "fsdp", "model", "pipe", "seq"), _layout(layout).axis_sizes(n)))
        print(f"dryrun_multirank OK: {n} {backend} ranks, mesh "
              + " ".join(f"{k}={v}" for k, v in sizes.items() if v > 1 or k == "data")
              + f", loss={m['loss']:.6f}, gnorm={m['gnorm']:.6f}")
        out[name] = {"loss": m["loss"], "gnorm": m["gnorm"]}
    return out if layouts else out["data_fsdp"]
