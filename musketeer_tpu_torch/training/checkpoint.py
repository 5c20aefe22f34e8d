"""Checkpoint save and load for the training state, and ``.pt`` interchange
(port of ``musketeer_tpu/training/checkpoint.py``).

The JAX package writes its training state with orbax; the port writes it with
``torch.save``: one file ``<save_dir>/<name>`` holding the ``TrainState``'s
step, fp32 parameters, AdamW state (count and both moments) and EMA shadow,
and the same ``<name>.meta.json`` beside it. Saving a name that exists
replaces that checkpoint (written to a temporary file, then renamed). The
save policy is the JAX package's (ref: utils/checkpoint_utils.py:35-190):
``checkpoint_last``, ``checkpoint<epoch>`` at an epoch's end,
``checkpoint_<epoch>_<updates>`` on update intervals, ``checkpoint_best``
on improvement and the best k as ``checkpoint.best_<metric>_<value>``.

The orbax layout is not read: the fairseq ``.pt`` (``export_pt`` /
``import_pt``) is the interchange format between the two packages.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..params import map_leaves
from .train_state import TrainState


def _path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, name)


def _snapshot(state: TrainState) -> Dict[str, Any]:
    """The state's tensors copied to the host (the training step updates the
    state in place, so an asynchronous write must not read the live tensors)."""
    host = lambda t: t.detach().to("cpu", copy=True)
    opt = state.opt_state
    return {
        "step": int(state.step),
        "params": map_leaves(host, state.params),
        "opt_state": {"count": int(opt["count"]), "mu": map_leaves(host, opt["mu"]),
                      "nu": map_leaves(host, opt["nu"])},
        "ema_params": None if state.ema_params is None else map_leaves(host, state.ema_params),
    }


def _write(path: str, blob: Dict[str, Any], extra: Optional[Dict[str, Any]]) -> None:
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    if extra is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)


class _AsyncWriter:
    """One background write at a time; ``wait`` joins it and re-raises its error."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, *args) -> None:
        self.wait()

        def run():
            try:
                _write(*args)
            except BaseException as e:  # handed to the caller of wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_writer = _AsyncWriter()


def wait_for_saves() -> None:
    """Block until the in-flight asynchronous checkpoint write lands (raising
    its error, if it failed)."""
    _writer.wait()


def save_checkpoint(
    save_dir: str,
    state: TrainState,
    name: str = "checkpoint_last",
    extra: Optional[Dict[str, Any]] = None,
    async_save: bool = False,
) -> None:
    """Write ``state`` as ``<save_dir>/<name>`` (and ``extra`` as its meta).

    ``async_save=True`` returns once the tensors are copied to the host; the
    file is written on a thread (the reference's ioPath async writes, ref:
    train.py:84-92). Call :func:`wait_for_saves` before reading it back or
    exiting; ``load_checkpoint`` waits itself.
    """
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.abspath(_path(save_dir, name))
    blob = _snapshot(state)
    if async_save:
        _writer.submit(path, blob, extra)
    else:
        _writer.wait()  # an earlier asynchronous write of the same name lands first
        _write(path, blob, extra)


def _copy_into(dst, src):
    """``src``'s values into the tensors of ``dst`` (same structure) in place."""
    dl, sl = _leaves(dst), _leaves(src)
    if len(dl) != len(sl):
        raise ValueError(f"checkpoint tree has {len(sl)} leaves, the template {len(dl)}")
    with torch.no_grad():
        for d, s in zip(dl, sl):
            d.copy_(s)
    return dst


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    map_leaves(out.append, tree)
    return out


def load_checkpoint(
    save_dir: str, template: Optional[TrainState] = None, name: str = "checkpoint_last",
    device=None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Read ``<save_dir>/<name>`` → (TrainState, meta).

    With a ``template`` the values land in its tensors (their device and
    ``requires_grad`` kept). The saved tree may or may not carry an EMA
    shadow; the result follows the checkpoint, not the template, so that an
    EMA checkpoint restores into a template without one (eval with or without
    ``--use-ema``) and the other way round. Without a template the tensors land
    on ``device``, which the caller must then name (the card or the CPU), and
    the parameters require grad, as ``params.trainable`` makes them.
    """
    if template is None and device is None:
        raise ValueError("load_checkpoint without a template needs device= (the card or the CPU)")
    wait_for_saves()
    path = os.path.abspath(_path(save_dir, name))
    target = "cpu" if template is not None else device
    blob = torch.load(path, map_location=target, weights_only=True)
    if template is not None:
        params = _copy_into(template.params, blob["params"])
        opt = template.opt_state
        _copy_into(opt["mu"], blob["opt_state"]["mu"])
        _copy_into(opt["nu"], blob["opt_state"]["nu"])
        opt["count"] = blob["opt_state"]["count"]
        ema = blob["ema_params"]
        if ema is not None:
            if template.ema_params is None:
                ema = map_leaves(lambda p: p.detach().clone(), params)
            else:
                ema = template.ema_params
            _copy_into(ema, blob["ema_params"])
        state = TrainState(step=blob["step"], params=params, opt_state=opt, ema_params=ema)
    else:
        params = map_leaves(lambda p: p.requires_grad_(True), blob["params"])
        state = TrainState(step=blob["step"], params=params, opt_state=blob["opt_state"],
                           ema_params=blob["ema_params"])
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return state, meta


def load_state(save_dir: str, state: TrainState, parallel=None,
               name: str = "checkpoint_last") -> Tuple[TrainState, Dict[str, Any]]:
    """``load_checkpoint`` into ``state``'s layout: the whole state, or under
    ``parallel`` (a ``parallel.DataParallel``, ``state`` this rank's blocks)
    this rank's blocks of the full state, which every rank reads. A
    checkpoint saved at any ``data × fsdp`` layout resumes at any other."""
    if parallel is None:
        return load_checkpoint(save_dir, state, name)
    full, meta = load_checkpoint(save_dir, parallel.gather_state(state), name)
    return parallel.shard_state(full), meta


def save_state(state: TrainState, write: Callable[[TrainState], None], parallel=None) -> None:
    """``write(full state)``: ``state`` itself, or under ``parallel`` the state
    gathered from every rank's blocks, written by rank 0 between two barriers
    (every rank calls this; the write has landed when it returns)."""
    if parallel is None:
        write(state)
        return
    parallel.barrier()
    full = parallel.gather_state(state)
    if parallel.mesh.rank == 0:
        write(full)
        wait_for_saves()
    parallel.barrier()


def _remove(path: str) -> None:
    for p in (path, path + ".meta.json"):
        if os.path.exists(p):
            os.remove(p)


@dataclass
class CheckpointManager:
    """Save policy: last + epoch/interval + best-k by metric
    (ref: utils/checkpoint_utils.py:35-190)."""

    save_dir: str
    best_checkpoint_metric: str = "score"
    maximize_best_checkpoint_metric: bool = True
    keep_best_checkpoints: int = -1
    save_interval_updates: int = 0
    async_save: bool = False  # background writes (wait_for_saves to flush)

    def __post_init__(self):
        self._best: List[Tuple[float, str]] = []
        # the running best metric, tracked whatever keep_best_checkpoints says
        # (ref: utils/checkpoint_utils.py:42-83)
        self._best_val: Optional[float] = None

    def restore_policy(self, meta: Dict[str, Any]) -> None:
        """Re-seed the best-metric tracker from a resumed checkpoint's meta."""
        bv = meta.get("best_val")
        if bv is not None:
            self._best_val = float(bv)

    def _save(self, state, name, extra):
        save_checkpoint(self.save_dir, state, name, extra, self.async_save)

    def step(
        self,
        state: TrainState,
        epoch: int,
        num_updates: int,
        val_metric: Optional[float] = None,
        end_of_epoch: bool = False,
        steps_in_epoch: int = 0,
    ) -> List[str]:
        """Decide and perform the saves; returns the names written."""
        written = []
        sign = 1.0 if self.maximize_best_checkpoint_metric else -1.0
        is_best = val_metric is not None and (
            self._best_val is None or sign * val_metric >= sign * self._best_val
        )
        if is_best:
            self._best_val = float(val_metric)
        extra = {
            "epoch": epoch,
            "num_updates": num_updates,
            "val_metric": val_metric,
            "end_of_epoch": end_of_epoch,
            "steps_in_epoch": steps_in_epoch,
            "best_val": self._best_val,
        }
        if end_of_epoch:
            self._save(state, f"checkpoint{epoch}", extra)
            written.append(f"checkpoint{epoch}")
        if (self.save_interval_updates > 0 and not end_of_epoch and num_updates > 0
                and num_updates % self.save_interval_updates == 0):
            # a genuine mid-epoch update boundary (ref: checkpoint_utils.py:74-78)
            name = f"checkpoint_{epoch}_{num_updates}"
            self._save(state, name, extra)
            written.append(name)
        if val_metric is not None:
            if is_best:
                self._save(state, "checkpoint_best", extra)
                written.append("checkpoint_best")
            if self.keep_best_checkpoints > 0:
                name = f"checkpoint.best_{self.best_checkpoint_metric}_{val_metric:.4f}"
                self._save(state, name, extra)
                written.append(name)
                self._best.append((val_metric, name))
                self._best.sort(key=lambda t: -sign * t[0])
                if self._best[self.keep_best_checkpoints:]:
                    wait_for_saves()  # never remove a file still being written
                for _, old in self._best[self.keep_best_checkpoints:]:
                    _remove(_path(self.save_dir, old))
                self._best = self._best[: self.keep_best_checkpoints]
        self._save(state, "checkpoint_last", extra)
        written.append("checkpoint_last")
        return written


def export_pt(params, model_cfg, path: str) -> None:
    """The port's parameters → a fairseq-named ``.pt`` (``{"model": state_dict}``),
    readable by the reference stack and by the JAX package's ``import_pt``."""
    from ..convert import export_state_dict

    torch.save({"model": export_state_dict(params, model_cfg)}, path)


def import_pt(path: str, model_cfg=None, *, device, dtype: torch.dtype = torch.float32):
    """A reference (or ``export_pt``) ``.pt`` → (parameters on ``device`` in
    ``dtype``, ModelConfig). ``device`` has no default: the caller names the
    card or the CPU."""
    from ..convert import load_checkpoint as _load

    return _load(path, model_cfg, device=device, dtype=dtype)


def load_state_dict(path: str):
    """A torch ``.pt`` / ``.ckpt`` (a CLIP or VQGAN checkpoint) → its state
    dict on the CPU (a Lightning checkpoint's ``state_dict``)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd
