"""Metrics aggregation, TensorBoard logging and profiling hooks (port of
``musketeer_tpu/training/metrics.py``).

A small smoothed-meter tree with derived metrics (ref: train.py:284-309,
trainer.py:1025-1036) and an optional TensorBoard writer
(``torch.utils.tensorboard``, where the ``tensorboard`` package is
installed; the JAX package writes with tensorflow's). Profiling uses
``torch.profiler`` where the JAX package uses ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class SmoothedMeter:
    """Running average (fairseq AverageMeter equivalent)."""

    def __init__(self, round_digits: int = 4):
        self.sum = 0.0
        self.count = 0
        self.last = 0.0
        self.round = round_digits

    def update(self, value: float, n: int = 1):
        self.sum += value * n
        self.count += n
        self.last = value

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self):
        self.sum, self.count, self.last = 0.0, 0, 0.0


def _ppl(avgs: Dict[str, float]) -> Optional[float]:
    """fairseq's perplexity 2^nll (ref: utils.get_perplexity) over the mean of
    the per-task nll meters the train step emits, capped at 2^30."""
    nlls = [v for k, v in avgs.items() if k == "nll" or k.startswith("nll/")]
    if not nlls:
        return None
    return float(2.0 ** min(sum(nlls) / len(nlls), 30.0))


class MetricsLogger:
    """Scalar aggregation, an optional TensorBoard writer and the ups meter.

    Derived metrics (the reference's ``metrics.log_derived``): register a
    name and a function of the averages dict with :meth:`log_derived`; ``ppl``
    is registered by default.
    """

    def __init__(self, tb_dir: Optional[str] = None):
        self.meters: Dict[str, SmoothedMeter] = defaultdict(SmoothedMeter)
        self._writer = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: log without it, as the JAX package does
                SummaryWriter = None
            if SummaryWriter is not None:
                self._writer = SummaryWriter(tb_dir)
        self._t0 = time.time()
        self._last_step = 0
        self._derived: Dict[str, object] = {}
        self.log_derived("ppl", _ppl)

    def log_derived(self, name: str, fn):
        """Register a derived metric: fn(averages_dict) -> float | None."""
        self._derived[name] = fn

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.meters[k].update(float(v), n)

    def log_step(self, step: int, values: Dict[str, float]):
        self.update(values)
        dt = time.time() - self._t0
        if dt > 0 and step > self._last_step:
            self.meters["ups"].update((step - self._last_step) / dt)
        self._t0 = time.time()
        self._last_step = step
        if self._writer is not None:
            for k, v in values.items():
                self._writer.add_scalar(k, float(v), step)
            for k, v in self._eval_derived().items():
                self._writer.add_scalar(k, v, step)

    def _eval_derived(self) -> Dict[str, float]:
        avgs = {k: m.avg for k, m in self.meters.items()}
        out = {}
        for name, fn in self._derived.items():
            v = fn(avgs)
            if v is not None:
                out[name] = float(v)
        return out

    def averages(self) -> Dict[str, float]:
        return {**{k: m.avg for k, m in self.meters.items()}, **self._eval_derived()}

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def flush(self):
        if self._writer is not None:
            self._writer.flush()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block (host and, where there is one, the CUDA
    device), its Chrome trace written to ``<log_dir>/trace.json`` on exit: the
    counterpart of the JAX package's ``jax.profiler`` trace (ref: train.py:537-540)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def named_scope(name: str):
    """A named range in ``torch.profiler`` traces (``record_function``; ref:
    trainer.py:848-894)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
