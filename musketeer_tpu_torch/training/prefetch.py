"""Host/device overlap: a background thread that builds the next batches and
copies them to the device (port of ``musketeer_tpu/training/prefetch.py``).

The reference overlaps its input pipeline with fairseq's multi-worker
EpochBatchIterator (ref: tasks/ofa_task.py:118-162). Here the batch builders
(PIL decode, resize and augmentation for each task, collate) run in a daemon
thread feeding a bounded queue. With a ``device`` the thread also copies each
batch there, on a CUDA stream of its own, and waits for the copy before it
queues the batch, so the training step never waits on a host→device copy of
its input. One thread: PIL and numpy release the interpreter lock for their
heavy work.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator

import torch

_SENTINEL = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def move_to(item: Any, device) -> Any:
    """``item`` with every tensor in it (dicts, lists, tuples and NamedTuples
    such as ``TaskBatch``) on ``device``."""
    if isinstance(item, torch.Tensor):
        return item.to(device)
    if isinstance(item, dict):
        return {k: move_to(v, device) for k, v in item.items()}
    if isinstance(item, tuple) and hasattr(item, "_fields"):
        return type(item)(*(move_to(v, device) for v in item))
    if isinstance(item, (list, tuple)):
        return type(item)(move_to(v, device) for v in item)
    return item


def _tensors(item: Any) -> Iterator[torch.Tensor]:
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from _tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _tensors(v)


class PrefetchIterator(Iterator[Any]):
    """Wrap an iterator; a daemon thread stays ``depth`` items ahead and, with
    a ``device``, hands out the items already on it.

    Order-preserving and exception-transparent: anything the inner iterator
    (or the copy) raises re-raises at the consuming ``__next__``. ``close()``
    stops the producer promptly (used when the train loop breaks early); it
    is idempotent and also runs at exhaustion. The overlap statistics:
    ``producer_cpu_s`` (thread CPU time spent building and copying),
    ``producer_wall_s``, ``producer_items``, ``stall_s`` and ``stall_count``
    (the consumer blocked on an empty queue), ``consumed``.
    """

    def __init__(self, iterable: Iterable[Any], depth: int = 2, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._device = None if device is None else torch.device(device)
        self._cuda = self._device is not None and self._device.type == "cuda"
        self.producer_cpu_s = 0.0
        self.producer_wall_s = 0.0
        self.producer_items = 0
        self.stall_s = 0.0
        self.stall_count = 0
        self.consumed = 0
        self._thread = threading.Thread(target=self._produce, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _copy(self, item, stream):
        if self._device is None:
            return item
        if not self._cuda:
            return move_to(item, self._device)
        with torch.cuda.stream(stream):
            item = move_to(item, self._device)
        stream.synchronize()
        return item

    def _produce(self, it: Iterator[Any]) -> None:
        try:
            stream = torch.cuda.Stream(self._device) if self._cuda else None
            while True:
                w0 = time.perf_counter()
                c0 = time.thread_time()
                try:
                    item = next(it)
                except StopIteration:
                    break
                item = self._copy(item, stream)
                self.producer_cpu_s += time.thread_time() - c0
                self.producer_wall_s += time.perf_counter() - w0
                self.producer_items += 1
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised at the consumer's __next__
            self._put(_Raised(e))
            return
        self._put(_SENTINEL)

    def __iter__(self) -> "PrefetchIterator":
        return self

    def reset_stats(self) -> None:
        self.producer_cpu_s = self.producer_wall_s = self.stall_s = 0.0
        self.producer_items = self.stall_count = self.consumed = 0

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        dt = time.perf_counter() - t0
        self.stall_s += dt
        if dt > 1e-3:
            self.stall_count += 1
        self.consumed += 1
        if item is _SENTINEL:
            self._stop.set()
            raise StopIteration
        if isinstance(item, _Raised):
            self._stop.set()
            raise item.exc
        if self._cuda:
            # the copy's memory came from the producer's stream: tell the
            # caching allocator that the consumer's stream uses it now
            consumer = torch.cuda.current_stream(self._device)
            for t in _tensors(item):
                t.record_stream(consumer)
        return item

    def close(self) -> None:
        """Stop the producer and drop queued items (early loop exit)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
