"""Host-to-device feeding (counterpart of `vitiq/data/pipeline.py`): a
background thread keeps `prefetch_depth` batches ahead of the consumer, so
reading and copying batch N+1 overlaps step N.

`device_prefetch(batches, device)` on a CUDA device is the counterpart of the
JAX package's ``device_put`` in a worker thread. The worker, on the caller's
device, copies each numpy array of an item into a pinned host buffer, starts
a ``non_blocking`` copy to the card on a side stream and records an event
after the item's copies. The consumer's current stream waits on that event
before the item is yielded, and each tensor is marked with `record_stream`,
so the caching allocator cannot hand its memory out again while the consumer
still uses it. A pinned buffer is refilled only after its last copy's event
has completed (two buffers a shape and dtype, in turns). An item is a tuple
(or list) of arrays, or one array, which comes back as one tensor; elements
of an item that are not numpy arrays pass through unchanged. There is no fallback: on a
CUDA device without CUDA it raises. On the CPU it is a plain thread
prefetcher that yields the items as they come. A worker's error reaches the
consumer where the stream ends.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

PINNED_SLOTS = 2  # pinned buffers a (shape, dtype), refilled in turns


class Prefetcher:
    """Wrap a batch iterable; a daemon thread keeps a queue of
    `prefetch_depth` items full, `transform` applied to each in the thread.
    Iterate it once. `close()` (also run when the iteration ends or is
    abandoned) stops the thread."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, prefetch_depth: int = 3,
                 transform: Optional[Callable] = None):
        if prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be at least 1, got {prefetch_depth}")
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    if self._stop.is_set():
                        return
                    if transform is not None:
                        item = transform(item)
                    if not self._put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                self._err = e
            finally:
                self._put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="vitiq-torch-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _receive(self, item):
        return item

    def __iter__(self) -> Iterator:
        try:
            while True:
                item = self._queue.get()
                if item is self._SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield self._receive(item)
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()
        while True:  # free a worker blocked on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self._thread is not threading.current_thread():
            self._thread.join()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class CudaPrefetcher(Prefetcher):
    """`Prefetcher` that copies each item's numpy arrays to a CUDA device
    through pinned buffers on a side stream (see the module docstring)."""

    def __init__(self, iterable: Iterable, device: torch.device, prefetch_depth: int = 3):
        self._device = device
        self._stream = torch.cuda.Stream(device=device)
        self._rings: dict = {}
        self._turns: dict = {}
        super().__init__(iterable, prefetch_depth, transform=self._to_device)

    def _slot(self, shape, dtype) -> list:
        """[pinned buffer, event of its last copy] for the next copy of this
        shape and dtype; waits until that buffer's last copy has completed."""
        key = (shape, dtype)
        ring = self._rings.setdefault(key, [])
        turn = self._turns.get(key, 0)
        self._turns[key] = turn + 1
        if len(ring) < PINNED_SLOTS:
            ring.append([torch.empty(shape, dtype=dtype, pin_memory=True), None])
            return ring[-1]
        slot = ring[turn % PINNED_SLOTS]
        slot[1].synchronize()
        return slot

    def _to_device(self, item):
        bare = isinstance(item, np.ndarray)  # one array, as vitiq's tree_map takes it
        out, used = [], []
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            for a in ((item,) if bare else item):
                if not isinstance(a, np.ndarray):
                    out.append(a)
                    continue
                slot = self._slot(a.shape, _torch_dtype(a.dtype))
                np.copyto(slot[0].numpy(), a)
                dev = torch.empty(a.shape, dtype=slot[0].dtype, device=self._device)
                dev.copy_(slot[0], non_blocking=True)
                out.append(dev)
                used.append(slot)
            event = torch.cuda.Event()
            event.record(self._stream)
        for slot in used:
            slot[1] = event
        return (out[0] if bare else tuple(out)), event

    def _receive(self, item):
        tensors, event = item
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(event)
        for t in (tensors if isinstance(tensors, tuple) else (tensors,)):
            if isinstance(t, torch.Tensor):
                t.record_stream(stream)
        return tensors


def device_prefetch(batch_iter: Iterable, device=None, prefetch_depth: int = 3) -> Prefetcher:
    """Prefetch batches and, on a CUDA `device`, copy their numpy arrays to
    it (see the module docstring); `device` None or the CPU prefetches the
    items as they are."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        return Prefetcher(batch_iter, prefetch_depth)
    if device.type != "cuda":
        raise ValueError(f"device_prefetch feeds the CPU or a CUDA device, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available: device_prefetch cannot copy to {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return CudaPrefetcher(batch_iter, device, prefetch_depth)
