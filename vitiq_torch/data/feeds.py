"""Batch feeds for `fit` and the evaluations (counterpart of
`vitiq/data/feeds.py`).

* `ArrayFeed` holds whole splits in host memory: shuffled drop-last train
  batches (a permutation seeded `shuffle_seed + epoch`, so a resumed run sees
  the batch order of an uninterrupted one), padded eval batches with a valid
  mask, and raw (x, y, snr) batches.
* `StreamFeed` streams a split from storage through a per-epoch batch
  iterator (`HDF5DataSource.batch_stream`'s windowed reads or
  `PackedDataSource.batch_stream` over memory-mapped shards), epoch after
  epoch the same under `shuffle_seed + epoch`; `close()` releases its
  storage handle.

Both yield host numpy batches; `fit` and the evaluations copy them to the
card through `data/pipeline.py`'s `device_prefetch`. The per-process feed
(`ProcessShardFeed`) waits for the device mesh.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]                     # (x, y)
EvalBatch = Tuple[np.ndarray, np.ndarray, np.ndarray]     # (x, y, valid_mask)
RawBatch = Tuple[np.ndarray, np.ndarray, np.ndarray]      # (x, y, snr)


def _pad_eval(bx: np.ndarray, by: np.ndarray, batch_size: int) -> EvalBatch:
    """Pad a (possibly partial) final batch to full size with a valid mask,
    so padded rows score as zero."""
    n_valid = len(bx)
    if n_valid < batch_size:
        pad = batch_size - n_valid
        bx = np.concatenate([bx, np.zeros((pad,) + bx.shape[1:], bx.dtype)])
        by = np.concatenate([by, np.zeros((pad,), by.dtype)])
    mask = np.zeros(batch_size, np.float32)
    mask[:n_valid] = 1.0
    return bx, by, mask


class DataFeed:
    """Interface: per-epoch shuffled train batches, padded eval batches and
    raw (x, y, snr) batches."""

    num_samples: int

    def train_batches(self, epoch: int, batch_size: int) -> Iterator[Batch]:
        raise NotImplementedError

    def eval_batches(self, batch_size: int) -> Iterator[EvalBatch]:
        raise NotImplementedError

    def raw_batches(self, batch_size: int) -> Iterator[RawBatch]:
        """Sequential un-padded (x, y, snr) batches (the last may be partial)."""
        raise NotImplementedError

    def close(self) -> None:
        """Release any storage handle (nothing for in-RAM feeds)."""


class ArrayFeed(DataFeed):
    """In-RAM feed over (x, y[, snr]) arrays."""

    def __init__(self, x: np.ndarray, y: np.ndarray,
                 snr: Optional[np.ndarray] = None, shuffle_seed: int = 0):
        self.x, self.y = x, y
        self.snr = snr if snr is not None else np.zeros(len(x), np.float32)
        self.shuffle_seed = shuffle_seed
        self.num_samples = len(x)

    def train_batches(self, epoch: int, batch_size: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.shuffle_seed + epoch)
        perm = rng.permutation(self.num_samples)
        for start in range(0, self.num_samples - batch_size + 1, batch_size):
            idx = perm[start:start + batch_size]
            yield self.x[idx], self.y[idx]

    def eval_batches(self, batch_size: int) -> Iterator[EvalBatch]:
        for start in range(0, self.num_samples, batch_size):
            yield _pad_eval(self.x[start:start + batch_size],
                            self.y[start:start + batch_size], batch_size)

    def raw_batches(self, batch_size: int) -> Iterator[RawBatch]:
        for start in range(0, self.num_samples, batch_size):
            sl = slice(start, start + batch_size)
            yield self.x[sl], self.y[sl], self.snr[sl]


class StreamFeed(DataFeed):
    """Out-of-core feed over a per-epoch batch-iterator factory:
    `make_iter(batch_size, shuffle, seed, drop_last)` yields raw (x, y, snr)
    batches, the contract of `HDF5DataSource.batch_stream` and
    `PackedDataSource.batch_stream`. Each epoch's iterator is seeded
    `shuffle_seed + epoch`; `source` is the storage object behind
    `make_iter`, closed by `close()` (a streaming run opens one a split)."""

    def __init__(self, make_iter: Callable[..., Iterator[RawBatch]], num_samples: int,
                 shuffle_seed: int = 0, source=None):
        self._make_iter = make_iter
        self.num_samples = num_samples
        self.shuffle_seed = shuffle_seed
        self.source = source

    def close(self) -> None:
        if self.source is not None and hasattr(self.source, "close"):
            self.source.close()

    def train_batches(self, epoch: int, batch_size: int) -> Iterator[Batch]:
        it = self._make_iter(batch_size=batch_size, shuffle=True,
                             seed=self.shuffle_seed + epoch, drop_last=True)
        for bx, by, _ in it:
            yield bx, by

    def eval_batches(self, batch_size: int) -> Iterator[EvalBatch]:
        it = self._make_iter(batch_size=batch_size, shuffle=False, seed=0, drop_last=False)
        for bx, by, _ in it:
            yield _pad_eval(bx, by, batch_size)

    def raw_batches(self, batch_size: int) -> Iterator[RawBatch]:
        return self._make_iter(batch_size=batch_size, shuffle=False, seed=0, drop_last=False)


def as_feed(data, shuffle_seed: int = 0) -> DataFeed:
    """A DataFeed passes through; an (x, y) or (x, y, snr) tuple becomes an
    ArrayFeed."""
    if isinstance(data, DataFeed):
        return data
    return ArrayFeed(*data, shuffle_seed=shuffle_seed)
