"""Batch feeds for `fit` (counterpart of `vitiq/data/feeds.py`, in-RAM part).

`ArrayFeed` holds whole splits in host memory and yields numpy batches:
shuffled drop-last train batches (a permutation seeded `shuffle_seed +
epoch`, so a resumed run sees the batch order of an uninterrupted one) and
padded eval batches with a valid mask. The streaming and per-process feeds
(`StreamFeed`, `ProcessShardFeed`) are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

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
        raise NotImplementedError


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


def as_feed(data, shuffle_seed: int = 0) -> DataFeed:
    """A DataFeed passes through; an (x, y) or (x, y, snr) tuple becomes an
    ArrayFeed."""
    if isinstance(data, DataFeed):
        return data
    return ArrayFeed(*data, shuffle_seed=shuffle_seed)
