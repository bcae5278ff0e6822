"""Normalization statistics (counterpart of `vitiq/data/stats.py`; h5py is
imported inside `stats_from_hdf5`).

Reproduces the reference's seeded-subset recipe exactly
(ref: ViT/dataloader/dataset.py:116-158): min(5000, n) train indices drawn
with np.random.seed(norm_seed) WITHOUT replacement, read in sorted 500-row
chunks, global per-channel mean/std over all I (resp. Q) values, stds clamped
>= 1e-8. The reference computes std via torch's default UNBIASED estimator
(`Tensor.std()`), so ddof=1 here.

Evaluation re-derives the identical stats by re-running the train split with
the same seeds (ref: ViT/training/evaluate.py:124-134) — determinism is the
contract, and it is tested.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def compute_normalization_stats(
    read_rows: Callable[[np.ndarray], np.ndarray],
    indices: np.ndarray,
    seed: int = 49,
    num_samples: int = 5000,
    chunk_size: int = 500,
) -> Dict[str, float]:
    """`read_rows(sorted_row_indices) -> [n, L, 2]` abstracts the storage
    (HDF5 dataset, memmap, or in-memory array)."""
    num_samples = min(num_samples, len(indices))
    np.random.seed(seed)
    sample_indices = np.random.choice(indices, num_samples, replace=False)
    sorted_indices = np.sort(sample_indices)
    chunk_size = min(chunk_size, num_samples)

    i_vals, q_vals = [], []
    for i in range(0, len(sorted_indices), chunk_size):
        chunk = read_rows(sorted_indices[i:i + chunk_size]).astype(np.float32)
        i_vals.append(chunk[:, :, 0].ravel())
        q_vals.append(chunk[:, :, 1].ravel())
    i_all = np.concatenate(i_vals)
    q_all = np.concatenate(q_vals)
    return {
        "i_mean": float(i_all.mean()),
        "i_std": max(float(i_all.std(ddof=1)), 1e-8),  # torch .std() is unbiased
        "q_mean": float(q_all.mean()),
        "q_std": max(float(q_all.std(ddof=1)), 1e-8),
    }


def stats_from_array(x: np.ndarray, indices: np.ndarray, seed: int = 49,
                     num_samples: int = 5000) -> Dict[str, float]:
    return compute_normalization_stats(
        lambda rows: x[rows], indices, seed=seed, num_samples=num_samples
    )


def stats_from_hdf5(file_path: str, indices: np.ndarray, seed: int = 49,
                    num_samples: int = 5000) -> Dict[str, float]:
    import h5py

    with h5py.File(file_path, "r") as f:
        x = f["X"]
        return compute_normalization_stats(
            lambda rows: x[rows, ...], indices, seed=seed, num_samples=num_samples
        )
