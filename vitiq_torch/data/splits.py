"""Deterministic dataset splitting and metadata (counterpart of
`vitiq/data/splits.py`, without scikit-learn).

The reference's split: 70/15/15 stratified jointly by (modulation x SNR)
through two chained ``train_test_split`` calls per stratum, then a final
seeded shuffle of each split (ref: ViT/dataloader/utils.py:58-148). Each
``train_test_split(idx, test_size=r, random_state=seed, shuffle=True)`` is one
``ShuffleSplit`` draw, which `shuffle_split` repeats with numpy: the
permutation of ``np.random.RandomState(seed)``, ``ceil(r * n)`` test rows
first, the rest for training, and the same ``ValueError`` where that leaves
no training row (a stratum of one frame). The same seeds give the same index
arrays, bit for bit.

Works over any label source: the HDF5 file's Y/Z datasets (h5py is imported
inside `load_dataset_metadata`) or in-memory arrays.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np


class SplitIndices(NamedTuple):
    train: np.ndarray
    valid: np.ndarray
    test: np.ndarray
    label_map: Dict[str, int]


def load_dataset_metadata(file_path: str, json_path: str):
    """Read labels and SNRs without touching X (ref:
    ViT/dataloader/utils.py:12-55). Returns (Y_strings, Z,
    available_modulations, total_samples)."""
    import h5py

    with h5py.File(file_path, "r") as f:
        total_samples = f["X"].shape[0]
        y_int = np.argmax(f["Y"][:], axis=1)
        z = f["Z"][:, 0]
    with open(json_path, "r") as f:
        modulation_classes = json.load(f)
    y_strings = np.array([modulation_classes[i] for i in y_int])
    available = list(np.unique(y_strings))
    return y_strings, z, available, total_samples


def shuffle_split(idx: np.ndarray, test_size: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) rows of `idx` as scikit-learn's
    ``train_test_split(idx, test_size=test_size, random_state=seed,
    shuffle=True)`` gives them for a float `test_size`."""
    n = len(idx)
    if test_size <= 0 or test_size >= 1:
        raise ValueError(f"test_size={test_size} should be either positive and smaller than "
                         f"the number of samples {n} or a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    if n - n_test == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and train_size=None, the "
                         "resulting train set will be empty. Adjust any of the aforementioned "
                         "parameters.")
    perm = np.random.RandomState(seed).permutation(n)
    return idx[perm[n_test:]], idx[perm[:n_test]]


def split_labels(
    y_strings: np.ndarray,
    z: np.ndarray,
    target_mods: Sequence[str],
    train_ratio: float,
    valid_ratio: float,
    test_ratio: float,
    seed: int,
) -> SplitIndices:
    """Stratified (modulation x SNR) split over in-memory label arrays: per
    stratum, split off `test_ratio`, then train/valid at
    valid / (train + valid), both seeded by `seed`; a single leftover frame
    goes to train; each split is then shuffled under
    ``np.random.seed(seed)`` (ref: ViT/dataloader/utils.py:96-148)."""
    if not np.isclose(train_ratio + valid_ratio + test_ratio, 1.0):
        raise ValueError("Ratios must sum to 1.0")

    label_map = {mod: i for i, mod in enumerate(target_mods)}
    train_indices: List[int] = []
    valid_indices: List[int] = []
    test_indices: List[int] = []

    for mod in target_mods:
        for snr in np.unique(z):
            idx = np.where((y_strings == mod) & (z == snr))[0]
            if len(idx) == 0:
                continue
            idx_train_val, idx_test = shuffle_split(idx, test_ratio, seed)
            relative_valid_ratio = valid_ratio / (train_ratio + valid_ratio)
            if len(idx_train_val) > 1:
                idx_train, idx_valid = shuffle_split(idx_train_val, relative_valid_ratio, seed)
            else:
                idx_train, idx_valid = idx_train_val, []
            train_indices.extend(idx_train)
            valid_indices.extend(idx_valid)
            test_indices.extend(idx_test)

    np.random.seed(seed)
    np.random.shuffle(train_indices)
    np.random.shuffle(valid_indices)
    np.random.shuffle(test_indices)
    return SplitIndices(
        np.array(train_indices), np.array(valid_indices), np.array(test_indices), label_map
    )


def split_data(
    file_path: str,
    json_path: str,
    target_mods: Sequence[str],
    train_ratio: float,
    valid_ratio: float,
    test_ratio: float,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, int]]:
    """HDF5-backed split with the reference's signature and return shape
    (ref: ViT/dataloader/utils.py:58-148)."""
    y_strings, z, _, _ = load_dataset_metadata(file_path, json_path)
    s = split_labels(y_strings, z, target_mods, train_ratio, valid_ratio, test_ratio, seed)
    return s.train, s.valid, s.test, s.label_map
