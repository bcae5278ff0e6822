"""Parameter files in `vitiq`'s layout (counterpart of
`vitiq/train/checkpoint.py: save_params, load_params`).

A parameter file is an ``.npz`` of ``leaf_{i}`` f32 arrays, the leaves of the
`vitiq` parameter tree (`interop.vitiq_tree_from_state_dict`) in
`jax.tree_util.tree_flatten` order: dict keys sorted, lists in order. Each
package therefore reads the other's ``model_best.npz``. Loading checks the
leaf count and every leaf's shape against the tree a model of the config
has, and raises on a mismatch instead of loading garbage.

Full `TrainState` checkpoints (the optimizer moments in `vitiq`'s leaf order)
and resuming from them are not ported yet.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, List

import numpy as np
import torch

from vitiq_torch.config import ModelConfig
from vitiq_torch.interop import state_dict_from_vitiq, vitiq_tree_from_state_dict


def tree_leaves(tree: Any) -> List[np.ndarray]:
    """The leaves of a nested dict / list tree in `jax.tree_util` order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        return {key: _unflatten(template[key], leaves) for key in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [_unflatten(item, leaves) for item in template]
    return next(leaves)


def _npz(path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(".npz")


def save_params(path, state_dict, cfg: ModelConfig) -> Path:
    """Write a model's parameters (its state dict) as `vitiq`'s parameter
    file ``<path>.npz``; returns that path."""
    npz = _npz(path)
    npz.parent.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(vitiq_tree_from_state_dict(state_dict, cfg))
    np.savez(npz, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    return npz


def load_params(path, cfg: ModelConfig) -> "OrderedDict[str, torch.Tensor]":
    """Read a parameter file written by either package into the state dict
    of an `AMCModel` for `cfg`. Raises ValueError when its leaf count or a
    leaf's shape differs from what `cfg` builds."""
    from vitiq_torch.models.amc import AMCModel

    template = vitiq_tree_from_state_dict(AMCModel(cfg).state_dict(), cfg)
    shapes = [leaf.shape for leaf in tree_leaves(template)]
    with np.load(_npz(path)) as data:
        names = [k for k in data.files if k.startswith("leaf_")]
        if len(names) != len(shapes):
            raise ValueError(f"{path}: {len(names)} leaves, but the model of this config has "
                             f"{len(shapes)}: config mismatch?")
        leaves = []
        for i, shape in enumerate(shapes):
            arr = np.asarray(data[f"leaf_{i}"], dtype=np.float32)
            if arr.shape != shape:
                raise ValueError(f"{path}: leaf {i} has shape {arr.shape}, the model of this "
                                 f"config expects {shape}")
            leaves.append(arr)
    return state_dict_from_vitiq(_unflatten(template, iter(leaves)), cfg)
