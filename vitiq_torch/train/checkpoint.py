"""Checkpoints and parameter files in `vitiq`'s layout (counterpart of
`vitiq/train/checkpoint.py`).

A parameter file is an ``.npz`` of ``leaf_{i}`` f32 arrays, the leaves of the
`vitiq` parameter tree (`interop.vitiq_tree_from_state_dict`) in
`jax.tree_util.tree_flatten` order: dict keys sorted, lists in order. A
checkpoint is ``<path>.npz`` of the TrainState's leaves in the same order
(`optim.train_state_leaves`: the parameters, the learning rate and step
counts, AdamW's moments in vitiq's leaf order) plus ``<path>.json``, the
manifest (``format_version``, ``num_leaves``, ``epoch``, ``val_loss``,
``history``, ``config``, ``extra``). Each package therefore reads the
other's ``model_best.npz`` and resumes from the other's checkpoints, and the
port also loads a checkpoint that vitiq wrote under ``VITIQ_FUSED_OPT=0``
(its per-leaf optimizer state, `optim.fused_leaves_from_chain`). Loading
checks the leaf count and every leaf's shape against what a model of the
config has, and raises ValueError on a mismatch instead of loading garbage.

On a device mesh (a model sharded by `parallel.mesh.shard_model`) saving is
a collective of every rank: the tensor-parallel shards are gathered into
the whole parameters and moments first (`full_train_state`,
`full_state_dict`), rank 0 alone writes, and every rank waits at a barrier
until it has. The files are then the one-process layout, so a checkpoint
written under any mesh loads into a one-process model of either package;
to resume under a mesh, load it into a whole model and let `fit` shard it.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vitiq_torch.config import ExperimentConfig, ModelConfig
from vitiq_torch.interop import (
    state_dict_from_vitiq,
    tree_leaves,
    tree_unflatten,
    vitiq_tree_from_state_dict,
)
from vitiq_torch.parallel import comm
from vitiq_torch.parallel.mesh import full_state_dict, full_train_state, model_mesh
from vitiq_torch.train.optim import (
    TrainState,
    chain_leaf_count,
    fused_leaves_from_chain,
    train_state_from_leaves,
    train_state_leaves,
)

FORMAT_VERSION = 1


def _npz(path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(".npz")


def _barrier(model) -> None:
    """Every rank of a sharded model's process group waits for rank 0's
    write."""
    if model_mesh(model) is not None and comm.world_size() > 1:
        torch.distributed.barrier()


def save_checkpoint(path, state: TrainState, epoch: int, val_loss: float, history: Dict,
                    config: Optional[ExperimentConfig] = None,
                    extra: Optional[Dict] = None) -> Path:
    """Write ``<path>.npz`` (the TrainState's leaves) and ``<path>.json`` (the
    manifest); returns the npz path. On a mesh every rank calls it and rank 0
    writes the whole state (see the module docstring)."""
    npz = _npz(path)
    model = state.model
    state = full_train_state(state)
    if comm.rank() != 0:
        _barrier(model)
        return npz
    npz.parent.mkdir(parents=True, exist_ok=True)
    leaves = train_state_leaves(state)
    np.savez(npz, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    manifest = {
        "format_version": FORMAT_VERSION,
        "num_leaves": len(leaves),
        "epoch": epoch,
        "val_loss": float(val_loss),
        "history": history,
        "config": config.to_dict() if config is not None else None,
        "extra": extra or {},
    }
    npz.with_suffix(".json").write_text(json.dumps(manifest, indent=2))
    _barrier(model)
    return npz


def load_checkpoint(path, template_state: TrainState) -> Tuple[TrainState, Dict]:
    """Restore a checkpoint written by either package into the structure of
    `template_state` (built for the same config): the parameters are loaded
    into its model in place. A checkpoint of vitiq's per-leaf optimizer
    (``VITIQ_FUSED_OPT=0``) is taken into the flat state. Returns (state,
    manifest). Raises ValueError on a leaf count or a leaf shape the template
    does not have (nothing is loaded then), FileNotFoundError on a missing
    file."""
    npz = _npz(path)
    manifest = json.loads(npz.with_suffix(".json").read_text())
    want = [np.shape(leaf) for leaf in train_state_leaves(template_state)]
    n_params = len(want) - 6
    chain = manifest["num_leaves"] == chain_leaf_count(n_params)
    if chain:  # per-leaf mu and nu: trees shaped like the parameters
        params = want[:n_params]
        want = params + [(), (), ()] + params + params + [()]
    if manifest["num_leaves"] != len(want):
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves but the model/optimizer "
                         f"built from the current config has {len(want)} — config mismatch?")
    with np.load(npz) as data:
        leaves = []
        for i, shape in enumerate(want):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != shape:
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != expected {shape}")
            leaves.append(np.asarray(arr))
    if chain:
        leaves = fused_leaves_from_chain(leaves, n_params)
    return train_state_from_leaves(template_state, leaves), manifest


def save_params(path, state_dict, cfg: ModelConfig, model=None) -> Path:
    """Write a model's parameters (its state dict) as `vitiq`'s parameter
    file ``<path>.npz``; returns that path. With `model` sharded over a mesh,
    `state_dict` holds its shards: every rank calls it, the whole
    parameters are gathered and rank 0 writes them."""
    npz = _npz(path)
    if model is not None:
        state_dict = full_state_dict(model, state_dict)
        if comm.rank() != 0:
            _barrier(model)
            return npz
    npz.parent.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(vitiq_tree_from_state_dict(state_dict, cfg))
    np.savez(npz, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    if model is not None:
        _barrier(model)
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
    return state_dict_from_vitiq(tree_unflatten(template, iter(leaves)), cfg)
