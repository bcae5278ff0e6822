"""Optimizer and train state (counterpart of `vitiq/train/optim.py`).

The reference's recipe: global-norm gradient clipping at 1.0, then
AdamW(lr, weight_decay, betas=(0.9, 0.99)), computed as one flat f32 vector
over every parameter (`make_optimizer`, the counterpart of
`_fused_clip_adamw`). The clip divides by ``norm + 1e-16`` as the JAX
package does (torch's `clip_grad_norm_` adds 1e-6). The learning rate is
mutable state in the optimizer state (`set_learning_rate`), where
`optax.inject_hyperparams` keeps it in the JAX package, so the host-side
plateau scheduler changes it between epochs.

The parameters live in the model (`TrainState.model`), and a step updates
them in place. Everything a step reads or advances lives on the parameters'
device and is updated in place, so that a CUDA graph captured over train
steps replays them: the step counter (`TrainState.step`, an int64 scalar),
AdamW's count (int32), mu and nu, and the learning rate (a float64 scalar:
`get_learning_rate` reads back exactly the value `set_learning_rate` wrote,
and the update rounds it to f32, as the Python float it replaced was
rounded). The bias corrections are read there from the count, with no host
tensor and no copy: 1 - b^c as the host computed it each step before (`torch.pow`
of 0-d f32 CPU tensors), tabulated once a beta up to the first count where it
is exactly 1 (`bias_corrections`: 165 entries at 0.9, 1,725 at 0.99), since
the card's f32 pow differs from the host's in the last bit at some counts;
every later count reads the table's last entry, 1, as the host form's pow
gives it there.
`set_learning_rate` fills the device scalar, so a captured graph sees the
plateau's new rate without a new capture.

On a mesh with a model axis above 1 (`make_optimizer(cfg, model)` of a
sharded model) the clip's global norm is vitiq's norm of the whole
parameters' gradient: the squares of the sharded gradients are summed over
the model group (one all-reduce of a scalar) and the replicated ones, the
same on every model rank, are counted once. The flat vectors (mu, nu, the
update) run over the rank's shards.

Checkpoint layout (`train_state_leaves`, `train_state_from_leaves`): the
leaves of `vitiq`'s TrainState under its default fused optimizer, in
`jax.tree_util` order -- the parameter tree's leaves (dict keys sorted,
kernels [in, out]), then `optax.inject_hyperparams`' step count (int32) and
learning rate (f32), then `FusedAdamWState`'s count (int32), mu [P] and nu
[P] (f32), then the step (int32). vitiq's mu and nu are `ravel_pytree` over
its parameter tree, in its leaf order and layouts; the port's are flat over
`model.parameters()` in torch layouts, so each is split per parameter and
taken through the same layout transform as the weights
(`interop.vitiq_tree_from_state_dict` / `state_dict_from_vitiq`), both ways.
`VITIQ_FUSED_OPT=0`, vitiq's per-leaf optax chain (clip, then optax's
adamw), keeps the same numbers in another structure: the parameters,
inject_hyperparams' count and learning rate, then `ScaleByAdamState`'s count
and mu and nu as trees like the parameters, then the step, 3 N + 4 leaves
for N parameter leaves (the fused layout has N + 6). Its mu and nu trees
raveled in leaf order are the fused layout's flat vectors, so
`fused_leaves_from_chain` turns such a checkpoint into the fused layout and
`train/checkpoint.load_checkpoint` loads it into the flat state. The port
writes only the fused layout.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vitiq_torch.config import TrainConfig
from vitiq_torch.parallel.comm import all_reduce_
from vitiq_torch.interop import (
    state_dict_from_vitiq,
    tree_leaves,
    tree_unflatten,
    vitiq_tree_from_state_dict,
)


class TrainState(NamedTuple):
    model: nn.Module  # holds the parameters
    opt_state: Any
    step: torch.Tensor  # int64 scalar on the parameters' device


class FusedAdamWState(NamedTuple):
    learning_rate: torch.Tensor  # float64 scalar on the device
    count: torch.Tensor  # int32 scalar on the device
    mu: torch.Tensor  # [P] first moment, flat over the parameters
    nu: torch.Tensor  # [P] second moment
    corrections: Tuple[torch.Tensor, torch.Tensor] = ()  # `bias_corrections` of b1, b2


CORRECTION_STEPS = 1 << 20  # the longest table of `bias_corrections`


@functools.lru_cache(maxsize=None)
def bias_corrections(beta: float) -> torch.Tensor:
    """1 - beta^c for c = 1, 2, ... in f32 on the CPU, each as the host form
    computed it (0-d f32 tensors, `torch.pow`), up to the first count where
    it is exactly 1.0; a beta whose table would pass CORRECTION_STEPS
    entries raises."""
    b = torch.tensor(beta, dtype=torch.float32)
    out = []
    for c in range(1, CORRECTION_STEPS + 1):
        out.append(1.0 - torch.pow(b, torch.tensor(float(c), dtype=torch.float32)))
        if out[-1] == 1.0:
            return torch.stack(out)
    raise ValueError(f"1 - {beta}^c is not 1.0 in f32 within {CORRECTION_STEPS} counts")


def _correction(table: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The bias correction at `count` (>= 1) from the device table; every
    count past it reads the last entry, 1.0."""
    # index_select, not table[t]: a tensor subscript reads t on the host
    idx = torch.clamp(count.long() - 1, max=table.shape[0] - 1).reshape(1)
    return torch.index_select(table, 0, idx).reshape(())


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of `value` made on `device` by a fill, not a host copy."""
    return torch.full((), value, dtype=dtype, device=device)


def _sharded_norm(model: Optional[nn.Module]):
    """(flat 0/1 mask of the sharded elements, model group) of a model
    sharded over a model axis above 1, else None."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or mesh.model_size == 1:
        return None
    from vitiq_torch.parallel.mesh import _spec_for

    mask = torch.cat([torch.full((p.numel(),), float(_spec_for(n) is not None),
                                 device=p.device) for n, p in model.named_parameters()])
    return mask, mesh.model_group


def make_optimizer(cfg: TrainConfig, model: Optional[nn.Module] = None) -> GradientTransformation:
    """clip-by-global-norm -> AdamW on ONE flat vector: init(params) ->
    state; update(grads, state, params) -> (updates, state), `grads` a list
    shaped like the parameters or one flat f32 vector, the updates a list
    shaped like the parameters, to be added to them. `update` advances the
    state's count, mu and nu in place and returns the same state. `model`,
    when it is sharded over a model axis above 1, makes the clip's norm the
    whole parameters' (see the module docstring)."""
    sharded = _sharded_norm(model)

    def square_norm(g: torch.Tensor) -> torch.Tensor:
        sq = torch.square(g)
        if sharded is None:
            return torch.sum(sq)
        mask, group = sharded
        shard = torch.sum(sq * mask).reshape(1)
        all_reduce_(shard, group)
        return torch.sum(sq * (1.0 - mask)) + shard[0]

    def init(params: Sequence[torch.Tensor]) -> FusedAdamWState:
        flat = _flat(params)
        return FusedAdamWState(learning_rate=_scalar(cfg.learning_rate, torch.float64, flat.device),
                               count=_scalar(0, torch.int32, flat.device),
                               mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
                               corrections=tuple(bias_corrections(b).to(flat.device)
                                                 for b in (cfg.adam_b1, cfg.adam_b2)))

    def update(grads: Sequence[torch.Tensor], state: FusedAdamWState,
               params: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], FusedAdamWState]:
        gflat = grads if isinstance(grads, torch.Tensor) else _flat(grads)
        pflat = _flat(params)
        gnorm = torch.sqrt(square_norm(gflat))
        scale = torch.clamp(cfg.grad_clip_max_norm / (gnorm + 1e-16), max=1.0)
        g = gflat * scale
        state.count.add_(1)
        torch.add(cfg.adam_b1 * state.mu, (1.0 - cfg.adam_b1) * g, out=state.mu)
        torch.add(cfg.adam_b2 * state.nu, (1.0 - cfg.adam_b2) * torch.square(g), out=state.nu)
        corr1, corr2 = (_correction(table, state.count) for table in state.corrections)
        mhat = state.mu / corr1
        vhat = state.nu / corr2
        upd = -state.learning_rate * (mhat / (torch.sqrt(vhat) + cfg.adam_eps)
                                      + cfg.weight_decay * pflat)
        updates = [u.view_as(p) for u, p in zip(upd.split([p.numel() for p in params]), params)]
        return updates, state

    return GradientTransformation(init, update)


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    params = list(model.parameters())
    return TrainState(model=model, opt_state=make_optimizer(cfg).init(params),
                      step=_scalar(0, torch.int64, params[0].device))


def get_learning_rate(state: TrainState) -> float:
    """The learning rate (reads the device scalar back to the host)."""
    return float(state.opt_state.learning_rate)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Host-side LR change between epochs: fills the device scalar in place
    (a graph captured over train steps reads the new rate) and returns the
    state."""
    state.opt_state.learning_rate.fill_(float(lr))
    return state


# --------------------------------------------------------------------------
# vitiq's checkpoint layout
# --------------------------------------------------------------------------

def _vitiq_flat(flat: torch.Tensor, model: nn.Module) -> np.ndarray:
    """A vector flat over `model.parameters()` (torch layouts) -> the same
    values raveled over vitiq's parameter tree (its leaf order, its layouts)."""
    named = list(model.named_parameters())
    pieces = flat.detach().cpu().float().split([p.numel() for _, p in named])
    sd = {name: piece.view(p.shape) for (name, p), piece in zip(named, pieces)}
    leaves = tree_leaves(vitiq_tree_from_state_dict(sd, model.cfg))
    return np.concatenate([leaf.reshape(-1) for leaf in leaves])


def _torch_flat(vec: np.ndarray, model: nn.Module) -> torch.Tensor:
    """The inverse of `_vitiq_flat`, on the model's device."""
    template = vitiq_tree_from_state_dict(model.state_dict(), model.cfg)
    shapes = [leaf.shape for leaf in tree_leaves(template)]
    parts = np.split(np.asarray(vec, np.float32), np.cumsum([int(np.prod(s)) for s in shapes])[:-1])
    sd = state_dict_from_vitiq(tree_unflatten(template, (p.reshape(s) for p, s in
                                                         zip(parts, shapes))), model.cfg)
    device = next(model.parameters()).device
    return torch.cat([sd[name].reshape(-1) for name, _ in model.named_parameters()]).to(device)


def train_state_leaves(state: TrainState) -> List[np.ndarray]:
    """The state as vitiq's TrainState leaves (see the module docstring);
    `state.model` is an `AMCModel` (its `cfg` gives the tree)."""
    model, opt = state.model, state.opt_state
    params = tree_leaves(vitiq_tree_from_state_dict(model.state_dict(), model.cfg))
    count = np.asarray(int(opt.count), np.int32)
    return params + [count, np.asarray(float(opt.learning_rate), np.float32), count.copy(),
                     _vitiq_flat(opt.mu, model), _vitiq_flat(opt.nu, model),
                     np.asarray(int(state.step), np.int32)]


def train_state_from_leaves(template: TrainState, leaves: Sequence[np.ndarray]) -> TrainState:
    """The inverse of `train_state_leaves`: loads the parameters into
    `template.model` and the optimizer state and step into the template's
    device tensors, all in place, and returns the template; the leaves'
    count and shapes must be `train_state_leaves(template)`'s
    (`load_checkpoint` checks them first)."""
    model, opt = template.model, template.opt_state
    tree = vitiq_tree_from_state_dict(model.state_dict(), model.cfg)
    n = len(tree_leaves(tree))
    _, lr, count, mu, nu, step = leaves[n:]
    model.load_state_dict(state_dict_from_vitiq(tree_unflatten(tree, iter(leaves[:n])),
                                                model.cfg))
    opt.learning_rate.fill_(float(lr))
    opt.count.fill_(int(count))
    opt.mu.copy_(_torch_flat(mu, model))
    opt.nu.copy_(_torch_flat(nu, model))
    template.step.fill_(int(step))
    return template


def chain_leaf_count(n_params: int) -> int:
    """The leaf count of vitiq's `VITIQ_FUSED_OPT=0` TrainState for
    `n_params` parameter leaves (see the module docstring)."""
    return 3 * n_params + 4


def fused_leaves_from_chain(leaves: Sequence[np.ndarray], n_params: int) -> List[np.ndarray]:
    """vitiq's `VITIQ_FUSED_OPT=0` TrainState leaves (the per-leaf optax
    chain: parameters, inject count, learning rate, Adam count, mu and nu as
    parameter trees, step) -> the fused layout's leaves (parameters, inject
    count, learning rate, count, flat mu, flat nu, step): mu and nu raveled
    in leaf order, as `ravel_pytree` ravels them."""
    if len(leaves) != chain_leaf_count(n_params):
        raise ValueError(f"a per-leaf optimizer state over {n_params} parameter leaves has "
                         f"{chain_leaf_count(n_params)} leaves, got {len(leaves)}")
    n = n_params
    params, (inject, lr, count) = list(leaves[:n]), leaves[n:n + 3]
    mu, nu = leaves[n + 3:2 * n + 3], leaves[2 * n + 3:3 * n + 3]

    def ravel(tree):
        return np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in tree])

    return params + [np.asarray(inject), np.asarray(lr), np.asarray(count), ravel(mu),
                     ravel(nu), np.asarray(leaves[-1])]
