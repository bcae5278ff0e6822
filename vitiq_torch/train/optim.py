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
them in place.

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
`VITIQ_FUSED_OPT=0`, vitiq's per-leaf optax chain, has another structure and
is not ported: its checkpoints have another leaf count.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vitiq_torch.config import TrainConfig
from vitiq_torch.interop import (
    state_dict_from_vitiq,
    tree_leaves,
    tree_unflatten,
    vitiq_tree_from_state_dict,
)


class TrainState(NamedTuple):
    model: nn.Module  # holds the parameters
    opt_state: Any
    step: int


class FusedAdamWState(NamedTuple):
    learning_rate: float
    count: int
    mu: torch.Tensor  # [P] first moment, flat over the parameters
    nu: torch.Tensor  # [P] second moment


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def make_optimizer(cfg: TrainConfig) -> GradientTransformation:
    """clip-by-global-norm -> AdamW on ONE flat vector: init(params) ->
    state; update(grads, state, params) -> (updates, state), the updates a
    list shaped like the parameters, to be added to them."""

    def init(params: Sequence[torch.Tensor]) -> FusedAdamWState:
        flat = _flat(params)
        return FusedAdamWState(learning_rate=cfg.learning_rate, count=0,
                               mu=torch.zeros_like(flat), nu=torch.zeros_like(flat))

    def update(grads: Sequence[torch.Tensor], state: FusedAdamWState,
               params: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], FusedAdamWState]:
        gflat, pflat = _flat(grads), _flat(params)
        gnorm = torch.sqrt(torch.sum(torch.square(gflat)))
        scale = torch.clamp(cfg.grad_clip_max_norm / (gnorm + 1e-16), max=1.0)
        g = gflat * scale
        count = state.count + 1
        mu = cfg.adam_b1 * state.mu + (1.0 - cfg.adam_b1) * g
        nu = cfg.adam_b2 * state.nu + (1.0 - cfg.adam_b2) * torch.square(g)
        c = torch.tensor(float(count), dtype=torch.float32)
        b1 = torch.tensor(cfg.adam_b1, dtype=torch.float32)
        b2 = torch.tensor(cfg.adam_b2, dtype=torch.float32)
        mhat = mu / (1.0 - torch.pow(b1, c)).to(mu.device)
        vhat = nu / (1.0 - torch.pow(b2, c)).to(nu.device)
        upd = -state.learning_rate * (mhat / (torch.sqrt(vhat) + cfg.adam_eps)
                                      + cfg.weight_decay * pflat)
        updates = [u.view_as(p) for u, p in zip(upd.split([p.numel() for p in params]), params)]
        return updates, state._replace(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    return TrainState(model=model, opt_state=make_optimizer(cfg).init(list(model.parameters())),
                      step=0)


def get_learning_rate(state: TrainState) -> float:
    return float(state.opt_state.learning_rate)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Host-side LR change between epochs."""
    return state._replace(opt_state=state.opt_state._replace(learning_rate=float(lr)))


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
    return params + [np.asarray(opt.count, np.int32), np.asarray(opt.learning_rate, np.float32),
                     np.asarray(opt.count, np.int32), _vitiq_flat(opt.mu, model),
                     _vitiq_flat(opt.nu, model), np.asarray(state.step, np.int32)]


def train_state_from_leaves(template: TrainState, leaves: Sequence[np.ndarray]) -> TrainState:
    """The inverse of `train_state_leaves`: loads the parameters into
    `template.model` in place and returns the state; the leaves' count and
    shapes must be `train_state_leaves(template)`'s (`load_checkpoint`
    checks them first)."""
    model = template.model
    tree = vitiq_tree_from_state_dict(model.state_dict(), model.cfg)
    n = len(tree_leaves(tree))
    _, lr, count, mu, nu, step = leaves[n:]
    model.load_state_dict(state_dict_from_vitiq(tree_unflatten(tree, iter(leaves[:n])),
                                                model.cfg))
    opt = FusedAdamWState(learning_rate=float(lr), count=int(count), mu=_torch_flat(mu, model),
                          nu=_torch_flat(nu, model))
    return TrainState(model=model, opt_state=opt, step=int(step))
