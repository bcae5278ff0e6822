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
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from vitiq_torch.config import TrainConfig


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
