"""Train and eval steps and the epoch loop (counterpart of
`vitiq/train/loop.py`).

One train step = preprocess (raw [B, L, 2] frames to the model input) +
forward + label-smoothed loss + backward + clip + AdamW, the parameters
updated in place, the step counter advanced. Dropout is a pure function of
(`TrainConfig.dropout_seed`, step): `step_seed` gives the step's int32 seed,
which the fused training kernels hash, and seeds the `torch.Generator` of
the plain dropout sites (the embedding, and the plain layers where the
fused stack does not run). Plateau LR, early stopping, best-parameter
tracking and the history stay on the host between epochs.

Not ported yet (later work): the device mesh and data parallelism, device-
scan superbatching (`TrainConfig.device_scan_steps`, one device call per K
steps), the prefetching host-to-device feed (`device_prefetch`), per-step
profiling (`fit(profile=True)`), and checkpoints with resuming from them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from vitiq.config import ExperimentConfig
from vitiq_torch.data.feeds import DataFeed, as_feed
from vitiq_torch.ops.metrics import (
    accuracy,
    label_smoothed_cross_entropy,
    label_smoothed_cross_entropy_per_sample,
)
from vitiq_torch.train.optim import (
    TrainState,
    create_train_state,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from vitiq_torch.train.schedule import EarlyStopping, ReduceLROnPlateau

_M32 = 0xFFFFFFFF


def step_seed(dropout_seed: int, step: int) -> int:
    """The step's int32 dropout seed: murmur3 fmix32 of (seed, step)."""
    h = (dropout_seed * 0x9E3779B1 + step * 0x85EBCA77) & _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_train_step(tx, label_smoothing: float, preprocess_fn: Optional[Callable] = None):
    """Returns step(state, x, y, dropout_seed) -> (state, metrics); x is the
    raw [B, L, 2] batch (or the model input when preprocess_fn is None)."""

    def step(state: TrainState, x, y, dropout_seed: int):
        model = state.model
        model.train()
        device = _device(model)
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device).long()
        seed = step_seed(dropout_seed, state.step)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed & _M32)
        inputs = preprocess_fn(x) if preprocess_fn is not None else x
        params = list(model.parameters())
        logits = model(inputs, generator=generator, seed=seed)
        loss = label_smoothed_cross_entropy(logits, y, label_smoothing)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        updates, opt_state = tx.update(grads, state.opt_state, params)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        metrics = {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), y)}
        return TrainState(model, opt_state, state.step + 1), metrics

    return step


def make_eval_step(label_smoothing: float, preprocess_fn: Optional[Callable] = None):
    """Returns step(model, x, y, valid_mask) -> loss and correct sums over the
    valid rows, their count, and the predictions."""

    @torch.no_grad()
    def step(model, x, y, valid_mask):
        model.eval()
        device = _device(model)
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device).long()
        valid_mask = torch.as_tensor(valid_mask, device=device)
        logits = model(preprocess_fn(x) if preprocess_fn is not None else x)
        per_sample = label_smoothed_cross_entropy_per_sample(logits, y, label_smoothing)
        preds = logits.argmax(dim=-1)
        return {"loss_sum": (per_sample * valid_mask).sum(),
                "correct_sum": ((preds == y).float() * valid_mask).sum(),
                "count": valid_mask.sum(), "preds": preds}

    return step


def evaluate_feed(eval_step, model, feed: DataFeed, batch_size: int) -> Dict[str, float]:
    """Padded batches over a DataFeed: every sample scored exactly once."""
    loss_sum = correct_sum = count = 0.0
    for bx, by, mask in feed.eval_batches(batch_size):
        m = eval_step(model, bx, by, mask)
        loss_sum += float(m["loss_sum"])
        correct_sum += float(m["correct_sum"])
        count += float(m["count"])
    return {"loss": loss_sum / count, "accuracy": correct_sum / count}


@dataclass
class FitResult:
    state: TrainState
    best_params: Any  # a state dict of detached clones
    history: Dict[str, list] = field(default_factory=dict)
    stopped_early: bool = False
    epochs_run: int = 0
    # True iff best_params was tracked by early stopping in this run; False
    # means it is the final epoch's parameters
    best_tracked: bool = False


def fit(
    cfg: ExperimentConfig,
    model,
    train_data,
    valid_data,
    preprocess_fn: Optional[Callable] = None,
    epoch_callback: Optional[Callable] = None,
    verbose: bool = True,
) -> FitResult:
    """Train `model` in place with the reference's control semantics:
    plateau LR, early stop, best-parameter tracking, full history.

    train_data / valid_data: (x, y) arrays of raw frames, or DataFeeds.
    `epoch_callback(epoch, state, history)` runs after each epoch."""
    tcfg = cfg.train
    tx = make_optimizer(tcfg)
    state = create_train_state(model, tcfg)
    train_step = make_train_step(tx, tcfg.label_smoothing, preprocess_fn)
    eval_step = make_eval_step(tcfg.label_smoothing, preprocess_fn)

    scheduler = ReduceLROnPlateau(factor=tcfg.lr_plateau_factor,
                                  patience=tcfg.lr_plateau_patience, min_lr=tcfg.min_lr)
    early_stopping = EarlyStopping(patience=tcfg.patience)
    history = {"train_loss": [], "train_acc": [], "val_loss": [], "val_acc": [], "lr": [],
               "epoch_time": []}

    train_feed = as_feed(train_data, shuffle_seed=tcfg.shuffle_seed)
    valid_feed = as_feed(valid_data, shuffle_seed=tcfg.shuffle_seed)
    if train_feed.num_samples < tcfg.batch_size:
        raise ValueError(
            f"batch_size ({tcfg.batch_size}) exceeds the training-set size "
            f"({train_feed.num_samples}); train batches drop the final partial "
            f"batch, so no step would ever run")
    if valid_feed.num_samples == 0:
        raise ValueError("validation set is empty: plateau LR and early stopping "
                         "need a validation metric")

    result = FitResult(state=state, best_params=None, history=history)
    for epoch in range(tcfg.num_epochs):
        t0 = time.perf_counter()
        losses, accs = [], []
        for bx, by in train_feed.train_batches(epoch, tcfg.batch_size):
            state, metrics = train_step(state, bx, by, tcfg.dropout_seed)
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
        train_loss = float(torch.stack(losses).mean())
        train_acc = float(torch.stack(accs).mean())

        val = evaluate_feed(eval_step, state.model, valid_feed, tcfg.batch_size)
        epoch_time = time.perf_counter() - t0

        lr = get_learning_rate(state)
        new_lr = scheduler.step(val["loss"], lr)
        if new_lr != lr:
            state = set_learning_rate(state, new_lr)

        history["train_loss"].append(train_loss)
        history["train_acc"].append(train_acc)
        history["val_loss"].append(val["loss"])
        history["val_acc"].append(val["accuracy"])
        history["lr"].append(lr)
        history["epoch_time"].append(epoch_time)
        if verbose:
            print(f"epoch {epoch + 1}/{tcfg.num_epochs} train_loss={train_loss:.4f} "
                  f"train_acc={train_acc:.4f} val_loss={val['loss']:.4f} "
                  f"val_acc={val['accuracy']:.4f} lr={lr:.2e} ({epoch_time:.1f}s)")

        result.state = state
        result.epochs_run = epoch + 1
        if epoch_callback is not None:
            epoch_callback(epoch, state, history)
        if early_stopping(val["loss"], state.model.state_dict()):
            result.stopped_early = True
            if verbose:
                print(f"early stopping at epoch {epoch + 1}")
            break

    result.state = state
    result.best_tracked = early_stopping.best_params is not None
    result.best_params = (early_stopping.best_params if result.best_tracked else
                          {k: v.detach().clone() for k, v in state.model.state_dict().items()})
    result.history = history
    return result
