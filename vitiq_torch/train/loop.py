"""Train and eval steps and the epoch loop (counterpart of
`vitiq/train/loop.py`).

One train step = preprocess (raw [B, L, 2] frames to the model input) +
forward + label-smoothed loss + backward + clip + AdamW, the parameters
updated in place, the step counter advanced. Dropout is a pure function of
(`TrainConfig.dropout_seed`, step): `step_seed` gives the step's int32 seed,
which the fused training kernels hash, and seeds the `torch.Generator` of
the plain dropout sites (the embedding, and the plain layers where the
fused stack does not run). Plateau LR, early stopping, best-parameter
tracking and the history stay on the host between epochs. `fit` resumes from
a checkpoint's state and history (`train/checkpoint.py`) at `start_epoch`:
the feed's per-epoch shuffle and the step's dropout seed continue where the
saved run stopped, so a resumed run takes the steps an uninterrupted one
takes.

Train and eval batches reach the model through `data/pipeline.py`'s
`device_prefetch`: on the card a worker thread copies batch N+1 through
pinned memory on a side stream while step N runs. `evaluate_feed` keeps its
sums on the device (float64, added in the order the host added them before)
and reads them once a pass. `fit(profile=True)` times each step with
`utils/profiling.StepTimer`, which waits for the device before its clock
stops, and adds per-epoch ``step_p50`` / ``step_p90`` to the history.

Not ported yet (later work): the device mesh and data parallelism, and
device-scan superbatching (`TrainConfig.device_scan_steps`, one device call
per K steps).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vitiq_torch.config import ExperimentConfig
from vitiq_torch.data.feeds import DataFeed, as_feed
from vitiq_torch.data.pipeline import device_prefetch
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


def evaluate_feed(eval_step, model, feed: DataFeed, batch_size: int,
                  prefetch_depth: int = 3) -> Dict[str, float]:
    """Padded batches over a DataFeed, prefetched to the model's device:
    every sample scored exactly once. The loss, correct and count sums stay
    on the device in float64, each batch's float32 sums added in batch order,
    and are read once at the end."""
    device = _device(model)
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    for bx, by, mask in device_prefetch(feed.eval_batches(batch_size), device, prefetch_depth):
        m = eval_step(model, bx, by, mask)
        sums += torch.stack([m["loss_sum"], m["correct_sum"], m["count"]]).double()
    loss_sum, correct_sum, count = sums.tolist()
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
    # StepTimer.summary() when fit(profile=True): p50/p90/best/mean step s
    step_times: Optional[Dict] = None


def fit(
    cfg: ExperimentConfig,
    model,
    train_data,
    valid_data,
    preprocess_fn: Optional[Callable] = None,
    epoch_callback: Optional[Callable] = None,
    resume_state: Optional[TrainState] = None,
    resume_history: Optional[Dict] = None,
    start_epoch: int = 0,
    verbose: bool = True,
    profile: bool = False,
) -> FitResult:
    """Train `model` in place with the reference's control semantics:
    plateau LR, early stop, best-parameter tracking, full history.

    train_data / valid_data: (x, y) arrays of raw frames, or DataFeeds.
    `epoch_callback(epoch, state, history)` runs after each epoch. To resume,
    pass the loaded state (its model must be `model`), the saved history
    (extended in place) and the first epoch to run: the plateau scheduler
    and early stopping are re-primed from the history's validation losses.

    Batches reach the model's device through `device_prefetch`, at most
    `TrainConfig.prefetch_depth` ahead. `profile=True` times each step after
    the device has finished it (`StepTimer`) and adds per-epoch step_p50 /
    step_p90 (seconds; the first step of the first epoch, the warm-up, left
    out) to the history and the summary to `FitResult.step_times`."""
    tcfg = cfg.train
    tx = make_optimizer(tcfg)
    if resume_state is not None:
        if resume_state.model is not model:
            raise ValueError("resume_state must hold the model being trained")
        state = resume_state
    else:
        state = create_train_state(model, tcfg)
    train_step = make_train_step(tx, tcfg.label_smoothing, preprocess_fn)
    eval_step = make_eval_step(tcfg.label_smoothing, preprocess_fn)

    scheduler = ReduceLROnPlateau(factor=tcfg.lr_plateau_factor,
                                  patience=tcfg.lr_plateau_patience, min_lr=tcfg.min_lr)
    early_stopping = EarlyStopping(patience=tcfg.patience)
    history = resume_history or {"train_loss": [], "train_acc": [], "val_loss": [],
                                 "val_acc": [], "lr": [], "epoch_time": []}
    # re-prime the scheduler and early stopping from the history on resume
    # (the reference restores the history but resets both controllers)
    for past_loss in history["val_loss"]:
        scheduler.step(past_loss, get_learning_rate(state))
        early_stopping(past_loss)
    early_stopping.early_stop = False

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

    timer = None
    if profile:
        from vitiq_torch.utils.profiling import StepTimer

        timer = StepTimer()
        history.setdefault("step_p50", [])
        history.setdefault("step_p90", [])

    device = _device(model)
    result = FitResult(state=state, best_params=None, history=history)
    for epoch in range(start_epoch, tcfg.num_epochs):
        t0 = time.perf_counter()
        losses, accs = [], []
        epoch_steps0 = len(timer.times) if timer else 0
        batches = device_prefetch(train_feed.train_batches(epoch, tcfg.batch_size), device,
                                  tcfg.prefetch_depth)
        for bx, by in batches:
            if timer is not None:
                with timer.step():
                    state, metrics = train_step(state, bx, by, tcfg.dropout_seed)
                    timer.sync(metrics["loss"])
            else:
                state, metrics = train_step(state, bx, by, tcfg.dropout_seed)
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
        train_loss = float(torch.stack(losses).mean())
        train_acc = float(torch.stack(accs).mean())

        val = evaluate_feed(eval_step, state.model, valid_feed, tcfg.batch_size,
                            tcfg.prefetch_depth)
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
        step_note = ""
        if timer is not None:
            et = np.asarray(timer.times[epoch_steps0:])
            if epoch == start_epoch and len(et) > 1:
                et = et[1:]  # the first step of the run warms up
            p50 = float(np.median(et)) if len(et) else float("nan")
            p90 = float(np.percentile(et, 90)) if len(et) else float("nan")
            history["step_p50"].append(p50)
            history["step_p90"].append(p90)
            step_note = f" step p50={p50 * 1e3:.1f}ms p90={p90 * 1e3:.1f}ms"
        if verbose:
            print(f"epoch {epoch + 1}/{tcfg.num_epochs} train_loss={train_loss:.4f} "
                  f"train_acc={train_acc:.4f} val_loss={val['loss']:.4f} "
                  f"val_acc={val['accuracy']:.4f} lr={lr:.2e} ({epoch_time:.1f}s){step_note}")

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
    if timer is not None:
        result.step_times = timer.summary()
    result.best_tracked = early_stopping.best_params is not None
    result.best_params = (early_stopping.best_params if result.best_tracked else
                          {k: v.detach().clone() for k, v in state.model.state_dict().items()})
    result.history = history
    return result
