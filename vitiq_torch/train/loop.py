"""Train and eval steps and the epoch loop (counterpart of
`vitiq/train/loop.py`).

One train step = preprocess (raw [B, L, 2] frames to the model input) +
forward + label-smoothed loss + backward + clip + AdamW, the parameters
updated in place, the step counter advanced. Everything the step reads and
advances lives on the model's device (`train/optim.py`: the step counter,
AdamW's count, moments and learning rate), and so does its dropout seed:
`step_seed_tensor` computes `step_seed(TrainConfig.dropout_seed, step)` there
from the step counter, bit for bit, and every dropout site hashes that int32
tensor (the fused training kernels read it from device memory; the
embedding and the plain layers salt it per site, `models/encoder.py`). A
step therefore holds no host state, and K of them can be captured in one
CUDA graph. Plateau LR, early stopping, best-parameter tracking and the
history stay on the host between epochs. `fit` resumes from a checkpoint's
state and history (`train/checkpoint.py`) at `start_epoch`: the feed's
per-epoch shuffle and the step's dropout seed continue where the saved run
stopped, so a resumed run takes the steps an uninterrupted one takes.

Device-scan superbatching (`TrainConfig.device_scan_steps` K > 1, the
default 64, and not `profile`): `superbatches` groups the epoch's batches
into equal-shape groups of K (a shape change flushes the group as single
steps; the ragged tail runs as single steps), and `make_train_scan_step`
runs a group's K steps. On the card they are one captured
`torch.cuda.CUDAGraph` a (K, batch shape): the first group of a shape runs
its K steps eagerly on a side stream (the warm-up, and steps of the
trajectory like any other), then the K steps are captured over static
[K, B, L, 2] and [K, B] input buffers into static [K] loss and accuracy
outputs; every later group is copied into the buffers (device to device)
and replayed. A failed capture or replay raises; nothing falls back to
eager steps. On the CPU the K steps run eagerly through the same functions.
Either way the steps, and so the parameters and the history, are the
per-batch path's bit for bit: the epoch's loss and accuracy are the mean
over its steps' values, as there.

Train and eval batches reach the model through `data/pipeline.py`'s
`device_prefetch`: on the card a worker thread copies batch N+1 through
pinned memory on a side stream while step N runs. `evaluate_feed` keeps its
sums on the device (float64, added in the order the host added them before)
and reads them once a pass. `fit(profile=True)` times each step with
`utils/profiling.StepTimer`, which waits for the device before its clock
stops, and adds per-epoch ``step_p50`` / ``step_p90`` to the history.

`TrainConfig.dispatch_sync_steps` N bounds how far the host runs ahead of
the card: one loss is read every N single steps, and after every scan call.

The device mesh (`parallel/mesh.py`), as vitiq's `fit` builds it: `fit`
shards the model over ``make_mesh(data=TrainConfig.data_parallel,
model=TrainConfig.model_parallel)`` (`shard_model`, which records the mesh
on the model) unless the model is already sharded. Every rank
runs the same `fit`; with more than one rank in the process group the feeds
are wrapped in `ProcessShardFeed` (each rank takes its data index's rows of
every global batch), the parameters and AdamW moments are broadcast from
data rank 0 before the first step, each train step all-reduces its flat
gradient and its loss and accuracy over the data group in one call and
divides them by the data size, and each evaluation all-reduces its sums
there: every rank's history, plateau LR and early stop are then the ones
the whole batch gives. The scan path is off above one rank (vitiq's
multi-process rule): the gloo collectives are host calls, which a CUDA
graph cannot capture. Under a model axis above 1 the clip's norm is the
whole parameters' (`train/optim.py`), and the best parameters and the
final model are the rank's shards (`parallel.mesh.full_state_dict` gathers
them).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vitiq_torch.config import ExperimentConfig
from vitiq_torch.data.feeds import DataFeed, ProcessShardFeed, as_feed
from vitiq_torch.data.pipeline import device_prefetch
from vitiq_torch.ops.cuda.fused_layer_train import fmix32, mul32
from vitiq_torch.ops.metrics import (
    accuracy,
    label_smoothed_cross_entropy,
    label_smoothed_cross_entropy_per_sample,
)
from vitiq_torch.parallel import comm
from vitiq_torch.parallel.mesh import make_mesh, model_mesh, shard_model
from vitiq_torch.train.optim import (
    TrainState,
    _flat,
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


def step_seed_tensor(dropout_seed: int, step: torch.Tensor) -> torch.Tensor:
    """`step_seed(dropout_seed, step)` on the step tensor's device, bit for
    bit: int64 arithmetic masked to 32 bits (each product split in 16-bit
    halves, `mul32`), returned as an int32 scalar there. No host value of
    the step is read, so a captured CUDA graph computes each replay's seed."""
    h = (((dropout_seed * 0x9E3779B1) & _M32) + mul32(step & _M32, 0x85EBCA77)) & _M32
    h = fmix32(h)
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_train_step(tx, label_smoothing: float, preprocess_fn: Optional[Callable] = None):
    """Returns step(state, x, y, dropout_seed) -> (state, metrics); x is the
    raw [B, L, 2] batch (or the model input when preprocess_fn is None).
    The state's tensors are updated in place (the returned state holds the
    same ones); the metrics are device scalars. On a mesh with data axes
    above 1 (the model's) x is the rank's rows, and the flat gradient, the
    loss and the accuracy are averaged over the data group in one
    all-reduce before the update."""

    def step(state: TrainState, x, y, dropout_seed: int):
        model = state.model
        model.train()
        device = _device(model)
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device).long()
        seed = step_seed_tensor(dropout_seed, state.step)
        inputs = preprocess_fn(x) if preprocess_fn is not None else x
        params = list(model.parameters())
        logits = model(inputs, seed=seed)
        loss = label_smoothed_cross_entropy(logits, y, label_smoothing)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        metrics = {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), y)}
        mesh = model_mesh(model)
        if mesh is not None and mesh.data_size > 1:
            flat = torch.cat([_flat(grads), metrics["loss"].float().reshape(1),
                              metrics["accuracy"].float().reshape(1)])
            comm.all_reduce_(flat, mesh.data_group)
            flat /= mesh.data_size
            grads = flat[:-2]
            metrics = {"loss": flat[-2], "accuracy": flat[-1]}
        updates, opt_state = tx.update(grads, state.opt_state, params)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
            state.step.add_(1)
        return TrainState(model, opt_state, state.step), metrics

    return step


def make_train_scan_step(tx, label_smoothing: float, preprocess_fn: Optional[Callable] = None,
                         pool=None):
    """K train steps a call: step(state, xs [K, B, ...], ys [K, B],
    dropout_seed) -> (state, losses [K], accuracies [K]), the K calls of
    `make_train_step`'s step in order (the same seeds, the same updates).
    On a CUDA model one captured CUDA graph a (K, batch shape, dtypes, seed,
    state) holds the K steps (see the module docstring); the returned
    function's `graphs` maps those keys to (static xs, static ys, static
    outputs, graph), and `capture_seconds` to the host time each capture
    took. On the CPU the steps run eagerly.

    Every graph is captured into one memory pool: `pool` (a
    `torch.cuda.graph_pool_handle()`, which other scan steps may share, as
    the sweep's architectures do), else one of this step's own. Graphs of
    one pool must not run concurrently, and one's replay may reuse what
    another freed inside its capture, its outputs included: so each call
    clones its outputs before it returns, and nothing reads a graph's
    static outputs after another graph ran."""
    single = make_train_step(tx, label_smoothing, preprocess_fn)
    graphs: Dict[tuple, tuple] = {}
    capture_seconds: Dict[tuple, float] = {}
    pools = [pool]

    def run(state: TrainState, xs, ys, dropout_seed: int):
        losses, accs = [], []
        for k in range(xs.shape[0]):
            state, m = single(state, xs[k], ys[k], dropout_seed)
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        return torch.stack(losses), torch.stack(accs)

    def step(state: TrainState, xs, ys, dropout_seed: int):
        device = _device(state.model)
        xs = torch.as_tensor(xs, device=device)
        ys = torch.as_tensor(ys, device=device)
        if device.type != "cuda":
            return (state,) + run(state, xs, ys, dropout_seed)
        key = (tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype, int(dropout_seed),
               id(state.model), id(state.opt_state.mu), id(state.step))
        params = list(state.model.parameters())
        if key not in graphs:
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):  # the warm-up: this group's steps
                out = run(state, xs, ys, dropout_seed)
            current.wait_stream(side)
            static_x, static_y = torch.empty_like(xs), torch.empty_like(ys)
            graph = torch.cuda.CUDAGraph()
            if pools[0] is None:
                pools[0] = torch.cuda.graph_pool_handle()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=pools[0]):
                static_out = run(state, static_x, static_y, dropout_seed)
            capture_seconds[key] = time.perf_counter() - t0
            graphs[key] = (static_x, static_y, static_out, graph)
            return (state,) + out
        static_x, static_y, static_out, graph = graphs[key]
        static_x.copy_(xs)
        static_y.copy_(ys)
        graph.replay()
        # the replay updated the parameters in place without bumping their
        # version counters, which the inference kernels' operand caches read
        for p in params:
            torch.autograd.graph.increment_version(p)
        return state, static_out[0].clone(), static_out[1].clone()

    step.graphs = graphs
    step.capture_seconds = capture_seconds
    return step


def superbatches(src_iter, k: int):
    """Group the batches of `src_iter` into ("scan", xs [k, B, ...], ys [k, B])
    items, equal-shape groups only (vitiq's `superbatches`). A batch whose
    shape differs from the group in progress flushes that group as
    ("single", x, y) items at once; the ragged tail ends as single items
    too."""
    buf = []
    for item in src_iter:
        if buf and item[0].shape != buf[0][0].shape:
            for b in buf:
                yield ("single",) + tuple(b)
            buf = []
        buf.append(item)
        if len(buf) == k:
            yield ("scan", np.stack([b[0] for b in buf]), np.stack([b[1] for b in buf]))
            buf = []
    for item in buf:
        yield ("single",) + tuple(item)


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
    and are read once at the end; a model sharded over data axes above 1
    (the feed a `ProcessShardFeed`) sums them over its data group first."""
    device = _device(model)
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    for bx, by, mask in device_prefetch(feed.eval_batches(batch_size), device, prefetch_depth):
        m = eval_step(model, bx, by, mask)
        sums += torch.stack([m["loss_sum"], m["correct_sum"], m["count"]]).double()
    mesh = model_mesh(model)
    comm.all_reduce_(sums, mesh.data_group if mesh is not None else None)
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
    `TrainConfig.prefetch_depth` ahead (superbatches: half that, at least 2).
    With `TrainConfig.device_scan_steps` K > 1 and `profile` false, full
    groups of K batches run through `make_train_scan_step` (one CUDA graph
    replay a group on the card), the rest as single steps. `profile=True`
    times each step after the device has finished it (`StepTimer`) and adds
    per-epoch step_p50 / step_p90 (seconds; the first step of the first
    epoch, the warm-up, left out) to the history and the summary to
    `FitResult.step_times`.

    The device mesh is the model's, else ``make_mesh(data=
    TrainConfig.data_parallel, model=TrainConfig.model_parallel)``, over
    which the model, and a resume state built on the whole model, are
    sharded (see the module docstring). The scan path runs only in a
    process group of one rank."""
    tcfg = cfg.train
    if resume_state is not None and resume_state.model is not model:
        raise ValueError("resume_state must hold the model being trained")
    mesh = model_mesh(model) or make_mesh(data=tcfg.data_parallel, model=tcfg.model_parallel)
    resume_state = shard_model(model, mesh, resume_state)
    state = resume_state if resume_state is not None else create_train_state(model, tcfg)
    multi = comm.world_size() > 1
    if mesh.data_size > 1:  # every data rank starts from data rank 0's state
        params = list(model.parameters())
        flat = torch.cat([_flat(params), state.opt_state.mu, state.opt_state.nu])
        comm.broadcast_(flat, mesh.data_src(), mesh.data_group)
        n = sum(p.numel() for p in params)
        with torch.no_grad():
            for p, piece in zip(params, flat[:n].split([p.numel() for p in params])):
                p.copy_(piece.view_as(p))
            state.opt_state.mu.copy_(flat[n:2 * n])
            state.opt_state.nu.copy_(flat[2 * n:])
    tx = make_optimizer(tcfg, model)
    train_step = make_train_step(tx, tcfg.label_smoothing, preprocess_fn)
    eval_step = make_eval_step(tcfg.label_smoothing, preprocess_fn)
    scan_k = (tcfg.device_scan_steps
              if tcfg.device_scan_steps and tcfg.device_scan_steps > 1 and not profile
              and not multi else 0)
    scan_step = make_train_scan_step(tx, tcfg.label_smoothing, preprocess_fn) if scan_k else None
    sync = tcfg.dispatch_sync_steps

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
    if multi:  # every rank takes its data index's rows of each global batch
        train_feed = ProcessShardFeed(train_feed, mesh)
        valid_feed = ProcessShardFeed(valid_feed, mesh)
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
        losses, accs = [], []  # one [n] tensor a train call, n its steps
        epoch_steps0 = len(timer.times) if timer else 0
        batches = train_feed.train_batches(epoch, tcfg.batch_size)
        if scan_k:  # a group's labels are [K, B], a single batch's [B]
            batches = device_prefetch(((bx, by) for _, bx, by in superbatches(batches, scan_k)),
                                      device, max(2, tcfg.prefetch_depth // 2))
        else:
            batches = device_prefetch(batches, device, tcfg.prefetch_depth)
        singles = 0
        for bx, by in batches:
            kind = "scan" if by.ndim == 2 else "single"
            if kind == "scan":
                state, loss, acc = scan_step(state, bx, by, tcfg.dropout_seed)
            elif timer is not None:
                with timer.step():
                    state, metrics = train_step(state, bx, by, tcfg.dropout_seed)
                    timer.sync(metrics["loss"])
            else:
                state, metrics = train_step(state, bx, by, tcfg.dropout_seed)
            if kind == "single":
                loss, acc = metrics["loss"].reshape(1), metrics["accuracy"].reshape(1)
                singles += 1
            losses.append(loss)
            accs.append(acc)
            # bound how far the host runs ahead: a scan call is a sync
            # window's worth of steps, single steps are read every `sync`
            if sync and (kind == "scan" or singles % sync == 0):
                float(loss[-1])
        train_loss = float(torch.cat(losses).mean())
        train_acc = float(torch.cat(accs).mean())

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
