"""Throughput / latency benchmarks (counterpart of `vitiq/bench.py`).

The headline metric is classified I/Q frames a second on one card through
the whole serving path: raw [B, frame_len, 2] f32 frames resident on the
device, the front-end (z-score and fold, or the fused raw embedding where
`build_forward_and_preprocess` takes it), the encoder (K1 on every full
layer, K2 on the CLS row) and the head, as `serve.build_serving_fn` runs it
for the `Server`. The reference publishes one throughput, ~2,330 frames/s
of training on an unspecified CUDA GPU (ref README.md:458-473); the north
star is 1M frames/s a chip.

Every function runs on the card unless the caller passes ``device="cpu"``
(the CPU tests do); asking for the card where CUDA is absent raises, and
nothing falls back to the CPU. A result names the device it ran on
(``backend``: "cuda" or "cpu"; ``device``: the card's name), so a CPU number
never stands for a device one.

Timing. vitiq's default, ``fori-slope``, runs K dependent steps in one device
call and reports the slope between a shallow and a deep call, so the
constant per-call cost cancels. Its counterpart here, ``graph-slope``
(`_time_amortized`): the timed step is captured once as a CUDA graph, after
two eager warm-up calls on a side stream (the kernel library builds and the
layers cache their kernel operands then); `k_small` and `k_big` replays run
back to back between two synchronizations, and the p50 over `reps` of
(t_big - t_small) / (k_big - k_small) is the step's time. `k_big` is adapted
to ~3 s of device work and capped as vitiq caps it. vitiq's ``x + i * 1e-6``
perturbation reads i from a device scalar that the graph itself advances (a
graph freezes every host value). A failed capture raises; the graph's step
must equal the eager step at the same i bit for bit, else it raises too.
Beside it every result reports the same step eager (``eager_*``): CUDA
events around `steps` back-to-back calls after warm-up, p50 over `reps`
windows. On the CPU the steps run eagerly in a loop (host clock) and
``timing_method`` says ``loop-slope``. The knobs are vitiq's:
``VITIQ_BENCH_TIMING=queue`` (independent eager dispatches, one drain),
``VITIQ_BENCH_K_SMALL`` (card 8, train 4; CPU 1), ``VITIQ_BENCH_K_CAP`` (card
256, CPU 3), ``VITIQ_BENCH_REPS`` (card 5, CPU 2) and ``VITIQ_TRAIN_TIMING``
(``amortized``, ``queue`` or ``percall``).

The train step's ``amortized`` timing replays a graph of
`train.loop.make_train_scan_step`, the path `fit` takes on the card. vitiq
sizes its loop's inputs by the loop's depth; a static [K, B, L, 2] f32 group
is 64 MiB a step at B=8192, so here the graph holds `k_small` steps over the
one batch repeated, and the slope is taken over the number of replays. The
state advances with every step, so nothing in the inputs needs perturbing.

``data_parallel`` (`bench_fused_infer`) serves over the device mesh (`parallel/`): one
process a rank (torchrun, or a group `parallel.comm.spawn` started), the
model replicated over ``make_mesh(data=N)`` (`shard_model`), each rank
timing its rows of the batch (`batch_sharding`); the reported rate is the
mesh's, the batch over the slowest rank's p50. Two ranks sharing one card
check the path; they measure no rate of a mesh.

``python -m vitiq_torch.bench`` is the counterpart of the repository's
root `bench.py` (the JAX package's headline benchmark): one JSON line with its
keys, after the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from vitiq_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
    flagship_conv1d_config,
    flagship_rawiq_config,
    flagship_vit_config,
    rawiq_best_config,
    rawiq_best_mp_config,
    rawiq_mp_config,
    rawiq_seg64_config,
    rawiq_seg64_mp_config,
    vit_tiny_2016_config,
)
from vitiq_torch.models.amc import AMCModel
from vitiq_torch.utils.device import resolve_device

FLAGSHIP_STATS = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
REFERENCE_GPU_TRAIN_FPS = 2330.0  # ref README.md:458-473, illustrative
TARGET_FPS = 1_000_000.0  # the north star, frames/s a chip

# Every benchable geometry, by arm name (bench_fused_infer, bench_train_step
# and cli bench's --which resolve through it).
ARM_CONFIGS = {
    "vit": flagship_vit_config,
    "rawiq": flagship_rawiq_config,
    "rawiq_seg64": rawiq_seg64_config,
    "rawiq_seg64_mp": rawiq_seg64_mp_config,
    "rawiq_mp": rawiq_mp_config,
    "rawiq_best": rawiq_best_config,
    "rawiq_best_mp": rawiq_best_mp_config,
    "rawiq_conv1d": flagship_conv1d_config,
    "vit_tiny": vit_tiny_2016_config,
}

# eager calls of a step on a side stream before its capture
WARMUP_CALLS = 2


def _experiment(cfg: ModelConfig, data: Optional[DataConfig] = None) -> ExperimentConfig:
    return ExperimentConfig(model=cfg, data=data or DataConfig(synthetic_frame_len=cfg.seq_length))


def _seeded_model(cfg: ModelConfig) -> AMCModel:
    return AMCModel(cfg, generator=torch.Generator().manual_seed(0))


def _frames(shape: Sequence[int], device) -> torch.Tensor:
    """vitiq's bench frames: standard normal from numpy's default_rng(0), f32."""
    x = np.random.default_rng(0).standard_normal(tuple(shape)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def _default_batch(device: torch.device) -> int:
    return 16384 if device.type == "cuda" else 256


def _default_inner(device: torch.device) -> int:
    # queue-mode depth only (VITIQ_BENCH_TIMING=queue)
    return 64 if device.type == "cuda" else 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _tensors(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _serving_step(serve: Callable) -> Callable:
    """vitiq's timed serving step: ``step(i, x) -> (argmax, logits)`` of
    `serve` on ``x + i * 1e-6``."""
    def step(i, x):
        logits = serve(x + i * 1e-6)
        return logits.argmax(dim=-1), logits

    return step


def measure_dispatch_rtt(reps: int = 10, device="cuda") -> Dict[str, float]:
    """The host's launch-and-sync round trip on a trivial kernel: one add on
    a device scalar and its read back to the host. Reported beside the
    bench numbers, which the slope timing keeps free of it."""
    device = resolve_device(device)
    a = torch.zeros((), dtype=torch.float32, device=device)
    float(a + 1.0)  # warm up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(a + 1.0)
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {"p50_ms": float(np.median(ts) * 1e3), "min_ms": float(ts.min() * 1e3)}


def _knobs(device: torch.device, k_small_card: int) -> tuple:
    """(k_small, k_cap, reps): vitiq's knobs and their defaults."""
    card = device.type == "cuda"
    return (int(os.environ.get("VITIQ_BENCH_K_SMALL", str(k_small_card) if card else "1")),
            int(os.environ.get("VITIQ_BENCH_K_CAP", "256" if card else "3")),
            int(os.environ.get("VITIQ_BENCH_REPS", "5" if card else "2")))


def _slope(timed: Callable[[int], float], k_small: int, k_cap: int, reps: int,
           unit: int = 1) -> Dict[str, float]:
    """vitiq's shallow/deep slope over `timed(k)`, the seconds of k steps
    (k a multiple of `unit`): one warm-up, k_big adapted to ~3 s of work."""
    timed(k_small)  # warm up
    est_step = max(timed(k_small) / k_small, 1e-6)  # an upper bound
    k_big = int(np.clip(round(3.0 / est_step), k_small * 3, k_cap))
    k_big = max(k_big // unit * unit, k_small + unit)
    slopes, overheads = [], []
    for r in range(reps):
        # alternate the order so slow host-side drift cancels across reps
        if r % 2 == 0:
            ts, tb = timed(k_small), timed(k_big)
        else:
            tb, ts = timed(k_big), timed(k_small)
        slope = max((tb - ts) / (k_big - k_small), 1e-9)
        slopes.append(slope)
        overheads.append(max(ts - k_small * slope, 0.0))
    s = np.asarray(slopes)
    return {"p50_s": float(np.median(s)), "best_s": float(s.min()),
            "overhead_p50_ms": float(np.median(overheads) * 1e3), "k_small": k_small,
            "k_big": k_big}


def _time_eager(call: Callable[[], object], steps: int, reps: int,
                device: torch.device) -> Dict[str, float]:
    """The step eager: `steps` back-to-back calls a window after three
    warm-up calls, CUDA events on the card (host clock on the CPU); the p50
    of the per-call time over `reps` windows."""
    steps = max(int(steps), 1)
    for _ in range(3):
        call()
    _sync(device)
    per_call = []
    for _ in range(max(reps, 1)):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(steps):
                call()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / 1e3 / steps)
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                call()
            per_call.append((time.perf_counter() - t0) / steps)
    return {"eager_p50_s": float(np.median(per_call))}


def _capture_step(step_fn: Callable, args, i: torch.Tensor, device: torch.device):
    """One CUDA graph of ``step_fn(i, *args)`` followed by ``i += 1``, after
    WARMUP_CALLS eager calls on a side stream. Raises if the capture fails
    or if the graph's step differs from the eager step at the same i."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            step_fn(i, *args)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _tensors(step_fn(i, *args))
        i.add_(1.0)
    i.fill_(3.0)
    graph.replay()
    got = [t.clone() for t in out]
    i.fill_(3.0)
    want = _tensors(step_fn(i, *args))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("the graph-timed step differs from its eager step")
    return graph


def _time_queue(step_fn: Callable, args, steps: int, inner: int,
                device: torch.device) -> Dict[str, float]:
    """vitiq's queue method (VITIQ_BENCH_TIMING=queue): `inner` independent
    eager calls, one drain read, per-call time over max(steps // inner, 3)
    windows."""
    idx = [torch.full((), float(i), device=device) for i in range(inner + 1)]

    def drain(out) -> None:
        float(_tensors(out)[0].float().sum())

    drain(step_fn(idx[0], *args))  # warm up
    times = []
    for _ in range(max(steps // inner, 3)):
        t0 = time.perf_counter()
        out = None
        for i in range(inner):
            out = step_fn(idx[i + 1], *args)
        drain(out)
        times.append((time.perf_counter() - t0) / inner)
    times = np.asarray(times)
    return {"p50_s": float(np.median(times)), "best_s": float(times.min()),
            "mean_s": float(times.mean()), "timing_method": "queue", "inner": inner}


def _time_amortized(step_fn: Callable, args, steps: int, inner: int,
                    device) -> Dict[str, float]:
    """The step's time, `step_fn(i, *args)` with i a 0-d f32 device scalar
    (see the module docstring): graph-slope on the card, loop-slope on the
    CPU, with the eager step's time beside it. VITIQ_BENCH_TIMING=queue
    takes `_time_queue` instead."""
    device = torch.device(device)
    if os.environ.get("VITIQ_BENCH_TIMING", "scan") == "queue":
        return _time_queue(step_fn, args, steps, inner, device)
    k_small, k_cap, reps = _knobs(device, 8)
    i = torch.zeros((), dtype=torch.float32, device=device)
    if device.type == "cuda":
        run = _capture_step(step_fn, args, i, device).replay
    else:
        def run():
            step_fn(i, *args)
            i.add_(1.0)

    def timed(k: int) -> float:
        t0 = time.perf_counter()
        for _ in range(k):
            run()
        _sync(device)
        return time.perf_counter() - t0

    out = _slope(timed, k_small, k_cap, reps)
    out["timing_method"] = "graph-slope" if device.type == "cuda" else "loop-slope"
    if device.type == "cuda":
        out["graph_equals_eager"] = True  # `_capture_step` raised otherwise
    out.update(_time_eager(lambda: step_fn(i, *args), steps, reps, device))
    return out


def fused_infer_setup(arm: str = "vit", batch_size: Optional[int] = None,
                      numerics: str = "tpu", n_head: Optional[int] = None,
                      data_parallel: Optional[int] = None, device="cuda",
                      model: Optional[AMCModel] = None) -> dict:
    """What `bench_fused_infer` times: ``infer(i, x) -> (argmax, logits)``,
    the `Server`'s serving function (`serve.build_serving_fn`) on
    ``x + i * 1e-6``, and its frames x on the device (the rank's rows under
    `data_parallel`); also the config, the whole batch's size, the mesh
    (None without `data_parallel`) and the model: the arm's from seed 0, or
    `model`, whose config then stands for the arm's."""
    from vitiq_torch.serve import build_serving_fn

    if model is not None:
        cfg = model.cfg
    else:
        cfg = ARM_CONFIGS[arm](numerics)
        if n_head is not None:
            cfg = dataclasses.replace(cfg, n_head=n_head)
    exp = _experiment(cfg)
    mesh = None
    if data_parallel:
        from vitiq_torch.parallel.mesh import make_mesh, shard_model
        from vitiq_torch.runner import start_ranks

        exp.train.data_parallel, exp.train.model_parallel = data_parallel, 1
        device = start_ranks(exp, device)
        mesh = make_mesh(data=data_parallel, model=1)
    device = resolve_device(device)
    batch_size = batch_size or _default_batch(device)
    if arm == "rawiq_conv1d":
        # 1025-token attention: keep the default batch within device memory,
        # as vitiq caps it
        batch_size = min(batch_size, 2048)
    model = _seeded_model(cfg) if model is None else model
    rows = slice(None)
    if mesh is not None:
        from vitiq_torch.parallel.mesh import batch_sharding

        shard_model(model, mesh)
        rows = batch_sharding(mesh, batch_size)
    serve = build_serving_fn(exp, model, FLAGSHIP_STATS, device)
    x = _frames((batch_size, cfg.seq_length, 2), "cpu")[rows].to(device)
    return {"infer": _serving_step(serve), "x": x, "cfg": cfg, "batch_size": batch_size, "mesh": mesh,
            "model": model}


def _mesh_worst(values: Sequence[float], mesh, device) -> tuple:
    """(the largest of each of `values` over the mesh's data ranks, every
    rank's first value), gathered by an all-reduce of a zeroed [ranks, n]
    buffer."""
    from vitiq_torch.parallel import comm

    buf = torch.zeros((mesh.data_size, len(values)), dtype=torch.float64, device=device)
    buf[mesh.data_index()] = torch.tensor(values, dtype=torch.float64)
    comm.all_reduce_(buf, mesh.data_group)
    return buf.amax(dim=0).tolist(), buf[:, 0].tolist()


def _with_timing(out: Dict, t: Dict, batch_size: int, device: torch.device,
                 method_key: str = "timing_method") -> Dict:
    """`out` with the timing's method (under `method_key`), overhead, depths,
    graph check and the eager rate beside the slope's, and the device."""
    if "timing_method" in t:
        out[method_key] = t["timing_method"]
    for k in ("overhead_p50_ms", "k_big", "k_small", "graph_equals_eager"):
        if k in t:
            out[k] = t[k]
    if "eager_p50_s" in t:
        out.update(eager_value=batch_size / t["eager_p50_s"],
                   eager_p50_latency_ms=t["eager_p50_s"] * 1e3)
    out["device"] = _device_name(device)
    return out


def bench_fused_infer(arm: str = "vit", batch_size: Optional[int] = None,
                      steps: int = 30, numerics: str = "tpu",
                      n_head: Optional[int] = None,
                      data_parallel: Optional[int] = None, device="cuda") -> Dict:
    """End-to-end serving frames a second: raw frames -> front-end ->
    encoder -> head -> argmax, the `Server`'s path, on one card.

    `n_head` overrides the arm's head count (d_head = d_model / n_head).
    `data_parallel` serves the batch over a data mesh of that many ranks
    (see the module docstring); the rate is then the mesh's: the batch over
    the slowest rank's p50 (each rank's in ``rank_p50_latency_ms``)."""
    s = fused_infer_setup(arm, batch_size, numerics, n_head, data_parallel, device)
    x, batch_size, mesh = s["x"], s["batch_size"], s["mesh"]
    dev = x.device
    t = _time_amortized(s["infer"], (x,), steps, _default_inner(dev), dev)
    extra = {}
    if mesh is not None:
        keys = [k for k in ("p50_s", "best_s", "eager_p50_s") if k in t]
        worst, rank_p50 = _mesh_worst([t[k] for k in keys], mesh, dev)
        t.update(zip(keys, worst))
        extra = {"data_parallel": data_parallel, "rank_batch_size": int(x.shape[0]),
                 "rank_p50_latency_ms": [v * 1e3 for v in rank_p50]}
    suffix = "" if n_head is None else f"_h{n_head}"
    out = {
        "metric": f"iq_frames_per_sec_per_chip_{arm}{suffix}",
        "value": batch_size / t["p50_s"],
        "unit": "frames/s",
        "batch_size": batch_size,
        "p50_latency_ms": t["p50_s"] * 1e3,
        "best_latency_ms": t["best_s"] * 1e3,
        "backend": dev.type,
        "numerics": numerics,
    }
    return {**_with_timing(out, t, batch_size, dev), **extra}


def bench_int8_infer(arm: str = "vit", batch_size: Optional[int] = None,
                     steps: int = 30, device="cuda") -> Dict:
    """End-to-end serving through the int8 W8A8 path
    (`serve.build_int8_serving_fn`: `ops.quant.QuantizedAMCModel`, K6 on
    every full layer and K2 on the CLS row on the card)."""
    from vitiq_torch.serve import build_int8_serving_fn

    device = resolve_device(device)
    batch_size = batch_size or _default_batch(device)
    cfg = flagship_vit_config("tpu") if arm == "vit" else flagship_rawiq_config("tpu")
    serve = build_int8_serving_fn(_experiment(cfg), _seeded_model(cfg), FLAGSHIP_STATS, device)
    x = _frames((batch_size, cfg.seq_length, 2), device)
    t = _time_amortized(_serving_step(serve), (x,), steps, _default_inner(device), device)
    out = {
        "metric": f"iq_frames_per_sec_per_chip_{arm}_int8",
        "value": batch_size / t["p50_s"],
        "unit": "frames/s",
        "batch_size": batch_size,
        "p50_latency_ms": t["p50_s"] * 1e3,
        "backend": device.type,
    }
    return _with_timing(out, t, batch_size, device)


def train_step_setup(cfg: ModelConfig, batch_size: int, device="cuda",
                     state_dict=None) -> dict:
    """What `bench_train_step` times: the model of `cfg` (seeded, or
    `state_dict`) and its preprocess (`serve.build_forward_and_preprocess`:
    raw frames through the fused raw embedding where vitiq's
    `_forward_and_pre` takes it, else the arm's preprocess), a fresh train
    state, vitiq's bench batch (frames from default_rng(0), every label 0)
    on the device, and the two steps over them: ``step(state, x, y, seed)``
    (`make_train_step`, the eager and the queue / percall timings) and
    ``scan(state, xs, ys, seed)`` (`make_train_scan_step`, the amortized
    timing's)."""
    from vitiq_torch.serve import build_forward_and_preprocess
    from vitiq_torch.train.loop import make_train_scan_step, make_train_step
    from vitiq_torch.train.optim import create_train_state, make_optimizer

    device = resolve_device(device)
    tcfg = TrainConfig(batch_size=batch_size)
    model = _seeded_model(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model, pre = build_forward_and_preprocess(_experiment(cfg), model, FLAGSHIP_STATS, device)
    tx = make_optimizer(tcfg, model)
    return {"train": tcfg, "state": create_train_state(model, tcfg), "pre": pre,
            "x": _frames((batch_size, cfg.seq_length, 2), device),
            "y": torch.zeros((batch_size,), dtype=torch.int32, device=device),
            "step": make_train_step(tx, tcfg.label_smoothing, pre),
            "scan": make_train_scan_step(tx, tcfg.label_smoothing, pre)}


def _train_tensors(state) -> list:
    opt = state.opt_state
    return [*state.model.parameters(), opt.mu, opt.nu, opt.count, opt.learning_rate, state.step]


def _graph_train_check(scan, state, xs, ys, seed: int) -> None:
    """The scan step's first call (its group eager, then the capture) and
    a replay from the same state: the parameters, AdamW's moments and
    count, and the losses must be the same bits."""
    before = [t.detach().clone() for t in _train_tensors(state)]
    _, eager_loss, _ = scan(state, xs, ys, seed)
    eager = [t.detach().clone() for t in _train_tensors(state)]
    with torch.no_grad():
        for t, b in zip(_train_tensors(state), before):
            t.copy_(b)
    _, graph_loss, _ = scan(state, xs, ys, seed)
    if not (torch.equal(eager_loss, graph_loss)
            and all(torch.equal(a, b) for a, b in zip(eager, _train_tensors(state)))):
        raise RuntimeError("the graph-timed train steps differ from their eager steps")


def bench_train_step(arm: str = "vit", batch_size: Optional[int] = None,
                     steps: int = 20, numerics: str = "tpu", device="cuda") -> Dict:
    """Train-step frames a second (preprocess + forward + backward + clip +
    AdamW, the state on the device), `VITIQ_TRAIN_TIMING` amortized
    (default; see the module docstring), queue or percall."""
    device = resolve_device(device)
    batch_size = batch_size or max(_default_batch(device) // 4, 64)
    s = train_step_setup(ARM_CONFIGS[arm](numerics), batch_size, device)
    tcfg, state, x, y, step, scan = (s[k] for k in ("train", "state", "x", "y", "step", "scan"))
    seed = tcfg.dropout_seed

    def one():
        return step(state, x, y, seed)[1]["loss"]

    float(one())  # warm up
    mode = os.environ.get("VITIQ_TRAIN_TIMING", "amortized")
    extra: Dict[str, object] = {"timing_method": mode}
    eager = None
    if mode == "percall":
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            float(one())
            times.append(time.perf_counter() - t0)
        p50 = float(np.median(times))
    elif mode == "queue":
        inner = max(min(steps, 10), 1)
        times = []
        for _ in range(max(steps // inner, 3)):
            t0 = time.perf_counter()
            loss = None
            for _ in range(inner):
                loss = one()
            float(loss)  # drains the device queue
            times.append((time.perf_counter() - t0) / inner)
        p50 = float(np.median(times))
    else:
        k_small, k_cap, reps = _knobs(device, 4)
        xs, ys = x.expand(k_small, *x.shape), y.expand(k_small, *y.shape)
        if device.type == "cuda":
            _graph_train_check(scan, state, xs, ys, seed)
            extra["graph_equals_eager"] = True

        def timed(k: int) -> float:
            t0 = time.perf_counter()
            for _ in range(k // k_small):
                scan(state, xs, ys, seed)
            _sync(device)
            return time.perf_counter() - t0

        t = _slope(timed, k_small, k_cap, reps, unit=k_small)
        p50 = t["p50_s"]
        extra.update(timing_method="graph-slope" if device.type == "cuda" else "loop-slope",
                     k_small=k_small, k_big=t["k_big"], overhead_p50_ms=t["overhead_p50_ms"])
        eager = _time_eager(one, steps, reps, device)["eager_p50_s"]
    out = {
        "metric": f"train_frames_per_sec_per_chip_{arm}",
        "value": batch_size / p50,
        "unit": "frames/s",
        "batch_size": batch_size,
        "p50_step_ms": p50 * 1e3,
        "vs_reference_gpu": (batch_size / p50) / REFERENCE_GPU_TRAIN_FPS,
        "backend": device.type,
        **extra,
    }
    if eager is not None:
        out.update(eager_value=batch_size / eager, eager_p50_step_ms=eager * 1e3)
    out["device"] = _device_name(device)
    return out


def bench_dsp_frontend(batch_size: Optional[int] = None, steps: int = 30,
                       sps: int = 2, device="cuda") -> Dict:
    """Matched-filter front-end GB/s (the RRC grouped convolution over
    batched [B, 1024, 2] f32 frames, `dsp.filtering.matched_filter_batch`)."""
    from vitiq_torch.dsp.filtering import matched_filter_batch, rrc_weights

    device = resolve_device(device)
    batch_size = batch_size or _default_batch(device)
    frame_len = 1024
    weights = rrc_weights(sps, device=device)

    def frontend(i, x):
        return matched_filter_batch(x + i * 1e-6, sps=sps, weights=weights)

    x = _frames((batch_size, frame_len, 2), device)
    t = _time_amortized(frontend, (x,), steps, _default_inner(device), device)
    bytes_moved = 2 * batch_size * frame_len * 2 * 4  # read + write f32
    out = {
        "metric": "dsp_frontend_gbps",
        "value": bytes_moved / t["p50_s"] / 1e9,
        "unit": "GB/s",
        "batch_size": batch_size,
        "p50_latency_ms": t["p50_s"] * 1e3,
        "backend": device.type,
    }
    out = _with_timing(out, t, batch_size, device)
    if "eager_p50_s" in t:  # a rate in GB/s here, not frames/s
        out["eager_value"] = bytes_moved / t["eager_p50_s"] / 1e9
    return out


def bench_sps_infer(batch_size: Optional[int] = None, steps: int = 30,
                    sps: int = 2, method: str = "gardner", device="cuda") -> Dict:
    """Oversampled [B, sps * 1024, 2] frames -> RRC matched filter -> timing
    recovery (`method`; the Gardner / Mueller-Mueller loops one launch of
    `timing_recovery_kernel`) -> z-score -> the rawIQ flagship, through the
    serving function of an experiment at that sps."""
    from vitiq_torch.serve import build_serving_fn

    device = resolve_device(device)
    batch_size = batch_size or max(_default_batch(device) // 2, 64)
    cfg = flagship_rawiq_config("tpu")
    data = DataConfig(sps=sps, timing_method=method, synthetic_frame_len=sps * cfg.seq_length)
    serve = build_serving_fn(_experiment(cfg, data), _seeded_model(cfg), FLAGSHIP_STATS, device)
    x = _frames((batch_size, sps * cfg.seq_length, 2), device)
    t = _time_amortized(_serving_step(serve), (x,), steps, _default_inner(device), device)
    out = {
        "metric": f"sps{sps}_{method}_frames_per_sec_per_chip",
        "value": batch_size / t["p50_s"],
        "unit": "frames/s",
        "batch_size": batch_size,
        "sps": sps,
        "timing_method": method,
        "p50_latency_ms": t["p50_s"] * 1e3,
        "backend": device.type,
    }
    return _with_timing(out, t, batch_size, device, method_key="step_timing")


def bench_ingestion(num_frames: int = 65536, frame_len: int = 1024,
                    batch_size: int = 1024, tmp_dir: Optional[str] = None) -> Dict:
    """Host ingestion: HDF5 chunked-shuffled streaming against packed mmap
    .npy shards, both through the background Prefetcher, then the packed
    shards' streaming read path and the host's sequential-copy ceiling
    (page cache warm). Needs h5py, as vitiq's does (the card's machine has
    none: there it raises ImportError)."""
    import shutil
    import tempfile
    from pathlib import Path

    import h5py

    from vitiq_torch.data import HDF5DataSource, PackedDataSource, Prefetcher, pack_split_to_npy

    tmp = tempfile.mkdtemp(dir=tmp_dir)
    try:
        path = f"{tmp}/bench.hdf5"
        rng = np.random.default_rng(0)
        with h5py.File(path, "w") as f:
            f.create_dataset("X", data=rng.standard_normal(
                (num_frames, frame_len, 2)).astype(np.float32))
            y = np.zeros((num_frames, 2), np.int64)
            y[:, 0] = 1
            f.create_dataset("Y", data=y)
            f.create_dataset("Z", data=np.zeros((num_frames, 1), np.float32))
        Path(f"{tmp}/c.json").write_text(json.dumps(["A", "B"]))

        src = HDF5DataSource(path, f"{tmp}/c.json")
        indices = np.arange(num_frames)
        label_map = {"A": 0, "B": 1}
        frame_bytes = frame_len * 2 * 4

        def drain(it) -> float:
            t0 = time.perf_counter()
            n = 0
            for bx, *_ in it:
                n += len(bx)
            return n / (time.perf_counter() - t0)

        hdf5_fps = drain(Prefetcher(src.batch_stream(indices, label_map, batch_size, seed=0),
                                    prefetch_depth=4))
        packed = PackedDataSource(pack_split_to_npy(src, indices, label_map, f"{tmp}/packed"))
        rng2 = np.random.default_rng(1)

        def packed_stream():
            order = rng2.permutation(num_frames)
            for s in range(0, num_frames - batch_size + 1, batch_size):
                yield (packed.read_rows(np.sort(order[s:s + batch_size])),)

        packed_fps = drain(Prefetcher(packed_stream(), prefetch_depth=4))
        # the streaming-training read path: shard-shuffle windows + lookahead
        stream_fps = drain(Prefetcher(packed.batch_stream(batch_size, shuffle=True, seed=2),
                                      prefetch_depth=4))
        # the host's sequential-copy ceiling (page-cache-warm memcpy)
        shard0 = packed._shards[0]
        blk = min(4096, len(shard0))
        buf = np.empty((blk,) + shard0.shape[1:], shard0.dtype)
        t0 = time.perf_counter()
        n_raw = 0
        for s in range(0, len(shard0) - blk + 1, blk):
            np.copyto(buf, shard0[s:s + blk])
            n_raw += blk
        raw_fps = n_raw / max(time.perf_counter() - t0, 1e-9)
        packed.close()
        src.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "metric": "ingestion_frames_per_sec",
        "hdf5_stream_fps": hdf5_fps,
        "hdf5_stream_gbps": hdf5_fps * frame_bytes / 1e9,
        "packed_mmap_fps": packed_fps,
        "packed_mmap_gbps": packed_fps * frame_bytes / 1e9,
        "packed_stream_fps": stream_fps,
        "packed_stream_gbps": stream_fps * frame_bytes / 1e9,
        "host_sequential_fps": raw_fps,
        "host_sequential_gbps": raw_fps * frame_bytes / 1e9,
        "value": packed_fps,
        "unit": "frames/s",
    }


def bench_e2e_serving(num_frames: int = 65536, batch_size: Optional[int] = None,
                      tmp_dir: Optional[str] = None, device="cuda") -> Dict:
    """Sustained serving from disk: packed mmap shards -> `device_prefetch`
    (a worker thread copying batch N+1 through pinned memory on a side
    stream while batch N runs) -> the ViT flagship's serving function, the
    wall clock over every batch, drained at the end."""
    import shutil
    import tempfile

    from vitiq_torch.data.pipeline import device_prefetch
    from vitiq_torch.serve import build_serving_fn

    device = resolve_device(device)
    batch_size = batch_size or _default_batch(device)
    num_frames = max(num_frames, 4 * batch_size)
    cfg = flagship_vit_config("tpu")
    serve = build_serving_fn(_experiment(cfg), _seeded_model(cfg), FLAGSHIP_STATS, device)

    def infer(x):
        return serve(x).argmax(dim=-1)

    tmp = tempfile.mkdtemp(dir=tmp_dir)
    try:
        rng = np.random.default_rng(0)
        shards = []
        shard_rows = 16384
        for s in range(0, num_frames, shard_rows):
            rows = min(shard_rows, num_frames - s)
            p = f"{tmp}/x_{s}.npy"
            np.save(p, rng.standard_normal((rows, cfg.seq_length, 2)).astype(np.float32))
            shards.append(np.load(p, mmap_mode="r"))

        def batches():
            for shard in shards:
                for b in range(0, len(shard) - batch_size + 1, batch_size):
                    yield np.asarray(shard[b:b + batch_size])

        # warm up outside the timed region
        infer(torch.zeros((batch_size, cfg.seq_length, 2), device=device))
        _sync(device)
        t0 = time.perf_counter()
        n = 0
        out = None
        for bx in device_prefetch(batches(), device, 4):
            out = infer(bx)
            n += batch_size
        out.cpu()  # drains the device queue
        wall = time.perf_counter() - t0
        del shards
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "metric": "e2e_serving_frames_per_sec",
        "value": n / wall,
        "unit": "frames/s",
        "frames": n,
        "batch_size": batch_size,
        "backend": device.type,
        "device": _device_name(device),
    }


def bench_streaming(num_channels: int = 64, windows: Optional[int] = None,
                    steps: int = 24, arm: str = "vit", device="cuda") -> Dict:
    """A wideband stream -> the 64-channel polyphase channelizer -> z-score
    and classify every channel's frame (`streaming.make_streaming_classifier`),
    classified frames a second (a window yields `num_channels` frames);
    `arm` is any ARM_CONFIGS key."""
    from vitiq_torch.streaming import make_streaming_classifier

    device = resolve_device(device)
    windows = windows or max(_default_batch(device) // num_channels, 2)
    cfg = ARM_CONFIGS[arm]("tpu")
    classify = make_streaming_classifier(cfg, _seeded_model(cfg), FLAGSHIP_STATS,
                                         num_channels=num_channels, device=device)
    n = num_channels * cfg.seq_length
    rng = np.random.default_rng(0)
    wr = torch.as_tensor(rng.standard_normal((windows, n)).astype(np.float32), device=device)
    wi = torch.as_tensor(rng.standard_normal((windows, n)).astype(np.float32), device=device)

    def run(i, wr, wi):
        logits = classify(torch.complex(wr + i * 1e-6, wi))
        return logits.argmax(dim=-1), logits

    t = _time_amortized(run, (wr, wi), steps, _default_inner(device), device)
    frames = windows * num_channels
    out = {
        "metric": "streaming_channelized_frames_per_sec_per_chip",
        "value": frames / t["p50_s"],
        "unit": "frames/s",
        "classifier_arm": arm,
        "num_channels": num_channels,
        "windows_per_call": windows,
        "p50_latency_ms": t["p50_s"] * 1e3,
        "backend": device.type,
    }
    return _with_timing(out, t, frames, device)


def run_benchmarks(which: str = "fused_vit_infer", batch_size: Optional[int] = None,
                   steps: int = 30, n_head: Optional[int] = None,
                   data_parallel: Optional[int] = None, sps: int = 2,
                   timing_method: Optional[str] = None, device="cuda") -> Dict:
    """One benchmark by `cli bench`'s --which name (vitiq's choices)."""
    if which == "head_variant":
        # d_head = d_model / n_head (default d_head 32)
        return bench_fused_infer("vit", batch_size, steps, n_head=n_head or 4,
                                 data_parallel=data_parallel, device=device)
    if which == "fused_vit_infer":
        return bench_fused_infer("vit", batch_size, steps, data_parallel=data_parallel,
                                 device=device)
    arms = {"rawiq_infer": "rawiq", "vit_tiny_infer": "vit_tiny",
            "rawiq64_infer": "rawiq_seg64", "rawiq64_mp_infer": "rawiq_seg64_mp",
            "rawiq_mp_infer": "rawiq_mp", "rawiq_best_infer": "rawiq_best",
            "rawiq_best_mp_infer": "rawiq_best_mp", "conv1d_infer": "rawiq_conv1d"}
    if which in arms:
        return bench_fused_infer(arms[which], batch_size, steps, n_head=n_head, device=device)
    if which == "int8_infer":
        return bench_int8_infer("vit", batch_size, steps, device=device)
    if which == "train_step":
        return bench_train_step("vit", batch_size, steps, device=device)
    if which == "dsp_frontend":
        return bench_dsp_frontend(batch_size, steps, device=device)
    if which == "sps_infer":
        return bench_sps_infer(batch_size, steps, sps=sps, method=timing_method or "gardner",
                               device=device)
    if which == "ingestion":
        return bench_ingestion()
    if which == "e2e_serving":
        return bench_e2e_serving(batch_size=batch_size, device=device)
    if which == "streaming":
        return bench_streaming(windows=batch_size, device=device)
    if which == "all":
        return {
            "fused_vit_infer": bench_fused_infer("vit", batch_size, steps, device=device),
            "rawiq_infer": bench_fused_infer("rawiq", batch_size, steps, device=device),
            "int8_infer": bench_int8_infer("vit", batch_size, steps, device=device),
            "train_step": bench_train_step("vit", batch_size, steps, device=device),
            "dsp_frontend": bench_dsp_frontend(batch_size, steps, device=device),
        }
    raise ValueError(f"unknown benchmark {which!r}")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def main(device="cuda") -> int:
    """The counterpart of the repository's root `bench.py`, on the card: one
    JSON line with its keys (the vit_tiny serving rate at B=16384 against
    the north star; the ViT flagship and the seg-64 mean-pool arm served;
    the train steps of rawiq_seg64_mp and rawiq_best at B=8192 and the
    rawIQ flagship at B=2048 against the reference's GPU), each with its
    eager rate beside it, and the dispatch round trip; the card's name and
    power limit on the line before it. ``VITIQ_BENCH_FLAGSHIP=0``,
    ``VITIQ_BENCH_MP=0`` and ``VITIQ_BENCH_TRAIN=0`` leave out their keys.
    A bench that fails raises."""
    rtt = measure_dispatch_rtt(device=device)
    res = bench_fused_infer("vit_tiny", 16384, device=device)
    line = {
        "metric": "iq_frames_per_sec_per_chip__vit_tiny",
        "value": res["value"],
        "unit": "frames/s",
        "vs_baseline": res["value"] / TARGET_FPS,
        "p50_latency_ms": res["p50_latency_ms"],
        "batch_size": res["batch_size"],
        "backend": res["backend"],
        "config": "vit_tiny (ViT-arm 11-class AMC, fused raw embedding + ViT-d64/L4, "
                  "128-sample frames)",
        "dispatch_rtt_ms_p50": rtt["p50_ms"],
        "dispatch_rtt_ms_min": rtt["min_ms"],
        "timing_method": res["timing_method"],
        "timing_overhead_ms_p50": res["overhead_p50_ms"],
        "eager_value": res["eager_value"],
        "device": res["device"],
    }
    if os.environ.get("VITIQ_BENCH_FLAGSHIP", "1") != "0":
        fl = bench_fused_infer("vit", device=device)
        line["vit_flagship_frames_per_sec"] = fl["value"]
        line["vit_flagship_vs_baseline"] = fl["value"] / TARGET_FPS
        line["vit_flagship_p50_latency_ms"] = fl["p50_latency_ms"]
        line["vit_flagship_eager_frames_per_sec"] = fl["eager_value"]
    if os.environ.get("VITIQ_BENCH_MP", "1") != "0":
        mp = bench_fused_infer("rawiq_seg64_mp", device=device)
        line["rawiq_seg64_mp_frames_per_sec"] = mp["value"]
        line["rawiq_seg64_mp_vs_baseline"] = mp["value"] / TARGET_FPS
        line["rawiq_seg64_mp_eager_frames_per_sec"] = mp["eager_value"]
    if os.environ.get("VITIQ_BENCH_TRAIN", "1") != "0":
        for key, arm, batch in (("rawiq_seg64_mp_train", "rawiq_seg64_mp", 8192),
                                ("rawiq_best_train", "rawiq_best", 8192),
                                ("rawiq_flagship_train", "rawiq", 2048)):
            tr = bench_train_step(arm, batch, device=device)
            line[f"{key}_frames_per_sec"] = tr["value"]
            line[f"{key}_vs_reference_gpu"] = tr["vs_reference_gpu"]
            line[f"{key}_eager_frames_per_sec"] = tr["eager_value"]
    line["card"] = card_line()
    print(line["card"], flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
