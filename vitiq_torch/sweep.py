"""PSO hyperparameter search (counterpart of `vitiq/sweep.py`).

Global-best PSO over the reference sketch's 9-dim space (18 particles, 25
iterations, c1 = c2 = 1.5, w = 0.6):

  [model_type, d_model, n_head, n_layers, ffn_hidden, drop_prob,
   learning_rate, batch_size, patch_or_segment_size]

`MIN_BOUNDS`, `MAX_BOUNDS`, `decode_particle`, `PSOResult` and
`global_best_pso` are the JAX package's pure-numpy code, copied as they are
(the port imports nothing of `vitiq`).

Fitness = minus the validation accuracy after a short training run
(`make_amc_fitness`): `train_steps` steps of `train/loop.make_train_scan_step`
over batches index-gathered on the device from the resident corpus. On the
card the whole budget is one replay of a CUDA graph captured once per
architecture (`make_train_scan_step`'s graph per batch shape), the
counterpart of vitiq's one scanned device call per evaluation: the sweep
trains hundreds of small architectures at batch 16-128 for tens to
hundreds of steps, which eager steps would spend almost entirely on
launches. On the CPU the steps run eagerly.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# bounds from the reference sketch (hyperparameter_tuning.py:105-132)
MIN_BOUNDS = np.array([0, 32, 2, 1, 64, 0.0, 1e-5, 16, 4], dtype=np.float64)
MAX_BOUNDS = np.array([1, 512, 16, 8, 2048, 0.4, 5e-3, 128, 64], dtype=np.float64)
DIM = 9


def _snap(v, grid):
    return min(grid, key=lambda g: abs(g - v))


def decode_particle(p: np.ndarray, bucket: bool = False) -> Dict:
    """Continuous position -> valid hyperparameter dict.

    bucket=True additionally snaps every SHAPE-AFFECTING dimension to a
    coarse grid so particles collide onto shared architectures. This is what
    makes the sweep TPU-viable: each distinct architecture costs one XLA
    compile (minutes through this environment's remote AOT service), and the
    fitness memoizes compiled steps per architecture — with bucketing, the
    swarm's 18x26 evaluations collapse onto a few dozen compiles instead of
    ~468. The learning rate stays CONTINUOUS: it is an injected state scalar
    (vitiq/train/optim.py), so it never triggers recompilation.
    """
    model_type = int(round(np.clip(p[0], 0, 1)))  # 0 = vit, 1 = rawiq
    n_head = int(np.clip(round(p[2]), 2, 16))
    d_model = int(np.clip(round(p[1]), 32, 512))
    n_layers = int(np.clip(round(p[3]), 1, 8))
    ffn_hidden = int(np.clip(round(p[4]), 64, 2048))
    drop_prob = float(np.clip(p[5], 0.0, 0.4))
    lr = float(np.clip(p[6], 1e-5, 5e-3))
    batch_size = int(np.clip(round(p[7]), 16, 128))
    size = int(np.clip(round(p[8]), 4, 64))
    if bucket:
        n_head = _snap(n_head, (2, 4, 8, 16))
        d_model = _snap(d_model, (32, 64, 128, 256, 512))
        ffn_hidden = _snap(ffn_hidden, (64, 128, 256, 512, 1024, 2048))
        batch_size = _snap(batch_size, (16, 32, 64, 128))
        drop_prob = round(drop_prob * 20) / 20  # 0.05 grid (a jit constant)
    d_model = max(n_head, (d_model // n_head) * n_head)  # divisibility
    if model_type == 0:
        # patch must divide 32 and 64 -> {4, 8, 16, 32}
        patch = min((4, 8, 16, 32), key=lambda v: abs(v - size))
        arch = {"arm": "vit", "patch_size": patch}
    else:
        # segment must divide 1024 -> snap to nearest power of two in range
        seg = min((4, 8, 16, 32, 64), key=lambda v: abs(v - size))
        arch = {"arm": "rawiq", "segment_size": seg}
    return {
        **arch,
        "d_model": d_model, "n_head": n_head, "n_layers": n_layers,
        "ffn_hidden": ffn_hidden, "drop_prob": drop_prob,
        "learning_rate": lr, "batch_size": batch_size,
    }


@dataclass
class PSOResult:
    best_position: np.ndarray
    best_cost: float
    best_hparams: Dict
    cost_history: List[float]
    evaluations: int


def global_best_pso(
    fitness: Callable[[np.ndarray], np.ndarray],
    n_particles: int = 18,
    iters: int = 25,
    c1: float = 1.5,
    c2: float = 1.5,
    w: float = 0.6,
    seed: int = 0,
    bounds: Tuple[np.ndarray, np.ndarray] = (MIN_BOUNDS, MAX_BOUNDS),
    verbose: bool = False,
    on_iter: Optional[Callable] = None,
    init_state: Optional[Dict] = None,
) -> PSOResult:
    """Canonical global-best PSO; `fitness(X[n_particles, dim]) -> cost[n]`.
    `on_iter(it, gbest_x, gbest_cost, history, swarm_state)` fires after each
    iteration — long on-chip sweeps use it to persist the partial trace
    including the FULL swarm state; passing that dict back as `init_state`
    resumes the trajectory exactly (round 5: interrupted sweeps continue
    instead of restarting)."""
    rng = np.random.default_rng(seed)
    lo, hi = bounds
    dim = len(lo)
    if init_state is not None:
        x = np.asarray(init_state["x"], np.float64)
        v = np.asarray(init_state["v"], np.float64)
        pbest_x = np.asarray(init_state["pbest_x"], np.float64)
        pbest_cost = np.asarray(init_state["pbest_cost"], np.float64)
        gbest_x = np.asarray(init_state["gbest_x"], np.float64)
        gbest_cost = float(init_state["gbest_cost"])
        history = list(init_state["history"])
        start_it = int(init_state["iters_done"])
        evals = int(init_state.get("evaluations", (start_it + 1) * n_particles))
        rng.bit_generator.state = init_state["rng_state"]
    else:
        x = rng.uniform(lo, hi, (n_particles, dim))
        v = np.zeros_like(x)
        pbest_x = x.copy()
        pbest_cost = fitness(x)
        g = int(np.argmin(pbest_cost))
        gbest_x, gbest_cost = pbest_x[g].copy(), float(pbest_cost[g])
        history = [gbest_cost]
        evals = n_particles
        start_it = 0

    for it in range(start_it, iters):
        r1 = rng.random((n_particles, dim))
        r2 = rng.random((n_particles, dim))
        v = w * v + c1 * r1 * (pbest_x - x) + c2 * r2 * (gbest_x - x)
        x = np.clip(x + v, lo, hi)
        cost = fitness(x)
        evals += n_particles
        improved = cost < pbest_cost
        pbest_x[improved] = x[improved]
        pbest_cost[improved] = cost[improved]
        g = int(np.argmin(pbest_cost))
        if pbest_cost[g] < gbest_cost:
            gbest_cost = float(pbest_cost[g])
            gbest_x = pbest_x[g].copy()
        history.append(gbest_cost)
        if verbose:
            print(f"pso iter {it + 1}/{iters}: best_cost={gbest_cost:.4f}",
                  flush=True)
        if on_iter is not None:
            swarm_state = {
                "x": x.tolist(), "v": v.tolist(),
                "pbest_x": pbest_x.tolist(),
                "pbest_cost": pbest_cost.tolist(),
                "gbest_x": gbest_x.tolist(), "gbest_cost": gbest_cost,
                "history": history, "iters_done": it + 1,
                "evaluations": evals,
                "rng_state": rng.bit_generator.state,
            }
            on_iter(it, gbest_x, gbest_cost, history, swarm_state)

    # decode only applies to the 9-dim AMC space; generic optimizations
    # (tests, other spaces) get the raw position
    hparams = decode_particle(gbest_x) if dim == DIM else {}
    return PSOResult(gbest_x, gbest_cost, hparams, history, evals)


# --------------------------------------------------------------------------
# fitness: short training run
# --------------------------------------------------------------------------

def init_state_dict(cfg, seed: int) -> Dict[str, torch.Tensor]:
    """The initial weights of an evaluation: an `AMCModel` of `cfg` drawn on
    the CPU from a generator seeded with `seed` (its state dict)."""
    from vitiq_torch.models import AMCModel

    return AMCModel(cfg, generator=torch.Generator().manual_seed(seed)).state_dict()


def cache_bytes(device) -> Optional[int]:
    """What the fitness's cached architectures may hold on `device`
    (`_Arch.nbytes`): a quarter of the card's memory; no bound on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // 4


class _Arch:
    """One architecture's cached training setup: the model and its train
    state on the device (re-initialized in place by every evaluation, so
    that a captured graph's tensor addresses stay valid), the scan step
    (one captured graph on the card, in the sweep's shared memory pool
    `pool`), the preprocess and the eval pass. `nbytes`: what it holds on
    the device outside that pool, the parameters, the AdamW state and the
    graph's static [train_steps, B, L, 2] and [train_steps, B] inputs."""

    def __init__(self, cfg, tcfg, pre, device, train_steps: int, pool=None):
        from vitiq_torch.models import AMCModel
        from vitiq_torch.train.loop import make_train_scan_step
        from vitiq_torch.train.optim import create_train_state, make_optimizer

        self.cfg, self.tcfg, self.pre = cfg, tcfg, pre
        self.model = AMCModel(cfg, device=device)
        self.state = create_train_state(self.model, tcfg)
        self.tx = make_optimizer(tcfg)
        self.scan = make_train_scan_step(self.tx, tcfg.label_smoothing, pre, pool=pool)
        opt = self.state.opt_state
        held = [*self.model.parameters(), opt.mu, opt.nu, *opt.corrections]
        self.nbytes = (sum(t.numel() * t.element_size() for t in held)
                       + train_steps * tcfg.batch_size * (cfg.seq_length * 2 * 4 + 8))

    def reset(self, seed: int, lr: float) -> None:
        """The evaluation's initial weights and a fresh AdamW state, written
        into the cached tensors; the learning rate filled in."""
        from vitiq_torch.train.optim import set_learning_rate

        with torch.no_grad():
            self.model.load_state_dict(init_state_dict(self.cfg, seed))
            opt = self.state.opt_state
            for t in (opt.count, opt.mu, opt.nu, self.state.step):
                t.zero_()
        set_learning_rate(self.state, lr)


def make_amc_fitness(
    train_data, valid_data, num_classes: int, seq_length: int,
    train_steps: int = 30, eval_batches: int = 4, seed: int = 0,
    bucket: bool = False, device="cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """Fitness for the AMC search space: -val_accuracy after `train_steps`
    train steps of each decoded particle's architecture (vitiq's
    `make_amc_fitness`): the ViT arm folds the [L, 2] frame into a [1, 32,
    2L/32] image, the rawIQ arm takes the decoded segment, `reference`
    numerics, z-score stats 0/1. An evaluation draws its batches with
    ``default_rng(seed).integers(0, n_train, (train_steps, batch_size))``,
    gathers them on the device from the resident corpus, and trains from
    `init_state_dict(cfg, seed)` with dropout seed `seed` through
    `make_train_scan_step`; then `fast_eval` scores whole valid batches of
    min(batch_size, n_valid) rows, the mean of their accuracies (vitiq's
    scan over n_valid // that many batches). `eval_batches` is vitiq's
    unused argument.

    The setups are MEMOIZED per architecture (every shape-affecting field;
    not the learning rate, which each evaluation fills into the device
    scalar): `fitness.compile_cache` maps the key to the `_Arch`, and on the
    card each holds the one CUDA graph its first evaluation captured (that
    evaluation's steps run eagerly, as the capture's warm-up); later
    evaluations re-initialize its tensors in place and replay the graph.
    Every graph is captured into one memory pool (evaluations never run
    concurrently), so the activations' memory is the largest capture's,
    not the sum. The cache is least-recently-used: past `cache_bytes(device)`
    of `_Arch.nbytes` the oldest architectures are dropped, and one
    evaluated again is captured again. `fitness.captures` counts the graphs captured,
    `fitness.architectures` the distinct architectures built.
    `fitness.eval_hp(hp, eval_seed=None, eager=False)` evaluates one
    architecture (``eager=True``: the steps one by one through
    `make_train_step`, no graph). A particle is penalized (accuracy 0) only
    for a configuration that `ModelConfig.validate` refuses (a ViT patch
    that does not divide the folded image, as vitiq's decode lets through);
    any other error, a CUDA error or a failed capture included, propagates.
    `device` is where the corpus, the models and the steps live (the card
    by default)."""
    from vitiq_torch.config import ModelConfig, TrainConfig
    from vitiq_torch.dsp import preprocess_batch_rawiq, preprocess_batch_vit
    from vitiq_torch.dsp.frontend import zscore_constants
    from vitiq_torch.ops.metrics import accuracy
    from vitiq_torch.train.loop import make_train_step
    from vitiq_torch.utils.device import resolve_device

    device = resolve_device(device)
    x_train, y_train = train_data
    x_valid, y_valid = valid_data
    stats = zscore_constants({"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0},
                             device)
    # one-time device residency: the sweep corpus is small (tens of MB)
    xd_tr = torch.as_tensor(np.asarray(x_train, np.float32), device=device)
    yd_tr = torch.as_tensor(np.asarray(y_train, np.int64), device=device)
    xd_va = torch.as_tensor(np.asarray(x_valid, np.float32), device=device)
    yd_va = torch.as_tensor(np.asarray(y_valid, np.int64), device=device)
    n_va = int(xd_va.shape[0])
    compile_cache: "OrderedDict[tuple, _Arch]" = OrderedDict()
    architectures = set()
    captures = [0]
    pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    budget = cache_bytes(device)

    def compiled_for(hp: Dict) -> _Arch:
        """The architecture's cached setup; raises ValueError (before any
        device work) for a configuration `ModelConfig.validate` refuses."""
        key = tuple(sorted((k, v) for k, v in hp.items() if k != "learning_rate"))
        if key in compile_cache:
            compile_cache.move_to_end(key)
            return compile_cache[key]
        if hp["arm"] == "vit":
            # fold the IQ frame into the largest image that fits the frame
            h, w = 32, (2 * seq_length) // 32
            cfg = ModelConfig(arm="vit", num_classes=num_classes,
                              d_model=hp["d_model"], n_head=hp["n_head"],
                              n_layers=hp["n_layers"], ffn_hidden=hp["ffn_hidden"],
                              drop_prob=hp["drop_prob"], img_size_h=h, img_size_w=w,
                              patch_size=hp["patch_size"], seq_length=seq_length)
            pre = lambda x: preprocess_batch_vit(x, stats, H=h, W=w)  # noqa: E731
        else:
            cfg = ModelConfig(arm="rawiq", num_classes=num_classes,
                              d_model=hp["d_model"], n_head=hp["n_head"],
                              n_layers=hp["n_layers"], ffn_hidden=hp["ffn_hidden"],
                              drop_prob=hp["drop_prob"], seq_length=seq_length,
                              segment_size=hp["segment_size"])
            pre = lambda x: preprocess_batch_rawiq(x, stats)  # noqa: E731
        cfg.validate()
        # learning_rate here is only the initial value; each evaluation
        # fills its own into the state
        tcfg = TrainConfig(batch_size=hp["batch_size"], learning_rate=hp["learning_rate"])
        arch = compile_cache[key] = _Arch(cfg, tcfg, pre, device, train_steps, pool)
        architectures.add(key)
        while (budget is not None and len(compile_cache) > 1
               and sum(a.nbytes for a in compile_cache.values()) > budget):
            compile_cache.popitem(last=False)
        return arch

    @torch.no_grad()
    def fast_eval(arch: _Arch) -> float:
        bs_e = min(arch.tcfg.batch_size, n_va)  # tiny corpora can be < one batch
        va_steps = max(n_va // bs_e, 1)
        model = arch.model
        model.eval()
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(va_steps):
            sl = slice(i * bs_e, (i + 1) * bs_e)
            total = total + accuracy(model(arch.pre(xd_va[sl])), yd_va[sl])
        return float(total / va_steps)

    def eval_one(hp: Dict, eval_seed: Optional[int] = None, eager: bool = False) -> float:
        s = seed if eval_seed is None else eval_seed
        arch = compiled_for(hp)
        arch.reset(s, hp["learning_rate"])
        idx = np.random.default_rng(s).integers(
            0, len(x_train), (train_steps, hp["batch_size"])).astype(np.int64)
        idx = torch.as_tensor(idx, device=device)
        xs, ys = xd_tr[idx], yd_tr[idx]
        if eager:
            step = make_train_step(arch.tx, arch.tcfg.label_smoothing, arch.pre)
            for k in range(train_steps):
                step(arch.state, xs[k], ys[k], s)
        else:
            before = len(arch.scan.graphs)
            arch.scan(arch.state, xs, ys, s)
            captures[0] += len(arch.scan.graphs) - before
        return fast_eval(arch)

    def fitness(X: np.ndarray) -> np.ndarray:
        costs = np.empty(len(X))
        for i, p in enumerate(X):
            hp = decode_particle(p, bucket=bucket)
            try:
                compiled_for(hp)
            except ValueError as e:
                print(f"particle {i} invalid ({e}); penalizing")
                costs[i] = -0.0
                continue
            costs[i] = -eval_one(hp)
        return costs

    fitness.compile_cache = compile_cache
    fitness.architectures = architectures
    fitness.captures = captures
    fitness.eval_hp = eval_one
    return fitness


def run_pso_sweep(
    n_particles: int = 18,
    iters: int = 25,
    seed: int = 0,
    train_steps: int = 30,
    source: str = "synthetic",
    file_path: Optional[str] = None,
    json_path: Optional[str] = None,
    output_path: Optional[str] = None,
    frames_per_class: int = 512,
    frame_len: int = 256,
    verbose: bool = True,
    bucket: Optional[bool] = None,
    classes: Optional[Tuple[str, ...]] = None,
    channel: bool = False,
    resume_path: Optional[str] = None,
    device="cuda",
) -> Dict:
    """End-to-end sweep over the 9-dim reference search space, with vitiq's
    arguments, and `device` (the card by default).

    `bucket` defaults to True on a CUDA device and False elsewhere. On the
    card every distinct architecture costs a model, a train state and one
    captured CUDA graph (and its first evaluation runs eagerly, the
    capture's warm-up): bucketing collapses the swarm's evaluations onto a
    few dozen architectures, so nearly every evaluation replays a graph,
    where vitiq buckets on the TPU to save XLA compiles. The CPU runs eager
    steps at no such cost, and unbucketed it searches the reference
    sketch's exact space.

    The JSON at `output_path` (after each iteration, with the full swarm
    state, then the final result) has vitiq's keys;
    ``distinct_architectures_compiled`` counts the graphs captured on the
    card (one an architecture, again for one that the fitness's cache
    dropped and met again) and the distinct architectures on the CPU.
    `resume_path`: a partial trace
    written by an earlier run, whose swarm continues its exact trajectory
    from the recorded iteration."""
    if bucket is None:
        bucket = torch.device(device).type == "cuda"
    init_state = None
    if resume_path and Path(resume_path).exists():
        prev = json.loads(Path(resume_path).read_text())
        if prev.get("partial") and prev.get("swarm_state"):
            init_state = prev["swarm_state"]
            if verbose:
                print(f"resuming sweep from iteration {init_state['iters_done']}", flush=True)
    if source == "synthetic":
        from vitiq_torch.data import ChannelModel, SyntheticAMCDataset

        ds = SyntheticAMCDataset(classes=classes or ("BPSK", "QPSK", "16QAM"),
                                 frames_per_class=frames_per_class,
                                 frame_len=frame_len, seed=seed,
                                 channel=ChannelModel() if channel else None)
        n = len(ds)
        split = int(0.85 * n)
        train, valid = (ds.X[:split], ds.Y[:split]), (ds.X[split:], ds.Y[split:])
        num_classes, seq_length = len(ds.classes), frame_len
    else:
        from vitiq_torch.config import DataConfig
        from vitiq_torch.data import HDF5DataSource

        dcfg = DataConfig(source="hdf5", file_path=file_path, json_path=json_path)
        src = HDF5DataSource(file_path, json_path)
        s = src.split(dcfg)
        x_t, y_t, _ = src.load_split_arrays(s.train[:20000], s.label_map)
        x_v, y_v, _ = src.load_split_arrays(s.valid[:4000], s.label_map)
        src.close()
        train, valid = (x_t, y_t), (x_v, y_v)
        num_classes, seq_length = len(dcfg.target_modulations), x_t.shape[1]

    fitness = make_amc_fitness(train, valid, num_classes, seq_length,
                               train_steps=train_steps, seed=seed, bucket=bucket, device=device)
    on_card = torch.device(device).type == "cuda"

    def compiled() -> int:
        return fitness.captures[0] if on_card else len(fitness.architectures)

    def persist_partial(it, gx, gc, hist, swarm_state):
        if not output_path:
            return
        Path(output_path).write_text(json.dumps({
            "partial": True, "iters_done": it + 1,
            "best_val_accuracy": -gc,
            "best_hparams": decode_particle(gx, bucket=bucket),
            "cost_history": hist,
            "distinct_architectures_compiled": compiled(),
            "train_steps": train_steps,
            "swarm_state": swarm_state,
        }, indent=2, default=float))

    result = global_best_pso(fitness, n_particles=n_particles, iters=iters,
                             seed=seed, verbose=verbose,
                             on_iter=persist_partial, init_state=init_state)
    out = {
        "best_val_accuracy": -result.best_cost,
        "best_hparams": result.best_hparams,
        "cost_history": result.cost_history,
        "evaluations": result.evaluations,
        "distinct_architectures_compiled": compiled(),
        "bucketed": bucket,
        "train_steps": train_steps,
        "partial": False,
    }
    if output_path:
        Path(output_path).write_text(json.dumps(out, indent=2, default=float))
    return out
