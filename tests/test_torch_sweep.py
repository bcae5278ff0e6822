"""The port's PSO sweep (`vitiq_torch/sweep.py`, `cli sweep`) against vitiq's.

The search space, `decode_particle` (both bucket modes, 200 random
particles) and `global_best_pso` (a numpy fitness, and its resume from a
persisted swarm state) are vitiq's bit for bit. The AMC fitness memoizes one
setup per architecture (not per learning rate), as vitiq memoizes one
compile; with vitiq's initial weights carried over through `interop` (the
port's initializer patched) its accuracy after one train step equals
vitiq's `make_amc_fitness`. Only a configuration `ModelConfig.validate`
refuses is penalized; other errors propagate. `run_pso_sweep` writes vitiq's
keys and resumes; `cli sweep` takes vitiq's flags. On the CPU the steps run
eagerly; the card's captured graph per architecture is driven by
`chip_smoke.py --scan`.
"""

import json

import jax
import numpy as np
import pytest

from vitiq import cli as vcli
from vitiq import sweep as vsweep
from vitiq.data import SyntheticAMCDataset
from vitiq.models import init_amc_params
from vitiq_torch import cli as pcli
from vitiq_torch import sweep as psweep
from vitiq_torch.interop import state_dict_from_vitiq


def _sphere(X):
    return np.sum((X - 0.3) ** 2, axis=1)


def test_search_space_is_vitiqs():
    np.testing.assert_array_equal(psweep.MIN_BOUNDS, vsweep.MIN_BOUNDS)
    np.testing.assert_array_equal(psweep.MAX_BOUNDS, vsweep.MAX_BOUNDS)
    assert psweep.DIM == vsweep.DIM == 9


@pytest.mark.parametrize("bucket", [False, True])
def test_decode_particle_equals_vitiqs(bucket):
    rng = np.random.default_rng(3 + bucket)
    lo, hi = vsweep.MIN_BOUNDS, vsweep.MAX_BOUNDS
    for p in rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo), (200, 9)):
        assert psweep.decode_particle(p, bucket=bucket) == vsweep.decode_particle(p, bucket)


@pytest.mark.parametrize("seed", [0, 3])
def test_global_best_pso_equals_vitiqs(seed):
    bounds = (np.zeros(3), np.ones(3))
    got = psweep.global_best_pso(_sphere, n_particles=5, iters=6, seed=seed, bounds=bounds)
    want = vsweep.global_best_pso(_sphere, n_particles=5, iters=6, seed=seed, bounds=bounds)
    np.testing.assert_array_equal(got.best_position, want.best_position)
    assert got.best_cost == want.best_cost and got.cost_history == want.cost_history
    assert got.evaluations == want.evaluations and got.best_hparams == want.best_hparams


def test_pso_resume_equals_vitiqs_and_the_uninterrupted_run():
    bounds = (np.zeros(3), np.ones(3))
    states = {}

    def grab(name):
        def on_iter(it, gx, gc, hist, swarm_state):
            if it == 2:
                states[name] = json.loads(json.dumps(swarm_state))
        return on_iter

    psweep.global_best_pso(_sphere, n_particles=5, iters=3, seed=3, bounds=bounds,
                           on_iter=grab("port"))
    vsweep.global_best_pso(_sphere, n_particles=5, iters=3, seed=3, bounds=bounds,
                           on_iter=grab("vitiq"))
    assert states["port"] == states["vitiq"]
    full = psweep.global_best_pso(_sphere, n_particles=5, iters=6, seed=3, bounds=bounds)
    resumed = psweep.global_best_pso(_sphere, n_particles=5, iters=6, seed=3, bounds=bounds,
                                     init_state=states["port"])
    np.testing.assert_array_equal(resumed.best_position, full.best_position)
    assert resumed.cost_history == full.cost_history
    assert resumed.evaluations == full.evaluations


def _corpus(frame_len=64):
    ds = SyntheticAMCDataset(classes=("BPSK", "QPSK"), frames_per_class=64,
                             frame_len=frame_len, seed=0)
    return (ds.X[:96], ds.Y[:96]), (ds.X[96:], ds.Y[96:])


BASE = np.array([1.0, 64, 4, 1, 64, 0.0, 1e-4, 16, 16], np.float64)


def test_fitness_memoizes_per_architecture():
    """Particles that decode to one architecture (or differ in the learning
    rate only) share one cached setup: the cache stays at one entry, a
    re-evaluation gives the same costs, and the learning rate of the last
    evaluation is in the cached state's device scalar."""
    train, valid = _corpus()
    fitness = psweep.make_amc_fitness(train, valid, num_classes=2, seq_length=64,
                                      train_steps=1, eval_batches=1, bucket=True, device="cpu")
    lr_twin = BASE.copy()
    lr_twin[6] = 3e-4
    near = BASE.copy()
    near[1], near[4] = 70, 60
    X = np.stack([BASE, lr_twin, near])
    c1 = fitness(X)
    assert len(fitness.compile_cache) == 1
    c2 = fitness(X)
    assert len(fitness.compile_cache) == 1
    np.testing.assert_array_equal(c1, c2)
    arch = next(iter(fitness.compile_cache.values()))
    assert float(arch.state.opt_state.learning_rate) == 1e-4


def test_fitness_cache_drops_the_least_recently_used_architecture(monkeypatch):
    """Past `cache_bytes` the oldest architecture leaves the cache, the one
    just used stays, and an architecture met again is built again and
    gives the cost it gave the first time; `architectures` counts the
    distinct ones."""
    train, valid = _corpus()
    other = BASE.copy()
    other[3] = 2  # two layers: another architecture
    monkeypatch.setattr(psweep, "cache_bytes", lambda device: 1)
    fitness = psweep.make_amc_fitness(train, valid, num_classes=2, seq_length=64,
                                      train_steps=1, bucket=True, device="cpu")
    first = fitness(BASE[None])
    assert len(fitness.compile_cache) == 1
    fitness(other[None])
    (arch,) = fitness.compile_cache.values()
    assert arch.cfg.n_layers == 2 and len(fitness.architectures) == 2
    assert arch.nbytes > 1 and fitness.captures == [0]
    np.testing.assert_array_equal(fitness(BASE[None]), first)
    (arch,) = fitness.compile_cache.values()
    assert arch.cfg.n_layers == 1 and len(fitness.architectures) == 2


@pytest.mark.parametrize("particle", [
    BASE,  # rawIQ, segment 16
    np.array([0.0, 64, 4, 2, 128, 0.0, 2e-3, 32, 4], np.float64),  # ViT, patch 4
])
def test_fitness_after_one_step_equals_vitiqs(particle, monkeypatch):
    """vitiq's initial weights carried over (the port's initializer patched
    to `state_dict_from_vitiq(init_amc_params(PRNGKey(seed), cfg))`): the
    validation accuracy after one step at dropout 0 equals vitiq's, and an
    eager evaluation equals the scan step's."""
    from vitiq.config import ModelConfig as VModelConfig

    def vitiq_init(cfg, seed):
        vcfg = VModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        return state_dict_from_vitiq(init_amc_params(jax.random.PRNGKey(seed), vcfg), cfg)

    monkeypatch.setattr(psweep, "init_state_dict", vitiq_init)
    train, valid = _corpus()
    kw = dict(num_classes=2, seq_length=64, train_steps=1, eval_batches=1, bucket=True)
    want = vsweep.make_amc_fitness(train, valid, **kw)(particle[None])
    fitness = psweep.make_amc_fitness(train, valid, device="cpu", **kw)
    got = fitness(particle[None])
    assert got[0] == want[0] and got[0] < 0
    hp = psweep.decode_particle(particle, bucket=True)
    assert fitness.eval_hp(hp, eager=True) == -got[0]


def test_only_config_errors_are_penalized(monkeypatch):
    """A ViT patch that does not divide the folded image is penalized
    (accuracy 0, nothing cached), as in vitiq; an error in training
    propagates."""
    train, valid = _corpus()
    fitness = psweep.make_amc_fitness(train, valid, num_classes=2, seq_length=64,
                                      train_steps=1, bucket=True, device="cpu")
    vit32 = np.array([0.0, 64, 4, 1, 64, 0.0, 1e-4, 16, 32], np.float64)  # 32x4 image
    assert fitness(vit32[None])[0] == 0.0 and len(fitness.compile_cache) == 0
    vfit = vsweep.make_amc_fitness(train, valid, num_classes=2, seq_length=64, train_steps=1,
                                   bucket=True)
    assert vfit(vit32[None])[0] == 0.0

    def broken(cfg, seed):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(psweep, "init_state_dict", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fitness(BASE[None])


def test_run_pso_sweep_writes_vitiqs_keys_and_resumes(tmp_path, monkeypatch):
    """A sweep stopped after its first iteration leaves vitiq's partial trace
    (with the swarm state); resumed from it, it ends where an uninterrupted
    sweep ends, with vitiq's final keys."""
    out = tmp_path / "sweep.json"
    kw = dict(n_particles=2, iters=2, train_steps=1, frames_per_class=24, frame_len=64,
              verbose=False, device="cpu")
    pso = psweep.global_best_pso

    def stopped_after_one(*args, on_iter=None, **kwargs):
        def stop(*a):
            on_iter(*a)
            raise KeyboardInterrupt
        return pso(*args, on_iter=stop, **kwargs)

    monkeypatch.setattr(psweep, "global_best_pso", stopped_after_one)
    with pytest.raises(KeyboardInterrupt):
        psweep.run_pso_sweep(output_path=str(out), **kw)
    monkeypatch.setattr(psweep, "global_best_pso", pso)
    partial = json.loads(out.read_text())
    assert set(partial) == {"partial", "iters_done", "best_val_accuracy", "best_hparams",
                            "cost_history", "distinct_architectures_compiled", "train_steps",
                            "swarm_state"}
    assert partial["partial"] and partial["iters_done"] == 1
    resumed = psweep.run_pso_sweep(output_path=str(out), resume_path=str(out), **kw)
    full = psweep.run_pso_sweep(output_path=str(tmp_path / "full.json"), **kw)
    assert set(full) == {"best_val_accuracy", "best_hparams", "cost_history", "evaluations",
                         "distinct_architectures_compiled", "bucketed", "train_steps",
                         "partial"}
    assert full["bucketed"] is False and not full["partial"]
    assert resumed["cost_history"] == full["cost_history"]
    assert resumed["evaluations"] == full["evaluations"] == 6
    assert json.loads(out.read_text()) == json.loads(json.dumps(resumed, default=float))


def _flags(parser, command):
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {tuple(a.option_strings): (a.default, a.type, a.nargs)
            for a in sub.choices[command]._actions if a.option_strings}


def test_cli_sweep_takes_vitiqs_flags():
    got, want = _flags(pcli.build_parser(), "sweep"), _flags(vcli.build_parser(), "sweep")
    assert {k: v for k, v in got.items() if k != ("--device",)} == want
    args = pcli.build_parser().parse_args(
        ["sweep", "--n_particles", "4", "--iters", "2", "--seed", "1", "--train_steps", "30",
         "--source", "synthetic", "--output", "x.json", "--resume"])
    assert args.fn is pcli.cmd_sweep and args.device == "cuda" and args.resume
