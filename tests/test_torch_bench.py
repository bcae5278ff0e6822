"""The port's throughput module (`vitiq_torch/bench.py`, ``cli bench``) on
the CPU, against vitiq's (`vitiq/bench.py`, `vitiq/cli.py`).

* The nine ARM_CONFIGS geometries, by name and order, in both numerics.
* ``cli bench``'s arguments: vitiq's options with their choices, types and
  defaults, and ``--device``.
* The bench's timed forward (`fused_infer_setup`: the `Server`'s serving
  function on its frames, the plain versions of K1/K2 on the CPU) for the
  three geometries no other test serves, at 2 layers and B=4, on vitiq's
  weights (`interop.state_dict_from_vitiq`), against vitiq's
  `_forward_and_pre` forward on the same frames: logits within 0.05 under
  bf16 `tpu` numerics (the serve parity tests' limit,
  tests/test_torch_serve_export.py), the same argmax.
* The bench's timed train step (`train_step_setup`'s scan step, dropout 0,
  `reference` numerics, 2 layers, B=8) against vitiq's `make_train_step`:
  the losses of the first two steps within rtol 1e-5 (f32; the second
  after one AdamW update).
* `run_benchmarks`' metric names and result keys for four choices at
  batch 4 and steps 1 against vitiq's (vitiq's parameters, timing and train
  step stubbed: only its names are compared, so nothing of it compiles).
* ``--trace DIR`` writes DIR/trace.json; `bench_ingestion` runs on the
  host (h5py) with vitiq's keys; ``data_parallel=2`` over two spawned gloo
  ranks reports the mesh's rate (the batch over the slowest rank's p50)
  and its ranks' predictions are one process's.
"""

import argparse
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitiq.bench as jbench
import vitiq.cli as jcli
import vitiq.ops.quant as jquant
import vitiq.train.loop as jloop
import vitiq.train.optim as joptim
from vitiq.config import TrainConfig as JTrainConfig
from vitiq.models import init_amc_params
from vitiq.train.optim import create_train_state as jcreate_train_state
from vitiq.train.optim import make_optimizer as jmake_optimizer
from vitiq_torch import bench as pbench
from vitiq_torch import cli as pcli
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.parallel import comm

SERVE_TOL = 0.05  # bf16 `tpu` logits against vitiq's (the serve parity tests')
LOSS_RTOL = 1e-5  # f32 `reference` losses
# the shallowest slope the knobs allow (k_small 1, k_big 2, one rep): the
# tests below check what a bench reports, not how fast the host is
SHALLOW = {"VITIQ_BENCH_K_CAP": "2", "VITIQ_BENCH_REPS": "1"}


def _one_layer(make):
    """A bench geometry cut to one layer (the names and keys a bench reports
    do not depend on its depth)."""
    return lambda numerics="tpu": dataclasses.replace(make(numerics), n_layers=1)


def _shallow(monkeypatch, arms=()):
    for key, value in SHALLOW.items():
        monkeypatch.setenv(key, value)
    for arm in arms:
        monkeypatch.setitem(pbench.ARM_CONFIGS, arm, _one_layer(pbench.ARM_CONFIGS[arm]))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: its benches are many small
    CPU ops, and a thread pool a worker spins against the suite's other
    workers (one layer's train-step bench, 0.6 s alone, took 104 s in a
    loaded 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bench_parser(module) -> dict:
    """The ``bench`` subcommand's arguments by dest."""
    sub = next(a for a in module.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a for a in sub.choices["bench"]._actions if a.dest != "help"}


@pytest.mark.parametrize("arm", list(jbench.ARM_CONFIGS))
def test_arm_configs_equal_vitiqs(arm):
    assert list(pbench.ARM_CONFIGS) == list(jbench.ARM_CONFIGS)
    for numerics in ("tpu", "reference"):
        got, want = pbench.ARM_CONFIGS[arm](numerics), jbench.ARM_CONFIGS[arm](numerics)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_tokens == want.num_tokens


def test_cli_bench_arguments_equal_vitiqs():
    got, want = _bench_parser(pcli), _bench_parser(jcli)
    assert set(got) - set(want) == {"device"} and got["device"].default == "cuda"
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.choices, b.type) == \
            (a.option_strings, a.default, a.choices, a.type), dest
    assert got["which"].choices == pcli.BENCH_CHOICES


@pytest.mark.parametrize("arm", ["rawiq_seg64", "rawiq_seg64_mp", "rawiq_mp"])
def test_timed_forward_matches_vitiq(arm):
    jcfg = dataclasses.replace(jbench.ARM_CONFIGS[arm]("tpu"), n_layers=2)
    pcfg = dataclasses.replace(pbench.ARM_CONFIGS[arm]("tpu"), n_layers=2)
    params = init_amc_params(jax.random.PRNGKey(0), jcfg)
    model = AMCModel(pcfg)
    model.load_state_dict(state_dict_from_vitiq(params, pcfg))
    s = pbench.fused_infer_setup(arm, 4, device="cpu", model=model)
    preds, got = s["infer"](torch.zeros(()), s["x"])

    fwd, pre = jbench._forward_and_pre(jcfg)
    x = np.random.default_rng(0).standard_normal((4, jcfg.seq_length, 2)).astype(np.float32)
    want = np.asarray(fwd(params, pre(jnp.asarray(x)), train=False), np.float32)
    np.testing.assert_array_equal(s["x"].numpy(), x)
    np.testing.assert_allclose(got.numpy(), want, atol=SERVE_TOL)
    np.testing.assert_array_equal(preds.numpy(), want.argmax(-1))


def test_timed_train_step_matches_vitiqs_losses():
    arm, batch = "rawiq_seg64_mp", 8
    jcfg = dataclasses.replace(jbench.ARM_CONFIGS[arm]("reference"), n_layers=2, drop_prob=0.0)
    pcfg = dataclasses.replace(pbench.ARM_CONFIGS[arm]("reference"), n_layers=2, drop_prob=0.0)
    params = init_amc_params(jax.random.PRNGKey(0), jcfg)
    s = pbench.train_step_setup(pcfg, batch, "cpu", state_dict_from_vitiq(params, pcfg))
    _, got, _ = s["scan"](s["state"], s["x"].expand(2, *s["x"].shape),
                          s["y"].expand(2, *s["y"].shape), s["train"].dropout_seed)

    tcfg = JTrainConfig(batch_size=batch)
    fwd, pre = jbench._forward_and_pre(jcfg)
    step = jloop.make_train_step(fwd, jmake_optimizer(tcfg), tcfg.label_smoothing, pre)
    state = jcreate_train_state(params, tcfg)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (batch, jcfg.seq_length, 2)), jnp.float32)
    y = jnp.zeros((batch,), jnp.int32)
    want = []
    for _ in range(2):
        state, m = step(state, x, y, jax.random.PRNGKey(0))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("which", ["fused_vit_infer", "rawiq64_mp_infer", "int8_infer",
                                   "train_step"])
def test_run_benchmarks_reports_vitiqs_metrics(which, monkeypatch):
    """vitiq's names and keys from its benches with their parameters, state,
    timing and train step stubbed (nothing of them computed: JAX would
    compile every initializer op by op), the port's from the same benches
    cut to one layer."""
    monkeypatch.setattr(jbench, "init_amc_params", lambda key, cfg: None)
    monkeypatch.setattr(jquant, "quantize_params_int8", lambda params: None)
    monkeypatch.setattr(joptim, "create_train_state", lambda params, cfg: None)
    monkeypatch.setattr(jbench, "_time_amortized",
                        lambda *a, **k: {"p50_s": 1.0, "best_s": 1.0, "mean_s": 1.0})
    monkeypatch.setattr(jloop, "make_train_step",
                        lambda *a, **k: lambda state, x, y, rng: (state, {"loss": jnp.zeros(())}))
    monkeypatch.setenv("VITIQ_TRAIN_TIMING", "percall")
    want = jbench.run_benchmarks(which, batch_size=4, steps=1)
    monkeypatch.delenv("VITIQ_TRAIN_TIMING")
    _shallow(monkeypatch, ("vit", "rawiq_seg64_mp"))
    monkeypatch.setattr(pbench, "flagship_vit_config", _one_layer(pbench.flagship_vit_config))
    got = pbench.run_benchmarks(which, batch_size=4, steps=1, device="cpu")
    assert set(want) - {"timing_method"} <= set(got)
    for key in ("metric", "unit", "batch_size", "backend", "numerics"):
        assert got.get(key) == want.get(key), key
    for key in ("value", "eager_value"):
        assert math.isfinite(got[key]) and got[key] > 0
    assert got["timing_method"] == "loop-slope" and got["device"] == "cpu"


def test_cli_bench_trace_writes_trace_json(tmp_path, capsys, monkeypatch):
    _shallow(monkeypatch, ("vit_tiny",))
    trace = tmp_path / "trace"
    assert pcli.main(["bench", "--which", "vit_tiny_infer", "--batch_size", "4", "--steps", "1",
                      "--device", "cpu", "--trace", str(trace)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "iq_frames_per_sec_per_chip_vit_tiny"
    assert line["trace_dir"] == str(trace) and (trace / "trace.json").stat().st_size > 0


def test_bench_ingestion_runs_on_the_host(tmp_path):
    got = pbench.bench_ingestion(num_frames=2048, tmp_dir=str(tmp_path))
    want = jbench.bench_ingestion(num_frames=2048, tmp_dir=str(tmp_path))
    assert set(got) == set(want) and got["metric"] == want["metric"]
    for key, value in got.items():
        if key.endswith(("_fps", "_gbps")) or key == "value":
            assert math.isfinite(value) and value > 0, key
    assert not list(tmp_path.iterdir())  # its files are removed


def dp_worker(rank, world, tmp):
    """One rank of the data-parallel bench (the ViT flagship cut to one
    layer): its rows' predictions at i = 0, then bench_fused_infer over the
    mesh."""
    torch.set_num_threads(1)
    pbench.ARM_CONFIGS["vit"] = _one_layer(pbench.ARM_CONFIGS["vit"])
    s = pbench.fused_infer_setup("vit", 8, data_parallel=world, device="cpu")
    preds = s["infer"](torch.zeros(()), s["x"])[0]
    res = pbench.bench_fused_infer("vit", 8, steps=1, data_parallel=world, device="cpu")
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump({"preds": preds.tolist(), "res": res, "world": comm.world_size()}, f)


def test_data_parallel_reports_the_mesh_and_one_process_predictions(tmp_path, monkeypatch):
    _shallow(monkeypatch, ("vit",))  # the spawned ranks take the knobs from the environment
    comm.spawn(dp_worker, 2, str(tmp_path), device="cpu")
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    s = pbench.fused_infer_setup("vit", 8, device="cpu")
    want = s["infer"](torch.zeros(()), s["x"])[0].tolist()
    assert ranks[0]["preds"] + ranks[1]["preds"] == want
    res = ranks[0]["res"]
    assert ranks[1]["res"]["value"] == res["value"] and ranks[0]["world"] == 2
    assert (res["metric"], res["data_parallel"], res["rank_batch_size"], res["batch_size"]) == \
        ("iq_frames_per_sec_per_chip_vit", 2, 4, 8)
    assert res["p50_latency_ms"] == max(res["rank_p50_latency_ms"])
    assert res["value"] == pytest.approx(8 / (res["p50_latency_ms"] / 1e3), rel=1e-12)


def test_bench_needs_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pbench.bench_fused_infer("vit_tiny", 4, steps=1)
