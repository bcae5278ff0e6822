"""The port runs where JAX and the JAX package are absent: a fresh
interpreter in which every `import jax` and every `import vitiq` fails
imports `vitiq_torch`, serves one batch and trains one epoch (`fit`) on the
CPU: a ViT on its preprocessed images through the fused training stack, a
rawIQ model on raw frames through `build_forward_and_preprocess` (the fused
raw embedding and the stash regime), and a conv1d model through the plain
layers with K5 as their attention; then it evaluates a saved experiment
(`run_evaluation`, float and int8, plots off) with scikit-learn, matplotlib,
seaborn and h5py blocked too, as the card's machine lacks them, and trains an
experiment with ``cli train`` and resumes it, its evaluation passes through
K7's plain version (``VITIQ_ATTN_INT8=1``). With h5py and scikit-learn still
blocked it imports the split and HDF5 modules (neither imports either at
load), trains an epoch with step profiling on a `StreamFeed` over packed
shards and evaluates a reference ``.pth`` with ``cli evaluate
--torch-checkpoint``; it exports an experiment with ``cli export`` and
serves the artifact, loads the reference ``.pth`` through the softmax guard
and runs MDF-NET. A second subprocess, with matplotlib blocked too, runs
`fit` through the scan step, the sweep's fitness and a bench
(`bench.run_benchmarks`), and imports `viz`. The
port's sources, and `chip_smoke.py`, import neither jax nor vitiq."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[name]
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
for name in [m for m in sys.modules if m == "vitiq" or m.startswith("vitiq.")]:
    del sys.modules[name]
sys.modules["vitiq"] = None
for name in ("sklearn", "matplotlib", "seaborn", "h5py"):  # absent on the card's machine
    sys.modules[name] = None

import torch
from vitiq_torch import ExperimentConfig, ModelConfig, DataConfig
from vitiq_torch.models import AMCModel
from vitiq_torch.serve import Server, build_serving_fn

cfg = ExperimentConfig(
    model=ModelConfig(arm="vit", num_classes=4, d_model=64, n_head=4, n_layers=2,
                      ffn_hidden=128, img_size_h=16, img_size_w=16, seq_length=128,
                      numerics="tpu"),
    data=DataConfig(synthetic_frame_len=128))
model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(0))
stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
server = Server(build_serving_fn(cfg, model, stats, "cpu"), 128, (8,), device="cpu")
x = torch.randn((3, 128, 2), generator=torch.Generator().manual_seed(1))
logits = server.run(x)
assert logits.shape == (3, 4) and bool(torch.isfinite(logits).all())
import numpy as np
from vitiq_torch.config import TrainConfig
from vitiq_torch.data import ArrayFeed
from vitiq_torch.dsp.frontend import preprocess_batch_vit
from vitiq_torch.ops import metrics
from vitiq_torch.ops.cuda import fused_layer_train
from vitiq_torch.train import fit

train_cfg = ExperimentConfig(
    model=ModelConfig(arm="vit", num_classes=4, d_model=128, n_head=8, n_layers=1,
                      ffn_hidden=128, img_size_h=16, img_size_w=16, numerics="tpu"),
    train=TrainConfig(batch_size=4, num_epochs=1))
rng = np.random.default_rng(0)
frames = rng.standard_normal((12, 128, 2)).astype(np.float32)
labels = rng.integers(0, 4, 12)
res = fit(train_cfg, AMCModel(train_cfg.model), (frames[:8], labels[:8]),
          ArrayFeed(frames[8:], labels[8:]),
          preprocess_fn=lambda t: preprocess_batch_vit(t, stats, H=16, W=16), verbose=False)
assert res.state.step == 2 and np.isfinite(res.history["train_loss"]).all()

# rawIQ on raw frames: the fused raw embedding and the stash regime (17 tokens)
from vitiq_torch.serve import build_forward_and_preprocess
raw_cfg = ExperimentConfig(
    model=ModelConfig(arm="rawiq", num_classes=4, d_model=128, n_head=8, n_layers=1,
                      ffn_hidden=128, seq_length=256, segment_size=16, numerics="tpu"),
    data=DataConfig(synthetic_frame_len=256), train=TrainConfig(batch_size=4, num_epochs=1))
raw_stats = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}
model, pre = build_forward_and_preprocess(raw_cfg, raw_cfg.model, raw_stats, device="cpu")
assert model.raw_stats == raw_stats
stash_calls = []
real_stash = fused_layer_train.fused_train_layer_fwd_stash
fused_layer_train.fused_train_layer_fwd_stash = lambda *a: stash_calls.append(1) or real_stash(*a)
frames = rng.standard_normal((12, 256, 2)).astype(np.float32)
res = fit(raw_cfg, model, (frames[:8], labels[:8]), ArrayFeed(frames[8:], labels[8:]),
          preprocess_fn=pre, verbose=False)
assert res.state.step == 2 and np.isfinite(res.history["train_loss"]).all()
assert len(stash_calls) == 2, stash_calls

# conv1d (1025 tokens, which the fused training stack turns down, as at the
# flagship): the plain layers, rematerialized, K5's plain versions as attention
from vitiq_torch.ops.cuda import flash_attention
conv_cfg = ExperimentConfig(
    model=ModelConfig(arm="rawiq", num_classes=4, d_model=64, n_head=4, n_layers=1,
                      ffn_hidden=128, seq_length=1024, embedding_type="conv1d",
                      numerics="tpu"),
    data=DataConfig(synthetic_frame_len=1024), train=TrainConfig(batch_size=4, num_epochs=1))
model, pre = build_forward_and_preprocess(conv_cfg, conv_cfg.model, raw_stats, device="cpu")
k5_calls = []
real_k5 = flash_attention.fused_attention_fwd
flash_attention.fused_attention_fwd = lambda *a: k5_calls.append(1) or real_k5(*a)
frames = rng.standard_normal((12, 1024, 2)).astype(np.float32)
res = fit(conv_cfg, model, (frames[:8], labels[:8]), ArrayFeed(frames[8:], labels[8:]),
          preprocess_fn=pre, verbose=False)
assert res.state.step == 2 and np.isfinite(res.history["train_loss"]).all()
assert len(k5_calls) == 4, k5_calls  # one layer, two steps, each recomputed; eval runs K1/K2
# evaluate a saved experiment on the CPU, in float and through the int8 path
import json, tempfile
from pathlib import Path
from vitiq_torch.runner import run_evaluation
from vitiq_torch.train.checkpoint import save_params
eval_cfg = ExperimentConfig(
    model=ModelConfig(arm="rawiq", num_classes=3, d_model=128, n_head=8, n_layers=2,
                      ffn_hidden=128, seq_length=128, segment_size=16, use_cls_token=True,
                      numerics="tpu"),
    data=DataConfig(synthetic_frames_per_class=20, synthetic_frame_len=128),
    train=TrainConfig(batch_size=16))
with tempfile.TemporaryDirectory() as exp:
    exp = Path(exp)
    eval_cfg.to_json(str(exp / "config.json"))
    (exp / "normalization_stats.json").write_text(json.dumps(raw_stats))
    save_params(exp / "model_best", AMCModel(eval_cfg.model).state_dict(), eval_cfg.model)
    for int8 in (False, True):
        res = run_evaluation(str(exp), int8=int8, device="cpu", make_plots=False,
                             verbose=False)
        assert 0.0 <= res["overall_accuracy"] <= 1.0 and len(res["predictions"]) == 9
        prefix = "test_int8" if int8 else "test"
        assert (exp / "evaluation" / f"{prefix}_classification_report.txt").exists()
        assert (exp / "evaluation" / f"{prefix}_results.pkl").exists()
# train an experiment with `cli train` (plots off), then resume it; under
# VITIQ_ATTN_INT8=1 its evaluation passes run K7's plain version
import os
from vitiq_torch import cli
from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn
k7_calls = []
real_k7 = fused_encoder_layer_int8attn.fused_encoder_layer_int8attn
fused_encoder_layer_int8attn.fused_encoder_layer_int8attn = (
    lambda *a: k7_calls.append(1) or real_k7(*a))
os.environ["VITIQ_ATTN_INT8"] = "1"
with tempfile.TemporaryDirectory() as tmp:
    run_cfg = ExperimentConfig(model=eval_cfg.model, data=eval_cfg.data,
                               train=TrainConfig(batch_size=16, num_epochs=1, save_freq=1),
                               experiment_name="run", checkpoint_dir=tmp, log_dir=tmp + "/logs")
    run_cfg.to_json(tmp + "/run.json")
    for argv in (["--num_epochs", "1"], ["--num_epochs", "2", "--resume", "auto"]):
        assert cli.main(["train", "--config", tmp + "/run.json", "--device", "cpu",
                         "--no_plots", *argv]) == 0
    assert json.loads(Path(tmp, "run", "summary.json").read_text())["epochs_run"] == 2
del os.environ["VITIQ_ATTN_INT8"]
assert len(k7_calls) == 4, k7_calls  # 1 full layer, 1 batch: each run validates, tests
# the data path from file to model without h5py or scikit-learn: the split
# and HDF5 modules import, a packed split streams through `fit` with step
# profiling, and `cli evaluate --torch-checkpoint` evaluates a reference .pth
import vitiq_torch.data.hdf5
import vitiq_torch.data.splits
from vitiq_torch.data import PackedDataSource, StreamFeed, pack_split_to_npy


class Rows:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def read_rows(self, rows):
        return self.x[rows]

    def labels_for(self, rows, label_map):
        return self.y[rows].astype(np.int32)

    def snrs_for(self, rows):
        return np.zeros(len(rows), np.float32)


frames = rng.standard_normal((40, 128, 2)).astype(np.float32)
labels = rng.integers(0, 3, 40)
with tempfile.TemporaryDirectory() as tmp:
    pack_split_to_npy(Rows(frames[:32], labels[:32]), np.arange(32), {"a": 0, "b": 1, "c": 2},
                      tmp + "/train", shard_rows=12)
    src = PackedDataSource(tmp + "/train")
    stream_cfg = ExperimentConfig(model=eval_cfg.model,
                                  train=TrainConfig(batch_size=8, num_epochs=1,
                                                    profile_steps=True))
    model, pre = build_forward_and_preprocess(stream_cfg, stream_cfg.model, raw_stats, "cpu")
    res = fit(stream_cfg, model, StreamFeed(src.batch_stream, src.num_rows, source=src),
              ArrayFeed(frames[32:], labels[32:]), preprocess_fn=pre, verbose=False,
              profile=stream_cfg.train.profile_steps)
    src.close()
    assert res.state.step == 4 and len(res.history["step_p50"]) == 1, res.history
    torch.save({"model_state_dict": model.state_dict()}, tmp + "/ref.pth")
    eval_cfg.to_json(tmp + "/synthetic.json")
    assert cli.main(["evaluate", "--torch-checkpoint", tmp + "/ref.pth", "--config",
                     tmp + "/synthetic.json", "--output", tmp + "/out", "--device", "cpu",
                     "--no_plots"]) == 0
    assert Path(tmp, "out", "test_classification_report.txt").exists()
    # the serving artifact of an experiment (`cli export`) loaded on the CPU,
    # the softmax guard on the reference .pth, and MDF-NET
    from vitiq_torch.dsp.frontend import preprocess_batch_mdf
    from vitiq_torch.interop import load_torch_checkpoint
    from vitiq_torch.models.mdf import create_multi_domain_model
    from vitiq_torch.serve import ServingArtifact
    exp = Path(tmp, "exp")
    eval_cfg.to_json(str(exp / "config.json"))
    (exp / "normalization_stats.json").write_text(json.dumps(raw_stats))
    save_params(exp / "model_best", model.state_dict(), eval_cfg.model)
    assert cli.main(["export", "--experiment_dir", str(exp), "--output", tmp + "/art",
                     "--batch_sizes", "8", "--platforms", "cpu"]) == 0
    assert ServingArtifact.load(tmp + "/art", device="cpu").run(frames[:3]).shape == (3, 3)
    assert set(load_torch_checkpoint(tmp + "/ref.pth", eval_cfg.model)) == set(model.state_dict())
    mdf_in = preprocess_batch_mdf(torch.randn((2, 1024, 2)))
    assert create_multi_domain_model(3)(*mdf_in).shape == (2, 3)
assert sys.modules["h5py"] is None and sys.modules["sklearn"] is None
leaked = sorted(m for m in sys.modules if m.startswith(("jax", "vitiq."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_port_imports_and_serves_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def _sources():
    return sorted((ROOT / "vitiq_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _offending_imports(pattern):
    offenders = []
    for path in _sources():
        for line in path.read_text().splitlines():
            if re.match(pattern, line):
                offenders.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    return offenders


def test_port_sources_never_import_jax():
    offenders = _offending_imports(r"\s*(from|import)\s+jax(lib)?(\.|\s|$)")
    assert not offenders, offenders


def test_port_sources_never_import_vitiq():
    """Nothing of the JAX package, not even a module that needs no JAX: the
    port keeps its own copy (vitiq_torch/config.py)."""
    offenders = _offending_imports(r"\s*(from|import)\s+vitiq(\.|\s|$)")
    assert not offenders, offenders


def test_port_sources_import_h5py_only_inside_functions():
    """h5py is imported where an HDF5 file is read (so the port loads where
    it is absent, as on the card's machine), never at a module's top level."""
    offenders = _offending_imports(r"(from|import)\s+h5py(\.|\s|$)")
    assert not offenders, offenders


def test_port_sources_never_import_sklearn():
    """The reference split is reproduced with numpy (`data/splits.py`)."""
    offenders = _offending_imports(r"\s*(from|import)\s+sklearn(\.|\s|$)")
    assert not offenders, offenders


SCAN_SCRIPT = r"""
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[name]
for name in [m for m in sys.modules if m == "vitiq" or m.startswith("vitiq.")]:
    del sys.modules[name]
for name in ("jax", "jaxlib", "vitiq", "sklearn", "matplotlib", "seaborn", "h5py"):
    sys.modules[name] = None

import numpy as np
import torch
from vitiq_torch import ExperimentConfig, ModelConfig
from vitiq_torch.config import TrainConfig
from vitiq_torch.dsp.frontend import preprocess_batch_rawiq
from vitiq_torch.models import AMCModel
from vitiq_torch.sweep import decode_particle, make_amc_fitness
from vitiq_torch.train import fit
import vitiq_torch.viz  # noqa: F401  (matplotlib only inside its functions)
import vitiq_torch.parallel.comm  # noqa: F401  (the device mesh)

stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
rng = np.random.default_rng(0)
x = rng.standard_normal((96, 64, 2)).astype(np.float32)
y = rng.integers(0, 2, 96).astype(np.int32)
cfg = ExperimentConfig(
    model=ModelConfig(arm="rawiq", num_classes=2, d_model=64, n_head=4, n_layers=1,
                      ffn_hidden=64, drop_prob=0.1, seq_length=64, segment_size=16,
                      numerics="tpu"),
    train=TrainConfig(batch_size=16, num_epochs=1, device_scan_steps=2))
model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(0))
res = fit(cfg, model, (x[:80], y[:80]), (x[80:], y[80:]),
          preprocess_fn=lambda b: preprocess_batch_rawiq(b, stats), verbose=False)
assert int(res.state.step) == 5 and np.isfinite(res.history["train_loss"]).all()
fitness = make_amc_fitness((x[:80], y[:80]), (x[80:], y[80:]), num_classes=2, seq_length=64,
                           train_steps=2, bucket=True, device="cpu")
p = np.array([1.0, 64, 4, 1, 64, 0.1, 1e-3, 16, 16])
assert -1.0 <= fitness(p[None])[0] <= 0.0 and len(fitness.compile_cache) == 1
assert decode_particle(p, bucket=True)["arm"] == "rawiq"
import os
from vitiq_torch import bench
os.environ.update(VITIQ_BENCH_K_CAP="2", VITIQ_BENCH_REPS="1")  # the shallowest slope
line = bench.run_benchmarks("vit_tiny_infer", batch_size=2, steps=1, device="cpu")
assert line["metric"] == "iq_frames_per_sec_per_chip_vit_tiny" and line["value"] > 0
leaked = sorted(m for m in sys.modules if m.startswith(("jax", "vitiq."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_scan_training_and_the_sweep_run_without_jax():
    """`fit` through the scan step (K = 2: two groups and a single step of
    five), the sweep's fitness, the viz module and a bench (`cli bench`'s
    vit_tiny_infer at B=2), with jax, vitiq and matplotlib blocked."""
    proc = subprocess.run([sys.executable, "-c", SCAN_SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
