"""The port runs where JAX is absent: a fresh interpreter in which every
`import jax` fails imports `vitiq_torch`, serves one batch and trains one
epoch through the fused training stack (`fit`) on the CPU."""

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
server = Server(build_serving_fn(cfg, model, stats, "cpu"), 128, (8,))
x = torch.randn((3, 128, 2), generator=torch.Generator().manual_seed(1))
logits = server.run(x)
assert logits.shape == (3, 4) and bool(torch.isfinite(logits).all())
import numpy as np
from vitiq.config import TrainConfig
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
leaked = sorted(m for m in sys.modules if m.startswith("jax") and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_port_imports_and_serves_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_never_import_jax():
    offenders = []
    for path in sorted((ROOT / "vitiq_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import jax", "from jax")):
                offenders.append(f"{path.relative_to(ROOT)}: {stripped}")
    assert not offenders, offenders
