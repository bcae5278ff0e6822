"""The port's serving artifact (`vitiq_torch/serve.py`: `export_serving`,
`ServingArtifact`, `export_from_experiment`, ``cli export``) on the CPU,
against vitiq's (`vitiq/serve.py`, tests/test_serve_export.py).

On the CPU `ServingArtifact.run` runs the serving function eagerly, so an
artifact's logits equal `build_serving_fn`'s bit for bit at the bucket's
batch. A ragged batch is padded to its bucket: its real rows are held to the
unpadded batch within 1e-6 (a CPU GEMM may block a 20-row product otherwise
than a 32-row one, so the last bits of a row may move).

Cross-package: one vitiq experiment directory is exported by both packages
(vitiq's with ``platforms=["cpu"]``) and both artifacts run the same frames.
The limits are those of tests/test_torch_streaming.py: under f32
`reference` numerics 1e-4; under bf16 `tpu` numerics 0.05, the
fused-serving gate; at sps 2 with the Gardner hybrid a frame whose strobe
rounds to the other sample in one package (at most one of the batch) is left
out of the comparison. Under `tpu` vitiq's CPU export holds its bf16 XLA
layers (`jax.export` cannot serialize the Pallas stack in interpret mode,
whose host callbacks it refuses), the port's artifact the plain versions of
K1/K2: both within bf16 rounding of the f32 path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitiq.dsp as jdsp
import vitiq.serve as jserve
from vitiq.config import DataConfig as JDataConfig
from vitiq.config import ExperimentConfig as JExperimentConfig
from vitiq.config import ModelConfig as JModelConfig
from vitiq.models import init_amc_params
from vitiq.train.checkpoint import save_params as jsave_params
from vitiq_torch import cli
from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig
from vitiq_torch.dsp import frontend as pfront
from vitiq_torch.models import AMCModel
from vitiq_torch.serve import (
    FORMAT,
    ServingArtifact,
    build_serving_fn,
    export_from_experiment,
    export_serving,
)

STATS = {"i_mean": 0.1, "i_std": 1.2, "q_mean": -0.05, "q_std": 0.9}
TOL = {"reference": 1e-4, "tpu": 0.05}
# vitiq's _tiny_cfg (tests/test_serve_export.py): the 19-class rawIQ preset at
# 2 layers and 256-sample frames; and a tiny ViT twin (d64, [1, 16, 16]
# images of 128-sample frames)
RAW = dict(arm="rawiq", num_classes=19, d_model=128, n_head=8, n_layers=2, ffn_hidden=256,
           seq_length=256, segment_size=16)
VIT = dict(arm="vit", num_classes=5, d_model=64, n_head=4, n_layers=2, ffn_hidden=128,
           img_size_h=16, img_size_w=16, seq_length=128)
FRAMES = {"rawiq": 256, "vit": 128}


def _tiny_cfg(arm="rawiq"):
    kw = RAW if arm == "rawiq" else VIT
    return ExperimentConfig(model=ModelConfig(**kw),
                            data=DataConfig(synthetic_frame_len=FRAMES[arm]))


def _frames(n, frame_len, seed):
    return np.random.default_rng(seed).standard_normal((n, frame_len, 2)).astype(np.float32)


@pytest.fixture(scope="module", params=["rawiq", "vit"])
def artifact(request, tmp_path_factory):
    cfg = _tiny_cfg(request.param)
    model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(0))
    out = export_serving(cfg, model, STATS, tmp_path_factory.mktemp("art") / "serving",
                         batch_sizes=[8, 32], platforms=["cpu"])
    return cfg, model, out


def test_round_trip_exact(artifact):
    cfg, model, out = artifact
    art = ServingArtifact.load(out, device="cpu")
    x = _frames(32, cfg.data.frame_len, 0)
    got = art.run(x)
    want = build_serving_fn(cfg, model, STATS, "cpu")(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (32, cfg.model.num_classes)
    assert torch.equal(got, want)


def test_ragged_batch_pads_to_bucket_without_perturbation(artifact):
    cfg, model, out = artifact
    art = ServingArtifact.load(out, device="cpu")
    x = _frames(20, cfg.data.frame_len, 1)
    got = art.run(x)  # 20 -> bucket 32, sliced back
    want = build_serving_fn(cfg, model, STATS, "cpu")(x)
    assert tuple(got.shape) == (20, cfg.model.num_classes)
    assert (got - want).abs().max().item() <= 1e-6
    preds = art.predict(x)
    assert isinstance(preds, np.ndarray) and preds.shape == (20,)
    np.testing.assert_array_equal(preds, got.argmax(-1).numpy())


def test_bucket_routing_and_errors(artifact):
    cfg, _, out = artifact
    art = ServingArtifact.load(out, device="cpu")
    assert art.batch_sizes == [8, 32]
    assert [art.bucket(b) for b in (1, 5, 8, 9, 32)] == [8, 8, 8, 32, 32]
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        art.run(np.zeros((33, cfg.data.frame_len, 2), np.float32))
    with pytest.raises(ValueError, match="raw I/Q frames"):
        art.run(np.zeros((4, 77, 2), np.float32))


def test_manifest_and_config_embedded(artifact):
    cfg, _, out = artifact
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["format"] == FORMAT == "vitiq-torch-serving/1"
    assert manifest["arm"] == cfg.model.arm
    assert manifest["num_classes"] == cfg.model.num_classes
    assert manifest["frame_len"] == cfg.data.frame_len
    assert manifest["input_spec"] == [None, cfg.data.frame_len, 2]
    assert manifest["batch_sizes"] == [8, 32] and manifest["platforms"] == ["cpu"]
    assert set(manifest["entries"]) == {"8", "32"}
    art = ServingArtifact.load(out, device="cpu")
    assert art.config.model == cfg.model
    assert json.loads((out / "stats.json").read_text()) == STATS


def test_params_are_vitiqs_parameter_file(artifact):
    """The artifact's weights are a `save_params` file, which vitiq reads."""
    from vitiq.train.checkpoint import load_params as jload_params

    cfg, model, out = artifact
    jcfg = JExperimentConfig.from_json(str(out / "config.json"))
    template = init_amc_params(jax.random.PRNGKey(1), jcfg.model)
    params = jload_params(out / json.loads((out / "manifest.json").read_text())
                          ["entries"]["8"]["file"], template)
    leaves = jax.tree_util.tree_leaves(params)
    from vitiq_torch.interop import tree_leaves, vitiq_tree_from_state_dict

    want = tree_leaves(vitiq_tree_from_state_dict(model.state_dict(), cfg.model))
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_rejects_non_artifact(tmp_path):
    (tmp_path / "manifest.json").write_text(json.dumps({"format": "other/9"}))
    with pytest.raises(ValueError, match="not a vitiq_torch serving artifact"):
        ServingArtifact.load(tmp_path, device="cpu")


def test_load_rejects_vitiqs_artifact(tmp_path):
    jcfg = JExperimentConfig(model=JModelConfig(**RAW), data=JDataConfig(synthetic_frame_len=256))
    params = init_amc_params(jax.random.PRNGKey(0), jcfg.model)
    out = jserve.export_serving(jcfg, params, STATS, tmp_path / "vitiq_art", batch_sizes=[4],
                                platforms=["cpu"])
    with pytest.raises(ValueError, match="StableHLO.*export_from_experiment"):
        ServingArtifact.load(out, device="cpu")


def test_platforms_and_device(tmp_path, monkeypatch):
    """`platforms` takes cuda and cpu (default the card) and bounds where the
    artifact loads; tpu raises; loading asks for the card by default and
    raises where CUDA is absent."""
    cfg = _tiny_cfg()
    model = AMCModel(cfg.model)
    with pytest.raises(ValueError, match="platforms"):
        export_serving(cfg, model, STATS, tmp_path / "tpu", batch_sizes=[4], platforms=["tpu"])
    out = export_serving(cfg, model.state_dict(), STATS, tmp_path / "cuda", batch_sizes=[4])
    assert json.loads((out / "manifest.json").read_text())["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="exported for"):
        ServingArtifact.load(out, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingArtifact.load(out)
    both = export_serving(cfg, model, STATS, tmp_path / "both", batch_sizes=[4],
                          platforms=["cuda", "cpu"])
    assert ServingArtifact.load(both, device="cpu").run(_frames(3, 256, 2)).shape == (3, 19)


def _vitiq_experiment(root, jcfg, seed=1, weights="model_best.npz"):
    params = init_amc_params(jax.random.PRNGKey(seed), jcfg.model)
    exp = root / "exp"
    exp.mkdir()
    (exp / "config.json").write_text(jcfg.to_json())
    (exp / "normalization_stats.json").write_text(json.dumps(STATS))
    jsave_params(exp / weights, params)
    return exp, params


def test_export_from_experiment_dir(tmp_path):
    """The CLI path: a training-run directory written by vitiq."""
    jcfg = JExperimentConfig(model=JModelConfig(**RAW), data=JDataConfig(synthetic_frame_len=256))
    exp, _ = _vitiq_experiment(tmp_path, jcfg)
    out = export_from_experiment(exp, tmp_path / "art", batch_sizes=[4], platforms=["cpu"])
    art = ServingArtifact.load(out, device="cpu")
    cfg = ExperimentConfig.from_json(str(exp / "config.json"))
    from vitiq_torch.train.checkpoint import load_params

    model = AMCModel(cfg.model)
    model.load_state_dict(load_params(exp / "model_best.npz", cfg.model))
    x = _frames(4, 256, 2)
    assert torch.equal(art.run(x), build_serving_fn(cfg, model, STATS, "cpu")(x))


def test_export_missing_explicit_checkpoint_raises(tmp_path):
    """An explicitly requested checkpoint that is absent raises; only the
    default model_best.npz falls back to model_final.npz."""
    jcfg = JExperimentConfig(model=JModelConfig(**RAW), data=JDataConfig(synthetic_frame_len=256))
    exp, _ = _vitiq_experiment(tmp_path, jcfg, weights="model_final.npz")
    with pytest.raises(FileNotFoundError, match="model_bets.npz"):
        export_from_experiment(exp, tmp_path / "art", batch_sizes=[4], platforms=["cpu"],
                               checkpoint="model_bets.npz")
    out = export_from_experiment(exp, tmp_path / "art2", batch_sizes=[4], platforms=["cpu"])
    assert (out / "manifest.json").exists()


def test_cli_export_cpu(tmp_path, capsys):
    jcfg = JExperimentConfig(model=JModelConfig(**RAW), data=JDataConfig(synthetic_frame_len=256))
    exp, _ = _vitiq_experiment(tmp_path, jcfg)
    out = tmp_path / "art"
    assert cli.main(["export", "--experiment_dir", str(exp), "--output", str(out),
                     "--batch_sizes", "8,4", "--platforms", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["artifact"] == str(out)
    assert printed["batch_sizes"] == [4, 8] and printed["platforms"] == ["cpu"]
    assert set(printed["entries"]) == {"4", "8"}
    art = ServingArtifact.load(out, device="cpu")
    assert art.predict(_frames(6, 256, 3)).shape == (6,)


@pytest.mark.parametrize("numerics", ["reference", "tpu"])
@pytest.mark.parametrize("arm,data_kw", [
    ("rawiq", {}), ("vit", {}),
    ("rawiq", dict(sps=2, timing_method="gardner", timing_hybrid_window=16)),
], ids=["rawiq", "vit", "rawiq-sps2-gardner-hybrid"])
def test_artifacts_of_both_packages_agree(arm, data_kw, numerics, tmp_path):
    """One vitiq experiment directory, exported by both packages; both
    artifacts' logits on the same frames."""
    kw = dict(RAW if arm == "rawiq" else VIT)
    frame = FRAMES[arm]
    if data_kw:  # the sps-2 front-end: 128 symbols from 256-sample frames
        kw.update(d_model=64, n_head=4, ffn_hidden=128, num_classes=5, seq_length=frame // 2,
                  segment_size=8)
    jcfg = JExperimentConfig(model=JModelConfig(**kw, numerics=numerics),
                             data=JDataConfig(synthetic_frame_len=frame, **data_kw))
    exp, _ = _vitiq_experiment(tmp_path, jcfg, seed=3)
    jout = jserve.export_from_experiment(exp, tmp_path / "jart", batch_sizes=[8],
                                         platforms=["cpu"])
    pout = export_from_experiment(exp, tmp_path / "part", batch_sizes=[8], platforms=["cpu"])
    x = _frames(8, frame, 4)
    if data_kw:
        from vitiq.data import generate_test_signal

        for b in range(6):  # RRC-shaped frames, as the front-end expects
            i, q, _ = generate_test_signal(("QPSK", "16QAM")[b % 2], frame // 2, 2, 15.0,
                                           seed=b)
            x[b] = np.stack([i, q], -1)
    want = np.asarray(jserve.ServingArtifact.load(jout).run(x))
    got = ServingArtifact.load(pout, device="cpu").run(x).numpy()
    assert got.shape == want.shape == (8, kw["num_classes"])
    same = np.ones(len(x), bool)
    if data_kw:
        win = data_kw["timing_hybrid_window"]
        sym = pfront.preprocess_batch_sps(torch.as_tensor(x), 2, method="gardner",
                                          hybrid_window=win).numpy()
        sym_want = np.asarray(jdsp.preprocess_batch_sps(jnp.asarray(x), 2, method="gardner",
                                                        hybrid_window=win))
        same = np.abs(sym - sym_want).max(axis=(1, 2)) <= 1e-5
        assert same.sum() >= len(x) - 1
    assert np.abs(got[same] - want[same]).max() <= TOL[numerics]


@pytest.mark.parametrize("arm,data_kw", [
    ("rawiq", {}), ("vit", {}),
    ("rawiq", dict(sps=2, timing_method="gardner", timing_hybrid_window=16)),
], ids=["rawiq", "vit", "rawiq-sps2-gardner-hybrid"])
def test_built_front_end_makes_its_constants_once(arm, data_kw, monkeypatch):
    """`build_preprocess` with a device puts the z-score stats and the RRC
    taps there once, where it is built: its calls make no tensor from host
    numbers, and give the bits of the front-end that makes them each call."""
    from vitiq_torch.serve import build_preprocess

    frame = FRAMES[arm] * (2 if data_kw else 1)
    model = dict(RAW if arm == "rawiq" else VIT)
    model["seq_length"] = FRAMES[arm]
    cfg = ExperimentConfig(model=ModelConfig(**model),
                           data=DataConfig(synthetic_frame_len=frame, **data_kw))
    x = torch.from_numpy(_frames(6, frame, 7))
    want = build_preprocess(cfg, STATS)(x)
    built = build_preprocess(cfg, STATS, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a built front-end made a tensor from host numbers")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    assert torch.equal(built(x), want)


@pytest.mark.parametrize("arm", ["rawiq", "vit"])
def test_fused_raw_embedding_keeps_its_constants(arm, monkeypatch):
    """The fused raw embedding makes mu, 1/sigma and its index maps at its
    first call and keeps them on the encoder: a later call makes no tensor
    from host numbers, and new stats or another device make them anew."""
    from vitiq_torch.models import raw_embed

    cfg = _tiny_cfg(arm).model
    cfg.numerics = "tpu"
    other = {k: v * 1.5 for k, v in STATS.items()}
    x = torch.from_numpy(_frames(4, FRAMES[arm], 8))
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(0), raw_stats=STATS).eval()
    fresh = AMCModel(cfg, raw_stats=other).eval()
    fresh.load_state_dict(model.state_dict())
    policy = model.policy
    with torch.no_grad():
        first = raw_embed.fused_raw_embed_apply(model.encoder, x, cfg, STATS, policy)
        with monkeypatch.context() as m:
            m.setattr(torch, "tensor", lambda *a, **k: pytest.fail("constants made again"))
            again = raw_embed.fused_raw_embed_apply(model.encoder, x, cfg, STATS, policy)
        assert torch.equal(first, again)
        got = raw_embed.fused_raw_embed_apply(model.encoder, x, cfg, other, policy)
        want = raw_embed.fused_raw_embed_apply(fresh.encoder, x, cfg, other, policy)
    assert torch.equal(got, want) and not torch.equal(got, first)
