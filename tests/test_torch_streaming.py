"""The front-end slices end to end, the port against `vitiq`: raw frames
through the SPS front-end (RRC matched filter and timing recovery) or the
feature transforms into a small model, and a wideband stream through the
polyphase channelizer into the classifier.

The models carry the same weights (`vitiq_torch/interop.py`). Under f32
`reference` numerics the logits agree within 1e-4 (the front-ends agree
within a few float32 ulps, see tests/test_torch_dsp.py, and two small
layers carry that). Under bf16 `tpu` numerics vitiq runs its fused Pallas
stack in interpret mode (VITIQ_FUSED_FORCE=1 and
`force_tpu_interpret_mode`, as tests/test_torch_fused_layer.py runs it) and
the port the plain versions of K1 and K2: within 0.05, the fused-serving
gate. Where a loop's strobe rounds to the other sample in one package (its
position within 1e-3 of a half-integer, tests/test_torch_dsp.py) the frame's
symbols differ; such frames are counted (at most one of the batch) and their
logits are not compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import vitiq.data as jdata
import vitiq.dsp as jdsp
import vitiq.serve as jserve
import vitiq.streaming as jstreaming
from vitiq.config import DataConfig as JDataConfig
from vitiq.config import ExperimentConfig as JExperimentConfig
from vitiq.config import ModelConfig as JModelConfig
from vitiq.models import init_amc_params, make_forward
from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig
from vitiq_torch.dsp import frontend as pfront
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.serve import Server, build_int8_serving_fn, build_preprocess, build_serving_fn
from vitiq_torch.streaming import demo_streaming, make_streaming_classifier

STATS = {"i_mean": 0.05, "i_std": 1.2, "q_mean": -0.02, "q_std": 0.8}
TOL = {"reference": 1e-4, "tpu": 0.05}
FRAME = 256
# a small rawIQ model over the sps-2 symbol stream: 128 symbols, seg-8 (17
# tokens with CLS); d64/H4 so that the fused stacks take it under `tpu`
RAW = dict(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=2, ffn_hidden=128,
           seq_length=FRAME // 2, segment_size=8)
VIT = dict(arm="vit", num_classes=5, d_model=64, n_head=4, n_layers=2, ffn_hidden=128,
           img_size_h=16, img_size_w=16, seq_length=128)


def _frames(B, sps=2, seed=0):
    """RRC-shaped QPSK / 16QAM frames of FRAME samples, then two noise frames."""
    out = []
    for b in range(B - 2):
        i, q, _ = jdata.generate_test_signal(("QPSK", "16QAM")[b % 2], FRAME // sps, sps,
                                             15.0, seed=seed + b)
        out.append(np.stack([i, q], -1))
    out += list(np.random.default_rng(seed).standard_normal((2, FRAME, 2)))
    return np.asarray(out, np.float32)


def _pair(model_kw, numerics, **data_kw):
    """(vitiq config, params, port config, port model with the same weights)."""
    jcfg = JExperimentConfig(model=JModelConfig(**model_kw, numerics=numerics),
                             data=JDataConfig(synthetic_frame_len=FRAME, **data_kw))
    pcfg = ExperimentConfig(model=ModelConfig(**model_kw, numerics=numerics),
                            data=DataConfig(synthetic_frame_len=FRAME, **data_kw))
    params = init_amc_params(jax.random.PRNGKey(3), jcfg.model)
    model = AMCModel(pcfg.model)
    model.load_state_dict(state_dict_from_vitiq(params, pcfg.model))
    return jcfg, params, pcfg, model


def _vitiq_logits(fn, numerics, monkeypatch):
    if numerics != "tpu":
        return np.asarray(fn())
    monkeypatch.setenv("VITIQ_FUSED_FORCE", "1")
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn())


@pytest.mark.parametrize("numerics", ["reference", "tpu"])
@pytest.mark.parametrize("method,window", [("gardner", 16), ("gardner", 0),
                                           ("mueller_muller", 16)],
                         ids=["gardner-hybrid", "gardner-full", "mm-hybrid"])
def test_sps_serving_matches_vitiq(method, window, numerics, monkeypatch):
    data_kw = dict(sps=2, timing_method=method, timing_hybrid_window=window)
    jcfg, params, pcfg, model = _pair(RAW, numerics, **data_kw)
    x = _frames(8)
    want = _vitiq_logits(lambda: jax.jit(jserve.build_serving_fn(jcfg, params, STATS))(
        jnp.asarray(x)), numerics, monkeypatch)
    got = build_serving_fn(pcfg, model, STATS, "cpu")(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (8, 5)
    sym = pfront.preprocess_batch_sps(torch.as_tensor(x), 2, method=method,
                                      hybrid_window=window).numpy()
    sym_want = np.asarray(jdsp.preprocess_batch_sps(jnp.asarray(x), 2, method=method,
                                                    hybrid_window=window))
    same = np.abs(sym - sym_want).max(axis=(1, 2)) <= 1e-5
    assert same.sum() >= len(x) - 1
    assert np.abs(got.numpy()[same] - want[same]).max() <= TOL[numerics]


@pytest.mark.parametrize("numerics", ["reference", "tpu"])
@pytest.mark.parametrize("arm,features", [("rawiq", "amp_phase"), ("vit", "spectrogram")])
def test_feature_serving_matches_vitiq(arm, features, numerics, monkeypatch):
    model_kw = dict(RAW, seq_length=FRAME) if arm == "rawiq" else VIT
    jcfg, params, pcfg, model = _pair(model_kw, numerics, features=features)
    x = _frames(6)
    want = _vitiq_logits(lambda: jax.jit(jserve.build_serving_fn(jcfg, params, STATS))(
        jnp.asarray(x)), numerics, monkeypatch)
    got = build_serving_fn(pcfg, model, STATS, "cpu")(x)
    assert tuple(got.shape) == want.shape == (6, 5)
    assert np.abs(got.numpy() - want).max() <= TOL[numerics]


def test_sps_front_end_through_server_and_int8():
    """Ragged requests through `Server` at sps 2 give the unpadded batch's
    logits; the int8 serving function takes the same front-end."""
    _, _, pcfg, model = _pair(RAW, "tpu", sps=2, timing_method="gardner")
    x = torch.as_tensor(_frames(8))
    serve = build_serving_fn(pcfg, model, STATS, "cpu")
    server = Server(serve, FRAME, (4, 16), device="cpu")
    full = serve(x)
    for n in (1, 3, 8):
        assert torch.allclose(server.run(x[:n]), full[:n], atol=1e-6)
    q = build_int8_serving_fn(pcfg, model, STATS, "cpu")(x)
    assert tuple(q.shape) == (8, 5) and torch.isfinite(q).all()
    assert (q - full).abs().max() < 0.35 * max(full.abs().max().item(), 1.0)


def test_build_preprocess_raises_vitiqs_errors():
    for arm, features in (("vit", "amp_phase"), ("rawiq", "spectrogram"), ("rawiq", "mdf")):
        kw = VIT if arm == "vit" else RAW
        cfg = ExperimentConfig(model=ModelConfig(**kw), data=DataConfig(features=features))
        jcfg = JExperimentConfig(model=JModelConfig(**kw), data=JDataConfig(features=features))
        from vitiq.runner import build_preprocess as jbuild

        with pytest.raises(ValueError, match="not valid") as want:
            jbuild(jcfg, STATS)
        with pytest.raises(ValueError, match="not valid") as got:
            build_preprocess(cfg, STATS)
        assert str(got.value) == str(want.value)
    cfg = ExperimentConfig(model=ModelConfig(**RAW), data=DataConfig(sps=2))
    out = build_preprocess(cfg, STATS)(torch.as_tensor(_frames(3)))
    assert tuple(out.shape) == (3, 2, FRAME // 2)


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------

@pytest.mark.parametrize("numerics", ["reference", "tpu"])
@pytest.mark.parametrize("arm", ["rawiq", "vit"])
def test_streaming_classifier_matches_vitiq(arm, numerics, monkeypatch):
    K = 8
    model_kw = dict(RAW, seq_length=128) if arm == "rawiq" else VIT
    mcfg = JModelConfig(**model_kw, numerics=numerics)
    params = init_amc_params(jax.random.PRNGKey(5), mcfg)
    pmcfg = ModelConfig(**model_kw, numerics=numerics)
    model = AMCModel(pmcfg)
    model.load_state_dict(state_dict_from_vitiq(params, pmcfg))
    rng = np.random.default_rng(K)
    w = (rng.standard_normal((2, K * 128)) + 1j * rng.standard_normal((2, K * 128))).astype(
        np.complex64)
    classify = jstreaming.make_streaming_classifier(mcfg, make_forward(mcfg), STATS,
                                                    num_channels=K)
    want = _vitiq_logits(lambda: classify(params, jnp.asarray(w)), numerics, monkeypatch)
    got = make_streaming_classifier(pmcfg, model, STATS, num_channels=K, device="cpu")(w)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, K, 5)
    assert np.abs(got.numpy() - want).max() <= TOL[numerics]
    assert model.raw_stats is None


def test_streaming_checks_the_window_and_needs_the_card(monkeypatch):
    pmcfg = ModelConfig(**dict(RAW, seq_length=128))
    classify = make_streaming_classifier(pmcfg, AMCModel(pmcfg), STATS, num_channels=8,
                                         device="cpu")
    with pytest.raises(ValueError, match="num_channels"):
        classify(np.zeros((1, 8 * 128 - 8), np.complex64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_streaming_classifier(pmcfg, AMCModel(pmcfg), STATS, num_channels=8)


def test_demo_streaming_runs_the_flagship_on_the_cpu():
    fel.reset_launches()
    out = demo_streaming(num_channels=4, numerics="reference", device="cpu")
    assert out["logits_shape"] == (1, 4, 19)
    assert out["per_channel_pred"].shape == (1, 4)
    assert sum(fel.launches.values()) == 0  # the CPU runs no kernel
