"""The whole serving slice: raw frames -> logits, port against `vitiq`.

* f32 `reference`: the port's `build_serving_fn` against
  `vitiq.serve.build_serving_fn`, atol 1e-5 on logits, at small widths and
  at `rawiq_best`'s full width and depth (d256/L9, 65 tokens).
* The model helpers (`make_feature_extractor`, `count_parameters`,
  `make_attention_map_fn`) against vitiq's, in f32.
* bf16 `tpu`: the port (plain version of the fused kernels on the CPU)
  against `vitiq`'s `make_forward(numerics="tpu")` with its preprocess,
  max |dlogit| <= 0.05 (the fused-serving gate of scripts/tpu_check_fused.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitiq.models.amc as jamc
import vitiq.serve as jax_serve
from vitiq.bench import rawiq_best_config
from vitiq.config import DataConfig, ExperimentConfig, ModelConfig
from vitiq.dsp import preprocess_batch_rawiq, preprocess_batch_vit
from vitiq.models import init_amc_params, make_forward
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.models import amc as pamc
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.serve import Server, build_serving_fn

STATS = {"i_mean": 0.05, "i_std": 1.2, "q_mean": -0.02, "q_std": 0.8}
CONFIGS = {
    # small ViT: d64/L2/H4 over a 16x16 image (128-sample frames, 17 tokens)
    "vit": (ModelConfig(arm="vit", num_classes=7, d_model=64, n_head=4, n_layers=2,
                        ffn_hidden=128, img_size_h=16, img_size_w=16,
                        seq_length=128), 128),
    # small rawIQ: seg-16 over 256 samples (17 tokens with CLS, 16 without)
    "rawiq_cls": (ModelConfig(arm="rawiq", num_classes=7, d_model=64, n_head=4,
                              n_layers=2, ffn_hidden=128, seq_length=256,
                              segment_size=16), 256),
    "rawiq_mean": (ModelConfig(arm="rawiq", num_classes=7, d_model=64, n_head=4,
                               n_layers=2, ffn_hidden=128, seq_length=256,
                               segment_size=16, use_cls_token=False), 256),
}
# the reference's best published geometry at full width and depth
BEST = {"rawiq_best": (rawiq_best_config("reference"), 1024)}


def _setup(name, numerics, seed=0):
    mcfg, frame_len = {**CONFIGS, **BEST}[name]
    mcfg = dataclasses.replace(mcfg, numerics=numerics)
    exp = ExperimentConfig(model=mcfg, data=DataConfig(synthetic_frame_len=frame_len))
    params = init_amc_params(jax.random.PRNGKey(seed), mcfg)
    model = AMCModel(mcfg)
    model.load_state_dict(state_dict_from_vitiq(params, mcfg))
    x = np.random.default_rng(seed).standard_normal((6, frame_len, 2)).astype(np.float32)
    return exp, params, model, x


@pytest.mark.parametrize("name", sorted(CONFIGS) + sorted(BEST))
def test_reference_logits_match_vitiq(name):
    exp, params, model, x = _setup(name, "reference")
    want = np.asarray(jax.jit(jax_serve.build_serving_fn(exp, params, STATS))(jnp.asarray(x)))
    got = build_serving_fn(exp, model, STATS, "cpu")(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tpu_numerics_logits_match_vitiq(name):
    exp, params, model, x = _setup(name, "tpu")
    mcfg = exp.model
    if mcfg.arm == "vit":
        pre = lambda z: preprocess_batch_vit(z, STATS, H=mcfg.img_size_h, W=mcfg.img_size_w)
    else:
        pre = lambda z: preprocess_batch_rawiq(z, STATS)
    fwd = make_forward(mcfg)
    want = np.asarray(jax.jit(lambda p, z: fwd(p, pre(z)))(params, jnp.asarray(x)))
    got = build_serving_fn(exp, model, STATS, "cpu")(x)
    assert np.abs(got.numpy() - want).max() <= 0.05


def test_tpu_serving_takes_fused_path_with_cls_tail(monkeypatch):
    exp, _, model, x = _setup("vit", "tpu")
    calls = []
    real = fel.fused_layer_reference

    real_cls = fel.fused_layer_cls_reference

    def spy(xx, ops, n_head, n_q):
        calls.append((tuple(xx.shape), xx.dtype, n_q))
        return real(xx, ops, n_head, n_q)

    def spy_cls(xx, ops, n_head):  # K2's plain version: the CLS row only
        calls.append((tuple(xx.shape), xx.dtype, 1))
        return real_cls(xx, ops, n_head)

    monkeypatch.setattr(fel, "fused_layer_reference", spy)
    monkeypatch.setattr(fel, "fused_layer_cls_reference", spy_cls)
    build_serving_fn(exp, model, STATS, "cpu")(x)
    # one full layer, then the last layer for the CLS row only
    assert calls == [((6, 17, 64), torch.bfloat16, 17), ((6, 17, 64), torch.bfloat16, 1)]


@pytest.mark.parametrize("env", ["VITIQ_NO_FUSED_LAYER=1", "VITIQ_CLS_ONLY=0"])
def test_opt_outs_compute_the_same_logits(env, monkeypatch):
    exp, _, model, x = _setup("vit", "tpu")
    serve = build_serving_fn(exp, model, STATS, "cpu")
    fused = serve(x)
    key, value = env.split("=")
    monkeypatch.setenv(key, value)
    assert torch.abs(serve(x) - fused).max() <= 0.05


@pytest.mark.parametrize("numerics", ["reference", "tpu"])
def test_bucket_routing_pads_and_slices(numerics):
    exp, _, model, x = _setup("vit", numerics)
    serve = build_serving_fn(exp, model, STATS, "cpu")
    server = Server(serve, frame_len=128, batch_sizes=(4, 16), device="cpu")
    assert server.bucket(1) == 4 and server.bucket(5) == 16
    for b in (1, 4, 5):
        got = server.run(x[:b])
        assert tuple(got.shape) == (b, 7)
        torch.testing.assert_close(got, serve(x[:b]), rtol=0, atol=1e-6)
    assert torch.equal(server.predict(x[:3]), server.run(x[:3]).argmax(-1))
    with pytest.raises(ValueError, match="largest bucket"):
        server.run(np.zeros((17, 128, 2), np.float32))
    with pytest.raises(ValueError, match="raw I/Q frames"):
        server.run(np.zeros((2, 64, 2), np.float32))


def _preprocessed(exp, x):
    mcfg = exp.model
    if mcfg.arm == "vit":
        return np.array(preprocess_batch_vit(jnp.asarray(x), STATS, H=mcfg.img_size_h,
                                               W=mcfg.img_size_w))
    return np.array(preprocess_batch_rawiq(jnp.asarray(x), STATS))


@pytest.mark.parametrize("name", ["vit", "rawiq_mean"])
def test_model_helpers_match_vitiq(name):
    """The port's helpers on an `AMCModel` against vitiq's on the same
    weights (f32 `reference`): the encoder's sequence and CLS outputs within
    1e-5, the parameter count equal, each layer's attention maps within
    1e-6."""
    exp, params, model, x = _setup(name, "reference")
    src = _preprocessed(exp, x)
    want = jamc.make_feature_extractor(exp.model)(params, jnp.asarray(src))
    got = pamc.make_feature_extractor(model)(torch.from_numpy(src))
    np.testing.assert_allclose(got["sequence_output"].numpy(),
                               np.asarray(want["sequence_output"]), atol=1e-5)
    if want["cls_output"] is None:
        assert got["cls_output"] is None
    else:
        np.testing.assert_allclose(got["cls_output"].numpy(), np.asarray(want["cls_output"]),
                                   atol=1e-5)
    assert pamc.count_parameters(model) == jamc.count_parameters(params)
    want_maps = jamc.make_attention_map_fn(exp.model)(params, jnp.asarray(src))
    got_maps = pamc.make_attention_map_fn(model)(torch.from_numpy(src))
    assert len(got_maps) == len(want_maps) == exp.model.n_layers
    for g, w in zip(got_maps, want_maps):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
