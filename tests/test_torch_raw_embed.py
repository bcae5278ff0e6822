"""The port's fused raw-frame embedding against `vitiq/models/raw_embed.py`.

* `fused_raw_embed_apply` on the same weights (carried by
  `state_dict_from_vitiq`) and non-trivial stats, for the three arms: f32
  (`reference`) at atol 1e-5; bf16 (`tpu`) within one bf16 ulp of the
  output (rtol 2^-7) plus 1e-2 absolute -- both round the same operands
  (x and W/sigma) to bf16 and accumulate in f32, but in another order, so
  the final rounding to bf16 may flip.
* `fused_raw_embed_enabled` over configurations x `VITIQ_FUSED_EMBED`.
* A raw-stats `AMCModel` against the unfused port path (preprocess, then
  the model) in f32: logits at atol 1e-4, and the gradients reaching the
  embedding weight, bias and CLS token at atol 1e-4.
* `build_forward_and_preprocess` picks the branch `vitiq.runner` picks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitiq import runner as jax_runner
from vitiq.config import DataConfig, ExperimentConfig, ModelConfig
from vitiq.models import init_amc_params
from vitiq.models import raw_embed as jax_raw_embed
from vitiq.ops.numerics import policy_for as jax_policy_for
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.models import raw_embed
from vitiq_torch.ops.numerics import policy_for
from vitiq_torch.serve import build_forward_and_preprocess, build_preprocess

STATS = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}
CONFIGS = {
    # ViT over a 16x16 image, patch 4: the block-sparse [256, 17 * 64] operand
    "vit": ModelConfig(arm="vit", num_classes=5, d_model=64, n_head=4, n_layers=1,
                       ffn_hidden=128, img_size_h=16, img_size_w=16, seq_length=128,
                       patch_size=4),
    "segment_cls": ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=1,
                               ffn_hidden=128, seq_length=256, segment_size=16),
    "segment_mean": ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=1,
                                ffn_hidden=128, seq_length=256, segment_size=16,
                                use_cls_token=False),
    "conv1d": ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=1,
                          ffn_hidden=128, seq_length=64, embedding_type="conv1d"),
}


def _setup(name, numerics="reference", seed=0):
    cfg = dataclasses.replace(CONFIGS[name], numerics=numerics)
    params = init_amc_params(jax.random.PRNGKey(seed), cfg)
    model = AMCModel(cfg)
    model.load_state_dict(state_dict_from_vitiq(params, cfg))
    x = 1.5 * np.random.default_rng(seed).standard_normal((3, cfg.seq_length, 2)) + 0.2
    return cfg, params, model, x.astype(np.float32)


@pytest.mark.parametrize("numerics", ["reference", "tpu"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_raw_embed_matches_vitiq(name, numerics):
    cfg, params, model, x = _setup(name, numerics)
    want = jax_raw_embed.fused_raw_embed_apply(params["encoder"], jnp.asarray(x), cfg, STATS,
                                               jax_policy_for(numerics))
    with torch.no_grad():
        got = raw_embed.fused_raw_embed_apply(model.encoder, torch.from_numpy(x), cfg, STATS,
                                              policy_for(numerics))
    want = np.asarray(want.astype(jnp.float32))
    assert tuple(got.shape) == want.shape == (3, cfg.num_tokens, cfg.d_model)
    if numerics == "reference":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=2 ** -7)


def test_fused_raw_embed_checks_the_frame_shape():
    cfg, _, model, x = _setup("segment_cls")
    with pytest.raises(ValueError, match="expected raw"):
        raw_embed.fused_raw_embed_apply(model.encoder, torch.from_numpy(x[:, :128]), cfg, STATS,
                                        policy_for("reference"))


GATE_CONFIGS = [
    CONFIGS["vit"],                                                   # (N+1)*D = 1088
    ModelConfig(arm="vit", d_model=128, patch_size=4),                # flagship: 16512
    ModelConfig(arm="vit", d_model=64, img_size_h=16, img_size_w=16),  # 16x16 != 2 * 1024
    ModelConfig(arm="vit", in_channels=2, img_size_h=16, img_size_w=16, seq_length=128),
    CONFIGS["segment_cls"],
    CONFIGS["conv1d"],
    ModelConfig(arm="rawiq", seq_length=1000, segment_size=16),       # 16 does not divide 1000
]


@pytest.mark.parametrize("env", [None, "0", "1", "auto"])
@pytest.mark.parametrize("numerics", ["reference", "tpu"])
def test_fused_raw_embed_enabled_matches_vitiq(env, numerics, monkeypatch):
    if env is not None:
        monkeypatch.setenv("VITIQ_FUSED_EMBED", env)
    for cfg in GATE_CONFIGS:
        cfg = dataclasses.replace(cfg, numerics=numerics)
        assert (raw_embed.fused_raw_embed_supported(cfg)
                == jax_raw_embed.fused_raw_embed_supported(cfg)), cfg
        assert (raw_embed.fused_raw_embed_enabled(cfg)
                == jax_raw_embed.fused_raw_embed_enabled(cfg)), cfg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_raw_stats_model_matches_unfused_path(name):
    """Logits in eval and, at dropout 0 in training, the gradients of every
    embedding parameter: the fused GEMM is the unfused chain's algebra."""
    cfg, _, trained, x = _setup(name)
    cfg = dataclasses.replace(cfg, drop_prob=0.0)
    exp = ExperimentConfig(model=cfg, data=DataConfig(synthetic_frame_len=cfg.seq_length))
    model, fused = AMCModel(cfg), AMCModel(cfg, raw_stats=STATS)
    model.load_state_dict(trained.state_dict())
    fused.load_state_dict(trained.state_dict())
    assert fused.state_dict().keys() == model.state_dict().keys()
    xt = torch.from_numpy(x)
    pre = build_preprocess(exp, STATS)
    with torch.no_grad():
        np.testing.assert_allclose(fused.eval()(xt).numpy(), model.eval()(pre(xt)).numpy(),
                                   atol=1e-4)
    fused.train()(xt).square().sum().backward()
    model.train()(pre(xt)).square().sum().backward()
    want = dict(model.named_parameters())
    embedding = [n for n in want if "embedding" in n or n == "encoder.cls_token"]
    assert len(embedding) == (3 if cfg.arm == "vit" or cfg.use_cls_token else 2)
    for n, p in fused.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        if n in embedding:
            assert p.grad.abs().max() > 0, n
            np.testing.assert_allclose(p.grad.numpy(), want[n].grad.numpy(), atol=1e-4,
                                       err_msg=n)


@pytest.mark.parametrize("name,numerics,env", [
    ("segment_cls", "tpu", None),        # rawIQ under tpu: fused
    ("segment_mean", "tpu", None),
    ("conv1d", "tpu", None),
    ("vit", "tpu", None),                # a narrow ViT: fused
    ("segment_cls", "reference", None),  # f32 keeps the unfused chain
    ("segment_cls", "tpu", "0"),
    ("vit", "reference", "1"),
])
def test_build_forward_and_preprocess_picks_vitiq_branch(name, numerics, env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("VITIQ_FUSED_EMBED", env)
    cfg, _, model, x = _setup(name, numerics)
    exp = ExperimentConfig(model=cfg, data=DataConfig(synthetic_frame_len=cfg.seq_length))
    _, jax_pre = jax_runner.build_forward_and_preprocess(exp, STATS)
    fused = jax_pre(x) is x  # vitiq's identity preprocess
    built, pre = build_forward_and_preprocess(exp, cfg, STATS, device="cpu")
    given, pre2 = build_forward_and_preprocess(exp, model, STATS, device="cpu")
    assert given is model
    xt = torch.from_numpy(x)
    for m, p in ((built, pre), (given, pre2)):
        assert (p(xt) is xt) == fused
        assert m.raw_stats == (STATS if fused else None)
        assert tuple(m.eval()(p(xt)).shape) == (3, cfg.num_classes)
