"""The softmax calibration guard in the port (`vitiq_torch/ops/guards.py`,
`interop.load_torch_checkpoint`) against vitiq's (`vitiq/ops/guards.py`,
`vitiq/interop.py`) on shared weights: the peak |scaled score| within 1e-5
relative for both arms on vitiq's default calibration batch; weights whose
w_q is scaled up raise with strict=True and warn by default; loading a
reference ``.pth`` runs the guard and gives vitiq's parameters."""

import warnings

import jax
import numpy as np
import pytest
import torch

from vitiq.config import ModelConfig as JModelConfig
from vitiq.interop import load_torch_checkpoint as jload_torch_checkpoint
from vitiq.models import init_amc_params
from vitiq.ops.guards import max_abs_attention_score as jmax_abs_attention_score
from vitiq_torch.config import ModelConfig
from vitiq_torch.interop import load_torch_checkpoint, state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.ops.guards import SAFE_SCORE_BOUND, check_softmax_bound, max_abs_attention_score

ARMS = {
    "vit": dict(arm="vit", num_classes=5, d_model=64, n_head=4, n_layers=2, ffn_hidden=128,
                img_size_h=16, img_size_w=16, seq_length=128),
    "rawiq": dict(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=2, ffn_hidden=128,
                  seq_length=128, segment_size=8),
}


def _pair(arm, numerics="tpu", seed=0):
    jcfg = JModelConfig(**ARMS[arm], numerics=numerics)
    cfg = ModelConfig(**ARMS[arm], numerics=numerics)
    params = init_amc_params(jax.random.PRNGKey(seed), jcfg)
    model = AMCModel(cfg)
    model.load_state_dict(state_dict_from_vitiq(params, cfg))
    return jcfg, params, cfg, model


def _calibration_batch(cfg):
    rng = np.random.default_rng(0)
    shape = ((32, cfg.in_channels, cfg.img_size_h, cfg.img_size_w) if cfg.arm == "vit"
             else (32, cfg.in_channels, cfg.seq_length))
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arm", ["vit", "rawiq"])
def test_peak_matches_vitiq(arm):
    jcfg, params, cfg, model = _pair(arm)
    src = _calibration_batch(cfg)
    want = jmax_abs_attention_score(params, jcfg, src)
    got = max_abs_attention_score(model, src)
    assert abs(got - want) <= 1e-5 * want
    # the default batch is vitiq's, and the model keeps its mode
    model.train()
    assert check_softmax_bound(model) == pytest.approx(got, rel=1e-6)
    assert model.training


def _scale_wq(model, factor):
    with torch.no_grad():
        for layer in model.encoder.layers:
            layer.attention.w_q.weight.mul_(factor)


@pytest.mark.parametrize("arm", ["vit", "rawiq"])
def test_scaled_wq_raises_strict_and_warns(arm):
    _, _, _, model = _pair(arm)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert check_softmax_bound(model) < SAFE_SCORE_BOUND
    _scale_wq(model, 400.0)
    with pytest.raises(ValueError, match="subtract the row max"):
        check_softmax_bound(model, strict=True)
    with pytest.warns(RuntimeWarning, match="exceeds the softmax safety bound"):
        peak = check_softmax_bound(model)
    assert peak > SAFE_SCORE_BOUND


def test_load_torch_checkpoint_runs_the_guard(tmp_path):
    jcfg, params, cfg, model = _pair("rawiq", numerics="reference")
    _scale_wq(model, 400.0)
    path = tmp_path / "ref.pth"
    torch.save({"model_state_dict": model.state_dict(), "epoch": 3}, path)
    with pytest.warns(RuntimeWarning, match="exceeds the softmax safety bound"):
        sd = load_torch_checkpoint(path, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_torch_checkpoint(path, cfg, check_bounds=False)
    want = state_dict_from_vitiq(jload_torch_checkpoint(str(path), jcfg, check_bounds=False), cfg)
    assert sorted(sd) == sorted(want)
    for name in want:
        assert torch.equal(sd[name], want[name]), name
    bare = tmp_path / "bare.pth"
    del want["mlp_head.1.weight"]
    torch.save(want, bare)
    with pytest.raises(KeyError, match="mlp_head.1.weight"):
        load_torch_checkpoint(bare, cfg)
