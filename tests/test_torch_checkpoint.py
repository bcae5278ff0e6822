"""Parameter files cross between the packages: a `model_best.npz` written by
vitiq (`vitiq.train.checkpoint.save_params`) loads into the port with f32
logits equal at 1e-5, the port's file loads into vitiq (`load_params`) bit
for bit, and a file of another config raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitiq.config import ModelConfig as VitiqModelConfig
from vitiq.models import init_amc_params, make_forward
from vitiq.train.checkpoint import load_params as vitiq_load_params
from vitiq.train.checkpoint import save_params as vitiq_save_params
from vitiq_torch.config import ModelConfig
from vitiq_torch.interop import state_dict_from_vitiq, vitiq_tree_from_state_dict
from vitiq_torch.models import AMCModel
from vitiq_torch.train.checkpoint import load_params, save_params, tree_leaves

CASES = {
    "vit": (dict(arm="vit", img_size_h=16, img_size_w=32, patch_size=4), (3, 1, 16, 32)),
    "rawiq_cls": (dict(arm="rawiq", seq_length=128, segment_size=16, use_cls_token=True),
                  (3, 2, 128)),
    "rawiq_mean": (dict(arm="rawiq", seq_length=128, segment_size=16, use_cls_token=False),
                   (3, 2, 128)),
    "conv1d": (dict(arm="rawiq", seq_length=64, embedding_type="conv1d", use_cls_token=True),
               (3, 2, 64)),
}


def _cfgs(case, **extra):
    kw = dict(num_classes=4, d_model=32, n_head=4, n_layers=2, ffn_hidden=64, drop_prob=0.0,
              numerics="reference", **CASES[case][0])
    kw.update(extra)
    return VitiqModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vitiq_file_loads_into_the_port(case, tmp_path):
    vcfg, pcfg = _cfgs(case)
    params = init_amc_params(jax.random.PRNGKey(7), vcfg)
    path = vitiq_save_params(tmp_path / "model_best", params)
    model = AMCModel(pcfg)
    model.load_state_dict(load_params(path, pcfg))
    x = np.random.default_rng(1).standard_normal(CASES[case][1]).astype(np.float32)
    want = np.asarray(make_forward(vcfg)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_file_loads_into_vitiq_bit_for_bit(case, tmp_path):
    vcfg, pcfg = _cfgs(case)
    model = AMCModel(pcfg, generator=torch.Generator().manual_seed(3))
    path = save_params(tmp_path / "model_best", model.state_dict(), pcfg)
    assert path.name == "model_best.npz"
    template = init_amc_params(jax.random.PRNGKey(0), vcfg)
    loaded = vitiq_load_params(path, template)
    want = vitiq_tree_from_state_dict(model.state_dict(), pcfg)
    got_leaves, got_def = jax.tree_util.tree_flatten(loaded)
    assert got_def == jax.tree_util.tree_structure(template)
    for got, ref in zip(got_leaves, jax.tree_util.tree_leaves(want)):
        assert got.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(got), ref)
    # and back: the port reads its own file into the same state
    again = load_params(path, pcfg)
    for key, value in model.state_dict().items():
        assert torch.equal(again[key], value), key


def test_leaf_order_is_jax_tree_order():
    vcfg, pcfg = _cfgs("rawiq_cls")
    tree = vitiq_tree_from_state_dict(AMCModel(pcfg).state_dict(), pcfg)
    shapes = [leaf.shape for leaf in tree_leaves(tree)]
    template = init_amc_params(jax.random.PRNGKey(0), vcfg)
    assert shapes == [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(template)]
    sd = state_dict_from_vitiq(tree, pcfg)
    assert set(sd) == set(AMCModel(pcfg).state_dict())


def test_a_file_of_another_config_raises(tmp_path):
    vcfg, pcfg = _cfgs("rawiq_cls")
    params = init_amc_params(jax.random.PRNGKey(1), vcfg)
    path = vitiq_save_params(tmp_path / "model_best", params)
    _, deeper = _cfgs("rawiq_cls", n_layers=3)
    with pytest.raises(ValueError, match="leaves"):
        load_params(path, deeper)
    _, wider = _cfgs("rawiq_cls", ffn_hidden=128)
    with pytest.raises(ValueError, match="shape"):
        load_params(path, wider)
