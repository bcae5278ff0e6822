"""vitiq parameter tree -> port state_dict -> vitiq tree, exactly."""

import jax
import numpy as np
import pytest
import torch

from vitiq.config import ModelConfig
from vitiq.interop import load_torch_state_dict
from vitiq.models import init_amc_params
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel

CONFIGS = {
    "vit": ModelConfig(arm="vit", num_classes=5, d_model=64, n_head=4, n_layers=2,
                       ffn_hidden=128, img_size_h=16, img_size_w=16, seq_length=128),
    "rawiq_cls": ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4,
                             n_layers=2, ffn_hidden=128, seq_length=256,
                             segment_size=16),
    "rawiq_mean": ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4,
                              n_layers=2, ffn_hidden=128, seq_length=256,
                              segment_size=16, use_cls_token=False),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_round_trip_is_exact(name):
    cfg = CONFIGS[name]
    params = init_amc_params(jax.random.PRNGKey(3), cfg)
    model = AMCModel(cfg)
    model.load_state_dict(state_dict_from_vitiq(params, cfg))  # strict: keys match
    back = load_torch_state_dict(model.state_dict(), cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_keys_are_the_reference_layout(name):
    cfg = CONFIGS[name]
    keys = set(AMCModel(cfg).state_dict())
    embed = ("encoder.patch_embedding.projection" if cfg.arm == "vit"
             else "encoder.sequence_embedding.projection")
    assert {f"{embed}.weight", f"{embed}.bias"} <= keys
    assert ("encoder.cls_token" in keys) == (cfg.arm == "vit" or cfg.use_cls_token)
    head = {"mlp_head.weight", "mlp_head.bias"} if cfg.arm == "vit" else {
        "mlp_head.0.weight", "mlp_head.0.bias", "mlp_head.1.weight", "mlp_head.1.bias"}
    assert head <= keys
    assert "encoder.layers.1.attention.w_concat.weight" in keys
    assert "encoder.layers.0.norm2.gamma" in keys


def test_seeded_init_is_reproducible():
    cfg = CONFIGS["vit"]
    a = AMCModel(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    b = AMCModel(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    c = AMCModel(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.cls_token"], c["encoder.cls_token"])
