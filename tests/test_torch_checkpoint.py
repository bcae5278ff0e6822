"""Parameter files and checkpoints cross between the packages.

A `model_best.npz` written by vitiq (`vitiq.train.checkpoint.save_params`)
loads into the port with f32 logits equal at 1e-5, the port's file loads into
vitiq (`load_params`) bit for bit, and a file of another config raises.

A TrainState checkpoint (`save_checkpoint`) written by either package after
two train steps (f32 `reference` numerics, dropout 0) resumes in the other:
the loaded parameters, AdamW moments (mapped from vitiq's raveled tree order
and [in, out] kernels to the port's flat torch order), counts and learning
rate equal the writer's, and the next step's loss agrees at rtol 1e-5 and
its parameters at atol 1e-5 (the tolerance `test_torch_train.py` holds f32
steps to: the w_k bias has an exactly zero gradient, so AdamW turns each
package's rounding noise there into updates). A checkpoint of another
config raises (vitiq's per-leaf optimizer, ``VITIQ_FUSED_OPT=0``, loads:
`tests/test_torch_scan_train.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from vitiq.config import ModelConfig as VitiqModelConfig
from vitiq.config import TrainConfig
from vitiq.models import init_amc_params, make_forward
from vitiq.train import optim as joptim
from vitiq.train.checkpoint import load_checkpoint as vitiq_load_checkpoint
from vitiq.train.checkpoint import load_params as vitiq_load_params
from vitiq.train.checkpoint import save_checkpoint as vitiq_save_checkpoint
from vitiq.train.checkpoint import save_params as vitiq_save_params
from vitiq.train.loop import make_train_step as jax_make_train_step
from vitiq_torch import train as ptrain
from vitiq_torch.config import ModelConfig
from vitiq_torch.interop import state_dict_from_vitiq, vitiq_tree_from_state_dict
from vitiq_torch.models import AMCModel
from vitiq_torch.train import optim as poptim
from vitiq_torch.train.checkpoint import (
    load_checkpoint,
    load_params,
    save_checkpoint,
    save_params,
    tree_leaves,
)

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


HISTORY = {"train_loss": [1.5], "train_acc": [0.25], "val_loss": [1.25], "val_acc": [0.5],
           "lr": [1e-4], "epoch_time": [0.5]}


def _batches(case, n):
    rng = np.random.default_rng(11)
    return [(rng.standard_normal(CASES[case][1]).astype(np.float32),
             rng.integers(0, 4, CASES[case][1][0]).astype(np.int32)) for _ in range(n)]


def _vitiq_steps(vcfg, params, batches, tcfg, state=None):
    step = jax_make_train_step(make_forward(vcfg), joptim.make_optimizer(tcfg), 0.1, None)
    state = state or joptim.create_train_state(params, tcfg)
    losses = []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(model, batches, tcfg, state=None):
    step = ptrain.make_train_step(poptim.make_optimizer(tcfg), 0.1, None)
    state = state or poptim.create_train_state(model, tcfg)
    losses = []
    for x, y in batches:
        state, m = step(state, x, y, 1)
        losses.append(float(m["loss"]))
    return state, losses


def _assert_same_state(pstate, jstate, pcfg):
    """The port's state equals vitiq's: parameters, AdamW moments (unraveled
    by jax into vitiq's tree, then into the port's names and layouts), counts
    and learning rate."""
    named = list(pstate.model.named_parameters())
    want = state_dict_from_vitiq(jax.tree_util.tree_map(np.asarray, jstate.params), pcfg)
    _, unravel = ravel_pytree(jstate.params)
    inner = jstate.opt_state.inner_state
    for moment, flat in (("mu", pstate.opt_state.mu), ("nu", pstate.opt_state.nu)):
        tree = jax.tree_util.tree_map(np.asarray, unravel(getattr(inner, moment)))
        want_m = state_dict_from_vitiq(tree, pcfg)
        for (name, p), got in zip(named, flat.split([p.numel() for _, p in named])):
            np.testing.assert_array_equal(got.view(p.shape).numpy(), want_m[name].numpy(),
                                          err_msg=f"{moment} {name}")
    for name, p in named:
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
    assert pstate.step == int(jstate.step) == int(inner.count)
    assert pstate.opt_state.count == int(inner.count) == int(jstate.opt_state.count)
    assert np.float32(pstate.opt_state.learning_rate) == np.float32(
        jstate.opt_state.hyperparams["learning_rate"])


def _next_step_agrees(pstate, jstate, vcfg, pcfg, batch, tcfg):
    jstate, jloss = _vitiq_steps(vcfg, None, [batch], tcfg, jstate)
    pstate, ploss = _port_steps(pstate.model, [batch], tcfg, pstate)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    want = state_dict_from_vitiq(jax.tree_util.tree_map(np.asarray, jstate.params), pcfg)
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["vit", "rawiq_cls"])
def test_vitiq_checkpoint_resumes_in_the_port(case, tmp_path):
    vcfg, pcfg = _cfgs(case)
    tcfg = TrainConfig()
    batches = _batches(case, 3)
    jstate, _ = _vitiq_steps(vcfg, init_amc_params(jax.random.PRNGKey(5), vcfg), batches[:2],
                             tcfg)
    vitiq_save_checkpoint(tmp_path / "ck", jstate, 0, 1.25, HISTORY)
    model = AMCModel(pcfg, generator=torch.Generator().manual_seed(9))
    pstate, manifest = load_checkpoint(tmp_path / "ck", poptim.create_train_state(model, tcfg))
    assert manifest["history"] == HISTORY and manifest["epoch"] == 0
    assert pstate.model is model
    _assert_same_state(pstate, jstate, pcfg)
    _next_step_agrees(pstate, jstate, vcfg, pcfg, batches[2], tcfg)


@pytest.mark.parametrize("case", ["vit", "rawiq_cls"])
def test_port_checkpoint_resumes_in_vitiq(case, tmp_path):
    vcfg, pcfg = _cfgs(case)
    tcfg = TrainConfig()
    batches = _batches(case, 3)
    params = init_amc_params(jax.random.PRNGKey(6), vcfg)
    model = AMCModel(pcfg)
    model.load_state_dict(state_dict_from_vitiq(params, pcfg))
    pstate, _ = _port_steps(model, batches[:2], tcfg)
    path = save_checkpoint(tmp_path / "ck", pstate, 1, 1.25, HISTORY, extra={"by": "port"})
    assert path.name == "ck.npz"
    jstate, manifest = vitiq_load_checkpoint(tmp_path / "ck", joptim.create_train_state(params,
                                                                                         tcfg))
    assert manifest["epoch"] == 1 and manifest["extra"] == {"by": "port"}
    _assert_same_state(pstate, jstate, pcfg)
    _next_step_agrees(pstate, jstate, vcfg, pcfg, batches[2], tcfg)


def test_checkpoints_of_another_optimizer_or_config_are_refused(tmp_path, monkeypatch):
    """vitiq's per-leaf optax chain (VITIQ_FUSED_OPT=0) loads
    (`test_per_leaf_optimizer_checkpoint_resumes_in_the_port`), but not one
    of another config; nor a port checkpoint of another width or a missing
    file."""
    vcfg, pcfg = _cfgs("rawiq_cls")
    vdeep, _ = _cfgs("rawiq_cls", n_layers=3)
    params = init_amc_params(jax.random.PRNGKey(2), vdeep)
    monkeypatch.setenv("VITIQ_FUSED_OPT", "0")  # vitiq's per-leaf optax chain
    vitiq_save_checkpoint(tmp_path / "chain", joptim.create_train_state(params, TrainConfig()),
                          0, 1.0, HISTORY)
    template = poptim.create_train_state(AMCModel(pcfg), TrainConfig())
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(tmp_path / "chain", template)
    monkeypatch.delenv("VITIQ_FUSED_OPT")
    save_checkpoint(tmp_path / "port", template, 0, 1.0, HISTORY)
    _, wider = _cfgs("rawiq_cls", ffn_hidden=128)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path / "port", poptim.create_train_state(AMCModel(wider),
                                                                     TrainConfig()))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "missing", template)
