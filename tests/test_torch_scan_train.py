"""Device-scan training in the port against its per-batch path and vitiq.

* `step_seed_tensor` computes `step_seed` on the device bit for bit.
* The device AdamW state (learning rate, count, moments, step on the
  parameters' device, updated in place) gives the updates of the former
  host form bit for bit, and checkpoint leaves round-trip; a checkpoint of
  vitiq's per-leaf optimizer (``VITIQ_FUSED_OPT=0``) loads into the flat
  state and resumes.
* K3/K4's plain versions and the plain layers draw the same masks from an
  int32 seed tensor as from the int seed, and remat recomputes them.
* `superbatches` groups as vitiq's; `fit` with ``device_scan_steps=4``
  equals the port's per-batch `fit` bit for bit at dropout 0.1 (vitiq's
  ragged case: 409 train rows at batch 64, one group of four and two single
  steps), under both numerics (under `tpu` through K4's plain versions), and
  vitiq's scanned `fit` at dropout 0 on shared weights (rtol 1e-5, the
  train-parity tolerance). On the CPU the scan step runs its K steps
  eagerly; the captured CUDA graph is held to eager steps in
  `tests/test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitiq.config import ExperimentConfig as VExperimentConfig
from vitiq.config import ModelConfig as VModelConfig
from vitiq.config import TrainConfig as VTrainConfig
from vitiq.data import SyntheticAMCDataset
from vitiq.dsp import preprocess_batch_rawiq as jax_preprocess_rawiq
from vitiq.models import init_amc_params, make_forward
from vitiq.train import loop as jloop
from vitiq.train import optim as joptim
from vitiq.train.checkpoint import save_checkpoint as vitiq_save_checkpoint
from vitiq_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from vitiq_torch.dsp.frontend import preprocess_batch_rawiq
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.models import layers as players
from vitiq_torch.ops import metrics as pmetrics
from vitiq_torch.ops.cuda import fused_layer_train as flt
from vitiq_torch.train import loop as ploop
from vitiq_torch.train import optim as poptim
from vitiq_torch.train.checkpoint import load_checkpoint, save_checkpoint

STATS = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}


def _model_kw(numerics="reference", drop=0.1):
    """vitiq's tiny rawIQ experiment (`tests/test_train.py`), at d64 under
    `tpu` so that the fused training stack (K4, 9 tokens) takes it."""
    return dict(arm="rawiq", num_classes=2, d_model=64 if numerics == "tpu" else 32, n_head=4,
                n_layers=2, ffn_hidden=64, drop_prob=drop, seq_length=128, segment_size=16,
                numerics=numerics)


def _train_kw(scan, epochs=2):
    return dict(batch_size=64, num_epochs=epochs, learning_rate=1e-3, weight_decay=1e-4,
                patience=10, device_scan_steps=scan)


def _data():
    """vitiq's `tiny_data`: 512 frames, the first 409 the train split."""
    ds = SyntheticAMCDataset(classes=("BPSK", "QPSK"), frames_per_class=256, frame_len=128,
                             snrs_db=(20.0,), seed=0)
    split = int(0.8 * len(ds))
    return (ds.X[:split], ds.Y[:split]), (ds.X[split:], ds.Y[split:])


def _port_fit(scan, numerics="reference", drop=0.1, weights=None, **train):
    cfg = ExperimentConfig(model=ModelConfig(**_model_kw(numerics, drop)),
                           train=TrainConfig(**{**_train_kw(scan), **train}))
    model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict(weights)
    train_data, valid_data = _data()
    res = ploop.fit(cfg, model, train_data, valid_data,
                    preprocess_fn=lambda x: preprocess_batch_rawiq(x, STATS), verbose=False)
    return res, model


# --------------------------------------------------------------------------
# the step's seed and the optimizer on the device
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dropout_seed", [0, 1, 7, -3, 123456, 2 ** 31 - 1, 2 ** 40 + 5])
def test_step_seed_tensor_equals_step_seed(dropout_seed):
    steps = [0, 1, 2, 63, 64, 1000, 2 ** 31 - 1, 2 ** 32 + 7, 2 ** 40]
    got = [int(ploop.step_seed_tensor(dropout_seed, torch.tensor(s, dtype=torch.int64)))
           for s in steps]
    assert got == [ploop.step_seed(dropout_seed, s) for s in steps]
    t = ploop.step_seed_tensor(dropout_seed, torch.tensor(5, dtype=torch.int64))
    assert t.dtype == torch.int32 and t.dim() == 0


def _host_form_update(cfg, grads, state, params):
    """The AdamW update as the port computed it before its state moved to
    the device: the learning rate a Python float, the count an int, the bias
    corrections host tensors copied to the moments' device."""
    gflat = torch.cat([g.detach().reshape(-1).float() for g in grads])
    pflat = torch.cat([p.detach().reshape(-1).float() for p in params])
    gnorm = torch.sqrt(torch.sum(torch.square(gflat)))
    scale = torch.clamp(cfg.grad_clip_max_norm / (gnorm + 1e-16), max=1.0)
    g = gflat * scale
    count = state["count"] + 1
    mu = cfg.adam_b1 * state["mu"] + (1.0 - cfg.adam_b1) * g
    nu = cfg.adam_b2 * state["nu"] + (1.0 - cfg.adam_b2) * torch.square(g)
    c = torch.tensor(float(count), dtype=torch.float32)
    b1 = torch.tensor(cfg.adam_b1, dtype=torch.float32)
    b2 = torch.tensor(cfg.adam_b2, dtype=torch.float32)
    mhat = mu / (1.0 - torch.pow(b1, c)).to(mu.device)
    vhat = nu / (1.0 - torch.pow(b2, c)).to(nu.device)
    upd = -state["lr"] * (mhat / (torch.sqrt(vhat) + cfg.adam_eps) + cfg.weight_decay * pflat)
    updates = [u.view_as(p) for u, p in zip(upd.split([p.numel() for p in params]), params)]
    return updates, dict(state, count=count, mu=mu, nu=nu)


def test_device_adamw_equals_the_host_form_bit_for_bit(monkeypatch):
    """1,800 updates with the clip active, past the end of both bias
    correction tables (165 and 1,725 counts), the learning rate changed
    before the third (as the plateau scheduler does): the parameters and
    moments equal the host form's bit for bit; the state's tensors are the
    same objects throughout (updated in place, as a captured graph needs)."""
    cfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-2)
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    assert [len(poptim.bias_corrections(b)) for b in (0.9, 0.99)] == [165, 1725]
    with monkeypatch.context() as m, pytest.raises(ValueError, match="not 1.0"):
        m.setattr(poptim, "CORRECTION_STEPS", 100)  # 0.95's table takes ~330 counts
        poptim.bias_corrections(0.95)
    grads = [{k: (4 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(1800)]
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in init.items()})
    state = poptim.create_train_state(module, cfg)
    tensors = [state.opt_state.learning_rate, state.opt_state.count, state.opt_state.mu,
               state.opt_state.nu, state.step]
    tx = poptim.make_optimizer(cfg)
    host_params = [torch.from_numpy(init[k].copy()) for k in shapes]
    flat = torch.zeros(sum(int(np.prod(s)) for s in shapes.values()))
    host = {"lr": cfg.learning_rate, "count": 0, "mu": flat.clone(), "nu": flat.clone()}
    for i, g in enumerate(grads):
        if i == 2:
            state = poptim.set_learning_rate(state, 1.5e-3)
            host["lr"] = 1.5e-3
        gl = [torch.from_numpy(g[k]) for k in shapes]
        params = list(module.parameters())
        updates, opt = tx.update(gl, state.opt_state, params)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        state = state._replace(opt_state=opt)
        hupd, host = _host_form_update(cfg, gl, host, host_params)
        host_params = [p + u for p, u in zip(host_params, hupd)]
    for got, want in zip(module.parameters(), host_params):
        assert torch.equal(got.detach(), want)
    assert torch.equal(state.opt_state.mu, host["mu"]) and torch.equal(state.opt_state.nu,
                                                                       host["nu"])
    assert int(state.opt_state.count) == 1800 and poptim.get_learning_rate(state) == 1.5e-3
    assert all(a is b for a, b in zip(tensors, [state.opt_state.learning_rate,
                                                state.opt_state.count, state.opt_state.mu,
                                                state.opt_state.nu, state.step]))
    assert state.opt_state.learning_rate.dtype == torch.float64
    assert state.opt_state.count.dtype == torch.int32 and state.step.dtype == torch.int64


def _stepped_state(seed, steps=2):
    cfg = ModelConfig(**_model_kw())
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(seed))
    tcfg = TrainConfig(learning_rate=1e-3)
    state = poptim.create_train_state(model, tcfg)
    step = ploop.make_train_step(poptim.make_optimizer(tcfg), 0.1, None)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x = rng.standard_normal((4, 2, 128)).astype(np.float32)
        state, _ = step(state, x, rng.integers(0, 2, 4), 1)
    poptim.set_learning_rate(state, 7e-4)
    return state, cfg, tcfg


def test_train_state_leaves_round_trip():
    """A state two steps in, as vitiq's leaves, into a fresh template (in
    place) and back: the same leaves, the same device tensors."""
    state, cfg, tcfg = _stepped_state(3)
    leaves = poptim.train_state_leaves(state)
    template = poptim.create_train_state(AMCModel(cfg), tcfg)
    mu = template.opt_state.mu
    loaded = poptim.train_state_from_leaves(template, leaves)
    assert loaded.opt_state.mu is mu and int(loaded.step) == 2
    assert int(loaded.opt_state.count) == 2
    assert poptim.get_learning_rate(loaded) == float(np.float32(7e-4))
    for a, b in zip(poptim.train_state_leaves(loaded), leaves):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_per_leaf_optimizer_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """vitiq's VITIQ_FUSED_OPT=0 TrainState (the per-leaf optax chain) after
    two steps loads into the port's flat state: its per-leaf mu and nu equal
    the port's flat moments raveled in leaf order (exactly), the counts, the
    step and the learning rate carry over, and the next step agrees with
    vitiq's next step at the train-parity tolerance (loss rtol 1e-5,
    parameters atol 1e-5)."""
    kw = dict(_model_kw(drop=0.0), use_cls_token=True)
    vcfg, pcfg = VModelConfig(**kw), ModelConfig(**kw)
    tcfg, vtcfg = TrainConfig(), VTrainConfig()
    params = init_amc_params(jax.random.PRNGKey(5), vcfg)
    rng = np.random.default_rng(11)
    batches = [(rng.standard_normal((3, 2, 128)).astype(np.float32),
                rng.integers(0, 2, 3).astype(np.int32)) for _ in range(3)]
    monkeypatch.setenv("VITIQ_FUSED_OPT", "0")
    jstep = jloop.make_train_step(make_forward(vcfg), joptim.make_optimizer(vtcfg), 0.1, None)
    jstate = joptim.create_train_state(params, vtcfg)
    for x, y in batches[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
    vitiq_save_checkpoint(tmp_path / "chain", jstate, 0, 1.0, {"val_loss": [1.0]})
    model = AMCModel(pcfg)
    pstate, manifest = load_checkpoint(tmp_path / "chain", poptim.create_train_state(model, tcfg))
    adam = jstate.opt_state.inner_state[1][0]
    for moment, flat in (("mu", pstate.opt_state.mu), ("nu", pstate.opt_state.nu)):
        want = state_dict_from_vitiq(jax.tree_util.tree_map(np.asarray, getattr(adam, moment)),
                                     pcfg)
        named = list(model.named_parameters())
        for (name, p), got in zip(named, flat.split([p.numel() for _, p in named])):
            np.testing.assert_array_equal(got.view(p.shape).numpy(), want[name].numpy(),
                                          err_msg=f"{moment} {name}")
    assert int(pstate.step) == int(jstate.step) == 2 == int(pstate.opt_state.count)
    assert np.float32(poptim.get_learning_rate(pstate)) == np.float32(
        jstate.opt_state.hyperparams["learning_rate"])
    x, y = batches[2]
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
    pstep = ploop.make_train_step(poptim.make_optimizer(tcfg), 0.1, None)
    pstate, pm = pstep(pstate, x, y, 1)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = state_dict_from_vitiq(jax.tree_util.tree_map(np.asarray, jstate.params), pcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


# --------------------------------------------------------------------------
# dropout from the device seed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, -7, 2 ** 31 - 1])
def test_tensor_seed_gives_the_int_seed_masks(seed):
    t = torch.tensor([seed], dtype=torch.int32)
    for layer_idx, site in ((0, 0), (1, 1), (3, 2)):
        want = flt.dropout_mask((3, 9, 64), 0.1, seed, layer_idx, site)
        assert torch.equal(flt.dropout_mask((3, 9, 64), 0.1, t, layer_idx, site), want)
        assert torch.equal(flt.dropout_mask((3, 9, 64), 0.1, t.reshape(()), layer_idx, site),
                           want)
    assert torch.equal(flt.seed_tensor(seed, "cpu"), t)


@pytest.mark.parametrize("stash", [False, True])
def test_k3_k4_plain_versions_take_the_seed_tensor(stash):
    """K3's (recompute) and K4's (stash) plain forward and backward at
    dropout 0.1: a seed tensor gives the int seed's outputs bit for bit,
    another seed other outputs."""
    gen = torch.Generator().manual_seed(4)
    layer = players.EncoderLayer(64, 128, 4, generator=gen)
    ops = flt.flat_weights(layer, torch.bfloat16)
    x = torch.randn((2, 9, 64), generator=gen).bfloat16()
    dy = (0.1 * torch.randn((2, 9, 64), generator=gen)).bfloat16()

    def run(seed):
        if stash:
            y, st = flt.fused_train_layer_fwd_stash(x, ops, 4, 0.1, seed, 1)
            dx, grads = flt.fused_train_layer_bwd_stash(x, dy, st, ops, 4, 0.1, seed, 1)
        else:
            y = flt.fused_train_layer_fwd(x, ops, 4, 0.1, seed, 1)
            dx, grads = flt.fused_train_layer_bwd(x, dy, ops, 4, 0.1, seed, 1)
        return [y, dx, *grads]

    want = run(-12345)
    for a, b in zip(run(torch.tensor([-12345], dtype=torch.int32)), want):
        assert torch.equal(a, b)
    assert not torch.equal(run(torch.tensor([7], dtype=torch.int32))[0], want[0])


def test_plain_layers_draw_from_the_seed_and_remat_recomputes_it(monkeypatch):
    """A rawIQ model at dropout 0.2 through the plain layers, given only the
    step's seed tensor: the gradient with every layer rematerialized
    (VITIQ_TRAIN_REMAT=1) equals the one without (0) bit for bit, the masks
    are those of the int seed, another seed gives another gradient, and an
    eval pass ignores the seed."""
    cfg = ModelConfig(**dict(_model_kw(drop=0.2), n_layers=2))
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(0)).train()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 2, 128), generator=gen)
    y = torch.randint(0, 2, (3,), generator=gen)

    def grads(seed):
        loss = pmetrics.label_smoothed_cross_entropy(model(x, seed=seed), y, 0.1)
        return torch.autograd.grad(loss, list(model.parameters()))

    seed = torch.tensor(123, dtype=torch.int32)
    monkeypatch.setenv("VITIQ_TRAIN_REMAT", "1")
    remat = grads(seed)
    monkeypatch.setenv("VITIQ_TRAIN_REMAT", "0")
    plain = grads(seed)
    as_int = grads(123)
    for a, b, c in zip(remat, plain, as_int):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert not torch.equal(grads(torch.tensor(124, dtype=torch.int32))[0], plain[0])
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x, seed=seed), model(x))


def test_hash_dropout_keeps_the_fused_kernels_positions():
    """A plain layer's FFN-hidden dropout at a layer's site salt drops the
    positions K3/K4 drop there (their keep mask)."""
    x = torch.ones((2, 9, 128))
    seed = torch.tensor(77, dtype=torch.int32)
    got = players.dropout(x, 0.25, True, seed=seed, salt=flt.site_salt(1, 1)) != 0
    want = flt.dropout_mask((2, 9, 128), 0.25, 77, 1, 1) != 0
    assert torch.equal(got, want) and 0.15 < 1 - got.float().mean() < 0.35


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hash_dropout_is_the_fused_kernels_mask_in_one_function(dtype):
    """`hash_dropout` (the plain sites' kernel; its plain version here):
    x times K3/K4's f32 keep multiplier at that site, rounded to x's dtype;
    its gradient is the same function of dy; a tensor seed gives the int
    seed's bits. Training dropout without a seed raises, as vitiq's
    without an rng."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((3, 9, 96), generator=gen).to(dtype).requires_grad_(True)
    dy = torch.randn((3, 9, 96), generator=gen).to(dtype)
    salt = flt.site_salt(2, 1)
    mask = flt.dropout_mask((3, 9, 96), 0.1, 55, 2, 1)
    y = flt.hash_dropout(x, 0.1, torch.tensor(55, dtype=torch.int32), salt)
    assert y.dtype == dtype and torch.equal(y, (x.detach().float() * mask).to(dtype))
    (dx,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(dx, (dy.float() * mask).to(dtype))
    assert torch.equal(flt.hash_dropout_plain(x.detach(), 0.1, 55, salt), y)
    assert not flt.dropout_launches["hash_dropout"]
    with pytest.raises(ValueError, match="seed"):
        players.dropout(x, 0.1, True)
    assert players.dropout(x, 0.1, False) is x


# --------------------------------------------------------------------------
# superbatches, the scan step and fit
# --------------------------------------------------------------------------

def test_superbatches_groups_like_vitiq():
    rng = np.random.default_rng(0)
    shapes = [4] * 6 + [3] * 2 + [4] * 5
    items = [(rng.standard_normal((b, 5)).astype(np.float32), rng.integers(0, 3, b))
             for b in shapes]
    got = list(ploop.superbatches(iter(items), 4))
    want = list(jloop.superbatches(iter(items), 4))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[0] for g in got].count("scan") == 2
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_scan_step_equals_single_steps():
    """Three steps of `make_train_scan_step` on the CPU (eager) against three
    `make_train_step` calls from the same weights: losses, accuracies,
    parameters, moments and the step counter, bit for bit."""
    results = []
    for scan in (True, False):
        state, cfg, tcfg = _stepped_state(8, steps=0)
        tx = poptim.make_optimizer(tcfg)
        rng = np.random.default_rng(2)
        xs = rng.standard_normal((3, 4, 2, 128)).astype(np.float32)
        ys = rng.integers(0, 2, (3, 4))
        if scan:
            state, losses, accs = ploop.make_train_scan_step(tx, 0.1, None)(state, xs, ys, 9)
        else:
            step = ploop.make_train_step(tx, 0.1, None)
            ms = [step(state, x, y, 9)[1] for x, y in zip(xs, ys)]
            losses = torch.stack([m["loss"] for m in ms])
            accs = torch.stack([m["accuracy"] for m in ms])
        results.append((losses, accs, [p.detach().clone() for p in state.model.parameters()],
                        state.opt_state.mu.clone(), int(state.step)))
    (l1, a1, p1, m1, s1), (l2, a2, p2, m2, s2) = results
    assert torch.equal(l1, l2) and torch.equal(a1, a2) and torch.equal(m1, m2) and s1 == s2 == 3
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.parametrize("numerics", ["reference", "tpu"])
def test_fit_scan_equals_the_per_batch_fit_bit_for_bit(numerics):
    """vitiq's ragged case at dropout 0.1: 409 train rows at batch 64 are six
    steps an epoch, one scan group of four and two single steps; the
    histories (but the epoch times) and the final parameters equal the
    per-batch fit's bit for bit."""
    runs = [_port_fit(scan, numerics) for scan in (4, 0)]
    (rs, ms), (rp, mp) = runs
    assert int(rs.state.step) == int(rp.state.step) == 12
    for key in ("train_loss", "train_acc", "val_loss", "val_acc", "lr"):
        assert rs.history[key] == rp.history[key], key
    for a, b in zip(ms.parameters(), mp.parameters()):
        assert torch.equal(a, b)


def test_dispatch_sync_steps_does_not_change_the_trajectory():
    a, ma = _port_fit(4, dispatch_sync_steps=1)
    b, mb = _port_fit(4, dispatch_sync_steps=0)
    assert a.history["train_loss"] == b.history["train_loss"]
    assert all(torch.equal(p, q) for p, q in zip(ma.parameters(), mb.parameters()))


def test_fit_scan_matches_vitiq_scan_at_dropout_0():
    """Both packages' scanned fit (K=4) from vitiq's initial weights at
    dropout 0: the histories at rtol 1e-5."""
    kw = _model_kw(drop=0.0)
    vcfg = VExperimentConfig(model=VModelConfig(**kw), train=VTrainConfig(**_train_kw(4)))
    params = init_amc_params(jax.random.PRNGKey(0), vcfg.model)
    train_data, valid_data = _data()
    jres = jloop.fit(vcfg, make_forward(vcfg.model), params, train_data, valid_data,
                     preprocess_fn=lambda x: jax_preprocess_rawiq(x, STATS), verbose=False)
    pres, _ = _port_fit(4, drop=0.0, weights=state_dict_from_vitiq(params, vcfg.model))
    for key in ("train_loss", "train_acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(pres.history[key], jres.history[key], rtol=1e-5,
                                   err_msg=key)
    assert pres.history["lr"] == pytest.approx(jres.history["lr"], rel=1e-7)
