"""The port's training slice against vitiq's: loss and metrics, clip + AdamW,
the schedulers, the in-RAM feed, train steps and `fit`.

Train steps are held against `vitiq.train.loop.make_train_step` on the same
weights and batches: three steps under the f32 `reference` numerics with
dropout 0 (losses at rtol 1e-5, final parameters at atol 1e-5), and one step
under the bf16 `tpu` numerics, where the port runs K3's plain versions and
vitiq its Pallas training stack in interpret mode (loss within 1e-2
relative: the two round to bf16 at different places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq import train as jtrain
from vitiq.config import ExperimentConfig, ModelConfig, TrainConfig
from vitiq.data.feeds import ArrayFeed as JaxArrayFeed
from vitiq.dsp import preprocess_batch_vit as jax_preprocess_vit
from vitiq.models import init_amc_params, make_forward
from vitiq.ops import metrics as jmetrics
from vitiq.train import optim as joptim
from vitiq.train.loop import make_train_step as jax_make_train_step
from vitiq_torch import train as ptrain
from vitiq_torch.data.feeds import ArrayFeed
from vitiq_torch.dsp.frontend import preprocess_batch_vit
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.models import encoder as port_encoder
from vitiq_torch.ops import metrics as pmetrics
from vitiq_torch.train import loop as ploop
from vitiq_torch.train import optim as poptim

STATS = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}


def _vit(numerics="reference", drop=0.0, n_layers=2, ffn=256, classes=5):
    return ModelConfig(arm="vit", num_classes=classes, d_model=128, n_head=8, n_layers=n_layers,
                       ffn_hidden=ffn, drop_prob=drop, img_size_h=16, img_size_w=16,
                       numerics=numerics)


def _frames(n, seed, classes=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 128, 2)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_metrics_match_vitiq(smoothing):
    rng = np.random.default_rng(0)
    logits = (5 * rng.standard_normal((7, 19))).astype(np.float32)
    labels = rng.integers(0, 19, 7).astype(np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(pmetrics.log_softmax(lt).numpy(),
                               np.asarray(jmetrics.log_softmax(jnp.asarray(logits))), atol=1e-6)
    np.testing.assert_allclose(
        float(pmetrics.label_smoothed_cross_entropy(lt, yt, smoothing)),
        float(jmetrics.label_smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                    smoothing)), rtol=1e-6)
    assert float(pmetrics.accuracy(lt, yt)) == float(
        jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_clip_adamw_matches_vitiq():
    """vitiq's make_optimizer (its `_fused_clip_adamw` under
    inject_hyperparams): three updates with the clip active (gradient norms
    above 1), the learning rate halved before the third, as the plateau
    scheduler does."""
    cfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-2)
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (4 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]

    jstate = joptim.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), cfg)
    jtx = joptim.make_optimizer(cfg)
    pstate = poptim.create_train_state(
        torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                for k, v in params.items()}), cfg)
    ptx = poptim.make_optimizer(cfg)
    for i, g in enumerate(grads):
        if i == 2:
            jstate = joptim.set_learning_rate(jstate, 1.5e-3)
            pstate = poptim.set_learning_rate(pstate, 1.5e-3)
        updates, opt = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate.opt_state,
                                  jstate.params)
        jstate = jstate._replace(params=jax.tree_util.tree_map(lambda p, u: p + u,
                                                               jstate.params, updates),
                                 opt_state=opt)
        plist = list(pstate.model.parameters())
        pupd, popt = ptx.update([torch.from_numpy(g[k]) for k in ("a", "b")], pstate.opt_state,
                                plist)
        with torch.no_grad():
            for p, u in zip(plist, pupd):
                p.add_(u)
        pstate = pstate._replace(opt_state=popt)
    assert poptim.get_learning_rate(pstate) == 1.5e-3
    assert joptim.get_learning_rate(jstate) == pytest.approx(1.5e-3, rel=1e-7)  # an f32 there
    for k in ("a", "b"):
        np.testing.assert_allclose(pstate.model[k].detach().numpy(),
                                   np.asarray(jstate.params[k]), atol=1e-6, rtol=1e-6)


def test_schedulers_match_vitiq():
    losses = [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.899, 0.94, 0.95, 0.96, 0.97]
    jp, pp = jtrain.ReduceLROnPlateau(patience=2), ptrain.ReduceLROnPlateau(patience=2)
    je, pe = jtrain.EarlyStopping(patience=4), ptrain.EarlyStopping(patience=4)
    jlr = plr = 1e-3
    for i, v in enumerate(losses):
        jlr, plr = jp.step(v, jlr), pp.step(v, plr)
        assert plr == jlr
        assert pe(v, {"w": torch.full((2,), float(i))}) == je(v, {"w": jnp.full((2,), i)})
        assert pp.state_dict() == jp.state_dict() and pe.state_dict() == je.state_dict()
    assert plr < 1e-3 and pe.early_stop
    assert float(pe.best_params["w"][0]) == float(je.best_params["w"][0]) == 8.0


def test_array_feed_matches_vitiq():
    x, y = _frames(23, 2)
    jf, pf = JaxArrayFeed(x, y, shuffle_seed=4), ArrayFeed(x, y, shuffle_seed=4)
    for epoch in (0, 1):
        for (jx, jy), (px, py) in zip(jf.train_batches(epoch, 5), pf.train_batches(epoch, 5)):
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_array_equal(py, jy)
    for want, got in zip(jf.eval_batches(8), pf.eval_batches(8)):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
    assert ploop.as_feed(pf) is pf


def _jax_and_port(model_cfg, steps, train_cfg):
    """Run `steps` train steps of both packages from the same weights on the
    same batches; returns (jax losses, port losses, jax params, port model)."""
    params = init_amc_params(jax.random.PRNGKey(0), model_cfg)
    model = AMCModel(model_cfg)
    model.load_state_dict(state_dict_from_vitiq(params, model_cfg))
    batches = [_frames(6, 10 + i) for i in range(steps)]

    jstep = jax_make_train_step(make_forward(model_cfg), joptim.make_optimizer(train_cfg),
                                train_cfg.label_smoothing,
                                lambda x: jax_preprocess_vit(x, STATS, H=16, W=16))
    jstate = joptim.create_train_state(params, train_cfg)
    jlosses = []
    for x, y in batches:
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
        jlosses.append(float(m["loss"]))

    pstep = ptrain.make_train_step(poptim.make_optimizer(train_cfg), train_cfg.label_smoothing,
                                   lambda x: preprocess_batch_vit(x, STATS, H=16, W=16))
    pstate = poptim.create_train_state(model, train_cfg)
    plosses = []
    for x, y in batches:
        pstate, m = pstep(pstate, x, y, 1)
        plosses.append(float(m["loss"]))
    assert pstate.step == steps
    return jlosses, plosses, jstate.params, model


def test_three_train_steps_match_vitiq_in_f32():
    """At the default learning rate (1e-4): the w_k bias has an exactly zero
    gradient, so AdamW turns each package's rounding noise there into
    updates of up to ~lr per step."""
    model_cfg = _vit("reference")
    tcfg = TrainConfig()
    jlosses, plosses, jparams, model = _jax_and_port(model_cfg, 3, tcfg)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    want = state_dict_from_vitiq(jax.tree_util.tree_map(np.asarray, jparams), model_cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5, err_msg=name)


def test_train_step_matches_pallas_train_stack_in_bf16(monkeypatch):
    """tpu numerics: the port's fused training stack (plain K3 on the CPU)
    against vitiq's Pallas training stack, engaged off the TPU by
    VITIQ_FUSED_FORCE=1 and run in interpret mode."""
    monkeypatch.setenv("VITIQ_FUSED_FORCE", "1")
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "0")
    calls = []
    real = port_encoder.fused_train_layer_stack
    monkeypatch.setattr(port_encoder, "fused_train_layer_stack",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model_cfg = _vit("tpu")
    with pltpu.force_tpu_interpret_mode():
        jlosses, plosses, _, _ = _jax_and_port(model_cfg, 1, TrainConfig(learning_rate=1e-3))
    assert calls == [1]
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-2)


def test_dropout_is_a_function_of_seed_and_step():
    model_cfg = _vit("tpu", drop=0.1, n_layers=1, ffn=128)
    tcfg = TrainConfig(learning_rate=1e-3)
    x, y = _frames(4, 3)
    pre = lambda t: preprocess_batch_vit(t, STATS, H=16, W=16)  # noqa: E731

    def run(dropout_seed, steps=2):
        model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
        step = ptrain.make_train_step(poptim.make_optimizer(tcfg), 0.1, pre)
        state = poptim.create_train_state(model, tcfg)
        losses = []
        for _ in range(steps):
            state, m = step(state, x, y, dropout_seed)
            losses.append(float(m["loss"]))
        return losses

    a = run(1)
    assert a == run(1)
    assert a != run(2)
    assert a[0] != a[1]
    assert ploop.step_seed(1, 0) != ploop.step_seed(1, 1)
    assert -2 ** 31 <= ploop.step_seed(123456, 789) < 2 ** 31


def _fit_cfg(**train):
    return ExperimentConfig(model=_vit("tpu", drop=0.1, n_layers=1, ffn=128, classes=3),
                            train=TrainConfig(batch_size=8, num_epochs=2, **train))


def test_fit_trains_and_validates_on_current_weights(monkeypatch):
    """Every train step runs the fused training stack and every validation
    the fused eval stack; validation after each epoch equals that of a model
    loaded from the weights at that point (the in-place updates reach the
    cached kernel operands)."""
    counts = {"train": 0, "eval": 0}
    real_train, real_eval = port_encoder.fused_train_layer_stack, port_encoder.fused_encoder_layer_stack

    def train_stack(*a, **k):
        counts["train"] += 1
        return real_train(*a, **k)

    def eval_stack(*a, **k):
        counts["eval"] += 1
        return real_eval(*a, **k)

    monkeypatch.setattr(port_encoder, "fused_train_layer_stack", train_stack)
    monkeypatch.setattr(port_encoder, "fused_encoder_layer_stack", eval_stack)
    cfg = _fit_cfg(learning_rate=1e-3)
    x, y = _frames(28, 4, classes=3)
    pre = lambda t: preprocess_batch_vit(t, STATS, H=16, W=16)  # noqa: E731
    model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []

    def callback(epoch, state, history):
        fresh = AMCModel(cfg.model)
        fresh.load_state_dict(state.model.state_dict())
        val = ploop.evaluate_feed(ploop.make_eval_step(0.1, pre), fresh, ArrayFeed(x[16:], y[16:]),
                                  8)
        seen.append(val["loss"])
        assert val["loss"] == history["val_loss"][epoch]

    res = ptrain.fit(cfg, model, (x[:16], y[:16]), (x[16:], y[16:]), preprocess_fn=pre,
                     epoch_callback=callback, verbose=False)
    assert set(res.history) == {"train_loss", "train_acc", "val_loss", "val_acc", "lr",
                                "epoch_time"}
    assert res.epochs_run == 2 and len(seen) == 2 and res.state.step == 4
    assert all(len(v) == 2 for v in res.history.values())
    assert np.isfinite(res.history["train_loss"]).all()
    # per epoch: 2 train steps (16 rows in batches of 8), and 2 validation
    # batches (12 rows) in fit and 2 more in the callback
    assert counts["train"] == 4 and counts["eval"] == 2 * (2 + 2)
    assert res.state.model is model
    assert not torch.equal(model.state_dict()["mlp_head.weight"], start["mlp_head.weight"])
    assert res.best_tracked and set(res.best_params) == set(start)


def test_fit_halves_the_learning_rate_after_a_plateau():
    """With a learning rate far below f32 resolution the weights do not move,
    so the second epoch's validation loss is no improvement and patience 0
    halves the rate."""
    cfg = _fit_cfg(learning_rate=1e-30, min_lr=0.0, lr_plateau_patience=0)
    x, y = _frames(24, 5, classes=3)
    model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(0))
    res = ptrain.fit(cfg, model, (x[:16], y[:16]), (x[16:], y[16:]),
                     preprocess_fn=lambda t: preprocess_batch_vit(t, STATS, H=16, W=16),
                     verbose=False)
    assert res.history["lr"] == [1e-30, 1e-30]
    assert poptim.get_learning_rate(res.state) == 5e-31
