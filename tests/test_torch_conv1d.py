"""The conv1d arm (one token per sample: the reference's long-sequence mode)
through the port against `vitiq`, on a d64/L2/H4 model whose weights come
from `vitiq` through `interop.state_dict_from_vitiq`: seq_length 128 (129
tokens) and 600 (601 tokens). Under `tpu` numerics the port trains this
d64 model through the fused training stack (K3's plain versions on the
CPU), which has no remat; the stack turns the conv1d flagship's 1025 tokens
down, and those train through the plain layers with K5 (`fused_attention`)
as their attention, each layer rematerialized above 512 tokens
(`VITIQ_TRAIN_REMAT=auto`, as in vitiq): a route driven here at an FFN
width of 96, which the stack turns down.

Tolerances: f32 `reference` logits and one train step at 1e-5 (losses
relative, parameters absolute). bf16 `tpu`: logits within 0.05 of vitiq's
(the fused-serving gate; vitiq's CPU path runs XLA attention where the port
runs K1 or K5's plain versions, rounding bf16 at other places), gradients by
cosine >= 0.999 and the loss within 1e-2 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitiq.config import ModelConfig, TrainConfig
from vitiq.models import init_amc_params, make_forward
from vitiq.ops import metrics as jmetrics
from vitiq.train import optim as joptim
from vitiq.train.loop import make_train_step as jax_make_train_step
from vitiq_torch import train as ptrain
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.models import encoder as port_encoder
from vitiq_torch.ops import metrics as pmetrics
from vitiq_torch.ops.cuda import flash_attention as fa
from vitiq_torch.train import optim as poptim


def _cfg(seq, numerics="reference", drop=0.0):
    return ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=2,
                       ffn_hidden=128, drop_prob=drop, seq_length=seq,
                       embedding_type="conv1d", numerics=numerics)


def _setup(cfg, seed=0, batch=4):
    params = init_amc_params(jax.random.PRNGKey(seed), cfg)
    model = AMCModel(cfg)
    model.load_state_dict(state_dict_from_vitiq(params, cfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 2, cfg.seq_length)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    return params, model, x, y


@pytest.fixture
def k5_calls(monkeypatch):
    """Count the calls of K5's two wrappers (their plain versions on the
    CPU), as the model reaches them through `FusedAttention`."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.fused_attention_fwd, fa.fused_attention_bwd

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(fa, "fused_attention_fwd", fwd)
    monkeypatch.setattr(fa, "fused_attention_bwd", bwd)
    return calls


@pytest.mark.parametrize("seq", [128, 600])
def test_logits_match_vitiq(seq):
    cfg = _cfg(seq)
    params, model, x, _ = _setup(cfg)
    want = np.asarray(jax.jit(make_forward(cfg))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    tcfg = dataclasses.replace(cfg, numerics="tpu")
    want = np.asarray(jax.jit(make_forward(tcfg))(params, jnp.asarray(x)))
    tmodel = AMCModel(tcfg)
    tmodel.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 0.05


def test_no_fused_layer_eval_goes_through_k5(k5_calls, monkeypatch):
    """VITIQ_NO_FUSED_LAYER=1: the plain layer loop, K5 as every layer's
    attention, no K1/K2; logits within the gate of vitiq's."""
    monkeypatch.setenv("VITIQ_NO_FUSED_LAYER", "1")
    cfg = _cfg(128, "tpu")
    params, model, x, _ = _setup(cfg, seed=1)
    stack = []
    real = port_encoder.fused_encoder_layer_stack
    monkeypatch.setattr(port_encoder, "fused_encoder_layer_stack",
                        lambda *a, **k: stack.append(1) or real(*a, **k))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert k5_calls == {"fwd": cfg.n_layers, "bwd": 0} and not stack
    want = np.asarray(jax.jit(make_forward(cfg))(params, jnp.asarray(x)))
    assert np.abs(got.numpy() - want).max() <= 0.05


def test_train_steps_match_vitiq_in_f32():
    """Two make_train_step steps at dropout 0 and 601 tokens (remat on in
    both packages) from the same weights on the same batch: the losses at
    rtol 1e-5 and every parameter after the AdamW updates at atol 1e-5, but
    the w_k bias, whose gradient is exactly zero (softmax ignores a shift of
    all keys), so AdamW turns each package's rounding noise there into
    updates of up to ~lr."""
    cfg = _cfg(600)
    params, model, x, y = _setup(cfg, seed=2)
    tcfg = TrainConfig(learning_rate=1e-3)
    jstep = jax_make_train_step(make_forward(cfg), joptim.make_optimizer(tcfg),
                                tcfg.label_smoothing)
    pstep = ptrain.make_train_step(poptim.make_optimizer(tcfg), tcfg.label_smoothing)
    jstate = joptim.create_train_state(params, tcfg)
    pstate = poptim.create_train_state(model, tcfg)
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
        pstate, pm = pstep(pstate, x, y, 1)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = state_dict_from_vitiq(jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    got = model.state_dict()
    for name, w in want.items():
        if not name.endswith("attention.w_k.bias"):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5, err_msg=name)


def _port_grad(model, x, y, seed=0):
    model.train()
    logits = model(torch.from_numpy(x), seed=seed)
    loss = pmetrics.label_smoothed_cross_entropy(logits, torch.from_numpy(y).long(), 0.1)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    named = dict(zip([n for n, _ in model.named_parameters()], grads))
    return loss.item(), named


@pytest.mark.parametrize("seq", [128, 600])
@pytest.mark.parametrize("numerics", ["reference", "tpu"])
def test_gradient_matches_vitiq(seq, numerics):
    """The gradient of one training step's loss at dropout 0: f32 at atol
    1e-5 per parameter, bf16 by cosine >= 0.999 (loss within 1e-2)."""
    cfg = _cfg(seq, numerics)
    params, model, x, y = _setup(cfg, seed=3)
    fwd = make_forward(cfg)

    def loss_fn(p):
        logits = fwd(p, jnp.asarray(x), train=True, rng=jax.random.PRNGKey(0))
        return jmetrics.label_smoothed_cross_entropy(logits, jnp.asarray(y), 0.1)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_vitiq(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    loss, got = _port_grad(model, x, y)
    if numerics == "reference":
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5, err_msg=name)
        return
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-2)
    a = torch.cat([got[n].reshape(-1).float() for n in want])
    b = torch.cat([want[n].reshape(-1) for n in want])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.999


@pytest.mark.parametrize("numerics", ["reference", "tpu"])
def test_remat_with_dropout_gives_the_gradient_without_remat(numerics, monkeypatch, k5_calls):
    """Dropout 0.2 at 601 tokens and an FFN width of 96, which the fused
    training stack turns down, so the plain layers run (with K5 under
    `tpu`, once more per layer in the recompute): the rematerialized layers
    (auto) draw the forward's dropout masks again from the step's seed, so
    the gradient equals the one without remat (VITIQ_TRAIN_REMAT=0) at
    1e-6."""
    cfg = dataclasses.replace(_cfg(600, numerics, drop=0.2), ffn_hidden=96)
    _, model, x, y = _setup(cfg, seed=4, batch=2)
    assert port_encoder.use_remat(True, cfg.num_tokens)
    loss, remat = _port_grad(model, x, y)
    n = cfg.n_layers if numerics == "tpu" else 0
    assert k5_calls == {"fwd": 2 * n, "bwd": n}
    monkeypatch.setenv("VITIQ_TRAIN_REMAT", "0")
    assert not port_encoder.use_remat(True, cfg.num_tokens)
    loss0, plain = _port_grad(model, x, y)
    assert loss == loss0
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, atol=1e-6, rtol=0, msg=name)
    _, other = _port_grad(model, x, y, seed=4)  # the masks do matter
    assert not torch.equal(other["encoder.layers.0.ffn.linear1.weight"],
                           plain["encoder.layers.0.ffn.linear1.weight"])


@pytest.mark.parametrize("seq,fwd_per_layer", [(128, 1), (600, 2)])
def test_tpu_train_step_routes_every_layer_through_k5(seq, fwd_per_layer, k5_calls):
    """A `tpu` train step through the plain layers (an FFN width of 96,
    which the fused training stack turns down) runs K5-fwd once per layer,
    and once more per layer where remat recomputes it (601 tokens), and
    K5-bwd once per layer; a `reference` step never calls K5."""
    tcfg = TrainConfig(learning_rate=1e-3)
    for numerics in ("tpu", "reference"):
        cfg = dataclasses.replace(_cfg(seq, numerics, drop=0.1), ffn_hidden=96)
        _, model, x, y = _setup(cfg, seed=5)
        step = ptrain.make_train_step(poptim.make_optimizer(tcfg), tcfg.label_smoothing)
        before = dict(k5_calls)
        _, m = step(poptim.create_train_state(model, tcfg), x, y, 1)
        assert np.isfinite(float(m["loss"]))
        n = cfg.n_layers if numerics == "tpu" else 0
        assert k5_calls["fwd"] - before["fwd"] == fwd_per_layer * n, numerics
        assert k5_calls["bwd"] - before["bwd"] == n, numerics


def test_fused_training_stack_turns_the_conv1d_flagship_down():
    from vitiq_torch.config import flagship_conv1d_config
    from vitiq_torch.ops.cuda.fused_layer_train import fused_train_supported

    cfg = flagship_conv1d_config()
    assert not fused_train_supported(cfg.num_tokens, cfg.d_model, cfg.ffn_hidden, cfg.n_head)
