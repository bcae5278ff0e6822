"""MDF-NET in the port (`vitiq_torch/models/mdf.py`) against vitiq's
(`vitiq/models/mdf.py`) on shared weights (`interop.mdf_state_dict_from_vitiq`)
and the port's `preprocess_batch_mdf` inputs, in float32 on the CPU: the
forward within 1e-5, each parameter's gradient of a cross-entropy loss at
dropout off within 1e-4 relative (L2), dropout's train / eval contract
(tests/test_mdf.py) and a short training run on separable frames."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vitiq.models import create_multi_domain_model as jcreate
from vitiq_torch.dsp.frontend import preprocess_batch_mdf
from vitiq_torch.interop import mdf_state_dict_from_vitiq
from vitiq_torch.models.mdf import MultiDomainModel, create_multi_domain_model

NUM_CLASSES = 5


def _pair(dropout_rate=0.7, seed=0):
    init_fn, apply_fn = jcreate(NUM_CLASSES, dropout_rate)
    params = init_fn(jax.random.PRNGKey(seed))
    model = create_multi_domain_model(NUM_CLASSES, dropout_rate)
    model.load_state_dict(mdf_state_dict_from_vitiq(params))
    return params, apply_fn, model


def _inputs(B=4, seed=0, scale=None):
    x = np.random.default_rng(seed).standard_normal((B, 1024, 2)).astype(np.float32)
    if scale is not None:
        x *= scale[:, None, None]
    return preprocess_batch_mdf(torch.as_tensor(x))


def test_state_dict_keys_and_factory():
    params, _, model = _pair()
    assert isinstance(model, MultiDomainModel)
    sd = mdf_state_dict_from_vitiq(params)
    assert list(sd) == list(model.state_dict())
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(leaf) for leaf in jax.tree_util.tree_leaves(params))


def test_forward_matches_vitiq():
    params, apply_fn, model = _pair()
    amp, phase, iq = _inputs()
    got = model(amp, phase, iq)
    want = np.asarray(apply_fn(params, *(jnp.asarray(t.numpy()) for t in (amp, phase, iq))))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (4, NUM_CLASSES)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5


def test_gradients_match_vitiq():
    params, apply_fn, model = _pair(dropout_rate=0.0)
    amp, phase, iq = _inputs(B=6, seed=1)
    labels = np.arange(6) % NUM_CLASSES
    jin = [jnp.asarray(t.numpy()) for t in (amp, phase, iq)]

    def loss_fn(p):
        logits = apply_fn(p, *jin)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    loss = F.cross_entropy(model(amp, phase, iq), torch.as_tensor(labels))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = mdf_state_dict_from_vitiq(jgrads)
    for name, p in model.named_parameters():
        err = (p.grad - want[name]).norm() / want[name].norm().clamp_min(1e-30)
        assert err.item() <= 1e-4, (name, err.item())


def test_dropout_train_vs_eval():
    _, _, model = _pair(dropout_rate=0.5)
    amp, phase, iq = _inputs()
    ev1, ev2 = model(amp, phase, iq), model(amp, phase, iq)
    assert torch.equal(ev1, ev2)
    tr1 = model(amp, phase, iq, train=True, generator=torch.Generator().manual_seed(1))
    tr2 = model(amp, phase, iq, train=True, generator=torch.Generator().manual_seed(2))
    assert not torch.allclose(tr1, ev1) and not torch.allclose(tr1, tr2)
    # train without a generator runs dropout-free, as vitiq's train without an rng
    assert torch.equal(model(amp, phase, iq, train=True), ev1)


def test_trains_on_separable_synthetic():
    """A few Adam steps on a 2-class amplitude-separable task cut the loss
    (tests/test_mdf.py:87, smaller): gradients flow through both CNN towers
    and the LSTM."""
    torch.manual_seed(0)
    model = create_multi_domain_model(2, dropout_rate=0.0,
                                      generator=torch.Generator().manual_seed(0))
    B = 8
    y = np.arange(B) % 2
    amp, phase, iq = _inputs(B=B, seed=7, scale=np.where(y == 1, 4.0, 1.0).astype(np.float32))
    labels = torch.as_tensor(y)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for _ in range(25):
        opt.zero_grad()
        loss = F.cross_entropy(model(amp, phase, iq), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert min(losses[-5:]) < losses[0] * 0.5, losses
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.parametrize("stats", [None, {"i_mean": 0.5, "i_std": 2.0, "q_mean": -0.25,
                                          "q_std": 0.5, "amp_max": 7.5}])
def test_inputs_match_vitiqs_transform(stats):
    from vitiq.dsp import preprocess_batch_mdf as jpre

    x = np.random.default_rng(3).standard_normal((3, 1024, 2)).astype(np.float32)
    got = preprocess_batch_mdf(torch.as_tensor(x), stats=stats)
    want = jpre(jnp.asarray(x), stats=stats)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
