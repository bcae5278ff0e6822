"""The port's layers, embeddings and front-end against `vitiq` under the f32
`reference` policy (atol 1e-5, the reference-parity tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitiq.dsp import preprocess_batch_rawiq as jax_pre_rawiq
from vitiq.dsp import preprocess_batch_vit as jax_pre_vit
from vitiq.models import embeddings as jemb
from vitiq.models import layers as L
from vitiq.ops.attention import scaled_dot_product_attention as jax_sdpa
from vitiq_torch.dsp import preprocess_batch_rawiq, preprocess_batch_vit
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models import embeddings as temb
from vitiq_torch.models.layers import EncoderLayer, LayerNorm, MultiHeadAttention
from vitiq_torch.ops.attention import scaled_dot_product_attention

ATOL = 1e-5
STATS = {"i_mean": 0.2, "i_std": 1.7, "q_mean": -0.1, "q_std": 0.6}


def _rng_array(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _port_layer(tree, d, f, n_head):
    layer = EncoderLayer(d, f, n_head)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    return layer.eval()


def test_layer_norm():
    x = _rng_array(0, (4, 9, 64), 3.0)
    gamma, beta = _rng_array(1, (64,)), _rng_array(2, (64,))
    want = L.layer_norm_apply({"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)},
                              jnp.asarray(x))
    ln = LayerNorm(64)
    ln.load_state_dict({"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)})
    got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa(masked):
    q, k, v = (_rng_array(s, (2, 4, 11, 16)) for s in (3, 4, 5))
    mask = (np.random.default_rng(6).random((2, 1, 11, 11)) > 0.3).astype(np.float32)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm)
    got = scaled_dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), mask=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n_head", [2, 4])
def test_mha(n_head):
    tree = L.encoder_layer_init(jax.random.PRNGKey(7), 64, 128)
    x = _rng_array(8, (3, 17, 64))
    want = L.mha_apply(tree["attention"], jnp.asarray(x), n_head)
    layer = _port_layer(tree, 64, 128, n_head)
    mha: MultiHeadAttention = layer.attention
    got = mha(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("Lx,masked", [(17, False), (129, False), (33, True)])
def test_encoder_layer(Lx, masked):
    tree = L.encoder_layer_init(jax.random.PRNGKey(9), 64, 256)
    x = _rng_array(10, (2, Lx, 64))
    mask = (np.random.default_rng(11).random((2, 1, 1, Lx)) > 0.2).astype(np.float32)
    want = L.encoder_layer_apply(tree, jnp.asarray(x), 4, 0.0, None, False,
                                 mask=jnp.asarray(mask) if masked else None)
    got = _port_layer(tree, 64, 256, 4)(
        torch.from_numpy(x), mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_train_mode_dropout_is_seeded():
    tree = L.encoder_layer_init(jax.random.PRNGKey(12), 64, 128)
    layer = _port_layer(tree, 64, 128, 4)
    layer.drop_prob = 0.5
    layer.train()
    x = torch.from_numpy(_rng_array(13, (2, 9, 64)))
    a = layer(x, seed=1)
    b = layer(x, seed=torch.tensor(1, dtype=torch.int32))
    c = layer(x, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    layer.eval()
    assert torch.equal(layer(x), layer(x))


def test_patch_embedding():
    rng = jax.random.PRNGKey(14)
    params = jemb.patch_embed_2d_init(rng, 1, 4, 64)
    x = _rng_array(15, (3, 1, 16, 32))
    want = jemb.patch_embed_2d_apply(params, jnp.asarray(x), 4)
    pe = temb.PatchEmbedding2d(1, 4, 64)
    kernel = np.asarray(params["proj"]["kernel"])
    pe.projection.load_state_dict({
        "weight": torch.from_numpy(kernel.T.reshape(64, 1, 4, 4).copy()),
        "bias": torch.from_numpy(np.array(params["proj"]["bias"]))})
    got = pe(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("method,s", [("segment", 16), ("segment", 64), ("conv1d", None)])
def test_sequence_embedding(method, s):
    params = jemb.sequence_embed_init(jax.random.PRNGKey(16), 2, 64, method, s)
    x = _rng_array(17, (2, 2, 256))
    want = jemb.sequence_embed_apply(params, jnp.asarray(x), method, s)
    se = temb.SequenceEmbedding(2, 64, method, s)
    kernel = np.asarray(params["proj"]["kernel"])
    se.projection.load_state_dict({
        "weight": torch.from_numpy(kernel.T.reshape(64, 2, s or 1).copy()),
        "bias": torch.from_numpy(np.array(params["proj"]["bias"]))})
    got = se(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("max_len,d", [(129, 128), (65, 128), (17, 64)])
def test_positional_encoding(max_len, d):
    want = np.asarray(jemb.sinusoidal_encoding(max_len, d))
    np.testing.assert_allclose(temb.sinusoidal_encoding(max_len, d).numpy(), want,
                               atol=1e-6)
    x = _rng_array(18, (2, max_len, d)).astype(jnp.bfloat16)
    got = temb.add_positional_encoding(torch.from_numpy(x.astype(np.float32)).bfloat16(),
                                       max_len)
    ref = np.asarray(jemb.add_positional_encoding(jnp.asarray(x), max_len), np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2 ** -7 * 4)


@pytest.mark.parametrize("arm", ["vit", "rawiq"])
def test_frontend(arm):
    x = _rng_array(19, (3, 128, 2), 2.0)
    if arm == "vit":
        want = jax_pre_vit(jnp.asarray(x), STATS, H=16, W=16)
        got = preprocess_batch_vit(torch.from_numpy(x), STATS, H=16, W=16)
    else:
        want = jax_pre_rawiq(jnp.asarray(x), STATS)
        got = preprocess_batch_rawiq(torch.from_numpy(x), STATS)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
