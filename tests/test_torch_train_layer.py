"""The port's fused training layer (K3) against vitiq's Pallas training stack.

On the CPU the port's wrappers run their plain PyTorch versions. They are
held against `vitiq.ops.pallas.fused_layer_train.fused_train_layer_stack`
run in interpret mode in f32 with dropout 0 and the recompute regime forced
(`VITIQ_TRAIN_STASH=0`): the forward at atol 1e-4 (the port subtracts the
row max before exp2, the TPU kernel does not), dx and the 12 gradients at
atol 2e-3, rtol 1e-3 (the bound of tests/test_fused_train_layer.py). The
explicit plain backward is held against torch.autograd of the plain forward
in f32 at atol 1e-5, with dropout off and on. The dropout masks are K8's
hash masks, bit for bit. The CUDA kernels are compared with the plain
versions on the GPU in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq.config import ModelConfig
from vitiq.models import layers as L
from vitiq.ops.pallas.fused_layer_train import fused_train_layer_stack as jax_train_stack
from vitiq.ops.pallas.train_xpack import _hash_mask, _site_salt
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models import AMCModel
from vitiq_torch.models import encoder as port_encoder
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_layer_train as flt

D = 128
# (B, L, n_head, d_model, FFN): d_model 128 at FFN 256, rawiq_best's widths
# (d256, FFN 1024, 65 tokens, d_head 32), vit_tiny_2016's (d64, FFN 256,
# 17 tokens, d_head 16) and d_head 64 (vit_tpu_production's n_head 2) at an
# FFN width that 64 divides and 128 does not
SHAPES = [pytest.param(2, 17, 4, D, 256, id="2-17-4"),
          pytest.param(1, 129, 8, D, 256, id="1-129-8"),
          pytest.param(1, 65, 8, 256, 1024, id="1-65-8-d256"),
          pytest.param(2, 17, 4, 64, 256, id="2-17-4-d64"),
          pytest.param(1, 33, 2, D, 192, id="1-33-2-f192")]


def _layer(seed, n_head, ffn=256, d=D):
    tree = L.encoder_layer_init(jax.random.PRNGKey(seed), d, ffn)
    layer = EncoderLayer(d, ffn, n_head)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    return tree, layer


@pytest.mark.parametrize("B,Lx,n_head,d,ffn", SHAPES)
def test_plain_forward_matches_pallas_train_stack(B, Lx, n_head, d, ffn, monkeypatch):
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "0")
    tree, layer = _layer(0, n_head, ffn, d)
    x = np.random.default_rng(Lx).standard_normal((B, Lx, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_train_stack(jnp.asarray(x), [tree], n_head, 0.0, 7))
    with torch.no_grad():
        got = flt.fused_train_layer_stack(torch.from_numpy(x), [layer], n_head, 0.0, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("B,Lx,n_head,d,ffn", SHAPES)
def test_gradients_match_pallas_train_stack(B, Lx, n_head, d, ffn, monkeypatch):
    """dx and all 12 gradients of the port's autograd path (K3's plain
    versions) against jax.grad of the Pallas stack, on a loss against a
    target (the bias of w_k has an exactly zero gradient)."""
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "0")
    tree, layer = _layer(1, n_head, ffn, d)
    rng = np.random.default_rng(B + Lx)
    x = rng.standard_normal((B, Lx, d)).astype(np.float32)
    tgt = rng.standard_normal((B, Lx, d)).astype(np.float32)

    def loss_jax(params, xx):
        return jnp.sum((jax_train_stack(xx, [params], n_head, 0.0, 7) - tgt) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want_gp, want_gx = jax.grad(loss_jax, argnums=(0, 1))(tree, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    y = flt.fused_train_layer_stack(xt, [layer], n_head, 0.0, 7)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), atol=2e-3, rtol=1e-3)
    want = encoder_layer_state_dict(want_gp)
    got = dict(layer.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), atol=2e-3, rtol=1e-3,
                                   err_msg=name)
    assert float(got["attention.w_k.bias"].grad.abs().max()) < 1e-4


@pytest.mark.parametrize("drop", [0.0, 0.25])
def test_explicit_backward_matches_autograd_of_plain_forward(drop):
    _, layer = _layer(2, 4)
    ops = [t.detach().clone().requires_grad_(True) for t in flt.flat_weights(layer, torch.float32)]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 17, D)).astype(np.float32)).requires_grad_(True)
    tgt = torch.from_numpy(rng.standard_normal((2, 17, D)).astype(np.float32))
    y = flt.fused_train_layer_reference(x, ops, 4, drop, 11, 3)
    want = torch.autograd.grad(((y - tgt) ** 2).sum(), [x] + ops)
    dx, grads = flt.fused_train_layer_backward_reference(
        x.detach(), 2 * (y - tgt).detach(), [o.detach() for o in ops], 4, drop, 11, 3)
    for i, (got, ref) in enumerate(zip([dx] + grads, want)):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0, msg=f"gradient {i}")


@pytest.mark.parametrize("seed", [0, 7, -123456789, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(2, 17, 128), (3, 5, 512)])
@pytest.mark.parametrize("layer_idx,site", [(0, 0), (3, 1), (5, 2)])
def test_masks_are_the_hash_masks_of_train_xpack(seed, shape, layer_idx, site):
    for rate in (0.1, 0.5):
        want = np.asarray(_hash_mask(shape, rate, jnp.int32(seed), _site_salt(layer_idx, site),
                                     0))
        got = flt.dropout_mask(shape, rate, seed, layer_idx, site).numpy()
        np.testing.assert_array_equal(got, want)


def test_mask_keep_rate_and_seed_sensitivity():
    a = flt.dropout_mask((64, 129, 128), 0.1, 5, 0, 0)
    assert abs(float((a > 0).float().mean()) - 0.9) < 0.005
    assert torch.all((a == 0) | (a == torch.tensor(1 / 0.9, dtype=torch.float32)))
    b = flt.dropout_mask((64, 129, 128), 0.1, 6, 0, 0)
    c = flt.dropout_mask((64, 129, 128), 0.1, 5, 1, 0)
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, flt.dropout_mask((64, 129, 128), 0.1, 5, 0, 0))
    assert torch.equal(flt.dropout_mask((2, 3, 4), 0.0, 5, 0, 0), torch.ones((2, 3, 4)))


def test_structural_gate():
    assert flt.fused_train_supported(129, 128, 512, 8)   # ViT flagship
    assert flt.fused_train_supported(65, 128, 1024, 8)   # rawIQ flagship
    assert flt.fused_train_supported(129, 128, 512, 4)   # d_head 32
    assert flt.fused_train_supported(65, 256, 1024, 8)   # rawiq_best (d_model 256)
    assert flt.fused_train_supported(64, 256, 1024, 8)   # rawiq_best_mp
    assert flt.fused_train_supported(17, 64, 256, 4)     # d_model 64 (vit_tiny_2016)
    assert flt.fused_train_supported(129, 128, 512, 2)   # d_head 64 (vit_tpu_production)
    assert flt.fused_train_supported(65, 128, 192, 8)    # FFN 64 mod 128
    assert not flt.fused_train_supported(65, 512, 1024, 8)    # d_model 512
    assert not flt.fused_train_supported(65, 32, 128, 2)      # d_model 32
    assert not flt.fused_train_supported(129, 128, 512, 16)   # d_head 8
    assert not flt.fused_train_supported(129, 128, 200, 8)    # FFN not a multiple of 64
    assert not flt.fused_train_supported(1025, 128, 1024, 8)  # conv1d length: shared memory
    assert flt.fused_train_supported(768, 128, 512, 8)
    assert not flt.fused_train_supported(769, 128, 512, 8)
    assert flt.fused_train_supported(224, 128, 512, 2)        # d_head 64: 223,872 bytes
    assert not flt.fused_train_supported(225, 128, 512, 2)
    assert flt.attention_bwd_smem_bytes(129, 64) == 146112    # one block per SM


def _presets():
    """(name, model config) of the JAX package's presets and the geometries
    the port trains, each with its token count."""
    from vitiq_torch import config as pc

    for name in ("vit_reference", "vit_tpu_production", "vit_synthetic19", "rawiq_synthetic19",
                 "vit_tiny_2016", "rawiq_reference", "rawiq_best"):
        yield name, getattr(pc.ExperimentConfig, name)().model
    for name in ("flagship_vit", "flagship_rawiq", "flagship_conv1d", "rawiq_best",
                 "rawiq_best_mp", "vit_tiny_2016"):
        yield f"{name}_config", getattr(pc, f"{name}_config")()


def test_gates_agree_with_vitiq_on_the_presets():
    """Where vitiq's budget gate (`fused_train_supported`, the one
    `vitiq/models/encoder.py` checks) trains a preset through its Pallas
    training kernels, the port's gate trains it through K3/K4, in the same
    regime (`stash_enabled` = `_stash_enabled` at the preset's batch), and
    where vitiq's turns it away (the conv1d arm's 1025 tokens), the port's
    does too."""
    from vitiq.ops.pallas import fused_layer_train as jflt

    seen = set()
    for name, cfg in _presets():
        L = cfg.num_tokens
        want = jflt.fused_train_supported(L, cfg.d_model, cfg.ffn_hidden)
        assert flt.fused_train_supported(L, cfg.d_model, cfg.ffn_hidden, cfg.n_head) == want, name
        lp = -(-L // 16) * 16
        for batch in (128, 256, 4096):
            assert (flt.stash_enabled(L, cfg.n_head, cfg.d_model, batch)
                    == jflt._stash_enabled(lp, L, cfg.n_head, cfg.d_model, batch)), (name, batch)
        seen.add((cfg.d_model, cfg.d_head, want))
    assert {(64, 16, True), (128, 64, True), (128, 16, True), (256, 32, True),
            (128, 16, False)} <= seen


def test_cpu_tensors_take_plain_versions_without_counting():
    _, layer = _layer(4, 8)
    ops = [t.detach() for t in flt.flat_weights(layer, torch.bfloat16)]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 9, D)).astype(np.float32))
    x = x.bfloat16()
    dy = x.flip(0)
    flt.reset_launches()
    assert torch.equal(flt.fused_train_layer_fwd(x, ops, 8, 0.1, 3, 1),
                       flt.fused_train_layer_reference(x, ops, 8, 0.1, 3, 1))
    dx, grads = flt.fused_train_layer_bwd(x, dy, ops, 8, 0.1, 3, 1)
    want_dx, want = flt.fused_train_layer_backward_reference(x, dy, ops, 8, 0.1, 3, 1)
    assert torch.equal(dx, want_dx) and all(torch.equal(a, b) for a, b in zip(grads, want))
    assert [g.dtype for g in grads] == [t.dtype for t in ops]
    assert not any(flt.launches.values())
    meta = torch.empty((1, 9, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flt.fused_train_layer_fwd(meta, ops, 8, 0.1, 3, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flt.fused_train_layer_bwd(meta, meta, ops, 8, 0.1, 3, 1)


def _vit(numerics="tpu", d_model=128, ffn=256):
    return ModelConfig(arm="vit", num_classes=5, d_model=d_model, n_head=8, n_layers=2,
                       ffn_hidden=ffn, img_size_h=16, img_size_w=16, numerics=numerics)


@pytest.mark.parametrize("numerics,env,kw,fused", [
    ("tpu", None, {"seed": 3}, True),
    ("tpu", "0", {"seed": 3}, False),         # VITIQ_FUSED_TRAIN=0
    ("tpu", None, {}, False),                 # no step seed: raises, as vitiq does
    ("reference", None, {"seed": 3}, False),  # f32 policy
    ("tpu", None, {"seed": 3, "d_model": 64}, False),  # shape the kernels do not take
])
def test_training_dispatch(numerics, env, kw, fused, monkeypatch):
    calls = []
    real = port_encoder.fused_train_layer_stack

    def counting(*args, **kwargs):
        calls.append(args[4])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_encoder, "fused_train_layer_stack", counting)
    if env is not None:
        monkeypatch.setenv("VITIQ_FUSED_TRAIN", env)
    seed = kw.pop("seed", None)
    model = AMCModel(_vit(numerics, **kw), generator=torch.Generator().manual_seed(0)).train()
    src = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 1, 16, 16))
                           .astype(np.float32))
    if seed is None:  # training with dropout and no seed raises before any layer runs
        with pytest.raises(ValueError, match="requires the step's seed"):
            model(src)
        assert calls == []
        return
    logits = model(src, seed=seed)
    logits.sum().backward()
    assert logits.shape == (2, 5)
    assert calls == ([seed] if fused else [])
    assert all(p.grad is not None for p in model.parameters())


def test_k8_xpack_train_stack_maps_onto_k3():
    """K8 (`fused_train_layer_stack_xpack`: the packed attention forward and
    the hybrid packed-recompute backward, interpret mode) against the port's
    K3 plain versions, in f32 with dropout on: both draw the position hash's
    masks (the same bits), so two layers agree as the recompute regime does
    (forward atol 1e-4; dx and the 12 gradients of each layer atol 2e-3,
    rtol 1e-3)."""
    from vitiq.ops.pallas.train_xpack import (
        fused_train_layer_stack_xpack,
        xpack_train_supported,
    )

    n_head, drop, seed = 4, 0.25, 7
    assert xpack_train_supported(17, D, 256, n_head)
    (t0, l0), (t1, l1) = _layer(5, n_head), _layer(6, n_head)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 17, D)).astype(np.float32)
    tgt = rng.standard_normal((2, 17, D)).astype(np.float32)

    def loss_jax(params, xx):
        y = fused_train_layer_stack_xpack(xx, params, n_head, drop, seed)
        return jnp.sum((y - tgt) ** 2), y

    with pltpu.force_tpu_interpret_mode():
        (_, want_y), (want_gp, want_gx) = jax.value_and_grad(
            loss_jax, argnums=(0, 1), has_aux=True)([t0, t1], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = flt.fused_train_layer_stack(xt, [l0, l1], n_head, drop, seed)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=1e-4)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), atol=2e-3, rtol=1e-3)
    for layer, tree in ((l0, want_gp[0]), (l1, want_gp[1])):
        got = dict(layer.named_parameters())
        for name, g in encoder_layer_state_dict(tree).items():
            np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), atol=2e-3, rtol=1e-3,
                                       err_msg=name)
