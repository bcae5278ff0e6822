"""The port's fused encoder-layer stack against vitiq's Pallas v3 stack.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the Pallas kernel run in interpret mode in f32 (atol 1e-4, the
tolerance vitiq's own xpack test uses against the unfused layers). The CUDA
kernels are compared with the plain version on the GPU in
tests/test_torch_cuda.py, which imports no JAX so that it also runs on a
GPU machine without it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq.models import layers as L
from vitiq.ops.pallas.fused_encoder_layer import fused_encoder_layer_v3_stack
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_encoder_layer as fel

D, F, H = 128, 512, 8


def _layers(seeds, d=D, f=F, n_head=H):
    """vitiq layer trees and the port layers carrying the same weights."""
    trees = [L.encoder_layer_init(jax.random.PRNGKey(s), d, f) for s in seeds]
    port = []
    for tree in trees:
        layer = EncoderLayer(d, f, n_head)
        layer.load_state_dict(encoder_layer_state_dict(tree))
        port.append(layer.eval())
    return trees, port


@pytest.mark.parametrize("Lx", [17, 129])
@pytest.mark.parametrize("cls_only", [False, True])
def test_plain_stack_matches_pallas_v3_stack(Lx, cls_only, monkeypatch):
    monkeypatch.setenv("VITIQ_V3_ATTN", "xpack")
    trees, port = _layers([40, 41])
    x = np.random.default_rng(Lx).standard_normal((3, Lx, D)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_encoder_layer_v3_stack(
            jnp.asarray(x), trees, H, cls_only=cls_only))
    got = fel.fused_encoder_layer_stack(torch.from_numpy(x), port, H,
                                        cls_only=cls_only).numpy()
    if cls_only:
        assert got.shape == (3, 1, D)
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4)
    else:
        assert got.shape == (3, Lx, D)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_plain_stack_matches_unfused_layers_in_bf16():
    """bf16 plain stack vs vitiq's unfused f32 layers: the bf16 rounding
    class (a few bf16 ulps after LayerNorm)."""
    trees, port = _layers([42, 43])
    x = np.random.default_rng(3).standard_normal((2, 33, D)).astype(np.float32)
    ref = jnp.asarray(x)
    for tree in trees:
        ref = L.encoder_layer_apply(tree, ref, H, 0.0, None, False)
    got = fel.fused_encoder_layer_stack(torch.from_numpy(x).bfloat16(), port, H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref), atol=0.1)


def test_layer_operands_layout_and_cache():
    (tree,), (layer,) = _layers([44])
    ops = fel.layer_operands(layer, H)
    assert fel.layer_operands(layer, H) is ops  # cached
    scale = np.float32(1.4426950408889634 / np.sqrt(D // H))
    wq = np.asarray(tree["attention"]["w_q"]["kernel"]) * scale
    want = torch.from_numpy(wq).bfloat16()
    assert torch.equal(ops[0][:, :D], want)
    assert ops[0].shape == (D, 3 * D) and ops[0].dtype == torch.bfloat16
    assert ops[6].shape == (D, F) and ops[8].shape == (F, D)
    assert all(ops[i].dtype == torch.float32 for i in (1, 3, 4, 5, 7, 9, 10, 11))
    np.testing.assert_array_equal(
        ops[1][:D].numpy(), np.asarray(tree["attention"]["w_q"]["bias"]) * scale)

    (other,), _ = _layers([45])
    layer.load_state_dict(encoder_layer_state_dict(other))
    fresh = fel.layer_operands(layer, H)
    assert fresh is not ops
    assert not torch.equal(fresh[0], ops[0])


def test_in_place_parameter_update_rebuilds_operands():
    """An optimizer updates parameters in place; the fused eval path must
    then run the new weights, exactly as a model loaded from them does."""
    from vitiq_torch.config import ModelConfig
    from vitiq_torch.models import AMCModel

    cfg = ModelConfig(arm="vit", num_classes=5, d_model=64, n_head=4, n_layers=2,
                      ffn_hidden=128, img_size_h=16, img_size_w=16, numerics="tpu")
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    src = torch.from_numpy(
        np.random.default_rng(6).standard_normal((3, 1, 16, 16)).astype(np.float32))
    with torch.no_grad():
        before = model(src)
        for p in model.parameters():
            p.add_(0.05)
        after = model(src)
    fresh = AMCModel(cfg).eval()
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = fresh(src)
    assert not torch.equal(before, want)
    torch.testing.assert_close(after, want, atol=0, rtol=0)


def test_cpu_tensor_takes_plain_version_without_counting():
    _, port = _layers([46, 47])
    fel.reset_launches()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 9, D)).astype(np.float32))
    ops = [fel.layer_operands(layer, H, torch.bfloat16) for layer in port]
    got = fel.fused_encoder_layer_stack(x.bfloat16(), port, H, cls_only=True)
    want = fel.fused_encoder_layer_stack_reference(x.bfloat16(), ops, H, cls_only=True)
    assert torch.equal(got, want)
    assert fel.launches == {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 0}


def test_kernel_wrappers_take_plain_version_on_cpu_only():
    _, (layer,) = _layers([48])
    ops = fel.layer_operands(layer, H)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 5, D)).astype(np.float32))
    x = x.bfloat16()
    fel.reset_launches()
    assert torch.equal(fel.fused_encoder_layer(x, ops, H), fel.fused_layer_reference(x, ops, H, 5))
    assert torch.equal(fel.fused_encoder_layer_cls(x, ops, H),
                       fel.fused_layer_reference(x, ops, H, 1))
    assert fel.launches == {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 0}
    meta = torch.empty((1, 5, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fel.fused_encoder_layer(meta, ops, H)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fel.fused_encoder_layer_cls(meta, ops, H)
