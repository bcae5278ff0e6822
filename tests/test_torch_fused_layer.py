"""The port's fused encoder-layer stack against vitiq's Pallas v3 stack.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the Pallas kernel run in interpret mode in f32 (atol 1e-4, the
tolerance vitiq's own xpack test uses against the unfused layers). The CUDA
kernels are compared with the plain version on the GPU in
tests/test_torch_cuda.py, which imports no JAX so that it also runs on a
GPU machine without it.

K9 (the key-tiled long-sequence stack) and K10 (the query-tiled one) are TPU
schedules of K1's function; their interpret-mode runs at 520 tokens are
held to the port's K1/K2 stack here, which closes them as mappings onto K1.

The stack is held at the widths the kernels take: d_model 64, 128 and 256,
d_head 16, 32 and 64. `fused_infer_supported` and `fused_train_supported`,
the shape gates the model dispatches on, are checked on every geometry the
JAX package serves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import vitiq.bench as jbench
from vitiq.config import ExperimentConfig
from vitiq.models import layers as L
from vitiq.ops.pallas.fused_encoder_layer import fused_encoder_layer_v3_stack
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.cuda import fused_layer_train as flt

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


# (B, L, d_model, FFN, n_head): the ViT flagship's widths at 17 and 129
# tokens, then rawiq_best (d256/F1024/H8, 65 tokens), vit_tiny_2016
# (d64/F256/H4, 17 tokens) and d_head 64 (vit_tpu_production's n_head 2)
GEOMETRIES = [
    pytest.param((3, 17, D, F, H), id="17"),
    pytest.param((3, 129, D, F, H), id="129"),
    pytest.param((2, 65, 256, 1024, 8), id="d256-L65"),
    pytest.param((2, 17, 64, 256, 4), id="d64-L17"),
    pytest.param((2, 17, 128, 512, 2), id="dh64-L17"),
]


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("cls_only", [False, True])
def test_plain_stack_matches_pallas_v3_stack(geom, cls_only, monkeypatch):
    monkeypatch.setenv("VITIQ_V3_ATTN", "xpack")
    B, Lx, d, f, n_head = geom
    trees, port = _layers([40, 41], d, f, n_head)
    x = np.random.default_rng(Lx).standard_normal((B, Lx, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_encoder_layer_v3_stack(
            jnp.asarray(x), trees, n_head, cls_only=cls_only))
    got = fel.fused_encoder_layer_stack(torch.from_numpy(x), port, n_head,
                                        cls_only=cls_only).numpy()
    if cls_only:
        assert got.shape == (B, 1, d)
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4)
    else:
        assert got.shape == (B, Lx, d)
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


# K9 and K10 are TPU schedules of K1's function at long L (key tiling and
# query tiling); the port computes them with K1 (and K2 for a CLS tail).
LONG_L = 520


def _long_case(seed):
    trees, port = _layers([60 + seed, 61 + seed], f=256)
    x = np.random.default_rng(seed).standard_normal((2, LONG_L, D)).astype(np.float32)
    return trees, port, x


def test_k9_key_tiled_stack_maps_onto_k1():
    """K9 (`fused_encoder_layer_xpack_kt_stack`, interpret mode) against the
    port's plain K1 stack: in f32 at atol 1e-4; in bf16 against the port's
    f32 stack at the 0.05 gate the port's long-sequence path is held to
    against the f32 path (K9 itself was looser than that on the TPU)."""
    from vitiq.ops.pallas.serve_xpack_kt import fused_encoder_layer_xpack_kt_stack

    trees, port, x = _long_case(0)
    want = fel.fused_encoder_layer_stack(torch.from_numpy(x), port, H).numpy()
    with pltpu.force_tpu_interpret_mode():
        got = np.asarray(fused_encoder_layer_xpack_kt_stack(jnp.asarray(x), trees, H))
        got16 = np.asarray(fused_encoder_layer_xpack_kt_stack(
            jnp.asarray(x, jnp.bfloat16), trees, H).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got16 - want).max() < 0.05


@pytest.mark.parametrize("cls_only", [False, True])
def test_k10_query_tiled_stack_maps_onto_k1(cls_only, monkeypatch):
    """K10 (`fused_encoder_layer_v4long_stack`, interpret mode, query tiles
    of 128 with a padded tail) against the port's plain K1/K2 stack in f32
    at atol 1e-4."""
    from vitiq.ops.pallas.fused_encoder_layer import fused_encoder_layer_v4long_stack

    monkeypatch.setenv("VITIQ_V4_TQ", "128")
    trees, port, x = _long_case(1)
    want = fel.fused_encoder_layer_stack(torch.from_numpy(x), port, H, cls_only=cls_only).numpy()
    with pltpu.force_tpu_interpret_mode():
        got = np.asarray(fused_encoder_layer_v4long_stack(jnp.asarray(x), trees, H,
                                                          cls_only=cls_only))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


# Every serving geometry of vitiq's bench at its serving shape, then the
# d_head-64 ViT (`vit_tpu_production`) and the conv1d arm with n_head 2,
# whose 1025-token K/V (d_head 64) do not fit the attention block.
@pytest.mark.parametrize("name", sorted(jbench.ARM_CONFIGS) + ["vit_tpu_production",
                                                               "conv1d_h2"])
def test_shape_gates_on_the_served_geometries(name):
    if name == "vit_tpu_production":
        cfg = ExperimentConfig.vit_tpu_production().model
    elif name == "conv1d_h2":
        cfg = dataclasses.replace(jbench.flagship_conv1d_config(), n_head=2)
    else:
        cfg = jbench.ARM_CONFIGS[name]()
    shape = (cfg.num_tokens, cfg.d_model, cfg.ffn_hidden, cfg.n_head)
    assert fel.fused_infer_supported(*shape) == (name != "conv1d_h2")
    train = cfg.d_model in (128, 256) and cfg.d_head in (16, 32) and cfg.num_tokens < 1025
    assert flt.fused_train_supported(*shape) == train


def test_eval_dispatch_turns_unsupported_shapes_to_the_plain_layers(monkeypatch):
    """conv1d with n_head 2 (1025 tokens, d_head 64): `Encoder.forward`'s
    eval branch and `QuantizedAMCModel` (forced fused) run the plain layers,
    never the fused stacks, and still give finite logits."""
    from vitiq_torch.config import ModelConfig
    from vitiq_torch.models import AMCModel, encoder
    from vitiq_torch.ops import quant

    def refuse(*args, **kwargs):
        raise AssertionError("a fused stack was called for a shape its gate turns away")

    monkeypatch.setattr(encoder, "fused_encoder_layer_stack", refuse)
    monkeypatch.setattr(quant, "fused_encoder_layer_int8_stack", refuse)
    cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=128, n_head=2, n_layers=1,
                      ffn_hidden=128, embedding_type="conv1d", numerics="tpu")
    assert cfg.num_tokens == 1025 and not fel.fused_infer_supported(1025, 128, 128, 2)
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    src = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 2, 1024))
                           .astype(np.float32))
    with torch.no_grad():
        logits = model(src)
    qlogits = quant.QuantizedAMCModel.from_model(model, fused=True)(src)
    assert logits.shape == qlogits.shape == (1, 3)
    assert torch.isfinite(logits).all() and torch.isfinite(qlogits).all()
