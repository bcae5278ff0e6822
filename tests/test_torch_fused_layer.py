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
So are K11 (`fused_encoder_layer_v2_stack`, the augmented-score layer that
``VITIQ_FUSED_VERSION=v2`` selects), K12 (`fused_encoder_layer`, the v1
layer, one per call) and K13 (the v3 stack's other schedules: the chained
core, its CLS tail, the fused CLS tail of ``VITIQ_V3_FUSECLS=1`` on both
cores, an epilogue and a head grouping), in f32 at atol 1e-4.

The stack is held at the widths the kernels take: d_model 64, 128 and 256,
d_head 16, 32 and 64. `fused_infer_supported` and `fused_train_supported`,
the shape gates the model dispatches on, are checked on every geometry the
JAX package serves.

K7, the layer with an int8 attention core (``VITIQ_ATTN_INT8=1``): its plain
version against vitiq's `fused_encoder_layer_v3_stack(..., attn_int8=True,
g_override=1)` in interpret mode (one frame per block, as the port's
kernel). Where L = Lp (16, 64 tokens, and 144 and 256 for two and three
128-key tiles merged on a running max) the two quantize the same values and
differ only where an exp2 of one library rounds a probability to the other
side of a half: relative L2 within 1e-3 (measured ~1e-7 in f32 on the CPU).
Where L is padded (17, 129 tokens), vitiq's padded rows enter its k scale
and tile maxima: both are held to vitiq's own bound against the f32 layers,
0.15 absolute (`tests/test_fused_layer.py`)."""

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
from vitiq.ops.numerics import REFERENCE
from vitiq.ops.pallas.fused_encoder_layer import fused_encoder_layer_v3_stack
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7
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
    cls_ops = fel.cls_operands(ops, H)
    assert torch.equal(fel.fused_encoder_layer_cls(x, cls_ops, H),
                       fel.fused_layer_cls_reference(x, cls_ops, H))
    assert fel.launches == {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 0}
    meta = torch.empty((1, 5, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fel.fused_encoder_layer(meta, ops, H)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fel.fused_encoder_layer_cls(meta, cls_ops, H)


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


# K11-K13, TPU schedules of K1/K2's function: (variant, environment, cls_only)
MAPPED_SCHEDULES = [
    pytest.param("v2", {}, False, id="K11-v2"),
    pytest.param("v1", {}, False, id="K12-v1"),
    pytest.param("v3", {"VITIQ_V3_ATTN": "chain"}, False, id="K13-chain"),
    pytest.param("v3", {"VITIQ_V3_ATTN": "chain"}, True, id="K13-chain-cls"),
    pytest.param("v3", {"VITIQ_V3_ATTN": "chain", "VITIQ_V3_FUSECLS": "1"}, True,
                 id="K13-fusecls-combo"),
    pytest.param("v3", {"VITIQ_V3_ATTN": "xpack", "VITIQ_V3_FUSECLS": "1"}, True,
                 id="K13-fusecls-mono"),
    pytest.param("v3", {"VITIQ_V3_EPI": "div3"}, False, id="K13-epi-div3"),
    pytest.param("v3", {"VITIQ_V3_HG": "2"}, True, id="K13-hg2-cls"),
]


@pytest.mark.parametrize("variant,env,cls_only", MAPPED_SCHEDULES)
def test_tpu_schedules_map_onto_k1_k2(variant, env, cls_only, monkeypatch):
    """K11, K12 and K13 in interpret mode against the port's plain K1 stack
    (K2 on the CLS row with `cls_only`), two layers of d128/H8/F256 over 33
    tokens, f32 at atol 1e-4."""
    from vitiq.ops.pallas.fused_encoder_layer import (
        fused_encoder_layer,
        fused_encoder_layer_v2_stack,
    )

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    trees, port = _layers([70, 71], f=256)
    x = np.random.default_rng(33).standard_normal((3, 33, D)).astype(np.float32)
    want = fel.fused_encoder_layer_stack(torch.from_numpy(x), port, H,
                                         cls_only=cls_only).numpy()
    with pltpu.force_tpu_interpret_mode():
        if variant == "v2":
            got = fused_encoder_layer_v2_stack(jnp.asarray(x), trees, H)
        elif variant == "v1":
            got = jnp.asarray(x)
            for tree in trees:
                got = fused_encoder_layer(got, tree, H)
        else:
            got = fused_encoder_layer_v3_stack(jnp.asarray(x), trees, H, cls_only=cls_only)
    got = np.asarray(got)
    assert got.shape == want.shape == ((3, 1, D) if cls_only else (3, 33, D))
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
    train = cfg.d_model in (64, 128, 256) and cfg.d_head in (16, 32, 64) and cfg.num_tokens < 1025
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


# K7: (B, L, d_model, FFN, n_head, dtype, n_layers, cls_only)
K7_PADDED_FREE = [
    pytest.param((2, 16, D, 256, H, "f32", 1, False), id="L16"),
    pytest.param((2, 64, D, 256, H, "f32", 1, False), id="L64"),
    # two and three 128-key tiles: the tile max and the f32 merge on a running max
    pytest.param((2, 144, D, 256, H, "f32", 1, False), id="L144-two-tiles"),
    pytest.param((2, 256, D, 256, H, "f32", 2, False), id="L256-two-tiles-2-layers"),
    pytest.param((2, 64, 256, 512, 8, "f32", 1, False), id="d256-L64"),
    pytest.param((2, 64, 64, 128, 4, "bf16", 1, False), id="d64-L64-bf16"),
    pytest.param((2, 64, D, 256, 4, "f32", 2, True), id="stack-K2-tail"),
]


def _k7_case(B, Lx, d, f, n_head, dtype, n_layers, cls_only):
    trees, port = _layers(list(range(50, 50 + n_layers)), d, f, n_head)
    x = np.random.default_rng(Lx).standard_normal((B, Lx, d)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_encoder_layer_v3_stack(
            jnp.asarray(x, jdt), trees, n_head, g_override=1, attn_int8=True,
            cls_only=cls_only).astype(jnp.float32))
    got = k7.fused_encoder_layer_int8attn_stack(torch.from_numpy(x).to(tdt), port, n_head,
                                                cls_only=cls_only).float().numpy()
    return trees, x, got, want


@pytest.mark.parametrize("case", K7_PADDED_FREE)
def test_k7_plain_version_matches_pallas_where_l_needs_no_padding(case):
    B, Lx, d, f, n_head, dtype, n_layers, cls_only = case
    _, _, got, want = _k7_case(*case)
    assert got.shape == ((B, 1, d) if cls_only else (B, Lx, d))
    if cls_only:
        want = want[:, :1]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3


@pytest.mark.parametrize("Lx", [17, 129])
def test_k7_plain_version_within_vitiqs_bound_where_l_is_padded(Lx):
    trees, x, got, want = _k7_case(2, Lx, D, 256, H, "f32", 1, False)
    ref = np.asarray(L.encoder_layer_apply(trees[0], jnp.asarray(x), H, 0.0, None, False,
                                           policy=REFERENCE))
    np.testing.assert_allclose(got, ref, atol=0.15)
    np.testing.assert_allclose(want, ref, atol=0.15)


def test_k7_wrappers_take_plain_version_on_cpu_only():
    _, (layer,) = _layers([49])
    ops = fel.layer_operands(layer, H)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 40, D)).astype(np.float32))
    x = x.bfloat16()
    k7.reset_launches()
    assert torch.equal(k7.fused_encoder_layer_int8attn(x, ops, H),
                       k7.fused_layer_int8attn_reference(x, ops, H))
    qkv = (fel._mm(x, ops[0]) + ops[1]).bfloat16()
    out, products = k7.attention_int8(qkv, H, dump=True)
    assert torch.equal(out, k7.attention_int8_reference(qkv, H))
    assert products["scores"].shape == (2, H, 40, 40) and products["scores"].dtype == torch.int32
    assert products["pv"].shape == (2, H, 1, 40, D // H + 1)
    # the denominator column is the ones level times the row's probability sum
    one = k7.quantize_heads(qkv, H)[3].to(torch.int32)
    assert torch.equal(products["pv"][:, :, 0, :, -1],
                       products["probs"].int().sum(-1) * one[..., 0])
    assert k7.launches == {"fused_encoder_layer_int8attn": 0, "attention_int8": 0}
    meta = torch.empty((1, 5, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        k7.fused_encoder_layer_int8attn(meta, ops, H)


@pytest.mark.parametrize("Lx,f,d", [(129, 512, 128), (65, 1024, 128), (65, 1024, 256)],
                         ids=["vit", "rawiq", "rawiq_best"])
def test_k7_layer_tolerance_rejects_k1s_core(Lx, f, d):
    """The card holds one K7 layer to its plain version within 1e-3 relative
    L2 (chip_smoke.py's K7_LAYER_TOL): K1's bf16 core in K7's place, on bf16
    inputs at the flagship widths, reads above that, so the check tells the
    two cores apart."""
    gen = torch.Generator().manual_seed(41)
    layer = EncoderLayer(d, f, 8, generator=gen).eval()
    with torch.no_grad():
        for norm in (layer.norm1, layer.norm2):  # LayerNorm affine away from (1, 0)
            norm.gamma.copy_(1.0 + 0.1 * torch.randn(d, generator=gen))
            norm.beta.copy_(0.1 * torch.randn(d, generator=gen))
        ops = fel.layer_operands(layer, 8)
        x = torch.randn((4, Lx, d), generator=gen).bfloat16()
        want = k7.fused_layer_int8attn_reference(x, ops, 8).float()
        k1 = fel.fused_encoder_layer(x, ops, 8).float()
    rel_l2 = ((k1 - want).norm() / want.norm()).item()
    print(f"K1's core in K7's place: relative L2 {rel_l2:.6g}")
    assert rel_l2 > 1e-3


@pytest.mark.parametrize("d_head", [16, 32, 64])
def test_k7_takes_every_length_k1_takes(d_head):
    """K7 shares K1's gate: its attention block fits shared memory at every
    L that `fused_infer_supported` admits."""
    n_head = 128 // d_head
    longest = max(Lx for Lx in range(1, 4096) if fel.fused_infer_supported(Lx, 128, 512, n_head))
    assert k7.attention_int8_smem_bytes(longest, d_head) < fel.attention_smem_bytes(longest,
                                                                                    d_head)
    assert k7.attention_int8_smem_bytes(longest, d_head) <= fel.MAX_SHARED_MEMORY


def test_eval_dispatch_takes_k7_under_vitiq_attn_int8(monkeypatch):
    """`Encoder.forward` in eval under `tpu` numerics: VITIQ_ATTN_INT8=1 runs
    the K7 stack (its plain version on the CPU, K2 on the CLS row), unset it
    runs K1's, and VITIQ_NO_FUSED_LAYER=1 runs neither."""
    from vitiq_torch.config import ModelConfig
    from vitiq_torch.models import AMCModel, encoder

    calls = []
    for name in ("fused_encoder_layer_stack", "fused_encoder_layer_int8attn_stack"):
        real = getattr(encoder, name)
        monkeypatch.setattr(encoder, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    cfg = ModelConfig(arm="vit", num_classes=5, d_model=64, n_head=4, n_layers=2,
                      ffn_hidden=128, img_size_h=16, img_size_w=16, numerics="tpu")
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    src = torch.from_numpy(
        np.random.default_rng(6).standard_normal((3, 1, 16, 16)).astype(np.float32))
    with torch.no_grad():
        monkeypatch.setenv("VITIQ_ATTN_INT8", "1")
        logits = model(src)
        x = model.encoder.embed(src, model.policy).bfloat16()
        ops = [fel.layer_operands(layer, 4) for layer in model.encoder.layers]
        want = k7.fused_encoder_layer_int8attn_stack_reference(x, ops, 4, cls_only=True)
        assert torch.equal(model.encoder(src, model.policy, model.attention_fn,
                                         cls_only_fused=True), want)
        monkeypatch.delenv("VITIQ_ATTN_INT8")
        float_logits = model(src)
        monkeypatch.setenv("VITIQ_NO_FUSED_LAYER", "1")
        monkeypatch.setenv("VITIQ_ATTN_INT8", "1")
        model(src)
    assert calls == ["fused_encoder_layer_int8attn_stack"] * 2 + ["fused_encoder_layer_stack"]
    assert logits.shape == (3, 5) and torch.isfinite(logits).all()
    assert not torch.equal(logits, float_logits)
