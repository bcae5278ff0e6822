"""The port's int8 W8A8 serving path against vitiq's (`vitiq/ops/quant.py`
and the Pallas int8 stacks in interpret mode), on the CPU at small sizes.

* Weight quantization and `int8_linear` are the same arithmetic: int8
  values and scales equal, outputs within 1e-6 relative.
* K6's plain version (`fused_encoder_layer_int8_stack`, on CPU tensors)
  against `fused_encoder_layer_v3_int8_stack` in interpret mode, and against
  the v1 kernel `fused_encoder_layer_int8` (the mapping onto K6): the two
  attention cores round differently (the port subtracts the row max; vitiq
  runs exp2 without it and, in v1, scales f32 scores of a bf16 q), so a bf16
  flip can move a downstream quantized value by a level. They are held by
  relative L2 and by a max counted in quantization steps (a row's absmax /
  127 of vitiq's output): one layer within 1e-2 and 2 steps, a stack of
  three within 2e-2 and 4 steps (measured: 0.0028 / 0.86 and 0.0063 / 1.6).
* The whole quantized model against `make_quantized_forward`: the unfused
  int8 layers (off the TPU) within 1e-2 of vitiq's logits, and the fused
  branch (reached on the CPU by reporting the backend as "tpu" inside
  interpret mode, in the test only) within 3e-2 of vitiq's fused branch;
  both within vitiq's own bound against the float forward,
  max |dlogit| < 0.35 * max(|ref|, 1) (`tests/test_quant.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq.config import ModelConfig as VitiqModelConfig
from vitiq.models import init_amc_params, make_forward
from vitiq.models import layers as VL
from vitiq.ops import quant as vq
from vitiq.ops.pallas import fused_encoder_layer as vfel
from vitiq_torch.config import ModelConfig
from vitiq_torch.interop import encoder_layer_state_dict, state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.ops import quant as pq
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

D, F = 128, 256
LAYER_TOL = (1e-2, 2.0)
STACK_TOL = (2e-2, 4.0)


def _layers(seed, n, n_head=8, d=D, ffn=F):
    """vitiq's quantized layer trees and the port's quantized layers, from
    the same float weights."""
    trees = [VL.encoder_layer_init(jax.random.PRNGKey(seed + i), d, ffn) for i in range(n)]
    layers = []
    for tree in trees:
        layer = pq.QuantizedEncoderLayer(d, ffn)
        layer.load_state_dict(pq.quantize_params_int8(encoder_layer_state_dict(tree)))
        layers.append(layer)
    return [vq.quantize_params_int8(t) for t in trees], layers


def _assert_steps_close(got, want, tol):
    rel, steps = tol
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)
    step = np.abs(want).max(axis=-1, keepdims=True) / 127
    assert np.all(np.abs(got - want) <= steps * step)


def _bf16_input(shape, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    x = x.bfloat16()
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


def test_quantize_linear_params_matches_vitiq():
    rng = np.random.default_rng(0)
    kernel = (rng.standard_normal((64, 48)) * rng.uniform(0.01, 3, 48)).astype(np.float32)
    kernel[:, 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    bias = rng.standard_normal(48).astype(np.float32)
    want = vq.quantize_linear_params({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)})
    got = pq.quantize_linear_params(torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias))
    assert got["weight_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["weight_q"].numpy(), np.asarray(want["kernel_q"]).T)
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(got["bias"].numpy(), bias)


@pytest.mark.parametrize("arm", ["vit", "rawiq"])
def test_quantize_params_int8_matches_vitiq_on_a_model(arm):
    """Every linear of a model (the embedding's convolution included) is
    quantized to vitiq's int8 values and scales; the head, its LayerNorm,
    the encoder's LayerNorms and the CLS token stay float."""
    kw = dict(arm=arm, num_classes=5, d_model=128, n_head=8, n_layers=2, ffn_hidden=F)
    kw.update(dict(img_size_h=16, img_size_w=16) if arm == "vit" else
              dict(seq_length=256, segment_size=16, use_cls_token=True))
    params = init_amc_params(jax.random.PRNGKey(1), VitiqModelConfig(**kw))
    want = vq.quantize_params_int8(params)
    got = pq.quantize_params_int8(state_dict_from_vitiq(params, ModelConfig(**kw)))
    proj = "patch_embedding" if arm == "vit" else "sequence_embedding"
    emb = want["encoder"]["embedding"]["proj"]
    np.testing.assert_array_equal(got[f"encoder.{proj}.projection.weight_q"].numpy(),
                                  np.asarray(emb["kernel_q"]).T)
    np.testing.assert_array_equal(got[f"encoder.{proj}.projection.scale"].numpy(),
                                  np.asarray(emb["scale"]))
    for i, layer in enumerate(want["encoder"]["layers"]):
        for path in ("attention.w_q", "attention.w_concat", "ffn.linear1", "ffn.linear2"):
            a, b = path.split(".")
            q = layer[a][b]
            np.testing.assert_array_equal(got[f"encoder.layers.{i}.{path}.weight_q"].numpy(),
                                          np.asarray(q["kernel_q"]).T)
            np.testing.assert_array_equal(got[f"encoder.layers.{i}.{path}.scale"].numpy(),
                                          np.asarray(q["scale"]))
        np.testing.assert_array_equal(got[f"encoder.layers.{i}.norm1.gamma"].numpy(),
                                      np.asarray(layer["norm1"]["gamma"]))
    head = "mlp_head" if arm == "vit" else "mlp_head.1"
    assert got[f"{head}.weight"].dtype == torch.float32 and f"{head}.weight_q" not in got
    np.testing.assert_array_equal(got[f"{head}.weight"].numpy(),
                                  np.asarray(want["mlp_head"]["kernel"]).T)
    if arm == "rawiq":
        assert "mlp_head.0.weight_q" not in got and got["mlp_head.0.weight"].dim() == 1


@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 64)])
def test_int8_linear_matches_vitiq(shape):
    rng = np.random.default_rng(2)
    lin = VL.linear_init(jax.random.PRNGKey(2), 64, 32)
    qlin = vq.quantize_linear_params(lin)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(vq.int8_linear(qlin, jnp.asarray(x)))
    port = pq.quantize_linear_params(torch.from_numpy(np.asarray(lin["kernel"]).T.copy()),
                                     torch.from_numpy(np.array(lin["bias"])))
    got = pq.int8_linear(port, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("cls_only,n_head,shape,ffn", [
    pytest.param(False, 8, (4, 17, D), F, id="False-8"),
    pytest.param(True, 8, (4, 17, D), F, id="True-8"),
    pytest.param(False, 4, (4, 17, D), F, id="False-4"),
    # rawiq_best's widths: d_model 256, FFN 1024, 65 tokens, d_head 32
    pytest.param(True, 8, (1, 65, 256), 1024, id="True-8-d256"),
])
def test_plain_int8_stack_matches_pallas_int8_stack(cls_only, n_head, shape, ffn):
    qtrees, layers = _layers(3, 3, n_head, shape[-1], ffn)
    x, xj = _bf16_input(shape, 0)
    with pltpu.force_tpu_interpret_mode():
        want = vfel.fused_encoder_layer_v3_int8_stack(xj, qtrees, n_head, cls_only=cls_only)
    want = np.asarray(want.astype(jnp.float32))
    got = k6.fused_encoder_layer_int8_stack(x, layers, n_head, cls_only=cls_only)
    assert got.dtype == torch.bfloat16
    if cls_only:
        assert got.shape == (shape[0], 1, shape[-1])
        want = want[:, :1]
    _assert_steps_close(got.float().numpy(), want, STACK_TOL)


@pytest.mark.parametrize("version", ["v3", "v1"])
def test_one_plain_int8_layer_matches_pallas_kernels(version):
    """One layer: the v3 W8A8 kernel and the v1 kernel
    (`fused_encoder_layer_int8`, VITIQ_FUSED_VERSION=v1), which K6 maps."""
    qtrees, layers = _layers(7, 1)
    x, xj = _bf16_input((3, 33, D), 1)
    with pltpu.force_tpu_interpret_mode():
        if version == "v1":
            want = vfel.fused_encoder_layer_int8(xj, qtrees[0], 8)
        else:
            want = vfel.fused_encoder_layer_v3_int8_stack(xj, qtrees, 8)
    got = k6.fused_encoder_layer_int8(x, k6.int8_layer_operands(layers[0], 8), 8)
    _assert_steps_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), LAYER_TOL)


def test_padded_frames_do_not_leak():
    """vitiq's check (`tests/test_quant.py`) on the port's plain K6: a frame's
    output is the same alone and beside a frame of large values."""
    _, layers = _layers(1, 1)
    ops = k6.int8_layer_operands(layers[0], 8)
    x9 = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 9, D)).astype(np.float32))
    x9 = x9.bfloat16()
    both = torch.cat([x9, torch.full_like(x9, 100.0)])
    solo = k6.fused_encoder_layer_int8(x9, ops, 8)
    paired = k6.fused_encoder_layer_int8(both, ops, 8)
    assert torch.equal(solo[0], paired[0])


def test_operands_are_cached_and_rebuilt_on_update():
    qtrees, (layer,) = _layers(5, 1)
    ops = k6.int8_layer_operands(layer, 8)
    assert k6.int8_layer_operands(layer, 8) is ops
    scale = np.float32(1.4426950408889634 / np.sqrt(D // 8))
    q = qtrees[0]["attention"]
    np.testing.assert_array_equal(ops[0][:D].numpy(), np.asarray(q["w_q"]["kernel_q"]).T)
    np.testing.assert_array_equal(ops[0][2 * D:].numpy(), np.asarray(q["w_v"]["kernel_q"]).T)
    np.testing.assert_array_equal(ops[1][:D].numpy(), np.asarray(q["w_q"]["scale"]) * scale)
    np.testing.assert_array_equal(ops[1][D:].numpy(), np.concatenate(
        [np.asarray(q["w_k"]["scale"]), np.asarray(q["w_v"]["scale"])]))
    deq = k6.dequant_layer_operands(layer, 8)
    assert deq[0].dtype == torch.bfloat16 and deq[0].shape == (D, 3 * D)
    with torch.no_grad():
        layer.attention.w_q.scale.mul_(2.0)
    fresh = k6.int8_layer_operands(layer, 8)
    assert fresh is not ops
    torch.testing.assert_close(fresh[1][:D], 2.0 * ops[1][:D], rtol=0, atol=0)
    assert k6.dequant_layer_operands(layer, 8) is not deq


def test_cpu_tensors_take_the_plain_versions_without_counting():
    _, layers = _layers(9, 2)
    x, _ = _bf16_input((2, 9, D), 4)
    k6.reset_launches()
    fel.reset_launches()
    got = k6.fused_encoder_layer_int8_stack(x, layers, 8, cls_only=True)
    want = k6.fused_encoder_layer_int8_stack_reference(
        x, [k6.int8_layer_operands(layers[0], 8)], 8, k6.dequant_layer_operands(layers[1], 8))
    assert torch.equal(got, want)
    assert k6.launches == {"fused_encoder_layer_int8": 0, "int8_gemm": 0}
    assert fel.launches == {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 0}
    meta = torch.empty((1, 9, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        k6.fused_encoder_layer_int8(meta, k6.int8_layer_operands(layers[0], 8), 8)


def test_plain_int8_gemm_is_the_reference_rounded():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((10, 128)).astype(np.float32)).bfloat16()
    wq = torch.from_numpy(rng.integers(-127, 128, (128, 128)).astype(np.int8))
    ws, b = torch.rand(128) / 127, torch.randn(128)
    want = k6.int8_gemm_reference(a, wq, ws, b)
    assert torch.equal(k6.int8_gemm(a, wq, ws, b), want.to(torch.bfloat16))
    assert torch.equal(k6.int8_gemm(a, wq, ws, b, relu=True), torch.relu(want).to(torch.bfloat16))


def _model_cases():
    common = dict(num_classes=5, d_model=128, n_head=8, n_layers=3, ffn_hidden=F,
                  drop_prob=0.0, numerics="tpu")
    return {
        "vit": (dict(arm="vit", img_size_h=16, img_size_w=16, patch_size=4, **common),
                (6, 1, 16, 16)),
        "rawiq_cls": (dict(arm="rawiq", seq_length=256, segment_size=16, use_cls_token=True,
                           **common), (6, 2, 256)),
        "rawiq_mean": (dict(arm="rawiq", seq_length=256, segment_size=16, use_cls_token=False,
                            **common), (6, 2, 256)),
    }


@pytest.mark.parametrize("case", ["vit", "rawiq_cls", "rawiq_mean"])
def test_quantized_model_matches_make_quantized_forward(case, monkeypatch):
    kw, shape = _model_cases()[case]
    vcfg, pcfg = VitiqModelConfig(**kw), ModelConfig(**kw)
    params = init_amc_params(jax.random.PRNGKey(3), vcfg)
    model = AMCModel(pcfg)
    model.load_state_dict(state_dict_from_vitiq(params, pcfg))
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    qparams = vq.quantize_params_int8(params)
    ref = np.asarray(make_forward(vcfg)(params, jnp.asarray(x)))
    bound = 0.35 * max(np.abs(ref).max(), 1.0)

    want = np.asarray(vq.make_quantized_forward(vcfg)(qparams, jnp.asarray(x)))
    got = pq.QuantizedAMCModel.from_model(model)(torch.from_numpy(x)).numpy()
    assert got.shape == (6, 5) and got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-2
    assert np.abs(got - ref).max() < bound

    # vitiq's fused int8 branch (the v3 int8 stack with its CLS tail, Pallas
    # in interpret mode) against the port's fused path (K6 and K2, plain)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want_fused = np.asarray(vq.make_quantized_forward(vcfg)(qparams, jnp.asarray(x)))
    monkeypatch.undo()
    assert np.abs(want_fused - want).max() > 0  # the fused branch did run
    got_fused = pq.QuantizedAMCModel.from_model(model, fused=True)(torch.from_numpy(x)).numpy()
    assert np.abs(got_fused - want_fused).max() < 3e-2
    assert np.abs(got_fused - ref).max() < bound


def test_quantized_model_routes_by_device_and_env(monkeypatch):
    """On the CPU the unfused layers run unless fused=True; with fused=True
    K6's and K2's plain versions run, VITIQ_NO_FUSED_LAYER=1 turns them off
    and VITIQ_CLS_ONLY=0 computes the full last layer with K6."""
    kw, shape = _model_cases()["vit"]
    model = AMCModel(ModelConfig(**kw), generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape).astype(np.float32))
    calls = []
    real = k6.fused_layer_int8_reference
    monkeypatch.setattr(k6, "fused_layer_int8_reference",
                        lambda *a: calls.append("k6") or real(*a))
    real_cls = fel.fused_layer_cls_reference
    monkeypatch.setattr(fel, "fused_layer_cls_reference",
                        lambda *a: calls.append("k2") or real_cls(*a))
    unfused = pq.QuantizedAMCModel.from_model(model)(x)
    assert calls == []
    fused_model = pq.QuantizedAMCModel.from_model(model, fused=True)
    fused_model(x)
    assert calls == ["k6", "k6", "k2"]
    monkeypatch.setenv("VITIQ_CLS_ONLY", "0")
    calls.clear()
    fused_model(x)
    assert calls == ["k6", "k6", "k6"]
    monkeypatch.setenv("VITIQ_NO_FUSED_LAYER", "1")
    calls.clear()
    assert torch.equal(fused_model(x), unfused) and calls == []
