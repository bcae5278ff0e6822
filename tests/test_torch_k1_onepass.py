"""The arithmetic of K1's redesigned attention core, held on the CPU.

K1's core on the card (`attention_core_kernel` in
`vitiq_torch/csrc/fused_encoder_layer.cu`) makes one pass over 64-key tiles
with a running max: each p = bf16(exp2(s - m)) is rounded at the running max
m, and the f32 sum of the rounded p and the f32 output are rescaled by
exp2(m_old - m_new) when a tile raises the max. Its plain version,
`fel.attention_onepass_reference`, is held here to vitiq's layer with the
same numpy-seeded inputs and weights: in f32 (where it is the softmax
itself) to vitiq's f32 reference layer and to vitiq's fused Pallas stack in
interpret mode (atol 1e-4, the tolerance the port's other fused-layer tests
use), and in bf16 to the port's two-pass plain layer (p rounded at the final
max) within K1's tolerance, 3e-2 + 1.6e-2 |plain|. L covers one and several
key tiles with a ragged last one (17, 65, 129, 1025), d_head 16, 32 and 64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import jax
from vitiq.models import layers as L
from vitiq.ops.pallas.fused_encoder_layer import fused_encoder_layer_v3_stack
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_encoder_layer as fel

LAYER_TOL = (3e-2, 1.6e-2)  # K1's one-layer gate on bf16 outputs


def _layer(seed, d, f, n_head):
    tree = L.encoder_layer_init(jax.random.PRNGKey(seed), d, f)
    layer = EncoderLayer(d, f, n_head)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    return tree, layer.eval()


def _onepass_layer(x, layer, n_head):
    ops = fel.layer_operands(layer, n_head, x.dtype)
    return fel.fused_layer_reference(x, ops, n_head, x.shape[1],
                                     attention=lambda qkv, h, n_q: fel.attention_onepass_reference(
                                         qkv, h))


# (L, d_model, n_head): d_head 16, 32 and 64 at each length
CASES = [pytest.param(Lx, d, h, id=f"L{Lx}-dh{d // h}")
         for Lx in (17, 65, 129, 1025) for d, h in ((64, 4), (128, 4), (128, 2))]


@pytest.mark.parametrize("Lx,d,n_head", CASES)
def test_onepass_layer_matches_vitiqs_f32_reference_layer(Lx, d, n_head):
    tree, layer = _layer(50 + Lx, d, 2 * d, n_head)
    x = np.random.default_rng(Lx + d).standard_normal((2, Lx, d)).astype(np.float32)
    want = np.asarray(L.encoder_layer_apply(tree, jnp.asarray(x), n_head, 0.0, None, False))
    got = _onepass_layer(torch.from_numpy(x), layer, n_head).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("Lx,d,n_head", [c for c in CASES if c.values[0] <= 129])
def test_onepass_layer_matches_vitiqs_fused_stack_in_interpret_mode(Lx, d, n_head, monkeypatch):
    monkeypatch.setenv("VITIQ_V3_ATTN", "xpack")
    tree, layer = _layer(60 + Lx, d, 2 * d, n_head)
    x = np.random.default_rng(Lx).standard_normal((2, Lx, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_encoder_layer_v3_stack(jnp.asarray(x), [tree], n_head))
    got = _onepass_layer(torch.from_numpy(x), layer, n_head).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("Lx,d,n_head", CASES)
def test_onepass_layer_in_bf16_is_within_k1s_tolerance_of_the_two_pass_layer(Lx, d, n_head):
    _, layer = _layer(70 + Lx, d, 2 * d, n_head)
    x = torch.from_numpy(
        np.random.default_rng(Lx).standard_normal((3, Lx, d)).astype(np.float32)).bfloat16()
    got = _onepass_layer(x, layer, n_head).float()
    want = fel.fused_layer_reference(x, fel.layer_operands(layer, n_head, x.dtype), n_head,
                                     Lx).float()
    atol, rtol = LAYER_TOL
    assert torch.all((got - want).abs() <= atol + rtol * want.abs())


def test_onepass_core_rounds_p_at_the_running_max():
    """Two key tiles whose second raises the max: the one-pass core's p of
    the first tile are rounded at the first tile's max and rescaled, which
    the two-pass core (p rounded at the final max) does not do; in f32 the
    two agree."""
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((1, 80, 48)).astype(np.float32)
    qkv[0, 70:, 16:32] *= 4.0  # keys of the second tile raise the max
    f32 = torch.from_numpy(qkv)
    torch.testing.assert_close(fel.attention_onepass_reference(f32, 1),
                               fel.attention_reference(f32, 1, 80), atol=1e-6, rtol=1e-5)
    bf = f32.bfloat16()
    one, two = fel.attention_onepass_reference(bf, 1), fel.attention_reference(bf, 1, 80)
    assert not torch.equal(one, two)
    assert torch.all((one.float() - two.float()).abs() <= 3e-2 + 1.6e-2 * two.float().abs())


@pytest.mark.parametrize("d,n_head", [(64, 4), (128, 4), (128, 2)])
def test_core_launches_at_every_length_the_shape_gate_admits(d, n_head):
    """K1's core takes every L that `fused_infer_supported` admits (the
    predicate is unchanged: the gate's formula, the layout of K2's former
    two-pass core, bounds it), the longest ~2.9K tokens at d_head 16, ~1.6K
    at 32 and ~850 at 64."""
    dh = d // n_head
    admitted = [Lx for Lx in range(1, 4000) if fel.fused_infer_supported(Lx, d, 128, n_head)]
    assert admitted == list(range(1, admitted[-1] + 1))
    assert admitted[-1] == {16: 2896, 32: 1600, 64: 848}[dh]
    assert all(fel.core_smem_bytes(Lx, dh) <= fel.MAX_SHARED_MEMORY for Lx in admitted)


@pytest.mark.parametrize("part", ["core", "bias", "relu", "ln"])
def test_k1_parts_take_their_plain_versions_on_a_cpu_tensor(part):
    """K1's parts alone (`attention_core`, `gemm_stage` with each epilogue)
    run their plain versions for a CPU tensor and count no launch."""
    rng = np.random.default_rng(3)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    fel.reset_launches()
    if part == "core":
        qkv = bf(2, 65, 192)
        got, want = fel.attention_core(qkv, 4), fel.attention_onepass_reference(qkv, 4)
    else:
        a, w, bias = bf(70, 64), bf(64, 64), torch.from_numpy(rng.standard_normal(64).astype(
            np.float32))
        kw = ({"res": bf(70, 64), "gamma": bias + 1, "beta": bias / 2} if part == "ln"
              else {"relu": part == "relu"})
        got, want = fel.gemm_stage(a, w, bias, **kw), fel.gemm_stage_reference(a, w, bias, **kw)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not any(fel.stage_launches.values()) and not any(fel.launches.values())
