"""K6's s8 GEMM stages (the int8 W8A8 layer's four stages on Hopper's s8
wgmma) on the CPU: their shared-memory plan, and their chain in launch order
against the plain layer and the JAX package's int8 kernel.

- The plan (`k6.s8_stage_plan`, the kernel's slab widths and ring sizing):
  every shape K6 admits gets a ring of at least two entries within the
  card's 232,448 bytes a block, on a wgmma width legal for s8 operands and
  an instance the build has.
- The chain (`k6.fused_layer_int8_staged`: `s8_stage_reference` for each
  stage, each row quantized where the kernel quantizes it: x1's levels from
  the out-projection's LayerNorm epilogue, y's from FFN2's, hid's row scale
  from FFN1's per-slab maxes merged on their f32 bits) equals the plain
  layer bit for bit, and the stack carrying each layer's levels to the next
  equals the plain stack bit for bit.
- The merge of FFN1's row maxes (an integer max of f32 bits, as atomicMax
  does) equals the absmax for rows with zeros, ties, subnormals and all-zero
  rows (whose scale is the floor, 1e-8 / 127).
- The chain against vitiq's `_fused_layer_kernel_v3_w8` in interpret mode,
  held as the plain layer is (1e-2 relative L2 and 2 quantization steps).
- The quotient the kernels take without a divide, mirrored in exact
  arithmetic, equals the IEEE quotient the plain version divides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq.models import layers as VL
from vitiq.ops import quant as vq
from vitiq.ops.pallas import fused_encoder_layer as vfel
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.ops import quant as pq
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

MAX_SMEM = 232448
LAYER_TOL = (1e-2, 2.0)
# (d_model, FFN width, n_head): the presets' (ViT and rawIQ flagships,
# rawiq_best, vit_tiny_2016) and others K6 admits
SHAPES = [(128, 512, 8), (128, 1024, 8), (256, 1024, 8), (64, 256, 4), (128, 384, 4),
          (64, 512, 4), (256, 256, 8)]


def _layers(seed, n, d, ffn, n_head):
    """vitiq's quantized layer trees and the port's quantized layers, from
    the same float weights."""
    trees = [VL.encoder_layer_init(jax.random.PRNGKey(seed + i), d, ffn) for i in range(n)]
    layers = []
    for tree in trees:
        layer = pq.QuantizedEncoderLayer(d, ffn)
        layer.load_state_dict(pq.quantize_params_int8(encoder_layer_state_dict(tree)))
        layers.append(layer)
    return [vq.quantize_params_int8(t) for t in trees], layers


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).bfloat16()


def _id(shape):
    return "d{}-f{}-h{}".format(*shape)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ffn", [128, 256, 384, 512, 1024])
def test_stage_plan_fits_every_admitted_shape(d, ffn):
    assert fel.fused_infer_supported(65, d, ffn, d // 32)
    plan = k6.s8_stage_plan(d, ffn)
    assert [s.stage for s in plan] == ["qkv", "out_proj", "ffn1", "ffn2"]
    assert [(s.op, s.n, s.k) for s in plan] == [("s8", 3 * d, d), ("quant_a", d, d),
                                                ("s8", ffn, d), ("quant_a", d, ffn)]
    for s in plan:
        assert s.ring >= 2 and s.smem <= MAX_SMEM, s
        assert s.bn in k6.S8_WGMMA_N and s.n % s.bn == 0, s
        assert (s.op, s.bn, s.resident) in k6.S8_INSTANCES, s
        assert s.resident == (s.k <= 256) and (s.resident or s.k % 128 == 0), s
        assert k6.s8_smem_bytes(s.op, s.bn, s.k, s.resident, s.ring + 1) > MAX_SMEM or \
            s.ring == k6.GW_MAX_RING
    # the LayerNorm stages hold whole rows: their slab is the whole width D
    assert plan[1].bn == plan[3].bn == d


def test_stage_plan_bytes_at_the_vit_shape():
    """The ViT flagship's stages, byte for byte as the kernel lays them out:
    an s8 A tile [64, 128] is 8 KB; a quantized-A tile two bf16 boxes; FFN2
    streams 128-deep steps of two bf16 A boxes [128, 64] and W2's [128, 128]
    int8 rows; 1 KB of alignment, the epilogue's 4 x 128 floats and 13
    mbarriers."""
    qkv, out_proj, ffn1, ffn2 = k6.s8_stage_plan(128, 512)
    fixed = 1024 + 16 * 128 + 8 * 13
    assert (qkv.bn, qkv.ring, qkv.smem) == (128, 6, fixed + 128 * 128 + 6 * 8192)
    assert (out_proj.bn, out_proj.ring) == (128, 6)
    assert out_proj.smem == fixed + 128 * 128 + 6 * 16384
    assert (ffn1.bn, ffn1.ring) == (256, 6)
    assert ffn1.smem == 1024 + 16 * 256 + 8 * 13 + 256 * 128 + 6 * 8192
    assert (ffn2.resident, ffn2.ring) == (False, 4)
    assert ffn2.smem == fixed + 4 * (2 * 16384 + 128 * 128)


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_staged_layer_equals_the_plain_layer(shape):
    d, ffn, n_head = shape
    _, layers = _layers(11, 1, d, ffn, n_head)
    ops = k6.int8_layer_operands(layers[0], n_head)
    x = _bf16((3, 17, d), d + ffn)
    want = k6.fused_layer_int8_reference(x, ops, n_head)
    got, levels = k6.fused_layer_int8_staged(x, ops, n_head)
    assert torch.equal(got, want)
    assert all(torch.equal(g, w) for g, w in zip(levels, k6.levels_of(want)))
    # given x's levels (as the previous layer's FFN2 epilogue writes them)
    again, _ = k6.fused_layer_int8_staged(x, ops, n_head, k6.levels_of(x))
    assert torch.equal(again, want)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=_id)
def test_each_stage_quantizes_whole_rows(shape):
    """The stages one by one on the plain layer's own intermediates: the
    out-projection's epilogue levels are `levels_of` its bf16 output, FFN1's
    merged slab maxes give hid's row scale, FFN2 on them is the plain FFN2."""
    d, ffn, n_head = shape
    _, layers = _layers(13, 1, d, ffn, n_head)
    wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 = (
        k6.int8_layer_operands(layers[0], n_head))
    attn, res = _bf16((40, d), 1), _bf16((40, d), 2)
    x1, _, x1_levels = k6.s8_stage_reference(wo, so, bo, a=attn, ln=(res, g1, be1))
    want = fel.layer_norm_reference(k6.int8_gemm_reference(attn, wo, so, bo) + res.float(),
                                    g1, be1).to(torch.bfloat16)
    assert torch.equal(x1, want)
    q, scale = k6.row_quant(x1)
    assert torch.equal(x1_levels.q, q.to(torch.int8))
    assert torch.equal(x1_levels.scale, scale.squeeze(-1))
    hid, hmax, _ = k6.s8_stage_reference(w1, s1, b1, levels=x1_levels, relu=True,
                                         slab=k6.s8_slab_width(ffn))
    plain_hid = torch.relu(k6.int8_gemm_reference(x1, w1, s1, b1)).to(torch.bfloat16)
    assert torch.equal(hid, plain_hid)
    assert torch.equal(k6.scale_of_absmax(hmax.view(torch.float32)[:, None]),
                       k6.absmax_scale(hid.float(), -1))
    y = k6.s8_stage_reference(w2, s2, b2, a=hid, amax=hmax, ln=(x1, g2, be2))[0]
    want = fel.layer_norm_reference(k6.int8_gemm_reference(hid, w2, s2, b2) + x1.float(),
                                    g2, be2).to(torch.bfloat16)
    assert torch.equal(y, want)


def _rows(case):
    """Rows of non-negative bf16 values (a ReLU's output) for the merge."""
    gen = torch.Generator().manual_seed(7)
    rows = torch.rand((6, 512), generator=gen).bfloat16().float()
    if case == "zeros":
        rows[:, ::3] = 0.0
    elif case == "ties":
        rows[:, 5] = rows[:, 300] = rows.amax(dim=-1) + 1.0
    elif case == "subnormals":
        rows = torch.full((6, 512), 2.0 ** -133)
        rows[:, 17] = 2.0 ** -130
        rows[3] = torch.tensor(2.0 ** -126)  # the least normal
    elif case == "all zero":
        rows = torch.zeros((6, 512))
    elif case == "mixed":
        rows[1] = 0.0
        rows[2, 100:] = 2.0 ** -140
    return rows.bfloat16().float()


@pytest.mark.parametrize("case", ["random", "zeros", "ties", "subnormals", "all zero", "mixed"])
@pytest.mark.parametrize("slab", [64, 128, 256])
def test_row_max_merged_on_bits_is_the_absmax(case, slab):
    """FFN1's epilogue merges each slab's row max with atomicMax on the f32
    bits: in any order, the integer max of the bits is the float max, so
    the scale FFN2 takes is the plain version's (all-zero rows: the floor)."""
    rows = _rows(case)
    slab_max = rows.unflatten(-1, (-1, slab)).amax(dim=-1)
    merged = k6.row_max_bits(slab_max)
    assert torch.equal(merged.view(torch.float32), rows.abs().amax(dim=-1))
    perm = torch.randperm(slab_max.shape[-1], generator=torch.Generator().manual_seed(1))
    assert torch.equal(k6.row_max_bits(slab_max[:, perm]), merged)
    scale = k6.scale_of_absmax(merged.view(torch.float32)[:, None])
    assert torch.equal(scale, k6.absmax_scale(rows, -1))
    if case == "all zero":
        assert torch.all(scale == torch.tensor(1e-8) / torch.tensor(127.0))


@pytest.mark.parametrize("cls_only", [False, True])
@pytest.mark.parametrize("shape", [(128, 256, 8), (256, 1024, 8), (64, 256, 4)], ids=_id)
def test_stack_carrying_levels_equals_the_plain_stack(shape, cls_only):
    d, ffn, n_head = shape
    _, layers = _layers(5, 3, d, ffn, n_head)
    x = _bf16((2, 9, d), 3)
    k6.reset_launches()
    got = k6.fused_encoder_layer_int8_stack(x, layers, n_head, cls_only=cls_only)
    full = layers[:-1] if cls_only else layers
    want = k6.fused_encoder_layer_int8_stack_reference(
        x, [k6.int8_layer_operands(q, n_head) for q in full], n_head,
        k6.dequant_layer_operands(layers[-1], n_head) if cls_only else None)
    assert torch.equal(got, want)
    assert k6.launches == {"fused_encoder_layer_int8": 0, "int8_gemm": 0}
    # the same chain through the staged version, levels carried
    h, levels = x, None
    for q in full:
        h, levels = k6.fused_layer_int8_staged(h, k6.int8_layer_operands(q, n_head), n_head,
                                               levels)
    if not cls_only:
        assert torch.equal(h, want)


def test_layer_wrapper_gives_its_output_levels_on_the_cpu():
    _, layers = _layers(9, 1, 128, 256, 8)
    ops = k6.int8_layer_operands(layers[0], 8)
    x = _bf16((2, 9, 128), 4)
    y, levels = k6.fused_encoder_layer_int8(x, ops, 8, x_levels=k6.levels_of(x),
                                            out_levels=True)
    assert torch.equal(y, k6.fused_encoder_layer_int8(x, ops, 8))
    assert levels.q.dtype == torch.int8 and levels.q.shape == (2, 9, 128)
    assert levels.scale.dtype == torch.float32 and levels.scale.shape == (2, 9)
    assert all(torch.equal(g, w) for g, w in zip(levels, k6.levels_of(y)))


def test_stage_wrappers_take_their_plain_versions_on_the_cpu():
    _, layers = _layers(21, 1, 128, 512, 8)
    wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 = (
        k6.int8_layer_operands(layers[0], 8))
    x, attn = _bf16((33, 128), 5), _bf16((33, 128), 6)
    k6.reset_launches()
    levels = k6.levels_of(x)
    assert torch.equal(k6.qkv_stage(levels, wqkv, sqkv, bqkv),
                       k6.int8_gemm_reference(x, wqkv, sqkv, bqkv).to(torch.bfloat16))
    x1, x1_levels = k6.out_proj_stage(attn, wo, so, bo, x, g1, be1)
    hid, hmax = k6.ffn1_stage(x1_levels, w1, s1, b1)
    y, y_levels = k6.ffn2_stage(hid, hmax, w2, s2, b2, x1, g2, be2)
    assert torch.equal(k6.ffn2_stage(hid, hmax, w2, s2, b2, x1, g2, be2, out_levels=False), y)
    assert all(torch.equal(g, w) for g, w in zip(y_levels, k6.levels_of(y)))
    assert k6.launches == {"fused_encoder_layer_int8": 0, "int8_gemm": 0}


@pytest.mark.parametrize("shape", [(128, 256, 8), (64, 256, 4)], ids=_id)
def test_staged_layer_matches_the_pallas_w8_kernel(shape):
    """The chain of stages against vitiq's `_fused_layer_kernel_v3_w8` (one
    layer of `fused_encoder_layer_v3_int8_stack`) in interpret mode, held
    as the plain layer is."""
    d, ffn, n_head = shape
    qtrees, layers = _layers(7, 1, d, ffn, n_head)
    x = _bf16((3, 17, d), 8)
    with pltpu.force_tpu_interpret_mode():
        want = vfel.fused_encoder_layer_v3_int8_stack(
            jnp.asarray(x.float().numpy(), jnp.bfloat16), qtrees, n_head)
    want = np.asarray(want.astype(jnp.float32))
    got = k6.fused_layer_int8_staged(x, k6.int8_layer_operands(layers[0], n_head), n_head)[0]
    got = got.float().numpy()
    rel, steps = LAYER_TOL
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)
    assert np.all(np.abs(got - want) <= steps * np.abs(want).max(axis=-1, keepdims=True) / 127)


def _rn32(x):
    """A rational rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    c = np.float32(float(x))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - x)
        if best is None or d < best[0] or (d == best[0] and cand.view(np.uint32) % 2 == 0):
            best = (d, cand)
    return best[1]


def _quant_div(v, s, y):
    """The kernels' quotient without a divide (`quant_div` in
    csrc/gemm_wgmma.cuh) in exact arithmetic: q = RN(v y), then twice
    q = RN(q + RN(v - s q) y), every fused step rounded once."""
    from fractions import Fraction as Fr

    def fma(a, b, c):
        return _rn32(Fr(float(a)) * Fr(float(b)) + Fr(float(c)))

    q = _rn32(Fr(float(v)) * Fr(float(y)))
    for _ in range(2):
        q = fma(fma(-s, q, v), y, q)
    return q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quotient_without_a_divide_is_the_ieee_quotient(seed):
    """The levels' quotient the kernels take without a divide equals the
    IEEE quotient v / s (what the plain version and the JAX package divide)
    for bf16 values of a row and its scale s = RN(max(absmax, 1e-8) / 127)
    (itself taken as quant_div(absmax, 127, RN(1 / 127))), with y = RN(1 /
    s): on random rows over 20 decades and on values at and next to
    half-integer quotients, where a faithful quotient would round the level
    the other way; the magic-number rint of it is the plain level."""
    from fractions import Fraction as Fr

    rng = np.random.default_rng(seed)
    f32 = np.float32
    inv127 = f32(1) / f32(127)
    for _ in range(40):
        row = torch.from_numpy((rng.standard_normal(64) * 10.0 ** rng.uniform(-12, 8))
                               .astype(np.float32)).bfloat16().float().numpy()
        amax = f32(max(np.abs(row).max(), f32(1e-8)))
        s = _quant_div(amax, f32(127), inv127)
        assert s == amax / f32(127)
        y = _rn32(1 / Fr(float(s)))
        ties = torch.from_numpy((rng.integers(-127, 127, 12) + 0.5).astype(np.float32) * s)
        ties = ties.bfloat16().float().numpy()
        for v in np.concatenate([row, ties, np.nextafter(ties, f32(np.inf))]):
            v = f32(v)
            if abs(v) > amax:
                continue
            q = _quant_div(v, s, y)
            assert q == v / s, (v, s)
            level = np.int8(np.uint8((q + f32(12582912.0)).view(np.uint32) & 0xFF))
            assert level == np.clip(np.round(v / s), -127, 127)
