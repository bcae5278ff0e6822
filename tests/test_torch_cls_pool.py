"""K2, the fused layer for the CLS row, as the port computes it: no K or V.

The CLS query's scores are x_j . qt_h with qt_h = W_k,h^T q_h (the key bias
adds a constant a head, which the softmax cancels), and its attention output
is W_v,h xbar_h + b_v,h with xbar_h the softmax-weighted mean of the tokens.
`fel.fused_layer_cls_reference` (K2's plain version, with its pooling step
`fel.cls_pool_reference` and the block operands of `fel.cls_operands`) is
held here to vitiq's `fused_encoder_layer_v3_stack(..., cls_only=True)` in
Pallas interpret mode in f32 at the geometries of
`tests/test_torch_fused_layer.py` (atol 1e-4, that file's CLS tolerance),
and to `fel.fused_layer_reference(x, ops, H, 1)`, the TPU function, in f32
and in bf16 (K2's limit on the card, 3e-2 + 1.6e-2 |plain|: the port rounds
qt and xbar where the TPU kernel rounds k and v). The shared-memory formulas
of K7's core and of K2's pooling kernel are held to the shape gate at every
L it admits. The kernels themselves are held to these plain versions on the
card (`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import math

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
from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7

# (B, L, d_model, FFN, n_head): test_torch_fused_layer.py's GEOMETRIES
GEOMETRIES = [
    pytest.param((3, 17, 128, 512, 8), id="17"),
    pytest.param((3, 129, 128, 512, 8), id="129"),
    pytest.param((2, 65, 256, 1024, 8), id="d256-L65"),
    pytest.param((2, 17, 64, 256, 4), id="d64-L17"),
    pytest.param((2, 17, 128, 512, 2), id="dh64-L17"),
]
K2_ATOL, K2_RTOL = 3e-2, 1.6e-2  # K2 against the plain layer on the card


def _layer(seed, d, f, n_head):
    """A vitiq layer tree and the port layer carrying the same weights."""
    tree = L.encoder_layer_init(jax.random.PRNGKey(seed), d, f)
    layer = EncoderLayer(d, f, n_head)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    return tree, layer.eval()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_k2_plain_version_matches_pallas_cls_layer(geom, monkeypatch):
    monkeypatch.setenv("VITIQ_V3_ATTN", "xpack")
    B, Lx, d, f, n_head = geom
    tree, layer = _layer(70 + Lx, d, f, n_head)
    x = _x((B, Lx, d), Lx)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_encoder_layer_v3_stack(jnp.asarray(x), [tree], n_head,
                                                       cls_only=True))
    ops = fel.layer_operands(layer, n_head, torch.float32)
    got = fel.fused_layer_cls_reference(torch.from_numpy(x), fel.cls_operands(ops, n_head),
                                        n_head).numpy()
    assert got.shape == (B, 1, d)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4)


@pytest.mark.parametrize("geom", GEOMETRIES + [pytest.param((2, 1025, 128, 1024, 8),
                                                            id="conv1d-L1025")])
def test_k2_plain_version_is_the_tpu_function(geom):
    """f32: the reassociated layer equals the plain layer for the CLS row up
    to f32 sums; bf16: within K2's limit on the card."""
    B, Lx, d, f, n_head = geom
    _, layer = _layer(80 + Lx, d, f, n_head)
    x = torch.from_numpy(_x((B, Lx, d), Lx + 1))
    ops = fel.layer_operands(layer, n_head, torch.float32)
    torch.testing.assert_close(fel.fused_layer_cls_reference(x, fel.cls_operands(ops, n_head),
                                                             n_head),
                               fel.fused_layer_reference(x, ops, n_head, 1), atol=2e-5,
                               rtol=1e-5)
    ops = fel.layer_operands(layer, n_head)
    xb = x.bfloat16()
    got = fel.fused_layer_cls_reference(xb, fel.cls_operands(ops, n_head), n_head).float()
    want = fel.fused_layer_reference(xb, ops, n_head, 1).float()
    assert torch.all((got - want).abs() <= K2_ATOL + K2_RTOL * want.abs())


@pytest.mark.parametrize("d,n_head", [(64, 1), (64, 4), (128, 2), (128, 8), (256, 8), (256, 16)])
def test_block_operands_layout(d, n_head):
    """Kblk [D, H D] holds W_k,h^T in block (h, h), Vblk [H D, D] holds W_v,h
    in block (h, h), zeros elsewhere, in Wqkv's dtype; q Kblk is qt, whose
    dot with a token is the head's score less its key-bias constant."""
    dh = d // n_head
    _, layer = _layer(90 + n_head, d, 2 * d, n_head)
    ops = fel.layer_operands(layer, n_head)
    full = fel.cls_operands(ops, n_head)
    assert len(full) == 15 and full[:12] == ops
    kblk, vblk, zero = full[12:]
    assert kblk.shape == (d, n_head * d) and vblk.shape == (n_head * d, d)
    assert kblk.dtype == vblk.dtype == torch.bfloat16 and zero.dtype == torch.float32
    assert torch.equal(zero, torch.zeros(n_head * d))
    wk, wv = ops[0][:, d:2 * d], ops[0][:, 2 * d:]
    mask = torch.zeros((d, n_head * d), dtype=torch.bool)
    for h in range(n_head):
        hs = slice(h * dh, (h + 1) * dh)
        assert torch.equal(kblk[hs, h * d:(h + 1) * d], wk[:, hs].t())
        assert torch.equal(vblk[h * d:(h + 1) * d, hs], wv[:, hs])
        mask[hs, h * d:(h + 1) * d] = True
    assert torch.all(kblk[~mask] == 0) and torch.all(vblk[~mask.t()] == 0)
    gen = torch.Generator().manual_seed(d + n_head)
    q, tok = torch.randn((3, d), generator=gen), torch.randn((5, d), generator=gen)
    qt = (q @ kblk.float()).reshape(3, n_head, d)
    scores = torch.einsum("bhc,jc->bhj", qt, tok)
    k = tok @ wk.float()
    want = torch.einsum("bhe,jhe->bhj", q.reshape(3, n_head, dh), k.reshape(5, n_head, dh))
    torch.testing.assert_close(scores, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("Lx", [1, 16, 17, 129, 1025])
def test_cls_pool_reference_is_the_softmax_mean(Lx):
    """In f32 the 16-token online softmax is the softmax-weighted mean of the
    tokens, whatever the ragged last step; in bf16 it rounds p at the running
    max."""
    gen = torch.Generator().manual_seed(Lx)
    x, qt = torch.randn((2, Lx, 64), generator=gen), torch.randn((2, 4, 64), generator=gen)
    p = torch.softmax((qt @ x.transpose(1, 2)) * math.log(2.0), dim=-1)
    torch.testing.assert_close(fel.cls_pool_reference(x, qt), p @ x, atol=1e-5, rtol=1e-5)
    one_step = fel.cls_pool_reference(x, qt, step=Lx)
    torch.testing.assert_close(fel.cls_pool_reference(x, qt), one_step, atol=1e-5, rtol=1e-5)
    got = fel.cls_pool_reference(x.bfloat16(), qt.bfloat16())
    assert got.dtype == torch.bfloat16
    want = fel.cls_pool_reference(x.bfloat16().float(), qt.bfloat16().float())
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


def test_k2_wrapper_takes_its_plain_version_on_cpu_and_caches_its_operands():
    _, layer = _layer(95, 128, 512, 8)
    x = torch.from_numpy(_x((2, 9, 128), 5)).bfloat16()
    ops = fel.layer_operands(layer, 8)
    full = fel.layer_cls_operands(layer, 8)
    assert fel.layer_cls_operands(layer, 8) is full and full[:12] == ops
    fel.reset_launches()
    got = fel.fused_encoder_layer_cls(x, full, 8)
    assert torch.equal(got, fel.fused_layer_cls_reference(x, full, 8))
    for wrong in (lambda: fel.fused_encoder_layer_cls(x, ops, 8),  # K2 takes its 15 only
                  lambda: fel.fused_layer_reference(x, full, 8, 1),  # the layer its 12 only
                  lambda: fel.cls_operands(full, 8)):
        with pytest.raises(ValueError):
            wrong()
    assert torch.equal(fel.cls_pool(x, x[:, :3].contiguous()),
                       fel.cls_pool_reference(x, x[:, :3].contiguous()))
    assert fel.launches["fused_encoder_layer_cls"] == 0 and fel.stage_launches["cls_pool"] == 0
    with torch.no_grad():
        layer.attention.w_k.weight.add_(0.01)
    fresh = fel.layer_cls_operands(layer, 8)
    assert fresh is not full and not torch.equal(fresh[12], full[12])


def _admitted(d, d_head):
    return [Lx for Lx in range(1, 4096)
            if fel.fused_infer_supported(Lx, d, 512, d // d_head)]


@pytest.mark.parametrize("d_head", [16, 32, 64])
def test_k7_core_fits_at_every_admitted_length(d_head):
    """K7's wgmma core takes K1's core's shared memory (bf16 k and v tiles)
    and quantizes in place: at every L the gate admits it fits the card
    beside the block's 32 static bytes (its warps' partial maxima), and the
    int8 layout ends within the tiles. Its mma.sync core fits too; a layer
    takes that one up to SYNC_MAX_L tokens (within one key tile), and the
    block the route gives."""
    for Lx in _admitted(128, d_head):
        smem = k7.attention_int8_smem_bytes(Lx, d_head, "wgmma")
        assert smem <= fel.core_smem_bytes(Lx, d_head)
        assert smem + 32 <= fel.MAX_SHARED_MEMORY
        assert k7.k7_int8_layout_bytes(Lx, d_head) <= 4 * (-(-Lx // 64) * 64) * d_head
        assert k7.attention_int8_smem_bytes(Lx, d_head, "sync") + 32 <= fel.MAX_SHARED_MEMORY
        route = k7.core_route(Lx)
        assert route == ("sync" if Lx <= k7.SYNC_MAX_L else "wgmma")
        assert k7.attention_int8_smem_bytes(Lx, d_head) == k7.attention_int8_smem_bytes(
            Lx, d_head, route)
    assert 64 < k7.SYNC_MAX_L <= k7.TILE  # the rawIQ arms' 65 tokens, one key tile


@pytest.mark.parametrize("d", [64, 128, 256])
def test_pool_smem_fits_two_blocks_at_every_admitted_shape(d):
    """K2's pooling kernel streams x, so its shared memory does not depend on
    L; at every admitted (d_model, n_head) a block fits the card, and two
    fit an SM (228 KB, 1 KB reserved a block) at every head count up to 8
    (all but d_model 256 with d_head 16)."""
    for d_head in fel.SUPPORTED_D_HEAD:
        if d % d_head or not _admitted(d, d_head):
            continue
        smem = fel.pool_smem_bytes(d, d // d_head)
        assert smem <= fel.MAX_SHARED_MEMORY
        assert d // d_head > 8 or 2 * (smem + 1024) <= 233472
        assert fel.pool_stages(d) >= 2
