"""K3/K4's GEMM stages one at a time, on the CPU.

The fused training layer's kernels run as a chain of stages
(`vitiq_torch/csrc/fused_layer_train.cu`: `forward`, `backward`): four GEMM
stages forward, the attention passes, LN2's backward rows, then for each
weight its split-K gradient and its input-gradient stage. Their plain
versions (`train_gemm_plain`, `ln_bwd_rows_plain` and the attention helpers),
chained in that order, must give the plain layer
(`fused_train_layer_reference`, `fused_train_layer_backward_reference`, and
K4's stash backward) bit for bit: the stages' operands, transposes,
residuals, masks and rounding points are the layer's. A Python mirror of the
stages' shared-memory sizing gives every stage of every admitted shape a ring
of at least two entries. The kernels themselves are held to these plain
versions on the card (`tests/test_torch_cuda.py`)."""

import pytest
import torch

from vitiq_torch.config import (ExperimentConfig, flagship_conv1d_config, flagship_rawiq_config,
                                flagship_vit_config, rawiq_best_config, rawiq_best_mp_config,
                                vit_tiny_2016_config)
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_layer_train as flt

DROP, SEED, LAYER = 0.1, 77, 2
B = 3  # frames
# (d_model, n_head, FFN width): d_head 16, 32 and 32
WIDTHS = ((64, 4, 256), (128, 4, 512), (256, 8, 1024))


def _case(D, H, F, L):
    gen = torch.Generator().manual_seed(D + L)
    layer = EncoderLayer(D, F, H, generator=gen)
    with torch.no_grad():  # LayerNorm affine away from (1, 0)
        for norm in (layer.norm1, layer.norm2):
            norm.gamma.copy_(1.0 + 0.1 * torch.randn(D, generator=gen))
            norm.beta.copy_(0.1 * torch.randn(D, generator=gen))
    ops = [t.detach().contiguous() for t in flt.flat_weights(layer, torch.bfloat16)]
    x = torch.randn((B, L, D), generator=gen).bfloat16()
    dy = (0.1 * torch.randn((B, L, D), generator=gen)).bfloat16()
    return ops, x, dy


def _drop(site, L):
    return (DROP, SEED, LAYER, site, L)


def _stages_forward(x, ops, H):
    """forward(): QKV, attention, out-projection + LN1, FFN1, FFN2 + LN2."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    L = x.shape[1]
    qkv = flt.train_gemm_plain(x, wqkv, "bias", bias=bqkv)
    r = flt._attention_plain(qkv, H)
    x1, xh1, r1 = flt.train_gemm_plain(r["attn_flat"], wo, "ln_fwd", bias=bo, res=x, gamma=g1,
                                       beta=be1, drop=_drop(0, L))
    h = flt.train_gemm_plain(x1, w1, "relu_drop", bias=b1, drop=_drop(1, L))
    y, xh2, r2 = flt.train_gemm_plain(h, w2, "ln_fwd", bias=b2, res=x1, gamma=g2, beta=be2,
                                      drop=_drop(2, L))
    r.update(x1=x1, xh1=xh1, r1=r1[..., None], h=h, xh2=xh2, r2=r2[..., None])
    return y, r


def _wgrad(act, grad):
    """weight_grad(): the split-K partials of act^T grad, then their sum."""
    splits = flt.weight_grad_splits(act.shape[0] * act.shape[1])
    return flt.train_gemm_plain(act, grad, "partial", splits=splits).sum(dim=0)


def _stages_backward(x, dy, r, ops, H):
    """backward() after the recompute (or K4's rebuild): LN2's rows, then
    FFN2, FFN1 with LN1's backward, the out-projection, the attention
    backward and the QKV projection, each weight gradient before its input
    gradient."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    L, dt = x.shape[1], x.dtype
    mask = flt._site_mask(x.shape, _drop(2, L), x.device)
    dfb, dz2, (dg2, dbe2, db2) = flt.ln_bwd_rows_plain(dy, r["xh2"], r["r2"], g2, mask)
    dw2 = _wgrad(r["h"], dfb)
    dpreb, db1 = flt.train_gemm_plain(dfb, w2, "dpre", res=r["h"], drop=_drop(1, L))
    dw1 = _wgrad(r["x1"], dpreb)
    dab, dz1, (dg1, dbe1, dbo) = flt.train_gemm_plain(
        dpreb, w1, "ln_bwd", res32=dz2, xh=r["xh1"], rstd=r["r1"][..., 0], gamma=g1,
        drop=_drop(0, L))
    dwo = _wgrad(r["attn_flat"], dab)
    dattn = flt.train_gemm_plain(dab, wo, "store")
    dqkv = flt._attention_bwd_plain(dattn, r, H)
    dqkvb = dqkv.to(dt)
    dbqkv = flt._colsum(dqkv)
    dwqkv = _wgrad(x, dqkvb)
    dx = flt.train_gemm_plain(dqkvb, wqkv, "res_out", res32=dz1)
    grads = [dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2]
    return dx, [g.to(w.dtype) for g, w in zip(grads, ops)]


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("L", [17, 65])
@pytest.mark.parametrize("D,H,F", WIDTHS)
def test_forward_stages_compose_to_the_plain_layer(D, H, F, L):
    ops, x, _ = _case(D, H, F, L)
    y, _ = _stages_forward(x, ops, H)
    _same(y, flt.fused_train_layer_reference(x, ops, H, DROP, SEED, LAYER))


@pytest.mark.parametrize("L", [17, 65])
@pytest.mark.parametrize("D,H,F", WIDTHS)
def test_backward_stages_compose_to_the_plain_layer(D, H, F, L):
    """K3-bwd: the recompute (the forward's stages), then the gradient
    stages."""
    ops, x, dy = _case(D, H, F, L)
    _, r = _stages_forward(x, ops, H)
    r["pbar"] = (r["p"] / r["den"]).to(x.dtype).float()
    dx, grads = _stages_backward(x, dy, r, ops, H)
    want_dx, want = flt.fused_train_layer_backward_reference(x, dy, ops, H, DROP, SEED, LAYER)
    _same(dx, want_dx)
    for got, ref in zip(grads, want):
        _same(got, ref)


@pytest.mark.parametrize("L", [17, 65])
@pytest.mark.parametrize("D,H,F", WIDTHS)
def test_stash_backward_stages_compose_to_the_plain_layer(D, H, F, L):
    """K4-bwd: QKV and FFN1 rebuilt by their stages, x1 from the stashed
    xh1, then the gradient stages on the stash."""
    ops, x, dy = _case(D, H, F, L)
    wqkv, bqkv, wo, bo, g1, be1, w1, b1 = ops[:8]
    _, stash = flt.fused_train_layer_stash_reference(x, ops, H, DROP, SEED, LAYER)
    attn, xh1, xh2, r1, r2, pbar = stash
    qkv = flt.train_gemm_plain(x, wqkv, "bias", bias=bqkv)
    r = flt._attention_plain(qkv, H)
    x1 = (xh1.float() * g1 + be1).to(x.dtype)  # rebuild_ln_out
    h = flt.train_gemm_plain(x1, w1, "relu_drop", bias=b1, drop=_drop(1, x.shape[1]))
    r.update(pbar=pbar[..., :L].float(), attn=flt._heads(attn, H), attn_flat=attn, x1=x1, h=h,
             xh1=xh1.float(), r1=r1[..., None], xh2=xh2.float(), r2=r2[..., None])
    dx, grads = _stages_backward(x, dy, r, ops, H)
    want_dx, want = flt.fused_train_layer_stash_backward_reference(x, dy, stash, ops, H, DROP,
                                                                   SEED, LAYER)
    _same(dx, want_dx)
    for got, ref in zip(grads, want):
        _same(got, ref)


def test_weight_gradient_splits_sum_to_the_whole_product():
    """The split-K partials (chunks of 64-row steps, the last one short) add
    up to act^T grad in f32."""
    gen = torch.Generator().manual_seed(5)
    act = torch.randn((1000, 64), generator=gen).bfloat16()
    grad = torch.randn((1000, 192), generator=gen).bfloat16()
    parts = flt.train_gemm_plain(act, grad, "partial", splits=3)
    assert parts.shape == (3, 64, 192) and flt.depth_chunk(1000, 3) == 384
    want = act.float().t() @ grad.float()
    assert torch.allclose(parts.sum(dim=0), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(flt.train_gemm(act, grad, "partial", splits=3), parts)


def test_ragged_rows_draw_the_masks_of_their_frames():
    """A stage's mask over M rows that are not whole frames is the frames'
    mask cut after M rows (row r: frame r // L, token r % L)."""
    full = flt.dropout_mask((4, 17, 64), 0.3, 9, 1, 2).reshape(-1, 64)
    assert torch.equal(flt._site_mask((60, 64), (0.3, 9, 1, 2, 17)), full[:60])


def _admitted_shapes():
    presets = [flagship_vit_config("tpu"), flagship_rawiq_config("tpu"),
               flagship_conv1d_config("tpu"), rawiq_best_config("tpu"),
               rawiq_best_mp_config("tpu"), vit_tiny_2016_config("tpu"),
               ExperimentConfig.vit_tpu_production().model]
    shapes = {(c.d_model, c.ffn_hidden) for c in presets}
    shapes |= {(D, F) for D in flt.SUPPORTED_D_MODEL for F in (64, 192, 320)}
    return sorted(shapes)


@pytest.mark.parametrize("D,F", _admitted_shapes())
def test_every_stage_of_an_admitted_shape_gets_a_ring_of_two(D, F):
    """Every GEMM stage K3 and K4 launch at the presets' widths and at FFN
    widths that 128 does not divide has a built instance whose ring holds
    at least two entries in 227 KB (gemm_wgmma.cuh's sizing, mirrored)."""
    assert flt.fused_train_supported(17, D, F, D // 16)
    for name, epi, K, N in flt.stage_plan(D, F):
        bn = flt.stage_slab(epi, N)
        assert N % bn == 0 and bn in (64, 128, 256), (name, bn)
        resident = flt.stage_resident(epi, bn, K)
        assert flt.stage_built(epi, bn, resident), (name, bn, resident)
        ring = flt.stage_ring(epi, bn, K, resident)
        assert ring >= 2, (name, bn, resident, ring)
        assert flt.stage_smem_bytes(epi, bn, K, resident, ring) <= flt.MAX_SHARED_MEMORY
