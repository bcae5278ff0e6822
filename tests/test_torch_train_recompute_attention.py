"""K3's two attention passes alone (`recompute_attention_fwd`,
`recompute_attention_bwd`): their plain versions against the plain K3 layer
and vitiq's K3 kernels, the tile and shared-memory mirrors of the CUDA
kernels, and K3's gate.

On the CPU the wrappers run their plain versions
(`recompute_attention_fwd_plain`, `recompute_attention_bwd_plain`), which are
held:

* to the attention pieces of the plain K3 layer (`fused_train_layer_reference`
  and `fused_train_layer_backward_reference`), bit for bit: the same qkv
  gives the same attn, and the stats (m, l) are the row max the plain
  forward subtracts and its sum of rounded probabilities; the attention
  backward inside the plain K3 backward gives the same dqkv and column sums
  as the plain pass on the qkv, attn and dattn it was handed and the
  forward pass's stats (the pass forms pbar = bf16(bf16(exp2(s - m)) / l)
  again from them, as the kernel does);
* to vitiq's K3 backward (`fused_train_layer_stack` with
  VITIQ_TRAIN_STASH=0, the recompute regime, in Pallas interpret mode, at
  dropout 0): per frame, the column sums of dqkv sum over frames to the
  gradient of the qkv bias, and x^T dqkv is the gradient of Wqkv; both in
  f32 within atol 2e-3, rtol 1e-3, the bound of
  tests/test_torch_train_stash_attention.py.

`fused_train_supported` admits exactly the (L, D, F, H) set it did before the
passes were redesigned (its bound is still the mma.sync backward's shared
memory, which the passes past 144 tokens keep), and the Python mirrors of the
tiles and shared memory equal the formulas the .cu header states."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq.models import layers as L
from vitiq.ops.pallas import fused_layer_train as jflt
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_layer_train as flt


def _layer(seed, n_head, ffn, d):
    tree = L.encoder_layer_init(jax.random.PRNGKey(seed), d, ffn)
    layer = EncoderLayer(d, ffn, n_head)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    return tree, layer


def _qkv(x, ops):
    """The layer's qkv as the plain K3 forward forms it."""
    return (flt._mm(x, ops[0]) + ops[1]).to(x.dtype)


def _spy_attention_backward(monkeypatch, seen):
    """Record the dattn the plain K3 backward hands its attention backward,
    and the dqkv it gets back."""
    bwd = flt._attention_bwd_plain

    def spy(dattn, r, h):
        seen["dattn"], seen["dqkv"] = dattn, bwd(dattn, r, h)
        return seen["dqkv"]

    monkeypatch.setattr(flt, "_attention_bwd_plain", spy)


@pytest.mark.parametrize("B,Lx,n_head,d", [(2, 17, 4, 64), (2, 33, 4, 128), (1, 65, 8, 128),
                                           (1, 65, 2, 128), (1, 1, 8, 128)])
def test_plain_passes_are_the_plain_layers_pieces_bit_for_bit(B, Lx, n_head, d, monkeypatch):
    _, layer = _layer(4, n_head, 256, d)
    ops = [t.detach() for t in flt.flat_weights(layer, torch.bfloat16)]
    rng = np.random.default_rng(Lx)
    x = torch.from_numpy(rng.standard_normal((B, Lx, d)).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(0.1 * rng.standard_normal((B, Lx, d)).astype(np.float32)).bfloat16()
    qkv = _qkv(x, ops)
    attn, stats = flt.recompute_attention_fwd(qkv, n_head)  # the plain version on the CPU
    _, r = flt._forward(x, ops, n_head, 0.1, 3, 1)
    assert torch.equal(attn, r["attn_flat"])
    assert stats.shape == (B, n_head, Lx, 2) and stats.dtype == torch.float32
    s = r["qs"] @ r["k"].transpose(-1, -2)
    assert torch.equal(stats[..., 0], s.amax(dim=-1))
    assert torch.equal(stats[..., 1], r["den"][..., 0])
    # the plain forward's probabilities from the stats: p = bf16(exp2(s - m))
    assert torch.equal(torch.exp2(s - stats[..., :1]).bfloat16().float(), r["p"])

    seen = {}
    _spy_attention_backward(monkeypatch, seen)
    flt.fused_train_layer_backward_reference(x, dy, ops, n_head, 0.1, 3, 1)
    monkeypatch.undo()
    dqkv, part = flt.recompute_attention_bwd(qkv, attn, seen["dattn"], stats, n_head)
    assert torch.equal(dqkv, seen["dqkv"].to(dqkv.dtype))
    assert torch.equal(part, seen["dqkv"].sum(dim=1)) and part.shape == (B, 3 * d)


@pytest.mark.parametrize("B,Lx,n_head,d", [(2, 17, 4, 64), (1, 65, 8, 128), (1, 33, 2, 128)])
def test_plain_backward_pass_matches_vitiqs_k3_backward(B, Lx, n_head, d, monkeypatch):
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "0")
    tree, layer = _layer(1, n_head, 256, d)
    rng = np.random.default_rng(9 + Lx)
    x = rng.standard_normal((B, Lx, d)).astype(np.float32)
    tgt = rng.standard_normal((B, Lx, d)).astype(np.float32)

    def fwd(params, xx):
        return jflt.fused_train_layer_stack(xx, [params], n_head, 0.0, 7)

    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(fwd, tree, jnp.asarray(x))
        gp, _ = vjp(2.0 * (y - jnp.asarray(tgt)))
    want = encoder_layer_state_dict(gp)

    ops = [t.detach() for t in flt.flat_weights(layer, torch.float32)]
    xt = torch.from_numpy(x)
    assert not flt.stash_enabled(Lx, n_head, d, B, xt.dtype)
    y_port = flt.fused_train_layer_reference(xt, ops, n_head, 0.0, 7, 0)
    seen = {}
    _spy_attention_backward(monkeypatch, seen)
    flt.fused_train_layer_backward_reference(xt, 2.0 * (y_port - torch.from_numpy(tgt)), ops,
                                             n_head, 0.0, 7, 0)
    monkeypatch.undo()
    qkv = _qkv(xt, ops)
    attn, stats = flt.recompute_attention_fwd_plain(qkv, n_head)
    dqkv, part = flt.recompute_attention_bwd_plain(qkv, attn, seen["dattn"], stats, n_head)
    dw = xt.reshape(-1, d).t() @ dqkv.reshape(-1, 3 * d)
    for i, name in enumerate(("w_q", "w_k", "w_v")):
        np.testing.assert_allclose(part.sum(0)[i * d:(i + 1) * d].numpy(),
                                   want[f"attention.{name}.bias"].numpy(), atol=2e-3, rtol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(dw[:, i * d:(i + 1) * d].t().numpy(),
                                   want[f"attention.{name}.weight"].numpy(), atol=2e-3,
                                   rtol=1e-3, err_msg=name)


def _supported_before(Lx, D, F, H):
    """`fused_train_supported` as it was before the passes' redesign: d_model
    64/128/256, d_head 16/32/64, an FFN width 64 divides, and the mma.sync
    attention-backward block (q, k, v, dO as rows, q, k, dO transposed, the
    row stats and column-sum scratch) within the card's shared memory."""
    if D not in (64, 128, 256) or D % H or (D // H) not in (16, 32, 64) or F % 64:
        return False
    lp, dh = -(-Lx // 16) * 16, D // H
    smem = (4 * lp * (dh + 8) + 3 * dh * (lp + 8)) * 2 + (3 * lp + 4 * 3 * dh) * 4
    return smem <= 232448


def test_k3_gate_admits_the_same_shapes():
    admitted = 0
    for Lx, D, H, F in itertools.product(range(1, 800), (64, 128, 256), (1, 2, 4, 8, 16),
                                         (192, 256)):
        got = flt.fused_train_supported(Lx, D, F, H)
        assert got == _supported_before(Lx, D, F, H), (Lx, D, H, F)
        admitted += got
    assert admitted > 0
    # the longest L K3 takes at each d_head, past which the layer is refused
    for D, H, longest in ((64, 4, 768), (64, 2, 432), (64, 1, 224)):
        assert flt.fused_train_supported(longest, D, 256, H)
        assert not flt.fused_train_supported(longest + 1, D, 256, H)


@pytest.mark.parametrize("dh", [16, 32, 64])
def test_tile_plan_and_shared_memory_mirror_the_kernels(dh):
    """The .cu's helpers as its header states them: the backward takes the
    wgmma pass where round16(L) <= 144, and so does the forward but at d_head
    16 past 80 keys (the mma.sync forward measured faster there); both in the
    least of 2, 4, 5 or 9 16-key groups that covers round16(L) (rows 16
    groups), the backward in 3 warpgroups at 9 groups past d_head 16, else
    1; the forward's
    shared memory is 1 KB of alignment, two buffers of q, k and v rows, each
    rounded up to 1 KB, and 16 bytes of mbarriers; the backward's 1 KB, q, k,
    v and dO rows, the pbar plane of ceil(rows / 64) chunks of rows x 128
    bytes, 4 x 3 x d_head f32 a warpgroup, the row terms (rows f32), a 64 x
    d_head f32 dQ partial for each warpgroup past the first and 16 bytes.
    Every such L fits one block, and L past 144 takes the mma.sync passes."""
    for Lx in range(1, 433):
        plan = flt.recompute_tile_plan(Lx, dh)
        ng = -(-Lx // 16)
        assert plan["bwd_wgmma"] == (ng <= 9)
        if not plan["bwd_wgmma"]:
            assert not plan["fwd_wgmma"] and plan["groups"] == plan["rows"] == 0
            continue
        groups = next(g for g in (2, 4, 5, 9) if ng <= g)
        rows, wgs = 16 * groups, 3 if groups == 9 and dh > 16 else 1
        assert (plan["groups"], plan["rows"], plan["bwd_warpgroups"]) == (groups, rows, wgs)
        assert plan["fwd_wgmma"] == (dh != 16 or ng <= 5)
        assert flt.recompute_attention_fwd_smem_bytes(Lx, dh) == (
            1024 + 2 * (-(-3 * rows * dh * 2 // 1024) * 1024) + 16)
        bwd = (1024 + 4 * rows * dh * 2 + -(-rows // 64) * rows * 128 + wgs * 4 * 3 * dh * 4
               + rows * 4 + (wgs - 1) * 64 * dh * 4 + 16)
        assert flt.recompute_attention_bwd_smem_bytes(Lx, dh) == bwd <= flt.MAX_SHARED_MEMORY
    # the main path's: ViT and vit_tpu_production (L 129, d_head 16 and 64),
    # rawiq_best (L 65, d_head 32)
    if dh == 16:
        assert flt.recompute_attention_bwd_smem_bytes(129, 16) == (1024 + 18432 + 55296 + 768 + 576
                                                                   + 16)
        assert flt.recompute_attention_fwd_smem_bytes(65, 16) == 1024 + 2 * 8192 + 16
    if dh == 32:
        assert flt.recompute_attention_bwd_smem_bytes(65, 32) == (1024 + 20480 + 20480 + 1536 + 320
                                                                  + 16)
    if dh == 64:
        assert flt.recompute_attention_bwd_smem_bytes(129, 64) == (
            1024 + 73728 + 55296 + 3 * 3072 + 576 + 2 * 16384 + 16)
        assert flt.recompute_attention_fwd_smem_bytes(129, 64) == 1024 + 2 * 55296 + 16


@pytest.mark.parametrize("Lx,d,n_head", [(129, 128, 8), (65, 256, 8), (129, 128, 2), (17, 64, 4),
                                         (65, 128, 8), (1, 128, 8)])
def test_every_main_path_shape_takes_the_wgmma_backward(Lx, d, n_head):
    """Every shape K3 trains on the main path (the ViT flagship,
    rawiq_best, vit_tpu_production, vit_tiny_2016 and the rawIQ flagship
    under VITIQ_TRAIN_STASH=0, and one token) is one K3 takes and one whose
    backward pass runs on wgmma; the forward does too, but at the ViT
    flagship's (d_head 16, 129 tokens)."""
    assert flt.fused_train_supported(Lx, d, 256, n_head)
    plan = flt.recompute_tile_plan(Lx, d // n_head)
    assert plan["bwd_wgmma"]
    assert plan["fwd_wgmma"] == ((Lx, d, n_head) != (129, 128, 8))


def test_stats_are_each_rows_max_and_sum():
    """stats[..., 0] is each query row's max score in log2 units (q scaled by
    log2(e) / sqrt(d_head)), stats[..., 1] the f32 sum of bf16(exp2(s - m)):
    at least 1 (the max key's p is 1) and at most L."""
    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 40, 3 * 64))
                           .astype(np.float32)).bfloat16()
    attn, stats = flt.recompute_attention_fwd(qkv, 4)
    a = flt._attention_plain(qkv, 4)
    s = a["qs"] @ a["k"].transpose(-1, -2)
    assert torch.equal(stats[..., 0], s.max(dim=-1).values)
    assert bool((stats[..., 1] >= 1).all()) and bool((stats[..., 1] <= 40).all())
    assert torch.equal(attn, a["attn_flat"])


def test_pass_wrappers_count_nothing_on_the_cpu():
    flt.reset_launches()
    qkv = torch.randn((1, 17, 3 * 64)).bfloat16()
    attn, stats = flt.recompute_attention_fwd(qkv, 4)
    flt.recompute_attention_bwd(qkv, attn, attn, stats, 4)
    assert flt.pass_launches == {"stash_attention_fwd": 0, "stash_attention_bwd": 0,
                                 "recompute_attention_fwd": 0, "recompute_attention_bwd": 0}
