"""K4's two attention passes alone (`stash_attention_fwd`, `stash_attention_bwd`):
their plain versions against vitiq's stash kernels, the tile and
shared-memory mirrors of the CUDA kernels, K4's gate and pbar's padding.

On the CPU the wrappers run their plain versions (`stash_attention_fwd_plain`,
`stash_attention_bwd_plain`), which are held:

* to the attention pieces of the plain K4 layer
  (`fused_train_layer_stash_reference` and `..._backward_reference`), bit
  for bit: the same qkv gives the same attn and pbar, and the attention
  backward inside the plain K4 backward gives the same dqkv and column sums
  as the plain pass on the inputs it was handed;
* to vitiq's stash forward (`_run_fwd` with VITIQ_TRAIN_STASH=1, in Pallas
  interpret mode, in both of its TPU schedules: the packed
  `_fwd_kernel_stash_xpack` and the chain `_fwd_kernel_stash`), whose stash
  packs attn and pbar as [B, Lp, 3D + H Lp]: in f32 within 1e-5 (the port
  subtracts each score row's max before exp2 and vitiq does not, which moves
  only f32 roundings), in bf16 within 1e-3 + 1.6e-2 |vitiq| (that max moves
  where p rounds to bf16: about two bf16 ulps, and vitiq's qkv may differ
  from the port's by a flip);
* to vitiq's stash backward: the plain backward pass, fed the qkv, attn, pbar
  and dattn that the plain K4 backward hands its attention backward, gives
  per frame the column sums of dqkv whose sum over frames is the gradient of
  the qkv bias, and x^T dqkv is the gradient of Wqkv; both are held to
  vitiq's vjp through its stash kernels in f32 at atol 2e-3, rtol 1e-3, the
  bound of tests/test_torch_train_stash.py, at dropout 0.

The card's checks hold the forward kernel's pbar within three bf16 ulps of
the plain pbar on the same qkv; `test_one_flipped_p_moves_pbar_by_up_to_three_ulps`
shows that a right kernel can reach that bound and no further.

`fused_train_stash_supported` admits exactly the (L, D, F, H) set it did
before the attention passes were redesigned (their shared memory never
binds: K3's gate does first), and the Python mirrors of the tiles and shared
memory equal the formulas the .cu header states."""

import itertools
import math

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

BF16_TOL = (1e-3, 1.6e-2)


def _layer(seed, n_head, ffn, d):
    tree = L.encoder_layer_init(jax.random.PRNGKey(seed), d, ffn)
    layer = EncoderLayer(d, ffn, n_head)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    return tree, layer


def _qkv(x, ops):
    """The layer's qkv as the plain K4 forward forms it."""
    return (flt._mm(x, ops[0]) + ops[1]).to(x.dtype)


@pytest.mark.parametrize("B,Lx,n_head,d", [(2, 17, 4, 64), (2, 64, 8, 128), (1, 65, 8, 128),
                                           (1, 65, 2, 128)])
def test_plain_passes_are_the_plain_layers_pieces_bit_for_bit(B, Lx, n_head, d, monkeypatch):
    _, layer = _layer(4, n_head, 256, d)
    ops = [t.detach() for t in flt.flat_weights(layer, torch.bfloat16)]
    rng = np.random.default_rng(Lx)
    x = torch.from_numpy(rng.standard_normal((B, Lx, d)).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(0.1 * rng.standard_normal((B, Lx, d)).astype(np.float32)).bfloat16()
    _, stash = flt.fused_train_layer_stash_reference(x, ops, n_head, 0.1, 3, 1)
    attn, pbar = flt.stash_attention_fwd(_qkv(x, ops), n_head)  # the plain version on the CPU
    assert torch.equal(attn, stash[0]) and torch.equal(pbar, stash[5])

    seen = {}
    inputs, bwd = flt._stash_attention_inputs, flt._attention_bwd_plain

    def spy_inputs(qkv, a, p, h):
        seen["qkv"] = qkv
        return inputs(qkv, a, p, h)

    def spy_bwd(dattn, r, h):
        seen["dattn"], seen["dqkv"] = dattn, bwd(dattn, r, h)
        return seen["dqkv"]

    monkeypatch.setattr(flt, "_stash_attention_inputs", spy_inputs)
    monkeypatch.setattr(flt, "_attention_bwd_plain", spy_bwd)
    flt.fused_train_layer_stash_backward_reference(x, dy, stash, ops, n_head, 0.1, 3, 1)
    monkeypatch.undo()
    dqkv, part = flt.stash_attention_bwd(seen["qkv"], stash[0], seen["dattn"], stash[5], n_head)
    assert torch.equal(dqkv, seen["dqkv"].to(dqkv.dtype))
    assert torch.equal(part, seen["dqkv"].sum(dim=1)) and part.shape == (B, 3 * d)


def _vitiq_stash_forward(tree, x, n_head, dtype):
    """vitiq's stash forward in interpret mode: (attn [B, L, D], pbar [B, H,
    L, L]) unpacked from its stash [B, Lp, 3D + H Lp]."""
    B, Lx, d = x.shape
    weights = jflt._flat_weights(tree, dtype)
    with pltpu.force_tpu_interpret_mode():
        _, sb, _ = jflt._run_fwd(n_head, 0.0, 0, Lx, 7, jnp.asarray(x, dtype), weights)
    sb = np.asarray(jnp.asarray(sb, jnp.float32))[:B, :Lx]
    lp = (sb.shape[-1] - 3 * d) // n_head
    pbar = sb[..., 3 * d:].reshape(B, Lx, n_head, lp)[..., :Lx].transpose(0, 2, 1, 3)
    return sb[..., :d], pbar


@pytest.mark.parametrize("schedule", ["xpack", "chain"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Lx,n_head,d", [(2, 17, 4, 64), (1, 64, 8, 128), (2, 65, 8, 128),
                                           (1, 65, 2, 128)])
def test_plain_forward_pass_matches_vitiqs_stash_forward(schedule, dtype, B, Lx, n_head, d,
                                                         monkeypatch):
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "1")
    monkeypatch.setenv("VITIQ_TRAIN_FWD", schedule)
    tree, layer = _layer(2, n_head, 256, d)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(B + Lx).standard_normal((B, Lx, d)).astype(np.float32)
    want_attn, want_pbar = _vitiq_stash_forward(tree, x, n_head, jdt)
    ops = [t.detach() for t in flt.flat_weights(layer, tdt)]
    attn, pbar = flt.stash_attention_fwd_plain(_qkv(torch.from_numpy(x).to(tdt), ops), n_head)
    assert pbar.shape == (B, n_head, Lx, flt.stash_cols(Lx))
    assert not torch.count_nonzero(pbar[..., Lx:])
    atol, rtol = (1e-5, 0.0) if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(attn.float().numpy(), want_attn, atol=atol, rtol=rtol)
    np.testing.assert_allclose(pbar[..., :Lx].float().numpy(), want_pbar, atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,Lx,n_head,d", [(2, 17, 4, 64), (1, 65, 8, 128), (1, 33, 2, 128)])
def test_plain_backward_pass_matches_vitiqs_stash_backward(B, Lx, n_head, d, monkeypatch):
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "1")
    tree, layer = _layer(1, n_head, 256, d)
    rng = np.random.default_rng(5 + Lx)
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
    y_port, stash = flt.fused_train_layer_stash_reference(xt, ops, n_head, 0.0, 7, 0)
    seen = {}
    inputs, bwd = flt._stash_attention_inputs, flt._attention_bwd_plain

    def spy_inputs(qkv, a, p, h):
        seen["qkv"] = qkv
        return inputs(qkv, a, p, h)

    def spy_bwd(dattn, r, h):
        seen["dattn"] = dattn
        return bwd(dattn, r, h)

    monkeypatch.setattr(flt, "_stash_attention_inputs", spy_inputs)
    monkeypatch.setattr(flt, "_attention_bwd_plain", spy_bwd)
    flt.fused_train_layer_stash_backward_reference(
        xt, 2.0 * (y_port - torch.from_numpy(tgt)), stash, ops, n_head, 0.0, 7, 0)
    monkeypatch.undo()
    dqkv, part = flt.stash_attention_bwd_plain(seen["qkv"], stash[0], seen["dattn"], stash[5],
                                               n_head)
    dw = xt.reshape(-1, d).t() @ dqkv.reshape(-1, 3 * d)
    for i, name in enumerate(("w_q", "w_k", "w_v")):
        np.testing.assert_allclose(part.sum(0)[i * d:(i + 1) * d].numpy(),
                                   want[f"attention.{name}.bias"].numpy(), atol=2e-3, rtol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(dw[:, i * d:(i + 1) * d].t().numpy(),
                                   want[f"attention.{name}.weight"].numpy(), atol=2e-3,
                                   rtol=1e-3, err_msg=name)


def _stash_supported_before(Lx, D, F, H):
    """`fused_train_stash_supported` as it was before the passes' redesign:
    K3's shapes, the stash gate, and the mma.sync attention-backward block (v and
    dO as rows, q, k and dO transposed, the row term and column-sum scratch)
    within the card's shared memory."""
    if not flt.fused_train_supported(Lx, D, F, H):
        return False
    lp, dh = -(-Lx // 16) * 16, D // H
    smem = (2 * lp * (dh + 8) + 3 * dh * (lp + 8)) * 2 + (lp + 4 * 3 * dh) * 4
    return flt.stash_supported(lp, Lx, H) and smem <= flt.MAX_SHARED_MEMORY


def test_stash_gate_admits_the_same_shapes(monkeypatch):
    monkeypatch.delenv("VITIQ_TRAIN_TAIL", raising=False)
    admitted = 0
    for Lx, D, H, F in itertools.product(range(1, 641), (64, 128, 256), (1, 2, 4, 8, 16),
                                         (192, 256)):
        got = flt.fused_train_stash_supported(Lx, D, F, H)
        assert got == _stash_supported_before(Lx, D, F, H), (Lx, D, H, F)
        admitted += got
    assert admitted > 0
    # the longest L K4 takes at each d_head: 320 (d_head 16), 432 (32), 224 (64)
    for D, H, longest in ((64, 4, 320), (64, 2, 432), (64, 1, 224)):
        assert flt.fused_train_stash_supported(longest, D, 256, H)
        assert not flt.fused_train_stash_supported(longest + 1, D, 256, H)


def test_tile_plan_and_shared_memory_mirror_the_kernels():
    """The .cu's helpers as its header states them: the forward keeps a
    64-query tile's scores over the least of 2, 4 or 5 16-key groups that
    covers round16(L), else 64-key tiles, loading q, k and v rows 16 NG or
    round64(L); the backward is resident up to round16(L) = 80 with 2, 4 or
    5 groups (rows 16 NG), else streams 64-key tiles (rows round64(L)); its
    shared memory is 1 KB of alignment, 4 rows x d_head bf16 operands, the
    pbar plane (resident: ceil(rows / 64) chunks of rows x 128 bytes; else
    two [64][64] tiles), 4 x 3 x d_head f32 and 16 bytes of mbarriers; the
    forward's is 1 KB, two buffers of q, k and v each rounded up to 1 KB,
    ceil(rows / 64) staging chunks of rows x 128 bytes (one tile: all its
    rows; else a 64-query tile's) and 16 bytes."""
    for Lx in range(1, 433):
        plan = flt.stash_tile_plan(Lx)
        ng = -(-Lx // 16)
        fg = next((g for g in (2, 4, 5) if ng <= g), 4)
        assert plan["fwd_groups"] == fg
        kr = 16 * fg if Lx <= 16 * fg else -(-Lx // 64) * 64
        assert plan["fwd_key_rows"] == kr
        assert plan["bwd_resident"] == (ng <= 5)
        bg = next(g for g in (2, 4, 5) if ng <= g) if ng <= 5 else 4
        rows = 16 * bg if ng <= 5 else -(-Lx // 64) * 64
        assert (plan["bwd_groups"], plan["bwd_rows"]) == (bg, rows)
        for dh in (16, 32, 64):
            plane = -(-rows // 64) * rows * 128 if ng <= 5 else 2 * 8192
            assert flt.stash_attention_bwd_smem_bytes(Lx, dh) == (
                1024 + 4 * rows * dh * 2 + plane + 4 * 3 * dh * 4 + 16)
            staging = -(-kr // 64) * (kr if Lx <= 16 * fg else 64) * 128
            qkv = -(-3 * kr * dh * 2 // 1024) * 1024
            assert flt.stash_attention_fwd_smem_bytes(Lx, dh) == 1024 + 2 * qkv + staging + 16
    # the main path's: the rawIQ flagship (L 65, d_head 16) and rawiq_best_mp
    # (L 64, d_head 32)
    assert flt.stash_attention_fwd_smem_bytes(65, 16) == 1024 + 2 * 8192 + 20480 + 16
    assert flt.stash_attention_bwd_smem_bytes(65, 16) == 1024 + 10240 + 20480 + 768 + 16
    assert flt.stash_attention_bwd_smem_bytes(64, 32) == 1024 + 16384 + 8192 + 1536 + 16


@pytest.mark.parametrize("B,Lx,n_head,d", [(2, 17, 4, 64), (1, 64, 8, 128), (2, 65, 8, 128),
                                           (1, 1, 8, 128), (1, 129, 4, 64)])
def test_pbar_is_padded_with_zeros_and_slices_back(B, Lx, n_head, d):
    """pbar's rows are stash_cols(L) = round_up(L, 8) long, the padding 0,
    and its slice [..., :L] is bf16(p / l) over the L keys, each row summing
    to about 1."""
    qkv = torch.from_numpy(np.random.default_rng(Lx).standard_normal((B, Lx, 3 * d))
                           .astype(np.float32)).bfloat16()
    _, pbar = flt.stash_attention_fwd(qkv, n_head)
    assert flt.stash_cols(Lx) == math.ceil(Lx / 8) * 8 and flt.stash_cols(Lx) % 8 == 0
    assert pbar.shape == (B, n_head, Lx, flt.stash_cols(Lx)) and pbar.dtype == torch.bfloat16
    assert not torch.count_nonzero(pbar[..., Lx:])
    a = flt._attention_plain(qkv, n_head)
    assert torch.equal(pbar[..., :Lx], (a["p"] / a["den"]).bfloat16())
    assert torch.allclose(pbar.float().sum(-1), torch.ones(B, n_head, Lx), atol=0.05)


def test_pass_wrappers_count_nothing_on_the_cpu():
    flt.reset_launches()
    qkv = torch.randn((1, 17, 3 * 64)).bfloat16()
    attn, pbar = flt.stash_attention_fwd(qkv, 4)
    flt.stash_attention_bwd(qkv, attn, attn, pbar, 4)
    assert flt.pass_launches == {"stash_attention_fwd": 0, "stash_attention_bwd": 0,
                                 "recompute_attention_fwd": 0, "recompute_attention_bwd": 0}


def test_one_flipped_p_moves_pbar_by_up_to_three_ulps():
    """pbar = bf16(p / l) with p = bf16(exp2(s - max)): where a kernel sums s
    in another order, p's bf16 rounding may flip by one ulp. p at the foot
    of its binade and p / l near the top of its own, that moves p / l by
    under two ulps of its binade, and the quotient's rounding across a
    binade edge by one more: three ulps of |plain| (the limit of the CUDA
    checks), reached and not passed."""
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    p = torch.exp2(-12 * torch.rand(n, generator=gen)).to(torch.bfloat16)
    l = 1 + 70 * torch.rand(n, generator=gen)  # row sums of up to ~71 keys
    q = (p.float() / l).to(torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(q)) - 7)
    worst = max(((torch.nextafter(p, torch.full_like(p, to)).float() / l).to(torch.bfloat16)
                 .float() - q).abs().div(ulp).max().item() for to in (0.0, 2.0))
    assert worst == 3
