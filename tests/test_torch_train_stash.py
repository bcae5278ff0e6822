"""The port's stash regime of the fused training layer (K4) against vitiq's.

On the CPU the K4 wrappers run their plain PyTorch versions. They are held
against `vitiq.ops.pallas.fused_layer_train.fused_train_layer_stack` run in
interpret mode with the stash forced on both sides (`VITIQ_TRAIN_STASH=1`),
at dropout 0, on a loss against a target:

* f32: the forward at atol 1e-4 (the port subtracts the row max before exp2,
  the TPU kernel does not), dx and the 12 gradients at atol 2e-3, rtol 1e-3
  (the bound of tests/test_fused_train_layer.py);
* bf16, which holds the stash itself to the JAX kernel (bf16 LN inputs, the
  x1 rebuilt from them, bf16 pbar): y within (3e-2 + 1.6e-2 |ref|), the
  one-layer tolerance of the CUDA tests (about two bf16 ulps plus a floor
  near zero); each gradient and dx at cosine >= 0.999. The w_k bias has an
  exactly zero gradient, so its noise is bounded instead (max |.| < 0.05).
  dx is not held to vitiq element by element: at L=65 about 1.4% of its
  elements differ by more than the one-layer tolerance in the recompute
  regime too (the port subtracts the row max, so its probabilities round
  elsewhere, and dx sums several bf16-rounded stages). It is held at a
  relative L2 error <= 1e-2, and, element by element at the one-layer
  tolerance, to the port's own recompute regime (K3's plain versions), as
  vitiq's stash dx agrees with its recompute dx.

The explicit plain K4 backward is held against torch.autograd of the plain
forward in f32 at atol 1e-5, with dropout off and on. The CUDA kernels are
compared with the plain versions on the GPU in tests/test_torch_cuda.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq.config import ModelConfig
from vitiq.models import layers as L
from vitiq.ops.pallas import fused_layer_train as jflt
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models import AMCModel
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_layer_train as flt

D = 128
LAYER_TOL = (3e-2, 1.6e-2)


def _layer(seed, n_head, ffn, d=D):
    tree = L.encoder_layer_init(jax.random.PRNGKey(seed), d, ffn)
    layer = EncoderLayer(d, ffn, n_head)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    return tree, layer


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_stash_gate_matches_vitiq(env, monkeypatch):
    """`stash_enabled` and `stash_supported` equal vitiq's `_stash_enabled`
    and `_stash_supported` over a grid of L, H, d, batch and dtype (Lp = L
    rounded up to 16 in bf16, to 8 in f32), with and without the tail-key
    mode that the stash does not serve."""
    if env is not None:
        monkeypatch.setenv("VITIQ_TRAIN_STASH", env)
    grid = itertools.product([1, 9, 16, 17, 64, 65, 80, 81, 129, 130, 136, 160],
                             [2, 4, 8, 16], [64, 128, 256, 512], [None, 2048, 4096, 8192],
                             [torch.bfloat16, torch.float32])
    for tail in ("0", "1"):
        monkeypatch.setenv("VITIQ_TRAIN_TAIL", tail)
        for Lx, H, d, batch, dtype in grid:
            lp = -(-Lx // (16 if dtype == torch.bfloat16 else 8)) * (16 if dtype == torch.bfloat16
                                                                    else 8)
            case = (tail, Lx, H, d, batch, dtype)
            assert flt.stash_supported(lp, Lx, H) == jflt._stash_supported(lp, Lx, H), case
            assert (flt.stash_enabled(Lx, H, d, batch, dtype)
                    == jflt._stash_enabled(lp, Lx, H, d, batch)), case


def test_flagship_gates():
    assert flt.stash_enabled(65, 8, 128, 4096)        # rawIQ flagship, Lp 80
    assert not flt.stash_enabled(129, 8, 128, 4096)   # ViT flagship, Lp 144
    assert flt.fused_train_stash_supported(65, 128, 1024, 8)
    assert flt.fused_train_stash_supported(144, 128, 512, 8)       # H * Lp = 1152
    assert not flt.fused_train_stash_supported(161, 128, 512, 8)   # H * Lp = 1408
    assert flt.fused_train_stash_supported(65, 128, 1024, 2)       # d_head 64
    assert flt.stash_enabled(65, 2, 128, 4096)     # the rawIQ flagship at n_head 2: K4
    assert not flt.stash_enabled(129, 2, 128, 4096)  # vit_tpu_production: K3
    assert flt.stash_enabled(17, 4, 64, 4096)      # vit_tiny_2016 (d64, Lp 32): K4
    assert flt.fused_train_stash_supported(17, 64, 256, 4)
    # K4-bwd's resident attention block at d_head 64: q, k, v, dO [80][64] and
    # the pbar plane of two key chunks [80][64]
    assert flt.stash_attention_bwd_smem_bytes(65, 64) == 65552
    # rawiq_best (d256, 65 tokens, Lp 80): the recompute; rawiq_best_mp (64
    # tokens, Lp 64): the stash at batch <= 4096, as vitiq gates it
    assert not flt.stash_enabled(65, 8, 256, 4096)
    assert flt.stash_enabled(64, 8, 256, 4096) and not flt.stash_enabled(64, 8, 256, 8192)
    assert flt.fused_train_supported(65, 256, 1024, 8)
    assert flt.fused_train_stash_supported(64, 256, 1024, 8)
    assert flt.stash_attention_bwd_smem_bytes(80, 32) < flt.attention_bwd_smem_bytes(80, 32)


def test_plain_stash_forward_y_is_the_plain_k3_forward():
    _, layer = _layer(5, 8, 256)
    ops = [t.detach() for t in flt.flat_weights(layer, torch.bfloat16)]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 65, D)).astype(np.float32))
    x = x.bfloat16()
    y, stash = flt.fused_train_layer_stash_reference(x, ops, 8, 0.2, 17, 2)
    assert torch.equal(y, flt.fused_train_layer_reference(x, ops, 8, 0.2, 17, 2))
    assert [(tuple(t.shape), t.dtype) for t in stash] == flt.stash_shapes(x, 8)
    pbar = stash[5].float()
    assert torch.all(pbar >= 0) and torch.allclose(pbar.sum(-1), torch.ones(3, 8, 65), atol=0.05)


def _jax_vjp(tree, x, tgt, n_head):
    """y and the gradients of sum((y - tgt)^2) through vitiq's Pallas stack."""
    def fwd(params, xx):
        return jflt.fused_train_layer_stack(xx, [params], n_head, 0.0, 7)

    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(fwd, tree, x)
        gy = 2.0 * (y.astype(jnp.float32) - tgt)
        gp, gx = vjp(gy.astype(y.dtype))
    return np.asarray(y.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32)), gp


def _port_grads(layer, x, tgt, n_head, stash=True):
    xt = x.clone().requires_grad_(True)
    y = flt.fused_train_layer_stack(xt, [layer], n_head, 0.0, 7)
    assert ("Stash" in type(y.grad_fn).__name__) == stash  # the K4 autograd Function
    ((y.float() - tgt) ** 2).sum().backward()
    return y.detach().float().numpy(), xt.grad.float().numpy(), dict(layer.named_parameters())


def _cosine(a, b):
    a, b = (torch.from_numpy(np.array(t, dtype=np.float32)).reshape(-1) for t in (a, b))
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Lx,n_head,ffn,d", [
    pytest.param(2, 17, 4, 256, D, id="2-17-4-256"),
    pytest.param(2, 65, 8, 1024, D, id="2-65-8-1024"),
    # rawiq_best_mp's widths: d256, FFN 1024, 64 tokens, d_head 32
    pytest.param(1, 64, 8, 1024, 256, id="1-64-8-1024-d256"),
    # vit_tiny_2016's (d64, FFN 256, 17 tokens), and d_head 64 at an FFN
    # width that 64 divides and 128 does not
    pytest.param(2, 17, 4, 256, 64, id="2-17-4-256-d64"),
    pytest.param(1, 33, 2, 192, D, id="1-33-2-192"),
])
def test_plain_stash_matches_pallas_stash(dtype, B, Lx, n_head, ffn, d, monkeypatch):
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "1")
    tree, layer = _layer(1, n_head, ffn, d)
    rng = np.random.default_rng(B + Lx)
    x = rng.standard_normal((B, Lx, d)).astype(np.float32)
    tgt = rng.standard_normal((B, Lx, d)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want_y, want_dx, want_gp = _jax_vjp(tree, jnp.asarray(x, jdt), jnp.asarray(tgt), n_head)
    got_y, got_dx, got = _port_grads(layer, torch.from_numpy(x).to(tdt), torch.from_numpy(tgt),
                                     n_head)
    want = encoder_layer_state_dict(want_gp)
    assert set(want) == set(got)
    if dtype == "f32":
        np.testing.assert_allclose(got_y, want_y, atol=1e-4)
        np.testing.assert_allclose(got_dx, want_dx, atol=2e-3, rtol=1e-3)
        for name, g in want.items():
            np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), atol=2e-3, rtol=1e-3,
                                       err_msg=name)
        return
    atol, rtol = LAYER_TOL
    assert np.all(np.abs(got_y - want_y) <= atol + rtol * np.abs(want_y))
    assert _cosine(got_dx, want_dx) >= 0.999
    assert np.linalg.norm(got_dx - want_dx) <= 1e-2 * np.linalg.norm(want_dx)
    for name, g in want.items():
        mine = got[name].grad
        if name == "attention.w_k.bias":
            assert float(mine.abs().max()) < 0.05 and float(g.abs().max()) < 0.05
            continue
        assert _cosine(mine, g) >= 0.999, (name, _cosine(mine, g))
    monkeypatch.setenv("VITIQ_TRAIN_STASH", "0")
    _, k3_dx, _ = _port_grads(_layer(1, n_head, ffn, d)[1], torch.from_numpy(x).to(tdt),
                              torch.from_numpy(tgt), n_head, stash=False)
    assert np.all(np.abs(got_dx - k3_dx) <= atol + rtol * np.abs(k3_dx))


@pytest.mark.parametrize("drop", [0.0, 0.25])
def test_explicit_stash_backward_matches_autograd_of_plain_forward(drop):
    _, layer = _layer(2, 4, 256)
    ops = [t.detach().clone().requires_grad_(True) for t in flt.flat_weights(layer, torch.float32)]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 17, D)).astype(np.float32)).requires_grad_(True)
    tgt = torch.from_numpy(rng.standard_normal((2, 17, D)).astype(np.float32))
    y = flt.fused_train_layer_reference(x, ops, 4, drop, 11, 3)
    want = torch.autograd.grad(((y - tgt) ** 2).sum(), [x] + ops)
    plain = [o.detach() for o in ops]
    y_stash, stash = flt.fused_train_layer_stash_reference(x.detach(), plain, 4, drop, 11, 3)
    assert torch.equal(y_stash, y.detach())
    dx, grads = flt.fused_train_layer_stash_backward_reference(
        x.detach(), 2 * (y - tgt).detach(), stash, plain, 4, drop, 11, 3)
    for i, (got, ref) in enumerate(zip([dx] + grads, want)):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0, msg=f"gradient {i}")


def test_cpu_tensors_take_plain_stash_versions_without_counting():
    _, layer = _layer(4, 8, 256)
    ops = [t.detach() for t in flt.flat_weights(layer, torch.bfloat16)]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 9, D)).astype(np.float32))
    x = x.bfloat16()
    flt.reset_launches()
    y, stash = flt.fused_train_layer_fwd_stash(x, ops, 8, 0.1, 3, 1)
    want_y, want_stash = flt.fused_train_layer_stash_reference(x, ops, 8, 0.1, 3, 1)
    assert torch.equal(y, want_y) and all(torch.equal(a, b) for a, b in zip(stash, want_stash))
    dy = x.flip(0)
    dx, grads = flt.fused_train_layer_bwd_stash(x, dy, stash, ops, 8, 0.1, 3, 1)
    want_dx, want = flt.fused_train_layer_stash_backward_reference(x, dy, stash, ops, 8, 0.1, 3, 1)
    assert torch.equal(dx, want_dx) and all(torch.equal(a, b) for a, b in zip(grads, want))
    assert [g.dtype for g in grads] == [t.dtype for t in ops]
    assert not any(flt.launches.values())
    meta = torch.empty((1, 9, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flt.fused_train_layer_fwd_stash(meta, ops, 8, 0.1, 3, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flt.fused_train_layer_bwd_stash(meta, meta, stash, ops, 8, 0.1, 3, 1)


def _model(arm):
    if arm.startswith("rawiq"):  # seg-16 over 1024 samples: 65 tokens with CLS, Lp 80
        d = 256 if arm.startswith("rawiq_best") else 128
        cfg = ModelConfig(arm="rawiq", num_classes=5, d_model=d, n_head=8, n_layers=1,
                          ffn_hidden=128, segment_size=16, numerics="tpu",
                          use_cls_token=not arm.endswith("_mp"))  # mean-pool: 64, Lp 64
        src = np.random.default_rng(6).standard_normal((2, 2, 1024))
    else:  # patch 4 over [1, 32, 64]: 129 tokens with CLS, Lp 144
        cfg = ModelConfig(arm="vit", num_classes=5, d_model=128, n_head=8, n_layers=1,
                          ffn_hidden=128, numerics="tpu")
        src = np.random.default_rng(6).standard_normal((2, 1, 32, 64))
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(0)).train()
    return model, torch.from_numpy(src.astype(np.float32))


@pytest.mark.parametrize("arm,env,regime", [
    ("rawiq", None, "K4"),   # Lp 80: the stash, as vitiq trains it
    ("vit", None, "K3"),     # Lp 144: the recompute
    ("rawiq", "0", "K3"),    # VITIQ_TRAIN_STASH=0
    ("vit", "1", "K4"),      # VITIQ_TRAIN_STASH=1 (H * Lp = 1152 <= 1280)
    ("rawiq_best", None, "K3"),     # d256, Lp 80: the recompute, as vitiq trains it
    ("rawiq_best_mp", None, "K4"),  # d256, Lp 64, batch <= 4096: the stash
])
def test_training_dispatch_picks_the_regime(arm, env, regime, monkeypatch):
    calls = []
    for name in ("fused_train_layer_fwd", "fused_train_layer_bwd", "fused_train_layer_fwd_stash",
                 "fused_train_layer_bwd_stash"):
        real = getattr(flt, name)
        monkeypatch.setattr(flt, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    if env is not None:
        monkeypatch.setenv("VITIQ_TRAIN_STASH", env)
    model, src = _model(arm)
    model(src, seed=3).sum().backward()
    suffix = "_stash" if regime == "K4" else ""
    assert calls == [f"fused_train_layer_fwd{suffix}", f"fused_train_layer_bwd{suffix}"]
    assert all(p.grad is not None for p in model.parameters())
