"""K5, the standalone packed attention: the port's plain versions and its
autograd function against vitiq's Pallas kernel (`_pallas_attention`) and
its custom VJP (`_fused_attention_tpu`), both run in Pallas interpret mode on
numpy-seeded inputs, B <= 4, L 1/17/130, d_head 16 and 32; and the kernel's
exact forward function (`attention_onepass_plain`) against the same kernel.

Tolerances: f32 at 1e-5 (one algorithm, f32 roundings apart). bf16 forward
at |port - vitiq| <= 3e-2 + 1.6e-2 |vitiq|: the TPU kernel rounds bf16(exp2(s))
with no max subtracted, the port bf16(exp2(s - max)), so a probability may
round to a neighbouring bf16 value, and the output's own bf16 rounding may
then flip (about two bf16 ulps plus a floor near zero). bf16 gradients: the
two backwards round P and dS to bf16 at different scales and in another
order, so each gradient is held by its L2 distance (1% of vitiq's norm) and
its cosine (>= 0.999). The CUDA kernels are held to these plain versions on
the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitiq.ops.pallas import flash_attention as jfa
from vitiq_torch.ops.cuda import flash_attention as fa
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.numerics import REFERENCE, TPU

D = 64
BF16_TOL = dict(atol=3e-2, rtol=1.6e-2)


def _inputs(B, L, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(4)]


def _torch(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("L", [1, 17, 130])
@pytest.mark.parametrize("n_head", [4, 2])  # d_head 16 and 32
def test_plain_forward_matches_pallas_kernel(L, n_head):
    q, k, v, _ = _inputs(3, L, L + n_head)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._pallas_attention(*map(jnp.asarray, (q, k, v)), n_head))
        want16 = np.asarray(jfa._pallas_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), n_head).astype(jnp.float32))
    got = fa.attention_reference(_torch(q), _torch(k), _torch(v), n_head)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got16 = fa.attention_reference(*(_torch(a, torch.bfloat16) for a in (q, k, v)), n_head)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, **BF16_TOL)


@pytest.mark.parametrize("L", [17, 130])
@pytest.mark.parametrize("n_head", [4, 2])  # d_head 16 and 32
def test_onepass_plain_forward_matches_pallas_kernel(L, n_head):
    """K5-fwd's kernel function, one pass over 64-key tiles with p rounded
    at the running max and the f32 denominator summed from the unrounded p
    (at 130 tokens the last tile holds 2 keys): f32 within 1e-5 of vitiq's
    kernel, bf16 within BF16_TOL (vitiq rounds bf16(exp2(s)) with no max)."""
    q, k, v, _ = _inputs(3, L, 40 + L + n_head)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._pallas_attention(*map(jnp.asarray, (q, k, v)), n_head))
        want16 = np.asarray(jfa._pallas_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), n_head).astype(jnp.float32))
    got, _ = fa.attention_onepass_plain(_torch(q), _torch(k), _torch(v), n_head)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got16, lse16 = fa.attention_onepass_plain(*(_torch(a, torch.bfloat16) for a in (q, k, v)),
                                              n_head)
    assert got16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    np.testing.assert_allclose(got16.float().numpy(), want16, **BF16_TOL)


@pytest.mark.parametrize("L", [1, 17, 130])
def test_onepass_plain_is_the_plain_forward_in_f32(L):
    """In f32 every rounding of the one-pass version is the identity: its out
    and lse are `attention_plain`'s within 1e-5, at d_head 16 and 32."""
    q, k, v, _ = _inputs(2, L, 50 + L)
    for n_head in (4, 2):
        out, lse = fa.attention_onepass_plain(_torch(q), _torch(k), _torch(v), n_head)
        want, want_lse = fa.attention_plain(_torch(q), _torch(k), _torch(v), n_head)
        torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)


def test_ring_shared_memory_fits_at_any_length():
    """The kernels stream k and v (or q and dout) through a ring of
    RING_STAGES 64-row tiles, so their shared memory does not grow with L:
    at d_head 16, 32 and 64 it fits Hopper's budget, where K1's core, which
    holds a frame-head's whole k and v, does not at 4097 tokens. The .cu's
    `ring_smem_bytes` is held to this repeat on the card
    (tests/test_torch_cuda.py)."""
    for dh in fa.SUPPORTED_D_HEAD:
        ring = fa.ring_smem_bytes(dh)
        assert ring == 1024 + fa.RING_STAGES * (2 * fa.TILE * dh * 2 + 16)
        assert ring <= fel.MAX_SHARED_MEMORY
        assert fel.core_smem_bytes(4097, dh) > ring
    assert fel.core_smem_bytes(4097, 64) > fel.MAX_SHARED_MEMORY


def _vitiq_grads(q, k, v, g, n_head, dtype):
    def loss(q_, k_, v_):
        with pltpu.force_tpu_interpret_mode():
            out = jfa._fused_attention_tpu(q_, k_, v_, n_head)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g, dtype).astype(jnp.float32))

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return [np.asarray(t.astype(jnp.float32)) for t in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, g, n_head, dtype):
    qt, kt, vt = (_torch(a, dtype, grad=True) for a in (q, k, v))
    out = fa.FusedAttention.apply(qt, kt, vt, n_head)
    assert out.dtype == dtype
    out.backward(_torch(g, dtype))
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("L", [1, 17, 130])
@pytest.mark.parametrize("n_head", [4, 2])
def test_gradients_match_pallas_custom_vjp_in_f32(L, n_head):
    q, k, v, g = _inputs(2, L, 10 + L)
    for got, want in zip(_port_grads(q, k, v, g, n_head, torch.float32),
                         _vitiq_grads(q, k, v, g, n_head, jnp.float32)):
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("L", [17, 130])
@pytest.mark.parametrize("n_head", [4, 2])
def test_gradients_match_pallas_custom_vjp_in_bf16(L, n_head):
    q, k, v, g = _inputs(4, L, 20 + L)
    for got, want in zip(_port_grads(q, k, v, g, n_head, torch.bfloat16),
                         _vitiq_grads(q, k, v, g, n_head, jnp.bfloat16)):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        cos = float(np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert rel <= 1e-2 and cos >= 0.999, (rel, cos)


def test_plain_backward_is_autograd_of_the_plain_forward_in_f32():
    q, k, v, g = _inputs(3, 33, 5)
    qt, kt, vt = (_torch(a, grad=True) for a in (q, k, v))
    out = fa.attention_reference(qt, kt, vt, 4)
    want = torch.autograd.grad(out, (qt, kt, vt), _torch(g))
    got = fa.attention_bwd_reference(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                     _torch(g), 4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_plain_versions_equal_unchunked(dtype, monkeypatch):
    """B=5 under a budget of 20000 bytes at H=4, L=17 (8092 bytes a frame):
    chunks of 2 frames and a remainder of 1. Equal up to the f32 rounding of
    the CPU's batched products, whose summation order may depend on the
    batch (1e-6; in bf16 that may flip one rounding: one ulp, 2^-7
    relative)."""
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else dict(atol=1e-2, rtol=8e-3)
    q, k, v, g = (_torch(a, dtype) for a in _inputs(5, 17, 6))
    out, lse = fa.attention_plain(q, k, v, 4)
    whole = fa.attention_bwd_reference(q, k, v, out, g, 4)
    monkeypatch.setenv("VITIQ_ATTN_BWD_BUDGET", "20000")
    assert fa.attention_chunk(5, 4, 17) == 2
    out2, lse2 = fa.attention_plain(q, k, v, 4)
    chunked = fa.attention_bwd_reference(q, k, v, out, g, 4)
    torch.testing.assert_close(out2, out, **tol)
    torch.testing.assert_close(lse2, lse, atol=1e-6, rtol=1e-6)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, **tol)


def test_mask_path_is_the_split_head_path():
    """With a mask, fused_attention takes vitiq's split-head path (f32, 1e-5
    against vitiq's `fused_attention` with the same mask); an all-ones mask
    gives the unmasked result."""
    q, k, v, _ = _inputs(2, 12, 7)
    mask = np.ones((2, 1, 12, 12), np.float32)
    mask[..., -3:] = 0
    want = np.asarray(jfa.fused_attention(*map(jnp.asarray, (q, k, v)), 4,
                                          mask=jnp.asarray(mask)))
    got = fa.fused_attention(_torch(q), _torch(k), _torch(v), 4, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ones = fa.fused_attention(_torch(q), _torch(k), _torch(v), 4,
                              mask=torch.ones((2, 1, 12, 12)))
    plain = fa.fused_attention(_torch(q), _torch(k), _torch(v), 4)
    torch.testing.assert_close(ones, plain, atol=1e-5, rtol=0)


def test_policy_casts_to_the_compute_dtype():
    q, k, v, _ = _inputs(2, 9, 8)
    out = fa.fused_attention(_torch(q), _torch(k), _torch(v), 4, policy=TPU)
    assert out.dtype == torch.bfloat16
    want = fa.attention_reference(*(_torch(a, torch.bfloat16) for a in (q, k, v)), 4)
    assert torch.equal(out, want)
    assert fa.fused_attention(_torch(q), _torch(k), _torch(v), 4,
                              policy=REFERENCE).dtype == torch.float32
    assert fa.fused_attention.packed_layout


def test_wrappers_take_plain_versions_on_cpu_only():
    q, k, v, g = (_torch(a, torch.bfloat16) for a in _inputs(2, 9, 9))
    fa.reset_launches()
    out, lse = fa.fused_attention_fwd(q, k, v, 4)
    assert torch.equal(out, fa.attention_reference(q, k, v, 4))
    assert lse.shape == (2, 4, 9) and lse.dtype == torch.float32
    grads = fa.fused_attention_bwd(q, k, v, out, lse, g, 4)
    for a, b in zip(grads, fa.attention_bwd_reference(q, k, v, out, g, 4)):
        assert torch.equal(a, b)
    assert fa.launches == {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    meta = torch.empty((2, 9, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.fused_attention_fwd(meta, meta, meta, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.fused_attention_bwd(meta, meta, meta, meta, meta, meta, 4)
