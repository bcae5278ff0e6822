"""CUDA kernels of the port against their plain PyTorch version on the GPU.

Marked `cuda`; every test skips where no CUDA GPU is present. This file
imports no JAX, so on a GPU machine without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerance on bf16 outputs, |kernel - plain| <= atol + rtol |plain|: for one
layer on the same input (3e-2, 1.6e-2), about two bf16 ulps (2^-7 relative
each) plus an absolute floor near zero -- the two sum in different orders,
so bf16 roundings may flip; for a stack twice that (6e-2, 3.2e-2), since
each layer's flips feed the next one's input. K3's backward: dx at the
one-layer tolerance, each weight, bias and LN gradient within 1% of the
plain version's in the L2 norm (sums over thousands of rows, taken in
another order and from operands whose bf16 roundings may flip)."""

import pytest
import torch

from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_encoder_layer as fel

D, H = 128, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _layers(n, ffn, device, n_head=H):
    gen = torch.Generator().manual_seed(0)
    return [EncoderLayer(D, ffn, n_head, device=device, generator=gen).eval()
            for _ in range(n)]


LAYER_TOL = (3e-2, 1.6e-2)
STACK_TOL = (6e-2, 3.2e-2)


def _assert_close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= atol + rtol * want.abs())


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head", [(129, 512, 8), (65, 1024, 8), (17, 128, 8),
                                           (1, 128, 8), (129, 512, 4), (40, 256, 4)])
def test_each_kernel_matches_plain_version_on_one_layer(cuda, Lx, ffn, n_head):
    ops = fel.layer_operands(_layers(1, ffn, cuda, n_head)[0], n_head)
    x = torch.randn((37, Lx, D), generator=torch.Generator().manual_seed(2))
    x = x.to(cuda, torch.bfloat16)
    full = fel.fused_encoder_layer(x, ops, n_head)
    cls = fel.fused_encoder_layer_cls(x, ops, n_head)
    torch.cuda.synchronize()
    _assert_close(full, fel.fused_layer_reference(x, ops, n_head, Lx), LAYER_TOL)
    _assert_close(cls, fel.fused_layer_reference(x, ops, n_head, 1), LAYER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn", [(129, 512), (65, 1024), (17, 128)])
@pytest.mark.parametrize("cls_only", [False, True])
def test_kernels_match_plain_version(cuda, Lx, ffn, cls_only):
    layers = _layers(3, ffn, cuda)
    x = torch.randn((37, Lx, D), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda, torch.bfloat16)
    got = fel.fused_encoder_layer_stack(x, layers, H, cls_only=cls_only)
    ops = [fel.layer_operands(layer, H) for layer in layers]
    want = fel.fused_encoder_layer_stack_reference(x, ops, H, cls_only=cls_only)
    torch.cuda.synchronize()
    _assert_close(got, want, STACK_TOL)


@pytest.mark.cuda
def test_each_launch_counts_once(cuda):
    layers = _layers(3, 512, cuda)
    x = torch.randn((4, 129, D)).to(cuda, torch.bfloat16)
    fel.reset_launches()
    fel.fused_encoder_layer_stack(x, layers, H, cls_only=True)
    torch.cuda.synchronize()
    assert fel.launches == {"fused_encoder_layer": 2, "fused_encoder_layer_cls": 1}


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    ops = fel.layer_operands(_layers(1, 512, cuda)[0], H)
    x = torch.randn((2, 9, D)).to(cuda)
    with pytest.raises(ValueError, match="bf16"):
        fel.fused_encoder_layer(x, ops, H)  # f32 activations
    with pytest.raises(ValueError, match="d_head"):
        fel.fused_encoder_layer(x.bfloat16(), ops, 2)  # d_head 64
    with pytest.raises(ValueError, match="operand 0"):
        fel.fused_encoder_layer_cls(x.bfloat16(), [ops[0].float()] + ops[1:], H)


# --------------------------------------------------------------------------
# K3: the fused training layer, forward and backward
# --------------------------------------------------------------------------

GRAD_REL = 1e-2  # ||kernel - plain||_2 <= GRAD_REL * ||plain||_2 for each gradient


def _train_operands(cuda, ffn, n_head):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    gen = torch.Generator().manual_seed(3)
    layer = EncoderLayer(D, ffn, n_head, generator=gen)
    with torch.no_grad():  # LayerNorm affine away from (1, 0)
        for norm in (layer.norm1, layer.norm2):
            norm.gamma.copy_(1.0 + 0.1 * torch.randn(D, generator=gen))
            norm.beta.copy_(0.1 * torch.randn(D, generator=gen))
    return [t.detach().contiguous() for t in flt.flat_weights(layer.to(cuda), torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lx", [1, 17, 129])
@pytest.mark.parametrize("n_head", [8, 4])  # d_head 16 and 32
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_train_kernels_match_plain_versions(cuda, Lx, n_head, drop):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, 256, n_head)
    gen = torch.Generator().manual_seed(Lx)
    x = torch.randn((37, Lx, D), generator=gen).to(cuda, torch.bfloat16)
    dy = (0.1 * torch.randn((37, Lx, D), generator=gen)).to(cuda, torch.bfloat16)
    y = flt.fused_train_layer_fwd(x, ops, n_head, drop, 99, 2)
    dx, grads = flt.fused_train_layer_bwd(x, dy, ops, n_head, drop, 99, 2)
    torch.cuda.synchronize()
    _assert_close(y, flt.fused_train_layer_reference(x, ops, n_head, drop, 99, 2), LAYER_TOL)
    want_dx, want = flt.fused_train_layer_backward_reference(x, dy, ops, n_head, drop, 99, 2)
    _assert_close(dx, want_dx, LAYER_TOL)
    for i, (got, ref) in enumerate(zip(grads, want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).norm()
        assert err <= GRAD_REL * ref.float().norm() + 1e-6, (i, float(err))


@pytest.mark.cuda
def test_train_launch_counts_and_autograd(cuda):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    layers = [EncoderLayer(D, 512, H).to(cuda).train() for _ in range(2)]
    x = torch.randn((4, 129, D)).to(cuda, torch.bfloat16).requires_grad_(True)
    flt.reset_launches()
    y = flt.fused_train_layer_stack(x, layers, H, 0.1, 5)
    assert flt.launches == {"fused_train_layer_fwd": 2, "fused_train_layer_bwd": 0}
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert flt.launches == {"fused_train_layer_fwd": 2, "fused_train_layer_bwd": 2}
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    for layer in layers:
        for p in layer.parameters():
            assert p.grad is not None and p.grad.dtype == torch.float32


@pytest.mark.cuda
def test_train_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, 256, H)
    x = torch.randn((2, 9, D)).to(cuda)
    with pytest.raises(ValueError, match="bf16"):
        flt.fused_train_layer_fwd(x, ops, H, 0.1, 1, 0)  # f32 activations
    with pytest.raises(ValueError, match="d_head"):
        flt.fused_train_layer_fwd(x.bfloat16(), ops, 2, 0.1, 1, 0)  # d_head 64
    long = torch.zeros((1, 1025, D), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        flt.fused_train_layer_bwd(long, long, ops, H, 0.1, 1, 0)  # conv1d length
    with pytest.raises(ValueError, match="operand 6"):
        flt.fused_train_layer_bwd(x.bfloat16(), x.bfloat16(), ops[:6] + [ops[6].float()]
                                  + ops[7:], H, 0.1, 1, 0)


@pytest.mark.cuda
def test_train_backward_is_the_same_bits_run_to_run(cuda):
    """The weight gradients are reduced in a fixed order, without atomics."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, 512, H)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((64, 129, D), generator=gen).to(cuda, torch.bfloat16)
    dy = torch.randn((64, 129, D), generator=gen).to(cuda, torch.bfloat16)
    first = flt.fused_train_layer_bwd(x, dy, ops, H, 0.1, 4, 1)
    second = flt.fused_train_layer_bwd(x, dy, ops, H, 0.1, 4, 1)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))
