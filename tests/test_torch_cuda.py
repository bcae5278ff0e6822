"""CUDA kernels of the port against their plain PyTorch version on the GPU.

Marked `cuda`; every test skips where no CUDA GPU is present. This file
imports no JAX, so on a GPU machine without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerance on bf16 outputs, |kernel - plain| <= atol + rtol |plain|: for one
layer on the same input (3e-2, 1.6e-2), about two bf16 ulps (2^-7 relative
each) plus an absolute floor near zero -- the two sum in different orders,
so bf16 roundings may flip; for a stack twice that (6e-2, 3.2e-2), since
each layer's flips feed the next one's input."""

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
