"""CUDA kernels of the port against their plain PyTorch version on the GPU.

Marked `cuda`; every test skips where no CUDA GPU is present. This file
imports no JAX, so on a GPU machine without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerance on bf16 outputs, |kernel - plain| <= atol + rtol |plain|: for one
layer on the same input (3e-2, 1.6e-2), about two bf16 ulps (2^-7 relative
each) plus an absolute floor near zero -- the two sum in different orders,
so bf16 roundings may flip; for a stack twice that (6e-2, 3.2e-2), since
each layer's flips feed the next one's input. K3's and K4's backward: dx at
the one-layer tolerance, each weight, bias and LN gradient within 1% of the
plain version's in the L2 norm (sums over thousands of rows, taken in
another order and from operands whose bf16 roundings may flip). K4's stash:
its bf16 tensors at the one-layer tolerance, its f32 1/std within 1e-3
relative (f32 statistics summed in another order).

The kernels are held at every width they take: K1, K2, K6, K3 and K4 at
d_model 64, 128 and 256 and d_head 16, 32 and 64 (K3 and K4 also at FFN
widths that 64 divides and 128 does not, where their GEMMs take 64-wide
tiles). The configurations of the JAX package that need the wider kernels
(`rawiq_best`, `rawiq_best_mp`, `vit_tiny_2016`, `vit_tpu_production`) are
served, evaluated in float and int8, and trained for an epoch under `tpu`
numerics through K3 or K4, with the launches of each kernel counted.

K6's four s8 GEMM stages (s8 wgmma) are held alone, each in the form the
layer launches it, to `s8_stage_reference`: the bias and ReLU stages bit
for bit, the LayerNorm stages by K6's layer tolerance with their int8
levels and scales bit for bit `levels_of` their own bf16 output; 30
launches of each stage and of the layer give the same bits, and every s8
instance runs IGMMA without a spill.

K7 (the int8-attention layer) is held as K6 is, by relative L2 and a max in
quantization steps (one layer 1e-3 and 2 steps, which K1's bf16 core in
its place does not pass; a stack with the K2 tail 2e-2 and 4 steps: its
core repeats the plain version's roundings, but a
bf16 flip in q or k from the QKV GEMM can move a level); its core's s32
score and P [v | 1] products equal the plain version's bit for bit on the
same quantized operands, over 30 launches with the same bits, and its s8
wgmma kernel runs IGMMA and its one-tile mma.sync kernel IMMA, neither with
a spill. `run_training` trains on the card
through K3, validates through K7 under VITIQ_ATTN_INT8=1, and resumes.

K2 forms no K or V: its pooling kernel (cls_pool_kernel) is held to its
plain version (1% L2 and the one-layer tolerance, 30 launches the same
bits, mma.sync without a spill), and the layer to its own plain version and
to the plain layer for the CLS row (the one-layer tolerance).

The probes (`vitiq_torch/probes/`, `csrc/probes.cu`): each P1 mask-op
variant against its plain version (elementwise bit for bit, exp2 within 2
ulp, the mm_* products within 1e-5 of the sum of |products|), P2's kernel
against ``in + 1`` bit for bit in each arm's shape, and P3 (K1 without its
exp) at every width and at 1025 tokens: it divides by a sum of scores that
can sit near zero, so no element-wise gate holds it. Its layer is held
within 1e-2 relative L2 over the rows whose sums of scores are not small
beside their magnitudes (`exp.check_layer`; over all rows too at d_model
64/128 and 129 tokens or fewer), its attention core alone within 1e-2 in
each such row on the same qkv (`exp.check_core`). K1's attention kernels
keep the registers they had before P3's flag was added beside them.

K5 (the standalone attention) is held at L 1 to 4097 (past the k and v
that K1's core keeps resident) and d_head 16/32/64 to both its plain
versions: the two-pass `attention_plain` and the kernel's exact function,
`attention_onepass_plain` (out within 1% L2, lse within 1e-3); its three
kernels run wgmma (HGMMA in their SASS) without a spill, and their TMA rings
give the same bits over 30 launches.

The DSP front-end: timing_scan_kernel (`csrc/timing.cu`, the Gardner and
Mueller-Mueller loops) equals its plain loop (`ops/cuda/timing.py`) bit for
bit, both loops, full and hybrid (64 steps from p0), sps 2 and 4, over 30
launches (it rounds each product and sum on its own, as the loop's tensor
operations do), and does not spill; the hybrid on the card is within 1e-3
of a sample of the host's; the matched filter on the card is within 1e-5 of
the signal's peak from a float64 convolution (TF32 would show about 1e-3);
SPS serving launches the kernel once a request for each loop.

The prefetching feed (`vitiq_torch/data/pipeline.py`): 30 batches copied to
the card through pinned buffers on a side stream arrive byte for byte (and
items of one array come back as one tensor), and
keep their bits while the consumer sleeps between batches on the host (the
worker fills the queue and waits for each pinned buffer's copy before it
refills it) and lags on the device (each batch read after a sleep queued on
the consumer's stream, after the consumer has let go of it: `record_stream`
keeps its memory from the next copies).

Device-scan training (`train/loop.make_train_scan_step`): K=4 train steps
of a tiny model (K4 under `tpu`, the plain layers under `reference`) at
dropout 0.1, captured once and replayed, equal eager steps bit for bit
(parameters, moments, losses, the step counter), the replays launching no
wrapper; a replay after `set_learning_rate` takes the new rate with no new
capture; K3 and K4 read the seed from device memory (a seed tensor gives
the int seed's bits; a graph captured with one seed and replayed after the
tensor is filled with another gives the other's bits); a capture that fails
raises, with no eager fallback; the bias corrections computed on the card
equal the host's."""

import math
import subprocess
from pathlib import Path

import time

import numpy as np
import pytest
import torch

from vitiq_torch.data.pipeline import device_prefetch
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.probes import exp as p3
from vitiq_torch.probes import mask_ops, refcost

D, H = 128, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _layers(n, ffn, device, n_head=H, d=D):
    gen = torch.Generator().manual_seed(0)
    return [EncoderLayer(d, ffn, n_head, device=device, generator=gen).eval()
            for _ in range(n)]


LAYER_TOL = (3e-2, 1.6e-2)
STACK_TOL = (6e-2, 3.2e-2)


def _assert_close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert torch.all((got - want).abs() <= atol + rtol * want.abs())


def _p(*values, d=D):
    """A case of the parametrized tests; the d_model 128 ones keep their
    ids, the others name their width."""
    name = "-".join(map(str, values))
    return pytest.param(*values, d, id=name if d == D else f"{name}-d{d}")


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,d", [
    _p(129, 512, 8), _p(65, 1024, 8), _p(17, 128, 8), _p(1, 128, 8), _p(129, 512, 4),
    _p(40, 256, 4),
    _p(65, 1024, 8, d=256), _p(65, 1024, 16, d=256), _p(1, 1024, 8, d=256),  # rawiq_best
    _p(17, 256, 4, d=64), _p(40, 256, 2, d=64),  # vit_tiny_2016 (d_head 16), d_head 32
    _p(129, 512, 2), _p(848, 256, 2)])  # d_head 64 (vit_tpu_production); its longest L
def test_each_kernel_matches_plain_version_on_one_layer(cuda, Lx, ffn, n_head, d):
    assert fel.fused_infer_supported(Lx, d, ffn, n_head)
    ops = fel.layer_operands(_layers(1, ffn, cuda, n_head, d)[0], n_head)
    x = torch.randn((37 if Lx < 800 else 5, Lx, d), generator=torch.Generator().manual_seed(2))
    x = x.to(cuda, torch.bfloat16)
    full = fel.fused_encoder_layer(x, ops, n_head)
    cls = fel.fused_encoder_layer_cls(x, fel.cls_operands(ops, n_head), n_head)
    torch.cuda.synchronize()
    _assert_close(full, fel.fused_layer_reference(x, ops, n_head, Lx), LAYER_TOL)
    _assert_close(cls, fel.fused_layer_reference(x, ops, n_head, 1), LAYER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,d", [pytest.param(129, 512, D, id="129-512"),
                                      pytest.param(65, 1024, D, id="65-1024"),
                                      pytest.param(17, 128, D, id="17-128"),
                                      pytest.param(65, 1024, 256, id="65-1024-d256")])
@pytest.mark.parametrize("cls_only", [False, True])
def test_kernels_match_plain_version(cuda, Lx, ffn, d, cls_only):
    layers = _layers(3, ffn, cuda, d=d)
    x = torch.randn((37, Lx, d), generator=torch.Generator().manual_seed(1))
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
    assert fel.kernel_launches() == {"cls_pool_kernel": 1, "attention_int8_kernel": 0,
                                     "attention_int8_sync_kernel": 0}


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    ops = fel.layer_operands(_layers(1, 512, cuda)[0], H)
    x = torch.randn((2, 9, D)).to(cuda)
    with pytest.raises(ValueError, match="bf16"):
        fel.fused_encoder_layer(x, ops, H)  # f32 activations
    with pytest.raises(ValueError, match="d_head"):
        fel.fused_encoder_layer(x.bfloat16(), ops, 1)  # d_head 128
    with pytest.raises(ValueError, match="shared-memory"):  # d_head 64 past ~850 tokens
        fel.fused_encoder_layer(torch.zeros((1, 1025, D), dtype=torch.bfloat16, device=cuda),
                                ops, 2)
    cls = fel.cls_operands(ops, H)
    with pytest.raises(ValueError, match="operand 0"):
        fel.fused_encoder_layer_cls(x.bfloat16(), [cls[0].float()] + cls[1:], H)
    with pytest.raises(ValueError, match="15"):  # K2 takes its 15 operands only
        fel.fused_encoder_layer_cls(x.bfloat16(), ops, H)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs())) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1000, 77])  # not multiples of the 64-row tile
@pytest.mark.parametrize("K", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("N,epi", [(64, "bias"), (128, "relu"), (192, "bias"), (256, "relu"),
                                   (384, "bias"), (768, "relu"), (1024, "bias"), (64, "ln"),
                                   (128, "ln"), (256, "ln")])
def test_gemm_stage_is_within_one_ulp_of_an_f32_product(cuda, M, K, N, epi):
    """One of K1's wgmma GEMM stages (W resident for K <= 256, streamed
    above) against an f32 product of the same bf16 operands with the same
    epilogue: within one bf16 ulp of the output (the ulp of max(|out|,
    rms(out) / 64): the two f32 sums run in other orders, so an output near
    zero may differ by more than its own ulp)."""
    gen = torch.Generator().manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn((K, N), generator=gen) / math.sqrt(K)).to(cuda, torch.bfloat16)
    bias = (0.1 * torch.randn(N, generator=gen)).to(cuda)
    ln = {}
    if epi == "ln":
        ln = {"res": torch.randn((M, N), generator=gen).to(cuda, torch.bfloat16),
              "gamma": (1 + 0.1 * torch.randn(N, generator=gen)).to(cuda),
              "beta": (0.1 * torch.randn(N, generator=gen)).to(cuda)}
    fel.reset_launches()
    got = fel.gemm_stage(a, w, bias, relu=epi == "relu", **ln)
    want = fel.gemm_stage_reference(a, w, bias, relu=epi == "relu", **ln).float()
    torch.cuda.synchronize()
    assert fel.stage_launches["gemm_stage"] == 1
    floor = want.square().mean().sqrt() / 64
    assert torch.all((got.float() - want).abs() <= _bf16_ulp(torch.maximum(want.abs(), floor)))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,epi", [(128, 384, "bias"), (256, 1024, "relu"), (128, 128, "ln"),
                                     (256, 64, "ln")])
def test_gemm_stage_gives_the_same_bits_over_repeated_launches(cuda, K, N, epi):
    """Stages with W resident (K <= 256) over ~100K rows, so each warpgroup
    of a block refills its ring of A tiles many times: 30 launches on the
    same operands give the same bits as the first and stay within one ulp of
    the f32 product (a slot refilled before every warp of its warpgroup had
    read it would move some rows)."""
    M = 100_003
    gen = torch.Generator().manual_seed(K + N)
    a = torch.randn((M, K), generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn((K, N), generator=gen) / math.sqrt(K)).to(cuda, torch.bfloat16)
    bias = (0.1 * torch.randn(N, generator=gen)).to(cuda)
    kw = {"relu": epi == "relu"}
    if epi == "ln":
        kw = {"res": torch.randn((M, N), generator=gen).to(cuda, torch.bfloat16),
              "gamma": (1 + 0.1 * torch.randn(N, generator=gen)).to(cuda),
              "beta": (0.1 * torch.randn(N, generator=gen)).to(cuda)}
    first = fel.gemm_stage(a, w, bias, **kw)
    want = fel.gemm_stage_reference(a, w, bias, **kw).float()
    floor = want.square().mean().sqrt() / 64
    assert torch.all((first.float() - want).abs() <= _bf16_ulp(torch.maximum(want.abs(), floor)))
    for _ in range(30):
        assert torch.equal(fel.gemm_stage(a, w, bias, **kw), first)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,n_head,d", [
    (1, 8, 128), (17, 8, 128), (65, 8, 128), (129, 8, 128), (1025, 8, 128), (64, 8, 128),
    (200, 4, 128), (65, 8, 256), (129, 4, 64), (129, 2, 128), (848, 2, 128), (1600, 4, 128),
    (2896, 8, 128)])
def test_attention_core_matches_its_one_pass_plain_version(cuda, Lx, n_head, d):
    """K1's wgmma core alone against `attention_onepass_reference` on the same
    qkv, at d_head 16, 32, 64, ragged L (one key in the last tile at 65, 129
    and 1025) and the longest L each d_head takes: within 1% in the L2 norm
    and elementwise within 0.08 rms + 1.6e-2 |plain| (K5's forward gate: the
    output's rms falls as 1/sqrt(L))."""
    assert fel.fused_infer_supported(Lx, d, 128, n_head)
    B = 3 if Lx > 800 else 17
    qkv = torch.randn((B, Lx, 3 * d), generator=torch.Generator().manual_seed(Lx))
    qkv = qkv.to(cuda, torch.bfloat16)
    fel.reset_launches()
    got = fel.attention_core(qkv, n_head)
    want = fel.attention_onepass_reference(qkv, n_head).float()
    torch.cuda.synchronize()
    assert fel.stage_launches["attention_core"] == 1
    got = got.float()
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= 1e-2
    rms = want.square().mean().sqrt()
    assert torch.all((got - want).abs() <= 0.08 * rms + 1.6e-2 * want.abs())


# --------------------------------------------------------------------------
# K3: the fused training layer, forward and backward
# --------------------------------------------------------------------------

GRAD_REL = 1e-2  # ||kernel - plain||_2 <= GRAD_REL * ||plain||_2 for each gradient


def _train_operands(cuda, ffn, n_head, d=D):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    gen = torch.Generator().manual_seed(3)
    layer = EncoderLayer(d, ffn, n_head, generator=gen)
    with torch.no_grad():  # LayerNorm affine away from (1, 0)
        for norm in (layer.norm1, layer.norm2):
            norm.gamma.copy_(1.0 + 0.1 * torch.randn(d, generator=gen))
            norm.beta.copy_(0.1 * torch.randn(d, generator=gen))
    return [t.detach().contiguous() for t in flt.flat_weights(layer.to(cuda), torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,d", [  # d_head 16 and 32, + rawIQ, + rawiq_best
    _p(Lx, ffn, n_head) for Lx, ffn in ((1, 256), (17, 256), (129, 256), (65, 1024))
    for n_head in (8, 4)] + [_p(65, 1024, 8, d=256), _p(65, 1024, 16, d=256),
                             _p(17, 256, 8, d=256)]
    # d_head 64 (vit_tpu_production: L 129, Lp 144; its longest L 224), d_model 64
    # (vit_tiny_2016: d_head 16; d_head 64 at n_head 1), FFN widths 64 mod 128
    + [_p(129, 512, 2), _p(224, 256, 2), _p(17, 256, 4, d=64), _p(40, 192, 1, d=64),
       _p(65, 320, 8), _p(33, 192, 4, d=256)])
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_train_kernels_match_plain_versions(cuda, Lx, ffn, n_head, d, drop):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, ffn, n_head, d)
    gen = torch.Generator().manual_seed(Lx)
    x = torch.randn((37, Lx, d), generator=gen).to(cuda, torch.bfloat16)
    dy = (0.1 * torch.randn((37, Lx, d), generator=gen)).to(cuda, torch.bfloat16)
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
    assert flt.launches == {"fused_train_layer_fwd": 2, "fused_train_layer_bwd": 0,
                            "fused_train_layer_fwd_stash": 0, "fused_train_layer_bwd_stash": 0}
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert flt.launches == {"fused_train_layer_fwd": 2, "fused_train_layer_bwd": 2,
                            "fused_train_layer_fwd_stash": 0, "fused_train_layer_bwd_stash": 0}
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
        flt.fused_train_layer_fwd(x.bfloat16(), ops, 16, 0.1, 1, 0)  # d_head 8
    wide = torch.zeros((1, 225, D), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        flt.fused_train_layer_fwd(wide, ops, 2, 0.1, 1, 0)  # d_head 64 past L 224
    long = torch.zeros((1, 1025, D), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        flt.fused_train_layer_bwd(long, long, ops, H, 0.1, 1, 0)  # conv1d length
    with pytest.raises(ValueError, match="operand 6"):
        flt.fused_train_layer_bwd(x.bfloat16(), x.bfloat16(), ops[:6] + [ops[6].float()]
                                  + ops[7:], H, 0.1, 1, 0)


# frames of the 30-launch bit tests: ~100K rows, so that each warpgroup of a
# persistent GEMM stage refills its ring many times
RING_FRAMES = {129: 800, 65: 1600}


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,d", [pytest.param(129, 512, D, id="d128"),
                                      pytest.param(65, 1024, 256, id="d256")])
def test_train_backward_is_the_same_bits_run_to_run(cuda, Lx, ffn, d):
    """The weight gradients are reduced in a fixed order, without atomics,
    and the GEMM stages' rings release a slot before TMA refills it: 30
    launches give the same bits."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, ffn, H, d)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((RING_FRAMES[Lx], Lx, d), generator=gen).to(cuda, torch.bfloat16)
    dy = torch.randn((RING_FRAMES[Lx], Lx, d), generator=gen).to(cuda, torch.bfloat16)
    first = flt.fused_train_layer_bwd(x, dy, ops, H, 0.1, 4, 1)
    for _ in range(30):
        again = flt.fused_train_layer_bwd(x, dy, ops, H, 0.1, 4, 1)
        torch.cuda.synchronize()
        assert torch.equal(first[0], again[0])
        assert all(torch.equal(a, b) for a, b in zip(first[1], again[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,d", [pytest.param(129, 512, D, id="d128"),
                                      pytest.param(65, 1024, 256, id="d256")])
def test_train_forward_is_the_same_bits_run_to_run(cuda, Lx, ffn, d):
    """K3-fwd's GEMM stages (resident and streamed rings): 30 launches give
    the same bits."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, ffn, H, d)
    x = torch.randn((RING_FRAMES[Lx], Lx, d), generator=torch.Generator().manual_seed(10))
    x = x.to(cuda, torch.bfloat16)
    first = flt.fused_train_layer_fwd(x, ops, H, 0.1, 4, 1)
    for _ in range(30):
        again = flt.fused_train_layer_fwd(x, ops, H, 0.1, 4, 1)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


def _within_one_ulp(got, want):
    """Within one bf16 ulp of max(|plain|, rms(plain) / 64), as K1's stage."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    floor = want.square().mean().sqrt() / 64
    assert torch.all((got - want).abs() <= _bf16_ulp(torch.maximum(want.abs(), floor)))


def _within_rel(got, want, rel=1e-5):
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).norm() <= rel * want.norm(), float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("epi,M,K,N", [
    ("bias", 1000, 64, 192), ("bias", 77, 128, 384), ("bias", 1000, 256, 768),
    ("relu_drop", 1000, 128, 1024), ("relu_drop", 77, 64, 320), ("relu_drop", 1000, 256, 256),
    ("ln_fwd", 1000, 128, 128), ("ln_fwd", 77, 64, 64), ("ln_fwd", 1000, 1024, 128),
    ("ln_fwd", 1000, 256, 256), ("ln_fwd", 77, 1024, 256), ("ln_fwd", 1000, 320, 64),
    ("store", 1000, 64, 64), ("store", 77, 128, 128), ("store", 1000, 256, 256),
    ("dpre", 1000, 128, 1024), ("dpre", 77, 64, 192), ("dpre", 1000, 256, 1024),
    ("ln_bwd", 1000, 1024, 256), ("ln_bwd", 77, 512, 128), ("ln_bwd", 1000, 192, 64),
    ("ln_bwd", 1000, 256, 128), ("ln_bwd", 77, 320, 256),
    # M = 64 mod 128: a streamed stage's last tile leaves one warpgroup no row
    ("ln_bwd", 1088, 1024, 256), ("ln_bwd", 1088, 512, 128), ("ln_fwd", 1088, 512, 64),
    ("res_out", 1000, 192, 64), ("res_out", 77, 384, 128), ("res_out", 1000, 768, 256),
    ("partial", 64, 1000, 192), ("partial", 256, 4133, 1024), ("partial", 1024, 2000, 256),
    ("partial", 128, 777, 128)])
def test_train_stage_is_within_one_ulp_of_its_plain_version(cuda, epi, M, K, N):
    """Each of K3/K4's GEMM stages alone (each epilogue; the input
    gradients' B = W^T and the weight gradients' A = act^T; ragged M; W
    resident and streamed) against `train_gemm_plain` on the same operands:
    its bf16 and f32 rows within one bf16 ulp (LN's 1/std too), its column
    sums and split-K partials within 1e-5 in the L2 norm (f32 sums in
    another order)."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    a, b, kw = flt.random_stage_operands(epi, M, K, N, 65, torch.Generator().manual_seed(M + K + N),
                                         cuda)
    splits = 3 if epi == "partial" else 1
    flt.reset_launches()
    got = flt.train_gemm(a, b, epi, splits=splits, **kw)
    want = flt.train_gemm_plain(a, b, epi, splits=splits, **kw)
    torch.cuda.synchronize()
    assert flt.stage_launches["train_gemm"] == 1
    if epi == "partial":
        _within_rel(got, want)
    elif epi == "ln_fwd":
        for g, w in zip(got, want):
            _within_one_ulp(g, w)
    elif epi == "dpre":
        _within_one_ulp(got[0], want[0])
        _within_rel(got[1], want[1])
    elif epi == "ln_bwd":
        _within_one_ulp(got[0], want[0])
        _within_one_ulp(got[1], want[1])
        for g, w in zip(got[2], want[2]):
            _within_rel(g, w)
    else:
        _within_one_ulp(got, want)


@pytest.mark.cuda
def test_train_stage_writes_xh_in_bf16_for_the_stash(cuda):
    """K4-fwd's LN stages write xh in bf16 (the stash) from the same
    epilogue: within one bf16 ulp of the plain f32 xh."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    a, b, kw = flt.random_stage_operands("ln_fwd", 1000, 512, 128, 65,
                                         torch.Generator().manual_seed(3), cuda)
    got = flt.train_gemm(a, b, "ln_fwd", xh_bf16=True, **kw)
    want = flt.train_gemm_plain(a, b, "ln_fwd", **kw)
    torch.cuda.synchronize()
    assert got[1].dtype == torch.bfloat16
    for g, w in zip(got, want):
        _within_one_ulp(g, w)


@pytest.mark.cuda
def test_train_stage_wrapper_raises_on_what_the_library_does_not_take(cuda):
    """A stage the library has no instance for (the QKV stage streams W only
    past K = 256, which no layer asks of it) fails in the C entry, and the
    wrapper raises; shapes it cannot tile raise before any launch."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    gen = torch.Generator().manual_seed(1)
    a, b, kw = flt.random_stage_operands("bias", 128, 512, 128, 65, gen, cuda)
    with pytest.raises(RuntimeError, match="vitiq_train_gemm_bf16 failed"):
        flt.train_gemm(a, b, "bias", **kw)
    a, b, kw = flt.random_stage_operands("ln_fwd", 128, 128, 192, 65, gen, cuda)
    with pytest.raises(ValueError, match="LayerNorm rows"):
        flt.train_gemm(a, b, "ln_fwd", **kw)


@pytest.mark.cuda
def test_train_stages_run_wgmma_and_do_not_spill(cuda):
    """Every instance of K3/K4's GEMM stage (train_gemm_kernel) and of K1's
    (gemm_wgmma_kernel): no spill in the build's `ptxas -v` report, HGMMA in
    its SASS (cuobjdump, beside nvcc)."""
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.build())], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    for stem, kernel, least in (("fused_layer_train", "train_gemm_kernel", 33),
                                ("fused_encoder_layer", "gemm_wgmma_kernel", 13)):
        entries = {n: v for n, v in _build.ptxas_entries(_build.ptxas_report(stem)).items()
                   if kernel in n}
        assert len(entries) >= least, (kernel, len(entries))
        for name, (regs, stores, loads) in entries.items():
            assert regs > 0 and stores == loads == 0, (name, regs, stores, loads)
            # the template arguments <int, int, bool> name the instance
            tag = kernel + name.split(kernel, 1)[1].split("EE", 1)[0]
            body = [b for n, b in bodies.items() if tag + "E" in n]
            assert len(body) == 1 and "HGMMA" in body[0], (name, len(body))


# --------------------------------------------------------------------------
# K4: the stash regime of the fused training layer, forward and backward
# --------------------------------------------------------------------------

STASH_NAMES = ("attn", "xh1", "xh2", "r1", "r2", "pbar")


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,d", [  # d_head 16 and 32, + rawiq_best_mp
    _p(Lx, ffn, n_head) for Lx, ffn in ((17, 256), (65, 1024), (80, 256))
    for n_head in (8, 4)] + [_p(64, 1024, 8, d=256), _p(64, 1024, 16, d=256)]
    # d_head 64 (the rawIQ flagship at n_head 2: Lp 80), d_model 64
    # (vit_tiny_2016: L 17, d_head 16), FFN widths 64 mod 128
    + [_p(65, 1024, 2), _p(17, 256, 4, d=64), _p(33, 192, 1, d=64), _p(65, 320, 8)])
@pytest.mark.parametrize("drop", [0.0, 0.2])
def test_stash_kernels_match_plain_versions(cuda, Lx, ffn, n_head, d, drop):
    """y and the bf16 stash tensors at the one-layer tolerance, 1/std (r1,
    r2, f32) at a relative 1e-3; dx and the gradients as K3's."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, ffn, n_head, d)
    gen = torch.Generator().manual_seed(Lx)
    x = torch.randn((37, Lx, d), generator=gen).to(cuda, torch.bfloat16)
    dy = (0.1 * torch.randn((37, Lx, d), generator=gen)).to(cuda, torch.bfloat16)
    y, stash = flt.fused_train_layer_fwd_stash(x, ops, n_head, drop, 99, 2)
    dx, grads = flt.fused_train_layer_bwd_stash(x, dy, stash, ops, n_head, drop, 99, 2)
    torch.cuda.synchronize()
    want_y, want_stash = flt.fused_train_layer_stash_reference(x, ops, n_head, drop, 99, 2)
    _assert_close(y, want_y, LAYER_TOL)
    for name, got, ref in zip(STASH_NAMES, stash, want_stash):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        _assert_close(got, ref, (0.0, 1e-3) if name in ("r1", "r2") else LAYER_TOL)
    # the backward on the plain stash, so that only K4-bwd is under test
    want_dx, want = flt.fused_train_layer_stash_backward_reference(x, dy, want_stash, ops, n_head,
                                                                   drop, 99, 2)
    dx_on_plain, grads_on_plain = flt.fused_train_layer_bwd_stash(x, dy, want_stash, ops, n_head,
                                                                  drop, 99, 2)
    torch.cuda.synchronize()
    for got_dx, got_grads in ((dx, grads), (dx_on_plain, grads_on_plain)):
        _assert_close(got_dx, want_dx, LAYER_TOL)
        for i, (got, ref) in enumerate(zip(got_grads, want)):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            err = (got.float() - ref.float()).norm()
            assert err <= GRAD_REL * ref.float().norm() + 1e-6, (i, float(err))


@pytest.mark.cuda
def test_stash_backward_is_the_same_bits_run_to_run(cuda):
    """As K3-bwd's: 30 launches of K4-bwd give the same bits."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, 1024, H)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((RING_FRAMES[65], 65, D), generator=gen).to(cuda, torch.bfloat16)
    dy = torch.randn((RING_FRAMES[65], 65, D), generator=gen).to(cuda, torch.bfloat16)
    _, stash = flt.fused_train_layer_fwd_stash(x, ops, H, 0.2, 4, 1)
    first = flt.fused_train_layer_bwd_stash(x, dy, stash, ops, H, 0.2, 4, 1)
    for _ in range(30):
        again = flt.fused_train_layer_bwd_stash(x, dy, stash, ops, H, 0.2, 4, 1)
        torch.cuda.synchronize()
        assert torch.equal(first[0], again[0])
        assert all(torch.equal(a, b) for a, b in zip(first[1], again[1]))


@pytest.mark.cuda
def test_stash_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, 256, H)
    x = torch.randn((2, 9, D)).to(cuda)
    with pytest.raises(ValueError, match="bf16"):
        flt.fused_train_layer_fwd_stash(x, ops, H, 0.1, 1, 0)  # f32 activations
    with pytest.raises(ValueError, match="stash gate"):  # H * Lp = 8 * 176 > 1280
        flt.fused_train_layer_fwd_stash(torch.zeros((1, 161, D), dtype=torch.bfloat16,
                                                    device=cuda), ops, H, 0.1, 1, 0)
    xb = x.bfloat16()
    _, stash = flt.fused_train_layer_fwd_stash(xb, ops, H, 0.1, 1, 0)
    with pytest.raises(ValueError, match="stash tensor 5"):  # pbar of the wrong shape
        flt.fused_train_layer_bwd_stash(xb, xb, stash[:5] + (stash[5][:, :4],), ops, H, 0.1, 1, 0)
    with pytest.raises(ValueError, match="stash tensor 3"):  # r1 in bf16
        flt.fused_train_layer_bwd_stash(xb, xb, stash[:3] + (stash[3].bfloat16(),) + stash[4:],
                                        ops, H, 0.1, 1, 0)
    with pytest.raises(ValueError, match="a stash of 6"):
        flt.fused_train_layer_bwd_stash(xb, xb, stash[:5], ops, H, 0.1, 1, 0)


@pytest.mark.cuda
def test_stash_launch_counts_and_autograd(cuda):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    layers = [EncoderLayer(D, 1024, H).to(cuda).train() for _ in range(2)]
    x = torch.randn((4, 65, D)).to(cuda, torch.bfloat16).requires_grad_(True)
    flt.reset_launches()
    y = flt.fused_train_layer_stack(x, layers, H, 0.2, 5)
    assert flt.launches == {"fused_train_layer_fwd": 0, "fused_train_layer_bwd": 0,
                            "fused_train_layer_fwd_stash": 2, "fused_train_layer_bwd_stash": 0}
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert flt.launches == {"fused_train_layer_fwd": 0, "fused_train_layer_bwd": 0,
                            "fused_train_layer_fwd_stash": 2, "fused_train_layer_bwd_stash": 2}
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    for layer in layers:
        for p in layer.parameters():
            assert p.grad is not None and p.grad.dtype == torch.float32


# K4's two attention passes alone (wg_attention_fwd, wg_attention_bwd_stash):
# the four shapes K4 trains (rawIQ, rawiq_best_mp, the rawIQ flagship at
# n_head 2, vit_tiny_2016), then the rest of what the stash gate admits:
# a dead key group (L 33), one token, Lp 80, and both passes' 64-key tiles
# past 80 keys (L 129 to the longest K4 takes at each d_head: 320, 432, 224)
STASH_PASS_SHAPES = [pytest.param(65, 128, 8, id="rawiq"),
                     pytest.param(64, 256, 8, id="rawiq_best_mp"),
                     pytest.param(65, 128, 2, id="rawiq-n_head2"),
                     pytest.param(17, 64, 4, id="vit_tiny_2016"),
                     pytest.param(33, 128, 4, id="L33"), pytest.param(1, 128, 8, id="L1"),
                     pytest.param(80, 128, 8, id="L80"), pytest.param(129, 64, 4, id="L129"),
                     pytest.param(200, 64, 2, id="L200-dh32"), pytest.param(224, 64, 1, id="L224"),
                     pytest.param(320, 64, 4, id="L320"), pytest.param(432, 64, 2, id="L432")]


def _stash_pass_inputs(cuda, B, Lx, d, n_head, seed):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, Lx, 3 * d), generator=gen).to(cuda, torch.bfloat16)
    dattn = (0.1 * torch.randn((B, Lx, d), generator=gen)).to(cuda, torch.bfloat16)
    attn, pbar = flt.stash_attention_fwd_plain(qkv, n_head)
    return qkv, dattn, attn, pbar


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,d,n_head", STASH_PASS_SHAPES)
def test_stash_attention_passes_match_plain_versions(cuda, Lx, d, n_head):
    """Each pass alone on the same inputs as its plain version: attn and
    dqkv at the one-layer tolerance, pbar within three bf16 ulps of |plain|
    (only a rounding of p or of p / l may flip: a flipped p moves p / l by
    under two ulps, its own rounding one more; its padding exactly 0),
    attn, pbar, dqkv and each frame's column sums within 1% in the L2 norm
    (the backward on the plain attn and pbar, so that it alone is under
    test). Then the backward on the forward kernel's attn and pbar: dqkv and
    the column sums within 1% of the plain chain's in the L2 norm."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    B = 37 if Lx <= 80 else 5
    qkv, dattn, attn_p, pbar_p = _stash_pass_inputs(cuda, B, Lx, d, n_head, Lx)
    flt.reset_launches()
    attn, pbar = flt.stash_attention_fwd(qkv, n_head)
    dqkv, part = flt.stash_attention_bwd(qkv, attn_p, dattn, pbar_p, n_head)
    torch.cuda.synchronize()
    assert flt.pass_launches == {"stash_attention_fwd": 1, "stash_attention_bwd": 1,
                                 "recompute_attention_fwd": 0, "recompute_attention_bwd": 0}
    assert pbar.shape == pbar_p.shape == (B, n_head, Lx, flt.stash_cols(Lx))
    assert not torch.count_nonzero(pbar[..., Lx:])
    _assert_close(attn, attn_p, LAYER_TOL)
    _assert_close(pbar, pbar_p, LAYER_TOL)
    ulps = ((pbar.float() - pbar_p.float()).abs()
            / _bf16_ulp(pbar_p.float().abs().clamp_min(2.0 ** -126))).max().item()
    assert ulps <= 3, ulps
    want_dqkv, want_part = flt.stash_attention_bwd_plain(qkv, attn_p, dattn, pbar_p, n_head)
    _assert_close(dqkv, want_dqkv, LAYER_TOL)
    dqkv_k, part_k = flt.stash_attention_bwd(qkv, attn, dattn, pbar, n_head)
    for got, want in ((attn, attn_p), (pbar, pbar_p), (dqkv, want_dqkv), (part, want_part),
                      (dqkv_k, want_dqkv), (part_k, want_part)):
        err = (got.float() - want.float()).norm()
        assert err <= GRAD_REL * want.float().norm() + 1e-6, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,d,n_head", [pytest.param(65, 128, 8, id="resident"),
                                         pytest.param(200, 64, 2, id="streamed")])
def test_stash_attention_passes_give_the_same_bits_over_repeated_launches(cuda, Lx, d, n_head):
    """30 launches of each pass give the first launch's bits (the TMA
    store of pbar, the in-place dS plane, the streamed pbar tiles)."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    qkv, dattn, attn_p, pbar_p = _stash_pass_inputs(cuda, 1600 if Lx <= 80 else 64, Lx, d,
                                                    n_head, 7)
    first = (*flt.stash_attention_fwd(qkv, n_head),
             *flt.stash_attention_bwd(qkv, attn_p, dattn, pbar_p, n_head))
    for _ in range(30):
        again = (*flt.stash_attention_fwd(qkv, n_head),
                 *flt.stash_attention_bwd(qkv, attn_p, dattn, pbar_p, n_head))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,d", [_p(129, 256, 4, d=64), _p(200, 192, 2, d=64),
                                             _p(224, 256, 1, d=64)])
def test_stash_kernels_at_long_L_match_plain_versions(cuda, Lx, ffn, n_head, d):
    """K4 where the stash gate admits L past 80 (VITIQ_TRAIN_STASH=1 routes
    such layers to it): both passes in 64-key tiles, held as
    test_stash_kernels_match_plain_versions holds K4."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    ops = _train_operands(cuda, ffn, n_head, d)
    gen = torch.Generator().manual_seed(Lx)
    x = torch.randn((6, Lx, d), generator=gen).to(cuda, torch.bfloat16)
    dy = (0.1 * torch.randn((6, Lx, d), generator=gen)).to(cuda, torch.bfloat16)
    y, stash = flt.fused_train_layer_fwd_stash(x, ops, n_head, 0.2, 99, 2)
    want_y, want_stash = flt.fused_train_layer_stash_reference(x, ops, n_head, 0.2, 99, 2)
    dx, grads = flt.fused_train_layer_bwd_stash(x, dy, want_stash, ops, n_head, 0.2, 99, 2)
    torch.cuda.synchronize()
    _assert_close(y, want_y, LAYER_TOL)
    for name, got, ref in zip(STASH_NAMES, stash, want_stash):
        _assert_close(got, ref, (0.0, 1e-3) if name in ("r1", "r2") else LAYER_TOL)
    want_dx, want = flt.fused_train_layer_stash_backward_reference(x, dy, want_stash, ops, n_head,
                                                                   0.2, 99, 2)
    _assert_close(dx, want_dx, LAYER_TOL)
    for i, (got, ref) in enumerate(zip(grads, want)):
        err = (got.float() - ref.float()).norm()
        assert err <= GRAD_REL * ref.float().norm() + 1e-6, (i, float(err))


@pytest.mark.cuda
def test_stash_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    qkv, dattn, attn, pbar = _stash_pass_inputs(cuda, 2, 65, D, H, 1)
    with pytest.raises(ValueError, match="bf16"):
        flt.stash_attention_fwd(qkv.float(), H)
    with pytest.raises(ValueError, match="stash gate"):  # H * Lp = 8 * 176 > 1280
        flt.stash_attention_fwd(torch.zeros((1, 161, 3 * D), dtype=torch.bfloat16,
                                            device=cuda), H)
    with pytest.raises(ValueError, match="pbar"):  # unpadded pbar
        flt.stash_attention_bwd(qkv, attn, dattn, pbar[..., :65].contiguous(), H)
    with pytest.raises(ValueError, match=r"\[B, L, D\]"):
        flt.stash_attention_bwd(qkv, attn[:, :64].contiguous(), dattn, pbar, H)


@pytest.mark.cuda
def test_stash_attention_kernels_run_wgmma_and_do_not_spill(cuda):
    """Every instance of K4's attention passes (wg_attention_fwd<DH, NG>,
    wg_attention_bwd_stash<DH, NG, RESIDENT>): no spill in the build's
    `ptxas -v` report, HGMMA in its SASS; the mma.sync stash backward
    (train_attention_bwd_stash) is gone."""
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.build())], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    report = _build.ptxas_report("fused_layer_train")
    entries = {n: v for n, v in _build.ptxas_entries(report).items() if "wg_attention" in n}
    assert len(entries) == 9 + 12, sorted(entries)  # fwd NG 2/4/5, bwd 2/4/5 + streamed
    for name, (regs, stores, loads) in entries.items():
        assert regs > 0 and stores == loads == 0, (name, regs, stores, loads)
        body = [b for n, b in bodies.items() if n.strip() == name]
        assert len(body) == 1 and "HGMMA" in body[0], (name, len(body))
    assert not any("train_attention_bwd_stash" in n for n in bodies)


# K3's two attention passes alone (wg_recompute_attention_fwd and
# wg_recompute_attention_bwd up to 144 keys, but the mma.sync forward at
# d_head 16 past 80 keys; the mma.sync passes past 144): the shapes K3 trains
# (ViT, rawiq_best, vit_tpu_production, the rawIQ flagship and
# vit_tiny_2016 under VITIQ_TRAIN_STASH=0), one token, a partly dead key
# group (L 33), each group count at d_head 32 (L 17, 65, 81, 129), and L
# past 144 at each d_head (the mma.sync passes)
RECOMPUTE_PASS_SHAPES = [pytest.param(129, 128, 8, id="vit"),
                         pytest.param(65, 256, 8, id="rawiq_best"),
                         pytest.param(129, 128, 2, id="vit_tpu_production"),
                         pytest.param(65, 128, 8, id="rawiq"),
                         pytest.param(17, 64, 4, id="vit_tiny_2016"),
                         pytest.param(1, 128, 8, id="L1"), pytest.param(33, 128, 4, id="L33"),
                         pytest.param(17, 128, 4, id="L17-dh32"),
                         pytest.param(65, 128, 4, id="L65-dh32"),
                         pytest.param(81, 128, 4, id="L81-dh32"),
                         pytest.param(144, 128, 4, id="L144-dh32"),
                         pytest.param(160, 128, 8, id="L160-mma.sync"),
                         pytest.param(200, 64, 2, id="L200-dh32-mma.sync"),
                         pytest.param(224, 64, 1, id="L224-dh64-mma.sync")]


def _recompute_pass_inputs(cuda, B, Lx, d, n_head, seed):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, Lx, 3 * d), generator=gen).to(cuda, torch.bfloat16)
    dattn = (0.1 * torch.randn((B, Lx, d), generator=gen)).to(cuda, torch.bfloat16)
    attn, stats = flt.recompute_attention_fwd_plain(qkv, n_head)
    return qkv, dattn, attn, stats


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,d,n_head", RECOMPUTE_PASS_SHAPES)
def test_recompute_attention_passes_match_plain_versions(cuda, Lx, d, n_head):
    """Each pass alone on the same inputs as its plain version: attn and
    dqkv at the one-layer tolerance and within 1% in the L2 norm; the
    forward's row max m within 1e-5 of max(|m|, 1) (the scores sum the same
    bf16 products in another order) and its sum l within 1e-3 relative (one
    flipped p moves l by an ulp of that p); each frame's column sums within
    1% in the L2 norm (the backward on the plain attn and stats, so that it
    alone is under test). Then the backward on the forward kernel's attn and
    stats: dqkv and the column sums within 1% of the plain chain's."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    B = 37 if Lx <= 144 else 5
    qkv, dattn, attn_p, stats_p = _recompute_pass_inputs(cuda, B, Lx, d, n_head, Lx)
    flt.reset_launches()
    attn, stats = flt.recompute_attention_fwd(qkv, n_head)
    dqkv, part = flt.recompute_attention_bwd(qkv, attn_p, dattn, stats_p, n_head)
    torch.cuda.synchronize()
    assert flt.pass_launches == {"stash_attention_fwd": 0, "stash_attention_bwd": 0,
                                 "recompute_attention_fwd": 1, "recompute_attention_bwd": 1}
    assert stats.shape == stats_p.shape == (B, n_head, Lx, 2) and torch.isfinite(stats).all()
    _assert_close(attn, attn_p, LAYER_TOL)
    m, m_p = stats[..., 0], stats_p[..., 0]
    assert ((m - m_p).abs() <= 1e-5 * m_p.abs().clamp_min(1.0)).all()
    assert ((stats[..., 1] - stats_p[..., 1]).abs() <= 1e-3 * stats_p[..., 1]).all()
    want_dqkv, want_part = flt.recompute_attention_bwd_plain(qkv, attn_p, dattn, stats_p, n_head)
    _assert_close(dqkv, want_dqkv, LAYER_TOL)
    dqkv_k, part_k = flt.recompute_attention_bwd(qkv, attn, dattn, stats, n_head)
    for got, want in ((attn, attn_p), (dqkv, want_dqkv), (part, want_part), (dqkv_k, want_dqkv),
                      (part_k, want_part)):
        err = (got.float() - want.float()).norm()
        assert err <= GRAD_REL * want.float().norm() + 1e-6, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,d,n_head", [pytest.param(129, 128, 8, id="vit"),
                                         pytest.param(65, 256, 8, id="rawiq_best"),
                                         pytest.param(129, 128, 2, id="vit_tpu_production")])
def test_recompute_attention_passes_give_the_same_bits_over_repeated_launches(cuda, Lx, d,
                                                                            n_head):
    """30 launches of each pass give the first launch's bits (the persistent
    forward's double-buffered TMA loads, the backward's pbar plane written
    in the kernel and overwritten by dS, the column sums in a fixed order)."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    qkv, dattn, attn_p, stats_p = _recompute_pass_inputs(cuda, 600, Lx, d, n_head, 7)
    first = (*flt.recompute_attention_fwd(qkv, n_head),
             *flt.recompute_attention_bwd(qkv, attn_p, dattn, stats_p, n_head))
    for _ in range(30):
        again = (*flt.recompute_attention_fwd(qkv, n_head),
                 *flt.recompute_attention_bwd(qkv, attn_p, dattn, stats_p, n_head))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_recompute_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    qkv, dattn, attn, stats = _recompute_pass_inputs(cuda, 2, 65, D, H, 1)
    with pytest.raises(ValueError, match="bf16"):
        flt.recompute_attention_fwd(qkv.float(), H)
    with pytest.raises(ValueError, match="shapes of K3"):  # d_head 8
        flt.recompute_attention_fwd(qkv, 16)
    with pytest.raises(ValueError, match="stats"):  # bf16 stats
        flt.recompute_attention_bwd(qkv, attn, dattn, stats.bfloat16(), H)
    with pytest.raises(ValueError, match=r"\[B, L, D\]"):
        flt.recompute_attention_bwd(qkv, attn[:, :64].contiguous(), dattn, stats, H)


@pytest.mark.cuda
def test_recompute_attention_kernels_run_wgmma_and_do_not_spill(cuda):
    """Every instance of K3's wgmma attention passes
    (wg_recompute_attention_fwd<DH, NG>, wg_recompute_attention_bwd<DH,
    NG>): no spill in the build's `ptxas -v` report, HGMMA in its SASS; the
    forward's <16, 9> is not built (its shapes take the mma.sync forward)."""
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.build())], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    report = _build.ptxas_report("fused_layer_train")
    entries = {n: v for n, v in _build.ptxas_entries(report).items()
               if "wg_recompute_attention" in n}
    assert len(entries) == 12 + 11, sorted(entries)  # bwd NG 2/4/5/9, fwd the same but <16, 9>
    assert not any("wg_recompute_attention_fwdILi16ELi9E" in n for n in entries)
    for name, (regs, stores, loads) in entries.items():
        assert regs > 0 and stores == loads == 0, (name, regs, stores, loads)
        body = [b for n, b in bodies.items() if n.strip() == name]
        assert len(body) == 1 and "HGMMA" in body[0], (name, len(body))


# --------------------------------------------------------------------------
# K5: the standalone packed attention, forward and backward
# --------------------------------------------------------------------------

def _qkv(cuda, B, L, seed, d=D):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, L, 3 * d), generator=gen).to(cuda, torch.bfloat16)
    dout = (0.1 * torch.randn((B, L, d), generator=gen)).to(cuda, torch.bfloat16)
    return qkv, dout


@pytest.mark.cuda
@pytest.mark.parametrize("Lx", [1, 17, 1025, 1040, 4097])
@pytest.mark.parametrize("n_head", [8, 4, 2])  # d_head 16, 32, 64
def test_attention_kernels_match_plain_versions(cuda, Lx, n_head):
    """out at the one-layer tolerance, the lse within 1e-3 (f32 sums in
    another order), dq, dk, dv [B, L, D] each within GRAD_REL of the plain
    gradient in the L2 norm. At 1025 and 1040 tokens the key tiles run past
    L: a padded key that leaked into the denominator would move the lse by
    far more than 1e-3. 4097 tokens run past what K1's core holds in shared
    memory at d_head 64. out and lse are held to the kernel's own one-pass
    function too (out within GRAD_REL in the L2 norm)."""
    from vitiq_torch.ops.cuda import flash_attention as fa

    qkv, dout = _qkv(cuda, 2 if Lx > 2048 else 3, Lx, Lx + n_head)
    q, k, v = qkv.split(D, dim=-1)  # column slices of qkv, as the model passes them
    out, lse = fa.fused_attention_fwd(q, k, v, n_head)
    grads = fa.fused_attention_bwd(q, k, v, out, lse, dout, n_head)
    torch.cuda.synchronize()
    want, want_lse = fa.attention_plain(q, k, v, n_head)
    _assert_close(out, want, LAYER_TOL)
    assert lse.shape == want_lse.shape and (lse - want_lse).abs().max() <= 1e-3
    one, one_lse = fa.attention_onepass_plain(q, k, v, n_head)
    assert (out.float() - one.float()).norm() <= GRAD_REL * one.float().norm()
    assert (lse - one_lse).abs().max() <= 1e-3
    for got, ref in zip(grads, fa.attention_bwd_reference(q, k, v, out, dout, n_head)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).norm()
        assert err <= GRAD_REL * ref.float().norm() + 1e-6, float(err)


@pytest.mark.cuda
def test_attention_kernels_read_strided_and_contiguous_inputs_alike(cuda):
    from vitiq_torch.ops.cuda import flash_attention as fa

    qkv, dout = _qkv(cuda, 4, 129, 3)
    views = qkv.split(D, dim=-1)
    dense = [t.contiguous() for t in views]
    a = fa.fused_attention_fwd(*views, 8)
    b = fa.fused_attention_fwd(*dense, 8)
    ga = fa.fused_attention_bwd(*views, a[0], a[1], dout, 8)
    gb = fa.fused_attention_bwd(*dense, b[0], b[1], dout, 8)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a + ga, b + gb))


@pytest.mark.cuda
@pytest.mark.parametrize("n_head", [8, 4, 2])
def test_attention_kernels_give_the_same_bits_over_repeated_launches(cuda, n_head):
    """30 launches of each pass at 1040 tokens (17 tiles: each ring of four
    stages wraps four times) give the same bits: a stage refilled before
    every warpgroup had released it would change some of them."""
    from vitiq_torch.ops.cuda import flash_attention as fa

    qkv, dout = _qkv(cuda, 8, 1040, 6 + n_head)
    q, k, v = qkv.split(D, dim=-1)
    out, lse = fa.fused_attention_fwd(q, k, v, n_head)
    grads = fa.fused_attention_bwd(q, k, v, out, lse, dout, n_head)
    for _ in range(30):
        o, l = fa.fused_attention_fwd(q, k, v, n_head)
        g = fa.fused_attention_bwd(q, k, v, out, lse, dout, n_head)
        torch.cuda.synchronize()
        assert torch.equal(o, out) and torch.equal(l, lse)
        assert all(torch.equal(a, b) for a, b in zip(g, grads))


@pytest.mark.cuda
def test_attention_backward_runs_on_a_fresh_host_thread(cuda):
    """K5-bwd encodes its TMA maps on the calling thread; autograd calls it
    from its own backward thread, whose first CUDA work it may be. A fresh
    host thread's call gives the main thread's bits."""
    import threading

    from vitiq_torch.ops.cuda import flash_attention as fa

    qkv, dout = _qkv(cuda, 2, 65, 7)
    q, k, v = qkv.split(D, dim=-1)
    out, lse = fa.fused_attention_fwd(q, k, v, 8)
    want = fa.fused_attention_bwd(q, k, v, out, lse, dout, 8)
    got = []
    thread = threading.Thread(
        target=lambda: got.append(fa.fused_attention_bwd(q, k, v, out, lse, dout, 8)))
    thread.start()
    thread.join()
    torch.cuda.synchronize()
    assert len(got) == 1 and all(torch.equal(a, b) for a, b in zip(got[0], want))


@pytest.mark.cuda
def test_attention_kernels_run_wgmma_and_do_not_spill(cuda):
    """K5's three kernels at d_head 16, 32 and 64: no spill in the build's
    `ptxas -v` report, HGMMA in each one's SASS (cuobjdump, beside nvcc),
    and the ring's shared memory the one the host-side repeat gives."""
    from vitiq_torch.ops.cuda import flash_attention as fa

    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.build())], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    for name in fa.KERNELS:
        for dh in fa.SUPPORTED_D_HEAD:
            tag = fa.kernel_tag(name, dh)
            regs, stores, loads = _build.kernel_resources("flash_attention", tag)
            assert regs > 0 and stores == loads == 0, (name, dh, regs, stores, loads)
            body = [b for n, b in bodies.items() if tag in n]
            assert len(body) == 1 and "HGMMA" in body[0], (name, dh, len(body))
            info = fa.ring_info(name, dh)
            assert info["smem"] == fa.ring_smem_bytes(dh), (name, dh, info)
            assert info["warpgroups"] in (1, 2) and info["blocks_one"] >= 1, (name, dh, info)


@pytest.mark.cuda
def test_attention_launch_counts_and_autograd(cuda):
    from vitiq_torch.ops.cuda import flash_attention as fa
    from vitiq_torch.ops.numerics import TPU

    qkv, dout = _qkv(cuda, 2, 65, 4)
    qkv.requires_grad_(True)
    fa.reset_launches()
    out = fa.fused_attention(*qkv.split(D, dim=-1), 8, policy=TPU)
    assert fa.launches == {"fused_attention_fwd": 1, "fused_attention_bwd": 0}
    out.backward(dout)
    torch.cuda.synchronize()
    assert fa.launches == {"fused_attention_fwd": 1, "fused_attention_bwd": 1}
    assert qkv.grad is not None and torch.isfinite(qkv.grad.float()).all()
    # f32 on the card takes the plain split-head path, and launches nothing
    fa.fused_attention(*qkv.detach().float().split(D, dim=-1), 8)
    assert fa.launches == {"fused_attention_fwd": 1, "fused_attention_bwd": 1}


@pytest.mark.cuda
def test_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from vitiq_torch.ops.cuda import flash_attention as fa

    qkv, dout = _qkv(cuda, 2, 9, 5)
    q, k, v = qkv.split(D, dim=-1)
    with pytest.raises(ValueError, match="bf16"):
        fa.fused_attention_fwd(q.float(), k, v, 8)
    with pytest.raises(ValueError, match="d_head"):
        fa.fused_attention_fwd(q, k, v, 16)  # d_head 8
    with pytest.raises(ValueError, match="like q"):
        fa.fused_attention_fwd(q, k[:, :4], v, 8)
    out, lse = fa.fused_attention_fwd(q, k, v, 8)
    with pytest.raises(ValueError, match="lse"):
        fa.fused_attention_bwd(q, k, v, out, lse[:, :4], dout, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("numerics", ["reference", "tpu"])
def test_remat_replays_the_dropout_masks_of_a_cuda_generator(cuda, numerics, monkeypatch):
    """A conv1d model at 601 tokens, dropout 0.2 and an FFN width of 96
    (which the fused training stack turns down, so the plain layers run,
    with K5 under `tpu`), one step's gradient with the step's seed as
    `make_train_step` passes it on the card (an int32 tensor there): the
    rematerialized layers (VITIQ_TRAIN_REMAT auto) draw the forward's masks
    again from it (the plain sites' kernel once more a site) and give the
    gradient without remat (0) at 1e-6; another seed gives another
    gradient. (The masks came from a CUDA generator before they came from
    the seed; the name is kept.)"""
    from vitiq_torch.config import ModelConfig
    from vitiq_torch.models import AMCModel
    from vitiq_torch.models import encoder as port_encoder
    from vitiq_torch.ops.cuda import flash_attention as fa
    from vitiq_torch.ops.cuda import fused_layer_train as flt
    from vitiq_torch.ops.metrics import label_smoothed_cross_entropy

    cfg = ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=2,
                      ffn_hidden=96, drop_prob=0.2, seq_length=600, embedding_type="conv1d",
                      numerics=numerics)
    model = AMCModel(cfg, device=cuda, generator=torch.Generator().manual_seed(0)).train()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 2, cfg.seq_length), generator=gen).to(cuda)
    y = torch.randint(0, cfg.num_classes, (2,), generator=gen).to(cuda)

    def grad(seed=3):
        seed_t = torch.tensor([seed], dtype=torch.int32, device=cuda)
        loss = label_smoothed_cross_entropy(model(x, seed=seed_t), y, 0.1)
        return loss.item(), torch.autograd.grad(loss, list(model.parameters()))

    n = cfg.n_layers
    assert port_encoder.use_remat(True, cfg.num_tokens)
    fa.reset_launches()
    flt.reset_launches()
    loss, remat = grad()
    k5 = n if numerics == "tpu" else 0
    assert fa.launches == {"fused_attention_fwd": 2 * k5, "fused_attention_bwd": k5}
    assert flt.dropout_launches == {"hash_dropout": 2 + 9 * n}
    monkeypatch.setenv("VITIQ_TRAIN_REMAT", "0")
    flt.reset_launches()
    loss0, plain = grad()
    assert flt.dropout_launches == {"hash_dropout": 2 + 6 * n}
    assert loss == loss0
    for a, b in zip(remat, plain):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    other = grad(seed=4)[1]
    assert not torch.equal(other[0], plain[0])


# --------------------------------------------------------------------------
# K6: the int8 W8A8 fused layer
# --------------------------------------------------------------------------
#
# K6 is held to its plain version by relative L2 and by a max counted in
# quantization steps (a step is a row's absmax / 127 of the plain output):
# past the exact int8 products, a one-ulp bf16 flip in an activation (the
# attention core sums in another order) can move a downstream quantized
# value by a level. One layer: ||kernel - plain|| <= 1e-2 ||plain|| and
# every element within 2 steps; a stack of layers: 2e-2 and 4 steps.
K6_LAYER_TOL = (1e-2, 2.0)
K6_STACK_TOL = (2e-2, 4.0)


def _assert_int8_close(got, want, tol):
    rel, steps = tol
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= rel
    step = want.abs().amax(dim=-1, keepdim=True) / 127
    assert torch.all((got - want).abs() <= steps * step)


def _qlayers(n, ffn, device, n_head=H, d=D):
    from vitiq_torch.ops.quant import QuantizedEncoderLayer, quantize_params_int8

    gen = torch.Generator().manual_seed(5)
    out = []
    for _ in range(n):
        layer = EncoderLayer(d, ffn, n_head, generator=gen)
        with torch.no_grad():  # LayerNorm affine away from (1, 0)
            for norm in (layer.norm1, layer.norm2):
                norm.gamma.copy_(1.0 + 0.1 * torch.randn(d, generator=gen))
                norm.beta.copy_(0.1 * torch.randn(d, generator=gen))
        q = QuantizedEncoderLayer(d, ffn)
        q.load_state_dict(quantize_params_int8(layer.state_dict()))
        out.append(q.to(device))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,batch,d", [
    _p(1, 256, 8, 37), _p(17, 256, 8, 37), _p(17, 256, 4, 37), _p(65, 1024, 8, 37),
    _p(65, 1024, 4, 37), _p(129, 512, 8, 37), _p(129, 512, 4, 37), _p(1025, 1024, 8, 6),
    _p(1025, 1024, 4, 6),
    _p(65, 1024, 8, 37, d=256), _p(1, 1024, 8, 37, d=256),  # rawiq_best
    _p(17, 256, 4, 37, d=64),  # vit_tiny_2016
    _p(129, 512, 2, 37)])  # d_head 64 (vit_tpu_production)
def test_int8_layer_matches_plain_version(cuda, Lx, ffn, n_head, batch, d):
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    ops = k6.int8_layer_operands(_qlayers(1, ffn, cuda, n_head, d)[0], n_head)
    x = torch.randn((batch, Lx, d), generator=torch.Generator().manual_seed(Lx)).to(
        cuda, torch.bfloat16)
    got = k6.fused_encoder_layer_int8(x, ops, n_head)
    torch.cuda.synchronize()
    _assert_int8_close(got, k6.fused_layer_int8_reference(x, ops, n_head), K6_LAYER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,d", [pytest.param(129, 512, D, id="129-512"),
                                      pytest.param(65, 1024, D, id="65-1024"),
                                      pytest.param(17, 256, D, id="17-256"),
                                      pytest.param(65, 1024, 256, id="65-1024-d256")])
@pytest.mark.parametrize("cls_only", [False, True])
def test_int8_stack_and_cls_tail_match_plain_version(cuda, Lx, ffn, d, cls_only):
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    layers = _qlayers(3, ffn, cuda, d=d)
    x = torch.randn((37, Lx, d), generator=torch.Generator().manual_seed(1)).to(
        cuda, torch.bfloat16)
    k6.reset_launches()
    fel.reset_launches()
    got = k6.fused_encoder_layer_int8_stack(x, layers, H, cls_only=cls_only)
    torch.cuda.synchronize()
    assert k6.launches["fused_encoder_layer_int8"] == (2 if cls_only else 3)
    assert fel.launches == {"fused_encoder_layer": 0, "fused_encoder_layer_cls": int(cls_only)}
    full = layers[:-1] if cls_only else layers
    want = k6.fused_encoder_layer_int8_stack_reference(
        x, [k6.int8_layer_operands(q, H) for q in full], H,
        k6.dequant_layer_operands(layers[-1], H) if cls_only else None)
    assert got.shape == ((37, 1, d) if cls_only else (37, Lx, d))
    _assert_int8_close(got, want, K6_STACK_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1000, 128, 384), (64, 128, 512), (777, 1024, 128),
                                   # rawiq_best's stages: QKV, out-projection, FFN1, FFN2
                                   (1000, 256, 768), (1000, 256, 256), (64, 256, 1024),
                                   (777, 1024, 256),
                                   (300, 64, 192), (300, 64, 64)])  # d_model 64: 64-wide tiles
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("prequant", [False, True])
def test_int8_gemm_stage_is_exact(cuda, M, K, N, relu, prequant):
    """A GEMM stage of K6 equals its plain version bit for bit, with its rows
    quantized inside the GEMM or by the separate pass: the same f32 row
    scales and int8 levels, s32 sums that an f32 product of the integer
    operands reproduces exactly (K <= 1040), the same f32 epilogue."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    gen = torch.Generator().manual_seed(M + K)
    a = (3 * torch.randn((M, K), generator=gen)).to(cuda, torch.bfloat16)
    wq = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).to(cuda)
    ws = (torch.rand(N, generator=gen) / 127).to(cuda)
    bias = torch.randn(N, generator=gen).to(cuda)
    got = k6.int8_gemm(a, wq, ws, bias, relu, prequant)
    want = k6.int8_gemm_reference(a, wq, ws, bias)
    want = (torch.relu(want) if relu else want).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if K != 128:
        return
    # at unit scales and zero biases on integer rows whose absmax is 127, the
    # stage returns the integer sums themselves (|sum| <= 254: exact in bf16)
    ints = torch.randint(-1, 2, (M, K), generator=gen)
    ints[:, 0] = 127
    small_w = torch.randint(-1, 2, (N, K), generator=gen, dtype=torch.int8)
    small_w[:, 0] = torch.randint(0, 2, (N,), generator=gen, dtype=torch.int8)
    sums = ints.float() @ small_w.float().t()
    assert sums.abs().max() < 256
    got = k6.int8_gemm(ints.to(cuda, torch.bfloat16), small_w.to(cuda), torch.ones(N, device=cuda),
                       torch.zeros(N, device=cuda), relu, prequant)
    torch.cuda.synchronize()
    assert torch.equal(got.float().cpu(), torch.relu(sums) if relu else sums)


def _stage_operands(d, ffn, M, cuda):
    """A quantized layer's 16 operands (n_head 4) and a maker of seeded bf16
    rows [M, n] for K6's stages alone."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    ops = k6.int8_layer_operands(_qlayers(1, ffn, cuda, 4, d)[0], 4)
    gen = torch.Generator().manual_seed(M + d)
    return ops, lambda n: (2 * torch.randn((M, n), generator=gen)).to(cuda, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d,ffn", [(128, 512), (128, 1024), (256, 1024), (64, 256), (64, 512),
                                   (128, 384)])
@pytest.mark.parametrize("M", [1088, 1000])  # 64 mod 128 (a streamed stage's half tile), ragged
def test_int8_s8_stages_match_their_plain_versions(cuda, d, ffn, M):
    """Each of K6's four s8 stage forms alone, as the layer launches it,
    against `s8_stage_reference` on the same inputs: QKV and FFN1 (levels in,
    bias / ReLU epilogue, FFN1's row max merged by atomicMax) bit for bit;
    the out-projection and FFN2 (bf16 rows quantized in the stage, LayerNorm
    epilogue) within K6's layer tolerance, their levels and scales bit for
    bit `levels_of` their own bf16 output. 30 launches of each give the same
    bits (the TMA rings)."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    ops, rows = _stage_operands(d, ffn, M, cuda)
    wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 = ops
    x, attn, res = rows(d), rows(d), rows(d)
    x_levels = k6.levels_of(x)
    runs = {
        "qkv": lambda: (k6.qkv_stage(x_levels, wqkv, sqkv, bqkv),),
        "out_proj": lambda: k6.out_proj_stage(attn, wo, so, bo, res, g1, be1),
    }
    qkv = runs["qkv"]()[0]
    want = k6.s8_stage_reference(wqkv, sqkv, bqkv, levels=x_levels)[0]
    torch.cuda.synchronize()
    assert torch.equal(qkv, want)
    x1, x1_levels = runs["out_proj"]()
    want, _, _ = k6.s8_stage_reference(wo, so, bo, a=attn, ln=(res, g1, be1))
    torch.cuda.synchronize()
    _assert_int8_close(x1, want, K6_LAYER_TOL)
    assert all(torch.equal(g, w) for g, w in zip(x1_levels, k6.levels_of(x1)))
    runs["ffn1"] = lambda: k6.ffn1_stage(x1_levels, w1, s1, b1)
    hid, hmax = runs["ffn1"]()
    want, want_max, _ = k6.s8_stage_reference(w1, s1, b1, levels=x1_levels, relu=True,
                                              slab=k6.s8_slab_width(ffn))
    torch.cuda.synchronize()
    assert torch.equal(hid, want) and torch.equal(hmax, want_max)
    assert torch.equal(hmax.view(torch.float32), hid.float().amax(dim=-1))
    runs["ffn2"] = lambda: k6.ffn2_stage(hid, hmax, w2, s2, b2, x1, g2, be2)
    y, y_levels = runs["ffn2"]()
    want, _, _ = k6.s8_stage_reference(w2, s2, b2, a=hid, amax=hmax, ln=(x1, g2, be2))
    torch.cuda.synchronize()
    _assert_int8_close(y, want, K6_LAYER_TOL)
    assert all(torch.equal(g, w) for g, w in zip(y_levels, k6.levels_of(y)))
    def flat(out):
        return [t for part in out for t in (part if isinstance(part, tuple) else (part,))]

    for name, run in runs.items():
        first = flat(run())
        for _ in range(29):
            assert all(torch.equal(a, b) for a, b in zip(first, flat(run()))), name


@pytest.mark.cuda
@pytest.mark.parametrize("d,ffn,n_head", [(128, 512, 8), (256, 1024, 8), (64, 256, 4)])
def test_int8_layer_carries_levels_and_repeats_its_bits(cuda, d, ffn, n_head):
    """K6 given x's levels equals K6 quantizing x itself, bit for bit; the
    levels it writes for the next layer are `levels_of` its output; 30
    launches give the same bits (M = 37 * 17 = 629, ragged)."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    ops = k6.int8_layer_operands(_qlayers(1, ffn, cuda, n_head, d)[0], n_head)
    x = torch.randn((37, 17, d), generator=torch.Generator().manual_seed(2)).to(
        cuda, torch.bfloat16)
    plain = k6.fused_encoder_layer_int8(x, ops, n_head)
    y, levels = k6.fused_encoder_layer_int8(x, ops, n_head, x_levels=k6.levels_of(x),
                                            out_levels=True)
    torch.cuda.synchronize()
    assert torch.equal(y, plain)
    assert all(torch.equal(g, w) for g, w in zip(levels, k6.levels_of(y)))
    for _ in range(29):
        assert torch.equal(k6.fused_encoder_layer_int8(x, ops, n_head), plain)


@pytest.mark.cuda
def test_int8_stages_run_s8_wgmma_and_do_not_spill(cuda):
    """Every instance of K6's s8 stage (gemm_s8_kernel): no spill in the
    build's `ptxas -v` report, IGMMA (the integer warpgroup MMA) in its
    SASS. (ptxas may add an empty `HGMMA.64x8x16.F16 RZ` beside the
    registers it fences, as it does in K1's stages.)"""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.build())], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    entries = {k6.s8_instance_of(n): v
               for n, v in _build.ptxas_entries(_build.ptxas_report("fused_encoder_layer")).items()
               if k6.s8_instance_of(n)}
    assert sorted(entries) == sorted(k6.S8_INSTANCES)
    for inst, (regs, stores, loads) in entries.items():
        assert regs > 0 and stores == loads == 0, (inst, regs, stores, loads)
        body = [b for n, b in bodies.items() if k6.s8_instance_of(n) == inst]
        assert len(body) == 1 and "IGMMA.64x" in body[0], inst


@pytest.mark.cuda
def test_int8_padded_frames_and_rows_do_not_leak(cuda):
    """A frame's output does not depend on the frames batched with it, nor
    on rows past its L (the attention core's zero-filled key tile)."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    ops = k6.int8_layer_operands(_qlayers(1, 256, cuda)[0], H)
    x9 = torch.randn((1, 9, D), generator=torch.Generator().manual_seed(3)).to(cuda,
                                                                                torch.bfloat16)
    both = torch.cat([x9, torch.full_like(x9, 100.0)])
    solo = k6.fused_encoder_layer_int8(x9, ops, H)
    paired = k6.fused_encoder_layer_int8(both, ops, H)
    torch.cuda.synchronize()
    assert torch.equal(solo[0], paired[0])
    assert torch.isfinite(paired).all()


@pytest.mark.cuda
def test_int8_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6

    ops = k6.int8_layer_operands(_qlayers(1, 256, cuda)[0], H)
    x = torch.randn((2, 9, D)).to(cuda)
    with pytest.raises(ValueError, match="bf16"):
        k6.fused_encoder_layer_int8(x, ops, H)  # f32 activations
    with pytest.raises(ValueError, match="d_head"):
        k6.fused_encoder_layer_int8(x.bfloat16(), ops, 1)  # d_head 128
    with pytest.raises(ValueError, match="operand 0"):
        k6.fused_encoder_layer_int8(x.bfloat16(), [ops[0].float()] + ops[1:], H)
    with pytest.raises(ValueError, match="K % 64"):
        k6.int8_gemm(x.bfloat16()[0, :, :100].contiguous(), ops[0][:, :100].contiguous(),
                     ops[1], ops[2])


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["vit", "rawiq"])
def test_quantized_model_serves_through_k6_and_k2(cuda, arm, monkeypatch):
    """The quantized model on the card: K6 on every full layer and K2 on the
    CLS row, no K1; its logits close to its unfused int8 path and to the
    float model's."""
    from vitiq_torch.config import ModelConfig
    from vitiq_torch.models import AMCModel
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6
    from vitiq_torch.ops.quant import QuantizedAMCModel

    if arm == "vit":
        cfg = ModelConfig(arm="vit", num_classes=5, d_model=128, n_head=8, n_layers=3,
                          ffn_hidden=256, numerics="tpu")
        src = torch.randn((9, 1, 32, 64), generator=torch.Generator().manual_seed(4))
    else:
        cfg = ModelConfig(arm="rawiq", num_classes=5, d_model=128, n_head=8, n_layers=3,
                          ffn_hidden=256, seq_length=256, segment_size=16, use_cls_token=True,
                          numerics="tpu")
        src = torch.randn((9, 2, 256), generator=torch.Generator().manual_seed(4))
    model = AMCModel(cfg, device=cuda, generator=torch.Generator().manual_seed(0)).eval()
    qmodel = QuantizedAMCModel.from_model(model)
    src = src.to(cuda)
    k6.reset_launches()
    fel.reset_launches()
    got = qmodel(src)
    torch.cuda.synchronize()
    assert k6.launches["fused_encoder_layer_int8"] == 2
    assert fel.launches == {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 1}
    monkeypatch.setenv("VITIQ_NO_FUSED_LAYER", "1")
    unfused = qmodel(src)
    with torch.no_grad():
        ref = model(src)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    bound = 0.35 * max(ref.abs().max().item(), 1.0)
    assert (got - ref).abs().max().item() < bound
    assert (got - unfused).abs().max().item() < bound


# --------------------------------------------------------------------------
# The configurations that need the wider kernels, end to end on the card
# --------------------------------------------------------------------------

WIDE_CONFIGS = ("rawiq_best", "rawiq_best_mp", "vit_tiny_2016", "vit_tpu_production")


def _wide_config(name):
    """The named geometry under `tpu` numerics with 3 classes (the synthetic
    corpus's) and its frame length."""
    import dataclasses

    from vitiq_torch import config as pc

    if name == "vit_tpu_production":
        cfg = pc.ExperimentConfig.vit_tpu_production().model
    else:
        cfg = getattr(pc, f"{name}_config")()
    cfg = dataclasses.replace(cfg, numerics="tpu", num_classes=3)
    return cfg, cfg.seq_length


def _all_launches():
    from vitiq_torch.ops.cuda import flash_attention as fa
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    return {**fel.launches, **k6.launches, **k7.launches, **fa.launches, **flt.launches}


def _reset_all():
    from vitiq_torch.ops.cuda import flash_attention as fa
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    for module in (fel, k6, k7, fa, flt):
        module.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE_CONFIGS)
def test_wide_configs_serve_evaluate_and_train_through_the_kernels(cuda, name, tmp_path):
    """Under `tpu` numerics on the card: `Server` answers a request through
    K1 (each full layer) and K2 (the CLS row, where the model pools on it),
    within 0.05 of the f32 path; the int8 twin through K6 and K2; `fit`
    trains an epoch (K3 for `rawiq_best` and `vit_tpu_production`, K4 for
    `rawiq_best_mp` and `vit_tiny_2016`) and validates through K1/K2;
    `run_evaluation` of the saved experiment writes its report in float
    (K1/K2) and int8 (K6/K2). Each of these raised on shapes past d_model
    128 / d_head 32 before the kernels were widened."""
    import dataclasses
    import json

    from vitiq_torch.config import DataConfig, ExperimentConfig, TrainConfig
    from vitiq_torch.models import AMCModel
    from vitiq_torch.ops.cuda import fused_layer_train as flt
    from vitiq_torch.runner import load_experiment_data, run_evaluation
    from vitiq_torch.serve import (Server, build_forward_and_preprocess,
                                   build_int8_serving_fn, build_serving_fn)
    from vitiq_torch.train import fit
    from vitiq_torch.train.checkpoint import save_params

    mcfg, frame_len = _wide_config(name)
    n, pools = mcfg.n_layers, mcfg.arm == "vit" or mcfg.use_cls_token
    exp = ExperimentConfig(model=mcfg,
                           data=DataConfig(synthetic_frames_per_class=96,
                                           synthetic_frame_len=frame_len),
                           train=TrainConfig(batch_size=32, num_epochs=1, learning_rate=3e-4))
    stats = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}
    model = AMCModel(mcfg, generator=torch.Generator().manual_seed(0))
    ref_cfg = dataclasses.replace(mcfg, numerics="reference")
    ref = AMCModel(ref_cfg)
    ref.load_state_dict(model.state_dict())
    x = torch.randn((5, frame_len, 2), generator=torch.Generator().manual_seed(1)).to(cuda)
    want = {k: 0 for k in _all_launches()}
    want.update({"fused_encoder_layer": n - 1 if pools else n,
                 "fused_encoder_layer_cls": int(pools)})

    server = Server(build_serving_fn(exp, model, stats, cuda), frame_len, (8,), cuda)
    _reset_all()
    got = server.run(x)
    torch.cuda.synchronize()
    assert _all_launches() == want
    f32 = build_serving_fn(ExperimentConfig(model=ref_cfg, data=exp.data), ref, stats, cuda)(x)
    assert got.shape == (5, 3) and torch.isfinite(got).all()
    assert (got - f32).abs().max().item() < 0.05

    int8 = Server(build_int8_serving_fn(exp, model, stats, cuda), frame_len, (8,), cuda)
    _reset_all()
    got8 = int8.run(x)
    torch.cuda.synchronize()
    want8 = {k: 0 for k in want}
    want8.update({"fused_encoder_layer_int8": want["fused_encoder_layer"],
                  "fused_encoder_layer_cls": int(pools)})
    assert _all_launches() == want8
    assert (got8 - f32).abs().max().item() < 0.35 * max(f32.abs().max().item(), 1.0)

    splits, data_stats, _ = load_experiment_data(exp)
    model, pre = build_forward_and_preprocess(
        exp, AMCModel(mcfg, generator=torch.Generator().manual_seed(2)), data_stats, cuda)
    _reset_all()
    res = fit(exp, model, splits["train"][:2], splits["valid"][:2], preprocess_fn=pre,
              verbose=False)
    torch.cuda.synchronize()
    launched = _all_launches()
    fwd, bwd = (("fused_train_layer_fwd", "fused_train_layer_bwd")
                if name in ("rawiq_best", "vit_tpu_production") else
                ("fused_train_layer_fwd_stash", "fused_train_layer_bwd_stash"))
    steps = len(splits["train"][0]) // exp.train.batch_size
    assert launched[fwd] == launched[bwd] == n * steps, launched
    assert sum(launched[k] for k in flt.launches) == 2 * n * steps
    assert launched["fused_attention_fwd"] == launched["fused_attention_bwd"] == 0
    assert launched["fused_encoder_layer"] > 0  # the validation pass
    assert res.epochs_run == 1 and all(map(math.isfinite, res.history["val_loss"]))

    save_params(tmp_path / "model_best", res.best_params, mcfg)
    exp.to_json(str(tmp_path / "config.json"))
    (tmp_path / "normalization_stats.json").write_text(json.dumps(data_stats))
    for quantized in (False, True):
        _reset_all()
        r = run_evaluation(str(tmp_path), "test", int8=quantized, device=cuda,
                           make_plots=False, verbose=False)
        torch.cuda.synchronize()
        launched = _all_launches()
        prefix = "test_int8" if quantized else "test"
        assert (tmp_path / "evaluation" / f"{prefix}_classification_report.txt").exists()
        assert 0.0 <= r["overall_accuracy"] <= 1.0
        layer = "fused_encoder_layer_int8" if quantized else "fused_encoder_layer"
        assert launched[layer] > 0 and launched["fused_encoder_layer_cls"] == (
            launched[layer] // want["fused_encoder_layer"] if pools else 0), launched
        assert launched["fused_attention_fwd"] == 0


# K7: one layer within 1e-3 relative L2 and 2 steps, below what K1's bf16
# core in K7's place reads (tests/test_torch_fused_layer.py); a stack with
# the K2 tail as K6's.
K7_LAYER_TOL, K7_STACK_TOL = (1e-3, 2.0), K6_STACK_TOL


def _k7_layers(n, ffn, device, n_head=H, d=D):
    """Float layers with LayerNorm affine away from (1, 0)."""
    layers = _layers(n, ffn, device, n_head, d)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for layer in layers:
            for norm in (layer.norm1, layer.norm2):
                norm.gamma.copy_(1.0 + 0.1 * torch.randn(d, generator=gen))
                norm.beta.copy_(0.1 * torch.randn(d, generator=gen))
    return layers


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,batch,d", [
    _p(129, 512, 8, 256), _p(65, 1024, 8, 256), _p(1025, 1024, 8, 64),  # the flagships
    _p(65, 1024, 8, 256, d=256),  # rawiq_best
    _p(129, 512, 4, 37), _p(129, 512, 2, 37), _p(17, 256, 4, 37, d=64), _p(1, 128, 8, 37),
    _p(848, 256, 2, 4)])  # d_head 32, 64, d_model 64, one token, d_head 64's longest L
def test_int8attn_layer_matches_plain_version(cuda, Lx, ffn, n_head, batch, d):
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7

    layers = _k7_layers(3, ffn, cuda, n_head, d)
    ops = [fel.layer_operands(layer, n_head) for layer in layers]
    x = torch.randn((batch, Lx, d), generator=torch.Generator().manual_seed(Lx)).to(
        cuda, torch.bfloat16)
    k7.reset_launches()
    fel.reset_launches()
    got = k7.fused_encoder_layer_int8attn(x, ops[0], n_head)
    stack = k7.fused_encoder_layer_int8attn_stack(x, layers, n_head, cls_only=True)
    torch.cuda.synchronize()
    assert k7.launches == {"fused_encoder_layer_int8attn": 3, "attention_int8": 0}
    assert fel.launches == {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 1}
    _assert_int8_close(got, k7.fused_layer_int8attn_reference(x, ops[0], n_head), K7_LAYER_TOL)
    want = k7.fused_encoder_layer_int8attn_stack_reference(x, ops, n_head, cls_only=True)
    assert stack.shape == (batch, 1, d)
    _assert_int8_close(stack, want, K7_STACK_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("core", ["wgmma", "sync"])
@pytest.mark.parametrize("Lx,n_head,d", [(129, 8, D), (65, 8, 256), (1025, 8, D), (200, 2, D),
                                         (17, 4, 64), (1, 8, D)])
def test_int8attn_core_products_are_exact(cuda, Lx, n_head, d, core):
    """K7's core alone on one qkv, in each of its two forms at every L: its
    s32 scores and its s32 P [v | 1] tile products (on its own int8
    probabilities) equal the plain version's bit for bit; the probabilities
    and outputs differ in at most a few elements (an exp2 rounding to the
    other side of a half)."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7

    qkv = torch.randn((3, Lx, 3 * d), generator=torch.Generator().manual_seed(4)).to(
        cuda, torch.bfloat16)
    out, dump = k7.attention_int8(qkv, n_head, dump=True, core=core)
    torch.cuda.synchronize()
    plain = k7.attention_int8_products(qkv, n_head, probs=dump["probs"])
    assert torch.equal(dump["scores"], plain["scores"])
    assert torch.equal(dump["pv"], plain["pv"])
    own = k7.attention_int8_products(qkv, n_head)
    assert (dump["probs"] != own["probs"]).float().mean().item() < 1e-3
    ref = k7.attention_int8_reference(qkv, n_head)
    assert (out != ref).float().mean().item() < 1e-2
    # the same bits without the dump
    assert torch.equal(out, k7.attention_int8(qkv, n_head, core=core))


def _sass_bodies():
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.build())], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    return dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])


def _instances(kernel):
    """(name, registers, spill stores, spill loads) of each instance of
    `kernel` in fused_encoder_layer.cu's ptxas report, and its SASS body."""
    bodies = _sass_bodies()
    out = []
    for name, (regs, stores, loads) in _build.ptxas_entries(
            _build.ptxas_report("fused_encoder_layer")).items():
        if kernel in name:
            short = name[name.index(kernel):]
            body = [b for n, b in bodies.items() if short in n]
            out.append((short, regs, stores, loads, body[0] if len(body) == 1 else ""))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,op", [("attention_int8_kernel", "IGMMA.64x"),
                                       ("attention_int8_sync_kernel", "IMMA")])
def test_int8attn_core_runs_igmma_and_does_not_spill(cuda, kernel, op):
    """K7's cores (at d_head 16/32/64, with and without their DUMP
    variants): the wgmma core runs the integer warpgroup MMA (IGMMA), the
    one-tile core mma.sync's (IMMA); neither spills."""
    found = _instances(kernel)
    assert len(found) == 6
    for name, regs, stores, loads, body in found:
        assert stores == loads == 0 and op in body, (name, regs, stores, loads)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,core", [(65, "sync"), (96, "sync"), (97, "wgmma"), (129, "wgmma"),
                                     (17, "sync"), (1025, "wgmma")])
def test_int8attn_layer_routes_its_core_by_length(cuda, Lx, core):
    """A K7 layer takes its mma.sync core up to 96 tokens and its wgmma core
    past them (`core_route`), each launch counted where the C code makes
    it."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7

    assert k7.core_route(Lx) == core
    ops = fel.layer_operands(_layers(1, 256, cuda)[0], H)
    x = torch.randn((4, Lx, D), generator=torch.Generator().manual_seed(8)).to(cuda,
                                                                              torch.bfloat16)
    k7.reset_launches()
    fel.reset_launches()
    k7.fused_encoder_layer_int8attn(x, ops, H)
    torch.cuda.synchronize()
    counted = fel.kernel_launches()
    assert counted["attention_int8_kernel"] == int(core == "wgmma")
    assert counted["attention_int8_sync_kernel"] == int(core == "sync")
    assert counted["cls_pool_kernel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("core", ["wgmma", "sync"])
@pytest.mark.parametrize("Lx,n_head,d", [(129, 8, D), (65, 8, 256), (1025, 8, D), (129, 2, D),
                                         (80, 4, D), (17, 4, 64)])
def test_int8attn_core_gives_the_same_bits_over_repeated_launches(cuda, Lx, n_head, d, core):
    """30 launches of K7's core in each form (the wgmma core: one block of
    one warpgroup a frame-head, its k and v loaded once by TMA; the mma.sync
    core: one block of four warps a frame-head) give the first launch's
    bits, and so does its DUMP variant's output."""
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7

    qkv = torch.randn((64 if Lx < 1000 else 8, Lx, 3 * d),
                      generator=torch.Generator().manual_seed(5)).to(cuda, torch.bfloat16)
    first = k7.attention_int8(qkv, n_head, core=core)
    again = [k7.attention_int8(qkv, n_head, core=core) for _ in range(29)]
    out, _ = k7.attention_int8(qkv, n_head, dump=True, core=core)
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in again) and torch.equal(first, out)


@pytest.mark.cuda
def test_cls_pool_runs_mma_and_does_not_spill(cuda):
    """K2's pooling kernel (cls_pool_kernel at d_model 64, 128 and 256, and
    256 with two head blocks) runs mma.sync (HMMA) and spills nothing."""
    found = _instances("cls_pool_kernel")
    assert len(found) == 4
    for name, regs, stores, loads, body in found:
        assert stores == loads == 0 and "HMMA" in body, (name, regs, stores, loads)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,n_head,d", [(129, 8, D), (65, 8, D), (1025, 8, D), (65, 8, 256),
                                         (17, 4, 64), (129, 2, D), (33, 16, 256), (1, 8, D),
                                         (16, 1, 64)])
def test_cls_pool_matches_its_plain_version(cuda, Lx, n_head, d):
    """K2's pooling kernel against `fel.cls_pool_reference` on the qt its
    stages give: within 1% in the L2 norm and the one-layer tolerance (the
    two sum the same bf16 products in other orders, so a bf16 p may round
    the other way); 30 launches give the same bits."""
    ops = fel.cls_operands(fel.layer_operands(_layers(1, 256, cuda, n_head, d)[0], n_head),
                           n_head)
    B = 64 if Lx < 1000 else 8
    x = torch.randn((B, Lx, d), generator=torch.Generator().manual_seed(Lx)).to(cuda,
                                                                               torch.bfloat16)
    q = (fel._mm(x[:, 0], ops[0][:, :d]) + ops[1][:d]).to(torch.bfloat16)
    qt = (fel._mm(q, ops[12]) + ops[14]).to(torch.bfloat16).reshape(B, n_head, d).contiguous()
    fel.reset_launches()
    got = fel.cls_pool(x, qt)
    again = [fel.cls_pool(x, qt) for _ in range(29)]
    want = fel.cls_pool_reference(x, qt)
    torch.cuda.synchronize()
    assert fel.stage_launches["cls_pool"] == 30
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 1e-2
    _assert_close(got, want, LAYER_TOL)
    assert all(torch.equal(got, o) for o in again)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,d", [_p(129, 512, 8), _p(1025, 1024, 8),
                                              _p(65, 1024, 8, d=256), _p(17, 256, 4, d=64),
                                              _p(129, 512, 2), _p(33, 256, 16, d=256)])
def test_cls_layer_matches_its_plain_version(cuda, Lx, ffn, n_head, d):
    """K2 (no K or V formed) against its own plain version, which rounds qt
    and xbar as it does, and against the plain layer for the CLS row, which
    rounds k and v: both within the one-layer tolerance; 30 launches give
    the same bits."""
    ops = fel.layer_operands(_layers(1, ffn, cuda, n_head, d)[0], n_head)
    cls_ops = fel.cls_operands(ops, n_head)
    x = torch.randn((37 if Lx < 1000 else 6, Lx, d),
                    generator=torch.Generator().manual_seed(6)).to(cuda, torch.bfloat16)
    got = fel.fused_encoder_layer_cls(x, cls_ops, n_head)
    again = [fel.fused_encoder_layer_cls(x, cls_ops, n_head) for _ in range(29)]
    torch.cuda.synchronize()
    assert all(torch.equal(got, o) for o in again)
    _assert_close(got, fel.fused_layer_cls_reference(x, cls_ops, n_head), LAYER_TOL)
    _assert_close(got, fel.fused_layer_reference(x, ops, n_head, 1), LAYER_TOL)


@pytest.mark.cuda
def test_int8attn_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7

    ops = fel.layer_operands(_layers(1, 256, cuda)[0], H)
    x = torch.randn((2, 17, D), device=cuda).bfloat16()
    with pytest.raises(ValueError):
        k7.fused_encoder_layer_int8attn(x.float(), ops, H)
    with pytest.raises(ValueError):
        k7.fused_encoder_layer_int8attn(x, ops, 5)  # d_head 128 / 5
    with pytest.raises(ValueError):
        k7.attention_int8(torch.randn((2, 17, 3 * 96), device=cuda).bfloat16(), 6)
    k7.reset_launches()
    k7.attention_int8(torch.randn((2, 17, 3 * D), device=cuda).bfloat16(), H)
    assert k7.launches == {"fused_encoder_layer_int8attn": 0, "attention_int8": 1}


@pytest.mark.cuda
def test_run_training_resumes_on_the_card_through_k3_and_k7(cuda, tmp_path, monkeypatch):
    """`run_training` of a small rawIQ model (d128/L2/H8, 17 tokens; K3 by
    VITIQ_TRAIN_STASH=0) for two epochs, then resumed to a third, with
    VITIQ_ATTN_INT8=1: every step launches K3 twice forward and twice
    backward, every evaluated batch (validation and test) K7 once and K2
    once, nothing else; the resumed run's history holds three epochs."""
    from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
    from vitiq_torch.runner import run_training

    monkeypatch.setenv("VITIQ_TRAIN_STASH", "0")
    monkeypatch.setenv("VITIQ_ATTN_INT8", "1")

    def cfg(epochs):
        return ExperimentConfig(
            model=ModelConfig(arm="rawiq", num_classes=3, d_model=128, n_head=8, n_layers=2,
                              ffn_hidden=256, seq_length=256, segment_size=16, numerics="tpu"),
            data=DataConfig(synthetic_frames_per_class=64, synthetic_frame_len=256),
            train=TrainConfig(batch_size=32, num_epochs=epochs, save_freq=1,
                              learning_rate=1e-3),
            experiment_name="exp", checkpoint_dir=str(tmp_path), log_dir=str(tmp_path / "logs"))

    steps, valid_b, test_b = 134 // 32, -(-28 // 32), -(-30 // 32)  # 70/15/15% of 192
    for epochs, resume in ((2, None), (3, "auto")):
        _reset_all()
        summary = run_training(cfg(epochs), resume=resume, verbose=False, device=cuda,
                               make_plots=False)
        torch.cuda.synchronize()
        run = epochs - (2 if resume else 0)
        want = {k: 0 for k in _all_launches()}
        want.update({"fused_train_layer_fwd": 2 * steps * run,
                     "fused_train_layer_bwd": 2 * steps * run,
                     "fused_encoder_layer_int8attn": run * valid_b + test_b,
                     "fused_encoder_layer_cls": run * valid_b + test_b})
        assert _all_launches() == want
    assert summary["epochs_run"] == 3 and len(summary["history"]["val_loss"]) == 3
    assert all(map(math.isfinite, summary["history"]["val_loss"]))
    assert 0.0 <= summary["test_overall_accuracy"] <= 1.0


# --------------------------------------------------------------------------
# the probes (P1-P3)
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", mask_ops.VARIANTS + mask_ops.MM_VARIANTS)
def test_probe_mask_op_kernels_match_plain_versions(cuda, name):
    mask_ops.reset_launches()
    assert mask_ops.check(name, cuda) >= 0.0  # raises where it disagrees
    assert mask_ops.launches[name] == 1
    regs, stores, loads = mask_ops.kernel_resources(name)
    assert regs > 0 and stores == loads == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nrefs,width", [(16, 128), (4, 512), (1, 2048), (64, 8)])
def test_probe_refcost_kernel_adds_one_bit_for_bit(cuda, nrefs, width):
    xs = refcost.arm_inputs(nrefs, width, 120, cuda)
    refcost.reset_launches()
    outs = refcost.refcost(xs, 40)
    torch.cuda.synchronize()
    assert refcost.launches == {refcost.arm_key(nrefs, width): 1}
    for got, want in zip(outs, refcost.refcost_reference(xs), strict=True):
        assert torch.equal(got, want)
    seed = torch.tensor(3.0, device=cuda)
    got = refcost.make_call(nrefs, width, 120, 40)(seed, *xs)
    got = [got] if nrefs == 1 else list(got)
    want = refcost.refcost_reference((xs[0] + seed.to(torch.bfloat16),) + xs[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.cuda
def test_probe_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    args = mask_ops.inputs(cuda)
    with pytest.raises(ValueError):
        mask_ops.mask_op("splat", args["x"].double())
    with pytest.raises(ValueError):
        mask_ops.mm_mask("mm_plain", args["xm"][:, :128], args["w"])
    with pytest.raises(ValueError):
        mask_ops.mask_op("mm_plain", args["x"])
    xs = refcost.arm_inputs(2, 128, 80, cuda)
    with pytest.raises(ValueError):
        refcost.refcost(xs, 30)
    with pytest.raises(ValueError):
        refcost.refcost(xs * 33, 40)
    with pytest.raises(ValueError):
        refcost.refcost((xs[0], xs[1][:40]), 40)


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,d", [
    _p(129, 512, 8), _p(65, 1024, 8), _p(17, 128, 8), _p(129, 512, 4), _p(129, 512, 2),
    _p(17, 256, 4, d=64)])
def test_probe_noexp_layer_matches_plain_version(cuda, Lx, ffn, n_head, d):
    B = 32
    ops = p3.stack_operands(1, d, ffn, n_head, cuda, seed=3)[0]
    x = torch.randn((B, Lx, d), generator=torch.Generator().manual_seed(1)).to(cuda,
                                                                                torch.bfloat16)
    p3.reset_launches()
    r = p3.check_layer(x, ops, n_head, all_rows=True)  # raises where it disagrees
    assert p3.launches["fused_encoder_layer_noexp"] == 1 and r["held"] > 0.5
    # and it is not K1: the exp is gone
    want = p3.fused_layer_noexp_reference(x, ops, n_head).float()
    k1 = fel.fused_encoder_layer(x, ops, n_head)
    assert ((k1.float() - want).norm() / want.norm()).item() > 10 * p3.LAYER_REL


# rawiq_best's d256 and the conv1d arm's 1025 tokens (65 key tiles): over
# the held rows only, since one frame row whose denominator's sign the bf16
# rounding of qkv decides moves a small batch's all-rows relative L2 past
# 1e-2 (rawiq_best at B=256 on the card)
@pytest.mark.cuda
@pytest.mark.parametrize("Lx,ffn,n_head,d,B", [
    pytest.param(65, 1024, 8, 256, 32, id="65-1024-8-d256"),
    pytest.param(65, 1024, 4, 256, 32, id="65-1024-4-d256"),
    pytest.param(1025, 1024, 8, 128, 4, id="1025-1024-8")])
def test_probe_noexp_layer_matches_plain_version_on_held_rows(cuda, Lx, ffn, n_head, d, B):
    ops = p3.stack_operands(1, d, ffn, n_head, cuda, seed=3)[0]
    x = torch.randn((B, Lx, d), generator=torch.Generator().manual_seed(1)).to(cuda,
                                                                                torch.bfloat16)
    assert p3.check_layer(x, ops, n_head, all_rows=False)["held"] > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("Lx,n_head,d,B", [
    (129, 8, 128, 32), (65, 8, 256, 32), (65, 4, 256, 32), (1025, 8, 128, 4),
    (129, 2, 128, 32), (17, 4, 64, 32), (40, 2, 64, 32)])
def test_probe_noexp_core_matches_plain_version_on_the_same_qkv(cuda, Lx, n_head, d, B):
    qkv = torch.randn((B, Lx, 3 * d), generator=torch.Generator().manual_seed(5))
    qkv = qkv.to(cuda, torch.bfloat16)
    p3.reset_launches()
    r = p3.check_core(qkv, n_head)  # raises where it disagrees
    assert p3.launches["attention_noexp"] == 1 and r["held"] > 0.5


@pytest.mark.cuda
def test_k1_attention_registers_unchanged_by_the_noexp_flag(cuda):
    """K1's one-pass core keeps the registers stated for it, spills nothing,
    and P3's NOEXP instance of the same core spills nothing."""
    for dh, regs in fel.K1_ATTENTION_REGISTERS.items():
        k1 = _build.kernel_resources("fused_encoder_layer", fel.attention_kernel_tag(dh))
        noexp = _build.kernel_resources("fused_encoder_layer", fel.attention_kernel_tag(dh, True))
        assert k1 == (regs, 0, 0), (dh, k1)
        assert noexp[1:] == (0, 0), (dh, noexp)


def _host_batches(n, B=512, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, 1024, 2)).astype(np.float32),
             rng.integers(0, 19, B).astype(np.int32), i) for i in range(n)]


def _same_bytes(got: torch.Tensor, want: np.ndarray) -> bool:
    return torch.equal(got.cpu().view(torch.int32), torch.from_numpy(want).view(torch.int32))


@pytest.mark.cuda
def test_prefetcher_copies_batches_to_the_card_byte_for_byte(cuda):
    batches = _host_batches(30)
    got = 0
    for (x, y, i), (dx, dy, di) in zip(batches, device_prefetch(iter(batches), cuda, 3)):
        assert dx.device == cuda and dy.device == cuda and di == i
        assert _same_bytes(dx, x) and _same_bytes(dy, y)
        got += 1
    assert got == 30


@pytest.mark.cuda
def test_prefetcher_copies_one_array_items(cuda):
    """An item that is one array (as vitiq's tree_map takes it) comes back as
    one tensor; its rows were once taken for the item's elements."""
    batches = [x for x, _, _ in _host_batches(6, seed=2)]
    got = list(device_prefetch(iter(batches), cuda, 2))
    assert len(got) == 6
    for x, dx in zip(batches, got):
        assert isinstance(dx, torch.Tensor) and dx.device == cuda and _same_bytes(dx, x)


@pytest.mark.cuda
def test_prefetcher_keeps_the_bits_while_the_consumer_sleeps(cuda):
    batches = _host_batches(30, seed=1)
    sums = []
    for dx, dy, i in device_prefetch(iter(batches), cuda, 2):
        time.sleep(0.01)  # the worker runs ahead and waits on its pinned buffers
        torch.cuda._sleep(2_000_000)  # the consumer's stream lags behind the copies
        sums.append((dx.view(torch.int32).sum(dtype=torch.int64), i))
        del dx, dy  # let go before the stream has read it
    torch.cuda.synchronize()
    for (x, _, i), (s, j) in zip(batches, sums):
        assert j == i
        assert int(s) == int(torch.from_numpy(x).view(torch.int32).sum(dtype=torch.int64))


# --------------------------------------------------------------------------
# the DSP front-end: timing_scan_kernel (csrc/timing.cu) and the FIR
# --------------------------------------------------------------------------

def _shaped_frames(B, frame_len, sps, seed=0):
    """RRC-shaped QPSK frames of `frame_len` samples at `sps`, [B, L, 2] f32."""
    from vitiq_torch.data import generate_test_signal

    return np.asarray([np.stack(generate_test_signal("QPSK", frame_len // sps, sps, 15.0,
                                                     seed=seed + b)[:2], -1)
                       for b in range(B)], np.float32)


def _filtered(cuda, B, frame_len, sps, seed=0):
    from vitiq_torch.dsp.filtering import matched_filter_batch

    return matched_filter_batch(torch.from_numpy(_shaped_frames(B, frame_len, sps, seed))
                                .to(cuda), sps)


@pytest.mark.cuda
@pytest.mark.parametrize("sps", [2, 4])
@pytest.mark.parametrize("window", [0, 64], ids=["full", "hybrid64"])
@pytest.mark.parametrize("method", ["gardner", "mueller_muller"])
def test_timing_scan_kernel_equals_its_plain_loop(cuda, method, window, sps):
    """The kernel rounds each product and sum on its own, as the plain loop's
    tensor operations do: the same positions and valid flags bit for bit,
    over the full loop (L//sps steps from sps) and the hybrid's window (from
    p0), and over 30 launches."""
    from vitiq_torch.ops.cuda import timing as tk

    x = _filtered(cuda, 256, 2048, sps, seed=sps)
    steps = window or 2048 // sps
    p0 = (torch.arange(256, device=cuda) % sps).float() + sps if window else None
    want = tk.timing_scan_plain(x, sps, steps, method, p0=p0)
    tk.reset_launches()
    got = tk.timing_scan(x, sps, steps, method, p0=p0)
    assert got[0].shape == (256, steps) and got[1].dtype == torch.bool
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for _ in range(30):
        again = tk.timing_scan(x, sps, steps, method, p0=p0)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    torch.cuda.synchronize()
    assert tk.launches["timing_scan"] == 31 and tk.kernel_launches() == 31


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gardner", "mueller_muller"])
def test_hybrid_positions_on_the_card_match_the_host(cuda, method):
    """The hybrid loop on the card (the kernel, then the circular mean on the
    card) against the same on the host (the plain loop): within 1e-3 of a
    sample (sin, cos and atan2 of two libraries)."""
    from vitiq_torch.dsp.timing import hybrid_positions

    x = _filtered(cuda, 64, 1024, 2, seed=7)
    got = hybrid_positions(x, 2, method)
    want = hybrid_positions(x.cpu(), 2, method)
    assert (got.cpu() - want).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("sps", [2, 4])
def test_fir_on_the_card_is_float32_not_tf32(cuda, sps):
    """The matched filter on the card within 1e-5 of the signal's peak from a
    float64 np.convolve (TF32 would show about 1e-3); the global TF32 flag
    is left as it was."""
    from vitiq_torch.dsp.filtering import matched_filter_batch
    from vitiq_torch.dsp.taps import rrc_filter

    before = torch.backends.cudnn.allow_tf32
    x = np.random.default_rng(sps).standard_normal((64, 2048, 2)).astype(np.float32)
    got = matched_filter_batch(torch.from_numpy(x).to(cuda), sps).cpu().numpy()
    taps = rrc_filter(sps=sps)
    want = np.stack([[np.convolve(xb[:, c].astype(np.float64), taps, mode="same")
                      for c in range(2)] for xb in x]).transpose(0, 2, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.cuda
def test_sps_serving_launches_the_scan_kernel(cuda):
    """A model served at sps 2 with each loop, hybrid and full, launches
    timing_scan_kernel once a request; the energy picker never."""
    from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig
    from vitiq_torch.models import AMCModel
    from vitiq_torch.ops.cuda import timing as tk
    from vitiq_torch.serve import build_serving_fn

    mcfg = ModelConfig(arm="rawiq", num_classes=5, d_model=64, n_head=4, n_layers=2,
                       ffn_hidden=128, seq_length=512, segment_size=16, numerics="tpu")
    x = torch.from_numpy(_shaped_frames(32, 1024, 2)).to(cuda)
    stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
    for method, window, want in (("gardner", 64, 1), ("gardner", 0, 1),
                                 ("mueller_muller", 64, 1), ("simple_energy", 64, 0)):
        cfg = ExperimentConfig(model=mcfg, data=DataConfig(
            synthetic_frame_len=1024, sps=2, timing_method=method,
            timing_hybrid_window=window))
        serve = build_serving_fn(cfg, AMCModel(mcfg, generator=torch.Generator().manual_seed(0)),
                                 stats, cuda)
        tk.reset_launches()
        logits = serve(x)
        torch.cuda.synchronize()
        assert tuple(logits.shape) == (32, 5) and torch.isfinite(logits).all()
        assert tk.launches["timing_scan"] == want and tk.kernel_launches() == want


@pytest.mark.cuda
def test_timing_scan_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from vitiq_torch.ops.cuda import timing as tk

    x = _filtered(cuda, 4, 256, 2)
    with pytest.raises(ValueError):
        tk.timing_scan(x.double(), 2, 8, "gardner")
    with pytest.raises(ValueError):
        tk.timing_scan(x.transpose(0, 1), 2, 8, "gardner")  # not contiguous
    with pytest.raises(ValueError):
        tk.timing_scan(x[..., :1].contiguous(), 2, 8, "gardner")
    with pytest.raises(ValueError):
        tk.timing_scan(x, 2, 8, "gardner", p0=torch.zeros(4))  # p0 on the host
    with pytest.raises(ValueError):
        tk.timing_scan(x, 2, 8, "psychic")


@pytest.mark.cuda
def test_timing_scan_kernel_does_not_spill(cuda):
    entries = {n: v for n, v in _build.ptxas_entries(_build.ptxas_report("timing")).items()
               if "timing_scan_kernel" in n}
    assert len(entries) == 2
    for name, (regs, stores, loads) in entries.items():
        assert (stores, loads) == (0, 0), name


# The serving artifact (`serve.ServingArtifact`): one CUDA graph a bucket.
# Its replay runs the kernels the eager `Server` runs on the same bytes (the
# padded rows zeroed in place of concatenated), so their logits agree bit
# for bit.
ARTIFACT_CASES = {
    "rawiq": (dict(arm="rawiq", seq_length=512, segment_size=16), {}),
    "vit": (dict(arm="vit", img_size_h=16, img_size_w=16, seq_length=128), {}),
    "rawiq-sps2-gardner": (dict(arm="rawiq", seq_length=256, segment_size=16),
                           dict(sps=2, timing_method="gardner")),
}


def _artifact(cuda, tmp_path, case="rawiq", buckets=(4, 16)):
    """(artifact loaded on the card, the eager Server of the same weights,
    frame_len) for a small model of ARTIFACT_CASES."""
    from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig
    from vitiq_torch.models import AMCModel
    from vitiq_torch.serve import Server, ServingArtifact, build_serving_fn, export_serving

    model_kw, data_kw = ARTIFACT_CASES[case]
    mcfg = ModelConfig(num_classes=5, d_model=64, n_head=4, n_layers=2, ffn_hidden=128,
                       numerics="tpu", **model_kw)
    frame_len = mcfg.seq_length * data_kw.get("sps", 1)
    cfg = ExperimentConfig(model=mcfg, data=DataConfig(synthetic_frame_len=frame_len, **data_kw))
    model = AMCModel(mcfg, generator=torch.Generator().manual_seed(0))
    stats = {"i_mean": 0.1, "i_std": 1.2, "q_mean": -0.05, "q_std": 0.9}
    art = ServingArtifact.load(export_serving(cfg, model, stats, tmp_path / "art", buckets),
                               device=cuda)
    server = Server(build_serving_fn(cfg, model, stats, cuda), frame_len, buckets, cuda)
    return art, server, frame_len


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ARTIFACT_CASES))
def test_artifact_graph_replay_equals_eager_server(cuda, case, tmp_path):
    art, server, frame_len = _artifact(cuda, tmp_path, case)
    want = {"fused_encoder_layer": 1, "fused_encoder_layer_cls": 1}
    if case.endswith("gardner"):
        want["timing_scan"] = 1
    assert art.captured_launches == {4: want, 16: want}
    x = torch.from_numpy(_shaped_frames(16, frame_len, 2)).to(cuda)
    for n in (1, 4, 7, 16):
        got = art.run(x[:n])
        assert got.dtype == torch.float32 and tuple(got.shape) == (n, 5)
        assert torch.equal(got, server.run(x[:n])), n


@pytest.mark.cuda
def test_artifact_result_survives_a_later_run(cuda, tmp_path):
    art, _, frame_len = _artifact(cuda, tmp_path)
    gen = torch.Generator().manual_seed(1)
    a = torch.randn((16, frame_len, 2), generator=gen).to(cuda)
    first = art.run(a)
    kept = first.clone()
    art.run(torch.randn((16, frame_len, 2), generator=gen).to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(first, kept)


@pytest.mark.cuda
def test_artifact_short_batch_after_a_full_one(cuda, tmp_path):
    """The rows a short batch leaves of its bucket are zeroed, whatever the
    full batch before it put there."""
    art, server, frame_len = _artifact(cuda, tmp_path)
    gen = torch.Generator().manual_seed(2)
    art.run(100.0 * torch.randn((16, frame_len, 2), generator=gen).to(cuda))
    short = torch.randn((9, frame_len, 2), generator=gen).to(cuda)
    assert torch.equal(art.run(short), server.run(short))


@pytest.mark.cuda
def test_artifact_capture_that_fails_raises(cuda, tmp_path, monkeypatch):
    """A serving function that reads the device from the host cannot be
    captured: loading raises, and nothing falls back to an eager run."""
    import vitiq_torch.serve as sv

    build = sv.build_serving_fn

    def syncing(*args, **kwargs):
        serve = build(*args, **kwargs)

        def f(x):
            out = serve(x)
            return out * (1.0 if out.sum().item() == out.sum().item() else 0.0)

        return f

    monkeypatch.setattr(sv, "build_serving_fn", syncing)
    with pytest.raises(RuntimeError):
        _artifact(cuda, tmp_path)


# --------------------------------------------------------------------------
# device-scan training: K train steps as one captured CUDA graph
# --------------------------------------------------------------------------

def _scan_setup(cuda, numerics="tpu", drop=0.1, seed=0):
    """A tiny rawIQ model (d64, 9 tokens: K4 under `tpu`) on the card with
    its train state, the scan step and four batches of raw frames."""
    from vitiq_torch.config import ModelConfig, TrainConfig
    from vitiq_torch.dsp.frontend import preprocess_batch_rawiq, zscore_constants
    from vitiq_torch.models import AMCModel
    from vitiq_torch.train.loop import make_train_scan_step, make_train_step
    from vitiq_torch.train.optim import create_train_state, make_optimizer

    cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=64, n_head=4, n_layers=2,
                      ffn_hidden=128, drop_prob=drop, seq_length=128, segment_size=16,
                      numerics=numerics)
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(seed)).to(cuda)
    tcfg = TrainConfig(learning_rate=1e-3)
    stats = zscore_constants({"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}, cuda)
    pre = lambda x: preprocess_batch_rawiq(x, stats)  # noqa: E731
    tx = make_optimizer(tcfg)
    gen = torch.Generator().manual_seed(seed + 1)
    xs = torch.randn((4, 32, 128, 2), generator=gen).to(cuda)
    ys = torch.randint(0, 3, (4, 32), generator=gen).to(cuda)
    return (model, create_train_state(model, tcfg), make_train_scan_step(tx, 0.1, pre),
            make_train_step(tx, 0.1, pre), xs, ys)


@pytest.mark.cuda
@pytest.mark.parametrize("numerics", ["tpu", "reference"])
def test_captured_scan_equals_eager_steps_bit_for_bit(cuda, numerics):
    """Three groups of K=4 steps at dropout 0.1 (under `tpu` through K4):
    the first group eager (the warm-up, which also captures), the next two
    replays of the graph, against twelve eager `make_train_step` steps from
    the same weights: losses, accuracies, parameters, moments and the step
    counter bit for bit; K4 launches only outside the replays."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    model_g, state_g, scan, _, xs, ys = _scan_setup(cuda, numerics)
    model_e, state_e, _, step, _, _ = _scan_setup(cuda, numerics)
    got, want = [], []
    for group in range(3):
        flt.reset_launches()
        state_g, losses, accs = scan(state_g, xs + group, ys, 1)
        if group:
            assert sum(flt.launches.values()) == 0  # the replay launches from the graph
        got.append((losses, accs))
        ms = [step(state_e, x, y, 1)[1] for x, y in zip(xs + group, ys)]
        want.append((torch.stack([m["loss"] for m in ms]),
                     torch.stack([m["accuracy"] for m in ms])))
    assert len(scan.graphs) == 1
    for (gl, ga), (wl, wa) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(ga, wa)
    for a, b in zip(model_g.parameters(), model_e.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(state_g.opt_state.mu, state_e.opt_state.mu)
    assert torch.equal(state_g.opt_state.nu, state_e.opt_state.nu)
    assert int(state_g.step) == int(state_e.step) == 12


@pytest.mark.cuda
def test_scan_replay_reads_the_new_learning_rate(cuda):
    """`set_learning_rate` fills the device scalar the graph reads: a replay
    after it takes the eager steps at the new rate, with no new capture."""
    from vitiq_torch.train.optim import set_learning_rate

    model_g, state_g, scan, _, xs, ys = _scan_setup(cuda, drop=0.0)
    model_e, state_e, _, step, _, _ = _scan_setup(cuda, drop=0.0)
    scan(state_g, xs, ys, 1)
    for x, y in zip(xs, ys):
        step(state_e, x, y, 1)
    set_learning_rate(state_g, 3e-4)
    set_learning_rate(state_e, 3e-4)
    scan(state_g, xs, ys, 1)
    for x, y in zip(xs, ys):
        step(state_e, x, y, 1)
    assert len(scan.graphs) == 1
    for a, b in zip(model_g.parameters(), model_e.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [False, True])
def test_k3_k4_read_the_seed_from_device_memory(cuda, stash):
    """K3 (recompute) and K4 (stash) at dropout 0.1 with the seed as a device
    tensor give the int seed's bits; captured in a CUDA graph with one seed
    and replayed after the tensor is filled with another, they give that
    other int seed's bits (forward and backward)."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    gen = torch.Generator().manual_seed(12)
    layer = EncoderLayer(64, 128, 4, device=cuda, generator=gen)
    ops = flt.flat_weights(layer, torch.bfloat16)
    x = torch.randn((16, 9, 64), generator=gen).to(cuda, torch.bfloat16)
    dy = (0.1 * torch.randn((16, 9, 64), generator=gen)).to(cuda, torch.bfloat16)

    def run(seed):
        if stash:
            y, st = flt.fused_train_layer_fwd_stash(x, ops, 4, 0.1, seed, 2)
            dx, grads = flt.fused_train_layer_bwd_stash(x, dy, st, ops, 4, 0.1, seed, 2)
        else:
            y = flt.fused_train_layer_fwd(x, ops, 4, 0.1, seed, 2)
            dx, grads = flt.fused_train_layer_bwd(x, dy, ops, 4, 0.1, seed, 2)
        return [y, dx, *grads]

    seed_t = torch.tensor([31], dtype=torch.int32, device=cuda)
    for a, b in zip(run(seed_t), run(31)):
        assert torch.equal(a, b)
    other = run(-977)
    assert not torch.equal(other[0], run(31)[0])
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        run(seed_t)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run(seed_t)
    seed_t.fill_(-977)
    graph.replay()
    for a, b in zip(captured, other):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,offset", [((4, 1025, 1024), 0), ((3, 17, 128), 0),
                                          ((2, 9, 96), 0), ((2, 5, 7), 0), ((2, 9, 64), 3)])
def test_hash_dropout_kernel_equals_its_plain_version(cuda, dtype, shape, offset):
    """The plain sites' dropout kernel at rate 0.1 (the conv1d arm's FFN
    hidden at B=4, an embedding, widths off the 16-byte path, a view at an
    unaligned offset) gives its plain version's bits for a device-tensor
    seed, forward and backward, counts one launch a call, and, captured in
    a CUDA graph and replayed after the seed tensor is filled with another
    value, that other seed's bits."""
    from vitiq_torch.ops.cuda import fused_layer_train as flt

    gen = torch.Generator().manual_seed(3)
    n = math.prod(shape)
    base = torch.randn((n + offset,), generator=gen).to(cuda, dtype)
    x = base[offset:].view(shape).requires_grad_(True)
    dy = torch.randn(shape, generator=gen).to(cuda, dtype)
    salt = flt.site_salt(5, 1)
    seed_t = torch.tensor([-41], dtype=torch.int32, device=cuda)
    flt.reset_launches()
    y = flt.hash_dropout(x, 0.1, seed_t, salt)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert flt.dropout_launches == {"hash_dropout": 2}
    want = flt.hash_dropout_plain(x.detach().cpu(), 0.1, -41, salt)
    assert torch.equal(y.cpu(), want)
    assert torch.equal(dx.cpu(), flt.hash_dropout_plain(dy.cpu(), 0.1, -41, salt))
    if n > 10_000:
        assert 0.09 < (want == 0).float().mean().item() < 0.11
    xd = x.detach()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        flt.hash_dropout_apply(xd, 0.1, seed_t, salt)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flt.hash_dropout_apply(xd, 0.1, seed_t, salt)
    seed_t.fill_(77)
    graph.replay()
    assert torch.equal(captured.cpu(), flt.hash_dropout_plain(xd.cpu(), 0.1, 77, salt))


@pytest.mark.cuda
def test_scan_capture_that_fails_raises(cuda):
    """A preprocess that reads the device from the host cannot be captured:
    the scan step raises after its eager warm-up group, and raises again on
    the next group; nothing falls back to eager steps."""
    from vitiq_torch.train.loop import make_train_scan_step
    from vitiq_torch.train.optim import make_optimizer
    from vitiq_torch.config import TrainConfig

    model, state, _, _, xs, ys = _scan_setup(cuda)

    def syncing(x):
        return (x * (1.0 if x.sum().item() == x.sum().item() else 0.0)).transpose(1, 2)

    scan = make_train_scan_step(make_optimizer(TrainConfig()), 0.1, syncing)
    with pytest.raises(RuntimeError):
        scan(state, xs, ys, 1)
    assert not scan.graphs
    with pytest.raises(RuntimeError):
        scan(state, xs, ys, 1)


@pytest.mark.cuda
def test_device_adamw_equals_the_host_form_on_the_card(cuda):
    """1,800 updates on the card, past the end of both bias-correction
    tables, with the clip active: the device form (the count, the learning
    rate and the tabulated corrections on the card) equals the former host
    form (the corrections computed on the host each update, from 0-d f32
    tensors, and copied over) bit for bit. The card's own f32 pow differs
    from the host's in the last bit at some counts, which the table avoids."""
    from vitiq_torch.config import TrainConfig
    from vitiq_torch.train import optim

    cfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-2)
    gen = torch.Generator().manual_seed(3)
    p0 = torch.randn(37, generator=gen).to(cuda)
    grads = (4 * torch.randn((1800, 37), generator=gen)).to(cuda)
    module = torch.nn.ParameterDict({"w": torch.nn.Parameter(p0.clone())})
    state = optim.create_train_state(module, cfg)
    tx = optim.make_optimizer(cfg)
    host_p, mu, nu = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    for i, g in enumerate(grads):
        (upd,), _ = tx.update([g], state.opt_state, [module["w"]])
        with torch.no_grad():
            module["w"].add_(upd)
        gn = torch.sqrt(torch.sum(torch.square(g)))
        gs = g * torch.clamp(cfg.grad_clip_max_norm / (gn + 1e-16), max=1.0)
        mu = cfg.adam_b1 * mu + (1.0 - cfg.adam_b1) * gs
        nu = cfg.adam_b2 * nu + (1.0 - cfg.adam_b2) * torch.square(gs)
        c = torch.tensor(float(i + 1), dtype=torch.float32)
        b1 = torch.tensor(cfg.adam_b1, dtype=torch.float32)
        b2 = torch.tensor(cfg.adam_b2, dtype=torch.float32)
        mhat = mu / (1.0 - torch.pow(b1, c)).to(cuda)
        vhat = nu / (1.0 - torch.pow(b2, c)).to(cuda)
        host_p = host_p + -cfg.learning_rate * (mhat / (torch.sqrt(vhat) + cfg.adam_eps)
                                                + cfg.weight_decay * host_p)
    assert torch.equal(module["w"].detach(), host_p)
    assert torch.equal(state.opt_state.nu, nu) and int(state.opt_state.count) == 1800
