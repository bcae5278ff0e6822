"""Fused post-norm encoder layers for inference: the wrappers of the CUDA
kernels in `vitiq_torch/csrc/fused_encoder_layer.cu` and their plain PyTorch
version (counterpart of `vitiq/ops/pallas/fused_encoder_layer.py`,
`fused_encoder_layer_v3_stack`).

* K1 (`fused_encoder_layer`): one full layer, [B, L, D] -> [B, L, D].
* K2 (`fused_encoder_layer_cls`): the layer for query row 0 (the CLS token)
  only, with K and V over every token: [B, L, D] -> [B, 1, D].

Each wrapper launches its kernel on a CUDA tensor (raising on any build,
launch or shape error) and runs its plain version, `fused_layer_reference`,
on a CPU tensor: q pre-scaled by log2(e)/sqrt(dh) in the weights, exp2 after
the row max is subtracted, f32 numerators and denominators over the valid
keys, a divide, and rounding to the activation dtype where the kernels round
to bf16. `fused_encoder_layer_stack` runs a layer stack through the wrappers;
`fused_encoder_layer_stack_reference` is the plain version of the stack.

`launches` counts kernel launches, one per call of a C entry point (K1 runs
one entry call per layer); the plain versions count nothing.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from vitiq_torch.ops.cuda import _build

LN_EPS = 1e-12
_LOG2E = 1.4426950408889634
SUPPORTED_D_MODEL = 128
SUPPORTED_D_HEAD = (16, 32)

launches = {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def layer_operands(layer, n_head: int, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """The 12 operands of one layer in the kernel's layout (counterpart of
    `xpack_layer_operands`): Wqkv [D, 3D], Wo [D, D], W1 [D, F], W2 [F, D] in
    `dtype`; biases and LN parameters in f32. The q columns of Wqkv and b_q
    are multiplied by log2(e)/sqrt(d_head) in f32 before the cast.

    Cached on the layer (`EncoderLayer.kernel_operands`) per (n_head, dtype,
    device) together with the storage and version counter of every parameter
    it reads: an in-place update (an optimizer step) or a loaded state dict
    rebuilds the operands. Every cached operand is a copy, never a view of a
    parameter."""
    att = layer.attention
    key = (n_head, dtype, att.w_q.weight.device)
    stamp = tuple((p.data_ptr(), p._version) for p in layer.parameters())
    cached = layer.kernel_operands.get(key)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    d_model = att.w_q.weight.shape[0]
    scale = _LOG2E / math.sqrt(d_model // n_head)

    def kernel(lin):  # torch [out, in] -> [in, out]
        return lin.weight.detach().float().t()

    def vec(t):
        return t.detach().to(torch.float32, copy=True)

    with torch.no_grad():
        wqkv = torch.cat([kernel(att.w_q) * scale, kernel(att.w_k), kernel(att.w_v)], dim=1)
        bqkv = torch.cat([vec(att.w_q.bias) * scale, vec(att.w_k.bias), vec(att.w_v.bias)])
        ops = [
            wqkv.to(dtype).contiguous(), bqkv,
            kernel(att.w_concat).to(dtype).contiguous(), vec(att.w_concat.bias),
            vec(layer.norm1.gamma), vec(layer.norm1.beta),
            kernel(layer.ffn.linear1).to(dtype).contiguous(), vec(layer.ffn.linear1.bias),
            kernel(layer.ffn.linear2).to(dtype).contiguous(), vec(layer.ffn.linear2.bias),
            vec(layer.norm2.gamma), vec(layer.norm2.beta),
        ]
    layer.kernel_operands[key] = (stamp, ops)
    return ops


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of the stored operands accumulated in f32 (exact bf16 products)."""
    return torch.matmul(a.float(), b.float())


def _layer_norm(v: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    mean = v.mean(dim=-1, keepdim=True)
    d = v - mean
    var = d.square().mean(dim=-1, keepdim=True)
    return gamma * (d * torch.rsqrt(var + LN_EPS)) + beta


def fused_layer_reference(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                          n_q: int) -> torch.Tensor:
    """One layer for query rows [0, n_q): x [B, L, D] -> [B, n_q, D]."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    dt = x.dtype
    B, L, D = x.shape
    dh = D // n_head
    qkv = (_mm(x, wqkv) + bqkv).to(dt)

    def heads(t, rows):  # [B, rows, D] -> [B, H, rows, dh] f32
        return t.float().reshape(B, rows, n_head, dh).transpose(1, 2)

    q = heads(qkv[:, :n_q, :D], n_q)
    k = heads(qkv[:, :, D:2 * D], L)
    v = heads(qkv[:, :, 2 * D:], L)
    s = q @ k.transpose(-1, -2)  # log2 units: q carries log2(e)/sqrt(dh)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(dt).float()
    attn = ((p @ v) / p.sum(dim=-1, keepdim=True)).to(dt)
    attn = attn.transpose(1, 2).reshape(B, n_q, D)
    x1 = _layer_norm(_mm(attn, wo) + bo + x[:, :n_q].float(), g1, be1).to(dt)
    h = torch.relu(_mm(x1, w1) + b1).to(dt)
    return _layer_norm(_mm(h, w2) + b2 + x1.float(), g2, be2).to(dt)


def fused_encoder_layer_stack_reference(x: torch.Tensor, ops_list, n_head: int,
                                        cls_only: bool = False) -> torch.Tensor:
    """Plain version of the stack: full layers, then (with ``cls_only``) the
    last layer for the CLS row only, returning [B, 1, D]."""
    full = ops_list[:-1] if cls_only else ops_list
    for ops in full:
        x = fused_layer_reference(x, ops, n_head, x.shape[1])
    if cls_only:
        x = fused_layer_reference(x, ops_list[-1], n_head, 1)
    return x


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _check_inputs(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int) -> int:
    """Validate what the kernels take; returns the FFN width."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 [B, L, D] tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    B, L, D = x.shape
    if B == 0 or L == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if D != SUPPORTED_D_MODEL or D % n_head or D // n_head not in SUPPORTED_D_HEAD:
        raise ValueError(f"kernels take d_model={SUPPORTED_D_MODEL} with d_head in "
                         f"{SUPPORTED_D_HEAD}; got d_model={D}, n_head={n_head}")
    if len(ops) != 12:
        raise ValueError(f"expected 12 layer operands, got {len(ops)}")
    F = ops[6].shape[-1]
    if F % 128:
        raise ValueError(f"FFN width must be a multiple of 128, got {F}")
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,),
              (D, F), (F,), (F, D), (D,), (D,), (D,)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        want = torch.bfloat16 if len(shape) == 2 else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"operand {i}: want contiguous {want} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return F


def _launch(entry: str, counter: str, x: torch.Tensor, out: torch.Tensor, ops,
            n_head: int, F: int, rows: int) -> None:
    """Allocate the scratch, launch one C entry point, raise on its error,
    count the launch."""
    B, L, D = x.shape
    qkv = torch.empty((B, L, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty((B, rows, D), dtype=x.dtype, device=x.device)
    x1 = torch.empty((B, rows, D), dtype=x.dtype, device=x.device)
    hid = torch.empty((B, rows, F), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            x1.data_ptr(), hid.data_ptr(), *(t.data_ptr() for t in ops),
            B, L, D, n_head, F, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
    launches[counter] += 1


def fused_encoder_layer(x: torch.Tensor, ops: Sequence[torch.Tensor],
                        n_head: int) -> torch.Tensor:
    """K1: one full layer, bf16 [B, L, D] -> bf16 [B, L, D]; the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_layer_reference(x, ops, n_head, x.shape[1])
    F = _check_inputs(x, ops, n_head)
    out = torch.empty_like(x)
    _launch("vitiq_encoder_layer_full", "fused_encoder_layer", x, out, ops, n_head, F, x.shape[1])
    return out


def fused_encoder_layer_cls(x: torch.Tensor, ops: Sequence[torch.Tensor],
                            n_head: int) -> torch.Tensor:
    """K2: the layer for the CLS row only, bf16 [B, L, D] -> bf16 [B, 1, D];
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_layer_reference(x, ops, n_head, 1)
    F = _check_inputs(x, ops, n_head)
    out = torch.empty((x.shape[0], 1, x.shape[2]), dtype=x.dtype, device=x.device)
    _launch("vitiq_encoder_layer_cls", "fused_encoder_layer_cls", x, out, ops, n_head, F, 1)
    return out


def fused_encoder_layer_stack(x: torch.Tensor, layers, n_head: int,
                              cls_only: bool = False) -> torch.Tensor:
    """Run `EncoderLayer` modules as the fused inference stack on x [B, L, D]
    (the compute dtype) through the K1/K2 wrappers; returns [B, L, D], or
    [B, 1, D] with ``cls_only``."""
    ops_list = [layer_operands(layer, n_head, x.dtype) for layer in layers]
    full = ops_list[:-1] if cls_only else ops_list
    for ops in full:
        x = fused_encoder_layer(x, ops, n_head)
    if cls_only:
        x = fused_encoder_layer_cls(x, ops_list[-1], n_head)
    return x
