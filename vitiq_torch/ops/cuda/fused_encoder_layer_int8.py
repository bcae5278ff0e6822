"""The int8 W8A8 fused encoder layer (K6): the wrapper of the CUDA kernel
`vitiq_encoder_layer_int8_full` in `vitiq_torch/csrc/fused_encoder_layer.cu`
and its plain PyTorch version (counterpart of
`vitiq/ops/pallas/fused_encoder_layer.py`, `fused_encoder_layer_v3_int8_stack`).

One layer on a bf16 [B, L, D] activation, every GEMM W8A8:
``int8_gemm(t) = (f32(rowquant(t) @ Wq^T) * s_row) * s_col + b``, with the
row scale ``s_row = max(max |t_row|, 1e-8) / 127`` over the whole bf16 row,
``rowquant(t) = clip(round_half_even(t / s_row), -127, 127)`` and the
weights quantized per output channel (`vitiq_torch.ops.quant`); the attention
core is K1's (bf16 q, k, v, exp2 after the row max, f32 sums). The q section
of the QKV scales and bias carries log2(e)/sqrt(dh), as in the TPU kernel.

`fused_encoder_layer_int8_stack` runs K6 on every full layer and, with
``cls_only``, K2 (`fused_encoder_layer_cls`) on the last layer's dequantized
weights (``W_q * s_col`` in f32, then bf16), as the TPU stack does.

The wrapper launches the kernel on a CUDA tensor (raising on any build,
launch or shape error) and runs the plain version, `fused_layer_int8_reference`,
on a CPU tensor. Its int8 products are f32 products of the integer operands:
|q_t q_w| summed over K <= 1040 stays below 2^24, so they are exact and equal
the kernel's int32 sums. `int8_gemm` runs one of K6's GEMM stages alone
(for tests and timing; it equals its plain version bit for bit).
`launches` counts kernel launches, one per layer or stage.

Tolerance of the kernel against the plain version (`chip_smoke.py`,
`tests/test_torch_cuda.py`): past the exact products, a one-ulp bf16 flip
in an activation (K1's attention core sums in another order) can move a
downstream quantized value by one level, 1/127 of its row's absmax. So the
layer is held by relative L2 and by a max counted in quantization steps (a
row's absmax / 127 of the plain output), not by bf16 ulps per element: one
layer within 1e-2 relative L2 and 2 steps; a stack (several layers, or
with the K2 tail) within 2e-2 and 4 steps. A single GEMM stage
(`int8_gemm`) is held bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import fused_encoder_layer as fel

ROW_SCALE_FLOOR = 1e-8
QMAX = 127

launches = {"fused_encoder_layer_int8": 0, "int8_gemm": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _stamp(layer):
    return tuple((b.data_ptr(), b._version) for b in layer.buffers())


def _cached(layer, key, build):
    """Operands cached on the layer per `key`, rebuilt when any of its
    buffers was replaced or updated in place."""
    stamp = _stamp(layer)
    cached = layer.kernel_operands.get(key)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    with torch.no_grad():
        ops = build()
    layer.kernel_operands[key] = (stamp, ops)
    return ops


def _q_scale(layer, n_head: int) -> float:
    d_model = layer.attention.w_q.weight_q.shape[0]
    return fel._LOG2E / math.sqrt(d_model // n_head)


def int8_layer_operands(layer, n_head: int) -> List[torch.Tensor]:
    """The 16 operands of a `QuantizedEncoderLayer` in K6's layout (the TPU
    stack's `layer_operands`): Wqkv [3D, D], Wo [D, D], W1 [F, D], W2 [D, F]
    int8 in nn.Linear's [out, in] layout, K contiguous; per-output-channel
    scales and biases f32, the q section of both multiplied by
    log2(e)/sqrt(d_head) in f32; LN parameters f32. Copies, cached."""
    att, ffn = layer.attention, layer.ffn
    scale = _q_scale(layer, n_head)

    def vec(t):
        return t.detach().to(torch.float32, copy=True)

    def build():
        lins = (att.w_q, att.w_k, att.w_v)
        return [
            torch.cat([lin.weight_q for lin in lins]).contiguous(),
            torch.cat([vec(att.w_q.scale) * scale, vec(att.w_k.scale), vec(att.w_v.scale)]),
            torch.cat([vec(att.w_q.bias) * scale, vec(att.w_k.bias), vec(att.w_v.bias)]),
            att.w_concat.weight_q.clone(), vec(att.w_concat.scale), vec(att.w_concat.bias),
            vec(layer.norm1.gamma), vec(layer.norm1.beta),
            ffn.linear1.weight_q.clone(), vec(ffn.linear1.scale), vec(ffn.linear1.bias),
            ffn.linear2.weight_q.clone(), vec(ffn.linear2.scale), vec(ffn.linear2.bias),
            vec(layer.norm2.gamma), vec(layer.norm2.beta),
        ]

    return _cached(layer, ("int8", n_head, att.w_q.weight_q.device), build)


def dequant_layer_operands(layer, n_head: int, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """K2's 12 operands (`fel.layer_operands`' layout) from a quantized
    layer's dequantized weights, ``W_q * s_col`` in f32 (the TPU stack's
    `_dequant_layer`, then `xpack_layer_operands`). Copies, cached."""
    att, ffn = layer.attention, layer.ffn
    scale = _q_scale(layer, n_head)

    def kernel(lin):  # dequantized [in, out] f32
        return (lin.weight_q.float() * lin.scale.float()[:, None]).t()

    def vec(t):
        return t.detach().to(torch.float32, copy=True)

    def build():
        wqkv = torch.cat([kernel(att.w_q) * scale, kernel(att.w_k), kernel(att.w_v)], dim=1)
        return [
            wqkv.to(dtype).contiguous(),
            torch.cat([vec(att.w_q.bias) * scale, vec(att.w_k.bias), vec(att.w_v.bias)]),
            kernel(att.w_concat).to(dtype).contiguous(), vec(att.w_concat.bias),
            vec(layer.norm1.gamma), vec(layer.norm1.beta),
            kernel(ffn.linear1).to(dtype).contiguous(), vec(ffn.linear1.bias),
            kernel(ffn.linear2).to(dtype).contiguous(), vec(ffn.linear2.bias),
            vec(layer.norm2.gamma), vec(layer.norm2.beta),
        ]

    return _cached(layer, ("dequant", n_head, dtype, att.w_q.weight_q.device), build)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def absmax_scale(t32: torch.Tensor, dim: int) -> torch.Tensor:
    """max(max |t| over `dim`, 1e-8) / 127 in f32, kept dims. The divisor
    is a tensor on t's device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which is not the IEEE quotient the kernel
    and the JAX package take."""
    amax = torch.clamp(t32.abs().amax(dim=dim, keepdim=True), min=ROW_SCALE_FLOOR)
    return amax / torch.tensor(float(QMAX), device=t32.device)


def row_quant(t: torch.Tensor):
    """[..., K] -> (integer-valued f32 values in [-127, 127], [..., 1] f32
    scales): symmetric absmax per row of the f32 values, round half to even."""
    t32 = t.float()
    scale = absmax_scale(t32, -1)
    return torch.clamp(torch.round(t32 / scale), -QMAX, QMAX), scale


def int8_gemm_reference(t: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """(f32(rowquant(t) @ wq^T) * s_row) * wscale + bias, f32; wq int8
    [N, K]. The f32 product of the integer operands is exact (K <= 1040)."""
    tq, s = row_quant(t)
    return torch.matmul(tq, wq.float().t()) * s * wscale + bias


def fused_layer_int8_reference(x: torch.Tensor, ops: Sequence[torch.Tensor],
                               n_head: int) -> torch.Tensor:
    """One full W8A8 layer: bf16 x [B, L, D] -> [B, L, D] in x's dtype."""
    wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 = ops
    dt = x.dtype
    qkv = int8_gemm_reference(x, wqkv, sqkv, bqkv).to(dt)
    attn = fel.attention_reference(qkv, n_head, x.shape[1])
    x1 = fel.layer_norm_reference(int8_gemm_reference(attn, wo, so, bo) + x.float(),
                                  g1, be1).to(dt)
    h = torch.relu(int8_gemm_reference(x1, w1, s1, b1)).to(dt)
    return fel.layer_norm_reference(int8_gemm_reference(h, w2, s2, b2) + x1.float(),
                                    g2, be2).to(dt)


def fused_encoder_layer_int8_stack_reference(x: torch.Tensor, ops_list, n_head: int,
                                             cls_ops=None) -> torch.Tensor:
    """Plain version of the stack: K6's plain version on each of `ops_list`,
    then, given `cls_ops` (the last layer's `dequant_layer_operands`), K2's
    for the CLS row, returning [B, 1, D]."""
    for ops in ops_list:
        x = fused_layer_int8_reference(x, ops, n_head)
    if cls_ops is not None:
        x = fel.fused_layer_reference(x, cls_ops, n_head, 1)
    return x


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

def _check_inputs(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int) -> int:
    """Validate what K6 takes; returns the FFN width."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 [B, L, D] tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    B, L, D = x.shape
    if len(ops) != 16:
        raise ValueError(f"expected 16 int8 layer operands, got {len(ops)}")
    F = ops[8].shape[0]
    fel.check_shape(B, L, D, F, n_head)  # K1's shapes (fel.fused_infer_supported)
    shapes = [(3 * D, D), (3 * D,), (3 * D,), (D, D), (D,), (D,), (D,), (D,),
              (F, D), (F,), (F,), (D, F), (D,), (D,), (D,), (D,)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        want = torch.int8 if len(shape) == 2 else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"operand {i}: want contiguous {want} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return F


def fused_encoder_layer_int8(x: torch.Tensor, ops: Sequence[torch.Tensor],
                             n_head: int) -> torch.Tensor:
    """K6: one full W8A8 layer, bf16 [B, L, D] -> bf16 [B, L, D]; the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_layer_int8_reference(x, ops, n_head)
    F = _check_inputs(x, ops, n_head)
    B, L, D = x.shape
    out = torch.empty_like(x)
    qkv = torch.empty((B, L, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    x1 = torch.empty_like(x)
    hid = torch.empty((B, L, F), dtype=x.dtype, device=x.device)
    aq = torch.empty((B, L, D), dtype=torch.int8, device=x.device)
    ascale = torch.empty((B, L), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vitiq_encoder_layer_int8_full(
            x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(),
            hid.data_ptr(), aq.data_ptr(), ascale.data_ptr(), *(t.data_ptr() for t in ops),
            B, L, D, n_head, F, stream)
    if err != 0:
        raise RuntimeError(f"vitiq_encoder_layer_int8_full failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
    launches["fused_encoder_layer_int8"] += 1
    return out


def int8_gemm(a: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor, bias: torch.Tensor,
              relu: bool = False, prequant: bool = False) -> torch.Tensor:
    """One of K6's GEMM stages alone (row quantization, s8 products,
    dequant + bias [+ ReLU] epilogue): bf16 a [M, K], int8 wq [N, K] ->
    bf16 [M, N]; with `prequant` the rows are quantized by a separate pass
    first (as K6's QKV and FFN1 stages take them; K <= 1024), else inside the
    GEMM (as its out-projection and FFN2 stages do). Equal bit for bit to its
    plain version, `int8_gemm_reference` rounded to bf16 (same row scales,
    levels, exact sums, same f32 epilogue). Not on the serving path: it
    exposes the stage to tests and timing."""
    if a.device.type == "cpu":
        y = int8_gemm_reference(a, wq, wscale, bias)
        return (torch.relu(y) if relu else y).to(a.dtype)
    M, K = a.shape
    N = wq.shape[0]
    if (a.dtype != torch.bfloat16 or not a.is_contiguous() or K % 64 or N % 64
            or (prequant and K > 1024)
            or tuple(wq.shape) != (N, K) or wq.dtype != torch.int8 or not wq.is_contiguous()
            or any(t.dtype != torch.float32 or tuple(t.shape) != (N,) for t in (wscale, bias))
            or any(t.device != a.device for t in (wq, wscale, bias))):
        raise ValueError("int8_gemm takes contiguous bf16 a [M, K], int8 wq [N, K] and f32 "
                         "wscale, bias [N] on one CUDA device, K % 64 == 0, N % 64 == 0 "
                         "(and K <= 1024 with prequant)")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    aq = torch.empty((M, K) if prequant else (1,), dtype=torch.int8, device=a.device)
    ascale = torch.empty((M if prequant else 1,), dtype=torch.float32, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.vitiq_gemm_int8(a.data_ptr(), wq.data_ptr(), wscale.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), aq.data_ptr(),
                                  ascale.data_ptr(), M, K, N, int(relu), int(prequant), stream)
    if err != 0:
        raise RuntimeError(f"vitiq_gemm_int8 failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
    launches["int8_gemm"] += 1
    return out


def fused_encoder_layer_int8_stack(x: torch.Tensor, qlayers, n_head: int,
                                   cls_only: bool = False) -> torch.Tensor:
    """Run `QuantizedEncoderLayer` modules as the int8 inference stack on bf16
    x [B, L, D]: K6 on every full layer, then with ``cls_only`` K2 on the last
    layer's dequantized weights for the CLS row; returns [B, L, D], or
    [B, 1, D] with ``cls_only``."""
    full = qlayers[:-1] if cls_only else qlayers
    for layer in full:
        x = fused_encoder_layer_int8(x, int8_layer_operands(layer, n_head), n_head)
    if cls_only:
        x = fel.fused_encoder_layer_cls(x, dequant_layer_operands(qlayers[-1], n_head), n_head)
    return x
