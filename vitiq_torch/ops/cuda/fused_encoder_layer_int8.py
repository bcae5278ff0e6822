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

The kernel runs the layer as four s8 GEMM stages on Hopper's s8 wgmma
(`gemm_s8_kernel` on the persistent main loop of `csrc/gemm_wgmma.cuh`)
around K1's attention core, each row quantized where whole rows already
are (`s8_stage_plan` lists the stages and their shared memory):
  QKV       x's levels (a row-quantization pass, or the previous layer's
            FFN2 epilogue) -> qkv;
  out-proj  attn quantized in registers (its scales from the whole rows in
            the stage's tile) + LN1 -> x1, whose epilogue also writes x1's
            levels and zeroes hid's row-max scratch;
  FFN1      x1's levels + ReLU -> hid, each row's max over the stage's slab
            merged into the scratch by atomicMax on its f32 bits;
  FFN2      hid quantized in registers by the scratch's max + LN2 -> y, and
            y's levels for the next layer where asked.
`qkv_stage`, `out_proj_stage`, `ffn1_stage` and `ffn2_stage` run one stage
alone as the layer launches it; `s8_stage_reference` is their plain
version, and chained in launch order they equal the plain layer bit for bit
(`fused_layer_int8_staged`).

`fused_encoder_layer_int8_stack` runs K6 on every full layer, each layer's
levels carried to the next, and, with ``cls_only``, K2
(`fused_encoder_layer_cls`) on the last layer's dequantized weights
(``W_q * s_col`` in f32, then bf16), as the TPU stack does.

The wrappers launch the kernel on a CUDA tensor (raising on any build,
launch or shape error) and run the plain version on a CPU tensor. The int8
products are f32 products of the integer operands: |q_t q_w| summed over K
<= 1040 stays below 2^24, so they are exact and equal the kernel's s32 sums.
`int8_gemm` runs one GEMM stage alone with its rows quantized by the
separate pass or in the stage (for tests and timing; it equals its plain
version bit for bit). `launches` counts kernel launches, one per layer or
stage.

Tolerance of the kernel against the plain version (`chip_smoke.py`,
`tests/test_torch_cuda.py`): past the exact products, a one-ulp bf16 flip
in an activation (K1's attention core and the LayerNorm statistics sum in
another order) can move a downstream quantized value by one level, 1/127 of
its row's absmax. So the layer is held by relative L2 and by a max counted
in quantization steps (a row's absmax / 127 of the plain output), not by
bf16 ulps per element: one layer within 1e-2 relative L2 and 2 steps; a
stack (several layers, or with the K2 tail) within 2e-2 and 4 steps. The
bias and ReLU stages are held bit for bit, the LayerNorm stages by the
layer's tolerance, their levels and scales bit for bit to `row_quant` of
their own bf16 output.
"""

from __future__ import annotations

import math
import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
    """K2's 15 operands (`fel.cls_operands`: `fel.layer_operands`' 12, then
    its block operands) from a quantized layer's dequantized weights, ``W_q *
    s_col`` in f32 (the TPU stack's `_dequant_layer`, then
    `xpack_layer_operands`). Copies, cached."""
    att, ffn = layer.attention, layer.ffn
    scale = _q_scale(layer, n_head)

    def kernel(lin):  # dequantized [in, out] f32
        return (lin.weight_q.float() * lin.scale.float()[:, None]).t()

    def vec(t):
        return t.detach().to(torch.float32, copy=True)

    def build():
        wqkv = torch.cat([kernel(att.w_q) * scale, kernel(att.w_k), kernel(att.w_v)], dim=1)
        return fel.cls_operands([
            wqkv.to(dtype).contiguous(),
            torch.cat([vec(att.w_q.bias) * scale, vec(att.w_k.bias), vec(att.w_v.bias)]),
            kernel(att.w_concat).to(dtype).contiguous(), vec(att.w_concat.bias),
            vec(layer.norm1.gamma), vec(layer.norm1.beta),
            kernel(ffn.linear1).to(dtype).contiguous(), vec(ffn.linear1.bias),
            kernel(ffn.linear2).to(dtype).contiguous(), vec(ffn.linear2.bias),
            vec(layer.norm2.gamma), vec(layer.norm2.beta),
        ], n_head)

    return _cached(layer, ("dequant", n_head, dtype, att.w_q.weight_q.device), build)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

class Levels(NamedTuple):
    """Rows quantized as `row_quant` gives them: int8 levels [..., K] and f32
    scales [...]."""
    q: torch.Tensor
    scale: torch.Tensor


def absmax_scale(t32: torch.Tensor, dim: int) -> torch.Tensor:
    """max(max |t| over `dim`, 1e-8) / 127 in f32, kept dims. The divisor
    is a tensor on t's device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which is not the IEEE quotient the kernel
    and the JAX package take."""
    return scale_of_absmax(t32.abs().amax(dim=dim, keepdim=True))


def scale_of_absmax(amax: torch.Tensor) -> torch.Tensor:
    """A row's scale from its f32 absmax: max(amax, 1e-8) / 127."""
    return (torch.clamp(amax, min=ROW_SCALE_FLOOR)
            / torch.tensor(float(QMAX), device=amax.device))


def row_quant(t: torch.Tensor):
    """[..., K] -> (integer-valued f32 values in [-127, 127], [..., 1] f32
    scales): symmetric absmax per row of the f32 values, round half to even."""
    t32 = t.float()
    scale = absmax_scale(t32, -1)
    return torch.clamp(torch.round(t32 / scale), -QMAX, QMAX), scale


def levels_of(t: torch.Tensor) -> Levels:
    """`row_quant` of t as the kernels store it: int8 levels, f32 scales."""
    q, scale = row_quant(t)
    return Levels(q.to(torch.int8), scale.squeeze(-1))


def int8_gemm_reference(t: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """(f32(rowquant(t) @ wq^T) * s_row) * wscale + bias, f32; wq int8
    [N, K]. The f32 product of the integer operands is exact (K <= 1040)."""
    tq, s = row_quant(t)
    return _dequant_gemm(tq, s, wq, wscale, bias)


def _dequant_gemm(tq, s, wq, wscale, bias):
    return torch.matmul(tq, wq.float().t()) * s * wscale + bias


def row_max_bits(slab_maxes: torch.Tensor) -> torch.Tensor:
    """The merge of FFN1's epilogue: each row's max over its slabs' maxes
    [..., n_slabs] (non-negative f32, one per slab) taken as an integer max of
    their f32 bits, as `atomicMax` on the bits does in any order; int32 bits
    [...]. Non-negative floats order as their bit patterns do."""
    return slab_maxes.float().contiguous().view(torch.int32).amax(dim=-1)


def s8_stage_reference(wq: torch.Tensor, wscale: torch.Tensor, bias: torch.Tensor, *,
                       a: Optional[torch.Tensor] = None, levels: Optional[Levels] = None,
                       amax: Optional[torch.Tensor] = None, relu: bool = False,
                       ln: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                       slab: Optional[int] = None):
    """Plain version of one of K6's s8 stages on [M, K] rows (the function
    of `vitiq_gemm_s8_stage`): A from `levels`, or bf16 `a` quantized with
    the scales of its whole rows, or of `amax` (the rows' absmax as int32 f32
    bits); (f32(A_q Wq^T) * s_row) * s_col + bias; then ReLU, or with
    ln = (res, gamma, beta) + res and LayerNorm; bf16. Returns (y, hmax,
    levels): with relu and `slab`, hmax is each row's max taken per `slab`
    columns and merged by `row_max_bits`; with ln, levels are y's
    `levels_of` (else None)."""
    if levels is not None:
        tq, s = levels.q.float(), levels.scale.float()[:, None]
    elif amax is not None:
        s = scale_of_absmax(amax.view(torch.float32)[:, None])
        tq = torch.clamp(torch.round(a.float() / s), -QMAX, QMAX)
    else:
        tq, s = row_quant(a)
    y = _dequant_gemm(tq, s, wq, wscale, bias)
    hmax = out = None
    if ln is not None:
        res, gamma, beta = ln
        y = fel.layer_norm_reference(y + res.float(), gamma, beta).to(torch.bfloat16)
        out = levels_of(y)
    else:
        y = (torch.relu(y) if relu else y).to(torch.bfloat16)
        if relu and slab is not None:
            hmax = row_max_bits(y.float().unflatten(-1, (-1, slab)).amax(dim=-1))
    return y, hmax, out


def fused_layer_int8_reference(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                               x_levels: Optional[Levels] = None) -> torch.Tensor:
    """One full W8A8 layer: bf16 x [B, L, D] -> [B, L, D] in x's dtype;
    x_levels, x's `levels_of` where the caller has them."""
    wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 = ops
    dt = x.dtype
    if x_levels is None:
        qkv = int8_gemm_reference(x, wqkv, sqkv, bqkv).to(dt)
    else:
        qkv = _dequant_gemm(x_levels.q.float(), x_levels.scale.float()[..., None], wqkv, sqkv,
                            bqkv).to(dt)
    attn = fel.attention_reference(qkv, n_head, x.shape[1])
    x1 = fel.layer_norm_reference(int8_gemm_reference(attn, wo, so, bo) + x.float(),
                                  g1, be1).to(dt)
    h = torch.relu(int8_gemm_reference(x1, w1, s1, b1)).to(dt)
    return fel.layer_norm_reference(int8_gemm_reference(h, w2, s2, b2) + x1.float(),
                                    g2, be2).to(dt)


def fused_layer_int8_staged(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                            x_levels: Optional[Levels] = None):
    """The layer as the kernel chains its stages (`s8_stage_reference` for
    each, in launch order, each row quantized where the kernel quantizes it:
    x's levels given or from `levels_of`, x1's from the out-projection's
    epilogue, hid's row scale from FFN1's per-slab maxes merged on their
    bits); returns (y, y's levels). Equal to `fused_layer_int8_reference`
    bit for bit."""
    wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 = ops
    B, L, D = x.shape
    F = w1.shape[0]
    rows = x.reshape(B * L, D)
    if x_levels is None:
        x_levels = levels_of(rows)
    x_levels = Levels(x_levels.q.reshape(B * L, D), x_levels.scale.reshape(B * L))
    qkv, _, _ = s8_stage_reference(wqkv, sqkv, bqkv, levels=x_levels)
    attn = fel.attention_reference(qkv.reshape(B, L, 3 * D), n_head, L).reshape(B * L, D)
    x1, _, x1_levels = s8_stage_reference(wo, so, bo, a=attn, ln=(rows, g1, be1))
    hid, hmax, _ = s8_stage_reference(w1, s1, b1, levels=x1_levels, relu=True,
                                      slab=s8_slab_width(F))
    y, _, y_levels = s8_stage_reference(w2, s2, b2, a=hid, amax=hmax, ln=(x1, g2, be2))
    return y.reshape(B, L, D), Levels(y_levels.q.reshape(B, L, D), y_levels.scale.reshape(B, L))


def fused_encoder_layer_int8_stack_reference(x: torch.Tensor, ops_list, n_head: int,
                                             cls_ops=None) -> torch.Tensor:
    """Plain version of the stack: K6's plain version on each of `ops_list`,
    then, given `cls_ops` (the last layer's `dequant_layer_operands`), K2's
    for the CLS row, returning [B, 1, D]."""
    for ops in ops_list:
        x = fused_layer_int8_reference(x, ops, n_head)
    if cls_ops is not None:
        x = fel.fused_layer_cls_reference(x, cls_ops, n_head)
    return x


# --------------------------------------------------------------------------
# the s8 stages' plan (the kernel's launch_s8, gemm_ring)
# --------------------------------------------------------------------------

GW_MAX_RING = 6
# the widths N of wgmma.mma_async m64nNk32 with s8 operands (PTX ISA)
S8_WGMMA_N = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 256)
# gemm_s8_kernel<Op, BN, RESIDENT> instances in the build: the products
# ("s8": int8 levels, "quant_a": bf16 rows quantized in registers), the slab
# width and whether W is resident
S8_INSTANCES = tuple((op, bn, resident) for op in ("s8", "quant_a") for bn in (64, 128, 256)
                     for resident in (True, False))


class S8Stage(NamedTuple):
    stage: str       # "qkv", "out_proj", "ffn1", "ffn2"
    op: str          # "s8" (A as int8 levels) or "quant_a" (bf16 A quantized in registers)
    n: int           # columns
    k: int           # depth
    bn: int          # slab width (wgmma's N)
    resident: bool   # W's slab kept in shared memory (K <= 256), else streamed
    ring: int        # ring entries
    smem: int        # bytes of shared memory


def s8_slab_width(n: int) -> int:
    """`s8_slab_width`: the whole width where it is 64, 128 or 256, else the
    widest of 256, 128, 64 that divides it."""
    if n in (64, 128, 256):
        return n
    return next(w for w in (256, 128, 64) if n % w == 0)


def s8_smem_bytes(op: str, bn: int, k: int, resident: bool, ring: int) -> int:
    """Shared memory of an s8 stage with `ring` entries (`gemm_smem_bytes`
    with the s8 element sizes): 1 KB of alignment, W's slab [BN, chunks of
    128 bytes] (resident), the entries (an A tile, or a 128-deep step of A
    [128 rows] and B [BN rows]), the epilogue's four BN-float vectors, the
    mbarriers."""
    a_boxes = 2 if op == "quant_a" else 1  # 128-byte A boxes a chunk
    chunks = (k + 127) // 128
    entry = chunks * a_boxes * 8192 if resident else a_boxes * 16384 + bn * 128
    return (1024 + 16 * bn + 8 * (1 + 2 * GW_MAX_RING) + (bn * chunks * 128 if resident else 0)
            + ring * entry)


def s8_ring(op: str, bn: int, k: int, resident: bool) -> int:
    """The ring's depth in what MAX_SHARED_MEMORY leaves (`gemm_ring`): 0
    where two entries do not fit, at most GW_MAX_RING."""
    fixed = s8_smem_bytes(op, bn, k, resident, 0)
    ring = (fel.MAX_SHARED_MEMORY - fixed) // (s8_smem_bytes(op, bn, k, resident, 1) - fixed)
    return 0 if ring < 2 else min(ring, GW_MAX_RING)


def s8_stage_plan(D: int, F: int) -> List[S8Stage]:
    """K6's four s8 stages at d_model D and FFN width F in launch order, each
    with the instance and shared memory the kernel gives it."""
    out = []
    for stage, op, n, k in (("qkv", "s8", 3 * D, D), ("out_proj", "quant_a", D, D),
                            ("ffn1", "s8", F, D), ("ffn2", "quant_a", D, F)):
        bn, resident = s8_slab_width(n), k <= 256
        ring = s8_ring(op, bn, k, resident)
        out.append(S8Stage(stage, op, n, k, bn, resident, ring,
                           s8_smem_bytes(op, bn, k, resident, ring)))
    return out


def s8_instance_of(name: str):
    """(op, bn, resident) of a gemm_s8_kernel<Op, BN, RESIDENT> instance from
    its mangled name (in a `ptxas -v` report or SASS), else None."""
    found = re.search(r"gemm_s8_kernel\w*?(MmaS8QuantA|MmaS8)E\w*?Li(\d+)ELb(\d)E", name)
    if not found:
        return None
    op, bn, resident = found.groups()
    return ("quant_a" if op == "MmaS8QuantA" else "s8", int(bn), resident == "1")


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


def _check_levels(levels: Levels, shape, device) -> None:
    q, scale = levels
    if (q.dtype != torch.int8 or tuple(q.shape) != tuple(shape) or scale.dtype != torch.float32
            or tuple(scale.shape) != tuple(shape[:-1]) or q.device != device
            or scale.device != device or not q.is_contiguous() or not scale.is_contiguous()):
        raise ValueError(f"levels must be contiguous int8 {tuple(shape)} and f32 "
                         f"{tuple(shape[:-1])} on {device}")


def _call(entry: str, device, *args) -> None:
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_encoder_layer_int8(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                             x_levels: Optional[Levels] = None, out_levels: bool = False):
    """K6: one full W8A8 layer, bf16 [B, L, D] -> bf16 [B, L, D]; the plain
    version for a CPU tensor. x_levels: x's `levels_of` ([B, L, D] int8,
    [B, L] f32), which the layer then reads instead of quantizing x; with
    out_levels, returns (y, y's levels) for the next layer."""
    if x.device.type == "cpu":
        y = fused_layer_int8_reference(x, ops, n_head, x_levels)
        return (y, levels_of(y)) if out_levels else y
    F = _check_inputs(x, ops, n_head)
    B, L, D = x.shape
    if x_levels is not None:
        _check_levels(x_levels, (B, L, D), x.device)
    out = torch.empty_like(x)
    qkv = torch.empty((B, L, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    x1 = torch.empty_like(x)
    hid = torch.empty((B, L, F), dtype=x.dtype, device=x.device)
    aq = torch.empty((B, L, D), dtype=torch.int8, device=x.device)
    ascale = torch.empty((B, L), dtype=torch.float32, device=x.device)
    hmax = torch.empty((B, L), dtype=torch.int32, device=x.device)
    y_levels = (Levels(torch.empty_like(aq), torch.empty_like(ascale)) if out_levels
                else Levels(None, None))
    xq, xs = x_levels if x_levels is not None else (None, None)
    _call("vitiq_encoder_layer_int8_full", x.device, x.data_ptr(), out.data_ptr(),
          qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), hid.data_ptr(), aq.data_ptr(),
          ascale.data_ptr(), hmax.data_ptr(), _ptr(xq), _ptr(xs), _ptr(y_levels.q),
          _ptr(y_levels.scale), *(t.data_ptr() for t in ops), B, L, D, n_head, F)
    launches["fused_encoder_layer_int8"] += 1
    return (out, y_levels) if out_levels else out


def _check_gemm(a, wq, wscale, bias, what: str) -> Tuple[int, int, int]:
    M, K = a.shape
    N = wq.shape[0]
    if (a.dtype not in (torch.bfloat16, torch.int8) or not a.is_contiguous()
            or K % 64 or N % 64 or (K > 256 and (K % 128 or K > 1024))
            or tuple(wq.shape) != (N, K) or wq.dtype != torch.int8 or not wq.is_contiguous()
            or any(t.dtype != torch.float32 or tuple(t.shape) != (N,) for t in (wscale, bias))
            or any(t.device != a.device for t in (wq, wscale, bias))):
        raise ValueError(f"{what} takes contiguous a [M, K], int8 wq [N, K] and f32 wscale, "
                         "bias [N] on one CUDA device, K % 64 == 0, N % 64 == 0, and above "
                         "K = 256 K % 128 == 0 and K <= 1024")
    return M, K, N


def _s8_stage(wq, wscale, bias, *, a=None, levels=None, amax=None, relu=False, ln=None,
              row_max=False, out_levels=False):
    """Launch one s8 stage (`vitiq_gemm_s8_stage`); see s8_stage_reference."""
    src = levels.q if levels is not None else a
    M, K, N = _check_gemm(src, wq, wscale, bias, "an s8 stage")
    dev = src.device
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    hmax = torch.zeros((M,), dtype=torch.int32, device=dev) if row_max else None
    out = (Levels(torch.empty((M, N), dtype=torch.int8, device=dev),
                  torch.empty((M,), dtype=torch.float32, device=dev)) if out_levels
           else Levels(None, None))
    res, gamma, beta = ln if ln is not None else (None, None, None)
    _call("vitiq_gemm_s8_stage", dev, _ptr(a), _ptr(levels.q if levels else None),
          _ptr(levels.scale if levels else None), _ptr(amax), wq.data_ptr(), wscale.data_ptr(),
          bias.data_ptr(), _ptr(res), _ptr(gamma), _ptr(beta), y.data_ptr(), _ptr(out.q),
          _ptr(out.scale), _ptr(hmax), None, M, K, N, int(relu))
    launches["int8_gemm"] += 1
    return y, hmax, (out if out_levels else None)


def qkv_stage(levels: Levels, wq, wscale, bias) -> torch.Tensor:
    """K6's QKV stage alone: bf16 [M, N] from x's levels ([M, K] int8, [M]
    f32) and int8 wq [N, K]."""
    if levels.q.device.type == "cpu":
        return s8_stage_reference(wq, wscale, bias, levels=levels)[0]
    return _s8_stage(wq, wscale, bias, levels=levels)[0]


def out_proj_stage(a, wq, wscale, bias, res, gamma, beta) -> Tuple[torch.Tensor, Levels]:
    """K6's out-projection + LN1 alone: (bf16 [M, D], its levels) from bf16
    attn rows a [M, D] quantized in the stage, res [M, D] the residual."""
    if a.device.type == "cpu":
        y, _, out = s8_stage_reference(wq, wscale, bias, a=a, ln=(res, gamma, beta))
        return y, out
    y, _, out = _s8_stage(wq, wscale, bias, a=a, ln=(res, gamma, beta), out_levels=True)
    return y, out


def ffn1_stage(levels: Levels, wq, wscale, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's FFN1 + ReLU alone: (bf16 hid [M, F], each row's max as int32 f32
    bits [M], merged over the stage's slabs) from x1's levels."""
    if levels.q.device.type == "cpu":
        y, hmax, _ = s8_stage_reference(wq, wscale, bias, levels=levels, relu=True,
                                        slab=s8_slab_width(wq.shape[0]))
        return y, hmax
    y, hmax, _ = _s8_stage(wq, wscale, bias, levels=levels, relu=True, row_max=True)
    return y, hmax


def ffn2_stage(h, hmax, wq, wscale, bias, res, gamma, beta, out_levels: bool = True):
    """K6's FFN2 + LN2 alone: bf16 y [M, D] (and, with out_levels, its
    levels) from bf16 hid rows h [M, F] quantized in the stage by hmax (their
    max as int32 f32 bits; read where F > 256, else the stage takes the whole
    rows it holds)."""
    if h.device.type == "cpu":
        y, _, out = s8_stage_reference(wq, wscale, bias, a=h, amax=hmax, ln=(res, gamma, beta))
    else:
        y, _, out = _s8_stage(wq, wscale, bias, a=h, amax=hmax, ln=(res, gamma, beta),
                              out_levels=out_levels)
    return (y, out) if out_levels else y


def int8_gemm(a: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor, bias: torch.Tensor,
              relu: bool = False, prequant: bool = False) -> torch.Tensor:
    """One of K6's GEMM stages alone (row quantization, s8 products,
    dequant + bias [+ ReLU] epilogue): bf16 a [M, K], int8 wq [N, K] ->
    bf16 [M, N]; with `prequant` the rows are quantized by a separate pass
    first and the stage reads their levels (as K6's QKV and FFN1 stages take
    them), else the stage quantizes them in registers (as its out-projection
    and FFN2 stages do; above K = 256 from the rows' absmax, which a pass
    writes first). Equal bit for bit to its plain version,
    `int8_gemm_reference` rounded to bf16 (same row scales, levels, exact
    sums, same f32 epilogue). Not on the serving path: it exposes the stage
    to tests and timing."""
    if a.device.type == "cpu":
        y = int8_gemm_reference(a, wq, wscale, bias)
        return (torch.relu(y) if relu else y).to(a.dtype)
    if a.dtype != torch.bfloat16:
        raise ValueError("int8_gemm takes bf16 a [M, K]")
    M, K, N = _check_gemm(a, wq, wscale, bias, "int8_gemm")
    if prequant and K > 1024:
        raise ValueError("int8_gemm with prequant takes K <= 1024")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    aq = torch.empty((M, K) if prequant else (1,), dtype=torch.int8, device=a.device)
    ascale = torch.empty((M,), dtype=torch.float32, device=a.device)
    _call("vitiq_gemm_int8", a.device, a.data_ptr(), wq.data_ptr(), wscale.data_ptr(),
          bias.data_ptr(), out.data_ptr(), aq.data_ptr(), ascale.data_ptr(), M, K, N, int(relu),
          int(prequant))
    launches["int8_gemm"] += 1
    return out


def fused_encoder_layer_int8_stack(x: torch.Tensor, qlayers, n_head: int,
                                   cls_only: bool = False) -> torch.Tensor:
    """Run `QuantizedEncoderLayer` modules as the int8 inference stack on bf16
    x [B, L, D]: K6 on every full layer, each layer's FFN2 epilogue writing
    the next one's levels (so the stack quantizes its input once), then with
    ``cls_only`` K2 on the last layer's dequantized weights for the CLS row;
    returns [B, L, D], or [B, 1, D] with ``cls_only``."""
    full = qlayers[:-1] if cls_only else qlayers
    levels = None
    for i, layer in enumerate(full):
        carry = i + 1 < len(full)
        out = fused_encoder_layer_int8(x, int8_layer_operands(layer, n_head), n_head,
                                       x_levels=levels, out_levels=carry)
        x, levels = out if carry else (out, None)
    if cls_only:
        x = fel.fused_encoder_layer_cls(x, dequant_layer_operands(qlayers[-1], n_head), n_head)
    return x
