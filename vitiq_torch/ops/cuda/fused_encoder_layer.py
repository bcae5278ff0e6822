"""Fused post-norm encoder layers for inference: the wrappers of the CUDA
kernels in `vitiq_torch/csrc/fused_encoder_layer.cu` and their plain PyTorch
version (counterpart of `vitiq/ops/pallas/fused_encoder_layer.py`,
`fused_encoder_layer_v3_stack`).

* K1 (`fused_encoder_layer`): one full layer, [B, L, D] -> [B, L, D].
* K2 (`fused_encoder_layer_cls`): the layer for query row 0 (the CLS token)
  only, attending over every token: [B, L, D] -> [B, 1, D]. It forms no K
  or V: the CLS query's scores are x_j . qt_h with qt_h = W_k,h^T q_h (the
  key bias adds a constant a head, which the softmax cancels), and its
  output is W_v,h xbar_h + b_v,h with xbar_h the softmax-weighted mean of
  the tokens. `cls_operands` adds the two block operands this takes (Kblk
  [D, H D], Vblk [H D, D]) and a zero bias to the 12; `cls_pool` runs its
  pooling kernel alone.

Each wrapper launches its kernel on a CUDA tensor (raising on any build,
launch or shape error) and runs its plain version on a CPU tensor. K1's,
`fused_layer_reference`: q pre-scaled by log2(e)/sqrt(dh) in the weights,
exp2 after the row max is subtracted, f32 numerators and denominators over
the valid keys, a divide, and rounding to the activation dtype where the
kernels round to bf16; it is also the TPU kernels' function for the CLS row
(n_q = 1). K2's, `fused_layer_cls_reference`: the same layer reassociated
as the kernel computes it, qt and xbar rounded where the TPU kernel rounds k
and v (`cls_pool_reference` is its pooling step). `fused_encoder_layer_stack`
runs a layer stack through the wrappers;
`fused_encoder_layer_stack_reference` is the plain version of the stack.

The kernels take d_model 64, 128 or 256 with d_head 16, 32 or 64, an FFN
width that is a multiple of 128, and an L whose frame-head K/V fit the
attention block's shared memory: `fused_infer_supported`, decided from shapes
alone and the same predicate as the kernels' `shapes_ok`. K6
(`fused_encoder_layer_int8`) and K7 (`fused_encoder_layer_int8attn`) take the
same shapes. The callers
(`Encoder.forward`, `QuantizedAMCModel.forward`) dispatch on it, so a shape
it admits never raises in a kernel and one it turns away never reaches one.

K1's parts run alone for the checks (`chip_smoke.py`, the CUDA tests):
`attention_core`, its one-pass attention core (plain version
`attention_onepass_reference`: p rounded at the running max of 64-key
tiles), and `gemm_stage`, one of its GEMM stages (`gemm_stage_reference`).

`launches` counts C entry calls, one per layer (a K1 call launches its five
stage kernels, a K2 call its seven, among them one `cls_pool_kernel`),
`stage_launches` those of the parts alone; the plain versions count
nothing. `kernel_launches` reads the counts the C code keeps of the
kernels a layer launches one of (K2's pooling kernel, K7's two cores),
each counted where it is launched.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Sequence

import torch

from vitiq_torch.ops.cuda import _build

LN_EPS = 1e-12
_LOG2E = 1.4426950408889634
SUPPORTED_D_MODEL = (64, 128, 256)
SUPPORTED_D_HEAD = (16, 32, 64)
MAX_SHARED_MEMORY = 232448  # bytes a block may use on Hopper

launches = {"fused_encoder_layer": 0, "fused_encoder_layer_cls": 0}
# K1's attention core, one of its GEMM stages and K2's pooling kernel called
# alone (`attention_core`, `gemm_stage`, `cls_pool`): the checks' entries, not
# the serving path's
stage_launches = {"attention_core": 0, "gemm_stage": 0, "cls_pool": 0}

# K2's pooling kernel (cls_pool_kernel): warps a block, tokens a ring stage
POOL_WARPS = 4
POOL_STEP = 16
POOL_RING = 20480  # bytes of a warp's ring below d_model 256

# `ptxas -v` registers of K1's attention core, attention_core_kernel<DH,
# false>, at d_head 16, 32 and 64 (nvcc for sm_90a); the build is held to
# them, and P3's instance of the same core (NOEXP) must not spill.
K1_ATTENTION_REGISTERS = {16: 86, 32: 98, 64: 122}
# the core's key tile (the wgmma's N) and query tile (its M)
CORE_TILE = 64


# the kernels whose launches the C code counts (`vitiq_kernel_launches`), in
# its order
COUNTED_KERNELS = ("cls_pool_kernel", "attention_int8_kernel", "attention_int8_sync_kernel")


def kernel_launches(reset: bool = False) -> Dict[str, int]:
    """The launches of COUNTED_KERNELS since the last reset, counted by the
    C code where it launches each (all zero while the library is not loaded:
    a CPU run loads it never); with `reset`, they then start again from 0."""
    if _build._library is None:
        return dict.fromkeys(COUNTED_KERNELS, 0)
    counts = (ctypes.c_ulonglong * len(COUNTED_KERNELS))()
    _build.library().vitiq_kernel_launches(counts, int(reset))
    return dict(zip(COUNTED_KERNELS, (int(c) for c in counts)))


def reset_launches() -> None:
    for counts in (launches, stage_launches):
        for name in counts:
            counts[name] = 0
    kernel_launches(reset=True)


def attention_smem_bytes(L: int, d_head: int) -> int:
    """The shape gate's shared-memory formula (`gate_smem_bytes` in the .cu):
    a frame-head's k rows and v transposed, bf16, padded, the layout of K2's
    former two-pass core, which set the bound every kernel of the gate keeps
    (K1's and K7's cores, `core_smem_bytes`, fit within it)."""
    lp = (L + 15) // 16 * 16
    return (lp * (d_head + 8) + d_head * (lp + 8)) * 2


def core_smem_bytes(L: int, d_head: int) -> int:
    """Shared memory of K1's one-pass core at L tokens (`core_smem_bytes` in
    the .cu, repeated here for the tests that hold it to the shape predicate
    without the library): the frame-head's k and v rows in 64-key tiles, an
    mbarrier a tile, and 1 KB of alignment. At every L that `fused_infer_supported`
    admits it is no more than MAX_SHARED_MEMORY (the gate's formula
    `attention_smem_bytes` sets the bound). K7's core takes the same."""
    n_kt = (L + CORE_TILE - 1) // CORE_TILE
    return n_kt * CORE_TILE * d_head * 2 * 2 + n_kt * 8 + 1024


def pool_stages(D: int) -> int:
    """Stages of a warp's ring in K2's pooling kernel (`pool_stages`)."""
    return 2 if D >= 256 else min(8, POOL_RING // (POOL_STEP * 2 * D))


def pool_smem_bytes(D: int, n_head: int) -> int:
    """Shared memory of K2's pooling kernel (`pool_smem_bytes` in the .cu):
    per warp its ring of 16-token stages, two buffers of qt rows (8 heads a
    head block, padded by 8) and an mbarrier a stage, and 1 KB of alignment.
    It does not depend on L."""
    ns, nhb = pool_stages(D), -(-n_head // 8)
    return 1024 + POOL_WARPS * (ns * POOL_STEP * D * 2 + 2 * nhb * 8 * (D + 8) * 2 + ns * 8)


def fused_infer_supported(L: int, D: int, ffn_hidden: int, n_head: int) -> bool:
    """Shapes K1, K2, K6 and K7 take: d_model in SUPPORTED_D_MODEL, d_head in
    SUPPORTED_D_HEAD, an FFN width that is a multiple of 128, and an L whose
    attention block fits the card's shared memory (at d_head 64, L up to
    ~850: the conv1d arm's 1025 tokens with n_head 2 are turned away).
    Decided from shapes alone, before any launch."""
    if D not in SUPPORTED_D_MODEL or n_head <= 0 or D % n_head or L <= 0:
        return False
    dh = D // n_head
    return (dh in SUPPORTED_D_HEAD and ffn_hidden > 0 and ffn_hidden % 128 == 0
            and attention_smem_bytes(L, dh) <= MAX_SHARED_MEMORY)


def attention_kernel_tag(d_head: int, noexp: bool = False) -> str:
    """The part of the mangled name of K1's attention core at `d_head`
    (attention_core_kernel<d_head, false>), or of P3's (NOEXP), that tells
    it from the other instantiations (in a `ptxas -v` report or SASS)."""
    return f"attention_core_kernelILi{d_head}ELb{int(noexp)}EE"


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


def cls_block_operands(wqkv: torch.Tensor, n_head: int):
    """K2's block operands from Wqkv [D, 3D] (its k columns W_k, v columns
    W_v, [in, out]): Kblk [D, H D] with Kblk[h dh + e, h D + c] = W_k[c, h dh
    + e], so that qt = q Kblk is [B, H, D] with qt_h = W_k,h^T q_h; Vblk
    [H D, D] with Vblk[h D + c, h dh + e] = W_v[c, h dh + e], so that
    xbar Vblk + b_v is the attention output; zeros off the diagonal blocks.
    Rearranged copies of Wqkv's entries in its dtype (no new rounding)."""
    D = wqkv.shape[0]
    dh = D // n_head
    wk, wv = wqkv[:, D:2 * D], wqkv[:, 2 * D:]
    kblk = wqkv.new_zeros((D, n_head * D))
    vblk = wqkv.new_zeros((n_head * D, D))
    for h in range(n_head):
        cols = slice(h * dh, (h + 1) * dh)
        kblk[cols, h * D:(h + 1) * D] = wk[:, cols].t()
        vblk[h * D:(h + 1) * D, cols] = wv[:, cols]
    return kblk.contiguous(), vblk.contiguous()


def cls_operands(ops: Sequence[torch.Tensor], n_head: int) -> List[torch.Tensor]:
    """K2's 15 operands from the layer's 12 (`layer_operands`' layout): the
    12, then Kblk [D, H D] and Vblk [H D, D] in Wqkv's dtype
    (`cls_block_operands`) and qt's zero bias [H D] f32."""
    if len(ops) != 12:
        raise ValueError(f"cls_operands takes the 12 layer operands, got {len(ops)}")
    with torch.no_grad():
        kblk, vblk = cls_block_operands(ops[0], n_head)
        zero = torch.zeros(kblk.shape[1], dtype=torch.float32, device=ops[0].device)
    return list(ops) + [kblk, vblk, zero]


def layer_cls_operands(layer, n_head: int, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """K2's 15 operands of one layer (`cls_operands` of `layer_operands`),
    cached on the layer beside them and rebuilt with them."""
    ops = layer_operands(layer, n_head, dtype)
    key = ("cls", n_head, dtype, layer.attention.w_q.weight.device)
    cached = layer.kernel_operands.get(key)
    if cached is not None and cached[0] is ops:
        return cached[1]
    full = cls_operands(ops, n_head)
    layer.kernel_operands[key] = (ops, full)
    return full


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of the stored operands accumulated in f32 (exact bf16 products)."""
    return torch.matmul(a.float(), b.float())


def layer_norm_reference(v: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor) -> torch.Tensor:
    """The kernels' LayerNorm epilogue on f32 rows (biased variance, rsqrt)."""
    mean = v.mean(dim=-1, keepdim=True)
    d = v - mean
    var = d.square().mean(dim=-1, keepdim=True)
    return gamma * (d * torch.rsqrt(var + LN_EPS)) + beta


def attention_reference(qkv: torch.Tensor, n_head: int, n_q: int) -> torch.Tensor:
    """The kernels' attention core on qkv [B, L, 3D] (q pre-scaled by
    log2(e)/sqrt(dh)) for query rows [0, n_q): [B, n_q, D] in qkv's dtype."""
    dt = qkv.dtype
    B, L, D3 = qkv.shape
    D = D3 // 3
    dh = D // n_head

    def heads(t, rows):  # [B, rows, D] -> [B, H, rows, dh] f32
        return t.float().reshape(B, rows, n_head, dh).transpose(1, 2)

    q = heads(qkv[:, :n_q, :D], n_q)
    k = heads(qkv[:, :, D:2 * D], L)
    v = heads(qkv[:, :, 2 * D:], L)
    s = q @ k.transpose(-1, -2)  # log2 units: q carries log2(e)/sqrt(dh)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(dt).float()
    attn = ((p @ v) / p.sum(dim=-1, keepdim=True)).to(dt)
    return attn.transpose(1, 2).reshape(B, n_q, D)


def attention_onepass_reference(qkv: torch.Tensor, n_head: int,
                                tile: int = CORE_TILE) -> torch.Tensor:
    """The plain version of K1's attention core (`attention_core_kernel`) on
    qkv [B, L, 3D], every query row: one pass over `tile`-key tiles with a
    running max m, each p = exp2(s - m) rounded to qkv's dtype at the running
    max, the f32 sum l of the rounded p and the f32 output o both rescaled by
    exp2(m_old - m_new) when a tile raises the max; out = (o / l) in qkv's
    dtype. In f32 it is the softmax itself; in bf16 it differs from
    `attention_reference` (p rounded at the final max) by bf16 roundings of
    p, within K1's tolerance. Tests and `chip_smoke.py` use it; the serving
    path does not."""
    dt = qkv.dtype
    B, L, D3 = qkv.shape
    D = D3 // 3
    dh = D // n_head

    def heads(t):  # [B, L, D] -> [B, H, L, dh] f32
        return t.float().reshape(B, L, n_head, dh).transpose(1, 2)

    q, k, v = heads(qkv[..., :D]), heads(qkv[..., D:2 * D]), heads(qkv[..., 2 * D:])
    m = torch.full((B, n_head, L, 1), -math.inf, device=qkv.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for j0 in range(0, L, tile):
        s = q @ k[:, :, j0:j0 + tile].transpose(-1, -2)  # log2 units
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        a = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).to(dt).float()
        l = l * a + p.sum(dim=-1, keepdim=True)
        o = o * a + p @ v[:, :, j0:j0 + tile]
        m = m_new
    return (o / l).to(dt).transpose(1, 2).reshape(B, L, D)


def gemm_stage_reference(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         relu: bool = False, res=None, gamma=None, beta=None) -> torch.Tensor:
    """The plain version of one of K1's GEMM stages: bf16(a @ w + bias), then
    ReLU, or bf16(LN(a @ w + bias + res)) with gamma, beta (f32 products of
    the bf16 operands, the kernels' LayerNorm)."""
    v = _mm(a, w) + bias
    if res is not None:
        v = layer_norm_reference(v + res.float(), gamma, beta)
    elif relu:
        v = torch.relu(v)
    return v.to(a.dtype)


def fused_layer_reference(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                          n_q: int, attention=attention_reference) -> torch.Tensor:
    """One layer for query rows [0, n_q): x [B, L, D] -> [B, n_q, D], from
    the 12 layer operands, with `attention(qkv, n_head, n_q)` as its core
    (K7's plain version passes its int8 core)."""
    if len(ops) != 12:
        raise ValueError(f"the layer takes its 12 operands, got {len(ops)} (K2's 15 go to "
                         "fused_layer_cls_reference)")
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    dt = x.dtype
    qkv = (_mm(x, wqkv) + bqkv).to(dt)
    attn = attention(qkv, n_head, n_q)
    x1 = layer_norm_reference(_mm(attn, wo) + bo + x[:, :n_q].float(), g1, be1).to(dt)
    h = torch.relu(_mm(x1, w1) + b1).to(dt)
    return layer_norm_reference(_mm(h, w2) + b2 + x1.float(), g2, be2).to(dt)


def cls_pool_reference(x: torch.Tensor, qt: torch.Tensor,
                       step: int = POOL_STEP) -> torch.Tensor:
    """The plain version of K2's pooling kernel (`cls_pool_kernel`): x [B,
    L, D] and qt [B, H, D] (one dtype) -> xbar [B, H, D] in that dtype. s_hj =
    x_j . qt_h (log2 units), p = exp2(s - m) rounded to the dtype at the
    running max m of `step`-token steps, l the f32 sum of the rounded p (both
    rescaled by exp2(m_old - m_new) when a step raises the max), xbar_h =
    sum_j p_hj x_j / l_h. In f32 it is the softmax-weighted mean itself."""
    dt = x.dtype
    B, L, D = x.shape
    xf, qf = x.float(), qt.float()
    m = torch.full((B, qt.shape[1], 1), -math.inf, device=x.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j0 in range(0, L, step):
        xs = xf[:, j0:j0 + step]
        s = qf @ xs.transpose(-1, -2)  # [B, H, step]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        a = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).to(dt).float()
        l = l * a + p.sum(dim=-1, keepdim=True)
        acc = acc * a + p @ xs
        m = m_new
    return (acc / l).to(dt)


def fused_layer_cls_reference(x: torch.Tensor, ops: Sequence[torch.Tensor],
                              n_head: int) -> torch.Tensor:
    """K2's plain version: the layer for the CLS row as the kernel computes
    it, x [B, L, D] -> [B, 1, D] in x's dtype, from K2's 15 operands
    (`cls_operands`):
      q = (x_0 Wq + b_q), qt = (q Kblk), xbar = cls_pool_reference(x, qt),
      attn = (xbar Vblk + b_v), then the out-projection + LN1, FFN1 and FFN2 +
      LN2 of `fused_layer_reference` on the B rows,
    each rounded to the dtype as the kernel rounds to bf16. The same
    function as `fused_layer_reference(x, ops, n_head, 1)` with qt and xbar
    rounded where that rounds k and v (equal in f32 up to f32 sums)."""
    if len(ops) != 15:
        raise ValueError(f"K2 takes its 15 operands (cls_operands), got {len(ops)}")
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, kblk, vblk, kzero = ops
    dt = x.dtype
    B, _, D = x.shape
    q = (_mm(x[:, 0], wqkv[:, :D]) + bqkv[:D]).to(dt)
    qt = (_mm(q, kblk) + kzero).to(dt).reshape(B, n_head, D)
    xbar = cls_pool_reference(x, qt)
    attn = (_mm(xbar.reshape(B, n_head * D), vblk) + bqkv[2 * D:]).to(dt)
    x1 = layer_norm_reference(_mm(attn, wo) + bo + x[:, 0].float(), g1, be1).to(dt)
    h = torch.relu(_mm(x1, w1) + b1).to(dt)
    return layer_norm_reference(_mm(h, w2) + b2 + x1.float(), g2, be2).to(dt)[:, None]


def fused_encoder_layer_stack_reference(x: torch.Tensor, ops_list, n_head: int,
                                        cls_only: bool = False) -> torch.Tensor:
    """Plain version of the stack: full layers, then (with ``cls_only``) K2's
    plain version on the last layer for the CLS row, returning [B, 1, D]."""
    full = ops_list[:-1] if cls_only else ops_list
    for ops in full:
        x = fused_layer_reference(x, ops, n_head, x.shape[1])
    if cls_only:
        x = fused_layer_cls_reference(x, cls_operands(ops_list[-1], n_head), n_head)
    return x


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _check_inputs(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                  n_ops: int = 12) -> int:
    """Validate what the kernels take: the 12 layer operands, or K2's 15
    (`cls_operands`) where `n_ops` is 15; returns the FFN width."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 [B, L, D] tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    B, L, D = x.shape
    if len(ops) != n_ops:
        raise ValueError(f"expected {n_ops} operands, got {len(ops)}"
                         + (" (K2's 15: cls_operands)" if n_ops == 15 else ""))
    F = ops[6].shape[-1]
    check_shape(B, L, D, F, n_head)
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,),
              (D, F), (F,), (F, D), (D,), (D,), (D,),
              (D, n_head * D), (n_head * D, D), (n_head * D,)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        want = torch.bfloat16 if len(shape) == 2 else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"operand {i}: want contiguous {want} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return F


def check_shape(B: int, L: int, D: int, F: int, n_head: int) -> None:
    """Raise unless `fused_infer_supported` admits the shape (K1, K2, K6, K7)."""
    if B == 0 or not fused_infer_supported(L, D, F, n_head):
        raise ValueError(f"the kernels take d_model in {SUPPORTED_D_MODEL}, d_head in "
                         f"{SUPPORTED_D_HEAD}, an FFN width that is a multiple of 128 and L "
                         f"up to the shared-memory bound; got B={B}, L={L}, d_model={D}, "
                         f"n_head={n_head}, ffn={F}")


def _call_layer(entry: str, x: torch.Tensor, out: torch.Tensor, scratch, ops, n_head: int,
                F: int) -> None:
    """Launch one layer's C entry point on the scratch buffers (their
    addresses); raise on its error."""
    B, L, D = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), out.data_ptr(), *scratch,
            *(t.data_ptr() for t in ops), B, L, D, n_head, F, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")


def _launch(entry: str, x: torch.Tensor, out: torch.Tensor, ops, n_head: int, F: int,
            rows: int) -> None:
    """A full layer (K1, K7, P3; rows = L): allocate its scratch, qkv [B, L,
    3D], attn and x1 [B, rows, D], hid [B, rows, F], and launch."""
    B, L, D = x.shape
    scratch = [torch.empty((B, L, 3 * D), dtype=x.dtype, device=x.device)]
    scratch += [torch.empty((B, rows, w), dtype=x.dtype, device=x.device) for w in (D, D, F)]
    _call_layer(entry, x, out, [t.data_ptr() for t in scratch], ops, n_head, F)


def fused_encoder_layer(x: torch.Tensor, ops: Sequence[torch.Tensor],
                        n_head: int) -> torch.Tensor:
    """K1: one full layer, bf16 [B, L, D] -> bf16 [B, L, D]; the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_layer_reference(x, ops, n_head, x.shape[1])
    F = _check_inputs(x, ops, n_head)
    out = torch.empty_like(x)
    _launch("vitiq_encoder_layer_full", x, out, ops, n_head, F, x.shape[1])
    launches["fused_encoder_layer"] += 1
    return out


def fused_encoder_layer_cls(x: torch.Tensor, ops: Sequence[torch.Tensor],
                            n_head: int) -> torch.Tensor:
    """K2: the layer for the CLS row only, bf16 [B, L, D] -> bf16 [B, 1, D],
    from its 15 operands (`cls_operands`; the stacks cache them,
    `layer_cls_operands`); the plain version, `fused_layer_cls_reference`,
    for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_layer_cls_reference(x, ops, n_head)
    F = _check_inputs(x, ops, n_head, 15)
    B, _, D = x.shape
    out = torch.empty((B, 1, D), dtype=x.dtype, device=x.device)
    # q, qt, xbar, attn, x1, hid: [B, width] each, one after another in one
    # buffer (each starts a multiple of 128 bytes in: the widths are
    # multiples of 64)
    widths = (D, n_head * D, n_head * D, D, D, F)
    buf = torch.empty(B * sum(widths), dtype=x.dtype, device=x.device)
    base, scratch = buf.data_ptr(), []
    for w in widths:
        scratch.append(base)
        base += B * w * buf.element_size()
    _call_layer("vitiq_encoder_layer_cls", x, out, scratch, ops, n_head, F)
    launches["fused_encoder_layer_cls"] += 1
    return out


def fused_encoder_layer_stack(x: torch.Tensor, layers, n_head: int,
                              cls_only: bool = False) -> torch.Tensor:
    """Run `EncoderLayer` modules as the fused inference stack on x [B, L, D]
    (the compute dtype) through the K1/K2 wrappers; returns [B, L, D], or
    [B, 1, D] with ``cls_only``."""
    full = layers[:-1] if cls_only else layers
    for layer in full:
        x = fused_encoder_layer(x, layer_operands(layer, n_head, x.dtype), n_head)
    if cls_only:
        x = fused_encoder_layer_cls(x, layer_cls_operands(layers[-1], n_head, x.dtype), n_head)
    return x


def cls_pool(x: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """K2's pooling kernel alone (C entry `vitiq_cls_pool`): bf16 x [B, L, D]
    and qt [B, H, D] -> xbar [B, H, D] bf16; `cls_pool_reference` for a CPU
    tensor. Not on the serving path: it exposes the kernel to tests and
    timing."""
    if x.device.type == "cpu":
        return cls_pool_reference(x, qt)
    B, L, D = x.shape
    if (x.dim() != 3 or qt.dim() != 3 or qt.shape[0] != B or qt.shape[2] != D
            or any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != x.device
                   for t in (x, qt))):
        raise ValueError(f"cls_pool takes contiguous bf16 x [B, L, D] and qt [B, H, D] on one "
                         f"device; got {x.dtype} {tuple(x.shape)}, {qt.dtype} {tuple(qt.shape)}")
    H = qt.shape[1]
    check_shape(B, L, D, 128, H)
    xbar = torch.empty((B, H, D), dtype=x.dtype, device=x.device)
    _build.call("vitiq_cls_pool", x.device, x.data_ptr(), qt.data_ptr(), xbar.data_ptr(), B, L,
                D, H)
    stage_launches["cls_pool"] += 1
    return xbar


def attention_core(qkv: torch.Tensor, n_head: int) -> torch.Tensor:
    """K1's attention core alone (C entry `vitiq_attention_core`) on qkv
    [B, L, 3D] bf16 (q pre-scaled by log2(e)/sqrt(dh)) -> [B, L, D] bf16;
    `attention_onepass_reference` for a CPU tensor."""
    if qkv.device.type == "cpu":
        return attention_onepass_reference(qkv, n_head)
    if (qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or qkv.shape[2] % 3):
        raise ValueError(f"qkv must be a contiguous bf16 [B, L, 3D] tensor, got {qkv.dtype} "
                         f"{tuple(qkv.shape)}")
    B, L, D3 = qkv.shape
    check_shape(B, L, D3 // 3, 128, n_head)
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    _build.call("vitiq_attention_core", qkv.device, qkv.data_ptr(), out.data_ptr(), B, L,
                D3 // 3, n_head)
    stage_launches["attention_core"] += 1
    return out


def gemm_stage(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, relu: bool = False,
               res=None, gamma=None, beta=None) -> torch.Tensor:
    """One of K1's GEMM stages alone (C entry `vitiq_gemm_bf16`): a [M, K] @
    w [K, N] + bias, then ReLU, or with `res` [M, N] (N = 64, 128 or 256)
    + res and LayerNorm; bf16 a, w, res, f32 bias, gamma, beta; K and N
    multiples of 64. `gemm_stage_reference` for a CPU tensor."""
    if a.device.type == "cpu":
        return gemm_stage_reference(a, w, bias, relu, res, gamma, beta)
    M, K = a.shape
    N = w.shape[1]
    mats = [a, w] + ([res] if res is not None else [])
    vecs = [bias] + ([gamma, beta] if res is not None else [])
    if (w.shape[0] != K or K % 64 or N % 64
            or any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != a.device
                   for t in mats)
            or any(t.dtype != torch.float32 or tuple(t.shape) != (N,) or t.device != a.device
                   for t in vecs)
            or (res is not None and (tuple(res.shape) != (M, N) or N not in SUPPORTED_D_MODEL))):
        raise ValueError(f"gemm_stage takes bf16 a [M, K], w [K, N] (K, N multiples of 64), f32 "
                         f"bias [N] and for LN res [M, N], N in {SUPPORTED_D_MODEL}; got "
                         f"{tuple(a.shape)} {tuple(w.shape)}")
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    _build.call("vitiq_gemm_bf16", a.device, a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                ptr(res), ptr(gamma), ptr(beta), c.data_ptr(), M, K, N,
                2 if res is not None else int(relu))
    stage_launches["gemm_stage"] += 1
    return c
