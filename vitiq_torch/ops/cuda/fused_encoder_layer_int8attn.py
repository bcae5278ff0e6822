"""The fused encoder layer with an int8 attention core (K7): the wrapper of
the CUDA kernel `vitiq_encoder_layer_attn_int8_full` in
`vitiq_torch/csrc/fused_encoder_layer.cu` and its plain PyTorch version
(counterpart of `vitiq/ops/pallas/fused_encoder_layer.py`,
`fused_encoder_layer_v3_stack(..., attn_int8=True)`, which the JAX encoder
runs under ``VITIQ_ATTN_INT8=1``).

K7 is K1's layer (the same 12 operands, `fel.layer_operands`, bf16 GEMMs)
with the attention core made int8, per frame and head, on the bf16 qkv read
as f32 (q pre-scaled by log2(e)/sqrt(dh)):

* q -> int8 levels ``rint(q * (127 / aq))``, ``aq = max(max |q_row|, 1e-8)``
  per query row; k -> ``rint(k * (127 / ak))`` with one ``ak = max(max |k|,
  1e-8)`` over the frame-head; [v | 1] -> ``rint(. * (127 / av))`` with one
  ``av = max(max |v|, 1)`` (the ones column shares v's scale, so its level is
  ``rint(127 / av)``);
* per 128-key tile: ``s = f32(qq . kq) * (aq * (ak / 127^2))``, the tile's
  row max ``m``, int8 probabilities ``p = rint(exp2(s - m) * 127)`` and the
  s32 product ``p . [vq | one]``; tiles merge on a running max in f32,
  ``acc * exp2(acc_m - new_m) + part * exp2(m - new_m)``;
* ``out = acc[:, :dh] / acc[:, dh]``, rounded to the activation dtype.

``rint`` rounds half to even (as `jnp.round` and `torch.round`). The TPU
kernel quantizes k and [v | 1] over a block of G frames (``VITIQ_V3_G``);
K7 takes one frame per block, which is the TPU kernel at G = 1. The TPU
kernel also pads the token stream to Lp = round_up(L, 16) (8 in f32), whose
padded rows carry nonzero k into ak and each tile's row max; the port has no
padded rows, so the two agree closely where L = Lp and by quantization noise
elsewhere (`tests/test_torch_fused_layer.py` holds both regimes).

`fused_encoder_layer_int8attn` launches the kernel on a CUDA tensor (raising
on any build, launch or shape error) and runs `fused_layer_int8attn_reference`
on a CPU tensor. It takes K1's shapes (`fel.fused_infer_supported`). Its int8
core has two forms of one function, chosen by L alone (`core_route`): past
one 128-key tile the s8 wgmma core (`attention_int8_kernel`), which loads
the frame-head's bf16 k and v as K1's core does and quantizes them in place,
so it needs K1's core's shared memory (`attention_int8_smem_bytes`); at L <=
SYNC_MAX_L the two-pass mma.sync core (`attention_int8_sync_kernel`), which
measured faster there (at 65 tokens the wgmma core's 64-row query tiles and
128-key tile are three quarters padding; the two cross between 81 and 97
tokens at d_head 16 and 32).
`fused_encoder_layer_int8attn_stack` runs K7 on every full layer and, with
``cls_only``, K2 (bf16) on the last layer's CLS row, as the TPU stack does.
`attention_int8` runs K7's attention core alone (for tests and timing); with
``dump=True`` it also returns the core's s32 scores, int8 probabilities and
s32 tile products, which `attention_int8_products` computes in plain
PyTorch: the integer products are exact in f32 (|sums| < 2^24), so on the
same quantized operands they equal the kernel's bit for bit.

Tolerance of the kernel against the plain version (`chip_smoke.py`,
`tests/test_torch_cuda.py`): its attention core repeats the plain version's
roundings one by one, but its QKV GEMM sums in another order than the plain
one, so a one-ulp bf16 flip in q or k can move a quantized level, which
moves a probability by one of 127 steps. The layer is held as K6 is: by
relative L2 and a max counted in quantization steps (a row's absmax / 127 of
the plain output), one layer within 1e-3 (below what K1's bf16 core in its
place reads) and 2 steps, a stack with the K2 tail within 2e-2 and 4 steps;
the core alone differs from the plain version in under 1e-3 of its
probabilities and 1e-2 of its outputs. `launches` counts C entry calls,
one per layer or per call of the core alone; `fel.kernel_launches` counts
each core's launches where the C code launches it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import fused_encoder_layer as fel

TILE = 128          # keys per tile, as the TPU kernel's
SCALE_FLOOR = 1e-8  # aq, ak floor
QMAX = 127.0

launches = {"fused_encoder_layer_int8attn": 0, "attention_int8": 0}
# the longest L the layer's core takes on mma.sync (`k7_sync_core` in the .cu)
SYNC_MAX_L = 96
# `attention_int8`'s `core` -> the C entry's: the layer's route, or one form
CORES = {None: 0, "wgmma": 1, "sync": 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def core_route(L: int) -> str:
    """The form of K7's core a layer of L tokens takes (`k7_sync_core`):
    "sync" up to SYNC_MAX_L tokens, "wgmma" past them."""
    return "sync" if L <= SYNC_MAX_L else "wgmma"


def attention_int8_smem_bytes(L: int, d_head: int, core: Optional[str] = None) -> int:
    """Shared memory of K7's attention block at L tokens, of the form `core`
    takes (the layer's route where None). The wgmma core's (`k7_smem_bytes`
    in the .cu): the frame-head's bf16 k and v in 64-key tiles (K1's
    core's), an mbarrier and 1 KB of alignment; the int8 k rows [key][max(32,
    d_head)] and v^T tiles [128 keys][d_head][128] then overwrite the tiles
    in place (`k7_int8_layout_bytes`). The mma.sync core's
    (`k7_sync_smem_bytes`): int8 k rows [key][d_head + 16] and v^T [d_head]
    [round32(L) + 16], keys rounded up to 32."""
    if (core or core_route(L)) == "sync":
        l32 = -(-L // 32) * 32
        return l32 * (d_head + 16) + d_head * (l32 + 16)
    n_kt = -(-L // 64)
    return 1024 + n_kt * 64 * d_head * 4 + 8


def k7_int8_layout_bytes(L: int, d_head: int) -> int:
    """Where the int8 layout the kernel writes in place ends, from the tiles'
    start: int8 k rows of the 64-key tiles' keys, max(32, d_head) bytes
    each, then (from the bf16 v tiles' start, 128 L_64 d_head bytes in,
    `v8_base`) the v^T tiles, d_head x 128 bytes a 128-key tile. It stays
    within the tiles' 4 L_64 d_head bytes (L_64: L rounded up to 64)."""
    n_kt = -(-L // 64)
    assert n_kt * 64 * max(32, d_head) <= n_kt * 64 * d_head * 2
    return n_kt * 64 * d_head * 2 + -(-L // TILE) * d_head * 128


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A divisor as a tensor on `like`'s device: PyTorch's CUDA division by a
    host scalar (and `scalar / tensor`) multiplies by a reciprocal, which is
    not the IEEE quotient the kernel and the JAX package take."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_heads(qkv: torch.Tensor, n_head: int):
    """qkv [B, L, 3D] -> (qq, kq, vq, one, deq): the int8 levels of q, k, v
    per head as integer-valued f32 [B, H, L, dh], the ones column's level
    [B, H, 1, 1] and the score dequant factor aq * (ak / 127^2) [B, H, L, 1]."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    dh = D // n_head

    def heads(t):  # [B, L, D] -> [B, H, L, dh] f32
        return t.float().reshape(B, L, n_head, dh).transpose(1, 2)

    q, k, v = heads(qkv[..., :D]), heads(qkv[..., D:2 * D]), heads(qkv[..., 2 * D:])
    c127 = _const(QMAX, qkv)
    aq = torch.clamp(q.abs().amax(dim=-1, keepdim=True), min=SCALE_FLOOR)
    ak = torch.clamp(k.abs().amax(dim=(-2, -1), keepdim=True), min=SCALE_FLOOR)
    av = torch.clamp(v.abs().amax(dim=(-2, -1), keepdim=True), min=1.0)
    qq = torch.round(q * (c127 / aq))
    kq = torch.round(k * (c127 / ak))
    vq = torch.round(v * (c127 / av))
    one = torch.round(c127 / av)
    deq = aq * (ak / _const(QMAX * QMAX, qkv))
    return qq, kq, vq, one, deq


def _tile_probs(qq, kq, deq, c0: int):
    """The tile's integer scores, dequantized scores, row max and int8
    probabilities (all f32)."""
    s_int = qq @ kq[:, :, c0:c0 + TILE].transpose(-1, -2)  # exact integers
    s = s_int * deq
    m = s.amax(dim=-1, keepdim=True)
    return s_int, m, torch.round(torch.exp2(s - m) * QMAX)


def _tile_product(p, vq, one, c0: int) -> torch.Tensor:
    """The tile's s32 product p . [vq | one] as exact f32 [B, H, L, dh + 1]."""
    return torch.cat([p @ vq[:, :, c0:c0 + TILE], p.sum(dim=-1, keepdim=True) * one], dim=-1)


def attention_int8_reference(qkv: torch.Tensor, n_head: int,
                             n_q: Optional[int] = None) -> torch.Tensor:
    """K7's attention core on qkv [B, L, 3D] for every query row: [B, L, D]
    in qkv's dtype (`n_q`, the signature of `fel.attention_reference`, must
    be L or None: K7 computes full layers only)."""
    B, L, D3 = qkv.shape
    if n_q not in (None, L):
        raise ValueError("the int8 attention core computes every query row")
    qq, kq, vq, one, deq = quantize_heads(qkv, n_head)
    dh = qq.shape[-1]
    acc = acc_m = None
    for c0 in range(0, L, TILE):
        _, m, p = _tile_probs(qq, kq, deq, c0)
        part = _tile_product(p, vq, one, c0)
        if acc is None:
            acc, acc_m = part, m
        else:
            new_m = torch.maximum(acc_m, m)
            acc = acc * torch.exp2(acc_m - new_m) + part * torch.exp2(m - new_m)
            acc_m = new_m
    out = (acc[..., :dh] / acc[..., dh:]).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, L, D3 // 3)


def attention_int8_products(qkv: torch.Tensor, n_head: int,
                            probs: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The integer intermediates of K7's core in plain PyTorch: "scores"
    int32 [B, H, L, L] (qq . kq), "probs" int8 [B, H, L, L] and "pv" int32
    [B, H, ceil(L / 128), L, dh + 1] (each tile's p . [vq | one]), the tile
    products taken with `probs` where given (the kernel's own, to hold its
    P [v | 1] product on the same operands), else with the plain ones."""
    L = qkv.shape[1]
    qq, kq, vq, one, deq = quantize_heads(qkv, n_head)
    scores, plain, pv = [], [], []
    for c0 in range(0, L, TILE):
        s_int, _, p = _tile_probs(qq, kq, deq, c0)
        scores.append(s_int)
        plain.append(p)
        p_used = p if probs is None else probs[..., c0:c0 + TILE].float()
        pv.append(_tile_product(p_used, vq, one, c0))
    return {"scores": torch.cat(scores, dim=-1).to(torch.int32),
            "probs": torch.cat(plain, dim=-1).to(torch.int8),
            "pv": torch.stack(pv, dim=2).to(torch.int32)}


def fused_layer_int8attn_reference(x: torch.Tensor, ops: Sequence[torch.Tensor],
                                   n_head: int) -> torch.Tensor:
    """One full K7 layer: x [B, L, D] -> [B, L, D] in x's dtype (K1's
    plain layer with the int8 core)."""
    return fel.fused_layer_reference(x, ops, n_head, x.shape[1],
                                     attention=attention_int8_reference)


def fused_encoder_layer_int8attn_stack_reference(x: torch.Tensor, ops_list, n_head: int,
                                                 cls_only: bool = False) -> torch.Tensor:
    """Plain version of the stack: K7's on the full layers, then (with
    ``cls_only``) K2's for the CLS row, returning [B, 1, D]."""
    full = ops_list[:-1] if cls_only else ops_list
    for ops in full:
        x = fused_layer_int8attn_reference(x, ops, n_head)
    if cls_only:
        x = fel.fused_layer_cls_reference(x, fel.cls_operands(ops_list[-1], n_head), n_head)
    return x


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

def fused_encoder_layer_int8attn(x: torch.Tensor, ops: Sequence[torch.Tensor],
                                 n_head: int) -> torch.Tensor:
    """K7: one full layer with the int8 attention core, bf16 [B, L, D] ->
    bf16 [B, L, D]; the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_layer_int8attn_reference(x, ops, n_head)
    F = fel._check_inputs(x, ops, n_head)
    out = torch.empty_like(x)
    fel._launch("vitiq_encoder_layer_attn_int8_full", x, out, ops, n_head, F, x.shape[1])
    launches["fused_encoder_layer_int8attn"] += 1
    return out


def attention_int8(qkv: torch.Tensor, n_head: int, dump: bool = False,
                   core: Optional[str] = None):
    """K7's attention core alone: bf16 qkv [B, L, 3D] (q pre-scaled) ->
    bf16 [B, L, D]; with `dump`, (out, {"scores", "probs", "pv"}) as
    `attention_int8_products` lays them out, from the kernel. `core`
    "wgmma" or "sync" takes that form at any L, None the layer's route
    (`core_route`). The plain version for a CPU tensor. Not on the serving
    path: it exposes the core to tests and timing."""
    if qkv.device.type == "cpu":
        out = attention_int8_reference(qkv, n_head)
        return (out, attention_int8_products(qkv, n_head)) if dump else out
    if qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous bf16 [B, L, 3D] tensor, got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    if core not in CORES:
        raise ValueError(f"core must be one of {list(CORES)}, got {core!r}")
    B, L, D3 = qkv.shape
    D = D3 // 3
    fel.check_shape(B, L, D, 128, n_head)
    out = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    dumps = {}
    if dump:  # the kernel's score and probability rows hold whole 128-key tiles
        dh, n_tiles = D // n_head, -(-L // TILE)
        dumps = {"scores": torch.empty((B, n_head, L, n_tiles * TILE), dtype=torch.int32,
                                       device=qkv.device),
                 "probs": torch.empty((B, n_head, L, n_tiles * TILE), dtype=torch.int8,
                                      device=qkv.device),
                 "pv": torch.empty((B, n_head, n_tiles, L, dh + 1), dtype=torch.int32,
                                   device=qkv.device)}
    ptrs = [dumps[k].data_ptr() if dump else None for k in ("scores", "probs", "pv")]
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.vitiq_attention_int8(qkv.data_ptr(), out.data_ptr(), *ptrs, B, L, D, n_head,
                                       CORES[core], stream)
    if err != 0:
        raise RuntimeError(f"vitiq_attention_int8 failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
    launches["attention_int8"] += 1
    if dump:
        dumps = {"scores": dumps["scores"][..., :L], "probs": dumps["probs"][..., :L],
                 "pv": dumps["pv"]}
        return out, dumps
    return out


def fused_encoder_layer_int8attn_stack(x: torch.Tensor, layers, n_head: int,
                                       cls_only: bool = False) -> torch.Tensor:
    """Run `EncoderLayer` modules as the int8-attention inference stack on
    bf16 x [B, L, D]: K7 on every full layer, then with ``cls_only`` K2 on
    the last layer for the CLS row; returns [B, L, D], or [B, 1, D] with
    ``cls_only``."""
    full = layers[:-1] if cls_only else layers
    for layer in full:
        x = fused_encoder_layer_int8attn(x, fel.layer_operands(layer, n_head, x.dtype), n_head)
    if cls_only:
        x = fel.fused_encoder_layer_cls(x, fel.layer_cls_operands(layers[-1], n_head, x.dtype),
                                        n_head)
    return x
