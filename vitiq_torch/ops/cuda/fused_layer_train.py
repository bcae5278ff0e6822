"""Fused post-norm encoder layer for training: the wrappers of the CUDA
kernels in `vitiq_torch/csrc/fused_layer_train.cu` (K3, K4), their plain
PyTorch versions and the differentiable stack (counterpart of
`vitiq/ops/pallas/fused_layer_train.py`, `fused_train_layer_stack`, in both
of its residual regimes).

* K3-fwd (`fused_train_layer_fwd`): one training layer, [B, L, D] -> [B, L, D],
  dropout at the three sites of the reference layer.
* K3-bwd (`fused_train_layer_bwd`): recompute the layer from x, then dx and
  the gradients of all 12 operands.
* K4-fwd (`fused_train_layer_fwd_stash`): K3-fwd's y plus the stash the
  backward reads instead of recomputing: attn [B, L, D], LN1's and LN2's
  normalized inputs xh1, xh2 [B, L, D] in x's dtype, their 1/std r1, r2
  [B, L] f32, and the normalized probabilities pbar [B, H, L, stash_cols(L)]
  in x's dtype (rows padded with zeros to a multiple of 8 elements, 16
  bytes, so that the kernels move them as tiles).
* K4-bwd (`fused_train_layer_bwd_stash`): dx and the 12 gradients from x, dy
  and the stash; it rebuilds only qkv, x1 = g1 * xh1 + be1 and the FFN
  hidden, as the JAX stash backward does.
`fused_train_layer_stack` takes K4 where `stash_enabled` (the JAX gate
`_stash_enabled`, `VITIQ_TRAIN_STASH`) puts the stash, K3 elsewhere.

The numerics follow the JAX kernels: q rounded, scaled by log2(e)/sqrt(dh) in
f32 and rounded again; exp2 probabilities rounded to the activation dtype and
summed in f32; f32 LayerNorm statistics (eps 1e-12, biased variance); dy
rounded to the activation dtype; the four matrix gradients rounded to the
weights' dtype. The port subtracts each score row's max before exp2, which
the TPU kernel does not (it relies on |score| < 88); that changes only where
the probabilities round.

Dropout is K8's counter-based hash (`vitiq/ops/pallas/train_xpack.py`:
`_hash_mask`, `_site_salt`) over the absolute (frame, token, lane) position,
so the forward and the backward, and the kernels and their plain versions,
draw the same masks. This stream differs from K3's TPU PRNG stream by design.
The kernels read the step's seed from device memory (`seed_tensor`: a
one-element int32 tensor), so a CUDA graph captured over train steps draws
each replayed step's masks; the autograd Functions save that tensor for the
backward. The dropout sites outside K3/K4 (the embedding's, and the plain
layers' three) draw the same hash through one more kernel of the .cu,
`hash_dropout_kernel` (`hash_dropout`: one pass that hashes each position
and writes x * scale or +0; its backward is the same pass over the
gradient; plain version `hash_dropout_plain`), so a plain layer drops what
K3/K4 drop at that layer.

The kernels run a chain of stages per layer (the .cu's `forward` and
`backward`): persistent wgmma GEMM stages fed by TMA (the main loop K1
shares, `csrc/gemm_wgmma.cuh`) with K3's epilogues, the attention passes,
LN2's backward rows and fixed-order reductions. One GEMM stage runs alone
through `train_gemm` (plain version `train_gemm_plain`, one per epilogue of
`EPILOGUES`); `stage_plan`, `stage_ring` and their helpers mirror which
instance each stage of a shape takes and its shared-memory ring. K4's two
attention passes run alone through `stash_attention_fwd` and
`stash_attention_bwd` (plain versions `stash_attention_fwd_plain`,
`stash_attention_bwd_plain`); `stash_tile_plan` and the `*_smem_bytes`
functions mirror their tiles and shared memory. K3's two attention passes
run alone through `recompute_attention_fwd` (attn and each query row's
max and sum, the stats K3-bwd's recompute keeps) and
`recompute_attention_bwd` (plain versions `recompute_attention_fwd_plain`,
`recompute_attention_bwd_plain`), routed by shape as K3 routes them
(`recompute_tile_plan`: the wgmma passes where round16(L) <= 144, but the
mma.sync forward at d_head 16 past 80 keys; the mma.sync passes past 144).

Each wrapper launches its kernel on a CUDA tensor (raising on any build,
launch or shape error) and runs its plain version on a CPU tensor.
`launches` counts kernel launches, one per call of a C entry point,
`stage_launches` those of `train_gemm`, `pass_launches` those of the
attention passes alone and `dropout_launches` those of `hash_dropout_kernel`;
the plain versions count nothing.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import torch

from vitiq_torch.ops.cuda import _build

LN_EPS = 1e-12
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
SUPPORTED_D_MODEL = (64, 128, 256)
SUPPORTED_D_HEAD = (16, 32, 64)
FFN_MULTIPLE = 64  # the narrowest GEMM tile
MAX_SHARED_MEMORY = 232448  # bytes a block may use on Hopper
_M32 = 0xFFFFFFFF

STASH_MAX_HEAD_LANES = 1280  # H * Lp bound of the stash (`_stash_supported`)

launches = {"fused_train_layer_fwd": 0, "fused_train_layer_bwd": 0,
            "fused_train_layer_fwd_stash": 0, "fused_train_layer_bwd_stash": 0}
# one GEMM stage called alone (`train_gemm`) and K4's attention passes
# called alone: the checks' entries, not the training path's
stage_launches = {"train_gemm": 0}
pass_launches = {"stash_attention_fwd": 0, "stash_attention_bwd": 0,
                 "recompute_attention_fwd": 0, "recompute_attention_bwd": 0}
# the plain dropout sites' kernel (`hash_dropout`): the embedding's, and the
# plain layers' (the conv1d arm, VITIQ_FUSED_TRAIN=0)
dropout_launches = {"hash_dropout": 0}


def reset_launches() -> None:
    for counts in (launches, stage_launches, pass_launches, dropout_launches):
        for name in counts:
            counts[name] = 0


def attention_bwd_smem_bytes(L: int, d_head: int) -> int:
    """Shared memory of the attention-backward block at L tokens (the
    formula of `attention_bwd_smem_bytes` in the .cu)."""
    lp = (L + 15) // 16 * 16
    return (4 * lp * (d_head + 8) + 3 * d_head * (lp + 8)) * 2 + (3 * lp + 4 * 3 * d_head) * 4


# K4's attention passes (the .cu's wg_attention_fwd, wg_attention_bwd_stash):
# their tiles and shared memory, as the .cu's header and helpers state them
WG_TILE = 64  # rows of a wgmma tile: queries, or keys
RESIDENT_ROWS = 80  # the backward holds a frame-head whole up to round16(L)
PLANE_CHUNK = 8192  # a [64][64] bf16 tile


def stash_cols(L: int) -> int:
    """pbar's row length in the stash: L rounded up to 8 elements (16 bytes)."""
    return _round_up(L, 8)


def stash_tile_plan(L: int) -> dict:
    """The tiles of K4's attention passes at L tokens (`fwd_groups`,
    `fwd_key_rows`, `bwd_resident`, `bwd_groups`, `bwd_rows` in the .cu):
    fwd_groups, the 16-key groups of the forward's score tile (the smallest
    of 2, 4, 5 that covers round16(L), its scores kept in registers; else
    64-key tiles, 4, formed twice); fwd_key_rows, the q, k and v rows the
    forward loads (16 groups, or L rounded up to 64); bwd_resident, whether
    the backward holds q, k, v, dO and all of pbar at once (round16(L) <=
    80); bwd_groups (2, 4 or 5 resident, else 4) and bwd_rows (16 groups,
    or L rounded up to 64)."""
    r16 = _round_up(L, 16)
    ng = r16 // 16
    fg = 2 if ng <= 2 else 4 if ng <= 4 else 5 if ng <= 5 else 4
    kr = 16 * fg if L <= 16 * fg else _round_up(L, WG_TILE)
    resident = r16 <= RESIDENT_ROWS
    bg = 2 if r16 <= 32 else 4 if r16 <= 64 else 5 if resident else 4
    rows = 16 * bg if resident else _round_up(L, WG_TILE)
    return dict(fwd_groups=fg, fwd_key_rows=kr, bwd_resident=resident, bwd_groups=bg,
                bwd_rows=rows)


def stash_attention_fwd_smem_bytes(L: int, d_head: int) -> int:
    """Shared memory of K4-fwd's attention block (`wg_fwd_smem_bytes`): 1 KB
    of alignment, two buffers of q, k and v rows [fwd_key_rows][d_head] bf16
    (each rounded up to 1 KB), the pbar staging chunks [rows][64 keys] over
    those keys (rows: every query, fwd_key_rows, where the scores are one
    tile of fwd_groups; else one 64-query tile), two mbarriers."""
    plan = stash_tile_plan(L)
    kr = plan["fwd_key_rows"]
    rows = kr if L <= 16 * plan["fwd_groups"] else WG_TILE
    return 1024 + 2 * _round_up(3 * kr * d_head * 2, 1024) + -(-kr // 64) * rows * 128 + 16


def stash_attention_bwd_smem_bytes(L: int, d_head: int) -> int:
    """Shared memory of K4-bwd's attention block (`wg_bwd_smem_bytes`): 1 KB
    of alignment, q, k, v and dO rows [bwd_rows][d_head] bf16; resident, the
    pbar plane (ceil(rows / 64) key chunks [rows][64] bf16, overwritten by
    dS), else one pbar tile and one dS tile [64][64]; the column-sum scratch
    [4 warps][3][d_head] f32 and two mbarriers."""
    plan = stash_tile_plan(L)
    r = plan["bwd_rows"]
    plane = -(-r // 64) * r * 128 if plan["bwd_resident"] else 2 * PLANE_CHUNK
    return 1024 + 4 * r * d_head * 2 + plane + 4 * 3 * d_head * 4 + 16


# K3's attention passes on wgmma (the .cu's wg_recompute_attention_fwd,
# wg_recompute_attention_bwd) and the shapes they take
RECOMPUTE_ROWS = 144  # they hold round16(L) <= 144 keys; longer L keeps mma.sync


def recompute_tile_plan(L: int, d_head: int) -> dict:
    """The tiles and route of K3's attention passes at L tokens and d_head
    (`recompute_wgmma`, `recompute_groups`, `recompute_fwd_wgmma` in the
    .cu): bwd_wgmma, whether the backward runs on wgmma (round16(L) <= 144;
    else the mma.sync pass train_attention_bwd); fwd_wgmma, whether the
    forward does (the same, but at d_head 16 past 80 keys, where the mma.sync
    train_attention_fwd measured faster); groups, the 16-key groups of a
    64-query tile's scores, all kept in registers (the least of 2, 4, 5, 9
    that covers round16(L)); rows, 16 groups: the q, k, v (and dO) rows each
    pass loads and the backward's pbar plane rows; bwd_warpgroups, the
    backward's warpgroups a block (`rc_bwd_warpgroups`: 3 at 9 groups past
    d_head 16, each taking 3 of a query tile's key groups, else 1)."""
    r16 = _round_up(L, 16)
    wgmma = r16 <= RECOMPUTE_ROWS
    groups = next(g for g in (2, 4, 5, 9) if r16 <= 16 * g) if wgmma else 0
    return dict(bwd_wgmma=wgmma, fwd_wgmma=wgmma and not (d_head == 16 and groups == 9),
                groups=groups, rows=16 * groups,
                bwd_warpgroups=3 if groups == 9 and d_head > 16 else 1)


def recompute_attention_fwd_smem_bytes(L: int, d_head: int) -> int:
    """Shared memory of K3's wgmma forward block (`rc_fwd_smem_bytes`): 1 KB
    of alignment, two buffers of q, k and v rows [rows][d_head] bf16 (each
    rounded up to 1 KB), two mbarriers."""
    rows = recompute_tile_plan(L, d_head)["rows"]
    return 1024 + 2 * _round_up(3 * rows * d_head * 2, 1024) + 16


def recompute_attention_bwd_smem_bytes(L: int, d_head: int) -> int:
    """Shared memory of K3's wgmma backward block (`rc_bwd_smem_bytes`): 1 KB
    of alignment, q, k, v and dO rows [rows][d_head] bf16, the pbar plane
    (ceil(rows / 64) key chunks [rows][64] bf16, overwritten by dS), the
    column-sum scratch [4 warpgroups' warps][3][d_head], the row terms [rows]
    and the dQ partials of the warpgroups past the first [64][d_head] (f32),
    an mbarrier."""
    plan = recompute_tile_plan(L, d_head)
    rows, wgs = plan["rows"], plan["bwd_warpgroups"]
    return (1024 + 4 * rows * d_head * 2 + -(-rows // 64) * rows * 128
            + 4 * wgs * 3 * d_head * 4 + rows * 4 + (wgs - 1) * WG_TILE * d_head * 4 + 16)


def fused_train_supported(L: int, D: int, ffn_hidden: int, n_head: int) -> bool:
    """Shapes the K3 kernels take: d_model 64, 128 or 256, d_head 16, 32 or
    64, an FFN width that is a multiple of 64, and an L whose
    attention-backward block fits the card's shared memory (the kernels'
    `shapes_ok`; up to L = 224 at d_head 64, so `vit_tpu_production`'s 129
    tokens train through K3, and the conv1d arm's 1025 at any d_head through
    the plain layers with K5). Decided from shapes alone, before any launch."""
    if D not in SUPPORTED_D_MODEL or n_head <= 0 or D % n_head or L <= 0:
        return False
    dh = D // n_head
    return (dh in SUPPORTED_D_HEAD and ffn_hidden > 0 and ffn_hidden % FFN_MULTIPLE == 0
            and attention_bwd_smem_bytes(L, dh) <= MAX_SHARED_MEMORY)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _key_split(lp: int, seq_len: int) -> Tuple[int, int]:
    """(mxu_k, n_tail) of `_key_split`: the TPU kernels' tail-key mode
    (``VITIQ_TRAIN_TAIL=1``), which the stash does not serve."""
    if os.environ.get("VITIQ_TRAIN_TAIL", "0") != "1":
        return lp, 0
    mxu_k = (lp // 128) * 128
    if 128 <= mxu_k <= seq_len and seq_len - mxu_k <= 8:
        return mxu_k, seq_len - mxu_k
    return lp, 0


def stash_supported(lp: int, seq_len: int, n_head: int) -> bool:
    """`_stash_supported`: no tail mode and H * Lp <= 1280."""
    return _key_split(lp, seq_len)[1] == 0 and n_head * lp <= STASH_MAX_HEAD_LANES


def stash_enabled(L: int, n_head: int, d: int, batch: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16) -> bool:
    """`_stash_enabled` at L tokens in `dtype` (Lp = L rounded up to 16 in
    bf16, to 8 otherwise). ``VITIQ_TRAIN_STASH``: ``0`` off, ``1`` on
    wherever `stash_supported`, ``auto`` (default) on at d <= 128 for
    Lp <= 80, and at d <= 256 for Lp <= 64 with a known batch <= 4096."""
    lp = _round_up(L, 16 if dtype == torch.bfloat16 else 8)
    env = os.environ.get("VITIQ_TRAIN_STASH", "auto")
    if env == "0" or not stash_supported(lp, L, n_head):
        return False
    if env == "1":
        return True
    if d <= 128:
        return lp <= 80
    return batch is not None and batch <= 4096 and lp <= 64 and d <= 256


def fused_train_stash_supported(L: int, D: int, ffn_hidden: int, n_head: int) -> bool:
    """Shapes the K4 kernels take: K3's (d_model 64, 128 or 256, d_head 16, 32
    or 64, an FFN width that is a multiple of 64), an L inside the stash gate
    (`stash_supported` at Lp = round_up(L, 16)) and attention blocks that fit
    the card's shared memory (where K3's gate holds they always do)."""
    if not fused_train_supported(L, D, ffn_hidden, n_head):
        return False
    dh = D // n_head
    return (stash_supported(_round_up(L, 16), L, n_head)
            and stash_attention_fwd_smem_bytes(L, dh) <= MAX_SHARED_MEMORY
            and stash_attention_bwd_smem_bytes(L, dh) <= MAX_SHARED_MEMORY)


def flat_weights(layer, dtype) -> List[torch.Tensor]:
    """The 12 operands of an `EncoderLayer` in the kernels' layout
    (counterpart of `_flat_weights`), differentiable back to the parameters:
    Wqkv [D, 3D] (unscaled), Wo [D, D], W1 [D, F], W2 [F, D] in `dtype`;
    biases and LN parameters f32."""
    att, ffn = layer.attention, layer.ffn

    def kernel(lin):  # torch [out, in] -> [in, out]
        return lin.weight.t().to(dtype).contiguous()

    wqkv = torch.cat([att.w_q.weight, att.w_k.weight, att.w_v.weight]).t()
    bqkv = torch.cat([att.w_q.bias, att.w_k.bias, att.w_v.bias])
    return [wqkv.to(dtype).contiguous(), bqkv.float(),
            kernel(att.w_concat), att.w_concat.bias.float(),
            layer.norm1.gamma.float(), layer.norm1.beta.float(),
            kernel(ffn.linear1), ffn.linear1.bias.float(),
            kernel(ffn.linear2), ffn.linear2.bias.float(),
            layer.norm2.gamma.float(), layer.norm2.beta.float()]


# --------------------------------------------------------------------------
# dropout masks: _hash_mask / _site_salt of vitiq/ops/pallas/train_xpack.py
# --------------------------------------------------------------------------

def site_salt(layer_idx: int, site: int) -> int:
    return ((layer_idx * 3 + site) * 0x9E3779B9 + 0x61C88647) & _M32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 of int64 h in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed_plus(seed, salt: int):
    """(seed + salt) mod 2^32: an int for an int seed, an int64 tensor on the
    seed's device for a tensor one (the step's int32 seed on the card)."""
    if isinstance(seed, torch.Tensor):
        return (seed.reshape(()).to(torch.int64) + salt) & _M32
    return (int(seed) + salt) & _M32


def mask_bits(shape: Tuple[int, int, int], seed, salt: int, device=None,
              lane0: int = 0) -> torch.Tensor:
    """The 32 hash bits of every position of a [G, L, W] block (int64 in
    [0, 2^32)): murmur3 fmix32 over the mixed (frame, token, lane) index plus
    seed + salt, as `_hash_mask` computes them in int32. `seed` is an int or
    an int32 tensor on `device` (one element), whose value is read on the
    device, so a captured CUDA graph draws the masks of each replay's seed.
    The lanes are numbered from `lane0` (a column shard of a wider
    activation: its lanes' positions in the whole)."""
    G, L, W = shape
    gi = torch.arange(G, dtype=torch.int64, device=device).view(G, 1, 1)
    li = torch.arange(L, dtype=torch.int64, device=device).view(1, L, 1)
    wi = torch.arange(lane0, lane0 + W, dtype=torch.int64, device=device).view(1, 1, W)
    h = mul32(gi, 0x9E3779B1) ^ mul32(li, 0x85EBCA77) ^ mul32(wi, 0xC2B2AE3D)
    return fmix32((h + seed_plus(seed, salt)) & _M32)


def seed_tensor(seed, device) -> torch.Tensor:
    """The step seed as the kernels read it: a one-element int32 tensor on
    `device` (a tensor seed is used as it is where it already is one; an int
    is copied there, which a CUDA graph capture does not allow)."""
    if isinstance(seed, torch.Tensor):
        t = seed.reshape(1)
        if t.dtype != torch.int32 or t.device != torch.device(device):
            t = t.to(device=device, dtype=torch.int32)
        return t.contiguous()
    return torch.tensor([(int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31], dtype=torch.int32,
                        device=device)


def drop_threshold(rate: float) -> Tuple[int, float]:
    """(threshold, scale): a position is dropped iff its low 31 hash bits are
    below the threshold; a kept one is multiplied by the f32 scale. (0, 1.0)
    when rate is 0: no dropout."""
    if rate == 0.0:
        return 0, 1.0
    return int(rate * 2147483648.0), float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def hash_dropout_plain(x: torch.Tensor, rate: float, seed, salt: int,
                       lane0: int = 0) -> torch.Tensor:
    """The plain version of `hash_dropout_kernel`: x * scale (f32, rounded
    to x's dtype) where the position hash of seed + `salt` over x's last two
    dims as (token, lane from `lane0`) and the rest as frames keeps a
    position, +0 where it drops it (`mask_bits`, `drop_threshold`)."""
    thresh, scale = drop_threshold(rate)
    L, W = x.shape[-2], x.shape[-1]
    bits = mask_bits((x.numel() // (L * W), L, W), seed, salt, x.device, lane0)
    kept = ((bits & 0x7FFFFFFF) >= thresh).reshape(x.shape)
    scaled = x.float() * torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.where(kept, scaled, torch.zeros((), device=x.device)).to(x.dtype)


def hash_dropout_apply(x: torch.Tensor, rate: float, seed, salt: int,
                       lane0: int = 0) -> torch.Tensor:
    """The plain dropout sites' kernel (C entry `vitiq_hash_dropout`, one
    pass: each position's hash, read x, write x * scale or +0) on a CUDA
    tensor of at least two dims, bf16 or f32; `seed` an int or an int32
    tensor on x's device, read there; lanes numbered from `lane0`. The plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return hash_dropout_plain(x, rate, seed, salt, lane0)
    if x.dim() < 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"hash_dropout takes a bf16 or f32 tensor of at least 2 dims, got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    thresh, scale = drop_threshold(rate)
    seed_t = seed_tensor(seed, x.device)
    L, W = x.shape[-2], x.shape[-1]
    _build.call("vitiq_hash_dropout", x.device, x.data_ptr(), out.data_ptr(), x.numel() // W, L,
                W, 0 if x.dtype == torch.bfloat16 else 1, thresh, scale, seed_t.data_ptr(),
                salt & _M32, lane0)
    dropout_launches["hash_dropout"] += 1
    return out


class _HashDropout(torch.autograd.Function):
    """Dropout at a plain site: the forward and the backward each apply the
    kernel (the backward to the gradient: the same mask and scale), so
    nothing but the seed tensor is saved."""

    @staticmethod
    def forward(ctx, x, rate, seed, salt, lane0):
        ctx.save_for_backward(seed)
        ctx.site = (rate, salt, lane0)
        return hash_dropout_apply(x, rate, seed, salt, lane0)

    @staticmethod
    def backward(ctx, dy):
        (seed,) = ctx.saved_tensors
        rate, salt, lane0 = ctx.site
        return hash_dropout_apply(dy, rate, seed, salt, lane0), None, None, None, None


def hash_dropout(x: torch.Tensor, rate: float, seed, salt: int, lane0: int = 0) -> torch.Tensor:
    """Differentiable dropout at a plain site (`hash_dropout_apply`); `seed`
    an int or an int32 tensor on x's device; lanes numbered from `lane0`."""
    return _HashDropout.apply(x, float(rate), seed_tensor(seed, x.device), int(salt),
                              int(lane0))


def dropout_mask(shape: Tuple[int, int, int], rate: float, seed, layer_idx: int,
                 site: int, device=None) -> torch.Tensor:
    """f32 keep/(1 - rate) multiplier of a [B, L, W] activation at dropout
    site 0 (attention output), 1 (FFN hidden) or 2 (FFN output); `seed` an
    int or an int32 device tensor (`mask_bits`)."""
    thresh, scale = drop_threshold(rate)
    if thresh == 0 and scale == 1.0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    bits = mask_bits(shape, seed, site_salt(layer_idx, site), device)
    keep = (bits & 0x7FFFFFFF) >= thresh
    return keep.float() * torch.tensor(scale, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of the stored operands accumulated in f32 (exact bf16 products)."""
    return torch.matmul(a.float(), b.float())


def _ln(z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """(gamma * xh + beta, xh, 1/std) with f32 statistics."""
    mean = z.mean(dim=-1, keepdim=True)
    d = z - mean
    rstd = torch.rsqrt(d.square().mean(dim=-1, keepdim=True) + LN_EPS)
    xh = d * rstd
    return gamma * xh + beta, xh, rstd


def _ln_bwd(dy, xh, rstd, gamma):
    """dz for y = gamma * xh + beta (`_ln_bwd` of the JAX module)."""
    dyg = dy * gamma
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xh).mean(dim=-1, keepdim=True)
    return rstd * (dyg - m1 - xh * m2)


def _masks(x: torch.Tensor, F: int, drop: float, seed: int, layer_idx: int):
    B, L, D = x.shape
    return [dropout_mask((B, L, w), drop, seed, layer_idx, site, x.device)
            for site, w in ((0, D), (1, F), (2, D))]


def _heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, dh] f32."""
    B, L, D = t.shape
    return t.float().reshape(B, L, n_head, D // n_head).transpose(1, 2)


def _forward(x, ops, n_head, drop, seed, layer_idx):
    """The layer and every intermediate the backward needs, in x's dtype
    where the kernels round to bf16."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    dt = x.dtype
    m1, m2, m3 = _masks(x, w1.shape[1], drop, seed, layer_idx)
    qkv = (_mm(x, wqkv) + bqkv).to(dt)
    a = _attention_plain(qkv, n_head)
    attn_flat = a["attn_flat"]
    x1f, xh1, r1 = _ln((_mm(attn_flat, wo) + bo) * m1 + x.float(), g1, be1)
    x1 = x1f.to(dt)
    h = (torch.relu(_mm(x1, w1) + b1) * m2).to(dt)
    y, xh2, r2 = _ln((_mm(h, w2) + b2) * m3 + x1.float(), g2, be2)
    return y.to(dt), dict(a, x1=x1, xh1=xh1, r1=r1, h=h, xh2=xh2, r2=r2, masks=(m1, m2, m3))


def _attention_plain(qkv: torch.Tensor, n_head: int) -> dict:
    """The attention forward of the layer (`train_attention_fwd`) on qkv [B,
    L, 3D] in the activation dtype: the scaled q, k, v per head, the rounded
    probabilities p and their f32 row sums den, attn per head and flat."""
    dt = qkv.dtype
    B, L, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (_heads(t, n_head) for t in qkv.split(D, dim=-1))
    qs = (q * (_LOG2E / math.sqrt(D // n_head))).to(dt).float()
    s = qs @ k.transpose(-1, -2)  # log2 units
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(dt).float()
    den = p.sum(dim=-1, keepdim=True)
    attn = ((p @ v) / den).to(dt)
    attn_flat = attn.transpose(1, 2).reshape(B, L, D)
    return dict(qs=qs, k=k, v=v, p=p, den=den, attn=attn, attn_flat=attn_flat)


def _gradients(x, dy, r, ops, n_head):
    """dx (x's dtype) and the 12 operand gradients (f32) from the activations
    the backward reads (`r`: qs, k, v, the rounded normalized probabilities
    pbar and attn per head, attn_flat, x1, h, xh1, r1, xh2, r2, the masks):
    the gradient stages shared by K3-bwd and K4-bwd."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    dt = x.dtype
    m1, m2, m3 = r["masks"]
    h, x1, attn_flat = r["h"], r["x1"], r["attn_flat"]

    def colsum(t):
        return t.reshape(-1, t.shape[-1]).sum(dim=0)

    def wgrad(act, grad):  # act^T grad over all rows
        return _mm(act.reshape(-1, act.shape[-1]).t(), grad.reshape(-1, grad.shape[-1]))

    dy = dy.to(dt).float()
    dg2, dbe2 = colsum(dy * r["xh2"]), colsum(dy)
    dz2 = _ln_bwd(dy, r["xh2"], r["r2"], g2)
    df = dz2 * m3
    dfb = df.to(dt)
    db2, dw2 = colsum(df), wgrad(h, dfb)
    dpre = torch.where(h.float() > 0, _mm(dfb, w2.t()) * m2, torch.zeros_like(m2))
    dpreb = dpre.to(dt)
    db1, dw1 = colsum(dpre), wgrad(x1, dpreb)
    dx1 = dz2 + _mm(dpreb, w1.t())
    dg1, dbe1 = colsum(dx1 * r["xh1"]), colsum(dx1)
    dz1 = _ln_bwd(dx1, r["xh1"], r["r1"], g1)
    da = dz1 * m1
    dab = da.to(dt)
    dbo, dwo = colsum(da), wgrad(attn_flat, dab)
    dattn = _mm(dab, wo.t()).to(dt)

    dqkv = _attention_bwd_plain(dattn, r, n_head)
    dqkvb = dqkv.to(dt)
    dbqkv, dwqkv = colsum(dqkv), wgrad(x, dqkvb)
    dx = (dz1 + _mm(dqkvb, wqkv.t())).to(dt)
    grads = [dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2]
    return dx, [g.to(w.dtype) for g, w in zip(grads, ops)]


def _attention_bwd_plain(dattn: torch.Tensor, r: dict, n_head: int) -> torch.Tensor:
    """The attention backward (`train_attention_bwd`): dqkv [B, L, 3D] in f32
    from dattn [B, L, D] and the forward's qs, k, v, attn per head and the
    rounded normalized probabilities pbar; per head, the flash identity gives
    the row term."""
    dt = dattn.dtype
    B, L, D = dattn.shape
    scale2 = _LOG2E / math.sqrt(D // n_head)
    do = _heads(dattn, n_head)
    pbar = r["pbar"]
    row = (do * r["attn"].float()).sum(dim=-1, keepdim=True)
    ds = (pbar * (do @ r["v"].transpose(-1, -2) - row)).to(dt).float()
    dq = (ds @ r["k"]) * (_LN2 * scale2)
    dk = (ds.transpose(-1, -2) @ r["qs"]) * _LN2
    dv = pbar.transpose(-1, -2) @ do
    return torch.cat([t.transpose(1, 2).reshape(B, L, D) for t in (dq, dk, dv)], dim=-1)


def fused_train_layer_reference(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                                drop: float, seed: int, layer_idx: int) -> torch.Tensor:
    """Plain version of K3-fwd: x [B, L, D] -> y [B, L, D] in x's dtype.
    Differentiable (the masks are constants)."""
    return _forward(x, ops, n_head, drop, seed, layer_idx)[0]


def fused_train_layer_backward_reference(
        x: torch.Tensor, dy: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
        drop: float, seed: int, layer_idx: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain version of K3-bwd, an explicit recompute and backprop: returns
    dx (x's dtype) and the gradients of the 12 operands (matrices rounded to
    their dtype, vectors f32)."""
    with torch.no_grad():
        _, r = _forward(x, ops, n_head, drop, seed, layer_idx)
        r["pbar"] = (r["p"] / r["den"]).to(x.dtype).float()
        return _gradients(x, dy, r, ops, n_head)


def _pbar_of(a: dict, dt: torch.dtype) -> torch.Tensor:
    """The stash's pbar from the attention forward's pieces: bf16(bf16(exp2(s
    - max)) / l) [B, H, L, L], its rows padded with zeros to stash_cols(L)."""
    pbar = (a["p"] / a["den"]).to(dt)
    L = pbar.shape[-1]
    return torch.nn.functional.pad(pbar, (0, stash_cols(L) - L))


def stash_attention_fwd_plain(qkv: torch.Tensor, n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4-fwd's attention pass (`stash_attention_fwd`): qkv
    [B, L, 3D] (q unscaled) -> (attn [B, L, D], pbar [B, H, L, stash_cols(L)]),
    both in qkv's dtype; the pieces of `fused_train_layer_stash_reference`."""
    a = _attention_plain(qkv, n_head)
    return a["attn_flat"], _pbar_of(a, qkv.dtype)


def _stash_attention_inputs(qkv: torch.Tensor, attn: torch.Tensor, pbar: torch.Tensor,
                            n_head: int) -> dict:
    """What the stash's attention backward reads, per head and in f32: the
    scaled q, k, v from qkv, pbar without its padding, attn."""
    dt = qkv.dtype
    D = qkv.shape[-1] // 3
    q, k, v = (_heads(t, n_head) for t in qkv.split(D, dim=-1))
    qs = (q * (_LOG2E / math.sqrt(D // n_head))).to(dt).float()
    return dict(qs=qs, k=k, v=v, pbar=pbar[..., :qkv.shape[1]].float(),
                attn=_heads(attn, n_head))


def stash_attention_bwd_plain(qkv: torch.Tensor, attn: torch.Tensor, dattn: torch.Tensor,
                              pbar: torch.Tensor, n_head: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4-bwd's attention pass (`stash_attention_bwd`): from
    qkv [B, L, 3D], attn and dattn [B, L, D] and the stashed pbar, (dqkv [B,
    L, 3D] in dattn's dtype, each frame's column sums of the f32 dqkv [B,
    3D]); the attention backward of `fused_train_layer_stash_backward_reference`."""
    with torch.no_grad():
        dqkv = _attention_bwd_plain(dattn, _stash_attention_inputs(qkv, attn, pbar, n_head),
                                    n_head)
        return dqkv.to(dattn.dtype), dqkv.sum(dim=1)


def recompute_attention_fwd_plain(qkv: torch.Tensor, n_head: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3's attention forward pass (`recompute_attention_fwd`):
    qkv [B, L, 3D] (q unscaled) -> (attn [B, L, D] in qkv's dtype, stats [B,
    H, L, 2] f32: each query row's max score m, log2 units, and l, the f32
    sum of its rounded probabilities); the pieces of
    `fused_train_layer_reference`, m the max it subtracts."""
    a = _attention_plain(qkv, n_head)
    m = (a["qs"] @ a["k"].transpose(-1, -2)).amax(dim=-1)
    return a["attn_flat"], torch.stack([m, a["den"][..., 0]], dim=-1)


def _recompute_attention_inputs(qkv: torch.Tensor, attn: torch.Tensor, stats: torch.Tensor,
                                n_head: int) -> dict:
    """What K3's attention backward reads, per head and in f32: the scaled q,
    k, v from qkv, attn, and pbar = bf16(bf16(exp2(s - m)) / l) formed again
    from the scores and the forward's stats (m, l)."""
    dt = qkv.dtype
    D = qkv.shape[-1] // 3
    q, k, v = (_heads(t, n_head) for t in qkv.split(D, dim=-1))
    qs = (q * (_LOG2E / math.sqrt(D // n_head))).to(dt).float()
    p = torch.exp2(qs @ k.transpose(-1, -2) - stats[..., :1]).to(dt).float()
    return dict(qs=qs, k=k, v=v, pbar=(p / stats[..., 1:]).to(dt).float(),
                attn=_heads(attn, n_head))


def recompute_attention_bwd_plain(qkv: torch.Tensor, attn: torch.Tensor, dattn: torch.Tensor,
                                  stats: torch.Tensor, n_head: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3's attention backward pass (`recompute_attention_bwd`):
    from qkv [B, L, 3D], attn and dattn [B, L, D] and the forward's stats [B,
    H, L, 2], (dqkv [B, L, 3D] in dattn's dtype, each frame's column sums of
    the f32 dqkv [B, 3D]); the attention backward of
    `fused_train_layer_backward_reference`."""
    with torch.no_grad():
        dqkv = _attention_bwd_plain(
            dattn, _recompute_attention_inputs(qkv, attn, stats, n_head), n_head)
        return dqkv.to(dattn.dtype), dqkv.sum(dim=1)


def fused_train_layer_stash_reference(
        x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int, drop: float, seed: int,
        layer_idx: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version of K4-fwd: (y, stash). y is K3's plain y, bit for bit;
    the stash is (attn [B, L, D], xh1, xh2 [B, L, D] in x's dtype, r1, r2
    [B, L] f32, pbar [B, H, L, stash_cols(L)] in x's dtype, pbar =
    bf16(bf16(exp2(s - max)) / l), its padding 0)."""
    with torch.no_grad():
        y, r = _forward(x, ops, n_head, drop, seed, layer_idx)
        dt = x.dtype
        stash = (r["attn_flat"], r["xh1"].to(dt), r["xh2"].to(dt), r["r1"][..., 0],
                 r["r2"][..., 0], _pbar_of(r, dt))
    return y, stash


def fused_train_layer_stash_backward_reference(
        x: torch.Tensor, dy: torch.Tensor, stash: Sequence[torch.Tensor],
        ops: Sequence[torch.Tensor], n_head: int, drop: float, seed: int,
        layer_idx: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain version of K4-bwd: rebuild qkv = bf16(x Wqkv + bqkv), x1 =
    bf16(xh1 g1 + be1) from the stashed xh1, h = bf16(relu(x1 W1 + b1) m2),
    then K3's gradient stages on the stash (LN backwards on the stashed xh,
    the attention backward on the stashed pbar and attn)."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    attn, xh1, xh2, r1, r2, pbar = stash
    dt = x.dtype
    with torch.no_grad():
        masks = _masks(x, w1.shape[1], drop, seed, layer_idx)
        qkv = (_mm(x, wqkv) + bqkv).to(dt)
        x1 = (xh1.float() * g1 + be1).to(dt)
        h = (torch.relu(_mm(x1, w1) + b1) * masks[1]).to(dt)
        r = dict(_stash_attention_inputs(qkv, attn, pbar, n_head), attn_flat=attn, x1=x1, h=h,
                 xh1=xh1.float(), r1=r1[..., None], xh2=xh2.float(), r2=r2[..., None],
                 masks=masks)
        return _gradients(x, dy, r, ops, n_head)


# --------------------------------------------------------------------------
# the GEMM stages one at a time: plain versions and shared-memory sizing
# --------------------------------------------------------------------------

# The kernels' GEMM epilogues, in the order of `Epi` in the .cu. The forward
# stages (bias, relu_drop, ln_fwd) take A [M, K] rows and W [K, N]; the input
# gradients (B_TRANSPOSED) B = W^T from W [N, K] as stored; the weight
# gradients (partial) A = act^T from act [depth, K1], in depth splits.
EPILOGUES = ("bias", "relu_drop", "ln_fwd", "store", "dpre", "ln_bwd", "res_out", "partial")
B_TRANSPOSED = ("store", "dpre", "ln_bwd", "res_out")
_COL_SUMS = {"dpre": 1, "ln_bwd": 3}  # column sums an epilogue writes
GW_MAX_RING = 6
ROW_TILE = 64  # rows of a column-sum partial


def _site_mask(shape, drop, device=None) -> torch.Tensor:
    """The f32 mask of an activation of `shape` [..., N] whose rows are
    frames of L tokens: drop = (rate, seed, layer_idx, site, L)."""
    rate, seed, layer_idx, site, L = drop
    N, rows = shape[-1], math.prod(shape[:-1])
    mask = dropout_mask((-(-rows // L), L, N), rate, seed, layer_idx, site, device)
    return mask.reshape(-1, N)[:rows].reshape(shape)


def weight_grad_splits(rows: int) -> int:
    """Depth splits of a weight gradient over `rows` rows (`Shape::splits`):
    ~2K rows each, at most 64."""
    return min(64, max(1, rows // 2048))


def depth_chunk(depth: int, splits: int) -> int:
    """Rows of one depth split: ceil(depth / splits) rounded up to the 64-deep
    step (`Shape::k_chunk`)."""
    return _round_up(-(-depth // splits), 64)


def _colsum(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).sum(dim=0)


def train_gemm_plain(a: torch.Tensor, b: torch.Tensor, epi: str, *, bias=None, res=None,
                     res32=None, xh=None, rstd=None, gamma=None, beta=None, drop=None,
                     splits: int = 1):
    """The plain version of one of K3/K4's GEMM stages (`train_gemm`), at the
    kernels' rounding points, on activations [..., K] (the plain layer's
    operations, so that the stages compose to it bit for bit). `drop`:
    (rate, seed, layer_idx, site, L); None is rate 0. Returns, by `epi`:
    bias: bf16(a W + bias); relu_drop: bf16(relu(a W + bias) mask);
    ln_fwd: (bf16(LN(z)), xh f32, 1/std f32 [...]) for z = (a W + bias) mask +
    res; store: bf16(a W^T); res_out: bf16(res32 + a W^T); dpre: (bf16(d), the
    column sums of d) for d = (res > 0) (a W^T) mask (res the FFN hidden h
    as FFN1 leaves it, bf16(relu(.) mask): the kernel takes the mask where h
    > 0 to be its keep scale);
    ln_bwd: (bf16(dz mask), dz f32, the column sums of g xh, g and dz mask
    [3, N]) for g = res32 + a W^T and dz its LN backward; partial: [chunks,
    K1, N] f32, a^T b over each depth chunk of `depth_chunk(depth, splits)`
    rows (a = act [depth, K1], b the gradient [depth, N])."""
    dt = a.dtype
    if epi == "partial":
        act, grad = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        chunk = depth_chunk(act.shape[0], splits)
        return torch.stack([_mm(act[c:c + chunk].t(), grad[c:c + chunk])
                            for c in range(0, act.shape[0], chunk)])
    prod = _mm(a, b.t() if epi in B_TRANSPOSED else b)
    mask = _site_mask(prod.shape, drop or (0.0, 0, 0, 0, 1), prod.device)
    if epi == "bias":
        return (prod + bias).to(dt)
    if epi == "relu_drop":
        return (torch.relu(prod + bias) * mask).to(dt)
    if epi == "ln_fwd":
        y, xh_, rstd_ = _ln((prod + bias) * mask + res.float(), gamma, beta)
        return y.to(dt), xh_, rstd_[..., 0]
    if epi == "store":
        return prod.to(dt)
    if epi == "res_out":
        return (res32 + prod).to(dt)
    if epi == "dpre":
        d = torch.where(res.float() > 0, prod * mask, torch.zeros_like(mask))
        return d.to(dt), _colsum(d)
    if epi == "ln_bwd":
        g = res32 + prod
        sums = [_colsum(g * xh), _colsum(g)]
        dz = _ln_bwd(g, xh, rstd[..., None], gamma)
        da = dz * mask
        return da.to(dt), dz, torch.stack(sums + [_colsum(da)])
    raise ValueError(f"epi must be one of {EPILOGUES}, got {epi!r}")


def random_stage_operands(epi: str, M: int, K: int, N: int, L: int, gen: torch.Generator,
                          device, seed: int = 1234):
    """Random operands of one GEMM stage (for `train_gemm` against
    `train_gemm_plain`) at the shapes it has in a layer of M rows of L
    tokens: (a, b, keywords). a: A [M, K] (partial: act [K, M], with the
    gradient [K, N] as b); b: W [K, N] or W [N, K] (B_TRANSPOSED); the
    epilogue's rows and vectors; dropout 0.1 at `seed` where the epilogue
    draws a mask, and dpre's h drawn under that mask, as FFN1 leaves it."""
    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(shape, generator=gen)).to(device, dt)

    if epi == "partial":
        return rnd(K, M), rnd(K, N, scale=0.1), {}
    a = rnd(M, K)
    b = rnd(N, K, scale=K ** -0.5) if epi in B_TRANSPOSED else rnd(K, N, scale=K ** -0.5)
    kw = {}
    if epi in ("bias", "relu_drop", "ln_fwd"):
        kw["bias"] = rnd(N, scale=0.1, dt=torch.float32)
    if epi in ("ln_fwd", "ln_bwd"):
        kw["gamma"] = 1.0 + rnd(N, scale=0.1, dt=torch.float32)
    if epi == "ln_fwd":
        kw.update(beta=rnd(N, scale=0.1, dt=torch.float32), res=rnd(M, N))
    if epi in ("ln_bwd", "res_out"):
        kw["res32"] = rnd(M, N, dt=torch.float32)
    if epi == "ln_bwd":
        kw.update(xh=rnd(M, N, dt=torch.float32),
                  rstd=(1.0 + 0.1 * torch.rand(M, generator=gen)).to(device))
    if epi in ("relu_drop", "ln_fwd", "dpre", "ln_bwd"):
        kw["drop"] = (0.1, seed, 3, 1, L)
    if epi == "dpre":
        mask = _site_mask((M, N), kw["drop"], device)
        kw["res"] = (torch.relu(rnd(M, N, dt=torch.float32)) * mask).bfloat16()
    return a, b, kw


def ln_bwd_rows_plain(dy: torch.Tensor, xh: torch.Tensor, rstd: torch.Tensor,
                      gamma: torch.Tensor, mask: torch.Tensor):
    """LN2's backward (`ln_bwd_rows`): (bf16 df = dz mask, dz f32, the column
    sums of dy xh, dy and df [3, D]) for dy in the activation dtype, xh and
    rstd [..., 1] as the forward left them."""
    dt = dy.dtype
    dy = dy.float()
    sums = [_colsum(dy * xh), _colsum(dy)]
    dz = _ln_bwd(dy, xh, rstd, gamma)
    df = dz * mask
    return df.to(dt), dz, torch.stack(sums + [_colsum(df)])


def stage_slab(epi: str, n: int) -> int:
    """A stage's slab width BN: D for the LayerNorm stages, else the widest
    of 256, 128 and 64 that divides its N (`stage<EPI>` in the .cu)."""
    if epi in ("ln_fwd", "ln_bwd"):
        return n
    return 256 if n % 256 == 0 else 128 if n % 128 == 0 else 64


def stage_built(epi: str, bn: int, resident: bool) -> bool:
    """Whether the library holds that instance (`stage_built` in the .cu)."""
    if epi == "partial":
        return not resident
    if epi in ("ln_fwd", "ln_bwd"):
        return bn != 256 if resident else True
    if epi == "res_out":
        return bn == 64 if resident else bn != 64
    return resident


def stage_resident(epi: str, bn: int, k: int) -> bool:
    """W resident (K <= 256, where that instance is built) or streamed."""
    return k <= 256 and stage_built(epi, bn, True)


def stage_smem_bytes(epi: str, bn: int, k: int, resident: bool, ring: int) -> int:
    """Shared memory of a stage with `ring` entries (`gemm_smem_bytes` in
    gemm_wgmma.cuh plus the epilogue's `stage_extra`): alignment, the
    epilogue's bias / gamma / beta and column-sum scratch, the mbarriers,
    W's slab (resident) and the ring's entries (an A tile [64, K], or a
    64-deep step of A [128, 64] and B [64, BN])."""
    extra = 3 * bn * 4 + 2 * _COL_SUMS.get(epi, 0) * 4 * bn * 4
    entry = 64 * k * 2 if resident else 128 * 128 + bn * 128
    return (1024 + extra + 8 * (1 + 2 * GW_MAX_RING) + (bn * k * 2 if resident else 0)
            + ring * entry)


def stage_ring(epi: str, bn: int, k: int, resident: bool) -> int:
    """The ring's depth in what MAX_SHARED_MEMORY leaves (`gemm_ring`): 0
    where two entries do not fit, at most GW_MAX_RING."""
    fixed = stage_smem_bytes(epi, bn, k, resident, 0)
    ring = (MAX_SHARED_MEMORY - fixed) // (stage_smem_bytes(epi, bn, k, resident, 1) - fixed)
    return 0 if ring < 2 else min(ring, GW_MAX_RING)


def stage_plan(D: int, F: int) -> List[Tuple[str, str, int, int]]:
    """The GEMM stages K3 and K4 launch at d_model D and FFN width F, as
    (stage, epilogue, K, N) in launch order: the forward's four (the
    backward's recompute or rebuild too), then each weight's gradient (K
    the width of act, the rows of the output) before its input gradient."""
    return [("qkv", "bias", D, 3 * D), ("out-proj + LN1", "ln_fwd", D, D),
            ("ffn1", "relu_drop", D, F), ("ffn2 + LN2", "ln_fwd", F, D),
            ("dW2", "partial", F, D), ("ffn2 dgrad", "dpre", D, F),
            ("dW1", "partial", D, F), ("ffn1 dgrad + LN1 bwd", "ln_bwd", F, D),
            ("dWo", "partial", D, D), ("out-proj dgrad", "store", D, D),
            ("dWqkv", "partial", D, 3 * D), ("qkv dgrad", "res_out", 3 * D, D)]


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _check_inputs(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                  stash: bool = False) -> int:
    """Validate what the kernels (K3, or K4 with `stash`) take; returns the
    FFN width."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 [B, L, D] tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    B, L, D = x.shape
    if len(ops) != 12:
        raise ValueError(f"expected 12 layer operands, got {len(ops)}")
    F = ops[6].shape[-1]
    if B == 0 or not fused_train_supported(L, D, F, n_head):
        raise ValueError(f"{'K4' if stash else 'K3'} takes d_model in {SUPPORTED_D_MODEL}, "
                         f"d_head in {SUPPORTED_D_HEAD}, an FFN width that is a multiple of "
                         f"{FFN_MULTIPLE} and L up to the shared-memory bound; got B={B}, L={L}, "
                         f"d_model={D}, n_head={n_head}, ffn={F}")
    if stash and not fused_train_stash_supported(L, D, F, n_head):
        raise ValueError(f"K4 takes L inside the stash gate (H * round_up(L, 16) <= "
                         f"{STASH_MAX_HEAD_LANES}, no tail keys); got L={L}, n_head={n_head}")
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,),
              (D, F), (F,), (F, D), (D,), (D,), (D,)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        want = torch.bfloat16 if len(shape) == 2 else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"operand {i}: want contiguous {want} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return F


def _launch(entry: str, counter: str, x: torch.Tensor, pointers, ops, n_head: int, F: int,
            drop: float, seed, layer_idx: int) -> None:
    """Allocate the workspace, launch one C entry point, raise on its error,
    count the launch. The kernel reads the seed from device memory."""
    B, L, D = x.shape
    lib = _build.library()
    size = getattr(lib, entry + "_workspace")(B, L, D, n_head, F)
    workspace = torch.empty(size, dtype=torch.uint8, device=x.device)
    thresh, scale = drop_threshold(drop)
    seed_t = seed_tensor(seed, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(*pointers, *(t.data_ptr() for t in ops),
                                  workspace.data_ptr(), B, L, D, n_head, F, thresh, scale,
                                  seed_t.data_ptr(), layer_idx, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
    launches[counter] += 1


def fused_train_layer_fwd(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                          drop: float, seed, layer_idx: int) -> torch.Tensor:
    """K3-fwd: one training layer, bf16 [B, L, D] -> bf16 [B, L, D]; the plain
    version for a CPU tensor. `seed`: the step's int32 dropout seed, an int or
    a one-element int32 tensor on x's device (`seed_tensor`)."""
    if x.device.type == "cpu":
        return fused_train_layer_reference(x, ops, n_head, drop, seed, layer_idx)
    F = _check_inputs(x, ops, n_head)
    y = torch.empty_like(x)
    _launch("vitiq_train_layer_fwd", "fused_train_layer_fwd", x, (x.data_ptr(), y.data_ptr()),
            ops, n_head, F, drop, seed, layer_idx)
    return y


def fused_train_layer_bwd(x: torch.Tensor, dy: torch.Tensor, ops: Sequence[torch.Tensor],
                          n_head: int, drop: float, seed,
                          layer_idx: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K3-bwd: dx and the 12 operand gradients (matrices rounded to bf16,
    vectors f32); the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_train_layer_backward_reference(x, dy, ops, n_head, drop, seed, layer_idx)
    F = _check_inputs(x, ops, n_head)
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    dx = torch.empty_like(x)
    grads = torch.empty(sum(t.numel() for t in ops), dtype=torch.float32, device=x.device)
    _launch("vitiq_train_layer_bwd", "fused_train_layer_bwd", x,
            (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), grads.data_ptr()),
            ops, n_head, F, drop, seed, layer_idx)
    parts = grads.split([t.numel() for t in ops])
    return dx, [g.view(t.shape).to(t.dtype) for g, t in zip(parts, ops)]


def train_gemm(a: torch.Tensor, b: torch.Tensor, epi: str, *, bias=None, res=None, res32=None,
               xh=None, rstd=None, gamma=None, beta=None, drop=None, splits: int = 1,
               xh_bf16: bool = False):
    """One of K3/K4's GEMM stages alone (C entry `vitiq_train_gemm_bf16`) on
    2-D operands, returning what `train_gemm_plain` returns (the column sums
    added over the kernel's 64-row tiles in f32; with `xh_bf16` ln_fwd's xh
    in bf16, as K4-fwd stashes it; ln_bwd reads xh in its dtype). a: [M, K]
    (partial: act [depth, K1]); b: W [K, N] (bias, relu_drop, ln_fwd), W [N,
    K] (B_TRANSPOSED) or the gradient [depth, N] (partial); bf16. The plain
    version for a CPU tensor."""
    if a.device.type == "cpu":
        return train_gemm_plain(a, b, epi, bias=bias, res=res, res32=res32, xh=xh, rstd=rstd,
                                gamma=gamma, beta=beta, drop=drop, splits=splits)
    if epi not in EPILOGUES:
        raise ValueError(f"epi must be one of {EPILOGUES}, got {epi!r}")
    if (a.dim() != 2 or b.dim() != 2 or any(t.dtype != torch.bfloat16 or not t.is_contiguous()
                                              or t.device != a.device for t in (a, b))):
        raise ValueError(f"train_gemm takes contiguous bf16 2-D a and b on one device, got "
                         f"{a.dtype} {tuple(a.shape)}, {b.dtype} {tuple(b.shape)}")
    dev = a.device
    if epi == "partial":
        K, M = a.shape
        N = b.shape[1]
        ok = b.shape[0] == K
    else:
        M, K = a.shape
        N, kb = (b.shape[0], b.shape[1]) if epi in B_TRANSPOSED else (b.shape[1], b.shape[0])
        ok = kb == K and K % 64 == 0
    if not ok or N % 64 or (epi in ("ln_fwd", "ln_bwd") and N not in SUPPORTED_D_MODEL):
        raise ValueError(f"train_gemm {epi}: shapes {tuple(a.shape)}, {tuple(b.shape)} do not "
                         "fit (K and N multiples of 64, LayerNorm rows of 64, 128 or 256)")
    empty = (lambda shape, dt: torch.empty(shape, dtype=dt, device=dev))
    out = out32 = xh_out = xh_out16 = rstd_out = part = None
    if epi == "partial":
        out32 = empty((-(-K // depth_chunk(K, splits)), M, N), torch.float32)
    else:
        out = empty((M, N), torch.bfloat16)
    if epi == "ln_fwd":
        xh_out16 = empty((M, N), torch.bfloat16) if xh_bf16 else None
        xh_out = None if xh_bf16 else empty((M, N), torch.float32)
        rstd_out = empty((M,), torch.float32)
    if epi == "ln_bwd":
        out32 = empty((M, N), torch.float32)
    if epi in _COL_SUMS:  # [sums][sum_stride(M)][N]: ceil(M / 64) tiles and a spare
        part = empty((_COL_SUMS[epi], -(-M // 128) * 2, N), torch.float32)
    xh16 = xh if xh is not None and xh.dtype == torch.bfloat16 else None
    xh32 = xh if xh is not None and xh16 is None else None
    rate, seed, layer_idx, site, L = drop if drop is not None else (0.0, 0, 0, 0, 1)
    thresh, scale = drop_threshold(rate)
    seed_t = seed_tensor(seed, dev)
    ptr = (lambda t: None if t is None else t.contiguous().data_ptr())
    _build.call("vitiq_train_gemm_bf16", dev, a.data_ptr(), b.data_ptr(), ptr(bias), ptr(res),
                ptr(res32), ptr(xh32), ptr(xh16), ptr(rstd), ptr(gamma), ptr(beta), ptr(out),
                ptr(out32), ptr(xh_out), ptr(xh_out16), ptr(rstd_out), ptr(part), M, K, N,
                EPILOGUES.index(epi), splits, L, thresh, scale, seed_t.data_ptr(), layer_idx,
                site)
    stage_launches["train_gemm"] += 1
    if epi == "partial":
        return out32
    if epi == "ln_fwd":
        return out, (xh_out16 if xh_bf16 else xh_out), rstd_out
    sums = None if part is None else part[:, :-(-M // ROW_TILE)].sum(dim=1)
    if epi == "dpre":
        return out, sums[0]
    if epi == "ln_bwd":
        return out, out32, sums
    return out


def stash_shapes(x: torch.Tensor, n_head: int):
    """(shape, dtype) of each stash tensor for activations x [B, L, D]:
    attn, xh1, xh2, r1, r2, pbar (rows of stash_cols(L))."""
    B, L, D = x.shape
    dt = x.dtype
    return [((B, L, D), dt), ((B, L, D), dt), ((B, L, D), dt), ((B, L), torch.float32),
            ((B, L), torch.float32), ((B, n_head, L, stash_cols(L)), dt)]


def _check_pass(qkv: torch.Tensor, n_head: int, *acts: torch.Tensor,
                kernel: str = "K4") -> Tuple[int, int, int]:
    """Validate what K4's (or K3's) attention passes take: contiguous bf16
    qkv [B, L, 3D] on a CUDA device at a shape that kernel takes, and
    activations [B, L, D] like it; returns (B, L, D)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or qkv.dtype != torch.bfloat16:
        raise ValueError(f"qkv must be a bf16 [B, L, 3D] tensor, got {qkv.dtype} "
                         f"{tuple(qkv.shape)}")
    B, L, D3 = qkv.shape
    D = D3 // 3
    if kernel == "K4" and (B == 0 or not fused_train_stash_supported(L, D, FFN_MULTIPLE, n_head)):
        raise ValueError(f"K4's attention takes the shapes of K4 (d_model in {SUPPORTED_D_MODEL}, "
                         f"d_head in {SUPPORTED_D_HEAD}, L inside the stash gate); got B={B}, "
                         f"L={L}, d_model={D}, n_head={n_head}")
    if kernel == "K3" and (B == 0 or not fused_train_supported(L, D, FFN_MULTIPLE, n_head)):
        raise ValueError(f"K3's attention takes the shapes of K3 (d_model in {SUPPORTED_D_MODEL}, "
                         f"d_head in {SUPPORTED_D_HEAD}, L within shared memory); got B={B}, "
                         f"L={L}, d_model={D}, n_head={n_head}")
    for t in (qkv, *acts):
        if not t.is_contiguous() or t.dtype != torch.bfloat16 or t.device != qkv.device:
            raise ValueError(f"{kernel}'s attention takes contiguous bf16 tensors on one device")
    for t in acts:
        if tuple(t.shape) != (B, L, D):
            raise ValueError(f"want [B, L, D] = {(B, L, D)}, got {tuple(t.shape)}")
    return B, L, D


def stash_attention_fwd(qkv: torch.Tensor, n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4-fwd's attention pass alone (C entry `vitiq_train_attention_fwd_stash`):
    qkv [B, L, 3D] bf16 -> (attn [B, L, D], pbar [B, H, L, stash_cols(L)]), as
    `stash_attention_fwd_plain`; the plain version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return stash_attention_fwd_plain(qkv, n_head)
    B, L, D = _check_pass(qkv, n_head)
    attn = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    pbar = torch.empty((B, n_head, L, stash_cols(L)), dtype=qkv.dtype, device=qkv.device)
    _build.call("vitiq_train_attention_fwd_stash", qkv.device, qkv.data_ptr(), attn.data_ptr(),
                pbar.data_ptr(), B, L, D, n_head)
    pass_launches["stash_attention_fwd"] += 1
    return attn, pbar


def stash_attention_bwd(qkv: torch.Tensor, attn: torch.Tensor, dattn: torch.Tensor,
                        pbar: torch.Tensor, n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4-bwd's attention pass alone (C entry `vitiq_train_attention_bwd_stash`):
    (dqkv [B, L, 3D] bf16, each frame's column sums of the f32 dqkv [B, 3D]),
    as `stash_attention_bwd_plain`; the plain version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return stash_attention_bwd_plain(qkv, attn, dattn, pbar, n_head)
    B, L, D = _check_pass(qkv, n_head, attn, dattn)
    if (tuple(pbar.shape) != (B, n_head, L, stash_cols(L)) or pbar.dtype != torch.bfloat16
            or pbar.device != qkv.device or not pbar.is_contiguous()):
        raise ValueError(f"pbar: want contiguous bf16 {(B, n_head, L, stash_cols(L))}, got "
                         f"{pbar.dtype} {tuple(pbar.shape)}")
    dqkv = torch.empty_like(qkv)
    part = torch.empty((B, 3 * D), dtype=torch.float32, device=qkv.device)
    _build.call("vitiq_train_attention_bwd_stash", qkv.device, qkv.data_ptr(), attn.data_ptr(),
                dattn.data_ptr(), pbar.data_ptr(), dqkv.data_ptr(), part.data_ptr(), B, L, D,
                n_head)
    pass_launches["stash_attention_bwd"] += 1
    return dqkv, part


def recompute_attention_fwd(qkv: torch.Tensor, n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's attention forward pass alone (C entry
    `vitiq_train_attention_fwd_recompute`, routed by shape as K3 routes it:
    `recompute_tile_plan`): qkv [B, L, 3D] bf16 -> (attn [B, L, D], stats [B,
    H, L, 2] f32), as `recompute_attention_fwd_plain`; the plain version for a
    CPU tensor."""
    if qkv.device.type == "cpu":
        return recompute_attention_fwd_plain(qkv, n_head)
    B, L, D = _check_pass(qkv, n_head, kernel="K3")
    attn = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, n_head, L, 2), dtype=torch.float32, device=qkv.device)
    _build.call("vitiq_train_attention_fwd_recompute", qkv.device, qkv.data_ptr(),
                attn.data_ptr(), stats.data_ptr(), B, L, D, n_head)
    pass_launches["recompute_attention_fwd"] += 1
    return attn, stats


def recompute_attention_bwd(qkv: torch.Tensor, attn: torch.Tensor, dattn: torch.Tensor,
                            stats: torch.Tensor, n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's attention backward pass alone (C entry
    `vitiq_train_attention_bwd_recompute`, routed as K3 routes it): (dqkv [B,
    L, 3D] bf16, each frame's column sums of the f32 dqkv [B, 3D]), as
    `recompute_attention_bwd_plain`; the plain version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return recompute_attention_bwd_plain(qkv, attn, dattn, stats, n_head)
    B, L, D = _check_pass(qkv, n_head, attn, dattn, kernel="K3")
    if (tuple(stats.shape) != (B, n_head, L, 2) or stats.dtype != torch.float32
            or stats.device != qkv.device or not stats.is_contiguous()):
        raise ValueError(f"stats: want contiguous f32 {(B, n_head, L, 2)}, got {stats.dtype} "
                         f"{tuple(stats.shape)}")
    dqkv = torch.empty_like(qkv)
    part = torch.empty((B, 3 * D), dtype=torch.float32, device=qkv.device)
    _build.call("vitiq_train_attention_bwd_recompute", qkv.device, qkv.data_ptr(),
                attn.data_ptr(), dattn.data_ptr(), stats.data_ptr(), dqkv.data_ptr(),
                part.data_ptr(), B, L, D, n_head)
    pass_launches["recompute_attention_bwd"] += 1
    return dqkv, part


def recompute_blocks_per_sm(L: int, D: int, n_head: int) -> Tuple[int, int]:
    """Blocks an SM of K3's wgmma forward and backward passes at this shape
    (the CUDA occupancy calculator; 0 for a pass the shape routes to
    mma.sync). Needs CUDA."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 2)()
    err = lib.vitiq_train_attention_recompute_blocks(L, D, n_head, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"vitiq_train_attention_recompute_blocks failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
    return out[0], out[1]


def fused_train_layer_fwd_stash(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                                drop: float, seed,
                                layer_idx: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """K4-fwd: (y, stash) for bf16 [B, L, D] activations (see
    `fused_train_layer_stash_reference`); the plain version for a CPU
    tensor."""
    if x.device.type == "cpu":
        return fused_train_layer_stash_reference(x, ops, n_head, drop, seed, layer_idx)
    F = _check_inputs(x, ops, n_head, stash=True)
    y = torch.empty_like(x)
    stash = tuple(torch.empty(shape, dtype=dt, device=x.device)
                  for shape, dt in stash_shapes(x, n_head))
    _launch("vitiq_train_layer_fwd_stash", "fused_train_layer_fwd_stash", x,
            (x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in stash)),
            ops, n_head, F, drop, seed, layer_idx)
    return y, stash


def fused_train_layer_bwd_stash(x: torch.Tensor, dy: torch.Tensor, stash: Sequence[torch.Tensor],
                                ops: Sequence[torch.Tensor], n_head: int, drop: float, seed,
                                layer_idx: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K4-bwd: dx and the 12 operand gradients (matrices rounded to bf16,
    vectors f32) from x, dy and K4-fwd's stash; the plain version for a CPU
    tensor."""
    if x.device.type == "cpu":
        return fused_train_layer_stash_backward_reference(x, dy, stash, ops, n_head, drop, seed,
                                                          layer_idx)
    F = _check_inputs(x, ops, n_head, stash=True)
    want = stash_shapes(x, n_head)
    if len(stash) != len(want):
        raise ValueError(f"expected a stash of {len(want)} tensors, got {len(stash)}")
    for i, (t, (shape, dt)) in enumerate(zip(stash, want)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"stash tensor {i}: want contiguous {dt} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    dx = torch.empty_like(x)
    grads = torch.empty(sum(t.numel() for t in ops), dtype=torch.float32, device=x.device)
    _launch("vitiq_train_layer_bwd_stash", "fused_train_layer_bwd_stash", x,
            (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), grads.data_ptr(),
             *(t.data_ptr() for t in stash)),
            ops, n_head, F, drop, seed, layer_idx)
    parts = grads.split([t.numel() for t in ops])
    return dx, [g.view(t.shape).to(t.dtype) for g, t in zip(parts, ops)]


class _FusedTrainLayer(torch.autograd.Function):
    """One training layer: the forward launches K3-fwd and saves only x, the
    seed tensor and the operands; the backward launches K3-bwd, which
    recomputes the layer and reads the same seed from device memory."""

    @staticmethod
    def forward(ctx, x, n_head, drop, seed, layer_idx, *ops):
        ctx.save_for_backward(x, seed, *ops)
        ctx.layer = (n_head, drop, layer_idx)
        return fused_train_layer_fwd(x, ops, n_head, drop, seed, layer_idx)

    @staticmethod
    def backward(ctx, dy):
        x, seed, *ops = ctx.saved_tensors
        n_head, drop, layer_idx = ctx.layer
        dx, grads = fused_train_layer_bwd(x, dy, ops, n_head, drop, seed, layer_idx)
        return (dx, None, None, None, None, *grads)


class _FusedTrainLayerStash(torch.autograd.Function):
    """One training layer in the stash regime: the forward launches K4-fwd
    and saves x, the stash and the operands; the backward launches K4-bwd,
    which reads the stash instead of recomputing the layer."""

    @staticmethod
    def forward(ctx, x, n_head, drop, seed, layer_idx, *ops):
        y, stash = fused_train_layer_fwd_stash(x, ops, n_head, drop, seed, layer_idx)
        ctx.save_for_backward(x, seed, *stash, *ops)
        ctx.layer = (n_head, drop, layer_idx)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, seed, *rest = ctx.saved_tensors
        stash, ops = rest[:6], rest[6:]
        n_head, drop, layer_idx = ctx.layer
        dx, grads = fused_train_layer_bwd_stash(x, dy, stash, ops, n_head, drop, seed, layer_idx)
        return (dx, None, None, None, None, *grads)


def fused_train_layer_stack(x: torch.Tensor, layers, n_head: int, drop_prob: float,
                            seed) -> torch.Tensor:
    """Differentiable fused training stack over `EncoderLayer` modules: x
    [B, L, D] in the compute dtype; `seed` the step's int32 dropout seed, an
    int or an int32 tensor on x's device (`make_train_step` passes the
    tensor that `step_seed_tensor` computes there).
    Each layer runs K4 where `stash_enabled` puts the stash (the rawIQ
    flagship, Lp=80), K3 elsewhere (the ViT flagship, Lp=144); gradients
    reach x and every layer parameter through K4-bwd or K3-bwd."""
    B, L, D = x.shape
    layer_fn = (_FusedTrainLayerStash if stash_enabled(L, n_head, D, B, x.dtype)
                else _FusedTrainLayer)
    seed = seed_tensor(seed, x.device)
    for i, layer in enumerate(layers):
        x = layer_fn.apply(x, n_head, float(drop_prob), seed, i,
                           *flat_weights(layer, x.dtype))
    return x
