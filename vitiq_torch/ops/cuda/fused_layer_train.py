"""Fused post-norm encoder layer for training: the wrappers of the CUDA
kernels in `vitiq_torch/csrc/fused_layer_train.cu` (K3), their plain PyTorch
versions and the differentiable stack (counterpart of
`vitiq/ops/pallas/fused_layer_train.py`, `fused_train_layer_stack`, in its
recompute regime).

* K3-fwd (`fused_train_layer_fwd`): one training layer, [B, L, D] -> [B, L, D],
  dropout at the three sites of the reference layer.
* K3-bwd (`fused_train_layer_bwd`): recompute the layer from x, then dx and
  the gradients of all 12 operands.

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

Each wrapper launches its kernel on a CUDA tensor (raising on any build,
launch or shape error) and runs its plain version on a CPU tensor.
`launches` counts kernel launches, one per call of a C entry point; the
plain versions count nothing.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from vitiq_torch.ops.cuda import _build

LN_EPS = 1e-12
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
SUPPORTED_D_MODEL = 128
SUPPORTED_D_HEAD = (16, 32)
MAX_SHARED_MEMORY = 232448  # bytes a block may use on Hopper
_M32 = 0xFFFFFFFF

launches = {"fused_train_layer_fwd": 0, "fused_train_layer_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def attention_bwd_smem_bytes(L: int, d_head: int) -> int:
    """Shared memory of the attention-backward block at L tokens (the
    formula of `attention_bwd_smem_bytes` in the .cu)."""
    lp = (L + 15) // 16 * 16
    return (4 * lp * (d_head + 8) + 3 * d_head * (lp + 8)) * 2 + (3 * lp + 4 * 3 * d_head) * 4


def fused_train_supported(L: int, D: int, ffn_hidden: int, n_head: int) -> bool:
    """Shapes the K3 kernels take: d_model 128, d_head 16 or 32, an FFN width
    that is a multiple of 128, and an L whose attention-backward block fits
    the card's shared memory. Decided from shapes alone, before any launch."""
    if D != SUPPORTED_D_MODEL or n_head <= 0 or D % n_head or L <= 0:
        return False
    dh = D // n_head
    return (dh in SUPPORTED_D_HEAD and ffn_hidden > 0 and ffn_hidden % 128 == 0
            and attention_bwd_smem_bytes(L, dh) <= MAX_SHARED_MEMORY)


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


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mask_bits(shape: Tuple[int, int, int], seed: int, salt: int,
              device=None) -> torch.Tensor:
    """The 32 hash bits of every position of a [G, L, W] block (int64 in
    [0, 2^32)): murmur3 fmix32 over the mixed (frame, token, lane) index plus
    seed + salt, as `_hash_mask` computes them in int32."""
    G, L, W = shape
    gi = torch.arange(G, dtype=torch.int64, device=device).view(G, 1, 1)
    li = torch.arange(L, dtype=torch.int64, device=device).view(1, L, 1)
    wi = torch.arange(W, dtype=torch.int64, device=device).view(1, 1, W)
    h = _mul32(gi, 0x9E3779B1) ^ _mul32(li, 0x85EBCA77) ^ _mul32(wi, 0xC2B2AE3D)
    h = (h + ((seed + salt) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def drop_threshold(rate: float) -> Tuple[int, float]:
    """(threshold, scale): a position is dropped iff its low 31 hash bits are
    below the threshold; a kept one is multiplied by the f32 scale. (0, 1.0)
    when rate is 0: no dropout."""
    if rate == 0.0:
        return 0, 1.0
    return int(rate * 2147483648.0), float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def dropout_mask(shape: Tuple[int, int, int], rate: float, seed: int, layer_idx: int,
                 site: int, device=None) -> torch.Tensor:
    """f32 keep/(1 - rate) multiplier of a [B, L, W] activation at dropout
    site 0 (attention output), 1 (FFN hidden) or 2 (FFN output)."""
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


def _forward(x, ops, n_head, drop, seed, layer_idx):
    """The layer and every intermediate the backward needs, in x's dtype
    where the kernels round to bf16."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    dt = x.dtype
    B, L, D = x.shape
    dh = D // n_head
    m1, m2, m3 = _masks(x, w1.shape[1], drop, seed, layer_idx)
    qkv = (_mm(x, wqkv) + bqkv).to(dt)

    def heads(t):  # [B, L, D] -> [B, H, L, dh] f32
        return t.float().reshape(B, L, n_head, dh).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    qs = (q * (_LOG2E / math.sqrt(dh))).to(dt).float()
    s = qs @ k.transpose(-1, -2)  # log2 units
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(dt).float()
    den = p.sum(dim=-1, keepdim=True)
    attn = ((p @ v) / den).to(dt)
    attn_flat = attn.transpose(1, 2).reshape(B, L, D)
    x1f, xh1, r1 = _ln((_mm(attn_flat, wo) + bo) * m1 + x.float(), g1, be1)
    x1 = x1f.to(dt)
    h = (torch.relu(_mm(x1, w1) + b1) * m2).to(dt)
    y, xh2, r2 = _ln((_mm(h, w2) + b2) * m3 + x1.float(), g2, be2)
    return y.to(dt), dict(qs=qs, k=k, v=v, p=p, den=den, attn=attn, attn_flat=attn_flat,
                          x1=x1, xh1=xh1, r1=r1, h=h, xh2=xh2, r2=r2, masks=(m1, m2, m3))


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
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
    dt = x.dtype
    B, L, D = x.shape
    dh = D // n_head
    scale2 = _LOG2E / math.sqrt(dh)
    with torch.no_grad():
        _, r = _forward(x, ops, n_head, drop, seed, layer_idx)
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

        # attention, per head: the flash identity gives the row term
        do = dattn.float().reshape(B, L, n_head, dh).transpose(1, 2)
        pbar = (r["p"] / r["den"]).to(dt).float()
        row = (do * r["attn"].float()).sum(dim=-1, keepdim=True)
        ds = (pbar * (do @ r["v"].transpose(-1, -2) - row)).to(dt).float()
        dq = (ds @ r["k"]) * (_LN2 * scale2)
        dk = (ds.transpose(-1, -2) @ r["qs"]) * _LN2
        dv = pbar.transpose(-1, -2) @ do
        dqkv = torch.cat([t.transpose(1, 2).reshape(B, L, D) for t in (dq, dk, dv)], dim=-1)
        dqkvb = dqkv.to(dt)
        dbqkv, dwqkv = colsum(dqkv), wgrad(x, dqkvb)
        dx = (dz1 + _mm(dqkvb, wqkv.t())).to(dt)
    grads = [dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2]
    return dx, [g.to(w.dtype) for g, w in zip(grads, ops)]


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
    if len(ops) != 12:
        raise ValueError(f"expected 12 layer operands, got {len(ops)}")
    F = ops[6].shape[-1]
    if B == 0 or not fused_train_supported(L, D, F, n_head):
        raise ValueError(f"K3 takes d_model={SUPPORTED_D_MODEL}, d_head in {SUPPORTED_D_HEAD}, "
                         f"an FFN width that is a multiple of 128 and L up to the shared-memory "
                         f"bound; got B={B}, L={L}, d_model={D}, n_head={n_head}, ffn={F}")
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
            drop: float, seed: int, layer_idx: int) -> None:
    """Allocate the workspace, launch one C entry point, raise on its error,
    count the launch."""
    B, L, D = x.shape
    lib = _build.library()
    size = getattr(lib, entry + "_workspace")(B, L, D, n_head, F)
    workspace = torch.empty(size, dtype=torch.uint8, device=x.device)
    thresh, scale = drop_threshold(drop)
    seed32 = (int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31  # as an int32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(*pointers, *(t.data_ptr() for t in ops),
                                  workspace.data_ptr(), B, L, D, n_head, F, thresh, scale,
                                  seed32, layer_idx, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
    launches[counter] += 1


def fused_train_layer_fwd(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                          drop: float, seed: int, layer_idx: int) -> torch.Tensor:
    """K3-fwd: one training layer, bf16 [B, L, D] -> bf16 [B, L, D]; the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_train_layer_reference(x, ops, n_head, drop, seed, layer_idx)
    F = _check_inputs(x, ops, n_head)
    y = torch.empty_like(x)
    _launch("vitiq_train_layer_fwd", "fused_train_layer_fwd", x, (x.data_ptr(), y.data_ptr()),
            ops, n_head, F, drop, seed, layer_idx)
    return y


def fused_train_layer_bwd(x: torch.Tensor, dy: torch.Tensor, ops: Sequence[torch.Tensor],
                          n_head: int, drop: float, seed: int,
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


class _FusedTrainLayer(torch.autograd.Function):
    """One training layer: the forward launches K3-fwd and saves only x and
    the operands (the seed rides along as a constant); the backward launches
    K3-bwd, which recomputes the layer."""

    @staticmethod
    def forward(ctx, x, n_head, drop, seed, layer_idx, *ops):
        ctx.save_for_backward(x, *ops)
        ctx.layer = (n_head, drop, seed, layer_idx)
        return fused_train_layer_fwd(x, ops, n_head, drop, seed, layer_idx)

    @staticmethod
    def backward(ctx, dy):
        x, *ops = ctx.saved_tensors
        dx, grads = fused_train_layer_bwd(x, dy, ops, *ctx.layer)
        return (dx, None, None, None, None, *grads)


def fused_train_layer_stack(x: torch.Tensor, layers, n_head: int, drop_prob: float,
                            seed: int) -> torch.Tensor:
    """Differentiable fused training stack over `EncoderLayer` modules: x
    [B, L, D] in the compute dtype; `seed` the step's int32 dropout seed.
    Gradients reach x and every layer parameter through K3-bwd."""
    for i, layer in enumerate(layers):
        x = _FusedTrainLayer.apply(x, n_head, float(drop_prob), int(seed), i,
                                   *flat_weights(layer, x.dtype))
    return x
