"""Standalone packed multi-head attention: the wrappers of the CUDA kernels in
`vitiq_torch/csrc/flash_attention.cu` (K5), their plain PyTorch versions and
the differentiable call (counterpart of `vitiq/ops/pallas/flash_attention.py`).

* K5-fwd (`fused_attention_fwd`): packed [B, L, D] q, k, v (heads are
  D/H-wide column slices) -> out [B, L, D] and the f32 log-sum-exp of every
  score row, [B, H, L] in log2 units, for the backward.
* K5-bwd (`fused_attention_bwd`): dq, dk, dv from q, k, v, out, the lse and
  dout; P is recomputed tile by tile, never stored.
`FusedAttention` is the autograd function over the two, and `fused_attention`
the `attention_fn` the model takes under the bf16 `tpu` numerics
(``packed_layout``: the encoder hands it [B, L, D] q, k, v and `n_head`).

Numerics, as the TPU kernel computes them: scores q.k / sqrt(dh) in f32 (in
log2 units, times log2(e)), p = exp2(s - max), the f32 denominator summed
from the unrounded p, bf16(p) into the P V product, one divide per output,
rounded to q's dtype. The TPU kernel subtracts no max; the plain version
subtracts each row's max and the kernel a running max (see the .cu header),
which moves only where bf16(p) rounds. The backward is the softmax gradient
at the kernel's rounding points: P = exp2(s - lse) in f32, bf16(P) into
dV = P^T dO, dS = P (dO V^T - rowsum(dO * O)) rounded to bf16 into dQ = dS K
and dK = dS^T Q (both / sqrt(dh)). In f32 every rounding is the identity, and
the plain backward is autograd of the plain forward.

`attention_onepass_plain` is K5-fwd's kernel function exactly: one pass over
64-key tiles with a running max, each p rounded to bf16 at the running max
for the P V product and the f32 denominator summed from the unrounded p; in
f32 it is `attention_plain`. `chip_smoke.py` holds the kernel to both.

The plain versions run per batch chunk of `attention_chunk` frames, under
the JAX backward's budget ``VITIQ_ATTN_BWD_BUDGET`` (bytes, default 2 GiB at
~7 bytes per score element), so that no [B, H, L, L] tensor is held whole.

Each wrapper launches its kernel on a CUDA tensor (raising on any build,
launch or shape error: d_head 16, 32 or 64, bf16 only, as the JAX kernel
serves the bf16 preset only) and runs its plain version on a CPU tensor.
`launches` counts kernel launches, one per call of a C entry point; the
plain versions count nothing.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from vitiq_torch.ops.attention import scaled_dot_product_attention
from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.numerics import REFERENCE, Policy

_LOG2E = 1.4426950408889634
SUPPORTED_D_HEAD = (16, 32, 64)
# the kernels' tiles (query rows, keys) and ring depth, as in the .cu
TILE = 64
RING_STAGES = 4
# K5's three kernels, in the order `ring_info` numbers them
KERNELS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv")

launches = {"fused_attention_fwd": 0, "fused_attention_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def attention_chunk(B: int, n_head: int, L: int) -> int:
    """Frames per chunk of the plain versions: `_bwd`'s
    ``budget // (H * L^2 * 7)``, at least 1, at most B."""
    budget = int(os.environ.get("VITIQ_ATTN_BWD_BUDGET", str(2 * 1024 ** 3)))
    return max(1, min(B, budget // max(n_head * L * L * 7, 1)))


def _heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, dh] f32."""
    B, L, D = t.shape
    return t.float().reshape(B, L, n_head, D // n_head).transpose(1, 2)


def _merge(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, L, dh] -> [B, L, D] in `dtype`."""
    B, H, L, dh = t.shape
    return t.transpose(1, 2).reshape(B, L, H * dh).to(dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, H, L, L] f32 scores in log2 units."""
    scale2 = _LOG2E / math.sqrt(q.shape[-1] // n_head)
    return (_heads(q, n_head) @ _heads(k, n_head).transpose(-1, -2)) * scale2


def _forward_chunk(q, k, v, n_head):
    dt = q.dtype
    s = _scores(q, k, n_head)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    den = p.sum(dim=-1, keepdim=True)
    out = (p.to(dt).float() @ _heads(v, n_head)) / den
    return _merge(out, dt), (m + torch.log2(den))[..., 0]


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5-fwd: (out [B, L, D] in q's dtype, lse [B, H, L]
    f32, log2 units). Differentiable: in f32, autograd of it is what the
    plain backward computes."""
    c = attention_chunk(q.shape[0], n_head, q.shape[1])
    parts = [_forward_chunk(q[i:i + c], k[i:i + c], v[i:i + c], n_head)
             for i in range(0, q.shape[0], c)]
    return torch.cat([o for o, _ in parts]), torch.cat([e for _, e in parts])


def attention_onepass_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K5-fwd's kernel (`attention_fwd` in the .cu):
    (out [B, L, D] in q's dtype, lse [B, H, L] f32, log2 units) by one pass
    over `TILE`-key tiles with a running max m of the log2-unit scores, each
    p = exp2(s - m) rounded to q's dtype at the running max for the P V
    product, the f32 denominator l summed from the unrounded p, l and the f32
    output rescaled by exp2(m_old - m_new) when a tile raises the max; out =
    o / l, lse = m + log2(l). In f32 it is `attention_plain`."""
    dt = q.dtype
    B, L, D = q.shape
    qh, kh, vh = _heads(q, n_head), _heads(k, n_head), _heads(v, n_head)
    scale2 = _LOG2E / math.sqrt(D // n_head)
    m = torch.full((B, n_head, L, 1), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for j0 in range(0, L, TILE):
        s = (qh @ kh[:, :, j0:j0 + TILE].transpose(-1, -2)) * scale2
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        a = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * a + p.sum(dim=-1, keepdim=True)
        o = o * a + p.to(dt).float() @ vh[:, :, j0:j0 + TILE]
        m = m_new
    return _merge(o / l, dt), (m + torch.log2(l))[..., 0]


def ring_smem_bytes(d_head: int) -> int:
    """Shared memory of the kernels' rings (`ring_smem_bytes` in the .cu,
    repeated for the host-side tests): 1 KB of alignment, then per stage two
    bf16 tiles [TILE, d_head] (k and v, or q and dout) and two mbarriers. It
    does not depend on L."""
    return 1024 + RING_STAGES * (2 * TILE * d_head * 2 + 2 * 8)


def kernel_tag(name: str, d_head: int) -> str:
    """The part of the mangled name of K5's kernel `name` (one of KERNELS)
    at `d_head` that tells it from every other kernel (in a `ptxas -v`
    report or SASS)."""
    return f"{len(name)}{name}ILi{d_head}E"


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_head: int) -> torch.Tensor:
    """The TPU kernel's function in plain PyTorch: packed [B, L, D] -> [B, L,
    D] in q's dtype (see the module docstring for its rounding points)."""
    return attention_plain(q, k, v, n_head)[0]


def _backward_chunk(q, k, v, out, dout, n_head):
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1] // n_head)
    s = _scores(q, k, n_head)
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(s - m).sum(dim=-1, keepdim=True))
    p = torch.exp2(s - lse)
    do = _heads(dout.to(dt), n_head)
    delta = (do * _heads(out, n_head)).sum(dim=-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ do
    ds = (p * (do @ _heads(v, n_head).transpose(-1, -2) - delta)).to(dt).float()
    dq = (ds @ _heads(k, n_head)) * scale
    dk = (ds.transpose(-1, -2) @ _heads(q, n_head)) * scale
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            n_head: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5-bwd: (dq, dk, dv) [B, L, D] in q's dtype, from the
    forward's inputs, its output `out` and the output gradient `dout`,
    attention recomputed per chunk of `attention_chunk` frames."""
    c = attention_chunk(q.shape[0], n_head, q.shape[1])
    with torch.no_grad():
        parts = [_backward_chunk(*(t[i:i + c] for t in (q, k, v, out, dout)), n_head)
                 for i in range(0, q.shape[0], c)]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, ld) with frame b's row i of t [B, L, D] at b*L*ld + i*ld, 16-byte
    aligned; t is copied contiguous where its layout is not so (a column
    slice of a [B, L, 3D] qkv is taken as it is)."""
    B, L, D = t.shape
    ld = t.stride(1) if L > 1 else (t.stride(0) if B > 1 else D)
    if (t.stride(2) != 1 or (B > 1 and t.stride(0) != L * ld) or ld < D or ld % 8
            or t.data_ptr() % 16):
        t = t.contiguous()
        ld = D
    return t, ld


def ring_info(kernel: str, d_head: int) -> dict:
    """The launch shape of K5's `kernel` (one of KERNELS) at `d_head` on the
    current CUDA device: its ring's shared memory (bytes), the blocks an SM
    holds at one and at two warpgroups a block
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the warpgroups a
    block takes. Needs CUDA."""
    lib = _build.library()
    info = (ctypes.c_int * 4)()
    _raise_on(lib.vitiq_attention_ring(KERNELS.index(kernel), d_head, ctypes.addressof(info)),
              "vitiq_attention_ring", lib)
    return dict(zip(("smem", "blocks_one", "blocks_two", "warpgroups"), info))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or t.dtype != torch.bfloat16 or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be a bf16 [B, L, D] tensor like q {tuple(q.shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    B, L, D = q.shape
    if B == 0 or L == 0 or n_head <= 0 or D % n_head or D // n_head not in SUPPORTED_D_HEAD:
        raise ValueError(f"K5 takes d_head in {SUPPORTED_D_HEAD} and B, L >= 1; got "
                         f"{tuple(q.shape)} with n_head={n_head}")


def _raise_on(err: int, entry: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5-fwd: (out [B, L, D] bf16, lse [B, H, L] f32); the plain version
    for a CPU tensor."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, n_head)
    _check(q, k, v, n_head)
    B, L, D = q.shape
    (q, ldq), (k, ldk), (v, ldv) = _rows(q), _rows(k), _rows(v)
    out = torch.empty((B, L, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, n_head, L), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vitiq_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      lse.data_ptr(), ldq, ldk, ldv, B, L, n_head, D, stream)
    _raise_on(err, "vitiq_attention_fwd", lib)
    launches["fused_attention_fwd"] += 1
    return out, lse


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor,
                        n_head: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5-bwd: (dq, dk, dv) [B, L, D] bf16; the plain version (which
    recomputes the lse) for a CPU tensor."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, out, dout, n_head)
    _check(q, k, v, n_head)
    B, L, D = q.shape
    dout = dout.to(q.dtype).contiguous()
    out = out.contiguous()
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype), ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (B, n_head, L), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lse = lse.contiguous()
    (q, ldq), (k, ldk), (v, ldv) = _rows(q), _rows(k), _rows(v)
    dq, dk, dv = (torch.empty((B, L, D), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((B, n_head, L), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vitiq_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ldq, ldk, ldv,
                                      B, L, n_head, D, stream)
    _raise_on(err, "vitiq_attention_bwd", lib)
    launches["fused_attention_bwd"] += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Packed attention: the forward launches K5-fwd and saves q, k, v, out
    and the lse; the backward launches K5-bwd, which recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v, n_head):
        out, lse = fused_attention_fwd(q, k, v, n_head)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_head = n_head
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, out, lse, dout, ctx.n_head), None)


def _split_head_attention(q, k, v, n_head, mask, policy):
    B, L, D = q.shape

    def split(t):  # [B, L, D] -> [B, H, L, dh]
        return t.reshape(B, L, n_head, D // n_head).transpose(1, 2)

    out = scaled_dot_product_attention(split(q), split(k), split(v), mask=mask, policy=policy)
    return out.transpose(1, 2).reshape(B, L, D)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                    mask: Optional[torch.Tensor] = None, policy: Policy = REFERENCE) -> torch.Tensor:
    """Packed-layout attention: [B, L, D] in and out. With a mask, the
    split-head `scaled_dot_product_attention` (the kernel takes none); else
    q, k, v in the policy's compute dtype through `FusedAttention`. An f32
    tensor on the card also takes the split-head path: the JAX kernel never
    sees f32 (the f32 `reference` preset does not route through it), and K5
    is bf16 only."""
    compute = policy.cast_compute
    q, k, v = compute(q), compute(k), compute(v)
    if mask is not None or (q.dtype != torch.bfloat16 and q.device.type != "cpu"):
        return _split_head_attention(q, k, v, n_head, mask, policy)
    return FusedAttention.apply(q, k, v, n_head)


fused_attention.packed_layout = True
