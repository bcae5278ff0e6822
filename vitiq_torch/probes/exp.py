"""P3, K1 without its softmax exp: the counterpart of scripts/tpu_probe_exp.py.

A timing probe, not a layer of the model. The TPU probe timed the fused
serving layer with the exp of its softmax removed -- mathematically wrong,
structurally identical -- to split the layer's cost between the exp and the
matmul and memory structure. Here the ablation is K1 itself with its
attention stage's exp removed (the NOEXP instance of K1's one-pass core,
`attention_core_kernel<DH, true>` in `csrc/fused_encoder_layer.cu`,
C entry `vitiq_encoder_layer_full_noexp`),
timed back to back with K1 in one process.

Function (the TPU probe's `kernel_noexp`), per frame and head: the scores s
(q carries log2(e)/sqrt(dh) where the TPU probe scales by 0.25: the factor
cancels in the ratio), p = (s - max s) + max s in f32 (the max pass kept,
so only the exp is gone), out = (bf16(p) @ v) / sum(p), the sum of the
unrounded f32 p (the kernel's one-pass core takes each p at the running
max of the keys so far; (s - m) + m is s up to rounding at either); then
K1's out-projection + LN1, FFN and LN2. The TPU probe
adds -1e30 to padded keys' probabilities, so its padded rows' v dominate its
output; the port has no padded rows (keys past L add nothing), and the two
are the same function only where L is a multiple of 16. The output divides
by the sum of the scores, which can sit near zero for a row, so no
element-wise gate holds it: `check_layer` and `check_core` hold the rows
whose sum is not small beside the sum of its magnitudes (see COND_FLOOR).

`fused_encoder_layer_noexp` launches the kernel on a CUDA tensor and runs the
plain version, `fused_layer_noexp_reference`, on a CPU tensor;
`attention_noexp` does the same for its attention core alone (the kernel's
`vitiq_attention_noexp`). `launches` counts the launches of each.

Usage: python -m vitiq_torch.probes.exp [B=8192] [L=129] [D=128] [F=512] [H=8]
(the TPU probe's stack: 6 layers of the ViT flagship's widths; prints the
no-exp stack's and K1's time per batch and the exp's share of K1's).
"""

from __future__ import annotations

import sys
from typing import Sequence

import torch

from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.probes._timing import require_cuda, time_amortized

N_LAYERS = 6
STACK_CALLS, STACK_REPS = 5, 5  # time_amortized's inner and reps for a stack
DEFAULT_SHAPE = (8192, 129, 128, 512, 8)  # B, L, D, F, H

# P3 against its plain version. Each (frame, head, query) row of the core is
# divided by l = sum_j p_j, a sum of scores of either sign. Where |l| is a
# small part of sum_j |p_j| a bf16 flip of qkv (the kernel's QKV GEMM beside
# the plain one) or another order of the f32 sums moves the row far, and
# where l's sign lies within that noise the row is not determined at all
# (at seeded random weights a batch of 256 frames holds rows with
# |l| / sum |p| near 1e-6). So the gates hold the rows whose conditioning
# c = |l| / sum_j |p_j| (`conditioning`) is at least COND_FLOOR: at seeded
# random weights 93-96% of (frame, head) rows at the ViT, conv1d and
# rawiq_best shapes, and 60-70% of frame rows in every head.
COND_FLOOR = 1e-2
# the layer (`check_layer`): relative L2 over the frame rows held in every
# head (and over all rows where the caller asks for it)
LAYER_REL = 1e-2
# the core alone on the same qkv (`check_core`, no GEMM between the two):
# each held row's relative L2 error. The two versions round the same
# quotient and the same p to bf16 and differ in the order of their f32 sums:
# |delta l| / |l| <= L 2^-24 / c, 6.1e-3 at L = 1025 and c = 1e-2 in the
# worst case, plus one bf16 ulp (up to 2^-7 relative) of each element where
# a quotient or a p sits at a rounding tie. On the H100 the worst held row
# reads 3.5e-3 to 4.5e-3 at the ViT, conv1d and rawiq_best shapes.
CORE_ROW_REL = 1e-2

launches = {"fused_encoder_layer_noexp": 0, "attention_noexp": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _probs(qkv: torch.Tensor, n_head: int, n_q: int):
    """The no-exp core's p [B, H, n_q, L] and v [B, H, L, dh], f32, from qkv
    [B, L, 3D] (q pre-scaled by log2(e)/sqrt(dh))."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    dh = D // n_head

    def heads(t, rows):  # [B, rows, D] -> [B, H, rows, dh] f32
        return t.float().reshape(B, rows, n_head, dh).transpose(1, 2)

    q = heads(qkv[:, :n_q, :D], n_q)
    k = heads(qkv[:, :, D:2 * D], L)
    s = q @ k.transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True)
    # the exp removed; the max kept in the arithmetic, as the kernel keeps it
    return (s - m) + m, heads(qkv[:, :, 2 * D:], L)


def attention_noexp_reference(qkv: torch.Tensor, n_head: int, n_q: int) -> torch.Tensor:
    """The no-exp attention core on qkv [B, L, 3D] (q pre-scaled by
    log2(e)/sqrt(dh)) for query rows [0, n_q): [B, n_q, D] in qkv's dtype."""
    B, _, D3 = qkv.shape
    p, v = _probs(qkv, n_head, n_q)
    attn = ((p.to(qkv.dtype).float() @ v) / p.sum(dim=-1, keepdim=True)).to(qkv.dtype)
    return attn.transpose(1, 2).reshape(B, n_q, D3 // 3)


def conditioning(qkv: torch.Tensor, n_head: int) -> torch.Tensor:
    """|sum_j p_j| / sum_j |p_j| of each row of the plain core on qkv
    [B, L, 3D]: f32 [B, H, L]."""
    p, _ = _probs(qkv, n_head, qkv.shape[1])
    return p.sum(dim=-1).abs() / p.abs().sum(dim=-1)


def fused_layer_noexp_reference(x: torch.Tensor, ops: Sequence[torch.Tensor],
                                n_head: int) -> torch.Tensor:
    """Plain version of P3: K1's layer (`fel.fused_layer_reference`) with
    the no-exp core, x [B, L, D] -> [B, L, D]."""
    return fel.fused_layer_reference(x, ops, n_head, x.shape[1],
                                      attention=attention_noexp_reference)


def fused_encoder_layer_noexp(x: torch.Tensor, ops: Sequence[torch.Tensor],
                              n_head: int) -> torch.Tensor:
    """P3: K1 with its exp removed, bf16 [B, L, D] -> bf16 [B, L, D] on K1's
    shapes (`fel.fused_infer_supported`); the plain version for a CPU
    tensor."""
    if x.device.type == "cpu":
        return fused_layer_noexp_reference(x, ops, n_head)
    F = fel._check_inputs(x, ops, n_head)
    out = torch.empty_like(x)
    fel._launch("vitiq_encoder_layer_full_noexp", x, out, ops, n_head, F, x.shape[1])
    launches["fused_encoder_layer_noexp"] += 1
    return out


def attention_noexp(qkv: torch.Tensor, n_head: int) -> torch.Tensor:
    """P3's attention core alone, bf16 qkv [B, L, 3D] (q pre-scaled) -> bf16
    [B, L, D]: `attention_core_kernel<DH, true>` on a CUDA tensor, the plain
    version on a CPU tensor. Not on the probe's path: it holds the core to
    its plain version on the same qkv."""
    if qkv.device.type == "cpu":
        return attention_noexp_reference(qkv, n_head, qkv.shape[1])
    if qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous bf16 [B, L, 3D] tensor, got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    B, L, D3 = qkv.shape
    fel.check_shape(B, L, D3 // 3, 128, n_head)
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    _build.call("vitiq_attention_noexp", qkv.device, qkv.data_ptr(), out.data_ptr(), B, L,
                D3 // 3, n_head)
    launches["attention_noexp"] += 1
    return out


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| over the last dimension."""
    got, want = got.float(), want.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def layer_readings(got: torch.Tensor, want: torch.Tensor, cond: torch.Tensor) -> dict:
    """The layer [B, L, D] against its plain version, with the plain core's
    `conditioning` [B, H, L]: relative L2 over all rows ("rel") and over the
    frame rows held in every head ("rel_held"), the share held, the largest
    |difference|, and the worst row's relative error with its least
    conditioning over the heads."""
    held = cond.amin(dim=1) >= COND_FLOOR  # [B, L]
    diff = got.float() - want.float()
    row = _row_rel(got, want)
    worst = int(row.argmax())
    return {"rel": float(diff.norm() / want.float().norm()),
            "rel_held": float(diff[held].norm() / want.float()[held].norm()),
            "held": float(held.float().mean()), "max_abs": float(diff.abs().max()),
            "worst_row_rel": float(row.flatten()[worst]),
            "worst_row_cond": float(cond.amin(dim=1).flatten()[worst])}


def core_readings(got: torch.Tensor, want: torch.Tensor, cond: torch.Tensor) -> dict:
    """The core [B, L, D] against its plain version on the same qkv, with
    their `conditioning` [B, H, L]: relative L2 over all rows ("rel"), the
    largest relative error of a held (frame, head, query) row
    ("row_rel_held"), the share held, and whether every output is finite."""
    B, H, L = cond.shape
    heads = (got.reshape(B, L, H, -1).transpose(1, 2), want.reshape(B, L, H, -1).transpose(1, 2))
    held = cond >= COND_FLOOR
    diff = got.float() - want.float()
    return {"rel": float(diff.norm() / want.float().norm()),
            "row_rel_held": float(_row_rel(*heads)[held].max()),
            "held": float(held.float().mean()), "finite": bool(torch.isfinite(got).all())}


def check_layer(x: torch.Tensor, ops: Sequence[torch.Tensor], n_head: int,
                all_rows: bool) -> dict:
    """P3's layer on the card against its plain version on x [B, L, D]:
    raises unless its output is finite and its relative L2 over the held
    rows (and, with `all_rows`, over all rows) is within LAYER_REL; returns
    `layer_readings`."""
    require_cuda(x.device)
    with torch.no_grad():
        got = fused_encoder_layer_noexp(x, ops, n_head)
        want = fused_layer_noexp_reference(x, ops, n_head)
        qkv = (fel._mm(x, ops[0]) + ops[1]).to(x.dtype)
        r = layer_readings(got, want, conditioning(qkv, n_head))
    if not torch.isfinite(got).all():
        raise AssertionError("P3's layer: non-finite output")
    if not r["rel_held"] <= LAYER_REL or (all_rows and not r["rel"] <= LAYER_REL):
        raise AssertionError(f"P3's layer disagrees with its plain version: {r}")
    return r


def check_core(qkv: torch.Tensor, n_head: int) -> dict:
    """P3's attention core on the card against its plain version on the same
    qkv [B, L, 3D]: raises unless every output is finite and every held row
    is within CORE_ROW_REL; returns `core_readings`."""
    require_cuda(qkv.device)
    got = attention_noexp(qkv, n_head)
    want = attention_noexp_reference(qkv, n_head, qkv.shape[1])
    r = core_readings(got, want, conditioning(qkv, n_head))
    if not r["finite"] or not r["row_rel_held"] <= CORE_ROW_REL:
        raise AssertionError(f"P3's core disagrees with its plain version: {r}")
    return r


def stack_operands(n_layers: int, D: int, F: int, H: int, device="cuda", seed: int = 0,
                   dtype=torch.bfloat16):
    """The operands (`fel.layer_operands`) of `n_layers` encoder layers with
    random weights from `seed`, on `device`."""
    gen = torch.Generator().manual_seed(seed)
    return [fel.layer_operands(EncoderLayer(D, F, H, device=device, generator=gen).eval(), H,
                               dtype) for _ in range(n_layers)]


def run_stack(layer, x: torch.Tensor, ops_list, n_head: int) -> torch.Tensor:
    """x through `layer(x, ops, n_head)` for each layer's operands."""
    for ops in ops_list:
        x = layer(x, ops, n_head)
    return x


def time_stacks(B: int, L: int, D: int, F: int, H: int, device="cuda") -> dict:
    """The no-exp stack and K1's stack (N_LAYERS layers, the same random
    weights and bf16 input) timed in turns on the card (no-exp, K1, K1,
    no-exp, so that a drift of the card's clock over the run falls on both);
    ms per batch of each (the mean of its two turns) and the exp's share of
    K1's time. Both stacks read x as it is: at the probe's shapes the
    activations are several times the card's L2."""
    device = require_cuda(device)
    ops_list = stack_operands(N_LAYERS, D, F, H, device)
    x = torch.randn((B, L, D), device=device,
                    generator=torch.Generator(device).manual_seed(0)).to(torch.bfloat16)
    layers = {"noexp": fused_encoder_layer_noexp, "k1": fel.fused_encoder_layer}
    times = {"noexp": [], "k1": []}
    with torch.no_grad():
        for arm in ("noexp", "k1", "k1", "noexp"):
            times[arm].append(time_amortized(
                lambda seed, x: run_stack(layers[arm], x, ops_list, H), (x,), STACK_CALLS,
                STACK_REPS))
    noexp, k1 = (sum(times[arm]) / 2 for arm in ("noexp", "k1"))
    return {"noexp_ms": noexp * 1e3, "k1_ms": k1 * 1e3, "exp_share": (k1 - noexp) / k1}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    B, L, D, F, H = [int(a) for a in argv] + list(DEFAULT_SHAPE[len(argv):])
    t = time_stacks(B, L, D, F, H)
    print(f"B={B} L={L} D={D} F={F} H={H}", flush=True)
    print(f"noexp {N_LAYERS}-layer stack: {t['noexp_ms']:.4f} ms/batch", flush=True)
    print(f"K1 {N_LAYERS}-layer stack: {t['k1_ms']:.4f} ms/batch", flush=True)
    print(f"exp share of K1: {t['exp_share']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
