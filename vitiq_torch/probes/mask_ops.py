"""P1, the mask-op probe on Hopper: the counterpart of
scripts/tpu_probe_mask_ops.py.

The TPU probe asked which elementwise op Mosaic could lower on a narrow
(16-lane) tile of 144 sublanes, K1's attention tile at the ViT flagship
(Lp 144, d_head 16): one tiny kernel per variant, f32 [G, LP, T] = [8, 144,
16], with SEQ 129 valid keys and the tile's first key at C0 128. Its `main`
ran seven elementwise variants (`VARIANTS`), its `main2` four that add the
mask to a bf16 product accumulated in f32 (`MM_VARIANTS`: [8, 144, 32] x
[8, 16, 32] contracted over the last dimension).

On Hopper each variant is one instance of a templated kernel in
`csrc/probes.cu` (`mask_op_kernel<OP>`, `mm_mask_kernel<OP>`, the mm_*
products on the tensor cores through mma.sync), and "does Mosaic lower it"
becomes three checks: it builds for sm_90a (its `ptxas -v` registers and
spills are printed), it launches, and it matches its plain PyTorch version
(`mask_op_reference`, `mm_mask_reference`) on the same inputs: the
elementwise variants bit for bit, exp2 within EXP2_ULPS, the mm_* variants
within MM_RTOL of the sum of the absolute products.

The wrappers (`mask_op`, `mm_mask`) launch the kernel on a CUDA tensor and
run the plain version on a CPU tensor; `launches` counts each variant's
launches. `check` runs a variant on the card and raises unless it agrees.

Usage: python -m vitiq_torch.probes.mask_ops v1 v2 ...  (default: the seven
elementwise variants; names starting with mm_ run the matmul-plus-mask
variants). Prints ``name: OK`` or ``name: FAIL <error>`` per variant and
exits 1 if any failed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vitiq_torch.ops.cuda import _build
from vitiq_torch.probes._timing import require_cuda

G, LP, T = 8, 144, 16
SEQ = 129
C0 = 128
K = 32  # the mm_* variants' contraction depth
NEG = -1e30

VARIANTS = ("splat", "iota_narrow", "iota_full_slice", "clip_chain", "select_narrow",
            "bcast_add", "exp2")
MM_VARIANTS = ("mm_plain", "mm_add_splat", "mm_add_select", "mm_add_clip")
# exp2f's documented error on the card; the host's libm differs by as much.
EXP2_ULPS = 2
# An f32 sum of K = 32 exact bf16 products, taken in another order: each
# partial sum rounds by at most 2^-24 of its magnitude, so the two orders
# differ by at most ~K * 2^-24 (2e-6) of the sum of |products|.
MM_RTOL = 1e-5

launches = {name: 0 for name in VARIANTS + MM_VARIANTS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _cols(device) -> torch.Tensor:
    return torch.arange(T, device=device)


def _select_mask(device) -> torch.Tensor:
    """0 where the key (column + C0) is valid, -1e30 past SEQ."""
    cols = _cols(device)
    return torch.where(cols + C0 < SEQ, 0.0, NEG).to(torch.float32)


def _clip_mask(device) -> torch.Tensor:
    """(clip(SEQ - (column + C0), 0, 1) - 1) * 1e30 in f32."""
    valid = torch.clamp((SEQ - (_cols(device) + C0)).to(torch.float32), 0.0, 1.0)
    return (valid - 1.0) * 1e30


def mask_row(name: str, device) -> torch.Tensor:
    """The f32 [T] row that variant `name` adds along the last dimension (not
    defined for exp2 and mm_plain, which add nothing)."""
    if name in ("splat", "mm_add_splat"):
        return torch.ones(T, dtype=torch.float32, device=device)
    if name in ("iota_narrow", "iota_full_slice"):
        return _cols(device).to(torch.float32)
    if name in ("clip_chain", "mm_add_clip"):
        return _clip_mask(device)
    if name in ("select_narrow", "mm_add_select"):
        return _select_mask(device)
    if name == "bcast_add":
        return torch.zeros(T, dtype=torch.float32, device=device) - 1.0
    raise ValueError(f"variant {name!r} adds no row")


def mask_op_reference(name: str, x: torch.Tensor) -> torch.Tensor:
    """Plain version of an elementwise variant on f32 x [G, LP, T]."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; the variants are {VARIANTS}")
    if name == "exp2":
        return torch.exp2(x)
    return x + mask_row(name, x.device)


def mm_mask_reference(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of an mm_* variant: bf16 x [G, LP, K] and w [G, T, K]
    contracted over K in f32 (the products of bf16 values are exact), plus
    the variant's mask row: f32 [G, LP, T]."""
    if name not in MM_VARIANTS:
        raise ValueError(f"unknown variant {name!r}; the mm variants are {MM_VARIANTS}")
    acc = torch.matmul(x.float(), w.float().transpose(-1, -2))
    return acc if name == "mm_plain" else acc + mask_row(name, x.device)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _check(t: torch.Tensor, shape, dtype) -> None:
    if (t.device.type != "cuda" or tuple(t.shape) != shape or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError(f"want a contiguous {dtype} {shape} CUDA tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def mask_op(name: str, x: torch.Tensor) -> torch.Tensor:
    """An elementwise variant on f32 x [G, LP, T]: `mask_op_kernel` on a
    CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return mask_op_reference(name, x)
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; the variants are {VARIANTS}")
    _check(x, (G, LP, T), torch.float32)
    out = torch.empty_like(x)
    _build.call("vitiq_probe_mask_op", x.device, VARIANTS.index(name), x.data_ptr(),
                out.data_ptr(), x.numel())
    launches[name] += 1
    return out


def mm_mask(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """An mm_* variant on bf16 x [G, LP, K] and w [G, T, K]: `mm_mask_kernel`
    on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return mm_mask_reference(name, x, w)
    if name not in MM_VARIANTS:
        raise ValueError(f"unknown variant {name!r}; the mm variants are {MM_VARIANTS}")
    _check(x, (G, LP, K), torch.bfloat16)
    _check(w, (G, T, K), torch.bfloat16)
    out = torch.empty((G, LP, T), dtype=torch.float32, device=x.device)
    _build.call("vitiq_probe_mm_mask", x.device, MM_VARIANTS.index(name), x.data_ptr(),
                w.data_ptr(), out.data_ptr())
    launches[name] += 1
    return out


# --------------------------------------------------------------------------
# the probe
# --------------------------------------------------------------------------

def inputs(device="cuda") -> dict:
    """The probe's inputs, seeded as the TPU probe's: x f32 [G, LP, T] from
    seed 0; for the mm_* variants bf16 xm [G, LP, K] from seed 0 and w
    [G, T, K] from seed 1 (rounded to bf16 from f32)."""
    def normal(seed, shape):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                                .astype(np.float32))

    return {"x": normal(0, (G, LP, T)).to(device),
            "xm": normal(0, (G, LP, K)).to(device, torch.bfloat16),
            "w": normal(1, (G, T, K)).to(device, torch.bfloat16)}


def run(name: str, args: dict) -> torch.Tensor:
    """Variant `name` through its wrapper on `inputs()`."""
    if name.startswith("mm_"):
        return mm_mask(name, args["xm"], args["w"])
    return mask_op(name, args["x"])


def reference(name: str, args: dict) -> torch.Tensor:
    """Variant `name`'s plain version on `inputs()`."""
    if name.startswith("mm_"):
        return mm_mask_reference(name, args["xm"], args["w"])
    return mask_op_reference(name, args["x"])


def disagreement(name: str, got: torch.Tensor, want: torch.Tensor, args: dict) -> str:
    """Why `got` fails variant `name`'s gate against its plain version
    `want`, or "" where it passes."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{got.dtype} {tuple(got.shape)} where {want.dtype} {tuple(want.shape)}"
    if name == "exp2":
        ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max()
        ok = bool(torch.isfinite(got).all()) and int(ulps) <= EXP2_ULPS
        return "" if ok else f"{int(ulps)} ulps apart (limit {EXP2_ULPS})"
    if name.startswith("mm_"):
        scale = torch.matmul(args["xm"].float().abs(), args["w"].float().abs().transpose(-1, -2))
        excess = ((got - want).abs() - MM_RTOL * scale).max()
        return "" if float(excess) <= 0 else f"{float(excess):.6g} past {MM_RTOL} of sum |x w|"
    differ = int((got != want).sum())
    return "" if differ == 0 else f"{differ} elements differ (bit for bit wanted)"


def kernel_resources(name: str):
    """(registers, spill store bytes, spill load bytes) of variant `name`'s
    kernel in the build's `ptxas -v` report."""
    if name.startswith("mm_"):
        return _build.kernel_resources("probes", f"mm_mask_kernelILi{MM_VARIANTS.index(name)}E")
    return _build.kernel_resources("probes", f"mask_op_kernelILi{VARIANTS.index(name)}E")


def ptxas_line(name: str) -> str:
    regs, stores, loads = kernel_resources(name)
    return f"ptxas sm_90a: {regs} registers, {stores} bytes spill stores, {loads} bytes spill loads"


def check(name: str, device="cuda") -> float:
    """Build, launch and hold variant `name` to its plain version on the
    card; returns max |kernel - plain| (raises AssertionError where they
    disagree, and whatever building or launching raises)."""
    args = inputs(require_cuda(device))
    got = run(name, args)
    want = reference(name, args)
    torch.cuda.synchronize(got.device)
    why = disagreement(name, got, want, args)
    if why:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {why}")
    return float((got - want).abs().max())


def report(names, device="cuda") -> dict:
    """`check` each variant of `names` on the card, printing ``name: OK`` or
    ``name: FAIL <error>`` for each; returns name -> max |kernel - plain|,
    None for a variant that failed."""
    errors = {}
    for name in names:
        try:
            errors[name] = check(name, device)
            print(f"{name}: OK  (max |kernel - plain| = {errors[name]:.6g}; {ptxas_line(name)})",
                  flush=True)
        except Exception as e:  # the probe's report: one line per variant, then go on
            errors[name] = None
            print(f"{name}: FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
    return errors


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    errors = report(argv or list(VARIANTS))
    return 1 if None in errors.values() else 0


if __name__ == "__main__":
    sys.exit(main())
