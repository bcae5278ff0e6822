"""P2, the per-operand cost probe on Hopper: the counterpart of
scripts/tpu_probe_refcost.py.

The TPU probe priced what each operand of a kernel costs per grid step (its
DMA descriptors): three kernels move identical bytes per grid step over an
identical grid of batch / G steps, and only the operand count differs:

  many: NR input operands + NR output operands, each [G, 16, W]
  mid:  NR / 4 per side, each [G, 16, 4W]
  fat:  1 per side, [G, 16, NR * W]

with W = 128 and the body ``out = in + 1`` in bf16. Time per grid step
against the operand count is the per-operand price. On Hopper the kernel is
`refcost_kernel` in `csrc/probes.cu`: one block per grid step, the operand
pointers passed by value in a struct, each block streaming its [G, 16, W]
slice of every operand; what an operand costs a block there is its pointer
loads and loop, not a descriptor. K3-bwd's ~40 operands per block are the
case it prices.

The TPU probe's timing perturbs the first operand of every call, which is
a sixteenth of the bytes in the many arm and all of them in the fat arm, so
on the card its price mixes that op's cost into the operands'; `measure`
also times each arm's kernel alone (no call can reuse another's result on
the card: each arm reads ten times its L2) and prints that price too.

`refcost` launches the kernel on CUDA tensors and runs its plain version,
`refcost_reference` (``x + 1`` per operand), on CPU tensors; `launches`
counts the launches per arm shape ("<operands>x<width>"). `make_call` and
`measure` mirror the TPU probe's `make_call` and `main`.

Usage: python -m vitiq_torch.probes.refcost [batch=8192] [G=40] [NR=16]

The defaults are the TPU probe's, and so is its check that G divides batch:
8192 is not a multiple of 40, so run with an explicit batch (8200 gives the
205 grid steps its docstring describes).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from vitiq_torch.ops.cuda import _build
from vitiq_torch.probes._timing import require_cuda, time_amortized

LP, W = 16, 128
MAX_OPERANDS = 64  # per side: REFCOST_MAX_OPERANDS in the .cu

launches: dict = {}


def reset_launches() -> None:
    launches.clear()


def arm_key(n_operands: int, width: int) -> str:
    return f"{n_operands}x{width}"


def arms(nr: int):
    """(tag, operands per side, width) of the three arms."""
    return (("many", nr, W), ("mid", nr // 4, 4 * W), ("fat", 1, nr * W))


def refcost_reference(xs):
    """Plain version: ``x + 1`` for each bf16 operand (computed in f32 and
    rounded to bf16, as the kernel does)."""
    return [x + 1 for x in xs]


def refcost(xs, g: int):
    """``out = in + 1`` for each bf16 [batch, LP, width] operand of `xs` (one
    shape for all), on a grid of batch / g blocks, each taking its g rows of
    every operand: `refcost_kernel` on CUDA tensors, the plain version on CPU
    tensors. Returns the outputs, a list."""
    if xs[0].device.type == "cpu":
        return refcost_reference(xs)
    batch, lp, width = xs[0].shape
    if not 0 < len(xs) <= MAX_OPERANDS:
        raise ValueError(f"the kernel takes 1 to {MAX_OPERANDS} operands, got {len(xs)}")
    if lp != LP or width % 8 or g <= 0 or batch % g:
        raise ValueError(f"want [batch, {LP}, width] operands with width a multiple of 8 and "
                         f"G dividing batch; got {tuple(xs[0].shape)} with G={g}")
    for x in xs:
        if (x.device != xs[0].device or x.shape != xs[0].shape or x.dtype != torch.bfloat16
                or not x.is_contiguous()):
            raise ValueError(f"every operand must be a contiguous bf16 {tuple(xs[0].shape)} "
                             f"tensor on {xs[0].device}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    outs = [torch.empty_like(x) for x in xs]
    pointers = ctypes.c_void_p * len(xs)
    _build.call("vitiq_probe_refcost", xs[0].device, pointers(*(x.data_ptr() for x in xs)),
                pointers(*(o.data_ptr() for o in outs)), len(xs), g * LP * width, batch // g)
    key = arm_key(len(xs), width)
    launches[key] = launches.get(key, 0) + 1
    return outs


def make_call(nr_refs: int, width: int, batch: int, g: int):
    """run(seed, *xs): the nr_refs operands of [batch, LP, width] with the
    first perturbed by the seed (one elementwise op in every arm, so that the
    arms differ in the kernel's operand count alone), through `refcost`;
    returns the outputs (the one tensor where nr_refs is 1)."""
    def run(seed, *xs):
        if len(xs) != nr_refs or tuple(xs[0].shape) != (batch, LP, width):
            raise ValueError(f"want {nr_refs} operands of {(batch, LP, width)}")
        xs = (xs[0] + seed.to(torch.bfloat16),) + tuple(xs[1:])
        outs = refcost(xs, g)
        return tuple(outs) if nr_refs > 1 else outs[0]

    return run


def arm_inputs(nrefs: int, width: int, batch: int, device="cuda"):
    """The arm's operands: bf16 [batch, LP, width] normals, operand i from
    seed i (made on `device`)."""
    device = torch.device(device)
    return tuple(torch.randn((batch, LP, width), device=device,
                             generator=torch.Generator(device).manual_seed(i)).to(torch.bfloat16)
                 for i in range(nrefs))


def check_arguments(batch: int, g: int, nr: int) -> None:
    """The TPU probe's two checks (its asserts): the mid arm moves the same
    bytes only when 4 divides NR, and the grid tiles exactly only when G
    divides batch."""
    if nr % 4:
        raise ValueError(f"NR must be a multiple of 4 (got {nr})")
    if batch % g:
        raise ValueError(f"batch ({batch}) must be a multiple of G ({g})")


def measure(batch: int, g: int, nr: int, device="cuda"):
    """Time the three arms on the card (`time_amortized`) and print, as the
    TPU probe does, each arm's ms per call and us per block, then the
    per-operand per-block price; returns one dict per arm."""
    check_arguments(batch, g, nr)
    device = require_cuda(device)
    grid = batch // g
    print(f"batch={batch} G={g} grid={grid} Lp={LP} W={W} "
          f"bytes/side/step={nr * g * LP * W * 2}", flush=True)
    rows = []
    for tag, nrefs, width in arms(nr):
        xs = arm_inputs(nrefs, width, batch, device)
        t = time_amortized(make_call(nrefs, width, batch, g), xs)
        alone = time_amortized(lambda seed, *xs: refcost(xs, g), xs)
        rows.append({"arm": tag, "operands": 2 * nrefs, "width": width, "ms": t * 1e3,
                     "us_per_block": t / grid * 1e6, "kernel_ms": alone * 1e3,
                     "kernel_us_per_block": alone / grid * 1e6})
        print(f"{tag:5s} operands={2 * nrefs:3d}  {t * 1e3:8.3f} ms/call  "
              f"{t / grid * 1e6:7.3f} us/block  (kernel alone {alone * 1e3:8.3f} ms/call  "
              f"{alone / grid * 1e6:7.3f} us/block)", flush=True)
        del xs
    d_ops = rows[0]["operands"] - rows[2]["operands"]
    for key, what in (("us_per_block", ""), ("kernel_us_per_block", ", kernel alone")):
        price_ns = (rows[0][key] - rows[2][key]) / d_ops * 1e3
        print(f"per-operand per-block price ~= {price_ns:.1f} ns (many-vs-fat over {d_ops} "
              f"operands{what})", flush=True)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    batch = int(argv[0]) if len(argv) > 0 else 8192
    g = int(argv[1]) if len(argv) > 1 else 40
    nr = int(argv[2]) if len(argv) > 2 else 16
    measure(batch, g, nr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
