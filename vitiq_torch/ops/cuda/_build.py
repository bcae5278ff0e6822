"""Build and load the port's CUDA kernels at first use.

Every `vitiq_torch/csrc/*.cu` is compiled by its own `nvcc` for Hopper
(sm_90a), all of them at once, and the objects are linked into one shared
library with a plain C interface, under `build/vitiq_torch_kernels/` beside
the package, and loaded with `ctypes`. The library's file name carries a hash
of the sources, the shared headers (`*.cuh`) and the flags, so an edited
source is rebuilt and an unchanged one is reused. Each source's `ptxas -v`
report (registers, shared memory and spills of every kernel) is kept beside
the library (`ptxas_report`). Nothing is built when this module is imported:
machines without `nvcc` (the CPU test runs) never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "vitiq_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points: name -> (argtypes, restype)
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_LAYER_ARGS = [_P] * 18 + [_I] * 5 + [_P]
# x, out (y or dy), [dx, grads,] [the 6 stash tensors,] the 12 weights,
# workspace; B, L, D, H, F; dropout threshold and scale, the seed's device
# pointer, layer index; stream
_DROP_ARGS = [_I] * 5 + [_U, _F, _P, _I, _P]
SIGNATURES = {
    "vitiq_encoder_layer_full": (_LAYER_ARGS, _I),
    # x, out, q, qt, xbar, attn, x1, hid, the 12 weights, Kblk, Vblk, qt's
    # zero bias; B, L, D, H, F; stream
    "vitiq_encoder_layer_cls": ([_P] * 23 + [_I] * 5 + [_P], _I),
    # x, qt, xbar; B, L, D, H; stream
    "vitiq_cls_pool": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "vitiq_encoder_layer_attn_int8_full": (_LAYER_ARGS, _I),
    "vitiq_encoder_layer_full_noexp": (_LAYER_ARGS, _I),
    # qkv, out; B, L, D, H; stream
    "vitiq_attention_noexp": ([_P] * 2 + [_I] * 4 + [_P], _I),
    # qkv, out, s_dump, p_dump, pv_dump; B, L, D, H, core; stream
    "vitiq_attention_int8": ([_P] * 5 + [_I] * 5 + [_P], _I),
    # unsigned long long[3] out, reset
    "vitiq_kernel_launches": ([_P, _I], _I),
    # x, out, 7 scratch, x's and out's levels and scales, 16 int8-layer
    # operands; B, L, D, H, F; stream
    "vitiq_encoder_layer_int8_full": ([_P] * 29 + [_I] * 5 + [_P], _I),
    # a, aq, ascale, amax_in, wq, wscale, bias, res, gamma, beta, c, cq, cscale,
    # row_max, clear; M, K, N, relu; stream
    "vitiq_gemm_s8_stage": ([_P] * 15 + [_I] * 4 + [_P], _I),
    # a, wq, wscale, bias, c, aq, ascale; M, K, N, relu, prequant; stream
    "vitiq_gemm_int8": ([_P] * 7 + [_I] * 5 + [_P], _I),
    # a, w, bias, res, gamma, beta, c; M, K, N, epi; stream
    "vitiq_gemm_bf16": ([_P] * 7 + [_I] * 4 + [_P], _I),
    # qkv, out; B, L, D, H; stream
    "vitiq_attention_core": ([_P] * 2 + [_I] * 4 + [_P], _I),
    "vitiq_train_layer_fwd": ([_P] * 15 + _DROP_ARGS, _I),
    "vitiq_train_layer_bwd": ([_P] * 17 + _DROP_ARGS, _I),
    "vitiq_train_layer_fwd_stash": ([_P] * 21 + _DROP_ARGS, _I),
    "vitiq_train_layer_bwd_stash": ([_P] * 23 + _DROP_ARGS, _I),
    # a, b, bias, res, res32, xh, xh16, rstd, gamma, beta, out, out32, xh_out,
    # xh_out16, rstd_out, part; M, K, N, epi, splits, L; dropout threshold and
    # scale, the seed's device pointer, layer index, site; stream
    "vitiq_train_gemm_bf16": ([_P] * 16 + [_I] * 6 + [_U, _F, _P, _I, _I, _P], _I),
    # the plain dropout sites: x, out; rows, L, W, dtype; threshold, scale,
    # the seed's device pointer, salt, the first lane's index; stream
    "vitiq_hash_dropout": ([_P, _P, ctypes.c_longlong] + [_I] * 3 + [_U, _F, _P, _U, _I, _P],
                           _I),
    # K4's attention passes alone. qkv, attn, pbar; B, L, D, H; stream
    "vitiq_train_attention_fwd_stash": ([_P] * 3 + [_I] * 4 + [_P], _I),
    # qkv, attn, dattn, pbar, dqkv, part; B, L, D, H; stream
    "vitiq_train_attention_bwd_stash": ([_P] * 6 + [_I] * 4 + [_P], _I),
    # K3's attention passes alone. qkv, attn, stats; B, L, D, H; stream
    "vitiq_train_attention_fwd_recompute": ([_P] * 3 + [_I] * 4 + [_P], _I),
    # qkv, attn, dattn, stats, dqkv, part; B, L, D, H; stream
    "vitiq_train_attention_bwd_recompute": ([_P] * 6 + [_I] * 4 + [_P], _I),
    # L, D, H, int[2] out (blocks an SM of the forward and the backward)
    "vitiq_train_attention_recompute_blocks": ([_I] * 3 + [_P], _I),
    "vitiq_train_layer_fwd_workspace": ([_I] * 5, ctypes.c_size_t),
    "vitiq_train_layer_bwd_workspace": ([_I] * 5, ctypes.c_size_t),
    "vitiq_train_layer_fwd_stash_workspace": ([_I] * 5, ctypes.c_size_t),
    "vitiq_train_layer_bwd_stash_workspace": ([_I] * 5, ctypes.c_size_t),
    # q, k, v, out, lse; ldq, ldk, ldv; B, L, H, D; stream
    "vitiq_attention_fwd": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # q, k, v, out, dout, lse, delta, dq, dk, dv; ldq, ldk, ldv; B, L, H, D; stream
    "vitiq_attention_bwd": ([_P] * 10 + [_I] * 7 + [_P], _I),
    # kernel (0 fwd, 1 dQ pass, 2 dK/dV pass), d_head, int[4] out
    "vitiq_attention_ring": ([_I, _I, _P], _I),
    # timing.cu. x, p0, positions, valid; B, L, sps, steps, method, gain; stream
    "vitiq_timing_scan": ([_P] * 4 + [_I] * 5 + [_F, _P], _I),
    # x, symbols, phase; B, L, sps, window, method, gain; stream
    "vitiq_timing_symbols": ([_P] * 3 + [_I] * 5 + [_F, _P], _I),
    # unsigned long long[1] out, reset
    "vitiq_timing_recovery_launches": ([_P, _I], _I),
    # probes.cu. op, x, out, n; stream
    "vitiq_probe_mask_op": ([_I, _P, _P, _I, _P], _I),
    # op, x, w, out; stream
    "vitiq_probe_mm_mask": ([_I, _P, _P, _P, _P], _I),
    # ins, outs (pointer arrays), n_ops, block_elems, grid; stream
    "vitiq_probe_refcost": ([_P, _P, _I, ctypes.c_longlong, _I, _P], _I),
    "vitiq_error_string": ([_I], ctypes.c_char_p),
}

_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(put nvcc on PATH or set CUDA_HOME)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _run(cmds) -> list:
    """Run the commands side by side; raise with the output of any that
    failed; return the output of each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed, outs = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build() -> Path:
    """Compile the sources into the hashed library path (if not built yet):
    one nvcc per source, all started together, then one link."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libvitiq_torch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    nvcc = _nvcc()
    outs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in zip(srcs, objs)])
    for src, out in zip(srcs, outs):
        _report_path(lib, src.stem).write_text(out)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


def _report_path(lib: Path, stem: str) -> Path:
    return lib.with_name(f"{lib.stem}.{stem}.ptxas.txt")


def ptxas_report(stem: str) -> str:
    """The `ptxas -v` output of `csrc/<stem>.cu` in the current build."""
    return _report_path(build(), stem).read_text()


def ptxas_entries(report: str) -> dict:
    """Each kernel of a `ptxas -v` report: mangled name -> (registers, spill
    store bytes, spill load bytes)."""
    entries = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        entries[name] = (int(regs.group(1)) if regs else 0,
                         *(map(int, spills.groups()) if spills else (0, 0)))
    return entries


def kernel_resources(stem: str, tag: str):
    """(registers, spill store bytes, spill load bytes) of the one kernel of
    `csrc/<stem>.cu` whose mangled name holds `tag`, from the build's `ptxas
    -v` report; raises unless exactly one kernel matches."""
    found = [v for k, v in ptxas_entries(ptxas_report(stem)).items() if tag in k]
    if len(found) != 1:
        raise RuntimeError(f"{tag}: {len(found)} entries in the ptxas report of {stem}.cu")
    return found[0]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _library = lib
    return _library


def call(entry: str, device, *args) -> None:
    """Call the C entry point `entry` with `args` and the current stream of
    the CUDA `device`; raise on the CUDA error it returns."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.vitiq_error_string(err).decode()})")
