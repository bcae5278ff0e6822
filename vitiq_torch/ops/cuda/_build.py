"""Build and load the port's CUDA kernels at first use.

Every `vitiq_torch/csrc/*.cu` is compiled by its own `nvcc` for Hopper
(sm_90a), all of them at once, and the objects are linked into one shared
library with a plain C interface, under `build/vitiq_torch_kernels/` beside
the package, and loaded with `ctypes`. The library's file name carries a hash
of the sources, the shared headers (`*.cuh`) and the flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is built when this
module is imported: machines without `nvcc` (the CPU test runs) never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "vitiq_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# C entry points: name -> (argtypes, restype)
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_LAYER_ARGS = [_P] * 18 + [_I] * 5 + [_P]
# x, out (y or dy), [dx, grads,] the 12 weights, workspace; B, L, D, H, F;
# dropout threshold and scale, seed, layer index; stream
_DROP_ARGS = [_I] * 5 + [_U, _F, _I, _I, _P]
SIGNATURES = {
    "vitiq_encoder_layer_full": (_LAYER_ARGS, _I),
    "vitiq_encoder_layer_cls": (_LAYER_ARGS, _I),
    "vitiq_train_layer_fwd": ([_P] * 15 + _DROP_ARGS, _I),
    "vitiq_train_layer_bwd": ([_P] * 17 + _DROP_ARGS, _I),
    "vitiq_train_layer_fwd_workspace": ([_I] * 5, ctypes.c_size_t),
    "vitiq_train_layer_bwd_workspace": ([_I] * 5, ctypes.c_size_t),
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


def _run(cmds) -> None:
    """Run the commands side by side; raise with the output of any that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


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
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)])
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


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
