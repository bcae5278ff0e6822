"""Build and load the port's CUDA kernels at first use.

Every `vitiq_torch/csrc/*.cu` is compiled by `nvcc` for Hopper (sm_90a) into
one shared library with a plain C interface, under
`build/vitiq_torch_kernels/` beside the package, and loaded with `ctypes`.
The library's file name carries a hash of the sources and flags, so an edited
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
              "-shared", "-Xcompiler", "-fPIC"]

# C entry points: name -> (argtypes, restype)
_P, _I = ctypes.c_void_p, ctypes.c_int
_LAYER_ARGS = [_P] * 18 + [_I] * 5 + [_P]
SIGNATURES = {
    "vitiq_encoder_layer_full": (_LAYER_ARGS, _I),
    "vitiq_encoder_layer_cls": (_LAYER_ARGS, _I),
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


def build() -> Path:
    """Compile the sources into the hashed library path (if not built yet)."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libvitiq_torch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
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
