"""Design experiments on timing_recovery_kernel (`csrc/timing.cu`), on the card.

Each variant is a text edit of `timing.cu`, built like the source as it is
("base") by its own nvcc into its own library under
``build/variants/timing/`` beside the package (seconds each: a plain C
interface), and its C entries are timed in turns (CUDA events, 20 launches
after 3, rounds in alternating orders) at B=4096 matched-filtered frames of
2,048 samples at sps 2, both loops: positions mode over the full loop's
1,024 steps (`vitiq_timing_scan`) and symbols mode, full loop and hybrid
(`vitiq_timing_symbols`). Every variant computes the same function, so its
outputs must equal base's bit for bit. Each line names the card and its
power limit.

    python -m vitiq_torch.ops.cuda.timing_variants [experiment ...]   # default: all

An edit that no longer matches the source raises. Needs nvcc and a CUDA card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import timing as tk

SOURCE = "timing.cu"
WORK = _build.BUILD_DIR.parent / "variants" / "timing"
B, L, SPS, WINDOW = 4096, 2048, 2, 64

_LOOP = "constexpr int kLoopGroup = 8;"
_HYBRID = "constexpr int kHybridGroup = 16;"

# experiment -> {variant: [(old text, new text), ...]}
EXPERIMENTS = {
    # lanes a frame: the loops' group (positions, full loop) and the hybrid's
    "group": {
        "loops 1 lane a frame": [(_LOOP, "constexpr int kLoopGroup = 1;")],
        "loops 2 lanes a frame": [(_LOOP, "constexpr int kLoopGroup = 2;")],
        "loops 4 lanes a frame": [(_LOOP, "constexpr int kLoopGroup = 4;")],
        "loops 16 lanes a frame": [(_LOOP, "constexpr int kLoopGroup = 16;")],
        "hybrid 8 lanes a frame": [(_HYBRID, "constexpr int kHybridGroup = 8;")],
    },
    # each group's ring shifted by 4 banks from the one before it
    "pad": {
        "rings 2 samples apart": [
            ("  float2* ring = smem + group * 2 * H;",
             "  float2* ring = smem + group * (2 * H + 2);"),
            ("  const size_t smem = static_cast<size_t>(kFrames) * 2 * p.half * sizeof(float2);",
             "  const size_t smem = static_cast<size_t>(kFrames) * (2 * p.half + 2) * "
             "sizeof(float2);")],
    },
}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def build(name: str, edits) -> ctypes.CDLL:
    """The library of timing.cu with `edits`, built into WORK/<name>."""
    text = (_build.CSRC / SOURCE).read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name!r}: {old!r} is not in {SOURCE}")
        text = text.replace(old, new)
    work = WORK / name.replace(" ", "_")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / SOURCE).write_text(text)
    lib = work / "libtiming.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(work / SOURCE)], check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out.vitiq_timing_scan.argtypes = [p] * 4 + [i] * 5 + [f, p]
    out.vitiq_timing_symbols.argtypes = [p] * 3 + [i] * 5 + [f, p]
    return out


def frames(device) -> torch.Tensor:
    """B synthetic frames of L samples RRC-shaped at SPS (the default
    classes and SNRs), after the matched filter, on `device`."""
    from vitiq_torch.config import DataConfig
    from vitiq_torch.data import SyntheticAMCDataset
    from vitiq_torch.dsp.filtering import matched_filter_batch

    data = DataConfig()
    ds = SyntheticAMCDataset(classes=data.synthetic_classes, frames_per_class=-(-B // 3),
                             frame_len=L, snrs_db=data.synthetic_snr_db, seed=0,
                             shaping_sps=SPS)
    x = torch.from_numpy(np.ascontiguousarray(ds.X[:B])).to(device)
    return matched_filter_batch(x, SPS)


def calls(lib: ctypes.CDLL, f: torch.Tensor, method: str) -> dict:
    """The three calls timed, each returning its output."""
    stream = torch.cuda.current_stream().cuda_stream
    m, gain = tk.METHODS[method], tk.GAINS[method]

    def positions():
        pos = torch.empty((B, L // SPS), device=f.device)
        ok = torch.empty((B, L // SPS), dtype=torch.bool, device=f.device)
        rc = lib.vitiq_timing_scan(f.data_ptr(), None, pos.data_ptr(), ok.data_ptr(), B, L, SPS,
                                   L // SPS, m, gain, stream)
        if rc:
            raise RuntimeError(f"vitiq_timing_scan returned {rc}")
        return pos

    def symbols(window):
        def call():
            out = torch.empty((B, L // SPS, 2), device=f.device)
            rc = lib.vitiq_timing_symbols(f.data_ptr(), out.data_ptr(), None, B, L, SPS, window,
                                          m, gain, stream)
            if rc:
                raise RuntimeError(f"vitiq_timing_symbols returned {rc}")
            return out
        return call

    return {"positions, full": positions, "symbols, full": symbols(0),
            "symbols, hybrid": symbols(WINDOW)}


def ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(experiment: str, f: torch.Tensor, line: str, rounds: int = 2) -> None:
    libs = {"base": build("base", [])}
    libs.update({name: build(name, edits) for name, edits in EXPERIMENTS[experiment].items()})
    for method in tk.METHODS:
        want = {k: fn() for k, fn in calls(libs["base"], f, method).items()}
        times = {name: {k: [] for k in want} for name in libs}
        for r in range(rounds):
            for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                for k, fn in calls(libs[name], f, method).items():
                    if r == 0 and not torch.equal(fn(), want[k]):
                        raise AssertionError(f"{experiment}: {name} {k} differs from base")
                    times[name][k].append(ms(fn))
        for name, t in times.items():
            print(f"{experiment}: {name}, {method}: "
                  + ", ".join(f"{k} {min(v):.4f} ms" for k, v in t.items())
                  + f" (the least of {rounds} rounds)  [{line}]", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("timing_variants needs a CUDA card", file=sys.stderr)
        return 1
    names = argv or list(EXPERIMENTS)
    line = card()
    f = frames(torch.device("cuda"))
    for name in names:
        run(name, f, line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
