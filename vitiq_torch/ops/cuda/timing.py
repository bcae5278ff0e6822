"""Symbol timing recovery's error-feedback loops: `timing_scan_kernel`
(`csrc/timing.cu`) and its plain PyTorch version.

The kernel replaces no TPU kernel: it is the port's form of the JAX
package's `lax.scan` loops, `_gardner_scan` and `_mueller_muller_scan`
(`vitiq/dsp/timing.py:76-137`), vmapped over frames. A PyTorch loop over the
same steps launches some 60 small kernels a step from the host, so on the
card the whole recurrence is one launch: one thread a frame, the strobe
position in a register (see the .cu for what bounds it).

`timing_scan(x, sps, num_steps, method, p0=None)` takes matched-filtered
frames x [B, L, 2] f32 (contiguous) and an optional start position p0 [B]
f32 (default sps) and returns positions [B, num_steps] f32 and valid
[B, num_steps] bool, as the scans return them. On a CUDA tensor it launches
the kernel (or raises: it never falls back to the plain loop); on a CPU
tensor it runs `timing_scan_plain`, the same recurrence as a loop of tensor
operations over the batch. The kernel rounds every product and sum on its
own, as the plain loop's separate operations do, so on the card the two
agree bit for bit; XLA may contract a product and a sum into one FMA and
sums in its own order, so the port is held to the JAX package by a position
tolerance (`tests/test_torch_dsp.py`).

`launches` counts the wrapper's kernel calls; `kernel_launches` reads the
count the C code keeps where it launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vitiq_torch.ops.cuda import _build

METHODS = {"gardner": 0, "mueller_muller": 1}
# the loops' gains (vitiq/dsp/timing.py:77, :105)
GAINS = {"gardner": 0.3, "mueller_muller": 0.1}

launches = {"timing_scan": 0}


def kernel_launches(reset: bool = False) -> int:
    """The launches of timing_scan_kernel since the last reset, counted by
    the C code where it launches the kernel (0 while the library is not
    loaded: a CPU run loads it never); with `reset`, the count then starts
    again from 0."""
    if _build._library is None:
        return 0
    count = (ctypes.c_ulonglong * 1)()
    _build.library().vitiq_timing_scan_launches(count, int(reset))
    return int(count[0])


def reset_launches() -> None:
    launches["timing_scan"] = 0
    kernel_launches(reset=True)


def lin_interp(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of signals x [..., n] at fractional positions
    pos [...] (`vitiq/dsp/timing.py:_lin_interp`, one position a row)."""
    n = x.shape[-1]
    pos = pos.clamp(0.0, n - 1.0)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=n - 1)
    frac = pos - lo.to(pos.dtype)
    x_lo = x.gather(-1, lo[..., None])[..., 0]
    x_hi = x.gather(-1, hi[..., None])[..., 0]
    return x_lo * (1.0 - frac) + x_hi * frac


def timing_scan_plain(x: torch.Tensor, sps: int, num_steps: int, method: str,
                      p0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function as a loop of tensor operations over the batch:
    x [B, L, 2] -> (positions [B, num_steps] f32, valid [B, num_steps]
    bool). Gardner: e = (y - y_prev) y_mid over I and Q, the strobe moves by
    sps - clip(gain e); Mueller-Mueller: e = sign(y_prev) y - sign(y) y_prev
    over I and Q, the strobe moves by sps + clip(gain e); clip to +-sps/2,
    the gain GAINS[method]. Every scalar stays in float32."""
    if method not in METHODS:
        raise ValueError(f"unknown error-feedback method {method!r}; choose from "
                         f"{tuple(METHODS)}")
    gain = GAINS[method]
    i_sig, q_sig = x[..., 0], x[..., 1]
    B, n = i_sig.shape
    if p0 is None:
        pos = torch.full((B,), float(sps), dtype=torch.float32, device=x.device)
    else:
        pos = p0.to(device=x.device, dtype=torch.float32)
    positions, valid = [], []
    for _ in range(num_steps):
        yi, yq = lin_interp(i_sig, pos), lin_interp(q_sig, pos)
        yi_prev, yq_prev = lin_interp(i_sig, pos - sps), lin_interp(q_sig, pos - sps)
        if method == "gardner":
            yi_mid = lin_interp(i_sig, pos - sps / 2.0)
            yq_mid = lin_interp(q_sig, pos - sps / 2.0)
            err = (yi - yi_prev) * yi_mid + (yq - yq_prev) * yq_mid
            step = -(gain * err).clamp(-0.5 * sps, 0.5 * sps)
        else:
            err = ((torch.sign(yi_prev) * yi - torch.sign(yi) * yi_prev)
                   + (torch.sign(yq_prev) * yq - torch.sign(yq) * yq_prev))
            step = (gain * err).clamp(-0.5 * sps, 0.5 * sps)
        positions.append(pos)
        valid.append(pos <= n - 1)
        pos = (pos + sps) + step
    if not positions:
        return (torch.empty((B, 0), dtype=torch.float32, device=x.device),
                torch.empty((B, 0), dtype=torch.bool, device=x.device))
    return torch.stack(positions, 1), torch.stack(valid, 1)


def timing_scan(x: torch.Tensor, sps: int, num_steps: int, method: str,
                p0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions [B, num_steps] f32 and valid [B, num_steps] bool of the
    error-feedback loop `method` over frames x [B, L, 2] f32: the kernel on
    a CUDA tensor, `timing_scan_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return timing_scan_plain(x, sps, num_steps, method, p0)
    if method not in METHODS:
        raise ValueError(f"unknown error-feedback method {method!r}; choose from "
                         f"{tuple(METHODS)}")
    if x.device.type != "cuda":
        raise ValueError(f"timing_scan takes a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 or not x.is_contiguous():
        raise ValueError(f"timing_scan takes contiguous [B, L, 2] float32 frames, got "
                         f"{tuple(x.shape)} {x.dtype} (contiguous: {x.is_contiguous()})")
    B, L, _ = x.shape
    if sps < 1 or num_steps < 0:
        raise ValueError(f"timing_scan needs sps >= 1 and num_steps >= 0, got {sps}, "
                         f"{num_steps}")
    if p0 is not None and (p0.device != x.device or p0.dtype != torch.float32
                           or tuple(p0.shape) != (B,) or not p0.is_contiguous()):
        raise ValueError(f"p0 must be a contiguous [{B}] float32 tensor on {x.device}")
    positions = torch.empty((B, num_steps), dtype=torch.float32, device=x.device)
    valid = torch.empty((B, num_steps), dtype=torch.bool, device=x.device)
    if B == 0 or num_steps == 0:
        return positions, valid
    _build.call("vitiq_timing_scan", x.device, x.data_ptr(),
                None if p0 is None else p0.data_ptr(), positions.data_ptr(), valid.data_ptr(),
                B, L, sps, num_steps, METHODS[method], GAINS[method])
    launches["timing_scan"] += 1
    return positions, valid
