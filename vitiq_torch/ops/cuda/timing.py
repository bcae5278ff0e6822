"""Symbol timing recovery on the card: `timing_recovery_kernel`
(`csrc/timing.cu`) and its plain PyTorch versions.

The kernel replaces no TPU kernel: the JAX package runs timing recovery as
XLA code, the loops `_gardner_scan` and `_mueller_muller_scan`
(`vitiq/dsp/timing.py:76-137`, `lax.scan`s vmapped over frames), the
hybrid's coarse phase and circular mean (`hybrid_timing_positions`,
:157-207) and the strobes' gather (`vitiq/dsp/frontend.py:190-200`). In
PyTorch the loop alone launches some 45 small kernels a step from the host,
so on the card it is one launch from filtered frames to symbols (see the
.cu for its design and what bounds it). Two wrappers launch it:

`timing_symbols(x, sps, method, window=64)`: matched-filtered frames x
[B, L, 2] f32 (contiguous) -> symbols [B, L//sps, 2] f32, the SPS
front-end's timing recovery. A window below L//sps runs the hybrid (the
coarse energy phase, `window` loop steps from one symbol past it, the
circular mean of the second half-window's positions, uniform strobes); 0 or
a window of L//sps or more runs the full loop. Its plain version
`timing_symbols_plain` is the tensor composition the front-end ran before:
`symbol_positions` (the coarse phase, `timing_scan_plain`, the circular mean;
or the full loop), then `strobe_symbols` (round half to even, clamp, gather).

`timing_scan(x, sps, num_steps, method, p0=None)`: the loop's positions
[B, num_steps] f32 and valid flags [B, num_steps] bool from start positions
p0 [B] f32 (default sps), as the scans return them; its plain version
`timing_scan_plain`, the same recurrence as a loop of tensor operations.

On a CUDA tensor each wrapper launches the kernel (or raises: it never falls
back to the plain version); on a CPU tensor it runs the plain version. The
kernel rounds every product and sum of the loop on its own, as the plain
loop's separate operations do, so on the card the positions and the full
loop's symbols equal the plain version's bit for bit; the hybrid's phase
sums its sines and cosines in another order (within a few float32 ulps, so a
symbol can differ only at a strobe that sits that close to a half-integer).
XLA may contract a product and a sum into one FMA and sums in its own order,
so the port is held to the JAX package by a position tolerance
(`tests/test_torch_dsp.py`).

`launches` counts each wrapper's kernel calls; `kernel_launches` reads the
count the C code keeps where it launches the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch

from vitiq_torch.ops.cuda import _build

METHODS = {"gardner": 0, "mueller_muller": 1}
# the loops' gains (vitiq/dsp/timing.py:77, :105)
GAINS = {"gardner": 0.3, "mueller_muller": 0.1}
# the largest sps whose 8 steps between two ring upkeeps fit half the kernel's ring (512 samples)
MAX_SPS = 42

launches = {"timing_scan": 0, "timing_symbols": 0}


def kernel_launches(reset: bool = False) -> int:
    """The launches of timing_recovery_kernel since the last reset (both
    modes), counted by the C code where it launches the kernel (0 while the
    library is not loaded: a CPU run loads it never); with `reset`, the count
    then starts again from 0."""
    if _build._library is None:
        return 0
    count = (ctypes.c_ulonglong * 1)()
    _build.library().vitiq_timing_recovery_launches(count, int(reset))
    return int(count[0])


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    kernel_launches(reset=True)


def check_loop(sps: int, method: str) -> None:
    """Raise ValueError on what vitiq's loops refuse: sps < 2 or an unknown
    method."""
    if sps < 2:
        raise ValueError("error-feedback timing recovery requires sps >= 2")
    if method not in METHODS:
        raise ValueError(f"unknown error-feedback method {method!r}; choose from "
                         f"{tuple(METHODS)}")


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
    """The loop as tensor operations over the batch: x [B, L, 2] ->
    (positions [B, num_steps] f32, valid [B, num_steps] bool). Gardner:
    e = (y - y_prev) y_mid over I and Q, the strobe moves by sps - clip(gain
    e); Mueller-Mueller: e = sign(y_prev) y - sign(y) y_prev over I and Q,
    the strobe moves by sps + clip(gain e); clip to +-sps/2, the gain
    GAINS[method]. Every scalar stays in float32."""
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


def _check_frames(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous [B, L, 2] float32 frames, got "
                         f"{tuple(x.shape)} {x.dtype} (contiguous: {x.is_contiguous()})")


def timing_scan(x: torch.Tensor, sps: int, num_steps: int, method: str,
                p0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions [B, num_steps] f32 and valid [B, num_steps] bool of the
    error-feedback loop `method` over frames x [B, L, 2] f32: the kernel in
    positions mode on a CUDA tensor, `timing_scan_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return timing_scan_plain(x, sps, num_steps, method, p0)
    if method not in METHODS:
        raise ValueError(f"unknown error-feedback method {method!r}; choose from "
                         f"{tuple(METHODS)}")
    _check_frames("timing_scan", x)
    B, L, _ = x.shape
    if not 1 <= sps <= MAX_SPS or num_steps < 0:
        raise ValueError(f"timing_scan needs 1 <= sps <= {MAX_SPS} and num_steps >= 0, got "
                         f"{sps}, {num_steps}")
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


def hybrid_window(window: int, n_sym: int) -> int:
    """The hybrid's loop steps for `window` at n_sym symbols a frame: the
    window where it is below n_sym, else 0 (the full loop)."""
    return window if window and window < n_sym else 0


def hybrid_positions(x: torch.Tensor, sps: int, method: str, window: int = 64,
                     scan: Callable = timing_scan_plain) -> torch.Tensor:
    """The hybrid loop's strobe positions [B, L//sps] f32 over frames x
    [B, L, 2] f32 as tensor operations around `scan` (`timing_scan_plain`, or
    `timing_scan` for the kernel's loop): the best integer decimation phase by
    mean symbol energy, `window` loop steps from one symbol past it, the
    circular mean (period sps) of the second half-window's positions as the
    steady-state phase, then uniform strobes phase + k sps, clipped to
    [0, L-1]."""
    check_loop(sps, method)
    B, n, _ = x.shape
    n_sym = n // sps
    ph = x[:, : n_sym * sps].reshape(B, n_sym, sps, 2).square().sum(-1)  # [B, n_sym, sps]
    p0 = ph.mean(1).argmax(-1).to(torch.float32)
    positions, _ = scan(x, sps, window, method, p0=(p0 + sps).contiguous())
    theta = positions * (2.0 * math.pi / sps)
    w = (torch.arange(window, device=x.device) >= window // 2).to(theta.dtype)
    frac = torch.atan2((theta.sin() * w).sum(-1), (theta.cos() * w).sum(-1))
    frac = (frac * (sps / (2.0 * math.pi))) % sps
    pos = frac[:, None] + sps * torch.arange(n_sym, dtype=torch.float32, device=x.device)
    return pos.clamp(0.0, n - 1.0)


def symbol_positions(x: torch.Tensor, sps: int, method: str, window: int = 64,
                     scan: Callable = timing_scan_plain) -> torch.Tensor:
    """The front-end's strobe positions [B, L//sps] f32: `hybrid_positions`
    for a window below L//sps, else the full loop's L//sps steps from sps."""
    check_loop(sps, method)
    n_sym = x.shape[1] // sps
    if hybrid_window(window, n_sym):
        return hybrid_positions(x, sps, method, window, scan)
    return scan(x, sps, n_sym, method)[0]


def strobe_symbols(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x [B, L, 2] at the strobes positions [B, S] rounded half to even and
    clamped to the frame: [B, S, 2] (vitiq's `rint`, clip, `take_along_axis`)."""
    B, L, _ = x.shape
    idx = positions.round().clamp(0, L - 1).long()
    return x.gather(1, idx[..., None].expand(B, idx.shape[1], 2))


def timing_symbols_plain(x: torch.Tensor, sps: int, method: str, window: int = 64,
                         scan: Callable = timing_scan_plain) -> torch.Tensor:
    """The kernel's function in symbols mode as tensor operations:
    `strobe_symbols(x, symbol_positions(x, sps, method, window, scan))`,
    [B, L//sps, 2]. With `scan=timing_scan` on the card it is the front-end's
    composition around the positions-mode kernel."""
    return strobe_symbols(x, symbol_positions(x, sps, method, window, scan))


def timing_symbols(x: torch.Tensor, sps: int, method: str, window: int = 64,
                   phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symbols [B, L//sps, 2] f32 of matched-filtered frames x [B, L, 2] f32 by
    the loop `method`, hybrid for a window below L//sps, else the full loop:
    the kernel in symbols mode on a CUDA tensor, `timing_symbols_plain` on a
    CPU tensor. Where given, `phase` [B] f32 on x's device receives the
    hybrid's steady-state phase (its first strobe)."""
    check_loop(sps, method)
    B, L = x.shape[0], x.shape[1]
    n_sym = L // sps
    steps = hybrid_window(window, n_sym)
    if phase is not None and (not steps or phase.device != x.device
                              or phase.dtype != torch.float32 or tuple(phase.shape) != (B,)
                              or not phase.is_contiguous()):
        raise ValueError(f"phase must be a contiguous [{B}] float32 tensor on {x.device}, "
                         "and the loop hybrid")
    if x.device.type == "cpu":
        positions = symbol_positions(x, sps, method, window)
        if phase is not None:
            phase.copy_(positions[:, 0])
        return strobe_symbols(x, positions)
    _check_frames("timing_symbols", x)
    if sps > MAX_SPS:
        raise ValueError(f"timing_symbols takes sps up to {MAX_SPS}, got {sps}")
    out = torch.empty((B, n_sym, 2), dtype=torch.float32, device=x.device)
    if B == 0 or n_sym == 0:
        return out
    _build.call("vitiq_timing_symbols", x.device, x.data_ptr(), out.data_ptr(),
                None if phase is None else phase.data_ptr(), B, L, sps, steps,
                METHODS[method], GAINS[method])
    launches["timing_symbols"] += 1
    return out
