"""Symbol timing recovery (counterpart of `vitiq/dsp/timing.py`).

The four methods of the reference's DSP contract: `simple_energy` and
`simple_correlation` (vectorized phase pickers) and `gardner`,
`mueller_muller` (sequential error-feedback loops). The loops' positions
come from `ops/cuda/timing.timing_scan`: one launch of the timing-recovery
kernel for the whole batch on a CUDA tensor, the plain PyTorch loop on a CPU
tensor (the SPS front-end takes its symbols straight from the kernel:
`ops/cuda/timing.timing_symbols`). Their fixed trip count and validity mask
are the JAX package's. The host-facing wrappers take numpy signals and
return numpy index arrays; they compute on `device` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from vitiq_torch.ops.cuda import timing as tk
from vitiq_torch.utils.device import resolve_device


def simple_timing_recovery(i_signal, q_signal, sps: int, method: str = "energy") -> np.ndarray:
    """Pick the best of the `sps` decimation phases and sample at symbol rate.

    method='energy':       phase maximizing the mean symbol energy |x|^2
                           (the eye is widest where the matched-filter output
                           peaks).
    method='correlation':  phase maximizing symbol-to-symbol correlation
                           sum |x[p] . x[p+sps]| -- peaks align consecutive
                           symbol cores rather than transitions.

    Returns integer sample indices, ~len(signal)//sps of them.
    """
    i_sig = np.asarray(i_signal, dtype=np.float64)
    q_sig = np.asarray(q_signal, dtype=np.float64)
    n = len(i_sig)
    num_sym = n // sps
    scores = np.empty(sps)
    for phase in range(sps):
        idx = np.arange(phase, phase + num_sym * sps, sps)
        idx = idx[idx < n]
        si, sq = i_sig[idx], q_sig[idx]
        if method == "energy":
            scores[phase] = np.mean(si * si + sq * sq)
        elif method == "correlation":
            scores[phase] = np.mean(np.abs(si[:-1] * si[1:] + sq[:-1] * sq[1:]))
        else:
            raise ValueError(f"unknown simple timing method {method!r}")
    best = int(np.argmax(scores))
    idx = np.arange(best, best + num_sym * sps, sps)
    return idx[idx < n]


def _scan_to_indices(positions, valid, n: int) -> np.ndarray:
    pos = np.asarray(positions)[np.asarray(valid)]
    idx = np.rint(pos).astype(np.int64)
    return np.clip(idx, 0, n - 1)


def full_positions(x: torch.Tensor, sps: int, method: str):
    """The full loops over filtered frames x [B, L, 2] f32 (contiguous):
    L//sps steps a frame from position sps. Returns (positions, valid)
    [B, L//sps]."""
    tk.check_loop(sps, method)
    return tk.timing_scan(x, sps, x.shape[1] // sps, method)


def hybrid_positions(x: torch.Tensor, sps: int, method: str, window: int = 64) -> torch.Tensor:
    """The hybrid loop over filtered frames x [B, L, 2] f32 (contiguous):
    the best integer decimation phase by mean symbol energy, `window` loop
    steps from one symbol past it, the circular mean (period sps) of the
    second half-window's positions as the steady-state phase, then uniform
    strobes phase + k sps for the whole frame (`ops/cuda/timing.
    hybrid_positions` around `timing_scan`). Returns positions [B, L//sps]
    f32, clipped to [0, L-1]."""
    return tk.hybrid_positions(x, sps, method, window, scan=tk.timing_scan)


def batched_timing_positions(i_sig: torch.Tensor, q_sig: torch.Tensor, sps: int,
                             method: str):
    """Batched error-feedback timing recovery: [B, L] I/Q -> (positions
    [B, L//sps] f32, valid [B, L//sps] bool), the device-path twin of
    timing_recovery_{gardner,mueller_muller}."""
    return full_positions(torch.stack([i_sig, q_sig], -1).float().contiguous(), sps, method)


def hybrid_timing_positions(i_sig: torch.Tensor, q_sig: torch.Tensor, sps: int,
                            method: str, window: int = 64):
    """HYBRID timing recovery: coarse energy-phase pick -> a short
    error-feedback tracking window -> steady-state fractional phase ->
    uniform strobes for the whole frame (`hybrid_positions`). Uniform strobes
    assume intra-frame clock drift well below a sample; drifting channels
    should use the full loops (`batched_timing_positions`).

    Returns (positions [B, L//sps] f32, valid [B, L//sps] all True)."""
    pos = hybrid_positions(torch.stack([i_sig, q_sig], -1).float().contiguous(), sps, method,
                           window)
    return pos, torch.ones(pos.shape, dtype=torch.bool, device=pos.device)


def _recover(i_signal, q_signal, sps: int, method: str, device) -> np.ndarray:
    device = resolve_device(device)
    x = torch.as_tensor(np.stack([np.asarray(i_signal, np.float32),
                                  np.asarray(q_signal, np.float32)], -1)[None], device=device)
    n = x.shape[1]
    positions, valid = tk.timing_scan(x, sps, n // sps, method)
    return _scan_to_indices(positions[0].cpu().numpy(), valid[0].cpu().numpy(), n)


def timing_recovery_gardner(i_signal, q_signal, sps: int, device="cuda") -> np.ndarray:
    """Gardner timing recovery -> integer sample indices (~n/sps symbols)."""
    if sps < 2:
        raise ValueError("Gardner timing recovery requires sps >= 2")
    return _recover(i_signal, q_signal, sps, "gardner", device)


def timing_recovery_mueller_muller(i_signal, q_signal, sps: int, device="cuda") -> np.ndarray:
    """Mueller-Mueller timing recovery -> integer sample indices."""
    if sps < 2:
        raise ValueError("Mueller-Müller timing recovery requires sps >= 2")
    return _recover(i_signal, q_signal, sps, "mueller_muller", device)
