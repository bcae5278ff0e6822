"""Polyphase filter-bank channelizer (counterpart of
`vitiq/dsp/channelizer.py`).

The streaming-wideband front-end: a critically-sampled polyphase
channelizer. A prototype lowpass of length K*taps_per_phase is decomposed
into K phases; each phase FIR-filters its decimated branch (one grouped
convolution with K groups, on the real and the imaginary parts, in float32
without TF32) and an FFT across the branches yields the K channel streams.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitiq_torch.dsp.filtering import f32_conv


def design_prototype_lowpass(num_channels: int, taps_per_phase: int = 8,
                             beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype with cutoff at the channel half-width
    (1/(2K) of the input rate). Unit DC gain per branch."""
    n = num_channels * taps_per_phase
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(t / num_channels) * np.kaiser(n, beta)
    return (h / h.sum()).astype(np.float64)


def polyphase_channelize(x: torch.Tensor, num_channels: int, taps: np.ndarray) -> torch.Tensor:
    """[B, N] complex wideband -> [B, K, N//K] complex64 channel streams.

    N must be a multiple of K. Channel k is centered at f = k/K of the input
    sample rate (fftfreq ordering: k > K/2 are negative frequencies).
    """
    B, N = x.shape
    K = num_channels
    if N % K:
        raise ValueError(f"stream length {N} must be a multiple of num_channels {K}")
    P = len(taps) // K
    if len(taps) != K * P:
        raise ValueError("taps length must be a multiple of num_channels")
    M = N // K

    # commutator: branch k takes samples n = m*K + k
    xb = x.reshape(B, M, K)
    # phase k of the prototype is taps[k::K]: h[p, k] = taps[p*K + k]
    h = torch.as_tensor(np.asarray(taps, np.float32).reshape(P, K), device=x.device)
    # branch FIR along m, causal: y[b, m, k] = sum_p x[b, m - p, k] h[p, k],
    # as a correlation with each branch's flipped phase; the real and the
    # imaginary parts are two halves of one batch
    lhs = torch.cat([xb.real, xb.imag]).transpose(1, 2)  # [2B, K, M]
    w = h.flip(0).T[:, None, :].contiguous()  # [K, 1, P]
    with f32_conv():
        out = F.conv1d(F.pad(lhs, (P - 1, 0)), w, groups=K)  # [2B, K, M]
    y = torch.complex(out[:B], out[B:]).transpose(1, 2)  # [B, M, K]
    # forward DFT across the branches demodulates channel k
    return torch.fft.fft(y, dim=-1).transpose(1, 2)


def synthesize_multitone(
    num_channels: int,
    samples_per_channel: int,
    active: Tuple[Tuple[int, float], ...],
    seed: int = 0,
    noise_db: float = -30.0,
) -> np.ndarray:
    """Test/demo wideband: complex tones (+ noise) at given (channel, amplitude)
    pairs. Returns [1, K * samples_per_channel] complex64."""
    K = num_channels
    N = K * samples_per_channel
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    x = np.zeros(N, np.complex128)
    for ch, amp in active:
        f = (ch / K) % 1.0
        phase = rng.uniform(0, 2 * np.pi)
        x += amp * np.exp(1j * (2 * np.pi * f * t + phase))
    npow = 10.0 ** (noise_db / 10.0)
    x += np.sqrt(npow / 2) * (rng.standard_normal(N) + 1j * rng.standard_normal(N))
    return x[None].astype(np.complex64)
