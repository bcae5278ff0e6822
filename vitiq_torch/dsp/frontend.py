"""Preprocessing front-end (counterpart of `vitiq/dsp/frontend.py`): symbol
extraction, normalization and model shaping.

The single-frame numpy APIs (`extract_symbols`, `apply_normalization`,
`preprocess_for_vit`, `preprocess_for_transformer`) follow the reference's
helpers and its `extract_symbols` contract. The batched functions take
[B, L, 2] frames on the device and stay there: the per-channel z-score and
the arm's input shape, the SPS front-end (RRC matched filter, then timing
recovery, the error-feedback loops one kernel launch on the card), the
spectrogram images, and the amplitude/phase features.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vitiq_torch.dsp.filtering import matched_filter, matched_filter_batch
from vitiq_torch.dsp.timing import (
    full_positions,
    hybrid_positions,
    simple_timing_recovery,
    timing_recovery_gardner,
    timing_recovery_mueller_muller,
)

_METHODS = ("simple_energy", "simple_correlation", "gardner", "mueller_muller")


def extract_symbols(i_signal, q_signal, sps: int = 1, method: str = "simple_energy",
                    device="cuda") -> Dict:
    """Symbol extraction with SPS-mode semantics from the reference contract.

    sps == 1 (RadioML 2018.01A mode): BYPASS -- no filtering, no timing
      recovery; every sample IS a symbol, so `filtered_i` equals the input
      exactly and the output length equals the input length.
    sps >= 2 (oversampled mode): RRC matched filter, then timing recovery via
      `method`, yielding ~n/sps symbols; the filter and the loops run on
      `device`.

    Returns dict with keys: symbol_i, symbol_q, symbol_indices,
    filtered_i, filtered_q.
    """
    i_sig = np.asarray(i_signal, dtype=np.float32)
    q_sig = np.asarray(q_signal, dtype=np.float32)
    if i_sig.shape != q_sig.shape or i_sig.ndim != 1:
        raise ValueError("i_signal and q_signal must be equal-length 1-D arrays")
    if sps < 1:
        raise ValueError(f"sps must be >= 1, got {sps}")

    if sps == 1:
        indices = np.arange(len(i_sig))
        return {
            "symbol_i": i_sig,
            "symbol_q": q_sig,
            "symbol_indices": indices,
            "filtered_i": i_sig,
            "filtered_q": q_sig,
        }

    if method not in _METHODS:
        raise ValueError(f"unknown timing-recovery method {method!r}; choose from {_METHODS}")

    filtered_i, filtered_q = matched_filter(i_sig, q_sig, sps=sps, device=device)
    if method == "simple_energy":
        indices = simple_timing_recovery(filtered_i, filtered_q, sps, method="energy")
    elif method == "simple_correlation":
        indices = simple_timing_recovery(filtered_i, filtered_q, sps, method="correlation")
    elif method == "gardner":
        indices = timing_recovery_gardner(filtered_i, filtered_q, sps, device=device)
    else:
        indices = timing_recovery_mueller_muller(filtered_i, filtered_q, sps, device=device)

    return {
        "symbol_i": filtered_i[indices],
        "symbol_q": filtered_q[indices],
        "symbol_indices": indices,
        "filtered_i": filtered_i,
        "filtered_q": filtered_q,
    }


# --------------------------------------------------------------------------
# normalization + model shaping (single frame, numpy)
# --------------------------------------------------------------------------

def apply_normalization(i_signal, q_signal, stats: Dict[str, float]):
    """Z-score I and Q with per-channel train-split stats."""
    i_norm = (np.asarray(i_signal) - stats["i_mean"]) / stats["i_std"]
    q_norm = (np.asarray(q_signal) - stats["q_mean"]) / stats["q_std"]
    return i_norm, q_norm


def preprocess_for_vit(i_signal, q_signal, stats: Dict[str, float], H: int = 32, W: int = 64):
    """normalize -> concat [I, Q] (2048) -> reshape [1, H, W]."""
    i_norm, q_norm = apply_normalization(i_signal, q_signal, stats)
    return np.concatenate([i_norm, q_norm]).reshape(1, H, W)


def preprocess_for_transformer(i_signal, q_signal, stats: Dict[str, float]):
    """normalize -> stack [2, L]."""
    i_norm, q_norm = apply_normalization(i_signal, q_signal, stats)
    return np.stack([i_norm, q_norm], axis=0)


# --------------------------------------------------------------------------
# batched device path
# --------------------------------------------------------------------------

Stats = Union[Mapping[str, float], Tuple[torch.Tensor, torch.Tensor]]


def zscore_constants(stats: Mapping[str, float], device,
                     dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The I and Q channels' (mean, std) from `stats` as [2] tensors on
    `device`. The host copy synchronizes the stream, which a CUDA graph's
    capture refuses, so a built front-end (`serve.build_preprocess`) makes
    them once and passes them to the batched functions in place of the
    dict."""
    return (torch.tensor([stats["i_mean"], stats["q_mean"]], dtype=dtype, device=device),
            torch.tensor([stats["i_std"], stats["q_std"]], dtype=dtype, device=device))


def _zscore(x: torch.Tensor, stats: Stats) -> torch.Tensor:
    mean, std = (zscore_constants(stats, x.device, x.dtype) if isinstance(stats, Mapping)
                 else stats)
    return (x - mean) / std


def preprocess_batch_vit(x: torch.Tensor, stats: Stats,
                         H: int = 32, W: int = 64) -> torch.Tensor:
    """[B, L, 2] raw frames -> [B, 1, H, W] images: the normalized I samples,
    then the Q samples (channel-major), viewed as one image. `stats` is the
    stats dict or its `zscore_constants`."""
    norm = _zscore(x, stats)
    flat = torch.cat([norm[..., 0], norm[..., 1]], dim=-1)  # [B, 2L]
    return flat.reshape(x.shape[0], 1, H, W)


def preprocess_batch_rawiq(x: torch.Tensor, stats: Stats) -> torch.Tensor:
    """[B, L, 2] raw frames -> [B, 2, L] normalized sequences (`stats` as in
    `preprocess_batch_vit`)."""
    return _zscore(x, stats).transpose(1, 2)


_HYBRID_LOGGED: set = set()


def _log_hybrid_engaged_once(method: str, window: int) -> None:
    """One notice per (method, window) that the hybrid loop's open-loop
    strobes replaced the full per-symbol feedback loop (timing_hybrid_window=0
    restores it: the default differs from the full loop on frames with
    intra-frame clock drift)."""
    key = (method, window)
    if key not in _HYBRID_LOGGED:
        _HYBRID_LOGGED.add(key)
        logging.getLogger("vitiq_torch.dsp").info(
            "timing recovery %r using HYBRID loop (window=%d); set "
            "timing_hybrid_window=0 for the full per-symbol feedback loop",
            method, window)


def preprocess_batch_sps(x: torch.Tensor, sps: int, alpha: float = 0.35, span: int = 8,
                         method: str = "simple_energy", hybrid_window: int = 64,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SPS-aware front-end on the device: [B, L, 2] -> [B, L//sps, 2].

    sps == 1: identity (the RadioML rule: every sample is a symbol).
    sps >= 2: RRC matched filter (one grouped convolution over the batch),
    then timing recovery by `method`:
      simple_energy / simple_correlation -- the best decimation phase a
        frame, picked by vector reductions;
      gardner / mueller_muller -- by default the hybrid loop (coarse energy
        phase, `hybrid_window` loop steps, uniform strobes:
        `dsp/timing.hybrid_positions`); hybrid_window=0 (or a window of at
        least L//sps) runs the full per-symbol loop. Strobes past the frame's
        end clamp to its last sample, so the shape stays [B, L//sps, 2].
    `weights` are the filter's `filtering.rrc_weights` where the caller made
    them once (a built front-end does), else they are made here.
    """
    if sps == 1:
        return x
    if method not in _METHODS:
        raise ValueError(f"unknown timing-recovery method {method!r}; choose from {_METHODS}")
    B, L, _ = x.shape
    if L % sps:
        raise ValueError(f"frame length {L} must be a multiple of sps ({sps})")
    filtered = matched_filter_batch(x, sps=sps, alpha=alpha, span=span, weights=weights)
    n_sym = L // sps

    if method in ("gardner", "mueller_muller"):
        if hybrid_window and hybrid_window < n_sym:
            _log_hybrid_engaged_once(method, hybrid_window)
            positions = hybrid_positions(filtered, sps, method, window=hybrid_window)
        else:
            positions, _valid = full_positions(filtered, sps, method)
        idx = positions.round().clamp(0, L - 1).long()
        return filtered.gather(1, idx[..., None].expand(B, n_sym, 2))

    phased = filtered.reshape(B, n_sym, sps, 2)
    if method == "simple_energy":
        score = (phased[..., 0] ** 2 + phased[..., 1] ** 2).sum(1)  # [B, sps]
    else:  # simple_correlation: symbol-to-symbol correlation per phase
        si, sq = phased[..., 0], phased[..., 1]
        score = (si[:, :-1] * si[:, 1:] + sq[:, :-1] * sq[:, 1:]).abs().mean(1)
    best = score.argmax(-1)  # [B]
    return phased.gather(2, best[:, None, None, None].expand(B, n_sym, 1, 2))[:, :, 0, :]


def preprocess_batch_spectrogram(x: torch.Tensor, nfft: int = 64, hop: int = 32,
                                 eps: float = 1e-10) -> torch.Tensor:
    """[B, L, 2] I/Q frames -> [B, 1, nfft, T] log-magnitude spectrogram
    images: complex STFT with a Hann window, the full two-sided spectrum
    fftshifted so DC is centered, log10 magnitude, each frame standardized
    (population std). T = (L - nfft)//hop + 1."""
    B, L, _ = x.shape
    if L < nfft:
        raise ValueError(f"frame length {L} must be >= nfft ({nfft})")
    sig = torch.complex(x[..., 0].float(), x[..., 1].float())
    T = (L - nfft) // hop + 1
    idx = (torch.arange(T, device=x.device) * hop)[:, None] + torch.arange(nfft,
                                                                         device=x.device)
    frames = sig[:, idx]  # [B, T, nfft]
    k = torch.arange(nfft, dtype=torch.float32, device=x.device)
    window = 0.5 * (1.0 - torch.cos(k * (2.0 * math.pi) / nfft))
    spec = torch.fft.fft(frames * window, dim=-1)
    mag = torch.log10(torch.fft.fftshift(spec, dim=-1).abs() + eps)
    img = mag.transpose(1, 2)  # [B, nfft (freq), T (time)]
    mean = img.mean(dim=(1, 2), keepdim=True)
    std = img.std(dim=(1, 2), keepdim=True, correction=0).clamp(min=1e-6)
    return ((img - mean) / std)[:, None].float()


def preprocess_batch_vit_spectrogram(x: torch.Tensor, H: int = 32, W: int = 64) -> torch.Tensor:
    """[B, L, 2] I/Q frames -> [B, 1, H, W] spectrogram images sized for the
    ViT patch grid (`DataConfig.features='spectrogram'`): nfft = H, a hop
    that yields at least W frames, the time axis center-cropped to W, or
    edge-padded where L is too short to give W frames at hop 1."""
    B, L, _ = x.shape
    if L < H:
        raise ValueError(f"frame length {L} must be >= nfft (= H = {H})")
    hop = max(1, (L - H) // max(1, W - 1))
    img = preprocess_batch_spectrogram(x, nfft=H, hop=hop)  # [B, 1, H, T]
    T = img.shape[-1]
    if T < W:
        img = F.pad(img, (0, W - T, 0, 0), mode="replicate")  # the time axis only
    elif T > W:
        start = (T - W) // 2
        img = img[..., start:start + W]
    return img


def preprocess_batch_mdf(x: torch.Tensor, H: int = 32, W: int = 32,
                         stats: Optional[Dict[str, float]] = None):
    """The MDF-NET dual-stream transform: [B, L, 2] raw frames ->
    (amplitude image [B, 1, H, W] over its max, phase image [B, 1, H, W] over
    pi, the I/Q sequence [B, L, 2]). With `stats` the I/Q channels are
    z-scored first; `stats['amp_max']`, where present, is the dataset-level
    amplitude scale, else each frame is scaled by its own max. L must equal
    H*W."""
    B, L, _ = x.shape
    if L != H * W:
        raise ValueError(f"frame length {L} must equal H*W = {H * W}")
    if stats is not None:
        x = torch.stack([(x[..., 0] - stats["i_mean"]) / stats["i_std"],
                         (x[..., 1] - stats["q_mean"]) / stats["q_std"]], dim=-1)
    i_sig, q_sig = x[..., 0], x[..., 1]
    amp = torch.sqrt(i_sig * i_sig + q_sig * q_sig)
    if stats is not None and "amp_max" in stats:
        amp_max = torch.full((), stats["amp_max"], dtype=amp.dtype, device=amp.device).clamp(
            min=1e-8)
    else:
        amp_max = amp.amax(dim=-1, keepdim=True).clamp(min=1e-8)
    amp_img = (amp / amp_max).reshape(B, 1, H, W)
    phase_img = (torch.atan2(q_sig, i_sig) / math.pi).reshape(B, 1, H, W)
    return amp_img, phase_img, x


def preprocess_batch_amplitude_phase(x: torch.Tensor) -> torch.Tensor:
    """[B, L, 2] raw frames -> [B, 2, L] (amplitude / its per-frame max,
    phase / pi) features for the rawIQ arm."""
    i_sig, q_sig = x[..., 0], x[..., 1]
    amp = torch.sqrt(i_sig * i_sig + q_sig * q_sig)
    amp_max = amp.amax(dim=-1, keepdim=True).clamp(min=1e-8)
    phase = torch.atan2(q_sig, i_sig) / math.pi
    return torch.stack([amp / amp_max, phase], dim=1)
