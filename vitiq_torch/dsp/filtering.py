"""Matched filtering (counterpart of `vitiq/dsp/filtering.py`).

Receiver-side RRC filtering of I/Q, the pair of the transmit pulse shaping
(`np.convolve(x, rrc, mode='same')` at the call sites). The batched filter is
one grouped 1-D convolution over the whole batch (identical taps on the I and
Q channels), in float32: cuDNN would run a float32 convolution in TF32 by
default (about three decimal digits), so it runs inside a scope that turns
TF32 off for that call only (`f32_conv`), leaving the global flag as it was.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vitiq_torch.dsp.taps import rrc_filter
from vitiq_torch.utils.device import resolve_device


def f32_conv():
    """A scope in which cuDNN convolutions run in full float32 (no TF32);
    cuDNN's other settings stay as they are."""
    if not torch.backends.cudnn.is_available():
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def rrc_weights(sps: int, alpha: float = 0.35, span: int = 8, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """The RRC matched filter's taps as `_fir_same`'s weights on `device`:
    flipped, since np.convolve is correlation with the flipped taps and
    conv1d correlates. The host copy synchronizes the stream, which a CUDA
    graph's capture refuses, so a built front-end (`serve.build_preprocess`)
    makes them once."""
    taps = rrc_filter(alpha=alpha, span=span, sps=sps).astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(taps[::-1]), dtype=dtype, device=device)


def _fir_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, C, L] -> [B, C, L]: each channel convolved with the taps whose
    flipped form is `w` ('same' mode, odd tap count), as np.convolve(x, taps,
    'same') per row."""
    k = w.shape[0]
    pad = (k - 1) // 2
    C = x.shape[1]
    with f32_conv():
        return F.conv1d(x, w.expand(C, 1, k), padding=pad, groups=C)


def matched_filter(i_signal, q_signal, sps: int = 2, alpha: float = 0.35, span: int = 8,
                   device="cuda"):
    """RRC matched filter over an I/Q pair; 'same'-mode convolution so sample
    indices stay aligned with the input (symbol peaks keep their positions).

    Returns (filtered_i, filtered_q) as float32 numpy arrays of the input
    length, computed on `device`."""
    device = resolve_device(device)
    iq = torch.as_tensor(np.stack([np.asarray(i_signal, np.float32),
                                   np.asarray(q_signal, np.float32)]), device=device)
    out = _fir_same(iq[None], rrc_weights(sps, alpha, span, device))[0].cpu().numpy()
    return out[0], out[1]


def matched_filter_batch(x: torch.Tensor, sps: int, alpha: float = 0.35, span: int = 8,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched matched filter: x [B, L, 2] -> [B, L, 2] (contiguous), one
    grouped convolution over the batch on x's device; `weights` are its
    `rrc_weights` where the caller made them once, else they are made
    here."""
    w = rrc_weights(sps, alpha, span, x.device, x.dtype) if weights is None else weights
    return _fir_same(x.transpose(1, 2), w).transpose(1, 2).contiguous()
