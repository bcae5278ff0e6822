"""Batched front-end on the device (counterpart of the batched part of
`vitiq/dsp/frontend.py`): per-channel z-score of raw [B, L, 2] frames, then
the arm's input shape."""

from __future__ import annotations

from typing import Dict

import torch


def _zscore(x: torch.Tensor, stats: Dict[str, float]) -> torch.Tensor:
    mean = torch.tensor([stats["i_mean"], stats["q_mean"]], dtype=x.dtype, device=x.device)
    std = torch.tensor([stats["i_std"], stats["q_std"]], dtype=x.dtype, device=x.device)
    return (x - mean) / std


def preprocess_batch_vit(x: torch.Tensor, stats: Dict[str, float],
                         H: int = 32, W: int = 64) -> torch.Tensor:
    """[B, L, 2] raw frames -> [B, 1, H, W] images: the normalized I samples,
    then the Q samples (channel-major), viewed as one image."""
    norm = _zscore(x, stats)
    flat = torch.cat([norm[..., 0], norm[..., 1]], dim=-1)  # [B, 2L]
    return flat.reshape(x.shape[0], 1, H, W)


def preprocess_batch_rawiq(x: torch.Tensor, stats: Dict[str, float]) -> torch.Tensor:
    """[B, L, 2] raw frames -> [B, 2, L] normalized sequences."""
    return _zscore(x, stats).transpose(1, 2)
