"""Streaming wideband inference (counterpart of `vitiq/streaming.py`): the
polyphase channelizer, then the classifier on every channel's frame.

A 64-channel polyphase channelizer splits a wideband complex stream into
per-channel baseband I/Q; every channel's frame is z-scored and shaped for
the arm and classified by the model, on one device, so the wideband samples
never leave it between stages. On the card the classifier runs its fused
kernels (K1 on every full layer, K2 on the CLS row).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from vitiq_torch.config import ModelConfig
from vitiq_torch.dsp.channelizer import design_prototype_lowpass, polyphase_channelize
from vitiq_torch.dsp.frontend import (
    preprocess_batch_rawiq,
    preprocess_batch_vit,
    zscore_constants,
)
from vitiq_torch.models.amc import AMCModel
from vitiq_torch.utils.device import resolve_device


def make_streaming_classifier(cfg: ModelConfig, model: AMCModel, stats: Dict[str, float],
                              num_channels: int = 64, taps_per_phase: int = 8,
                              device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(wideband [B, N] complex64) -> logits [B, num_channels, num_classes]
    f32 on `device`. Puts `model` on `device` in eval mode; it takes the
    arm's preprocessed input (no raw-frame embedding).

    N must equal num_channels * frame_len so each channel yields exactly one
    model frame per call (streaming callers invoke once per frame window).
    """
    device = resolve_device(device)
    frame_len = cfg.seq_length
    # the taps and the z-score constants go to the device once, here: a
    # call copies nothing from the host, so it can be captured in a graph
    taps = torch.as_tensor(design_prototype_lowpass(num_channels, taps_per_phase),
                           dtype=torch.float32, device=device)
    stats = zscore_constants(stats, device)
    if cfg.arm == "vit":
        pre = lambda x: preprocess_batch_vit(x, stats, H=cfg.img_size_h, W=cfg.img_size_w)
    else:
        pre = lambda x: preprocess_batch_rawiq(x, stats)
    model = model.to(device).eval()
    model.raw_stats = None

    @torch.no_grad()
    def classify(wideband) -> torch.Tensor:
        w = torch.as_tensor(wideband, device=device).to(torch.complex64)
        B, N = w.shape
        if N != num_channels * frame_len:
            raise ValueError(
                f"stream window must be num_channels*frame_len = "
                f"{num_channels * frame_len} samples, got {N}")
        chans = polyphase_channelize(w, num_channels, taps)  # [B, K, L]
        frames = torch.stack([chans.real, chans.imag], dim=-1)  # [B, K, L, 2]
        flat = frames.reshape(B * num_channels, frame_len, 2)
        return model(pre(flat)).float().reshape(B, num_channels, -1)

    return classify


def demo_streaming(num_channels: int = 64, batch: int = 1, numerics: str = "tpu",
                   seed: int = 0, device="cuda") -> Dict:
    """Self-contained demo: the flagship rawIQ classifier (random weights
    from `seed`) over a synthetic multitone wideband. Returns the logits'
    shape and each channel's argmax."""
    from vitiq_torch.dsp.channelizer import synthesize_multitone

    cfg = ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8, n_layers=6,
                      ffn_hidden=1024, segment_size=16, numerics=numerics)
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(seed))
    stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
    classify = make_streaming_classifier(cfg, model, stats, num_channels, device=device)
    wideband = np.concatenate([
        synthesize_multitone(num_channels, cfg.seq_length, active=((3, 1.0), (17, 0.5)),
                             seed=seed + i)
        for i in range(batch)])
    logits = classify(wideband)
    return {"logits_shape": tuple(logits.shape),
            "per_channel_pred": logits.argmax(-1).cpu().numpy()}
