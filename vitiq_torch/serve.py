"""Serving: raw I/Q frames in, f32 logits out (counterpart of
`vitiq/serve.py: build_serving_fn`, `vitiq/runner.py:
build_forward_and_preprocess` and the bucket routing of `ServingArtifact`).

A `Server` holds a set of batch-size buckets and routes a ragged batch to the
smallest bucket that holds it: the batch is padded with zero frames and the
logits are sliced back. Frames are independent rows in the serving path, so
padding never changes a real row's result. Exported (`torch.export`)
artifacts are not part of this module yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from vitiq.config import ExperimentConfig
from vitiq_torch.dsp.frontend import preprocess_batch_rawiq, preprocess_batch_vit
from vitiq_torch.models.amc import AMCModel


def build_preprocess(cfg: ExperimentConfig, stats: Dict[str, float]) -> Callable:
    """The arm's front-end: raw [B, L, 2] -> model input. Only the I/Q
    features at one sample per symbol are ported."""
    if cfg.data.sps != 1 or cfg.data.features != "iq":
        raise NotImplementedError(
            f"the port serves iq features at sps=1 only (got features="
            f"{cfg.data.features!r}, sps={cfg.data.sps})")
    m = cfg.model
    if m.arm == "vit":
        return lambda x: preprocess_batch_vit(x, stats, H=m.img_size_h, W=m.img_size_w)
    return lambda x: preprocess_batch_rawiq(x, stats)


def build_serving_fn(cfg: ExperimentConfig, model: AMCModel, stats: Dict[str, float],
                     device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Raw [B, frame_len, 2] f32 frames -> [B, num_classes] f32 logits on
    `device`. Puts `model` on `device` in eval mode."""
    device = torch.device(device)
    pre = build_preprocess(cfg, stats)
    model.to(device).eval()

    @torch.no_grad()
    def serve(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return model(pre(x)).float()

    return serve


class Server:
    """Bucketed serving over a serving function."""

    def __init__(self, serve_fn: Callable[[torch.Tensor], torch.Tensor], frame_len: int,
                 batch_sizes: Sequence[int] = (256, 8192), device="cpu"):
        sizes = sorted(set(int(b) for b in batch_sizes))
        if not sizes or sizes[0] <= 0:
            raise ValueError(f"batch_sizes must be positive, got {list(batch_sizes)}")
        self.serve_fn = serve_fn
        self.frame_len = frame_len
        self.batch_sizes = sizes
        self.device = torch.device(device)

    def bucket(self, b: int) -> int:
        for cand in self.batch_sizes:
            if cand >= b:
                return cand
        raise ValueError(f"batch of {b} frames exceeds the largest bucket "
                         f"({self.batch_sizes[-1]})")

    def run(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.dim() != 3 or x.shape[1] != self.frame_len or x.shape[2] != 2:
            raise ValueError(f"expected [B, {self.frame_len}, 2] raw I/Q frames, "
                             f"got {tuple(x.shape)}")
        b = x.shape[0]
        bucket = self.bucket(b)
        if bucket != b:
            pad = torch.zeros((bucket - b, self.frame_len, 2), dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad])
        return self.serve_fn(x)[:b]

    def predict(self, x) -> torch.Tensor:
        return self.run(x).argmax(dim=-1)
