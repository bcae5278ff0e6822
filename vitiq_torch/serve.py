"""Serving: raw I/Q frames in, f32 logits out (counterpart of
`vitiq/serve.py: build_serving_fn`, `vitiq/runner.py:
build_forward_and_preprocess` and the bucket routing of `ServingArtifact`).

A `Server` holds a set of batch-size buckets and routes a ragged batch to the
smallest bucket that holds it: the batch is padded with zero frames and the
logits are sliced back. Frames are independent rows in the serving path, so
padding never changes a real row's result. Exported (`torch.export`)
artifacts are not part of this module yet.

The entry points run on the card: `build_forward_and_preprocess` and
`Server` take ``device="cuda"`` unless the caller passes another device
(``device="cpu"`` for a run on the host, as the CPU tests do), and
`build_serving_fn` takes its device as a required argument. Asking for the
card where CUDA is absent raises; nothing falls back to the CPU.
`build_int8_serving_fn` serves the int8 W8A8 twin of a model (K6 and K2 on
the card). Every one of them takes the experiment's front-end
(`build_preprocess`): the SPS front-end at ``data.sps >= 2`` and the arm's
features.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import torch

from vitiq_torch.config import ExperimentConfig, ModelConfig
from vitiq_torch.dsp.frontend import (
    preprocess_batch_amplitude_phase,
    preprocess_batch_rawiq,
    preprocess_batch_sps,
    preprocess_batch_vit,
    preprocess_batch_vit_spectrogram,
)
from vitiq_torch.models.amc import AMCModel
from vitiq_torch.models.raw_embed import fused_raw_embed_enabled
from vitiq_torch.utils.device import resolve_device


def build_preprocess(cfg: ExperimentConfig, stats: Dict[str, float]) -> Callable:
    """The front-end matching the experiment: raw [B, L, 2] -> model input.

    With ``data.sps >= 2`` the SPS front-end runs first (RRC matched filter,
    then timing recovery by ``data.timing_method``: L samples to L/sps
    symbols, the error-feedback loops one kernel launch on the card), and the
    arm's features are taken from the symbol stream. The normalization stats
    are the raw frames': the RRC taps have unit energy, so the symbol instants
    keep their scale. Features: 'iq' (both arms), 'spectrogram' (the ViT arm:
    STFT images), 'amp_phase' (the rawIQ arm: amplitude and phase); any other
    raises ValueError, as in the JAX package."""
    arm_pre = _build_arm_preprocess(cfg, stats)
    if cfg.data.sps <= 1:
        return arm_pre
    sps, method = cfg.data.sps, cfg.data.timing_method
    hyb = cfg.data.timing_hybrid_window
    return lambda x: arm_pre(preprocess_batch_sps(x, sps, method=method, hybrid_window=hyb))


def _build_arm_preprocess(cfg: ExperimentConfig, stats: Dict[str, float]) -> Callable:
    m, features = cfg.model, cfg.data.features
    if m.arm == "vit":
        if features == "spectrogram":
            return lambda x: preprocess_batch_vit_spectrogram(x, H=m.img_size_h, W=m.img_size_w)
        if features != "iq":
            raise ValueError(f"features={features!r} is not valid for the vit arm "
                             "(use 'iq' or 'spectrogram')")
        return lambda x: preprocess_batch_vit(x, stats, H=m.img_size_h, W=m.img_size_w)
    if features == "amp_phase":
        return preprocess_batch_amplitude_phase
    if features != "iq":
        raise ValueError(f"features={features!r} is not valid for the rawiq arm "
                         "(use 'iq' or 'amp_phase')")
    return lambda x: preprocess_batch_rawiq(x, stats)


def build_forward_and_preprocess(cfg: ExperimentConfig, model_or_cfg: Union[AMCModel, ModelConfig],
                                 stats: Dict[str, float],
                                 device="cuda") -> Tuple[AMCModel, Callable]:
    """(model, preprocess) for the experiment, the model on `device`. Where
    the fused raw embedding applies (iq features at sps 1 and
    `fused_raw_embed_enabled`), the model takes raw [B, L, 2] frames through
    it and preprocess is the identity; otherwise the model takes
    `build_preprocess`'s output. Given a model, sets its `raw_stats`
    accordingly, moves it to `device` and returns it; given a config, builds
    the model there."""
    device = resolve_device(device)
    fused = (cfg.data.sps <= 1 and cfg.data.features == "iq"
             and fused_raw_embed_enabled(cfg.model))
    raw_stats = dict(stats) if fused else None
    if isinstance(model_or_cfg, AMCModel):
        model = model_or_cfg.to(device)
        model.raw_stats = raw_stats
    else:
        model = AMCModel(model_or_cfg, device=device, raw_stats=raw_stats)
    return model, ((lambda x: x) if fused else build_preprocess(cfg, stats))


def build_serving_fn(cfg: ExperimentConfig, model: AMCModel, stats: Dict[str, float],
                     device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Raw [B, frame_len, 2] f32 frames -> [B, num_classes] f32 logits on
    `device`, through `build_forward_and_preprocess`. Puts `model` on
    `device` in eval mode."""
    device = resolve_device(device)
    model, pre = build_forward_and_preprocess(cfg, model, stats, device)
    model.eval()

    @torch.no_grad()
    def serve(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return model(pre(x)).float()

    return serve


def build_int8_serving_fn(cfg: ExperimentConfig, model: AMCModel, stats: Dict[str, float],
                          device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Raw frames -> f32 logits through the int8 W8A8 twin of `model`
    (`ops.quant.QuantizedAMCModel`, quantized from its current weights):
    the arm's preprocess (the quantized path is not raw-aware), then on a
    CUDA device K6 on every full layer and K2 on the CLS row."""
    from vitiq_torch.ops.quant import QuantizedAMCModel

    device = resolve_device(device)
    qmodel = QuantizedAMCModel.from_model(model.to(device))
    pre = build_preprocess(cfg, stats)

    def serve(x) -> torch.Tensor:
        return qmodel(pre(torch.as_tensor(x, dtype=torch.float32, device=device)))

    return serve


class Server:
    """Bucketed serving over a serving function; requests are padded on
    `device` (the serving function's)."""

    def __init__(self, serve_fn: Callable[[torch.Tensor], torch.Tensor], frame_len: int,
                 batch_sizes: Sequence[int] = (256, 8192), device="cuda"):
        sizes = sorted(set(int(b) for b in batch_sizes))
        if not sizes or sizes[0] <= 0:
            raise ValueError(f"batch_sizes must be positive, got {list(batch_sizes)}")
        self.serve_fn = serve_fn
        self.frame_len = frame_len
        self.batch_sizes = sizes
        self.device = resolve_device(device)

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
