"""Serving: raw I/Q frames in, f32 logits out (counterpart of
`vitiq/serve.py` and of `vitiq/runner.py: build_forward_and_preprocess`).

A `Server` holds a set of batch-size buckets and routes a ragged batch to the
smallest bucket that holds it: the batch is padded with zero frames and the
logits are sliced back. Frames are independent rows in the serving path, so
padding never changes a real row's result.

The entry points run on the card: `build_forward_and_preprocess`, `Server`
and `ServingArtifact.load` take ``device="cuda"`` unless the caller passes
another device (``device="cpu"`` for a run on the host, as the CPU tests
do), and `build_serving_fn` takes its device as a required argument. Asking
for the card where CUDA is absent raises; nothing falls back to the CPU.
`build_int8_serving_fn` serves the int8 W8A8 twin of a model (K6 and K2 on
the card). Every one of them takes the experiment's front-end
(`build_preprocess`): the SPS front-end at ``data.sps >= 2`` and the arm's
features.

The serving artifact (`export_serving`, `export_from_experiment`, `cli
export`) is the deployment unit: a directory of

    manifest.json   format "vitiq-torch-serving/1", arm, num_classes,
                    frame_len, input_spec, batch_sizes, platforms, entries
    config.json     the full ExperimentConfig
    stats.json      the normalization stats
    params.npz      the weights in `train/checkpoint.py: save_params`'
                    layout (vitiq's parameter files; vitiq reads it too)

vitiq's artifact holds one StableHLO program a bucket (`jax.export`) and runs
without vitiq's model code. This one holds no compiled program:
`torch.export` cannot trace the kernels, which are ctypes calls into the
library `ops/cuda/_build.py` builds, so the artifact needs `vitiq_torch` to
load. `ServingArtifact.load` rebuilds the serving function
(`build_serving_fn`) and, on the card, captures it as one CUDA graph a
bucket, the card's counterpart of a compiled program a bucket: warmed up on
a side stream (the kernel library builds at first use and each layer's
kernel operands are cached on it then), then captured largest bucket first,
every bucket's graph in one memory pool, each with a static input buffer of
its own. A graph holds the addresses of what it reads, the TMA maps among
them (kernel parameters), so the artifact keeps its model, the cached kernel
operands and the buffers alive and unmoved: its weights are frozen. On the
CPU the same function runs eagerly. Host-side launch counters do not tick
on a replay; `captured_launches[b]` keeps each bucket's counts from its
capture.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from vitiq_torch.config import ExperimentConfig, ModelConfig
from vitiq_torch.dsp.filtering import rrc_weights
from vitiq_torch.dsp.frontend import (
    preprocess_batch_amplitude_phase,
    preprocess_batch_rawiq,
    preprocess_batch_sps,
    preprocess_batch_vit,
    preprocess_batch_vit_spectrogram,
    zscore_constants,
)
from vitiq_torch.models.amc import AMCModel
from vitiq_torch.models.raw_embed import fused_raw_embed_enabled
from vitiq_torch.ops.cuda import flash_attention as fa
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7
from vitiq_torch.ops.cuda import timing as tk
from vitiq_torch.train.checkpoint import load_params, save_params
from vitiq_torch.utils.device import resolve_device


def build_preprocess(cfg: ExperimentConfig, stats: Dict[str, float],
                     device=None) -> Callable:
    """The front-end matching the experiment: raw [B, L, 2] -> model input.

    With ``data.sps >= 2`` the SPS front-end runs first (RRC matched filter,
    then timing recovery by ``data.timing_method``: L samples to L/sps
    symbols, the error-feedback loops one kernel launch on the card), and the
    arm's features are taken from the symbol stream. The normalization stats
    are the raw frames': the RRC taps have unit energy, so the symbol instants
    keep their scale. Features: 'iq' (both arms), 'spectrogram' (the ViT arm:
    STFT images), 'amp_phase' (the rawIQ arm: amplitude and phase); any other
    raises ValueError, as in the JAX package.

    With a `device`, the z-score stats and the RRC taps are put there once,
    here: each call then copies nothing from the host (a host copy
    synchronizes the stream, which a CUDA graph's capture refuses). Without
    one, each call makes them on its frames' device."""
    arm_pre = _build_arm_preprocess(cfg, stats, device)
    if cfg.data.sps <= 1:
        return arm_pre
    sps, method = cfg.data.sps, cfg.data.timing_method
    hyb = cfg.data.timing_hybrid_window
    weights = None if device is None else rrc_weights(sps, device=resolve_device(device))
    return lambda x: arm_pre(preprocess_batch_sps(x, sps, method=method, hybrid_window=hyb,
                                                  weights=weights))


def _build_arm_preprocess(cfg: ExperimentConfig, stats: Dict[str, float],
                          device) -> Callable:
    m, features = cfg.model, cfg.data.features
    if features == "iq" and device is not None:
        stats = zscore_constants(stats, resolve_device(device))
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
    return model, ((lambda x: x) if fused else build_preprocess(cfg, stats, device))


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
    pre = build_preprocess(cfg, stats, device)

    def serve(x) -> torch.Tensor:
        return qmodel(pre(torch.as_tensor(x, dtype=torch.float32, device=device)))

    return serve


def bucket_sizes(batch_sizes: Sequence[int]) -> list:
    """The distinct batch buckets, ascending; raises unless all are positive."""
    sizes = sorted(set(int(b) for b in batch_sizes))
    if not sizes or sizes[0] <= 0:
        raise ValueError(f"batch_sizes must be positive, got {list(batch_sizes)}")
    return sizes


class Server:
    """Bucketed serving over a serving function; requests are padded on
    `device` (the serving function's)."""

    def __init__(self, serve_fn: Callable[[torch.Tensor], torch.Tensor], frame_len: int,
                 batch_sizes: Sequence[int] = (256, 8192), device="cuda"):
        self.serve_fn = serve_fn
        self.frame_len = frame_len
        self.batch_sizes = bucket_sizes(batch_sizes)
        self.device = resolve_device(device)

    def bucket(self, b: int) -> int:
        for cand in self.batch_sizes:
            if cand >= b:
                return cand
        raise ValueError(f"batch of {b} frames exceeds the largest bucket "
                         f"({self.batch_sizes[-1]})")

    def frames(self, x) -> torch.Tensor:
        """x as f32 frames on the server's device; raises unless [B,
        frame_len, 2]."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.dim() != 3 or x.shape[1] != self.frame_len or x.shape[2] != 2:
            raise ValueError(f"expected [B, {self.frame_len}, 2] raw I/Q frames, "
                             f"got {tuple(x.shape)}")
        return x

    def run(self, x) -> torch.Tensor:
        x = self.frames(x)
        b = x.shape[0]
        bucket = self.bucket(b)
        if bucket != b:
            pad = torch.zeros((bucket - b, self.frame_len, 2), dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad])
        return self.serve_fn(x)[:b]

    def predict(self, x) -> torch.Tensor:
        return self.run(x).argmax(dim=-1)


FORMAT = "vitiq-torch-serving/1"
VITIQ_FORMAT = "vitiq-serving/1"  # vitiq's artifact: StableHLO programs
PLATFORMS = ("cuda", "cpu")
PARAMS_FILE = "params.npz"
# eager calls a bucket on the side stream before its capture
WARMUP_CALLS = 2


def _launch_counts() -> Dict[str, int]:
    """The host-side launch counters of the wrappers a float serving function
    can reach (K1/K2, K7, K5, the timing scan)."""
    return {**fel.launches, **k7.launches, **fa.launches, **tk.launches}


def export_serving(
    cfg: ExperimentConfig,
    model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
    stats: Dict[str, float],
    path,
    batch_sizes: Sequence[int] = (256, 8192),
    platforms: Optional[Sequence[str]] = None,
) -> Path:
    """Write the serving artifact of `cfg` with a model's weights (a module
    or its state dict) and `stats` into the directory `path`; returns it.
    `platforms` lists the devices it may load on, from PLATFORMS (default
    ``["cuda"]``, the card): vitiq's ``tpu`` raises."""
    out = Path(path)
    sizes = bucket_sizes(batch_sizes)
    platforms = ["cuda"] if platforms is None else list(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be among {PLATFORMS}, got {platforms}; a TPU "
                         "artifact is vitiq's (vitiq.serve.export_serving)")
    state_dict = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
                  else model_or_state_dict)
    out.mkdir(parents=True, exist_ok=True)
    params = save_params(out / PARAMS_FILE, state_dict, cfg.model)
    size = params.stat().st_size
    frame_len = cfg.data.frame_len
    manifest = {
        "format": FORMAT,
        "arm": cfg.model.arm,
        "num_classes": cfg.model.num_classes,
        "frame_len": frame_len,
        "input_spec": [None, frame_len, 2],
        "batch_sizes": sizes,
        "platforms": platforms,
        # no program a bucket: every bucket serves the one weights file
        "entries": {str(b): {"file": PARAMS_FILE, "bytes": size} for b in sizes},
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    (out / "config.json").write_text(cfg.to_json())
    (out / "stats.json").write_text(json.dumps(stats, indent=2))
    return out


class ServingArtifact:
    """A loaded serving artifact. `run(x)` routes a [B, frame_len, 2] batch
    to the smallest bucket >= B (`Server.bucket`): on the card it copies x
    into the bucket's static input, zeroes the buffer's other rows, replays
    the bucket's graph and returns a copy of the logits of its B rows (the
    graph's output buffer changes at the next replay); on the CPU it runs
    `Server.run`. `predict(x)` returns the argmax class indices as a numpy
    array."""

    def __init__(self, manifest: Dict, root: Path, server: Server):
        self.manifest = manifest
        self.root = root
        self._server = server
        self.device = server.device
        self._graphs: Dict[int, Tuple[torch.Tensor, torch.Tensor, "torch.cuda.CUDAGraph"]] = {}
        self.captured_launches: Dict[int, Dict[str, int]] = {}

    @classmethod
    def load(cls, path, device="cuda") -> "ServingArtifact":
        """Load the artifact at `path` on `device` (the card unless the
        caller asks for the CPU); on the card, capture one CUDA graph a
        bucket. A capture that fails raises. Raises ValueError for a
        directory that is not this package's artifact (vitiq's among them)
        or a device its manifest does not list."""
        root = Path(path)
        manifest = json.loads((root / "manifest.json").read_text())
        fmt = manifest.get("format")
        if fmt == VITIQ_FORMAT:
            raise ValueError(
                f"{root} is vitiq's serving artifact ({VITIQ_FORMAT!r}): it holds StableHLO "
                "programs, which the port cannot run; export the experiment directory with "
                "vitiq_torch.serve.export_from_experiment for the port's artifact")
        if fmt != FORMAT:
            raise ValueError(f"{root} is not a vitiq_torch serving artifact "
                             f"(format={fmt!r}, expected {FORMAT!r})")
        device = resolve_device(device)
        if device.type not in manifest["platforms"]:
            raise ValueError(f"{root} was exported for {manifest['platforms']}, not {device.type}")
        cfg = ExperimentConfig.from_json(str(root / "config.json"))
        stats = json.loads((root / "stats.json").read_text())
        model = AMCModel(cfg.model)
        model.load_state_dict(load_params(root / PARAMS_FILE, cfg.model))
        serve = build_serving_fn(cfg, model, stats, device)
        art = cls(manifest, root, Server(serve, manifest["frame_len"],
                                         manifest["batch_sizes"], device))
        if device.type == "cuda":
            art._capture()
        return art

    def _capture(self) -> None:
        serve, dev = self._server.serve_fn, self.device
        sizes = sorted(self.batch_sizes, reverse=True)
        inputs = {b: torch.zeros((b, self._server.frame_len, 2), device=dev) for b in sizes}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for b in sizes:
                for _ in range(WARMUP_CALLS):
                    serve(inputs[b])
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for b in sizes:
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with torch.cuda.graph(graph, pool=pool):
                out = serve(inputs[b])
            self.captured_launches[b] = {k: v - before[k] for k, v in _launch_counts().items()
                                         if v != before[k]}
            self._graphs[b] = (inputs[b], out, graph)

    @property
    def batch_sizes(self) -> list:
        return list(self._server.batch_sizes)

    def bucket(self, b: int) -> int:
        """The bucket a batch of b frames runs in (`Server.bucket`)."""
        return self._server.bucket(b)

    @property
    def config(self) -> ExperimentConfig:
        return ExperimentConfig.from_json(str(self.root / "config.json"))

    def run(self, x) -> torch.Tensor:
        if not self._graphs:
            return self._server.run(x)
        x = self._server.frames(x)
        b = x.shape[0]
        static, out, graph = self._graphs[self.bucket(b)]
        static[:b].copy_(x)
        static[b:].zero_()
        graph.replay()
        return out[:b].clone()

    def predict(self, x) -> np.ndarray:
        return self.run(x).argmax(dim=-1).cpu().numpy()


def export_from_experiment(
    experiment_dir,
    path,
    batch_sizes: Sequence[int] = (256, 8192),
    platforms: Optional[Sequence[str]] = None,
    checkpoint: str = "model_best.npz",
) -> Path:
    """The artifact of a training-run directory written by either package
    (config.json, normalization_stats.json, the weights `checkpoint`). Only
    the default checkpoint falls back to model_final.npz where it is absent
    (an interrupted run); an explicit checkpoint that is missing raises
    FileNotFoundError rather than export other weights."""
    exp = Path(experiment_dir)
    cfg = ExperimentConfig.from_json(str(exp / "config.json"))
    stats = json.loads((exp / "normalization_stats.json").read_text())
    ckpt = exp / checkpoint
    if not ckpt.exists():
        if checkpoint != "model_best.npz":
            raise FileNotFoundError(f"checkpoint not found: {ckpt}")
        ckpt = exp / "model_final.npz"
    return export_serving(cfg, load_params(ckpt, cfg.model), stats, path,
                          batch_sizes=batch_sizes, platforms=platforms)
