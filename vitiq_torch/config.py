"""Configuration tree: the port's own copy of `vitiq/config.py` (the JAX
package's dataclasses, validation, JSON round-trip, CLI overlay and reference
presets), plus the flagship geometries of `vitiq/bench.py`.

The port imports nothing of `vitiq`, so the dataclasses are copied here field
for field, default for default; `tests/test_torch_config.py` holds the copy
to the original. Defaults reproduce the reference defaults exactly,
including the 19-modulation target list, split seeds 42/49, AdamW betas
(0.9, 0.99), ReduceLROnPlateau(factor=0.5, patience=5) and early-stop
patience 10.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

# The 19 digital modulation classes trained in the reference
# (ref: ViT/training/train.py:60-80).
TARGET_MODULATIONS_19: Tuple[str, ...] = (
    "OOK", "4ASK", "8ASK", "BPSK", "QPSK", "8PSK", "16PSK", "32PSK",
    "16APSK", "32APSK", "64APSK", "128APSK", "16QAM", "32QAM", "64QAM",
    "128QAM", "256QAM", "GMSK", "OQPSK",
)

# Full 24-class RadioML 2018.01A list (the eval CLI's fallback default,
# ref: ViT/training/evaluate.py:69-74).
TARGET_MODULATIONS_24: Tuple[str, ...] = (
    "OOK", "4ASK", "8ASK", "BPSK", "QPSK", "8PSK", "16PSK", "32PSK",
    "16APSK", "32APSK", "64APSK", "128APSK", "16QAM", "32QAM", "64QAM",
    "128QAM", "256QAM", "AM-SSB-WC", "AM-SSB-SC", "AM-DSB-WC", "AM-DSB-SC",
    "FM", "GMSK", "OQPSK",
)

# RadioML 2016.10a's 11-class task (BASELINE.json config 2), expressed in
# this generator's class names: AM-DSB -> AM-DSB-WC, AM-SSB -> AM-SSB-WC,
# PAM4 -> 4ASK (same 4-level line code), QAM16/QAM64 -> 16QAM/64QAM,
# WBFM -> FM.
RADIOML_2016_CLASSES: Tuple[str, ...] = (
    "8PSK", "AM-DSB-WC", "AM-SSB-WC", "BPSK", "CPFSK", "GFSK", "4ASK",
    "16QAM", "64QAM", "QPSK", "FM",
)


@dataclass
class ModelConfig:
    """Architecture of one arm.

    arm='vit'   : [B, 1, 32, 64] image -> Conv-patchify -> CLS encoder -> Linear head
                  (ref: ViT/models/amc_transformer.py:5-31)
    arm='rawiq' : [B, 2, 1024] sequence -> conv1d|segment tokens -> encoder ->
                  CLS or mean-pool -> LayerNorm+Linear head
                  (ref: transformer_rawIQ/models/transformer_rawIQ.py:7-97)
    """

    arm: str = "vit"  # 'vit' | 'rawiq'
    num_classes: int = 19
    d_model: int = 128
    n_head: int = 8
    n_layers: int = 6
    ffn_hidden: int = 512  # reference ViT default: D_MODEL * 4 (train.py:88)
    drop_prob: float = 0.1

    # ViT arm uses 1-channel [1, 32, 64] images; rawIQ uses 2 I/Q channels.
    # 0 means "derive from arm" (1 for vit, 2 for rawiq).
    in_channels: int = 0
    img_size_h: int = 32
    img_size_w: int = 64
    patch_size: int = 4

    # raw-IQ arm
    seq_length: int = 1024
    embedding_type: str = "segment"  # 'conv1d' | 'segment'
    segment_size: int = 16
    use_cls_token: bool = True

    # Numerics preset: 'reference' = f32, exact reference semantics (post-norm,
    # LN eps=1e-12 biased var, ReLU FFN, -10000 mask fill); 'tpu' = bf16 matmul
    # compute with f32 params/softmax/LN and the Pallas fused-attention path.
    numerics: str = "reference"

    def __post_init__(self):
        if self.in_channels == 0:
            self.in_channels = 1 if self.arm == "vit" else 2

    @property
    def num_tokens(self) -> int:
        """Sequence length seen by the encoder, including the CLS token."""
        if self.arm == "vit":
            n = (self.img_size_h // self.patch_size) * (self.img_size_w // self.patch_size)
            return n + 1
        if self.embedding_type == "conv1d":
            n = self.seq_length
        else:
            n = self.seq_length // self.segment_size
        return n + (1 if self.use_cls_token else 0)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    def validate(self) -> None:
        errors = []
        if self.arm not in ("vit", "rawiq"):
            errors.append(f"arm must be 'vit' or 'rawiq', got {self.arm!r}")
        if self.d_model % self.n_head != 0:
            errors.append(f"d_model ({self.d_model}) must be divisible by n_head ({self.n_head})")
        if self.arm == "vit":
            if self.img_size_h % self.patch_size or self.img_size_w % self.patch_size:
                errors.append(
                    f"img size ({self.img_size_h}x{self.img_size_w}) must be divisible "
                    f"by patch_size ({self.patch_size})"
                )
        else:
            if self.embedding_type not in ("conv1d", "segment"):
                errors.append(f"embedding_type must be 'conv1d' or 'segment', got {self.embedding_type!r}")
            if self.embedding_type == "segment" and self.seq_length % self.segment_size:
                errors.append(
                    f"seq_length ({self.seq_length}) must be divisible by "
                    f"segment_size ({self.segment_size})"
                )
        if self.numerics not in ("reference", "tpu"):
            errors.append(f"numerics must be 'reference' or 'tpu', got {self.numerics!r}")
        for name in ("num_classes", "d_model", "n_head", "n_layers", "ffn_hidden"):
            if getattr(self, name) <= 0:
                errors.append(f"{name} must be positive")
        if not 0.0 <= self.drop_prob < 1.0:
            errors.append(f"drop_prob must be in [0, 1), got {self.drop_prob}")
        if errors:
            raise ValueError("ModelConfig validation failed:\n" + "\n".join(f"  - {e}" for e in errors))


@dataclass
class DataConfig:
    """Dataset location, split and normalization parameters.

    Split is 70/15/15, stratified jointly by (modulation x SNR) with
    SPLIT_SEED=42; normalization stats come from a NORM_SEED=49 seeded
    5000-sample subset of the train split (ref: ViT/dataloader/utils.py:58-148,
    ViT/dataloader/dataset.py:116-158).
    """

    source: str = "synthetic"  # 'synthetic' | 'hdf5'
    # out-of-core training: stream every split from storage via windowed
    # sequential reads (HDF5DataSource.batch_stream) instead of
    # materializing it in RAM — REQUIRED for the real 19-class RadioML
    # train split (~19 GB of f32 frames). RSS is bounded by
    # stream_window_rows frames (~8 MB/1k rows at L=1024).
    streaming: bool = False
    stream_window_rows: int = 16384
    # SPS-mode front-end (BASELINE config 3): sps=1 is the RadioML bypass
    # rule (every sample is a symbol, ref: test_sps_modes.py:103-127);
    # sps>=2 runs RRC matched filter + timing recovery INSIDE the jitted
    # step, decimating frames to frame_len/sps symbols before the
    # classifier. timing_method in {simple_energy, simple_correlation,
    # gardner, mueller_muller} (ref: test_dsp_functions.py:117-156).
    sps: int = 1
    timing_method: str = "gardner"
    # gardner/mueller_muller batched path: hybrid tracking-window length
    # (coarse energy phase + short feedback window + uniform strobes —
    # vitiq/dsp/timing.py hybrid_timing_positions). 0 = full per-symbol
    # feedback loop (needed when intra-frame clock drift ~ 1 sample).
    timing_hybrid_window: int = 64
    # input features: 'iq' (reference behavior for both arms), 'amp_phase'
    # (rawiq arm — the MDF-NET dual-domain transform, vitiq extension), or
    # 'spectrogram' (vit arm — STFT-image patchification, BASELINE config 2)
    features: str = "iq"
    file_path: str = ""
    json_path: str = ""
    target_modulations: Tuple[str, ...] = TARGET_MODULATIONS_19
    train_size: float = 0.7
    valid_size: float = 0.15
    test_size: float = 0.15
    split_seed: int = 42
    norm_seed: int = 49
    norm_sample_count: int = 5000
    # synthetic source parameters
    synthetic_classes: Tuple[str, ...] = ("BPSK", "QPSK", "16QAM")
    synthetic_frames_per_class: int = 2048
    synthetic_frame_len: int = 1024
    synthetic_snr_db: Tuple[float, ...] = (-8.0, 0.0, 8.0, 20.0)
    synthetic_seed: int = 0
    # 1 = iid symbols (RadioML sps=1 rule); >=2 = RRC-shaped oversampled
    # constellation frames for SPS-mode experiments
    synthetic_shaping_sps: int = 1
    # 2018.01A-style channel impairments for the synthetic corpus: RRC
    # pulse shaping at ~8 samples/symbol + CFO + sample-clock offset +
    # Rician selective fading, captured back at 1 sample/symbol
    # (vitiq.data.synthetic.ChannelModel). synthetic_channel turns the
    # chain on; synthetic_channel_params overrides ChannelModel fields
    # (e.g. {"fading": false, "cfo_max": 0}) for the impairment-ablation
    # ladder. Overrides synthetic_shaping_sps when on.
    synthetic_channel: bool = False
    synthetic_channel_params: Optional[Dict[str, Any]] = None

    @property
    def num_classes(self) -> int:
        mods = self.target_modulations if self.source == "hdf5" else self.synthetic_classes
        return len(mods)

    @property
    def frame_len(self) -> int:
        """Raw I/Q samples per frame as stored: the RadioML 2018.01A frame
        is fixed at 1024 (ref: README.md:226-232); synthetic corpora use
        synthetic_frame_len."""
        return 1024 if self.source == "hdf5" else self.synthetic_frame_len

    def validate(self, check_paths: bool = True) -> None:
        errors = []
        if self.source not in ("synthetic", "hdf5"):
            errors.append(f"source must be 'synthetic' or 'hdf5', got {self.source!r}")
        if abs(self.train_size + self.valid_size + self.test_size - 1.0) > 1e-9:
            errors.append(
                f"splits must sum to 1.0, got "
                f"{self.train_size + self.valid_size + self.test_size}"
            )
        if self.source == "hdf5" and check_paths:
            if not Path(self.file_path).exists():
                errors.append(f"HDF5 file not found: {self.file_path}")
            if self.json_path and not Path(self.json_path).exists():
                errors.append(f"classes JSON not found: {self.json_path}")
        if self.sps < 1:
            errors.append(f"sps must be >= 1, got {self.sps}")
        _methods = ("simple_energy", "simple_correlation", "gardner", "mueller_muller")
        if self.timing_method not in _methods:
            errors.append(
                f"timing_method must be one of {_methods}, got {self.timing_method!r}")
        if errors:
            raise ValueError("DataConfig validation failed:\n" + "\n".join(f"  - {e}" for e in errors))


@dataclass
class TrainConfig:
    """Optimization & loop hyperparameters; defaults = reference defaults
    (ref: ViT/training/train.py:90-110, :405-424)."""

    batch_size: int = 256
    num_epochs: int = 100
    learning_rate: float = 1e-4
    weight_decay: float = 1e-3  # rawIQ arm default is 1e-4
    label_smoothing: float = 0.1
    grad_clip_max_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    adam_eps: float = 1e-8
    # ReduceLROnPlateau(mode='min', factor=0.5, patience=5)  (train.py:415-421)
    lr_plateau_factor: float = 0.5
    lr_plateau_patience: int = 5
    min_lr: float = 1e-7
    # EarlyStopping(patience=10)  (utils.py:14-55)
    patience: int = 10
    save_freq: int = 10
    init_seed: int = 0
    dropout_seed: int = 1
    shuffle_seed: int = 2
    # host->device feeding: background-prefetch queue depth (parity with the
    # reference loader's prefetch_factor=3, ref: ViT/training/train.py:99)
    prefetch_depth: int = 3
    # bound on async-dispatch depth: fetch one loss scalar every N train
    # steps so the device queue drains and in-flight host-to-device batch
    # buffers are released. 0 disables.
    dispatch_sync_steps: int = 64
    # record dispatch-synchronized per-step wall times (StepTimer) and emit
    # per-epoch step_p50/step_p90 into history
    profile_steps: bool = False
    # device-scan superbatching: stage K train batches in one transfer and
    # run them as K steps of one device call (the port: one replay of a
    # captured CUDA graph, `train/loop.make_train_scan_step`). 0/1 = off
    # (per-batch steps).
    device_scan_steps: int = 64
    # parallelism: number of mesh devices along the data / model axes
    data_parallel: int = 1
    model_parallel: int = 1

    def validate(self) -> None:
        errors = []
        for name in ("batch_size", "num_epochs"):
            if getattr(self, name) <= 0:
                errors.append(f"{name} must be positive")
        if self.learning_rate <= 0:
            errors.append("learning_rate must be positive")
        if errors:
            raise ValueError("TrainConfig validation failed:\n" + "\n".join(f"  - {e}" for e in errors))


@dataclass
class ExperimentConfig:
    """Everything needed to reproduce a run; JSON round-trips and is embedded in
    checkpoints (the rawIQ arm persisted config.json per experiment,
    ref: transformer_rawIQ/training/train.py:378-381)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    experiment_name: str = "exp"
    checkpoint_dir: str = "result/checkpoints"
    log_dir: str = "result/logs"

    def validate(self, check_paths: bool = True) -> None:
        self.model.validate()
        self.data.validate(check_paths=check_paths)
        self.train.validate()
        if self.model.num_classes != self.data.num_classes:
            raise ValueError(
                f"model.num_classes ({self.model.num_classes}) != number of dataset "
                f"classes ({self.data.num_classes})"
            )
        if self.data.source == "synthetic":
            frame_len = self.data.synthetic_frame_len
            if frame_len % self.data.sps:
                raise ValueError(
                    f"data.synthetic_frame_len ({frame_len}) must be a multiple "
                    f"of data.sps ({self.data.sps})"
                )
            # the model consumes the post-SPS symbol stream (L/sps symbols)
            eff_len = frame_len // self.data.sps
            if self.model.arm == "rawiq" and self.model.seq_length != eff_len:
                raise ValueError(
                    f"model.seq_length ({self.model.seq_length}) != effective "
                    f"frame length ({eff_len} = synthetic_frame_len {frame_len}"
                    f" / sps {self.data.sps})"
                )
            if self.model.arm == "vit" and (
                self.model.img_size_h * self.model.img_size_w != 2 * eff_len
            ):
                raise ValueError(
                    f"ViT image {self.model.img_size_h}x{self.model.img_size_w} must "
                    f"hold 2*(frame_len/sps) = {2 * eff_len} values"
                )

    # ---- JSON round-trip -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            Path(path).write_text(text)
        return text

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        def build(dc_cls, sub):
            fields = {f.name for f in dataclasses.fields(dc_cls)}
            kwargs = {k: v for k, v in sub.items() if k in fields}
            for k, v in kwargs.items():
                if isinstance(v, list):
                    kwargs[k] = tuple(v)
            return dc_cls(**kwargs)

        return cls(
            model=build(ModelConfig, d.get("model", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            experiment_name=d.get("experiment_name", "exp"),
            checkpoint_dir=d.get("checkpoint_dir", "result/checkpoints"),
            log_dir=d.get("log_dir", "result/logs"),
        )

    @classmethod
    def from_json(cls, text_or_path: str) -> "ExperimentConfig":
        text = text_or_path
        if "\n" not in text_or_path and len(text_or_path) < 4096:
            p = Path(text_or_path)
            if p.exists():
                text = p.read_text()
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_reference_dict(cls, d: Dict[str, Any],
                            arm: Optional[str] = None) -> "ExperimentConfig":
        """Convert a REFERENCE config dict (the UPPERCASE class-attribute
        Config the reference persists as config.json per checkpoint dir and
        embeds in .pth checkpoints, ref: ViT/training/train.py:42-110,
        transformer_rawIQ/training/train.py:43-167 / :378-381) into an
        ExperimentConfig — the interop half of `vitiq evaluate
        --torch-checkpoint`. Arm auto-detection: EMBEDDING_TYPE/SEGMENT_SIZE
        present -> rawiq; else vit."""
        if arm is None:
            arm = ("rawiq" if ("EMBEDDING_TYPE" in d or "SEGMENT_SIZE" in d
                               or "USE_CLS_TOKEN" in d) else "vit")
        mods = tuple(d.get("TARGET_MODULATIONS", TARGET_MODULATIONS_19))
        model = ModelConfig(
            arm=arm,
            num_classes=len(mods),
            d_model=int(d.get("D_MODEL", 128)),
            n_head=int(d.get("N_HEAD", 8)),
            n_layers=int(d.get("N_LAYERS", 6)),
            ffn_hidden=int(d.get("FFN_HIDDEN",
                                 4 * int(d.get("D_MODEL", 128)))),
            drop_prob=float(d.get("DROP_PROB", 0.1)),
            # the reference evaluates its published checkpoints in f32
            numerics="reference",
        )
        if arm == "vit":
            model.patch_size = int(d.get("PATCH_SIZE", 4))
        else:
            model.seq_length = int(d.get("SEQ_LENGTH", 1024))
            model.embedding_type = str(d.get("EMBEDDING_TYPE", "segment"))
            model.segment_size = int(d.get("SEGMENT_SIZE", 16))
            model.use_cls_token = bool(d.get("USE_CLS_TOKEN", True))
        data = DataConfig(
            source="hdf5",
            file_path=str(d.get("FILE_PATH", "")),
            json_path=str(d.get("JSON_PATH", "")),
            target_modulations=mods,
            train_size=float(d.get("TRAIN_SIZE", 0.7)),
            valid_size=float(d.get("VALID_SIZE", 0.15)),
            test_size=float(d.get("TEST_SIZE", 0.15)),
            split_seed=int(d.get("SPLIT_SEED", 42)),
            norm_seed=int(d.get("NORM_SEED", 49)),
        )
        train = TrainConfig(
            batch_size=int(d.get("BATCH_SIZE", 256)),
            num_epochs=int(d.get("NUM_EPOCHS", 100)),
            learning_rate=float(d.get("LEARNING_RATE", 1e-4)),
            weight_decay=float(d.get("WEIGHT_DECAY", 1e-3)),
            label_smoothing=float(d.get("LABEL_SMOOTHING", 0.1)),
            patience=int(d.get("PATIENCE", 10)),
            save_freq=int(d.get("SAVE_FREQ", 10)),
        )
        return cls(model=model, data=data, train=train,
                   experiment_name=f"reference_import_{arm}")

    # ---- reference presets -------------------------------------------------
    @classmethod
    def vit_reference(cls, **overrides) -> "ExperimentConfig":
        """The reference ViT arm's production config (ref: ViT/training/train.py:82-95)."""
        cfg = cls(
            model=ModelConfig(arm="vit", num_classes=19, d_model=128, n_head=8, n_layers=6,
                              ffn_hidden=512, drop_prob=0.1, patch_size=4),
            data=DataConfig(source="hdf5", target_modulations=TARGET_MODULATIONS_19),
            train=TrainConfig(weight_decay=1e-3, save_freq=10),
        )
        return _apply_overrides(cfg, overrides)

    @classmethod
    def vit_tpu_production(cls, **overrides) -> "ExperimentConfig":
        """The JAX package's TPU-recommended architecture: the reference ViT
        config with n_head=2 (d_head=64). Its speed and accuracy record is
        the JAX package's (`vitiq/config.py`, docs/BENCHMARKS.md,
        head_variant_validation.json), taken on a TPU; nothing here has
        measured it on a GPU."""
        cfg = cls.vit_reference()
        cfg = _apply_overrides(cfg, {"model.n_head": 2})
        return _apply_overrides(cfg, overrides)

    @classmethod
    def vit_synthetic19(cls, **overrides) -> "ExperimentConfig":
        """The reference ViT arm at the reference training regime (batch 256,
        plateau LR, early stop) on the 19-class SYNTHETIC proxy corpus — the
        strongest accuracy proxy buildable without the 20 GB RadioML download:
        same class list (ref: ViT/training/train.py:60-80), full constellation
        geometry incl. ASK/APSK/cross-QAM, GMSK/OQPSK waveform synthesis
        (vitiq/data/synthetic.py), SNR grid spanning the -8/0/+8 dB eval
        targets."""
        cfg = cls.vit_reference()
        cfg.data = DataConfig(
            source="synthetic",
            synthetic_classes=TARGET_MODULATIONS_19,
            synthetic_frames_per_class=2048,
            synthetic_snr_db=(-8.0, -4.0, 0.0, 4.0, 8.0, 12.0, 16.0, 20.0),
        )
        cfg.experiment_name = "vit_synthetic19"
        return _apply_overrides(cfg, overrides)

    @classmethod
    def rawiq_synthetic19(cls, **overrides) -> "ExperimentConfig":
        """The reference rawIQ arm on the 19-class synthetic proxy corpus
        (see vit_synthetic19); the head-to-head pair for the two-arm
        comparison at the reference regime."""
        cfg = cls.rawiq_reference()
        cfg.data = DataConfig(
            source="synthetic",
            synthetic_classes=TARGET_MODULATIONS_19,
            synthetic_frames_per_class=2048,
            synthetic_snr_db=(-8.0, -4.0, 0.0, 4.0, 8.0, 12.0, 16.0, 20.0),
        )
        cfg.experiment_name = "rawiq_synthetic19"
        return _apply_overrides(cfg, overrides)

    @classmethod
    def vit_tiny_2016(cls, **overrides) -> "ExperimentConfig":
        """ViT-Tiny for RadioML 2016.10a-style data (BASELINE.json config 2):
        128-sample frames folded to [1, 16, 16] images, the full 11-class
        2016.10a task (RADIOML_2016_CLASSES — the synthetic generator covers
        all of it incl. CPFSK/GFSK/analog); point data at an HDF5 export for
        the real corpus."""
        cfg = cls(
            model=ModelConfig(arm="vit", num_classes=11, d_model=64, n_head=4,
                              n_layers=4, ffn_hidden=256, drop_prob=0.1,
                              img_size_h=16, img_size_w=16, patch_size=4,
                              seq_length=128),
            data=DataConfig(source="synthetic",
                            synthetic_classes=RADIOML_2016_CLASSES,
                            synthetic_frame_len=128),
            train=TrainConfig(weight_decay=1e-4),
        )
        return _apply_overrides(cfg, overrides)

    @classmethod
    def rawiq_reference(cls, **overrides) -> "ExperimentConfig":
        """The reference rawIQ arm's defaults (ref: transformer_rawIQ/training/train.py:84-106)."""
        cfg = cls(
            model=ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8, n_layers=6,
                              ffn_hidden=1024, drop_prob=0.2, embedding_type="segment",
                              segment_size=16, use_cls_token=True),
            data=DataConfig(source="hdf5", target_modulations=TARGET_MODULATIONS_19),
            train=TrainConfig(weight_decay=1e-4, save_freq=5),
        )
        return _apply_overrides(cfg, overrides)

    @classmethod
    def rawiq_best(cls, **overrides) -> "ExperimentConfig":
        """The reference's BEST published checkpoint: rawIQ
        exp_L9_H8_F1024_W1e-3 — 63.44% overall on the 19-class RadioML
        2018.01A test split, the stronger arm of the head-to-head (ref:
        transformer_rawIQ/result/checkpoints/exp_L9_H8_F1024_W1e-3/
        config.json and .../evaluation/test_classification_report.txt:4).
        d_model=256, 9 layers, segment-16 tokens (65 incl. CLS), batch 128,
        lr 1e-4, weight decay 1e-3, patience 10."""
        cfg = cls(
            model=ModelConfig(arm="rawiq", num_classes=19, d_model=256, n_head=8, n_layers=9,
                              ffn_hidden=1024, drop_prob=0.1, embedding_type="segment",
                              segment_size=16, use_cls_token=True),
            data=DataConfig(source="hdf5", target_modulations=TARGET_MODULATIONS_19),
            train=TrainConfig(batch_size=128, weight_decay=1e-3, save_freq=10),
        )
        return _apply_overrides(cfg, overrides)


def _apply_overrides(cfg: ExperimentConfig, overrides: Dict[str, Any]) -> ExperimentConfig:
    """Apply flat 'section.key' or bare-key overrides (CLI overlay).

    Bare keys are resolved against model, then train, then data — mirroring the
    reference's `Config.from_args` upper-case attribute overlay
    (ref: ViT/training/train.py:112-118).
    """
    for key, value in overrides.items():
        if value is None:
            continue
        if "." in key:
            section, name = key.split(".", 1)
            sub = getattr(cfg, section)
            if not hasattr(sub, name):
                raise AttributeError(f"unknown config key {key!r}")
            setattr(sub, name, value)
        elif hasattr(cfg, key):
            setattr(cfg, key, value)
        else:
            for sub in (cfg.model, cfg.train, cfg.data):
                if hasattr(sub, key):
                    setattr(sub, key, value)
                    break
            else:
                raise AttributeError(f"unknown config key {key!r}")
    return cfg


# ---- the flagship geometries (`vitiq/bench.py`) ----------------------------

def flagship_vit_config(numerics: str = "tpu") -> ModelConfig:
    """The reference's production ViT arm: d128/L6/H8, FFN 512, patch 4 over
    the [1, 32, 64] image (129 tokens with CLS), 19 classes."""
    return ModelConfig(arm="vit", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=512, drop_prob=0.1, patch_size=4,
                       numerics=numerics)


def flagship_rawiq_config(numerics: str = "tpu") -> ModelConfig:
    """The rawIQ flagship: d128/L6/H8, FFN 1024, segment-16 tokens (65 with
    CLS), CLS pooling, head LayerNorm eps 1e-5, 19 classes."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=16, numerics=numerics)


def flagship_conv1d_config(numerics: str = "tpu") -> ModelConfig:
    """rawIQ conv1d tokenization: one token per sample, 1025 tokens with CLS,
    the reference's long-sequence mode (ref: transformer_rawIQ/models/
    encoder.py:34-41); d128/L6/H8, FFN 1024, dropout 0.2."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       embedding_type="conv1d", numerics=numerics)


def rawiq_seg64_config(numerics: str = "tpu") -> ModelConfig:
    """rawIQ segment-64: the reference's production_rawIQv1 tokenization,
    16 segments and CLS (17 tokens), d128/L6/H8, FFN 1024, dropout 0.2."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=64, numerics=numerics)


def rawiq_seg64_mp_config(numerics: str = "tpu") -> ModelConfig:
    """`rawiq_seg64_config` with the mean-pool readout (use_cls_token=False,
    the reference's own pooling flag, ref: transformer_rawIQ.py:88-93): 16
    tokens, no CLS row."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=64, use_cls_token=False,
                       numerics=numerics)


def rawiq_mp_config(numerics: str = "tpu") -> ModelConfig:
    """The rawIQ flagship (segment 16) with the mean-pool readout: 64
    tokens, no CLS row."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=16, use_cls_token=False,
                       numerics=numerics)


def rawiq_best_config(numerics: str = "tpu") -> ModelConfig:
    """The reference's best published checkpoint geometry (rawIQ
    exp_L9_H8_F1024_W1e-3, 63.44%): d256/L9/H8, FFN 1024, segment-16 tokens
    (65 with CLS, d_head 32), dropout 0.1, 19 classes (ref:
    transformer_rawIQ/result/checkpoints/exp_L9_H8_F1024_W1e-3/config.json)."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=256, n_head=8,
                       n_layers=9, ffn_hidden=1024, drop_prob=0.1,
                       segment_size=16, numerics=numerics)


def rawiq_best_mp_config(numerics: str = "tpu") -> ModelConfig:
    """`rawiq_best_config` with the mean-pool readout (use_cls_token=False,
    the reference's own pooling flag): 64 tokens, Lp=64."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=256, n_head=8,
                       n_layers=9, ffn_hidden=1024, drop_prob=0.1,
                       segment_size=16, use_cls_token=False,
                       numerics=numerics)


def vit_tiny_2016_config(numerics: str = "tpu") -> ModelConfig:
    """ViT-Tiny on RadioML 2016.10a-style data: 128-sample frames folded to
    [1, 16, 16] images, 11 classes, d64/L4/H4, FFN 256, 17 tokens."""
    return ModelConfig(arm="vit", num_classes=11, d_model=64, n_head=4,
                       n_layers=4, ffn_hidden=256, drop_prob=0.1,
                       img_size_h=16, img_size_w=16, patch_size=4,
                       seq_length=128, numerics=numerics)
