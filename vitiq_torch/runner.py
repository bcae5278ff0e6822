"""Experiment orchestration (counterpart of `vitiq/runner.py`): the data of
an experiment and the standalone evaluation of a saved one.

`run_evaluation` re-derives the split and the normalization stats from the
config, rebuilds the model, loads its parameter file (`vitiq`'s layout, so
an experiment directory written by either package evaluates) and writes the
evaluation artifacts, in float through the serving path or, with ``int8``,
through the W8A8 quantized model (`ops/quant.py`: K6 and K2 on the card).
It runs on the card unless the caller asks for another device, and raises
where CUDA is absent.

Only the synthetic source is ported: the HDF5 source needs h5py. Training
runs (`run_training`), the reference-checkpoint import and the head-to-head
comparison are not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from vitiq_torch.config import ExperimentConfig
from vitiq_torch.data import ArrayFeed, SyntheticAMCDataset, channel_from_config, stats_from_array


def _check_source(cfg: ExperimentConfig) -> None:
    if cfg.data.source != "synthetic":
        raise NotImplementedError(
            f"data source {cfg.data.source!r}: the port reads the synthetic source only "
            "(the HDF5 source needs h5py and is not ported yet)")


def load_experiment_data(cfg: ExperimentConfig):
    """Returns (splits dict of (x, y, snr), stats, class_names): the
    synthetic corpus of `cfg.data`, split in order into train / valid / test,
    the stats from a seeded subset of the train split."""
    _check_source(cfg)
    ds = SyntheticAMCDataset(
        classes=cfg.data.synthetic_classes,
        frames_per_class=cfg.data.synthetic_frames_per_class,
        frame_len=cfg.data.synthetic_frame_len,
        snrs_db=cfg.data.synthetic_snr_db,
        seed=cfg.data.synthetic_seed,
        shaping_sps=cfg.data.synthetic_shaping_sps,
        channel=channel_from_config(cfg.data),
    )
    n = len(ds)
    n_train = int(cfg.data.train_size * n)
    n_valid = int(cfg.data.valid_size * n)
    sl = {
        "train": slice(0, n_train),
        "valid": slice(n_train, n_train + n_valid),
        "test": slice(n_train + n_valid, n),
    }
    splits = {k: (ds.X[v], ds.Y[v], ds.Z[v]) for k, v in sl.items()}
    stats = stats_from_array(ds.X[:n_train], np.arange(n_train), seed=cfg.data.norm_seed,
                             num_samples=cfg.data.norm_sample_count)
    return splits, stats, list(cfg.data.synthetic_classes)


def load_experiment_feeds(cfg: ExperimentConfig):
    """Returns (feeds dict of ArrayFeed, stats, class_names)."""
    splits, stats, class_names = load_experiment_data(cfg)
    feeds = {name: ArrayFeed(x, y, z, shuffle_seed=cfg.train.shuffle_seed)
             for name, (x, y, z) in splits.items()}
    return feeds, stats, class_names


def load_experiment_config(exp_dir: Path, config_path: Optional[str] = None) -> ExperimentConfig:
    """config.json of the experiment (or `config_path`), else the config a
    checkpoint manifest embeds."""
    cfg_file = Path(config_path) if config_path else exp_dir / "config.json"
    if cfg_file.exists():
        return ExperimentConfig.from_json(str(cfg_file))
    for name in ("checkpoint_final.json", "checkpoint_interrupted.json"):
        p = exp_dir / name
        if p.exists():
            manifest = json.loads(p.read_text())
            if manifest.get("config"):
                return ExperimentConfig.from_dict(manifest["config"])
    raise FileNotFoundError(
        f"no config.json in {exp_dir} and no checkpoint manifest with an embedded config "
        "— pass --config explicitly")


def run_evaluation(
    checkpoint_dir: str,
    dataset: str = "test",
    batch_size: Optional[int] = None,
    config_path: Optional[str] = None,
    int8: bool = False,
    device="cuda",
    make_plots: bool = True,
    verbose: bool = True,
) -> Dict:
    """Evaluate a saved experiment on one split (the reference's evaluate.py
    flow): artifacts under ``<checkpoint_dir>/evaluation`` with the prefix
    `dataset`, or ``{dataset}_int8`` through the int8 W8A8 path. Weights from
    model_best.npz, else model_final.npz; stats from normalization_stats.json
    when present."""
    from vitiq_torch.eval import evaluate_feed_with_confusion
    from vitiq_torch.models.amc import AMCModel
    from vitiq_torch.serve import build_forward_and_preprocess, build_preprocess, resolve_device
    from vitiq_torch.train.checkpoint import load_params

    device = resolve_device(device)
    exp_dir = Path(checkpoint_dir)
    cfg = load_experiment_config(exp_dir, config_path)
    if batch_size:
        cfg.train.batch_size = batch_size

    feeds, stats, class_names = load_experiment_feeds(cfg)
    stats_file = exp_dir / "normalization_stats.json"
    if stats_file.exists():
        stats = json.loads(stats_file.read_text())

    weights = exp_dir / "model_best.npz"
    if not weights.exists():
        weights = exp_dir / "model_final.npz"
    model = AMCModel(cfg.model)
    model.load_state_dict(load_params(weights, cfg.model))

    prefix = dataset
    if int8:
        # the W8A8 serving path (fused K6/K2 on the card) takes the
        # preprocessed input: it is not raw-aware
        from vitiq_torch.ops.quant import QuantizedAMCModel

        forward = QuantizedAMCModel.from_model(model.to(device))
        preprocess = build_preprocess(cfg, stats)
        prefix = f"{dataset}_int8"
    else:
        forward, preprocess = build_forward_and_preprocess(cfg, model, stats, device)
        forward.eval()
    return evaluate_feed_with_confusion(
        forward, feeds[dataset], class_names, exp_dir / "evaluation", device, prefix=prefix,
        batch_size=cfg.train.batch_size, preprocess_fn=preprocess, make_plots=make_plots,
        verbose=verbose)
