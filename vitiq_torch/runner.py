"""Experiment orchestration (counterpart of `vitiq/runner.py`): the data of
an experiment, a training run and the standalone evaluation of a saved one.

`run_training` is the reference's per-arm `main()`: config.json and the
normalization stats, `fit` with plateau LR and early stopping, a rolling
``model_best`` and ``checkpoint_epoch_{n}`` every ``save_freq`` epochs, a
``checkpoint_interrupted`` rescue on KeyboardInterrupt, resuming from a
checkpoint (``resume="auto"`` picks the newest in the experiment directory),
``checkpoint_final`` / ``model_final``, the history plot and the test
evaluation with ``summary.json``. Its files are `vitiq`'s, so either package
resumes or evaluates the other's experiment.

`run_evaluation` re-derives the split and the normalization stats from the
config, rebuilds the model, loads its parameter file and writes the
evaluation artifacts, in float through the serving path or, with ``int8``,
through the W8A8 quantized model (`ops/quant.py`: K6 and K2 on the card).

`run_head_to_head` is the thesis's experiment: both arms trained by
`run_training` on the same data, each evaluated on its test split, then the
cross-arm comparison of their reports (`eval/compare.py`).

`run_reference_evaluation` evaluates a reference PyTorch ``.pth`` without
retraining: the port keeps the reference's parameter names, so its
``model_state_dict`` loads with `load_state_dict`.

The data is the synthetic corpus or a RadioML-layout HDF5 file (h5py is
imported where the file is read): in RAM (`ArrayFeed`), or with
``data.streaming`` one `StreamFeed` a split over windowed reads, each with
its own file handle, closed when the run ends. All four run on the card
unless the caller asks for another device, and raise where CUDA is absent;
under ``VITIQ_ATTN_INT8=1`` their float evaluation passes run K7
(`Encoder.forward`).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from vitiq_torch.config import ExperimentConfig
from vitiq_torch.data import (
    ArrayFeed,
    DataFeed,
    HDF5DataSource,
    StreamFeed,
    SyntheticAMCDataset,
    channel_from_config,
    stats_from_array,
)


def _check_frame_geometry(cfg: ExperimentConfig, frame_len: int) -> None:
    """Fail fast where the HDF5 file's frame length (after SPS decimation)
    does not fit the model: it is known only once the file is open."""
    if frame_len % cfg.data.sps:
        raise ValueError(f"dataset frame length ({frame_len}) must be a multiple of "
                         f"data.sps ({cfg.data.sps})")
    eff = frame_len // cfg.data.sps
    if cfg.model.arm == "rawiq" and cfg.model.seq_length != eff:
        raise ValueError(
            f"model.seq_length ({cfg.model.seq_length}) != effective frame "
            f"length ({eff} = dataset frame_len {frame_len} / sps {cfg.data.sps})")
    if (cfg.model.arm == "vit" and cfg.data.features == "iq"
            and cfg.model.img_size_h * cfg.model.img_size_w != 2 * eff):
        raise ValueError(f"ViT image {cfg.model.img_size_h}x{cfg.model.img_size_w} must "
                         f"hold 2*(frame_len/sps) = {2 * eff} values")


def load_experiment_data(cfg: ExperimentConfig):
    """Returns (splits dict of (x, y, snr), stats, class_names): the HDF5
    file's reference split, each split read into RAM in sorted row order, or
    the synthetic corpus of `cfg.data` split in order into train / valid /
    test; the stats from a seeded subset of the train split."""
    if cfg.data.source == "hdf5":
        with HDF5DataSource(cfg.data.file_path, cfg.data.json_path) as src:
            _check_frame_geometry(cfg, src.frame_len)
            s = src.split(cfg.data)
            stats = src.normalization_stats(s.train, cfg.data)
            splits = {name: src.load_split_arrays(idx, s.label_map)
                      for name, idx in (("train", s.train), ("valid", s.valid),
                                        ("test", s.test))}
        return splits, stats, list(cfg.data.target_modulations)
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
    """Returns (feeds dict of DataFeed, stats, class_names). With
    ``data.streaming`` and the HDF5 source each split is a `StreamFeed` over
    `HDF5DataSource.batch_stream` (``data.stream_window_rows`` a window) with
    a file handle of its own, which the feed's `close()` releases; otherwise
    the splits are read into RAM as `ArrayFeed`s."""
    if cfg.data.source == "hdf5" and cfg.data.streaming:
        import functools

        with HDF5DataSource(cfg.data.file_path, cfg.data.json_path) as meta_src:
            _check_frame_geometry(cfg, meta_src.frame_len)
            s = meta_src.split(cfg.data)
            stats = meta_src.normalization_stats(s.train, cfg.data)
        feeds: Dict[str, DataFeed] = {}
        for name, idx in (("train", s.train), ("valid", s.valid), ("test", s.test)):
            src = HDF5DataSource(cfg.data.file_path, cfg.data.json_path)
            feeds[name] = StreamFeed(
                functools.partial(src.batch_stream, idx, s.label_map,
                                  window_rows=cfg.data.stream_window_rows),
                num_samples=len(idx), shuffle_seed=cfg.train.shuffle_seed, source=src)
        return feeds, stats, list(cfg.data.target_modulations)

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
        preprocess = build_preprocess(cfg, stats, device)
        prefix = f"{dataset}_int8"
    else:
        forward, preprocess = build_forward_and_preprocess(cfg, model, stats, device)
        forward.eval()
    try:
        return evaluate_feed_with_confusion(
            forward, feeds[dataset], class_names, exp_dir / "evaluation", device, prefix=prefix,
            batch_size=cfg.train.batch_size, preprocess_fn=preprocess, make_plots=make_plots,
            verbose=verbose)
    finally:
        for f in feeds.values():
            f.close()


def _config_from_json(path: Path) -> ExperimentConfig:
    """A vitiq config JSON, or the reference's UPPERCASE config.json (told
    apart by the case of its keys)."""
    d = json.loads(Path(path).read_text())
    if any(k.isupper() for k in d):
        return ExperimentConfig.from_reference_dict(d)
    return ExperimentConfig.from_dict(d)


def run_reference_evaluation(
    torch_checkpoint: str,
    config_path: Optional[str] = None,
    output_dir: Optional[str] = None,
    dataset: str = "test",
    batch_size: Optional[int] = None,
    data_path: Optional[str] = None,
    json_path: Optional[str] = None,
    device="cuda",
    make_plots: bool = True,
    verbose: bool = True,
) -> Dict:
    """Evaluate a reference PyTorch checkpoint (a ``.pth`` holding
    ``model_state_dict``, or a bare state dict) on one split and write the
    evaluation artifacts, without retraining.

    The config comes from, in order: `config_path` (a vitiq config JSON or
    the reference's UPPERCASE config.json); a config JSON beside the
    checkpoint (``<stem>.json``, else ``config.json`` in its directory); the
    reference config the checkpoint embeds under ``config``.
    `data_path` / `json_path` override the dataset's location (and
    `data_path` selects the HDF5 source). The weights load with
    `load_state_dict` (the port keeps the reference's parameter names;
    entries the model does not have, such as buffers, are ignored, and a
    missing parameter raises KeyError). The checkpoint is read with
    ``torch.load(weights_only=True)``: tensors, containers and plain values
    only. Artifacts go to `output_dir`, by default
    ``result/reference_import/<stem>/evaluation``."""
    from vitiq_torch.eval import evaluate_feed_with_confusion
    from vitiq_torch.interop import load_reference_state_dict
    from vitiq_torch.models.amc import AMCModel
    from vitiq_torch.serve import build_forward_and_preprocess, resolve_device

    device = resolve_device(device)
    ckpt_path = Path(torch_checkpoint)
    blob = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob

    cfg = None
    if config_path:
        cfg = _config_from_json(Path(config_path))
    else:
        for cand in (ckpt_path.with_suffix(".json"), ckpt_path.parent / "config.json"):
            if cand.exists():
                cfg = _config_from_json(cand)
                break
        if cfg is None and isinstance(blob, dict) and blob.get("config"):
            cfg = ExperimentConfig.from_reference_dict(blob["config"])
    if cfg is None:
        raise FileNotFoundError(
            f"no config found for {ckpt_path}: pass --config, place a config.json next to "
            "the checkpoint, or use a reference training checkpoint with an embedded config")
    if data_path:
        cfg.data.file_path = data_path
        cfg.data.source = "hdf5"
    if json_path:
        cfg.data.json_path = json_path
    if batch_size:
        cfg.train.batch_size = batch_size
    cfg.model.validate()

    model = AMCModel(cfg.model)
    load_reference_state_dict(model, sd)

    out = Path(output_dir) if output_dir else (
        Path("result/reference_import") / ckpt_path.stem / "evaluation")
    feeds, stats, class_names = load_experiment_feeds(cfg)
    try:
        forward, preprocess = build_forward_and_preprocess(cfg, model, stats, device)
        forward.eval()
        return evaluate_feed_with_confusion(
            forward, feeds[dataset], class_names, out, device, prefix=dataset,
            batch_size=cfg.train.batch_size, preprocess_fn=preprocess, make_plots=make_plots,
            verbose=verbose)
    finally:
        for f in feeds.values():
            f.close()


def _newest_checkpoint(exp_dir: Path) -> Optional[str]:
    """``resume="auto"``: the newest of the epoch-numbered checkpoints and the
    interrupt rescue (which counts as the epoch after its own)."""
    candidates = []
    for p in exp_dir.glob("checkpoint_epoch_*.json"):
        try:
            candidates.append((int(p.stem.rsplit("_", 1)[1]), p))
        except ValueError:
            continue
    p_int = exp_dir / "checkpoint_interrupted.json"
    if p_int.exists():
        try:
            candidates.append((json.loads(p_int.read_text())["epoch"] + 1, p_int))
        except (OSError, ValueError, KeyError, TypeError):
            pass  # an unreadable rescue is skipped, as an unparsable epoch name is
    return str(max(candidates)[1].with_suffix("")) if candidates else None


def start_ranks(cfg: ExperimentConfig, device="cuda") -> torch.device:
    """The rank's device for a run. Above one rank (torchrun's
    ``WORLD_SIZE``, or a process group already started, as
    `parallel.comm.spawn` starts one) the group is started if it is not
    (`parallel.comm.init_distributed`: NCCL when every local rank has a
    card, gloo otherwise, printed) and the rank placed on
    ``cuda:LOCAL_RANK``, or on the CPU when it is asked for. The world must
    be ``data_parallel * model_parallel``, else ValueError."""
    import os

    from vitiq_torch.parallel import comm
    from vitiq_torch.utils.device import resolve_device

    data, model = cfg.train.data_parallel, cfg.train.model_parallel
    if comm.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) > 1:
        device, _ = comm.init_distributed(device)
    else:
        device = resolve_device(device)
    if comm.world_size() != data * model:
        raise ValueError(f"data_parallel={data} x model_parallel={model} needs a process group "
                         f"of {data * model} ranks (torchrun --nproc_per_node "
                         f"{data * model}), have {comm.world_size()}")
    return device


def run_training(cfg: ExperimentConfig, resume: Optional[str] = None, evaluate_test: bool = True,
                 verbose: bool = True, device="cuda", make_plots: bool = True) -> Dict:
    """Train and evaluate an experiment in ``<checkpoint_dir>/<experiment_name>``
    (the reference's flow, with the rawIQ arm's fixes: model_best preferred
    for the test evaluation); returns the summary dict. `resume`: a
    checkpoint path, or "auto" for the newest in the experiment directory; a
    missing or corrupt one starts the run fresh. ``make_plots=False`` skips
    the plots (they need matplotlib and seaborn); a failing history plot
    only warns.

    Over a (data, model) mesh of ranks (`start_ranks`: every rank runs this
    function, started by torchrun or `parallel.comm.spawn`), each rank
    builds the whole seeded model, `fit` shards it, the checkpoints and
    parameter files are gathered and written by rank 0 in the one-process
    layout, and rank 0 alone writes config.json, the stats, the test
    evaluation's artifacts, the plots and summary.json; every rank returns
    the summary. The interrupt rescue is a one-rank feature."""
    from vitiq_torch.eval import evaluate_feed_with_confusion
    from vitiq_torch.models.amc import AMCModel, count_parameters
    from vitiq_torch.parallel import comm
    from vitiq_torch.parallel.mesh import shard_state_dict
    from vitiq_torch.serve import build_forward_and_preprocess
    from vitiq_torch.train import fit
    from vitiq_torch.train.checkpoint import (
        load_checkpoint,
        load_params,
        save_checkpoint,
        save_params,
    )
    from vitiq_torch.train.optim import create_train_state

    cfg.validate(check_paths=cfg.data.source == "hdf5")
    device = start_ranks(cfg, device)
    lead = comm.rank() == 0
    verbose = verbose and lead
    make_plots = make_plots and lead
    exp_dir = Path(cfg.checkpoint_dir) / cfg.experiment_name
    log_dir = Path(cfg.log_dir)
    if lead:
        exp_dir.mkdir(parents=True, exist_ok=True)
        log_dir.mkdir(parents=True, exist_ok=True)
        cfg.to_json(str(exp_dir / "config.json"))

    feeds, stats, class_names = load_experiment_feeds(cfg)
    if lead:
        (exp_dir / "normalization_stats.json").write_text(json.dumps(stats, indent=2))
    model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(cfg.train.init_seed))
    model, preprocess = build_forward_and_preprocess(cfg, model, stats, device)
    if verbose:
        data, tp = cfg.train.data_parallel, cfg.train.model_parallel
        print(f"model: {cfg.model.arm}, {count_parameters(model):,} parameters"
              + (f", mesh data {data} x model {tp}" if data * tp > 1 else ""))

    resume_state = resume_history = None
    start_epoch = 0
    if resume == "auto":
        resume = _newest_checkpoint(exp_dir)
    if resume:
        try:
            resume_state, manifest = load_checkpoint(resume, create_train_state(model, cfg.train))
            resume_history = manifest["history"]
            start_epoch = manifest["epoch"] + 1
            if verbose:
                print(f"resumed from {resume} at epoch {start_epoch}")
        except (FileNotFoundError, ValueError) as e:
            # corrupt/missing resume -> start fresh, like the rawIQ arm
            print(f"warning: could not resume from {resume} ({e}); starting fresh")

    def checkpoint_callback(epoch: int, state, history):
        if (epoch + 1) % cfg.train.save_freq == 0:
            save_checkpoint(exp_dir / f"checkpoint_epoch_{epoch + 1}", state, epoch,
                            history["val_loss"][-1], history, cfg)
        if history["val_loss"][-1] <= min(history["val_loss"]):  # rolling best
            save_params(exp_dir / "model_best", state.model.state_dict(), cfg.model,
                        model=state.model)

    # rescue state for Ctrl-C (the reference saves checkpoint_interrupted)
    last = {"state": None, "epoch": -1, "history": None}

    def tracking_callback(epoch, state, history):
        last.update(state=state, epoch=epoch, history=history)
        checkpoint_callback(epoch, state, history)

    t0 = time.perf_counter()
    try:
        result = fit(cfg, model, feeds["train"], feeds["valid"], preprocess_fn=preprocess,
                     epoch_callback=tracking_callback, resume_state=resume_state,
                     resume_history=resume_history, start_epoch=start_epoch, verbose=verbose,
                     profile=cfg.train.profile_steps)
    except KeyboardInterrupt:
        if comm.world_size() > 1:
            raise
        if last["state"] is not None:
            save_checkpoint(exp_dir / "checkpoint_interrupted", last["state"], last["epoch"],
                            last["history"]["val_loss"][-1], last["history"], cfg)
            print(f"interrupted — rescue checkpoint written to "
                  f"{exp_dir / 'checkpoint_interrupted.npz'} (epoch {last['epoch'] + 1})")
        else:
            print("interrupted before the first epoch completed — nothing to rescue")
        for f in feeds.values():
            f.close()
        raise
    train_wall = time.perf_counter() - t0

    history = result.history
    save_checkpoint(exp_dir / "checkpoint_final", result.state, result.epochs_run - 1,
                    history["val_loss"][-1] if history["val_loss"] else float("inf"),
                    history, cfg)
    save_params(exp_dir / "model_final", model.state_dict(), cfg.model, model=model)
    best_params = result.best_params
    best_path = exp_dir / "model_best.npz"
    if result.best_tracked or not comm.agree(best_path.exists()):
        save_params(best_path, best_params, cfg.model, model=model)
    else:
        # a resumed run whose epochs never beat the historical best: the
        # rolling model_best of the original run holds the best weights
        best_params = shard_state_dict(load_params(best_path, cfg.model), model)

    if make_plots:
        try:
            from vitiq_torch.eval.plots import plot_training_history

            plot_training_history(history, log_dir / f"{cfg.experiment_name}_training_history.png")
        except Exception as e:  # plotting must never kill a finished run
            print(f"warning: history plot failed: {e}")

    summary: Dict = {
        "experiment_dir": str(exp_dir),
        "epochs_run": result.epochs_run,
        "stopped_early": result.stopped_early,
        "train_wall_seconds": train_wall,
        "best_val_loss": min(history["val_loss"]) if history["val_loss"] else None,
        "history": history,
        "normalization_stats": stats,
    }
    if result.step_times:
        summary["step_times"] = result.step_times
    if evaluate_test:
        model.load_state_dict(best_params)
        model.eval()
        res = evaluate_feed_with_confusion(
            model, feeds["test"], class_names, exp_dir / "evaluation", device, prefix="test",
            batch_size=cfg.train.batch_size, preprocess_fn=preprocess, make_plots=make_plots,
            verbose=verbose)
        summary["test_overall_accuracy"] = res["overall_accuracy"]
        summary["test_snr_accuracies"] = res["snr_accuracies"]
    if lead:
        (exp_dir / "summary.json").write_text(json.dumps(
            {k: v for k, v in summary.items() if k != "history"}, indent=2, default=float))
    for f in feeds.values():
        f.close()  # a streaming run holds a file handle a split
    return summary


def run_head_to_head(vit_cfg: ExperimentConfig, rawiq_cfg: ExperimentConfig,
                     comparison_dir: str = "comparison_results", verbose: bool = True,
                     resume: Optional[str] = None, device="cuda", make_plots: bool = True) -> Dict:
    """Train both arms on identical data (the ViT arm first), evaluate each,
    and compare their test reports into `comparison_dir`; returns each
    arm's summary (without its history), the comparison directory and the
    insights. `resume="auto"` resumes each arm from the newest checkpoint
    in its experiment directory. ``make_plots=False`` skips every plot."""
    from vitiq_torch.eval.compare import ModelComparison

    summaries = [run_training(cfg, resume=resume, verbose=verbose, device=device,
                              make_plots=make_plots) for cfg in (vit_cfg, rawiq_cfg)]
    vit_report, rawiq_report = (Path(s["experiment_dir"]) / "evaluation"
                                / "test_classification_report.txt" for s in summaries)
    mc = ModelComparison(vit_report, rawiq_report, output_dir=comparison_dir)
    insights = mc.run_comparison(verbose=verbose, make_plots=make_plots)
    vit_summary, rawiq_summary = ({k: v for k, v in s.items() if k != "history"}
                                  for s in summaries)
    return {"vit": vit_summary, "rawiq": rawiq_summary, "comparison_dir": str(comparison_dir),
            "insights": insights}
