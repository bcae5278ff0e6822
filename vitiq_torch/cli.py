"""Command-line interface (counterpart of `vitiq/cli.py`): ``train``,
``evaluate``, ``export``, ``compare``, ``head-to-head``, ``visualize`` and
``sweep``, with the JAX package's argument names, presets, overrides and
printed lines.

    python -m vitiq_torch.cli train [--preset NAME | --config PATH | --arm vit|rawiq]
        [--source synthetic|hdf5 --file_path H5 --json_path JSON [--streaming]]
        [--num_epochs N] [--numerics tpu] [--profile_steps] [...overrides]
        [--resume PATH|auto] [--device cuda] [--no_plots]
    python -m vitiq_torch.cli evaluate --checkpoint DIR [--dataset test]
        [--batch_size N] [--config PATH] [--int8] [--device cuda] [--no_plots]
    python -m vitiq_torch.cli evaluate --torch-checkpoint PTH [--config PATH]
        [--data-path H5] [--json-path JSON] [--output DIR] [--dataset test]
        [--batch_size N] [--device cuda] [--no_plots]
    python -m vitiq_torch.cli export --experiment_dir DIR --output ART
        [--batch_sizes 256,8192] [--platforms cuda,cpu] [--checkpoint model_best.npz]
    python -m vitiq_torch.cli compare --vit_report PATH --transformer_report PATH
        [--output_dir DIR] [--no_plots]
    python -m vitiq_torch.cli head-to-head [train's flags] [--output_dir DIR]
    python -m vitiq_torch.cli visualize [--file_path H5 --json_path JSON]
        [--output_dir DIR] [--modulations M ...] [--num_samples N]
        [--create_overview] [--dpi N] [--sps N]
    python -m vitiq_torch.cli sweep [--n_particles N] [--iters N] [--seed N]
        [--train_steps N] [--source synthetic|hdf5 --file_path H5 --json_path JSON]
        [--output PATH] [--resume] [--device cuda]

``--device`` (default ``cuda``) picks where the model runs; ``--device cpu``
runs on the host. ``--no_plots`` skips the plots, which need matplotlib and
seaborn. ``head-to-head`` trains the ViT arm from train's flags, then the
rawIQ arm from the same flags on a deep copy of the ViT arm's data (iq
features), as ``<experiment_name>_vit`` and ``<experiment_name>_rawiq``
(base name ``h2h``), and compares their test reports. ``visualize`` draws
vitiq's preprocessing figures on the host (`viz.py`, needs matplotlib);
``sweep`` runs the PSO search (`sweep.py`: each architecture's short
training one captured CUDA graph on the card) and prints its result. ``evaluate
--torch-checkpoint`` evaluates a reference PyTorch ``.pth``
(`runner.run_reference_evaluation`). ``export`` writes the serving artifact
of a training-run directory (`serve.export_from_experiment`) and prints
vitiq's keys; ``--platforms`` takes cuda and cpu. The presets read the HDF5 source
unless ``--source synthetic`` is given. ``--sps`` 2 or more runs the SPS
front-end (RRC matched filter, then ``--timing_method``; the Gardner and
Mueller-Mueller loops are one kernel launch on the card) before the model,
and ``--features`` picks the arm's input; `config.json` keeps both, so
``evaluate`` re-derives the same front-end.

``train --data_parallel D --model_parallel M`` trains over a (data, model)
mesh of D x M ranks, one process each, started by torchrun::

    torchrun --nproc_per_node 2 -m vitiq_torch.cli train --data_parallel 2 ...

(`runner.start_ranks`: NCCL when every local rank has a card of its own,
gloo otherwise, e.g. two ranks sharing one card; the world must be D x M;
scan training is off above one rank).
"""

from __future__ import annotations

import argparse
import json
import sys

from vitiq_torch.config import ExperimentConfig, _apply_overrides

PRESETS = ("vit_reference", "vit_tpu_production", "vit_synthetic19",
           "rawiq_synthetic19", "vit_tiny_2016", "rawiq_reference",
           "rawiq_best")


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arm", choices=["vit", "rawiq"], default=None)
    p.add_argument("--config", type=str, help="Path to experiment config JSON")
    p.add_argument("--preset", choices=PRESETS,
                   help="start from a named ExperimentConfig preset (e.g. rawiq_best = the "
                        "reference's best published checkpoint config); individual flags "
                        "still override")
    # data
    p.add_argument("--source", choices=["synthetic", "hdf5"], default=None)
    p.add_argument("--features", choices=["iq", "amp_phase", "spectrogram"], default=None,
                   help="input features: raw I/Q (both arms), the amplitude/phase "
                        "transform (rawiq) or STFT spectrogram images (vit)")
    p.add_argument("--file_path", type=str, help="Path to HDF5 data file")
    p.add_argument("--json_path", type=str, help="Path to classes JSON file")
    p.add_argument("--sps", type=int, default=None,
                   help="samples per symbol: 1 = RadioML bypass (default); >= 2 runs the "
                        "RRC matched filter and timing recovery before the model")
    p.add_argument("--timing_method",
                   choices=["simple_energy", "simple_correlation", "gardner", "mueller_muller"],
                   default=None, help="timing recovery for --sps >= 2")
    p.add_argument("--timing_hybrid_window", type=int, default=None,
                   help="gardner/mueller_muller: hybrid tracking-window length (default "
                        "64; 0 = the full per-symbol feedback loop for drifting clocks)")
    p.add_argument("--streaming", action="store_true", default=None,
                   help="stream splits from the HDF5 file")
    p.add_argument("--stream_window_rows", type=int,
                   help="shuffle-window size (rows) for --streaming")
    p.add_argument("--profile_steps", action="store_true", default=None,
                   help="record per-step wall times (step_p50/step_p90 in the history)")
    # training
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_epochs", type=int)
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--weight_decay", type=float)
    p.add_argument("--grad_clip_max_norm", type=float)
    p.add_argument("--data_parallel", type=int)
    p.add_argument("--model_parallel", type=int)
    # model
    p.add_argument("--d_model", type=int)
    p.add_argument("--n_head", type=int)
    p.add_argument("--n_layers", type=int)
    p.add_argument("--ffn_hidden", type=int)
    p.add_argument("--drop_prob", type=float)
    p.add_argument("--patch_size", type=int)
    p.add_argument("--segment_size", type=int)
    p.add_argument("--seq_length", type=int,
                   help="rawiq arm: token-stream length the model consumes (= frame_len / sps)")
    p.add_argument("--frame_len", type=int, help="synthetic source: samples per generated frame")
    p.add_argument("--frames_per_class", type=int,
                   help="synthetic source: frames generated per class")
    p.add_argument("--shaping_sps", type=int,
                   help="synthetic source: RRC-shape constellation frames at this oversampling")
    p.add_argument("--embedding_type", choices=["conv1d", "segment"])
    p.add_argument("--pooling", choices=["cls", "mean"],
                   help="rawiq arm readout: the CLS token or the mean over tokens")
    p.add_argument("--numerics", choices=["reference", "tpu"])
    # other
    p.add_argument("--resume", type=str,
                   help="Checkpoint to resume from, or 'auto' for the newest in the experiment "
                        "directory")
    p.add_argument("--experiment_name", type=str)
    p.add_argument("--no_validate_config", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="Device to train on (default cuda; cpu runs on the host)")
    p.add_argument("--no_plots", action="store_true",
                   help="Skip the plots (they need matplotlib and seaborn)")


def _config_from_args(args) -> ExperimentConfig:
    if args.config:
        cfg = ExperimentConfig.from_json(args.config)
    elif getattr(args, "preset", None):
        cfg = getattr(ExperimentConfig, args.preset)()
    elif args.arm == "rawiq":
        cfg = ExperimentConfig.rawiq_reference()
    else:
        cfg = ExperimentConfig.vit_reference()
    if args.arm and args.arm != cfg.model.arm:
        cfg.model.arm = args.arm
        cfg.model.in_channels = 0
        cfg.model.__post_init__()  # re-derive in_channels for the arm
    overrides = {
        "data.source": args.source,
        "data.features": args.features,
        "data.file_path": args.file_path,
        "data.json_path": args.json_path,
        "data.streaming": args.streaming,
        "data.stream_window_rows": args.stream_window_rows,
        "data.sps": args.sps,
        "data.timing_method": args.timing_method,
        "data.timing_hybrid_window": args.timing_hybrid_window,
        "train.profile_steps": args.profile_steps,
        "train.batch_size": args.batch_size,
        "train.num_epochs": args.num_epochs,
        "train.learning_rate": args.learning_rate,
        "train.weight_decay": args.weight_decay,
        "train.grad_clip_max_norm": args.grad_clip_max_norm,
        "train.data_parallel": args.data_parallel,
        "train.model_parallel": args.model_parallel,
        "model.d_model": args.d_model,
        "model.n_head": args.n_head,
        "model.n_layers": args.n_layers,
        "model.ffn_hidden": args.ffn_hidden,
        "model.drop_prob": args.drop_prob,
        "model.patch_size": args.patch_size,
        "model.segment_size": args.segment_size,
        "model.seq_length": args.seq_length,
        "data.synthetic_frame_len": args.frame_len,
        "data.synthetic_frames_per_class": args.frames_per_class,
        "data.synthetic_shaping_sps": args.shaping_sps,
        "model.embedding_type": args.embedding_type,
        "model.use_cls_token": None if args.pooling is None else args.pooling == "cls",
        "model.numerics": args.numerics,
        "experiment_name": args.experiment_name,
    }
    cfg = _apply_overrides(cfg, overrides)
    if cfg.data.source == "synthetic":
        # synthetic class count drives the head size
        cfg.model.num_classes = len(cfg.data.synthetic_classes)
    if not args.no_validate_config:
        cfg.validate(check_paths=cfg.data.source == "hdf5")
    return cfg


def cmd_train(args) -> int:
    from vitiq_torch.runner import run_training

    from vitiq_torch.parallel import comm

    cfg = _config_from_args(args)
    summary = run_training(cfg, resume=args.resume, device=args.device,
                           make_plots=not args.no_plots)
    if comm.rank() == 0:
        print(json.dumps({k: v for k, v in summary.items() if k != "history"}, indent=2,
                         default=float))
    return 0


def cmd_evaluate(args) -> int:
    if args.torch_checkpoint:
        from vitiq_torch.runner import run_reference_evaluation

        res = run_reference_evaluation(
            args.torch_checkpoint, config_path=args.config, output_dir=args.output,
            dataset=args.dataset, batch_size=args.batch_size, data_path=args.data_path,
            json_path=args.json_path, device=args.device, make_plots=not args.no_plots)
    elif args.checkpoint:
        from vitiq_torch.runner import run_evaluation

        res = run_evaluation(args.checkpoint, dataset=args.dataset, batch_size=args.batch_size,
                             config_path=args.config, int8=args.int8, device=args.device,
                             make_plots=not args.no_plots)
    else:
        raise SystemExit("evaluate: --checkpoint or --torch-checkpoint is required")
    print(f"overall accuracy: {res['overall_accuracy'] * 100:.2f}%")
    for snr, acc in sorted(res["snr_accuracies"].items()):
        print(f"  SNR {snr:+3d} dB: {acc * 100:.2f}%")
    return 0


def cmd_compare(args) -> int:
    from vitiq_torch.eval.compare import ModelComparison

    mc = ModelComparison(args.vit_report, args.transformer_report, output_dir=args.output_dir)
    mc.run_comparison(make_plots=not args.no_plots)
    return 0


def cmd_export(args) -> int:
    from vitiq_torch.serve import export_from_experiment

    out = export_from_experiment(
        args.experiment_dir, args.output,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        platforms=args.platforms.split(",") if args.platforms else None,
        checkpoint=args.checkpoint,
    )
    manifest = json.loads((out / "manifest.json").read_text())
    print(json.dumps({"artifact": str(out), "batch_sizes": manifest["batch_sizes"],
                      "platforms": manifest["platforms"], "entries": manifest["entries"]},
                     indent=2))
    return 0


def head_to_head_configs(args):
    """(vit_cfg, rawiq_cfg) of `cmd_head_to_head`: the ViT arm from the
    flags, the rawIQ arm from the same flags (its arm's preset defaults where
    no flag overrides them) on a deep copy of the ViT arm's data."""
    import copy

    base_name = args.experiment_name or "h2h"
    args.arm = "vit"
    vit_cfg = _config_from_args(args)
    vit_cfg.experiment_name = f"{base_name}_vit"
    rawiq_args = copy.copy(args)
    rawiq_args.arm = "rawiq"
    rawiq_cfg = _config_from_args(rawiq_args)
    rawiq_cfg.data = copy.deepcopy(vit_cfg.data)  # identical data for both arms
    rawiq_cfg.data.features = "iq"
    rawiq_cfg.experiment_name = f"{base_name}_rawiq"
    return vit_cfg, rawiq_cfg


def cmd_head_to_head(args) -> int:
    from vitiq_torch.runner import run_head_to_head

    vit_cfg, rawiq_cfg = head_to_head_configs(args)
    result = run_head_to_head(vit_cfg, rawiq_cfg, comparison_dir=args.output_dir,
                              device=args.device, make_plots=not args.no_plots)
    print(json.dumps(result, indent=2, default=float))
    return 0


def cmd_visualize(args) -> int:
    from vitiq_torch.viz import run_visualization

    run_visualization(
        file_path=args.file_path, json_path=args.json_path,
        output_dir=args.output_dir, modulations=args.modulations,
        num_samples=args.num_samples, create_overview=args.create_overview,
        dpi=args.dpi, sps=args.sps,
    )
    return 0


def cmd_sweep(args) -> int:
    from vitiq_torch.sweep import run_pso_sweep

    best = run_pso_sweep(
        n_particles=args.n_particles, iters=args.iters, seed=args.seed,
        train_steps=args.train_steps, source=args.source,
        file_path=args.file_path, json_path=args.json_path,
        output_path=args.output,
        resume_path=args.output if args.resume else None,
        device=args.device,
    )
    print(json.dumps(best, indent=2, default=float))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vitiq_torch", description="PyTorch/CUDA port of vitiq (ViT vs raw-IQ AMC)")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("train", help="Train an AMC transformer")
    _add_train_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="Evaluate a trained experiment")
    p.add_argument("--checkpoint",
                   help="Experiment directory (containing config.json + model_best)")
    p.add_argument("--torch-checkpoint", dest="torch_checkpoint",
                   help="Evaluate a reference PyTorch .pth instead (config from --config, a "
                        "sibling config.json, or the checkpoint's embedded reference config)")
    p.add_argument("--data-path", dest="data_path",
                   help="HDF5 dataset path override (with --torch-checkpoint)")
    p.add_argument("--json-path", dest="json_path",
                   help="classes JSON path override (with --torch-checkpoint)")
    p.add_argument("--output",
                   help="Artifact directory (with --torch-checkpoint; default "
                        "result/reference_import/<stem>/evaluation)")
    p.add_argument("--dataset", choices=["train", "valid", "test"], default="test")
    p.add_argument("--batch_size", type=int)
    p.add_argument("--config", type=str, help="Override config JSON path")
    p.add_argument("--int8", action="store_true",
                   help="Evaluate through the int8 W8A8 serving path")
    p.add_argument("--device", default="cuda",
                   help="Device to run the model on (default cuda; cpu runs on the host)")
    p.add_argument("--no_plots", action="store_true",
                   help="Skip the plots (they need matplotlib and seaborn)")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("export", help="Export a serving artifact (the weights, config and stats; "
                                      "one CUDA graph a bucket when loaded on the card)")
    p.add_argument("--experiment_dir", required=True,
                   help="Training-run directory (config.json + normalization_stats.json + "
                        "model_best.npz)")
    p.add_argument("--output", required=True, help="Artifact directory to write")
    p.add_argument("--batch_sizes", default="256,8192",
                   help="Comma-separated fixed batch buckets")
    p.add_argument("--platforms", default=None,
                   help="Comma-separated devices it may load on (cuda, cpu); default cuda")
    p.add_argument("--checkpoint", default="model_best.npz",
                   help="Weights file inside the experiment dir")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("compare", help="Compare two classification reports")
    p.add_argument("--vit_report", required=True)
    p.add_argument("--transformer_report", required=True)
    p.add_argument("--output_dir", default="comparison_results")
    p.add_argument("--no_plots", action="store_true",
                   help="Skip the plots (they need matplotlib and seaborn)")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("head-to-head", help="Train both arms on the same data and compare")
    _add_train_args(p)
    p.add_argument("--output_dir", default="comparison_results")
    p.set_defaults(fn=cmd_head_to_head)

    p = sub.add_parser("visualize", help="Preprocessing visualization figures")
    p.add_argument("--file_path", type=str, default=None,
                   help="HDF5 path (omit for synthetic data)")
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--output_dir", default="visualization_results")
    p.add_argument("--modulations", nargs="+", default=None)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--create_overview", action="store_true")
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--sps", type=int, default=1)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("sweep", help="PSO hyperparameter search")
    p.add_argument("--n_particles", type=int, default=18)
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_steps", type=int, default=30)
    p.add_argument("--source", choices=["synthetic", "hdf5"], default="synthetic")
    p.add_argument("--file_path", type=str)
    p.add_argument("--json_path", type=str)
    p.add_argument("--output", type=str, default="sweep_results.json")
    p.add_argument("--resume", action="store_true",
                   help="Resume the exact swarm trajectory from a partial "
                        "trace at --output (written every iteration)")
    p.add_argument("--device", default="cuda",
                   help="Device to train on (default cuda; cpu runs on the host)")
    p.set_defaults(fn=cmd_sweep)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
