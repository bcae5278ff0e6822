"""Command-line interface (counterpart of `vitiq/cli.py`): ``evaluate`` so
far, with the JAX package's argument names and printed lines.

    python -m vitiq_torch.cli evaluate --checkpoint DIR [--dataset test]
        [--batch_size N] [--config PATH] [--int8] [--device cuda] [--no_plots]

``--device`` (default ``cuda``) picks where the model runs; ``--device cpu``
runs on the host. ``--no_plots`` skips the plots, which need matplotlib and
seaborn. The other subcommands (train, compare, bench, ...) and
``--torch-checkpoint`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def cmd_evaluate(args) -> int:
    from vitiq_torch.runner import run_evaluation

    res = run_evaluation(args.checkpoint, dataset=args.dataset, batch_size=args.batch_size,
                         config_path=args.config, int8=args.int8, device=args.device,
                         make_plots=not args.no_plots)
    print(f"overall accuracy: {res['overall_accuracy'] * 100:.2f}%")
    for snr, acc in sorted(res["snr_accuracies"].items()):
        print(f"  SNR {snr:+3d} dB: {acc * 100:.2f}%")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vitiq_torch", description="PyTorch/CUDA port of vitiq (ViT vs raw-IQ AMC)")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("evaluate", help="Evaluate a trained experiment")
    p.add_argument("--checkpoint", required=True,
                   help="Experiment directory (containing config.json + model_best)")
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
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
