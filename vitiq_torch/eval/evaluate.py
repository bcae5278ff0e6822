"""Model evaluation (counterpart of `vitiq/eval/evaluate.py`): batched
inference on the model's device, the overall and per-SNR confusion matrices,
the classification report, accuracy against SNR and the pickled results.

Artifacts, as the JAX package writes them:

  {prefix}_confusion_matrix_overall.png
  {prefix}_confusion_matrix_snr_{t}dB.png   for t in (-8, 0, 8) within 0.5 dB
  {prefix}_classification_report.txt
  {prefix}_accuracy_vs_snr.png
  {prefix}_results.pkl

The plots need matplotlib and seaborn (``make_plots=False`` skips them); the
confusion matrices and the report are numpy. Batches reach the device
through `data/pipeline.py`'s `device_prefetch` (on the card: pinned memory,
a side stream, a worker thread ahead of the model), and the predictions stay
on the device until the pass ends: one copy to the host a pass.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vitiq_torch.data.pipeline import device_prefetch
from vitiq_torch.eval.report import confusion_matrix, write_classification_report

TARGET_SNRS = (-8, 0, 8)  # ref: ViT/training/utils.py:349


@torch.no_grad()
def predict_feed(forward_fn: Callable, feed, batch_size: int, device,
                 preprocess_fn: Optional[Callable] = None, prefetch_depth: int = 3):
    """Predictions over a DataFeed's raw (x, y, snr) batches: each batch is
    padded to `batch_size` with zero frames on the host, prefetched to
    `device`, run through `preprocess_fn` and `forward_fn`, and the argmax of
    its valid rows kept on the device; labels and SNRs stay on the host.
    Returns (preds, labels, snrs) numpy, the predictions copied once."""
    device = torch.device(device)

    def padded():
        for bx, by, bz in feed.raw_batches(batch_size):
            n_valid = len(bx)
            bx = np.asarray(bx, np.float32)
            if n_valid < batch_size:
                bx = np.concatenate(
                    [bx, np.zeros((batch_size - n_valid,) + bx.shape[1:], bx.dtype)])
            yield bx, (np.asarray(by), np.asarray(bz)), n_valid

    preds, labels, snrs = [], [], []
    for x, (by, bz), n_valid in device_prefetch(padded(), device, prefetch_depth):
        x = torch.as_tensor(x, device=device)
        inputs = preprocess_fn(x) if preprocess_fn is not None else x
        preds.append(forward_fn(inputs).argmax(dim=-1)[:n_valid])
        labels.append(by)
        snrs.append(bz)
    return torch.cat(preds).cpu().numpy(), np.concatenate(labels), np.concatenate(snrs)


def evaluate_feed_with_confusion(
    forward_fn: Callable,
    feed,
    class_names: Sequence[str],
    save_dir: str | Path,
    device,
    prefix: str = "test",
    batch_size: int = 256,
    preprocess_fn: Optional[Callable] = None,
    save_pickle: bool = True,
    make_plots: bool = True,
    verbose: bool = True,
) -> Dict:
    """`predict_feed` then `confusion_artifacts`; returns the results dict."""
    preds, labels, snrs = predict_feed(forward_fn, feed, batch_size, device, preprocess_fn)
    return confusion_artifacts(preds, labels, snrs, class_names, save_dir, prefix=prefix,
                               save_pickle=save_pickle, make_plots=make_plots,
                               verbose=verbose)


def confusion_artifacts(
    preds: np.ndarray,
    labels: np.ndarray,
    snrs: np.ndarray,
    class_names: Sequence[str],
    save_dir: str | Path,
    prefix: str = "test",
    save_pickle: bool = True,
    make_plots: bool = True,
    verbose: bool = True,
) -> Dict:
    """The confusion matrices, the report, accuracy against SNR and the
    pickle, given predictions (ref: ViT/training/utils.py:284-466)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    if make_plots:
        from vitiq_torch.eval.plots import plot_accuracy_vs_snr, plot_confusion_matrix

    # 1. overall confusion matrix
    if make_plots:
        cm_overall, acc_overall = plot_confusion_matrix(
            labels, preds, class_names,
            title=f"Overall Confusion Matrix - {prefix.capitalize()} Set",
            save_path=save_dir / f"{prefix}_confusion_matrix_overall.png",
        )
    else:
        cm_overall = confusion_matrix(labels, preds, len(class_names))
        acc_overall = float((labels == preds).mean())
    if verbose:
        print(f"Overall Accuracy: {acc_overall * 100:.2f}%")

    # 2. per-SNR confusion matrices at the target SNRs (within 0.5 dB)
    snr_accuracies: Dict[int, float] = {}
    for target in TARGET_SNRS:
        mask = np.abs(snrs - target) <= 0.5
        if mask.sum() == 0:
            if verbose:
                print(f"no samples found for SNR = {target} dB")
            continue
        if make_plots:
            _, acc = plot_confusion_matrix(
                labels[mask], preds[mask], class_names,
                title=f"Confusion Matrix - {prefix.capitalize()} Set (SNR = {target} dB)",
                save_path=save_dir / f"{prefix}_confusion_matrix_snr_{target}dB.png",
            )
        else:
            acc = float((labels[mask] == preds[mask]).mean())
        snr_accuracies[target] = acc
        if verbose:
            print(f"Accuracy @ {target} dB: {acc * 100:.2f}%  ({int(mask.sum()):,} samples)")

    # 3. the classification report, the format the comparison tool parses
    write_classification_report(
        save_dir / f"{prefix}_classification_report.txt",
        prefix, acc_overall, snr_accuracies, labels, preds, list(class_names),
    )

    # 4. accuracy against every unique SNR
    snr_acc_pairs: List = []
    for snr in sorted(np.unique(snrs)):
        m = snrs == snr
        if m.sum() > 0:
            snr_acc_pairs.append((float(snr), float((preds[m] == labels[m]).mean() * 100)))
    if make_plots and snr_acc_pairs:
        plot_accuracy_vs_snr(snr_acc_pairs, acc_overall, TARGET_SNRS, prefix,
                             save_dir / f"{prefix}_accuracy_vs_snr.png")

    results = {
        "overall_accuracy": acc_overall,
        "snr_accuracies": snr_accuracies,
        "confusion_matrix": cm_overall,
        "predictions": preds,
        "labels": labels,
        "snrs": snrs,
        "accuracy_vs_snr": snr_acc_pairs,
    }
    if save_pickle:
        with open(save_dir / f"{prefix}_results.pkl", "wb") as f:
            pickle.dump(results, f)
    return results
