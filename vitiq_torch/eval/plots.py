"""Evaluation and training plots (counterpart of `vitiq/eval/plots.py`):
confusion-matrix heatmaps, accuracy against SNR, the two-panel training
history. matplotlib and seaborn are imported inside the functions, so the
package imports where they are absent; only plotting needs them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vitiq_torch.eval.report import confusion_matrix


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    class_names: Sequence[str],
    title: str = "Confusion Matrix",
    save_path: Optional[Path] = None,
    normalize: bool = True,
    figsize: Tuple[int, int] = (14, 12),
) -> Tuple[np.ndarray, float]:
    """Heatmap; returns (cm, accuracy) like the reference
    (ref: ViT/training/utils.py:216-281)."""
    import seaborn as sns

    plt = _pyplot()
    cm = confusion_matrix(y_true, y_pred, len(class_names))
    accuracy = float((y_true == y_pred).mean()) if len(y_true) else 0.0

    display = cm.astype(np.float64)
    if normalize:
        row_sums = display.sum(axis=1, keepdims=True)
        display = np.divide(display, np.maximum(row_sums, 1), where=row_sums > 0)

    fig, ax = plt.subplots(figsize=figsize)
    sns.heatmap(
        display, annot=len(class_names) <= 24, fmt=".2f" if normalize else ".0f",
        cmap="Blues", xticklabels=class_names, yticklabels=class_names,
        square=True, cbar_kws={"label": "Proportion" if normalize else "Count"}, ax=ax,
    )
    ax.set_xlabel("Predicted Label")
    ax.set_ylabel("True Label")
    ax.set_title(f"{title}\nAccuracy: {accuracy * 100:.2f}%")
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return cm, accuracy


def plot_accuracy_vs_snr(
    snr_accuracy_pairs: List[Tuple[float, float]],
    overall_accuracy: float,
    target_snrs: Sequence[int],
    prefix: str,
    save_path: Path,
) -> None:
    """Line plot of accuracy over every unique SNR with the overall accuracy
    as a reference line (ref: ViT/training/utils.py:408-443). Percent."""
    plt = _pyplot()
    snrs, accs = zip(*snr_accuracy_pairs)
    fig = plt.figure(figsize=(12, 6))
    plt.plot(snrs, accs, "b-o", linewidth=2, markersize=6)
    plt.axhline(y=overall_accuracy * 100, color="r", linestyle="--", linewidth=2,
                label=f"Overall: {overall_accuracy * 100:.2f}%")
    for t in target_snrs:
        plt.axvline(x=t, color="gray", linestyle=":", alpha=0.5)
    plt.xlabel("SNR (dB)", fontsize=12)
    plt.ylabel("Accuracy (%)", fontsize=12)
    plt.title(f"Accuracy vs SNR - {prefix.capitalize()} Set", fontsize=14, fontweight="bold")
    plt.grid(True, alpha=0.3)
    plt.legend(fontsize=11)
    plt.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def plot_training_history(history: Dict[str, list], save_path: Path) -> None:
    """2-panel loss/accuracy curves (ref: ViT/training/utils.py:177-213)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 5))
    epochs = np.arange(1, len(history["train_loss"]) + 1)
    ax1.plot(epochs, history["train_loss"], "b-", label="Train Loss")
    ax1.plot(epochs, history["val_loss"], "r-", label="Validation Loss")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    ax1.set_title("Training and Validation Loss")
    ax1.legend()
    ax1.grid(True, alpha=0.3)
    ax2.plot(epochs, np.asarray(history["train_acc"]) * 100, "b-", label="Train Accuracy")
    ax2.plot(epochs, np.asarray(history["val_acc"]) * 100, "r-", label="Validation Accuracy")
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel("Accuracy (%)")
    ax2.set_title("Training and Validation Accuracy")
    ax2.legend()
    ax2.grid(True, alpha=0.3)
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
