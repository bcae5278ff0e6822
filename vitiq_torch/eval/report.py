"""Classification-report text format: writer and parser (counterpart of
`vitiq/eval/report.py`).

The report file is the machine-readable API between evaluation and the
comparison tool, so its text is byte-identical to the JAX package's, which
writes scikit-learn's ``classification_report(labels=arange(C),
target_names, digits=4, zero_division=0)`` under a header. The table is
computed here with numpy alone, with scikit-learn's arithmetic (float64
ratios, the same averages) and its column layout, so the report needs no
scikit-learn where the port runs.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

DIGITS = 4
_HEADERS = ("precision", "recall", "f1-score", "support")


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den in float64, 0 where den is 0 (zero_division=0)."""
    den = np.asarray(den, dtype=np.float64).copy()
    mask = den == 0
    den[mask] = 1
    out = np.asarray(num, dtype=np.float64) / den
    out[mask] = 0.0
    return out


def _scores(tp: np.ndarray, pred_sum: np.ndarray, true_sum: np.ndarray):
    """precision, recall, F1 (= 2 tp / (true + pred)) per entry."""
    return (_divide(tp, pred_sum), _divide(tp, true_sum),
            _divide(2.0 * tp.astype(np.float64),
                    true_sum.astype(np.float64) + pred_sum.astype(np.float64)))


def _weighted(a: np.ndarray, weights: np.ndarray) -> float:
    try:
        return float(np.average(a, weights=weights))
    except ZeroDivisionError:  # every weight 0: the plain mean
        return float(np.average(a))


def classification_report_text(labels: np.ndarray, preds: np.ndarray,
                               class_names: List[str]) -> str:
    """scikit-learn's ``classification_report(labels, preds,
    labels=arange(C), target_names=class_names, digits=4, zero_division=0)``
    text, for integer labels and predictions."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    preds = np.asarray(preds).astype(np.int64).ravel()
    n = len(class_names)
    cm = confusion_matrix(labels, preds, n)
    tp = np.diag(cm)
    pred_sum, true_sum = cm.sum(axis=0), cm.sum(axis=1)
    if not np.any(labels == preds):
        # scikit-learn's counts are float zeros when no prediction is right
        # (multilabel_confusion_matrix), so every support prints as a float
        true_sum = true_sum.astype(np.float64)
    p, r, f1 = _scores(tp, pred_sum, true_sum)

    width = max(max(len(c) for c in class_names), len("weighted avg"), DIGITS)
    head_fmt = "{:>{width}s} " + " {:>9}" * len(_HEADERS)
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    report = head_fmt.format("", *_HEADERS, width=width) + "\n\n"
    for row in zip(class_names, p, r, f1, true_sum):
        report += row_fmt.format(*row, width=width, digits=DIGITS)
    report += "\n"

    support = true_sum.sum()
    # micro average: "accuracy" when no label or prediction lies outside the classes
    mp, mr, mf = (float(v[0]) for v in _scores(tp.sum(keepdims=True),
                                                pred_sum.sum(keepdims=True),
                                                true_sum.sum(keepdims=True)))
    seen = np.union1d(labels, preds)
    if seen.size == 0 or (seen.min() >= 0 and seen.max() < n):
        acc_fmt = "{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n"
        report += acc_fmt.format("accuracy", "", "", mf, support, width=width, digits=DIGITS)
    else:
        report += row_fmt.format("micro avg", mp, mr, mf, support, width=width, digits=DIGITS)
    report += row_fmt.format("macro avg", float(np.nanmean(p)), float(np.nanmean(r)),
                             float(np.nanmean(f1)), support, width=width, digits=DIGITS)
    report += row_fmt.format("weighted avg", _weighted(p, true_sum), _weighted(r, true_sum),
                             _weighted(f1, true_sum), support, width=width, digits=DIGITS)
    return report


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, n_classes: int) -> np.ndarray:
    """[n_classes, n_classes] int64 counts, rows true, columns predicted;
    pairs with a label or prediction outside the classes are left out."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    preds = np.asarray(preds).astype(np.int64).ravel()
    keep = (labels >= 0) & (labels < n_classes) & (preds >= 0) & (preds < n_classes)
    flat = labels[keep] * n_classes + preds[keep]
    return np.bincount(flat, minlength=n_classes * n_classes).reshape(n_classes, n_classes)


def write_classification_report(
    path: str | Path,
    prefix: str,
    overall_accuracy: float,
    snr_accuracies: Dict[int, float],
    labels: np.ndarray,
    preds: np.ndarray,
    class_names: List[str],
) -> Path:
    """Write the reference report format (header, overall accuracy, accuracy
    by SNR, then the per-class table); accuracies are fractions in [0, 1]."""
    report = classification_report_text(labels, preds, list(class_names))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"Classification Report - {prefix.capitalize()} Set\n")
        f.write("=" * 80 + "\n\n")
        f.write(f"Overall Accuracy: {overall_accuracy * 100:.2f}%\n\n")
        f.write("Accuracy by SNR:\n")
        for snr, acc in snr_accuracies.items():
            f.write(f"  SNR {snr:+3d} dB: {acc * 100:.2f}%\n")
        f.write("\n" + "=" * 80 + "\n\n")
        f.write(report)
    return path


class ClassificationReportParser:
    """Regex parser for report text files (ref: compare_models.py:23-60).

    Exposes overall_accuracy / snr_accuracies in PERCENT (as the reference
    does) and per-class precision/recall/f1/support. The class-name regex
    also matches hyphenated names like AM-SSB-WC.
    """

    def __init__(self, report_path: str | Path):
        self.report_path = Path(report_path)
        self.overall_accuracy: Optional[float] = None
        self.snr_accuracies: Dict[int, float] = {}
        self.class_metrics: Dict[str, Dict[str, float]] = {}
        self.parse_report()

    def parse_report(self) -> None:
        content = self.report_path.read_text()

        overall = re.search(r"Overall Accuracy:\s+([\d.]+)%", content)
        if overall:
            self.overall_accuracy = float(overall.group(1))

        for snr, acc in re.findall(r"SNR\s+([-+]\d+)\s+dB:\s+([\d.]+)%", content):
            self.snr_accuracies[int(snr)] = float(acc)

        class_pattern = r"^\s*([\w-]+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)\s+(\d+)\s*$"
        for line in content.split("\n"):
            match = re.match(class_pattern, line)
            if match:
                name, precision, recall, f1, support = match.groups()
                if name not in ("accuracy", "macro", "weighted"):
                    self.class_metrics[name] = {
                        "precision": float(precision),
                        "recall": float(recall),
                        "f1-score": float(f1),
                        "support": int(support),
                    }
