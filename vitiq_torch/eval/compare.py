"""Cross-arm comparison (counterpart of `vitiq/eval/compare.py`): parses two
classification-report files (the ViT arm and the raw-IQ arm) and writes

  summary_comparison.csv    overall and per-SNR accuracy with differences
  detailed_comparison.csv   per-class precision / recall / F1 side by side
  snr_comparison.png        grouped bars across SNR levels
  per_class_metrics.png     per-class metric bars
  f1_difference_heatmap.png F1 delta per class
  overall_comparison.png    4-panel summary

and returns the key insights (top improved and degraded classes).

The JAX package builds its two tables as pandas DataFrames; the port needs
no pandas. A table here is a plain dict from column name to column, in
column order: the text columns are lists of str, the numeric ones 1-D numpy
arrays (float64; `Support` int64). `write_csv` writes such a table as
`DataFrame.to_csv(index=False)` writes the DataFrame, byte for byte: floats
by numpy's shortest round-trip text (``0.0``, ``1e-05``, ``inf``), NaN as an
empty field, text quoted only where the csv module must; a table with no
columns is one empty line. The order of the top improved and degraded
classes repeats pandas' `sort_values` (`argsort_like_pandas`), ties
included. matplotlib and seaborn are imported inside the plot methods, so
the comparison runs where they are absent with ``make_plots=False``.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List

import numpy as np

from vitiq_torch.eval.plots import _pyplot
from vitiq_torch.eval.report import ClassificationReportParser

SUMMARY_METRICS = ("Overall Accuracy (%)", "SNR -8 dB (%)", "SNR 0 dB (%)", "SNR +8 dB (%)")


def argsort_like_pandas(values: np.ndarray, ascending: bool = True) -> np.ndarray:
    """The row order of ``Series.sort_values(ascending=...)`` (pandas'
    `nargsort` with its default quicksort): NaN last; descending sorts the
    reversed values and reverses the result, so equal values come out in the
    order pandas gives them."""
    values = np.asarray(values, dtype=np.float64)
    idx = np.arange(len(values))
    mask = np.isnan(values)
    keys, keep = values[~mask], idx[~mask]
    if not ascending:
        keys, keep = keys[::-1], keep[::-1]
    order = keep[keys.argsort(kind="quicksort")]
    if not ascending:
        order = order[::-1]
    return np.concatenate([order, np.nonzero(mask)[0]])


def _csv_cells(column) -> List[str]:
    """One column's cells as `DataFrame.to_csv` writes them."""
    if isinstance(column, np.ndarray) and column.dtype.kind == "f":
        cells = column.astype(str)
        cells[np.isnan(column)] = ""
        return cells.tolist()
    return [str(v) for v in column]


def write_csv(table: Dict[str, object], path: str | Path) -> None:
    """`DataFrame(table).to_csv(path, index=False)` without pandas."""
    columns = [_csv_cells(col) for col in table.values()]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(table))
        writer.writerows(zip(*columns))


class ModelComparison:
    """Comparison between two evaluated models from their report files."""

    def __init__(
        self,
        vit_report_path: str | Path,
        transformer_report_path: str | Path,
        output_dir: str | Path = "comparison_results",
        vit_name: str = "ViT (Vision Transformer)",
        transformer_name: str = "Transformer (Raw IQ)",
    ):
        self.vit_parser = ClassificationReportParser(vit_report_path)
        self.transformer_parser = ClassificationReportParser(transformer_report_path)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.vit_name = vit_name
        self.transformer_name = transformer_name

    # ---- tables ----------------------------------------------------------
    def _arm_accuracies(self, parser: ClassificationReportParser) -> np.ndarray:
        return np.array([parser.overall_accuracy, parser.snr_accuracies.get(-8, 0),
                         parser.snr_accuracies.get(0, 0), parser.snr_accuracies.get(8, 0)],
                        dtype=np.float64)

    def create_summary_table(self) -> Dict[str, object]:
        """Overall and target-SNR accuracy rows with Difference and
        Improvement (%), the latter rounded half to even to 2 decimals (inf
        where the ViT accuracy is 0, NaN for 0 / 0): {column: list of str or
        float64 array}."""
        vit = self._arm_accuracies(self.vit_parser)
        trans = self._arm_accuracies(self.transformer_parser)
        diff = trans - vit
        with np.errstate(divide="ignore", invalid="ignore"):
            improvement = np.round(diff / vit * 100, 2)
        return {"Metric": list(SUMMARY_METRICS), self.vit_name: vit,
                self.transformer_name: trans, "Difference": diff,
                "Improvement (%)": improvement}

    def create_detailed_comparison_table(self) -> Dict[str, object]:
        """Per-class metrics (in %) of the classes both reports hold, with
        the F1 Diff column: {column: list of str or numpy array}; {} where
        they share no class."""
        common = [c for c in self.vit_parser.class_metrics
                  if c in self.transformer_parser.class_metrics]
        if not common:
            return {}
        v = [self.vit_parser.class_metrics[c] for c in common]
        t = [self.transformer_parser.class_metrics[c] for c in common]

        def pct(rows, key):
            return np.array([r[key] * 100 for r in rows], dtype=np.float64)

        return {
            "Modulation": common,
            "ViT Precision": pct(v, "precision"),
            "ViT Recall": pct(v, "recall"),
            "ViT F1": pct(v, "f1-score"),
            "Trans Precision": pct(t, "precision"),
            "Trans Recall": pct(t, "recall"),
            "Trans F1": pct(t, "f1-score"),
            "F1 Diff": np.array([(b["f1-score"] - a["f1-score"]) * 100 for a, b in zip(v, t)],
                                dtype=np.float64),
            "Support": np.array([r["support"] for r in v], dtype=np.int64),
        }

    # ---- plots -----------------------------------------------------------
    def plot_snr_comparison(self) -> None:
        plt = _pyplot()
        snr_values = sorted(self.vit_parser.snr_accuracies)
        vit = [self.vit_parser.snr_accuracies[s] for s in snr_values]
        trans = [self.transformer_parser.snr_accuracies.get(s, 0) for s in snr_values]
        x = np.arange(len(snr_values))
        width = 0.35
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.bar(x - width / 2, vit, width, label=self.vit_name, alpha=0.8)
        ax.bar(x + width / 2, trans, width, label=self.transformer_name, alpha=0.8)
        ax.set_xlabel("SNR (dB)", fontsize=12, fontweight="bold")
        ax.set_ylabel("Accuracy (%)", fontsize=12, fontweight="bold")
        ax.set_title("Accuracy Comparison Across Different SNR Levels",
                     fontsize=14, fontweight="bold")
        ax.set_xticks(x)
        ax.set_xticklabels([f"{s:+d}" for s in snr_values])
        ax.legend(fontsize=10)
        ax.grid(True, axis="y", alpha=0.3)
        fig.tight_layout()
        fig.savefig(self.output_dir / "snr_comparison.png", dpi=300, bbox_inches="tight")
        plt.close(fig)

    def plot_per_class_metrics(self) -> None:
        df = self.create_detailed_comparison_table()
        if not df:
            return
        plt = _pyplot()
        x = np.arange(len(df["Modulation"]))
        width = 0.35
        fig, axes = plt.subplots(3, 1, figsize=(16, 14), sharex=True)
        for ax, metric in zip(axes, ("Precision", "Recall", "F1")):
            ax.bar(x - width / 2, df[f"ViT {metric}"], width, label=self.vit_name, alpha=0.8)
            ax.bar(x + width / 2, df[f"Trans {metric}"], width,
                   label=self.transformer_name, alpha=0.8)
            ax.set_ylabel(f"{metric} (%)")
            ax.legend(fontsize=9)
            ax.grid(True, axis="y", alpha=0.3)
        axes[-1].set_xticks(x)
        axes[-1].set_xticklabels(df["Modulation"], rotation=45, ha="right")
        fig.suptitle("Per-Class Metric Comparison", fontsize=14, fontweight="bold")
        fig.tight_layout()
        fig.savefig(self.output_dir / "per_class_metrics.png", dpi=300, bbox_inches="tight")
        plt.close(fig)

    def plot_f1_difference_heatmap(self) -> None:
        df = self.create_detailed_comparison_table()
        if not df:
            return
        plt = _pyplot()
        import seaborn as sns

        fig, ax = plt.subplots(figsize=(16, 3))
        sns.heatmap(df["F1 Diff"][None, :], annot=True, fmt=".1f", center=0, cmap="RdYlGn",
                    xticklabels=df["Modulation"], yticklabels=["F1 Diff (%)"], ax=ax)
        ax.set_title("F1-Score Difference (Transformer - ViT) by Modulation",
                     fontweight="bold")
        fig.tight_layout()
        fig.savefig(self.output_dir / "f1_difference_heatmap.png", dpi=300,
                    bbox_inches="tight")
        plt.close(fig)

    def plot_overall_comparison(self) -> None:
        plt = _pyplot()
        df = self.create_detailed_comparison_table()
        summary = self.create_summary_table()
        fig, axes = plt.subplots(2, 2, figsize=(15, 12))
        # (1) overall + SNR bars
        ax1 = axes[0, 0]
        x = np.arange(len(summary["Metric"]))
        width = 0.35
        ax1.bar(x - width / 2, summary[self.vit_name], width, label="ViT", alpha=0.8)
        ax1.bar(x + width / 2, summary[self.transformer_name], width,
                label="Transformer", alpha=0.8)
        ax1.set_xticks(x)
        ax1.set_xticklabels(summary["Metric"], rotation=20, ha="right", fontsize=8)
        ax1.set_ylabel("Accuracy (%)")
        ax1.set_title("Summary Metrics", fontweight="bold")
        ax1.legend()
        # (2) F1 scatter
        ax2 = axes[0, 1]
        if df:
            ax2.scatter(df["ViT F1"], df["Trans F1"], alpha=0.7)
            lim = [0, 100]
            ax2.plot(lim, lim, "k--", alpha=0.5)
            ax2.set_xlabel("ViT F1 (%)")
            ax2.set_ylabel("Transformer F1 (%)")
        ax2.set_title("Per-Class F1: Transformer vs ViT", fontweight="bold")
        # (3) F1 diff bars
        ax3 = axes[1, 0]
        if df:
            order = argsort_like_pandas(df["F1 Diff"])
            diffs = df["F1 Diff"][order]
            colors = ["#e74c3c" if d < 0 else "#2ecc71" for d in diffs]
            ax3.barh([df["Modulation"][i] for i in order], diffs, color=colors, alpha=0.8)
            ax3.axvline(0, color="k", linewidth=0.8)
        ax3.set_xlabel("F1 Diff (Transformer - ViT, %)")
        ax3.set_title("Per-Class F1 Difference", fontweight="bold")
        # (4) better/worse/equal pie
        ax4 = axes[1, 1]
        if df:
            diff = df["F1 Diff"]
            ax4.pie([int((diff > 0).sum()), int((diff < 0).sum()), int((diff == 0).sum())],
                    labels=["Better", "Worse", "Equal"], autopct="%1.1f%%",
                    colors=["#2ecc71", "#e74c3c", "#95a5a6"], startangle=90)
        ax4.set_title("Transformer vs ViT\n(F1-Score Comparison by Class)",
                      fontweight="bold", fontsize=12)
        fig.tight_layout()
        fig.savefig(self.output_dir / "overall_comparison.png", dpi=300,
                    bbox_inches="tight")
        plt.close(fig)

    # ---- report ----------------------------------------------------------
    def _print_summary(self, summary: Dict[str, object]) -> None:
        cells = {name: _csv_cells(col) for name, col in summary.items()}
        widths = {name: max(len(name), *map(len, col)) for name, col in cells.items()}
        print("  ".join(name.rjust(widths[name]) for name in cells))
        for i in range(len(summary["Metric"])):
            print("  ".join(cells[name][i].rjust(widths[name]) for name in cells))

    def generate_report(self, verbose: bool = True) -> Dict:
        summary = self.create_summary_table()
        write_csv(summary, self.output_dir / "summary_comparison.csv")
        detailed = self.create_detailed_comparison_table()
        write_csv(detailed, self.output_dir / "detailed_comparison.csv")

        insights: Dict = {
            "overall_improvement":
                self.transformer_parser.overall_accuracy - self.vit_parser.overall_accuracy,
            "snr_improvements": {
                snr: self.transformer_parser.snr_accuracies.get(snr, 0)
                - self.vit_parser.snr_accuracies[snr]
                for snr in sorted(self.vit_parser.snr_accuracies)
            },
        }
        if detailed:
            order = argsort_like_pandas(detailed["F1 Diff"], ascending=False)
            ranked = [(detailed["Modulation"][i], float(detailed["F1 Diff"][i])) for i in order]
            insights["top_improved"] = ranked[:3]
            insights["top_degraded"] = ranked[-3:]
        if verbose:
            print("=" * 80)
            print("AUTOMATIC MODULATION CLASSIFICATION - MODEL COMPARISON")
            print("=" * 80)
            self._print_summary(summary)
            print(f"\n1. Overall Accuracy Improvement: {insights['overall_improvement']:+.2f}%")
            for snr, diff in insights["snr_improvements"].items():
                print(f"2. SNR {snr:+d} dB Improvement: {diff:+.2f}%")
            if "top_improved" in insights:
                print("\n3. Top 3 Improved Modulations (F1-Score):")
                for name, diff in insights["top_improved"]:
                    print(f"   - {name}: {diff:+.2f}%")
                print("\n4. Top 3 Degraded Modulations (F1-Score):")
                for name, diff in insights["top_degraded"]:
                    print(f"   - {name}: {diff:+.2f}%")
        return insights

    def run_comparison(self, verbose: bool = True, make_plots: bool = True) -> Dict:
        """The CSVs and the insights; the four plots unless ``make_plots`` is
        False (they need matplotlib, and the heatmap seaborn)."""
        insights = self.generate_report(verbose=verbose)
        if make_plots:
            self.plot_overall_comparison()
            self.plot_snr_comparison()
            self.plot_per_class_metrics()
            self.plot_f1_difference_heatmap()
        return insights
