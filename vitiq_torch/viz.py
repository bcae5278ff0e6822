"""Preprocessing visualization tool (counterpart of `vitiq/viz.py`).

For each modulation, an 8-panel figure: raw I/Q, raw and normalized
constellations, the stats, the ViT [1, 32, 64] image, the transformer [2, L]
sequence, the `extract_symbols` constellation and the normalized amplitude
histogram; optionally a constellation overview of all modulations, and at
sps > 1 the four timing-recovery methods side by side. vitiq's figures under
vitiq's file names, computed with the port's `dsp/` and
`data/synthetic.generate_test_signal`.

Works from the RadioML HDF5 when given a file path (h5py), or from the
synthetic generator otherwise. This is a host tool: the DSP runs on the CPU
(`DEVICE`), and matplotlib is imported inside the functions (`_pyplot`, as
`eval/plots.py` does), so the package imports where matplotlib is absent.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from vitiq_torch.dsp import (
    apply_normalization,
    extract_symbols,
    preprocess_for_transformer,
    preprocess_for_vit,
)

DEVICE = "cpu"  # where extract_symbols runs its filter and loops


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    return plt


def _collect_frames(file_path, json_path, modulations, num_samples, seed=42):
    """-> (frames dict {mod: [n, L, 2]}, normalization stats)."""
    if file_path:
        from vitiq_torch.config import DataConfig
        from vitiq_torch.data import HDF5DataSource

        src = HDF5DataSource(file_path, json_path)
        mods = modulations or src.available_modulations[:5]
        dcfg = DataConfig(source="hdf5", file_path=file_path, json_path=json_path,
                          target_modulations=tuple(mods))
        s = src.split(dcfg)
        stats = src.normalization_stats(s.train, dcfg)
        rng = np.random.default_rng(seed)
        frames = {}
        for mod in mods:
            rows = np.where(src.y_strings == mod)[0]
            # prefer high-SNR rows for legible constellations (the reference
            # visualizes snr=30 samples, ref: visualization_results/*)
            high = rows[src.z[rows] >= 20] if (src.z[rows] >= 20).any() else rows
            pick = rng.choice(high, min(num_samples, len(high)), replace=False)
            frames[mod] = src.read_rows(np.asarray(pick))
        src.close()
    else:
        from vitiq_torch.data import SyntheticAMCDataset
        from vitiq_torch.data.synthetic import SYNTHETIC_MODULATIONS

        mods = modulations or ["BPSK", "QPSK", "16QAM"]
        unknown = [m for m in mods if m not in SYNTHETIC_MODULATIONS]
        if unknown:
            raise ValueError(f"synthetic mode supports {SYNTHETIC_MODULATIONS}, got {unknown}")
        ds = SyntheticAMCDataset(classes=tuple(mods), frames_per_class=max(num_samples, 64),
                                 frame_len=1024, snrs_db=(30.0,), seed=seed)
        frames = {}
        for i, mod in enumerate(mods):
            rows = np.where(ds.Y == i)[0][:num_samples]
            frames[mod] = ds.X[rows]
        from vitiq_torch.data import stats_from_array
        stats = stats_from_array(ds.X, np.arange(len(ds)), seed=49)
    return frames, stats


def plot_modulation_pipeline(
    frame: np.ndarray,
    modulation: str,
    stats: Dict[str, float],
    save_path: Path,
    dpi: int = 150,
    sps: int = 1,
) -> None:
    """8-panel preprocessing figure for one frame [L, 2]
    (ref: plot_preprocessing_signal.py:242-380)."""
    i_sig, q_sig = frame[:, 0].astype(np.float64), frame[:, 1].astype(np.float64)
    i_norm, q_norm = apply_normalization(i_sig, q_sig, stats)
    vit_img = preprocess_for_vit(i_sig, q_sig, stats)
    seq = preprocess_for_transformer(i_sig, q_sig, stats)
    symbols = extract_symbols(i_sig, q_sig, sps=sps, device=DEVICE)

    plt = _pyplot()
    fig, axes = plt.subplots(2, 4, figsize=(22, 10))
    fig.suptitle(f"{modulation} — preprocessing pipeline", fontsize=16, fontweight="bold")

    ax = axes[0, 0]
    t = np.arange(len(i_sig))
    ax.plot(t, i_sig, linewidth=0.7, label="I", alpha=0.8)
    ax.plot(t, q_sig, linewidth=0.7, label="Q", alpha=0.8)
    ax.set_title("Raw I/Q time series"); ax.legend(); ax.grid(alpha=0.3)

    ax = axes[0, 1]
    ax.scatter(i_sig, q_sig, s=3, alpha=0.4)
    ax.set_title("Raw constellation"); ax.set_xlabel("I"); ax.set_ylabel("Q")
    ax.axis("equal"); ax.grid(alpha=0.3)

    ax = axes[0, 2]
    ax.scatter(i_norm, q_norm, s=3, alpha=0.4, color="tab:green")
    ax.set_title("Normalized constellation"); ax.set_xlabel("I"); ax.set_ylabel("Q")
    ax.axis("equal"); ax.grid(alpha=0.3)

    ax = axes[0, 3]
    txt = (
        f"samples: {len(i_sig)}\n"
        f"i_mean: {stats['i_mean']:+.5f}\ni_std:  {stats['i_std']:.5f}\n"
        f"q_mean: {stats['q_mean']:+.5f}\nq_std:  {stats['q_std']:.5f}\n\n"
        f"sps: {sps} ("
        f"{'bypass — every sample is a symbol' if sps == 1 else 'matched filter + timing recovery'}"
        ")\n"
        f"symbols extracted: {len(symbols['symbol_i'])}"
    )
    ax.text(0.05, 0.95, txt, transform=ax.transAxes, va="top", family="monospace")
    ax.set_title("Normalization stats"); ax.axis("off")

    ax = axes[1, 0]
    im = ax.imshow(vit_img[0], aspect="auto", cmap="viridis")
    ax.set_title("ViT input image [1, 32, 64]\n(rows 0-15 = I, 16-31 = Q)")
    fig.colorbar(im, ax=ax, fraction=0.04)

    ax = axes[1, 1]
    ax.plot(seq[0], linewidth=0.7, label="I (normalized)", alpha=0.8)
    ax.plot(seq[1], linewidth=0.7, label="Q (normalized)", alpha=0.8)
    ax.set_title(f"Transformer input sequence [2, {seq.shape[1]}]")
    ax.legend(); ax.grid(alpha=0.3)

    ax = axes[1, 2]
    ax.scatter(symbols["symbol_i"], symbols["symbol_q"], s=6, alpha=0.5, color="tab:red")
    ax.set_title(f"Extracted symbols (sps={sps}, n={len(symbols['symbol_i'])})")
    ax.set_xlabel("I"); ax.set_ylabel("Q"); ax.axis("equal"); ax.grid(alpha=0.3)

    ax = axes[1, 3]
    ax.hist(np.hypot(i_norm, q_norm), bins=60, alpha=0.8, color="tab:purple")
    ax.set_title("Normalized amplitude histogram"); ax.grid(alpha=0.3)

    fig.tight_layout()
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)


def plot_overview(
    frames: Dict[str, np.ndarray],
    stats: Dict[str, float],
    save_path: Path,
    dpi: int = 150,
) -> None:
    """Constellation-per-modulation overview grid
    (ref: plot_preprocessing_signal.py:448-551)."""
    mods = list(frames)
    plt = _pyplot()
    fig, axes = plt.subplots(2, len(mods), figsize=(4.2 * len(mods), 8.5), squeeze=False)
    fig.suptitle("Preprocessing overview — raw vs normalized constellations",
                 fontsize=15, fontweight="bold")
    for c, mod in enumerate(mods):
        frame = frames[mod][0]
        i_sig, q_sig = frame[:, 0], frame[:, 1]
        i_norm, q_norm = apply_normalization(i_sig, q_sig, stats)
        axes[0][c].scatter(i_sig, q_sig, s=3, alpha=0.4)
        axes[0][c].set_title(f"{mod} raw")
        axes[1][c].scatter(i_norm, q_norm, s=3, alpha=0.4, color="tab:green")
        axes[1][c].set_title(f"{mod} normalized")
        for r in (0, 1):
            axes[r][c].axis("equal"); axes[r][c].grid(alpha=0.3)
    fig.tight_layout()
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)


def run_visualization(
    file_path: Optional[str] = None,
    json_path: Optional[str] = None,
    output_dir: str = "visualization_results",
    modulations: Optional[Sequence[str]] = None,
    num_samples: int = 1,
    create_overview: bool = False,
    dpi: int = 150,
    sps: int = 1,
) -> List[Path]:
    """CLI entry (ref: plot_preprocessing_signal.py:554-638). Returns the
    written figure paths."""
    out = Path(output_dir)
    frames, stats = _collect_frames(file_path, json_path, modulations, num_samples)
    written: List[Path] = []
    for mod, arr in frames.items():
        for k in range(min(num_samples, len(arr))):
            p = out / mod / f"{mod}_preprocessing_sample_{k + 1}.png"
            plot_modulation_pipeline(arr[k], mod, stats, p, dpi=dpi, sps=sps)
            written.append(p)
    if create_overview:
        p = out / "preprocessing_overview.png"
        plot_overview(frames, stats, p, dpi=dpi)
        written.append(p)
    if sps > 1:
        # four-method timing-recovery A/B panel (runnable without the dataset)
        p = out / "timing_recovery_comparison.png"
        plot_timing_recovery_comparison(p, sps=sps, dpi=dpi)
        written.append(p)
    print(f"wrote {len(written)} figures to {out}")
    return written


def plot_timing_recovery_comparison(
    save_path: str | Path,
    modulation: str = "QPSK",
    num_symbols: int = 50,
    sps: int = 2,
    snr_db: float = 15.0,
    seed: int = 42,
    dpi: int = 150,
) -> Path:
    """Visual A/B of ALL FOUR timing-recovery methods on one synthetic signal
    — true-vs-recovered strobes per method (the reference's DSP test script
    produced this figure for two methods, ref: test_dsp_functions.py:175-241;
    here every contract method gets a panel).

    Layout: raw trajectory + time-domain strobes on the top row, one
    recovered-constellation panel per method below.
    """
    from vitiq_torch.data import generate_test_signal

    i_sig, q_sig, true_idx = generate_test_signal(
        modulation, num_symbols=num_symbols, sps=sps, snr_db=snr_db, seed=seed)
    methods = ("simple_energy", "simple_correlation", "gardner", "mueller_muller")

    plt = _pyplot()
    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    fig.suptitle(
        f"Timing Recovery Comparison — {modulation}, sps={sps}, {snr_db:g} dB",
        fontsize=15, fontweight="bold")

    ax = axes[0, 0]
    ax.scatter(i_sig, q_sig, alpha=0.2, s=3, color="gray", label="Raw samples")
    ax.scatter(i_sig[true_idx], q_sig[true_idx], alpha=0.6, s=30,
               color="green", marker="x", label=f"True ({len(true_idx)})")
    ax.set_title("Raw Trajectory with True Symbols")
    ax.set_xlabel("I"); ax.set_ylabel("Q"); ax.legend(); ax.grid(alpha=0.3)
    ax.axis("equal")

    ax = axes[0, 1]
    t = np.arange(len(i_sig))
    ax.plot(t, i_sig, alpha=0.7, linewidth=0.8, label="I")
    ax.plot(t, q_sig, alpha=0.7, linewidth=0.8, label="Q")
    ax.scatter(true_idx, i_sig[true_idx], s=20, color="red", marker="o", zorder=5)
    ax.set_title("Time Domain with True Symbol Strobes")
    ax.set_xlabel("Sample Index"); ax.set_ylabel("Amplitude")
    ax.legend(); ax.grid(alpha=0.3)

    panels = [axes[0, 2], axes[1, 0], axes[1, 1], axes[1, 2]]
    for ax, method in zip(panels, methods):
        res = extract_symbols(i_sig, q_sig, sps=sps, method=method, device=DEVICE)
        rec_idx = np.asarray(res["symbol_indices"])
        # mean |strobe - nearest true strobe| in samples (the contract's
        # quality metric, ref: test_dsp_functions.py:129-153)
        err = float(np.mean(np.min(
            np.abs(rec_idx[:, None] - np.asarray(true_idx)[None, :]), axis=1)))
        ax.scatter(res["symbol_i"], res["symbol_q"], alpha=0.6, s=20,
                   color="red", marker="o",
                   label=f"Recovered ({len(rec_idx)})")
        ax.scatter(i_sig[true_idx], q_sig[true_idx], alpha=0.6, s=30,
                   color="green", marker="x", label=f"True ({len(true_idx)})")
        ax.set_title(f"{method}  (mean timing err {err:.2f} samp)")
        ax.set_xlabel("I"); ax.set_ylabel("Q"); ax.legend(); ax.grid(alpha=0.3)
        ax.axis("equal")

    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    plt.tight_layout()
    plt.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return save_path
