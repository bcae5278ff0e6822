"""The port's evaluation against vitiq's: the report text byte for byte
(vitiq writes scikit-learn's; the port writes it with numpy), the confusion
artifacts, the synthetic corpus and its stats bit for bit, and the
evaluation of an experiment directory written by vitiq, through
`vitiq_torch.runner.run_evaluation` and `python -m vitiq_torch.cli evaluate`
on the CPU, in float and int8."""

import functools
import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import vitiq.eval as veval
from vitiq.config import DataConfig as VitiqDataConfig
from vitiq.config import ExperimentConfig as VitiqExperimentConfig
from vitiq.config import ModelConfig as VitiqModelConfig
from vitiq.config import TrainConfig as VitiqTrainConfig
from vitiq.data import SyntheticAMCDataset as VitiqDataset
from vitiq.data import channel_from_config as vitiq_channel
from vitiq.data import stats_from_array as vitiq_stats
from vitiq.eval import report as vreport
from vitiq.eval.compare import ModelComparison
from vitiq.eval.evaluate import confusion_artifacts as vitiq_confusion_artifacts
from vitiq.models import init_amc_params
from vitiq.runner import run_evaluation as vitiq_run_evaluation
from vitiq.train.checkpoint import save_params as vitiq_save_params
from vitiq_torch.config import DataConfig
from vitiq_torch.data import SyntheticAMCDataset, channel_from_config, stats_from_array
from vitiq_torch.eval import ClassificationReportParser, confusion_artifacts
from vitiq_torch.eval.plots import plot_training_history
from vitiq_torch.eval.report import confusion_matrix, write_classification_report
from vitiq_torch.runner import run_evaluation

ROOT = Path(__file__).resolve().parents[1]
RADIOML = ["OOK", "4ASK", "8ASK", "BPSK", "QPSK", "8PSK", "16PSK", "32PSK", "16APSK",
           "32APSK", "64APSK", "128APSK", "16QAM", "32QAM", "64QAM", "128QAM", "256QAM",
           "AM-SSB-WC", "AM-SSB-SC", "AM-DSB-WC", "AM-DSB-SC", "FM", "GMSK", "OQPSK"]


def _report_cases():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 19, 700)
    preds = np.where(rng.random(700) < 0.6, labels, rng.integers(0, 19, 700))
    absent = rng.integers(0, 5, 300)
    absent[absent == 2] = 3  # class 2 never appears, nor is it predicted
    absent_pred = np.where(rng.random(300) < 0.5, absent, rng.integers(0, 5, 300))
    absent_pred[absent_pred == 2] = 0
    one = np.zeros(10, np.int64)
    return {
        "random_radioml": (labels, preds, RADIOML[:19]),
        "absent_class": (absent, absent_pred, ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM"]),
        "hyphenated": (rng.integers(0, 5, 97), rng.integers(0, 5, 97), RADIOML[17:22]),
        "never_predicted": (rng.integers(0, 3, 40), np.zeros(40, np.int64), ["A", "B", "C"]),
        "single_label": (one, one, ["BPSK", "QPSK", "16QAM"]),
        "long_name": (rng.integers(0, 2, 50), rng.integers(0, 2, 50),
                      ["a-very-long-modulation-name", "x"]),
    }


@pytest.mark.parametrize("case", sorted(_report_cases()))
def test_report_is_byte_identical_to_vitiq(case, tmp_path):
    labels, preds, names = _report_cases()[case]
    snr_acc = {-8: 0.1344, 0: 0.5, 8: 0.987654}
    want = vreport.write_classification_report(tmp_path / "vitiq.txt", "test", 0.62025,
                                               snr_acc, labels, preds, names)
    got = write_classification_report(tmp_path / "port.txt", "test", 0.62025, snr_acc,
                                      labels, preds, names)
    assert got.read_bytes() == want.read_bytes()
    port = ClassificationReportParser(got)
    ref = vreport.ClassificationReportParser(want)
    assert port.overall_accuracy == ref.overall_accuracy == 62.02
    assert port.snr_accuracies == ref.snr_accuracies
    assert port.class_metrics == ref.class_metrics


def test_confusion_matrix_matches_sklearn():
    from sklearn.metrics import confusion_matrix as sk_cm

    labels, preds, names = _report_cases()["random_radioml"]
    got = confusion_matrix(labels, preds, len(names))
    np.testing.assert_array_equal(got, sk_cm(labels, preds, labels=np.arange(len(names))))
    assert got.dtype == np.int64


def _artifacts_case():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 4, 400)
    preds = np.where(rng.random(400) < 0.7, labels, rng.integers(0, 4, 400))
    snrs = rng.choice(np.asarray([-8.0, -0.3, 0.4, 8.0, 20.0], np.float32), 400)
    return preds, labels, snrs, ["BPSK", "QPSK", "16QAM", "AM-DSB-SC"]


def test_confusion_artifacts_match_vitiq(tmp_path):
    preds, labels, snrs, names = _artifacts_case()
    want = vitiq_confusion_artifacts(preds, labels, snrs, names, tmp_path / "vitiq",
                                     prefix="valid", make_plots=False, verbose=False)
    got = confusion_artifacts(preds, labels, snrs, names, tmp_path / "port", prefix="valid",
                              make_plots=False, verbose=False)
    assert got["overall_accuracy"] == want["overall_accuracy"]
    assert got["snr_accuracies"] == want["snr_accuracies"]
    np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])
    assert got["accuracy_vs_snr"] == want["accuracy_vs_snr"]
    name = "valid_classification_report.txt"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "vitiq" / name).read_bytes()
    with open(tmp_path / "port" / "valid_results.pkl", "rb") as f:
        saved = pickle.load(f)
    np.testing.assert_array_equal(saved["predictions"], preds)


def test_confusion_artifacts_plots(tmp_path):
    preds, labels, snrs, names = _artifacts_case()
    confusion_artifacts(preds, labels, snrs, names, tmp_path, prefix="test", save_pickle=False,
                        verbose=False)
    for stem in ("confusion_matrix_overall", "confusion_matrix_snr_-8dB",
                 "confusion_matrix_snr_0dB", "confusion_matrix_snr_8dB", "accuracy_vs_snr"):
        assert (tmp_path / f"test_{stem}.png").stat().st_size > 0
    assert not (tmp_path / "test_results.pkl").exists()
    history = {"train_loss": [1.1, 0.9], "val_loss": [1.0, 0.95], "train_acc": [0.4, 0.6],
               "val_acc": [0.45, 0.55]}
    plot_training_history(history, tmp_path / "history.png")
    assert (tmp_path / "history.png").stat().st_size > 0


def test_model_comparison_reads_a_port_report_beside_a_vitiq_one(tmp_path):
    preds, labels, snrs, names = _artifacts_case()
    vitiq_confusion_artifacts(preds, labels, snrs, names, tmp_path / "vitiq",
                              make_plots=False, verbose=False)
    port_preds = np.where(np.arange(len(preds)) % 5 == 0, labels, preds)
    confusion_artifacts(port_preds, labels, snrs, names, tmp_path / "port", make_plots=False,
                        verbose=False)
    mc = ModelComparison(tmp_path / "vitiq" / "test_classification_report.txt",
                         tmp_path / "port" / "test_classification_report.txt",
                         output_dir=tmp_path / "cmp")
    assert mc.transformer_parser.overall_accuracy == pytest.approx(
        100 * np.mean(port_preds == labels), abs=0.005)
    assert set(mc.transformer_parser.class_metrics) == set(names)
    table = mc.create_detailed_comparison_table()
    assert list(table["Modulation"]) == names
    summary = mc.create_summary_table()
    assert summary.shape[0] == 4


@pytest.mark.parametrize("channel", [False, True])
def test_synthetic_corpus_and_stats_match_vitiq_bit_for_bit(channel):
    kw = dict(synthetic_classes=("BPSK", "16QAM", "GMSK", "AM-SSB-WC", "FM"),
              synthetic_frames_per_class=24, synthetic_frame_len=128,
              synthetic_channel=channel,
              synthetic_channel_params=({"tap_delays": [0.0, 1.5], "tap_powers": [1.0, 0.3]}
                                        if channel else None))
    vcfg, pcfg = VitiqDataConfig(**kw), DataConfig(**kw)
    args = dict(classes=kw["synthetic_classes"], frames_per_class=24, frame_len=128, seed=3)
    want = VitiqDataset(**args, channel=vitiq_channel(vcfg))
    got = SyntheticAMCDataset(**args, channel=channel_from_config(pcfg))
    assert (got.channel is None) == (not channel)
    for a, b in ((got.X, want.X), (got.Y, want.Y), (got.Z, want.Z)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    idx = np.arange(80)
    assert stats_from_array(got.X, idx, num_samples=50) == vitiq_stats(want.X, idx,
                                                                      num_samples=50)


# --------------------------------------------------------------------------
# a saved experiment written by vitiq, evaluated by the port
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vitiq_experiment(tmp_path_factory):
    """A tiny rawIQ experiment (f32 `reference` numerics, CLS pooling) as
    vitiq's run_training leaves it: config.json, normalization_stats.json,
    model_best.npz."""
    exp_dir = tmp_path_factory.mktemp("exp")
    cfg = VitiqExperimentConfig(
        model=VitiqModelConfig(arm="rawiq", num_classes=3, d_model=128, n_head=8, n_layers=2,
                               ffn_hidden=256, seq_length=128, segment_size=16,
                               use_cls_token=True, drop_prob=0.0, numerics="reference"),
        data=VitiqDataConfig(synthetic_frames_per_class=60, synthetic_frame_len=128),
        train=VitiqTrainConfig(batch_size=32))
    cfg.to_json(str(exp_dir / "config.json"))
    (exp_dir / "normalization_stats.json").write_text(json.dumps(
        {"i_mean": 0.01, "i_std": 0.9, "q_mean": -0.02, "q_std": 1.1}))
    vitiq_save_params(exp_dir / "model_best", init_amc_params(jax.random.PRNGKey(4), cfg.model))
    return exp_dir


def _vitiq_eval(exp_dir, monkeypatch, int8):
    monkeypatch.setattr(veval, "evaluate_feed_with_confusion", functools.partial(
        veval.evaluate_feed_with_confusion, make_plots=False))
    return vitiq_run_evaluation(str(exp_dir), int8=int8, verbose=False)


def test_run_evaluation_float_equals_vitiq(vitiq_experiment, monkeypatch):
    want = _vitiq_eval(vitiq_experiment, monkeypatch, int8=False)
    got = run_evaluation(str(vitiq_experiment), device="cpu", make_plots=False, verbose=False)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["overall_accuracy"] == want["overall_accuracy"]
    report = vitiq_experiment / "evaluation" / "test_classification_report.txt"
    assert vreport.ClassificationReportParser(report).overall_accuracy == pytest.approx(
        100 * want["overall_accuracy"], abs=0.005)


def test_run_evaluation_int8_within_vitiq_bounds(vitiq_experiment, monkeypatch):
    """The int8 path against vitiq's int8 evaluation and against the port's
    float one: argmax agreement >= 0.875 (vitiq's bound on untrained logits,
    `tests/test_quant.py`) and accuracy within 2 points of float."""
    want = _vitiq_eval(vitiq_experiment, monkeypatch, int8=True)
    got = run_evaluation(str(vitiq_experiment), int8=True, device="cpu", make_plots=False,
                         verbose=False)
    flt = run_evaluation(str(vitiq_experiment), device="cpu", make_plots=False, verbose=False)
    assert np.mean(got["predictions"] == want["predictions"]) >= 0.875
    assert np.mean(got["predictions"] == flt["predictions"]) >= 0.875
    assert abs(got["overall_accuracy"] - flt["overall_accuracy"]) <= 0.02
    assert (vitiq_experiment / "evaluation" / "test_int8_results.pkl").exists()


@pytest.mark.parametrize("int8", [False, True])
def test_cli_evaluate_writes_reports_vitiq_reads(vitiq_experiment, int8):
    args = [sys.executable, "-m", "vitiq_torch.cli", "evaluate", "--checkpoint",
            str(vitiq_experiment), "--device", "cpu"]
    args += ["--int8", "--no_plots"] if int8 else ["--dataset", "valid"]
    proc = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "overall accuracy:" in proc.stdout and "SNR  -8 dB:" in proc.stdout
    prefix = "test_int8" if int8 else "valid"
    out = vitiq_experiment / "evaluation"
    parsed = vreport.ClassificationReportParser(out / f"{prefix}_classification_report.txt")
    assert set(parsed.class_metrics) == {"BPSK", "QPSK", "16QAM"}
    with open(out / f"{prefix}_results.pkl", "rb") as f:
        res = pickle.load(f)
    assert f"overall accuracy: {res['overall_accuracy'] * 100:.2f}%" in proc.stdout
    assert (out / f"{prefix}_confusion_matrix_overall.png").exists() != int8


def test_run_evaluation_defaults_to_the_card(vitiq_experiment):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_evaluation(str(vitiq_experiment), make_plots=False, verbose=False)


def test_hdf5_source_is_not_ported(vitiq_experiment, tmp_path):
    cfg = json.loads((vitiq_experiment / "config.json").read_text())
    cfg["data"]["source"] = "hdf5"
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="h5py"):
        run_evaluation(str(vitiq_experiment), config_path=str(tmp_path / "config.json"),
                       device="cpu", make_plots=False, verbose=False)
