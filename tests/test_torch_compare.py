"""The port's cross-arm comparison and head-to-head against vitiq's.

* `ModelComparison`: vitiq's (pandas) and the port's (numpy and csv) read
  the same two report files, written by each package's
  `write_classification_report` from the same labels and predictions, and
  must write the same CSV bytes and return an equal insights dict: with
  tied F1 differences (the order of the top improved and degraded classes
  is pandas' `sort_values`, which is not a stable sort at 19 rows), an SNR
  one report lacks, a ViT accuracy of 0 (inf, and 0 / 0 written as an empty
  field), no class in common, and 19 classes.
* `run_head_to_head` on the CPU at vitiq's `TestHeadToHead` size, without
  plots; the insights agree with the two arms' test accuracies.
* The ``compare`` and ``head-to-head`` parsers against vitiq's, and the two
  arms' configurations `cmd_head_to_head` builds, field for field."""

import copy

import numpy as np
import pandas as pd
import pytest

import vitiq.cli as vcli
from vitiq.eval.compare import ModelComparison as VitiqComparison
from vitiq.eval.report import write_classification_report as vitiq_write_report
from vitiq_torch import cli
from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from vitiq_torch.eval.compare import ModelComparison, argsort_like_pandas
from vitiq_torch.eval.report import write_classification_report
from vitiq_torch.runner import run_head_to_head

CLASSES_19 = ["OOK", "4ASK", "8ASK", "BPSK", "QPSK", "8PSK", "16PSK", "32PSK", "16APSK",
              "32APSK", "64APSK", "128APSK", "16QAM", "32QAM", "64QAM", "128QAM", "256QAM",
              "AM-SSB-WC", "GMSK"]
CSVS = ("summary_comparison.csv", "detailed_comparison.csv")


def _predictions(correct, per_class=20):
    """Labels and predictions where class c has correct[c] right and its
    other frames predicted as class c + 1: classes in a run of equal counts
    get equal F1 scores, so the two arms' F1 differences tie."""
    labels, preds = [], []
    n = len(correct)
    for c, k in enumerate(correct):
        labels += [c] * per_class
        preds += [c] * k + [(c + 1) % n] * (per_class - k)
    return np.array(labels), np.array(preds)


def _reports(tmp_path, vit_case, trans_case, classes, trans_classes=None):
    """Both packages' report files for both arms; returns the two pairs of
    paths (vitiq's, the port's)."""
    paths = {}
    for arm, (overall, snrs, correct), names in (
            ("vit", vit_case, classes), ("trans", trans_case, trans_classes or classes)):
        labels, preds = _predictions(correct)
        for pkg, write in (("vitiq", vitiq_write_report), ("port", write_classification_report)):
            path = tmp_path / pkg / f"{arm}.txt"
            write(path, "test", overall, snrs, labels, preds, names)
            paths[pkg, arm] = path
    assert paths["vitiq", "vit"].read_bytes() == paths["port", "vit"].read_bytes()
    return (paths["vitiq", "vit"], paths["vitiq", "trans"]), (paths["port", "vit"],
                                                              paths["port", "trans"])


SNRS = {-8: 0.2517, 0: 0.5, 8: 0.9124}
CASES = {
    # 19 classes, runs of equal counts in both arms: tied F1 differences
    "ties-19": ((0.5512, SNRS, [10] * 6 + [14] * 7 + [3] * 6),
                (0.6033, {-8: 0.3, 0: 0.5, 8: 0.9124},
                 [12] * 6 + [16] * 7 + [5] * 6), CLASSES_19, None),
    # the raw-IQ report lacks SNR 0 and the ViT report SNR +8
    "missing-snr": ((0.5, {-8: 0.25, 0: 0.5}, [10, 12, 7, 20]),
                    (0.625, {-8: 0.3, 8: 0.75}, [11, 12, 9, 19]), CLASSES_19[:4], None),
    # a ViT accuracy of 0: inf where the raw-IQ arm scores, 0 / 0 elsewhere
    "zero-vit": ((0.0, {-8: 0.0, 0: 0.0, 8: 0.0}, [0, 0, 0]),
                 (0.25, {-8: 0.0, 0: 0.25, 8: 0.5}, [5, 0, 20]), CLASSES_19[:3], None),
    # no class in common: an empty detailed table, no top classes
    "disjoint": ((0.5, SNRS, [10, 10]), (0.5, SNRS, [10, 10]), ["BPSK", "QPSK"],
                 ["8PSK", "GMSK"]),
    # a lone class, all of the diffs negative
    "one-class": ((0.9, SNRS, [18]), (0.85, SNRS, [17]), ["BPSK"], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_comparison_writes_vitiqs_csv_bytes_and_insights(case, tmp_path, capsys):
    vit_case, trans_case, classes, trans_classes = CASES[case]
    (v_vit, v_trans), (p_vit, p_trans) = _reports(tmp_path, vit_case, trans_case, classes,
                                                  trans_classes)
    want = VitiqComparison(v_vit, v_trans, output_dir=tmp_path / "vitiq_out").generate_report(
        verbose=False)
    got = ModelComparison(p_vit, p_trans, output_dir=tmp_path / "port_out").run_comparison(
        verbose=True, make_plots=False)
    assert "MODEL COMPARISON" in capsys.readouterr().out
    for name in CSVS:
        assert (tmp_path / "port_out" / name).read_bytes() == \
            (tmp_path / "vitiq_out" / name).read_bytes(), name
    assert got == want
    assert [type(v) for pair in got.get("top_improved", []) for v in pair] == \
        [type(v) for pair in want.get("top_improved", []) for v in pair]
    assert not list((tmp_path / "port_out").glob("*.png"))
    if case == "ties-19":
        diffs = [d for _, d in got["top_improved"] + got["top_degraded"]]
        assert len(set(diffs)) < len(diffs)  # the top and bottom three hold ties
    if case == "zero-vit":
        text = (tmp_path / "port_out" / "summary_comparison.csv").read_text()
        assert ",inf\n" in text and "SNR -8 dB (%),0.0,0.0,0.0,\n" in text


def test_argsort_like_pandas_on_ties():
    """The row order of Series.sort_values in both directions, on values
    with many ties, NaN and signed zeros."""
    rng = np.random.default_rng(0)
    for n in (1, 3, 16, 17, 19, 40, 100):
        for _ in range(20):
            v = rng.integers(-2, 3, n).astype(np.float64) * 1.25
            v[rng.random(n) < 0.1] = np.nan
            v[rng.random(n) < 0.1] = -0.0
            for ascending in (True, False):
                want = pd.Series(v).sort_values(ascending=ascending).index.to_numpy()
                np.testing.assert_array_equal(argsort_like_pandas(v, ascending), want)


def test_comparison_plots(tmp_path):
    vit_case, trans_case, classes, _ = CASES["missing-snr"]
    _, (p_vit, p_trans) = _reports(tmp_path, vit_case, trans_case, classes)
    ModelComparison(p_vit, p_trans, output_dir=tmp_path / "out").run_comparison(verbose=False)
    for name in ("overall_comparison", "snr_comparison", "per_class_metrics",
                 "f1_difference_heatmap"):
        assert (tmp_path / "out" / f"{name}.png").stat().st_size > 0


def test_run_head_to_head_on_the_cpu(tmp_path):
    """vitiq's TestHeadToHead experiment through the port, without plots."""
    data = DataConfig(source="synthetic", synthetic_classes=("BPSK", "QPSK"),
                      synthetic_frames_per_class=48, synthetic_frame_len=128)
    common = dict(data=data, train=TrainConfig(batch_size=16, num_epochs=1),
                  checkpoint_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "logs"))
    vit = ExperimentConfig(
        model=ModelConfig(arm="vit", num_classes=2, d_model=16, n_head=2, n_layers=1,
                          ffn_hidden=32, img_size_h=16, img_size_w=16, patch_size=8,
                          seq_length=128),
        experiment_name="h2h_vit", **common)
    rawiq = ExperimentConfig(
        model=ModelConfig(arm="rawiq", num_classes=2, d_model=16, n_head=2, n_layers=1,
                          ffn_hidden=32, seq_length=128, segment_size=32),
        experiment_name="h2h_rawiq", **copy.deepcopy(common))
    res = run_head_to_head(vit, rawiq, comparison_dir=str(tmp_path / "cmp"), verbose=False,
                           device="cpu", make_plots=False)
    assert set(res) == {"vit", "rawiq", "comparison_dir", "insights"}
    assert "history" not in res["vit"] and "history" not in res["rawiq"]
    for arm in ("vit", "rawiq"):
        assert (tmp_path / "ck" / f"h2h_{arm}" / "summary.json").exists()
    for name in CSVS:
        assert (tmp_path / "cmp" / name).exists()
    assert not list((tmp_path / "cmp").glob("*.png"))
    accuracy = res["rawiq"]["test_overall_accuracy"] - res["vit"]["test_overall_accuracy"]
    assert abs(res["insights"]["overall_improvement"] - 100 * accuracy) <= 0.01 + 1e-9
    assert set(res["insights"]["snr_improvements"]) == set(res["vit"]["test_snr_accuracies"])


def _public(args):
    return {k: v for k, v in vars(args).items()
            if k not in ("fn", "device", "no_plots") and not callable(v)}


@pytest.mark.parametrize("argv", [
    ["compare", "--vit_report", "a.txt", "--transformer_report", "b.txt"],
    ["compare", "--vit_report", "a.txt", "--transformer_report", "b.txt", "--output_dir", "o"],
    ["head-to-head", "--source", "synthetic", "--numerics", "tpu"],
    ["head-to-head", "--source", "synthetic", "--numerics", "tpu", "--n_head", "2",
     "--num_epochs", "3", "--experiment_name", "pair", "--output_dir", "cmp"],
    ["head-to-head", "--preset", "vit_tiny_2016", "--batch_size", "64", "--drop_prob", "0.0"],
])
def test_parsers_and_head_to_head_configs_match_vitiq(argv):
    want = vcli.build_parser().parse_args(argv)
    got = cli.build_parser().parse_args(argv + ["--no_plots"])
    assert _public(got) == _public(want)
    assert got.no_plots and (argv[0] == "compare" or got.device == "cuda")
    if argv[0] != "head-to-head":
        return
    # vitiq's cmd_head_to_head, up to its run_head_to_head call
    base_name = want.experiment_name or "h2h"
    want.arm = "vit"
    v_vit = vcli._config_from_args(want)
    v_vit.experiment_name = f"{base_name}_vit"
    raw_args = copy.copy(want)
    raw_args.arm = "rawiq"
    v_raw = vcli._config_from_args(raw_args)
    v_raw.data = copy.deepcopy(v_vit.data)
    v_raw.data.features = "iq"
    v_raw.experiment_name = f"{base_name}_rawiq"
    p_vit, p_raw = cli.head_to_head_configs(got)
    assert p_vit.to_dict() == v_vit.to_dict()
    assert p_raw.to_dict() == v_raw.to_dict()
    assert p_raw.model.arm == "rawiq" and p_raw.data == p_vit.data


def test_head_to_head_refuses_hdf5():
    """The presets read the HDF5 file: where it is missing the head-to-head
    stops before training either arm."""
    args = cli.build_parser().parse_args(["head-to-head", "--numerics", "tpu", "--file_path",
                                          "/nonexistent/corpus.hdf5"])
    with pytest.raises(ValueError, match="HDF5 file not found"):
        cli.head_to_head_configs(args)
