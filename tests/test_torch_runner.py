"""The port's training runner against vitiq's: `run_training` and
``python -m vitiq_torch.cli train`` on the CPU (``--device cpu``), resuming,
the interrupt rescue and the configurations the port refuses.

* Artifacts: vitiq's `run_training` and the port's ``cli train`` on the same
  small synthetic experiment write the same files (the figures are written
  as empty files here: rendering them at 300 dpi is most of a run's time and
  says nothing about the runner), and ``cli evaluate`` reads the port's
  experiment, and vitiq's, back.
* Resume: two epochs, then ``resume="auto"`` for a third, give the history
  and the parameters of three uninterrupted epochs, bit for bit, with
  dropout on at f32 (the learning rate compared at f32, the width a
  checkpoint stores it at; epoch times are wall clock).
* A KeyboardInterrupt during `fit` writes ``checkpoint_interrupted``, which
  ``resume="auto"`` picks up; a missing resume starts the run fresh."""

import json
import pickle

import numpy as np
import pytest
import torch
from matplotlib.figure import Figure

from vitiq.config import DataConfig as VDataConfig
from vitiq.config import ExperimentConfig as VExperimentConfig
from vitiq.config import ModelConfig as VModelConfig
from vitiq.config import TrainConfig as VTrainConfig
from vitiq.runner import run_training as vitiq_run_training
from vitiq_torch import cli
from vitiq_torch import train as ptrain
from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from vitiq_torch.runner import run_training
from vitiq_torch.train.checkpoint import load_params

MODEL = dict(arm="rawiq", num_classes=3, d_model=32, n_head=4, n_layers=1, ffn_hidden=64,
             seq_length=128, segment_size=16, drop_prob=0.1, numerics="reference")
DATA = dict(synthetic_frames_per_class=40, synthetic_frame_len=128)
TRAIN = dict(batch_size=16, num_epochs=2, save_freq=1, learning_rate=1e-3)


def _cfg(tmp_path, name="exp", **train):
    return ExperimentConfig(model=ModelConfig(**MODEL), data=DataConfig(**DATA),
                            train=TrainConfig(**{**TRAIN, **train}), experiment_name=name,
                            checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_cli_train_writes_what_vitiq_writes_and_evaluate_reads_it(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(Figure, "savefig", lambda self, path, **kw: open(path, "wb").close())
    vcfg = VExperimentConfig(model=VModelConfig(**MODEL), data=VDataConfig(**DATA),
                             train=VTrainConfig(**TRAIN), experiment_name="exp",
                             checkpoint_dir=str(tmp_path / "vitiq" / "ckpt"),
                             log_dir=str(tmp_path / "vitiq" / "logs"))
    vitiq_run_training(vcfg, verbose=False)
    path = tmp_path / "exp.json"
    _cfg(tmp_path / "port").to_json(str(path))
    assert cli.main(["train", "--config", str(path), "--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "port" / "ckpt" / "exp" / "summary.json").read_text())
    assert '"epochs_run": 2' in capsys.readouterr().out  # cmd_train prints the summary
    assert _files(tmp_path / "port") == _files(tmp_path / "vitiq")
    vsummary = json.loads((tmp_path / "vitiq" / "ckpt" / "exp" / "summary.json").read_text())
    assert set(summary) == set(vsummary)
    assert summary["epochs_run"] == 2 and len(summary["test_snr_accuracies"]) == 3
    for exp in ("port", "vitiq"):
        manifest = json.loads((tmp_path / exp / "ckpt" / "exp" / "checkpoint_final.json")
                              .read_text())
        assert set(manifest) == {"format_version", "num_leaves", "epoch", "val_loss", "history",
                                 "config", "extra"}
        assert manifest["epoch"] == 1 and len(manifest["history"]["val_loss"]) == 2

    exp_dir = tmp_path / "port" / "ckpt" / "exp"
    capsys.readouterr()
    assert cli.main(["evaluate", "--checkpoint", str(exp_dir), "--device", "cpu",
                     "--no_plots"]) == 0
    printed = capsys.readouterr().out
    assert f"overall accuracy: {summary['test_overall_accuracy'] * 100:.2f}%" in printed
    with open(exp_dir / "evaluation" / "test_results.pkl", "rb") as f:
        assert len(pickle.load(f)["predictions"]) == 18  # 15% of 120 frames
    # the port evaluates vitiq's experiment too
    assert cli.main(["evaluate", "--checkpoint", str(tmp_path / "vitiq" / "ckpt" / "exp"),
                     "--device", "cpu", "--no_plots"]) == 0
    assert (f"overall accuracy: {vsummary['test_overall_accuracy'] * 100:.2f}%"
            in capsys.readouterr().out)


def test_resume_auto_equals_an_uninterrupted_run(tmp_path):
    whole = run_training(_cfg(tmp_path, "whole", num_epochs=3), evaluate_test=False,
                         verbose=False, device="cpu", make_plots=False)
    run_training(_cfg(tmp_path, "split", num_epochs=2), evaluate_test=False, verbose=False,
                 device="cpu", make_plots=False)
    split = run_training(_cfg(tmp_path, "split", num_epochs=3), resume="auto",
                         evaluate_test=False, verbose=False, device="cpu", make_plots=False)
    assert split["epochs_run"] == whole["epochs_run"] == 3
    for key in ("train_loss", "train_acc", "val_loss", "val_acc"):
        assert split["history"][key] == whole["history"][key], key
    assert (np.float32(split["history"]["lr"]) == np.float32(whole["history"]["lr"])).all()
    model_cfg = ModelConfig(**MODEL)
    want = load_params(tmp_path / "ckpt" / "whole" / "model_final.npz", model_cfg)
    got = load_params(tmp_path / "ckpt" / "split" / "model_final.npz", model_cfg)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    with np.load(tmp_path / "ckpt" / "whole" / "checkpoint_final.npz") as a, \
            np.load(tmp_path / "ckpt" / "split" / "checkpoint_final.npz") as b:
        assert a.files == b.files
        for leaf in a.files:  # AdamW's moments and the step counts too
            np.testing.assert_array_equal(a[leaf], b[leaf])


def test_interrupt_writes_a_rescue_that_resume_auto_picks_up(tmp_path, monkeypatch, capsys):
    real_fit = ptrain.fit

    def interrupted_fit(*args, epoch_callback=None, **kwargs):
        def callback(epoch, state, history):
            epoch_callback(epoch, state, history)
            raise KeyboardInterrupt

        return real_fit(*args, epoch_callback=callback, **kwargs)

    cfg = _cfg(tmp_path, num_epochs=3, save_freq=10)
    monkeypatch.setattr(ptrain, "fit", interrupted_fit)
    with pytest.raises(KeyboardInterrupt):
        run_training(cfg, evaluate_test=False, device="cpu", make_plots=False)
    exp_dir = tmp_path / "ckpt" / "exp"
    assert "rescue checkpoint written" in capsys.readouterr().out
    assert json.loads((exp_dir / "checkpoint_interrupted.json").read_text())["epoch"] == 0
    assert not list(exp_dir.glob("checkpoint_epoch_*"))
    monkeypatch.setattr(ptrain, "fit", real_fit)
    summary = run_training(cfg, resume="auto", evaluate_test=False, device="cpu",
                           make_plots=False)
    assert "checkpoint_interrupted at epoch 1" in capsys.readouterr().out
    assert summary["epochs_run"] == 3 and len(summary["history"]["val_loss"]) == 3


def test_a_missing_resume_starts_fresh(tmp_path, capsys):
    summary = run_training(_cfg(tmp_path, num_epochs=1), resume=str(tmp_path / "nothing"),
                           evaluate_test=False, device="cpu", make_plots=False)
    assert "could not resume" in capsys.readouterr().out
    assert summary["epochs_run"] == 1 and len(summary["history"]["val_loss"]) == 1


@pytest.mark.parametrize("args", [
    ["--sps", "2"], ["--features", "amp_phase"], ["--data_parallel", "2"],
    ["--model_parallel", "2"]], ids=lambda a: "".join(a).strip("-"))
def test_cli_train_refuses_what_the_port_cannot_run(args):
    base = ["--arm", "rawiq", "--source", "synthetic"]
    with pytest.raises(NotImplementedError, match="cannot run"):
        cli.main(["train", "--device", "cpu", *base, *args])


@pytest.mark.parametrize("args", [["--source", "hdf5"], ["--preset", "rawiq_best"]],
                         ids=lambda a: "".join(a).strip("-"))
def test_cli_train_takes_hdf5_configs_and_checks_their_file(args, tmp_path):
    base = [] if "--preset" in args else ["--arm", "rawiq"]
    with pytest.raises(ValueError, match="HDF5 file not found"):
        cli.main(["train", "--device", "cpu", "--file_path", str(tmp_path / "missing.hdf5"),
                  *base, *args])


def test_run_training_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--arm", "rawiq", "--source", "synthetic"])
    assert not (tmp_path / "ckpt").exists()  # nothing written before the check
