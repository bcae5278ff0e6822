"""The port's preprocessing figures (`vitiq_torch/viz.py`, `cli visualize`)
against vitiq's: the same figure files under the same names from the same
arguments (synthetic frames, the overview, the sps-2 timing-recovery panel),
vitiq's flags on the command line, and vitiq's ValueError for a modulation
the synthetic generator lacks. matplotlib is imported only when a figure is
drawn."""

import subprocess
import sys

import pytest

from vitiq import cli as vcli
from vitiq.viz import run_visualization as vitiq_visualization
from vitiq_torch import cli as pcli
from vitiq_torch.viz import run_visualization


def _names(paths, root):
    return sorted(str(p.relative_to(root)) for p in paths)


@pytest.mark.parametrize("kw", [
    dict(modulations=["BPSK", "QPSK"], create_overview=True),
    dict(modulations=["QPSK"], num_samples=2, sps=2),
])
def test_writes_vitiqs_figures(kw, tmp_path):
    got = run_visualization(output_dir=str(tmp_path / "port"), dpi=40, **kw)
    want = vitiq_visualization(output_dir=str(tmp_path / "vitiq"), dpi=40, **kw)
    assert _names(got, tmp_path / "port") == _names(want, tmp_path / "vitiq")
    for p in got:
        assert p.exists() and p.stat().st_size > 1000


def test_unknown_synthetic_modulation_raises(tmp_path):
    with pytest.raises(ValueError, match="synthetic mode supports"):
        run_visualization(output_dir=str(tmp_path), modulations=["ZAP-9"])


def _flags(parser):
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {tuple(a.option_strings): (a.default, a.type, a.nargs, a.const)
            for a in sub.choices["visualize"]._actions if a.option_strings}


def test_cli_visualize_takes_vitiqs_flags(tmp_path):
    assert _flags(pcli.build_parser()) == _flags(vcli.build_parser())
    out = tmp_path / "figs"
    assert pcli.main(["visualize", "--output_dir", str(out), "--modulations", "BPSK",
                      "--num_samples", "1", "--dpi", "30", "--sps", "1"]) == 0
    assert [p.name for p in out.rglob("*.png")] == ["BPSK_preprocessing_sample_1.png"]


def test_the_module_imports_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None; import vitiq_torch.viz, "
            "vitiq_torch.cli; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
