"""The port's data path from file to batches against the JAX package's.

The same inputs, made from a numpy seed, go through `vitiq`'s function and
its port in `vitiq_torch`: the reference split (the port without
scikit-learn, held to vitiq's index arrays bit for bit, including their
dtypes and the ValueError cases), the normalization stats of an HDF5 file,
`batch_stream` over the HDF5 source and over packed shards (shuffled and
not, across windows), the packed files, `StreamFeed` epochs,
`load_experiment_feeds` with and without streaming, and
`run_reference_evaluation` of one `.pth` (a narrow two-layer rawIQ model in
`reference` numerics: the same confusion matrices and report files, logits
within 1e-4). Each test writes its own RadioML-layout HDF5 file (X [N, L, 2]
f32, Y one-hot, Z [N, 1]) and classes JSON.
"""

import filecmp
import functools
import json
import pickle

import numpy as np
import pytest
import torch

from vitiq import data as vdata
from vitiq.config import DataConfig as VDataConfig
from vitiq.config import ExperimentConfig as VExperimentConfig
from vitiq_torch import cli
from vitiq_torch import data as pdata
from vitiq_torch.config import DataConfig, ExperimentConfig
from vitiq_torch.data import native

MODS = ["BPSK", "QPSK", "16QAM"]
L = 128


def write_radioml(path, counts, seed=0, frame_len=L, snrs=(-8.0, 0.0, 8.0)):
    """A RadioML-layout file: for each (modulation, SNR) stratum in turn the
    number of frames `counts` gives (cycled), rows interleaved by a seeded
    permutation; returns (file path, classes JSON path)."""
    import h5py

    rng = np.random.default_rng(seed)
    labels, z = [], []
    for i, (m, s) in enumerate((m, s) for m in range(len(MODS)) for s in snrs):
        n = counts[i % len(counts)]
        labels += [m] * n
        z += [s] * n
    perm = rng.permutation(len(labels))
    labels, z = np.asarray(labels)[perm], np.asarray(z, np.float32)[perm]
    x = rng.standard_normal((len(labels), frame_len, 2)).astype(np.float32)
    x += 0.5 * labels[:, None, None]  # a class signal a model can learn
    y = np.zeros((len(labels), len(MODS)), np.int64)
    y[np.arange(len(labels)), labels] = 1
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=x)
        f.create_dataset("Y", data=y)
        f.create_dataset("Z", data=z[:, None])
    json_path = path.parent / "classes.json"
    json_path.write_text(json.dumps(MODS))
    return str(path), str(json_path)


@pytest.fixture(scope="module")
def radioml(tmp_path_factory):
    return write_radioml(tmp_path_factory.mktemp("radioml") / "corpus.hdf5", (23, 31, 17, 40))


def _labels(counts, seed):
    rng = np.random.default_rng(seed)
    y, z = [], []
    for i, (m, s) in enumerate((m, s) for m in MODS for s in (-10.0, 0.0, 10.0)):
        y += [m] * counts[i % len(counts)]
        z += [s] * counts[i % len(counts)]
    perm = rng.permutation(len(y))
    return np.asarray(y)[perm], np.asarray(z)[perm]


def _assert_same_arrays(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("counts", [(2,), (3,), (2, 3, 5), (7, 13, 40), (50, 2, 9, 3)],
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("seed", [42, 7])
def test_split_labels_matches_vitiq_bit_for_bit(counts, seed):
    y, z = _labels(counts, seed)
    for ratios in ((0.7, 0.15, 0.15), (0.5, 0.25, 0.25), (0.8, 0.1, 0.1)):
        want = vdata.split_labels(y, z, MODS, *ratios, seed)
        got = pdata.split_labels(y, z, MODS, *ratios, seed)
        _assert_same_arrays(got[:3], want[:3])
        assert got.label_map == want.label_map
    # a subset of the modulations, as a preset's target list picks it
    want = vdata.split_labels(y, z, MODS[1:], 0.7, 0.15, 0.15, seed)
    _assert_same_arrays(pdata.split_labels(y, z, MODS[1:], 0.7, 0.15, 0.15, seed)[:3],
                        want[:3])


@pytest.mark.parametrize("counts,ratios", [((1,), (0.7, 0.15, 0.15)),
                                           ((5, 1), (0.7, 0.15, 0.15)),
                                           ((5,), (0.7, 0.2, 0.2)),
                                           ((5,), (0.9, 0.1, 0.0))],
                         ids=["stratum-of-1", "one-stratum-of-1", "ratio-sum", "no-test"])
def test_split_labels_raises_where_vitiq_raises(counts, ratios):
    y, z = _labels(counts, 0)
    with pytest.raises(ValueError) as want:
        vdata.split_labels(y, z, MODS, *ratios, 42)
    with pytest.raises(ValueError) as got:
        pdata.split_labels(y, z, MODS, *ratios, 42)
    if "train set will be empty" in str(want.value):  # sklearn's wording elsewhere varies
        assert str(got.value) == str(want.value)


def test_hdf5_source_split_and_stats_match_vitiq(radioml):
    path, jpath = radioml
    vsrc, psrc = vdata.HDF5DataSource(path, jpath), pdata.HDF5DataSource(path, jpath)
    vcfg = VDataConfig(source="hdf5", file_path=path, json_path=jpath,
                       target_modulations=tuple(MODS), norm_sample_count=300)
    pcfg = DataConfig(source="hdf5", file_path=path, json_path=jpath,
                      target_modulations=tuple(MODS), norm_sample_count=300)
    vs, ps = vsrc.split(vcfg), psrc.split(pcfg)
    _assert_same_arrays(ps[:3], vs[:3])
    assert psrc.frame_len == vsrc.frame_len == L
    assert psrc.available_modulations == vsrc.available_modulations
    assert psrc.normalization_stats(ps.train, pcfg) == vsrc.normalization_stats(vs.train, vcfg)
    for n in (17, 5000):
        assert (pdata.stats_from_hdf5(path, ps.valid, seed=3, num_samples=n)
                == vdata.stats_from_hdf5(path, vs.valid, seed=3, num_samples=n))
    _assert_same_arrays(psrc.load_split_arrays(ps.test, ps.label_map, chunk_size=7),
                        vsrc.load_split_arrays(vs.test, vs.label_map, chunk_size=7))
    rows = np.array([5, 3, 3, 99, 0])
    np.testing.assert_array_equal(psrc.read_rows(rows), vsrc.read_rows(rows))
    with pdata.HDF5DataSource(path, jpath) as s:
        s.read_rows(rows)
        assert s._file is not None
    assert s._file is None
    vsrc.close()
    psrc.close()


def _batches(it):
    return [tuple(np.asarray(a) for a in b) for b in it]


def _assert_same_batches(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        _assert_same_arrays(g, w)


@pytest.mark.parametrize("window", [16, 50, 1000])
def test_hdf5_batch_stream_matches_vitiq(radioml, window):
    path, jpath = radioml
    vsrc, psrc = vdata.HDF5DataSource(path, jpath), pdata.HDF5DataSource(path, jpath)
    cfg = DataConfig(source="hdf5", file_path=path, json_path=jpath,
                     target_modulations=tuple(MODS))
    s = psrc.split(cfg)
    for shuffle, seed, drop_last in ((True, 3, True), (True, 4, False), (False, 0, False)):
        kw = dict(batch_size=24, shuffle=shuffle, seed=seed, drop_last=drop_last,
                  window_rows=window)
        _assert_same_batches(_batches(psrc.batch_stream(s.train, s.label_map, **kw)),
                             _batches(vsrc.batch_stream(s.train, s.label_map, **kw)))
    vsrc.close()
    psrc.close()


@pytest.fixture(scope="module")
def packed(radioml, tmp_path_factory):
    """The train split packed by both packages, 40 rows a shard."""
    path, jpath = radioml
    src = pdata.HDF5DataSource(path, jpath)
    s = src.split(DataConfig(source="hdf5", file_path=path, json_path=jpath,
                             target_modulations=tuple(MODS)))
    root = tmp_path_factory.mktemp("packed")
    with vdata.HDF5DataSource(path, jpath) as vsrc:
        vdata.pack_split_to_npy(vsrc, s.train, s.label_map, root / "vitiq", shard_rows=40)
    pdata.pack_split_to_npy(src, s.train, s.label_map, root / "port", shard_rows=40)
    src.close()
    return root / "vitiq", root / "port", s


def test_pack_split_to_npy_writes_vitiq_files(packed):
    vdir, pdir, s = packed
    names = sorted(p.name for p in vdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    assert len([n for n in names if n.startswith("x_")]) == -(-len(s.train) // 40)
    match, mismatch, errors = filecmp.cmpfiles(vdir, pdir, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("parallel", [False, True])
def test_packed_source_matches_vitiq(packed, parallel, monkeypatch):
    vdir, pdir, s = packed
    vsrc = vdata.PackedDataSource(vdir, parallel_reads=parallel)
    rows = np.random.default_rng(0).integers(0, len(s.train), 150)
    with pdata.PackedDataSource(pdir, parallel_reads=parallel) as psrc:
        assert native.available()
        np.testing.assert_array_equal(psrc.read_rows(rows), vsrc.read_rows(rows))
        for shuffle, seed, drop_last in ((True, 5, True), (True, 6, False), (False, 0, False)):
            kw = dict(batch_size=24, shuffle=shuffle, seed=seed, drop_last=drop_last)
            _assert_same_batches(_batches(psrc.batch_stream(**kw)),
                                 _batches(vsrc.batch_stream(**kw)))
        # the numpy path where the native gather is unavailable
        monkeypatch.setattr(native, "_load", lambda: None)
        assert not native.available()
        np.testing.assert_array_equal(psrc.read_rows(rows), vsrc.read_rows(rows))


def test_native_gather_matches_numpy_and_checks_bounds():
    src = np.random.default_rng(1).standard_normal((20, 8, 2)).astype(np.float32)
    dst = np.zeros((5, 8, 2), np.float32)
    rows = np.array([3, 19, 0, 3, 7])
    assert native.gather_rows(dst, src, rows)
    np.testing.assert_array_equal(dst, src[rows])
    dst2 = np.zeros_like(dst)
    assert native.gather_scatter_rows(dst2, np.array([4, 0]), src, np.array([1, 2]))
    np.testing.assert_array_equal(dst2[[4, 0]], src[[1, 2]])
    with pytest.raises(IndexError):
        native.gather_rows(dst, src, np.array([20]))
    assert not native.gather_rows(dst.astype(np.float64), src, rows)  # dtype differs


def test_stream_feed_epochs_match_vitiq(packed):
    vdir, pdir, s = packed
    vsrc, psrc = vdata.PackedDataSource(vdir), pdata.PackedDataSource(pdir)
    vfeed = vdata.StreamFeed(vsrc.batch_stream, vsrc.num_rows, shuffle_seed=11)
    pfeed = pdata.StreamFeed(psrc.batch_stream, psrc.num_rows, shuffle_seed=11, source=psrc)
    assert pfeed.num_samples == len(s.train)
    for epoch in (0, 1, 4):
        _assert_same_batches(_batches(pfeed.train_batches(epoch, 32)),
                             _batches(vfeed.train_batches(epoch, 32)))
    _assert_same_batches(_batches(pfeed.eval_batches(32)), _batches(vfeed.eval_batches(32)))
    _assert_same_batches(_batches(pfeed.raw_batches(32)), _batches(vfeed.raw_batches(32)))
    assert psrc._ensure_pool() is not None
    pfeed.close()
    assert psrc._pool is None


def _exp_cfgs(path, jpath, tmp_path, streaming):
    common = dict(data={"source": "hdf5", "file_path": path, "json_path": jpath,
                        "target_modulations": MODS, "streaming": streaming,
                        "stream_window_rows": 64, "norm_sample_count": 200},
                  model={"arm": "rawiq", "num_classes": 3, "d_model": 32, "n_head": 4,
                         "n_layers": 2, "ffn_hidden": 64, "seq_length": L,
                         "segment_size": 16, "numerics": "reference"},
                  train={"batch_size": 24, "num_epochs": 2, "shuffle_seed": 5},
                  checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
    return VExperimentConfig.from_dict(common), ExperimentConfig.from_dict(common)


@pytest.mark.parametrize("streaming", [False, True])
def test_load_experiment_feeds_matches_vitiq(radioml, tmp_path, streaming):
    from vitiq.runner import load_experiment_feeds as vload
    from vitiq_torch.runner import load_experiment_feeds as pload

    vcfg, pcfg = _exp_cfgs(*radioml, tmp_path, streaming)
    vfeeds, vstats, vnames = vload(vcfg)
    pfeeds, pstats, pnames = pload(pcfg)
    assert pstats == vstats and pnames == vnames
    kind = pdata.StreamFeed if streaming else pdata.ArrayFeed
    assert all(isinstance(f, kind) for f in pfeeds.values())
    for name in ("train", "valid", "test"):
        v, p = vfeeds[name], pfeeds[name]
        assert p.num_samples == v.num_samples
        _assert_same_batches(_batches(p.train_batches(1, 24)), _batches(v.train_batches(1, 24)))
        _assert_same_batches(_batches(p.eval_batches(24)), _batches(v.eval_batches(24)))
        _assert_same_batches(_batches(p.raw_batches(24)), _batches(v.raw_batches(24)))
    for f in (*vfeeds.values(), *pfeeds.values()):
        f.close()
    if streaming:
        assert all(f.source._file is None for f in pfeeds.values())


def test_frame_geometry_is_checked_when_the_file_opens(radioml, tmp_path):
    from vitiq_torch.runner import load_experiment_feeds

    _, pcfg = _exp_cfgs(*radioml, tmp_path, True)
    pcfg.model.seq_length = 2 * L
    with pytest.raises(ValueError, match="seq_length"):
        load_experiment_feeds(pcfg)


def _reference_dict(path, jpath):
    """The UPPERCASE config the reference embeds in its checkpoints."""
    return {"BATCH_SIZE": 32, "SEQ_LENGTH": L, "EMBEDDING_TYPE": "segment", "SEGMENT_SIZE": 16,
            "USE_CLS_TOKEN": True, "D_MODEL": 32, "N_HEAD": 4, "N_LAYERS": 2, "FFN_HIDDEN": 64,
            "DROP_PROB": 0.1, "TARGET_MODULATIONS": MODS, "FILE_PATH": path, "JSON_PATH": jpath,
            "SPLIT_SEED": 42, "NORM_SEED": 49}


def test_run_reference_evaluation_matches_vitiq(radioml, tmp_path):
    from vitiq.interop import load_torch_state_dict
    from vitiq.runner import build_forward_and_preprocess as vbuild
    from vitiq.runner import load_experiment_feeds as vload
    from vitiq.runner import run_reference_evaluation as vrun
    from vitiq_torch.models import AMCModel
    from vitiq_torch.runner import run_reference_evaluation
    from vitiq_torch.serve import build_forward_and_preprocess

    path, jpath = radioml
    ref = _reference_dict("C:\\nowhere\\corpus.hdf5", "C:\\nowhere\\classes.json")
    cfg = ExperimentConfig.from_reference_dict(ref)
    model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(3))
    pth = tmp_path / "model_best.pth"
    torch.save({"model_state_dict": model.state_dict(), "config": ref, "epoch": 12}, pth)

    kw = dict(dataset="test", data_path=path, json_path=jpath, verbose=False)
    want = vrun(str(pth), output_dir=str(tmp_path / "vitiq"), **kw)
    got = run_reference_evaluation(str(pth), output_dir=str(tmp_path / "port"), device="cpu",
                                   make_plots=False, **kw)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])
    assert got["snr_accuracies"] == want["snr_accuracies"]
    for name in ("test_classification_report.txt",):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "vitiq" / name).read_bytes()
    pkl = pickle.loads((tmp_path / "port" / "test_results.pkl").read_bytes())
    np.testing.assert_array_equal(pkl["confusion_matrix"], want["confusion_matrix"])

    # the logits behind those predictions, on the first test batch
    vcfg = VExperimentConfig.from_reference_dict(ref)
    vcfg.data.file_path, vcfg.data.json_path = path, jpath
    feeds, stats, _ = vload(vcfg)
    x = next(feeds["test"].raw_batches(32))[0]
    vfwd, vpre = vbuild(vcfg, stats)
    want_logits = np.asarray(vfwd(load_torch_state_dict(model.state_dict(), vcfg.model),
                                  vpre(x), train=False))
    fwd, pre = build_forward_and_preprocess(cfg, model, stats, "cpu")
    with torch.no_grad():
        got_logits = fwd.eval()(pre(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4, rtol=0)


def test_run_reference_evaluation_config_order_and_missing_weights(radioml, tmp_path):
    from vitiq_torch.models import AMCModel
    from vitiq_torch.runner import run_reference_evaluation

    path, jpath = radioml
    ref = _reference_dict(path, jpath)
    model = AMCModel(ExperimentConfig.from_reference_dict(ref).model)
    pth = tmp_path / "bare.pth"
    torch.save(model.state_dict(), pth)  # a bare state dict: no embedded config
    with pytest.raises(FileNotFoundError, match="no config found"):
        run_reference_evaluation(str(pth), device="cpu", make_plots=False, verbose=False)
    (tmp_path / "config.json").write_text(json.dumps(ref))  # a sibling reference config
    res = run_reference_evaluation(str(pth), output_dir=str(tmp_path / "out"), device="cpu",
                                   make_plots=False, verbose=False)
    assert set(res["snr_accuracies"]) == {-8, 0, 8}
    sd = model.state_dict()
    del sd["mlp_head.1.weight"]
    torch.save({"model_state_dict": sd}, pth)
    with pytest.raises(KeyError, match="mlp_head.1.weight"):
        run_reference_evaluation(str(pth), device="cpu", make_plots=False, verbose=False)


def test_cli_evaluate_torch_checkpoint_on_the_cpu(radioml, tmp_path, capsys):
    from vitiq_torch.models import AMCModel

    path, jpath = radioml
    ref = _reference_dict(path, jpath)
    model = AMCModel(ExperimentConfig.from_reference_dict(ref).model)
    pth = tmp_path / "ckpt.pth"
    torch.save({"model_state_dict": model.state_dict(), "config": ref}, pth)
    out = tmp_path / "artifacts"
    assert cli.main(["evaluate", "--torch-checkpoint", str(pth), "--output", str(out),
                     "--batch_size", "16", "--device", "cpu", "--no_plots"]) == 0
    assert "overall accuracy" in capsys.readouterr().out
    assert (out / "test_classification_report.txt").exists()
    with pytest.raises(SystemExit, match="required"):
        cli.main(["evaluate", "--device", "cpu"])


@pytest.mark.parametrize("streaming", [False, True])
def test_cli_train_reads_hdf5_with_step_profiling(radioml, tmp_path, streaming):
    path, jpath = radioml
    _, cfg = _exp_cfgs(path, jpath, tmp_path, streaming)
    cfg.experiment_name = "h5"
    cfg.to_json(str(tmp_path / "h5.json"))
    argv = ["train", "--config", str(tmp_path / "h5.json"), "--source", "hdf5",
            "--num_epochs", "2", "--profile_steps", "--device", "cpu", "--no_plots"]
    assert cli.main(argv + (["--streaming"] if streaming else [])) == 0
    summary = json.loads((tmp_path / "ckpt" / "h5" / "summary.json").read_text())
    manifest = json.loads((tmp_path / "ckpt" / "h5" / "checkpoint_final.json").read_text())
    assert summary["epochs_run"] == 2 and summary["step_times"]["steps"] > 0
    assert len(manifest["history"]["step_p50"]) == len(manifest["history"]["step_p90"]) == 2
    assert 0.0 <= summary["test_overall_accuracy"] <= 1.0


def test_cli_train_hdf5_needs_its_file(tmp_path):
    with pytest.raises(ValueError, match="HDF5 file not found"):
        cli.main(["train", "--arm", "rawiq", "--source", "hdf5", "--file_path",
                  str(tmp_path / "missing.hdf5"), "--device", "cpu"])


def test_stream_feed_of_a_split_reads_like_its_array_feed(radioml):
    """Unshuffled, a split streamed from the file gives the rows that the
    in-RAM feed holds, in the same (sorted) order."""
    path, jpath = radioml
    with pdata.HDF5DataSource(path, jpath) as src:
        s = src.split(DataConfig(source="hdf5", file_path=path, json_path=jpath,
                                 target_modulations=tuple(MODS)))
        x, y, z = src.load_split_arrays(s.valid, s.label_map)
        feed = pdata.StreamFeed(functools.partial(src.batch_stream, s.valid, s.label_map,
                                                  window_rows=32), len(s.valid))
        _assert_same_batches(_batches(feed.raw_batches(10)),
                             _batches(pdata.ArrayFeed(x, y, z).raw_batches(10)))
