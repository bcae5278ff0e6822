"""The port's host-to-device feed and per-step profiling on the CPU.

`Prefetcher` / `device_prefetch` (`vitiq_torch/data/pipeline.py`) keep the
order of the stream, hand a worker's error to the consumer after the items
before it, end with the stream and stop their thread when the consumer
leaves early; on a CUDA device without CUDA they raise. `fit(profile=True)`
adds per-epoch step_p50 / step_p90 to the history; `fit` through the
prefetcher trains the same parameters, bit for bit, as batch-by-batch
copies (over an in-RAM and a packed streaming feed); `evaluate_feed` gives
the `val_loss` the per-batch host sums gave before its sums moved to the
device; `predict_feed` the predictions of per-batch host copies. The
profiling helpers match the JAX package's (`format_time`, `StepTimer`'s
summary) and `trace_context` writes a Chrome trace. The prefetcher's copies
to the card are held in `tests/test_torch_cuda.py`.
"""

import json
import threading

import numpy as np
import pytest
import torch

from vitiq.utils import profiling as vprof
from vitiq_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from vitiq_torch.data import ArrayFeed, PackedDataSource, StreamFeed, pack_split_to_npy
from vitiq_torch.data import pipeline
from vitiq_torch.data.pipeline import Prefetcher, device_prefetch
from vitiq_torch.eval.evaluate import predict_feed
from vitiq_torch.models import AMCModel
from vitiq_torch.serve import build_forward_and_preprocess
from vitiq_torch.train import loop
from vitiq_torch.utils import profiling

L = 64
STATS = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}


def test_prefetcher_keeps_the_order_and_ends_with_the_stream():
    assert list(Prefetcher(range(100), prefetch_depth=3)) == list(range(100))
    assert list(Prefetcher(iter(()), prefetch_depth=1)) == []
    items = [(np.arange(3), np.ones(2)) for _ in range(5)]
    got = list(device_prefetch(iter(items), "cpu", prefetch_depth=2))
    assert all(g is w for g, w in zip(got, items)) and len(got) == 5  # as they come


def test_prefetcher_applies_its_transform_in_the_worker():
    names = []

    def transform(item):
        names.append(threading.current_thread().name)
        return item * 2

    assert list(Prefetcher(range(4), transform=transform)) == [0, 2, 4, 6]
    assert set(names) == {"vitiq-torch-prefetch"}


def test_prefetcher_hands_a_worker_error_to_the_consumer():
    def stream():
        yield from range(3)
        raise ValueError("the disk went away")

    got = []
    with pytest.raises(ValueError, match="the disk went away"):
        for item in Prefetcher(stream(), prefetch_depth=2):
            got.append(item)
    assert got == [0, 1, 2]


def test_an_abandoned_prefetcher_stops_its_thread():
    pf = Prefetcher(iter(range(10_000)), prefetch_depth=2)
    it = iter(pf)
    assert [next(it), next(it)] == [0, 1]
    it.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


def test_device_prefetch_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_prefetch(iter(()), "cuda")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        device_prefetch(iter(()), "meta")
    with pytest.raises(ValueError, match="prefetch_depth"):
        device_prefetch(iter(()), "cpu", prefetch_depth=0)


def _experiment(epochs=2, batch=16):
    return ExperimentConfig(
        model=ModelConfig(arm="rawiq", num_classes=3, d_model=32, n_head=4, n_layers=1,
                          ffn_hidden=64, seq_length=L, segment_size=16, drop_prob=0.1),
        train=TrainConfig(batch_size=batch, num_epochs=epochs, learning_rate=1e-3,
                          prefetch_depth=2))


def _data(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = (rng.standard_normal((n, L, 2)) + 0.5 * y[:, None, None]).astype(np.float32)
    return x, y, rng.choice([-8.0, 0.0, 8.0], n).astype(np.float32)


def _model(cfg):
    model = AMCModel(cfg.model, generator=torch.Generator().manual_seed(0))
    return build_forward_and_preprocess(cfg, model, STATS, "cpu")


def _synchronous(batch_iter, device=None, prefetch_depth=3):
    """Each batch copied in the consumer, as `fit` did before the prefetcher."""
    for item in batch_iter:
        yield tuple(torch.as_tensor(a).to(device) for a in item)


class _Rows:
    """A packing source over in-RAM arrays (read_rows, labels_for, snrs_for)."""

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def read_rows(self, rows):
        return self.x[rows]

    def labels_for(self, rows, label_map):
        return self.y[rows].astype(np.int32)

    def snrs_for(self, rows):
        return self.z[rows]


def _packed_feed(x, y, z, out_dir, shuffle_seed):
    pack_split_to_npy(_Rows(x, y, z), np.arange(len(x)), {"a": 0, "b": 1, "c": 2}, out_dir,
                      shard_rows=48)
    src = PackedDataSource(out_dir)
    return StreamFeed(src.batch_stream, src.num_rows, shuffle_seed=shuffle_seed, source=src)


@pytest.mark.parametrize("feed", ["array", "packed"])
def test_fit_through_the_prefetcher_trains_what_batch_copies_train(feed, tmp_path, monkeypatch):
    cfg = _experiment()
    x, y, z = _data(112, 1)
    xv, yv, _ = _data(40, 2)
    params = []
    for run, prefetch in enumerate((loop.device_prefetch, _synchronous)):
        monkeypatch.setattr(loop, "device_prefetch", prefetch)
        train = (ArrayFeed(x, y, z, shuffle_seed=cfg.train.shuffle_seed) if feed == "array" else
                 _packed_feed(x, y, z, tmp_path / str(run), cfg.train.shuffle_seed))
        model, pre = _model(cfg)
        res = loop.fit(cfg, model, train, (xv, yv), preprocess_fn=pre, verbose=False)
        train.close()
        params.append([p.detach().clone() for p in model.parameters()])
        assert res.state.step == 2 * (112 // 16)
    for a, b in zip(*params):
        assert torch.equal(a, b)


def test_fit_profile_adds_step_percentiles_to_the_history(capsys):
    cfg = _experiment(epochs=3)
    model, pre = _model(cfg)
    x, y, _ = _data(64, 3)
    res = loop.fit(cfg, model, (x, y), _data(20, 4)[:2], preprocess_fn=pre, profile=True)
    h = res.history
    assert len(h["step_p50"]) == len(h["step_p90"]) == 3
    assert all(0 < p50 <= p90 for p50, p90 in zip(h["step_p50"], h["step_p90"]))
    assert res.step_times["steps"] == 3 * 4 - 1  # the first step is the warm-up
    assert "step p50=" in capsys.readouterr().out
    model, pre = _model(cfg)
    plain = loop.fit(cfg, model, (x, y), _data(20, 4)[:2], preprocess_fn=pre, verbose=False)
    assert "step_p50" not in plain.history and plain.step_times is None


def _evaluate_feed_per_batch(eval_step, model, feed, batch_size):
    """`evaluate_feed` before its sums moved to the device: each batch's
    three sums read to the host and added there."""
    loss_sum = correct_sum = count = 0.0
    for bx, by, mask in feed.eval_batches(batch_size):
        m = eval_step(model, bx, by, mask)
        loss_sum += float(m["loss_sum"])
        correct_sum += float(m["correct_sum"])
        count += float(m["count"])
    return {"loss": loss_sum / count, "accuracy": correct_sum / count}


@pytest.mark.parametrize("n", [13, 48, 61])
def test_evaluate_feed_gives_the_val_loss_of_per_batch_host_sums(n):
    cfg = _experiment()
    model, pre = _model(cfg)
    step = loop.make_eval_step(cfg.train.label_smoothing, pre)
    feed = ArrayFeed(*_data(n, 5))
    assert loop.evaluate_feed(step, model, feed, 16) == _evaluate_feed_per_batch(
        step, model, feed, 16)


@torch.no_grad()
def _predict_feed_per_batch(forward_fn, feed, batch_size, preprocess_fn):
    """`predict_feed` before the prefetcher: each batch's argmax copied to
    the host before the next batch."""
    preds, labels, snrs = [], [], []
    for bx, by, bz in feed.raw_batches(batch_size):
        n_valid = len(bx)
        x = torch.as_tensor(np.asarray(bx, np.float32))
        if n_valid < batch_size:
            x = torch.cat([x, torch.zeros((batch_size - n_valid,) + tuple(x.shape[1:]))])
        preds.append(forward_fn(preprocess_fn(x)).argmax(dim=-1)[:n_valid].numpy())
        labels.append(np.asarray(by))
        snrs.append(np.asarray(bz))
    return np.concatenate(preds), np.concatenate(labels), np.concatenate(snrs)


def test_predict_feed_gives_the_predictions_of_per_batch_copies():
    cfg = _experiment()
    model, pre = _model(cfg)
    model.eval()
    feed = ArrayFeed(*_data(53, 6))
    got = predict_feed(model, feed, 16, "cpu", pre, prefetch_depth=2)
    want = _predict_feed_per_batch(model, feed, 16, pre)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_profiling_helpers_match_vitiq(tmp_path):
    for s in (0.04, 59.9, 61.0, 3599.0, 3600.0, 7384.5):
        assert profiling.format_time(s) == vprof.format_time(s)
    times = [0.5, 0.01, 0.03, 0.02, 0.04]
    mine, theirs = profiling.StepTimer(), vprof.StepTimer()
    mine.times, theirs.times = list(times), list(times)
    for skip in (0, 1, 9):
        assert mine.summary(skip) == theirs.summary(skip)
    timer = profiling.StepTimer()
    with timer.step():
        timer.sync(torch.ones(2))  # nothing to wait for on the CPU
    assert len(timer.times) == 1 and timer.times[0] >= 0
    with profiling.trace_context(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    with profiling.trace_context(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()


def test_pinned_buffers_take_turns_by_shape(monkeypatch):
    """The CUDA prefetcher's ring, as the worker uses it: two pinned buffers
    a (shape, dtype), handed out in turns, each only after its last copy's
    event has completed (`_slot` waits on it)."""
    waited = []

    class Event:
        def __init__(self, name):
            self.name = name

        def synchronize(self):
            waited.append(self.name)

    pf = object.__new__(pipeline.CudaPrefetcher)
    pf._rings, pf._turns = {}, {}
    pinned = []
    torch_empty = torch.empty

    def fake_empty(shape, dtype=None, pin_memory=False):
        pinned.append(pin_memory)
        return torch_empty(shape, dtype=dtype)

    monkeypatch.setattr(pipeline.torch, "empty", fake_empty)
    slots = []
    for turn in range(5):
        slot = pf._slot((4, 2), torch.float32)
        slot[1] = Event(turn)
        slots.append(slot)
    other = pf._slot((3,), torch.int64)
    assert pinned == [True, True, True]
    assert slots[0] is slots[2] is slots[4] and slots[1] is slots[3]
    assert waited == [0, 1, 2]  # turns 2, 3, 4 waited on turns 0, 1, 2
    assert other is not slots[0] and other[0].shape == (3,)
