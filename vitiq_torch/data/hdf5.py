"""The HDF5 source and packed shards (counterpart of `vitiq/data/hdf5.py`):
the same batches, in the same order, under the same seeds.

* `HDF5DataSource` reads a RadioML-layout file (X [N, L, 2] f32, Y [N, K]
  one-hot, Z [N, 1] SNR dB): the reference split (`data/splits.py`), the
  normalization stats, whole splits in RAM, and one epoch of batches through
  windowed sequential reads (`batch_stream`). h5py is imported inside its
  methods.
* `pack_split_to_npy` writes a split as memory-mapped ``x_{s:05d}.npy``
  shards plus ``y.npy``, ``z.npy`` and ``meta.json``.
* `PackedDataSource` reads them back with numpy alone (no h5py: it runs on a
  machine without it): ``read_rows`` through the native gather
  (`data/native.py`, numpy where it is unavailable) and ``batch_stream`` one
  shard a shuffle window, the next shard read on a background thread.

Normalization and reshaping stay in the model's preprocessing on the device;
the host moves raw bytes, and `data/pipeline.py` copies them to the card
ahead of the step.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np

from vitiq_torch.config import DataConfig
from vitiq_torch.data.splits import SplitIndices, load_dataset_metadata, split_labels
from vitiq_torch.data.stats import stats_from_hdf5


def _batches(chunks, batch_size: int, drop_last: bool):
    """Full batches out of a stream of (x, y, z) chunks, the remainder of
    each chunk carried into the next; the final partial batch unless
    `drop_last`."""
    leftover = None
    for x, y, z in chunks:
        if leftover is not None:
            x = np.concatenate([leftover[0], x])
            y = np.concatenate([leftover[1], y])
            z = np.concatenate([leftover[2], z])
            leftover = None
        n_full = (len(x) // batch_size) * batch_size
        for b in range(0, n_full, batch_size):
            yield x[b:b + batch_size], y[b:b + batch_size], z[b:b + batch_size]
        if n_full < len(x):
            leftover = (x[n_full:], y[n_full:], z[n_full:])
    if leftover is not None and not drop_last:
        yield leftover


class HDF5DataSource:
    """Deterministic facade over a RadioML-style HDF5 file
    (X:(N,L,2) float32, Y:(N,K) one-hot, Z:(N,1) SNR dB)."""

    def __init__(self, file_path: str, json_path: str):
        import h5py

        self.file_path = str(file_path)
        self.json_path = str(json_path)
        self._file = None
        (self.y_strings, self.z, self.available_modulations, self.total_samples
         ) = load_dataset_metadata(self.file_path, self.json_path)
        with h5py.File(self.file_path, "r") as f:
            self.frame_len = int(f["X"].shape[1])

    # -- lifecycle ---------------------------------------------------------
    def _x(self):
        import h5py

        if self._file is None:
            self._file = h5py.File(self.file_path, "r")
        return self._file["X"]

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            finally:
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- splits / stats ------------------------------------------------------
    def split(self, cfg: DataConfig) -> SplitIndices:
        return split_labels(self.y_strings, self.z, cfg.target_modulations,
                            cfg.train_size, cfg.valid_size, cfg.test_size, cfg.split_seed)

    def normalization_stats(self, train_indices: np.ndarray,
                            cfg: DataConfig) -> Dict[str, float]:
        return stats_from_hdf5(self.file_path, train_indices, seed=cfg.norm_seed,
                               num_samples=cfg.norm_sample_count)

    def labels_for(self, indices: np.ndarray, label_map: Dict[str, int]) -> np.ndarray:
        return np.array([label_map[s] for s in self.y_strings[indices]], dtype=np.int32)

    def snrs_for(self, indices: np.ndarray) -> np.ndarray:
        return self.z[indices].astype(np.float32)

    # -- reads ---------------------------------------------------------------
    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        """Raw [n, L, 2] frames in any row order (duplicates allowed): the
        unique rows are read in sorted order (h5py needs it), then scattered
        back to the order asked for."""
        rows = np.asarray(rows)
        unique_rows, inverse = np.unique(rows, return_inverse=True)
        data = self._x()[unique_rows, ...]
        return data[inverse]

    def load_split_arrays(self, indices: np.ndarray, label_map: Dict[str, int],
                          chunk_size: int = 8192) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A whole split (X, y, snr) in RAM, its rows in sorted order."""
        idx_sorted = np.sort(np.asarray(indices))
        xs = [self._x()[idx_sorted[i:i + chunk_size], ...]
              for i in range(0, len(idx_sorted), chunk_size)]
        x = np.concatenate(xs) if xs else np.empty((0,), np.float32)
        return x, self.labels_for(idx_sorted, label_map), self.snrs_for(idx_sorted)

    def batch_stream(
        self,
        indices: np.ndarray,
        label_map: Dict[str, int],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        window_rows: int = 65536,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One epoch of (x, y, snr) batches through windowed sequential reads:
        the file is read as contiguous `window_rows` slices (fancy-index reads
        are far slower) and the split's rows picked in memory; with `shuffle`
        the window order and the rows within each window are permuted under
        `seed` (a streaming shuffle buffer, not a full permutation)."""
        rng = np.random.default_rng(seed)
        rows_sorted = np.sort(np.asarray(indices))
        n_total = self.total_samples
        windows = list(range(0, n_total, window_rows))
        if shuffle:
            rng.shuffle(windows)
        x_dset = self._x()

        def chunks():
            for w0 in windows:
                w1 = min(w0 + window_rows, n_total)
                lo = np.searchsorted(rows_sorted, w0)
                hi = np.searchsorted(rows_sorted, w1)
                if lo == hi:
                    continue
                sel_rows = rows_sorted[lo:hi]
                x = x_dset[w0:w1][sel_rows - w0]  # one contiguous read
                y = self.labels_for(sel_rows, label_map)
                z = self.snrs_for(sel_rows)
                if shuffle:
                    perm = rng.permutation(len(sel_rows))
                    x, y, z = x[perm], y[perm], z[perm]
                yield x, y, z

        return _batches(chunks(), batch_size, drop_last)


def pack_split_to_npy(source, indices: np.ndarray, label_map: Dict[str, int],
                      out_dir: str | Path, shard_rows: int = 65536) -> Path:
    """Write a split as memory-mapped .npy shards plus meta.json. `source`
    is anything with `read_rows`, `labels_for` and `snrs_for` (an
    `HDF5DataSource`); rows go in sorted order, `shard_rows` a shard."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    idx_sorted = np.sort(np.asarray(indices))
    shards = []
    for s, start in enumerate(range(0, len(idx_sorted), shard_rows)):
        rows = idx_sorted[start:start + shard_rows]
        np.save(out_dir / f"x_{s:05d}.npy", source.read_rows(rows))
        shards.append(len(rows))
    np.save(out_dir / "y.npy", source.labels_for(idx_sorted, label_map))
    np.save(out_dir / "z.npy", source.snrs_for(idx_sorted))
    (out_dir / "meta.json").write_text(json.dumps({
        "num_rows": int(len(idx_sorted)),
        "shard_rows": shard_rows,
        "shards": shards,
        "label_map": label_map,
    }))
    return out_dir


class PackedDataSource:
    """Memory-mapped reader of `pack_split_to_npy`'s output (numpy only).

    `read_rows` copies rows shard by shard through the native gather, and
    fans the shards out over a thread pool only with ``parallel_reads=True``
    (for cold storage: on a warm page cache many small copies contend for
    the interpreter lock). The pool's default job is `batch_stream`'s
    look-ahead of one shard. `close()` shuts the pool down."""

    def __init__(self, packed_dir: str | Path, num_threads: int = 8,
                 parallel_reads: bool = False):
        self.dir = Path(packed_dir)
        meta = json.loads((self.dir / "meta.json").read_text())
        self.num_rows: int = meta["num_rows"]
        self.shard_rows: int = meta["shard_rows"]
        self.label_map: Dict[str, int] = meta["label_map"]
        self.y = np.load(self.dir / "y.npy")
        self.z = np.load(self.dir / "z.npy")
        self._shards = [np.load(p, mmap_mode="r") for p in sorted(self.dir.glob("x_*.npy"))]
        self.num_threads = num_threads
        self.parallel_reads = parallel_reads
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None and self.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_threads,
                                            thread_name_prefix="vitiq-torch-packed-read")
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        from vitiq_torch.data import native

        rows = np.asarray(rows)
        out = np.empty((len(rows),) + self._shards[0].shape[1:], self._shards[0].dtype)
        shard_ids = rows // self.shard_rows
        offsets = rows % self.shard_rows
        uniq = np.unique(shard_ids)

        def fill(sid):
            m = shard_ids == sid
            if not native.gather_scatter_rows(out, np.flatnonzero(m), self._shards[sid],
                                              offsets[m]):
                out[m] = self._shards[sid][offsets[m]]

        pool = self._ensure_pool() if self.parallel_reads and len(uniq) > 1 else None
        if pool is None:
            for sid in uniq:
                fill(sid)
        else:
            list(pool.map(fill, uniq))
        return out

    def batch_stream(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One epoch of (x, y, snr) batches, `HDF5DataSource.batch_stream`'s
        contract with each shard a shuffle window: the shard order and the
        rows within each shard are permuted under `seed` (all permutations
        drawn up front, so the stream does not depend on the look-ahead's
        timing), and about two shards are resident at a time."""
        rng = np.random.default_rng(seed)
        shard_order = np.arange(len(self._shards))
        if shuffle:
            rng.shuffle(shard_order)
        orders = [rng.permutation(self._shards[sid].shape[0]) if shuffle
                  else np.arange(self._shards[sid].shape[0]) for sid in shard_order]

        def load(i):
            sid = int(shard_order[i])
            start_row = sid * self.shard_rows
            order = orders[i]
            x = np.asarray(self._shards[sid])[order]  # one sequential read
            return x, self.y[start_row + order], self.z[start_row + order]

        def chunks():
            pool = self._ensure_pool()
            fut = pool.submit(load, 0) if pool is not None and len(shard_order) else None
            for i in range(len(shard_order)):
                if fut is not None:
                    chunk = fut.result()
                    fut = pool.submit(load, i + 1) if i + 1 < len(shard_order) else None
                else:
                    chunk = load(i)
                yield chunk

        return _batches(chunks(), batch_size, drop_last)
