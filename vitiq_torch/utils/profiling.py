"""Tracing and profiling (counterpart of `vitiq/utils/profiling.py`).

* `StepTimer`: per-step wall times that mean device time. CUDA launches
  return before the device finishes, so a clock read around a step measures
  the enqueue; `StepTimer.sync` waits for the device (``torch.cuda.synchronize``
  for a CUDA value, nothing on the CPU) before the clock stops, and `summary`
  gives p50 / p90 / best / mean.
* `trace_context`: `torch.profiler` over a region (CPU and, where present,
  CUDA activity), written as a Chrome trace (``trace.json``) into `log_dir`.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def format_time(seconds: float) -> str:
    """Human-readable duration (parity with ref utils.py:681-700)."""
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        m, s = divmod(seconds, 60)
        return f"{int(m)}m {s:.0f}s"
    h, rem = divmod(seconds, 3600)
    m = rem / 60
    return f"{int(h)}h {m:.0f}m"


@dataclass
class StepTimer:
    """Per-step wall times, each closed after the device finished the step:

        timer = StepTimer()
        with timer.step():
            state, metrics = train_step(...)
            timer.sync(metrics["loss"])   # wait for the device first
    """

    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    @contextlib.contextmanager
    def step(self):
        self._t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def sync(self, value) -> None:
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        """p50/p90/best/mean over the recorded steps, skipping the first
        `skip_first` (warm-up) where more were recorded."""
        t = np.asarray(self.times[skip_first:] if len(self.times) > skip_first
                       else self.times)
        if len(t) == 0:
            return {}
        return {
            "steps": int(len(t)),
            "p50_s": float(np.median(t)),
            "p90_s": float(np.percentile(t, 90)),
            "best_s": float(t.min()),
            "mean_s": float(t.mean()),
        }


@contextlib.contextmanager
def trace_context(log_dir: str = "result/trace", enabled: bool = True):
    """`torch.profiler` over the wrapped region; on exit its Chrome trace is
    written to ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler (None when not `enabled`)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
