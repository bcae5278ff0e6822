"""Device timing of the probes: the counterpart of `time_amortized`
(scripts/tpu_probe_refcost.py:68).

The TPU probe queued `inner` calls of a jitted function and waited once, the
median of `reps` such runs. On the card the same is CUDA events around
`inner` back-to-back calls on the current stream, after one warm-up call.
A time is only ever taken on the card: these functions raise for any other
device.
"""

from __future__ import annotations

import statistics

import torch


def require_cuda(device) -> torch.device:
    """`device` as a torch.device; raises unless it is a CUDA device and CUDA
    is available."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probes time and check kernels on a CUDA GPU; got device "
                           f"{device} (CUDA available: {torch.cuda.is_available()})")
    return device


def time_amortized(fn, args, inner: int = 40, reps: int = 5) -> float:
    """Seconds per call of fn(seed, *args): the median over `reps` runs of
    `inner` back-to-back calls, each run timed by CUDA events. Call i gets a
    0-d f32 seed tensor of value i on the args' device, with which fn
    perturbs its first input where a call's result could otherwise be reused
    (the TPU probe's run did). Raises unless the first arg lies on a CUDA
    device."""
    device = require_cuda(args[0].device)
    seeds = [torch.tensor(float(i), device=device) for i in range(inner + 1)]
    fn(seeds[0], *args)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(inner):
            fn(seeds[i + 1], *args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / inner)
    return statistics.median(times)
