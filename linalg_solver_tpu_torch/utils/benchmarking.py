"""CUDA-event timing (counterpart of ``device_slope_time`` in
``linalg_solver_tpu.utils.benchmarking``).

PyTorch returns from a CUDA call before the device has finished, so a
host clock without a synchronise measures the enqueue.  ``cuda_time``
brackets each run with a pair of CUDA events on the current stream,
synchronises once after all runs, and reports the median.  Where a call
is several short launches, the host's launch gaps fill that bracket;
``device_time`` sums what the profiler saw the device run instead.
There is no CPU fallback: timing a CPU run under a device name would be
wrong.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_time(fn: Callable, *args, warmup: int = 3, iters: int = 10) -> float:
    """Median seconds per call of ``fn(*args)`` on the current CUDA
    device, after ``warmup`` untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    for _ in range(warmup):
        fn(*args)
    events = [
        (torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def device_time(fn: Callable, *args, warmup: int = 3, iters: int = 5,
                match: str = "") -> float:
    """Seconds of device time per call of ``fn(*args)``: the sum of the
    device entries (kernels, copies, sets) ``torch.profiler`` records over
    ``iters`` calls after ``warmup`` untimed ones, over ``iters``; with
    ``match``, only the entries whose name contains it.  A name seen
    about k times a call counts its mean entry k times, so that a record
    the profiler drops does not bias the sum (late in ``chip_smoke.py``
    the plain sum over five kernel-2 launches read 4/5 of their
    CUDA-event time)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity"):
            continue
        if match not in e.key:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        per_call = round(e.count / iters)
        total += t * per_call / e.count if per_call else t / iters
    return total / 1e6
