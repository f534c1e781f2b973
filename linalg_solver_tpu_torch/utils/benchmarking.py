"""CUDA-event timing and profiling (counterpart of
``linalg_solver_tpu.utils.benchmarking``: ``cuda_time`` for its
``device_slope_time``, ``chained_time`` and ``profiler_trace`` under
their own names).

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

import contextlib
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


def chained_time(fn: Callable, *args, iters: int = 15,
                 repeats: int = 2) -> float:
    """Mean seconds per call of ``fn(*args)`` over a chain of ``iters``
    calls on the current CUDA device, each call's first input nudged by
    ``1e-12`` times a scalar of the previous output (so the calls run in
    order and none can be skipped), bracketed by one pair of CUDA events;
    the best of ``repeats`` chains (the first is shorter and warms up)."""
    if not torch.cuda.is_available():
        raise RuntimeError("chained_time needs a CUDA device")

    def leaf(out):
        while isinstance(out, (tuple, list)):
            out = out[0]
        return out.reshape(-1)[0]

    def run(k: int) -> float:
        out = fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        chained = args[0]
        start.record()
        for _ in range(k):
            out = fn(chained, *args[1:])
            chained = args[0] + 1e-12 * leaf(out)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / k

    return min(run(iters if r else max(iters // 3, 2))
               for r in range(repeats))


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile a block's CUDA activity with ``torch.profiler`` and write a
    Chrome trace into ``log_dir`` (the reference's ``trace`` context on
    ``jax.profiler``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("profiler_trace needs a CUDA device")
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
