"""Where the time of the port's paths goes on a CUDA card.

    python3 tools/profile_paths.py [--out FILE.json]

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and nvcc.  For each path below, on the inputs
``chip_smoke.py`` drives (built by its own functions): the call time
(CUDA events, median of 10 after warm-up,
``utils.benchmarking.cuda_time``), then ``torch.profiler`` over 3 calls
after 2 warm-up calls: device time a call (the sum of the device events'
own times), device events a call (kernels, copies and sets), the busy
share (device time a call over the unprofiled call time; the
profiler's own overhead lengthens its window, whose share is kept as
``window_share``), and the five largest device entries by name.  The
paths: the 256-wide solve, inverse, det and LU paths, the large-N
solves, schur-gauss-256's ``eigvals_schur`` and one of its outer sweeps
as a CUDA-graph replay.  Prints
one line per path and the card's name and power limit, and writes the
same as JSON to ``--out`` when given.  Needs a card: without one it
exits with an error.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())


def _paths(dev):
    """Each path with its arguments: the inputs ``chip_smoke.py`` drives
    (its builders, so that both scripts measure the same cells)."""
    import chip_smoke as cs
    from linalg_solver_tpu_torch.ops import dispatch, schur

    a, b = cs.bench_batch(dev)
    ap, bp = cs.phase_batch(dev)
    paths = {
        "solve-256 solve_batched(auto)": (dispatch.solve_batched, a, b),
        "solve-256-k16 solve_batched(auto)": (dispatch.solve_batched, ap, bp),
        "inverse-256 inverse_batched(auto)": (dispatch.inverse_batched, ap),
        "solve-256-mixed solve_batched(mixed)": (
            lambda x, y: dispatch.solve_batched(x, y, "mixed"), a, b),
        "det-256 det_batched(auto)": (dispatch.det_batched,
                                      cs.det_batch(dev)),
        "lu-factor-256 lu_factor_batched(auto)": (
            dispatch.lu_factor_batched, a),
    }
    for bsz, n in cs.LARGE_CELLS:
        paths[f"large-{n} solve_batched(auto)"] = (
            dispatch.solve_batched, *cs.large_batch(bsz, n, dev))
    g = cs.gaussian_input(dev)
    paths["schur-gauss-256 eigvals_schur"] = (schur.eigvals_schur, g)
    H, Q, hi, st, an, _ = schur._schur_init(g)
    npairs = schur._auto_npairs(g.shape[1])
    state = (H, Q, hi, st, an, torch.zeros_like(hi, dtype=torch.bool),
             torch.zeros((), dtype=torch.long, device=dev))
    paths["schur-gauss-256 one outer sweep (CUDA graph)"] = (
        schur._sweep_graph(state, npairs, schur._auto_aed_w(
            g.shape[1], npairs)).replay,)
    return paths


def _device_stats(prof, calls: int):
    """(device ms a call, device events a call, top five [name, ms a
    call]) from a finished profiler: the entries that ran on the device
    (kernels, copies, sets), not the host operators that launched them
    nor the profiler's own buffer requests."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((e.key, t / 1e3 / calls, e.count / calls))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    events = sum(r[2] for r in rows)
    return total, events, [[k, ms] for k, ms, _ in rows[:5]]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the results here (JSON)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths.py: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    out = {"card": card, "torch": torch.__version__, "paths": {}}
    calls = 3
    for name, (fn, *xs) in _paths(dev).items():
        call_ms = cuda_time(fn, *xs, warmup=3, iters=10) * 1e3
        for _ in range(2):
            fn(*xs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*xs)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        dev_ms, events, top = _device_stats(prof, calls)
        row = {"call_ms": call_ms, "device_ms": dev_ms,
               "device_events": events, "busy_share": dev_ms / call_ms,
               "window_share": dev_ms * calls / window_ms, "top": top}
        out["paths"][name] = row
        print(f"{name}: call {call_ms:.4f} ms, device {dev_ms:.4f} ms a call "
              f"in {events:.0f} device events, busy share "
              f"{row['busy_share']:.3f} ({card})")
        for k, ms in top:
            print(f"    {ms:.4f} ms  {k[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
