"""Time the real Schur solver's kernels and cells on a CUDA card, for
comparing two versions of the package.

    python3 tools/time_schur.py [--label NAME] [--out FILE.json]
                                [--dump FILE.pt]
    python3 tools/time_schur.py --compare A.pt B.pt
    python3 tools/time_schur.py --window-form FILE.cu ...

Run on a machine with an NVIDIA H100 (or another sm_90a card) and nvcc,
with the package to time on ``PYTHONPATH`` (the checkout's root by
default), so that two checkouts can be timed in turns within one call:

    PYTHONPATH=old python3 tools/time_schur.py --label parent
    PYTHONPATH=.   python3 tools/time_schur.py --label change

The inputs are ``chip_smoke.py``'s (``gaussian_input``,
``spectral_input``, ``jordan_input``, ``eig_input``: B = 32, n = 256),
built by its own functions, loaded from the ``chip_smoke.py`` beside
this script's ``tools/`` (so both versions get the same inputs).  Times
(CUDA events, ``utils.benchmarking.cuda_time``):

- one AED round (``ops.schur._aed`` from schur-gauss-256's initial
  state, w = 32, 8 shift pairs) captured in a CUDA graph and replayed,
  median of 10: the inner real Schur form of the windows, their
  deflation and write-back;
- one outer sweep as a CUDA-graph replay (``ops.schur._sweep_graph``),
  median of 10;
- the main chase (``kernels.schur_chase.francis_chase``, the version's
  own variant choice) on the arrays the first outer sweep gives it,
  without Q (schur-gauss-256) and with Q (spectral-eig-256), median of
  10;
- the Schur cells' calls, median of 3: ``eigvals_schur`` on
  schur-gauss-256, ``spectral_pipeline`` with ``method="schur"`` at
  ``max_distinct`` 3 and None on config 4, ``"auto"`` on config 5 and
  ``"eig"`` on spectral-eig-256.

Uses only functions both versions have.  Prints one JSON object with the
card's name and power limit, and writes it to ``--out`` when given.
``--dump`` saves every cell's output; ``--compare`` reports whether two
such dumps are equal to the bit (NaN where the other is NaN).
``--window-form`` alone builds each given source, a form of
``csrc/schur_window.cu`` with its C entry point ``schur_window`` (e.g.
``tools/schur_window_warp.cu``, the first form), holds it to the
bit (NaN-equal) against the package's kernel on the first AED round's
windows of schur-gauss-256 ([32, 33, 33], f32 and float64, as
``chip_smoke.hold_schur`` records them), and times the two in turns,
three rounds each way (package first in rounds 0 and 2).  Needs a card
(but ``--compare``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

if not os.environ.get("PYTHONPATH"):
    sys.path.insert(0, os.getcwd())


def _load(rel: str, name: str):
    """A file of this script's checkout, as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _first_chase(a, with_q):
    """The main chase's arguments of the first outer sweep from ``a``."""
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    n = a.shape[1]
    npairs = schur._auto_npairs(n)
    H, Q, hi, st, an, _ = schur._schur_init(a, with_q=with_q)
    state = (H, Q, hi, st, an, torch.zeros_like(hi, dtype=torch.bool),
             torch.zeros((), dtype=torch.long, device=a.device))
    calls = []
    orig = sc.francis_chase

    def rec(H, Q, tables, nc, *rest):
        calls.append((H.clone(), None if Q is None else Q.clone(),
                      [t.clone() for t in tables], nc))
        return orig(H, Q, tables, nc, *rest)

    sc.francis_chase = rec
    try:
        with schur.f32_matmuls():
            schur._schur_sweep(state, npairs, schur._auto_aed_w(n, npairs))
    finally:
        sc.francis_chase = orig
    return [c for c in calls if c[0].shape[1] == n + 1][0]


def _aed_graph(a):
    """One AED round from ``a``'s initial state, captured in a CUDA graph."""
    from linalg_solver_tpu_torch.ops import schur

    n = a.shape[1]
    npairs = schur._auto_npairs(n)
    w = schur._auto_aed_w(n, npairs)
    H, Q, hi, st, an, _ = schur._schur_init(a)
    args = (H, Q, hi, st, an, w, npairs, False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), schur.f32_matmuls():
        schur._aed(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), schur.f32_matmuls():
        schur._aed(*args)
    return graph


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
    ap.add_argument("--dump")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--window-form", nargs="+", default=[])
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        raise SystemExit("time_schur.py: needs a CUDA device")
    smoke = _load("chip_smoke.py", "_smoke_inputs")
    from linalg_solver_tpu_torch.models import spectral
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    a = smoke.gaussian_input(dev)
    a4 = smoke.spectral_input(dev)
    a5 = smoke.jordan_input(dev)
    ae, _ = smoke.eig_input(dev)
    tol = smoke.TOL_SPEC
    out = {"label": args.label, "card": card,
           "package": os.path.dirname(os.path.dirname(
               os.path.abspath(schur.__file__))), "ms": {}}
    ms = out["ms"]
    if args.window_form:
        for path in args.window_form:
            _window_form(path, smoke, a, ms)
        print(json.dumps(out))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return

    graph = _aed_graph(a)
    ms["AED round, CUDA graph"] = cuda_time(graph.replay, warmup=2,
                                            iters=10) * 1e3
    n = a.shape[1]
    npairs = schur._auto_npairs(n)
    H, Q, hi, st, an, _ = schur._schur_init(a)
    state = (H, Q, hi, st, an, torch.zeros_like(hi, dtype=torch.bool),
             torch.zeros((), dtype=torch.long, device=dev))
    sweep = schur._sweep_graph(state, npairs, schur._auto_aed_w(n, npairs))
    ms["outer sweep, CUDA graph"] = cuda_time(sweep.replay, warmup=2,
                                              iters=10) * 1e3
    for what, x, with_q in (("main chase [32, 257, 257]", a, False),
                            ("main chase with Q", ae, True)):
        c = _first_chase(x, with_q)
        ms[what] = cuda_time(sc.francis_chase, *c, warmup=2, iters=10) * 1e3

    dump = {}
    cells = {
        "schur-gauss-256": lambda: schur.eigvals_schur(a),
        "spectral-schur-256 max_distinct=3": lambda: spectral
        .spectral_pipeline(a4, tol=tol, method="schur", max_distinct=3),
        "spectral-schur-256 max_distinct=None": lambda: spectral
        .spectral_pipeline(a4, tol=tol, method="schur"),
        "spectral-auto-jordan-256": lambda: spectral.spectral_pipeline(
            a5, tol=tol, method="auto"),
        "spectral-eig-256": lambda: spectral.spectral_pipeline(
            ae, tol=tol, method="eig"),
    }
    for what, fn in cells.items():
        dump[what] = [t.cpu() for t in fn()]
        ms[what] = cuda_time(fn, warmup=0, iters=3) * 1e3
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if args.dump:
        torch.save(dump, args.dump)


def _window_form(path: str, smoke, a, ms) -> None:
    """``--window-form``: the form of the window kernel in ``path``, built,
    held to the bit against the package's kernel on the first AED round's
    windows, then timed in turns with it."""
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    lib = _load("tools/time_pivoted.py", "_time_pivoted")._form_library(
        path, ("schur_window",))
    name = os.path.basename(path)
    for x in (a, a.double()):
        _, _, args = smoke.hold_schur(x, False, f"for {name}")
        Hw, Qw, hw, an, beta, hi_w0, n = args
        B, npad, _ = Hw.shape

        def form():
            H, Q = Hw.clone(), Qw.clone()
            h, p = hw.clone(), hi_w0.clone()
            nd = torch.zeros_like(p)
            live = (hw >= 1).any()
            err = lib.schur_window(
                H.data_ptr(), Q.data_ptr(), h.data_ptr(), an.data_ptr(),
                beta.data_ptr(), p.data_ptr(), nd.data_ptr(),
                live.data_ptr(), B, npad - 1, n,
                int(Hw.dtype == torch.float64),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return H, Q, h, nd, p

        calls = {"package": lambda: sw.window_schur(*args), name: form}
        got = [calls[k]() for k in calls]
        if not all(_bitwise(u, v) for u, v in zip(*got)):
            raise AssertionError(f"{name} disagrees with the package's window "
                                 f"kernel on {list(Hw.shape)} {Hw.dtype}")
        key = f"window kernel {list(Hw.shape)} {Hw.dtype}"
        for r in range(3):
            order = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for k in order:
                ms[f"{key} {k}, round {r}"] = cuda_time(
                    calls[k], warmup=2, iters=10) * 1e3


def _bitwise(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.shape != y.shape:
        return False
    if x.is_floating_point():
        return bool(((x == y) | (x.isnan() & y.isnan())).all())
    return torch.equal(x, y)


def compare(a: str, b: str) -> None:
    """Print whether two dumps are equal to the bit (NaN-equal), cell by
    cell."""
    da, db = torch.load(a), torch.load(b)
    same = {cell: all(_bitwise(x, y) for x, y in zip(da[cell], db[cell]))
            for cell in da if cell in db}
    print(json.dumps({"compare": [a, b], "cells": len(same),
                      "bitwise_equal": all(same.values()),
                      "per_cell": same}))


if __name__ == "__main__":
    main()
