"""Time the port's two pivoted kernels, kernel 2 and the 256-wide
pivoted paths on a CUDA card, for comparing two versions of the package.

    python3 tools/time_pivoted.py [--label NAME] [--out FILE.json]
                                  [--dump FILE.pt]
    python3 tools/time_pivoted.py --compare A.pt B.pt

Run on a machine with an NVIDIA H100 (or another sm_90a card) and nvcc,
with the package to time on ``PYTHONPATH`` (the checkout's root by
default), so that two checkouts can be timed in turns within one call:

    PYTHONPATH=old python3 tools/time_pivoted.py --label parent
    PYTHONPATH=.   python3 tools/time_pivoted.py --label change

The inputs are ``chip_smoke.py``'s, built by its own functions, which
are loaded from the ``chip_smoke.py`` beside this script's ``tools/``
(so both versions get the same inputs).  Times (CUDA events, median of
20 after 3 warm-up calls, ``utils.benchmarking.cuda_time``):

- kernel 3 (``gauss_jordan_tiled``) on ``[A | I]`` of the bench class at
  B=1024, N=64, 127 and 167, and on ``det_batch`` at B=256, N=237,
  beside ``torch.linalg.inv`` / ``torch.linalg.det``;
- kernel 6 (``panel_factor_masked``) over the four panels that
  ``solve_batched(backend="mixed")`` gives it at B=N=256, made
  contiguous as ``chip_smoke.py`` times them;
- kernel 2 (``inverse_rbt_fused``) at B=1024, N=64;
- the call time of the three 256-wide pivoted paths:
  ``solve_batched(mixed)``, ``det_batched(auto)`` on ``det_batch`` and
  ``lu_factor_batched(auto)``.

Uses only the wrappers' public calls, so it times any version of the
package that has them.  Prints one JSON object with the card's name and
power limit, and writes it to ``--out`` when given.  ``--dump`` saves
every output of the timed kernel calls; ``--compare`` reports whether
two such dumps (two versions of the package, same inputs) are equal to
the bit, NaN where the other is NaN.  Needs a card (but ``--compare``).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

if not os.environ.get("PYTHONPATH"):
    sys.path.insert(0, os.getcwd())


def _chip_smoke():
    """``chip_smoke.py`` of this script's checkout, as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
    ap.add_argument("--dump")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        raise SystemExit("time_pivoted.py: no CUDA device")
    dev = torch.device("cuda")
    cs = _chip_smoke()

    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_panel
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    outputs = {}

    def t(fn, *a, kernel=True):
        if kernel:
            outputs[len(outputs)] = [x.cpu() for x in _tensors(fn(*a))]
        return cuda_time(fn, *a, warmup=3, iters=20) * 1e3

    res = {"label": args.label, "card": cs.card_line(),
           "package": os.path.dirname(os.path.dirname(gj.__file__)),
           "ms": {}}
    ms = res["ms"]
    for n in (64, 127, 167):
        a = cs.inverse_batch(cs.B_INV, n, 500 + n, dev)
        aug = torch.cat([a, torch.eye(n, device=dev).expand_as(a)], dim=2)
        ms[f"kernel 3 [{cs.B_INV}, {n}, {2 * n}]"] = t(gj.gauss_jordan_tiled,
                                                       aug)
        ms[f"torch.linalg.inv [{cs.B_INV}, {n}, {n}]"] = t(
            torch.linalg.inv, a, kernel=False)
    s = cs.det_batch(dev, 237)
    ms[f"kernel 3 [{cs.B}, 237, 237]"] = t(gj.gauss_jordan_tiled, s)
    ms[f"torch.linalg.det [{cs.B}, 237, 237]"] = t(torch.linalg.det, s,
                                                   kernel=False)

    a, b = cs.bench_batch(dev)
    calls, off = cs.record(lu_panel, "panel_factor_masked")
    dispatch.solve_batched(a, b, backend="mixed")
    off()
    # contiguous, as chip_smoke.py times them: the kernel without the
    # wrapper's copies of the path's strided views
    panels = [(p.contiguous(), m.contiguous(), nb) for (p, m, nb), _ in calls]

    def kernel6():
        return [lu_panel.panel_factor_masked(*args) for args in panels]

    ms[f"kernel 6, the mixed path's {len(panels)} panels"] = t(kernel6)

    ai = cs.inverse_batch(cs.B_INV, cs.N_INV, 0, dev)
    diags = (rbt.default_diags(cs.N_INV, rbt.MAIN_SEEDS, str(dev)),
             rbt.default_diags(cs.N_INV, rbt.RESCUE_SEEDS, str(dev)),
             rbt.default_probe(cs.N_INV, str(dev)))
    ms[f"kernel 2 [{cs.B_INV}, {cs.N_INV}, {cs.N_INV}]"] = t(
        inv_rbt.inverse_rbt_fused, ai, *diags)

    sd = cs.det_batch(dev)
    for name, fn, xs in (
            ("solve_batched(mixed)",
             lambda x, y: dispatch.solve_batched(x, y, "mixed"), (a, b)),
            ("det_batched(auto)", dispatch.det_batched, (sd,)),
            ("lu_factor_batched(auto)", dispatch.lu_factor_batched, (a,))):
        ms[f"path {name} B={cs.B} N={cs.N}"] = t(fn, *xs, kernel=False)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if args.dump:
        torch.save(outputs, args.dump)


def _tensors(out):
    """The tensors of a kernel call's result, flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for item in out for x in _tensors(item)]


def compare(a: str, b: str) -> None:
    """Print whether two dumps are equal to the bit (NaN-equal)."""
    da, db = torch.load(a), torch.load(b)
    same = {}
    for call in da:
        same[call] = all(
            x.shape == y.shape and bool(((x == y) | (x.isnan() & y.isnan()))
                                        .all()
                                        if x.is_floating_point()
                                        else torch.equal(x, y))
            for x, y in zip(da[call], db[call]))
    print(json.dumps({"compare": [a, b], "calls": len(same),
                      "bitwise_equal": all(same.values()),
                      "per_call": same}))


if __name__ == "__main__":
    main()
