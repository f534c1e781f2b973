"""Time the port's kernels 1-6 and the 256-wide paths on a CUDA card,
for comparing two versions of the package.

    python3 tools/time_pivoted.py [--label NAME] [--out FILE.json]
                                  [--dump FILE.pt]
                                  [--grid | --grid-inv | --big]
                                  [--trsyl-form FILE.cu ...]
    python3 tools/time_pivoted.py --sturm-form FILE.cu ...
    python3 tools/time_pivoted.py --complex-gauss-form FILE.cu ...
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
- kernel 2 (``inverse_rbt_fused``) at B=1024 on the bench class, N=64,
  128 and 164, and 172 and 180 where the package's ``inv_rbt.fits``
  takes them, as CUDA-event and as device time, beside
  ``torch.linalg.inv``; and ``inverse_batched(auto)`` at B=1024, N=64
  (metric 2);
- kernel 4 (``butterfly_two_sided``, depth 2, both sides transposed) at
  [256, 256, 256] (``phase_batch``'s A), as device time and CUDA-event
  time, each with L2 warm (back-to-back calls) and flushed (a 256 MB
  buffer written before each call; only the kernel's own device entries
  counted), ten runs of each, median and range;
- kernel 1 (``solve_fused_rbt``) on ``bench_batch`` (B=N=256, k=1, the
  main path's one launch) and on the same class at B=256, N=128, k=1;
- kernel 5 (``panel_factor_nopivot``) over the eight panels that
  ``solve_batched(auto)`` gives it at k=16 and the four that
  ``inverse_batched(auto)`` gives it at N=256 (``phase_batch``), both as
  CUDA-event time of the Python launches and as device time
  (``torch.profiler``, ``device_time`` of this checkout's
  ``utils/benchmarking.py``): the launches are short enough that the
  host's gaps fill the first;
- the call time of the 256-wide paths: ``solve_batched(mixed)``,
  ``det_batched(auto)`` on ``det_batch``, ``lu_factor_batched(auto)``,
  and solve-256, solve-256-k16 and inverse-256 (``auto``).

``--grid`` times only kernel 1, at B=256 on the bench class for
N = 64, 96, ..., 256 and k = 1, 2, 4, 8: the shapes that chose its
variants' routes (``solve_fused.variant``).  ``--grid-inv`` times only
kernel 2, device time at B=1024 on the bench class for N = 16, 20, ...,
180 in every variant that takes N (``inv_rbt.VARIANTS``, chosen with
``inverse_rbt_fused(..., v=)``): the shapes that chose its routes
(``inv_rbt.variant``).  ``--big`` times only kernel 3's big-reach
variant (3) at the shapes its paths give it, [1024, 256, 257] (the
spectral core at ``max_distinct=None``), [96, 256, 257] (the Jordan
``"gj"`` path), [256, 256, 257] (affine-256) on ``affine_batch``'s
``[A | b]`` and [256, 424, 424] (rank-424) on ``rank_batch``, and the
trsyl kernel forward and adjoint at [32, 256, 256] on a seeded upper
triangular complex T (diagonal spread over [-2, 2] + [-1, 1] i, the rest
Gaussian / 16) with m = 120 ... 135 by lane, each as CUDA-event and as
device time (the kernel's own entries).  ``--trsyl-form`` (with
``--big``) builds each given source, a form of ``csrc/trsyl.cu`` with
its C entry point ``trsyl_masked``, with the package's ``nvcc`` flags
into the package's build directory, checks that it agrees with the
package's kernel to the bit on those operands, and times it in turns
with the package's kernel, three rounds each way.  ``--sturm-form``
alone builds each given source, a form of ``csrc/sturm.cu`` with its C
entry points ``sturm_bisect`` and ``sturm_count`` (e.g.
``tools/sturm_step.cu``, the one-launch-a-step form), holds its
bisection to the bit against the package's at ``chip_smoke.py``'s
phase-55 shapes ([256, 4096], [16, 4096], [32, 512], their live steps
too) and its count at the [16, 4096] midpoints, 4096 a lane, and times
each in turns with the package's kernel, three rounds each way (package
first in rounds 0 and 2); then the package's bisection as device time
of its count and of its plan kernels.  ``--complex-gauss-form`` alone
builds each given source, a form of ``csrc/complex_gauss.cu`` with its C
entry points ``complex_gauss`` and ``complex_gauss_variant`` (e.g.
``tools/complex_gauss_simple.cu``, the first form), holds it to the bit
(NaN-equal, flags included) against the package's kernel on phase 59's
determinant inputs ([256, n, n] at n = 128 and 192, a singular, a NaN
and an Inf lane) in f32 and at n = 128 in float64, and times the two in
turns, three rounds each way (package first in rounds 0 and 2), beside
``torch.linalg.det`` on the same lanes in complex64 (complex128 for
float64) in every round.

Uses only the wrappers' public calls, so it times any version of the
package that has them.  Prints one JSON object with the card's name and
power limit, and writes it to ``--out`` when given.  ``--dump`` saves
every output of the timed kernel calls; ``--compare`` reports whether
two such dumps (two versions of the package, same inputs) are equal to
the bit, NaN where the other is NaN, on the calls both made, and for
kernel 1 (whose variants round differently) the flags' equality and
the solutions' largest relative difference.  Needs a card (but ``--compare``).  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
    ap.add_argument("--dump")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--grid-inv", action="store_true")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--trsyl-form", nargs="+", default=[])
    ap.add_argument("--sturm-form", nargs="+", default=[])
    ap.add_argument("--complex-gauss-form", nargs="+", default=[])
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        raise SystemExit("time_pivoted.py: no CUDA device")
    dev = torch.device("cuda")
    cs = _load("chip_smoke.py", "chip_smoke")
    device_time = _load("linalg_solver_tpu_torch/utils/benchmarking.py",
                        "benchmarking").device_time

    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import butterfly, inv_rbt
    from linalg_solver_tpu_torch.ops.kernels import lu_nopivot, lu_panel
    from linalg_solver_tpu_torch.ops.kernels import solve_fused
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    outputs = {}

    def t(name, fn, *a, kernel=True):
        if kernel:
            outputs[name] = [x.cpu() for x in _tensors(fn(*a))]
        ms[name] = cuda_time(fn, *a, warmup=3, iters=20) * 1e3

    res = {"label": args.label, "card": cs.card_line(),
           "package": os.path.dirname(os.path.dirname(gj.__file__)),
           "ms": {}}
    ms = res["ms"]
    if args.grid:
        for n in range(64, 257, 32):
            a = cs.inverse_batch(cs.B, n, 600 + n, dev)
            d = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
            for k in (1, 2, 4, 8):
                b = torch.randn(cs.B, n, k, generator=torch.Generator(
                    device=dev).manual_seed(n + k), device=dev)
                t(f"kernel 1 [{cs.B}, {n}, k={k}]",
                  solve_fused.solve_fused_rbt, a, b, *d, kernel=False)
        _emit(res, args.out)
        return
    if args.grid_inv:
        for n in range(16, 181, 4):
            a = cs.inverse_batch(cs.B_INV, n, 800 + n, dev)
            d = (rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev)),
                 rbt.default_diags(n, rbt.RESCUE_SEEDS, str(dev)),
                 rbt.default_probe(n, str(dev)))
            for v in inv_rbt.VARIANTS:
                if inv_rbt.takes(v, n):
                    ms[f"kernel 2 [{cs.B_INV}, {n}, {n}] variant {v}, "
                       f"device"] = device_time(
                        lambda *x, v=v: inv_rbt.inverse_rbt_fused(*x, v=v),
                        a, *d) * 1e3
        _emit(res, args.out)
        return
    if args.sturm_form:
        for path in args.sturm_form:
            _sturm_form(path, cs, dev, ms, device_time)
        _emit(res, args.out)
        return
    if args.complex_gauss_form:
        for path in args.complex_gauss_form:
            _complex_gauss_form(path, cs, dev, ms)
        _emit(res, args.out)
        return
    if args.big:
        _big(cs, dev, t, ms, device_time)
        for path in args.trsyl_form:
            _trsyl_form(path, dev, ms)
        _emit(res, args.out)
        if args.dump:
            torch.save(outputs, args.dump)
        return
    for n in (64, 127, 167):
        a = cs.inverse_batch(cs.B_INV, n, 500 + n, dev)
        aug = torch.cat([a, torch.eye(n, device=dev).expand_as(a)], dim=2)
        t(f"kernel 3 [{cs.B_INV}, {n}, {2 * n}]", gj.gauss_jordan_tiled, aug)
        t(f"torch.linalg.inv [{cs.B_INV}, {n}, {n}]", torch.linalg.inv, a,
          kernel=False)
    s = cs.det_batch(dev, 237)
    t(f"kernel 3 [{cs.B}, 237, 237]", gj.gauss_jordan_tiled, s)
    t(f"torch.linalg.det [{cs.B}, 237, 237]", torch.linalg.det, s,
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

    t(f"kernel 6, the mixed path's {len(panels)} panels", kernel6)

    # kernel 2 at metric 2's shape and past it, as far as `fits` goes
    for n in (64, 128, 164, 172, 180):
        if not inv_rbt.fits(n):
            continue
        ai = cs.inverse_batch(cs.B_INV, n, 0, dev)
        diags = (rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev)),
                 rbt.default_diags(n, rbt.RESCUE_SEEDS, str(dev)),
                 rbt.default_probe(n, str(dev)))
        name = f"kernel 2 [{cs.B_INV}, {n}, {n}]"
        t(name, inv_rbt.inverse_rbt_fused, ai, *diags)
        ms[name + ", device"] = device_time(
            inv_rbt.inverse_rbt_fused, ai, *diags) * 1e3
        t(f"torch.linalg.inv [{cs.B_INV}, {n}, {n}]", torch.linalg.inv, ai,
          kernel=False)
        if n == cs.N_INV:
            t(f"path inverse_batched(auto) B={cs.B_INV} N={n}",
              dispatch.inverse_batched, ai, kernel=False)

    # kernel 4 at [256, 256, 256], L2 warm and flushed
    ap4, _ = cs.phase_batch(dev)
    U, V = rbt.default_diags(cs.N, rbt.MAIN_SEEDS, str(dev))
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB, past the L2

    def kernel4():
        return butterfly.butterfly_two_sided(ap4, U, V, 2)

    def kernel4_cold():
        flush.fill_(1.0)
        return kernel4()

    outputs["kernel 4 [256, 256, 256]"] = [kernel4().cpu()]
    runs = {"device, L2 warm": [], "device, L2 flushed": [],
            "CUDA events, L2 warm": [], "CUDA events, L2 flushed": []}
    for _ in range(10):
        runs["device, L2 warm"].append(device_time(kernel4) * 1e3)
        runs["device, L2 flushed"].append(device_time(
            kernel4_cold, match="bf2_kernel") * 1e3)
        runs["CUDA events, L2 warm"].append(
            cuda_time(kernel4, warmup=3, iters=20) * 1e3)
        runs["CUDA events, L2 flushed"].append(_cold_events(
            kernel4, flush) * 1e3)
    for what, xs in runs.items():
        res.setdefault("kernel 4 [256, 256, 256]", {})[what] = {
            "median": statistics.median(xs), "min": min(xs), "max": max(xs)}

    # kernel 1: the main path's launch, and one block a system at N = 128
    du, dv = rbt.default_diags(cs.N, rbt.MAIN_SEEDS, str(dev))
    t(f"kernel 1 [{cs.B}, {cs.N}, k=1]", solve_fused.solve_fused_rbt, a, b,
      du, dv)
    a128 = cs.inverse_batch(cs.B, 128, 128, dev)
    b128 = torch.randn(cs.B, 128, generator=torch.Generator(
        device=dev).manual_seed(129), device=dev)
    t(f"kernel 1 [{cs.B}, 128, k=1]", solve_fused.solve_fused_rbt, a128,
      b128, *rbt.default_diags(128, rbt.MAIN_SEEDS, str(dev)))

    # kernel 5 on the panels the phase paths give it
    ap, bp = cs.phase_batch(dev)
    for what, fn, xs in (
            ("solve-256-k16", dispatch.solve_batched, (ap, bp)),
            ("inverse-256", dispatch.inverse_batched, (ap,))):
        calls, off = cs.record(lu_nopivot, "panel_factor_nopivot")
        fn(*xs)
        off()
        k5 = [(p.contiguous(), nb) for (p, nb), _ in calls]

        def kernel5(k5=k5):
            return [lu_nopivot.panel_factor_nopivot(p, nb) for p, nb in k5]

        name = f"kernel 5, {what}'s {len(k5)} panels"
        t(name, kernel5)
        ms[name + ", device"] = device_time(kernel5) * 1e3

    sd = cs.det_batch(dev)
    for name, fn, xs in (
            ("solve_batched(mixed)",
             lambda x, y: dispatch.solve_batched(x, y, "mixed"), (a, b)),
            ("det_batched(auto)", dispatch.det_batched, (sd,)),
            ("lu_factor_batched(auto)", dispatch.lu_factor_batched, (a,)),
            ("solve-256 solve_batched(auto)", dispatch.solve_batched, (a, b)),
            ("solve-256-k16 solve_batched(auto)", dispatch.solve_batched,
             (ap, bp)),
            ("inverse-256 inverse_batched(auto)", dispatch.inverse_batched,
             (ap,))):
        t(f"path {name} B={cs.B} N={cs.N}", fn, *xs, kernel=False)
    _emit(res, args.out)
    if args.dump:
        torch.save(outputs, args.dump)


def trsyl_input(dev, bsz=32, n=256, seed=15):
    """``--big``'s trsyl operands: T upper triangular (re, im) with its
    diagonal spread over [-2, 2] + [-1, 1] i and Gaussian / 16 above it,
    C Gaussian, m = 120 + lane mod 16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t_re = torch.randn(bsz, n, n, generator=g, device=dev).triu(1) / 16
    t_im = torch.randn(bsz, n, n, generator=g, device=dev).triu(1) / 16
    t_re.diagonal(dim1=1, dim2=2).copy_(
        4 * torch.rand(bsz, n, generator=g, device=dev) - 2)
    t_im.diagonal(dim1=1, dim2=2).copy_(
        2 * torch.rand(bsz, n, generator=g, device=dev) - 1)
    c_re = torch.randn(bsz, n, n, generator=g, device=dev)
    c_im = torch.randn(bsz, n, n, generator=g, device=dev)
    m = 120 + torch.arange(bsz, device=dev, dtype=torch.int32) % 16
    return t_re, t_im, m, c_re, c_im


def _big(cs, dev, t, ms, device_time) -> None:
    """``--big``: kernel 3's variant 3 at its four path shapes and the
    trsyl kernel at [32, 256, 256], CUDA events and device time."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    for bsz, seed in ((1024, 51), (96, 52), (cs.B, 31)):
        a, b, _ = cs.affine_batch(bsz, cs.N, seed, dev)
        arr = torch.cat([a, b[:, :, None]], dim=2)
        name = f"kernel 3 [{bsz}, {cs.N}, {cs.N + 1}]"
        t(name, gj.gauss_jordan_tiled, arr)
        ms[name + ", device"] = device_time(gj.gauss_jordan_tiled, arr,
                                            match="gj_") * 1e3
    r, _ = cs.rank_batch(cs.B, cs.N_RANK_BIG, 41, dev)
    name = f"kernel 3 [{cs.B}, {cs.N_RANK_BIG}, {cs.N_RANK_BIG}]"
    t(name, gj.gauss_jordan_tiled, r)
    ms[name + ", device"] = device_time(gj.gauss_jordan_tiled, r,
                                        match="gj_") * 1e3
    ops = trsyl_input(dev)
    for adjoint in (False, True):
        def fn(*x, adjoint=adjoint):
            return trsyl.trsyl_masked(*x, adjoint=adjoint)

        name = f"trsyl [32, 256, 256] adjoint={adjoint}"
        t(name, fn, *ops)
        ms[name + ", device"] = device_time(fn, *ops,
                                            match="trsyl_kernel") * 1e3


def _trsyl_form(path: str, dev, ms) -> None:
    """``--trsyl-form``: the form of the trsyl kernel in ``path``, built
    and held against the package's kernel, then timed in turns with it."""
    from linalg_solver_tpu_torch.ops.kernels import trsyl
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    lib = _form_library(path, ("trsyl_masked",))
    t_re, t_im, m, c_re, c_im = trsyl_input(dev)
    name = os.path.basename(path)
    mm = m.to(torch.int32).contiguous()
    for adjoint in (False, True):
        def form():
            m_re, m_im, smin = trsyl._operands(t_re, t_im, adjoint)
            x_re, x_im = torch.zeros_like(m_re), torch.zeros_like(m_im)
            pert = torch.zeros(m.shape[0], dtype=torch.bool, device=dev)
            err = lib.trsyl_masked(
                m_re.data_ptr(), m_im.data_ptr(), mm.data_ptr(),
                c_re.data_ptr(), c_im.data_ptr(), smin.data_ptr(),
                x_re.data_ptr(), x_im.data_ptr(), pert.data_ptr(),
                m.shape[0], m_re.shape[1], int(adjoint), 0,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return x_re, x_im, pert

        def package():
            return trsyl.trsyl_masked(t_re, t_im, m, c_re, c_im,
                                      adjoint=adjoint)

        if not all(_bitwise(a, b) for a, b in zip(form(), package())):
            raise AssertionError(f"{name} adjoint={adjoint} disagrees with "
                                 f"the package's trsyl kernel")
        key = f"trsyl [32, 256, 256] adjoint={adjoint}"
        for r in range(3):
            ms[f"{key}, package, round {r}"] = cuda_time(
                package, warmup=2, iters=10) * 1e3
            ms[f"{key}, {name}, round {r}"] = cuda_time(
                form, warmup=2, iters=10) * 1e3


def _form_library(path: str, names):
    """The source at ``path`` built with the package's ``nvcc`` flags into
    the package's build directory, loaded, its entry points ``names``
    given the package's C signatures."""
    import ctypes
    import hashlib
    import subprocess

    from linalg_solver_tpu_torch.ops.kernels import _build

    src = os.path.abspath(path)
    h = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    lib_path = _build.BUILD_DIR / f"form_{stem}_{h}.so"
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        f"-I{_build.CSRC}", "-o", str(lib_path), src],
                       check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in names:
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = \
            _build._SIGNATURES[fn]
    return lib


def _sturm_form(path: str, cs, dev, ms, device_time) -> None:
    """``--sturm-form``: the form of the Sturm kernels in ``path``, built,
    held to the bit against the package's at phase 55's shapes, then
    timed in turns with it; the package's bisection also as device time
    by kernel (its count and plan kernels)."""
    from linalg_solver_tpu_torch.ops import sturm
    from linalg_solver_tpu_torch.ops.kernels import sturm as ks
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    lib = _form_library(path, ("sturm_bisect", "sturm_count"))
    name = os.path.basename(path)
    shapes = [(cs.STURM_B, cs.STURM_N, 0)] + [
        (bsz, n, bsz + n) for bsz, n in cs.STURM_CHECKS]
    for bsz, n, seed in shapes:
        d, e = (torch.from_numpy(x).to(dev)
                for x in cs.tridiagonal_input(bsz, n, seed=seed))
        ops = sturm.bisect_operands(d, e)
        calls = {"package": lambda: ks._launch_bisect(*ops)[:3],
                 name: lambda: ks._launch_bisect(*ops, lib=lib)[:3]}
        if (bsz, n) == cs.STURM_CHECKS[0]:
            a, b, _ = calls["package"]()
            m = 0.5 * (a + b)
            calls = {**calls, **{
                f"count {k}": (lambda lib_=lib_: ks._launch_count(
                    *ops[:3], m, lib=lib_))
                for k, lib_ in (("package", None), (name, lib))}}
        outs = {k: fn() for k, fn in calls.items()}
        for k in (name, f"count {name}"):
            if k in outs:
                ref = outs[k.replace(name, "package")]
                if not all(_bitwise(x, y) for x, y in zip(
                        _tensors(outs[k]), _tensors(ref))):
                    raise AssertionError(f"{k} disagrees with the package's "
                                         f"kernel at [{bsz}, {n}]")
        ms[f"sturm [{bsz}, {n}] {name}: bitwise, live steps"] = int(
            outs[name][2])
        for r in range(3):
            order = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for k in order:
                ms[f"sturm [{bsz}, {n}] {k}, round {r}"] = cuda_time(
                    calls[k], warmup=1, iters=3 if bsz > 32 else 10) * 1e3
        for kernel in ("step_count_kernel", "plan_kernel"):
            ms[f"sturm [{bsz}, {n}] package, device, {kernel}"] = device_time(
                calls["package"], warmup=1, iters=3, match=kernel) * 1e3


def _complex_gauss_form(path: str, cs, dev, ms) -> None:
    """``--complex-gauss-form``: the form of the complex elimination kernel
    in ``path``, built, held to the bit against the package's kernel, then
    timed in turns with it beside ``torch.linalg.det``."""
    from linalg_solver_tpu_torch.ops.kernels import complex_gauss as cg
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    lib = _form_library(path, ("complex_gauss", "complex_gauss_variant"))
    name = os.path.basename(path)
    for n, dtype in ((128, torch.float32), (192, torch.float32),
                     (128, torch.float64)):
        re, im = (x.to(dtype) for x in cs.complex_batch(cs.CX_DET_B, n,
                                                         63 + n, dev))
        re[1, :, 0] = im[1, :, 0] = 0.0
        re[2, n // 2, 1] = float("nan")
        im[3, 0, n - 1] = float("inf")
        f64 = int(dtype == torch.float64)
        B = re.shape[0]
        work = None
        if lib.complex_gauss_variant(n, f64) == 1:
            work = torch.empty(B * 2 * n * (n | 1), dtype=dtype, device=dev)

        def form(re=re, im=im, work=work, f64=f64):
            pr = torch.empty(B, n, dtype=dtype, device=dev)
            pi = torch.empty_like(pr)
            sg = torch.empty(B, dtype=dtype, device=dev)
            ok = torch.empty(B, dtype=torch.bool, device=dev)
            err = lib.complex_gauss(
                re.data_ptr(), im.data_ptr(),
                None if work is None else work.data_ptr(), pr.data_ptr(),
                pi.data_ptr(), sg.data_ptr(), ok.data_ptr(), B, n, f64,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return pr, pi, sg, ok

        calls = {"package": lambda re=re, im=im: cg.gauss_pivots_complex(
                     re, im), name: form}
        ref = cg.gauss_pivots_complex_reference(re, im)
        for k, fn in calls.items():
            if not all(_bitwise(x, y) for x, y in zip(fn(), ref)):
                raise AssertionError(f"{k} disagrees with the plain version "
                                     f"at [{B}, {n}, {n}] {dtype}")
        a = torch.complex(re, im)
        key = f"complex elimination [{B}, {n}, {n}] {dtype}"
        ms[f"{key}: variants (package, {name})"] = [
            cg.variant(n, dtype), lib.complex_gauss_variant(n, f64)]
        for r in range(3):
            order = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for k in order:
                ms[f"{key} {k}, round {r}"] = cuda_time(
                    calls[k], warmup=2, iters=10) * 1e3
            ms[f"{key} torch.linalg.det, round {r}"] = cuda_time(
                torch.linalg.det, a, warmup=2, iters=10) * 1e3


def _cold_events(fn, flush, iters: int = 20) -> float:
    """Median seconds of ``fn()`` under CUDA events, with ``flush``
    written before each call (outside the events)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3


def _emit(res: dict, out) -> None:
    """Print the result line, and write it to ``out`` when given."""
    line = json.dumps(res)
    print(line)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


def _tensors(out):
    """The tensors of a kernel call's result, flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for item in out for x in _tensors(item)]


def _bitwise(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.shape != y.shape:
        return False
    if x.is_floating_point():
        return bool(((x == y) | (x.isnan() & y.isnan())).all())
    return torch.equal(x, y)


def compare(a: str, b: str) -> None:
    """Print whether two dumps are equal to the bit (NaN-equal), and for
    kernel 1 whether the flags are equal and the solutions' largest
    relative difference over the finite entries."""
    da, db = torch.load(a), torch.load(b)
    same, kernel1 = {}, {}
    for call in da:
        if call not in db:
            continue
        if call.startswith("kernel 1"):
            (x, bad), (y, bad_y) = da[call], db[call]
            both = torch.isfinite(x) & torch.isfinite(y)
            rel = float((x - y)[both].abs().max() / y[both].abs().max())
            kernel1[call] = {"flags_equal": torch.equal(bad, bad_y),
                             "max_rel_diff": rel}
        else:
            same[call] = all(_bitwise(x, y)
                             for x, y in zip(da[call], db[call]))
    print(json.dumps({"compare": [a, b], "calls": len(same),
                      "bitwise_equal": all(same.values()),
                      "per_call": same, "kernel 1": kernel1}))


if __name__ == "__main__":
    main()
