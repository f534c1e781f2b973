"""Drive the PyTorch port's batched solve once on a CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and nvcc.  Phases, in order; any failure is an
uncaught exception and a non-zero exit:

1. require CUDA; print the card's name and power limit;
2. build the CUDA kernels from ``linalg_solver_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card, on
   batches with probe systems that a kernel without the butterfly or
   without refinement gets wrong, and show that the check fails for the
   kernel run without refinement;
4. drive the main path, ``ops.dispatch.solve_batched(backend="auto")``,
   at the bench shape (B=256 systems of 256x256 f32, vector RHS), check
   that it launched the kernel and that the result solves the systems,
   then the rescue cases;
5. time the kernel, its plain version, ``solve_batched(auto)`` and
   ``torch.linalg.solve`` with CUDA events.

The line before the last is a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

B, N = 256, 256
TOL_KERNEL = 1e-5      # max relative difference, kernel vs plain version
TOL_RESID = 1e-5       # worst-system relative residual, float64
FLAGGED = [2, 5]       # probe systems the kernel must flag (probe_batch)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_batch(dev):
    """Gaussian plus 4*sqrt(N)*I, as bench.py builds it, on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(B, N, N, generator=g, device=dev)
    a += 4.0 * N**0.5 * torch.eye(N, device=dev)
    return a, torch.randn(B, N, generator=g, device=dev)


def probe_batch(bsz, n, k, du, dv, dev):
    """Gaussian plus 4*sqrt(n)*I with four probe systems: 2 all zero and
    5 with a NaN (both flagged), 6 with a zero leading minor (flagged
    only without the butterfly) and 7 with a 1e-3 first pivot after the
    butterfly (off by ~1e-3 without refinement)."""
    from linalg_solver_tpu_torch.utils import systems

    g = torch.Generator(device=dev).manual_seed(100 + k + n)
    a = torch.randn(bsz, n, n, generator=g, device=dev)
    a += 4.0 * n**0.5 * torch.eye(n, device=dev)
    b = torch.randn(bsz, n, k, generator=g, device=dev)
    a[2] = 0.0
    a[5, 3, 7] = float("nan")
    a[6] = systems.zero_minor_system(a[6])
    a[7] = systems.pivot_system(a[7], du, dv, 1e-3)
    return a, b


def worst_resid(a, b, x):
    """Max over systems of max|A x - b| / max|b|, in float64."""
    b3 = b.reshape(b.shape[0], b.shape[1], -1).double()
    r = a.double() @ x.reshape(b3.shape).double() - b3
    return r.abs().amax(dim=(1, 2)) / b3.abs().amax(dim=(1, 2))


def compare(x, bad, x_ref, bad_ref):
    """(max relative difference of x over the unflagged systems, the
    system where it is largest, max absolute difference there, what else
    differs or None): the flags and the non-finite pattern must agree
    exactly; a flagged system's x carries no promise."""
    if not torch.equal(bad, bad_ref):
        return 0.0, -1, 0.0, f"flags {bad.tolist()} vs {bad_ref.tolist()}"
    fin, fin_ref = torch.isfinite(x), torch.isfinite(x_ref)
    if not torch.equal(fin, fin_ref):
        return 0.0, -1, 0.0, "non-finite entries differ"
    x3 = x.reshape(x.shape[0], -1)
    r3 = x_ref.reshape(x.shape[0], -1)
    use = fin.reshape(x.shape[0], -1) & ~bad[:, None]
    zero = torch.zeros((), device=x.device)
    diff = torch.where(use, (x3 - r3).abs(), zero).amax(dim=1)
    scale = torch.where(use, r3.abs(), zero).amax(dim=1)
    rel = diff / scale.clamp_min(1e-30)
    worst = int(rel.argmax())
    return float(rel[worst]), worst, float(diff.max()), None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; there is no CPU path")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}")
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import _build
    from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
    from linalg_solver_tpu_torch.utils import systems
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. kernel against its plain version, same diagonals
    for bsz, n, k in ((8, 64, 1), (8, 64, 8), (B, N, 1)):
        du, dv = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
        a, b = probe_batch(bsz, n, k, du, dv, dev)
        x, bad = sf.solve_fused_rbt(a, b, du, dv)
        torch.cuda.synchronize()
        x_ref, bad_ref = sf.solve_fused_rbt_reference(a, b, du, dv)
        rel, worst, abs_err, why = compare(x, bad, x_ref, bad_ref)
        flagged = bad.nonzero().flatten().tolist()
        print(f"kernel vs plain B={bsz} N={n} k={k}: max rel diff {rel:.3e} "
              f"in system {worst} (tol {TOL_KERNEL}), flagged {flagged}")
        if why is not None or not rel <= TOL_KERNEL:
            raise AssertionError(f"kernel disagrees with plain version: "
                                 f"{why or rel}")
        if flagged != FLAGGED:
            raise AssertionError(f"flagged {flagged}, expected {FLAGGED}")
        if (bsz, n, k) == (8, 64, 1):
            control = (a, b, du, dv, x_ref, bad_ref)
        if bsz == B:
            bench_abs_err = abs_err

    # the same check must fail for a kernel without refinement: the
    # small-pivot system 7 is off by ~1e-3 before it
    a, b, du, dv, x_ref, bad_ref = control
    x0, bad0 = sf.solve_fused_rbt(a, b, du, dv, ir_steps=0)
    rel0, worst0, _, why0 = compare(x0, bad0, x_ref, bad_ref)
    print(f"control, kernel ir_steps=0 vs plain ir_steps=2 B=8 N=64 k=1: "
          f"max rel diff {rel0:.3e} in system {worst0} (must exceed "
          f"{TOL_KERNEL}), {why0 or 'flags equal'}")
    if why0 is None and not rel0 > TOL_KERNEL:
        raise AssertionError("the kernel check cannot see a kernel "
                             "without refinement")

    # 4. the main path
    a, b = bench_batch(dev)
    sf.LAUNCHES = 0
    x = dispatch.solve_batched(a, b, backend="auto")
    torch.cuda.synchronize()
    launches = sf.LAUNCHES
    resid = float(worst_resid(a, b, x).max())
    print(f"main path solve_batched(auto) B={B} N={N}: launches {launches}, "
          f"worst residual {resid:.3e} (tol {TOL_RESID}), x {tuple(x.shape)}")
    if launches < 1:
        raise AssertionError("the main path did not launch the kernel")
    if launches != 1:
        raise AssertionError("a clean batch was flagged (rescue launched)")
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        raise AssertionError("main path output has the wrong shape or non-finite values")
    if not resid <= TOL_RESID:
        raise AssertionError(f"main path residual {resid}")

    a2 = a.clone()
    a2[5, :16, :16] = 0.0     # full rank, zero leading minor: solved
    a2[9] = 0.0               # exactly singular: non-finite
    # a zero pivot under the main draw: flagged, solved by the redraw
    a2[12] = systems.pivot_system(
        a[12], *rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev)), 0.0)
    sf.LAUNCHES = 0
    x2 = dispatch.solve_batched(a2, b, backend="auto")
    torch.cuda.synchronize()
    r2 = worst_resid(a2, b, x2)
    others = [i for i in range(B) if i not in (5, 9, 12)]
    same = all(torch.equal(x2[i], x[i]) for i in others)
    print(f"rescue: launches {sf.LAUNCHES}, zero-minor system residual "
          f"{float(r2[5]):.3e}, redraw system residual {float(r2[12]):.3e}, "
          f"singular system finite={bool(torch.isfinite(x2[9]).all())}, "
          f"other systems bitwise unchanged={same}")
    if sf.LAUNCHES != 2:
        raise AssertionError("rescue did not rerun the kernel exactly once")
    if not float(r2[[5, 12]].max()) <= TOL_RESID:
        raise AssertionError("rescue left a solvable system unsolved")
    if bool(torch.isfinite(x2[9]).all()):
        raise AssertionError("singular system came back finite")
    if not same:
        raise AssertionError("the rescue changed a system it was not given")

    # 5. times at B = N = 256
    flops = B * (2.0 / 3.0 * N**3 + 2.0 * N**2)
    du, dv = rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev))
    times = {
        "kernel solve_fused_rbt": cuda_time(
            sf.solve_fused_rbt, a, b, du, dv, warmup=3, iters=20),
        "plain solve_fused_rbt_reference": cuda_time(
            sf.solve_fused_rbt_reference, a, b, du, dv, warmup=1, iters=3),
        "solve_batched(auto)": cuda_time(
            dispatch.solve_batched, a, b, warmup=3, iters=20),
        "torch.linalg.solve": cuda_time(
            lambda a_, b_: torch.linalg.solve(a_, b_.unsqueeze(-1)),
            a, b, warmup=3, iters=20),
    }
    for what, t in times.items():
        print(f"time {what}: {t * 1e3:.4f} ms, {flops / t / 1e9:.2f} GFLOP/s "
              f"(B={B} N={N}, {card})")

    print(json.dumps({"kernels": [{
        "name": "solve_fused_rbt",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/solve_fused.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/solve_fused_kernel.py:180",
        "launches": launches,
        "max_abs_err": bench_abs_err,
        "ms": times["kernel solve_fused_rbt"] * 1e3,
        "plain_ms": times["plain solve_fused_rbt_reference"] * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
