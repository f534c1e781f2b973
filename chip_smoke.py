"""Drive the PyTorch port's batched solve and batched inverse once on a
CUDA card, through the fused kernels and through the RBT phase engine.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and nvcc.  Phases, in order; any failure is an
uncaught exception and a non-zero exit:

1. require CUDA; print the card's name and power limit;
2. build the CUDA kernels from ``linalg_solver_tpu_torch/csrc``;
3. hold the solve kernel against its plain PyTorch version on the card,
   on batches with probe systems that a kernel without the butterfly or
   without refinement gets wrong, and show that the check fails for the
   kernel run without refinement;
4. drive the solve path, ``ops.dispatch.solve_batched(backend="auto")``,
   at the bench shape (B=256 systems of 256x256 f32, vector RHS), check
   that it launched the kernel and that the result solves the systems,
   then the rescue cases;
5. time the kernel, its plain version, ``solve_batched(auto)`` and
   ``torch.linalg.solve`` with CUDA events;
6. hold the fused inverse kernel and the pivoted Gauss-Jordan kernel
   against their plain versions on probe batches (one matrix on every
   rung of the inverse's rescue ladder) and at the bench shape, and
   show that the check fails for the inverse kernel without its rescue;
7. drive the inverse path, ``ops.dispatch.inverse_batched(backend=
   "auto")``, at the bench shape (1024 matrices of 64x64 f32): one
   launch of the fused kernel, then the rescue cases;
8. drive the pivoted kernel's path: the inverse at N=63 (not a multiple
   of 4), ``det_batched`` and ``rank_batched``, then hold the kernel
   against its plain version on the arrays that path gave it;
9. time both inverse kernels, their plain versions,
   ``inverse_batched(auto)`` and ``torch.linalg.inv``;
10. hold the phase engine's two-sided butterfly kernel against its plain
    version, bitwise (depth 1 and 2, both directions, N = 64, 256, 896),
    and show that the check fails for the kernel with its sides flipped;
    hold its no-pivot panel kernel against its plain version on probe
    panels (a zero pivot, a NaN, an Inf) with the flags equal;
11. hold the phase solve on the card against the same engine on the CPU
    (the plain versions) and show that the check fails for the card's
    solve without refinement;
12. drive the phase engine's paths: ``solve_batched(auto)`` at B=256,
    N=256 with k=16 RHS columns (one butterfly launch, eight panel
    launches, no fused one), ``inverse_batched(auto)`` at B=256, N=256
    (two butterfly launches, four panel launches) and the solve at N=896,
    k=1, past the fused kernel; hold both kernels against their plain
    versions on the arrays the first two paths gave them; then the rescue
    cases of both paths;
13. time both kernels, their plain versions, the two paths and
    ``torch.linalg.solve`` / ``torch.linalg.inv``.

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
B_INV, N_INV = 1024, 64
TOL_INV = 5e-5         # worst-matrix max|A X - I|, float64
K_PHASE = 16           # RHS columns of the phase engine's solve path
N_REACH = 896          # past the fused kernel's reach at k=1


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
    only without the butterfly) and 7 with a SMALL_PIVOT first pivot
    after the butterfly (off by >= 2e-3 without refinement)."""
    from linalg_solver_tpu_torch.utils import systems

    g = torch.Generator(device=dev).manual_seed(100 + k + n)
    a = torch.randn(bsz, n, n, generator=g, device=dev)
    a += 4.0 * n**0.5 * torch.eye(n, device=dev)
    b = torch.randn(bsz, n, k, generator=g, device=dev)
    a[2] = 0.0
    a[5, 3, 7] = float("nan")
    a[6] = systems.zero_minor_system(a[6])
    a[7] = systems.pivot_system(a[7], du, dv, systems.SMALL_PIVOT)
    return a, b


def inverse_batch(bsz, n, seed, dev):
    """Gaussian plus 4*sqrt(n)*I from a seeded generator on the card, as
    bench.py builds the inverse's batch."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(bsz, n, n, generator=g, device=dev)
    return a + 4.0 * n**0.5 * torch.eye(n, device=dev)


def inverse_resid(a, x):
    """max|A X - I| per matrix, in float64."""
    eye = torch.eye(a.shape[-1], device=a.device, dtype=torch.float64)
    return (a.double() @ x.double() - eye).abs().amax(dim=(1, 2))


def compare_inverse(x, bad, x_ref, bad_ref, level3):
    """(max relative difference over the unflagged matrices and the
    level-3 ones, max absolute difference there, what else differs or
    None): flags and non-finite pattern must agree exactly."""
    if not torch.equal(bad, bad_ref):
        return 0.0, 0.0, f"flags {bad.nonzero().flatten().tolist()} vs " \
            f"{bad_ref.nonzero().flatten().tolist()}"
    if not torch.equal(torch.isfinite(x), torch.isfinite(x_ref)):
        return 0.0, 0.0, "non-finite entries differ"
    use = ~bad
    use[level3] = True
    diff = (x - x_ref).abs().amax(dim=(1, 2))[use]
    rel = diff / x_ref.abs().amax(dim=(1, 2))[use].clamp_min(1e-30)
    return float(rel.max()), float(diff.max()), None


def hold_pivoted(arr, tol, what):
    """The pivoted kernel against its plain version on ``arr`` with the
    thresholds ``tol``: perm and the non-finite pattern equal, reduced
    array and pivots within TOL_KERNEL of each matrix's largest entry.
    Returns the max absolute difference of the reduced arrays."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    r = gj.gauss_jordan_tiled(arr, tol)
    torch.cuda.synchronize()
    ref = gj.gauss_jordan_reference(arr, tol)
    fin = torch.isfinite(r.reduced)
    same = (torch.equal(r.perm, ref.perm)
            and torch.equal(fin, torch.isfinite(ref.reduced))
            and torch.equal(torch.isfinite(r.pivots),
                            torch.isfinite(ref.pivots)))
    ok = fin.flatten(1).all(dim=1)
    diff = (r.reduced - ref.reduced).abs().amax(dim=(1, 2))[ok]
    scale = ref.reduced.abs().amax(dim=(1, 2))[ok]
    rel = float((diff / scale.clamp_min(1e-30)).max())
    pd = (r.pivots - ref.pivots).abs().amax(dim=1)[ok]
    prel = float((pd / ref.pivots.abs().amax(dim=1)[ok].clamp_min(1e-30))
                 .max())
    print(f"pivoted kernel vs plain {what} [{arr.shape[1]}, {arr.shape[2]}]: "
          f"perm and non-finite pattern equal {same}, max rel diff reduced "
          f"{rel:.3e} pivots {prel:.3e} (tol {TOL_KERNEL})")
    if not (same and rel <= TOL_KERNEL and prel <= TOL_KERNEL):
        raise AssertionError("pivoted kernel disagrees with plain version")
    return float(diff.max())


def check_inverse_kernels(dev):
    """Phase 6: both inverse kernels against their plain versions.
    Returns (kernel 2's, kernel 3's) max absolute difference at the
    bench shape."""
    from linalg_solver_tpu_torch.ops import rbt
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.utils import systems

    errs = {}
    for bsz, n in ((8, 32), (8, 64), (B_INV, N_INV)):
        draw = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
        redraw = rbt.default_diags(n, rbt.RESCUE_SEEDS, str(dev))
        probe = rbt.default_probe(n, str(dev))
        a = systems.inverse_probe_batch(
            inverse_batch(bsz, n, 200 + n, dev), draw, redraw)
        x, bad = inv_rbt.inverse_rbt_fused(a, draw, redraw, probe)
        torch.cuda.synchronize()
        x_ref, bad_ref = inv_rbt.inverse_rbt_fused_reference(
            a, draw, redraw, probe)
        rel, abs_err, why = compare_inverse(x, bad, x_ref, bad_ref, 6)
        flagged = bad.nonzero().flatten().tolist()
        print(f"inverse kernel vs plain B={bsz} N={n}: max rel diff "
              f"{rel:.3e} (tol {TOL_KERNEL}), flagged {flagged}")
        if why is not None or not rel <= TOL_KERNEL:
            raise AssertionError(f"inverse kernel disagrees with plain "
                                 f"version: {why or rel}")
        if flagged != systems.INVERSE_FLAGGED:
            raise AssertionError(f"flagged {flagged}, expected "
                                 f"{systems.INVERSE_FLAGGED}")
        errs["inv_rbt"] = abs_err
        if n == 64 and bsz == 8:
            # the same check must fail for the kernel without levels 2-3
            x0, bad0 = inv_rbt.inverse_rbt_fused(
                a, draw, redraw, probe, rescue=False)
            rel0, _, why0 = compare_inverse(x0, bad0, x_ref, bad_ref, 6)
            print(f"control, inverse kernel rescue=False vs plain "
                  f"rescue=True B=8 N=64: max rel diff {rel0:.3e} (must "
                  f"exceed {TOL_KERNEL}) or flags differ: {why0}")
            if why0 is None and not rel0 > TOL_KERNEL:
                raise AssertionError("the inverse check cannot see a "
                                     "kernel without its rescue")

        # the pivoted kernel on [A | I] of the same batch, with per-matrix
        # thresholds, and on the square batch (the det / rank width)
        eye = torch.eye(n, device=dev).expand(bsz, n, n)
        tol = torch.zeros(bsz, device=dev)
        tol[3] = 1e-2
        errs["gauss_jordan"] = max(
            hold_pivoted(torch.cat([a, eye], dim=2), tol, f"B={bsz}"),
            hold_pivoted(a, tol, f"B={bsz}"))
    return errs


def drive_inverse_path(dev):
    """Phase 7: the inverse path at the bench shape, then its rescue
    cases.  Returns the number of launches of the fused kernel."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.utils import systems

    a = inverse_batch(B_INV, N_INV, 0, dev)
    inv_rbt.LAUNCHES = gj.LAUNCHES = 0
    x = dispatch.inverse_batched(a, backend="auto")
    torch.cuda.synchronize()
    launches = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    resid = float(inverse_resid(a, x).max())
    print(f"inverse path inverse_batched(auto) B={B_INV} N={N_INV}: launches "
          f"fused {launches[0]} pivoted {launches[1]}, worst max|AX - I| "
          f"{resid:.3e} (tol {TOL_INV}), x {tuple(x.shape)}")
    if launches != (1, 0):
        raise AssertionError(f"expected one fused launch and no pivoted "
                             f"one, got {launches}")
    if x.shape != a.shape or not bool(torch.isfinite(x).all()):
        raise AssertionError("inverse has the wrong shape or non-finite "
                             "values")
    if not resid <= TOL_INV:
        raise AssertionError(f"inverse residual {resid}")

    draw = rbt.default_diags(N_INV, rbt.MAIN_SEEDS, str(dev))
    redraw = rbt.default_diags(N_INV, rbt.RESCUE_SEEDS, str(dev))
    a2 = a.clone()
    a2[5, :16, :16] = 0.0                  # zero leading minor: level 1
    a2[9] = systems.two_draw_zero_pivot_system(a[9], draw, redraw)
    a2[12] = 0.0                           # singular
    inv_rbt.LAUNCHES = gj.LAUNCHES = 0
    x2 = dispatch.inverse_batched(a2, backend="auto")
    torch.cuda.synchronize()
    launches2 = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    x3, bad = inv_rbt.inverse_rbt_fused_batched(a2, return_flags=True)
    r2 = inverse_resid(a2, x2)
    others = [i for i in range(B_INV) if i not in (5, 9, 12)]
    same = all(torch.equal(x2[i], x[i]) for i in others)
    flagged = bad.nonzero().flatten().tolist()
    print(f"inverse rescue: launches fused {launches2[0]} pivoted "
          f"{launches2[1]}, zero-minor max|AX - I| {float(r2[5]):.3e}, "
          f"two-draw (level 3) {float(r2[9]):.3e}, flagged {flagged}, "
          f"other matrices bitwise unchanged={same}")
    if launches2 != (1, 0):
        raise AssertionError(f"the rescue left the kernel: {launches2}")
    if not (float(r2[5]) <= 1e-2 and float(r2[9]) <= TOL_INV):
        raise AssertionError("the rescue left an invertible matrix wrong")
    if flagged != [9, 12] or not torch.equal(x3, x2):
        raise AssertionError("flags of the rescue case are wrong")
    if not same:
        raise AssertionError("the rescue changed a matrix it was not given")
    return launches[0]


def drive_pivoted_path(dev):
    """Phase 8: the pivoted kernel through the facade, then held against
    its plain version on the arrays the path gave it.  Returns its
    launches and the max absolute difference."""
    from linalg_solver_tpu_torch.ops import dispatch
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt

    n = 63
    a = inverse_batch(B_INV, n, 1, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    s = torch.eye(n, device=dev) + 0.1 * torch.randn(
        B_INV, n, n, generator=g, device=dev) / n**0.5
    low = s[:, :, :5] @ s[:, :5, :]
    inv_rbt.LAUNCHES = gj.LAUNCHES = 0
    x = dispatch.inverse_batched(a, backend="auto")
    d = dispatch.det_batched(s, backend="auto")
    rk = dispatch.rank_batched(low, backend="auto")
    torch.cuda.synchronize()
    launches = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    resid = float(inverse_resid(a, x).max())
    d_ref = torch.linalg.det(s.double())
    d_rel = float(((d.double() - d_ref).abs() / d_ref.abs()).max())
    print(f"pivoted path B={B_INV} N={n}: launches fused {launches[0]} "
          f"pivoted {launches[1]}, inverse worst max|AX - I| {resid:.3e}, "
          f"det max rel err vs float64 {d_rel:.3e}, ranks "
          f"{sorted(set(rk.tolist()))}")
    if launches != (0, 3):
        raise AssertionError(f"expected three pivoted launches, got "
                             f"{launches}")
    if not (resid <= TOL_INV and d_rel <= 1e-4 and set(rk.tolist()) == {5}):
        raise AssertionError("pivoted path gave a wrong result")

    # the kernel against its plain version on what the path gave it
    zero = torch.zeros(B_INV, device=dev)
    eye = torch.eye(n, device=dev).expand(B_INV, n, n)
    err = max(hold_pivoted(torch.cat([a, eye], dim=2), zero, "inverse path"),
              hold_pivoted(s, zero, "det path"),
              hold_pivoted(low, gj.default_rank_tol(low), "rank path"))
    return launches[1], err


def time_inverse(dev, card):
    """Phase 9: times at the bench shape, in ms and matrices/s."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    a = inverse_batch(B_INV, N_INV, 0, dev)
    args = (a, rbt.default_diags(N_INV, rbt.MAIN_SEEDS, str(dev)),
            rbt.default_diags(N_INV, rbt.RESCUE_SEEDS, str(dev)),
            rbt.default_probe(N_INV, str(dev)))
    aug = torch.cat([a, torch.eye(N_INV, device=dev).expand_as(a)], dim=2)

    times = {
        "kernel inverse_rbt_fused": cuda_time(
            inv_rbt.inverse_rbt_fused, *args, warmup=3, iters=20),
        "plain inverse_rbt_fused_reference": cuda_time(
            inv_rbt.inverse_rbt_fused_reference, *args, warmup=1, iters=3),
        "kernel gauss_jordan_tiled [A|I]": cuda_time(
            gj.gauss_jordan_tiled, aug, warmup=3, iters=20),
        "plain gauss_jordan_reference [A|I]": cuda_time(
            gj.gauss_jordan_reference, aug, warmup=1, iters=3),
        "gauss_jordan.inverse_batched": cuda_time(
            gj.inverse_batched, a, warmup=3, iters=20),
        "plain of gauss_jordan.inverse_batched": cuda_time(
            gj.inverse_reference, a, warmup=1, iters=3),
        "inverse_batched(auto)": cuda_time(
            dispatch.inverse_batched, a, warmup=3, iters=20),
        "torch.linalg.inv": cuda_time(
            torch.linalg.inv, a, warmup=3, iters=20),
    }
    for what, t in times.items():
        print(f"time {what}: {t * 1e3:.4f} ms, {B_INV / t:.0f} matrices/s "
              f"(B={B_INV} N={N_INV}, {card})")
    return times


def nan_equal(x, y) -> bool:
    """Bitwise equal, NaN where the other is NaN."""
    return bool(((x == y) | (x.isnan() & y.isnan())).all())


def record(module, name):
    """Wrap ``module.name`` so that every call's arguments and result are
    kept (the phase engine looks its kernels up at each call).  Returns
    the list of calls and a function that takes the wrapper off."""
    calls = []
    orig = getattr(module, name)

    def wrapped(*args):
        out = orig(*args)
        calls.append((args, out))
        return out

    setattr(module, name, wrapped)
    return calls, lambda: setattr(module, name, orig)


def hold_panels(calls, what):
    """Kernel 5's results on ``calls`` (recorded launches) against its
    plain version: flags and non-finite pattern equal, values within
    TOL_KERNEL of each panel's largest entry.  Returns (max abs diff,
    number of panels bitwise equal, number of panels)."""
    from linalg_solver_tpu_torch.ops.kernels import lu_nopivot

    worst = abs_err = 0.0
    bitwise = 0
    for (panel, nb), (x, ok) in calls:
        ref, ok_ref = lu_nopivot.panel_factor_nopivot_reference(panel, nb)
        fin = torch.isfinite(x)
        if not (torch.equal(ok, ok_ref)
                and torch.equal(fin, torch.isfinite(ref))):
            raise AssertionError(f"panel kernel {what}: flags or non-finite "
                                 f"pattern differ at [{panel.shape[1]}, {nb}]")
        keep = fin.flatten(1).all(dim=1)
        diff = (x - ref).abs().amax(dim=(1, 2))[keep]
        scale = ref.abs().amax(dim=(1, 2))[keep].clamp_min(1e-30)
        worst = max(worst, float((diff / scale).max()) if keep.any() else 0.0)
        abs_err = max(abs_err, float(diff.max()) if keep.any() else 0.0)
        bitwise += nan_equal(x, ref)
    print(f"panel kernel vs plain {what}: {len(calls)} launches, "
          f"{bitwise} bitwise equal, flags equal, max rel diff {worst:.3e} "
          f"(tol {TOL_KERNEL})")
    if not worst <= TOL_KERNEL:
        raise AssertionError(f"panel kernel disagrees with plain version "
                             f"{what}: {worst}")
    return abs_err, bitwise, len(calls)


def abs_diff(x, ref) -> float:
    """Max |x - ref| where both are finite."""
    both = torch.isfinite(x) & torch.isfinite(ref)
    return float((x - ref)[both].abs().max()) if both.any() else 0.0


def hold_butterflies(calls, what):
    """Kernel 4's results on ``calls`` against its plain version, bitwise.
    Returns the max absolute difference (0.0 when bitwise)."""
    from linalg_solver_tpu_torch.ops.kernels import butterfly

    err = 0.0
    for args, x in calls:
        ref = butterfly.butterfly_two_sided_reference(*args)
        if not nan_equal(x, ref):
            raise AssertionError(f"butterfly kernel disagrees with plain "
                                 f"version {what}")
        err = max(err, abs_diff(x, ref))
    print(f"butterfly kernel vs plain {what}: {len(calls)} launches, all "
          f"bitwise equal (max abs diff {err:.3e})")
    return err


def check_phase_kernels(dev):
    """Phase 10: kernels 4 and 5 against their plain versions.  Returns
    kernel 4's max absolute difference."""
    from linalg_solver_tpu_torch.ops import rbt
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot

    err = 0.0
    for n, bsz in ((64, 8), (256, B), (896, 8)):
        a = inverse_batch(bsz, n, 300 + n, dev)
        a[1, 2, 3] = float("inf")
        U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
        for depth in (1, 2):
            for trans in (True, False):
                x = butterfly.butterfly_two_sided(a, U, V, depth, trans, trans)
                torch.cuda.synchronize()
                ref = butterfly.butterfly_two_sided_reference(
                    a, U, V, depth, trans, trans)
                same = nan_equal(x, ref)
                print(f"butterfly kernel vs plain B={bsz} N={n} depth={depth} "
                      f"trans={trans}: bitwise equal {same}")
                if not same:
                    raise AssertionError("butterfly kernel disagrees with its "
                                         "plain version")
                err = max(err, abs_diff(x, ref))
        if n == 256:
            # the same check must fail for the kernel with its sides flipped
            x0 = butterfly.butterfly_two_sided(a, U, V, 2, False, False)
            ref = butterfly.butterfly_two_sided_reference(a, U, V, 2, True,
                                                          True)
            miss = float((x0 - ref)[2:].abs().max())
            print(f"control, butterfly kernel trans=False vs plain trans=True "
                  f"N=256: max abs diff {miss:.3e} (must exceed 1e-2)")
            if not miss > 1e-2:
                raise AssertionError("the butterfly check cannot see a "
                                     "flipped side")

    calls = []
    for m, nb in ((40, 8), (256, 32), (256, 64), (896, 64)):
        g = torch.Generator(device=dev).manual_seed(m + nb)
        p = torch.randn(6, m, nb, generator=g, device=dev)
        p[:, torch.arange(nb), torch.arange(nb)] += 4.0 * nb**0.5
        p[1, :, 3] = 0.0                    # a zero pivot
        p[2, 5, 1] = float("nan")           # a NaN that reaches a pivot
        p[3, m - 1, 2] = float("inf")       # an Inf below the square part
        p[4, 2, 2] = float("nan")           # a NaN pivot
        out = lu_nopivot.panel_factor_nopivot(p, nb)
        torch.cuda.synchronize()
        if out[1].tolist() != [True, False, False, False, False, True]:
            raise AssertionError(f"panel kernel flags {out[1].tolist()}")
        calls.append(((p, nb), out))
    hold_panels(calls, "on probe panels")
    return err


def phase_compare(x, bad, x_ref, bad_ref):
    """(max relative difference over the unflagged systems, what else
    differs or None) of two phase solves: flags equal, and the unflagged
    systems finite in both."""
    if not torch.equal(bad, bad_ref):
        return 0.0, f"flags {bad.tolist()} vs {bad_ref.tolist()}"
    use = ~bad
    if not (bool(torch.isfinite(x[use]).all())
            and bool(torch.isfinite(x_ref[use]).all())):
        return 0.0, "an unflagged system is not finite"
    diff = (x - x_ref).abs().amax(dim=(1, 2))[use]
    rel = diff / x_ref.abs().amax(dim=(1, 2))[use].clamp_min(1e-30)
    return float(rel.max()), None


def check_phase_solve(dev):
    """Phase 11: the phase solve on the card against the same engine on
    the CPU (plain versions), f32 glue; and the control without
    refinement."""
    from linalg_solver_tpu_torch.ops import rbt

    n = 64
    du, dv = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
    a, b = probe_batch(8, n, K_PHASE, du, dv, dev)
    x, bad = rbt._solve_core(a, b, (du, dv), 16, 2, "float32")
    torch.cuda.synchronize()
    x_ref, bad_ref = rbt._solve_core(a.cpu(), b.cpu(), (du.cpu(), dv.cpu()),
                                     16, 2, "float32")
    rel, why = phase_compare(x.cpu(), bad.cpu(), x_ref, bad_ref)
    flagged = bad.nonzero().flatten().tolist()
    print(f"phase solve card vs CPU plain B=8 N={n} k={K_PHASE} nb=16: max "
          f"rel diff {rel:.3e} (tol {TOL_KERNEL}), flagged {flagged}")
    if why is not None or not rel <= TOL_KERNEL or flagged != FLAGGED:
        raise AssertionError(f"phase solve disagrees with the plain path: "
                             f"{why or rel}, flagged {flagged}")
    x0, bad0 = rbt._solve_core(a, b, (du, dv), 16, 0, "float32")
    rel0 = float((x0[7].cpu() - x_ref[7]).abs().max() / x_ref[7].abs().max())
    print(f"control, phase solve ir_steps=0 vs plain ir_steps=2: small-pivot "
          f"system 7 max rel diff {rel0:.3e} (must exceed {TOL_KERNEL}), "
          f"flagged by the card {bool(bad0[7])}, by the plain path "
          f"{bool(bad_ref[7])}")
    if bool(bad_ref[7]) or not rel0 > TOL_KERNEL:
        raise AssertionError("the phase check cannot see a solve without "
                             "refinement")


def phase_counts():
    from linalg_solver_tpu_torch.ops.kernels import butterfly, gauss_jordan
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_nopivot
    from linalg_solver_tpu_torch.ops.kernels import solve_fused

    return {"fused": solve_fused.LAUNCHES, "inv_rbt": inv_rbt.LAUNCHES,
            "gauss_jordan": gauss_jordan.LAUNCHES,
            "butterfly": butterfly.LAUNCHES, "lu_nopivot": lu_nopivot.LAUNCHES}


def reset_counts():
    from linalg_solver_tpu_torch.ops.kernels import butterfly, gauss_jordan
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_nopivot
    from linalg_solver_tpu_torch.ops.kernels import solve_fused

    for mod in (solve_fused, inv_rbt, gauss_jordan, butterfly, lu_nopivot):
        mod.LAUNCHES = 0


def drive_phase_paths(dev):
    """Phase 12: the phase engine's solve and inverse paths at B=N=256,
    the reach check at N=896, the kernels against their plain versions on
    what the paths gave them, then the rescue cases.  Returns the launch
    counts, the max abs differences and the solve's panel launches."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot
    from linalg_solver_tpu_torch.utils import systems

    a = inverse_batch(B, N, 7, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    b = torch.randn(B, N, K_PHASE, generator=g, device=dev)
    out = {}

    # the solve path, k = 16
    bf_calls, bf_off = record(butterfly, "butterfly_two_sided")
    lu_calls, lu_off = record(lu_nopivot, "panel_factor_nopivot")
    reset_counts()
    x = dispatch.solve_batched(a, b, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    bf_off()
    lu_off()
    resid = float(worst_resid(a, b, x).max())
    print(f"phase solve path solve_batched(auto) B={B} N={N} k={K_PHASE}: "
          f"launches {counts}, worst residual {resid:.3e} (tol {TOL_RESID}), "
          f"x {tuple(x.shape)}")
    want = {"fused": 0, "inv_rbt": 0, "gauss_jordan": 0, "butterfly": 1,
            "lu_nopivot": N // 32}
    if counts != want:
        raise AssertionError(f"expected launches {want} (no rescue)")
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        raise AssertionError("phase solve has the wrong shape or non-finite "
                             "values")
    if not resid <= TOL_RESID:
        raise AssertionError(f"phase solve residual {resid}")
    out["butterfly_err"] = hold_butterflies(bf_calls, "on the solve path")
    out["panel_err"], _, _ = hold_panels(lu_calls, "on the solve path")
    out["solve_panels"] = [args for args, _ in lu_calls]
    out["butterfly_launches"] = counts["butterfly"]
    out["panel_launches"] = counts["lu_nopivot"]

    # the inverse path, N = 256
    bf_calls, bf_off = record(butterfly, "butterfly_two_sided")
    lu_calls, lu_off = record(lu_nopivot, "panel_factor_nopivot")
    reset_counts()
    xi = dispatch.inverse_batched(a, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    bf_off()
    lu_off()
    r_inv = float(inverse_resid(a, xi).max())
    print(f"phase inverse path inverse_batched(auto) B={B} N={N}: launches "
          f"{counts}, worst max|AX - I| {r_inv:.3e} (tol {TOL_INV})")
    want = {"fused": 0, "inv_rbt": 0, "gauss_jordan": 0, "butterfly": 2,
            "lu_nopivot": N // 64}
    if counts != want:
        raise AssertionError(f"expected launches {want} (no rescue)")
    if not (bool(torch.isfinite(xi).all()) and r_inv <= TOL_INV):
        raise AssertionError(f"phase inverse residual {r_inv}")
    out["butterfly_err"] = max(
        out["butterfly_err"], hold_butterflies(bf_calls, "on the inverse path"))
    out["panel_err"] = max(out["panel_err"],
                           hold_panels(lu_calls, "on the inverse path")[0])
    out["butterfly_launches"] += counts["butterfly"]
    out["panel_launches"] += counts["lu_nopivot"]

    # the reach check: N = 896 at k = 1 is past the fused kernel
    a8 = inverse_batch(8, N_REACH, 9, dev)
    b8 = torch.randn(8, N_REACH, generator=g, device=dev)
    reset_counts()
    x8 = dispatch.solve_batched(a8, b8, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    r8 = float(worst_resid(a8, b8, x8).max())
    print(f"reach check solve_batched(auto) B=8 N={N_REACH} k=1: launches "
          f"{counts}, worst residual {r8:.3e} (tol {TOL_RESID})")
    if counts["fused"] or counts["butterfly"] != 1 or not r8 <= TOL_RESID:
        raise AssertionError("the reach check failed")

    # rescue cases of the solve path
    draw = rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev))
    a2 = a.clone()
    a2[5] = systems.zero_minor_system(a[5])    # full rank: solved
    a2[9] = 0.0                                # singular: non-finite
    a2[12] = systems.pivot_system(a[12], *draw, 0.0)   # the redraw solves it
    reset_counts()
    x2 = dispatch.solve_batched(a2, b, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    r2 = worst_resid(a2, b, x2)
    others = [i for i in range(B) if i not in (5, 9, 12)]
    same = all(torch.equal(x2[i], x[i]) for i in others)
    print(f"phase solve rescue: launches {counts}, zero-minor residual "
          f"{float(r2[5]):.3e}, redraw system residual {float(r2[12]):.3e}, "
          f"singular system finite={bool(torch.isfinite(x2[9]).all())}, other "
          f"systems bitwise unchanged={same}")
    if counts["butterfly"] != 2:
        raise AssertionError("the rescue did not rerun the phase engine once")
    if not float(r2[[5, 12]].max()) <= TOL_RESID:
        raise AssertionError("rescue left a solvable system unsolved")
    if bool(torch.isfinite(x2[9]).all()) or not same:
        raise AssertionError("singular system finite, or another changed")

    # rescue cases of the inverse path
    redraw = rbt.default_diags(N, rbt.RESCUE_SEEDS, str(dev))
    a3 = a.clone()
    a3[5] = systems.zero_minor_system(a[5])
    a3[9] = systems.two_draw_zero_pivot_system(a[9], draw, redraw)
    a3[12] = 0.0
    reset_counts()
    x3 = dispatch.inverse_batched(a3, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    r3 = inverse_resid(a3, x3)
    same = all(torch.equal(x3[i], xi[i]) for i in others)
    print(f"phase inverse rescue: launches {counts}, zero-minor max|AX - I| "
          f"{float(r3[5]):.3e}, two-draw (pivoted) {float(r3[9]):.3e}, "
          f"singular finite={bool(torch.isfinite(x3[12]).all())}, other "
          f"matrices bitwise unchanged={same}")
    if counts["butterfly"] != 4 or not float(r3[[5, 9]].max()) <= TOL_INV:
        raise AssertionError("the inverse rescue failed")
    if bool(torch.isfinite(x3[12]).all()) or not same:
        raise AssertionError("singular matrix finite, or another changed")
    return out


def time_phase(dev, card, panels):
    """Phase 13: times at B=N=256."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    a = inverse_batch(B, N, 7, dev)
    b = torch.randn(B, N, K_PHASE, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev)
    U, V = rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev))
    panels = [(p.contiguous(), nb) for p, nb in panels]

    def panel_kernels():
        for p, nb in panels:
            lu_nopivot.panel_factor_nopivot(p, nb)

    def panel_plain():
        for p, nb in panels:
            lu_nopivot.panel_factor_nopivot_reference(p, nb)

    times = {
        "kernel butterfly_two_sided": cuda_time(
            butterfly.butterfly_two_sided, a, U, V, 2, warmup=3, iters=20),
        "plain butterfly_two_sided_reference": cuda_time(
            butterfly.butterfly_two_sided_reference, a, U, V, 2, warmup=1,
            iters=5),
        "kernel panel_factor_nopivot, the 8 solve panels": cuda_time(
            panel_kernels, warmup=3, iters=20),
        "plain panel_factor_nopivot_reference, the 8 solve panels": cuda_time(
            panel_plain, warmup=1, iters=3),
        f"solve_batched(auto) k={K_PHASE}": cuda_time(
            dispatch.solve_batched, a, b, warmup=3, iters=10),
        f"torch.linalg.solve k={K_PHASE}": cuda_time(
            torch.linalg.solve, a, b, warmup=3, iters=10),
        "inverse_batched(auto) N=256": cuda_time(
            dispatch.inverse_batched, a, warmup=3, iters=10),
        "torch.linalg.inv N=256": cuda_time(
            torch.linalg.inv, a, warmup=3, iters=10),
    }
    for what, t in times.items():
        print(f"time {what}: {t * 1e3:.4f} ms (B={B} N={N}, {card})")
    return times


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
    # values of the small-pivot system 7 are off by >= 2e-3 before it,
    # whether or not the loose unrefined gate also flags it
    a, b, du, dv, x_ref, bad_ref = control
    x0, bad0 = sf.solve_fused_rbt(a, b, du, dv, ir_steps=0)
    rel0 = float((x0[7] - x_ref[7]).abs().max() / x_ref[7].abs().max())
    print(f"control, kernel ir_steps=0 vs plain ir_steps=2 B=8 N=64 k=1: "
          f"small-pivot system 7 max rel diff {rel0:.3e} (must exceed "
          f"{TOL_KERNEL}), flagged by the kernel {bool(bad0[7])}, by the "
          f"plain version {bool(bad_ref[7])}")
    if bool(bad_ref[7]) or not rel0 > TOL_KERNEL:
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

    # 6-9. the inverse
    inv_errs = check_inverse_kernels(dev)
    inv_launches = drive_inverse_path(dev)
    gj_launches, gj_err = drive_pivoted_path(dev)
    inv_times = time_inverse(dev, card)

    # 10-13. the phase engine
    bf_err = check_phase_kernels(dev)
    check_phase_solve(dev)
    phase = drive_phase_paths(dev)
    ph_times = time_phase(dev, card, phase["solve_panels"])

    print(json.dumps({"kernels": [{
        "name": "solve_fused_rbt",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/solve_fused.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/solve_fused_kernel.py:180",
        "launches": launches,
        "max_abs_err": bench_abs_err,
        "ms": times["kernel solve_fused_rbt"] * 1e3,
        "plain_ms": times["plain solve_fused_rbt_reference"] * 1e3,
    }, {
        "name": "inverse_rbt_fused",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/inv_rbt.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/inv_rbt_kernel.py:125",
        "launches": inv_launches,
        "max_abs_err": inv_errs["inv_rbt"],
        "ms": inv_times["kernel inverse_rbt_fused"] * 1e3,
        "plain_ms": inv_times["plain inverse_rbt_fused_reference"] * 1e3,
    }, {
        "name": "gauss_jordan_tiled",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/gauss_jordan.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/gj_kernel.py:55",
        "launches": gj_launches,
        "max_abs_err": max(inv_errs["gauss_jordan"], gj_err),
        "ms": inv_times["kernel gauss_jordan_tiled [A|I]"] * 1e3,
        "plain_ms": inv_times["plain gauss_jordan_reference [A|I]"] * 1e3,
    }, {
        "name": "butterfly_two_sided",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/butterfly.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/butterfly_kernel.py:91",
        "launches": phase["butterfly_launches"],
        "max_abs_err": max(bf_err, phase["butterfly_err"]),
        "ms": ph_times["kernel butterfly_two_sided"] * 1e3,
        "plain_ms": ph_times["plain butterfly_two_sided_reference"] * 1e3,
    }, {
        "name": "panel_factor_nopivot",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/lu_nopivot.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/lu_nopivot_kernel.py:41",
        "launches": phase["panel_launches"],
        "max_abs_err": phase["panel_err"],
        "ms": ph_times["kernel panel_factor_nopivot, the 8 solve panels"] * 1e3,
        "plain_ms": ph_times[
            "plain panel_factor_nopivot_reference, the 8 solve panels"] * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
