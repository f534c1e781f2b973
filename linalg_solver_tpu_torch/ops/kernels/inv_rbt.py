"""The fused RBT inverse for small N (counterpart of
``linalg_solver_tpu.ops.pallas.inv_rbt_kernel``).

Per matrix, in one launch of ``csrc/inv_rbt.cu`` (one thread block per
matrix): butterflies ``A' = Uᵀ A V``, Gauss–Jordan without pivoting on
``[A' | I]`` (step j updates only the live columns ``[j, n+j]``),
``X = V inv(A') Uᵀ``, and a Rademacher probe against the original A,
``bad = !(max|A (X v) − v| ≤ 1e-2 and no zero pivot)``.  With
``rescue`` a flagged matrix is rebuilt from A with the second draw
(R, S) (level 2), and if that fails too it is inverted by the pivoted
Gauss–Jordan steps of ``gauss_jordan`` with tol 0, its rows put back in
order by plain indexing, as ``gauss_jordan.inverse_batched`` does
(level 3).  A matrix that reaches level 3 stays flagged, inverted or
not.  (The TPU kernel puts them back with one-hot sums, which spread a
NaN over its whole column; that moves only the garbage of a flagged
non-finite matrix.)

The elimination runs in place on n columns: slot c holds A'-column c
until step c, then I-column ``n + c``, which at that step is still
``e_c`` with a pivot-row entry of 1 (``csrc/inv_rbt.cu``'s header note
derives it).  The result is bitwise that of the ``[n, 2n]`` span
(``_eliminate_span``, the TPU kernel's form, kept for the test that
holds the two equal).  The kernel takes N % 4 = 0 from 4 to 180, the
reference's reach (``fits``), with the n × n tile in registers, in one
of four variants chosen by N (``variant``: n ≤ 32, 64, 128, 180).
Level 3's ``[n, 2n]`` tile lives in a device-memory scratch of
``n (2n + 1)`` floats a matrix, allocated by the wrapper.

``inverse_rbt_fused`` launches the kernel on a CUDA tensor and runs
``inverse_rbt_fused_reference``, the same steps in plain PyTorch
vectorised over the batch, on a CPU tensor; on a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.
``inverse_rbt_fused_batched`` is the wrapper with the reference's
options.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import rbt
from ...utils.precision import f32_matmuls
from . import gauss_jordan as gj

#: the probe's threshold on max|A (X v) − v|
_RTOL = 1e-2

#: the largest N the kernel takes (the reference's ``supported`` cap)
MAX_N = 180

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

#: the gates ``inverse_rbt_fused_batched`` knows
GATE_MODES = ("probe", "full")

#: the kernel's variants, (warps, rows a lane, slots a warp): the tile
#: in registers for ``n ≤ 32·rows`` and ``n ≤ warps·slots``; the mirror
#: of ``INV_VARIANTS`` in ``csrc/inv_rbt.cu``
VARIANTS = {1: (4, 1, 8), 2: (8, 2, 8), 3: (16, 4, 8), 4: (16, 6, 12)}


def takes(v: int, n: int) -> bool:
    """Whether variant ``v`` takes an ``n`` that ``fits``."""
    nw, rows, slots = VARIANTS[v]
    return n <= 32 * rows and n <= nw * slots


def variant(n: int) -> int:
    """The variant that takes n, the smallest tile that holds it: the
    mirror of ``inv_variant`` in ``csrc/inv_rbt.cu``."""
    if n <= 32:
        return 1
    if n <= 64:
        return 2
    if n <= 128:
        return 3
    return 4


def smem_bytes(n: int, v: Optional[int] = None) -> int:
    """Shared memory variant ``v`` (by default ``variant(n)``) takes for
    n, in bytes: the mirror of ``inv_smem_floats`` in ``csrc/inv_rbt.cu``
    (the tile with column stride ``n | 1``, or level 3's small slots if
    larger; two coefficient buffers; four diagonal pairs; the probe and
    X v; the block-max slots and the zero-pivot flag)."""
    nw = VARIANTS[variant(n) if v is None else v][0]
    tile = max(n * (n | 1), 10 * n + 2 * nw)
    return 4 * (tile + 12 * n + nw + 1)


def fits(n: int) -> bool:
    """Whether the kernel takes n: the reference's ``supported``, n a
    multiple of 4 from 4 to 180."""
    return n >= 4 and n % 4 == 0 and n <= MAX_N


def attributes(n: int, v: Optional[int] = None) -> dict:
    """Registers, spill bytes and resident blocks an SM of variant ``v``
    (by default ``variant(n)``) at n (on a machine with the card)."""
    from . import _build

    v = variant(n) if v is None else v
    return {"variant": v, **_build.attributes("inv_attributes", v, n, 0)}


def _check(a: torch.Tensor) -> torch.Tensor:
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must be [B, N, N]; got {tuple(a.shape)}")
    if a.shape[-1] % 2:
        raise ValueError(f"N={a.shape[-1]}: butterfly segments need an even N")
    if a.is_complex():
        raise TypeError("inverse_rbt_fused takes real matrices")
    return a.to(torch.float32)


def _defaults(n, dev, diags, rescue_diags, probe):
    if diags is None:
        diags = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
    if rescue_diags is None:
        rescue_diags = rbt.default_diags(n, rbt.RESCUE_SEEDS, str(dev))
    if probe is None:
        probe = rbt.default_probe(n, str(dev))
    return diags, rescue_diags, probe


def inverse_rbt_fused(
    a: torch.Tensor,
    diags: Tuple[torch.Tensor, torch.Tensor],
    rescue_diags: Tuple[torch.Tensor, torch.Tensor],
    probe: torch.Tensor,
    rescue: bool = True,
    v: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch: ``(X [B, N, N] f32, bad [B] bool)``.  ``diags`` and
    ``rescue_diags`` are ``[2, N]`` (U, V) and (R, S) pairs, ``probe``
    the ``[N]`` ±1 vector; ``rescue`` turns levels 2 and 3 on.  ``v``
    picks a kernel variant that takes N (by default ``variant(N)``); the
    plain version has one form for all."""
    a32 = _check(a)
    if a32.is_cuda:
        return _launch(a32, diags, rescue_diags, probe, rescue, v)
    if a32.device.type == "cpu":
        return inverse_rbt_fused_reference(
            a32, diags, rescue_diags, probe, rescue)
    raise ValueError(f"inverse_rbt_fused: no kernel for {a32.device}")


def _launch(a32, diags, rescue_diags, probe, rescue, v):
    global LAUNCHES
    from . import _build

    B, n, _ = a32.shape
    dev = a32.device
    if not fits(n):
        raise ValueError(f"N={n}: the kernel takes N % 4 == 0 from 4 to "
                         f"{MAX_N}")
    v = variant(n) if v is None else v
    if v not in VARIANTS or not takes(v, n):
        raise ValueError(f"variant {v} does not take N={n}")
    named = {"diags_u": diags[0], "diags_v": diags[1],
             "rescue_u": rescue_diags[0], "rescue_v": rescue_diags[1]}
    for name, t in named.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(
                t.shape) != (2, n):
            raise ValueError(
                f"{name} must be f32 [2, {n}] on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if probe.device != dev or probe.dtype != torch.float32 or tuple(
            probe.shape) != (n,):
        raise ValueError(f"probe must be f32 [{n}] on {dev}")
    lib = _build.load()
    a32 = a32.contiguous()
    ptrs = [t.contiguous() for t in (*named.values(), probe)]
    x = torch.empty_like(a32)
    bad = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return x, bad
    # level 3's [n, 2n | 1] tile, a slot a matrix (touched only by the
    # matrices that reach it)
    scratch = torch.empty(B * n * (2 * n + 1) if rescue else 0,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.inv_rbt_f32(
            a32.data_ptr(), *(t.data_ptr() for t in ptrs), x.data_ptr(),
            bad.data_ptr(), scratch.data_ptr() if rescue else None, B, n, v,
            int(rescue), stream,
        )
    _build.check(err, "inverse_rbt_fused launch")
    LAUNCHES += 1
    return x, bad


def _pivot(work, j):
    """Step j's ``(coeff [B, n], has [B])`` from column j of ``work``."""
    pv = work[:, j, j]
    has = (pv.abs() > 0).to(torch.float32)
    inv = 1.0 / (pv + (1.0 - has))
    coeff = work[:, :, j] * inv[:, None]
    coeff[:, j] = 1.0 - inv
    return coeff, has


def _eliminate(w):
    """The n steps in place on ``w [B, n, n]`` (a copy): step j turns slot
    j into I-column ``n + j`` (``e_j``, pivot-row entry 1) and updates
    every slot with one rounding.  Returns ``(inv(A'), ok)``."""
    B, n, _ = w.shape
    work = w.clone()
    ok = torch.ones(B, dtype=torch.float32, device=w.device)
    rows = torch.arange(n, device=w.device)
    for j in range(n):
        coeff, has = _pivot(work, j)
        prow = work[:, j, :].clone()
        prow[:, j] = 1.0
        work[:, :, j] = (rows == j).to(torch.float32)
        work = gj.fms(work, coeff[:, :, None], prow[:, None, :])
        ok = ok * has
    return work, ok


def _eliminate_span(w):
    """The TPU kernel's form of ``_eliminate``: ``[A' | I]``, step j
    updating the live span ``[j, n + j]``.  Bitwise the same result."""
    B, n, _ = w.shape
    eye = torch.eye(n, dtype=torch.float32, device=w.device)
    work = torch.cat([w, eye.expand(B, n, n)], dim=2)
    ok = torch.ones(B, dtype=torch.float32, device=w.device)
    for j in range(n):
        coeff, has = _pivot(work, j)
        span = work[:, :, j:n + j + 1]
        prow = work[:, j, j:n + j + 1]
        work[:, :, j:n + j + 1] = gj.fms(
            span, coeff[:, :, None], prow[:, None, :])
        ok = ok * has
    return work[:, :, n:], ok


def _nopivot_pass(a32, du, dv, probe):
    """Level 1 (or 2) on ``a32 [B, n, n]``: ``(X, bad)``."""
    d = rbt.shrink_depth(a32.shape[-1])
    du, dv = du[:d], dv[:d]
    w = rbt.butterfly_apply(a32, du, trans=True)
    w = rbt.butterfly_apply(w.transpose(1, 2), dv, trans=True).transpose(1, 2)
    inv, ok = _eliminate(w)
    x = rbt.butterfly_apply(inv, dv, trans=False)
    x = rbt.butterfly_apply(x.transpose(1, 2), du, trans=False)
    x = x.transpose(1, 2).contiguous()
    xv = (x * probe).sum(dim=2)
    resid = (a32 * xv[:, None, :]).sum(dim=2) - probe
    rmax = resid.abs().amax(dim=1)            # NaN-propagating
    bad = ~((rmax <= _RTOL) & (ok > 0))
    return x, bad


def inverse_rbt_fused_reference(
    a: torch.Tensor,
    diags: Tuple[torch.Tensor, torch.Tensor],
    rescue_diags: Tuple[torch.Tensor, torch.Tensor],
    probe: torch.Tensor,
    rescue: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the kernel, vectorised over the batch:
    the same contract as ``inverse_rbt_fused`` on any device.  Levels 2
    and 3 run on the flagged matrices only, as the kernel's branches
    do."""
    a32 = _check(a)
    x, bad = _nopivot_pass(a32, *diags, probe)
    if not rescue:
        return x, bad
    idx = torch.nonzero(bad).squeeze(1)
    if idx.numel():
        a_sub = a32.index_select(0, idx)
        x2, bad2 = _nopivot_pass(a_sub, *rescue_diags, probe)
        idx3 = torch.nonzero(bad2).squeeze(1)
        if idx3.numel():
            # level 3: the pivoted steps with tol 0 on [A | I]
            x2 = x2.index_copy(
                0, idx3, gj.inverse_reference(a_sub.index_select(0, idx3)))
        x = x.index_copy(0, idx, x2)
        bad = bad.index_copy(0, idx, bad2)
    return x, bad


def inverse_rbt_fused_batched(
    a: torch.Tensor,
    ns_steps: int = 0,
    fallback: bool = True,
    gate_mode: str = "probe",
    return_flags: bool = False,
    diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rescue_diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    probe: Optional[torch.Tensor] = None,
):
    """Batched small-N inverse through the fused RBT kernel.

    The default (``ns_steps=0, fallback=True, gate_mode="probe"``) runs
    gate and rescue inside the kernel and reads nothing to the host.
    Otherwise the kernel runs without its rescue, then ``ns_steps``
    Newton–Schulz rounds against the original A, then (with
    ``fallback``) the full gate ``max|I − A X| ≤ 1e-2`` ORed into the
    kernel's flags, and the pivoted ``gauss_jordan.inverse_batched`` on
    exactly the flagged matrices.

    ``return_flags=True`` also returns the final ``bad [B]`` flags;
    a matrix that failed every level (a singular one) comes back as
    finite or non-finite garbage, and the flag is the only signal.
    ``diags`` / ``rescue_diags`` / ``probe`` default to the seeded draws
    (``rbt.MAIN_SEEDS``, ``rbt.RESCUE_SEEDS``, ``rbt.PROBE_SEED``)."""
    if gate_mode not in GATE_MODES:
        raise ValueError(f"gate_mode {gate_mode!r}; one of {GATE_MODES}")
    if ns_steps < 0:
        raise ValueError(f"ns_steps must be >= 0, got {ns_steps}")
    a32 = _check(a)
    n = a32.shape[-1]
    diags, rescue_diags, probe = _defaults(
        n, a32.device, diags, rescue_diags, probe)
    hot = fallback and ns_steps == 0 and gate_mode == "probe"
    x, bad = inverse_rbt_fused(a32, diags, rescue_diags, probe, rescue=hot)
    if not hot:
        eye = torch.eye(n, dtype=torch.float32, device=a32.device)
        with f32_matmuls():
            for _ in range(ns_steps):
                r = eye - a32 @ x
                x = x + x @ r
            if fallback:
                r = eye - a32 @ x
                bad = bad | ~(r.abs().amax(dim=(1, 2)) <= _RTOL)
        if fallback:
            # One host read (the number of flagged matrices), as in
            # rbt._compacted_rescue: this branch is not the hot path.
            idx = torch.nonzero(bad).squeeze(1)
            if idx.numel():
                x = x.index_copy(
                    0, idx, gj.inverse_batched(a32.index_select(0, idx)))
    if a.dtype != torch.float32 and a.is_floating_point():
        x = x.to(a.dtype)
    return (x, bad) if return_flags else x
