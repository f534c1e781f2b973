"""The Sturm-count bisection of symmetric tridiagonal eigenvalues
(``ops.sturm``; the reference runs it as an XLA ``lax.while_loop`` of at
most 64 steps around a ``lax.scan`` over n, and has no Pallas kernel for
it).

For a lane with diagonal ``d [n]``, ``e2 [n]`` (``e2[0] = 0``,
``e2[i] = e[i-1]²``) and pivot floor ``pivmin``, the count of eigenvalues
below x is the number of negative pivots

    q_0 = 1,  q_i = (d_i − x) − e2_i / q_{i−1},  q_i = −pivmin where
    |q_i| < pivmin (before counting),

and a bisection step halves each (lane, index k) interval ``[a, b]`` on
``count(m) <= k`` at ``m = 0.5·(a + b)``.  The bisection stops when no
interval of the whole batch is wider than ``2·eps·max(|a|, |b|) + 1e-30``,
after 64 steps at most.

``sturm_count`` and ``bisect`` launch ``csrc/sturm.cu`` on CUDA tensors
and run the plain versions ``sturm_count_reference`` /
``bisect_reference`` on CPU tensors.  On a CUDA tensor they launch the
kernel or raise; they never fall back (``fits`` says which shapes the
kernel takes).  The kernel counts only what a step needs: an interval
that a step left bit for bit unchanged never changes again, and a run of
bit-identical neighbouring intervals shares one midpoint, so each step
counts one midpoint a run of live intervals (``bisect_schedule_reference``
is the plain model of that schedule).  ``bisect`` issues its
``BISECT_LAUNCHES`` launches at once, a device flag skipping the steps
after the stop, so nothing is read to the host inside the loop.
``LAUNCHES`` counts kernel launches (a ``sturm_count`` call one),
``LAST_STEPS`` keeps the live steps of the last ``bisect`` call on its
device and ``LAST_COUNTED`` the midpoints each of its steps counted.
Kernel and plain version round every operation on its own in the same
order, so they agree to the bit.
"""

from __future__ import annotations

import torch

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

#: the steps the last ``bisect`` call ran (an int32 tensor on its device;
#: None before the first call)
LAST_STEPS = None

#: the midpoints each step of the last ``bisect`` call counted (an int64
#: tensor [STEPS] on its device, 0 past the stop; None before the first
#: call)
LAST_COUNTED = None

#: bisection steps at most (the reference's ``it < 64``)
STEPS = 64

#: kernel launches of a ``bisect`` call on the card: the first plan, then
#: a count and a plan a step
BISECT_LAUNCHES = 1 + 2 * STEPS

#: the dynamic shared memory a block may take on the H100
_SMEM_LIMIT = 232448


def fits(n: int, dtype) -> bool:
    """Whether the kernel takes lanes of length ``n`` in ``dtype``: the
    lane's (d, e2) pairs in one block's shared memory."""
    size = {torch.float32: 4, torch.float64: 8}.get(dtype)
    return size is not None and 1 <= n and 2 * n * size <= _SMEM_LIMIT


def attributes(dtype=torch.float32) -> dict:
    """Registers and spill bytes a thread of the bisection's count and
    plan kernels (on a machine with the card)."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 4)()
    _build.check(_build.load().sturm_attributes(
        int(dtype == torch.float64), out), "sturm_attributes")
    return {"registers": out[0], "local_bytes": out[1],
            "plan_registers": out[2], "plan_local_bytes": out[3]}


def tolerance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stopping tolerance of an interval: ``2·eps·max(|a|, |b|) +
    1e-30`` in the tensors' dtype."""
    eps = torch.finfo(a.dtype).eps
    return 2 * eps * torch.maximum(a.abs(), b.abs()) + 1e-30


def _check(d, e2, pivmin):
    if d.dim() != 2 or e2.shape != d.shape:
        raise ValueError(f"d and e2 must be [B, n]; got {tuple(d.shape)} "
                         f"and {tuple(e2.shape)}")
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"d must be float32 or float64; got {d.dtype}")
    for name, t in (("e2", e2), ("pivmin", pivmin)):
        if t.dtype != d.dtype or t.device != d.device:
            raise ValueError(f"{name} must be {d.dtype} on {d.device}")
    if tuple(pivmin.shape) != (d.shape[0],):
        raise ValueError(f"pivmin must be [{d.shape[0]}]; got "
                         f"{tuple(pivmin.shape)}")


def sturm_count(d, e2, pivmin, x):
    """``int32 [B, G]`` counts of eigenvalues below ``x [B, G]``."""
    _check(d, e2, pivmin)
    if d.is_cuda:
        return _launch_count(d, e2, pivmin, x)
    if d.device.type == "cpu":
        return sturm_count_reference(d, e2, pivmin, x)
    raise ValueError(f"sturm_count: no kernel for {d.device}")


def sturm_count_reference(d, e2, pivmin, x):
    """Plain-PyTorch version of the count: the n-step recurrence as a
    Python loop of batched operations."""
    _check(d, e2, pivmin)
    pm = pivmin[:, None]
    q = torch.ones_like(x)
    cnt = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(d.shape[1]):
        q = (d[:, i, None] - x) - e2[:, i, None] / q
        q = torch.where(q.abs() < pm, -pm, q)
        cnt += (q < 0).to(torch.int32)
    return cnt


def bisect(d, e2, pivmin, a, b):
    """``(a, b, steps)``: the final intervals ``[B, n]`` from the
    enclosures ``a, b`` (left as they were) and the number of steps run
    (an int32 tensor on the device)."""
    global LAST_STEPS, LAST_COUNTED
    _check(d, e2, pivmin)
    if d.is_cuda:
        a, b, steps, LAST_COUNTED = _launch_bisect(d, e2, pivmin, a, b)
    elif d.device.type == "cpu":
        a, b, steps = bisect_reference(d, e2, pivmin, a, b)
        LAST_COUNTED = None
    else:
        raise ValueError(f"sturm bisect: no kernel for {d.device}")
    LAST_STEPS = steps
    return a, b, steps


def bisect_reference(d, e2, pivmin, a, b, steps_run=None):
    """Plain-PyTorch version of the bisection: the reference's loop, the
    stopping test read to the host once a step.  With ``steps_run`` it
    runs exactly that many steps: a wider batch's count, so that some of
    its lanes (each lane's steps are independent of the others') run
    alone give its intervals there."""
    _check(d, e2, pivmin)
    k = torch.arange(d.shape[1], device=d.device)[None, :]
    steps = 0
    while (steps < STEPS and bool(((b - a) > tolerance(a, b)).any())
           if steps_run is None else steps < steps_run):
        m = 0.5 * (a + b)
        below = sturm_count_reference(d, e2, pivmin, m) <= k
        a = torch.where(below, m, a)
        b = torch.where(below, b, m)
        steps += 1
    return a, b, torch.tensor(steps, dtype=torch.int32, device=d.device)


def _bits(t):
    """The bit patterns of a float tensor, as integers."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def bisect_schedule_reference(d, e2, pivmin, a, b, count=None):
    """Plain-PyTorch model of the kernel's schedule: ``(a, b, steps,
    counted)``, the intervals and steps of ``bisect_reference`` (to the
    bit) and the midpoints each step counted (int64 [STEPS], 0 past the
    stop).  An index is live until a step leaves its (a, b) bit for bit
    unchanged; a live index leads its run unless its left neighbour is
    live with the same bits; each leader's midpoint is counted once (by
    ``count``, ``sturm_count_reference`` unless given: any function with
    its arguments and results) and every index of the run takes it."""
    _check(d, e2, pivmin)
    count = count or sturm_count_reference
    B, n = d.shape
    dev = d.device
    k = torch.arange(n, device=dev)[None, :]
    frozen = torch.zeros(B, n, dtype=torch.bool, device=dev)
    counted = torch.zeros(STEPS, dtype=torch.int64, device=dev)
    steps = 0
    while steps < STEPS and bool(((b - a) > tolerance(a, b)).any()):
        live = ~frozen
        lead = live.clone()
        lead[:, 1:] &= ~(live[:, :-1]
                         & (_bits(a[:, 1:]) == _bits(a[:, :-1]))
                         & (_bits(b[:, 1:]) == _bits(b[:, :-1])))
        slot = torch.cumsum(lead, dim=1) - 1
        counted[steps] = lead.sum()
        m = 0.5 * (a + b)
        xs = torch.zeros(B, max(int(lead.sum(dim=1).max()), 1),
                         dtype=d.dtype, device=dev)
        rows, cols = lead.nonzero(as_tuple=True)
        xs[rows, slot[rows, cols]] = m[rows, cols]
        c = count(d, e2, pivmin, xs).gather(1, slot.clamp(min=0))
        below = c <= k
        na = torch.where(live & below, m, a)
        nb = torch.where(live & ~below, m, b)
        frozen |= live & (_bits(na) == _bits(a)) & (_bits(nb) == _bits(b))
        a, b = na, nb
        steps += 1
    return (a, b, torch.tensor(steps, dtype=torch.int32, device=dev),
            counted)


def _launch_count(d, e2, pivmin, x, lib=None):
    global LAUNCHES
    from . import _build

    B, n = d.shape
    if not fits(n, d.dtype):
        raise ValueError(f"sturm_count: no kernel for n = {n} in {d.dtype}")
    if tuple(x.shape[:1]) != (B,) or x.dim() != 2 or x.dtype != d.dtype:
        raise ValueError(f"x must be [{B}, G] {d.dtype}")
    x = x.contiguous()
    cnt = torch.zeros(x.shape, dtype=torch.int32, device=d.device)
    if B == 0 or x.shape[1] == 0:
        return cnt
    lib = lib or _build.load()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.sturm_count(d.contiguous().data_ptr(),
                              e2.contiguous().data_ptr(),
                              pivmin.contiguous().data_ptr(), x.data_ptr(),
                              cnt.data_ptr(), B, n, x.shape[1],
                              int(d.dtype == torch.float64), stream)
    _build.check(err, "sturm_count launch")
    LAUNCHES += 1
    return cnt


def _launch_bisect(d, e2, pivmin, a, b, lib=None):
    """``(a, b, steps, counted)`` from the kernel (``lib``: another build of
    its C entry points, for timing two forms)."""
    global LAUNCHES
    from . import _build

    B, n = d.shape
    if not fits(n, d.dtype):
        raise ValueError(f"sturm bisect: no kernel for n = {n} in "
                         f"{d.dtype}")
    a = a.to(d.dtype).contiguous().clone()
    b = b.to(d.dtype).contiguous().clone()
    live = torch.zeros(STEPS + 1, dtype=torch.int32, device=d.device)
    live[0] = ((b - a) > tolerance(a, b)).any()
    nl = torch.zeros(STEPS, B, dtype=torch.int32, device=d.device)
    if B > 0:
        lib = lib or _build.load()
        xs = torch.empty(B, n, dtype=d.dtype, device=d.device)
        cs = torch.empty(B, n, dtype=torch.int32, device=d.device)
        lp = torch.empty(B, n, dtype=torch.int32, device=d.device)
        dc, ec, pc = d.contiguous(), e2.contiguous(), pivmin.contiguous()
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream(d.device).cuda_stream
            err = lib.sturm_bisect(
                dc.data_ptr(), ec.data_ptr(), pc.data_ptr(), a.data_ptr(),
                b.data_ptr(), live.data_ptr(), xs.data_ptr(), cs.data_ptr(),
                lp.data_ptr(), nl.data_ptr(), B, n,
                int(d.dtype == torch.float64), stream)
        _build.check(err, "sturm bisect launch")
        LAUNCHES += BISECT_LAUNCHES
    counted = nl.sum(dim=1) * live[:STEPS]
    return a, b, live[:STEPS].sum(dtype=torch.int32), counted
