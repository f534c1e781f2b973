"""The inner real Schur form of an AED window and its trailing deflation
run in one launch (the aggressive-early-deflation round of
``ops.schur``; the reference runs them as a ``lax.while_loop`` of strict
sweeps and a ``lax.scan`` of batched tests in ``_aed`` and has no Pallas
kernel for them).

``window_schur`` launches ``csrc/schur_window.cu`` (one warp a window,
the window and its accumulator resident in shared memory for all of its
up to ``2w`` sweeps) on CUDA tensors and runs ``window_schur_reference``
on CPU tensors: ``ops.schur._window_schur``, the batch loop of strict
``_one_sweep`` calls on the plain chase, then
``ops.schur._trailing_deflation``.  On a CUDA tensor it launches
the kernel or raises; it never falls back (``fits`` says which windows
the kernel takes; ``ops.schur._aed`` chooses by it).  ``LAUNCHES``
counts kernel launches (a CUDA graph's replay adds those it captured:
``ops.schur``).  Kernel and plain version round every operation on its
own in the same order and agree to the bit, NaN lanes included, up to
the sign of a zero: the kernel skips a chase step that has beta = 0
where every value it could form is finite (``window_schedule_reference``
is that rule written plainly), and ``live_steps`` reads the kernel's
device count of the steps it ran.
"""

from __future__ import annotations

import torch

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

#: the kernel's reach: w + 1 <= 128 positions, and a block's shared memory
MAX_W = 127
SMEM_MAX = 232448


def smem_bytes(w: int, dtype) -> int:
    """Shared memory of the kernel's block at window size ``w`` (mirror
    of ``window_bytes`` in ``csrc/schur_window.cu``): H, Q, two shift
    arrays and two int arrays a position, H and Q at an odd row stride."""
    esize = torch.empty((), dtype=dtype).element_size()
    npad = w + 1
    ld = npad | 1
    b = (npad * ld + w * ld + 2 * npad) * esize + 2 * npad * 4
    return (b + 15) & ~15


def fits(w: int, dtype) -> bool:
    """Whether the kernel takes windows of size ``w`` in ``dtype``."""
    return (dtype in (torch.float32, torch.float64) and 1 <= w <= MAX_W
            and smem_bytes(w, dtype) <= SMEM_MAX)


def attributes(w: int, dtype) -> dict:
    """Registers, spill bytes, dynamic shared memory and resident blocks
    an SM of the kernel at window size ``w`` (on a machine with the
    card)."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 4)()
    _build.check(_build.load().schur_window_attributes(
        w, int(dtype == torch.float64), out), "schur_window_attributes")
    return {"registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2], "blocks_per_sm": out[3]}


def reset_live_steps(device) -> None:
    """Set the kernel's device count of the steps it ran back to 0 (on the
    current stream of ``device``)."""
    from . import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(_build.load().schur_window_live_reset(stream),
                     "schur_window_live_reset")


def live_steps(device) -> torch.Tensor:
    """The steps (not skipped) the kernel ran over its launches since the
    last ``reset_live_steps``, as an int64 [1] tensor on ``device``."""
    from . import _build

    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(_build.load().schur_window_live_steps(out.data_ptr(),
                                                           stream),
                     "schur_window_live_steps")
    return out


def _check(Hw, Qw, hw, anorm_w, beta, hi_w0):
    if Hw.dim() != 3 or Hw.shape[1] != Hw.shape[2]:
        raise ValueError(f"Hw must be [B, w+1, w+1]; got {tuple(Hw.shape)}")
    B, npad, _ = Hw.shape
    if Hw.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Hw must be float32 or float64; got {Hw.dtype}")
    if (tuple(Qw.shape) != (B, npad - 1, npad) or Qw.dtype != Hw.dtype
            or Qw.device != Hw.device):
        raise ValueError(f"Qw must be [{B}, {npad - 1}, {npad}] {Hw.dtype}; "
                         f"got {tuple(Qw.shape)} {Qw.dtype}")
    if tuple(hw.shape) != (B,) or hw.dtype != torch.int64:
        raise ValueError(f"hw must be [{B}] int64; got {tuple(hw.shape)} "
                         f"{hw.dtype}")
    for name, t in (("anorm_w", anorm_w), ("beta", beta)):
        if tuple(t.shape) != (B,) or t.dtype != Hw.dtype:
            raise ValueError(f"{name} must be [{B}] {Hw.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    if tuple(hi_w0.shape) != (B,) or hi_w0.dtype != torch.int64:
        raise ValueError(f"hi_w0 must be [{B}] int64; got "
                         f"{tuple(hi_w0.shape)} {hi_w0.dtype}")


def window_schur(Hw, Qw, hw, anorm_w, beta, hi_w0, n: int):
    """The real Schur form of every padded window ``Hw [B, w+1, w+1]``
    with ``Qw [B, w, w+1]`` accumulated, from the bottom rows ``hw [B]``
    and the norms ``anorm_w [B]``: up to ``2w`` strict sweeps, each lane
    stopping once ``hw < 1``; then the trailing deflation run from the
    rows ``hi_w0 [B]`` with the spike ``beta [B]·Qw[0, :]`` (``n``: the
    full matrix's size, which sets the deflation floor).  Returns new
    ``(Hw, Qw, hw, nd, p_fin)``; the inputs are left as they were."""
    _check(Hw, Qw, hw, anorm_w, beta, hi_w0)
    if Hw.is_cuda:
        return _launch(Hw, Qw, hw, anorm_w, beta, hi_w0, n)
    if Hw.device.type == "cpu":
        return window_schur_reference(Hw, Qw, hw, anorm_w, beta, hi_w0, n)
    raise ValueError(f"window_schur: no kernel for {Hw.device}")


def window_schur_reference(Hw, Qw, hw, anorm_w, beta, hi_w0, n: int):
    """Plain-PyTorch version of the kernel: the same contract as
    ``window_schur`` on any device."""
    from ..schur import _window_schur

    _check(Hw, Qw, hw, anorm_w, beta, hi_w0)
    return _window_schur(Hw, Qw, hw, anorm_w, beta, hi_w0, n)


#: the dead-step rule's bound on every value of H and Q a launch has held:
#: 2^60 in float32, 2^500 in float64 (as keys: the bits of |x|, the high
#: word in float64)
SKIP_BOUND = {torch.float32: (60 + 127) << 23,
              torch.float64: (500 + 1023) << 20}


def _mag_key(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` as the kernel's key, its largest over each lane: the bits
    (float64: the high word), NaN and Inf above every finite value."""
    a = x.abs().reshape(x.shape[0], -1)
    if a.dtype == torch.float64:
        return (a.view(torch.int64) >> 32).amax(1)
    return a.view(torch.int32).long().amax(1)


def _window_step(H, Q, tables, p: int, skip, mh):
    """Chase step ``p`` of a window sweep (``schur_chase._bulges`` at one
    position, written out) on lanes where ``skip`` is False; returns the
    new ``(H, Q, mh)``, ``mh`` each lane's largest key of a value it wrote
    (after the row update and the tail, then after the column update of
    H and Q)."""
    act, cre, chs, zcut, S, P = (t[:, 0, p] for t in tables)
    a00, a01 = H[:, p, p], H[:, p, p + 1]
    a10, a11, a21 = H[:, p + 1, p], H[:, p + 1, p + 1], H[:, p + 2, p + 1]
    x = a00 * a00 + a01 * a10 - S * a00 + P
    y = a10 * (a00 + a11 - S)
    z = a10 * a21
    if p > 0:
        x = torch.where(cre, x, H[:, p, p - 1])
        y = torch.where(cre, y, H[:, p + 1, p - 1])
        z = torch.where(cre, z, H[:, p + 2, p - 1])
    z = torch.where(zcut, 0.0, z)
    nrm = torch.sqrt(x * x + y * y + z * z)
    v0 = x + torch.where(x < 0, -1.0, 1.0) * nrm
    vn2 = v0 * v0 + y * y + z * z
    beta = torch.where(act & (vn2 >= torch.finfo(H.dtype).tiny), 2.0 / vn2,
                       0.0)
    v = [t[:, None] for t in (v0, y, z)]
    bv = [beta[:, None] * t for t in v]
    Hn = H.clone()
    rows = [Hn[:, p + i, :] for i in range(3)]
    vr = v[0] * rows[0] + v[1] * rows[1] + v[2] * rows[2]
    for i in range(3):
        rows[i].sub_(bv[i] * vr)
    if p > 0:
        Hn[:, p + 1:p + 3, p - 1].masked_fill_(chs[:, None], 0.0)
    keep = skip[:, None, None]
    mh = torch.where(skip, mh, torch.maximum(mh, _mag_key(Hn)))
    out = []
    for M in (Hn, Q.clone()):
        cols = [M[:, :, p + i] for i in range(3)]
        cv = cols[0] * v[0] + cols[1] * v[1] + cols[2] * v[2]
        for i in range(3):
            cols[i].sub_(cv * bv[i])
        out.append(M)
    Hn, Qn = out
    mh = torch.where(skip, mh, torch.maximum(
        mh, torch.maximum(_mag_key(Hn), _mag_key(Qn))))
    return torch.where(keep, H, Hn), torch.where(keep, Q, Qn), mh


def window_schedule_reference(Hw, Qw, hw, anorm_w, beta, hi_w0, n: int):
    """The kernel's dead-step rule written plainly:
    ``window_schur_reference`` with a chase step skipped where it is at
    ``p > 0``, in no active block (beta = 0), and every value of H and Q
    the lane has held in the launch (its largest key, ``SKIP_BOUND``) is
    below 2^60 in float32 (2^500 in float64).  Returns ``(Hw, Qw, hw, nd,
    p_fin, steps)``: the kernel's outputs, equal to the plain version's
    up to the sign of a zero, and each lane's steps run (not skipped) in
    the sweeps the kernel runs for it (all of them while its ``hw >= 1``,
    one for a lane that enters converged where the batch is live)."""
    from .. import schur

    _check(Hw, Qw, hw, anorm_w, beta, hi_w0)
    B, npad, _ = Hw.shape
    w = npad - 1
    bound = SKIP_BOUND[Hw.dtype]
    cur = {"mh": torch.maximum(_mag_key(Hw), _mag_key(Qw)),
           "steps": torch.zeros_like(hw), "runs": None}

    def chase(H, Q, tables, n_chain):
        for p in range(max(npad - 2, 1)):
            act = tables[0][:, 0, p]
            skip = (~act & (cur["mh"] < bound)) if p > 0 else torch.zeros_like(
                act)
            H, Q, mh = _window_step(H, Q, tables, p, skip, cur["mh"])
            runs = cur["runs"]
            cur["mh"] = torch.where(runs, mh, cur["mh"])
            cur["steps"] += (runs & ~skip).long()
        return H, Q

    stg = torch.zeros_like(hw)
    live0 = (hw >= 1).any()
    for t in range(2 * w):
        live = (hw >= 1).any()
        cur["runs"] = live0 & ((hw >= 1) | (t == 0))
        new = schur._one_sweep(Hw, hw, stg, anorm_w, Qw, strict_deflate=True,
                               chase=chase)
        Hw, hw, stg, Qw = schur._blend(live, new[:4], (Hw, hw, stg, Qw))
    nd, p_fin = schur._trailing_deflation(Hw[:, :w, :w], Qw[:, :, :w], hw,
                                          beta, hi_w0, n)
    return Hw, Qw, hw, nd, p_fin, cur["steps"]


def _launch(Hw, Qw, hw, anorm_w, beta, hi_w0, n):
    global LAUNCHES
    from . import _build

    B, npad, _ = Hw.shape
    w = npad - 1
    if not fits(w, Hw.dtype):
        raise ValueError(f"window_schur: no kernel for w = {w} in "
                         f"{Hw.dtype} (fits: w <= {MAX_W} within "
                         f"{SMEM_MAX} bytes of shared memory)")
    dev = Hw.device
    for t in (Qw, hw, anorm_w, beta, hi_w0):
        if t.device != dev:
            raise ValueError(f"window_schur: every input must be on {dev}")
    H = Hw.clone(memory_format=torch.contiguous_format)
    Q = Qw.clone(memory_format=torch.contiguous_format)
    h = hw.clone(memory_format=torch.contiguous_format)
    p = hi_w0.clone(memory_format=torch.contiguous_format)
    nd = torch.zeros_like(p)
    if B == 0:
        return H, Q, h, nd, p
    an, be = anorm_w.contiguous(), beta.contiguous()
    live = (hw >= 1).any()        # read by the kernel on the device
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.schur_window(H.data_ptr(), Q.data_ptr(), h.data_ptr(),
                               an.data_ptr(), be.data_ptr(), p.data_ptr(),
                               nd.data_ptr(), live.data_ptr(), B, w, n,
                               int(Hw.dtype == torch.float64), stream)
    _build.check(err, "schur_window launch")
    LAUNCHES += 1
    return H, Q, h, nd, p
