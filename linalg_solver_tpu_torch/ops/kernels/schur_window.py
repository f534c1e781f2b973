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
own in the same order and agree to the bit, NaN lanes included.
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
