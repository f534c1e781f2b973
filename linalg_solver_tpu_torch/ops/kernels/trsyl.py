"""The masked triangular Sylvester solve of a reordered complex Schur
form (``ops.ordschur``'s cluster condition numbers; the reference solves
it in ``_trsyl_masked`` as an XLA ``lax.scan`` over rows with an inner
``lax.scan`` over columns and has no Pallas kernel for it).

For every lane, with ``T11 = T[:m, :m]`` and ``T22 = T[m:, m:]`` (``m``
a lane), it solves

    T11 X − X T22 = C          (adjoint=False)
    T11ᴴ X − X T22ᴴ = C        (adjoint=True)

for ``X`` on rows ``< m`` × columns ``≥ m`` (zero elsewhere; ``C`` is
read only there), on (re, im) pairs.  A denominator ``T_ii − T_jj`` whose
modulus is below ``smin = eps·max(max|T_re| + |T_im|, 1)`` is floored to
``±smin`` and the lane's ``pert`` flag set (an eigenvalue shared between
the clusters).

Both directions run on one operator ``M``: ``T`` forward, ``Tᴴ``
(transposed, imaginary part negated) for the adjoint.  Row ``i`` then
needs ``Σ_k M[i, k]·X[k, :]`` over the rows solved before it (below it
forward, above it for the adjoint) and each column ``j`` the running sum
``Σ_l x_l·M[l, j]`` over the columns solved before it in the row.

``trsyl_masked`` launches ``csrc/trsyl.cu`` (one block a lane, a thread a
column) on CUDA tensors and runs ``trsyl_masked_reference``, the
reference's double loop as Python loops of batched operations, on CPU
tensors.  On a CUDA tensor it launches the kernel or raises; it never
falls back (``fits`` says which shapes the kernel takes).  ``LAUNCHES``
counts kernel launches.  Both sum in the same order and round every
operation on its own, the row's masked product a term at a time, so they
agree to the bit.
"""

from __future__ import annotations

import torch

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

#: the kernel's reach: a thread a column, one block a lane
MAX_N = 1024


def fits(n: int, dtype) -> bool:
    """Whether the kernel takes ``[B, n, n]`` in ``dtype``."""
    return dtype in (torch.float32, torch.float64) and 1 <= n <= MAX_N


def attributes(n: int, dtype, adjoint: bool = False) -> dict:
    """Registers, spill bytes and dynamic shared memory of the kernel that
    takes ``[B, n, n]`` in ``dtype`` (on a machine with the card)."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 3)()
    _build.check(_build.load().trsyl_attributes(
        n, int(dtype == torch.float64), int(adjoint), out),
        "trsyl_attributes")
    return {"registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2]}


def _check(t_re, t_im, m, c_re, c_im):
    if t_re.dim() != 3 or t_re.shape[1] != t_re.shape[2]:
        raise ValueError(f"t_re must be [B, n, n]; got {tuple(t_re.shape)}")
    if t_re.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"t_re must be float32 or float64; got {t_re.dtype}")
    for name, t in (("t_im", t_im), ("c_re", c_re), ("c_im", c_im)):
        if (t.shape != t_re.shape or t.dtype != t_re.dtype
                or t.device != t_re.device):
            raise ValueError(f"{name} must be {tuple(t_re.shape)} "
                             f"{t_re.dtype} on {t_re.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if (tuple(m.shape) != (t_re.shape[0],) or m.dtype not in (
            torch.int32, torch.int64) or m.device != t_re.device):
        raise ValueError(f"m must be [{t_re.shape[0]}] int32 or int64 on "
                         f"{t_re.device}; got {tuple(m.shape)} {m.dtype}")


def _operands(t_re, t_im, adjoint: bool):
    """``M = T`` or ``Tᴴ`` as contiguous (re, im), and each lane's
    denominator floor ``smin``."""
    if adjoint:
        m_re = t_re.transpose(1, 2).contiguous()
        m_im = (-t_im).transpose(1, 2).contiguous()
    else:
        m_re, m_im = t_re.contiguous(), t_im.contiguous()
    mag = (t_re.abs() + t_im.abs()).amax(dim=(1, 2)) if t_re.numel() else (
        torch.zeros(t_re.shape[0], dtype=t_re.dtype, device=t_re.device))
    smin = torch.finfo(t_re.dtype).eps * torch.clamp(mag, min=1.0)
    return m_re, m_im, smin


def trsyl_masked(t_re, t_im, m, c_re, c_im, adjoint: bool = False):
    """``(X_re, X_im, pert)`` of the masked triangular Sylvester equation
    (module docstring) for ``T`` ``[B, n, n]`` upper triangular (re, im),
    ``m [B]`` and ``C [B, n, n]``.  The inputs are left as they were."""
    _check(t_re, t_im, m, c_re, c_im)
    if t_re.is_cuda:
        return _launch(t_re, t_im, m, c_re, c_im, adjoint)
    if t_re.device.type == "cpu":
        return trsyl_masked_reference(t_re, t_im, m, c_re, c_im, adjoint)
    raise ValueError(f"trsyl_masked: no kernel for {t_re.device}")


def trsyl_masked_reference(t_re, t_im, m, c_re, c_im, adjoint: bool = False):
    """Plain-PyTorch version of the kernel: the same contract as
    ``trsyl_masked`` on any device.  Rows run from the last (forward) or
    the first (adjoint) and columns the other way, over the bounds the
    batch's ``m`` spans (one host read); a lane outside its own block
    gets zeros."""
    _check(t_re, t_im, m, c_re, c_im)
    m_re, m_im, smin = _operands(t_re, t_im, adjoint)
    B, n, _ = t_re.shape
    X_re, X_im = torch.zeros_like(m_re), torch.zeros_like(m_im)
    pert = torch.zeros(B, dtype=torch.bool, device=t_re.device)
    if B == 0 or n == 0:
        return X_re, X_im, pert
    lo, hi = torch.stack([m.min(), m.max()]).tolist()
    m = m.to(torch.int64)
    idx = torch.arange(n, device=t_re.device)
    unsel = idx[None, :] >= m[:, None]                       # [B, n]
    dg_re, dg_im = m_re.diagonal(0, 1, 2), m_im.diagonal(0, 1, 2)
    smin2 = (smin * smin)[:, None]
    rows = range(hi) if adjoint else range(hi - 1, -1, -1)
    cols = range(n - 1, lo - 1, -1) if adjoint else range(lo, n)
    for i in rows:
        # the row's masked product with the rows solved before it, a term
        # at a time: Σ_k M[i, k] X[k, :] over k < i (adjoint) or k > i
        # (forward), k < m
        sr, si, tr, ti = (torch.zeros(B, n, dtype=m_re.dtype,
                                      device=m_re.device) for _ in range(4))
        for k in (range(i) if adjoint else range(i + 1, hi)):
            keep = k < m
            wr = torch.where(keep, m_re[:, i, k], 0.0)[:, None]
            wi = torch.where(keep, m_im[:, i, k], 0.0)[:, None]
            sr = sr + wr * X_re[:, k, :]
            si = si + wi * X_im[:, k, :]
            tr = tr + wr * X_im[:, k, :]
            ti = ti + wi * X_re[:, k, :]
        rhs_re = c_re[:, i, :] - (sr - si)
        rhs_im = c_im[:, i, :] - (tr + ti)
        den_re = dg_re[:, i, None] - dg_re
        den_im = dg_im[:, i, None] - dg_im
        small = den_re * den_re + den_im * den_im < smin2
        den_re = torch.where(
            small, torch.where(den_re < 0, -smin[:, None], smin[:, None]),
            den_re)
        den_im = torch.where(small, 0.0, den_im)
        den2 = den_re * den_re + den_im * den_im
        act = (i < m)[:, None] & unsel                      # [B, n]
        pert = pert | (small & act).any(dim=1)
        acc_re = torch.zeros(B, n, dtype=m_re.dtype, device=m_re.device)
        acc_im = torch.zeros_like(acc_re)
        for j in cols:
            nr = rhs_re[:, j] + acc_re[:, j]
            ni = rhs_im[:, j] + acc_im[:, j]
            xr = torch.where(act[:, j], (nr * den_re[:, j]
                                         + ni * den_im[:, j]) / den2[:, j],
                             0.0)
            xi = torch.where(act[:, j], (ni * den_re[:, j]
                                         - nr * den_im[:, j]) / den2[:, j],
                             0.0)
            X_re[:, i, j] = xr
            X_im[:, i, j] = xi
            # feed the columns solved after j: acc += x_j M[j, :]
            later = slice(0, j) if adjoint else slice(j + 1, n)
            mr, mi = m_re[:, j, later], m_im[:, j, later]
            acc_re[:, later] += xr[:, None] * mr - xi[:, None] * mi
            acc_im[:, later] += xr[:, None] * mi + xi[:, None] * mr
    return X_re, X_im, pert


def _launch(t_re, t_im, m, c_re, c_im, adjoint):
    global LAUNCHES
    from . import _build

    B, n, _ = t_re.shape
    if not fits(n, t_re.dtype):
        raise ValueError(f"trsyl_masked: no kernel for n = {n} in "
                         f"{t_re.dtype} (fits: 1 <= n <= {MAX_N})")
    m_re, m_im, smin = _operands(t_re, t_im, adjoint)
    X_re, X_im = torch.zeros_like(m_re), torch.zeros_like(m_im)
    pert = torch.zeros(B, dtype=torch.bool, device=t_re.device)
    if B == 0:
        return X_re, X_im, pert
    mm = m.to(torch.int32).contiguous()
    cr, ci = c_re.contiguous(), c_im.contiguous()
    lib = _build.load()
    dev = t_re.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.trsyl_masked(m_re.data_ptr(), m_im.data_ptr(),
                               mm.data_ptr(), cr.data_ptr(), ci.data_ptr(),
                               smin.data_ptr(), X_re.data_ptr(),
                               X_im.data_ptr(), pert.data_ptr(), B, n,
                               int(adjoint),
                               int(t_re.dtype == torch.float64), stream)
    _build.check(err, "trsyl_masked launch")
    LAUNCHES += 1
    return X_re, X_im, pert
