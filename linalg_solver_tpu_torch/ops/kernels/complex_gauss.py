"""Pivoted complex Gauss elimination on (re, im) planes, the pivots of
``ops.complexlin``'s determinant and log-determinant (the reference runs
``_gauss_pivots_complex`` as an XLA ``lax.fori_loop`` of n steps and has
no Pallas kernel for it).

For every lane ``A = re + i·im [n, n]`` and step k: the first row ``p ≥
k`` of largest ``|A[p, k]|²`` (NaN counts as largest, as ``torch.argmax``
and ``jnp.argmax`` order it), ``has = |A[p, k]|² > 0``; rows k and p
exchanged where ``has`` and ``p ≠ k`` (the sign flips); ``pivot_k =
A[k, k]``; the factors ``f_i = A[i, k] / pivot_k`` below it (zero where
not ``has``) and the rank-1 update ``A[i, j] −= f_i·A[k, j]``.  Returns
``(pivots_re, pivots_im, sign, ok)`` with ``det = sign·Π pivot_k`` where
``ok``.

``gauss_pivots_complex`` launches ``csrc/complex_gauss.cu`` on CUDA
tensors (one block a lane: the planes in shared memory where ``8 n²``
bytes in f32, ``16 n²`` in f64, fit, else in a device-memory scratch the
wrapper allocates) and runs ``gauss_pivots_complex_reference`` on CPU
tensors.  On a CUDA tensor it launches the kernel or raises; it never
falls back.  ``LAUNCHES`` counts kernel launches.  Both round every
operation on its own in the reference's order, so they agree to the bit.
The reference exchanges rows by one-hot products (``M − e_k δ + e_p δ``,
which rounds ``M_k − (M_k − M_p)``); here a row exchange moves the rows
as they are, so the two differ by that rounding and on non-finite rows.
"""

from __future__ import annotations

import torch

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

#: the dynamic shared memory variant 0 may take (a block's 232,448 bytes
#: less the kernel's static scalars)
SMEM_LIMIT = 232448 - 64

_DTYPES = (torch.float32, torch.float64)


def smem_bytes(n: int, dtype) -> int:
    """Shared memory the lane's two planes take at ``n``."""
    return 2 * n * n * torch.empty((), dtype=dtype).element_size()


def variant(n: int, dtype) -> int:
    """0: the planes in shared memory; 1: in a device-memory scratch."""
    return 0 if smem_bytes(n, dtype) <= SMEM_LIMIT else 1


def fits(n: int, dtype) -> bool:
    """Whether the kernel takes ``[B, n, n]`` planes in ``dtype`` (every n
    from 1: past shared memory variant 1 works in device memory)."""
    return dtype in _DTYPES and n >= 1


def attributes(n: int, dtype) -> dict:
    """Registers, spill bytes and dynamic shared memory of the kernel at
    ``n`` (on a machine with the card)."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 3)()
    _build.check(_build.load().complex_gauss_attributes(
        n, int(dtype == torch.float64), out), "complex_gauss_attributes")
    return {"registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2]}


def _check(a_re, a_im):
    if a_re.dim() != 3 or a_re.shape[1] != a_re.shape[2]:
        raise ValueError(f"a_re must be [B, n, n]; got {tuple(a_re.shape)}")
    if a_re.dtype not in _DTYPES:
        raise TypeError(f"a_re must be float32 or float64; got {a_re.dtype}")
    if (a_im.shape != a_re.shape or a_im.dtype != a_re.dtype
            or a_im.device != a_re.device):
        raise ValueError(f"a_im must be {tuple(a_re.shape)} {a_re.dtype} on "
                         f"{a_re.device}; got {tuple(a_im.shape)} "
                         f"{a_im.dtype} on {a_im.device}")


def gauss_pivots_complex(a_re: torch.Tensor, a_im: torch.Tensor):
    """``(pivots_re [B, n], pivots_im [B, n], sign [B], ok [B])`` of the
    pivoted elimination of ``a_re + i·a_im`` (module docstring); the
    inputs are left as they were."""
    _check(a_re, a_im)
    if a_re.is_cuda:
        return _launch(a_re, a_im)
    if a_re.device.type == "cpu":
        return gauss_pivots_complex_reference(a_re, a_im)
    raise ValueError(f"gauss_pivots_complex: no kernel for {a_re.device}")


def gauss_pivots_complex_reference(a_re: torch.Tensor, a_im: torch.Tensor):
    """Plain-PyTorch version of the kernel, the same contract on any
    device: a step is the reference's, with the row exchange by gathers
    and the update on the trailing rows and columns (the only ones read
    again)."""
    _check(a_re, a_im)
    B, n, _ = a_re.shape
    re, im = a_re.clone(), a_im.clone()
    zeros = torch.zeros(B, n, dtype=re.dtype, device=re.device)
    pr, pi = zeros, zeros.clone()
    sg = torch.ones(B, dtype=re.dtype, device=re.device)
    ok = torch.ones(B, dtype=torch.bool, device=re.device)
    lanes = torch.arange(B, device=re.device)
    for k in range(n):
        cr, ci = re[:, k:, k], im[:, k:, k]
        mag = cr * cr + ci * ci
        rel = torch.argmax(mag, dim=1)
        has = mag.gather(1, rel[:, None])[:, 0] > 0
        ok = ok & has
        swap = has & (rel != 0)
        src = torch.where(swap, rel + k, k)
        for plane in (re, im):
            row_p = plane[lanes, src, k:]
            row_k = plane[:, k, k:].clone()
            plane[:, k, k:] = row_p
            plane[lanes, src, k:] = row_k
        sg = torch.where(swap, -sg, sg)
        pre, pim = re[:, k, k], im[:, k, k]
        pr[:, k], pi[:, k] = pre, pim
        if k + 1 == n:
            break
        den = torch.where(has, pre * pre + pim * pim,
                          torch.ones_like(pre))[:, None]
        pre_, pim_ = pre[:, None], pim[:, None]
        xr, xi = re[:, k + 1:, k], im[:, k + 1:, k]
        fre = (xr * pre_ + xi * pim_) / den
        fim = (xi * pre_ - xr * pim_) / den
        fre = torch.where(has[:, None], fre, 0.0)[:, :, None]
        fim = torch.where(has[:, None], fim, 0.0)[:, :, None]
        prow_re = re[:, k, None, k + 1:]
        prow_im = im[:, k, None, k + 1:]
        re[:, k + 1:, k + 1:] = re[:, k + 1:, k + 1:] - (
            fre * prow_re - fim * prow_im)
        im[:, k + 1:, k + 1:] = im[:, k + 1:, k + 1:] - (
            fre * prow_im + fim * prow_re)
    return pr, pi, sg, ok


def _launch(a_re, a_im):
    global LAUNCHES
    from . import _build

    B, n, _ = a_re.shape
    dev = a_re.device
    are, aim = a_re.contiguous(), a_im.contiguous()
    pr = torch.empty(B, n, dtype=a_re.dtype, device=dev)
    pi = torch.empty_like(pr)
    sg = torch.empty(B, dtype=a_re.dtype, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0 or n == 0:
        return pr, pi, sg.fill_(1), ok.fill_(True)
    work = None
    if variant(n, a_re.dtype) == 1:
        work = torch.empty(B, 2, n, n, dtype=a_re.dtype, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.complex_gauss(
            are.data_ptr(), aim.data_ptr(),
            None if work is None else work.data_ptr(), pr.data_ptr(),
            pi.data_ptr(), sg.data_ptr(), ok.data_ptr(), B, n,
            int(a_re.dtype == torch.float64), stream)
    _build.check(err, "complex_gauss launch")
    LAUNCHES += 1
    return pr, pi, sg, ok
