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
tensors and runs ``gauss_pivots_complex_reference`` on CPU tensors.  On
a CUDA tensor it launches the kernel or raises; it never falls back.
``LAUNCHES`` counts kernel launches.  The kernel's variant 2 (f32 to
n = 192, f64 to 128: one block of 16 warps a lane, a warp owning whole
columns, the first ``CR`` column slots of each warp in registers and the
other ``CS`` in shared memory) leaves the rows in place and keeps each
row's position instead; ``gauss_rows_in_place_reference`` is that
schedule written plainly.  Past its reach variant 1 works on a
device-memory copy of the planes ([B, 2, n, n | 1], the wrapper's
scratch).  All of them round every operation on its own in the
reference's order, so they agree to the bit.  The reference exchanges
rows by one-hot products (``M − e_k δ + e_p δ``, which rounds ``M_k −
(M_k − M_p)``); here a row exchange moves the rows as they are, so the
two differ by that rounding and on non-finite rows.
"""

from __future__ import annotations

import torch

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

#: the dynamic shared memory a block may take (a block's 232,448 bytes
#: less a margin for the static scalars)
SMEM_LIMIT = 232448 - 256

_DTYPES = (torch.float32, torch.float64)

#: the register variant's warps, and its (CR, CS) column slots a warp in
#: registers and in shared memory by R = ceil(n / 32) rows a lane
#: (mirror of CG_REGS_F32 / CG_REGS_F64 in csrc/complex_gauss.cu)
WARPS = 16
REGS_SLOTS = {
    torch.float32: {1: (2, 0), 2: (4, 0), 3: (6, 0), 4: (6, 2), 5: (5, 5),
                    6: (4, 8)},
    torch.float64: {1: (2, 0), 2: (4, 0), 3: (3, 3), 4: (3, 5)},
}


def _esize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of variant 2 at ``n`` (0 for variant 1): the
    shared column slots of every warp, two factor buffers, 32 staging
    rows of ``n + 1`` and the step slots."""
    slots = REGS_SLOTS.get(dtype, {}).get(-(-n // 32))
    if slots is None:
        return 0
    R, CS = -(-n // 32), slots[1]
    return ((WARPS * CS * 2 * 32 * R + 4 * 32 * R + 32 * (n + 1))
            * _esize(dtype) + 2 * 8 * 4)


def variant(n: int, dtype) -> int:
    """2: the planes in registers and shared memory (n <= 192 in f32, 128
    in f64); 1: in a device-memory scratch."""
    b = smem_bytes(n, dtype)
    return 2 if 0 < b <= SMEM_LIMIT else 1


def scratch_ld(n: int) -> int:
    """Row stride of variant 1's device-memory scratch (odd)."""
    return n | 1


def fits(n: int, dtype) -> bool:
    """Whether the kernel takes ``[B, n, n]`` planes in ``dtype`` (every n
    from 1: past variant 2 variant 1 works in device memory)."""
    return dtype in _DTYPES and n >= 1


def attributes(n: int, dtype) -> dict:
    """Registers, spill bytes, dynamic shared memory and resident blocks
    an SM of the kernel variant that takes ``n`` (on a machine with the
    card)."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 4)()
    _build.check(_build.load().complex_gauss_attributes(
        n, int(dtype == torch.float64), out), "complex_gauss_attributes")
    return {"registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2], "blocks_per_sm": out[3]}


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


def gauss_rows_in_place_reference(a_re: torch.Tensor, a_im: torch.Tensor):
    """Variant 2's schedule written plainly: the same contract as
    ``gauss_pivots_complex_reference``, with the rows left in place.
    ``pos[b, r]`` is row r's position (initially r); step k's candidates
    are the rows with ``pos >= k``, ordered as ``torch.argmax`` orders
    positions (NaN largest, then the larger ``|·|²``, then the smaller
    position); an exchange gives the winner position k and the row that
    held position k the winner's old position; the factors and the update
    go to the rows with ``pos > k``, in the columns ``> k``.  Every entry
    sees the operations of the plain version, so the two agree to the
    bit."""
    _check(a_re, a_im)
    B, n, _ = a_re.shape
    dev = a_re.device
    re, im = a_re.clone(), a_im.clone()
    pr = torch.zeros(B, n, dtype=re.dtype, device=dev)
    pi = torch.zeros_like(pr)
    sg = torch.ones(B, dtype=re.dtype, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    lanes = torch.arange(B, device=dev)
    pos = torch.arange(n, device=dev).expand(B, n).clone()
    nan_key = torch.tensor(float("inf"), dtype=re.dtype, device=dev)
    for k in range(n):
        cr, ci = re[:, :, k], im[:, :, k]
        mag = cr * cr + ci * ci
        cand = pos >= k
        # the largest key (NaN above Inf), then the smallest position
        key = torch.where(torch.isnan(mag), nan_key, mag)
        isnan = torch.isnan(mag) & cand
        anynan = isnan.any(1, keepdim=True)
        top = torch.where(cand & ~torch.isnan(mag), key,
                          torch.full_like(key, -1.0)).amax(1, keepdim=True)
        best = torch.where(anynan, isnan, cand & ~torch.isnan(mag)
                           & (key == top))
        wpos = torch.where(best, pos, n).amin(1)
        w = torch.argmax((pos == wpos[:, None]).long(), dim=1)
        rowk = torch.argmax((pos == k).long(), dim=1)
        mw = mag[lanes, w]
        has = mw > 0
        ok = ok & has
        prow = torch.where(has, w, rowk)
        swap = has & (wpos != k)
        sg = torch.where(swap, -sg, sg)
        pos_w = pos[lanes, w].clone()
        pos[lanes, torch.where(swap, rowk, prow)] = torch.where(
            swap, pos_w, pos[lanes, prow])
        pos[lanes, prow] = k
        pre, pim = re[lanes, prow, k], im[lanes, prow, k]
        pr[:, k], pi[:, k] = pre, pim
        if k + 1 == n:
            break
        den = torch.where(has, pre * pre + pim * pim,
                          torch.ones_like(pre))[:, None]
        pre_, pim_ = pre[:, None], pim[:, None]
        xr, xi = re[:, :, k], im[:, :, k]
        fre = (xr * pre_ + xi * pim_) / den
        fim = (xi * pre_ - xr * pim_) / den
        fre = torch.where(has[:, None], fre, 0.0)[:, :, None]
        fim = torch.where(has[:, None], fim, 0.0)[:, :, None]
        up = (pos > k)[:, :, None]
        prow_re = re[lanes, prow, k + 1:][:, None, :]
        prow_im = im[lanes, prow, k + 1:][:, None, :]
        nr = re[:, :, k + 1:] - (fre * prow_re - fim * prow_im)
        ni = im[:, :, k + 1:] - (fre * prow_im + fim * prow_re)
        re[:, :, k + 1:] = torch.where(up, nr, re[:, :, k + 1:])
        im[:, :, k + 1:] = torch.where(up, ni, im[:, :, k + 1:])
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
        work = torch.empty(B, 2, n, scratch_ld(n), dtype=a_re.dtype,
                           device=dev)
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
