"""One Francis sweep's bulge chase (the real Schur solver of
``ops.schur``; the reference chases in an XLA scan, ``_one_sweep``'s
``lax.scan`` over ``_chase_step``, and has no Pallas kernel for it).

``francis_chase`` launches ``csrc/schur_chase.cu`` (every chase step of
the sweep in one launch; ``variant`` picks by shape between one block a
matrix in device memory and a cluster of two or four blocks holding H's
rows in their shared memory) on CUDA tensors and runs
``francis_chase_reference``, ~60 batched PyTorch operations a chase step
on strided views of the state, on CPU tensors.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  ``LAUNCHES`` counts
kernel launches (a CUDA graph's replay adds the launches it captured:
``ops.schur``).  Kernel and plain version round every product, sum and
difference on its own, in the same order, so they agree to the bit: a
chase through nearly deflated subdiagonals amplifies a rounding's
difference by orders of magnitude, so agreeing to a rounding would not
be a usable check.
"""

from __future__ import annotations

import torch

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

#: the variants: device memory, one block a matrix; a cluster of blocks
#: holding H's rows in shared memory
VARIANTS = (0, 1)
#: variant 1 from this n (mirror of N_CLUSTER_MIN in the source)
N_CLUSTER_MIN = 128
_SMEM_MAX = 232448
_MAXB = 64


def cluster_smem_bytes(n: int, cs: int, dtype) -> int:
    """Variant 1's dynamic shared memory a block at ``n`` in a cluster of
    ``cs`` blocks (mirror of ``cluster_bytes``): ``ceil((n+1)/cs)`` rows
    of H and a live flag a chase step."""
    esize = torch.empty((), dtype=dtype).element_size()
    b = -(-(n + 1) // cs) * (n + 1) * esize + n + 3 * (_MAXB - 1)
    return (b + 15) & ~15


def cluster_size(n: int, dtype) -> int:
    """Variant 1's blocks a cluster at ``n`` (mirror of ``cluster_size``):
    2 where half of H and a step's reflectors fit a block's shared
    memory, else 4 where a quarter does, else 0."""
    refl = 64 * 3 * 2 * (8 if dtype == torch.float64 else 4) + 64 * 2 * 4
    for cs in (2, 4):
        if cluster_smem_bytes(n, cs, dtype) + refl <= _SMEM_MAX:
            return cs
    return 0


def variant(n: int, dtype) -> int:
    """The variant the launch takes at ``n`` (mirror of
    ``chase_variant``): 1 from ``N_CLUSTER_MIN`` where a cluster holds H,
    else 0."""
    return 1 if n >= N_CLUSTER_MIN and cluster_size(n, dtype) else 0


def chase_tables(start, end, s_arr, p_arr, hi, chain, n_chain: int):
    """Each bulge's control at each position, ``[B, n_chain + 1, npad]``:
    row ``r`` is chain bulge ``n_chain − r`` (row ``n_chain`` is bulge 0,
    one per unreduced block), so that the bulges of one chase step, at
    positions ``k − 3i``, read their entries through one strided view.
    Returns ``(active, create, chasing, zcut, s, p)``: live; creating
    (at its block's start); chasing (live past row 0: its tail below
    column ``k − 1`` is zeroed); ``z`` cut (a 2-row step at the window's
    foot); the shift sum and product."""
    B, npad = start.shape
    pos = torch.arange(npad, device=start.device)
    if n_chain:
        lo_ch, s_ch, p_ch, ok_ch = chain

        def rows(per_bulge, bulge0):
            return torch.cat([per_bulge.flip(1)[:, :, None].expand(
                B, n_chain, npad), bulge0[:, None, :]], 1)

        LO = rows(lo_ch, start)
        HI = rows(hi[:, None].expand(B, n_chain), end)
        S = rows(s_ch, s_arr)
        P = rows(p_ch, p_arr)
        OK = rows(ok_ch, torch.ones_like(start, dtype=torch.bool))
    else:
        LO, HI = start[:, None, :], end[:, None, :]
        S, P = s_arr[:, None, :], p_arr[:, None, :]
        OK = True
    act = (pos >= LO) & (pos <= HI - 1) & (HI >= 2) & OK
    return (act, act & (pos == LO), act & (pos > 0), pos + 2 > HI,
            S.contiguous(), P.contiguous())


def _bulges(H, Q, tables, p0: int, r0: int, nb: int):
    """Advance (or create) ``nb`` bulges at positions ``p0, p0 + 3, …``
    (table rows ``r0, r0 + 1, …``) by one step, in place on the
    contiguous ``H`` (and ``Q``).  Their 3-row and 3-column supports are
    disjoint and each reflector reads only entries the others leave
    alone, so one batched step is the reference's sequence up to the
    order of the roundings where a bulge's rows cross another's columns.
    Every product, sum and difference is its own operation, rounded on
    its own in the kernel's order (no fused multiply-add, no reduction
    whose order the library picks)."""
    act, cre, chs, zcut, S, P = tables
    B, npad, _ = H.shape
    sb, o = H.stride(0), H.storage_offset()

    def ctl(t):
        return t.as_strided((B, nb), (t.stride(0), npad + 3),
                            t.storage_offset() + r0 * npad + p0)

    def dot3(u, w):                 # (u0 w0 + u1 w1) + u2 w2
        return u[0] * w[0] + u[1] * w[1] + u[2] * w[2]

    D = H.as_strided((B, nb, 3, 3), (sb, 3 * npad + 3, npad, 1),
                     o + p0 * npad + p0)          # H[p + r, p + c]
    a00, a01 = D[..., 0, 0], D[..., 0, 1]
    a10, a11, a21 = D[..., 1, 0], D[..., 1, 1], D[..., 2, 1]
    s = ctl(S)
    # first column of (H − aI)(H − bI) restricted to rows p..p+2
    x = a00 * a00 + a01 * a10 - s * a00 + ctl(P)
    y = a10 * (a00 + a11 - s)
    z = a10 * a21
    if p0 > 0:
        # chasing: the bulge sits in column p − 1
        bulge = H.as_strided((B, nb, 3), (sb, 3 * npad + 3, npad),
                             o + p0 * npad + p0 - 1)
        c = ctl(cre)
        x = torch.where(c, x, bulge[..., 0])
        y = torch.where(c, y, bulge[..., 1])
        z = torch.where(c, z, bulge[..., 2])
    # (at p = 0 a live bulge is always being created)
    z = torch.where(ctl(zcut), 0.0, z)
    # 3-vector Householder annihilating (y, z): v0 = x − alpha
    nrm = torch.sqrt(dot3((x, y, z), (x, y, z)))
    v0 = x + torch.where(x < 0, -1.0, 1.0) * nrm
    v = (v0, y, z)
    vn2 = dot3(v, v)
    beta = torch.where(ctl(act) & (vn2 >= torch.finfo(H.dtype).tiny),
                       2.0 / vn2, 0.0)
    bv = [(beta * vi)[..., None] for vi in v]
    v = [vi[..., None] for vi in v]

    # rows p..p+2, full width: H ← (I − βvvᵀ) H
    R = H.as_strided((B, nb, 3, npad), (sb, 3 * npad, npad, 1),
                     o + p0 * npad)
    rows = R.unbind(2)
    vr = dot3(v, rows)
    for i in range(3):
        rows[i].sub_(bv[i] * vr)
    if p0 > 0:
        # the bulge tail (and a deepened start's leak) in column p − 1
        tail = H.as_strided((B, nb, 2), (sb, 3 * npad + 3, npad),
                            o + (p0 + 1) * npad + p0 - 1)
        tail.masked_fill_(ctl(chs)[..., None], 0.0)
    # columns p..p+2, full height: H ← H (I − βvvᵀ); Q likewise
    cols = [(H.as_strided((B, nb, npad, 3), (sb, 3, npad, 1), o + p0))]
    if Q is not None:
        qs = Q.stride()
        cols.append(Q.as_strided((B, nb, Q.shape[1], 3),
                                 (qs[0], 3, qs[1], 1),
                                 Q.storage_offset() + p0))
    for C in cols:
        cc = C.unbind(3)
        cv = dot3(cc, v)
        for i in range(3):
            cc[i].sub_(cv * bv[i])

def _check(H, Q, tables, n_chain):
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"H must be [B, n+1, n+1]; got {tuple(H.shape)}")
    B, npad, _ = H.shape
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"H must be float32 or float64; got {H.dtype}")
    if Q is not None and (Q.dim() != 3 or Q.shape[0] != B
                          or Q.shape[2] != npad or Q.dtype != H.dtype):
        raise ValueError(f"Q must be [{B}, rows, {npad}] {H.dtype}; got "
                         f"{tuple(Q.shape)} {Q.dtype}")
    if not 0 <= n_chain <= 63:
        raise ValueError(f"n_chain must be in [0, 63]; got {n_chain}")
    for t in tables:
        if tuple(t.shape) != (B, n_chain + 1, npad):
            raise ValueError(f"tables must be [{B}, {n_chain + 1}, {npad}]; "
                             f"got {tuple(t.shape)}")


def francis_chase(H, Q, tables, n_chain: int, v=None):
    """One sweep's chase on the padded Hessenberg batch ``H [B, n+1,
    n+1]`` and, when given, the accumulator ``Q [B, rows, n+1]`` (every
    reflector also applied on its right), under the control ``tables``
    of ``chase_tables``.  ``v`` forces a kernel variant (tests; default
    by shape).  Returns new ``(H, Q)``; the inputs are left as they
    were."""
    _check(H, Q, tables, n_chain)
    H = H.clone(memory_format=torch.contiguous_format)
    if Q is not None:
        Q = Q.clone(memory_format=torch.contiguous_format)
    if H.is_cuda:
        _launch(H, Q, tables, n_chain, v)
    elif H.device.type == "cpu":
        _chase(H, Q, tables, n_chain)
    else:
        raise ValueError(f"francis_chase: no kernel for {H.device}")
    return H, Q


def francis_chase_reference(H, Q, tables, n_chain: int):
    """Plain-PyTorch version of the kernel: the same contract as
    ``francis_chase`` on any device."""
    _check(H, Q, tables, n_chain)
    H = H.clone(memory_format=torch.contiguous_format)
    if Q is not None:
        Q = Q.clone(memory_format=torch.contiguous_format)
    _chase(H, Q, tables, n_chain)
    return H, Q


def _chase(H, Q, tables, n_chain: int):
    """The chase in place on contiguous ``H`` and ``Q``."""
    n = H.shape[1] - 1
    for k in range(max(n - 1 + 3 * n_chain, 1)):
        # bulge i sits at k − 3i; only 0 <= k − 3i <= n − 2 can be live
        i_lo = max(0, -(-(k - (n - 2)) // 3))
        i_hi = min(n_chain, k // 3)
        if i_lo > i_hi:
            continue
        r_lo, r_hi = n_chain - i_hi, n_chain - i_lo
        p0 = k - 3 * i_hi
        if p0 == 0 and r_hi > r_lo:
            # a bulge created at row 0 has no column −1: a step of its own
            _bulges(H, Q, tables, 0, r_lo, 1)
            _bulges(H, Q, tables, 3, r_lo + 1, r_hi - r_lo)
        else:
            _bulges(H, Q, tables, p0, r_lo, r_hi - r_lo + 1)


def _launch(H, Q, tables, n_chain, v=None):
    global LAUNCHES
    from . import _build

    B, npad, _ = H.shape
    dev = H.device
    act, cre, chs, zcut, S, P = (t.contiguous() for t in tables)
    for t in (act, cre, chs, zcut):
        if t.dtype != torch.bool or t.device != dev:
            raise ValueError(f"control tables must be bool on {dev}")
    for t in (S, P):
        if t.dtype != H.dtype or t.device != dev:
            raise ValueError(f"shift tables must be {H.dtype} on {dev}")
    if B == 0:
        return
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.schur_chase(
            H.data_ptr(), 0 if Q is None else Q.data_ptr(), act.data_ptr(),
            cre.data_ptr(), chs.data_ptr(), zcut.data_ptr(), S.data_ptr(),
            P.data_ptr(), B, npad - 1, n_chain,
            0 if Q is None else Q.shape[1], int(H.dtype == torch.float64),
            -1 if v is None else v, stream)
    _build.check(err, "schur_chase launch")
    LAUNCHES += 1
