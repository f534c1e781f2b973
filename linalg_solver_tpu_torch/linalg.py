"""``numpy.linalg``-shaped namespace backed by the port's kernels
(counterpart of ``linalg_solver_tpu.linalg``).

For users arriving from ``numpy.linalg`` / ``torch.linalg``: the familiar
call signatures, arbitrary leading batch dimensions (including none),
complex eigenvalue outputs, routed through the batched ops
(``ops.dispatch`` for solve, inv and det, the Schur stack for eig, QDWH
for the SVD, CholeskyQR2 for QR and least squares, ``ops.complexlin``
for complex input).

    from linalg_solver_tpu_torch import linalg as tla
    x = tla.solve(a, b)          # any leading batch dims
    w, v = tla.eig(a)            # complex, like numpy

Devices: a ``torch.Tensor`` argument keeps its device (the tests pass CPU
tensors).  Any other array-like (a numpy array, a list) goes to the CUDA
device, as float32 (complex64 if complex), as the JAX package takes it
with float64 off; without a CUDA device that raises: there is no CPU
fallback.

Differences from ``numpy.linalg`` (as in the reference):

- Never raises ``LinAlgError``: singular or unconverged lanes give inf or
  NaN results.  Per-lane flags are in the underlying ``ops.*`` results
  (``converged`` / ``valid`` / ``ok``).
- ``svd(full_matrices=True)`` pads with an orthonormal complement whose
  span (not entries) matches numpy's.
- Complex outputs (``eig``, ``eigvals``, complex ``solve``, …) are torch
  complex tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops import complexlin as _cx
from .ops import dispatch as _dispatch
from .ops import lstsq as _lstsq
from .ops import lu as _lu
from .ops import schur as _schur
from .ops import spd as _spd
from .ops import svd as _svd
from .ops import symmetric as _symmetric
from .utils.precision import f32_matmuls

norm = torch.linalg.norm


def _as_tensor(x) -> torch.Tensor:
    """The device rule: a tensor as it is; any other array-like on the CUDA
    device as float32 (complex64 if complex)."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            "linalg: a non-tensor argument goes to the CUDA device, and "
            "there is none; pass a torch.Tensor to compute on its device")
    arr = np.asarray(x)
    dtype = np.complex64 if np.iscomplexobj(arr) else np.float32
    return torch.as_tensor(arr.astype(dtype), device="cuda")


def _batched(a, core_ndim: int = 2):
    """Flatten leading dims to one batch axis; returns ``(flat,
    unflatten, lead)``."""
    a = _as_tensor(a)
    lead = tuple(a.shape[: a.dim() - core_ndim])
    flat = a.reshape((-1,) + tuple(a.shape[a.dim() - core_ndim:]))

    def unflatten(x):
        return x.reshape(lead + tuple(x.shape[1:]))

    return flat, unflatten, lead


def _parts(x: torch.Tensor):
    """(re, im) of a tensor, complex or real."""
    if torch.is_complex(x):
        return x.real, x.imag
    return x, torch.zeros_like(x)


def solve(a, b):
    """``numpy.linalg.solve`` semantics: matrix or stacked-vector RHS, any
    matching leading batch dims.  Complex input runs through the
    embedded solver (``ops.complexlin``)."""
    a, b = _as_tensor(a), _as_tensor(b)
    af, unf, _ = _batched(a)
    vector_rhs = b.dim() == a.dim() - 1
    nb_dims = 1 if vector_rhs else 2
    bf = b.reshape((-1,) + tuple(b.shape[b.dim() - nb_dims:]))
    if torch.is_complex(af) or torch.is_complex(bf):
        n = af.shape[-1]
        ar, ai = _parts(af)
        br, bi = _parts(bf)
        if vector_rhs:
            xr, xi = _cx.solve_complex_batched(ar, ai, br, bi)
            return unf(torch.complex(xr, xi))
        # embedded matrix RHS: [Re b; Im b] stacked rows
        x = _SolveMatrixRHS.apply(_cx._embed(ar, ai), torch.cat([br, bi], 1))
        return unf(torch.complex(x[:, :n, :], x[:, n:, :]))
    if vector_rhs:
        return unf(_dispatch.solve_batched(af, bf))
    return unf(_SolveMatrixRHS.apply(af, bf))


def _solve_matrix_rhs_impl(af: torch.Tensor, bf: torch.Tensor):
    """One factorization, k solves: the dispatch solve at k = 1, else the
    blocked LU where a panel of 64, 48, 32, 16 or 8 tiles N ≥ 16, else
    the LU loop."""
    if bf.shape[-1] == 1:
        return _dispatch.solve_batched(af, bf[..., 0])[..., None]
    from .ops import lu_blocked as _lub

    n = af.shape[-1]
    nb = next((w for w in (64, 48, 32, 16, 8) if n % w == 0), None)
    if nb is not None and n >= 16:
        return _lub.blocked_solve_batched(af, bf, nb=nb)
    return _lu.lu_solve_batched(_lu.lu_factor_batched(af), bf)


class _SolveMatrixRHS(torch.autograd.Function):
    """Matrix-RHS solve with the reference's backward: one transposed
    solve ``ȳ = A⁻ᵀ x̄``, ``Ā = −ȳ xᵀ``, ``b̄ = ȳ``."""

    @staticmethod
    def forward(ctx, af, bf):
        x = _solve_matrix_rhs_impl(af, bf)
        ctx.save_for_backward(af, x)
        return x

    @staticmethod
    def backward(ctx, g):
        af, x = ctx.saved_tensors
        gy = _solve_matrix_rhs_impl(af.transpose(-1, -2), g)
        with f32_matmuls():
            abar = -(gy @ x.transpose(-1, -2))
        return abar.to(af.dtype), gy.to(x.dtype)


def inv(a):
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        return unf(torch.complex(*_cx.inverse_complex_batched(*_parts(af))))
    return unf(_dispatch.inverse_batched(af))


def det(a):
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        return unf(torch.complex(*_cx.det_complex_batched(*_parts(af))))
    return unf(_dispatch.det_batched(af))


class _SlogdetCore(torch.autograd.Function):
    """``(sign, log|det|)`` from the LU loop's diagonal, with the
    reference's backward ``d log|det A| = tr(A⁻¹ dA)`` (the inverse
    through ``dispatch.inverse_batched``; the sign is locally constant)."""

    @staticmethod
    def forward(ctx, af):
        res = _lu.lu_factor_batched(af)
        d = torch.diagonal(res.lu, dim1=-2, dim2=-1)
        sign = torch.sign(d).prod(dim=-1) * res.sign
        logabs = torch.log(d.abs()).sum(dim=-1)
        ctx.save_for_backward(af)
        ctx.mark_non_differentiable(sign)
        return sign, logabs

    @staticmethod
    def backward(ctx, g_sign, g_logabs):
        (af,) = ctx.saved_tensors
        inv_t = _dispatch.inverse_batched(af).transpose(-1, -2)
        return g_logabs[..., None, None] * inv_t


def slogdet(a):
    """(sign, log|det|) from the LU diagonal: finite where ``det`` itself
    would overflow."""
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        sr, si, la = _cx.slogdet_complex_batched(*_parts(af))
        return unf(torch.complex(sr, si)), unf(la)
    sign, logabs = _SlogdetCore.apply(af)
    return unf(sign), unf(logabs)


def matrix_rank(a, tol=None):
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        s = _cx.svd_complex_batched(*_parts(af)).s
        m, n = af.shape[-2:]
        cut = (tol if tol is not None
               else max(m, n) * torch.finfo(s.dtype).eps
               * s.amax(dim=1, keepdim=True))
        return unf((s > cut).sum(dim=1))
    return unf(_svd.rank_svd_batched(af, tol=tol))


def eig(a):
    """Complex eigenvalues and right eigenvectors (numpy layout: ``w [...,
    n]``, ``v [..., n, n]`` with ``v[..., :, i]`` the i-th eigenvector);
    complex input through the embedded eigensolver."""
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        r = _cx.eig_complex_batched(*_parts(af))
        return (unf(torch.complex(r.real, r.imag)),
                unf(torch.complex(r.v_re, r.v_im)))
    r = _schur.eig_batched(af)
    return (unf(torch.complex(r.real, r.imag)),
            unf(torch.complex(r.vectors_real, r.vectors_imag)))


def eigvals(a):
    a = _as_tensor(a)
    if torch.is_complex(a):
        return eig(a)[0]
    af, unf, _ = _batched(a)
    r = _schur.eigvals_schur(af)
    return unf(torch.complex(r.real, r.imag))


def eigh(a):
    """Ascending eigenvalues and orthonormal eigenvectors of symmetric (or
    complex HERMITIAN) input (numpy order)."""
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        r = _cx.eigh_complex_batched(*_parts(af))
        return unf(r.w), unf(torch.complex(r.v_re, r.v_im))
    r = _symmetric.eigh_batched(af)
    return unf(r.w), unf(r.V)


def eigvalsh(a):
    a = _as_tensor(a)
    if torch.is_complex(a):
        return eigh(a)[0]
    af, unf, _ = _batched(a)
    return unf(_symmetric.eigh_batched(af).w)


def svd(a, full_matrices: bool = False, compute_uv: bool = True):
    """SVD.  ``full_matrices=True`` pads the short factor with an
    orthonormal complement (CholeskyQR2 on a projected Gaussian block);
    the padded columns span the left/right null space, like numpy's
    (complement bases are unique only up to rotation)."""
    af, unf, _ = _batched(a)
    m, n = af.shape[-2], af.shape[-1]
    if torch.is_complex(af):
        rc = _cx.svd_complex_batched(*_parts(af))
        if not compute_uv:
            return unf(rc.s)
        u_re, u_im, v_re, v_im = rc.u_re, rc.u_im, rc.v_re, rc.v_im
        if full_matrices and m > n:
            c_re, c_im = _cx.complete_basis_complex_batched(u_re, u_im)
            u_re, u_im = torch.cat([u_re, c_re], -1), torch.cat([u_im, c_im],
                                                                -1)
        if full_matrices and n > m:
            c_re, c_im = _cx.complete_basis_complex_batched(v_re, v_im)
            v_re, v_im = torch.cat([v_re, c_re], -1), torch.cat([v_im, c_im],
                                                                -1)
        vh = torch.complex(v_re.transpose(-1, -2), -v_im.transpose(-1, -2))
        return unf(torch.complex(u_re, u_im)), unf(rc.s), unf(vh)
    r = _svd.svd_batched(af)
    if not compute_uv:
        return unf(r.s)
    U, V = r.U, r.V
    if full_matrices and m > n:
        U = torch.cat([U, _lstsq.complete_basis_batched(U)], -1)
    if full_matrices and n > m:
        V = torch.cat([V, _lstsq.complete_basis_batched(V)], -1)
    # numpy returns Vᴴ (rows are right singular vectors)
    return unf(U), unf(r.s), unf(V.transpose(-1, -2))


def qr(a):
    """Thin QR (mode='reduced')."""
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        rc = _cx.qr_complex_batched(*_parts(af))
        return (unf(torch.complex(rc.q_re, rc.q_im)),
                unf(torch.complex(rc.r_re, rc.r_im)))
    r = _lstsq.qr_batched(af)
    return unf(r.Q), unf(r.R)


def cholesky(a):
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        rc = _cx.chol_complex_batched(*_parts(af))
        return unf(torch.complex(rc.l_re, rc.l_im))
    return unf(_spd.cholesky_batched(af).L)


def lstsq(a, b):
    """Least-squares solution (only ``x``, the part numpy callers use;
    residuals, rank and singular values come from ``ops.lstsq`` /
    ``ops.svd``)."""
    a, b = _as_tensor(a), _as_tensor(b)
    af, unf, _ = _batched(a)
    vector_rhs = b.dim() == a.dim() - 1
    bf = b.reshape((-1,) + tuple(b.shape[b.dim() - (1 if vector_rhs
                                                    else 2):]))
    if torch.is_complex(af) or torch.is_complex(bf):
        ar, ai = _parts(af)
        br, bi = _parts(bf)
        if vector_rhs:
            xr, xi, _ = _cx.lstsq_complex_batched(ar, ai, br, bi)
            return unf(torch.complex(xr, xi))
        pr, pi, _ = _cx.pinv_complex_batched(ar, ai)
        return unf(torch.complex(*_cx._cmatmul(pr, pi, br, bi)))
    return unf(_lstsq.lstsq_batched(af, bf).x)


def pinv(a, rcond=None):
    af, unf, _ = _batched(a)
    if torch.is_complex(af):
        pr, pi, _ = _cx.pinv_complex_batched(*_parts(af), rcond=rcond)
        return unf(torch.complex(pr, pi))
    return unf(_svd.pinv_batched(af, rcond=rcond))


def _held_norm(af: torch.Tensor, p):
    """Batched matrix norm for ``cond``: p ∈ {1, -1, inf, -inf, 'fro'} on
    ``[B, m, n]`` (complex too: ``abs`` is the modulus)."""
    mag = af.abs()
    if p == "fro":
        return torch.sqrt((mag * mag).sum(dim=(-2, -1)))
    col = mag.sum(dim=-2)
    row = mag.sum(dim=-1)
    return {1: col.amax(-1), -1: col.amin(-1), math.inf: row.amax(-1),
            -math.inf: row.amin(-1)}[p]


def cond(a, p=None):
    """Condition number in any numpy norm: p ∈ {None, 2, -2} from singular
    values; p ∈ {1, -1, inf, -inf, 'fro'} as ‖A‖·‖A⁻¹‖ (square input; one
    inverse through the batched ops, as numpy computes it)."""
    af, unf, _ = _batched(a)
    is_c = torch.is_complex(af)
    if p in (None, 2, -2):
        s = (_cx.svd_complex_batched(*_parts(af)).s if is_c
             else _svd.svd_batched(af).s)
        if p == -2:
            return unf(s[:, -1] / torch.clamp(s[:, 0], min=1e-37))
        return unf(s[:, 0] / torch.clamp(s[:, -1], min=1e-37))
    if p not in (1, -1, "fro") and not (isinstance(p, float)
                                        and math.isinf(p)):
        raise ValueError(f"cond: unsupported norm order {p!r}")
    if af.shape[-1] != af.shape[-2]:
        raise ValueError("cond: p≠±2 requires square input (numpy too)")
    if is_c:
        inv_a = torch.complex(*_cx.inverse_complex_batched(*_parts(af)))
    else:
        inv_a = _dispatch.inverse_batched(af)
    return unf(_held_norm(af, p) * _held_norm(inv_a, p))


def matrix_power(a, n: int):
    """Integer matrix power by binary squaring (a negative n inverts
    first)."""
    af, unf, _ = _batched(a)
    if n < 0:
        af = inv(af)
        n = -n
    size = af.shape[-1]
    out = torch.eye(size, dtype=af.dtype, device=af.device).expand(
        af.shape).clone()
    base = af
    with f32_matmuls():
        while n > 0:
            if n & 1:
                out = out @ base
            n >>= 1
            if n:
                base = base @ base
    return unf(out)


def svdvals(a):
    """Singular values only (numpy 2.0 ``linalg.svdvals``)."""
    return svd(a, compute_uv=False)


def matrix_transpose(a):
    return _as_tensor(a).transpose(-1, -2)


def matrix_norm(a, ord="fro"):
    """Matrix norms over the trailing two axes (numpy 2.0 API).  ``ord=2``
    (spectral), -2 and ``"nuc"`` go through the QDWH SVD; the rest are
    reductions."""
    a = _as_tensor(a)
    mag = a.abs()
    if ord == "fro":
        return torch.sqrt((mag ** 2).sum(dim=(-2, -1)))
    if ord in ("nuc", 2, -2):
        s = svd(a, compute_uv=False)
        return {"nuc": s.sum(dim=-1), 2: s[..., 0], -2: s[..., -1]}[ord]
    if ord in (1, -1):
        col = mag.sum(dim=-2)
        return col.amax(dim=-1) if ord == 1 else col.amin(dim=-1)
    if ord in (math.inf, -math.inf):
        row = mag.sum(dim=-1)
        return row.amax(dim=-1) if ord > 0 else row.amin(dim=-1)
    raise ValueError(f"matrix_norm: unsupported ord {ord!r}")


def vector_norm(x, ord=2, axis=None, keepdims: bool = False):
    return torch.linalg.vector_norm(_as_tensor(x), ord=ord, dim=axis,
                                    keepdim=keepdims)


def vecdot(x1, x2, axis: int = -1):
    """Conjugating vector dot product over ``axis`` (numpy 2.0)."""
    x1, x2 = _as_tensor(x1), _as_tensor(x2)
    return (x1.conj() * x2).sum(dim=axis)


def outer(x1, x2):
    return torch.outer(_as_tensor(x1).flatten(), _as_tensor(x2).flatten())


def cross(x1, x2, axis: int = -1):
    return torch.linalg.cross(_as_tensor(x1), _as_tensor(x2), dim=axis)


def diagonal(x, offset: int = 0):
    return torch.diagonal(_as_tensor(x), offset=offset, dim1=-2, dim2=-1)


def trace(x, offset: int = 0, dtype=None):
    t = diagonal(x, offset).sum(dim=-1)
    return t.to(dtype) if dtype is not None else t


@f32_matmuls()
def matmul(x1, x2):
    return torch.matmul(_as_tensor(x1), _as_tensor(x2))


@f32_matmuls()
def tensordot(x1, x2, axes=2):
    return torch.tensordot(_as_tensor(x1), _as_tensor(x2), dims=axes)


def multi_dot(arrays):
    """Chained matrix product with the classic O(k³) dynamic-program
    parenthesization (numpy semantics: 1-D endpoints as row/column
    vectors, squeezed from the result).  The program runs on the host
    over the shapes; the device runs only the chosen products."""
    mats = [_as_tensor(a) for a in arrays]
    if not mats:
        raise ValueError("multi_dot: need at least one array")
    if len(mats) == 1:
        return mats[0]
    head_vec, tail_vec = mats[0].dim() == 1, mats[-1].dim() == 1
    if head_vec:
        mats[0] = mats[0][None, :]
    if tail_vec:
        mats[-1] = mats[-1][:, None]
    if any(m.dim() != 2 for m in mats):
        raise ValueError("multi_dot: interior arrays must be 2-D")
    dims = [m.shape[0] for m in mats] + [mats[-1].shape[1]]
    k = len(mats)
    cost = [[0.0] * k for _ in range(k)]
    split = [[0] * k for _ in range(k)]
    for ln in range(2, k + 1):
        for i in range(k - ln + 1):
            j = i + ln - 1
            cost[i][j] = math.inf
            for s in range(i, j):
                c = (cost[i][s] + cost[s + 1][j]
                     + dims[i] * dims[s + 1] * dims[j + 1])
                if c < cost[i][j]:
                    cost[i][j], split[i][j] = c, s

    def build(i, j):
        if i == j:
            return mats[i]
        s = split[i][j]
        return matmul(build(i, s), build(s + 1, j))

    out = build(0, k - 1)
    if head_vec:
        out = out[0]
    if tail_vec:
        out = out[..., 0]
    return out


def tensorsolve(a, b, axes=None):
    """``numpy.linalg.tensorsolve``: solve ``a x = b`` with ``a`` reshaped
    to square over the trailing ``x`` dimensions."""
    a, b = _as_tensor(a), _as_tensor(b)
    if axes is not None:
        allaxes = list(range(a.dim()))
        for ax in axes:
            allaxes.remove(ax)
            allaxes.append(ax)
        a = a.permute(allaxes)
    rest = tuple(a.shape[b.dim():])
    prod = math.prod(rest)
    if math.prod(a.shape[: b.dim()]) != prod:
        raise ValueError("tensorsolve: a is not square over x-dims")
    return solve(a.reshape(prod, prod), b.reshape(prod)).reshape(rest)


def tensorinv(a, ind: int = 2):
    """``numpy.linalg.tensorinv``: the inverse under tensordot over the
    first ``ind`` axes."""
    a = _as_tensor(a)
    if ind <= 0:
        raise ValueError("tensorinv: ind must be positive")
    inv_shape = tuple(a.shape[ind:]) + tuple(a.shape[:ind])
    prod = math.prod(a.shape[:ind])
    if math.prod(a.shape[ind:]) != prod:
        raise ValueError("tensorinv: a is not square over ind split")
    return inv(a.reshape(prod, prod)).reshape(inv_shape)
