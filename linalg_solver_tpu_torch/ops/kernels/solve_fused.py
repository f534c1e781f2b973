"""The one-launch RBT solve (counterpart of
``linalg_solver_tpu.ops.pallas.solve_fused_kernel``).

``solve_fused_rbt`` launches ``csrc/solve_fused.cu`` on a CUDA tensor,
and runs ``solve_fused_rbt_reference``, the same math in plain PyTorch
vectorised over the batch, on a CPU tensor.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  The kernel has
variants chosen by shape alone (``variant``): for 96 ≤ N ≤ 256, A' stays
on the chip from load to solution, in one thread block a system where
its columns and vectors fit the block's shared memory (1), else, for
k ≤ 4, in a cluster of two blocks a system that read each other's shared
memory (2); elsewhere one block a system with A' in a device-memory
scratch (0), which sets the reach (``fits``).  Each on-chip variant
takes the shapes where it beat variant 0 on an H100.  ``LAUNCHES`` counts kernel launches of every
variant.

The per-system flags ``bad`` have the TPU kernel's semantics: a system
is flagged when a pivot of the butterflied matrix is zero (or NaN), when
the last refinement correction exceeds 0.3·max|x|, or (``ir_steps`` ≥ 2)
when the last residual exceeds 1e-4·max(|b|, |A|·|x|); with
``ir_steps=0`` only the loose 1e-2 residual gate applies.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import rbt
from ...utils.precision import f32_matmuls

#: max matrix-RHS columns that share one factorization
MAX_K_RHS = 8

#: shared memory a thread block may use on sm_90 (bytes)
_MAX_SMEM = 232448

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

_NB, _NWARP = 32, 8   # csrc/solve_fused.cu's panel width and warps
#: its on-chip variants' warps, N range and the cluster's most RHS columns
_OC_NWARP, _OC_MIN_N, _OC_MAX_N, _OC_CLUSTER_MAX_K = 16, 96, 256, 4


def smem_bytes(n: int, k: int) -> int:
    """Shared memory the kernel takes for (n, k), in bytes: the mirror of
    ``smem_floats`` in ``csrc/solve_fused.cu`` (panel P and U12, two
    diagonal pairs, four k·n vectors, ipiv, reduction slots)."""
    return 4 * (max(2 * _NB * n, 32 * 33) + 4 * n + 4 * k * n + n + _NWARP)


def fits(n: int, k: int) -> bool:
    """Whether the kernel takes N=n with k RHS columns on sm_90."""
    return n % 2 == 0 and 1 <= k <= MAX_K_RHS and smem_bytes(n, k) <= _MAX_SMEM


def onchip_smem_bytes(n: int, k: int, blocks: int) -> int:
    """Shared memory a block of the on-chip variant with ``blocks`` blocks
    a system takes, in bytes: the mirror of ``onchip_smem_floats`` in
    ``csrc/solve_fused.cu`` (the block's whole panels of A' with column
    stride n + 1, a copy of a peer's panel, the diagonals, four k·n
    vectors, ipiv, the slots)."""
    ld = n + 1
    panels = -(-n // _NB)
    cols = _NB * -(-panels // blocks)
    return 4 * (cols * ld + (_NB * ld if blocks > 1 else 0)
                + 4 * n + 4 * k * n + n + _OC_NWARP + 4)


def variant(n: int, k: int) -> int:
    """The variant that takes (n, k): the mirror of ``solve_variant`` in
    ``csrc/solve_fused.cu`` (1: one block a system where that layout fits
    a block's shared memory, 2: two for k <= 4, both for even
    96 <= N <= 256; else 0)."""
    if n % 2 or not _OC_MIN_N <= n <= _OC_MAX_N or not 1 <= k <= MAX_K_RHS:
        return 0
    if onchip_smem_bytes(n, k, 1) <= _MAX_SMEM:
        return 1
    if k <= _OC_CLUSTER_MAX_K and onchip_smem_bytes(n, k, 2) <= _MAX_SMEM:
        return 2
    return 0


def attributes(n: int, k: int) -> dict:
    """Registers, spill bytes and resident blocks an SM of the variant
    that takes (n, k) (on a machine with the card)."""
    from . import _build

    v = variant(n, k)
    return {"variant": v, **_build.attributes("solve_attributes", v, n, k)}


def _prepare(a: torch.Tensor, b: torch.Tensor):
    """Validate shapes and cast to f32; ``b`` becomes ``[B, N, k]``."""
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must be [B, N, N]; got {tuple(a.shape)}")
    B, N, _ = a.shape
    matrix_rhs = b.dim() == 3
    if b.shape[:2] != (B, N) or b.dim() not in (2, 3):
        raise ValueError(
            f"b must be [B, N] or [B, N, k] for a {tuple(a.shape)}; got "
            f"{tuple(b.shape)}"
        )
    k = b.shape[-1] if matrix_rhs else 1
    if not 1 <= k <= MAX_K_RHS:
        raise ValueError(f"k={k} RHS columns; the kernel takes 1..{MAX_K_RHS}")
    if N % 2:
        raise ValueError(f"N={N}: butterfly segments need an even N")
    if a.is_complex() or b.is_complex():
        raise TypeError("solve_fused_rbt takes real matrices")
    a32 = a.to(torch.float32)
    b3 = (b if matrix_rhs else b.unsqueeze(-1)).to(torch.float32)
    return a32, b3, matrix_rhs


def solve_fused_rbt(
    a: torch.Tensor,
    b: torch.Tensor,
    diags_u: torch.Tensor,
    diags_v: torch.Tensor,
    ir_steps: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-launch RBT solve of ``a @ x = b``.

    ``a`` is ``[B, N, N]`` (N even), ``b`` is ``[B, N]`` or
    ``[B, N, k ≤ MAX_K_RHS]``; other real dtypes are cast to f32.
    ``diags_u`` / ``diags_v`` are the ``[2, N]`` butterfly diagonals;
    the depth is the largest ≤ 2 whose segments stay even, and a level
    beyond it is not read.  Returns ``(x, bad)`` with ``x`` shaped like
    ``b`` and ``bad`` a ``[B]`` bool tensor."""
    a32, b3, matrix_rhs = _prepare(a, b)
    if a32.is_cuda:
        x, bad = _launch(a32, b3, diags_u, diags_v, ir_steps)
    elif a32.device.type == "cpu":
        x, bad = solve_fused_rbt_reference(a32, b3, diags_u, diags_v, ir_steps)
    else:
        raise ValueError(f"solve_fused_rbt: no kernel for {a32.device}")
    return (x if matrix_rhs else x.squeeze(-1)), bad


def _launch(a32, b3, diags_u, diags_v, ir_steps):
    global LAUNCHES
    from . import _build

    B, N, _ = a32.shape
    k = b3.shape[-1]
    dev = a32.device
    tensors = {"b": b3, "diags_u": diags_u, "diags_v": diags_v}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
    for name in ("diags_u", "diags_v"):
        t = tensors[name]
        if t.dtype != torch.float32 or tuple(t.shape) != (2, N):
            raise ValueError(
                f"{name} must be f32 [2, {N}]; got {t.dtype} {tuple(t.shape)}"
            )
    if ir_steps < 0:
        raise ValueError(f"ir_steps must be >= 0, got {ir_steps}")
    lib = _build.load()
    smem = lib.solve_fused_smem_bytes(N, k)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"N={N}, k={k} needs {smem} bytes of shared memory per block; "
            f"the kernel has {_MAX_SMEM}"
        )
    a32 = a32.contiguous()
    b3 = b3.contiguous()
    du = diags_u.contiguous()
    dv = diags_v.contiguous()
    x = torch.empty_like(b3)
    bad = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return x, bad
    # variant 0's column-major working copy of U^T A V; the on-chip
    # variants keep it in shared memory
    work = torch.empty_like(a32) if lib.solve_variant(N, k) == 0 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.solve_fused_rbt_f32(
            a32.data_ptr(), b3.data_ptr(), du.data_ptr(), dv.data_ptr(),
            None if work is None else work.data_ptr(), x.data_ptr(),
            bad.data_ptr(), B, N, k, rbt.shrink_depth(N), ir_steps, stream,
        )
    _build.check(err, "solve_fused_rbt launch")
    LAUNCHES += 1
    return x, bad


def _lu_nopivot(w: torch.Tensor):
    """Right-looking rank-1 LU of ``w [B, N, N]`` in place, pivot(c) =
    row c, with the kernel's zero-pivot rule.  Returns (w, ipiv, ok)."""
    B, n, _ = w.shape
    ipiv = torch.empty(B, n, dtype=w.dtype, device=w.device)
    ok = torch.ones(B, dtype=w.dtype, device=w.device)
    for c in range(n):
        pv = w[:, c, c]
        has = (pv.abs() > 0).to(w.dtype)
        inv = 1.0 / (pv + (1.0 - has))
        ok = ok * has
        ipiv[:, c] = inv
        fm = w[:, c + 1:, c] * inv[:, None]
        w[:, c + 1:, c] = fm
        w[:, c + 1:, c + 1:] -= fm[:, :, None] * w[:, c, None, c + 1:]
    return w, ipiv, ok


def _forward(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y := L⁻¹ y for ``y [B, N, k]`` (L unit lower in ``w``)."""
    y = y.clone()
    for c in range(w.shape[1] - 1):
        y[:, c + 1:, :] -= w[:, c + 1:, c, None] * y[:, c, None, :]
    return y


def _backward(w: torch.Tensor, ipiv: torch.Tensor, y: torch.Tensor):
    """y := U⁻¹ y (U upper in ``w``, reciprocal diagonal ``ipiv``)."""
    y = y.clone()
    for c in range(w.shape[1] - 1, -1, -1):
        xc = y[:, c, :] * ipiv[:, c, None]
        y[:, c, :] = xc
        if c:
            y[:, :c, :] -= w[:, :c, c, None] * xc[:, None, :]
    return y


def solve_fused_rbt_reference(
    a: torch.Tensor,
    b: torch.Tensor,
    diags_u: torch.Tensor,
    diags_v: torch.Tensor,
    ir_steps: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the kernel, vectorised over the batch:
    the same contract as ``solve_fused_rbt`` on any device."""
    a32, b3, matrix_rhs = _prepare(a, b)
    n = a32.shape[-1]
    d = rbt.shrink_depth(n)
    du, dv = diags_u[:d], diags_v[:d]

    amax = a32.abs().amax(dim=(1, 2))
    bmax = b3.abs().amax(dim=(1, 2))
    # A' = Uᵀ A V ; b' = Uᵀ b
    w = rbt.butterfly_apply(a32, du, trans=True)
    w = rbt.butterfly_apply(w.transpose(1, 2), dv, trans=True)
    w = w.transpose(1, 2).contiguous()
    w, ipiv, ok = _lu_nopivot(w)

    def solve(v):
        v = rbt.butterfly_apply(v, du, trans=True)
        v = _backward(w, ipiv, _forward(w, v))
        return rbt.butterfly_apply(v, dv, trans=False)

    def absmax(t):
        return t.abs().amax(dim=(1, 2))

    x = solve(b3)
    rmax = xmax = zcmax = None
    for step in range(ir_steps):
        with f32_matmuls():
            resid = b3 - a32 @ x
        if step == ir_steps - 1:
            rmax, xmax = absmax(resid), absmax(x)
        zc = solve(resid)
        if step == ir_steps - 1:
            zcmax = absmax(zc)
        x = x + zc

    bad = rbt.refinement_gate(ok < 0.5, ir_steps, a32, b3, x, amax, bmax,
                              rmax, xmax, zcmax)
    return (x if matrix_rhs else x.squeeze(-1)), bad
