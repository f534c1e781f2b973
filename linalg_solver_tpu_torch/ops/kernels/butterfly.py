"""Two-sided random butterfly in one pass (counterpart of
``linalg_solver_tpu.ops.pallas.butterfly_kernel``).

``butterfly_two_sided`` launches ``csrc/butterfly.cu`` (one thread per
orbit of 2^depth × 2^depth entries, no shared memory) on a CUDA tensor,
and runs ``butterfly_two_sided_reference``, ``rbt.butterfly_apply`` on
the rows and then on the columns, on a CPU tensor.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  ``LAUNCHES`` counts
kernel launches.  Both round every product and sum on their own, so they
agree to the bit.
"""

from __future__ import annotations

import torch

from .. import rbt

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0


def fits(n: int, depth: int) -> bool:
    """Whether the kernel takes ``[B, n, n]`` at ``depth``: every level's
    segments even, i.e. ``n`` a multiple of ``2^depth``."""
    return depth in (1, 2) and n >= (1 << depth) and n % (1 << depth) == 0


def _check(a, diags_rows, diags_cols, depth):
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must be [B, N, N]; got {tuple(a.shape)}")
    n = a.shape[-1]
    if not fits(n, depth):
        raise ValueError(
            f"butterfly_two_sided(depth={depth}) needs depth 1 or 2 and N a "
            f"multiple of 2^depth; got N={n}")
    for name, d in (("diags_rows", diags_rows), ("diags_cols", diags_cols)):
        if d.dim() != 2 or d.shape[0] < depth or d.shape[1] != n:
            raise ValueError(f"{name} must be [>= {depth}, {n}]; got "
                             f"{tuple(d.shape)}")
    if a.is_complex():
        raise TypeError("butterfly_two_sided takes real matrices")
    return a.to(torch.float32)


def butterfly_two_sided(
    a: torch.Tensor,
    diags_rows: torch.Tensor,
    diags_cols: torch.Tensor,
    depth: int,
    trans_rows: bool = True,
    trans_cols: bool = True,
) -> torch.Tensor:
    """``W_rows^(T) · a · W_cols^(T)ᵀ`` on ``a [B, N, N]`` (cast to f32):
    the depth-``depth`` butterfly with ``diags_rows`` (``[>= depth, N]``,
    only the first ``depth`` rows read) along the rows, then the one with
    ``diags_cols`` along the columns; ``trans_*`` picks ``Bᵀ`` on that
    side.  ``(True, True)`` with ``(u, v)`` is the preconditioning
    ``UᵀAV``, ``(False, False)`` with ``(v, u)`` the reconstruction
    ``V X Uᵀ``."""
    a32 = _check(a, diags_rows, diags_cols, depth)
    if a32.is_cuda:
        return _launch(a32, diags_rows, diags_cols, depth, trans_rows,
                       trans_cols)
    if a32.device.type == "cpu":
        return butterfly_two_sided_reference(
            a32, diags_rows, diags_cols, depth, trans_rows, trans_cols)
    raise ValueError(f"butterfly_two_sided: no kernel for {a32.device}")


def _launch(a32, diags_rows, diags_cols, depth, trans_rows, trans_cols):
    global LAUNCHES
    from . import _build

    B, n, _ = a32.shape
    dev = a32.device
    ds = []
    for name, d in (("diags_rows", diags_rows), ("diags_cols", diags_cols)):
        if d.device != dev or d.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 on {dev}; got {d.dtype} on "
                             f"{d.device}")
        ds.append(d[:depth].contiguous())
    a32 = a32.contiguous()
    out = torch.empty_like(a32)
    if B == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.butterfly_two_sided_f32(
            a32.data_ptr(), ds[0].data_ptr(), ds[1].data_ptr(),
            out.data_ptr(), B, n, depth, int(trans_rows), int(trans_cols),
            stream,
        )
    _build.check(err, "butterfly_two_sided launch")
    LAUNCHES += 1
    return out


def butterfly_two_sided_reference(
    a: torch.Tensor,
    diags_rows: torch.Tensor,
    diags_cols: torch.Tensor,
    depth: int,
    trans_rows: bool = True,
    trans_cols: bool = True,
) -> torch.Tensor:
    """Plain-PyTorch version of the kernel: the same contract as
    ``butterfly_two_sided`` on any device."""
    a32 = _check(a, diags_rows, diags_cols, depth)
    x = rbt.butterfly_apply(a32, diags_rows[:depth], trans=trans_rows)
    x = rbt.butterfly_apply(x.transpose(1, 2), diags_cols[:depth],
                            trans=trans_cols)
    return x.transpose(1, 2).contiguous()
