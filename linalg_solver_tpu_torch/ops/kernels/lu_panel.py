"""Partial-pivot panel LU without row swaps (counterpart of
``linalg_solver_tpu.ops.pallas.lu_panel_kernel``).

``panel_factor_masked`` launches ``csrc/lu_panel.cu`` (one thread block
per panel) on a CUDA tensor, and runs ``panel_factor_masked_reference``,
the same steps in plain PyTorch vectorised over the batch, on a CPU
tensor.  On a CUDA tensor it launches the kernel or raises; it never
falls back.  The kernel has variants chosen by shape alone
(``variant``): the panel in registers at ``nb = 32`` up to ``N = 1024``
and ``nb = 64`` up to ``N = 256``, a warp owning whole columns with the
rows on its lanes and one barrier a step; else the whole panel in shared
memory, which sets the reach (``fits``).  ``LAUNCHES`` counts kernel
launches of every variant.

Step ``c`` takes as pivot the first row of largest ``|a[:, c]|`` among
the rows not pivoted yet (rows marked in ``pivoted`` by earlier panels
never are; a NaN counts as the largest, as in ``jnp.argmax``), and
applies the TPU kernel's formulas one for one: the pivot value and the
pivot row read as one-hot sums (NaN as soon as another entry of their
column is Inf or NaN), ``has = max|unpivoted| > 0``, ``inv = 1/(pv + (1
− has))``, multipliers ``f = col·inv·elim`` on the other unpivoted rows,
the rank-1 update ``a[:, h] −= f · prow[h]`` on every column ``h > c``
(one rounding, ``gauss_jordan.fms``; ``fmaf`` on the card), and the
stored column ``elim·f + (1 − elim)·col``.  ``piv_row[c] = p`` is
recorded even where ``has`` is 0, as the TPU kernel records it.

Not ported: the ``lookahead`` fold of two steps into one pass over the
live columns, which is Mosaic scheduling (on finite panels the fold
rounds exactly as the sequential steps do), and the batch padding to
128 lanes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import gauss_jordan as gj

#: shared memory a thread block may use on sm_90 (bytes)
_MAX_SMEM = 232448

#: the shared-memory variant's threads per block (8 warps)
_NWARP = 8

#: csrc/lu_panel.cu's variants by number: (nb, most rows, which is also
#: the threads of a block), None for the shared-memory one
VARIANTS = {0: None, 1: (32, 1024), 2: (64, 256)}

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0


def smem_bytes(n: int, nb: int) -> int:
    """Shared memory the kernel takes for an ``[n, nb]`` panel, in bytes:
    the mirror of ``panel_smem_floats`` in ``csrc/lu_panel.cu`` (the panel
    with column stride n + 1, the staged pivot row, two per-column counts
    of non-finite entries, the per-row pivot state and the argmax
    slots)."""
    return 4 * (nb * (n + 4) + n + 2 * _NWARP)


def fits(n: int, nb: int) -> bool:
    """Whether the kernel takes an ``[n, nb]`` panel (``nb`` even, at
    most ``n``)."""
    return n >= nb >= 2 and nb % 2 == 0 and smem_bytes(n, nb) <= _MAX_SMEM


def variant(n: int, nb: int) -> int:
    """The variant that takes an ``[n, nb]`` panel: the mirror of
    ``panel_variant`` in ``csrc/lu_panel.cu`` (the register variant of
    that ``nb`` where it has a row for each of the ``n`` rows, else 0,
    the shared-memory one)."""
    for v, shape in VARIANTS.items():
        if shape is not None and shape[0] == nb and n <= shape[1]:
            return v
    return 0


def attributes(n: int, nb: int) -> dict:
    """Registers, spill bytes and resident blocks an SM of the variant
    that takes ``[n, nb]`` (on a machine with the card)."""
    from . import _build

    v = variant(n, nb)
    return {"variant": v, **_build.attributes("panel_attributes", v, n, nb)}


def _check(panel: torch.Tensor, pivoted: torch.Tensor, nb: int):
    if nb < 2 or nb % 2:
        raise ValueError(f"the panel kernel needs an even nb >= 2, got {nb}")
    if panel.dim() != 3 or panel.shape[2] != nb:
        raise ValueError(f"panel must be [B, N, nb] with nb={nb}; got "
                         f"{tuple(panel.shape)}")
    if panel.shape[1] < nb:
        # a step c >= N could record c = N, the row state's "not pivoted"
        raise ValueError(f"the panel kernel needs N >= nb; got "
                         f"{tuple(panel.shape)}")
    if tuple(pivoted.shape) != tuple(panel.shape[:2]):
        raise ValueError(f"pivoted must be {tuple(panel.shape[:2])}; got "
                         f"{tuple(pivoted.shape)}")
    if panel.is_complex():
        raise TypeError("panel_factor_masked takes real panels")
    return (panel.to(torch.float32),
            pivoted.to(device=panel.device, dtype=torch.int32))


def panel_factor_masked(
    panel: torch.Tensor, pivoted: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, ...]:
    """Factor every ``[N, nb]`` panel of ``panel [B, N, nb]`` (cast to
    f32) in place, skipping the rows marked in ``pivoted [B, N]`` (0/1:
    finished U rows of earlier panels).  Rows are not reordered.

    Returns ``(panel_u, piv_step, piv_row, pivoted_out, ok)``: the
    eliminated panel in the original row order; the step at which each
    row was pivoted by this panel, int32 ``[B, N]`` (``N`` where not); the
    pivot row of each step, int32 ``[B, nb]``; the updated mask, int32
    ``[B, N]``; and ``ok [B]``, False where a step found no nonzero
    pivot."""
    p32, m32 = _check(panel, pivoted, nb)
    if p32.is_cuda:
        return _launch(p32, m32, nb)
    if p32.device.type == "cpu":
        return panel_factor_masked_reference(p32, m32, nb)
    raise ValueError(f"panel_factor_masked: no kernel for {p32.device}")


def _launch(p32: torch.Tensor, m32: torch.Tensor, nb: int):
    global LAUNCHES
    from . import _build

    B, n, _ = p32.shape
    dev = p32.device
    lib = _build.load()
    smem = lib.panel_smem_bytes(n, nb)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"[{n}, {nb}] needs {smem} bytes of shared memory per block; the "
            f"kernel has {_MAX_SMEM}")
    p32, m32 = p32.contiguous(), m32.contiguous()
    out = torch.empty_like(p32)
    piv_step = torch.empty(B, n, dtype=torch.int32, device=dev)
    piv_row = torch.empty(B, nb, dtype=torch.int32, device=dev)
    mask = torch.empty(B, n, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out, piv_step, piv_row, mask, ok
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lu_panel_f32(
            p32.data_ptr(), m32.data_ptr(), out.data_ptr(),
            piv_step.data_ptr(), piv_row.data_ptr(), mask.data_ptr(),
            ok.data_ptr(), B, n, nb, stream)
    _build.check(err, "panel_factor_masked launch")
    LAUNCHES += 1
    return out, piv_step, piv_row, mask, ok


def panel_factor_masked_reference(
    panel: torch.Tensor, pivoted: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, ...]:
    """Plain-PyTorch version of the kernel, vectorised over the batch:
    the same contract as ``panel_factor_masked`` on any device."""
    p32, m32 = _check(panel, pivoted, nb)
    p = p32.clone()
    B, n, _ = p.shape
    dev = p.device
    rows = torch.arange(n, device=dev)
    piv = m32 > 0
    piv_step = torch.full((B, n), n, dtype=torch.int32, device=dev)
    piv_row = torch.zeros(B, nb, dtype=torch.int32, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    for c in range(nb):
        col = p[:, :, c].clone()
        masked = torch.where(piv, -torch.inf, col.abs())
        pr = gj._first_argmax(masked)
        has = masked.amax(dim=1) > 0
        oh = rows[None, :] == pr[:, None]
        ohf = oh.to(torch.float32)
        pv = (col * ohf).sum(dim=1)
        inv = 1.0 / (pv + (1.0 - has.to(torch.float32)))
        elim = (~piv & ~oh & has[:, None]).to(torch.float32)
        f = col * inv[:, None] * elim
        if c + 1 < nb:
            prow = (p[:, :, c + 1:] * ohf[:, :, None]).sum(dim=1)
            p[:, :, c + 1:] = gj.fms(p[:, :, c + 1:], f[:, :, None],
                                     prow[:, None, :])
        p[:, :, c] = elim * f + (1.0 - elim) * col
        newly = oh & has[:, None]
        piv = piv | newly
        piv_step = torch.where(newly, torch.tensor(c, dtype=torch.int32,
                                                   device=dev), piv_step)
        piv_row[:, c] = pr.to(torch.int32)
        ok = ok & has
    return p, piv_step, piv_row, piv.to(torch.int32), ok
