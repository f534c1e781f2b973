"""Panel LU without a pivot search (counterpart of
``linalg_solver_tpu.ops.pallas.lu_nopivot_kernel``).

``panel_factor_nopivot`` launches ``csrc/lu_nopivot.cu`` (one thread
block per panel) on a CUDA tensor, and runs
``panel_factor_nopivot_reference``, the same steps in plain PyTorch
vectorised over the batch, on a CPU tensor.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  The kernel has
variants chosen by shape alone (``variant``): the panel in registers at
``nb = 32`` and ``nb = 64`` up to ``M = 256``, a warp owning whole
columns with the rows on its lanes and one barrier a step; else the
whole panel in shared memory,
which sets the reach (``fits``).  ``LAUNCHES`` counts kernel launches of
every variant.

Step ``c`` takes row ``c`` as the pivot and applies the TPU kernel's
zero-pivot rule formula for formula: the pivot read as a one-hot sum
``pv = Σ_r col[r]·(r == c)`` (NaN as soon as any entry of the column is
Inf or NaN), ``has = |pv| > 0``, ``inv = 1/(pv + (1 − has))``,
multipliers ``f = col·inv·below·has``, the rank-1 update ``a[:, h] −= f ·
a[c, h]`` on every column ``h > c`` (one rounding, ``gauss_jordan.fms``;
``fmaf`` on the card), and the stored column ``f + col·(1 − below)``.  A
NaN pivot counts as zero and is flagged; its NaN still spreads.

Not ported: the ``lookahead`` / ``group`` / ``chunk_w`` folding of
several steps into one pass, which is Mosaic scheduling (it changes the
rounding of the trailing update, not the math), and the batch padding to
128 lanes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import gauss_jordan as gj

#: shared memory a thread block may use on sm_90 (bytes)
_MAX_SMEM = 232448

#: csrc/lu_nopivot.cu's variants by number: (nb, most rows), None for the
#: shared-memory one
VARIANTS = {0: None, 1: (32, 256), 2: (64, 256)}

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0


def smem_bytes(m: int, nb: int) -> int:
    """Shared memory the kernel takes for an ``[m, nb]`` panel, in bytes:
    the mirror of ``nopivot_smem_floats`` in ``csrc/lu_nopivot.cu`` (the
    panel with column stride m + 1, and the staged pivot row)."""
    return 4 * (nb * (m + 1) + nb)


def fits(m: int, nb: int) -> bool:
    """Whether the kernel takes an ``[m, nb]`` panel (``m >= nb``)."""
    return 1 <= nb <= m and smem_bytes(m, nb) <= _MAX_SMEM


def variant(m: int, nb: int) -> int:
    """The variant that takes an ``[m, nb]`` panel: the mirror of
    ``nopivot_variant`` in ``csrc/lu_nopivot.cu`` (the register variant of
    that ``nb`` where it has a row for each of the ``m`` rows, else 0, the
    shared-memory one)."""
    for v, shape in VARIANTS.items():
        if shape is not None and shape[0] == nb and m <= shape[1]:
            return v
    return 0


def attributes(m: int, nb: int) -> dict:
    """Registers, spill bytes and resident blocks an SM of the variant
    that takes ``[m, nb]`` (on a machine with the card)."""
    from . import _build

    v = variant(m, nb)
    return {"variant": v,
            **_build.attributes("nopivot_attributes", v, m, nb)}


def _check(panel: torch.Tensor, nb: int) -> torch.Tensor:
    if panel.dim() != 3 or panel.shape[2] != nb or panel.shape[1] < nb:
        raise ValueError(
            f"panel must be [B, M >= nb, nb] with nb={nb}; got "
            f"{tuple(panel.shape)}")
    if panel.is_complex():
        raise TypeError("panel_factor_nopivot takes real panels")
    return panel.to(torch.float32)


def panel_factor_nopivot(
    panel: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor every ``[M, nb]`` panel of ``panel [B, M, nb]`` (cast to
    f32) with pivot(c) = row c.  Returns ``(panel_u, ok)``: ``panel_u``
    holds the multipliers strictly below the diagonal (rows ≥ nb: the L21
    block) and U on and above it; ``ok [B]`` is False where a pivot was
    zero or NaN."""
    p32 = _check(panel, nb)
    if p32.is_cuda:
        return _launch(p32, nb)
    if p32.device.type == "cpu":
        return panel_factor_nopivot_reference(p32, nb)
    raise ValueError(f"panel_factor_nopivot: no kernel for {p32.device}")


def _launch(p32: torch.Tensor, nb: int):
    global LAUNCHES
    from . import _build

    B, m, _ = p32.shape
    dev = p32.device
    lib = _build.load()
    smem = lib.nopivot_smem_bytes(m, nb)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"[{m}, {nb}] needs {smem} bytes of shared memory per block; the "
            f"kernel has {_MAX_SMEM}")
    p32 = p32.contiguous()
    out = torch.empty_like(p32)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out, ok
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lu_nopivot_f32(p32.data_ptr(), out.data_ptr(),
                                 ok.data_ptr(), B, m, nb, stream)
    _build.check(err, "panel_factor_nopivot launch")
    LAUNCHES += 1
    return out, ok


def panel_factor_nopivot_reference(
    panel: torch.Tensor, nb: int, one_hot: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the kernel, vectorised over the batch:
    the same contract as ``panel_factor_nopivot`` on any device.
    ``one_hot=False`` reads the pivot directly instead of as the one-hot
    sum (NaN when another entry of its column is not finite): a version
    without the TPU kernel's rule, for checks that must tell the two
    apart."""
    p = _check(panel, nb).clone()
    B, m, _ = p.shape
    rows = torch.arange(m, device=p.device)
    ok = torch.ones(B, dtype=torch.bool, device=p.device)
    for c in range(nb):
        col = p[:, :, c].clone()
        if one_hot:
            pv = (col * (rows == c).to(torch.float32)).sum(dim=1)
        else:
            pv = col[:, c]
        has = (pv.abs() > 0).to(torch.float32)
        inv = 1.0 / (pv + (1.0 - has))
        below = (rows > c).to(torch.float32)
        f = col * inv[:, None] * below * has[:, None]
        if c + 1 < nb:
            p[:, :, c + 1:] = gj.fms(p[:, :, c + 1:], f[:, :, None],
                                     p[:, c, None, c + 1:])
        p[:, :, c] = f + col * (1.0 - below)
        ok = ok & (has > 0)
    return p, ok
