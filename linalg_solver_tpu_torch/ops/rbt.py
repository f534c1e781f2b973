"""Random-butterfly-preconditioned pivot-free LU solve
(counterpart of ``linalg_solver_tpu.ops.rbt``).

``A' = Uᵀ A V`` with depth-≤2 random butterflies (Parker's
construction) makes LU without pivoting stable for generic input with
probability ~1.  The solve itself is one launch of the fused kernel
(``ops.kernels.solve_fused``); refinement runs against the original
system, and a per-system gate sends the systems the probabilistic
argument fails to a rescue: the same kernel with a second butterfly
draw, then the pivoted ``lu_blocked.blocked_solve_batched``.

Butterfly diagonals are ``[depth, N]`` tensors (``rbt_diags``) or, as
the kernel takes them, ``[2, N]`` (``pad_diags``).  They are drawn on a
CPU ``torch.Generator`` so the draw does not depend on the device, and
every entry point takes them as an argument so that tests can feed the
JAX package's draw (``diags_from_numpy``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .lu_blocked import blocked_solve_batched

_SQRT_HALF = 0.7071067811865476

#: generator seeds of the main draw (U, V) and of the rescue redraw;
#: the JAX package uses the same numbers as PRNG keys
MAIN_SEEDS = (17, 29)
RESCUE_SEEDS = (101, 103)


def shrink_depth(n: int) -> int:
    """Largest butterfly depth ≤ 2 whose segments stay even for ``n``."""
    d = 2
    while d > 1 and (n >> (d - 1)) % 2:
        d -= 1
    return d


def rbt_diags(
    n: int, depth: int, generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Per-level butterfly diagonals, ``[depth, n]`` f32 with entries
    ``exp(r/10)``, r ~ U(−1, 1), drawn on ``generator`` (a CPU
    generator) and then moved to ``device``."""
    r = torch.rand((depth, n), generator=generator, dtype=torch.float32)
    return torch.exp((2.0 * r - 1.0) / 10.0).to(device)


def pad_diags(diags: torch.Tensor) -> torch.Tensor:
    """``[depth, n]`` → ``[2, n]``: level 1 all ones at depth 1 (the
    kernel reads only the first ``depth`` levels), as ``diags_lanes``
    does without its 128-lane broadcast."""
    if diags.shape[0] == 1:
        return torch.cat([diags, torch.ones_like(diags)], dim=0)
    return diags


def diags_from_numpy(
    du_levels: Sequence[np.ndarray], dv_levels: Sequence[np.ndarray],
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's per-level diagonals (``rbt_diags(key, n, d)``
    as numpy arrays) → the port's ``[2, n]`` (U, V) tensors."""
    def conv(levels):
        stacked = np.stack([np.asarray(v, np.float32) for v in levels])
        return pad_diags(torch.from_numpy(stacked)).to(device)

    return conv(du_levels), conv(dv_levels)


@functools.lru_cache(maxsize=16)
def default_diags(
    n: int, seeds: Tuple[int, int], device: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The seeded (U, V) draw at depth ``shrink_depth(n)``, ``[2, n]``
    each.  Cached: a draw costs a host-to-device copy, and callers never
    write to the returned tensors."""
    d = shrink_depth(n)
    return tuple(
        pad_diags(rbt_diags(n, d, torch.Generator().manual_seed(s), device))
        for s in seeds
    )


#: generator seed of the inverse's Rademacher probe (a PRNG key in the
#: JAX package, as the butterfly seeds are)
PROBE_SEED = 83


@functools.lru_cache(maxsize=16)
def default_probe(n: int, device: str) -> torch.Tensor:
    """The seeded Rademacher probe of the inverse's gate: ``[n]`` f32 of
    ±1 drawn on a CPU generator seeded ``PROBE_SEED``, moved to
    ``device``.  Cached like ``default_diags``."""
    g = torch.Generator().manual_seed(PROBE_SEED)
    bits = torch.randint(0, 2, (n,), generator=g, dtype=torch.int64)
    return (2.0 * bits - 1.0).to(torch.float32).to(device)


def probe_from_numpy(
    v: np.ndarray, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """The JAX package's probe (``jax.random.rademacher`` as a numpy
    array) → the port's ``[n]`` f32 tensor."""
    return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)


def _bf_level(x: torch.Tensor, r: torch.Tensor, seg: int, trans: bool):
    """One butterfly level along axis 1 of ``x [B, N, K]``: block-diag of
    ``N/seg`` butterflies ``(1/√2)[[R0, R1], [R0, −R1]]`` with per-level
    diagonal ``r [N]``; ``trans`` applies the transpose."""
    B, n, K = x.shape
    h = seg // 2
    xs = x.reshape(B, n // seg, 2, h, K)
    rs = r.reshape(n // seg, 2, h)[None, :, :, :, None]
    top, bot = xs[:, :, 0], xs[:, :, 1]
    r0, r1 = rs[:, :, 0], rs[:, :, 1]
    if trans:
        out_top = r0 * (top + bot)
        out_bot = r1 * (top - bot)
    else:
        out_top = r0 * top + r1 * bot
        out_bot = r0 * top - r1 * bot
    out = torch.stack([out_top, out_bot], dim=2) * _SQRT_HALF
    return out.reshape(B, n, K)


def butterfly_apply(
    x: torch.Tensor, diags, trans: bool = False
) -> torch.Tensor:
    """Apply the depth-d butterfly ``W`` (or ``Wᵀ``) along axis 1 of
    ``[B, N, K]``; ``diags`` holds exactly d levels.  ``trans`` applies
    levels 0..d-1, otherwise d-1..0."""
    n = x.shape[1]
    levels = list(range(len(diags)))
    if not trans:
        levels = levels[::-1]
    for lvl in levels:
        x = _bf_level(x, diags[lvl], n >> lvl, trans)
    return x


def _compacted_rescue(
    a32: torch.Tensor, b3: torch.Tensor, x: torch.Tensor,
    bad: torch.Tensor, rescue_diags: Optional[Tuple[torch.Tensor, ...]],
    ir_steps: int,
) -> torch.Tensor:
    """Re-solve exactly the flagged systems: gather them, rerun the fused
    kernel with the rescue draw, send the ones that fail again to the
    pivoted solve, and write the results back.

    The decision reads one scalar to the host (``int(bad.sum())``): on
    CUDA that waits for the kernel.  It is the one host read of a clean
    call; moving the decision into the kernel is on the roadmap."""
    from .kernels.solve_fused import solve_fused_rbt

    if int(bad.sum()) == 0:
        return x
    if rescue_diags is None:
        rescue_diags = default_diags(
            a32.shape[-1], RESCUE_SEEDS, str(a32.device)
        )
    idx = torch.nonzero(bad).squeeze(1)
    a_sub = a32.index_select(0, idx)
    b_sub = b3.index_select(0, idx)
    y, bad2 = solve_fused_rbt(a_sub, b_sub, *rescue_diags, ir_steps=ir_steps)
    idx2 = torch.nonzero(bad2).squeeze(1)
    if idx2.numel():
        yp = blocked_solve_batched(
            a_sub.index_select(0, idx2), b_sub.index_select(0, idx2),
            ir_steps=2,
        )
        y = y.index_copy(0, idx2, yp)
    return x.index_copy(0, idx, y)


def solve_rbt_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    ir_steps: int = 2,
    diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rescue_diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Solve ``a @ x = b`` for ``a [B, N, N]`` and ``b [B, N]`` or
    ``[B, N, k ≤ 8]`` (N even) by the fused RBT kernel with the
    lane-compacted rescue; the counterpart of the ``engine="fused"``
    branch of ``pallas_solve_rbt_batched``.

    ``diags`` / ``rescue_diags`` are ``[2, N]`` (U, V) pairs; by default
    the seeded draws ``MAIN_SEEDS`` / ``RESCUE_SEEDS``.  Matrix RHS stays
    ``[B, N, k]`` throughout."""
    from .kernels.solve_fused import solve_fused_rbt

    n = a.shape[-1]
    if diags is None:
        diags = default_diags(n, MAIN_SEEDS, str(a.device))
    vector_input = b.dim() == 2
    b3 = b.unsqueeze(-1) if vector_input else b
    a32 = a.to(torch.float32).contiguous()
    b3 = b3.to(torch.float32).contiguous()
    x, bad = solve_fused_rbt(a32, b3, *diags, ir_steps=ir_steps)
    x = _compacted_rescue(a32, b3, x, bad, rescue_diags, ir_steps)
    return x.squeeze(-1) if vector_input else x
