"""Matmul precision control (counterpart of ``linalg_solver_tpu.utils.precision``).

On an H100, a float32 matrix product may run in TF32 (about three
decimal digits) when ``torch.backends.cuda.matmul.allow_tf32`` is set or
the float32 matmul precision is "high"/"medium"; cuDNN uses TF32 by
default.  A refinement residual computed that way stalls near 1e-3, so
every residual product of the numerical cores runs under
``f32_matmuls``, which pins full float32 and restores the caller's
settings afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmuls():
    """Context manager (and, called, a decorator: ``@f32_matmuls()``)
    that runs its body with TF32 off and float32 matmul precision
    "highest"."""
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
