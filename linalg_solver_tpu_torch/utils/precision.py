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


#: the JAX package's ``factor_precision`` names: "float32" runs a product
#: in full float32, "bfloat16" in the card's reduced-precision float32
#: product, TF32 (on the TPU, bf16 passes)
FACTOR_PRECISIONS = ("float32", "bfloat16")


@contextlib.contextmanager
def _matmuls(tf32: bool):
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32_matmuls():
    """Context manager (and, called, a decorator: ``@f32_matmuls()``)
    that runs its body with TF32 off and float32 matmul precision
    "highest"."""
    return _matmuls(False)


def factor_matmuls(precision: str):
    """Context manager for the products of a factorization at the JAX
    package's ``factor_precision``: ``"float32"`` is ``f32_matmuls``,
    ``"bfloat16"`` turns TF32 on.  Products on the CPU are full float32
    either way."""
    if precision not in FACTOR_PRECISIONS:
        raise ValueError(
            f"factor_precision {precision!r}; one of {FACTOR_PRECISIONS}")
    return _matmuls(precision == "bfloat16")
