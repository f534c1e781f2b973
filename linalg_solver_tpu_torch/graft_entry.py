"""The forward step of the flagship batched solve and its example
arguments (counterpart of the JAX package's root ``__graft_entry__.
entry``).

``entry()`` returns ``(forward, (a, b))``: ``forward(a, b)`` is
``dispatch.solve_batched(a, b, backend="auto")``, which takes the fused
solve kernel (``csrc/solve_fused.cu``) at this shape on a CUDA device,
and ``(a, b)`` is a seeded batch of B = 8 systems of N = 64: Gaussian
plus 4√N·I and a Gaussian right-hand side, drawn on a CPU generator and
then moved to the device.  Run it with ``python -m
linalg_solver_tpu_torch.graft_entry``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

#: the batch of the flagship step: B systems of N unknowns
B, N = 8, 64
SEED = 0


def example_args(device: torch.device | str) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``(a [B, N, N], b [B, N])`` f32 on ``device``, from a CPU
    generator seeded ``SEED``."""
    g = torch.Generator().manual_seed(SEED)
    a = torch.randn(B, N, N, generator=g) + 4.0 * N ** 0.5 * torch.eye(N)
    b = torch.randn(B, N, generator=g)
    return a.to(device), b.to(device)


def forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The flagship step: ``dispatch.solve_batched(a, b, "auto")``."""
    from .ops import dispatch

    return dispatch.solve_batched(a, b, backend="auto")


def entry(device: Optional[torch.device | str] = None
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """``(forward, (a, b))`` on ``device``; None means CUDA, which must be
    there (tests pass ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry() runs on a CUDA device and there is "
                               "none; pass device='cpu' for the CPU")
        device = "cuda"
    return forward, example_args(device)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", tuple(out.shape))
