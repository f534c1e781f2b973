"""Random starts of the port's power iterations (``ops.ordschur``'s sep
estimate, ``ops.pseudospectra``'s inverse iteration, ``ops.funm``'s
``expm_cond_batched``).

The reference draws each from ``jax.random`` with ``PRNGKey(0)``; the port
takes the start as an optional argument, else draws it from a
``torch.Generator`` (by default one on the input's device, seeded
``SEED``).  The two libraries give different numbers from one seed, so a
caller that wants the reference's start hands over its draw as a numpy
array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: seed of the default generator
SEED = 0


def start(shape, dtype, device, given=None,
          generator: Optional[torch.Generator] = None, parts: int = 1):
    """A power iteration's random start as ``parts`` tensors of ``shape``
    in ``dtype`` on ``device`` (the real and imaginary parts of a complex
    start: ``parts=2``): the ``given`` ones (a tuple of ``parts`` numpy
    arrays or tensors, or one where ``parts`` is 1), else ``parts``
    standard normal draws in turn on ``generator`` (default: one on
    ``device`` seeded ``SEED``, so the draw stays on the device)."""
    if given is not None:
        given = (given,) if parts == 1 else tuple(given)
        return tuple(
            (g if isinstance(g, torch.Tensor) else torch.from_numpy(
                np.array(g))).to(device=device, dtype=dtype) for g in given)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(SEED)
    return tuple(torch.randn(shape, generator=generator, dtype=dtype,
                             device=generator.device).to(device)
                 for _ in range(parts))
