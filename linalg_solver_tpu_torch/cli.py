"""Command-line driver (counterpart of ``linalg_solver_tpu.cli``): runs the
six showcase workloads and writes the accumulated LaTeX derivation to
``output.tex`` (compilable inside ``docs/res.tex``).

The sections: determinant of a sparse 6x6, inverse of a regular 3x3, a
linear system, eigenvalues of a diagonalizable 3x3, diagonalization, and
the kernel of a rank-deficient 3x4, all over exact ``Fraction``s with a
fixed seed.  For the same ``--seed`` the file is byte for byte the JAX
package's.

``--device`` also runs the batched numeric path on the GPU (a CUDA device;
it raises where there is none) and replays its recorded pivot events into
the same document.  Its text names the device where the JAX package's says
``TPU``.
"""

from __future__ import annotations

import argparse
import random
from fractions import Fraction

from .exact.matrix import Matrix
from .exact.random_matrix import (
    RandomMatrixBuilder,
    gen_diagonalizable_matrix,
    gen_matrix_with_rank,
    gen_regular_matrix,
)
from .utils.fmt import cformat
from .utils.trace import global_logger, log, raw_log


def rationalize_matrix(mat: Matrix) -> Matrix:
    """Copy of ``mat`` with numeric entries converted to ``Fraction`` so
    elimination stays exact."""
    return mat.self_map(
        lambda x: Fraction(x) if isinstance(x, (int, float)) else x
    )


def rationalize_vector(vec):
    return [Fraction(x) if isinstance(x, (int, float)) else x for x in vec]


def random_sparse_matrix(n: int, sparsity: float) -> Matrix:
    def sparse_dist():
        if random.random() > sparsity:
            return random.randint(-5, 5)
        return 0

    return (
        RandomMatrixBuilder.new()
        .with_dist(sparse_dist)
        .with_size(n, n)
        .build()
    )


def determinant_section() -> None:
    log(r"\section{Determinant}")
    A = rationalize_matrix(random_sparse_matrix(6, 0.45))
    log(r"Vstupní matice $A$: $%s$ \\", A)
    det_val = A.determinant(log_permutation_details=True)
    log(r"\textbf{Determinant:} $%s$", det_val)


def inverse_section() -> None:
    log(r"\section{Inverze}")
    A = rationalize_matrix(gen_regular_matrix(3))
    log(r"Vstupní matice $A$: $%s$", A)
    inv = A.inverse(log_matrices=True, log_steps=True, log_result=True)
    log(r"\textbf{Inverzní matice:} $%s$", inv)


def linear_system_section() -> None:
    log(r"\section{Lineární soustava}")
    A = rationalize_matrix(gen_regular_matrix(3))
    b = rationalize_vector([random.randint(-5, 5) for _ in range(3)])
    log(r"Lineární soustava $A\,x=b$ s $A=%s$", A)
    sol = A.find_preimage_of(
        b, log_matrices=True, log_steps=True, log_result=True
    )
    log(r"\textbf{Množina řešení:} $%s$", sol)


def eigenvalues_section() -> None:
    log(r"\section{Vlastní čísla}")
    A = rationalize_matrix(
        gen_diagonalizable_matrix(3, eigenvalues=[(-3, 1), (0, 1), (4, 1)])
    )
    log(r"Vstupní matice $A$: $%s$", A)
    eigs = A.eigenvalues()
    summary = ", ".join(
        "%s^{%d}" % (cformat(e), m) for e, m in eigs.items()
    )
    log(r"\textbf{Vlastní čísla:} $%s$", summary)


def diagonalization_section() -> None:
    log(r"\section{Diagonalizace}")
    A = rationalize_matrix(
        gen_diagonalizable_matrix(3, eigenvalues=[(5, 1), (2, 1), (-5, 1)])
    )
    log(r"Vstupní matice $A$: $%s$", A)
    log(r"%s", A.diagonalize())


def kernel_section() -> None:
    log(r"\section{Kernel}")
    A = rationalize_matrix(gen_matrix_with_rank(3, 4, rank=2))
    log(r"Vstupní matice $A$: $%s$ \\", A)
    ker = A.find_preimage_of(
        [0] * 3, log_matrices=True, log_steps=True, log_result=True
    )
    log(r"\textbf{Báze jádra:}    $%s$", ker)


def device_section(seed: int = 2026, device=None, systems=None,
                   batch=None) -> None:
    """Run the batched numeric path on ``device`` (``"cuda"`` unless the
    caller names another; no CUDA device raises) and replay its recorded
    elimination events into the document.

    ``systems = (A, b)`` replaces the replay's drawn batch and ``batch``
    the spectral subsection's, so a caller can give two implementations
    the same inputs."""
    import torch

    from .trace.events import replay_solve_trace

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device runs the batched path on a CUDA device, and torch "
            "sees none")
    log(r"\section{Dávkový %s řešič}"
        % ("GPU" if device.type == "cuda" else "CPU"))
    replay_solve_trace(device=device, systems=systems)
    _device_spectral_subsection(seed, device, batch)


def _device_spectral_subsection(seed: int, device, batch=None) -> None:
    """Batched spectral report (eigenvalues, multiplicities,
    diagonalizability) for a generated device batch, summarized as a
    LaTeX table: the device-scale counterpart of the eigenvalue and
    diagonalization sections."""
    import numpy as np
    import torch

    from .models.spectral import spectral_pipeline
    from .ops.generate import diagonalizable_batch

    log(r"\subsection*{Spektrální rozklad dávky}")
    if batch is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        batch = diagonalizable_batch(gen, 4, [4.0, 1.0, 1.0, -2.0],
                                     transform="orthogonal", device=device)
    else:
        batch = torch.as_tensor(np.asarray(batch), dtype=torch.float32,
                                device=device)
    rep = spectral_pipeline(batch, tol=1e-2)
    lam = rep.eig_real.cpu().numpy()
    alg = rep.alg_mult.cpu().numpy()
    geom = rep.geom_mult.cpu().numpy()
    ok = rep.diagonalizable.cpu().numpy()
    raw_log(r"\begin{tabular}{c|c|c|c|c}")
    raw_log(
        r"matice & $\lambda$ & alg.~n\'asobnost & geom.~n\'asobnost"
        r" & diagonalizovateln\'a \\ \hline"
    )
    for b in range(lam.shape[0]):
        # distinct eigenvalues in descending order
        firsts = np.concatenate(
            [[True], np.abs(np.diff(lam[b])) > 1e-2]
        )
        lam_s = ", ".join(f"{v:.4g}" for v in lam[b][firsts])
        alg_s = ", ".join(str(int(v)) for v in alg[b][firsts])
        geom_s = ", ".join(str(int(v)) for v in geom[b][firsts])
        flag = r"ano" if bool(ok[b]) else r"ne"
        raw_log(
            f"$A_{{{b + 1}}}$ & ${lam_s}$ & {alg_s} & {geom_s}"
            f" & {flag} \\\\"
        )
    raw_log(r"\end{tabular}")
    raw_log("")


SECTIONS = [
    determinant_section,
    inverse_section,
    linear_system_section,
    eigenvalues_section,
    diagonalization_section,
    kernel_section,
]


def main(argv=None, device=None) -> None:
    """The CLI.  ``device`` (a keyword for callers such as tests, not a
    flag) is where ``--device`` runs: ``"cuda"`` unless given."""
    parser = argparse.ArgumentParser(
        prog="linalg-solver-tpu-torch",
        description="Exact linear algebra with LaTeX derivations "
        "(the PyTorch/CUDA numeric path included).",
    )
    parser.add_argument(
        "-o", "--output", default="output.tex",
        help="output .tex path (default: output.tex)",
    )
    parser.add_argument(
        "--seed", type=int, default=2026, help="PRNG seed (default: 2026)"
    )
    parser.add_argument(
        "--device", action="store_true",
        help="also run the batched device pipeline section (CUDA)",
    )
    parser.add_argument(
        "--quiet", action="store_true",
        help="do not echo log lines to stdout",
    )
    args = parser.parse_args(argv)

    if args.quiet:
        global_logger.auto_print = False

    random.seed(args.seed)
    for section in SECTIONS:
        section()
    if args.device:
        device_section(args.seed, device=device)

    with open(args.output, "w", encoding="utf-8") as f:
        f.write("\n".join(global_logger.accum))


if __name__ == "__main__":
    main()
