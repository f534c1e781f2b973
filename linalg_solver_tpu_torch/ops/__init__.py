"""Numeric operations of the port (counterpart of ``linalg_solver_tpu.ops``).

- ``dispatch`` — ``solve_batched``, ``inverse_batched``, ``det_batched``,
  ``rank_batched``, ``lu_factor_batched``, ``affine_solve_batched`` and
  ``nullspace_batched`` with backend routing and autograd
- ``rref``, ``lu``, ``solve`` — the Gauss–Jordan and LU loops (the
  ``"loop"`` backend), affine solution sets, nullspaces, inverses, ranks
  and determinants, and the affine solve on the pivoted kernel
- ``rref_blocked`` — blocked rank-revealing Gauss–Jordan past the
  kernel's reach
- ``rbt`` — random-butterfly preconditioned pivot-free solve and
  inverse + rescue: the fused engine and the phase engine, the seeded
  butterfly and probe draws
- ``lu_blocked`` — the pivoted phase loop on the masked panel kernel
  (mixed and blocked solves, det, packed LU, inverse), the pivoted solve
  and inverse the rescues end in, and the triangular inverses
- ``lu_large`` — the large-N solves: RBT block elimination and the
  pivoted blocked LU with library panels
- ``lu_recursive`` — the pivot-free recursive inverse of ``lu_large``'s
  diagonal blocks
- ``kernels`` — hand-written CUDA kernels beside their plain versions,
  and the facade the inverse, det and rank route to
- ``eigen`` — characteristic polynomial (Faddeev–LeVerrier), QR-iteration
  eigenvalues, eigenspaces, multiplicities, diagonalization, and the
  batched spectral decomposition on kernel 3
- ``schur`` — balancing, Hessenberg reduction and multishift Francis QR
  with aggressive early deflation: the real Schur form, its vectors,
  eigenvalues, the real eigenvectors (strevc), the full complex
  eigendecomposition with Rayleigh-shifted inverse iteration
  (``eig_batched``) and per-eigenvalue condition numbers
  (``schur.eig_condition_batched``, not re-exported, as in the reference)
- ``symmetric`` — the symmetric eigensolver with a backward that is
  finite on repeated eigenvalues, and the symmetry probe
- ``orth`` — batched masked CholeskyQR orthonormalization
- ``generate`` — structured random batches on the device
- ``cond`` — Hager's 1-norm condition estimate on the LU factors
- ``lstsq`` — least-squares and minimum-norm solves, thin QR and basis
  completion by shifted CholeskyQR2
- ``svd`` — QDWH polar decomposition, the SVD built on it, the
  pseudoinverse, the 2-norm condition number and the SVD rank
- ``spd`` — Cholesky solve, inverse and log-determinant, and the
  pivoted (rank-revealing) Cholesky
- ``sylvester`` — Sylvester and Lyapunov equations (Bartels–Stewart on the
  Schur form and ``eig_batched``) and the Stein equation (Smith doubling)
- ``riccati`` — continuous (matrix sign) and discrete (doubling) algebraic
  Riccati equations
- ``geig`` — generalized eigenproblems: symmetric-definite (Cholesky),
  invertible B (LU), and singular B by shift-invert
- ``quadeig`` — polynomial and quadratic eigenproblems by companion
  linearization
- ``roots`` — polynomial roots: the companion matrix's Schur eigenvalues
- ``sign`` — the matrix sign function, half-plane eigenvalue counts and
  spectral projectors
- ``ordschur`` — rsf2csf, ordered complex Schur forms, invariant
  subspaces and cluster condition numbers (the masked Sylvester solve on
  ``kernels.trsyl``)
- ``pseudospectra`` — σmin(A − zI) over points and grids by inverse
  iteration on the complex Schur form
- ``funm`` — expm (differentiable), sqrtm, logm, powm and their SPD forms,
  the trigonometric and hyperbolic functions, ``funm`` on the
  eigendecomposition, expm's Fréchet derivative, condition number and
  action on vectors
- ``nearness`` — nearest PSD, correlation and orthogonal matrices
- ``fitting`` — ridge, total least squares, Procrustes and principal
  angles
- ``dd`` — f64-class solve, inverse, least squares and eigenvalues:
  float32 factorizations on the kernels, refinement with float64
  residuals (the ``"dd"`` backend of ``dispatch``)
- ``complexlin`` — complex solve, inverse, determinant (the pivoted
  complex elimination on ``kernels.complex_gauss``), eigh, eig, Cholesky,
  QR, SVD, pseudoinverse, least squares, matrix functions and equations,
  generalized eigenproblems and roots, on (re, im) pairs through the real
  embedding
- ``krylov`` — CG, BiCGSTAB, GMRES(m), MINRES and LSQR, dense and
  matrix-free, their loops run in chunks with one host read a chunk
- ``toeplitz`` — FFT Toeplitz matvec, Strang's preconditioner, the
  Krylov solve
- ``structured`` — circulant (FFT), Hankel (through Toeplitz) and
  Vandermonde (Björck–Pereyra) families
- ``banded`` — block-tridiagonal and banded solves by block cyclic
  reduction
- ``lobpcg`` — extreme eigenpairs of SPD matrices
- ``arnoldi`` — Krylov–Schur eigenpairs of general operators, plain and
  shift-invert, on ``schur.eig_batched``
- ``blocksparse`` — block-sparse operators: a deterministic block matvec,
  iterative solves and eigenpairs
- ``kron`` — Kronecker products and sums: matvec, solve, least squares,
  and the Kronecker-sum solve on the Sylvester equation
- ``exact_int`` — Bareiss elimination in int32 and CRT reconstruction:
  exact integer determinants, ranks and solutions (not re-exported, as
  in the reference)

As in the reference, the functions ``rref``, ``solve`` and
``rref_blocked`` shadow the modules of the same names on this package:
reach those with ``importlib.import_module`` (``from . import solve``
binds the function).
"""

from .rref import (
    EV_ELIM_ABOVE,
    EV_ELIM_BELOW,
    EV_NORM,
    EV_SWAP,
    EVENT_NAMES,
    RREFResult,
    rref,
    rref_batched,
)
from .solve import (
    BatchedAffineSubspace,
    InverseResult,
    det_gj,
    det_gj_batched,
    inverse,
    inverse_batched,
    nullspace,
    nullspace_batched,
    rank,
    rank_batched,
    solve,
    solve_batched,
)
from .lu import (
    LUResult,
    det_lu,
    det_lu_batched,
    lu_factor,
    lu_factor_batched,
    lu_solve,
    lu_solve_batched,
    solve_lu,
    solve_lu_batched,
)
from .schur import (
    EigFullResult,
    EigResult,
    SchurEigvals,
    SchurResult,
    SchurVectors,
    eig_batched,
    eig_real_batched,
    eigvals_schur,
    hessenberg,
    real_schur,
    real_schur_vectors,
)
from .rref_blocked import (
    BlockedRREF,
    rank_blocked_batched,
    rref_blocked,
    solve_affine_blocked_batched,
)
from .symmetric import (
    EighResult,
    eigh_batched,
    is_symmetric_batched,
    symmetry_defect_batched,
)
from .cond import (
    cond1_est_batched,
    lu_solve_transposed,
    lu_solve_transposed_batched,
    rcond_batched,
)
from .lstsq import (
    LstsqResult,
    QRResult,
    lstsq_batched,
    qr_batched,
)
from .svd import (
    PolarResult,
    SVDResult,
    cond2_batched,
    pinv_batched,
    polar_batched,
    rank_svd_batched,
    svd_batched,
)
from .sylvester import (
    SteinResult,
    SylvesterResult,
    lyapunov_batched,
    stein_batched,
    sylvester_batched,
)
from .riccati import (
    CAREResult,
    DAREResult,
    care_batched,
    dare_batched,
)
from .funm import (
    ExpmFrechetResult,
    ExpmvResult,
    LogmResult,
    SqrtmResult,
    expm_batched,
    expm_cond_batched,
    expm_frechet_batched,
    expm_multiply_batched,
    expm_multiply_matvec,
    logm_batched,
    logm_spd_batched,
    powm_batched,
    powm_spd_batched,
    sqrtm_batched,
    sqrtm_spd_batched,
)
from .spd import (
    CholeskyResult,
    PivotedCholesky,
    cholesky_batched,
    cholesky_inverse_batched,
    cholesky_solve_batched,
    logdet_spd_batched,
    pivoted_cholesky_batched,
)
from .geig import (
    GeneralizedEigResult,
    GeneralizedEigShifted,
    GeneralizedEighResult,
    eig_generalized_batched,
    eig_generalized_shifted_batched,
    eigh_generalized_batched,
)
from .fitting import (
    ProcrustesResult,
    RidgeResult,
    SubspaceAngles,
    TLSResult,
    procrustes_batched,
    ridge_batched,
    subspace_angles_batched,
    tls_batched,
)
from .nearness import (
    NearestCorrResult,
    NearestPSDResult,
    nearest_correlation_batched,
    nearest_orthogonal_batched,
    nearest_psd_batched,
)
from .pseudospectra import (
    PseudospectraResult,
    pseudospectrum_grid_batched,
    sigmin_points_batched,
)
from .quadeig import (
    PolyEigResult,
    QuadEigResult,
    polyeig_batched,
    quadeig_batched,
)
from .complexlin import (
    det_complex_batched,
    inverse_complex_batched,
    solve_complex_batched,
)
from .roots import (
    RootsResult,
    roots_batched,
)
from .sign import (
    SignResult,
    eig_count_left_batched,
    sign_batched,
    spectral_projector_batched,
)
from .ordschur import (
    ClusterCondition,
    ComplexSchur,
    InvariantSubspace,
    OrderedSchur,
    invariant_subspace_batched,
    rsf2csf_batched,
    schur_cluster_cond_batched,
    schur_reorder_batched,
    schur_sort_batched,
)
from .tridiag import (
    TridiagResult,
    tridiag_solve_batched,
)
from .sturm import (
    TridiagEigResult,
    TridiagEigVecResult,
    eigh_tridiagonal_batched,
    sturm_count_batched,
    tridiag_eigenvectors_batched,
)
from .banded import (
    BlockTridiagResult,
    banded_solve_batched,
    block_tridiag_solve_batched,
)
from .kron import (
    KronSumResult,
    kron_batched,
    kron_lstsq_batched,
    kron_matvec_batched,
    kron_solve_batched,
    kronsum_solve_batched,
)
from .krylov import (
    KrylovResult,
    bicgstab_batched,
    bicgstab_matvec,
    cg_batched,
    cg_matvec,
    gmres_batched,
    gmres_matvec,
)
from .toeplitz import (
    make_toeplitz_matvec,
    strang_precond,
    toeplitz_dense_batched,
    toeplitz_matvec_batched,
    toeplitz_solve_batched,
)
from .lobpcg import (
    LOBPCGResult,
    lobpcg_batched,
)
from .arnoldi import (
    ArnoldiEigs,
    eigs_arnoldi_batched,
    eigs_arnoldi_matvec,
    eigs_arnoldi_shifted_batched,
)
from .blocksparse import (
    BlockSparse,
    blocksparse_eigs,
    blocksparse_from_dense,
    blocksparse_solve,
    blocksparse_to_dense,
    make_blocksparse_matvec,
)
from .structured import (
    CirculantSolve,
    VandermondeSolve,
    circulant_dense_batched,
    circulant_matvec_batched,
    circulant_solve_batched,
    hankel_dense_batched,
    hankel_matvec_batched,
    hankel_solve_batched,
    vandermonde_dense_batched,
    vandermonde_solve_batched,
    vandermonde_solve_t_batched,
)
from .randomized import (
    CURDecomposition,
    InterpolativeDecomposition,
    RandomizedSVD,
    cur_batched,
    interpolative_batched,
    randomized_svd_batched,
)

__all__ = [
    "SchurResult", "SchurEigvals", "SchurVectors", "EigResult",
    "hessenberg", "real_schur", "eigvals_schur",
    "real_schur_vectors", "eig_real_batched",
    "EigFullResult", "eig_batched",
    "EighResult", "eigh_batched", "is_symmetric_batched",
    "symmetry_defect_batched",
    "cond1_est_batched", "rcond_batched",
    "lu_solve_transposed", "lu_solve_transposed_batched",
    "LstsqResult", "lstsq_batched", "QRResult", "qr_batched",
    "SVDResult", "svd_batched", "pinv_batched",
    "cond2_batched", "rank_svd_batched",
    "PolarResult", "polar_batched",
    "SylvesterResult", "sylvester_batched", "lyapunov_batched",
    "SteinResult", "stein_batched", "CAREResult", "care_batched",
    "DAREResult", "dare_batched",
    "expm_batched", "ExpmvResult", "expm_multiply_batched",
    "ExpmFrechetResult", "expm_frechet_batched", "expm_cond_batched",
    "expm_multiply_matvec", "sqrtm_spd_batched", "logm_spd_batched",
    "powm_spd_batched",
    "SqrtmResult", "sqrtm_batched", "LogmResult", "logm_batched",
    "powm_batched",
    "CholeskyResult", "cholesky_batched", "cholesky_solve_batched",
    "cholesky_inverse_batched", "logdet_spd_batched",
    "PivotedCholesky", "pivoted_cholesky_batched",
    "TridiagResult", "tridiag_solve_batched",
    "BlockTridiagResult", "block_tridiag_solve_batched",
    "banded_solve_batched",
    "GeneralizedEighResult", "eigh_generalized_batched",
    "GeneralizedEigResult", "eig_generalized_batched",
    "GeneralizedEigShifted", "eig_generalized_shifted_batched",
    "KronSumResult", "kron_batched", "kron_lstsq_batched",
    "kron_matvec_batched", "kron_solve_batched",
    "kronsum_solve_batched",
    "TridiagEigResult", "TridiagEigVecResult",
    "eigh_tridiagonal_batched", "sturm_count_batched",
    "tridiag_eigenvectors_batched",
    "NearestCorrResult", "NearestPSDResult",
    "nearest_correlation_batched", "nearest_orthogonal_batched",
    "nearest_psd_batched",
    "PseudospectraResult", "pseudospectrum_grid_batched",
    "sigmin_points_batched",
    "PolyEigResult", "polyeig_batched",
    "QuadEigResult", "quadeig_batched",
    "RidgeResult", "ridge_batched", "TLSResult", "tls_batched",
    "ProcrustesResult", "procrustes_batched",
    "SubspaceAngles", "subspace_angles_batched",
    "solve_complex_batched", "inverse_complex_batched",
    "det_complex_batched",
    "RootsResult", "roots_batched",
    "RandomizedSVD", "randomized_svd_batched",
    "InterpolativeDecomposition", "interpolative_batched",
    "CURDecomposition", "cur_batched",
    "KrylovResult", "cg_batched", "bicgstab_batched", "gmres_batched",
    "cg_matvec", "bicgstab_matvec", "gmres_matvec",
    "toeplitz_solve_batched", "toeplitz_matvec_batched",
    "toeplitz_dense_batched", "make_toeplitz_matvec", "strang_precond",
    "LOBPCGResult", "lobpcg_batched",
    "ArnoldiEigs", "eigs_arnoldi_batched", "eigs_arnoldi_matvec",
    "eigs_arnoldi_shifted_batched",
    "BlockSparse", "blocksparse_from_dense", "blocksparse_to_dense",
    "make_blocksparse_matvec", "blocksparse_solve", "blocksparse_eigs",
    "CirculantSolve", "circulant_dense_batched",
    "circulant_matvec_batched", "circulant_solve_batched",
    "hankel_dense_batched", "hankel_matvec_batched",
    "hankel_solve_batched",
    "VandermondeSolve", "vandermonde_dense_batched",
    "vandermonde_solve_batched", "vandermonde_solve_t_batched",
    "SignResult", "sign_batched", "eig_count_left_batched",
    "spectral_projector_batched",
    "ComplexSchur", "rsf2csf_batched",
    "OrderedSchur", "schur_reorder_batched", "schur_sort_batched",
    "InvariantSubspace", "invariant_subspace_batched",
    "ClusterCondition", "schur_cluster_cond_batched",
    "BlockedRREF", "rref_blocked", "solve_affine_blocked_batched",
    "rank_blocked_batched",
    "RREFResult", "rref", "rref_batched",
    "EV_SWAP", "EV_NORM", "EV_ELIM_BELOW", "EV_ELIM_ABOVE", "EVENT_NAMES",
    "BatchedAffineSubspace", "InverseResult",
    "solve", "solve_batched", "nullspace", "nullspace_batched",
    "inverse", "inverse_batched", "rank", "rank_batched",
    "det_gj", "det_gj_batched",
    "LUResult", "lu_factor", "lu_factor_batched",
    "lu_solve", "lu_solve_batched", "det_lu", "det_lu_batched",
    "solve_lu", "solve_lu_batched",
]
