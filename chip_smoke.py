"""Drive the PyTorch port's batched solve and batched inverse once on a
CUDA card, through the fused kernels and through the RBT phase engine,
then its pivoted, rank-revealing paths (affine solve, nullspace, rank),
the loop backend, ``BatchedSolver``'s serving flow, the device eigen
stack (Jordan analysis and the spectral pipeline), the real Schur
solver with the spectral pipeline's Schur routes,
``BatchedSolver``'s least squares, SVD, condition estimate and exact
integer determinant, and the eigenvector family built on the Schur
kernels (eigenvectors and their condition, polynomial roots, the matrix
sign, Sylvester, Lyapunov, Stein and Riccati equations, generalized and
quadratic eigenproblems), the matrix functions, BASELINE config 1's
exact LaTeX derivation with the card's pivot events replayed into it,
the CLI, the tridiagonal family, the f64-class layer in float64, the
complex layer, the ``numpy.linalg``-shaped namespace, the LU family's
hybrid and recursive engines, the flagship step's twin, the Krylov,
LOBPCG, Arnoldi, structured, banded, block-sparse and Kronecker
modules, and the mesh layer on a 1-rank NCCL world.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card), nvcc and g++ (the CUDA kernels and the native
planner are built from the checkout's sources at first use).  Phases, in
order; any failure is an uncaught exception and a non-zero exit:

1. require CUDA; print the card's name and power limit;
2. build the CUDA kernels from ``linalg_solver_tpu_torch/csrc``;
3. hold the solve kernel against its plain PyTorch version on the card,
   on batches with probe systems that a kernel without the butterfly or
   without refinement gets wrong, at a shape of each of its variants (one
   block a system at N = 100 and 200, a cluster of two at N = 226 and
   256, the device-memory scratch at N = 64 and 512), and show that the
   check fails for the kernel run without refinement;
4. drive the solve path, ``ops.dispatch.solve_batched(backend="auto")``,
   at the bench shape (B=256 systems of 256x256 f32, vector RHS), check
   that it launched the kernel and that the result solves the systems,
   then the rescue cases;
5. time the kernel, its plain version, ``solve_batched(auto)`` and
   ``torch.linalg.solve`` with CUDA events;
6. hold the fused inverse kernel (kernel 2) and the pivoted
   Gauss-Jordan kernel against their plain versions on probe batches
   (one matrix on every rung of the inverse's rescue ladder) and at the
   bench shape, kernel 2 at a shape of each of its variants (N = 32, 64,
   128, 172) and at N = 172 and 180, where its level 3 works in a
   device-memory scratch, and show that the check fails for the inverse
   kernel without its rescue;
7. drive the inverse path, ``ops.dispatch.inverse_batched(backend=
   "auto")``, at the bench shape (1024 matrices of 64x64 f32): one
   launch of the fused kernel, then the rescue cases, then N = 180 (the
   reference's reach, one launch);
8. drive the pivoted kernel's path: the inverse at N=63 (not a multiple
   of 4), ``det_batched``, ``rank_batched`` and ``solve_batched(auto)``
   (odd N: the ``"pallas"`` solve), then hold the kernel against its
   plain version on the arrays that path gave it;
9. time both inverse kernels (kernel 2 also as profiler device time),
   their plain versions, ``inverse_batched(auto)`` and
   ``torch.linalg.inv``;
10. hold the phase engine's two-sided butterfly kernel against its plain
    version, bitwise (depth 1 and 2, both directions, N = 64, 256, 896),
    and show that the check fails for the kernel with its sides flipped;
    hold its no-pivot panel kernel against its plain version bitwise on
    probe panels (a zero pivot, a NaN, an Inf) in each of its variants,
    with the flags equal, and show that the check fails against a plain
    version without the one-hot pivot rule;
11. hold the phase solve on the card against the same engine on the CPU
    (the plain versions) and show that the check fails for the card's
    solve without refinement;
12. drive the phase engine's paths: ``solve_batched(auto)`` at B=256,
    N=256 with k=16 RHS columns (one butterfly launch, eight panel
    launches, no fused one), ``inverse_batched(auto)`` at B=256, N=256
    (two butterfly launches, four panel launches) and the solve at N=896,
    k=1, past the fused kernel; hold both kernels against their plain
    versions on the arrays the first two paths gave them; then the rescue
    cases of both paths;
13. time both kernels (kernel 4 also as profiler device time), their
    plain versions, the two paths and ``torch.linalg.solve`` /
    ``torch.linalg.inv``;
14. hold the masked partial-pivot panel kernel (kernel 6) against its
    plain version, bitwise on all five outputs, on random panels with and
    without pre-pivoted rows and with a zero-column and a NaN panel, and
    show that the check fails for the kernel run without the mask;
15. drive kernel 6's paths at B=N=256, nb=64: ``solve_batched(backend=
    "mixed")`` (four kernel-6 launches, no other kernel, no rescue),
    ``det_batched(auto)`` and ``lu_factor_batched(auto)``, holding the
    kernel against its plain version on the arrays each path gave it; the
    mixed path's rescue of a system its TF32 factors cannot refine (that
    system alone goes to the pivoted rung); the reach check
    ``det_batched(auto)`` at N=960 (two-level panels);
16. drive the large-N branch, ``solve_batched(auto)`` at B=16, N=1024 and
    B=8, N=2048 (one kernel-4 launch each, no panel kernel, no system
    left to the pivoted rung), holding kernel 4 against its plain version
    on the array each gave it; then the routes ``auto`` gives the library
    from N = 1024 (the solve at N = 1088, the inverse and det at 1024: no
    kernel launch, the results ``torch.linalg``'s);
17. time kernel 6, its plain version and its library yardstick
    (``torch.linalg.lu_factor_ex`` on each phase's unpivoted rows), the
    three paths and the large solves against ``torch.linalg``;
18. drive kernel 3's path at its large shapes: ``inverse_batched(auto)``
    at B=1024, N=127 and N=167 (``[A | I]`` of the bench class) and
    ``det_batched(auto)`` at B=256, N=237 (``det_batch``'s class, with its
    singular and swapped lanes), one kernel-3 launch each; hold the kernel
    against its plain version on ``[A | I]`` and the det batch; time the
    kernel, its plain version, the two paths and ``torch.linalg.inv`` /
    ``det`` there; drive kernel 2's path at B=1024, N=128, 164, 172 and
    180 (one launch each), hold the kernel against its plain version
    there and time both beside ``torch.linalg.inv``; print the
    registers, spill bytes and
    resident blocks an SM of every variant of kernels 1, 2, 3, 5 and 6 on
    one line;
19. hold kernel 3's cluster variant (3, the reference's big reach: the
    tile in the shared memory of a cluster of 2 or 4 blocks) against its
    plain version, bitwise on perm, reduced array and pivots, at B=8 and
    [256, 257], [423, 424], [424, 424], on full-rank, rank-deficient,
    square-padded rectangular and inconsistent lanes and lanes with an
    Inf and a NaN, and show that the check fails for the kernel run with
    tol = 0;
20. drive the paths that take it: ``affine_solve_batched(auto)`` and
    ``nullspace_batched(auto)`` at B=N=256 and ``rank_batched(auto)`` at
    B=256, N=424 (one variant-3 launch each, the kernel held bitwise
    against its plain version on the array the path gave it); past it the
    blocked RREF, the rank at B=32, N=512 and the affine solve at s=448
    (no launch); then ``auto``'s former refusals, now the loop: the solve
    at B=256, N=237 and B=16, N=796, the inverse at B=256, N=170, the det
    at B=256, N=240 and its gradient at N=170, ``lu_factor`` at B=256,
    N=100;
21. a serving run as ``examples/serving_pipeline.py`` serves: five
    requests of 256 integer systems of 64x64 with three singular ones
    planted, through ``BatchedSolver.solve_checked``; exactly the planted
    systems fail the check, and their retry through
    ``BatchedSolver.affine_solve`` tells the consistent one from the
    others;
22. time variant 3 (kernel, plain version, paths) beside
    ``torch.linalg.matrix_rank`` for the rank (the affine solve has no
    single library call), each loop path beside its ``torch.linalg``
    call, and the blocked rank beside ``matrix_rank``;
23. config 5 (``examples/bench_spectral.py``'s size): ``jordan_analysis``
    at B=32, n=256 on a seeded orthogonal similarity of the Jordan form
    with blocks (2, 3) x 20, (2, 2) x 20, (5, 2) x 40, (1, 1) x 76 at
    eigenvalues (2, 5, 1), k_max=4: ``"svd"`` gives the exact Weyr
    characteristic, multiplicities and block counts on every lane,
    ``"gj"`` on every lane but the two where the reference's
    Gauss-Jordan misses one null direction, and there what the reference
    reports (``JORDAN_GJ_MISSES``);
    ``"gj"`` launches kernel 3's variant 3 four times on
    ``[96, 256, 257]``, each launch held bitwise against its plain
    version; ``"svd"`` launches none;
24. config 4: a seeded orthogonal similarity of diag(1 x 86, 2 x 85,
    5 x 85) at B=32; ``spectral_pipeline(method="auto")`` takes the
    eigh route; the spectral core on eigh's eigenvalues (tol 1e-2) at
    ``max_distinct`` 3 and None launches kernel 3 twice on
    ``[96, 256, 257]`` / 16 times on ``[1024, 256, 257]`` and the phase
    inverse's two kernel-4 and four kernel-5 launches a pass (a second
    pass, the redraw, where its gate flags a lane); every lane
    diagonalizable with alg = geom = the cluster sizes and
    ``max|diag(D) - lambda| <= 1e-2``; every kernel-3 launch held bitwise
    (the first of a cell whole, a later launch of 1024 matrices on every
    16th lane from its index mod 16 on, ``GJ_HOLD_LANES``), a launch of
    each other kernel;
25. the defective control: the spectral core on phase 23's batch with
    its exact eigenvalues flags no lane diagonalizable, geom < alg at 2
    and 5; ``spectral_pipeline(method="qr")`` at B=32, n=32 on a
    config-4 batch (kernel 3 twice, kernel 2 once), every lane
    diagonalizable;
26. time the eigen paths (CUDA events, median of 3, kernel 3's share of
    each as profiler device time), ``torch.linalg.eig`` on the config-4
    batch as a reference point, and kernel 3 alone at
    ``[96, 256, 257]`` and ``[1024, 256, 257]`` beside its plain
    version and bound;
27. the real Schur solver (``ops.schur``) at the same size,
    schur-gauss-256: ``eigvals_schur`` on 32 seeded Gaussian 256x256
    matrices, every lane converged and clean, the eigenvalues within
    2e-3 of numpy's float64 ones, the sweep count printed, the window
    kernel (``csrc/schur_window.cu``, one launch an AED round: the
    windows' whole inner real Schur form) and the bulge chase kernel
    (``csrc/schur_chase.cu``, one launch a main sweep; variant 1 holds H
    in a cluster's shared memory) launched from a CUDA graph a sweep;
    both held bitwise against their plain versions on every launch of
    the first outer sweep (the main chase in both variants), in f32 and
    in float64;
28. spectral-schur-256: config 4's batch through
    ``spectral_pipeline(method="schur")`` at ``max_distinct`` 3 and None,
    every lane diagonalizable with alg = geom = the cluster sizes, kernel
    3 and the phase inverse launched as in phase 24, every kernel-3
    launch held bitwise as there;
29. spectral-auto-jordan-256: config 5's batch through ``method="auto"``
    takes the Schur route, and no lane is reported diagonalizable; its
    kernel-3 launches held bitwise as in phase 24; both Schur kernels
    held on its first sweep (a defective batch);
30. spectral-eig-256: ``method="eig"`` on ``P diag(lambda) P^-1`` (256
    distinct reals, built in float64 from a seed): every lane
    diagonalizable, alg = 1, ``max|diag(D) - lambda| <= 1e-3``, P^-1 on
    the phase inverse (kernels 4 and 5 held bitwise), both Schur kernels
    held with Q;
31. time one outer sweep eagerly and as a CUDA-graph replay, the four
    cells (median of 3) beside ``torch.linalg.eigvals`` / ``eig``, the
    window kernel alone on an AED round (f32, float64) beside its plain
    version, the eager per-sweep loop it replaced and its bound (on the
    steps its dead-step rule runs, and on every step), after holding it
    on that round, on a NaN lane with converged lanes and on a lane
    scaled past the rule's bound, its device count of the steps it ran
    against ``window_schedule_reference``'s, and the chase kernel alone
    at the main sweep's shape (without Q, with Q, float64) in both
    variants beside its plain version and bound.

32. serving on one GPU, ``BatchedSolver()`` on inputs built on the card
    from seeded generators: ``rcond`` at B=256, N=256 (Gaussian +
    4 sqrt(N) I; two lanes with a row nearly repeated, one with a row
    repeated) between the exact 1/kappa_1 of a float64 inverse (less
    f32 rounding, 1e-3) and 3x it, 0 on the singular lane;
33. ``lstsq`` with a vector RHS at [256, 768, 256] (the 3:1 ratio of
    ``examples/solver_family.py``) and the minimum-norm case at
    [256, 256, 768]: x within 1e-4 relative of ``torch.linalg.lstsq`` in
    float64, the lane with a zero column (row) not ok and NaN; ``svd`` at
    [256, 256, 256] and [256, 768, 256]: sigma within 1e-5 sigma_max of
    float64 (the square roots of A^T A's float64 eigenvalues),
    ||U S V^T - A|| / ||A|| within 1e-5, and ||U^T U - I||_2 within 1e-5
    plus 2.5x the defect the reference's 8 QDWH steps leave on the lane
    (``qdwh_reach``: 0 where they converge; the lanes it lets through
    are printed with their float64 kappa_2);
34. ``det_exact`` on 4096 matrices of 8x8 ``randint(-5, 5)`` (BASELINE
    config 1's class) and 64 of 24x24 with entries to 1e4: det, rank and
    ok bitwise the host's int32 Bareiss (``host_bareiss``), det equal to
    the Python-int determinant on every lane where no product left int32,
    every 24x24 lane not ok, and ``crt_det_batched`` exact on every lane
    not ok or past int32; the lanes where the reference's overflow
    sentinel misses a product past int32 (ok, det wrong, in the reference
    too) are counted and listed;
35. time each method beside its library call (``torch.linalg.cond(p=1)``,
    ``lstsq``, ``svd``, float64 ``det``);
36-44. the eigenvector family at the Schur cells' width (``eigf_inputs``:
    seeded numpy on the host; every check in float64 on the host, each
    entry point with the kernels' counts set to 0 just before it and read
    just after): eig-256, ``eig_batched`` on examples/chip_eig_tail.py's
    32 Gaussian 256x256 matrices with ``refine_steps`` 0 and 1 (the
    residuals' median, p99 and max, no column worse with refinement, the
    spectrum against ``torch.linalg.eigvals``); eig-cond-256,
    ``schur.eig_condition_batched`` on the same batch plus a lane holding
    a 16-block Jordan chain (s against scipy's float64 left and right
    eigenvectors, the chain's tiny s and large error estimate); roots of
    1024 degree-32 polynomials against ``np.roots`` (a zero leading
    coefficient flagged); sign-256 (S^2 = I, the half-plane counts,
    the projector); sylvester-256, lyapunov-256 and stein-256 (relative
    residuals, a rho = 1.1 lane flagged); care-128 and dare-128 against
    scipy on 4 lanes; geig-256 (the symmetric-definite, LU and shift-
    invert paths against scipy, a B of rank n - 4 on 4 lanes giving
    exactly 4 infinite eigenvalues); quadeig-128's residuals.  The
    limits are ``EIGF_LIMITS``; where the JAX package misses one on the
    same input, ``EIGF_JAX`` holds its figure and the card is held to
    1.5x it;
45. time each entry point (median of 5 after the check's call) beside
    its library call where one computes the same function
    (``torch.linalg.eig``, ``eigvals`` of the companion, ``eigh`` of the
    Cholesky-reduced matrix, ``eig(solve(B, A))``), and
    ``_shifted_backsolve`` alone with its device events a call beside
    ``real_schur_vectors``;
46-51. ordered Schur forms, pseudospectra, matrix functions, nearness and
    fitting at full width (``mf_inputs``: seeded numpy on the host; every
    check in float64 on the host, each entry point with the kernels'
    counts set to 0 just before it and read just after): ordschur-256
    (eig-256's batch: its Schur pair once, then the |lambda| sort, the
    Re lambda < 0 reorder and the stable invariant subspace: Q T Q^H
    against D A D^-1, Q unitary, the order, V^T V = I and the invariance
    residual); cluster-cond-256 (``schur_cluster_cond_batched`` on the same
    pair with ``sep_iters=5``: 11 launches of the trsyl kernel, s against
    LAPACK's ztrsen on 4 lanes, sep at most gap, no lane perturbed);
    pseudo-128 (8 x G/sqrt(n), a 32 x 32 grid over [-2, 2]^2 from a
    seeded start, sigma_min at 64 seeded points against the same 20-step
    iteration in float64 on the card's own Schur form T, and against a
    float64 SVD of A - zI where that iteration has converged to the SVD of
    T - zI); funm-128 (sqrtm, logm,
    powm(1/2) and the expm round trip on G + 3 sqrt(n) I); expm-256 (4 G /
    sqrt(n) and its gradient against scipy's expm and expm_frechet);
    funm-256 (``funm_batched(exp)`` on eig-256's batch against scipy's
    expm; its V^-1 through the 512 x 512 real embedding on the phase
    engine's butterfly and no-pivot panel kernels); frechet-128 (the Frechet derivative against scipy's, expm_cond
    against a float64 power iteration); nearness-128 (64 corrupted rank-40
    correlation matrices: the nearest correlation, PSD and orthogonal
    matrices); fitting-768x256 (ridge, TLS, Procrustes on a planted
    rotation, principal angles).  The limits are ``MF_LIMITS``, or 1.5x
    the JAX package's figure in ``MF_JAX`` where it misses one on the same
    input.  Then the trsyl kernel held bitwise against its plain version on
    every launch of the cluster-cond path (the plain version on the CPU on
    every 4th lane of each launch, each direction's launches stacked into
    one call), and the butterfly
    and panel kernels on every launch of the funm path;
52. time each entry point (median of 3 after the check's call) beside its
    library call where one computes the same function
    (``torch.linalg.matrix_exp``, ``svdvals`` of the stacked A - zI at
    128 of the grid's 1,024 points, ``svd`` of [A | b] and of B A^T), and
    the trsyl kernel alone on the
    first forward and adjoint launch beside its plain version (a launch's
    share of the CPU hold) and bound;
53. BASELINE config 1's exact text path on this host, which has no sympy
    (``drive_text``): build the native determinant planner with ``g++``
    (its seconds printed); write config 1's derivation through the port's
    ``exact.Matrix`` (``find_preimage_of`` with every log on an 8 x 8
    randint(-5, 5) system, the planned determinant of a sparse 6 x 6 and
    a dense 5 x 5, all from ``random.Random(2026)``) with the Python
    planner engine and hold it byte for byte against
    ``tests/data_torch/text_config1.tex``, which a CPU test holds the JAX
    package to; plan both determinants with both engines (the same cost;
    each engine's plan time and whether its text equals the file
    printed); run 4096 config-1 systems (numpy, seed 2026) through
    ``rref_batched`` on the card and on the CPU, the events equal lane by
    lane; replay 256 of them into LaTeX and count the lanes whose text is
    the exact path's (``TEXT_MATCHED``, which the CPU test pins against
    the JAX package); hold ``crt_solve_batched``'s regular lanes on the
    card against ``find_preimage_of``'s solution;
54. the CLI (``drive_cli``): ``python -m linalg_solver_tpu_torch -o F
    --seed S --quiet`` for S = 2026, 7 and 123, each file byte for byte
    ``tests/data_torch/cli_seed{S}.tex`` (the JAX package's files; a CPU
    test holds the JAX package to them); then the CLI with ``--device`` in
    this process, every kernel count set to 0 just before and read just
    after: its exact part equal to the golden file, the replayed
    derivation equal to the exact path's text, the Bareiss determinants
    equal to ``crt_det_batched``, the spectral table exact;
55. sturm-4096 (``drive_sturm``): ``eigh_tridiagonal_batched`` on
    Gaussian [256, 4096] tridiagonals (``examples/chip_session7.py``'s
    cell; the bisection's 129 launches, a count and a plan a step,
    counted), lane 0 against float64 LAPACK, the midpoints each step
    counted against the plain schedule model; the kernel bitwise against
    its plain version at [16, 4096] (two of its lanes, on the host's CPU,
    for the kernel's steps: the intervals) and on the card at [32, 512]
    in float32 and float64 (intervals and live step count) and against the
    schedule model (intervals, live steps, counted midpoints), their times against the bound (3·n operations a midpoint the
    data needs) and the plain version, ``torch.linalg.eigvalsh`` on the
    [16, 4096] lanes' dense tridiagonals as the library call; the count
    kernel through ``sturm_count_batched`` at the [16, 4096] intervals'
    midpoints (its one launch counted), bitwise its plain version in
    float32 and float64, timed;
56. getvec-512 (``drive_getvec``): the twisted factorization's vectors at
    [32, 512], every vector ``ok``, the residual's max and p99, timed;
57. tridiag-4096 and rsvd-1024 (``drive_tridiag_rsvd``): cyclic reduction
    at [256, 4096], k = 1, on diagonally dominant systems, its float64
    residual; ``randomized_svd_batched`` on [64, 1024, 1024] of rank 32
    plus 1e-3 noise at k = 32, its σ against the float64 SVD, beside
    ``torch.svd_lowrank`` and ``torch.linalg.svd``, timed;
58. dd (``drive_dd``): ``solve_dd_batched`` and ``solve_batched(backend=
    "dd")`` at B=N=256 on orthogonal factors around logspace(0, -4) (kappa
    1e4; panel kernel 6 four times, each launch held bitwise against its
    plain version), the float64 residual under the reference's 1e-12
    target and the forward error within 1e-10 of numpy's float64 solve;
    ``inverse_dd_batched`` at B=1024, N=64 (kernel 2 once, max|I - AX| ≤
    1e-12); ``eig_dd_batched`` on schur-gauss-256's batch (the Schur
    kernels; the median error within 1e-10 of max|A|, every eigenvalue
    within 10x its err_bound); ``eigh_dd`` at [32, 128] and ``lstsq_dd`` at
    [64, 384, 128]; each timed beside its float64 ``torch.linalg`` call;
59. complex (``drive_complex``): ``solve_complex_batched`` at B=256,
    n=128 (kernel 1 on the [256, 256, 256] embedding), ``inverse_complex_
    batched`` at B=1024, n=32 (kernel 2), ``eig_complex_batched`` at
    B=32, n=128 (the Schur kernels), each against numpy complex128;
    ``det_complex_batched`` and ``slogdet_complex_batched`` at B=256,
    n=128 and 192 (the complex elimination kernel, ``csrc/complex_
    gauss.cu``, its register variant, held bitwise against its plain
    version on every call, a singular lane 0 and -inf), each timed beside
    its ``torch.linalg`` complex64 call; the kernel also held at those n
    in f32 and float64 (float64 at 192: the device-memory variant) with a
    singular, a NaN and an Inf lane;
60. linalg (``drive_linalg``): every entry point of the ``numpy.linalg``-
    shaped namespace at leading dims (), (3,) and (2, 2), real and
    complex, against numpy float64 / complex128, and a numpy argument
    that must land on the card;
61. the LU family's other engines (``drive_rbt_engines``):
    ``solve_rbt_batched`` (k = 1 and 16) and ``inverse_rbt_batched`` with
    ``engine="hybrid"`` and ``"recursive"`` at B = N = 256, every launch
    of kernels 4 and 5 held bitwise against its plain version on the
    arrays the path gave it; ``fallback="pivoted"`` and ``False`` on a
    batch with one zero pivot under the main draw (the other systems
    bitwise the clean run's; any launch of kernel 6 by the pivoted
    rescue held against its plain version); ``lu_large.large_solve_rbt(diag_engine=
    "pivoted")`` at B = 16, N = 1024; float64 residuals; times beside
    ``torch.linalg.solve`` / ``inv``;
62. the flagship step's twin (``drive_graft``): ``graft_entry.entry()``'s
    forward at B = 8, N = 64, one kernel-1 launch held against its plain
    version, timed beside ``torch.linalg.solve``;
63. Krylov (``drive_krylov``): CG (SPD, κ ≈ 5), BiCGSTAB, GMRES(32) and
    MINRES at B = 8, n = 1024, LSQR at [8, 2048, 1024]: converged, the
    float64 residual within 4·tol, the host reads a call against
    ⌈iters / chunk⌉ + 1, the device's busy share, times beside the
    library's dense solve / lstsq;
64. LOBPCG (``drive_lobpcg``), k = 8 smallest of 16 SPD 512 x 512: every
    lane converged, its eigenvalues against float64 ``eigvalsh``, host reads,
    timed beside ``torch.lobpcg``;
65. Arnoldi (``drive_arnoldi``): Krylov–Schur, 6 eigenpairs (3 complex
    pairs) of 8 general 1024 x 1024 at m = 32, Ritz residuals by true
    matvecs in float64, one host read a restart, both Schur kernels held
    bitwise on its first Rayleigh matrix; the shift-invert mode at n = 512;
66-67. the structured and banded solves (``drive_structured``): Toeplitz
    (Strang-preconditioned GMRES), circulant and Hankel at B = 16,
    n = 4096, Björck–Pereyra at n = 32 (primal and dual), banded at
    N = 4096, kb = 4: float64 residuals, flags, busy shares, times
    beside ``torch.linalg.solve`` on the dense operator;
68-69. block-sparse and Kronecker (``drive_blocksparse_kron``): GMRES and
    Krylov–Schur on a symmetric 2048 x 2048 operator with 5 % of its
    64-wide blocks (B = 8), the top 3 eigenvalues against float64
    ``eigvalsh``, the block matvec repeatable bitwise; ``kron_solve``,
    ``kronsum_solve`` (the Schur kernels, held bitwise) and
    ``kron_lstsq`` at B = 16, m = n = 64 ([96, 64] ⊗ [96, 64]); residuals
    in float64; times beside the library on the dense operator;
70-77. the mesh layer (``drive_mesh``) on a 1-rank NCCL world started
    here (``init_process_group("nccl", store=HashStore(), rank=0,
    world_size=1)``, no launcher) with a ("dp", "tp") = (1, 1) mesh,
    closed at the end: ``BatchedSolver(mesh=...)``'s solve (B = N = 256),
    inverse (B = 1024, N = 64), det and rank (B = N = 256), each with no
    collective, bitwise the unsharded call, its kernel held against its
    plain version on the arrays it was given; three training steps at
    B = N = 256 (the loss falls, the first step within 1e-4 of the
    float64 step); ``distributed_solve``, ``distributed_det`` and
    ``distributed_solve_dd`` on one N = 2048 system at nb = 128 (float32
    residual ≤ 1e-5, dd ≤ 1e-10, collectives equal to
    ``comm.model_lu_solve``); ``distributed_lstsq`` and
    ``distributed_svd_tall`` on [16384, 256], ``distributed_randomized_svd``
    (k = 16) on [16384, 1024], held to float64 numpy; the distributed
    CG, BiCGSTAB and GMRES at n = 1024; ``distributed_eigh`` and
    ``distributed_svd_jacobi`` at n = 256 against float64, the eigh's
    collectives equal to ``comm.model_eigh_adaptive``;
    ``spectral_pipeline_sharded`` at B = 32, n = 64 bitwise the unsharded
    pipeline, the Schur kernels and kernel 3 held; then
    ``graft_entry.dryrun_multichip(1)``, its kernel 1 launches held
    against the plain version; times beside the library or the unsharded
    call (the sharded and unsharded inverse's device times, with the
    host's axes-and-slice bookkeeping timed alone);
78. the exact eigen stack's radicals on this host, with no sympy (the
    port imports none; ``drive_radicals``): for the eight matrices of
    ``RADICAL_MATRICES`` (ℚ(√33), ℚ(√3) beside a rational root, ℚ(√-3),
    the companions of λ³ − 2, λ³ − 3λ + 1 and λ⁵ − λ − 1, an irreducible
    cubic, two √33 blocks with two-dimensional eigenspaces)
    ``eigenvalues()``, ``eigenvalues(real_only=True)``, the geometric
    multiplicities and, where the port writes it, ``diagonalize()``'s
    result, byte for byte against ``tests/data_torch/eigen_radicals.tex``
    (which a CPU test holds the JAX package to), with its seconds; no
    kernel.
79. the rest of sympy's roots on this host, with sympy, mpmath and jax
    refused (``drive_roots``): for the matrices of ``ROOT_MATRICES``
    (three 4×4 int matrices whose characteristic polynomial has float
    coefficients, Ferrari's quartics λ⁴ − λ − 1, λ⁴ + λ + 1 and
    λ⁴ − 3λ³ − λ² + 3λ − 1 (the cube root of a real, a complex and a
    negative number), the decompositions λ⁴ − 10λ² + 1 and λ⁴ − 2λ² − 2,
    the cyclotomic Φ₅, Φ₇ and Φ₉, the binomials λ⁵ + 2 and λ⁷ − 3, the
    product λ⁶ − 12λ⁴ + 21λ² − 2 that Zassenhaus splits) ``eigenvalues()``
    and ``eigenvalues(real_only=True)`` byte for byte against
    ``tests/data_torch/eigen_roots.tex`` (which a CPU test holds the JAX
    package to), with its seconds; no kernel.

The line before the last is a JSON summary of the twelve kernels, each with
its bound (the larger of its bytes over 3.35 TB/s and its operations
over the 67 TFLOP/s FP32 rate, counted from this run's inputs) and the
time of the one library call that computes the same function, where
there is one (the ``ms`` of kernels 2, 4 and 5 is device time from
``torch.profiler``, kernel 5's over the solve path's eight panels;
``host_ms`` the CUDA-event time of the same Python calls; kernels 2 and
3 list their large shapes, kernel 3's variant-3 shapes with their plain
and path times; the chase and window kernels, which replace an XLA scan
and an XLA while loop and no Pallas kernel, their shapes, the chase's
other variant and the eager and graph sweep times, and their launches
on each path of the eigenvector family; the trsyl kernel, which replaces
the nested XLA scans of ``_trsyl_masked`` and no Pallas kernel, its
forward and adjoint shapes; the Sturm bisection kernel, which replaces
the XLA while loop of ``eigh_tridiagonal_batched``, its row at
[16, 4096] beside its library call and its [256, 4096] and [32, 512]
shapes with their live steps; the Sturm count kernel, which replaces the
XLA scan of ``sturm_count_batched``, its [16, 4096] lanes at 4096 points
each; the complex elimination kernel, which replaces the XLA fori loop of
``_gauss_pivots_complex``, its shared- and device-memory shapes beside
``torch.linalg.det`` complex64; each earlier kernel's launches on phases
58-60 under ``dd_complex_linalg_launches``, on phases 61-69 under
``phases_61_69_launches`` and on phases 70-77 under ``mesh_launches``);
the last line is
``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

B, N = 256, 256
TOL_KERNEL = 1e-5      # max relative difference, kernel vs plain version
TOL_RESID = 1e-5       # worst-system relative residual, float64
FLAGGED = [2, 5]       # probe systems the kernel must flag (probe_batch)
B_INV, N_INV = 1024, 64
TOL_INV = 5e-5         # worst-matrix max|A X - I|, float64
INV_REACH = 180        # kernel 2's last N (the reference's cap)
#: kernel 2 against its plain version: a shape of each variant (N = 32,
#: 64, 128, 172), the reach (level 3 in device memory at 172 and 180)
INV_SHAPES = ((8, 32), (8, 64), (8, 128), (8, 172), (8, INV_REACH),
              (B_INV, N_INV))
K_PHASE = 16           # RHS columns of the phase engine's solve path
N_REACH = 896          # past the fused kernel's reach at k=1
N_PANEL_REACH = 960    # past kernel 6's reach at nb = 64 (det, two levels)
TOL_DET = 1e-3         # max relative error of det, against float64
HBM_RATE = 3.35e12     # bytes/s, H100 SXM (NVIDIA's data sheet)
FP32_RATE = 67e12      # FLOP/s, FP32 outside the tensor cores (same)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the HBM rate and the operations over the
    FP32 rate."""
    tb, tf = nbytes / HBM_RATE, flops / FP32_RATE
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_batch(dev):
    """Gaussian plus 4*sqrt(N)*I, as bench.py builds it, on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(B, N, N, generator=g, device=dev)
    a += 4.0 * N**0.5 * torch.eye(N, device=dev)
    return a, torch.randn(B, N, generator=g, device=dev)


def phase_batch(dev):
    """The phase engine's solve and inverse input at B = N = 256 (the
    inverse's matrix class, seed 7) with K_PHASE RHS columns (seed 8)."""
    a = inverse_batch(B, N, 7, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    return a, torch.randn(B, N, K_PHASE, generator=g, device=dev)


def det_batch(dev, n=N):
    """The det cell's input at B = 256, N = ``n`` (256 by default): I +
    G/(2 sqrt N), whose determinant stays inside f32's range (the bench
    class overflows it); lane 3 is singular (all zero) and lane 4 has two
    rows swapped."""
    g = torch.Generator(device=dev).manual_seed(11)
    s = torch.eye(n, device=dev) + torch.randn(
        B, n, n, generator=g, device=dev) / (2 * n**0.5)
    s[3] = 0.0
    s[4, [0, 7]] = s[4, [7, 0]]
    return s


def probe_batch(bsz, n, k, du, dv, dev):
    """Gaussian plus 4*sqrt(n)*I with four probe systems: 2 all zero and
    5 with a NaN (both flagged), 6 with a zero leading minor (flagged
    only without the butterfly) and 7 with a SMALL_PIVOT first pivot
    after the butterfly (off by >= 2e-3 without refinement)."""
    from linalg_solver_tpu_torch.utils import systems

    g = torch.Generator(device=dev).manual_seed(100 + k + n)
    a = torch.randn(bsz, n, n, generator=g, device=dev)
    a += 4.0 * n**0.5 * torch.eye(n, device=dev)
    b = torch.randn(bsz, n, k, generator=g, device=dev)
    a[2] = 0.0
    a[5, 3, 7] = float("nan")
    a[6] = systems.zero_minor_system(a[6])
    a[7] = systems.pivot_system(a[7], du, dv, systems.SMALL_PIVOT)
    return a, b


def inverse_batch(bsz, n, seed, dev):
    """Gaussian plus 4*sqrt(n)*I from a seeded generator on the card, as
    bench.py builds the inverse's batch."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(bsz, n, n, generator=g, device=dev)
    return a + 4.0 * n**0.5 * torch.eye(n, device=dev)


def inverse_resid(a, x):
    """max|A X - I| per matrix, in float64."""
    eye = torch.eye(a.shape[-1], device=a.device, dtype=torch.float64)
    return (a.double() @ x.double() - eye).abs().amax(dim=(1, 2))


def compare_inverse(x, bad, x_ref, bad_ref, level3):
    """(max relative difference over the unflagged matrices and the
    level-3 ones, max absolute difference there, what else differs or
    None): flags and non-finite pattern must agree exactly."""
    if not torch.equal(bad, bad_ref):
        return 0.0, 0.0, f"flags {bad.nonzero().flatten().tolist()} vs " \
            f"{bad_ref.nonzero().flatten().tolist()}"
    if not torch.equal(torch.isfinite(x), torch.isfinite(x_ref)):
        return 0.0, 0.0, "non-finite entries differ"
    use = ~bad
    use[level3] = True
    diff = (x - x_ref).abs().amax(dim=(1, 2))[use]
    rel = diff / x_ref.abs().amax(dim=(1, 2))[use].clamp_min(1e-30)
    return float(rel.max()), float(diff.max()), None


def hold_pivoted(arr, tol, what):
    """The pivoted kernel against its plain version on ``arr`` with the
    thresholds ``tol``: perm and the non-finite pattern equal, reduced
    array and pivots within TOL_KERNEL of each matrix's largest entry.
    Returns the max absolute difference of the reduced arrays."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    r = gj.gauss_jordan_tiled(arr, tol)
    torch.cuda.synchronize()
    ref = gj.gauss_jordan_reference(arr, tol)
    fin = torch.isfinite(r.reduced)
    same = (torch.equal(r.perm, ref.perm)
            and torch.equal(fin, torch.isfinite(ref.reduced))
            and torch.equal(torch.isfinite(r.pivots),
                            torch.isfinite(ref.pivots)))
    ok = fin.flatten(1).all(dim=1)
    diff = (r.reduced - ref.reduced).abs().amax(dim=(1, 2))[ok]
    scale = ref.reduced.abs().amax(dim=(1, 2))[ok]
    rel = float((diff / scale.clamp_min(1e-30)).max())
    pd = (r.pivots - ref.pivots).abs().amax(dim=1)[ok]
    prel = float((pd / ref.pivots.abs().amax(dim=1)[ok].clamp_min(1e-30))
                 .max())
    print(f"pivoted kernel vs plain {what} [{arr.shape[1]}, {arr.shape[2]}]: "
          f"perm and non-finite pattern equal {same}, max rel diff reduced "
          f"{rel:.3e} pivots {prel:.3e} (tol {TOL_KERNEL})")
    if not (same and rel <= TOL_KERNEL and prel <= TOL_KERNEL):
        raise AssertionError("pivoted kernel disagrees with plain version")
    return float(diff.max())


def check_inverse_kernels(dev):
    """Phase 6: both inverse kernels against their plain versions.
    Returns (kernel 2's, kernel 3's) max absolute difference at the
    bench shape."""
    from linalg_solver_tpu_torch.ops import rbt
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.utils import systems

    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    errs = {"inv_rbt": 0.0}
    for bsz, n in INV_SHAPES:
        draw = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
        redraw = rbt.default_diags(n, rbt.RESCUE_SEEDS, str(dev))
        probe = rbt.default_probe(n, str(dev))
        a = systems.inverse_probe_batch(
            inverse_batch(bsz, n, 200 + n, dev), draw, redraw)
        x, bad = inv_rbt.inverse_rbt_fused(a, draw, redraw, probe)
        torch.cuda.synchronize()
        x_ref, bad_ref = inv_rbt.inverse_rbt_fused_reference(
            a, draw, redraw, probe)
        rel, abs_err, why = compare_inverse(x, bad, x_ref, bad_ref, 6)
        flagged = bad.nonzero().flatten().tolist()
        print(f"inverse kernel vs plain B={bsz} N={n} (variant "
              f"{inv_rbt.variant(n)}): max rel diff {rel:.3e} (tol "
              f"{TOL_KERNEL}), flagged {flagged} (6: level 3)")
        if why is not None or not rel <= TOL_KERNEL:
            raise AssertionError(f"inverse kernel disagrees with plain "
                                 f"version: {why or rel}")
        if flagged != systems.INVERSE_FLAGGED:
            raise AssertionError(f"flagged {flagged}, expected "
                                 f"{systems.INVERSE_FLAGGED}")
        errs["inv_rbt"] = max(errs["inv_rbt"], abs_err)
        if n == 64 and bsz == 8:
            # the same check must fail for the kernel without levels 2-3
            x0, bad0 = inv_rbt.inverse_rbt_fused(
                a, draw, redraw, probe, rescue=False)
            rel0, _, why0 = compare_inverse(x0, bad0, x_ref, bad_ref, 6)
            print(f"control, inverse kernel rescue=False vs plain "
                  f"rescue=True B=8 N=64: max rel diff {rel0:.3e} (must "
                  f"exceed {TOL_KERNEL}) or flags differ: {why0}")
            if why0 is None and not rel0 > TOL_KERNEL:
                raise AssertionError("the inverse check cannot see a "
                                     "kernel without its rescue")

        if n > N_INV:
            continue
        # the pivoted kernel on [A | I] of the same batch, with per-matrix
        # thresholds, and on the square batch (the det / rank width)
        eye = torch.eye(n, device=dev).expand(bsz, n, n)
        tol = torch.zeros(bsz, device=dev)
        tol[3] = 1e-2
        errs["gauss_jordan"] = max(
            errs.get("gauss_jordan", 0.0),
            hold_pivoted(torch.cat([a, eye], dim=2), tol, f"B={bsz}"),
            hold_pivoted(a, tol, f"B={bsz}"))
    variants = sorted({inv_rbt.variant(n) for _, n in INV_SHAPES})
    if variants != sorted(inv_rbt.VARIANTS):
        raise AssertionError(f"phase 6 reached kernel-2 variants {variants} "
                             f"only")
    assert not gj.fits(180, 360)  # 172 and 180 are kernel 2's alone
    return errs


def drive_inverse_path(dev):
    """Phase 7: the inverse path at the bench shape, then its rescue
    cases.  Returns the number of launches of the fused kernel."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.utils import systems

    a = inverse_batch(B_INV, N_INV, 0, dev)
    inv_rbt.LAUNCHES = gj.LAUNCHES = 0
    x = dispatch.inverse_batched(a, backend="auto")
    torch.cuda.synchronize()
    launches = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    resid = float(inverse_resid(a, x).max())
    print(f"inverse path inverse_batched(auto) B={B_INV} N={N_INV}: launches "
          f"fused {launches[0]} pivoted {launches[1]}, worst max|AX - I| "
          f"{resid:.3e} (tol {TOL_INV}), x {tuple(x.shape)}")
    if launches != (1, 0):
        raise AssertionError(f"expected one fused launch and no pivoted "
                             f"one, got {launches}")
    if x.shape != a.shape or not bool(torch.isfinite(x).all()):
        raise AssertionError("inverse has the wrong shape or non-finite "
                             "values")
    if not resid <= TOL_INV:
        raise AssertionError(f"inverse residual {resid}")

    draw = rbt.default_diags(N_INV, rbt.MAIN_SEEDS, str(dev))
    redraw = rbt.default_diags(N_INV, rbt.RESCUE_SEEDS, str(dev))
    a2 = a.clone()
    a2[5, :16, :16] = 0.0                  # zero leading minor: level 1
    a2[9] = systems.two_draw_zero_pivot_system(a[9], draw, redraw)
    a2[12] = 0.0                           # singular
    inv_rbt.LAUNCHES = gj.LAUNCHES = 0
    x2 = dispatch.inverse_batched(a2, backend="auto")
    torch.cuda.synchronize()
    launches2 = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    x3, bad = inv_rbt.inverse_rbt_fused_batched(a2, return_flags=True)
    r2 = inverse_resid(a2, x2)
    others = [i for i in range(B_INV) if i not in (5, 9, 12)]
    same = all(torch.equal(x2[i], x[i]) for i in others)
    flagged = bad.nonzero().flatten().tolist()
    print(f"inverse rescue: launches fused {launches2[0]} pivoted "
          f"{launches2[1]}, zero-minor max|AX - I| {float(r2[5]):.3e}, "
          f"two-draw (level 3) {float(r2[9]):.3e}, flagged {flagged}, "
          f"other matrices bitwise unchanged={same}")
    if launches2 != (1, 0):
        raise AssertionError(f"the rescue left the kernel: {launches2}")
    if not (float(r2[5]) <= 1e-2 and float(r2[9]) <= TOL_INV):
        raise AssertionError("the rescue left an invertible matrix wrong")
    if flagged != [9, 12] or not torch.equal(x3, x2):
        raise AssertionError("flags of the rescue case are wrong")
    if not same:
        raise AssertionError("the rescue changed a matrix it was not given")

    # the reach: N = 180, past an [n, 2n] tile's shared memory
    n = INV_REACH
    a3 = inverse_batch(B_INV, n, 3, dev)
    inv_rbt.LAUNCHES = gj.LAUNCHES = 0
    x4 = dispatch.inverse_batched(a3, backend="auto")
    torch.cuda.synchronize()
    launches3 = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    r3 = float(inverse_resid(a3, x4).max())
    print(f"inverse path inverse_batched(auto) B={B_INV} N={n}: launches "
          f"fused {launches3[0]} pivoted {launches3[1]}, worst max|AX - I| "
          f"{r3:.3e} (tol {TOL_INV})")
    if launches3 != (1, 0):
        raise AssertionError(f"expected one fused launch at N={n}, got "
                             f"{launches3}")
    if not (bool(torch.isfinite(x4).all()) and r3 <= TOL_INV):
        raise AssertionError(f"inverse at N={n} gave a wrong result")
    return launches[0] + launches3[0]


def drive_pivoted_path(dev):
    """Phase 8: the pivoted kernel through the facade, then held against
    its plain version on the arrays the path gave it.  Returns its
    launches and the max absolute difference."""
    from linalg_solver_tpu_torch.ops import dispatch
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt

    n = 63
    a = inverse_batch(B_INV, n, 1, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    s = torch.eye(n, device=dev) + 0.1 * torch.randn(
        B_INV, n, n, generator=g, device=dev) / n**0.5
    low = s[:, :, :5] @ s[:, :5, :]
    rhs = torch.randn(B_INV, n, generator=g, device=dev)
    inv_rbt.LAUNCHES = gj.LAUNCHES = 0
    x = dispatch.inverse_batched(a, backend="auto")
    d = dispatch.det_batched(s, backend="auto")
    rk = dispatch.rank_batched(low, backend="auto")
    xs = dispatch.solve_batched(a, rhs, backend="auto")
    torch.cuda.synchronize()
    launches = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    resid = float(inverse_resid(a, x).max())
    s_resid = float(worst_resid(a, rhs, xs).max())
    d_ref = torch.linalg.det(s.double())
    d_rel = float(((d.double() - d_ref).abs() / d_ref.abs()).max())
    print(f"pivoted path B={B_INV} N={n}: launches fused {launches[0]} "
          f"pivoted {launches[1]}, inverse worst max|AX - I| {resid:.3e}, "
          f"det max rel err vs float64 {d_rel:.3e}, ranks "
          f"{sorted(set(rk.tolist()))}, solve_batched(auto) worst residual "
          f"{s_resid:.3e}")
    if launches != (0, 4):
        raise AssertionError(f"expected four pivoted launches, got "
                             f"{launches}")
    if not (resid <= TOL_INV and d_rel <= 1e-4 and set(rk.tolist()) == {5}
            and s_resid <= TOL_RESID):
        raise AssertionError("pivoted path gave a wrong result")

    # the kernel against its plain version on what the path gave it
    zero = torch.zeros(B_INV, device=dev)
    eye = torch.eye(n, device=dev).expand(B_INV, n, n)
    err = max(hold_pivoted(torch.cat([a, eye], dim=2), zero, "inverse path"),
              hold_pivoted(s, zero, "det path"),
              hold_pivoted(low, gj.default_rank_tol(low), "rank path"),
              hold_pivoted(torch.cat([a, rhs[:, :, None]], dim=2), zero,
                           "solve path"))
    return launches[1], err


def time_inverse(dev, card):
    """Phase 9: times at the bench shape, in ms and matrices/s."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.utils.benchmarking import (cuda_time,
                                                            device_time)

    a = inverse_batch(B_INV, N_INV, 0, dev)
    args = (a, rbt.default_diags(N_INV, rbt.MAIN_SEEDS, str(dev)),
            rbt.default_diags(N_INV, rbt.RESCUE_SEEDS, str(dev)),
            rbt.default_probe(N_INV, str(dev)))
    aug = torch.cat([a, torch.eye(N_INV, device=dev).expand_as(a)], dim=2)

    times = {
        "kernel inverse_rbt_fused, device": device_time(
            inv_rbt.inverse_rbt_fused, *args, warmup=3, iters=5),
        "kernel inverse_rbt_fused": cuda_time(
            inv_rbt.inverse_rbt_fused, *args, warmup=3, iters=20),
        "plain inverse_rbt_fused_reference": cuda_time(
            inv_rbt.inverse_rbt_fused_reference, *args, warmup=1, iters=3),
        "kernel gauss_jordan_tiled [A|I]": cuda_time(
            gj.gauss_jordan_tiled, aug, warmup=3, iters=20),
        "plain gauss_jordan_reference [A|I]": cuda_time(
            gj.gauss_jordan_reference, aug, warmup=1, iters=3),
        "gauss_jordan.inverse_batched": cuda_time(
            gj.inverse_batched, a, warmup=3, iters=20),
        "plain of gauss_jordan.inverse_batched": cuda_time(
            gj.inverse_reference, a, warmup=1, iters=3),
        "inverse_batched(auto)": cuda_time(
            dispatch.inverse_batched, a, warmup=3, iters=20),
        "torch.linalg.inv": cuda_time(
            torch.linalg.inv, a, warmup=3, iters=20),
    }
    for what, t in times.items():
        print(f"time {what}: {t * 1e3:.4f} ms, {B_INV / t:.0f} matrices/s "
              f"(B={B_INV} N={N_INV}, {card})")
    return times


def nan_equal(x, y) -> bool:
    """Bitwise equal, NaN where the other is NaN."""
    return bool(((x == y) | (x.isnan() & y.isnan())).all())


def record(module, name, keep=None):
    """Wrap ``module.name`` so that every call's positional arguments and
    result are kept (the paths look their kernels and rescue rungs up at
    each call); with ``keep``, only the first ``keep`` calls' (later ones
    add None).  Returns the list of calls and a function that takes the
    wrapper off."""
    calls = []
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, out) if keep is None or len(calls) < keep
                     else None)
        return out

    setattr(module, name, wrapped)
    return calls, lambda: setattr(module, name, orig)


def hold_panels(calls, what):
    """Kernel 5's results on ``calls`` (recorded launches) against its
    plain version: flags equal and every value bitwise equal (NaN where
    the other is NaN).  Returns (max abs diff, 0.0 when bitwise; the
    variants the calls reached)."""
    from linalg_solver_tpu_torch.ops.kernels import lu_nopivot

    err = 0.0
    for (panel, nb), (x, ok) in calls:
        ref, ok_ref = lu_nopivot.panel_factor_nopivot_reference(panel, nb)
        if not (torch.equal(ok, ok_ref) and nan_equal(x, ref)):
            raise AssertionError(f"panel kernel {what} disagrees with its "
                                 f"plain version at [{panel.shape[1]}, {nb}]")
        err = max(err, abs_diff(x, ref))
    variants = sorted({lu_nopivot.variant(p.shape[1], nb)
                       for (p, nb), _ in calls})
    print(f"panel kernel vs plain {what}: {len(calls)} launches, all bitwise "
          f"equal with equal flags (max abs diff {err:.3e}), variants "
          f"{variants}")
    return err, variants


def abs_diff(x, ref) -> float:
    """Max |x - ref| where both are finite."""
    both = torch.isfinite(x) & torch.isfinite(ref)
    return float((x - ref)[both].abs().max()) if both.any() else 0.0


def hold_butterflies(calls, what):
    """Kernel 4's results on ``calls`` against its plain version, bitwise.
    Returns the max absolute difference (0.0 when bitwise)."""
    from linalg_solver_tpu_torch.ops.kernels import butterfly

    err = 0.0
    for args, x in calls:
        ref = butterfly.butterfly_two_sided_reference(*args)
        if not nan_equal(x, ref):
            raise AssertionError(f"butterfly kernel disagrees with plain "
                                 f"version {what}")
        err = max(err, abs_diff(x, ref))
    print(f"butterfly kernel vs plain {what}: {len(calls)} launches, all "
          f"bitwise equal (max abs diff {err:.3e})")
    return err


def check_phase_kernels(dev):
    """Phase 10: kernels 4 and 5 against their plain versions.  Returns
    kernel 4's max absolute difference."""
    from linalg_solver_tpu_torch.ops import rbt
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot

    err = 0.0
    for n, bsz in ((64, 8), (256, B), (896, 8)):
        a = inverse_batch(bsz, n, 300 + n, dev)
        a[1, 2, 3] = float("inf")
        U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
        for depth in (1, 2):
            for trans in (True, False):
                x = butterfly.butterfly_two_sided(a, U, V, depth, trans, trans)
                torch.cuda.synchronize()
                ref = butterfly.butterfly_two_sided_reference(
                    a, U, V, depth, trans, trans)
                same = nan_equal(x, ref)
                print(f"butterfly kernel vs plain B={bsz} N={n} depth={depth} "
                      f"trans={trans}: bitwise equal {same}")
                if not same:
                    raise AssertionError("butterfly kernel disagrees with its "
                                         "plain version")
                err = max(err, abs_diff(x, ref))
        if n == 256:
            # the same check must fail for the kernel with its sides flipped
            x0 = butterfly.butterfly_two_sided(a, U, V, 2, False, False)
            ref = butterfly.butterfly_two_sided_reference(a, U, V, 2, True,
                                                          True)
            miss = float((x0 - ref)[2:].abs().max())
            print(f"control, butterfly kernel trans=False vs plain trans=True "
                  f"N=256: max abs diff {miss:.3e} (must exceed 1e-2)")
            if not miss > 1e-2:
                raise AssertionError("the butterfly check cannot see a "
                                     "flipped side")

    calls = []
    for m, nb in ((40, 8), (256, 32), (224, 32), (256, 64), (192, 64),
                  (896, 64)):
        g = torch.Generator(device=dev).manual_seed(m + nb)
        p = torch.randn(6, m, nb, generator=g, device=dev)
        p[:, torch.arange(nb), torch.arange(nb)] += 4.0 * nb**0.5
        p[1, :, 3] = 0.0                    # a zero pivot
        p[2, 5, 1] = float("nan")           # a NaN that reaches a pivot
        p[3, m - 1, 2] = float("inf")       # an Inf below the square part
        p[4, 2, 2] = float("nan")           # a NaN pivot
        out = lu_nopivot.panel_factor_nopivot(p, nb)
        torch.cuda.synchronize()
        if out[1].tolist() != [True, False, False, False, False, True]:
            raise AssertionError(f"panel kernel flags {out[1].tolist()}")
        calls.append(((p, nb), out))
    _, variants = hold_panels(calls, "on probe panels (zero-pivot, NaN and "
                              "Inf lanes included)")
    if variants != sorted(lu_nopivot.VARIANTS):
        raise AssertionError(f"phase 10 reached kernel-5 variants {variants} "
                             f"only")
    # the same check must fail against a plain version without the one-hot
    # pivot rule, in each register variant
    for (p, nb), (x, ok) in calls[1:4:2]:
        y, ok0 = lu_nopivot.panel_factor_nopivot_reference(p, nb,
                                                           one_hot=False)
        same = nan_equal(x, y) and torch.equal(ok, ok0)
        print(f"control, panel kernel vs plain without the one-hot rule "
              f"[{p.shape[1]}, {nb}] (variant "
              f"{lu_nopivot.variant(p.shape[1], nb)}): equal {same} (must "
              f"not be)")
        if same:
            raise AssertionError("the kernel-5 check cannot see a dropped "
                                 "one-hot rule")
    return err


def phase_compare(x, bad, x_ref, bad_ref):
    """(max relative difference over the unflagged systems, what else
    differs or None) of two phase solves: flags equal, and the unflagged
    systems finite in both."""
    if not torch.equal(bad, bad_ref):
        return 0.0, f"flags {bad.tolist()} vs {bad_ref.tolist()}"
    use = ~bad
    if not (bool(torch.isfinite(x[use]).all())
            and bool(torch.isfinite(x_ref[use]).all())):
        return 0.0, "an unflagged system is not finite"
    diff = (x - x_ref).abs().amax(dim=(1, 2))[use]
    rel = diff / x_ref.abs().amax(dim=(1, 2))[use].clamp_min(1e-30)
    return float(rel.max()), None


def check_phase_solve(dev):
    """Phase 11: the phase solve on the card against the same engine on
    the CPU (plain versions), f32 glue; and the control without
    refinement."""
    from linalg_solver_tpu_torch.ops import rbt

    n = 64
    du, dv = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
    a, b = probe_batch(8, n, K_PHASE, du, dv, dev)
    x, bad = rbt._solve_core(a, b, (du, dv), 16, 2, "float32")
    torch.cuda.synchronize()
    x_ref, bad_ref = rbt._solve_core(a.cpu(), b.cpu(), (du.cpu(), dv.cpu()),
                                     16, 2, "float32")
    rel, why = phase_compare(x.cpu(), bad.cpu(), x_ref, bad_ref)
    flagged = bad.nonzero().flatten().tolist()
    print(f"phase solve card vs CPU plain B=8 N={n} k={K_PHASE} nb=16: max "
          f"rel diff {rel:.3e} (tol {TOL_KERNEL}), flagged {flagged}")
    if why is not None or not rel <= TOL_KERNEL or flagged != FLAGGED:
        raise AssertionError(f"phase solve disagrees with the plain path: "
                             f"{why or rel}, flagged {flagged}")
    x0, bad0 = rbt._solve_core(a, b, (du, dv), 16, 0, "float32")
    rel0 = float((x0[7].cpu() - x_ref[7]).abs().max() / x_ref[7].abs().max())
    print(f"control, phase solve ir_steps=0 vs plain ir_steps=2: small-pivot "
          f"system 7 max rel diff {rel0:.3e} (must exceed {TOL_KERNEL}), "
          f"flagged by the card {bool(bad0[7])}, by the plain path "
          f"{bool(bad_ref[7])}")
    if bool(bad_ref[7]) or not rel0 > TOL_KERNEL:
        raise AssertionError("the phase check cannot see a solve without "
                             "refinement")


def phase_counts():
    """Launches of kernels 1-6 and the AED window kernel since
    ``reset_counts`` (the chase kernel's are ``schur_chase.LAUNCHES``,
    read by the Schur phases)."""
    from linalg_solver_tpu_torch.ops.kernels import butterfly, gauss_jordan
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_nopivot
    from linalg_solver_tpu_torch.ops.kernels import lu_panel, schur_window
    from linalg_solver_tpu_torch.ops.kernels import solve_fused

    return {"fused": solve_fused.LAUNCHES, "inv_rbt": inv_rbt.LAUNCHES,
            "gauss_jordan": gauss_jordan.LAUNCHES,
            "butterfly": butterfly.LAUNCHES, "lu_nopivot": lu_nopivot.LAUNCHES,
            "lu_panel": lu_panel.LAUNCHES,
            "schur_window": schur_window.LAUNCHES}


def reset_counts():
    from linalg_solver_tpu_torch.ops.kernels import butterfly, gauss_jordan
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_nopivot
    from linalg_solver_tpu_torch.ops.kernels import lu_panel, schur_chase
    from linalg_solver_tpu_torch.ops.kernels import schur_window, solve_fused

    for mod in (solve_fused, inv_rbt, gauss_jordan, butterfly, lu_nopivot,
                lu_panel, schur_chase, schur_window):
        mod.LAUNCHES = 0


def drive_phase_paths(dev):
    """Phase 12: the phase engine's solve and inverse paths at B=N=256,
    the reach check at N=896, the kernels against their plain versions on
    what the paths gave them, then the rescue cases.  Returns the launch
    counts, the max abs differences and the solve's panel launches."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot
    from linalg_solver_tpu_torch.utils import systems

    a, b = phase_batch(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    out = {}

    # the solve path, k = 16
    bf_calls, bf_off = record(butterfly, "butterfly_two_sided")
    lu_calls, lu_off = record(lu_nopivot, "panel_factor_nopivot")
    reset_counts()
    x = dispatch.solve_batched(a, b, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    bf_off()
    lu_off()
    resid = float(worst_resid(a, b, x).max())
    print(f"phase solve path solve_batched(auto) B={B} N={N} k={K_PHASE}: "
          f"launches {counts}, worst residual {resid:.3e} (tol {TOL_RESID}), "
          f"x {tuple(x.shape)}")
    want = {"fused": 0, "inv_rbt": 0, "gauss_jordan": 0, "butterfly": 1,
            "lu_nopivot": N // 32, "lu_panel": 0, "schur_window": 0}
    if counts != want:
        raise AssertionError(f"expected launches {want} (no rescue)")
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        raise AssertionError("phase solve has the wrong shape or non-finite "
                             "values")
    if not resid <= TOL_RESID:
        raise AssertionError(f"phase solve residual {resid}")
    out["butterfly_err"] = hold_butterflies(bf_calls, "on the solve path")
    out["panel_err"], _ = hold_panels(lu_calls, "on the solve path")
    out["solve_panels"] = [args for args, _ in lu_calls]
    out["butterfly_launches"] = counts["butterfly"]
    out["panel_launches"] = counts["lu_nopivot"]

    # the inverse path, N = 256
    bf_calls, bf_off = record(butterfly, "butterfly_two_sided")
    lu_calls, lu_off = record(lu_nopivot, "panel_factor_nopivot")
    reset_counts()
    xi = dispatch.inverse_batched(a, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    bf_off()
    lu_off()
    r_inv = float(inverse_resid(a, xi).max())
    print(f"phase inverse path inverse_batched(auto) B={B} N={N}: launches "
          f"{counts}, worst max|AX - I| {r_inv:.3e} (tol {TOL_INV})")
    want = {"fused": 0, "inv_rbt": 0, "gauss_jordan": 0, "butterfly": 2,
            "lu_nopivot": N // 64, "lu_panel": 0, "schur_window": 0}
    if counts != want:
        raise AssertionError(f"expected launches {want} (no rescue)")
    if not (bool(torch.isfinite(xi).all()) and r_inv <= TOL_INV):
        raise AssertionError(f"phase inverse residual {r_inv}")
    out["butterfly_err"] = max(
        out["butterfly_err"], hold_butterflies(bf_calls, "on the inverse path"))
    out["panel_err"] = max(out["panel_err"],
                           hold_panels(lu_calls, "on the inverse path")[0])
    out["butterfly_launches"] += counts["butterfly"]
    out["panel_launches"] += counts["lu_nopivot"]

    # the reach check: N = 896 at k = 1 is past the fused kernel
    a8 = inverse_batch(8, N_REACH, 9, dev)
    b8 = torch.randn(8, N_REACH, generator=g, device=dev)
    reset_counts()
    x8 = dispatch.solve_batched(a8, b8, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    r8 = float(worst_resid(a8, b8, x8).max())
    print(f"reach check solve_batched(auto) B=8 N={N_REACH} k=1: launches "
          f"{counts}, worst residual {r8:.3e} (tol {TOL_RESID})")
    if counts["fused"] or counts["butterfly"] != 1 or not r8 <= TOL_RESID:
        raise AssertionError("the reach check failed")

    # rescue cases of the solve path
    draw = rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev))
    a2 = a.clone()
    a2[5] = systems.zero_minor_system(a[5])    # full rank: solved
    a2[9] = 0.0                                # singular: non-finite
    a2[12] = systems.pivot_system(a[12], *draw, 0.0)   # the redraw solves it
    reset_counts()
    x2 = dispatch.solve_batched(a2, b, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    r2 = worst_resid(a2, b, x2)
    others = [i for i in range(B) if i not in (5, 9, 12)]
    same = all(torch.equal(x2[i], x[i]) for i in others)
    print(f"phase solve rescue: launches {counts}, zero-minor residual "
          f"{float(r2[5]):.3e}, redraw system residual {float(r2[12]):.3e}, "
          f"singular system finite={bool(torch.isfinite(x2[9]).all())}, other "
          f"systems bitwise unchanged={same}")
    if counts["butterfly"] != 2:
        raise AssertionError("the rescue did not rerun the phase engine once")
    if not float(r2[[5, 12]].max()) <= TOL_RESID:
        raise AssertionError("rescue left a solvable system unsolved")
    if bool(torch.isfinite(x2[9]).all()) or not same:
        raise AssertionError("singular system finite, or another changed")

    # rescue cases of the inverse path
    redraw = rbt.default_diags(N, rbt.RESCUE_SEEDS, str(dev))
    a3 = a.clone()
    a3[5] = systems.zero_minor_system(a[5])
    a3[9] = systems.two_draw_zero_pivot_system(a[9], draw, redraw)
    a3[12] = 0.0
    reset_counts()
    x3 = dispatch.inverse_batched(a3, backend="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    r3 = inverse_resid(a3, x3)
    same = all(torch.equal(x3[i], xi[i]) for i in others)
    print(f"phase inverse rescue: launches {counts}, zero-minor max|AX - I| "
          f"{float(r3[5]):.3e}, two-draw (pivoted) {float(r3[9]):.3e}, "
          f"singular finite={bool(torch.isfinite(x3[12]).all())}, other "
          f"matrices bitwise unchanged={same}")
    if counts["butterfly"] != 4 or not float(r3[[5, 9]].max()) <= TOL_INV:
        raise AssertionError("the inverse rescue failed")
    if bool(torch.isfinite(x3[12]).all()) or not same:
        raise AssertionError("singular matrix finite, or another changed")
    return out


def time_phase(dev, card, panels):
    """Phase 13: times at B=N=256."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot
    from linalg_solver_tpu_torch.utils.benchmarking import (cuda_time,
                                                            device_time)

    a = inverse_batch(B, N, 7, dev)
    b = torch.randn(B, N, K_PHASE, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev)
    U, V = rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev))
    panels = [(p.contiguous(), nb) for p, nb in panels]

    def panel_kernels():
        for p, nb in panels:
            lu_nopivot.panel_factor_nopivot(p, nb)

    def panel_plain():
        for p, nb in panels:
            lu_nopivot.panel_factor_nopivot_reference(p, nb)

    def panel_library():
        for p, nb in panels:
            torch.linalg.lu_factor_ex(p, pivot=False)

    times = {
        "kernel panel_factor_nopivot, the 8 solve panels, device": device_time(
            panel_kernels, warmup=3, iters=5),
        "kernel butterfly_two_sided, device": device_time(
            butterfly.butterfly_two_sided, a, U, V, 2, warmup=3, iters=5),
        "kernel butterfly_two_sided": cuda_time(
            butterfly.butterfly_two_sided, a, U, V, 2, warmup=3, iters=20),
        "plain butterfly_two_sided_reference": cuda_time(
            butterfly.butterfly_two_sided_reference, a, U, V, 2, warmup=1,
            iters=5),
        "kernel panel_factor_nopivot, the 8 solve panels": cuda_time(
            panel_kernels, warmup=3, iters=20),
        "plain panel_factor_nopivot_reference, the 8 solve panels": cuda_time(
            panel_plain, warmup=1, iters=3),
        "library lu_factor_ex(pivot=False), the 8 solve panels": cuda_time(
            panel_library, warmup=2, iters=10),
        f"solve_batched(auto) k={K_PHASE}": cuda_time(
            dispatch.solve_batched, a, b, warmup=3, iters=10),
        f"torch.linalg.solve k={K_PHASE}": cuda_time(
            torch.linalg.solve, a, b, warmup=3, iters=10),
        "inverse_batched(auto) N=256": cuda_time(
            dispatch.inverse_batched, a, warmup=3, iters=10),
        "torch.linalg.inv N=256": cuda_time(
            torch.linalg.inv, a, warmup=3, iters=10),
    }
    for what, t in times.items():
        print(f"time {what}: {t * 1e3:.4f} ms (B={B} N={N}, {card})")
    return times


def hold_masked(calls, what):
    """Kernel 6's results on ``calls`` (recorded launches) against its
    plain version: all five outputs bitwise equal (NaN where the other
    is NaN).  Returns the max absolute difference of the panels (0.0 when
    bitwise)."""
    from linalg_solver_tpu_torch.ops.kernels import lu_panel

    err = 0.0
    for args, out in calls:
        ref = lu_panel.panel_factor_masked_reference(*args)
        if not all(nan_equal(x, y) for x, y in zip(out, ref)):
            raise AssertionError(f"kernel 6 disagrees with its plain version "
                                 f"{what} at {tuple(args[0].shape)}")
        err = max(err, abs_diff(out[0], ref[0]))
    print(f"kernel 6 vs plain {what}: {len(calls)} launches, all five outputs "
          f"bitwise equal (max abs diff {err:.3e})")
    return err


def masked_panels(bsz, n, nb, frac, dev):
    """Gaussian panels with about ``frac`` of the rows pre-pivoted; panel
    0 has a zero column 1 (no pivot at step 1), panel 1 a NaN, panel 3 an
    Inf in its first pre-pivoted row (which reaches the pivot rows of its
    column only through the one-hot reads)."""
    g = torch.Generator(device=dev).manual_seed(400 + n + nb)
    p = torch.randn(bsz, n, nb, generator=g, device=dev)
    m = (torch.rand(bsz, n, generator=g, device=dev) < frac).to(torch.int32)
    p[0, :, 1] = 0.0
    p[1, 5, 2] = float("nan")
    pre = m[3].nonzero().flatten()
    if len(pre):
        p[3, int(pre[0]), nb // 2] = float("inf")
    return p, m


def check_panel_kernel(dev):
    """Phase 14: kernel 6 against its plain version on synthetic panels
    that reach every variant (``lu_panel.VARIANTS``), and the control
    without the mask.  Returns the max abs difference."""
    from linalg_solver_tpu_torch.ops.kernels import lu_panel

    calls = []
    for bsz, n, nb, frac in ((B, N, 64, 0.0), (B, N, 64, 0.4),
                             (B, 96, 32, 0.4), (8, N_PANEL_REACH, 32, 0.3),
                             (8, 889, 64, 0.2)):
        p, m = masked_panels(bsz, n, nb, frac, dev)
        out = lu_panel.panel_factor_masked(p, m, nb)
        torch.cuda.synchronize()
        if out[4][:3].tolist() != [False, False, True]:
            raise AssertionError(f"kernel 6 flags {out[4][:3].tolist()}")
        calls.append(((p, m, nb), out))
    variants = sorted({lu_panel.variant(p.shape[1], nb)
                       for (p, _, nb), _ in calls})
    err = hold_masked(calls, f"on random panels (zero-column, NaN and "
                      f"pre-pivoted-Inf lanes included; variants {variants})")
    if variants != sorted(lu_panel.VARIANTS):
        raise AssertionError(f"phase 14 reached variants {variants} only")
    (p, m, nb), _ = calls[1]
    out = lu_panel.panel_factor_masked(p, torch.zeros_like(m), nb)
    ref = lu_panel.panel_factor_masked_reference(p, m, nb)
    same = [nan_equal(x, y) for x, y in zip(out, ref)]
    print(f"control, kernel 6 without the mask vs plain with it: outputs "
          f"equal {same} (must not all be)")
    if all(same):
        raise AssertionError("the kernel-6 check cannot see a dropped mask")
    return err


def offset_gaussian(n, g, dev):
    """A Gaussian matrix plus 100 in every entry: condition number ~4e5,
    and the rank-one part drowns the rest in a TF32 product, so the mixed
    path cannot refine it (its final residual stays ~0.3 of max(|b|,
    |A||x|) on an H100); the pivoted f32 rung solves it."""
    return torch.randn(n, n, generator=g, device=dev) + 100.0


def inf_norm(x):
    """Per-matrix max row sum of |x|, in float64."""
    return x.double().abs().sum(dim=2).amax(dim=1)


def drive_panel_paths(dev):
    """Phase 15: kernel 6's paths at B=N=256 with kernel 6 held against
    its plain version on what each gave it, the mixed rescue and the
    N=960 reach.  Returns the launches, the max abs difference and the
    mixed path's panel calls."""
    from linalg_solver_tpu_torch.ops import dispatch, lu_blocked
    from linalg_solver_tpu_torch.ops.kernels import lu_panel

    out = {"launches": 0, "err": 0.0}
    a, b = bench_batch(dev)
    only6 = {"fused": 0, "inv_rbt": 0, "gauss_jordan": 0, "butterfly": 0,
             "lu_nopivot": 0, "lu_panel": N // 64, "schur_window": 0}

    # the mixed solve, k = 1; the pivoted rung must not be called
    calls, off = record(lu_panel, "panel_factor_masked")
    rescued, off_rescue = record(lu_blocked, "blocked_solve_batched")
    reset_counts()
    x = dispatch.solve_batched(a, b, backend="mixed")
    torch.cuda.synchronize()
    counts = phase_counts()
    off()
    off_rescue()
    resid = float(worst_resid(a, b, x).max())
    print(f"mixed path solve_batched(mixed) B={B} N={N} k=1: launches "
          f"{counts}, systems rescued {len(rescued)}, worst residual "
          f"{resid:.3e} (tol {TOL_RESID})")
    if counts != only6:
        raise AssertionError(f"expected launches {only6}")
    if rescued:
        raise AssertionError("the mixed path rescued a system of the bench "
                             "batch")
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        raise AssertionError("mixed solve has the wrong shape or non-finite "
                             "values")
    if not resid <= TOL_RESID:
        raise AssertionError(f"mixed solve residual {resid}")
    out["err"] = hold_masked(calls, "on the mixed solve path")
    out["launches"] += counts["lu_panel"]
    out["panels"] = [args for args, _ in calls]

    # the determinant
    s = det_batch(dev)
    calls, off = record(lu_panel, "panel_factor_masked")
    reset_counts()
    d = dispatch.det_batched(s)
    torch.cuda.synchronize()
    counts = phase_counts()
    off()
    want = torch.linalg.det(s.double().cpu())
    keep = [i for i in range(B) if i != 3]
    rel = float(((d.double().cpu() - want) / want).abs()[keep].max())
    signs = bool((torch.sign(d.cpu()[keep]) == torch.sign(want[keep])).all())
    print(f"det path det_batched(auto) B={B} N={N}: launches {counts}, max "
          f"rel err vs float64 {rel:.3e} (tol {TOL_DET}), signs equal "
          f"{signs}, singular lane {float(d[3])}")
    if counts != only6:
        raise AssertionError(f"expected launches {only6}")
    if not (rel <= TOL_DET and signs and float(d[3]) == 0.0):
        raise AssertionError("det path gave a wrong result")
    out["err"] = max(out["err"], hold_masked(calls, "on the det path"))
    out["launches"] += counts["lu_panel"]
    out["det_input"] = s

    # the packed factorization
    calls, off = record(lu_panel, "panel_factor_masked")
    reset_counts()
    res = dispatch.lu_factor_batched(a)
    torch.cuda.synchronize()
    counts = phase_counts()
    off()
    lu = res.lu.double()
    lo = torch.tril(lu, -1) + torch.eye(N, device=dev, dtype=torch.float64)
    pa = a.double().gather(1, res.perm.long()[:, :, None].expand(-1, -1, N))
    rel = float((inf_norm(lo @ torch.triu(lu) - pa) / inf_norm(a)).max())
    print(f"lu_factor path lu_factor_batched(auto) B={B} N={N}: launches "
          f"{counts}, max |PA - LU|_inf / |A|_inf {rel:.3e} (tol 1e-5), ok "
          f"{bool(res.ok.all())}")
    if counts != only6 or not (rel <= 1e-5 and bool(res.ok.all())):
        raise AssertionError("lu_factor path gave a wrong result")
    out["err"] = max(out["err"], hold_masked(calls, "on the lu_factor path"))
    out["launches"] += counts["lu_panel"]

    # the mixed path's rescue: system 7 is one the TF32 factorization
    # cannot refine; the pivoted f32 rung solves it
    g = torch.Generator(device=dev).manual_seed(12)
    a2 = a.clone()
    a2[7] = offset_gaussian(N, g, dev)
    rescued, off_rescue = record(lu_blocked, "blocked_solve_batched")
    reset_counts()
    x2 = dispatch.solve_batched(a2, b, backend="mixed")
    torch.cuda.synchronize()
    counts = phase_counts()
    off_rescue()
    x0 = lu_blocked.pallas_solve_mixed_batched(a2, b, nb=64, fallback=False)
    rung = lu_blocked.blocked_solve_batched(a2[7:8], b[7:8], ir_steps=2)
    r7 = (a2[7].double() @ x2[7].double() - b[7].double()).abs().max()
    scale = max(float(b[7].abs().max()),
                float(a2[7].abs().max() * x2[7].abs().max()))
    others = [i for i in range(B) if i != 7]
    same = all(torch.equal(x2[i], x[i]) for i in others)
    taken = torch.equal(x2[7:8], rung) and not torch.equal(x2[7], x0[7])
    print(f"mixed rescue: launches {counts}, offset-Gaussian system residual "
          f"{float(r7) / scale:.3e} of max(|b|, |A||x|) (tol {TOL_RESID}), "
          f"solved by the pivoted rung {taken}, systems it was given "
          f"{[c[0][0].shape[0] for c in rescued]}, other systems bitwise "
          f"unchanged {same}")
    if (counts["lu_panel"] != N // 64 or not taken or not same
            or [c[0][0].shape[0] for c in rescued] != [1]):
        raise AssertionError("the mixed rescue failed")
    if not float(r7) <= TOL_RESID * scale:
        raise AssertionError("the rescue left the offset-Gaussian system "
                             "unsolved")

    # the reach check: N = 960 takes 32-wide sub-panels (checked, not timed)
    n = N_PANEL_REACH
    s8 = torch.eye(n, device=dev) + torch.randn(
        8, n, n, generator=g, device=dev) / (2 * n**0.5)
    reset_counts()
    d8 = dispatch.det_batched(s8)
    torch.cuda.synchronize()
    counts = phase_counts()
    want8 = torch.linalg.det(s8.double().cpu())
    rel8 = float(((d8.double().cpu() - want8) / want8).abs().max())
    print(f"reach check det_batched(auto) B=8 N={n}: kernel-6 launches "
          f"{counts['lu_panel']} (two 32-wide sub-panels a phase), max rel "
          f"err vs float64 {rel8:.3e} (tol {TOL_DET})")
    if counts["lu_panel"] != 2 * n // 64 or not rel8 <= TOL_DET:
        raise AssertionError("the N=960 reach check failed")
    return out


def large_batch(bsz, n, dev):
    """The large-N cell's input: the bench matrix class at N = ``n``, a
    vector RHS, seeded by ``n``."""
    g = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn(bsz, n, n, generator=g, device=dev)
    a += 4.0 * n**0.5 * torch.eye(n, device=dev)
    return a, torch.randn(bsz, n, generator=g, device=dev)


#: the large-N cells, (B, N)
LARGE_CELLS = ((16, 1024), (8, 2048))


def drive_large_paths(dev):
    """Phase 16: the large-N solve at N = 1024 and 2048, kernel 4 held
    against its plain version on the array the path gave it, and no system
    left to the pivoted rung.  Returns the kernel-4 launches, the max abs
    difference and the batches."""
    from linalg_solver_tpu_torch.ops import dispatch, lu_large
    from linalg_solver_tpu_torch.ops.kernels import butterfly

    launches, err, batches = 0, 0.0, {}
    for bsz, n in LARGE_CELLS:
        a, b = large_batch(bsz, n, dev)
        calls, off = record(butterfly, "butterfly_two_sided")
        rescued, off_rescue = record(lu_large, "large_solve_mixed")
        reset_counts()
        x = dispatch.solve_batched(a, b)
        torch.cuda.synchronize()
        counts = phase_counts()
        off()
        off_rescue()
        resid = float(worst_resid(a, b, x).max())
        print(f"large path solve_batched(auto) B={bsz} N={n}: launches "
              f"{counts}, systems rescued {len(rescued)}, worst residual "
              f"{resid:.3e} (tol {TOL_RESID})")
        want = {"fused": 0, "inv_rbt": 0, "gauss_jordan": 0, "butterfly": 1,
                "lu_nopivot": 0, "lu_panel": 0, "schur_window": 0}
        if counts != want:
            raise AssertionError(f"expected launches {want}")
        if rescued:
            raise AssertionError("the large-N solve left a system of the "
                                 "bench class to the pivoted rung")
        if not (bool(torch.isfinite(x).all()) and resid <= TOL_RESID):
            raise AssertionError(f"large solve residual {resid}")
        err = max(err, hold_butterflies(calls, f"on the large path N={n}"))
        launches += counts["butterfly"]
        batches[n] = (a, b)
    return launches, err, batches


def drive_library_routes(dev):
    """Phase 16, end: the shapes ``auto`` gives ``torch.linalg`` from
    N = 1024, as the reference gives them ``jnp.linalg``: the solve at
    N = 1088 (N % 128 != 0), the inverse and the det at N = 1024.  No
    kernel launches; the results equal the library's calls."""
    from linalg_solver_tpu_torch.ops import dispatch

    a, b = large_batch(2, 1088, dev)
    g = torch.Generator(device=dev).manual_seed(1024)
    s = torch.eye(1024, device=dev) + torch.randn(
        2, 1024, 1024, generator=g, device=dev) / (2 * 1024**0.5)
    reset_counts()
    x = dispatch.solve_batched(a, b)
    xi = dispatch.inverse_batched(a[:, :1024, :1024].contiguous())
    d = dispatch.det_batched(s)
    torch.cuda.synchronize()
    counts = phase_counts()
    same = (torch.equal(x, torch.linalg.solve(a, b[:, :, None])[:, :, 0])
            and torch.equal(xi, torch.linalg.inv(a[:, :1024, :1024]))
            and torch.equal(d, torch.linalg.det(s)))
    resid = float(worst_resid(a, b, x).max())
    print(f"library routes solve_batched(auto) N=1088, inverse_batched and "
          f"det_batched(auto) N=1024 (B=2): launches {counts}, equal to "
          f"torch.linalg {same}, solve worst residual {resid:.3e}")
    if any(counts.values()) or not same or not resid <= TOL_RESID:
        raise AssertionError("the library routes from N = 1024 failed")


def time_panel_paths(dev, card, panels, det_input, large):
    """Phase 17: kernel 6 over the mixed path's four panels, its plain
    version, its library yardstick, the three paths and the large
    solves."""
    from linalg_solver_tpu_torch.ops import dispatch
    from linalg_solver_tpu_torch.ops.kernels import lu_panel
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    a, b = bench_batch(dev)
    panels = [(p.contiguous(), m.contiguous(), nb) for p, m, nb in panels]
    # the library's pivoted LU of the rows each phase has left to pivot
    unpiv = [unpivoted_rows(p, m) for p, m, _ in panels]

    def kernels():
        for args in panels:
            lu_panel.panel_factor_masked(*args)

    def plain():
        for args in panels:
            lu_panel.panel_factor_masked_reference(*args)

    def library():
        for rows in unpiv:
            torch.linalg.lu_factor_ex(rows)

    times = {
        "kernel panel_factor_masked, the 4 mixed-path panels": cuda_time(
            kernels, warmup=3, iters=20),
        "plain panel_factor_masked_reference, the 4 panels": cuda_time(
            plain, warmup=1, iters=3),
        "library lu_factor_ex on the unpivoted rows, the 4 panels": cuda_time(
            library, warmup=3, iters=20),
        "solve_batched(mixed) k=1": cuda_time(
            dispatch.solve_batched, a, b, "mixed", warmup=3, iters=10),
        "torch.linalg.solve k=1": cuda_time(
            lambda a_, b_: torch.linalg.solve(a_, b_.unsqueeze(-1)), a, b,
            warmup=3, iters=10),
        "det_batched(auto)": cuda_time(
            dispatch.det_batched, det_input, warmup=3, iters=10),
        "torch.linalg.det": cuda_time(
            torch.linalg.det, det_input, warmup=3, iters=10),
        "lu_factor_batched(auto)": cuda_time(
            dispatch.lu_factor_batched, a, warmup=3, iters=10),
        "torch.linalg.lu_factor": cuda_time(
            torch.linalg.lu_factor, a, warmup=3, iters=10),
    }
    for what, t in times.items():
        print(f"time {what}: {t * 1e3:.4f} ms (B={B} N={N}, {card})")
    for n, (al, bl) in large.items():
        for what, fn in (
                (f"solve_batched(auto) N={n}", dispatch.solve_batched),
                (f"torch.linalg.solve N={n}",
                 lambda a_, b_: torch.linalg.solve(a_, b_.unsqueeze(-1)))):
            t = cuda_time(fn, al, bl, warmup=2, iters=5)
            times[what] = t
            print(f"time {what}: {t * 1e3:.4f} ms (B={al.shape[0]} N={n}, "
                  f"{card})")
    return times


#: kernel 3's large shapes: (op, B, N); the inverse's array is [A | I]
PIVOTED_LARGE = (("inverse", B_INV, 127), ("inverse", B_INV, 167),
                 ("det", B, 237))


def pivoted_work(bsz, n, w):
    """(bytes, operations) of kernel 3 on a ``[bsz, n, w]`` array: the
    array and tol read, the reduced array, perm and pivots written once;
    step j's rank-1 update of the n rows over the w - j columns not yet
    reduced (the j reduced ones hold zeros off their pivot rows), one
    multiply-add an entry: 2 n (w - j) operations."""
    return (4 * (2 * bsz * n * w + 3 * bsz * n),
            bsz * 2 * n * sum(w - j for j in range(n)))


def drive_pivoted_large(dev, card):
    """Phase 18: kernel 3 at its large shapes through the facade, held
    against its plain version, and timed beside the library.  Returns the
    launches, the max abs difference and one entry a shape."""
    from linalg_solver_tpu_torch.ops import dispatch
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    launches, err, shapes = 0, 0.0, []
    for op, bsz, n in PIVOTED_LARGE:
        if op == "inverse":
            a = inverse_batch(bsz, n, 500 + n, dev)
            arr = torch.cat([a, torch.eye(n, device=dev).expand_as(a)], dim=2)
            path, library = dispatch.inverse_batched, torch.linalg.inv
        else:
            a = arr = det_batch(dev, n)
            path, library = dispatch.det_batched, torch.linalg.det
        reset_counts()
        x = path(a)
        torch.cuda.synchronize()
        counts = phase_counts()
        if op == "inverse":
            resid = float(inverse_resid(a, x).max())
            good = bool(torch.isfinite(x).all()) and resid <= TOL_INV
            what = f"worst max|AX - I| {resid:.3e} (tol {TOL_INV})"
        else:
            want = torch.linalg.det(a.double().cpu())
            keep = [i for i in range(bsz) if i != 3]
            rel = float(((x.double().cpu() - want) / want).abs()[keep].max())
            signs = bool((torch.sign(x.cpu()[keep])
                          == torch.sign(want[keep])).all())
            good = rel <= TOL_DET and signs and float(x[3]) == 0.0
            what = (f"max rel err vs float64 {rel:.3e} (tol {TOL_DET}), "
                    f"signs equal {signs}, singular lane {float(x[3])}")
        print(f"pivoted path {op}_batched(auto) B={bsz} N={n}: launches "
              f"{counts}, {what}")
        want_counts = dict.fromkeys(counts, 0)
        want_counts["gauss_jordan"] = 1
        if counts != want_counts:
            raise AssertionError(f"expected launches {want_counts}")
        if not good:
            raise AssertionError(f"pivoted {op} at N={n} gave a wrong result")
        launches += counts["gauss_jordan"]
        tol = torch.zeros(bsz, device=dev)
        err = max(err, hold_pivoted(arr, tol, f"{op} path B={bsz}"))
        t_kernel = cuda_time(gj.gauss_jordan_tiled, arr, warmup=2, iters=10)
        t_plain = cuda_time(gj.gauss_jordan_reference, arr, warmup=0,
                            iters=1)
        t_path = cuda_time(path, a, warmup=2, iters=10)
        t_lib = cuda_time(library, a, warmup=2, iters=10)
        b_ms, b_by = bound(*pivoted_work(*arr.shape))
        for name, t in (("kernel gauss_jordan_tiled", t_kernel),
                        ("plain gauss_jordan_reference", t_plain),
                        (f"{op}_batched(auto)", t_path),
                        (f"torch.linalg.{'inv' if op == 'inverse' else op}",
                         t_lib)):
            print(f"time {name} [{arr.shape[1]}, {arr.shape[2]}]: "
                  f"{t * 1e3:.4f} ms (B={bsz}, bound {b_ms:.4f} ms "
                  f"{b_by}, {card})")
        shapes.append({"shape": list(arr.shape), "ms": t_kernel * 1e3,
                       "plain_ms": t_plain * 1e3,
                       "path_ms": t_path * 1e3, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": t_lib * 1e3,
                       "variant": gj.variant(n, arr.shape[2])})
    return launches, err, shapes


#: kernel 2's large shapes: (B, N)
INVERSE_LARGE = ((B_INV, 128), (B_INV, 164), (B_INV, 172), (B_INV, INV_REACH))


def inverse_work(bsz, n):
    """(bytes, operations) of kernel 2 on ``[bsz, n, n]``: A read, X
    written, the four diagonal pairs and the probe read, the flags written
    once; the elimination's n steps of n^2 multiply-adds (2 n^3
    operations) and the butterflies' 24 n^2 (3 an entry a level, two
    levels, two sides, on A and on X)."""
    return (4 * (2 * bsz * n * n + 9 * n) + bsz,
            bsz * (2 * n**3 + 24 * n**2))


def drive_inverse_large(dev, card):
    """Phase 18, kernel 2: ``inverse_batched(auto)`` at its large shapes,
    one launch each, the kernel held against its plain version and timed
    (device time and CUDA events) beside the path and
    ``torch.linalg.inv``.  Returns the launches, the max abs difference
    and one entry a shape."""
    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.utils.benchmarking import (cuda_time,
                                                            device_time)

    launches, err, shapes = 0, 0.0, []
    for bsz, n in INVERSE_LARGE:
        a = inverse_batch(bsz, n, 700 + n, dev)
        reset_counts()
        x = dispatch.inverse_batched(a)
        torch.cuda.synchronize()
        counts = phase_counts()
        resid = float(inverse_resid(a, x).max())
        print(f"inverse path inverse_batched(auto) B={bsz} N={n}: launches "
              f"{counts}, worst max|AX - I| {resid:.3e} (tol {TOL_INV})")
        want = dict.fromkeys(counts, 0)
        want["inv_rbt"] = 1
        if counts != want:
            raise AssertionError(f"expected launches {want}")
        if not (bool(torch.isfinite(x).all()) and resid <= TOL_INV):
            raise AssertionError(f"inverse at N={n} gave a wrong result")
        launches += counts["inv_rbt"]
        args = (a, rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev)),
                rbt.default_diags(n, rbt.RESCUE_SEEDS, str(dev)),
                rbt.default_probe(n, str(dev)))
        xk, bad = inv_rbt.inverse_rbt_fused(*args)
        torch.cuda.synchronize()
        x_ref, bad_ref = inv_rbt.inverse_rbt_fused_reference(*args)
        rel, abs_err, why = compare_inverse(xk, bad, x_ref, bad_ref, [])
        print(f"inverse kernel vs plain B={bsz} N={n}: max rel diff "
              f"{rel:.3e} (tol {TOL_KERNEL}), flagged "
              f"{bad.nonzero().flatten().tolist()}")
        if why is not None or not rel <= TOL_KERNEL or bool(bad.any()):
            raise AssertionError(f"inverse kernel disagrees with plain "
                                 f"version at N={n}: {why or rel}")
        err = max(err, abs_err)
        t_dev = device_time(inv_rbt.inverse_rbt_fused, *args, warmup=2,
                            iters=5)
        t_host = cuda_time(inv_rbt.inverse_rbt_fused, *args, warmup=2,
                           iters=10)
        t_plain = cuda_time(inv_rbt.inverse_rbt_fused_reference, *args,
                            warmup=0, iters=1)
        t_path = cuda_time(dispatch.inverse_batched, a, warmup=2, iters=10)
        t_lib = cuda_time(torch.linalg.inv, a, warmup=2, iters=10)
        b_ms, b_by = bound(*inverse_work(bsz, n))
        for name, t in (("kernel inverse_rbt_fused, device", t_dev),
                        ("kernel inverse_rbt_fused", t_host),
                        ("plain inverse_rbt_fused_reference", t_plain),
                        ("inverse_batched(auto)", t_path),
                        ("torch.linalg.inv", t_lib)):
            print(f"time {name} N={n}: {t * 1e3:.4f} ms (B={bsz}, bound "
                  f"{b_ms:.4f} ms {b_by}, {card})")
        shapes.append({"shape": [bsz, n, n], "ms": t_dev * 1e3,
                       "host_ms": t_host * 1e3, "plain_ms": t_plain * 1e3,
                       "path_ms": t_path * 1e3,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": t_lib * 1e3,
                       "variant": inv_rbt.variant(n)})
    return launches, err, shapes


def variant_attributes():
    """Registers a thread, spill bytes and resident blocks an SM of every
    variant of kernels 1, 2, 3 (variant 3 at the affine [256, 257] and the
    rank's [424, 424], with its blocks a cluster and the clusters resident
    at once), 5 and 6, at a shape each takes, the trsyl kernel's
    registers, spills and shared memory at the matrix-function width, and
    the complex elimination kernel's (each row count of its register
    variant, then variant 1) and the window kernel's (each positions-a-
    lane count) registers, spills, shared memory and blocks an SM."""
    from linalg_solver_tpu_torch.ops.kernels import complex_gauss as cg
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_nopivot
    from linalg_solver_tpu_torch.ops.kernels import lu_panel, solve_fused
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    return {
        "inv_rbt": {f"N={n}": inv_rbt.attributes(n)
                    for n in (32, N_INV, 128, INV_REACH)},
        "solve_fused": {f"N={n} k={k}": solve_fused.attributes(n, k)
                        for n, k in ((128, 1), (N, 1), (N, 8))},
        "lu_nopivot": {f"[{m}, {nb}]": lu_nopivot.attributes(m, nb)
                       for m, nb in ((N, 32), (N, 64), (N_REACH, 64))},
        "gauss_jordan": {f"[{n}, {w}]": gj.attributes(n, w)
                         for n, w in ((64, 128), (127, 254), (167, 334),
                                      (237, 237), (256, 257), (424, 424))},
        "lu_panel": {f"[{n}, {nb}]": lu_panel.attributes(n, nb)
                     for n, nb in ((960, 32), (256, 64), (889, 64))},
        "trsyl": {f"n={MF_N} {dt} adjoint={adj}": trsyl.attributes(
            MF_N, getattr(torch, dt), adj)
            for dt in ("float32", "float64") for adj in (False, True)},
        "complex_gauss": {
            f"n={n} {dt} variant {cg.variant(n, getattr(torch, dt))}":
            cg.attributes(n, getattr(torch, dt))
            for dt, ns in (("float32", (32, 64, 96, 128, 160, 192, 193)),
                           ("float64", (32, 64, 96, 128, 129)))
            for n in ns},
        "schur_window": {f"w={w} {dt}": sw.attributes(w, getattr(torch, dt))
                         for w in (31, 32, 64, 100)
                         for dt in ("float32", "float64")},
    }


def unpivoted_rows(panel, mask):
    """The rows of ``panel [B, N, nb]`` not marked in ``mask``, in their
    order: ``[B, N − k, nb]`` when every panel has k rows marked."""
    keep = int((mask[0] == 0).sum())
    order = torch.argsort(mask, dim=1, stable=True)[:, :keep]
    return panel.gather(1, order[:, :, None].expand(-1, -1, panel.shape[2]))


def panel_work(panels):
    """(bytes, operations) of kernel 6 over ``panels`` [(panel, mask, nb)]:
    each input read and each output written once; the multipliers and
    rank-1 updates of the rows each step leaves unpivoted."""
    nbytes = flops = 0
    for p, m, nb in panels:
        bsz, n, _ = p.shape
        nbytes += 4 * bsz * (2 * n * nb + 3 * n + nb) + bsz
        free = int((m[0] == 0).sum())
        flops += bsz * sum((free - c - 1) * (2 * (nb - c - 1) + 1)
                           for c in range(nb))
    return nbytes, flops


def nopivot_work(panels):
    """(bytes, operations) of kernel 5 over ``panels`` [(panel, nb)]."""
    nbytes = flops = 0
    for p, nb in panels:
        bsz, m, _ = p.shape
        nbytes += 4 * bsz * 2 * m * nb + bsz
        flops += bsz * sum((m - c - 1) * (2 * (nb - c - 1) + 1)
                           for c in range(nb))
    return nbytes, flops


def worst_resid(a, b, x):
    """Max over systems of max|A x - b| / max|b|, in float64."""
    b3 = b.reshape(b.shape[0], b.shape[1], -1).double()
    r = a.double() @ x.reshape(b3.shape).double() - b3
    return r.abs().amax(dim=(1, 2)) / b3.abs().amax(dim=(1, 2))


def compare(x, bad, x_ref, bad_ref):
    """(max relative difference of x over the unflagged systems, the
    system where it is largest, max absolute difference there, what else
    differs or None): the flags and the non-finite pattern must agree
    exactly; a flagged system's x carries no promise."""
    if not torch.equal(bad, bad_ref):
        return 0.0, -1, 0.0, f"flags {bad.tolist()} vs {bad_ref.tolist()}"
    fin, fin_ref = torch.isfinite(x), torch.isfinite(x_ref)
    if not torch.equal(fin, fin_ref):
        return 0.0, -1, 0.0, "non-finite entries differ"
    x3 = x.reshape(x.shape[0], -1)
    r3 = x_ref.reshape(x.shape[0], -1)
    use = fin.reshape(x.shape[0], -1) & ~bad[:, None]
    zero = torch.zeros((), device=x.device)
    diff = torch.where(use, (x3 - r3).abs(), zero).amax(dim=1)
    scale = torch.where(use, r3.abs(), zero).amax(dim=1)
    rel = diff / scale.clamp_min(1e-30)
    worst = int(rel.argmax())
    return float(rel[worst]), worst, float(diff.max()), None


#: kernel 3's cluster variant (3) against its plain version: B = 8 at the
#: affine solve's [256, 257] and [423, 424] and the rank's [424, 424], the
#: reference's big reach (clusters of 2, 4 and 4 blocks)
V3_SHAPES = ((256, 257), (423, 424), (424, 424))
#: lanes of ``variant3_batch`` whose dependent rows were rounded in f32:
#: a threshold of 0 takes their rounding residues as pivots
V3_DEFICIENT = [2, 3, 6]
N_RANK_BIG = 424       # the rank's last N on kernel 3 (variant 3), B = 256
N_RANK_BLOCKED = 512   # past it: the blocked RREF, B = 32
S_AFFINE_BLOCKED = 448  # the affine solve past kernel 3: blocked, B = 32
#: ||A G||_F <= TOL_GEN ||A||_F ||G||_F for the generators G (a generator
#: is defined up to its scale: e_j minus the pivot columns' multiples,
#: ||G|| in the hundreds where a repeated row leaves the last column free)
TOL_GEN = 1e-5
#: the serving run: requests of B x SERVE_N integer systems; lane ->
#: whether its planted singular system is consistent
SERVE_REQUESTS, SERVE_N = 5, 64
SERVE_PLANTED = {3: False, 77: True, 200: False}
#: a random integer system past this float64 condition number may fail
#: the 1e-3 residual check in f32 (kappa eps > 0.01) and be retried too
SERVE_ILL = 1e5
#: the former refusals of ``auto``, now its loop: (op, B, N)
LOOP_CELLS = (("solve", B, 237), ("solve", 16, 796), ("inverse", B, 170),
              ("det", B, 240), ("lu_factor", B, 100))
N_DET_GRAD = 170       # det on kernel 3 with the loop inverse's backward


def variant3_batch(n, w, dev):
    """B = 8 ``[n, w]`` arrays for variant 3 (w = n: the rank's, w = n + 1:
    the affine solve's ``[A | b]``) and the paths' default thresholds:
    lane 0 Gaussian; 1 Gaussian with an Inf; 2 a row that is a combination
    of two others (rounded in f32); 3 a zero row, a repeated row and a
    rounded combination; 4 a rectangular ``[n - 37, n - 20]`` system
    square-padded with zeros; 5 inconsistent (a repeated row of A beside
    another b) or, at w = n, a repeated column; 6 rank 40 (a product,
    rounded); 7 Gaussian with a NaN in its last column."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    g = torch.Generator(device=dev).manual_seed(n + w)
    a = torch.randn(8, n, w, generator=g, device=dev)
    a[2, 5] = 0.3 * a[2, 1] + 0.7 * a[2, 2]
    a[3, 9] = 0.0
    a[3, 13] = a[3, 4]
    a[3, 11] = 0.5 * a[3, 4] - 1.5 * a[3, 0]
    a[4, n - 37:] = 0.0
    a[4, :, n - 20:n] = 0.0
    if w > n:
        a[5, 7] = a[5, 3]
        a[5, 7, n] += 1.0
    else:
        a[5, :, 6] = a[5, :, 1]
    a[6, :, :n] = torch.randn(n, 40, generator=g, device=dev) @ torch.randn(
        40, n, generator=g, device=dev)
    a[1, n // 2, 3] = float("inf")
    a[7, n - 5, w - 1] = float("nan")
    if w > n:   # solve.augment_square_padded's default
        tol = 100 * (n + 1) * torch.finfo(torch.float32).eps * a.abs().amax(
            dim=(1, 2))
    else:
        tol = gj.default_rank_tol(a)
    # the thresholds see the finite lanes' scale
    tol[1], tol[7] = tol[0], tol[0]
    return a, tol


def hold_gj_bitwise(arr, tol, what):
    """Kernel 3 against its plain version on ``arr`` with ``tol``: perm,
    reduced array and pivots equal, bit for bit (NaN where the other is
    NaN).  Returns the kernel's result."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    r = gj.gauss_jordan_tiled(arr, tol)
    torch.cuda.synchronize()
    p = gj.gauss_jordan_reference(arr, tol)
    same = (torch.equal(r.perm, p.perm) and nan_equal(r.reduced, p.reduced)
            and nan_equal(r.pivots, p.pivots))
    print(f"pivoted kernel vs plain {what} [{arr.shape[1]}, {arr.shape[2]}] "
          f"B={arr.shape[0]} (variant {gj.variant(*arr.shape[1:])}): perm, "
          f"reduced and pivots bitwise equal {same}, pivots a matrix "
          f"{(r.pivots != 0).sum(dim=1).tolist()[:8]}")
    if not same:
        raise AssertionError(f"pivoted kernel disagrees with its plain "
                             f"version {what}")
    return r, p


#: a kernel-3 launch of more matrices than this, but the first of a cell,
#: is held on every k-th of them, k = ceil(B / GJ_HOLD_LANES), from the
#: launch's index mod k on, so that the launches together cover every lane
#: index (the plain version's time grows with the batch: 2.2 s at
#: [1024, 256, 257] on the H100)
GJ_HOLD_LANES = 64


def record_gj():
    """Wrap ``gauss_jordan_tiled`` so that every launch keeps the lanes it
    is held on with the kernel's results there: all of the first launch
    and of a launch of at most GJ_HOLD_LANES matrices, else every k-th
    from the launch's index mod k on.  Returns the list of kept launches
    ``(arr, tol, result, B)`` (the first one whole) and a function that
    takes the wrapper off."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    kept = []
    orig = gj.gauss_jordan_tiled

    def wrapped(a, tol=None):
        res = orig(a, tol)
        bsz = a.shape[0]
        k = 1 if not kept else -(-bsz // GJ_HOLD_LANES)
        sel = torch.arange(len(kept) % k, bsz, k, device=a.device)
        t = torch.zeros(bsz, device=a.device) if tol is None else tol
        kept.append((a[sel].clone(), t[sel].clone(), gj.GJResult(
            res.reduced[sel], res.perm[sel], res.pivots[sel]), bsz))
        return res

    gj.gauss_jordan_tiled = wrapped
    return kept, lambda: setattr(gj, "gauss_jordan_tiled", orig)


def hold_gj_launches(kept, what):
    """Every kept launch (``record_gj``) against the plain version on its
    kept lanes, bitwise on perm, reduced array and pivots, the launches'
    lanes (one shape) in one plain call.  Returns the launches held."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    arr = torch.cat([k[0] for k in kept])
    tol = torch.cat([k[1] for k in kept])
    p = gj.gauss_jordan_reference(arr, tol)
    r = [torch.cat([k[2][i] for k in kept]) for i in range(3)]
    same = (torch.equal(r[1], p.perm) and nan_equal(r[0], p.reduced)
            and nan_equal(r[2], p.pivots))
    print(f"pivoted kernel vs plain {what}: {len(kept)} launches of "
          f"[B, {arr.shape[1]}, {arr.shape[2]}] (variant "
          f"{gj.variant(*arr.shape[1:])}), B {sorted({k[3] for k in kept})}, "
          f"{arr.shape[0]} lanes held (every lane of the first launch and "
          f"of one of at most {GJ_HOLD_LANES}, else every k-th): perm, "
          f"reduced and pivots "
          f"bitwise equal {same}")
    if not same:
        raise AssertionError(f"pivoted kernel disagrees with its plain "
                             f"version {what}")
    return len(kept)


def check_variant3(dev):
    """Phase 19: variant 3 against its plain version at its three shapes,
    bitwise; the control: the kernel with tol = 0 against the plain
    version with the real tol must differ in the pivots of the
    rank-deficient lanes."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    for n, w in V3_SHAPES:
        if gj.variant(n, w) != 3:
            raise AssertionError(f"[{n}, {w}] is not variant 3's")
        a, tol = variant3_batch(n, w, dev)
        _, p = hold_gj_bitwise(a, tol, "variant 3")
        r0 = gj.gauss_jordan_tiled(a, torch.zeros_like(tol))
        torch.cuda.synchronize()
        differ = [i for i in range(8) if not nan_equal(r0.pivots[i],
                                                       p.pivots[i])]
        print(f"control, variant 3 with tol = 0 vs plain with the real tol "
              f"[{n}, {w}]: pivots differ in lanes {differ} (must include "
              f"{V3_DEFICIENT})")
        if not set(V3_DEFICIENT) <= set(differ):
            raise AssertionError("the variant-3 check cannot see a kernel "
                                 "that ignores its threshold")


def affine_batch(bsz, n, seed, dev):
    """``[A | b]`` systems of the bench class (Gaussian + 4 sqrt(n) I) for
    the affine paths, by lane mod 4: 0 full rank; 1 a repeated column, b
    in the range; 2 a repeated row, b off the range (inconsistent); 3 row
    and column 9 zero, b zero there (the rest keeps its diagonal, so the
    system stays as well conditioned as the class).  Returns (a, b,
    whether each system is consistent)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(bsz, n, n, generator=g, device=dev)
    a += 4.0 * n**0.5 * torch.eye(n, device=dev)
    b = torch.randn(bsz, n, generator=g, device=dev)
    a[1::4, :, 7] = a[1::4, :, 3]
    b[1::4] = (a[1::4] @ torch.randn(n, 1, generator=g, device=dev))[..., 0]
    a[2::4, 7] = a[2::4, 3]
    b[2::4, 7] = b[2::4, 3] + 1.0
    a[3::4, :, 9] = 0.0
    a[3::4, 9] = 0.0
    b[3::4, 9] = 0.0
    consistent = torch.arange(bsz, device=dev) % 4 != 2
    return a, b, consistent


def rank_batch(bsz, n, seed, dev):
    """``[n, n]`` matrices of the bench class and constructed rank
    n - k - d: k = lane mod 5 zero rows and d = (lane // 5) mod 3 repeated
    rows, exactly (so float64 sees the same rank).  Returns (a, the
    ranks)."""
    a = inverse_batch(bsz, n, seed, dev)
    ranks = []
    for i in range(bsz):
        k, d = i % 5, (i // 5) % 3
        a[i, 10:10 + k] = 0.0
        a[i, 20:20 + d] = a[i, 40:40 + d]
        ranks.append(n - k - d)
    return a, ranks


#: lanes whose float64 rank numpy computes (every construction of
#: ``rank_batch`` and ``affine_batch`` occurs among them)
RANK64_LANES = 16


def numpy_rank64(a):
    """numpy's float64 rank of the first RANK64_LANES matrices of ``a``."""
    import numpy as np

    return np.linalg.matrix_rank(
        a[:RANK64_LANES].double().cpu().numpy()).tolist()


def check_affine(res, a, b, consistent, what):
    """The limits of an affine path: the particular solution of each
    consistent system ||A x - b|| <= TOL_RESID ||b||, the generators
    ||A G||_F <= TOL_GEN ||A||_F max(1, ||G||_F), dim as built and equal
    to N - numpy's float64 rank (first RANK64_LANES systems),
    is_consistent as built."""
    a64 = a.double()
    r = (a64 @ res.particular.double()[..., None])[..., 0] - b.double()
    rel = (r.norm(dim=1) / b.double().norm(dim=1).clamp_min(1e-30))
    rel = rel[consistent]
    g64 = res.generators.double()
    gen = (a64 @ g64).flatten(1).norm(dim=1) / (
        a64.flatten(1).norm(dim=1) * g64.flatten(1).norm(dim=1).clamp_min(1))
    n = a.shape[-1]
    built = torch.where(torch.arange(a.shape[0], device=a.device) % 4 == 0,
                        0, 1)
    dims_ok = (torch.equal(res.dim.long(), built)
               and res.dim.tolist()[:RANK64_LANES]
               == [n - r for r in numpy_rank64(a)])
    cons_ok = torch.equal(res.is_consistent, consistent)
    print(f"{what}: worst ||Ax - b||/||b|| {float(rel.max()):.3e} (tol "
          f"{TOL_RESID}), worst ||AG||/(||A|| ||G||) {float(gen.max()):.3e} (tol "
          f"{TOL_GEN}), dims {sorted(set(res.dim.tolist()))} as built and "
          f"equal to N - float64 rank {dims_ok}, is_consistent as built {cons_ok}")
    if not (float(rel.max()) <= TOL_RESID and float(gen.max()) <= TOL_GEN
            and dims_ok and cons_ok):
        raise AssertionError(f"{what} gave a wrong solution set")


def drive_big_reach_paths(dev):
    """Phase 20: the affine solve and the nullspace at B = N = 256 and the
    rank at B = 256, N = 424 (one variant-3 launch each, the kernel held
    bitwise against its plain version on the array the path gave it); the
    rank at B = 32, N = 512 and the affine solve at s = 448 on the
    blocked RREF (no kernel launch).  Returns the launches and the arrays
    the paths gave the kernel."""
    from linalg_solver_tpu_torch.ops import dispatch
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    out = {"launches": 0, "arrays": {}}
    only3 = dict.fromkeys(phase_counts(), 0)
    only3["gauss_jordan"] = 1
    a, b, consistent = affine_batch(B, N, 31, dev)
    for what, run in (
            ("affine", lambda: dispatch.affine_solve_batched(a, b)),
            ("nullspace", lambda: dispatch.nullspace_batched(a))):
        calls, off = record(gj, "gauss_jordan_tiled")
        reset_counts()
        res = run()
        torch.cuda.synchronize()
        counts = phase_counts()
        off()
        print(f"{what} path {what}_batched(auto) B={B} N={N}: launches "
              f"{counts}")
        if counts != only3 or len(calls) != 1:
            raise AssertionError(f"expected launches {only3}")
        want = consistent if what == "affine" else torch.ones_like(
            consistent)
        check_affine(res, a, b if what == "affine" else torch.zeros_like(b),
                     want, f"{what} path")
        (arr, tol), _ = calls[0]
        hold_gj_bitwise(arr, tol, f"on the {what} path")
        out["launches"] += counts["gauss_jordan"]
        out["arrays"][what] = (arr, tol)

    r, ranks = rank_batch(B, N_RANK_BIG, 41, dev)
    calls, off = record(gj, "gauss_jordan_tiled")
    reset_counts()
    got = dispatch.rank_batched(r)
    torch.cuda.synchronize()
    counts = phase_counts()
    off()
    rank64 = numpy_rank64(r)
    good = got.tolist() == ranks and rank64 == ranks[:RANK64_LANES]
    print(f"rank path rank_batched(auto) B={B} N={N_RANK_BIG}: launches "
          f"{counts}, equal to the constructed ranks and numpy's float64 "
          f"ones {good}")
    if counts != only3 or not good:
        raise AssertionError("the rank at N = 424 is wrong")
    (arr, tol), _ = calls[0]
    hold_gj_bitwise(arr, tol, "on the rank path")
    out["launches"] += counts["gauss_jordan"]
    out["arrays"]["rank"] = (arr, tol)

    none = dict.fromkeys(phase_counts(), 0)
    r, ranks = rank_batch(32, N_RANK_BLOCKED, 43, dev)
    reset_counts()
    got = dispatch.rank_batched(r)
    torch.cuda.synchronize()
    counts = phase_counts()
    rank64 = numpy_rank64(r)
    good = got.tolist() == ranks and rank64 == ranks[:RANK64_LANES]
    print(f"rank path rank_batched(auto) B=32 N={N_RANK_BLOCKED} (blocked "
          f"RREF): launches {counts}, equal to the constructed ranks and "
          f"numpy's float64 ones {good}")
    if counts != none or not good:
        raise AssertionError("the blocked rank at N = 512 is wrong")
    out["arrays"]["rank_blocked"] = r

    ab, bb, cb = affine_batch(32, S_AFFINE_BLOCKED, 47, dev)
    reset_counts()
    res = dispatch.affine_solve_batched(ab, bb)
    torch.cuda.synchronize()
    counts = phase_counts()
    print(f"affine path affine_solve_batched(auto) B=32 "
          f"s={S_AFFINE_BLOCKED} (blocked RREF): launches {counts}")
    if counts != none:
        raise AssertionError("the blocked affine solve launched a kernel")
    check_affine(res, ab, bb, cb, "blocked affine path")
    out["arrays"]["affine_blocked"] = (ab, bb)
    return out


def loop_input(op, bsz, n, dev):
    """The loop cells' inputs: the bench class for the solve (with b),
    the inverse and the LU; ``det_batch``'s class for the det."""
    if op == "det":
        return (det_batch(dev, n),)
    a = inverse_batch(bsz, n, 600 + n, dev)
    if op == "solve":
        g = torch.Generator(device=dev).manual_seed(n)
        return a, torch.randn(bsz, n, generator=g, device=dev)
    return (a,)


def drive_loop_paths(dev):
    """Phase 20, the former refusals of ``auto``, now the reference's
    ``"loop"``: the solve at N = 237 and 796, the inverse at 170, the
    det at 240 and its gradient at 170 (det on kernel 3, the backward's
    inverse on the loop), ``lu_factor`` at 100; no kernel launch but the
    gradient's det.  Returns the inputs and the kernel-3 launches."""
    from linalg_solver_tpu_torch.ops import dispatch

    none = dict.fromkeys(phase_counts(), 0)
    inputs = {}
    for op, bsz, n in LOOP_CELLS:
        args = loop_input(op, bsz, n, dev)
        fn = {"solve": dispatch.solve_batched,
              "inverse": dispatch.inverse_batched,
              "det": dispatch.det_batched,
              "lu_factor": dispatch.lu_factor_batched}[op]
        reset_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = phase_counts()
        a = args[0]
        if op == "solve":
            err = float(worst_resid(a, args[1], out).max())
            good = bool(torch.isfinite(out).all()) and err <= TOL_RESID
            what = f"worst residual {err:.3e} (tol {TOL_RESID})"
        elif op == "inverse":
            err = float(inverse_resid(a, out).max())
            good = bool(torch.isfinite(out).all()) and err <= TOL_INV
            what = f"worst max|AX - I| {err:.3e} (tol {TOL_INV})"
        elif op == "det":
            want = torch.linalg.det(a.double().cpu())
            keep = [i for i in range(bsz) if i != 3]
            err = float(((out.double().cpu() - want) / want).abs()[keep]
                        .max())
            good = err <= TOL_DET and float(out[3]) == 0.0
            what = (f"max rel err vs float64 {err:.3e} (tol {TOL_DET}), "
                    f"singular lane {float(out[3])}")
        else:
            lu = out.lu.double()
            lo = torch.tril(lu, -1) + torch.eye(n, device=dev,
                                                dtype=torch.float64)
            pa = torch.take_along_dim(a.double(), out.perm.long()[:, :, None],
                                      dim=1)
            err = float((inf_norm(lo @ torch.triu(lu) - pa)
                         / inf_norm(a)).max())
            good = err <= TOL_RESID and bool(out.ok.all())
            what = f"worst ||PA - LU||/||A|| (inf) {err:.3e} (tol {TOL_RESID})"
        print(f"loop path {op}_batched(auto) B={bsz} N={n}: launches "
              f"{counts}, {what}, {secs:.2f} s")
        if counts != none:
            raise AssertionError(f"the loop {op} launched a kernel")
        if not good:
            raise AssertionError(f"the loop {op} at N={n} gave a wrong "
                                 f"result")
        inputs[(op, n)] = args

    n = N_DET_GRAD
    g = torch.Generator(device=dev).manual_seed(n)
    s = torch.eye(n, device=dev) + torch.randn(
        B, n, n, generator=g, device=dev) / (2 * n**0.5)
    w = torch.randn(B, generator=g, device=dev)
    st = s.clone().requires_grad_()
    reset_counts()
    (dispatch.det_batched(st) * w).sum().backward()
    torch.cuda.synchronize()
    counts = phase_counts()
    s64 = s.double().requires_grad_()
    (torch.linalg.det(s64) * w.double()).sum().backward()
    err = float(((st.grad.double() - s64.grad).abs().amax(dim=(1, 2))
                 / s64.grad.abs().amax(dim=(1, 2))).max())
    print(f"det gradient det_batched(auto) B={B} N={n}: launches {counts} "
          f"(det on kernel 3, the backward's inverse on the loop), max rel "
          f"err vs float64 autograd {err:.3e} (tol 1e-4)")
    want = dict(none, gauss_jordan=1)
    if counts != want or not err <= 1e-4:
        raise AssertionError("the det gradient at N = 170 is wrong")
    return inputs, counts["gauss_jordan"]


def serving_run(dev):
    """Phase 21, as ``examples/serving_pipeline.py`` serves: five requests
    of B x SERVE_N integer systems in [-5, 5) from a numpy seed, with
    SERVE_PLANTED's singular systems planted, through
    ``BatchedSolver.solve_checked``; the failed systems retried through
    ``BatchedSolver.affine_solve``.  Every planted system must fail the
    check and get the right ``is_consistent``; no other system may fail
    unless its float64 condition number exceeds SERVE_ILL (listed).
    Returns the kernel-3 launches."""
    import numpy as np

    from linalg_solver_tpu_torch.models.solver import BatchedSolver

    solver = BatchedSolver()
    rng = np.random.RandomState(2026)
    planted = sorted(SERVE_PLANTED)
    served = failed = launches = 0
    worst = 0.0
    ill = []
    counts_all = dict.fromkeys(phase_counts(), 0)
    for step in range(SERVE_REQUESTS):
        a = rng.randint(-5, 5, size=(B, SERVE_N, SERVE_N)).astype(np.float32)
        b = rng.randint(-5, 5, size=(B, SERVE_N)).astype(np.float32)
        a[3, 7] = a[3, 3]
        b[3, 7] = b[3, 3] + 1.0       # a repeated row, b off the range
        a[77], b[77] = 0.0, 0.0       # every x solves it
        a[200, 9] = 0.0
        b[200, 9] = 1.0               # a zero row, b not zero there
        at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        reset_counts()
        x, rel, ok = solver.solve_checked(at, bt)
        bad = ~ok
        lanes = bad.nonzero().flatten().tolist()
        sub = solver.affine_solve(at[bad], bt[bad]) if lanes else None
        if lanes:
            x[bad] = sub.particular
        torch.cuda.synchronize()
        counts = phase_counts()
        for k, v in counts.items():
            counts_all[k] += v
        served += B
        failed += len(lanes)
        worst = max(worst, float(rel[ok].max()))
        cons = dict(zip(lanes, sub.is_consistent.tolist() if lanes else []))
        kappa = np.linalg.cond(a.astype(np.float64))
        others = [i for i in lanes if i not in SERVE_PLANTED]
        ill += [(step, i, float(kappa[i])) for i in others]
        if (any(cons.get(i) is not c for i, c in SERVE_PLANTED.items())
                or any(kappa[i] <= SERVE_ILL for i in others)):
            raise AssertionError(
                f"request {step}: retried {lanes} with is_consistent "
                f"{list(cons.values())}; planted {SERVE_PLANTED}, condition "
                f"numbers of the others {[float(kappa[i]) for i in others]}")
        launches += counts["gauss_jordan"]
    print(f"serving run: {SERVE_REQUESTS} requests of B={B} N={SERVE_N}, "
          f"served {served}, failed the check and retried {failed}: the "
          f"planted {planted} each time with is_consistent right, and the "
          f"ill-conditioned (request, lane, float64 condition number) "
          f"{ill}; worst residual of the served {worst:.3e} (rel_tol 1e-3), "
          f"launches {counts_all}")
    return launches


def time_new_paths(dev, card, big, loops):
    """Phase 22: variant 3 at the affine [256, 257] and the rank's
    [424, 424] (its plain version, its paths, ``torch.linalg.matrix_rank``
    for the rank; the affine solve has no single library call), each
    loop path beside its library call, and the blocked rank beside
    ``matrix_rank``.  Returns variant 3's entries for the JSON line."""
    from linalg_solver_tpu_torch.ops import dispatch
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    shapes = []
    for what in ("affine", "rank"):
        arr, tol = big["arrays"][what]
        if what == "affine":
            a = arr[:, :, :N]
            b = arr[:, :, N]
            path = cuda_time(dispatch.affine_solve_batched, a, b, warmup=1,
                             iters=5)
            lib = None
        else:
            path = cuda_time(dispatch.rank_batched, arr, warmup=1, iters=5)
            # matrix_rank of [256, 424, 424] takes seconds: one call
            lib = cuda_time(torch.linalg.matrix_rank, arr, warmup=0, iters=1)
        t_k = cuda_time(gj.gauss_jordan_tiled, arr, tol, warmup=1, iters=5)
        t_p = cuda_time(gj.gauss_jordan_reference, arr, tol, warmup=0,
                        iters=1)
        b_ms, b_by = bound(*pivoted_work(*arr.shape))
        lib_s = "none" if lib is None else f"{lib * 1e3:.4f} ms"
        print(f"time variant 3 [{arr.shape[1]}, {arr.shape[2]}] B="
              f"{arr.shape[0]} ({what}): kernel {t_k * 1e3:.4f} ms, plain "
              f"{t_p * 1e3:.4f} ms, {what} path {path * 1e3:.4f} ms, library "
              f"{lib_s}, bound {b_ms:.4f} ms {b_by} ({card})")
        shapes.append({"shape": list(arr.shape), "op": what,
                       "ms": t_k * 1e3, "plain_ms": t_p * 1e3,
                       "path_ms": path * 1e3, "bound_ms": b_ms,
                       "bound_by": b_by,
                       "library_ms": None if lib is None else lib * 1e3,
                       "variant": gj.variant(*arr.shape[1:])})

    libs = {"solve": lambda a_, b_: torch.linalg.solve(a_, b_.unsqueeze(-1)),
            "inverse": torch.linalg.inv, "det": torch.linalg.det,
            "lu_factor": torch.linalg.lu_factor_ex}
    paths = {"solve": dispatch.solve_batched,
             "inverse": dispatch.inverse_batched,
             "det": dispatch.det_batched,
             "lu_factor": dispatch.lu_factor_batched}
    for (op, n), args in loops.items():
        t_path = cuda_time(paths[op], *args, warmup=1, iters=3)
        t_lib = cuda_time(libs[op], *args, warmup=2, iters=10)
        print(f"time loop {op}_batched(auto) B={args[0].shape[0]} N={n}: "
              f"{t_path * 1e3:.4f} ms, library {t_lib * 1e3:.4f} ms "
              f"({card})")
    r = big["arrays"]["rank_blocked"]
    t_path = cuda_time(dispatch.rank_batched, r, warmup=1, iters=3)
    t_lib = cuda_time(torch.linalg.matrix_rank, r, warmup=1, iters=3)
    ab, bb = big["arrays"]["affine_blocked"]
    t_aff = cuda_time(dispatch.affine_solve_batched, ab, bb, warmup=1,
                      iters=3)
    print(f"time blocked RREF rank_batched(auto) B=32 N={N_RANK_BLOCKED}: "
          f"{t_path * 1e3:.4f} ms, torch.linalg.matrix_rank "
          f"{t_lib * 1e3:.4f} ms; affine_solve_batched(auto) B=32 "
          f"s={S_AFFINE_BLOCKED}: {t_aff * 1e3:.4f} ms, library none "
          f"({card})")
    return shapes


# --- the device eigen stack (BASELINE configs 4 and 5) ------------------

#: examples/bench_spectral.py's size for configs 4 and 5
B_SPEC, N_SPEC = 32, 256
#: config 5: Jordan blocks (eigenvalue, size), orthogonal transform
JORDAN_BLOCKS = (((2.0, 3),) * 20 + ((2.0, 2),) * 20 + ((5.0, 2),) * 40
                 + ((1.0, 1),) * 76)
JORDAN_EIGS = (2.0, 5.0, 1.0)
K_MAX = 4
#: lanes of ``jordan_input`` where ``method="gj"`` misses the built
#: structure, and the Weyr characteristic it reports there: the JAX
#: package's ``jordan_analysis(method="gj")`` reports the same on this
#: batch (the card's draw, saved and run through the reference on a
#: CPU).  Gauss-Jordan with partial pivoting is not rank-revealing there:
#: at step 3 the deflated matrix has a clean gap (100 singular values
#: <= 2e-5, the next 0.73-1.0) but a pivot above the threshold
#: (3e-3 max|M|) in its null part; the SVD method finds the structure
JORDAN_GJ_MISSES = {28: [[40, 40, 19, 0], [40, 40, 0, 0], [76, 0, 0, 0]],
                    30: [[40, 39, 20, 0], [40, 40, 0, 0], [76, 0, 0, 0]]}
#: config 4: three distinct eigenvalues, orthogonal transform (symmetric)
SPEC_EIGS = (1.0,) * 86 + (2.0,) * 85 + (5.0,) * 85
TOL_SPEC = 1e-2        # clustering radius; max|diag(D) - lambda| limit
#: the QR route's config-4 batch: B_SPEC matrices of N_QR x N_QR
N_QR = 32
SPEC_EIGS_QR = (1.0,) * 11 + (2.0,) * 11 + (5.0,) * 10


def jordan_structure(blocks, eigs, k_max):
    """(Weyr [E, k_max], alg [E], geom [E]) of a Jordan form: w_k is the
    number of blocks of size >= k."""
    sizes = [[s for lam, s in blocks if lam == e] for e in eigs]
    weyr = [[sum(s >= k for s in ss) for k in range(1, k_max + 1)]
            for ss in sizes]
    return weyr, [sum(ss) for ss in sizes], [len(ss) for ss in sizes]


def slot_eigenvalues(eigs):
    """The true eigenvalue of each slot of a report (descending)."""
    return sorted(eigs, reverse=True)


def jordan_input(dev):
    """Config 5's batch: ``P^T J P`` with P orthogonal, seeded."""
    from linalg_solver_tpu_torch.ops.generate import jordan_batch

    g = torch.Generator(device=dev).manual_seed(1)
    return jordan_batch(g, B_SPEC, JORDAN_BLOCKS, transform="orthogonal",
                        device=dev)


def spectral_input(dev, eigs=SPEC_EIGS, seed=0):
    """Config 4's batch: ``P^T diag(eigs) P`` with P orthogonal, seeded."""
    from linalg_solver_tpu_torch.ops.generate import diagonalizable_batch

    g = torch.Generator(device=dev).manual_seed(seed)
    return diagonalizable_batch(g, B_SPEC, eigs, transform="orthogonal",
                                device=dev)


def weyr_report(weyr):
    """(alg, geom, block counts) of a Weyr characteristic ``[E, k]``."""
    blocks = [[x - y for x, y in zip(w, w[1:] + [0])] for w in weyr]
    return [sum(w) for w in weyr], [w[0] for w in weyr], blocks


def drive_jordan(dev):
    """Phase 23, config 5 (jordan-256): ``jordan_analysis`` at B = 32,
    n = 256 with both rank methods: ``"svd"`` the exact Weyr
    characteristic, multiplicities and block counts on every lane,
    ``"gj"`` the same but on the lanes of ``JORDAN_GJ_MISSES``, where it
    reports what the reference reports; ``"gj"`` launches kernel 3's
    variant 3 four times on ``[96, 256, 257]`` (``"svd"`` none), each
    launch held bitwise against its plain version.  Returns the input,
    the kernel-3 launches and the arrays of the launches."""
    from linalg_solver_tpu_torch.models.jordan import jordan_analysis
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

    a = jordan_input(dev)
    weyr, _, _ = jordan_structure(JORDAN_BLOCKS, JORDAN_EIGS, K_MAX)
    E = len(JORDAN_EIGS)
    out = {"a": a, "launches": 0}
    for method in ("gj", "svd"):
        calls, off = record(gj, "gauss_jordan_tiled")
        reset_counts()
        t0 = time.perf_counter()
        rep = jordan_analysis(a, JORDAN_EIGS, k_max=K_MAX, method=method)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = phase_counts()
        off()
        misses = JORDAN_GJ_MISSES if method == "gj" else {}
        bad, off_structure = [], {}
        for i in range(B_SPEC):
            w = misses.get(i, weyr)
            got = (rep.weyr[i].tolist(), rep.alg_mult[i].tolist(),
                   rep.geom_mult[i].tolist(), rep.block_counts[i].tolist())
            if got != (w, *weyr_report(w)):
                bad.append(i)
            if got[0] != weyr:
                off_structure[i] = got[0]
        print(f"jordan path jordan_analysis(method={method!r}) B={B_SPEC} "
              f"n={N_SPEC} at {JORDAN_EIGS}: launches {counts}, Weyr "
              f"{rep.weyr[0].tolist()}, alg {rep.alg_mult[0].tolist()}, geom "
              f"{rep.geom_mult[0].tolist()} on lane 0; exact on "
              f"{B_SPEC - len(off_structure)}/{B_SPEC} lanes, off the "
              f"structure {off_structure} (the reference's misses: "
              f"{misses or 'none'}), {secs:.2f} s")
        if bad:
            raise AssertionError(f"jordan_analysis({method}) reports an "
                                 f"unexpected structure on lanes {bad}")
        want_counts = dict.fromkeys(counts, 0)
        if method == "gj":
            want_counts["gauss_jordan"] = K_MAX
        if counts != want_counts:
            raise AssertionError(f"expected launches {want_counts}")
        if method == "gj":
            shapes = {tuple(args[0].shape) for args, _ in calls}
            if shapes != {(B_SPEC * E, N_SPEC, N_SPEC + 1)}:
                raise AssertionError(f"kernel 3 shapes {shapes}")
            for k, ((arr, tol), _) in enumerate(calls):
                hold_gj_bitwise(arr, tol, f"on the Jordan gj path, step "
                                          f"{k + 1}")
            out["arrays"] = [args for args, _ in calls]
            out["launches"] += counts["gauss_jordan"]
    return out


def check_spectral_report(rep, eigs, what):
    """Config 4's limits: every lane diagonalizable, alg = geom = the
    cluster sizes slot by slot, ``max|diag(D) - lambda| <= TOL_SPEC``."""
    lam = torch.tensor(slot_eigenvalues(eigs), device=rep.D.device)
    sizes = torch.tensor([eigs.count(v) for v in slot_eigenvalues(eigs)],
                         device=rep.D.device, dtype=torch.int32)
    err = float((rep.D.diagonal(dim1=1, dim2=2) - lam).abs().max())
    diag_ok = bool(rep.diagonalizable.all())
    mult_ok = (bool((rep.alg_mult == sizes).all())
               and bool((rep.geom_mult == sizes).all()))
    print(f"{what}: diagonalizable on {int(rep.diagonalizable.sum())}/"
          f"{rep.D.shape[0]} lanes, alg = geom = cluster sizes "
          f"{sorted(set(sizes.tolist()))} on every slot {mult_ok}, "
          f"max|diag(D) - lambda| {err:.3e} (tol {TOL_SPEC})")
    if not (diag_ok and mult_ok and err <= TOL_SPEC):
        raise AssertionError(f"{what} is wrong")


def drive_spectral(dev):
    """Phase 24, config 4 (spectral-eigh-256, spectral-core-256):
    ``spectral_pipeline(method="auto")`` on the symmetric batch takes the
    eigh route (no kernel launch); the spectral core on eigh's
    eigenvalues at ``max_distinct`` 3 and None: kernel 3 twice on
    ``[96, 256, 257]`` and 16 times on ``[1024, 256, 257]``, and P^-1 on
    the phase inverse (two kernel-4 and four kernel-5 launches a pass,
    a second pass where its gate flags a lane); each held
    bitwise (every launch, ``record_gj``'s lanes).  Returns the input,
    eigenvalues, the launches and the arrays."""
    from linalg_solver_tpu_torch.models import spectral
    from linalg_solver_tpu_torch.ops import rbt
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.symmetric import eigh_batched

    a = spectral_input(dev)
    eigh_calls, off = record(spectral, "_report_from_eigh")
    reset_counts()
    rep = spectral.spectral_pipeline(a, tol=TOL_SPEC, method="auto")
    torch.cuda.synchronize()
    counts = phase_counts()
    off()
    print(f"spectral path spectral_pipeline(method='auto') B={B_SPEC} "
          f"n={N_SPEC}: eigh route taken {len(eigh_calls)} time(s), "
          f"launches {counts}")
    if len(eigh_calls) != 1 or any(counts.values()):
        raise AssertionError("method='auto' did not take the eigh route")
    check_spectral_report(rep, SPEC_EIGS, "eigh pipeline")

    ev = eigh_batched(a).w
    zeros = torch.zeros_like(ev)
    out = {"a": a, "ev": ev, "launches": {}, "arrays": {}}
    for md in (3, None):
        # the reference's chunks of 2^26 // (K n^2) matrices, two passes
        # a chunk: 2 launches on [96, 256, 257] at K = 3, 16 on
        # [1024, 256, 257] at K = n
        K = md or N_SPEC
        chunk = min(B_SPEC, max(1, 2**26 // (K * N_SPEC**2)))
        want_gj, rows = 2 * -(-B_SPEC // chunk), chunk * K
        kept, off_kept = record_gj()
        passes, off_passes = record(rbt, "_inverse_core")
        reset_counts()
        t0 = time.perf_counter()
        rep = spectral._spectral_core(a, ev, zeros, TOL_SPEC,
                                      max_distinct=md)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = phase_counts()
        off_kept()
        off_passes()
        arr, tol = kept[0][:2]
        shape = [rows, N_SPEC, N_SPEC + 1]
        flagged = [int(bad.sum()) for _, (_, bad) in passes]
        del passes[:]
        print(f"spectral core max_distinct={md} B={B_SPEC} n={N_SPEC}: "
              f"launches {counts}, kernel 3 on {list(arr.shape)}, P^-1 "
              f"in {len(flagged)} phase-inverse pass(es) flagging "
              f"{flagged} lanes (the last pass's to the pivoted rung), "
              f"{secs:.2f} s")
        # P^-1 on the phase inverse: two kernel-4 and four kernel-5
        # launches a pass; a second pass (the redraw) where the gate
        # flags a lane, as the no-pivot LU of a butterflied orthogonal
        # matrix can grow past its f32 triangular inverses (the
        # reference's gate flags such matrices too)
        want = dict.fromkeys(counts, 0)
        want.update(gauss_jordan=want_gj, butterfly=2 * len(flagged),
                    lu_nopivot=4 * len(flagged))
        if (counts != want or list(arr.shape) != shape
                or len(flagged) not in (1, 2)):
            raise AssertionError(f"expected launches {want} on {shape}")
        check_spectral_report(rep, SPEC_EIGS, f"spectral core "
                                              f"max_distinct={md}")
        if hold_gj_launches(kept, f"on the spectral core, max_distinct="
                                  f"{md}") != want_gj:
            raise AssertionError("a kernel-3 launch of the core was not held")
        out["launches"][md] = counts
        out["arrays"][md] = (arr, tol)
    return out


def drive_defective(dev, jordan):
    """Phase 25, the defective control (spectral-defective-256): the
    spectral core on config 5's batch with its exact eigenvalues flags no
    lane diagonalizable and finds geom < alg at 2 and 5; then the QR
    route at B = 32, n = 32 on a config-4 batch (kernel 3 twice on
    ``[1024, 32, 33]``, P^-1 on kernel 2).  Returns the launches."""
    from linalg_solver_tpu_torch.models import spectral

    a = jordan["a"]
    slots = slot_eigenvalues([e for e, s in JORDAN_BLOCKS for _ in range(s)])
    lam = torch.tensor(slots, device=dev).expand(B_SPEC, -1).contiguous()
    _, alg, geom = jordan_structure(JORDAN_BLOCKS, JORDAN_EIGS, K_MAX)
    reset_counts()
    rep = spectral._spectral_core(a, lam, torch.zeros_like(lam), TOL_SPEC,
                                  max_distinct=3)
    torch.cuda.synchronize()
    counts = phase_counts()
    firsts = [slots.index(e) for e in JORDAN_EIGS]
    geo = rep.geom_mult[:, firsts]
    al = rep.alg_mult[:, firsts]
    print(f"defective control _spectral_core(max_distinct=3) B={B_SPEC} "
          f"n={N_SPEC}: launches {counts}, diagonalizable on "
          f"{int(rep.diagonalizable.sum())} lanes (want 0), alg at "
          f"{JORDAN_EIGS} {al[0].tolist()} (built {alg}), geom "
          f"{sorted(set(map(tuple, geo.tolist())))} (built {geom})")
    if (bool(rep.diagonalizable.any()) or al.tolist() != [alg] * B_SPEC
            or not bool((geo[:, :2] < al[:, :2]).all())):
        raise AssertionError("the defective control is wrong")
    launches = counts

    aq = spectral_input(dev, SPEC_EIGS_QR, seed=2)
    reset_counts()
    t0 = time.perf_counter()
    rep = spectral.spectral_pipeline(aq, tol=TOL_SPEC, method="qr")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = phase_counts()
    print(f"qr path spectral_pipeline(method='qr') B={B_SPEC} n={N_QR}: "
          f"launches {counts}, {secs:.2f} s")
    want = dict.fromkeys(counts, 0)
    want.update(gauss_jordan=2, inv_rbt=1)
    if counts != want:
        raise AssertionError(f"expected launches {want}")
    check_spectral_report(rep, SPEC_EIGS_QR, "qr pipeline")
    return {k: launches[k] + counts[k] for k in counts}


def time_eigen_paths(dev, card, jordan, spec):
    """Phase 26: the eigen stack's paths (CUDA events, median of 3 after
    a warm-up; ``jordan_analysis(svd)`` and ``torch.linalg.eig`` one call) —
    ``jordan_analysis`` with both methods, the spectral core at both
    ``max_distinct``, the eigh pipeline, and ``torch.linalg.eig`` on the
    config-4 batch as a reference point; kernel 3 inside each path as
    profiler device time; kernel 3's launch at ``[96, 256, 257]`` and
    ``[1024, 256, 257]`` alone (CUDA events), its plain version (one
    run) and its bound.  Returns kernel 3's entries for the JSON line."""
    from linalg_solver_tpu_torch.models import spectral
    from linalg_solver_tpu_torch.models.jordan import jordan_analysis
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time
    from linalg_solver_tpu_torch.utils.benchmarking import device_time

    a5, a4, ev = jordan["a"], spec["a"], spec["ev"]
    zeros = torch.zeros_like(ev)
    paths = {
        "jordan_analysis(gj)": (lambda: jordan_analysis(
            a5, JORDAN_EIGS, k_max=K_MAX, method="gj"), True),
        "jordan_analysis(svd)": (lambda: jordan_analysis(
            a5, JORDAN_EIGS, k_max=K_MAX, method="svd"), False),
        "spectral core max_distinct=3": (lambda: spectral._spectral_core(
            a4, ev, zeros, TOL_SPEC, max_distinct=3), True),
        "spectral core max_distinct=None": (lambda: spectral._spectral_core(
            a4, ev, zeros, TOL_SPEC, max_distinct=None), True),
        "spectral_pipeline(eigh)": (lambda: spectral.spectral_pipeline(
            a4, tol=TOL_SPEC, method="eigh"), False),
        "torch.linalg.eig (reference point)": (
            lambda: torch.linalg.eig(a4), False),
    }
    # torch.linalg.svd of [96, 256, 256] (the "svd" method) and
    # torch.linalg.eig of the batch take seconds a call: one call each
    once = ("jordan_analysis(svd)", "torch.linalg.eig (reference point)")
    times = {}
    for what, (fn, has_gj) in paths.items():
        t = cuda_time(fn, warmup=int(what not in once),
                      iters=1 if what in once else 3)
        k3 = (device_time(fn, warmup=0, iters=1,
                          match="gj_cluster_kernel")
              if has_gj else None)
        times[what] = (t, k3)
        k3_s = "" if k3 is None else f", kernel 3 device time {k3 * 1e3:.4f} ms"
        print(f"time {what} B={B_SPEC} n={N_SPEC}: {t * 1e3:.4f} ms{k3_s} "
              f"({card})")

    shapes = []
    for (arr, tol), path in ((jordan["arrays"][0], "jordan_analysis(gj)"),
                             (spec["arrays"][None],
                              "spectral core max_distinct=None")):
        t_k = cuda_time(gj.gauss_jordan_tiled, arr, tol, warmup=1, iters=3)
        t_p = cuda_time(gj.gauss_jordan_reference, arr, tol, warmup=0,
                        iters=1)
        b_ms, b_by = bound(*pivoted_work(*arr.shape))
        print(f"time variant 3 [{arr.shape[1]}, {arr.shape[2]}] B="
              f"{arr.shape[0]} ({path}): kernel {t_k * 1e3:.4f} ms, plain "
              f"{t_p * 1e3:.4f} ms, path "
              f"{times[path][0] * 1e3:.4f} ms, library none, bound "
              f"{b_ms:.4f} ms {b_by} ({card})")
        shapes.append({"shape": list(arr.shape), "op": path,
                       "ms": t_k * 1e3, "plain_ms": t_p * 1e3,
                       "path_ms": times[path][0] * 1e3,
                       "path_kernel_device_ms": times[path][1] * 1e3,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None,
                       "variant": gj.variant(*arr.shape[1:])})
    return shapes


# --- the real Schur solver (ops/schur.py) and its routes -----------------

#: schur-gauss-256: max distance of a lane's eigenvalues from numpy's
#: float64 ones (greedy nearest matching)
TOL_SCHUR_EIG = 2e-3
#: spectral-eig-256: max|diag(D) - lambda|
TOL_EIG_CELL = 1e-3


def gaussian_input(dev):
    """schur-gauss-256's batch: 32 seeded Gaussian 256x256 f32 matrices."""
    g = torch.Generator(device=dev).manual_seed(3)
    return torch.randn(B_SPEC, N_SPEC, N_SPEC, generator=g, device=dev)


def eig_input(dev):
    """spectral-eig-256's batch: ``A = P diag(lam) P^-1`` built in float64
    on the host from a seed, lam = 1 + 4i/255 (256 distinct reals), P =
    I + G/(4 sqrt n); rounded to f32 on the card.  Returns (A, lam in
    the report's descending slot order)."""
    import numpy as np

    rng = np.random.RandomState(5)
    n = N_SPEC
    lam = 1.0 + 4.0 * np.arange(n) / (n - 1)
    P = np.eye(n) + rng.randn(B_SPEC, n, n) / (4 * n**0.5)
    a = np.einsum("bij,j,bjk->bik", P, lam, np.linalg.inv(P))
    return torch.from_numpy(a.astype(np.float32)).to(dev), lam[::-1].copy()


def eig_deviation(re, im, a):
    """Per lane, the largest distance of the eigenvalues ``re + i im``
    from numpy's float64 ``eigvals`` of ``a`` under a greedy nearest
    matching (host, float64)."""
    import numpy as np

    want = np.linalg.eigvals(a.double().cpu().numpy())
    got = (re.double() + 1j * im.double()).cpu().numpy()
    out = []
    for g_l, w_l in zip(got, want):
        left = np.array(w_l)
        worst = 0.0
        for z in g_l[np.argsort(g_l.real)]:
            j = int(np.argmin(np.abs(left - z)))
            worst = max(worst, abs(left[j] - z))
            left = np.delete(left, j)
        out.append(worst)
    return out


def chase_work(H, Q, tables):
    """(bytes, operations) of one chase-kernel launch: H (and Q) read and
    written once, the tables read once; a live bulge-step (an entry of
    the ``act`` table: each (bulge, position) is visited once a sweep)
    costs 11 operations a column of its row update, 11 a row of its
    column updates of H and Q, and ~30 for its reflector."""
    B, npad, _ = H.shape
    nq = 0 if Q is None else Q.shape[1]
    R = tables[0].shape[1]
    live = int(tables[0].sum())
    nbytes = (H.element_size() * (2 * B * npad * npad + 2 * B * nq * npad
                                  + 2 * B * R * npad) + 4 * B * R * npad)
    return nbytes, live * (11 * npad + 11 * (npad + nq) + 30)


def window_sweeps(Hw, Qw, hw, an, *_):
    """Each lane's sweeps in the window kernel on these windows: the
    sweeps it starts with ``hw >= 1`` in the plain batch loop, and one
    for a lane converged on entry where the batch was live."""
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    w = Qw.shape[1]
    live0 = bool((hw >= 1).any())
    count = torch.zeros_like(hw)
    stg = torch.zeros_like(hw)
    H, Q, h = Hw, Qw, hw
    for _ in range(2 * w):
        live = h >= 1
        if not bool(live.any()):
            break
        count += live.long()
        H, h, stg, Q, _ = schur._one_sweep(
            H, h, stg, an, Q, strict_deflate=True,
            chase=sc.francis_chase_reference)
    return torch.where((hw < 1) & live0, 1, count)


def window_work(Hw, Qw, hw, an, beta, hi_w0, n, live, sweeps):
    """(bytes, operations) of one window-kernel launch: the windows and
    their Q read and written once, hw, the norms, beta and the trailing
    run's ends; ``live`` chase steps (those these inputs need: the steps
    the dead-step rule does not skip) at 11 operations a column of the
    row update, 11 a row of H and Q in the column update, ~30 for the
    reflector; ``sweeps`` (``window_sweeps``' sum) at ~45 operations a
    position of deflation, shifts and bulge starts; ~15 a row of the
    trailing run."""
    B, npad, _ = Hw.shape
    w = npad - 1
    e = Hw.element_size()
    nbytes = B * (2 * e * (npad * npad + w * npad) + 2 * e + 40)
    per = 11 * npad + 11 * (npad + w) + 30
    return nbytes, live * per + sweeps * 45 * npad + B * 15 * w


def hold_window_cases(args, what, card):
    """The window kernel on the card against its plain version on
    ``args`` and on two variants of it (a NaN lane with lanes converged
    on entry; lane 1 scaled by 1e19 in f32, 1e155 in float64, so that its
    dead steps' sums overflow), and the kernel's device count of the
    steps it ran against ``window_schedule_reference``'s.  Returns
    ``{"live_steps", "all_steps", "model_steps", "sweeps"}`` of ``args``
    (``all_steps``: every step of each sweep a lane runs)."""
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw

    Hw, Qw, hw, an, *rest = args
    w = Qw.shape[1]
    Hn, hn = Hw.clone(), hw.clone()
    Hn[0, 3, 5] = float("nan")
    hn[1], hn[2] = 0, -1
    Hs, ans = Hw.clone(), an.clone()
    s = 1e19 if Hw.dtype == torch.float32 else 1e155
    Hs[1] *= s
    ans[1] *= s
    out = {}
    for name, case in (("as given", args), ("NaN and converged lanes",
                                            (Hn, Qw, hn, an, *rest)),
                       ("lane 1 scaled", (Hs, Qw, hw, ans, *rest))):
        sw.reset_live_steps(Hw.device)
        got = sw.window_schur(*case)
        ran = int(sw.live_steps(Hw.device))
        model = sw.window_schedule_reference(*case)
        live = int(model[5].sum())
        ref = sw.window_schur_reference(*case)
        if not all(nan_equal(x, y) for x, y in zip(got, ref)) or not all(
                nan_equal(x, y) for x, y in zip(got, model[:5])):
            raise AssertionError(f"window kernel {what} ({name}) disagrees "
                                 f"with its plain version")
        if ran != live:
            raise AssertionError(f"window kernel {what} ({name}) ran {ran} "
                                 f"steps, its plain model {live}")
        every = ""
        if name == "as given":
            sweeps = int(window_sweeps(*case).sum())
            out = {"live_steps": ran, "all_steps": sweeps * (w - 1),
                   "model_steps": live, "sweeps": sweeps}
            every = (f" of {sweeps * (w - 1)} "
                     f"({ran / max(sweeps * (w - 1), 1):.4f})")
        print(f"window kernel vs plain {what} ({name}, {list(Hw.shape)} "
              f"{Hw.dtype}): bitwise equal (NaN-equal); steps run on the "
              f"device {ran}, the plain model's {live}{every} ({card})")
    return out


def hold_schur(a, with_q, what, balance=True, nshift_pairs=0, aed_w=-1):
    """The window kernel (every AED round, where the sweep has one) and
    the chase kernel (every launch, the main chase in both variants)
    against their plain versions, bitwise (NaN-equal), on the arrays one
    outer sweep of ``ops.schur`` from ``a``'s initial state gives them,
    under ``real_schur``'s arguments.  Returns (max abs diff, the main
    chase's arguments, the window kernel's arguments or None)."""
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw

    B_, n = a.shape[0], a.shape[1]
    npairs, aed_w = schur._sweep_config(n, nshift_pairs, aed_w)
    H, Q, hi, st, an, _ = schur._schur_init(a, balance=balance,
                                            with_q=with_q)
    state = (H, Q, hi, st, an, torch.zeros_like(hi, dtype=torch.bool),
             torch.zeros((), dtype=torch.long, device=a.device))
    chases, wins = [], []
    orig, orig_w = sc.francis_chase, sw.window_schur

    def rec(H, Q, tables, nc):
        args = (H.clone(), None if Q is None else Q.clone(),
                [t.clone() for t in tables], nc)
        out = orig(H, Q, tables, nc)
        chases.append((args, out))
        return out

    def rec_w(*args):
        out = orig_w(*args)
        wins.append(([x.clone() if isinstance(x, torch.Tensor) else x
                      for x in args], out))
        return out

    sc.francis_chase, sw.window_schur = rec, rec_w
    try:
        with schur.f32_matmuls():
            schur._schur_sweep(state, npairs, aed_w)
    finally:
        sc.francis_chase, sw.window_schur = orig, orig_w
    torch.cuda.synchronize()
    err = 0.0
    for args, out in wins:
        ref = sw.window_schur_reference(*args)
        if not all(nan_equal(o, r) for o, r in zip(out, ref)):
            raise AssertionError(f"window kernel {what} disagrees with its "
                                 f"plain version on {list(args[0].shape)} "
                                 f"{args[0].dtype}")
        err = max(err, abs_diff(out[0], ref[0]), abs_diff(out[1], ref[1]))
    for (H, Q, tables, nc), (Ho, Qo) in chases:
        Hr, Qr = sc.francis_chase_reference(H, Q, tables, nc)
        outs = [(Ho, Qo)]
        if H.shape[1] == n + 1:
            # the main chase: the other variant too
            v = sc.variant(n, H.dtype)
            outs += [sc.francis_chase(H, Q, tables, nc, v=u)
                     for u in sc.VARIANTS if u != v]
        for Hk, Qk in outs:
            if not (nan_equal(Hk, Hr) and (Q is None or nan_equal(Qk, Qr))):
                raise AssertionError(f"chase kernel {what} disagrees with "
                                     f"its plain version on {list(H.shape)}, "
                                     f"{nc + 1} bulges a step")
            err = max(err, abs_diff(Hk, Hr))
    shapes = sorted({(tuple(c[0][0].shape), c[0][3] + 1) for c in chases})
    print(f"window kernel vs plain {what}: " + (
          f"{len(wins)} launch(es) of one outer sweep "
          f"({[list(w_[0][0].shape) for w_ in wins]}, {a.dtype}), bitwise "
          f"equal (NaN-equal) on H, Q, hw and the trailing deflation's rows "
          f"and end" if aed_w else f"none (AED off at n = {n})") + f"; chase "
          f"kernel vs plain: {len(chases)} launch(es) (shape, bulges a step: "
          f"{shapes}, Q {with_q}), the main chase in variants "
          f"{list(sc.VARIANTS)}, all bitwise equal (max abs diff {err:.3e})")
    if (len(wins) != int(aed_w > 0) or not chases
            or any(c[0][0].shape[1] != n + 1 for c in chases)):
        raise AssertionError(f"an outer sweep took other launches than "
                             f"{int(aed_w > 0)} window-kernel launch(es) "
                             f"and the main chase")
    return err, chases[0][0], wins[0][0] if wins else None


def drive_schur(dev):
    """Phase 27, schur-gauss-256: ``eigvals_schur`` on 32 seeded Gaussian
    256x256 f32 matrices (8 shift pairs, AED window 32: one window-kernel
    launch an AED round and one chase-kernel launch a main sweep, replayed
    from a CUDA graph): every lane converged and clean, the eigenvalues
    within ``TOL_SCHUR_EIG`` of numpy's float64 ones; no kernel 1-6
    launch; then both kernels held bitwise against their plain versions
    on every launch of the first sweep, in f32 and in float64.  Returns
    the input, the launches, the held error and the kernels' arguments."""
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    a = gaussian_input(dev)
    runs, off = record(schur, "real_schur")
    reset_counts()
    t0 = time.perf_counter()
    ev = schur.eigvals_schur(a)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, chase = phase_counts(), sc.LAUNCHES
    window = counts.pop("schur_window")
    off()
    sweeps = int(runs[0][1].sweeps)
    dev_ = max(eig_deviation(ev.real, ev.imag, a))
    conv, clean = int(ev.converged.sum()), int(ev.clean.sum())
    print(f"schur path eigvals_schur B={B_SPEC} n={N_SPEC} Gaussian: "
          f"converged {conv}/{B_SPEC}, clean {clean}/{B_SPEC}, {sweeps} "
          f"sweeps, max eigenvalue deviation from numpy float64 "
          f"{dev_:.3e} (tol {TOL_SCHUR_EIG}), window launches {window}, "
          f"chase launches {chase}, other launches {counts}, {secs:.2f} s "
          f"(CUDA-graph capture included)")
    if any(counts.values()) or chase < 1 or window < 1:
        raise AssertionError("eigvals_schur launched other kernels, or no "
                             "window kernel or chase")
    if ev.real.shape != (B_SPEC, N_SPEC) or not bool(
            torch.isfinite(ev.real).all() & torch.isfinite(ev.imag).all()):
        raise AssertionError("eigvals_schur's output has the wrong shape or "
                             "non-finite values")
    if conv != B_SPEC or clean != B_SPEC or not dev_ <= TOL_SCHUR_EIG:
        raise AssertionError("eigvals_schur is wrong")
    err, main, win = hold_schur(a, False, "on schur-gauss-256")
    err64, main64, win64 = hold_schur(a.double(), False,
                                      "on schur-gauss-256 in float64")
    return {"a": a, "launches": chase, "window": window,
            "err": max(err, err64), "main": main, "win": win,
            "main64": main64, "win64": win64, "sweeps": sweeps}


def drive_schur_spectral(dev):
    """Phases 28-30: config 4's batch through ``spectral_pipeline(
    method="schur")`` at ``max_distinct`` 3 and None (spectral-schur-256:
    every lane diagonalizable, alg = geom = the cluster sizes, kernel 3
    as in phase 24, every launch held bitwise on ``record_gj``'s lanes);
    config 5's batch through ``method="auto"`` (spectral-auto-jordan-256:
    the Schur route, no lane diagonalizable, its kernel-3 launches held
    likewise); spectral-eig-256 through ``method="eig"`` (every lane
    diagonalizable, alg = 1, ``max|diag(D) - lambda| <= TOL_EIG_CELL``,
    P^-1 on the phase inverse: kernels 4 and 5 held bitwise) and the
    chase kernel held with Q.  Returns the inputs, the launches of each
    kernel and the held errors."""
    from linalg_solver_tpu_torch.models import spectral
    from linalg_solver_tpu_torch.ops import rbt
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    out = {"launches": dict.fromkeys(phase_counts(), 0), "chase": 0}

    def add(counts):
        for k in counts:
            out["launches"][k] += counts[k]
        out["chase"] += sc.LAUNCHES
        if counts["schur_window"] < 1:
            raise AssertionError("the Schur route launched no window kernel")

    a4 = spectral_input(dev)
    for md in (3, None):
        K = md or N_SPEC
        chunk = min(B_SPEC, max(1, 2**26 // (K * N_SPEC**2)))
        kept, off = record_gj()
        passes, off_passes = record(rbt, "_inverse_core")
        schur_runs, off_s = record(spectral, "eigvals_schur")
        reset_counts()
        t0 = time.perf_counter()
        rep = spectral.spectral_pipeline(a4, tol=TOL_SPEC, method="schur",
                                         max_distinct=md)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = phase_counts()
        add(counts)
        off()
        off_passes()
        off_s()
        flagged = [int(bad.sum()) for _, (_, bad) in passes]
        del passes[:]
        print(f"spectral-schur path spectral_pipeline(method='schur', "
              f"max_distinct={md}) B={B_SPEC} n={N_SPEC}: Schur stage "
              f"{len(schur_runs)} call(s), chase launches {sc.LAUNCHES}, "
              f"launches {counts}, P^-1 in {len(flagged)} phase-inverse "
              f"pass(es) flagging {flagged} lanes, {secs:.2f} s")
        want = dict.fromkeys(counts, 0)
        want.update(gauss_jordan=2 * -(-B_SPEC // chunk),
                    butterfly=2 * len(flagged), lu_nopivot=4 * len(flagged),
                    schur_window=counts["schur_window"])
        if (counts != want or len(schur_runs) != 1 or sc.LAUNCHES < 1
                or len(flagged) not in (1, 2)):
            raise AssertionError(f"expected launches {want} and the Schur "
                                 f"stage")
        check_spectral_report(rep, SPEC_EIGS, f"schur pipeline "
                                              f"max_distinct={md}")
        if hold_gj_launches(kept, f"on the schur pipeline, max_distinct="
                                  f"{md}") != want["gauss_jordan"]:
            raise AssertionError("a kernel-3 launch of the pipeline was not "
                                 "held")
    out["a4"] = a4

    a5 = jordan_input(dev)
    schur_runs, off_s = record(spectral, "eigvals_schur")
    eigh_runs, off_e = record(spectral, "_report_from_eigh")
    kept, off_kept = record_gj()
    reset_counts()
    t0 = time.perf_counter()
    rep = spectral.spectral_pipeline(a5, tol=TOL_SPEC, method="auto")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = phase_counts()
    add(counts)
    off_kept()
    off_s()
    off_e()
    alg = sorted(set(rep.alg_mult.flatten().tolist()))
    at_built = [int(rep.alg_mult[0][(rep.eig_real[0] - e).abs()
                                    <= TOL_SPEC].max()) for e in JORDAN_EIGS]
    print(f"spectral-auto-jordan path spectral_pipeline(method='auto') "
          f"B={B_SPEC} n={N_SPEC} (config 5): Schur route {len(schur_runs)} "
          f"call(s), eigh route {len(eigh_runs)}, chase launches "
          f"{sc.LAUNCHES}, launches {counts}, diagonalizable on "
          f"{int(rep.diagonalizable.sum())}/{B_SPEC} lanes (want 0), alg "
          f"multiplicities seen {alg}, lane 0's at the built eigenvalues "
          f"{at_built} "
          f"(built {jordan_structure(JORDAN_BLOCKS, JORDAN_EIGS, K_MAX)[1]}), "
          f"{secs:.2f} s")
    if (len(schur_runs) != 1 or eigh_runs or sc.LAUNCHES < 1
            or bool(rep.diagonalizable.any())):
        raise AssertionError("method='auto' on config 5 is wrong")
    if counts["gauss_jordan"] and hold_gj_launches(
            kept, "on spectral-auto-jordan-256") != counts["gauss_jordan"]:
        raise AssertionError("a kernel-3 launch of auto-jordan was not held")
    out["a5"] = a5
    err5, _, _ = hold_schur(a5, False, "on spectral-auto-jordan-256 "
                                       "(defective)")

    ae, lam = eig_input(dev)
    eig_runs, off_g = record(spectral, "eig_real_batched")
    bf_calls, bf_off = record(butterfly, "butterfly_two_sided")
    lu_calls, lu_off = record(lu_nopivot, "panel_factor_nopivot")
    reset_counts()
    t0 = time.perf_counter()
    rep = spectral.spectral_pipeline(ae, tol=TOL_SPEC, method="eig")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = phase_counts()
    add(counts)
    off_g()
    bf_off()
    lu_off()
    lam_t = torch.tensor(lam, device=dev, dtype=torch.float32)
    err = float((rep.D.diagonal(dim1=1, dim2=2) - lam_t).abs().max())
    ndiag = int(rep.diagonalizable.sum())
    print(f"spectral-eig path spectral_pipeline(method='eig') B={B_SPEC} "
          f"n={N_SPEC}: eig_real_batched {len(eig_runs)} call(s), chase "
          f"launches {sc.LAUNCHES}, launches {counts} (P^-1 on the phase "
          f"inverse), diagonalizable on {ndiag}/{B_SPEC} lanes, alg = 1 "
          f"everywhere {bool((rep.alg_mult == 1).all())}, max|diag(D) - "
          f"lambda| {err:.3e} (tol {TOL_EIG_CELL}), {secs:.2f} s")
    if (len(eig_runs) != 1 or sc.LAUNCHES < 1 or counts["gauss_jordan"]
            or counts["butterfly"] < 2 or counts["lu_nopivot"] < 4):
        raise AssertionError("method='eig' did not take its route")
    if (ndiag != B_SPEC or not bool((rep.alg_mult == 1).all())
            or not err <= TOL_EIG_CELL):
        raise AssertionError("method='eig' is wrong")
    out["bf_err"] = hold_butterflies(bf_calls, "on the eig route's P^-1")
    out["panel_err"], _ = hold_panels(lu_calls, "on the eig route's P^-1")
    out["ae"] = ae
    err, out["main_q"], out["win_q"] = hold_schur(ae, True,
                                                  "on spectral-eig-256")
    out["err"] = max(err, err5)
    return out


def time_schur_paths(dev, card, schur_out, spec_out):
    """Phase 31: one outer sweep at [32, 256, 256] eagerly and as a CUDA
    graph replay; the four cells' calls (CUDA events, median of 3) beside
    ``torch.linalg.eigvals`` / ``eig`` on the same batches (reference
    points only); the window kernel alone on the first AED round (f32 and
    float64) beside its plain version, the per-sweep loop it replaced
    (eager, a chase launch a sweep) and its bound; the chase kernel alone
    at the main sweep's shape, with and without Q, in both variants,
    beside its plain version and bound.  Returns the times and the
    kernels' rows."""
    from linalg_solver_tpu_torch.models import spectral
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    a, a4, a5, ae = (schur_out["a"], spec_out["a4"], spec_out["a5"],
                     spec_out["ae"])
    npairs = schur._auto_npairs(N_SPEC)
    aed_w = schur._auto_aed_w(N_SPEC, npairs)
    H, Q, hi, st, an, _ = schur._schur_init(a)
    state = (H, Q, hi, st, an, torch.zeros_like(hi, dtype=torch.bool),
             torch.zeros((), dtype=torch.long, device=dev))

    def eager_sweep():
        with schur.f32_matmuls():
            schur._schur_sweep(state, npairs, aed_w)

    graph = schur._sweep_graph(state, npairs, aed_w)
    t_eager = cuda_time(eager_sweep, warmup=1, iters=3)
    t_graph = cuda_time(graph.replay, warmup=1, iters=3)
    print(f"time one outer sweep B={B_SPEC} n={N_SPEC} (AED w={aed_w}: one "
          f"window-kernel launch of up to {2 * aed_w} inner sweeps; "
          f"{npairs} shift pairs): eager {t_eager * 1e3:.4f} ms, CUDA graph "
          f"{t_graph * 1e3:.4f} ms, launches a replay (chase, window) "
          f"{graph.launches} ({card})")
    cells = {
        "schur-gauss-256 eigvals_schur": lambda: schur.eigvals_schur(a),
        "torch.linalg.eigvals (reference point)":
            lambda: torch.linalg.eigvals(a),
        "spectral-schur-256 max_distinct=3":
            lambda: spectral.spectral_pipeline(a4, tol=TOL_SPEC,
                                               method="schur",
                                               max_distinct=3),
        "spectral-schur-256 max_distinct=None":
            lambda: spectral.spectral_pipeline(a4, tol=TOL_SPEC,
                                               method="schur"),
        "spectral-auto-jordan-256": lambda: spectral.spectral_pipeline(
            a5, tol=TOL_SPEC, method="auto"),
        "spectral-eig-256": lambda: spectral.spectral_pipeline(
            ae, tol=TOL_SPEC, method="eig"),
        "torch.linalg.eig on spectral-eig-256 (reference point)":
            lambda: torch.linalg.eig(ae),
    }
    times = {"sweep eager": t_eager, "sweep graph": t_graph}
    for what, fn in cells.items():
        # the library's reference points take seconds a call: one each
        times[what] = cuda_time(fn, warmup=0, iters=1 if "reference point"
                                in what else 3)
        print(f"time {what} B={B_SPEC} n={N_SPEC}: "
              f"{times[what] * 1e3:.4f} ms ({card})")

    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    print("chase variant 1 at n=256 (blocks a cluster, clusters the card "
          "runs at once): " + ", ".join(
              f"{t} ({lib.chase_cluster_size(N_SPEC, f64)}, "
              f"{lib.chase_clusters(N_SPEC, f64)})"
              for t, f64 in (("f32", 0), ("float64", 1))))
    wrows = []
    for args, what in ((schur_out["win"], "AED round, f32"),
                       (schur_out["win64"], "AED round, float64")):
        steps = hold_window_cases(args, what, card)
        t_k = cuda_time(sw.window_schur, *args, warmup=1, iters=5)
        t_p = cuda_time(sw.window_schur_reference, *args, warmup=0, iters=1)
        t_loop = cuda_time(lambda: schur._window_schur(
            *args, chase=sc.francis_chase), warmup=0, iters=1)
        b_ms, b_by = bound(*window_work(*args, live=steps["live_steps"],
                                        sweeps=steps["sweeps"]))
        b_all, _ = bound(*window_work(*args, live=steps["all_steps"],
                                      sweeps=steps["sweeps"]))
        print(f"time window kernel {what} {list(args[0].shape)}: kernel "
              f"{t_k * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms, the per-sweep "
              f"loop on the chase kernel (eager) {t_loop * 1e3:.4f} ms, "
              f"library none, bound {b_ms:.4f} ms {b_by} on the "
              f"{steps['live_steps']} steps run ({b_all:.4f} ms on all "
              f"{steps['all_steps']}) ({card})")
        wrows.append({"shape": list(args[0].shape), "op": what,
                      "ms": t_k * 1e3, "plain_ms": t_p * 1e3,
                      "loop_ms": t_loop * 1e3, "bound_ms": b_ms,
                      "bound_by": b_by, "bound_ms_all_steps": b_all,
                      "library_ms": None, **steps})
    rows = []
    for args, what in ((schur_out["main"], "main sweep"),
                       (spec_out["main_q"], "main sweep with Q"),
                       (schur_out["main64"], "main sweep, float64")):
        H, Qm, tables, nc = args
        v = sc.variant(N_SPEC, H.dtype)
        t_v = {}
        for u in (v, 1 - v, 1 - v, v):
            t_v.setdefault(u, []).append(cuda_time(
                sc.francis_chase, H, Qm, tables, nc, u, warmup=1, iters=3))
        t_k = min(t_v[v])
        t_o = min(t_v[1 - v])
        t_p = cuda_time(sc.francis_chase_reference, H, Qm, tables, nc,
                        warmup=0, iters=1)
        b_ms, b_by = bound(*chase_work(H, Qm, tables))
        print(f"time chase kernel {what} {list(H.shape)}, {nc + 1} bulges a "
              f"step: variant {v} (by shape) {t_k * 1e3:.4f} ms, variant "
              f"{1 - v} {t_o * 1e3:.4f} ms (in turns, best of 2), plain "
              f"{t_p * 1e3:.4f} ms, library none, bound {b_ms:.4f} ms {b_by} "
              f"({card})")
        rows.append({"shape": list(H.shape), "op": what, "variant": v,
                     "ms": t_k * 1e3, "other_variant_ms": t_o * 1e3,
                     "plain_ms": t_p * 1e3, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    return times, rows, wrows


# 32-35. serving on one GPU: BatchedSolver's lstsq, svd, rcond, det_exact
FAM_B, FAM_N = 256, 256
FAM_M = 768            # the 3:1 tall ratio of examples/solver_family.py:55
FAM_NEAR = {10: 1e-3, 20: 1e-2}  # rcond lanes: a row nearly repeated
FAM_SINGULAR = 30      # rcond lane with a repeated row: rcond 0
FAM_DEFICIENT = 5      # lstsq lane with a zero column (zero row when wide)
TOL_LSTSQ = 1e-4       # x against float64, relative, per lane
TOL_SVD = 1e-5         # sigma / sigma_max, reconstruction, orthogonality
RCOND_LOW = 1e-3       # f32 rounding below the exact 1/kappa_1 allowed
EXACT_B, EXACT_N = 4096, 8        # BASELINE config 1's class, batched
BIG_B, BIG_N, BIG_AMAX = 64, 24, 10_000   # past int32: crt_det_batched


def family_inputs(dev, bsz=FAM_B, n=FAM_N, m=FAM_M):
    """Phase 32's inputs, built on the card from seeded generators: the
    rcond batch (Gaussian + 4 sqrt(N) I, two lanes with a row nearly
    repeated, one with a row repeated), the tall and wide lstsq batches
    (Gaussian, one lane rank-deficient), the square and tall SVD batches
    (Gaussian), and the integer batches of det_exact."""
    g = torch.Generator(device=dev).manual_seed(32)
    cond = (torch.randn(bsz, n, n, generator=g, device=dev)
            + 4 * n ** 0.5 * torch.eye(n, device=dev))
    for lane, eps in FAM_NEAR.items():
        cond[lane, 7] = cond[lane, 3] + eps * torch.randn(
            n, generator=g, device=dev)
    cond[FAM_SINGULAR, 9] = cond[FAM_SINGULAR, 2]
    tall = torch.randn(bsz, m, n, generator=g, device=dev)
    tall[FAM_DEFICIENT, :, 11] = 0.0
    wide = torch.randn(bsz, n, m, generator=g, device=dev)
    wide[FAM_DEFICIENT, 11] = 0.0
    return {
        "rcond": cond,
        "lstsq_tall": (tall, torch.randn(bsz, m, generator=g, device=dev)),
        "lstsq_wide": (wide, torch.randn(bsz, n, generator=g, device=dev)),
        "svd_square": torch.randn(bsz, n, n, generator=g, device=dev),
        "svd_tall": torch.randn(bsz, m, n, generator=g, device=dev),
        "det_small": torch.randint(-5, 5, (EXACT_B, EXACT_N, EXACT_N),
                                   generator=g, device=dev,
                                   dtype=torch.int32),
        "det_big": torch.randint(-BIG_AMAX, BIG_AMAX + 1,
                                 (BIG_B, BIG_N, BIG_N), generator=g,
                                 device=dev, dtype=torch.int32),
    }


def host_bareiss(a, exact):
    """``ops.exact_int.bareiss_batched`` on the host, from its own
    arithmetic: in int32 (wrapped like the card's, ``exact=False``), or in
    Python integers (``exact=True``).  Returns (det, rank, ok, over):
    ``ok`` the float32 overflow sentinel, ``over`` (exact only) whether a
    product of a lane really left int32."""
    import numpy as np

    M = a.astype(object if exact else np.int64)
    bsz, n, _ = M.shape

    def wrap(x):
        return x if exact else ((x + 2**31) & (2**32 - 1)) - 2**31

    rows, lanes = np.arange(n), np.arange(bsz)
    r = np.zeros(bsz, np.int64)
    prev = np.ones(bsz, M.dtype)
    sign = np.ones(bsz, M.dtype)
    rank = np.zeros(bsz, np.int64)
    ok = np.ones(bsz, bool)
    over = np.zeros(bsz, bool)
    for j in range(n):
        elig = (rows[None] >= r[:, None]) & (M[:, :, j] != 0)
        has = elig.any(axis=1)
        p = np.where(has, elig.argmax(axis=1), 0)
        swap = (has & (p != r))[:, None]
        row_r, row_p = M[lanes, r].copy(), M[lanes, p].copy()
        M[lanes, r] = np.where(swap, row_p, row_r)
        M[lanes, p] = np.where(swap, row_r, row_p)
        sign = np.where(swap[:, 0], -sign, sign)
        piv, prow = M[lanes, r, j], M[lanes, r]
        below = (rows[None] > r[:, None]) & has[:, None]
        if not exact:
            act = (rows[None] >= r[:, None])[:, :, None]
            max_m = np.where(act, wrap(np.abs(M)), 0).max(axis=(1, 2))
            risk = (np.float32(2.0) * max_m.astype(np.float32)
                    * np.maximum(wrap(np.abs(piv)).astype(np.float32),
                                 np.float32(1.0))) >= np.float32(2.0**31)
            ok &= ~(risk & has)
        t1 = M * piv[:, None, None]
        t2 = (M[:, :, j] * below)[:, :, None] * prow[:, None, :]
        if exact:
            big = [np.abs(t) >= 2**31 for t in (t1, t2, t1 - t2)]
            over |= ((big[0] | big[1] | big[2]) & below[:, :, None]).any(
                axis=(1, 2))
        upd = wrap(wrap(wrap(t1) - wrap(t2)) // prev[:, None, None])
        M = np.where(below[:, :, None], upd, M)
        rank += has
        prev = np.where(has, piv, prev)
        r += has
    det = np.where(rank == n, wrap(sign * prev), 0)
    return det, rank, ok, over


def qdwh_reach(a64, s64, iters=8, l0=1e-3):
    """[B] the largest ``1 - f(sigma_i / alpha)`` of each lane, ``f`` the
    reference's ``iters`` dynamically weighted Halley steps from the lower
    bound ``l0`` applied to a scalar in float64 (``ops.svd._qdwh_coeffs``),
    ``alpha = sqrt(||A||_1 ||A||_inf)`` its scaling: how far from
    orthogonal its polar factor is left on a singular value that starts
    below ``l0`` (0 where the iteration converges)."""
    from linalg_solver_tpu_torch.ops.svd import _qdwh_coeffs

    alpha = torch.sqrt(torch.linalg.matrix_norm(a64, 1)
                       * torch.linalg.matrix_norm(a64, float("inf")))
    xs = s64 / alpha[:, None]
    l = torch.full_like(alpha, l0)
    for _ in range(iters):
        a_, b_, c_, l = _qdwh_coeffs(l)
        xs = xs * (a_[:, None] + b_[:, None] * xs * xs) / (
            1 + c_[:, None] * xs * xs)
    return (1 - xs).abs().amax(dim=1)


def drive_family(dev, bsz=FAM_B, n=FAM_N, m=FAM_M):
    """Phases 32-34: ``BatchedSolver().rcond``, ``.lstsq``, ``.svd`` and
    ``.det_exact`` on ``family_inputs``, each checked against float64 on
    the card or exact integers on the host (see the module docstring).
    Returns the inputs and the outputs, for the times."""
    import numpy as np

    from linalg_solver_tpu_torch.models.solver import BatchedSolver
    from linalg_solver_tpu_torch.ops.exact_int import crt_det_batched

    solver = BatchedSolver()
    x = family_inputs(dev, bsz, n, m)

    # rcond: between the exact 1/kappa_1 (a float64 inverse) and 3x it
    a = x["rcond"]
    rc = solver.rcond(a).double()
    a64 = a.double()
    inv, info = torch.linalg.inv_ex(a64)
    exact = 1.0 / (torch.linalg.matrix_norm(a64, 1)
                   * torch.linalg.matrix_norm(inv, 1))
    keep = torch.arange(bsz, device=dev) != FAM_SINGULAR
    ratio = (rc / exact)[keep]
    near = {k: (float(rc[k]), float(exact[k])) for k in FAM_NEAR}
    print(f"serving rcond B={bsz} N={n}: rcond / exact 1/kappa_1 in "
          f"[{float(ratio.min()):.6f}, {float(ratio.max()):.6f}] (limits "
          f"[{1 - RCOND_LOW}, 3]), near-singular lanes (rcond, exact) {near}, "
          f"singular lane {FAM_SINGULAR}: {float(rc[FAM_SINGULAR])}")
    if not (float(ratio.min()) >= 1 - RCOND_LOW
            and float(ratio.max()) <= 3.0):
        raise AssertionError("rcond outside [exact, 3 exact]")
    if float(rc[FAM_SINGULAR]) != 0.0:
        raise AssertionError("rcond of a singular lane is not 0")

    # lstsq: the least-squares and minimum-norm solutions
    errs = {}
    for what in ("lstsq_tall", "lstsq_wide"):
        a, b = x[what]
        res = solver.lstsq(a, b)
        lanes_ok = res.ok.cpu().tolist()
        want_ok = [i != FAM_DEFICIENT for i in range(bsz)]
        good = res.ok
        x64 = torch.linalg.lstsq(a[good].double(),
                                 b[good].double()[..., None]).solution[..., 0]
        rel = ((res.x[good].double() - x64).norm(dim=1)
               / x64.norm(dim=1)).max()
        errs[what] = float(rel)
        nan = bool(res.x[FAM_DEFICIENT].isnan().all())
        print(f"serving {what} {tuple(a.shape)}: max relative error of x "
              f"against float64 {float(rel):.3e} (tol {TOL_LSTSQ}), ok False "
              f"exactly on lane {FAM_DEFICIENT}: {lanes_ok == want_ok}, its "
              f"x NaN {nan}")
        if lanes_ok != want_ok or not nan or not float(rel) <= TOL_LSTSQ:
            raise AssertionError(f"{what} failed its check")

    # svd: sigma against float64, U S V^T against A, U^T U against I
    for what in ("svd_square", "svd_tall"):
        a = x[what]
        res = solver.svd(a)
        a64 = a.double()
        s64 = torch.linalg.eigvalsh(a64.mT @ a64).flip(-1).clamp(min=0).sqrt()
        U, s, V = res.U.double(), res.s.double(), res.V.double()
        sig = float(((s - s64).abs().amax(dim=1) / s64[:, 0]).max())
        rec = float((((U * s[:, None, :]) @ V.mT - a64).norm(dim=(1, 2))
                     / a64.norm(dim=(1, 2))).max())
        eye = torch.eye(U.shape[-1], dtype=torch.float64, device=dev)
        # the 2-norm of the symmetric U^T U - I: its largest |eigenvalue|
        orth = torch.linalg.eigvalsh(U.mT @ U - eye).abs().amax(dim=1)
        reach = qdwh_reach(a64, s64)
        short = (reach > 1e-7).nonzero().flatten().tolist()
        info = {i: (float(orth[i]), float(reach[i]),
                    float(s64[i, 0] / s64[i, -1])) for i in short}
        worst = int(orth.argmax())
        print(f"serving {what} {tuple(a.shape)}: ok {int(res.ok.sum())}/{bsz}, "
              f"max |sigma - sigma64| / sigma_max {sig:.3e}, "
              f"||U S V^T - A|| / ||A|| {rec:.3e}, ||U^T U - I||_2 "
              f"{float(orth.max()):.3e} in lane {worst} (tol {TOL_SVD} each, "
              f"plus 2.5x the defect the reference's 8 QDWH steps leave: "
              f"(lane: ||U^T U - I||_2, defect, float64 kappa_2) {info})")
        if not (bool(res.ok.all()) and max(sig, rec) <= TOL_SVD
                and bool((orth <= TOL_SVD + 2.5 * reach).all())):
            raise AssertionError(f"{what} failed its check")
        errs[what] = max(sig, rec, float(orth.max()))

    # det_exact: bitwise the host's int32 Bareiss, exact wherever no
    # product left int32; crt_det_batched exact wherever one might have
    for what in ("det_small", "det_big"):
        a = x[what]
        res = solver.det_exact(a)
        a_np = a.cpu().numpy()
        det32, rank32, ok32, _ = host_bareiss(a_np, exact=False)
        det, rank, _, over = host_bareiss(a_np, exact=True)
        card = [t.cpu().numpy() for t in res]
        same = all(np.array_equal(c, h)
                   for c, h in zip(card, (det32, rank32, ok32)))
        ok = card[2]
        fine = ~over
        exact_ok = bool((card[0][fine] == det[fine].astype(np.int64)).all())
        missed = np.nonzero(ok & over)[0].tolist()
        crt_lanes = np.nonzero(~ok | over)[0]
        crt = crt_det_batched(a[torch.from_numpy(crt_lanes).to(dev)])
        crt_exact = crt == [int(det[i]) for i in crt_lanes]
        print(f"serving {what} {tuple(a.shape)}: det, rank, ok bitwise the "
              f"host's int32 Bareiss {same}; ok on {int(ok.sum())} lanes; a "
              f"product left int32 on {int(over.sum())} lanes; det exact on "
              f"every other lane {exact_ok}; ok with a product past int32 "
              f"(the sentinel's misses, as the reference's) on "
              f"{len(missed)} lanes {missed[:8]}; crt_det_batched exact on "
              f"the {len(crt_lanes)} lanes not ok or past int32 {crt_exact}")
        if not (same and exact_ok and crt_exact):
            raise AssertionError(f"{what} failed its check")
        if what == "det_big" and bool(ok.any()):
            raise AssertionError("a 24x24 lane with entries to 1e4 is ok")
    return x, errs


def time_family(dev, card, x):
    """Phase 35: each serving method beside the one library call that
    computes the same function on the same input (CUDA events, median of
    3).  Float64 ``det`` is the nearest library call to ``det_exact``,
    not the same function: it is not exact."""
    from linalg_solver_tpu_torch.models.solver import BatchedSolver
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    solver = BatchedSolver()
    cells = (
        ("serve-rcond-256", solver.rcond, (x["rcond"],),
         "torch.linalg.cond(p=1)", lambda a: torch.linalg.cond(a, p=1)),
        ("serve-lstsq-768x256", solver.lstsq, x["lstsq_tall"],
         "torch.linalg.lstsq", lambda a, b: torch.linalg.lstsq(a, b[..., None])),
        ("serve-lstsq-min-256x768", solver.lstsq, x["lstsq_wide"],
         "torch.linalg.lstsq", lambda a, b: torch.linalg.lstsq(a, b[..., None])),
        ("serve-svd-256", solver.svd, (x["svd_square"],),
         "torch.linalg.svd", lambda a: torch.linalg.svd(
             a, full_matrices=False)),
        ("serve-svd-768x256", solver.svd, (x["svd_tall"],),
         "torch.linalg.svd", lambda a: torch.linalg.svd(
             a, full_matrices=False)),
        ("serve-det-exact-8", solver.det_exact, (x["det_small"],),
         "torch.linalg.det(float64)",
         lambda a: torch.linalg.det(a.double())),
        ("serve-det-exact-24", solver.det_exact, (x["det_big"],),
         "torch.linalg.det(float64)",
         lambda a: torch.linalg.det(a.double())),
    )
    out = {}
    for cell, fn, args, lib_name, lib in cells:
        t = cuda_time(fn, *args, warmup=1, iters=3)
        tl = cuda_time(lib, *args, warmup=1, iters=3)
        out[cell] = {"ms": t * 1e3, "library": lib_name,
                     "library_ms": tl * 1e3,
                     "shape": list(args[0].shape)}
        print(f"time {cell} {tuple(args[0].shape)}: BatchedSolver "
              f"{t * 1e3:.4f} ms, {lib_name} {tl * 1e3:.4f} ms ({card})")
    return out


# --- phases 36-45: the eigenvector family (eig_batched and what is built
# on it), at the Schur cells' width ---------------------------------------

EIGF_B, EIGF_N = B_SPEC, N_SPEC
ROOTS_B, ROOTS_D = 1024, 32
ROOTS_ZERO_LANE = 5        # its leading coefficient is zero: ok False
RIC_N, RIC_M = 128, 16     # care-128 / dare-128: Hamiltonians 256 x 256
RIC_SCIPY_LANES = 4
QUAD_N = 128               # quadeig-128: the linearization is 256 x 256
STEIN_RHO, STEIN_BAD = 0.9, 1.1
STEIN_BAD_LANE = 1
GSHIFT_LANES = (0, 2, 4, 6)  # geig-256's shifted pencils: B of rank n - 4
GSHIFT_INF = 4
#: the family's limits
EIGF_LIMITS = {
    "eig_p99": 2e-6, "eig_max": 1e-5, "eig_worse": 1e-7,
    "eig_spectrum": 1e-4, "cond_s": 1e-3, "cond_jordan_min_s": 1e-3,
    "cond_jordan_max_err": 1e-2, "roots": 1e-3,
    "sign_s2": 64 * EIGF_N * 2.0 ** -23, "sign_projector": 1e-4,
    "sylvester": 1e-5, "sylvester_imag_defect": 1e-4, "lyapunov": 1e-5,
    "lyapunov_imag_defect": 1e-4, "stein": 1e-5, "care": 1e-3,
    "dare": 1e-3, "geigh_w": 1e-4, "geigh_vtbv": 1e-4,
    "geig_spectrum": 1e-3, "geig_rcond": 10.0, "quadeig": 1e-4,
}
#: the JAX package's own figures where it misses a limit on the same
#: inputs (JAX 0.9.0 on the CPU, all 32 lanes: ``JAX_PLATFORMS=cpu
#: PYTHONPATH=. python tests/test_torch_eig_family.py --lanes 32 --cells
#: eig-cond-256,sign-256,sylvester-256,care-128``; on every other limit
#: it stays inside on the first 8 lanes, ``--lanes 8``): the card is held
#: to 1.5x these
EIGF_JAX = {
    "cond_s": 1.3036941179998534e-03,
    "sign_projector": 1.249580089468259e-04,
    "sylvester_imag_defect": 2.3421755759045482e-04,
}


def eigf_inputs(bsz=EIGF_B, n=EIGF_N, roots_b=ROOTS_B, ric_n=RIC_N,
                quad_n=QUAD_N):
    """The family's inputs, float32 numpy arrays built on the host from
    seeds (the special lanes sit among the first eight, so that a run on
    eight lanes meets them too)."""
    import numpy as np

    f32 = np.float32
    x = {}
    # eig-256: examples/chip_eig_tail.py's batch
    x["eig"] = np.random.RandomState(0).randn(bsz, n, n).astype(f32)
    # eig-cond-256: the same, plus a lane holding test_ops_schur.py's
    # near-defective input (a 16-block at 0.5 under a seeded similarity)
    # beside n - 16 eigenvalues spaced 4/(n - 17) apart in [2, 6], under
    # a seeded orthogonal similarity
    rng = np.random.RandomState(6)
    J = (np.eye(16) * 0.5 + np.eye(16, k=1)).astype(f32)
    P = rng.randn(16, 16).astype(f32)
    D = np.zeros((n, n))
    D[:16, :16] = np.linalg.solve(P, J @ P)
    D[16:, 16:] = np.diag(2.0 + 4.0 * np.arange(n - 16) / (n - 17))
    Qo, _ = np.linalg.qr(np.random.RandomState(7).randn(n, n))
    x["cond"] = np.concatenate([x["eig"], (Qo @ D @ Qo.T)[None].astype(f32)])
    # roots: degree-32 polynomials from 16 conjugate pairs of prescribed
    # roots, radius in [0.8, 1.2], angles pi (k + 1/2)/16 jittered by
    # +-0.05: well separated
    rng = np.random.RandomState(11)
    h = ROOTS_D // 2
    ang = np.pi * (np.arange(h) + 0.5) / h + rng.uniform(-0.05, 0.05,
                                                         (roots_b, h))
    z = rng.uniform(0.8, 1.2, (roots_b, h)) * np.exp(1j * ang)
    z = np.concatenate([z, z.conj()], axis=1)
    c = np.stack([np.poly(r).real for r in z])
    c[ROOTS_ZERO_LANE, 0] = 0.0
    x["roots"] = c.astype(f32)
    rs = n ** 0.5
    # sign-256: A = G + 3 sqrt(n) diag(+-1)
    rng = np.random.RandomState(12)
    signs = rng.choice([-1.0, 1.0], (bsz, n))
    x["sign"] = (rng.randn(bsz, n, n)
                 + 3 * rs * np.eye(n) * signs[:, None, :]).astype(f32)
    # sylvester-256: A = G1 + 3 sqrt(n) I, B = G2 + 3 sqrt(n) I, C = G3;
    # Lyapunov on A with Q = C + C^T
    rng = np.random.RandomState(13)
    a = (rng.randn(bsz, n, n) + 3 * rs * np.eye(n)).astype(f32)
    b = (rng.randn(bsz, n, n) + 3 * rs * np.eye(n)).astype(f32)
    cc = rng.randn(bsz, n, n).astype(f32)
    x["sylvester"] = (a, b, cc)
    x["lyapunov"] = (a, (cc + cc.transpose(0, 2, 1)).astype(f32))
    # stein: rho(A) = 0.9 (a Gaussian scaled by its own spectral radius),
    # 1.1 on one lane; Q = H H^T / n
    rng = np.random.RandomState(14)
    g = rng.randn(bsz, n, n)
    rho = np.abs(np.linalg.eigvals(g)).max(axis=1)
    scale = np.full(bsz, STEIN_RHO)
    scale[STEIN_BAD_LANE] = STEIN_BAD
    hh = rng.randn(bsz, n, n)
    x["stein"] = ((g * (scale / rho)[:, None, None]).astype(f32),
                  (hh @ hh.transpose(0, 2, 1) / n).astype(f32))
    # care-128 / dare-128: B [n, m], Q = C^T C, R = I + H H^T / m; for
    # the CARE A = G / (2 sqrt n) - I (eigenvalues' real parts in about
    # [-1.5, -0.5]), for the DARE A = 0.9 G / sqrt(n) (rho about 0.9)
    rng = np.random.RandomState(15)
    m, rn = RIC_M, ric_n ** 0.5
    ga = rng.randn(bsz, ric_n, ric_n) / rn
    bb = rng.randn(bsz, ric_n, m).astype(f32)
    cq = rng.randn(bsz, ric_n, ric_n) / rn
    q = (cq.transpose(0, 2, 1) @ cq).astype(f32)
    hr = rng.randn(bsz, m, m)
    r = (np.eye(m) + hr @ hr.transpose(0, 2, 1) / m).astype(f32)
    x["care"] = ((ga / 2 - np.eye(ric_n)).astype(f32), bb, q, r)
    x["dare"] = ((0.9 * ga).astype(f32), bb, q, r)
    # geig-256: symmetric A with B = H H^T / n + I; general A with
    # B = H + 4 sqrt(n) I; the shifted pencils P diag(lam) Q,
    # P diag(1, .., 1, 0 x 4) Q on GSHIFT_LANES (lam in [-3, -1])
    rng = np.random.RandomState(16)
    g = rng.randn(bsz, n, n)
    hh = rng.randn(bsz, n, n)
    x["geigh"] = ((g + g.transpose(0, 2, 1)).astype(f32),
                  (hh @ hh.transpose(0, 2, 1) / n + np.eye(n)).astype(f32))
    x["geig"] = (rng.randn(bsz, n, n).astype(f32),
                 (rng.randn(bsz, n, n) + 4 * rs * np.eye(n)).astype(f32))
    lam = -(1.0 + 2.0 * np.arange(n) / (n - 1))
    da = np.tile(lam, (bsz, 1))
    db = np.ones((bsz, n))
    for lane in GSHIFT_LANES[:(bsz + 1) // 2]:
        da[lane, -GSHIFT_INF:] = 1.0
        db[lane, -GSHIFT_INF:] = 0.0
    pp = np.eye(n) + 0.4 * rng.randn(bsz, n, n) / rs
    qq = np.eye(n) + 0.4 * rng.randn(bsz, n, n) / rs
    x["gshift"] = ((pp * da[:, None, :] @ qq).astype(f32),
                   (pp * db[:, None, :] @ qq).astype(f32))
    # quadeig-128: M = I + G/(4 sqrt n), C and K Gaussian / sqrt(n)
    rng = np.random.RandomState(17)
    g = rng.randn(3, bsz, quad_n, quad_n) / quad_n ** 0.5
    x["quad"] = ((np.eye(quad_n) + g[0] / 4).astype(f32), g[1].astype(f32),
                 g[2].astype(f32))
    return x


def eigf_lanes(x, lanes):
    """The first ``lanes`` lanes of every input of ``eigf_inputs`` (the
    condition batch keeps its last lane, the Jordan chain; the
    polynomials are kept whole): the same inputs at fewer lanes."""
    out = {}
    for k, v in x.items():
        if k == "cond":
            out[k] = v[list(range(lanes)) + [v.shape[0] - 1]]
        elif k == "roots":
            out[k] = v
        else:
            out[k] = (tuple(t[:lanes] for t in v) if isinstance(v, tuple)
                      else v[:lanes])
    return out


def _host(res):
    """A result tuple's fields as numpy arrays (torch on any device, or
    any array numpy can read)."""
    import numpy as np

    return {f: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v))
            for f, v in zip(res._fields, res) if v is not None}


def _pairs(want, got):
    """Indices pairing each of ``want`` with one of ``got`` (the one-to-one
    matching of least total distance)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(np.abs(want[:, None] - got[None, :]))


def fig_eig(a, r0, r1, lib):
    """eig-256's figures from host results: over the valid columns, the
    median, p99 and max of ||A v - lam v||_2 / ||A||_F with refine_steps 1
    (and 0), the valid count, the worst growth of a column's residual
    from 0 to 1 refinement step, and the spectrum's largest distance from
    ``lib`` (eigenvalues in float64 from a library, matched one to one)
    over ||A||_2."""
    import numpy as np

    a64 = a.astype(np.float64)
    anorm = np.linalg.norm(a64, axis=(1, 2))
    out = {}
    res = {}
    for k, r in ((0, r0), (1, r1)):
        V = r["vectors_real"].astype(np.float64) + 1j * r["vectors_imag"]
        lam = r["real"].astype(np.float64) + 1j * r["imag"]
        rn = np.linalg.norm(a64 @ V - lam[:, None, :] * V, axis=1) / anorm[
            :, None]
        res[k] = rn
        v = rn[r["valid"]]
        out[k] = {"median": float(np.median(v)),
                  "p99": float(np.percentile(v, 99)), "max": float(v.max()),
                  "valid": int(r["valid"].sum())}
    both = r0["valid"] & r1["valid"]
    out["worse"] = float((res[1] - res[0])[both].max())
    a2 = np.linalg.norm(a64, 2, axis=(1, 2))
    lam = r1["real"].astype(np.float64) + 1j * r1["imag"]
    dev = []
    for b in range(a.shape[0]):
        i, j = _pairs(lib[b], lam[b])
        dev.append(np.abs(lib[b][i] - lam[b][j]).max() / a2[b])
    out["spectrum"] = float(max(dev))
    out["converged"] = int(r1["converged"].sum())
    return out


def fig_cond(a, r, jordan_lane):
    """eig-cond-256's figures: the range of s, the largest relative
    distance of s from scipy's float64 dtrsna-style s (left and right
    eigenvectors of ``scipy.linalg.eig``) over the Gaussian lanes where
    scipy's s > 1e-3, and the Jordan lane's min s and max err_est."""
    import numpy as np
    import scipy.linalg as sl

    lam = r["real"].astype(np.float64) + 1j * r["imag"]
    worst, at = 0.0, None
    for b in range(a.shape[0]):
        if b == jordan_lane:
            continue
        w, vl, vr = sl.eig(a[b].astype(np.float64), left=True, right=True)
        s64 = np.abs((vl.conj() * vr).sum(0)) / (
            np.linalg.norm(vl, axis=0) * np.linalg.norm(vr, axis=0))
        i, j = _pairs(w, lam[b])
        rel = np.where(s64[i] > 1e-3,
                       np.abs(r["s"][b][j] - s64[i]) / s64[i], 0.0)
        k = int(rel.argmax())
        if rel[k] > worst:
            worst, at = float(rel[k]), [b, float(s64[i][k]), str(w[i][k])]
    s = r["s"]
    return {"s_min": float(s.min()), "s_max": float(s.max()),
            "s_vs_scipy": worst, "s_vs_scipy_at": at,
            "jordan_min_s": float(s[jordan_lane].min()),
            "jordan_max_err": float(r["err_est"][jordan_lane].max()),
            "valid": int(r["valid"].sum()),
            "converged": int(r["converged"].sum())}


def fig_roots(c, r):
    """roots' figures: each root's distance from numpy's float64
    ``np.roots`` of the same float32 coefficients (matched one to one)
    over max(1, |root|), the worst lane; the lanes not ok."""
    import numpy as np

    got = r["real"].astype(np.float64) + 1j * r["imag"]
    worst = 0.0
    for b in range(c.shape[0]):
        if b == ROOTS_ZERO_LANE:
            continue
        want = np.roots(c[b].astype(np.float64))
        i, j = _pairs(want, got[b])
        worst = max(worst, float((np.abs(want[i] - got[b][j])
                                  / np.maximum(1.0, np.abs(want[i]))).max()))
    return {"roots": worst,
            "not_ok": [int(i) for i in np.flatnonzero(~r["ok"])],
            "converged": int(r["converged"].sum())}


def fig_sign(r, counts, lib_counts, proj):
    """sign-256's figures: max|S^2 - I|, whether the left counts equal the
    library eigenvalues' negative real parts, max|P^2 - P|."""
    import numpy as np

    S = r["S"].astype(np.float64)
    n = S.shape[-1]
    P = proj.astype(np.float64)
    return {"sign_s2": float(np.abs(S @ S - np.eye(n)).max()),
            "counts_equal": bool((counts == lib_counts).all()),
            "sign_projector": float(np.abs(P @ P - P).max()),
            "iters": int(r["iters"]), "converged": int(r["converged"].sum())}


def _fro(x):
    import numpy as np

    return np.linalg.norm(x, axis=(-2, -1))


def fig_sylvester(a, b, c, r):
    """The worst relative residual ||AX + XB - C|| / ((||A|| + ||B||)||X||
    + ||C||) (Frobenius, float64), ok and the largest imag_defect."""
    import numpy as np

    a, b, c = (t.astype(np.float64) for t in (a, b, c))
    X = r["X"].astype(np.float64)
    res = _fro(a @ X + X @ b - c) / ((_fro(a) + _fro(b)) * _fro(X) + _fro(c))
    return {"resid": float(res.max()), "ok": int(r["ok"].sum()),
            "imag_defect": float(r["imag_defect"].max())}


def fig_stein(a, q, r):
    """The worst relative residual ||A X A^T - X + Q|| / (||A||^2 ||X|| +
    ||X|| + ||Q||) over the lanes ok, and the lanes not ok."""
    import numpy as np

    a, q = a.astype(np.float64), q.astype(np.float64)
    X = r["X"].astype(np.float64)
    res = _fro(a @ X @ a.transpose(0, 2, 1) - X + q) / (
        _fro(a) ** 2 * _fro(X) + _fro(X) + _fro(q))
    return {"resid": float(res[r["ok"]].max()),
            "not_ok": [int(i) for i in np.flatnonzero(~r["ok"])],
            "iters": int(r["iters"])}


def fig_riccati(args, r, discrete):
    """ok, and X's largest relative distance (max-abs over max-abs) from
    scipy's float64 solve_continuous_are / solve_discrete_are on the
    first ``lanes`` lanes."""
    import numpy as np
    import scipy.linalg as sl

    solve = sl.solve_discrete_are if discrete else sl.solve_continuous_are
    worst = 0.0
    for b in range(min(RIC_SCIPY_LANES, len(r["X"]))):
        want = solve(*(t[b].astype(np.float64) for t in args))
        worst = max(worst, float(np.abs(r["X"][b] - want).max()
                                 / np.abs(want).max()))
    return {"x_vs_scipy": worst, "ok": int(r["ok"].sum()),
            "resid": float(r["resid"].max())}


def fig_geig(xh, rh, xg, rg, rs):
    """geig-256's figures: eigh_generalized's eigenvalues against scipy's
    float64 ``eigh(a, b)`` (relative to the lane's largest) and
    max|V^T B V - I|; eig_generalized's spectrum against scipy's
    ``eigvals(a, b)`` (matched one to one, relative to the lane's
    largest) and rcond_b over the exact 1/kappa_1(B) (its range); the
    shifted pencils' count of columns not finite a lane."""
    import numpy as np
    import scipy.linalg as sl

    a, b = (t.astype(np.float64) for t in xh)
    wt, worst_w, worst_v = rh["w"].astype(np.float64), 0.0, 0.0
    V = rh["V"].astype(np.float64)
    for k in range(a.shape[0]):
        w = sl.eigh(a[k], b[k], eigvals_only=True)
        worst_w = max(worst_w, float(np.abs(wt[k] - w).max()
                                     / np.abs(w).max()))
        worst_v = max(worst_v, float(np.abs(V[k].T @ b[k] @ V[k]
                                            - np.eye(len(w))).max()))
    a, b = (t.astype(np.float64) for t in xg)
    lam = rg["real"].astype(np.float64) + 1j * rg["imag"]
    worst_l, ratio = 0.0, []
    for k in range(a.shape[0]):
        w = sl.eigvals(a[k], b[k])
        i, j = _pairs(w, lam[k])
        worst_l = max(worst_l, float(np.abs(w[i] - lam[k][j]).max()
                                     / np.abs(w).max()))
        ratio.append(float(rg["rcond_b"][k]) * np.linalg.cond(b[k], 1))
    inf = (~rs["finite"]).sum(axis=1)
    return {"geigh_w": worst_w, "geigh_vtbv": worst_v,
            "geig_spectrum": worst_l, "rcond_ratio": [min(ratio), max(ratio)],
            "geig_ok": int(rg["ok"].sum()),
            "not_finite": {int(k): int(v) for k, v in enumerate(inf) if v},
            "shift_ok": int(rs["ok"].sum())}


def fig_quad(mck, r):
    """quadeig-128's figure: the worst ||(lam^2 M + lam C + K) v|| /
    ((|lam|^2 ||M|| + |lam| ||C|| + ||K||) ||v||) (2-norms of the vector,
    1-norms of the matrices, float64) over the finite, valid columns; the
    count of those columns."""
    import numpy as np

    M, C, K = (t.astype(np.float64) for t in mck)
    lam = r["real"].astype(np.float64) + 1j * r["imag"]
    V = r["vectors_real"].astype(np.float64) + 1j * r["vectors_imag"]
    keep = r["finite"] & r["valid"]
    lam0 = np.where(keep, lam, 0.0)
    res = (M @ V * lam0[:, None, :] ** 2 + C @ V * lam0[:, None, :]
           + K @ V)
    nrm = lambda t: np.abs(t).sum(axis=1).max(axis=1)[:, None]
    scale = (np.abs(lam0) ** 2 * nrm(M) + np.abs(lam0) * nrm(C) + nrm(K)) * (
        np.linalg.norm(V, axis=1))
    rel = np.linalg.norm(res, axis=1) / np.maximum(scale, 1e-300)
    return {"quadeig": float(rel[keep].max()), "columns": int(keep.sum()),
            "finite": int(r["finite"].sum()), "ok": int(r["ok"].sum())}


def run_family(ops, x, to, lib, call=None, cells=None):
    """Every entry point of the family on the inputs ``x`` (``to`` moves a
    numpy array to the package's device; ``lib(a)`` gives a library's
    eigenvalues of a numpy batch as numpy; ``call(key, thunk)``, if
    given, runs each entry point, to count its launches; ``cells``, if
    given, names the cells to run): the host results and figures, keyed
    by cell.  Shared by ``drive_eig_family`` and a run of another package
    with the same API on the same inputs."""
    schur = ops.schur
    out, figs = {}, {}
    call = call or (lambda key, thunk: thunk())

    def want(cell):
        return cells is None or cell in cells

    def go(key, fn, *args, **kw):
        targs = [to(t) for t in args]
        res = call(key, lambda: fn(*targs, **kw))
        out[key] = _host(res) if hasattr(res, "_fields") else [
            _host_array(t) for t in res]
        return out[key]

    if want("eig-256"):
        a = x["eig"]
        r0 = go("eig0", ops.eig_batched, a, refine_steps=0)
        r1 = go("eig1", ops.eig_batched, a, refine_steps=1)
        figs["eig-256"] = fig_eig(a, r0, r1, lib(a))
    if want("eig-cond-256"):
        rc = go("cond", schur.eig_condition_batched, x["cond"])
        figs["eig-cond-256"] = fig_cond(x["cond"], rc,
                                        x["cond"].shape[0] - 1)
    if want("roots"):
        figs["roots"] = fig_roots(x["roots"], go("roots", ops.roots_batched,
                                                 x["roots"]))
    if want("sign-256"):
        rsg = go("sign", ops.sign_batched, x["sign"])
        counts, _ = go("count", ops.eig_count_left_batched, x["sign"])
        proj, _ = go("projector", ops.spectral_projector_batched, x["sign"])
        figs["sign-256"] = fig_sign(rsg, counts,
                                    (lib(x["sign"]).real < 0).sum(axis=1),
                                    proj)
    if want("sylvester-256"):
        figs["sylvester-256"] = fig_sylvester(
            *x["sylvester"], go("sylvester", ops.sylvester_batched,
                                *x["sylvester"]))
        a_l, q_l = x["lyapunov"]
        figs["lyapunov-256"] = fig_sylvester(
            a_l, a_l.transpose(0, 2, 1), q_l,
            go("lyapunov", ops.lyapunov_batched, a_l, q_l))
        figs["stein-256"] = fig_stein(*x["stein"], go(
            "stein", ops.stein_batched, *x["stein"]))
    if want("care-128"):
        figs["care-128"] = fig_riccati(x["care"], go(
            "care", ops.care_batched, *x["care"]), False)
        figs["dare-128"] = fig_riccati(x["dare"], go(
            "dare", ops.dare_batched, *x["dare"]), True)
    if want("geig-256"):
        figs["geig-256"] = fig_geig(
            x["geigh"], go("geigh", ops.eigh_generalized_batched,
                           *x["geigh"]),
            x["geig"], go("geig", ops.eig_generalized_batched, *x["geig"]),
            go("gshift", ops.eig_generalized_shifted_batched, *x["gshift"]))
    if want("quadeig-128"):
        figs["quadeig-128"] = fig_quad(x["quad"], go(
            "quad", ops.quadeig_batched, *x["quad"]))
    return out, figs


def _host_array(t):
    import numpy as np

    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def hold_family(figs, bsz=EIGF_B):
    """Every limit of the family on ``figs`` (``EIGF_LIMITS``, or 1.5x the
    JAX package's figure in ``EIGF_JAX`` where that misses the limit);
    raises on the first one missed."""
    def lim(key):
        jax_fig = EIGF_JAX.get(key)
        base = EIGF_LIMITS[key]
        return base if jax_fig is None or jax_fig <= base else 1.5 * jax_fig

    e, c = figs["eig-256"], figs["eig-cond-256"]
    checks = [
        ("eig p99", e[1]["p99"], lim("eig_p99")),
        ("eig max", e[1]["max"], lim("eig_max")),
        ("eig refine 1 worse than 0 by", e["worse"], lim("eig_worse")),
        ("eig spectrum vs library / ||A||_2", e["spectrum"],
         lim("eig_spectrum")),
        ("eig-cond s vs scipy", c["s_vs_scipy"], lim("cond_s")),
        ("roots vs np.roots", figs["roots"]["roots"], lim("roots")),
        ("sign max|S^2 - I|", figs["sign-256"]["sign_s2"], lim("sign_s2")),
        ("sign projector max|P^2 - P|", figs["sign-256"]["sign_projector"],
         lim("sign_projector")),
        ("sylvester residual", figs["sylvester-256"]["resid"],
         lim("sylvester")),
        ("sylvester imag_defect", figs["sylvester-256"]["imag_defect"],
         lim("sylvester_imag_defect")),
        ("lyapunov residual", figs["lyapunov-256"]["resid"], lim("lyapunov")),
        ("lyapunov imag_defect", figs["lyapunov-256"]["imag_defect"],
         lim("lyapunov_imag_defect")),
        ("stein residual", figs["stein-256"]["resid"], lim("stein")),
        ("care X vs scipy", figs["care-128"]["x_vs_scipy"], lim("care")),
        ("dare X vs scipy", figs["dare-128"]["x_vs_scipy"], lim("dare")),
        ("geigh eigenvalues vs scipy", figs["geig-256"]["geigh_w"],
         lim("geigh_w")),
        ("geigh max|V^T B V - I|", figs["geig-256"]["geigh_vtbv"],
         lim("geigh_vtbv")),
        ("geig spectrum vs scipy", figs["geig-256"]["geig_spectrum"],
         lim("geig_spectrum")),
        ("quadeig residual", figs["quadeig-128"]["quadeig"], lim("quadeig")),
    ]
    for what, got, limit in checks:
        if not got <= limit:
            raise AssertionError(f"{what} {got} above its limit {limit}")
    lo, hi = figs["geig-256"]["rcond_ratio"]
    g = figs["geig-256"]
    flags = [
        ("eig-256 every lane converged", e["converged"] == bsz),
        ("eig-cond-256 s in (0, 1]", c["s_min"] > 0 and c["s_max"] <= 1.0),
        ("eig-cond-256 Jordan lane's min s below the limit",
         c["jordan_min_s"] < EIGF_LIMITS["cond_jordan_min_s"]),
        ("eig-cond-256 Jordan lane's max err_est above the limit",
         c["jordan_max_err"] > EIGF_LIMITS["cond_jordan_max_err"]),
        ("roots ok False on the zero-lead lane only",
         figs["roots"]["not_ok"] == [ROOTS_ZERO_LANE]),
        ("sign-256 converged on every lane",
         figs["sign-256"]["converged"] == bsz),
        ("sign-256 counts equal the library's",
         figs["sign-256"]["counts_equal"]),
        ("sylvester-256 ok on every lane", figs["sylvester-256"]["ok"] == bsz),
        ("lyapunov-256 ok on every lane", figs["lyapunov-256"]["ok"] == bsz),
        ("stein-256 not ok on the rho = 1.1 lane only",
         figs["stein-256"]["not_ok"] == [STEIN_BAD_LANE]),
        ("care-128 ok on every lane", figs["care-128"]["ok"] == bsz),
        ("dare-128 ok on every lane", figs["dare-128"]["ok"] == bsz),
        ("geig-256 rcond_b within 10x of 1/kappa_1",
         1 / EIGF_LIMITS["geig_rcond"] <= lo and hi <= EIGF_LIMITS[
             "geig_rcond"]),
        ("geig-256 ok on every lane", g["geig_ok"] == bsz),
        ("geig-256 shifted: 4 columns not finite on the rank n - 4 lanes "
         "and none elsewhere",
         g["not_finite"] == {k: GSHIFT_INF
                             for k in GSHIFT_LANES[:(bsz + 1) // 2]}),
    ]
    for what, good in flags:
        if not good:
            raise AssertionError(f"{what}: no")


def drive_eig_family(dev):
    """Phases 36-44: every entry point of the family on ``eigf_inputs``
    on the card, each driven with the kernels' counts set to 0 just before
    it and read just after, its figures printed beside their limits and
    held (``hold_family``); then both Schur kernels held against their
    plain versions (``hold_schur``) on every distinct Schur input the
    paths gave ``real_schur``, in its dtype, with or without Q.  Returns
    the inputs, the results, the launches a cell, the kernels' held error
    and the recorded arguments of the main path's ``_shifted_backsolve``."""
    import numpy as np

    from linalg_solver_tpu_torch import ops
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    t0 = time.perf_counter()
    x = eigf_inputs()
    print(f"eigenvector family inputs built on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = {}
    schur_inputs = []        # (key, a, with_q, balance, npairs, aed_w)
    run_schur, key_now = schur._run_schur, [None]

    def run_rec(a, max_sweeps, chunk, balance, with_q, *rest):
        schur_inputs.append((key_now[0], a.clone(), with_q, balance) + rest)
        return run_schur(a, max_sweeps, chunk, balance, with_q, *rest)

    def call(key, thunk):
        key_now[0] = key
        reset_counts()
        res = thunk()
        torch.cuda.synchronize()
        counts = phase_counts()
        launches[key] = {"chase": sc.LAUNCHES,
                         "window": counts.pop("schur_window"),
                         "kernels 1-6": sum(counts.values())}
        return res

    def to(t):
        return torch.from_numpy(t).to(dev)

    def lib(a):
        return torch.linalg.eigvals(to(a)).cpu().numpy().astype(np.complex128)

    bs_calls, off = record(schur, "_shifted_backsolve", keep=1)
    schur._run_schur = run_rec
    t0 = time.perf_counter()
    try:
        out, figs = run_family(ops, x, to, lib, call)
    finally:
        off()
        schur._run_schur = run_schur
    secs = time.perf_counter() - t0
    for cell, f in figs.items():
        print(f"eigenvector family {cell}: {json.dumps(f)}")
    print(f"eigenvector family launches a call (chase, window, kernels 1-6):"
          f" {json.dumps(launches)}; {secs:.2f} s with the host's checks")
    print(f"eigenvector family limits {json.dumps(EIGF_LIMITS)}, the JAX "
          f"package's figures where it misses one {json.dumps(EIGF_JAX)}")
    hold_family(figs)
    chase = sum(v["chase"] for v in launches.values())
    window = sum(v["window"] for v in launches.values())
    if chase < 1 or window < 1:
        raise AssertionError("the eigenvector family launched no chase or "
                             "no window kernel")
    t0 = time.perf_counter()
    err, held = 0.0, []
    for key, a, with_q, *conf in schur_inputs:
        if any(a.dtype == b.dtype and q == with_q and a.shape == b.shape
               and torch.equal(a, b) for b, q in held):
            continue
        e, _, _ = hold_schur(a, with_q, f"on the family's {key} "
                             f"{list(a.shape)}", *conf)
        err = max(err, e)
        held.append((a, with_q))
    kinds = sorted({(str(a.dtype), tuple(a.shape), q) for a, q in held})
    print(f"eigenvector family: both Schur kernels held on {len(held)} "
          f"distinct Schur inputs of {len(schur_inputs)} ((dtype, shape, "
          f"Q): {kinds}), max abs diff {err:.3e}, "
          f"{time.perf_counter() - t0:.2f} s")
    keys = {k for k, *_ in schur_inputs}
    if not keys >= {"eig1", "cond", "roots", "sylvester", "lyapunov",
                    "geig", "gshift", "quad"}:
        raise AssertionError(f"the family's Schur inputs came only from "
                             f"{sorted(keys)}")
    return {"x": x, "out": out, "figs": figs, "launches": launches,
            "chase": chase, "window": window, "err": err,
            "backsolve": bs_calls[0][0]}


def time_eig_family(dev, card, fam):
    """Phase 45: each entry point as the median of 3 calls after the
    check's call (its warm-up), beside the one library call that computes
    the same function where there is one (after one warm-up of its own;
    ``torch.linalg.eig`` and ``eigvals``, seconds a call, once without
    one);
    ``eig_condition_batched`` (its Schur form and back-substitutions in
    float64) beside the same in float32, the reference's arithmetic
    (after one warm-up), and that form's s against scipy's;
    ``_shifted_backsolve`` alone on the main path's arguments, with its
    device events a call, beside ``real_schur_vectors`` (eig_batched's
    Schur part).  ``polyeig_batched`` is timed as ``quadeig_batched``,
    which is the quadratic case of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from linalg_solver_tpu_torch import ops
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    x = fam["x"]

    def to(t):
        return torch.from_numpy(t).to(dev)

    a = to(x["eig"])
    c = to(x["roots"])
    comp = torch.diag(torch.ones(ROOTS_D - 1, device=dev), -1).expand(
        c.shape[0], ROOTS_D, ROOTS_D).clone()
    comp[:, 0, :] = -c[:, 1:] / torch.where(c[:, :1] != 0, c[:, :1], 1.0)
    ah, bh = to(x["geigh"][0]), to(x["geigh"][1])
    L = torch.linalg.cholesky(bh)
    red = torch.linalg.solve_triangular(L, torch.linalg.solve_triangular(
        L, ah, upper=False).transpose(1, 2), upper=False)
    ag, bg = to(x["geig"][0]), to(x["geig"][1])
    sg = to(x["sign"])
    f32_form = "eig-cond-256 the same in float32"
    cells = (
        ("eig-256 eig_batched", ops.eig_batched, (a,),
         "torch.linalg.eig", torch.linalg.eig, (a,)),
        ("eig-cond-256 eig_condition_batched", schur.eig_condition_batched,
         (to(x["cond"]),), None, None, None),
        (f32_form, lambda a_: schur._eig_condition(a_, torch.float32),
         (to(x["cond"]),), None, None, None),
        ("roots roots_batched", ops.roots_batched, (c,),
         "torch.linalg.eigvals(companion)", torch.linalg.eigvals, (comp,)),
        ("geig-256 eigh_generalized_batched", ops.eigh_generalized_batched,
         (ah, bh), "torch.linalg.eigh(L^-1 A L^-T)", torch.linalg.eigh,
         (red,)),
        ("geig-256 eig_generalized_batched", ops.eig_generalized_batched,
         (ag, bg), "torch.linalg.eig(torch.linalg.solve(B, A))",
         lambda a_, b_: torch.linalg.eig(torch.linalg.solve(b_, a_)),
         (ag, bg)),
        ("geig-256 eig_generalized_shifted_batched",
         ops.eig_generalized_shifted_batched, tuple(map(to, x["gshift"])),
         None, None, None),
        ("quadeig-128 quadeig_batched", ops.quadeig_batched,
         tuple(map(to, x["quad"])), None, None, None),
        ("sign-256 sign_batched", ops.sign_batched, (sg,), None, None,
         None),
        ("sign-256 eig_count_left_batched", ops.eig_count_left_batched,
         (sg,), None, None, None),
        ("sign-256 spectral_projector_batched",
         ops.spectral_projector_batched, (sg,), None, None, None),
        ("sylvester-256 sylvester_batched", ops.sylvester_batched,
         tuple(map(to, x["sylvester"])), None, None, None),
        ("sylvester-256 lyapunov_batched", ops.lyapunov_batched,
         tuple(map(to, x["lyapunov"])), None, None, None),
        ("stein-256 stein_batched", ops.stein_batched,
         tuple(map(to, x["stein"])), None, None, None),
        ("care-128 care_batched", ops.care_batched,
         tuple(map(to, x["care"])), None, None, None),
        ("dare-128 dare_batched", ops.dare_batched,
         tuple(map(to, x["dare"])), None, None, None),
    )
    out = {}
    for cell, fn, args, lib_name, lib, lib_args in cells:
        t = cuda_time(fn, *args, warmup=int(cell == f32_form), iters=3)
        # the library's eig and eigvals of [32, 256, 256] and of the
        # companions take seconds: one call
        once = lib_name is not None and ("linalg.eig(" in lib_name + "("
                                         or "linalg.eigvals(" in lib_name)
        tl = (cuda_time(lib, *lib_args, warmup=int(not once),
                        iters=1 if once else 5)
              if lib is not None else None)
        out[cell] = {"ms": t * 1e3, "library": lib_name or "none",
                     "library_ms": None if tl is None else tl * 1e3}
        lib_txt = "none" if tl is None else f"{lib_name} {tl * 1e3:.4f} ms"
        print(f"time {cell}: {t * 1e3:.4f} ms, library: {lib_txt} ({card})")
    r32 = _host(schur._eig_condition(to(x["cond"]), torch.float32))
    f32 = fig_cond(x["cond"], r32, x["cond"].shape[0] - 1)["s_vs_scipy"]
    out[f32_form]["s_vs_scipy"] = f32
    print(f"eig-cond-256's s against scipy's float64 s: float64 inside "
          f"{fam['figs']['eig-cond-256']['s_vs_scipy']:.6e}, float32 inside "
          f"{f32:.6e} (limit {EIGF_LIMITS['cond_s']}, 1.5x the JAX package "
          f"{1.5 * EIGF_JAX['cond_s']:.6e})")
    args = fam["backsolve"]
    t_bs = cuda_time(schur._shifted_backsolve, *args, warmup=1, iters=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        schur._shifted_backsolve(*args)
        torch.cuda.synchronize()
    events = sum(e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith("Activity"))
    t_sv = cuda_time(schur.real_schur_vectors, a, warmup=1, iters=5)
    out["_shifted_backsolve"] = {"ms": t_bs * 1e3, "device_events": events,
                                 "shape": list(args[3].shape),
                                 "real_schur_vectors_ms": t_sv * 1e3}
    print(f"time _shifted_backsolve {list(args[3].shape)}: {t_bs * 1e3:.4f} "
          f"ms, {events} device events a call; real_schur_vectors (eig_"
          f"batched's Schur part) {t_sv * 1e3:.4f} ms ({card})")
    return out


# --- phases 46-52: ordered Schur forms, pseudospectra, matrix functions,
# nearness and fitting, at full width --------------------------------------

MF_B, MF_N = EIGF_B, EIGF_N    # ordschur-256, cluster-cond-256, expm/funm-256
SEP_ITERS = 5
TRSYL_HOLD_STEP = 4            # the trsyl hold takes every 4th lane a launch
PS_B, PS_N, PS_G, PS_ITERS = 8, 128, 32, 20   # pseudo-128
PS_SVD_POINTS = 128            # grid points of the library's timed svdvals
PS_POINTS = 64                 # grid points held against float64 on the host
FN_B, FN_N = 32, 128           # funm-128, frechet-128
NEAR_B, NEAR_N, NEAR_K = 64, 128, 40          # nearness-128
FIT_B = 32                     # fitting-768x256 (FAM_M x FAM_N)
RIDGE_LAM = 0.5
MF_SCIPY_LANES = 4
COND_LANES, COND_REF_ITERS = 2, 40
#: the block's limits, the JAX package's own test tolerances
#: (tests/test_ops_{ordschur,pseudospectra,funm,nearness,fitting}.py,
#: tests/test_autodiff.py), relative to the largest entry where the test's
#: entries are of order one; ridge's and TLS's x absolute, as the tests
#: hold them
MF_LIMITS = {
    "ord_recon": 3e-5, "ord_unitary": 1e-5, "inv_orth": 1e-5,
    "inv_resid": 1e-3, "cc_s": 2e-3, "sigmin": 1e-4, "sigmin_svd": 1e-4,
    "sqrtm": 1e-4, "logm_roundtrip": 1e-4, "powm_half": 1e-3, "expm": 1e-4,
    "expm_grad": 5e-5, "funm_exp": 2e-4, "funm_imag": 1e-4,
    "frechet_expm": 2e-5, "frechet_L": 2e-5, "ncorr_diag": 1e-5,
    "ncorr_min_eig": 1e-6, "npsd_min_eig": 1e-5, "npsd_x": 1e-4,
    "north_orth": 1e-5, "north_q": 1e-4, "ridge": 1e-5, "tls": 2e-4,
    "procrustes": 1e-4, "angles": 1e-4,
}
#: the JAX package's figures where it misses a limit on the same inputs
#: (JAX 0.9.0 on the CPU: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
#: tests/test_torch_matfun.py --lanes 32 --cells ordschur-256,
#: cluster-cond-256,fitting-768x256``, ``--lanes 8 --cells pseudo-128``
#: and ``--lanes 4`` for the rest, inside every other limit): the card is
#: held to 1.5x these.  ord_unitary: n = 256 sweeps of rotations on Q in
#: float32
MF_JAX = {"ord_unitary": 1.0661477100493144e-05}


def mf_inputs(bsz=MF_B, n=MF_N, ps_b=PS_B, ps_n=PS_N, fn_b=FN_B, fn_n=FN_N,
              near_b=NEAR_B, near_n=NEAR_N, fit_b=FIT_B, fit_m=FAM_M,
              fit_n=FAM_N):
    """The block's inputs, float32 numpy arrays built on the host from
    seeds."""
    import numpy as np

    f32 = np.float32
    x = {}
    # ordschur-256 / cluster-cond-256 / funm(exp): eig-256's batch
    x["ord"] = np.random.RandomState(0).randn(bsz, n, n).astype(f32)
    # pseudo-128: examples/chip_session7.py's 8 x G / sqrt(n)
    rng = np.random.RandomState(21)
    x["pseudo"] = (rng.randn(ps_b, ps_n, ps_n) / ps_n ** 0.5).astype(f32)
    pts = np.linspace(-2, 2, PS_G).astype(f32)
    x["grid"] = (pts, pts)
    # the held points: (lane, im index, re index), drawn before any run
    x["points"] = np.stack([np.arange(PS_POINTS) % ps_b,
                            rng.randint(0, PS_G, PS_POINTS),
                            rng.randint(0, PS_G, PS_POINTS)], axis=1)
    # the inverse iteration's start, one a grid point (row-major over
    # (im, re)), real and imaginary parts
    rng = np.random.RandomState(27)
    x["ps_u0"] = tuple(rng.randn(PS_G * PS_G, ps_n).astype(f32)
                       for _ in range(2))
    # funm-128: examples/chip_new_families.py's G + 3 sqrt(n) I
    rng = np.random.RandomState(22)
    x["funm"] = (rng.randn(fn_b, fn_n, fn_n)
                 + 3.0 * fn_n ** 0.5 * np.eye(fn_n)).astype(f32)
    # expm-256: 4 G / sqrt(n) (1-norm ~ 50: every lane squares) and the
    # cotangent of its gradient
    rng = np.random.RandomState(23)
    x["expm"] = ((4.0 * rng.randn(bsz, n, n) / n ** 0.5).astype(f32),
                 rng.randn(bsz, n, n).astype(f32))
    # frechet-128: A = G / sqrt(n), E Gaussian
    rng = np.random.RandomState(24)
    x["frechet"] = ((rng.randn(fn_b, fn_n, fn_n) / fn_n ** 0.5).astype(f32),
                    rng.randn(fn_b, fn_n, fn_n).astype(f32))
    # nearness-128: examples/chip_session7.py's rank-40 correlation
    # matrices plus 0.3 Gaussian noise
    rng = np.random.RandomState(25)
    g = rng.randn(near_b, near_n, NEAR_K)
    c = g @ g.transpose(0, 2, 1)
    d = np.sqrt(np.einsum("bii->bi", c))
    x["near"] = (c / (d[:, :, None] * d[:, None, :])
                 + 0.3 * rng.randn(near_b, near_n, near_n)).astype(f32)
    # fitting-768x256: b = A x + 0.01 noise (ridge, TLS); Procrustes on
    # P [n, m] and R P with R orthogonal; angles between span(A) and
    # span(A + 0.1 G)
    rng = np.random.RandomState(26)
    a = rng.randn(fit_b, fit_m, fit_n)
    b = np.einsum("bmn,bn->bm", a, rng.randn(fit_b, fit_n)) + 0.01 * (
        rng.randn(fit_b, fit_m))
    x["fit"] = (a.astype(f32), b.astype(f32))
    r, _ = np.linalg.qr(rng.randn(fit_b, fit_n, fit_n))
    p = rng.randn(fit_b, fit_n, fit_m)
    x["procrustes"] = (p.astype(f32), (r @ p).astype(f32), r)
    x["angles"] = (a.astype(f32),
                   (a + 0.1 * rng.randn(*a.shape)).astype(f32))
    return x


def mf_lanes(x, lanes):
    """The first ``lanes`` lanes of every batch of ``mf_inputs`` (the grid,
    its starts and the held points kept, the points moved onto the kept
    lanes)."""
    out = {}
    for k, v in x.items():
        if k in ("grid", "ps_u0"):
            out[k] = v
        elif k == "points":
            out[k] = v.copy()
            out[k][:, 0] %= lanes
        else:
            out[k] = (tuple(t[:lanes] for t in v) if isinstance(v, tuple)
                      else v[:lanes])
    return out


def _c128(h, re, im):
    return h[re].astype("float64") + 1j * h[im].astype("float64")


def fig_ordschur(a, sv, srt, reo, inv, sel):
    """ordschur-256's figures (float64 on the host): the worst
    ||Q T Q^H - D A D^-1||_max / ||A||_max and ||Q^H Q - I||_max of the
    sorted and the reordered forms; whether the sort's |lambda| is
    nonincreasing (with the JAX test's slack) and the reorder puts the
    selected eigenvalues first; the invariant subspace's ok count, m
    against numpy's count of Re lambda < 0 (a lane may differ only where
    an eigenvalue lies within 1e-3 of the axis), ||V^T V - I||_max and
    ||A V - V (V^T A V)||_F / ||A||_F."""
    import numpy as np

    a64 = a.astype(np.float64)
    recon, unit = 0.0, 0.0
    for r in (srt, reo):
        T, Q = _c128(r, "t_re", "t_im"), _c128(r, "q_re", "q_im")
        for b in range(a.shape[0]):
            s = sv["scale"][b].astype(np.float64)
            dad = a64[b] * s[:, None] / s[None, :]
            recon = max(recon, float(np.abs(Q[b] @ T[b] @ Q[b].conj().T - dad)
                                     .max() / np.abs(a64[b]).max()))
            unit = max(unit, float(np.abs(Q[b].conj().T @ Q[b]
                                          - np.eye(len(s))).max()))
    mags = np.abs(_c128(srt, "w_re", "w_im"))
    order = bool((np.diff(mags, axis=1) <= 1e-4 * mags[:, :-1] + 1e-5).all())
    w = _c128(reo, "w_re", "w_im")
    lead = all((w[b, :m].real < 0).all() and (w[b, m:].real >= 0).all()
               for b, m in enumerate(reo["m"]))
    m_sel = bool((reo["m"] == sel.sum(axis=1)).all())
    V = inv["v"].astype(np.float64)
    orth, resid, m_off = 0.0, 0.0, []
    for b in range(a.shape[0]):
        m = int(inv["m"][b])
        wa = np.linalg.eigvals(a64[b])
        if m != int((wa.real < 0).sum()) and not (
                np.abs(wa.real) < 1e-3).any():
            m_off.append(b)
        Vb = V[b][:, :m]
        orth = max(orth, float(np.abs(Vb.T @ Vb - np.eye(m)).max()))
        AV = a64[b] @ Vb
        resid = max(resid, float(np.linalg.norm(AV - Vb @ (Vb.T @ AV))
                                 / np.linalg.norm(a64[b])))
    return {"ord_recon": recon, "ord_unitary": unit, "sort_order": order,
            "reorder_lead": lead, "reorder_m": m_sel, "inv_orth": orth,
            "inv_resid": resid, "inv_ok": int(inv["ok"].sum()),
            "inv_m_off": m_off}


def fig_cluster(cc, reo, lanes=MF_SCIPY_LANES):
    """cluster-cond-256's figures: s against LAPACK's ztrsen (scipy, job
    'E') on the reordered complex form in float64, the worst relative
    distance over the first ``lanes`` lanes; the largest sep / gap (sep
    estimates from above a quantity at most gap); s's range; the lanes
    flagged perturbed; m equal to the reorder's."""
    import numpy as np
    from scipy.linalg import lapack

    T, Q = _c128(reo, "t_re", "t_im"), _c128(reo, "q_re", "q_im")
    worst = 0.0
    n = T.shape[-1]
    for b in range(min(lanes, T.shape[0])):
        m = int(reo["m"][b])
        sel = (np.arange(n) < m).astype(np.int32)
        out = lapack.ztrsen(sel, T[b], Q[b], job="E", wantq=0,
                            lwork=max(1, 2 * m * (n - m)))
        s64, info = out[4], out[-1]
        if info != 0:
            raise AssertionError(f"ztrsen info {info} on lane {b}")
        worst = max(worst, abs(float(cc["s"][b]) - s64) / s64)
    return {"cc_s": worst,
            "sep_over_gap": float((cc["sep"] / cc["gap"]).max()),
            "s_range": [float(cc["s"].min()), float(cc["s"].max())],
            "perturbed": [int(i) for i in np.flatnonzero(cc["perturbed"])],
            "m_equal": bool((cc["m"] == reo["m"]).all())}


def _sigmin_iteration(t, z, u, iters):
    """The port's inverse iteration for sigma_min(T - zI) in float64 on the
    host: ``iters`` steps of a solve with (T - zI)^H then with T - zI from
    the start ``u``, scipy's triangular solves."""
    import numpy as np
    import scipy.linalg as sl

    m = t - z * np.eye(t.shape[-1])
    u = u / np.linalg.norm(u)
    lam = 0.0
    for _ in range(iters):
        w = sl.solve_triangular(m, sl.solve_triangular(m, u, trans="C"))
        lam = np.linalg.norm(w)
        u = w / lam
    return 1.0 / np.sqrt(lam)


def fig_pseudo(a, grid, points, ps, pt, u0, iters=PS_ITERS):
    """pseudo-128's figures at the held points: sigma_min against the same
    ``iters``-step inverse iteration in float64 on the host, on the
    package's own complex Schur form T (``pt``) and from the same start
    ``u0`` (the worst relative distance: the program, not the iteration's
    convergence); against numpy's float64 SVD of A - zI (the JAX package's
    test) at the points where that float64 iteration has converged, within
    1e-6 of the SVD of T - zI, and their count; the converged count and the
    grid's shape."""
    import numpy as np

    re, im = grid
    T = _c128(pt, "t_re", "t_im")
    u = u0[0].astype(np.float64) + 1j * u0[1].astype(np.float64)
    eye = np.eye(a.shape[-1])
    worst, worst_svd, held = 0.0, 0.0, 0
    for b, i, j in points:
        z = complex(re[j], im[i])
        got = float(ps["sigmin"][b, i, j])
        ref = _sigmin_iteration(T[b], z, u[i * len(re) + j], iters)
        worst = max(worst, abs(got - ref) / ref)
        svd_t = np.linalg.svd(T[b] - z * eye, compute_uv=False)[-1]
        if abs(ref - svd_t) <= 1e-6 * svd_t:
            held += 1
            svd = np.linalg.svd(a[b].astype(np.float64) - z * eye,
                                compute_uv=False)[-1]
            worst_svd = max(worst_svd, abs(got - svd) / svd)
    return {"sigmin": worst, "sigmin_svd": worst_svd, "svd_points": held,
            "converged": int(ps["converged"].sum()),
            "shape": list(ps["sigmin"].shape)}


def _rel_max(got, want):
    import numpy as np

    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


def fig_funm(a, sq, lg, back, pw):
    """funm-128's figures: sqrtm's ||Y^2 - A||_max / ||A||_max, logm's
    round trip ||expm(logm A) - A||_max / ||A||_max, powm(A, 1/2) against
    sqrtm relative to max|Y|, and the converged counts."""
    import numpy as np

    a64 = a.astype(np.float64)
    Y = sq["Y"].astype(np.float64)
    return {"sqrtm": _rel_max(Y @ Y, a64),
            "logm_roundtrip": _rel_max(back, a64),
            "powm_half": _rel_max(pw[0], Y),
            "sqrtm_converged": int(sq["converged"].sum()),
            "logm_converged": int(lg["converged"].sum()),
            "powm_ok": int(pw[1].sum()), "logm_roots": lg["roots"].tolist()}


def fig_expm(a, g, e, grad, lanes=MF_SCIPY_LANES):
    """expm-256's figures on the first ``lanes`` lanes: expm against
    scipy's float64 ``expm`` relative to its largest entry, and the
    gradient of sum(G * expm(A)) against scipy's ``expm_frechet(A^T, G)``
    over max(its largest entry, 1)."""
    import numpy as np
    import scipy.linalg as sl

    we, wg = 0.0, 0.0
    for b in range(min(lanes, a.shape[0])):
        a64 = a[b].astype(np.float64)
        we = max(we, _rel_max(e[b], sl.expm(a64)))
        _, L = sl.expm_frechet(a64.T, g[b].astype(np.float64))
        wg = max(wg, float(np.abs(grad[b] - L).max()
                           / max(np.abs(L).max(), 1.0)))
    return {"expm": we, "expm_grad": wg,
            "finite": bool(np.isfinite(e).all() and np.isfinite(grad).all())}


def fig_funm_exp(a, fm, lanes=MF_SCIPY_LANES):
    """funm(exp) on eig-256's batch: F against scipy's float64 ``expm``
    relative to its largest entry (first ``lanes`` lanes), imag_max
    relative to max|F|, the ok count and the largest resid."""
    import numpy as np
    import scipy.linalg as sl

    worst = max(_rel_max(fm["F"][b], sl.expm(a[b].astype(np.float64)))
                for b in range(min(lanes, a.shape[0])))
    fmax = np.abs(fm["F"]).max(axis=(1, 2))
    return {"funm_exp": worst,
            "funm_imag": float((fm["imag_max"] / fmax).max()),
            "ok": int(fm["ok"].sum()), "resid": float(fm["resid"].max())}


def _cond_reference(a, e0, iters):
    """The power iteration of ``expm_cond_batched`` in float64 with scipy's
    ``expm_frechet``, run ``iters`` steps from ``e0``: the operator norm."""
    import numpy as np
    import scipy.linalg as sl

    E, sig = e0, 0.0
    for _ in range(iters):
        E = E / np.linalg.norm(E)
        _, W = sl.expm_frechet(a, E)
        sig = np.linalg.norm(W)
        _, E = sl.expm_frechet(a.T, W)
    return sig


def fig_frechet(a, e, fr, kc, lanes=MF_SCIPY_LANES, cond_lanes=COND_LANES):
    """frechet-128's figures: expm and L(A, E) against scipy's float64
    ``expm_frechet`` (L over max(its largest entry, 1)) on the first
    ``lanes`` lanes; expm_cond's operator norm over a float64 power
    iteration of ``COND_REF_ITERS`` steps (from a seeded start) on the
    first ``cond_lanes`` lanes: its range."""
    import numpy as np
    import scipy.linalg as sl

    we, wl = 0.0, 0.0
    for b in range(min(lanes, a.shape[0])):
        eA, L = sl.expm_frechet(a[b].astype(np.float64),
                                e[b].astype(np.float64))
        we = max(we, float(np.abs(fr["expm"][b] - eA).max()))
        wl = max(wl, float(np.abs(fr["L"][b] - L).max()
                           / max(np.abs(L).max(), 1.0)))
    rng = np.random.RandomState(28)
    ratio = []
    for b in range(min(cond_lanes, a.shape[0])):
        ref = _cond_reference(a[b].astype(np.float64),
                              rng.randn(*a.shape[1:]), COND_REF_ITERS)
        ratio.append(float(kc[1][b]) / ref)
    return {"frechet_expm": we, "frechet_L": wl,
            "cond_ratio": [min(ratio), max(ratio)]}


def fig_nearness(c, nc, npsd, north):
    """nearness-128's figures (float64 on the host, every lane): the
    correlation's max|diag - 1|, min eigenvalue, converged count and
    iterations; the PSD repair's min eigenvalue and its distance from the
    float64 closed form; the orthogonal factor's ||Q^T Q - I||_max and
    distance from the SVD's U V^T, and its ok count."""
    import numpy as np

    c64 = c.astype(np.float64)
    X = nc["x"].astype(np.float64)
    P = npsd["x"].astype(np.float64)
    Qo = north[0].astype(np.float64)
    n = c.shape[-1]
    diag, wmin, pmin, px, qo, qd = 0.0, np.inf, np.inf, 0.0, 0.0, 0.0
    for b in range(c.shape[0]):
        diag = max(diag, float(np.abs(np.diag(X[b]) - 1).max()))
        wmin = min(wmin, float(np.linalg.eigvalsh(X[b]).min()))
        pmin = min(pmin, float(np.linalg.eigvalsh(P[b]).min()))
        we, V = np.linalg.eigh((c64[b] + c64[b].T) / 2)
        px = max(px, float(np.abs(P[b] - (V * np.maximum(we, 0)) @ V.T)
                           .max()))
        qo = max(qo, float(np.abs(Qo[b].T @ Qo[b] - np.eye(n)).max()))
        U, _, Vt = np.linalg.svd(c64[b])
        qd = max(qd, float(np.abs(Qo[b] - U @ Vt).max()))
    return {"ncorr_diag": diag, "ncorr_min_eig": -wmin,
            "ncorr_converged": int(nc["converged"].sum()),
            "ncorr_iters": int(nc["iters"]), "npsd_min_eig": -pmin,
            "npsd_x": px, "north_orth": qo, "north_q": qd,
            "north_ok": int(north[2].sum())}


def fig_fitting(fit, proc, ang, rd, tl, pr, an, lanes=MF_SCIPY_LANES):
    """fitting-768x256's figures (float64 on the host): ridge's x against
    the normal equations and TLS's x against the SVD of [A | b] (every
    lane, max abs), ok counts; Procrustes' Q against the planted rotation
    (max abs); the angles against scipy's ``subspace_angles`` on the
    first ``lanes`` lanes (sorted, max abs)."""
    import numpy as np
    import scipy.linalg as sl

    a, b = (t.astype(np.float64) for t in fit)
    n = a.shape[-1]
    wr, wt = 0.0, 0.0
    for k in range(a.shape[0]):
        want = np.linalg.solve(a[k].T @ a[k] + RIDGE_LAM * np.eye(n),
                               a[k].T @ b[k])
        wr = max(wr, float(np.abs(rd["x"][k] - want).max()))
        _, _, Vt = np.linalg.svd(np.concatenate([a[k], b[k][:, None]], 1))
        want = -Vt[-1, :n] / Vt[-1, n]
        wt = max(wt, float(np.abs(tl["x"][k] - want).max()))
    wa = 0.0
    for k in range(min(lanes, a.shape[0])):
        want = np.sort(sl.subspace_angles(*(t[k].astype(np.float64)
                                            for t in ang)))
        wa = max(wa, float(np.abs(np.sort(an["angles"][k]) - want).max()))
    return {"ridge": wr, "ridge_ok": int(rd["ok"].sum()), "tls": wt,
            "tls_ok": int(tl["ok"].sum()),
            "procrustes": float(np.abs(pr["Q"] - proc[2]).max()),
            "procrustes_ok": int(pr["ok"].sum()), "angles": wa,
            "angles_ok": int(an["ok"].sum())}


def run_matfun(ops, x, to, grad, exp, call=None, cells=None, pass_u0=True):
    """Every entry point of the block on the inputs ``x`` (``to`` moves a
    numpy array to the package's device; ``grad(fn, a, g)`` is the
    gradient of sum(g * fn(a)); ``exp`` the package's elementwise
    exponential; ``call(key, thunk)``, if given, runs each entry point;
    ``cells`` the cells to run, default all; ``pass_u0`` hands the grid
    its start ``x["ps_u0"]``, which the JAX package draws itself and
    ``x["ps_u0"]`` must then hold): the host results and figures, keyed
    by cell.  Shared by ``drive_matfun`` and a run of the JAX package,
    which has the same API, on the same inputs."""
    out, figs = {}, {}
    call = call or (lambda key, thunk: thunk())

    def want(cell):
        return cells is None or cell in cells

    def go(name, fn, *args, **kw):
        targs = [to(t) for t in args]
        res = call(name, lambda: fn(*targs, **kw))
        out[name] = _host(res) if hasattr(res, "_fields") else (
            [_host_array(t) for t in res] if isinstance(res, tuple)
            else _host_array(res))
        return out[name]

    if want("ordschur-256") or want("cluster-cond-256"):
        a = x["ord"]
        sv = go("schur", ops.real_schur_vectors, a)
        T, Q = sv["T"], sv["Q"]
        cs = go("rsf2csf", ops.rsf2csf_batched, T, Q)
        sel = cs["t_re"].diagonal(axis1=1, axis2=2) < 0
        reo = go("reorder", ops.schur_reorder_batched, T, Q, sel)
    if want("ordschur-256"):
        srt = go("sort", ops.schur_sort_batched, T, Q, key="abs_desc")
        inv = go("invariant", ops.invariant_subspace_batched, a,
                 select_fn=lambda re, im: re < 0)
        figs["ordschur-256"] = fig_ordschur(a, sv, srt, reo, inv, sel)
    if want("cluster-cond-256"):
        cc = go("cluster_cond", ops.schur_cluster_cond_batched, T, Q, sel,
                sep_iters=SEP_ITERS)
        figs["cluster-cond-256"] = fig_cluster(cc, reo)
    if want("pseudo-128"):
        kw = {"u0": tuple(to(t) for t in x["ps_u0"])} if pass_u0 else {}
        ps = go("pseudo", ops.pseudospectrum_grid_batched, x["pseudo"],
                *x["grid"], iters=PS_ITERS, **kw)

        def complex_schur(a_):
            sv_ = ops.real_schur_vectors(a_, balance=False)
            return ops.rsf2csf_batched(sv_.T, sv_.Q)

        # the complex Schur form the grid's iteration ran on
        pt = go("pseudo_schur", complex_schur, x["pseudo"])
        figs["pseudo-128"] = fig_pseudo(x["pseudo"], x["grid"], x["points"],
                                        ps, pt, x["ps_u0"])
    if want("funm-128"):
        af = x["funm"]
        sq = go("sqrtm", ops.sqrtm_batched, af)
        lg = go("logm", ops.logm_batched, af)
        back = go("logm_expm", ops.expm_batched, lg["L"])
        pw = go("powm", ops.powm_batched, af, p=0.5)
        figs["funm-128"] = fig_funm(af, sq, lg, back, pw)
    if want("expm-256"):
        ae, ge = x["expm"]
        e = go("expm", ops.expm_batched, ae)
        gr = call("expm_grad", lambda: grad(ops.expm_batched, to(ae),
                                            to(ge)))
        out["expm_grad"] = _host_array(gr)
        figs["expm-256"] = fig_expm(ae, ge, e, out["expm_grad"])
    if want("funm-256"):
        fm = go("funm", ops.funm.funm_batched, x["ord"], f=exp)
        figs["funm-256"] = fig_funm_exp(x["ord"], fm)
    if want("frechet-128"):
        af, ef = x["frechet"]
        fr = go("frechet", ops.expm_frechet_batched, af, ef)
        kc = go("expm_cond", ops.expm_cond_batched, af)
        figs["frechet-128"] = fig_frechet(af, ef, fr, kc)
    if want("nearness-128"):
        c = x["near"]
        nc = go("ncorr", ops.nearest_correlation_batched, c)
        npsd = go("npsd", ops.nearest_psd_batched, c)
        north = go("north", ops.nearest_orthogonal_batched, c)
        figs["nearness-128"] = fig_nearness(c, nc, npsd, north)
    if want("fitting-768x256"):
        rd = go("ridge", ops.ridge_batched, *x["fit"], lam=RIDGE_LAM)
        tl = go("tls", ops.tls_batched, *x["fit"])
        pr = go("procrustes", ops.procrustes_batched, *x["procrustes"][:2])
        an = go("angles", ops.subspace_angles_batched, *x["angles"])
        figs["fitting-768x256"] = fig_fitting(x["fit"], x["procrustes"],
                                              x["angles"], rd, tl, pr, an)
    return out, figs


def mf_limit(key):
    """A limit of the block: ``MF_LIMITS``, or 1.5x the JAX package's
    figure in ``MF_JAX`` where that misses the limit."""
    jax_fig = MF_JAX.get(key)
    base = MF_LIMITS[key]
    return base if jax_fig is None or jax_fig <= base else 1.5 * jax_fig


def hold_matfun(figs, bsz=MF_B, ps_b=PS_B, fn_b=FN_B, near_b=NEAR_B,
                fit_b=FIT_B):
    """Every limit and flag of the block on ``figs``; raises on the first
    one missed."""
    cells = {"ord_recon": "ordschur-256", "ord_unitary": "ordschur-256",
             "inv_orth": "ordschur-256", "inv_resid": "ordschur-256",
             "cc_s": "cluster-cond-256", "sigmin": "pseudo-128",
             "sigmin_svd": "pseudo-128",
             "sqrtm": "funm-128", "logm_roundtrip": "funm-128",
             "powm_half": "funm-128", "expm": "expm-256",
             "expm_grad": "expm-256", "funm_exp": "funm-256",
             "funm_imag": "funm-256", "frechet_expm": "frechet-128",
             "frechet_L": "frechet-128"}
    cells.update({k: "nearness-128" for k in MF_LIMITS
                  if k.startswith(("ncorr", "npsd", "north"))})
    cells.update({k: "fitting-768x256" for k in ("ridge", "tls",
                                                 "procrustes", "angles")})
    for key, cell in cells.items():
        if cell in figs and not figs[cell][key] <= mf_limit(key):
            raise AssertionError(f"{cell} {key} {figs[cell][key]} above its "
                                 f"limit {mf_limit(key)}")
    flags = []
    if "ordschur-256" in figs:
        o = figs["ordschur-256"]
        flags += [("ordschur sort order", o["sort_order"]),
                  ("ordschur selected first", o["reorder_lead"]),
                  ("ordschur m equal to the selection", o["reorder_m"]),
                  ("invariant subspace ok on every lane",
                   o["inv_ok"] == bsz),
                  ("invariant subspace m equal to numpy's count",
                   o["inv_m_off"] == [])]
    if "cluster-cond-256" in figs:
        c = figs["cluster-cond-256"]
        flags += [("cluster sep at most gap", c["sep_over_gap"] <= 1.0),
                  ("cluster s in (0, 1]",
                   c["s_range"][0] > 0 and c["s_range"][1] <= 1.0),
                  ("cluster no lane perturbed", c["perturbed"] == []),
                  ("cluster m equal to the reorder's", c["m_equal"])]
    if "pseudo-128" in figs:
        p = figs["pseudo-128"]
        flags += [("pseudo converged on every lane", p["converged"] == ps_b),
                  ("pseudo: an eighth of the held points converged in "
                   f"{PS_ITERS} iterations", p["svd_points"] >= PS_POINTS // 8)]
    if "funm-128" in figs:
        f = figs["funm-128"]
        flags += [("sqrtm converged on every lane",
                   f["sqrtm_converged"] == fn_b),
                  ("logm converged on every lane",
                   f["logm_converged"] == fn_b),
                  ("powm ok on every lane", f["powm_ok"] == fn_b)]
    if "expm-256" in figs:
        flags += [("expm and its gradient finite",
                   figs["expm-256"]["finite"])]
    if "funm-256" in figs:
        flags += [("funm ok on every lane", figs["funm-256"]["ok"] == bsz)]
    if "frechet-128" in figs:
        lo, hi = figs["frechet-128"]["cond_ratio"]
        flags += [("expm_cond within [0.5, 1.05] of the float64 power "
                   "iteration", 0.5 <= lo and hi <= 1.05)]
    if "nearness-128" in figs:
        nr = figs["nearness-128"]
        flags += [("nearest correlation converged on every lane",
                   nr["ncorr_converged"] == near_b),
                  ("nearest orthogonal ok on every lane",
                   nr["north_ok"] == near_b)]
    if "fitting-768x256" in figs:
        ft = figs["fitting-768x256"]
        flags += [(f"{k} ok on every lane", ft[f"{k}_ok"] == fit_b)
                  for k in ("ridge", "tls", "procrustes", "angles")]
    for what, good in flags:
        if not good:
            raise AssertionError(f"{what}: no")


def torch_grad(fn, a, g):
    """The gradient of sum(g * fn(a)) by autograd."""
    a = a.detach().clone().requires_grad_(True)
    (fn(a) * g).sum().backward()
    return a.grad


def trsyl_work(t_re, m, esize):
    """(bytes, operations) of one masked Sylvester solve on this run's
    data: T's upper triangle (re, im) read, C's block read and X's block
    written; a complex multiply-add (8 operations) for each term of each
    row's product and column sum, and ~12 for each entry's quotient."""
    bsz, n, _ = t_re.shape
    nbytes, ops = 0.0, 0.0
    for mb in m.tolist():
        k = mb * (n - mb)
        nbytes += (n * (n + 1) + 4 * k) * esize
        ops += 8 * (n - mb) * mb * (mb - 1) / 2 + 8 * mb * (n - mb) * (
            n - mb - 1) / 2 + 12 * k
    return nbytes, ops


def hold_trsyl(calls, what):
    """The trsyl kernel's results on every recorded launch against its
    plain version on the same arguments: X bitwise (NaN where the other is
    NaN) and pert equal, on every TRSYL_HOLD_STEP-th lane of each launch.
    The plain version runs on the CPU (the same IEEE operations, one
    rounding each, so the same bits as on the card; its ~10^5 small
    operations a call take a fraction of the card's launch time), the
    launches of one direction stacked into one call (lanes are
    independent).  Returns (max abs diff, {adjoint: (plain seconds of the
    stacked call, launches)})."""
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    err, secs = 0.0, {}
    k = TRSYL_HOLD_STEP
    for adjoint in (False, True):
        group = [c for c in calls if c[0][1].get("adjoint", False) == adjoint]
        if not group:
            continue
        args = [torch.cat([c[0][0][i][::k] for c in group]).cpu()
                for i in range(5)]
        got = [torch.cat([c[1][i][::k] for c in group]).cpu()
               for i in range(3)]
        t0 = time.perf_counter()
        rr, ri, rp = trsyl.trsyl_masked_reference(*args, adjoint=adjoint)
        secs[adjoint] = (time.perf_counter() - t0, len(group))
        err = max(err, abs_diff(got[0], rr), abs_diff(got[1], ri))
        same = nan_equal(got[0], rr) and nan_equal(got[1], ri)
        print(f"trsyl kernel vs plain (CPU) {what}: {len(group)} launches of "
              f"{list(group[0][1][0].shape)} adjoint={adjoint}, every {k}-th "
              f"lane held, stacked: "
              f"bitwise {same}, max abs diff {err:.3e}, pert equal "
              f"{torch.equal(got[2], rp)} (lanes flagged "
              f"{int(got[2].sum())}), plain {secs[adjoint][0]:.2f} s")
        if not same or not torch.equal(got[2], rp):
            raise AssertionError(f"the trsyl kernel disagrees with its plain "
                                 f"version {what}")
    return err, secs


def drive_matfun(dev):
    """Phases 46-51: every entry point of the block on ``mf_inputs`` on the
    card, each with the kernels' counts set to 0 just before it and read
    just after, its figures printed beside their limits and held
    (``hold_matfun``); then the trsyl kernel held against its plain
    version on every launch of the cluster-cond path.  Returns the inputs, the figures, the launches a
    call, the trsyl calls and the held error."""
    from linalg_solver_tpu_torch import ops
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot
    from linalg_solver_tpu_torch.ops.kernels import lu_panel
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    t0 = time.perf_counter()
    x = mf_inputs()
    print(f"matrix-function inputs built on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = {}

    def call(key, thunk):
        reset_counts()
        trsyl.LAUNCHES = 0
        res = thunk()
        torch.cuda.synchronize()
        launches[key] = {"trsyl": trsyl.LAUNCHES, "chase": sc.LAUNCHES,
                         **phase_counts()}
        return res

    calls = []
    orig = trsyl.trsyl_masked

    def rec(*args, **kw):
        out = orig(*args, **kw)
        calls.append(((tuple(t.clone() for t in args), dict(kw)), out))
        return out

    trsyl.trsyl_masked = rec
    # funm_batched inverts V through the 2n real embedding: the phase
    # engine's butterfly and no-pivot panel kernels (kernel 6 if a lane
    # needs the pivoted rescue)
    bf_calls, bf_off = record(butterfly, "butterfly_two_sided")
    lu_calls, lu_off = record(lu_nopivot, "panel_factor_nopivot")
    k6_calls, k6_off = record(lu_panel, "panel_factor_masked")
    t0 = time.perf_counter()
    try:
        out, figs = run_matfun(ops, x, lambda t: torch.from_numpy(
            t).to(dev), torch_grad, torch.exp, call)
    finally:
        trsyl.trsyl_masked = orig
        bf_off()
        lu_off()
        k6_off()
    secs = time.perf_counter() - t0
    for cell, f in figs.items():
        print(f"matrix functions {cell}: {json.dumps(f)}")
    shown = {key: {k: v for k, v in c.items() if v}
             for key, c in launches.items()}
    print(f"matrix functions launches a call (the kernels launched): "
          f"{json.dumps(shown)}; {secs:.2f} s with the host's checks")
    print(f"matrix functions limits {json.dumps(MF_LIMITS)}, the JAX "
          f"package's figures where it misses one {json.dumps(MF_JAX)}")
    hold_matfun(figs)
    if (launches["cluster_cond"]["trsyl"] != 1 + 2 * SEP_ITERS
            or len(calls) != 1 + 2 * SEP_ITERS):
        raise AssertionError(f"cluster-cond launched the trsyl kernel "
                             f"{launches['cluster_cond']['trsyl']} times, "
                             f"not {1 + 2 * SEP_ITERS}")
    fl = launches["funm"]
    if fl["butterfly"] < 2 or fl["lu_nopivot"] < 1:
        raise AssertionError(f"funm_batched's inverse did not run the phase "
                             f"engine's kernels: {fl}")
    total = {k: sum(v[k] for v in launches.values()) for k in fl}
    unheld = {k: total[k] for k in ("fused", "inv_rbt", "gauss_jordan")
              if total[k]}
    if unheld:
        raise AssertionError(f"the block launched kernels it does not hold: "
                             f"{unheld}")
    err, plain_s = hold_trsyl(calls, "on the cluster-cond path")
    bf_err = hold_butterflies(bf_calls, "on the funm path")
    panel_err, _ = hold_panels(lu_calls, "on the funm path")
    k6_err = hold_masked(k6_calls, "on the funm path") if k6_calls else 0.0
    return {"x": x, "figs": figs, "launches": launches, "calls": calls,
            "err": err, "plain_s": plain_s, "counts": total,
            "bf_err": bf_err, "panel_err": panel_err, "k6_err": k6_err}


def time_matfun(dev, card, mf):
    """Phase 52: each entry point as the median of 3 calls after the
    check's call (its warm-up), beside the one library call that computes
    the same function where there is one (after one warm-up of its own):
    ``torch.linalg.matrix_exp`` for expm and funm(exp), ``svdvals`` of the
    stacked A - zI at PS_SVD_POINTS of the grid's points for the grid (one
    call: on all 1,024 points it took ~31 s), ``svd`` for Procrustes and
    TLS; then the
    trsyl kernel alone on the first recorded forward and adjoint launches
    (median of 5 after one warm-up), its plain version (a launch's share
    of the hold's stacked call on the CPU) and its bound."""
    from linalg_solver_tpu_torch import ops
    from linalg_solver_tpu_torch.ops.kernels import trsyl
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    x = mf["x"]

    def to(t):
        return torch.from_numpy(t).to(dev)

    a = to(x["ord"])
    sv = ops.real_schur_vectors(a)
    cs = ops.rsf2csf_batched(sv.T, sv.Q)
    sel = cs.t_re.diagonal(dim1=1, dim2=2) < 0
    ps = to(x["pseudo"])
    re, im = (to(t) for t in x["grid"])
    zz = torch.complex(*torch.meshgrid(re, im, indexing="xy"))
    # the library's svdvals on PS_SVD_POINTS of the grid's points (every
    # lane): on all PS_G² it took ~31 s a call on the H100
    pts = zz.reshape(-1)[:PS_SVD_POINTS]
    stacked = (ps.to(torch.complex64)[:, None, :, :]
               - pts[None, :, None, None] * torch.eye(
                   PS_N, dtype=torch.complex64, device=dev))
    af, ae = to(x["funm"]), to(x["expm"][0])
    ge = to(x["expm"][1])
    fa, fe = (to(t) for t in x["frechet"])
    c = to(x["near"])
    fa_, fb_ = (to(t) for t in x["fit"])
    pa, pb = (to(t) for t in x["procrustes"][:2])
    ua, va = (to(t) for t in x["angles"])
    cells = (
        ("ordschur-256 real_schur_vectors", ops.real_schur_vectors, (a,),
         None, None, None),
        ("ordschur-256 rsf2csf_batched", ops.rsf2csf_batched,
         (sv.T, sv.Q), None, None, None),
        ("ordschur-256 schur_sort_batched", ops.schur_sort_batched,
         (sv.T, sv.Q), None, None, None),
        ("ordschur-256 schur_reorder_batched", ops.schur_reorder_batched,
         (sv.T, sv.Q, sel), None, None, None),
        ("ordschur-256 invariant_subspace_batched",
         lambda a_: ops.invariant_subspace_batched(a_, lambda r, i: r < 0),
         (a,), None, None, None),
        ("cluster-cond-256 schur_cluster_cond_batched",
         ops.schur_cluster_cond_batched, (sv.T, sv.Q, sel), None, None,
         None),
        ("pseudo-128 pseudospectrum_grid_batched",
         ops.pseudospectrum_grid_batched, (ps, re, im),
         f"torch.linalg.svdvals(A - zI, stacked), {PS_SVD_POINTS} of the "
         f"{PS_G * PS_G} points", torch.linalg.svdvals, (stacked,)),
        ("funm-128 sqrtm_batched", ops.sqrtm_batched, (af,), None, None,
         None),
        ("funm-128 logm_batched", ops.logm_batched, (af,), None, None, None),
        ("funm-128 powm_batched", ops.powm_batched, (af, 0.5), None, None,
         None),
        ("expm-256 expm_batched", ops.expm_batched, (ae,),
         "torch.linalg.matrix_exp", torch.linalg.matrix_exp, (ae,)),
        ("expm-256 expm_batched and its gradient",
         lambda a_, g_: torch_grad(ops.expm_batched, a_, g_), (ae, ge),
         "torch.linalg.matrix_exp and its gradient",
         lambda a_, g_: torch_grad(torch.linalg.matrix_exp, a_, g_),
         (ae, ge)),
        ("funm-256 funm_batched(exp)",
         lambda a_: ops.funm.funm_batched(a_, torch.exp), (a,),
         "torch.linalg.matrix_exp", torch.linalg.matrix_exp, (a,)),
        ("frechet-128 expm_frechet_batched", ops.expm_frechet_batched,
         (fa, fe), None, None, None),
        ("frechet-128 expm_cond_batched", ops.expm_cond_batched, (fa,),
         None, None, None),
        ("nearness-128 nearest_correlation_batched",
         ops.nearest_correlation_batched, (c,), None, None, None),
        ("nearness-128 nearest_psd_batched", ops.nearest_psd_batched, (c,),
         None, None, None),
        ("nearness-128 nearest_orthogonal_batched",
         ops.nearest_orthogonal_batched, (c,), None, None, None),
        ("fitting-768x256 ridge_batched", ops.ridge_batched,
         (fa_, fb_, RIDGE_LAM), None, None, None),
        ("fitting-768x256 tls_batched", ops.tls_batched, (fa_, fb_),
         "torch.linalg.svd([A | b])",
         lambda a_, b_: torch.linalg.svd(torch.cat([a_, b_[:, :, None]], 2),
                                         full_matrices=False),
         (fa_, fb_)),
        ("fitting-768x256 procrustes_batched", ops.procrustes_batched,
         (pa, pb), "torch.linalg.svd(B A^T)",
         lambda a_, b_: torch.linalg.svd(b_ @ a_.transpose(1, 2)),
         (pa, pb)),
        ("fitting-768x256 subspace_angles_batched",
         ops.subspace_angles_batched, (ua, va), None, None, None),
    )
    out = {}
    for cell, fn, args, lib_name, lib, lib_args in cells:
        t = cuda_time(fn, *args, warmup=0, iters=3)
        # svdvals of the stacked 128 x 128 complex matrices takes seconds
        # a call on the H100: one call, without a warm-up
        once = cell.startswith("pseudo-128")
        tl = (cuda_time(lib, *lib_args, warmup=int(not once),
                        iters=1 if once else 5)
              if lib is not None else None)
        out[cell] = {"ms": t * 1e3, "library": lib_name or "none",
                     "library_ms": None if tl is None else tl * 1e3}
        lib_txt = "none" if tl is None else f"{lib_name} {tl * 1e3:.4f} ms"
        print(f"time {cell}: {t * 1e3:.4f} ms, library: {lib_txt} ({card})")
    shapes = []
    for adjoint in (False, True):
        args, kw = next(c[0] for c in mf["calls"]
                        if c[0][1].get("adjoint", False) == adjoint)
        t = cuda_time(lambda *a_: trsyl.trsyl_masked(*a_, **kw), *args,
                      warmup=1, iters=5)
        esize = args[0].element_size()
        b_ms, b_by = bound(*trsyl_work(args[0], args[2], esize))
        plain_s, count = mf["plain_s"][adjoint]
        shapes.append({"shape": list(args[0].shape), "adjoint": adjoint,
                       "ms": t * 1e3, "plain_ms": plain_s / count * 1e3,
                       "plain_on": f"cpu, every {TRSYL_HOLD_STEP}-th lane",
                       "bound_ms": b_ms,
                       "bound_by": b_by})
        print(f"time trsyl kernel {shapes[-1]} ({card})")
    return out, shapes


# ---------------------------------------------------------------------------
# 53. BASELINE config 1's exact text path on the card's host
# ---------------------------------------------------------------------------

TEXT_SEED = 2026
TEXT_LANES = 4096      # config-1 systems through rref_batched on the card
TEXT_REPLAYED = 256    # of them replayed into LaTeX on the host
#: replayed lanes whose text equals the exact path's (the JAX package's
#: count on the same lanes, pinned by tests/test_torch_text_golden.py)
TEXT_MATCHED = 256
TEXT_GOLDEN = "tests/data_torch/text_config1.tex"


def config1_inputs(seed=TEXT_SEED):
    """BASELINE config 1's matrices as integer rows, from one
    ``random.Random(seed)``: an 8 x 8 randint(-5, 5) A and its b, a sparse
    6 x 6 drawn row by row as the CLI's ``sparse_dist`` draws (an entry
    nonzero where ``random() > 0.45``), and a dense 5 x 5."""
    import random

    rng = random.Random(seed)
    a = [[rng.randint(-5, 5) for _ in range(8)] for _ in range(8)]
    b = [rng.randint(-5, 5) for _ in range(8)]
    sparse = [[rng.randint(-5, 5) if rng.random() > 0.45 else 0
               for _ in range(6)] for _ in range(6)]
    dense = [[rng.randint(-5, 5) for _ in range(5)] for _ in range(5)]
    return a, b, sparse, dense


def config1_derivation(Matrix, log, exact, inputs):
    """Log config 1's derivation through a package's ``Matrix`` and ``log``
    (``exact`` makes an integer that package's exact number): the system's
    solution set by ``find_preimage_of`` with every log, then the planned
    ``determinant(log_permutation_details=True)`` of the sparse 6 x 6 and
    the dense 5 x 5.  Returns the solution set and the determinants."""
    a, b, sparse, dense = inputs
    log(r"\section{Lineární soustava}")
    A = Matrix([[exact(x) for x in row] for row in a])
    log(r"Lineární soustava $A\,x=b$ s $A=%s$", A)
    sol = A.find_preimage_of([exact(x) for x in b], log_matrices=True,
                             log_steps=True, log_result=True)
    log(r"\textbf{Množina řešení:} $%s$", sol)
    dets = []
    for items in (sparse, dense):
        log(r"\section{Determinant}")
        M = Matrix([[exact(x) for x in row] for row in items])
        log(r"Vstupní matice $A$: $%s$ \\", M)
        dets.append(M.determinant(log_permutation_details=True))
        log(r"\textbf{Determinant:} $%s$", dets[-1])
    return sol, dets


def text_lanes(count=TEXT_LANES, seed=TEXT_SEED):
    """Config-1 systems as numpy int64 on the host: A [count, 8, 8] and b
    [count, 8], entries in [-5, 5]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.integers(-5, 6, size=(count, 8, 8)),
            rng.integers(-5, 6, size=(count, 8)))


def drive_text(dev, lanes=TEXT_LANES, replayed=TEXT_REPLAYED):
    """Phase 53: build the native planner; write config 1's derivation
    with the Python engine and hold it byte for byte against the golden
    file; plan the two determinants with both engines (same cost); run
    ``lanes`` config-1 systems through ``rref_batched`` on ``dev`` and on
    the CPU (events equal lane by lane); replay ``replayed`` of them into
    LaTeX and count those whose text is the exact path's; hold the CRT
    solve's regular lanes against ``find_preimage_of``."""
    import os
    import pathlib

    import numpy as np

    from linalg_solver_tpu_torch import planner
    from linalg_solver_tpu_torch.exact import Matrix, from_reference_items
    from linalg_solver_tpu_torch.ops.exact_int import crt_det_batched
    from linalg_solver_tpu_torch.ops.exact_int import crt_solve_batched
    from linalg_solver_tpu_torch.ops.rref import rref_batched
    from linalg_solver_tpu_torch.planner import native
    from linalg_solver_tpu_torch.trace import events
    from linalg_solver_tpu_torch.utils.trace import capture_logs, log
    from fractions import Fraction

    t_phase = time.perf_counter()
    saved = os.environ.get("LINALG_TPU_NATIVE")
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    print(f"text: native planner built with g++ in {build_s:.3f} s "
          f"({native.library_path().name})")

    inputs = config1_inputs()
    pats = {"sparse-6": inputs[2], "dense-5": inputs[3]}
    texts, plans, plan_s = {}, {}, {}
    try:
        for name in ("python", "native"):
            # the planner reads its engine at each call
            os.environ["LINALG_TPU_NATIVE"] = "1" if name == "native" else "0"
            for what, items in pats.items():
                p = [[x != 0 for x in row] for row in items]
                t0 = time.perf_counter()
                plans[name, what] = planner.find_optimal_determinant_process(p)
                plan_s[name, what] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = []
            texts[name] = capture_logs(lambda: out.append(config1_derivation(
                Matrix, log, Fraction, inputs)))
            print(f"text: config 1 derivation with the {name} engine in "
                  f"{time.perf_counter() - t0:.3f} s, {len(texts[name])} "
                  f"characters")
    finally:
        if saved is None:
            os.environ.pop("LINALG_TPU_NATIVE", None)
        else:
            os.environ["LINALG_TPU_NATIVE"] = saved
    sol, dets = out[0]
    golden = (pathlib.Path(__file__).resolve().parent / TEXT_GOLDEN
              ).read_text(encoding="utf-8")
    same_golden = texts["python"] == golden
    print(f"text: python-engine text equals {TEXT_GOLDEN} byte for byte: "
          f"{same_golden}; native-engine text equal to it: "
          f"{texts['native'] == golden}")
    if not same_golden:
        raise AssertionError(f"config 1's text differs from {TEXT_GOLDEN}")
    for what in pats:
        cp, cn = plans["python", what].cost, plans["native", what].cost
        print(f"text: plan {what}: cost ({cp.multiplications}, "
              f"{cp.additions}) python {plan_s['python', what]:.4f} s, "
              f"native ({cn.multiplications}, {cn.additions}) "
              f"{plan_s['native', what]:.4f} s")
        if cp != cn:
            raise AssertionError(f"the engines' costs differ on {what}")
    a_in, b_in = inputs[:2]
    if any(sum(a_in[i][j] * sol.vec[j] for j in range(8)) != b_in[i]
           for i in range(8)):
        raise AssertionError("config 1's solution does not solve A x = b")
    exact = [crt_det_batched(torch.tensor([items], device=dev))[0]
             for items in pats.values()]
    print(f"text: planned determinants {', '.join(map(str, dets))}, CRT "
          f"determinants on {dev} {', '.join(map(str, exact))}")
    if dets != exact:
        raise AssertionError("a planned determinant differs from the CRT one")

    # the card's pivot events against the CPU's, lane by lane
    A, b = (x[:lanes] for x in text_lanes())
    aug = torch.from_numpy(np.concatenate([A, b[:, :, None]], axis=2)).to(
        torch.float32)
    t0 = time.perf_counter()
    res = rref_batched(aug.to(dev), bar_col=8, tol=events.REPLAY_TOL,
                       pivot_rule="first")
    ev, ne = res.events.cpu(), res.num_events.cpu()
    rref_s = time.perf_counter() - t0
    ref = rref_batched(aug, bar_col=8, tol=events.REPLAY_TOL,
                       pivot_rule="first")
    same_lanes = ((ev == ref.events).all(dim=(1, 2))
                  & (ne == ref.num_events))
    print(f"text: rref_batched on {dev} over {lanes} config-1 systems in "
          f"{rref_s:.3f} s: events equal to the CPU's on "
          f"{int(same_lanes.sum())} of {lanes} lanes")
    if not bool(same_lanes.all()):
        raise AssertionError("the card's pivot events differ from the CPU's")

    # replay on the host, against the exact path's text
    host = aug.numpy()
    t0 = time.perf_counter()
    matched = sum(events.replay_matches_exact(host[k], ev[k].numpy(),
                                              int(ne[k]), bar_col=8)
                  for k in range(replayed))
    print(f"text: {matched} of {replayed} replayed lanes match the exact "
          f"path's text (pinned {TEXT_MATCHED}) in "
          f"{time.perf_counter() - t0:.3f} s")
    if matched != TEXT_MATCHED:
        raise AssertionError(f"{matched} lanes matched, not {TEXT_MATCHED}")

    # the CRT solve's regular lanes against find_preimage_of
    xs, _ = crt_solve_batched(torch.from_numpy(A[:replayed]).to(dev),
                              torch.from_numpy(b[:replayed]).to(dev))
    regular = 0
    for k, xk in enumerate(xs):
        pre = Matrix(from_reference_items(A[k].tolist())).find_preimage_of(
            from_reference_items([b[k].tolist()])[0])
        unique = hasattr(pre, "dim") and pre.dim() == 0
        regular += xk is not None
        if unique != (xk is not None) or (unique and list(pre.vec) != xk):
            raise AssertionError(f"lane {k}: the CRT solve differs from "
                                 f"find_preimage_of")
    print(f"text: crt_solve_batched regular on {regular} of {replayed} "
          f"lanes, each equal to find_preimage_of's solution")
    seconds = time.perf_counter() - t_phase
    print(f"text phase: {seconds:.2f} s")
    return {"build_s": build_s, "matched": matched, "seconds": seconds,
            "plan_s": {f"{k[0]} {k[1]}": v for k, v in plan_s.items()}}


# ---------------------------------------------------------------------------
# 54. The CLI: the exact sections on this host, then --device on the card
# ---------------------------------------------------------------------------

CLI_SEEDS = (2026, 7, 123)
CLI_GOLDEN = "tests/data_torch/cli_seed{}.tex"
#: the spectral table --device writes for diagonalizable_batch's [4, 1, 1,
#: -2]: distinct eigenvalues descending (.4g), algebraic and geometric
#: multiplicities, diagonalizable
CLI_TABLE_ROW = r" & $4, 1, -2$ & 1, 2, 1 & 1, 2, 1 & ano \\"
#: the kernels --device launches: the Schur stage's chase at n = 4 (no AED
#: window below its size), the spectral core's pivoted Gauss–Jordan and
#: P⁻¹'s fused inverse (N = 4)
CLI_KERNELS = ("chase", "gauss_jordan", "inv_rbt")


def all_counts():
    """Launches of every kernel since ``reset_all_counts``."""
    from linalg_solver_tpu_torch.ops.kernels import complex_gauss
    from linalg_solver_tpu_torch.ops.kernels import schur_chase, sturm, trsyl

    return {**phase_counts(), "chase": schur_chase.LAUNCHES,
            "trsyl": trsyl.LAUNCHES, "sturm": sturm.LAUNCHES,
            "complex_gauss": complex_gauss.LAUNCHES}


def reset_all_counts():
    from linalg_solver_tpu_torch.ops.kernels import complex_gauss, sturm, trsyl

    reset_counts()
    trsyl.LAUNCHES = sturm.LAUNCHES = complex_gauss.LAUNCHES = 0


def drive_cli(dev):
    """Phase 54: ``python -m linalg_solver_tpu_torch -o F --seed S --quiet``
    for each of ``CLI_SEEDS``, each file byte for byte its golden file
    (which the JAX package writes; a CPU test holds it to them); then the
    CLI with ``--device`` in this process, every kernel count set to 0
    just before and read just after: its exact part equal to the golden
    file, its replay (recomputed from the same draws) equal to the exact
    path's text, its Bareiss determinants equal to ``crt_det_batched``,
    its spectral table exact."""
    import pathlib
    import tempfile

    t_phase = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        return _drive_cli(dev, root, pathlib.Path(tmp), t_phase)


def _drive_cli(dev, root, out, t_phase):
    """``drive_cli`` writing its files into ``out``."""
    import os
    import re
    import sys

    from linalg_solver_tpu_torch import cli
    from linalg_solver_tpu_torch.ops.exact_int import bareiss_batched
    from linalg_solver_tpu_torch.ops.exact_int import crt_det_batched
    from linalg_solver_tpu_torch.ops.generate import diagonalizable_batch
    from linalg_solver_tpu_torch.ops.generate import full_rank_batch
    from linalg_solver_tpu_torch.ops.generate import random_batch
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt
    from linalg_solver_tpu_torch.ops.rref import rref_batched
    from linalg_solver_tpu_torch.trace import events
    from linalg_solver_tpu_torch.utils.trace import global_logger

    env = dict(os.environ, PYTHONPATH=str(root))
    seconds = {}
    for seed in CLI_SEEDS:
        path = out / f"cli_{seed}.tex"
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "linalg_solver_tpu_torch", "-o",
             str(path), "--seed", str(seed), "--quiet"], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        seconds[seed] = time.perf_counter() - t0
        golden = (root / CLI_GOLDEN.format(seed)).read_text(encoding="utf-8")
        same = run.returncode == 0 and path.read_text(
            encoding="utf-8") == golden
        print(f"cli: python -m linalg_solver_tpu_torch --seed {seed} in "
              f"{seconds[seed]:.2f} s: equal to {CLI_GOLDEN.format(seed)} "
              f"byte for byte: {same}")
        if not same:
            raise AssertionError(f"the CLI's file for seed {seed} differs "
                                 f"from its golden file: {run.stderr[-2000:]}")

    # --device, in this process so that the kernel counts can be read and
    # the pivoted and inverse kernels' arguments kept (the chase runs in
    # the Schur sweep's CUDA graph: hold_cli_launches holds it on one
    # eager sweep of the same batch)
    path = out / "cli_device.tex"
    saved, echo = list(global_logger.accum), global_logger.auto_print
    global_logger.accum.clear()
    launched = {"gauss_jordan": [], "inv_rbt": []}
    wraps = [(gj, "gauss_jordan_tiled", "gauss_jordan"),
             (inv_rbt, "inverse_rbt_fused", "inv_rbt")]
    origs = [getattr(mod, fn) for mod, fn, _ in wraps]

    def keeper(orig, key):
        def wrapped(*args, **kwargs):
            kept = [[t.clone() for t in x] if isinstance(x, list) else
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in args]
            out_ = orig(*args, **kwargs)
            launched[key].append((kept, kwargs, out_))
            return out_
        return wrapped

    for (mod, fn, key), orig in zip(wraps, origs):
        setattr(mod, fn, keeper(orig, key))
    reset_all_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["-o", str(path), "--seed", "2026", "--quiet", "--device"])
        torch.cuda.synchronize()
    finally:
        global_logger.accum[:] = saved
        global_logger.auto_print = echo
        for (mod, fn, _), orig in zip(wraps, origs):
            setattr(mod, fn, orig)
    device_s = time.perf_counter() - t0
    counts = {k: v for k, v in all_counts().items() if v}
    text = path.read_text(encoding="utf-8")
    golden = (root / CLI_GOLDEN.format(2026)).read_text(encoding="utf-8")
    print(f"cli --device: {device_s:.2f} s, kernel launches {counts}")
    if not text.startswith(golden + "\n"):
        raise AssertionError("--device changed the exact sections' text")
    device_text = text[len(golden) + 1:]
    if (r"\section{Dávkový GPU řešič}" not in device_text
            or "řešena na GPU" not in device_text):
        raise AssertionError("--device does not name the GPU")
    # the replay's systems, drawn as replay_solve_trace draws them
    gen = torch.Generator(device=dev).manual_seed(0)
    A = full_rank_batch(gen, 4, 3, lo=-5, hi=5, device=dev)
    b = random_batch(gen, 4, 3, 1, device=dev)[:, :, 0]
    aug = torch.cat([A, b[:, :, None]], dim=2)
    res = rref_batched(aug, bar_col=3, tol=events.REPLAY_TOL)
    matches = events.replay_matches_exact(
        aug[0].cpu().numpy(), res.events[0].cpu().numpy(),
        int(res.num_events[0]), bar_col=3)
    dets = [int(x) for x in bareiss_batched(
        torch.round(A).to(torch.int32)).det.cpu()]
    exact = crt_det_batched(torch.round(A).to(torch.int64))
    printed = re.search(r"přesně\): \$([^$]*)\$", device_text).group(1)
    rows = [ln for ln in device_text.splitlines() if ln.startswith("$A_{")]
    table_ok = len(rows) == 4 and all(
        ln == f"$A_{{{k + 1}}}$" + CLI_TABLE_ROW for k, ln in enumerate(rows))
    print(f"cli --device: replay equals the exact path's text: {matches}; "
          f"Bareiss determinants {dets} (printed {printed}), CRT {exact}; "
          f"spectral table exact: {table_ok} ({rows})")
    if not matches:
        raise AssertionError("the replayed derivation differs from the "
                             "exact path's")
    if dets != exact or printed != ", ".join(map(str, exact)):
        raise AssertionError("the device determinants differ from the CRT "
                             "determinants")
    if not table_ok:
        raise AssertionError("the spectral table is not the expected one")
    if sorted(counts) != sorted(CLI_KERNELS) or any(
            len(v) != counts[k] for k, v in launched.items()):
        raise AssertionError(f"--device launched {counts}, not each of "
                             f"{CLI_KERNELS}")
    gen = torch.Generator(device=dev).manual_seed(2026)
    spec_batch = diagonalizable_batch(gen, 4, [4.0, 1.0, 1.0, -2.0],
                                      transform="orthogonal", device=dev)
    err = hold_cli_launches(launched, spec_batch)
    seconds_phase = time.perf_counter() - t_phase
    print(f"cli phase: {seconds_phase:.2f} s")
    return {"counts": counts, "seconds": seconds, "device_s": device_s,
            "phase_s": seconds_phase, "err": err}


def hold_cli_launches(launched, spec_batch):
    """Every pivoted and fused-inverse launch of the CLI's ``--device`` run
    against the plain version on the same (cloned) arguments, the first
    bitwise (NaN-equal), the second within TOL_KERNEL with equal flags;
    the chase (whose launches run inside the Schur sweep's CUDA graph) on
    every launch of one eager outer sweep of the spectral subsection's
    batch, bitwise (``hold_schur``).  Returns the max abs difference a
    kernel."""
    from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt

    err = dict.fromkeys(("chase", *launched), 0.0)
    err["chase"] = hold_schur(spec_batch, False, "on the CLI's spectral "
                                                 "batch")[0]
    for args, kwargs, res in launched["gauss_jordan"]:
        p = gj.gauss_jordan_reference(*args, **kwargs)
        if not (torch.equal(res.perm, p.perm)
                and nan_equal(res.reduced, p.reduced)
                and nan_equal(res.pivots, p.pivots)):
            raise AssertionError(f"pivoted kernel on the CLI's "
                                 f"{list(args[0].shape)} disagrees with its "
                                 f"plain version")
    for args, kwargs, (x, bad) in launched["inv_rbt"]:
        x_ref, bad_ref = inv_rbt.inverse_rbt_fused_reference(*args, **kwargs)
        # no level-3 matrix to add to the unflagged ones: slice(0, 0)
        rel, abs_err, why = compare_inverse(x, bad, x_ref, bad_ref,
                                            slice(0, 0))
        if why is not None or not rel <= TOL_KERNEL:
            raise AssertionError(f"inverse kernel on the CLI's "
                                 f"{list(args[0].shape)} disagrees with its "
                                 f"plain version: {why or rel}")
        err["inv_rbt"] = max(err["inv_rbt"], abs_err)
    shapes = {k: sorted({tuple(c[0][0].shape) for c in v})
              for k, v in launched.items()}
    held = ", ".join(f"{k} {len(v)} on {shapes[k]}"
                     for k, v in launched.items())
    print(f"cli --device: every pivoted and inverse launch held against "
          f"its plain version ({held}): pivoted bitwise, fused inverse max "
          f"abs diff {err['inv_rbt']:.3e}")
    return err


# ---------------------------------------------------------------------------
# 55-57. The tridiagonal family: Sturm bisection (a kernel), the twisted
# factorization's eigenvectors, cyclic reduction, the randomized SVD
# ---------------------------------------------------------------------------

STURM_B, STURM_N = 256, 4096   # examples/chip_session7.py:59-80
STURM_CHECKS = ((16, 4096), (32, 512))
STURM_PLAIN_LANES = 2  # lanes of [16, 4096] the plain version runs, on the CPU
GETVEC_B, GETVEC_N = 32, 512
TOL_STURM = 1e-5       # lane 0 against float64 LAPACK, relative to |w|max
TOL_GETVEC = 1e-5      # a vector's residual over ||T|| (the JAX test's)
PCR_B, PCR_N = 256, 4096
TOL_PCR = 1e-5         # worst relative residual, float64
RSVD_B, RSVD_N, RSVD_R = 64, 1024, 32
RSVD_NOISE = 1e-3
TOL_RSVD = 1e-4        # sigma against the full SVD's, relative to sigma_1


def tridiagonal_input(bsz, n, seed=0):
    """Gaussian d [bsz, n] and e [bsz, n - 1] (f32, numpy), as
    ``examples/chip_session7.py`` builds them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randn(bsz, n).astype(np.float32),
            rng.randn(bsz, n - 1).astype(np.float32))


def sturm_work(bsz, n, counted):
    """(bytes, operations) of a bisection call: d, e², the pivot floor and
    the intervals read once and the intervals written once; n (sub, div,
    sub) for each midpoint counted: those the run's data needs (its
    schedule's count), or steps·bsz·n where every pair counts every step."""
    return 4 * (6 * bsz * n + bsz), 3.0 * counted * n


def count_work(bsz, n, g):
    """(bytes, operations) of a count call at g query points a lane: d, e²,
    the pivot floor and the points read once, the counts written once;
    n (sub, div, sub) for each of the bsz·g points."""
    return 4 * (2 * bsz * n + bsz + 2 * bsz * g), 3.0 * bsz * g * n


def drive_sturm(dev, card):
    """Phase 55: ``eigh_tridiagonal_batched`` at [256, 4096] (the count
    set to 0 just before, read just after: ``BISECT_LAUNCHES``), lane 0
    against ``scipy.linalg.eigh_tridiagonal`` in float64, and the
    midpoints each step counted (the kernel's device counter) against the
    plain schedule model ``bisect_schedule_reference`` on the same
    operands, its counts taken by the count kernel (held bitwise below);
    the bisection kernel bitwise against its plain version at [16, 4096]
    (on STURM_PLAIN_LANES of its lanes, on the host's CPU, for the
    kernel's live steps: both ``a`` and ``b``) and on the card at
    [32, 512] (both ``a`` and ``b`` and the live step count), in float32
    and float64, and against the schedule model with its live steps and
    counted midpoints; the count kernel through ``sturm_count_batched``
    at the [16, 4096] intervals' midpoints (the count set to 0 just
    before, read just after: one launch), bitwise its plain version, and
    in float64 too; each kernel's time against its bound (3·n operations
    a midpoint the data needs; beside it the bound of every pair counted
    every live step) and the plain version's, and ``torch.linalg.eigvalsh``
    on the [16, 4096] lanes' dense tridiagonals as the bisection's library
    call."""
    import numpy as np
    import scipy.linalg

    from linalg_solver_tpu_torch.ops import sturm
    from linalg_solver_tpu_torch.ops.kernels import sturm as ks
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    t_phase = time.perf_counter()
    dn, en = tridiagonal_input(STURM_B, STURM_N)
    d, e = torch.from_numpy(dn).to(dev), torch.from_numpy(en).to(dev)
    reset_all_counts()
    res = sturm.eigh_tridiagonal_batched(d, e)
    torch.cuda.synchronize()
    launches = ks.LAUNCHES
    steps_main = int(ks.LAST_STEPS)
    counted_main = ks.LAST_COUNTED.clone()
    others = {k: v for k, v in all_counts().items() if v and k != "sturm"}
    w0 = res.w[0].double().cpu().numpy()
    want = scipy.linalg.eigh_tridiagonal(dn[0].astype(np.float64),
                                         en[0].astype(np.float64),
                                         eigvals_only=True)
    err0 = float(np.abs(w0 - want).max() / np.abs(want).max())
    print(f"sturm-4096 eigh_tridiagonal_batched [{STURM_B}, {STURM_N}]: "
          f"sturm launches {launches} ({steps_main} live steps), other "
          f"kernels {others}, converged on "
          f"{int(res.converged.sum())} of {STURM_B} lanes, lane 0 against "
          f"float64 LAPACK {err0:.3e} (tol {TOL_STURM})")
    if launches != ks.BISECT_LAUNCHES:
        raise AssertionError(f"the bisection launched {launches} times, not "
                             f"{ks.BISECT_LAUNCHES}")
    if not bool(res.converged.all()) or not err0 <= TOL_STURM:
        raise AssertionError("the Sturm eigenvalues are off")
    if bool(torch.isnan(res.w).any()) or res.w.shape != d.shape:
        raise AssertionError("the Sturm eigenvalues are not finite [B, n]")
    ops_main = sturm.bisect_operands(d, e)
    ma, mb, msteps, mcounted = ks.bisect_schedule_reference(
        *ops_main, count=ks.sturm_count)
    midpoints = int(counted_main.sum())
    print(f"sturm-4096 schedule: {midpoints} midpoints counted of "
          f"{steps_main * STURM_B * STURM_N} pairs over the live steps; "
          f"the plain schedule model's the same each step "
          f"{torch.equal(mcounted, counted_main)}, its eigenvalues bitwise "
          f"{torch.equal(0.5 * (ma + mb), res.w)}")
    if not (torch.equal(mcounted, counted_main) and int(msteps) == steps_main
            and torch.equal(0.5 * (ma + mb), res.w)):
        raise AssertionError("the bisection's schedule differs from its "
                             "plain model at [256, 4096]")

    shapes, err, count = [], 0.0, None
    for dtype in (torch.float32, torch.float64):
        for bsz, n in STURM_CHECKS:
            dc, ec = (torch.from_numpy(x).to(dev, dtype)
                      for x in tridiagonal_input(bsz, n, seed=bsz + n))
            args = sturm.bisect_operands(dc, ec)
            a, b, steps = ks.bisect(*args)
            counted = ks.LAST_COUNTED.clone()
            torch.cuda.synchronize()
            # at n = 4096 the plain version (a launch an operation, n of
            # them a count) runs on the host's CPU on STURM_PLAIN_LANES
            # lanes for the kernel's steps, held against those lanes
            few = n == STURM_CHECKS[0][1]
            t0 = time.perf_counter()
            if few:
                ra, rb, rsteps = ks.bisect_reference(
                    *(x[:STURM_PLAIN_LANES].cpu() for x in args),
                    steps_run=int(steps))
                ka, kb = a[:STURM_PLAIN_LANES].cpu(), b[:STURM_PLAIN_LANES].cpu()
            else:
                ra, rb, rsteps = ks.bisect_reference(*args)
                ka, kb = a, b
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            # at [16, 4096] the plain version runs the kernel's step count,
            # so there only the intervals are held against it; the steps
            # are held against the schedule model's at every shape
            same = (torch.equal(ka, ra) and torch.equal(kb, rb)
                    and (few or int(steps) == int(rsteps)))
            sa, sb, ssteps, scounted = ks.bisect_schedule_reference(
                *args, count=ks.sturm_count)
            model = (torch.equal(sa, a) and torch.equal(sb, b)
                     and int(ssteps) == int(steps)
                     and torch.equal(scounted, counted))
            err = max(err, float((ka - ra).abs().max()),
                      float((kb - rb).abs().max()))
            t = cuda_time(ks.bisect, *args, warmup=1, iters=5)
            entry = {"shape": [bsz, n], "dtype": str(dtype)[6:],
                     "live_steps": int(steps),
                     "midpoints": int(counted.sum()), "ms": t * 1e3,
                     "plain_ms": plain_s * 1e3}
            if few:
                entry["plain_on"] = f"cpu, {STURM_PLAIN_LANES} of {bsz} lanes"
            text = ""
            if dtype == torch.float32:
                b_ms, b_by = bound(*sturm_work(bsz, n, int(counted.sum())))
                a_ms, _ = bound(*sturm_work(bsz, n, int(steps) * bsz * n))
                entry.update(bound_ms=b_ms, bound_by=b_by,
                             bound_ms_every_pair=a_ms)
                text = (f", bound {b_ms:.4f} ms ({b_by}; {a_ms:.4f} for "
                        f"every pair)")
            shapes.append(entry)
            print(f"sturm kernel vs plain [{bsz}, {n}] {entry['dtype']} "
                  f"({entry.get('plain_on', 'card, every lane')}): "
                  f"bitwise {same}, the schedule model {model} "
                  f"({int(steps)} live steps, {entry['midpoints']} midpoints "
                  f"of {int(steps) * bsz * n}); kernel {t * 1e3:.4f} ms, "
                  f"plain {plain_s * 1e3:.1f} ms{text} ({card})")
            if not same or not model:
                raise AssertionError(f"the Sturm kernel differs from its "
                                     f"plain version or schedule at "
                                     f"[{bsz}, {n}] in {dtype}")
            if (bsz, n) != STURM_CHECKS[0]:
                continue
            if dtype == torch.float32:
                dense = (torch.diag_embed(dc) + torch.diag_embed(ec, 1)
                         + torch.diag_embed(ec, -1))
                torch.cuda.synchronize()
                t_lib = cuda_time(torch.linalg.eigvalsh, dense, warmup=1,
                                  iters=5)
                lib_w = torch.linalg.eigvalsh(dense[:1]).double().cpu().numpy()
                own = 0.5 * (a[:1] + b[:1]).double().cpu().numpy()
                print(f"sturm library torch.linalg.eigvalsh on the [{bsz}, "
                      f"{n}] lanes' dense tridiagonals: {t_lib * 1e3:.1f} ms; "
                      f"its lane 0 against the kernel's "
                      f"{float(np.abs(lib_w - own).max()):.3e} ({card})")
                shapes[-1]["library_ms"] = t_lib * 1e3
                del dense
            # the count kernel through its entry point, at the midpoints
            m = 0.5 * (a + b)
            reset_all_counts()
            cnt = sturm.sturm_count_batched(dc, ec, m)
            torch.cuda.synchronize()
            c_launches = ks.LAUNCHES
            c_others = {k: v for k, v in all_counts().items()
                        if v and k != "sturm"}
            t0 = time.perf_counter()
            rcnt = ks.sturm_count_reference(*args[:3], m)
            torch.cuda.synchronize()
            c_plain_s = time.perf_counter() - t0
            c_same = torch.equal(cnt, rcnt)
            c_err = float((cnt - rcnt).abs().max())
            t_c = cuda_time(ks.sturm_count, *args[:3], m, warmup=1, iters=5)
            c_ms, c_by = bound(*count_work(bsz, n, n))
            print(f"sturm count kernel sturm_count_batched [{bsz}, {n}] "
                  f"{str(dtype)[6:]} at {n} midpoints a lane: launches "
                  f"{c_launches}, other kernels {c_others}, bitwise its "
                  f"plain version {c_same}; kernel {t_c * 1e3:.4f} ms, "
                  f"plain {c_plain_s * 1e3:.1f} ms, bound {c_ms:.4f} ms "
                  f"({c_by}) ({card})")
            if c_launches != 1 or c_others:
                raise AssertionError(f"sturm_count_batched launched "
                                     f"{c_launches} count kernels, others "
                                     f"{c_others}")
            if not c_same:
                raise AssertionError("the Sturm count kernel differs from "
                                     "its plain version")
            if dtype == torch.float32:
                count = {"shape": [bsz, n, n], "launches": c_launches,
                         "err": c_err, "ms": t_c * 1e3,
                         "plain_ms": c_plain_s * 1e3, "bound_ms": c_ms,
                         "bound_by": c_by}
            else:
                count["float64_ms"] = t_c * 1e3
    t_main = cuda_time(ks.bisect, *ops_main, warmup=1, iters=3)
    b_ms, b_by = bound(*sturm_work(STURM_B, STURM_N, midpoints))
    a_ms, _ = bound(*sturm_work(STURM_B, STURM_N,
                                steps_main * STURM_B * STURM_N))
    shapes.insert(0, {"shape": [STURM_B, STURM_N], "dtype": "float32",
                      "live_steps": steps_main, "midpoints": midpoints,
                      "ms": t_main * 1e3, "bound_ms": b_ms,
                      "bound_by": b_by, "bound_ms_every_pair": a_ms})
    t_call = cuda_time(sturm.eigh_tridiagonal_batched, d, e, warmup=0,
                       iters=3)
    print(f"time sturm-4096: kernel bisection {t_main * 1e3:.4f} ms "
          f"(bound {b_ms:.4f} ms, {b_by}, for the {midpoints} midpoints "
          f"counted; {a_ms:.4f} ms for every pair every live step), "
          f"eigh_tridiagonal_batched {t_call * 1e3:.4f} ms ({card})")
    for dtype in (torch.float32, torch.float64):
        attrs = ks.attributes(dtype)
        print(f"sturm kernels {str(dtype)[6:]}: count registers "
              f"{attrs['registers']}, spill bytes {attrs['local_bytes']}; "
              f"plan registers {attrs['plan_registers']}, spill bytes "
              f"{attrs['plan_local_bytes']}")
    seconds = time.perf_counter() - t_phase
    print(f"sturm phase: {seconds:.2f} s")
    return {"launches": launches, "err": err, "shapes": shapes,
            "count": count, "call_ms": t_call * 1e3, "seconds": seconds}


def drive_getvec(dev, card):
    """Phase 56: ``tridiag_eigenvectors_batched`` (the twisted
    factorization's four scans, plain torch) at [32, 512] on the Sturm
    eigenvalues: every vector ``ok``, the residual's max and p99, the
    call's time."""
    import numpy as np

    from linalg_solver_tpu_torch.ops import sturm
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    dn, en = tridiagonal_input(GETVEC_B, GETVEC_N, seed=1)
    d, e = torch.from_numpy(dn).to(dev), torch.from_numpy(en).to(dev)
    w = sturm.eigh_tridiagonal_batched(d, e).w
    vec = sturm.tridiag_eigenvectors_batched(d, e, w)
    resid = vec.resid.cpu().numpy()
    ok = int(vec.ok.sum())
    t = cuda_time(sturm.tridiag_eigenvectors_batched, d, e, w, warmup=1,
                  iters=3)
    print(f"getvec-512 [{GETVEC_B}, {GETVEC_N}]: resid max "
          f"{resid.max():.3e}, p99 {np.percentile(resid, 99):.3e}, ok "
          f"{ok} of {resid.size}; {t * 1e3:.2f} ms a call ({card})")
    if ok != resid.size or not resid.max() <= TOL_GETVEC:
        raise AssertionError("the twisted-factorization vectors are off")
    return {"ms": t * 1e3, "resid_max": float(resid.max()),
            "resid_p99": float(np.percentile(resid, 99))}


def drive_tridiag_rsvd(dev, card):
    """Phase 57: cyclic reduction at [256, 4096] with k = 1 on diagonally
    dominant systems (``examples/solver_family.py:86-93``), the residual
    in float64; ``randomized_svd_batched`` on [64, 1024, 1024] of rank 32
    plus 1e-3 noise at k = 32, its σ against ``torch.linalg.svd``'s and
    ``torch.svd_lowrank`` beside it, all timed."""
    from linalg_solver_tpu_torch.ops.randomized import randomized_svd_batched
    from linalg_solver_tpu_torch.ops.tridiag import tridiag_solve_batched
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    g = torch.Generator(device=dev).manual_seed(57)
    dl = torch.randn(PCR_B, PCR_N, generator=g, device=dev)
    du = torch.randn(PCR_B, PCR_N, generator=g, device=dev)
    d = dl.abs() + du.abs() + 1
    b = torch.randn(PCR_B, PCR_N, generator=g, device=dev)
    res = tridiag_solve_batched(dl, d, du, b)
    x = res.x.double()
    r = d.double() * x - b.double()
    r[:, 1:] += dl[:, 1:].double() * x[:, :-1]
    r[:, :-1] += du[:, :-1].double() * x[:, 1:]
    resid = float((r.abs().amax(dim=1) / b.abs().amax(dim=1)).max())
    t_pcr = cuda_time(tridiag_solve_batched, dl, d, du, b, warmup=2, iters=10)
    print(f"tridiag-4096 [{PCR_B}, {PCR_N}], k = 1: ok on "
          f"{int(res.ok.sum())} of {PCR_B} lanes, worst residual "
          f"{resid:.3e} (tol {TOL_PCR}); {t_pcr * 1e3:.4f} ms ({card})")
    if not bool(res.ok.all()) or not resid <= TOL_PCR:
        raise AssertionError("the cyclic reduction's solutions are off")

    lhs = torch.randn(RSVD_B, RSVD_N, RSVD_R, generator=g, device=dev)
    rhs = torch.randn(RSVD_B, RSVD_R, RSVD_N, generator=g, device=dev)
    a = lhs @ rhs + RSVD_NOISE * torch.randn(RSVD_B, RSVD_N, RSVD_N,
                                              generator=g, device=dev)
    del lhs, rhs
    rs = randomized_svd_batched(a, k=RSVD_R)
    t_rs = cuda_time(lambda a_: randomized_svd_batched(a_, k=RSVD_R), a,
                     warmup=1, iters=3)
    t_full = cuda_time(lambda a_: torch.linalg.svd(a_, full_matrices=False),
                       a, warmup=0, iters=1)
    full_s = torch.linalg.svdvals(a[:4].double())[:, :RSVD_R]
    t_low = cuda_time(lambda a_: torch.svd_lowrank(a_, q=RSVD_R + 8,
                                                   niter=2), a,
                      warmup=1, iters=3)
    err = float(((rs.s[:4].double() - full_s).abs().amax(dim=1)
                 / full_s[:, 0]).max())
    rec = rs.U[:4] @ (rs.s[:4, :, None] * rs.V[:4].transpose(1, 2))
    rec_err = float((rec - a[:4]).abs().max() / a[:4].abs().max())
    print(f"rsvd-1024 [{RSVD_B}, {RSVD_N}, {RSVD_N}] rank {RSVD_R} + "
          f"{RSVD_NOISE} noise, k = {RSVD_R}: ok {int(rs.ok.sum())}, valid "
          f"{int(rs.valid.sum())} of {rs.valid.numel()}, sigma against the "
          f"float64 SVD of 4 lanes {err:.3e} (tol {TOL_RSVD}), reconstruction "
          f"{rec_err:.3e} of max|A|, resid_est max "
          f"{float(rs.resid_est.max()):.3e}; randomized_svd_batched "
          f"{t_rs * 1e3:.2f} ms, torch.svd_lowrank {t_low * 1e3:.2f} ms, "
          f"torch.linalg.svd {t_full * 1e3:.2f} ms ({card})")
    if not bool(rs.ok.all()) or not bool(rs.valid.all()) or not err <= TOL_RSVD:
        raise AssertionError("the randomized SVD is off")
    return {"pcr_ms": t_pcr * 1e3, "pcr_resid": resid, "rsvd_ms": t_rs * 1e3,
            "svd_lowrank_ms": t_low * 1e3, "svd_ms": t_full * 1e3}


DD_KAPPA = 1e4         # phase 58's solve: orthogonal factors around
#                        logspace(0, -4)
TOL_DD_FWD = 1e-10     # forward error of x_hi + x_lo, relative, float64
TOL_DD_INV = 1e-12     # max|I - A X| of the refined inverse, float64
TOL_DD_EIG = 1e-10     # median eigenvalue error over max|A| (eigh, eig)
DD_EIGH_B, DD_EIGH_N = 32, 128
DD_LSQ_B, DD_LSQ_M, DD_LSQ_N = 64, 384, 128
CX_SOLVE_B, CX_SOLVE_N = 256, 128   # the embedding is [256, 256, 256]
CX_INV_B, CX_INV_N = 1024, 32      # [1024, 64, 64]: kernel 2
CX_EIG_B, CX_EIG_N = 32, 128       # [32, 256, 256]: the Schur kernels
CX_DET_B = 256
CX_DET_NS = (128, 192)             # the register variant, R = 4 and 6
TOL_CX = 1e-5          # complex solve residual, inverse max|AX - I|/...
TOL_CX_DET = 1e-3      # det and exp(logabs) against complex128, relative
TOL_LINALG = 1e-4      # the namespace against numpy float64, relative


def _f64_host(t):
    return t.detach().double().cpu().numpy() if not t.is_complex() else \
        t.detach().cpu().numpy().astype("complex128")


def _matched(got, want):
    """Per lane, the distances of a one-to-one matching (linear_sum_
    assignment) of the spectra ``got`` and ``want`` [B, n] (host)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    out = []
    for g_l, w_l in zip(got, want):
        cost = np.abs(g_l[:, None] - w_l[None, :])
        r, c = linear_sum_assignment(cost)
        d = np.empty(len(g_l))
        d[r] = cost[r, c]
        out.append(d)
    return np.array(out)


def conditioned_batch(bsz, n, kappa, seed, dev):
    """Seeded orthogonal factors around logspace(0, -log10 kappa), built in
    float64 on the card, rounded to f32; b Gaussian."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u, _ = torch.linalg.qr(torch.randn(bsz, n, n, generator=g, device=dev,
                                       dtype=torch.float64))
    v, _ = torch.linalg.qr(torch.randn(bsz, n, n, generator=g, device=dev,
                                       dtype=torch.float64))
    s = torch.logspace(0, -torch.log10(torch.tensor(kappa)).item(), n,
                       dtype=torch.float64, device=dev)
    a = ((u * s) @ v.transpose(1, 2)).float()
    return a, torch.randn(bsz, n, generator=g, device=dev)


def drive_dd(dev, card):
    """Phase 58: the f64-class layer.  ``solve_dd_batched`` and
    ``solve_batched(backend="dd")`` at B=N=256, kappa = 1e4 (panel kernel
    6: four launches, each held bitwise against its plain version), the
    float64 residual under the reference's target and the forward error
    against numpy's float64 solve; ``inverse_dd_batched`` at B=1024,
    N=64 (kernel 2 once); ``eig_dd_batched`` on schur-gauss-256's batch
    (the Schur kernels); ``eigh_dd`` at [32, 128] and ``lstsq_dd`` at
    [64, 384, 128]; each checked on the host in float64 and timed beside
    the float64 ``torch.linalg`` call."""
    import numpy as np

    from linalg_solver_tpu_torch.ops import dd, dispatch
    from linalg_solver_tpu_torch.ops.kernels import lu_panel
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    out = {"counts": {}, "ms": {}, "lib_ms": {}}
    a, b = conditioned_batch(B, N, DD_KAPPA, 58, dev)
    calls, off = record(lu_panel, "panel_factor_masked")
    reset_all_counts()
    r = dd.solve_dd_batched(a, b)
    torch.cuda.synchronize()
    counts = all_counts()
    off()
    x = r.x_hi.double() + r.x_lo.double()
    a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
    x64 = np.linalg.solve(a64, b64[:, :, None])[:, :, 0]
    xh = x.cpu().numpy()
    fwd = float((np.abs(xh - x64).max(axis=1)
                 / np.abs(x64).max(axis=1)).max())
    res = np.abs(b64 - np.einsum("bij,bj->bi", a64, xh)).max(axis=1)
    target = 1e-12 * np.maximum(np.abs(a64).max(axis=(1, 2))
                                * np.abs(xh).max(axis=1),
                                np.abs(b64).max(axis=1))
    k6_err = hold_masked(calls, "on the dd solve path")
    print(f"dd-256 solve_dd_batched B={B} N={N} kappa {DD_KAPPA:g}: launches "
          f"{counts}, ok {int(r.ok.sum())} of {B}, float64 residual max "
          f"{res.max():.3e} (target 1e-12 scale: every lane under it "
          f"{bool((res <= target).all())}), forward error {fwd:.3e} (tol "
          f"{TOL_DD_FWD}), reported resid max {float(r.resid.max()):.3e}")
    if counts["lu_panel"] != N // 64 or len(calls) != N // 64:
        raise AssertionError("the dd solve did not run panel kernel 6 once a "
                             "phase")
    if not bool(r.ok.all()) or not (res <= target).all():
        raise AssertionError("the dd solve missed the reference's target")
    if not fwd <= TOL_DD_FWD:
        raise AssertionError(f"dd solve forward error {fwd}")
    out["counts"]["solve"] = counts
    out["k6_err"] = k6_err
    reset_all_counts()
    xd = dispatch.solve_batched(a, b, backend="dd")
    torch.cuda.synchronize()
    c2 = all_counts()
    same = torch.equal(xd, r.x_hi + r.x_lo)
    print(f"dd-256 solve_batched(backend='dd'): launches {c2}, equal to "
          f"x_hi + x_lo of the call above {same}")
    if not same or c2["lu_panel"] != N // 64:
        raise AssertionError("backend='dd' is not solve_dd_batched collapsed")
    out["counts"]["backend_dd"] = c2
    out["ms"]["solve"] = cuda_time(dd.solve_dd_batched, a, b, warmup=1,
                                   iters=5) * 1e3
    ad, bd = a.double(), b.double()[:, :, None]
    out["lib_ms"]["solve"] = cuda_time(torch.linalg.solve, ad, bd, warmup=1,
                                       iters=5) * 1e3

    ai = inverse_batch(B_INV, N_INV, 58, dev)
    reset_all_counts()
    ri = dd.inverse_dd_batched(ai)
    torch.cuda.synchronize()
    ci = all_counts()
    xi = (ri.x_hi.double() + ri.x_lo.double()).cpu().numpy()
    ai64 = ai.double().cpu().numpy()
    inv_res = float(np.abs(ai64 @ xi - np.eye(N_INV)).max())
    print(f"dd-inverse-64 inverse_dd_batched B={B_INV} N={N_INV}: launches "
          f"{ci}, ok {int(ri.ok.sum())} of {B_INV}, float64 max|AX - I| "
          f"{inv_res:.3e} (tol {TOL_DD_INV})")
    if ci["inv_rbt"] != 1 or not bool(ri.ok.all()) or \
            not inv_res <= TOL_DD_INV:
        raise AssertionError("the dd inverse is off")
    out["counts"]["inverse"] = ci
    out["ms"]["inverse"] = cuda_time(dd.inverse_dd_batched, ai, warmup=1,
                                     iters=5) * 1e3
    out["lib_ms"]["inverse"] = cuda_time(torch.linalg.inv, ai.double(),
                                         warmup=1, iters=5) * 1e3

    ag = gaussian_input(dev)
    reset_all_counts()
    re_ = dd.eig_dd_batched(ag)
    torch.cuda.synchronize()
    ce = all_counts()
    lam = (re_.lam_re.double() + re_.lam_re_lo.double()).cpu().numpy() + 1j * (
        re_.lam_im.double() + re_.lam_im_lo.double()).cpu().numpy()
    want = np.linalg.eigvals(ag.double().cpu().numpy())
    anorm = ag.abs().amax(dim=(1, 2)).double().cpu().numpy()[:, None]
    err = _matched(lam, want) / anorm
    bound = re_.err_bound.double().cpu().numpy() / anorm
    honest = bool((err <= np.maximum(10 * bound, 1e-9)).all())
    f32_err = _matched(_f64_host(torch.complex(re_.lam_re, re_.lam_im)),
                       want) / anorm
    print(f"dd-eig-256 eig_dd_batched B={B_SPEC} n={N_SPEC}: launches {ce}, "
          f"converged {int(re_.converged.sum())}, valid "
          f"{int(re_.valid.sum())} of {re_.valid.numel()}; error over "
          f"max|A| against numpy float64: median {np.median(err):.3e} (tol "
          f"{TOL_DD_EIG}), p99 {np.quantile(err, 0.99):.3e}, max "
          f"{err.max():.3e}; within max(10 err_bound, 1e-9) everywhere "
          f"{honest}; the f32 Schur eigenvalues' median "
          f"{np.median(f32_err):.3e}")
    if not bool(re_.converged.all()) or not np.median(err) <= TOL_DD_EIG \
            or not honest or ce["chase"] < 1 or ce["schur_window"] < 1:
        raise AssertionError("the dd eigenvalues are off")
    out["counts"]["eig"] = ce
    out["ms"]["eig"] = cuda_time(dd.eig_dd_batched, ag, warmup=0,
                                 iters=2) * 1e3
    out["lib_ms"]["eig"] = cuda_time(torch.linalg.eigvals, ag.double(),
                                     warmup=0, iters=2) * 1e3

    g = torch.Generator(device=dev).manual_seed(59)
    s = torch.randn(DD_EIGH_B, DD_EIGH_N, DD_EIGH_N, generator=g, device=dev)
    s = s + s.transpose(1, 2)
    rh = dd.eigh_dd_batched(s)
    wh = (rh.w.double() + rh.w_lo.double()).cpu().numpy()
    wh64 = np.linalg.eigvalsh(s.double().cpu().numpy())
    snorm = s.abs().amax(dim=(1, 2)).double().cpu().numpy()[:, None]
    eh = np.abs(wh - wh64) / snorm
    al = torch.randn(DD_LSQ_B, DD_LSQ_M, DD_LSQ_N, generator=g, device=dev)
    bl = torch.randn(DD_LSQ_B, DD_LSQ_M, generator=g, device=dev)
    rl = dd.lstsq_dd_batched(al, bl)
    xl = (rl.x_hi.double() + rl.x_lo.double()).cpu().numpy()
    al64, bl64 = al.double().cpu().numpy(), bl.double().cpu().numpy()
    xl64 = np.stack([np.linalg.lstsq(m, v, rcond=None)[0]
                     for m, v in zip(al64, bl64)])
    el = float((np.abs(xl - xl64).max(axis=1)
                / np.abs(xl64).max(axis=1)).max())
    print(f"dd-eigh-128 eigh_dd_batched [{DD_EIGH_B}, {DD_EIGH_N}]: error "
          f"over max|A| median {np.median(eh):.3e}, max {eh.max():.3e} (tol "
          f"{TOL_DD_EIG} median); dd-lstsq-384x128 lstsq_dd_batched "
          f"[{DD_LSQ_B}, {DD_LSQ_M}, {DD_LSQ_N}]: ok {int(rl.ok.sum())} of "
          f"{DD_LSQ_B}, forward error {el:.3e} (tol {TOL_DD_FWD})")
    if not np.median(eh) <= TOL_DD_EIG or not bool(rl.ok.all()) or \
            not el <= TOL_DD_FWD:
        raise AssertionError("eigh_dd or lstsq_dd is off")
    out["ms"]["eigh"] = cuda_time(dd.eigh_dd_batched, s, warmup=1,
                                  iters=3) * 1e3
    out["lib_ms"]["eigh"] = cuda_time(torch.linalg.eigvalsh, s.double(),
                                      warmup=1, iters=3) * 1e3
    out["ms"]["lstsq"] = cuda_time(dd.lstsq_dd_batched, al, bl, warmup=1,
                                   iters=3) * 1e3
    out["lib_ms"]["lstsq"] = cuda_time(
        lambda m, v: torch.linalg.lstsq(m, v[:, :, None]), al.double(),
        bl.double(), warmup=1, iters=3) * 1e3
    for k in out["ms"]:
        print(f"time dd {k}: {out['ms'][k]:.4f} ms, torch.linalg float64 "
              f"{out['lib_ms'][k]:.4f} ms ({card})")
    return out


def complex_batch(bsz, n, seed, dev, shift=1.0):
    """(re, im) of ``shift·I + (G_re + i G_im)/sqrt(2n)`` from a seeded
    generator on the card (the spectrum a disk of radius ~1 around
    ``shift``: E log|det| ~ 0 at shift 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    re = torch.randn(bsz, n, n, generator=g, device=dev) / (2 * n) ** 0.5
    im = torch.randn(bsz, n, n, generator=g, device=dev) / (2 * n) ** 0.5
    return re + shift * torch.eye(n, device=dev), im


def gauss_work(bsz, n, dtype=torch.float32):
    """(bytes, operations) of the pivoted complex elimination in
    ``dtype``: the planes read once, the pivots, sign and flags written
    once; per step k the magnitudes (3 (n-k)), the factors (8 (n-k-1) + 2
    divisions) and the update (8 (n-k-1)^2)."""
    e = torch.empty((), dtype=dtype).element_size()
    ops = sum(3 * (n - k) + 10 * (n - k - 1) + 8 * (n - k - 1) ** 2
              for k in range(n))
    return e * (2 * bsz * n * n + 2 * bsz * n + bsz) + bsz, bsz * ops


def hold_gauss_cases(n, dev):
    """The complex elimination kernel against its plain version at
    [CX_DET_B, n, n] in f32 and float64, with a singular lane (a zero
    first column), a NaN lane and an Inf lane: pivots, sign and ok
    NaN-equal.  Returns the largest difference (0) and the variants."""
    from linalg_solver_tpu_torch.ops.kernels import complex_gauss as cg

    err, variants = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        re, im = (x.to(dtype) for x in complex_batch(CX_DET_B, n, 70 + n,
                                                      dev))
        re[1, :, 0] = im[1, :, 0] = 0.0
        re[2, n // 2, 1] = float("nan")
        im[3, 0, n - 1] = float("inf")
        got = cg.gauss_pivots_complex(re, im)
        ref = cg.gauss_pivots_complex_reference(re, im)
        if not all(nan_equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"the complex elimination kernel disagrees "
                                 f"with its plain version at n = {n} in "
                                 f"{dtype} (NaN, Inf and singular lanes)")
        err = max(err, abs_diff(got[0], ref[0]), abs_diff(got[1], ref[1]))
        variants[str(dtype).replace("torch.", "")] = cg.variant(n, dtype)
    return err, variants


def drive_complex(dev, card):
    """Phase 59: the complex layer on the real kernels.
    ``solve_complex_batched`` at B=256, n=128 (the [256, 256, 256]
    embedding: kernel 1), ``inverse_complex_batched`` at B=1024, n=32
    (kernel 2), ``eig_complex_batched`` at B=32, n=128 (the Schur
    kernels), ``det_complex_batched`` and ``slogdet_complex_batched`` at
    B=256, n=128 and 192 (the complex elimination kernel's register
    variant, held bitwise against its plain version on what each call
    gave it, then on f32 and float64 lanes with a singular, a NaN and an
    Inf lane: ``hold_gauss_cases``), each checked on the host in
    complex128 and timed beside the ``torch.linalg`` complex64 call."""
    import numpy as np

    from linalg_solver_tpu_torch.ops import complexlin as cx
    from linalg_solver_tpu_torch.ops.kernels import complex_gauss as cg
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    out = {"counts": {}, "ms": {}, "lib_ms": {}, "shapes": []}
    a_re, a_im = complex_batch(CX_SOLVE_B, CX_SOLVE_N, 59, dev, shift=3.0)
    g = torch.Generator(device=dev).manual_seed(60)
    b_re, b_im = (torch.randn(CX_SOLVE_B, CX_SOLVE_N, generator=g,
                              device=dev) for _ in range(2))
    reset_all_counts()
    x_re, x_im = cx.solve_complex_batched(a_re, a_im, b_re, b_im)
    torch.cuda.synchronize()
    cs = all_counts()
    A = _f64_host(torch.complex(a_re, a_im))
    bb = _f64_host(torch.complex(b_re, b_im))
    xx = _f64_host(torch.complex(x_re, x_im))
    res = np.abs(np.einsum("bij,bj->bi", A, xx) - bb).max(axis=1) / (
        np.abs(A).max(axis=(1, 2)) * np.abs(xx).max(axis=1))
    print(f"complex-128 solve_complex_batched B={CX_SOLVE_B} n={CX_SOLVE_N}: "
          f"launches {cs}, worst relative residual {res.max():.3e} (tol "
          f"{TOL_CX})")
    if cs["fused"] < 1 or not res.max() <= TOL_CX:
        raise AssertionError("the complex solve did not run kernel 1 or is "
                             "off")
    out["counts"]["solve"] = cs
    out["ms"]["solve"] = cuda_time(cx.solve_complex_batched, a_re, a_im,
                                   b_re, b_im, warmup=2, iters=10) * 1e3
    ac, bc = torch.complex(a_re, a_im), torch.complex(b_re, b_im)[:, :, None]
    out["lib_ms"]["solve"] = cuda_time(torch.linalg.solve, ac, bc, warmup=2,
                                       iters=10) * 1e3

    i_re, i_im = complex_batch(CX_INV_B, CX_INV_N, 61, dev, shift=3.0)
    reset_all_counts()
    v_re, v_im = cx.inverse_complex_batched(i_re, i_im)
    torch.cuda.synchronize()
    ci = all_counts()
    Ai = _f64_host(torch.complex(i_re, i_im))
    Xi = _f64_host(torch.complex(v_re, v_im))
    ires = float(np.abs(Ai @ Xi - np.eye(CX_INV_N)).max())
    print(f"complex-inverse-32 inverse_complex_batched B={CX_INV_B} "
          f"n={CX_INV_N}: launches {ci}, max|AX - I| {ires:.3e} (tol "
          f"{TOL_INV})")
    if ci["inv_rbt"] < 1 or not ires <= TOL_INV:
        raise AssertionError("the complex inverse did not run kernel 2 or "
                             "is off")
    out["counts"]["inverse"] = ci
    out["ms"]["inverse"] = cuda_time(cx.inverse_complex_batched, i_re, i_im,
                                     warmup=2, iters=10) * 1e3
    out["lib_ms"]["inverse"] = cuda_time(
        torch.linalg.inv, torch.complex(i_re, i_im), warmup=2,
        iters=10) * 1e3

    e_re, e_im = complex_batch(CX_EIG_B, CX_EIG_N, 62, dev, shift=0.0)
    reset_all_counts()
    re_ = cx.eig_complex_batched(e_re, e_im)
    torch.cuda.synchronize()
    ce = all_counts()
    Ae = _f64_host(torch.complex(e_re, e_im))
    want = np.linalg.eigvals(Ae)
    got = _f64_host(torch.complex(re_.real, re_.imag))
    norm_e = np.abs(Ae).max(axis=(1, 2))[:, None]
    dev_e = _matched(got, want) / norm_e
    print(f"complex-eig-128 eig_complex_batched B={CX_EIG_B} n={CX_EIG_N}: "
          f"launches {ce}, ok {int(re_.ok.sum())} of {CX_EIG_B}, valid "
          f"{int(re_.valid.sum())} of {re_.valid.numel()}, spectra against "
          f"numpy complex128 (matched) max {dev_e.max():.3e} of max|A| (tol "
          f"{TOL_SCHUR_EIG})")
    if ce["chase"] < 1 or ce["schur_window"] < 1 or not bool(re_.ok.all()) \
            or not dev_e.max() <= TOL_SCHUR_EIG:
        raise AssertionError("the complex eig did not run the Schur kernels "
                             "or is off")
    out["counts"]["eig"] = ce
    out["ms"]["eig"] = cuda_time(cx.eig_complex_batched, e_re, e_im,
                                 warmup=0, iters=2) * 1e3
    out["lib_ms"]["eig"] = cuda_time(torch.linalg.eigvals,
                                     torch.complex(e_re, e_im), warmup=0,
                                     iters=2) * 1e3

    out["det_launches"], out["err"] = 0, 0.0
    for n in CX_DET_NS:
        d_re, d_im = complex_batch(CX_DET_B, n, 63 + n, dev)
        d_re[1, :, 0] = 0.0           # no pivot at step 0: ok False
        d_im[1, :, 0] = 0.0
        calls, off = record(cg, "gauss_pivots_complex")
        reset_all_counts()
        det_re, det_im = cx.det_complex_batched(d_re, d_im)
        s_re, s_im, logabs = cx.slogdet_complex_batched(d_re, d_im)
        torch.cuda.synchronize()
        cd = all_counts()
        off()
        for args, got_ in calls:
            ref = cg.gauss_pivots_complex_reference(*args)
            if not all(nan_equal(x, y) for x, y in zip(got_, ref)):
                raise AssertionError(f"the complex elimination kernel "
                                     f"disagrees with its plain version at "
                                     f"n = {n}")
            out["err"] = max(out["err"], abs_diff(got_[0], ref[0]),
                             abs_diff(got_[1], ref[1]))
        Ad = _f64_host(torch.complex(d_re, d_im))
        sign64, log64 = np.linalg.slogdet(Ad)
        keep = np.arange(CX_DET_B) != 1
        det = _f64_host(torch.complex(det_re, det_im))[keep]
        det64 = (sign64 * np.exp(log64))[keep]
        det_err = float((np.abs(det - det64) / np.abs(det64)).max())
        sgn = _f64_host(torch.complex(s_re, s_im))[keep]
        log_err = float(np.abs(logabs.double().cpu().numpy()[keep]
                               - log64[keep]).max())
        sgn_err = float(np.abs(sgn - sign64[keep]).max())
        flags = (float(det_re[1]) == 0.0 and float(det_im[1]) == 0.0
                 and float(logabs[1]) == float("-inf"))
        print(f"complex-det-{n} det/slogdet_complex_batched B={CX_DET_B} "
              f"n={n} (variant {cg.variant(n, torch.float32)}): launches "
              f"{cd}, the kernel bitwise its plain version on "
              f"{len(calls)} calls; det against complex128 {det_err:.3e}, "
              f"sign {sgn_err:.3e}, log|det| {log_err:.3e} (tol "
              f"{TOL_CX_DET}); the singular lane 0 and -inf {flags}")
        if cd["complex_gauss"] != 2 or len(calls) != 2 or not flags or \
                not max(det_err, sgn_err) <= TOL_CX_DET or \
                not log_err <= TOL_CX_DET * n:
            raise AssertionError(f"the complex determinant at n = {n} is off")
        out["det_launches"] += cd["complex_gauss"]
        t_k = cuda_time(cg.gauss_pivots_complex, d_re, d_im, warmup=2,
                        iters=10)
        t_p = cuda_time(cg.gauss_pivots_complex_reference, d_re, d_im,
                        warmup=1, iters=2)
        dc = torch.complex(d_re, d_im)
        t_det = cuda_time(cx.det_complex_batched, d_re, d_im, warmup=2,
                          iters=10)
        t_lib = cuda_time(torch.linalg.det, dc, warmup=2, iters=10)
        t_sl = cuda_time(cx.slogdet_complex_batched, d_re, d_im, warmup=2,
                         iters=10)
        t_sl_lib = cuda_time(torch.linalg.slogdet, dc, warmup=2, iters=10)
        bms, by = bound(*gauss_work(CX_DET_B, n, d_re.dtype))
        h_err, h_var = hold_gauss_cases(n, dev)
        out["err"] = max(out["err"], h_err)
        print(f"complex elimination kernel vs plain at [{CX_DET_B}, {n}, "
              f"{n}] with singular, NaN and Inf lanes: bitwise equal in "
              f"f32 and float64 (variants {h_var})")
        out["shapes"].append({
            "shape": [CX_DET_B, n, n], "variant": cg.variant(n, torch.float32),
            "ms": t_k * 1e3, "plain_ms": t_p * 1e3, "bound_ms": bms,
            "bound_by": by, "library_ms": t_lib * 1e3,
            "det_ms": t_det * 1e3, "slogdet_ms": t_sl * 1e3,
            "slogdet_library_ms": t_sl_lib * 1e3,
            "attributes": cg.attributes(n, torch.float32)})
        print(f"time complex elimination [{CX_DET_B}, {n}, {n}]: kernel "
              f"{t_k * 1e3:.4f} ms, plain {t_p * 1e3:.2f} ms, bound "
              f"{bms:.4f} ms ({by}); det_complex_batched {t_det * 1e3:.4f} "
              f"ms, torch.linalg.det complex64 {t_lib * 1e3:.4f} ms; "
              f"slogdet {t_sl * 1e3:.4f} ms, torch.linalg.slogdet "
              f"{t_sl_lib * 1e3:.4f} ms; attributes "
              f"{out['shapes'][-1]['attributes']} ({card})")
    for k in out["ms"]:
        print(f"time complex {k}: {out['ms'][k]:.4f} ms, torch.linalg "
              f"complex64 {out['lib_ms'][k]:.4f} ms ({card})")
    return out


LINALG_N = 16
LINALG_LEADS = ((), (3,), (2, 2))


def _linalg_input(lead, cplx, seed, dev, m=None, shift=3.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n, m = LINALG_N, m or LINALG_N
    a = torch.randn(*lead, n, m, generator=g, device=dev)
    if cplx:
        a = torch.complex(a, torch.randn(*lead, n, m, generator=g,
                                         device=dev))
    if n == m:
        a = a + shift * n ** 0.5 * torch.eye(n, device=dev)
    return a


def drive_linalg(dev, card):
    """Phase 60: the ``numpy.linalg``-shaped namespace on the card, every
    entry point at leading batch dims (), (3,) and (2, 2), real and
    complex, against numpy in float64 / complex128 on the host; one call
    on a numpy array (it must land on the card).  Returns the seconds and
    the kernel launches of the whole phase."""
    import numpy as np

    from linalg_solver_tpu_torch import linalg as tla

    def close(name, got, want, tol=TOL_LINALG):
        got = _f64_host(got)
        want = np.asarray(want)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        if got.shape != want.shape or not err <= tol:
            raise AssertionError(f"linalg.{name}: {got.shape} against "
                                 f"{want.shape}, relative error {err}")
        return err

    t0 = time.perf_counter()
    reset_all_counts()
    worst = {}
    for cplx in (False, True):
        for lead in LINALG_LEADS:
            tag = f"{'complex' if cplx else 'real'} {lead}"
            a = _linalg_input(lead, cplx, 70, dev)
            an = _f64_host(a)
            b = _linalg_input(lead, False, 71, dev)[..., 0]
            bm = _linalg_input(lead, False, 72, dev)[..., :3]
            t = _linalg_input(lead, cplx, 73, dev, m=8)
            tn = _f64_host(t)
            errs = {
                "solve": close("solve", tla.solve(a, b), np.linalg.solve(
                    an, _f64_host(b)[..., None])[..., 0]),
                "solve_matrix": close("solve", tla.solve(a, bm),
                                      np.linalg.solve(an, _f64_host(bm))),
                "inv": close("inv", tla.inv(a), np.linalg.inv(an)),
                "det": close("det", tla.det(a), np.linalg.det(an)),
                "slogdet": close("slogdet", tla.slogdet(a)[1],
                                 np.linalg.slogdet(an)[1]),
                "eigvals": float(np.max(_matched(
                    _f64_host(tla.eigvals(a)).reshape(-1, LINALG_N),
                    np.linalg.eigvals(an).reshape(-1, LINALG_N)))
                    / np.abs(an).max()),
                "eigvalsh": close("eigvalsh", tla.eigvalsh(
                    (a + a.mH) / 2), np.linalg.eigvalsh((an + np.conj(
                        np.swapaxes(an, -1, -2))) / 2)),
                "svdvals": close("svdvals", tla.svdvals(t), np.linalg.svd(
                    tn, compute_uv=False)),
                "pinv": close("pinv", tla.pinv(t), np.linalg.pinv(tn)),
                "lstsq": close("lstsq", tla.lstsq(t, b), np.stack([
                    np.linalg.lstsq(m_, v_, rcond=None)[0] for m_, v_ in zip(
                        tn.reshape(-1, LINALG_N, 8),
                        _f64_host(b).reshape(-1, LINALG_N))]).reshape(
                            lead + (8,))),
                "cond": close("cond", tla.cond(a, p=1), np.linalg.cond(
                    an, p=1)),
                "matrix_power": close("matrix_power", tla.matrix_power(
                    a / (4 * LINALG_N), 3), np.linalg.matrix_power(
                        an / (4 * LINALG_N), 3)),
                "matrix_rank": float(np.abs(
                    _f64_host(tla.matrix_rank(t))
                    - np.linalg.matrix_rank(tn)).max()),
            }
            w, v = tla.eig(a)
            res = np.abs(an @ _f64_host(v) - _f64_host(v) * _f64_host(w)[
                ..., None, :]).max() / np.abs(an).max()
            h = (a + a.mH) / 2
            wh, vh = tla.eigh(h)
            hn = _f64_host(h)
            res_h = np.abs(hn @ _f64_host(vh) - _f64_host(vh) * _f64_host(
                wh)[..., None, :]).max() / np.abs(hn).max()
            u, s, vh_ = tla.svd(t)
            rec = np.abs((_f64_host(u) * _f64_host(s)[..., None, :])
                         @ _f64_host(vh_) - tn).max() / np.abs(tn).max()
            q, r = tla.qr(t)
            qr_err = np.abs(_f64_host(q) @ _f64_host(r) - tn).max() / \
                np.abs(tn).max()
            gram = t.mH @ t + torch.eye(8, device=dev)
            lc = tla.cholesky(gram)
            ch_err = np.abs(_f64_host(lc) @ np.conj(np.swapaxes(
                _f64_host(lc), -1, -2)) - _f64_host(gram)).max() / np.abs(
                    _f64_host(gram)).max()
            errs.update({"eig": res, "eigh": res_h, "svd": rec, "qr": qr_err,
                         "cholesky": ch_err})
            bad = {k: e for k, e in errs.items() if not e <= TOL_LINALG}
            if bad:
                raise AssertionError(f"linalg {tag}: {bad}")
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), float(e))
    an = np.random.RandomState(74).randn(4, LINALG_N, LINALG_N) \
        + 3 * LINALG_N ** 0.5 * np.eye(LINALG_N)
    d = tla.det(an)
    if d.device.type != "cuda":
        raise AssertionError("a numpy argument did not land on the card")
    close("det (numpy input)", d, np.linalg.det(an.astype(np.float32)
                                                .astype(np.float64)))
    torch.cuda.synchronize()
    counts = all_counts()
    secs = time.perf_counter() - t0
    print(f"linalg namespace: every entry point at leading dims "
          f"{list(LINALG_LEADS)}, real and complex, n = {LINALG_N}, within "
          f"{TOL_LINALG} of numpy float64 (worst "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}); "
          f"a numpy input ran on {d.device}; launches {counts}; "
          f"{secs:.2f} s ({card})")
    return {"seconds": secs, "counts": counts, "worst": worst}


# --- phases 61-69: the rest of the LU family, the flagship step's twin,
# the iterative, structured and Kronecker modules ------------------------

KRY_B, KRY_N, LSQR_M = 8, 1024, 2048   # README: 1024x1024 SPD CG, B=8
TOL_KRY = 1e-5          # the solvers' tol; the float64 residual within 4x
LOB_B, LOB_N, LOB_K = 16, 512, 8        # README: LOBPCG k=8 smallest, B=16
TOL_LOB = 1e-4
ARN_B, ARN_N, ARN_K, ARN_M, ARN_SHIFT_N = 8, 1024, 6, 32, 512
ARN_SIGMA = 1.234
STRUCT_B, STRUCT_N = 16, 4096
VDM_B, VDM_N = 16, 32
BAND_B, BAND_N, BAND_KB = 16, 4096, 4
BSP_B, BSP_N, BSP_BS, BSP_PAIRS = 8, 2048, 64, 10   # 32 + 20 of 1024
KRON_B, KRON_M, KRON_LSQ = 16, 64, (96, 64)
LARGE_PIV_B, LARGE_PIV_N = 16, 1024    # README: 1024x1024 solve, B=16
TOL_STRUCT = 1e-4       # float64 residual, relative, of the structured solves
TOL_BSP_EIG = 2e-3 * 20  # block-sparse top-3 eigenvalues (the JAX test's)


def _time_pair(what, card, fn, lib, warmup=1, iters=3, lib_name="",
               lib_runs=None):
    """CUDA-event times of ``fn()`` and of the library call ``lib()``
    (None: no library counterpart; ``lib_runs`` its (warmup, iters), by
    default one warmup and ``iters``), printed with the card; returns
    (ms, lib_ms)."""
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    ms = cuda_time(fn, warmup=warmup, iters=iters) * 1e3
    lib_w, lib_i = lib_runs or (min(warmup, 1), iters)
    lib_ms = None if lib is None else cuda_time(
        lib, warmup=lib_w, iters=lib_i) * 1e3
    print(f"time {what}: {ms:.4f} ms" + (
        "" if lib is None else f", {lib_name} {lib_ms:.4f} ms") + f" ({card})")
    return ms, lib_ms


def _busy(what, fn, ms):
    """The device's busy share of one call of ``fn``: its device time
    (``device_time``) over its CUDA-event time ``ms``; printed.  One
    profiled call: ``fn`` was warmed up when ``ms`` was taken, and the
    profiler's processing of a host-bound call's thousands of launches
    costs several times the call."""
    from linalg_solver_tpu_torch.utils.benchmarking import device_time

    dev_ms = device_time(fn, warmup=0, iters=1) * 1e3
    print(f"device time {what}: {dev_ms:.4f} ms of {ms:.4f} ms a call, busy "
          f"share {dev_ms / ms:.3f}")
    return dev_ms


def _held_run(fn, *modules):
    """``fn()`` with every kernel count set to 0 just before and read just
    after, and the kernel wrappers ``modules`` ((module, name) pairs)
    recorded.  Returns (result, counts, recorded calls a module)."""
    recs = [record(m, n) for m, n in modules]
    reset_all_counts()
    try:
        out = fn()
        torch.cuda.synchronize()
        counts = all_counts()
    finally:
        for _, off in recs:
            off()
    return out, counts, [c for c, _ in recs]


def drive_rbt_engines(dev, card):
    """Phase 61: ``solve_rbt_batched`` and ``inverse_rbt_batched`` with
    ``engine="hybrid"`` and ``"recursive"`` at B = N = 256 (the solve at
    k = 1 and 16), every kernel-4 and kernel-5 launch held bitwise against
    its plain version on the arrays the path gave it; the direct pivoted
    rescue and the gate-free form on a batch with one zero pivot under the
    main draw; ``lu_large.large_solve_rbt(diag_engine="pivoted")`` at
    B = 16, N = 1024; float64 residuals; times beside ``torch.linalg``."""
    from linalg_solver_tpu_torch.ops import lu_large, rbt
    from linalg_solver_tpu_torch.ops.kernels import (
        butterfly, lu_nopivot, lu_panel)
    from linalg_solver_tpu_torch.utils import systems

    kmods = ((butterfly, "butterfly_two_sided"),
             (lu_nopivot, "panel_factor_nopivot"))
    out = {"counts": {}, "ms": {}, "lib_ms": {}, "bf_err": 0.0,
           "panel_err": 0.0, "k6_err": 0.0}
    a = inverse_batch(B, N, 61, dev)
    g = torch.Generator(device=dev).manual_seed(61)
    rhs = {1: torch.randn(B, N, generator=g, device=dev),
           16: torch.randn(B, N, 16, generator=g, device=dev)}
    nb_solve, nb_inv = (rbt.phase_nb(N, None, rbt.SOLVE_NB_SMALL),
                        rbt.phase_nb(N, None, rbt.INVERSE_NB))
    clean = {}
    for engine in ("hybrid", "recursive"):
        panels = N // nb_solve if engine == "hybrid" else 0
        for k, b in rhs.items():
            key = f"solve-{engine}-k{k}"
            x, c, (bf, pn) = _held_run(
                lambda: rbt.solve_rbt_batched(a, b, engine=engine), *kmods)
            res = float(worst_resid(a, b, x).max())
            print(f"{key} B={B} N={N}: launches {c}, worst residual "
                  f"{res:.3e} (tol {TOL_RESID})")
            if (c["butterfly"], c["lu_nopivot"]) != (1, panels) or \
                    c["fused"] or not res <= TOL_RESID:
                raise AssertionError(f"{key}: launches {c} or residual "
                                     f"{res} off")
            out["bf_err"] = max(out["bf_err"], hold_butterflies(bf, key))
            if pn:
                out["panel_err"] = max(out["panel_err"],
                                       hold_panels(pn, key)[0])
            out["counts"][key] = c
            clean[key] = x
        key = f"inverse-{engine}"
        panels = N // nb_inv if engine == "hybrid" else 0
        x, c, (bf, pn) = _held_run(
            lambda: rbt.inverse_rbt_batched(a, engine=engine), *kmods)
        res = float(inverse_resid(a, x).max())
        print(f"{key} B={B} N={N}: launches {c}, worst max|AX - I| "
              f"{res:.3e} (tol {TOL_INV})")
        if (c["butterfly"], c["lu_nopivot"]) != (2, panels) or \
                not res <= TOL_INV:
            raise AssertionError(f"{key}: launches {c} or residual {res}")
        out["bf_err"] = max(out["bf_err"], hold_butterflies(bf, key))
        if pn:
            out["panel_err"] = max(out["panel_err"], hold_panels(pn, key)[0])
        out["counts"][key] = c

    # one zero pivot under the main draw (system 3)
    a2 = a.clone()
    a2[3] = systems.pivot_system(
        a[3], *rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev)), 0.0)
    b1 = rhs[1]
    # the rescue's pivoted solve (``lu_blocked.blocked_solve_batched``) is
    # the library's LU: kernel 6 is recorded and held should it launch
    x, c, (bf, pn, k6) = _held_run(lambda: rbt.solve_rbt_batched(
        a2, b1, engine="hybrid", fallback="pivoted"), *kmods,
        (lu_panel, "panel_factor_masked"))
    r = worst_resid(a2, b1, x)
    same = all(torch.equal(x[i], clean["solve-hybrid-k1"][i])
               for i in range(B) if i != 3)
    print(f"solve-hybrid-k1 fallback='pivoted', system 3 a zero pivot: "
          f"launches {c}, its residual {float(r[3]):.3e}, worst "
          f"{float(r.max()):.3e}, the other systems bitwise the clean "
          f"run's {same}")
    if not float(r.max()) <= TOL_RESID or not same or \
            c["lu_nopivot"] != N // nb_solve or len(k6) != c["lu_panel"]:
        raise AssertionError("the pivoted rescue did not solve system 3 "
                             "alone")
    key = "solve-hybrid-k1-pivoted"
    out["bf_err"] = max(out["bf_err"], hold_butterflies(bf, key))
    out["panel_err"] = max(out["panel_err"], hold_panels(pn, key)[0])
    if k6:
        out["k6_err"] = hold_masked(k6, f"on {key}")
    out["counts"]["solve-hybrid-k1-pivoted"] = c
    x, c, (bf,) = _held_run(lambda: rbt.solve_rbt_batched(
        a2, b1, engine="recursive", fallback=False), kmods[0])
    same = all(torch.equal(x[i], clean["solve-recursive-k1"][i])
               for i in range(B) if i != 3)
    print(f"solve-recursive-k1 fallback=False: launches {c}, the unflagged "
          f"systems bitwise the clean run's {same}")
    if not same or c["butterfly"] != 1:
        raise AssertionError("fallback=False changed another system")
    out["bf_err"] = max(out["bf_err"], hold_butterflies(
        bf, "solve-recursive-k1-nofallback"))
    out["counts"]["solve-recursive-k1-nofallback"] = c

    al = inverse_batch(LARGE_PIV_B, LARGE_PIV_N, 62, dev)
    bl = torch.randn(LARGE_PIV_B, LARGE_PIV_N, generator=g, device=dev)
    x, c, (bf,) = _held_run(lambda: lu_large.large_solve_rbt(
        al, bl, diag_engine="pivoted"), kmods[0])
    res = float(worst_resid(al, bl, x).max())
    print(f"large-pivoted large_solve_rbt(diag_engine='pivoted') "
          f"B={LARGE_PIV_B} N={LARGE_PIV_N}: launches {c}, worst residual "
          f"{res:.3e} (tol {TOL_RESID})")
    if c["butterfly"] != 1 or not res <= TOL_RESID:
        raise AssertionError("the large-N pivoted diagonal engine is off")
    out["bf_err"] = max(out["bf_err"], hold_butterflies(bf, "large-pivoted"))
    out["counts"]["large-pivoted"] = c

    solve_lib = {k: (lambda b_: lambda: torch.linalg.solve(
        a, b_ if b_.dim() == 3 else b_[:, :, None]))(b)
        for k, b in rhs.items()}
    for engine in ("hybrid", "recursive"):
        for k, b in rhs.items():
            key = f"solve-{engine}-k{k}"
            out["ms"][key], out["lib_ms"][key] = _time_pair(
                f"{key} B={B} N={N}", card,
                (lambda e, b_: lambda: rbt.solve_rbt_batched(
                    a, b_, engine=e))(engine, b), solve_lib[k],
                warmup=2, iters=10, lib_name="torch.linalg.solve")
        key = f"inverse-{engine}"
        out["ms"][key], out["lib_ms"][key] = _time_pair(
            f"{key} B={B} N={N}", card,
            (lambda e: lambda: rbt.inverse_rbt_batched(a, engine=e))(engine),
            lambda: torch.linalg.inv(a), warmup=2, iters=10,
            lib_name="torch.linalg.inv")
    out["ms"]["large-pivoted"], out["lib_ms"]["large-pivoted"] = _time_pair(
        f"large-pivoted B={LARGE_PIV_B} N={LARGE_PIV_N}", card,
        lambda: lu_large.large_solve_rbt(al, bl, diag_engine="pivoted"),
        lambda: torch.linalg.solve(al, bl[:, :, None]), warmup=2, iters=5,
        lib_name="torch.linalg.solve")
    out["ms"]["large-recursive"], _ = _time_pair(
        f"large-recursive (the default engine, beside it) B={LARGE_PIV_B} "
        f"N={LARGE_PIV_N}", card, lambda: lu_large.large_solve_rbt(al, bl),
        None, warmup=2, iters=5)
    return out


def drive_graft(dev, card):
    """Phase 62: the flagship step's twin, ``graft_entry.entry()`` (B = 8,
    N = 64): its forward takes kernel 1 once, held against the kernel's
    plain version on the arrays the forward gave it (TOL_KERNEL), the
    residual in float64, and its time beside ``torch.linalg.solve``."""
    from linalg_solver_tpu_torch import graft_entry
    from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf

    fwd, (a, b) = graft_entry.entry()
    x, c, (calls,) = _held_run(lambda: fwd(a, b), (sf, "solve_fused_rbt"))
    (args, (xk, badk)), = calls
    x_ref, bad_ref = sf.solve_fused_rbt_reference(*args)
    rel, _, abs_err, why = compare(xk, badk, x_ref, bad_ref)
    res = float(worst_resid(a, b, x).max())
    print(f"graft twin entry() B={a.shape[0]} N={a.shape[1]}: launches {c}, "
          f"kernel vs plain max rel diff {rel:.3e} (tol {TOL_KERNEL}), "
          f"flagged {badk.nonzero().flatten().tolist()}, worst residual "
          f"{res:.3e} (tol {TOL_RESID})")
    if c["fused"] != 1 or why is not None or not rel <= TOL_KERNEL or \
            bool(badk.any()) or not res <= TOL_RESID:
        raise AssertionError(f"the graft twin is off: {why or c}")
    ms, lib_ms = _time_pair(
        "graft twin forward B=8 N=64", card, lambda: fwd(a, b),
        lambda: torch.linalg.solve(a, b[:, :, None]), warmup=3, iters=20,
        lib_name="torch.linalg.solve")
    return {"launches": c["fused"], "err": abs_err, "ms": ms,
            "lib_ms": lib_ms}


def _spd_gram(bsz, n, shift, g, dev, m=None):
    """G Gᵀ + shift·I with G [bsz, n, m or n] Gaussian over √n (the repo's
    SPD bench class: eigenvalues in [shift, shift + 4] at m = n)."""
    G = torch.randn(bsz, n, m or n, generator=g, device=dev) / n ** 0.5
    return G @ G.transpose(1, 2) + shift * torch.eye(n, device=dev)


def _check_reads(what, reads, iters, chunk):
    bound_ = math.ceil(iters / chunk) + 1
    print(f"host reads {what}: {reads} for {iters} iterations (chunk "
          f"{chunk}; bound ceil(iters/chunk) + 1 = {bound_})")
    if reads > bound_:
        raise AssertionError(f"{what} read the host {reads} times")


def _rel_resid64(a, b, x):
    """max over lanes of ‖b − A x‖ / ‖b‖ in float64 (``a [B, m, n]``)."""
    r = b.double() - (a.double() @ x.double()[:, :, None])[:, :, 0]
    return float((r.norm(dim=1) / b.double().norm(dim=1)).max())


def drive_krylov(dev, card):
    """Phase 63: CG (SPD, κ ≈ 5), BiCGSTAB, GMRES(32) and MINRES at B = 8,
    n = 1024, LSQR at [8, 2048, 1024]: every lane converged, the float64
    residual (LSQR: the normal equations' residual) within 4·tol, the
    host reads a call against its iterations, the device's busy share,
    and times beside ``torch.linalg.solve`` / ``lstsq``."""
    from linalg_solver_tpu_torch.ops import krylov

    g = torch.Generator(device=dev).manual_seed(63)
    n = KRY_N
    spd = _spd_gram(KRY_B, n, 1.0, g, dev)
    gen = torch.randn(KRY_B, n, n, generator=g, device=dev) / n ** 0.5 \
        + 4.0 * torch.eye(n, device=dev)
    Q, _ = torch.linalg.qr(torch.randn(KRY_B, n, n, generator=g, device=dev))
    lam = torch.cat([-torch.logspace(0, math.log10(3), n // 2, device=dev),
                     torch.logspace(0, math.log10(3), n // 2, device=dev)])
    sym = (Q * lam) @ Q.transpose(1, 2)
    tall = torch.randn(KRY_B, LSQR_M, n, generator=g, device=dev)
    b = torch.randn(KRY_B, n, generator=g, device=dev)
    bt = torch.randn(KRY_B, LSQR_M, generator=g, device=dev)
    cases = {
        "cg": (krylov.cg_batched, spd, b, krylov.CHUNK),
        "bicgstab": (krylov.bicgstab_batched, gen, b, krylov.CHUNK),
        "gmres": (krylov.gmres_batched, gen, b, krylov.GMRES_CHUNK),
        "minres": (krylov.minres_batched, sym, b, krylov.CHUNK),
        "lsqr": (krylov.lsqr_batched, tall, bt, krylov.CHUNK),
    }
    out = {"ms": {}, "lib_ms": {}, "dev_ms": {}, "reads": {}, "iters": {}}
    for name, (fn, a, rhs, chunk) in cases.items():
        krylov.reset_host_reads()
        r, c, _ = _held_run(lambda: fn(a, rhs, tol=TOL_KRY))
        reads, iters = krylov.HOST_READS, int(r.iters)
        if name == "gmres":
            iters //= 32          # restarts: one host read each
        if name == "lsqr":
            at = a.transpose(1, 2).double()
            rr = rhs.double() - (a.double() @ r.x.double()[:, :, None])[..., 0]
            ne = float(((at @ rr[:, :, None])[..., 0].norm(dim=1) / (
                torch.linalg.matrix_norm(a.double()) * rr.norm(dim=1)
            )).max())
            what = f"normal-equations residual {ne:.3e}"
            ok = ne <= 4 * TOL_KRY
        else:
            ne = _rel_resid64(a, rhs, r.x)
            what = f"float64 residual {ne:.3e}"
            ok = ne <= 4 * TOL_KRY
        print(f"krylov {name} [{a.shape[0]}, {a.shape[1]}, {a.shape[2]}]: "
              f"converged {int(r.converged.sum())} of {a.shape[0]}, iters "
              f"{int(r.iters)}, {what} (tol 4 x {TOL_KRY}), launches "
              f"{sum(c.values())}")
        if not bool(r.converged.all()) or not ok:
            raise AssertionError(f"krylov {name} did not converge")
        _check_reads(f"krylov {name}", reads, iters, chunk)
        out["reads"][name], out["iters"][name] = reads, int(r.iters)
        lib = (lambda a_, b_: lambda: torch.linalg.lstsq(
            a_, b_[:, :, None]))(a, rhs) if name == "lsqr" else \
            (lambda a_, b_: lambda: torch.linalg.solve(
                a_, b_[:, :, None]))(a, rhs)
        call = (lambda f_, a_, b_: lambda: f_(a_, b_, tol=TOL_KRY))(
            fn, a, rhs)
        out["ms"][name], out["lib_ms"][name] = _time_pair(
            f"krylov {name}", card, call, lib, lib_name=(
                "torch.linalg.lstsq" if name == "lsqr"
                else "torch.linalg.solve"))
        out["dev_ms"][name] = _busy(f"krylov {name}", call, out["ms"][name])
    return out


def drive_lobpcg(dev, card):
    """Phase 64: LOBPCG, the 8 smallest eigenpairs of 16 SPD 512 x 512
    matrices (G Gᵀ + 0.1 I, the repo's LOBPCG bench class): every lane
    converged, the eigenvalues against float64 ``eigvalsh`` on the card,
    their residuals, the host reads against the iterations, the busy share, and
    the time beside ``torch.lobpcg``."""
    from linalg_solver_tpu_torch.ops import krylov, lobpcg

    g = torch.Generator(device=dev).manual_seed(64)
    s = _spd_gram(LOB_B, LOB_N, 0.1, g, dev)
    krylov.reset_host_reads()
    r, c, _ = _held_run(lambda: lobpcg.lobpcg_batched(s, LOB_K, tol=TOL_LOB))
    reads, iters = krylov.HOST_READS, int(r.iters)
    want = torch.linalg.eigvalsh(s.double())[:, :LOB_K]
    conv = r.converged
    # a residual of rn·‖A‖ bounds each eigenvalue's error (symmetric A)
    anorm = s.double().abs().sum(dim=2).amax(dim=1)
    err = float(((r.w.double() - want).abs().amax(dim=1) / anorm).max())
    print(f"lobpcg [{LOB_B}, {LOB_N}] k={LOB_K}: converged {int(conv.sum())} "
          f"of {LOB_B}, iters {iters}, eigenvalue error over ||A||_inf "
          f"{err:.3e} (bound 4 tol = {4 * TOL_LOB}), resnorm max "
          f"{float(r.resnorm.max()):.3e}, launches {sum(c.values())}")
    if not bool(conv.all()) or not err <= 4 * TOL_LOB or \
            not float(r.resnorm.max()) <= 4 * TOL_LOB:
        raise AssertionError("lobpcg is off")
    _check_reads("lobpcg", reads, iters, lobpcg.CHUNK)

    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    def lib():
        return torch.lobpcg(s, k=LOB_K, largest=False, tol=TOL_LOB)

    # one library call (≈ 13–19 s on the H100), timed as it is tried
    try:
        lib_ms = cuda_time(lib, warmup=0, iters=1) * 1e3
        lib_name = "torch.lobpcg (batched)"
    except Exception as e:      # the library's lobpcg may refuse a batch
        print(f"torch.lobpcg on the batch raised {type(e).__name__}: "
              f"{str(e)[:120]}; timed one lane at a time")

        def lib():
            return [torch.lobpcg(s[i], k=LOB_K, largest=False, tol=TOL_LOB)
                    for i in range(LOB_B)]
        lib_ms = cuda_time(lib, warmup=0, iters=1) * 1e3
        lib_name = "torch.lobpcg (a lane at a time)"
    call = (lambda: lobpcg.lobpcg_batched(s, LOB_K, tol=TOL_LOB))
    ms, _ = _time_pair(f"lobpcg [{LOB_B}, {LOB_N}] k={LOB_K}", card, call,
                       None, warmup=1, iters=3)
    print(f"time {lib_name} [{LOB_B}, {LOB_N}] k={LOB_K}: {lib_ms:.4f} ms "
          f"({card})")
    return {"ms": ms, "lib_ms": lib_ms, "dev_ms": _busy("lobpcg", call, ms),
            "reads": reads, "iters": iters, "converged": int(conv.sum())}


def _rotation_batch(bsz, n, g, dev):
    """P diag(R₁₂, R₉, R₇, tail) P⁻¹: three dominant complex pairs (radii
    12, 9, 7) over a real tail in [0, 5], scrambled by P = I + G/2."""
    blocks = torch.zeros(bsz, n, n, device=dev)
    for i, (rad, th) in enumerate(((12.0, 0.4), (9.0, 1.1), (7.0, 2.0))):
        cth, sth = math.cos(th), math.sin(th)
        blocks[:, 2 * i:2 * i + 2, 2 * i:2 * i + 2] = rad * torch.tensor(
            [[cth, -sth], [sth, cth]], device=dev)
    tail = torch.rand(bsz, n - 6, generator=g, device=dev) * 5
    blocks[:, 6:, 6:] = torch.diag_embed(tail)
    P = torch.eye(n, device=dev) + 0.5 * torch.randn(
        bsz, n, n, generator=g, device=dev) / n ** 0.5
    return (P.double() @ blocks.double() @ torch.linalg.inv(P.double())
            ).float()


def drive_arnoldi(dev, card):
    """Phase 65: Krylov–Schur, the 6 largest-magnitude eigenpairs (three
    complex pairs) of 8 general 1024 x 1024 matrices at m = 32, and the
    shift-invert mode (4 nearest σ = 1.234) at n = 512: converged, the
    eigenvalues against the planted ones, the Ritz residuals from true
    matvecs in float64; both Schur kernels held bitwise (``hold_schur``)
    on the first Rayleigh matrix the path gave ``eig_batched``; times."""
    from linalg_solver_tpu_torch.ops import arnoldi, krylov, schur

    g = torch.Generator(device=dev).manual_seed(65)
    a = _rotation_batch(ARN_B, ARN_N, g, dev)
    krylov.reset_host_reads()
    r, c, (eigs,) = _held_run(lambda: arnoldi.eigs_arnoldi_batched(
        a, ARN_K, m=ARN_M, max_restarts=30), (schur, "eig_batched"))
    lam = torch.complex(r.real.double(), r.imag.double())
    mags = lam.abs().sort(dim=1).values
    want = torch.tensor([7.0, 7.0, 9.0, 9.0, 12.0, 12.0], device=dev,
                        dtype=torch.float64)
    lam_err = float((mags - want).abs().max())
    V = torch.complex(r.vectors_real.double(), r.vectors_imag.double())
    res64 = float(((a.to(torch.complex128) @ V - V * lam[:, None, :])
                   .norm(dim=1) / 12.0).max())
    print(f"arnoldi [{ARN_B}, {ARN_N}] k={ARN_K} m={ARN_M}: restarts "
          f"{r.restarts} ({krylov.HOST_READS} host reads), converged "
          f"{int(r.converged.sum())} of {r.converged.numel()}, |lambda| "
          f"error {lam_err:.3e}, float64 Ritz residual over 12 {res64:.3e}, "
          f"launches {c}")
    if not bool(r.converged.all()) or not lam_err <= 1e-3 or \
            not res64 <= 1e-4 or c["chase"] < 1:
        raise AssertionError("arnoldi is off")
    if krylov.HOST_READS != r.restarts:
        raise AssertionError("arnoldi read the host more than once a restart")
    (sargs, _), = eigs[:1]
    err, _, _ = hold_schur(sargs[0], True, f"on arnoldi's first Rayleigh "
                           f"matrix {list(sargs[0].shape)}")

    rng = torch.Generator(device=dev).manual_seed(66)
    n2 = ARN_SHIFT_N
    lams = torch.sort(torch.rand(ARN_B, n2, generator=rng, device=dev)
                      * 20 - 10, dim=1).values
    Q, _ = torch.linalg.qr(torch.randn(ARN_B, n2, n2, generator=rng,
                                       device=dev))
    s = (Q * lams[:, None, :]) @ Q.transpose(1, 2)
    rs, cs, _ = _held_run(lambda: arnoldi.eigs_arnoldi_shifted_batched(
        s, 4, ARN_SIGMA, max_restarts=30))
    near = torch.gather(lams, 1, (lams - ARN_SIGMA).abs().argsort(dim=1)
                        [:, :4]).sort(dim=1).values
    s_err = float((rs.real.sort(dim=1).values - near).abs().max())
    print(f"arnoldi shift-invert [{ARN_B}, {n2}] k=4 sigma={ARN_SIGMA}: "
          f"restarts {rs.restarts}, converged {int(rs.converged.sum())} of "
          f"{rs.converged.numel()}, error against the planted eigenvalues "
          f"{s_err:.3e} (tol 1e-3), launches {cs}")
    if not bool(rs.converged.all()) or not s_err <= 1e-3:
        raise AssertionError("shift-invert arnoldi is off")
    ms, lib_ms = _time_pair(
        f"arnoldi [{ARN_B}, {ARN_N}] k={ARN_K}", card,
        lambda: arnoldi.eigs_arnoldi_batched(a, ARN_K, m=ARN_M,
                                             max_restarts=30),
        lambda: torch.linalg.eigvals(a), warmup=1, iters=2,
        lib_name="torch.linalg.eigvals (all n)")
    ms_s, lib_s = _time_pair(
        f"arnoldi shift-invert [{ARN_B}, {n2}] k=4", card,
        lambda: arnoldi.eigs_arnoldi_shifted_batched(s, 4, ARN_SIGMA,
                                                     max_restarts=30),
        lambda: torch.linalg.eigvalsh(s), warmup=1, iters=2,
        lib_name="torch.linalg.eigvalsh (all n)")
    return {"chase": c["chase"] + cs["chase"],
            "window": c["schur_window"] + cs["schur_window"], "err": err,
            "counts": {"plain": c, "shifted": cs}, "ms": ms,
            "lib_ms": lib_ms, "shift_ms": ms_s, "shift_lib_ms": lib_s,
            "restarts": r.restarts}


def _band_matvec64(ab, x, kb):
    """``A x`` in float64 from ``solve_banded`` storage (``A[i, i+d] =
    ab[kb − d, i + d]``)."""
    ab, x = ab.double(), x.double()
    n = x.shape[1]
    y = torch.zeros_like(x)
    for d in range(-kb, kb + 1):
        lo, hi = max(0, -d), min(n, n - d)
        y[:, lo:hi] += ab[:, kb - d, lo + d:hi + d] * x[:, lo + d:hi + d]
    return y


def drive_structured(dev, card):
    """Phases 66-67: the Toeplitz (Strang-preconditioned GMRES),
    circulant and Hankel solves at B = 16, n = 4096, Björck–Pereyra at
    n = 32 (primal on smooth data, dual on moments), the banded solve at
    N = 4096, kb = 4: float64 residuals, flags, host reads, busy shares,
    and times beside ``torch.linalg.solve`` on the dense operator."""
    from linalg_solver_tpu_torch.ops import banded, krylov, structured
    from linalg_solver_tpu_torch.ops import toeplitz

    g = torch.Generator(device=dev).manual_seed(66)
    bsz, n = STRUCT_B, STRUCT_N
    decay = torch.exp(-0.5 * torch.arange(n, device=dev))
    c = torch.randn(bsz, n, generator=g, device=dev) * decay
    r = torch.randn(bsz, n, generator=g, device=dev) * decay
    c[:, 0] += 4.0
    r[:, 0] = c[:, 0]
    b = torch.randn(bsz, n, generator=g, device=dev)
    out = {"ms": {}, "lib_ms": {}, "dev_ms": {}}

    def held(name, fn, dense, rhs, check):
        krylov.reset_host_reads()
        res, cnt, _ = _held_run(fn)
        x = res.x
        rel = float(((dense.double() @ x.double()[:, :, None])[..., 0]
                     - rhs.double()).norm(dim=1).div(
                         rhs.double().norm(dim=1)).max())
        flags = res.converged if hasattr(res, "converged") else res.ok
        extra = (f", iters {int(res.iters)}, host reads {krylov.HOST_READS}"
                 if hasattr(res, "iters") else "")
        print(f"{name} [{rhs.shape[0]}, {rhs.shape[1]}]: ok "
              f"{int(flags.sum())} of {flags.numel()}{extra}, float64 "
              f"residual {rel:.3e} (tol {check}), launches "
              f"{sum(cnt.values())}")
        if not bool(flags.all()) or not rel <= check:
            raise AssertionError(f"{name} is off")
        if hasattr(res, "iters"):
            _check_reads(name, krylov.HOST_READS, int(res.iters) // 32,
                         krylov.GMRES_CHUNK)
        call = fn
        out["ms"][name], out["lib_ms"][name] = _time_pair(
            name, card, call, lambda: torch.linalg.solve(
                dense, rhs[:, :, None]), lib_name="torch.linalg.solve "
            "(dense)")
        out["dev_ms"][name] = _busy(name, call, out["ms"][name])

    T = toeplitz.toeplitz_dense_batched(c, r)
    held("toeplitz", lambda: toeplitz.toeplitz_solve_batched(c, r, b), T, b,
         4 * TOL_KRY)
    del T
    cc = torch.randn(bsz, n, generator=g, device=dev) * decay
    cc[:, 0] += 3.0
    held("circulant", lambda: structured.circulant_solve_batched(cc, b),
         structured.circulant_dense_batched(cc), b, TOL_STRUCT)
    # H = T J for the Toeplitz T above: its first column is T's first
    # column, its last row T's first row reversed
    hc, hr = r.flip(1).contiguous(), c.contiguous()
    held("hankel", lambda: structured.hankel_solve_batched(hc, hr, b),
         structured.hankel_dense_batched(hc, hr), b, 4 * TOL_KRY)

    out["vandermonde"] = drive_vandermonde(dev, card, g)

    kb, nb_ = BAND_KB, BAND_N
    ab = torch.randn(BAND_B, 2 * kb + 1, nb_, generator=g, device=dev)
    ab[:, kb] += 4.0 * (2 * kb + 1)
    bb = torch.randn(BAND_B, nb_, generator=g, device=dev)
    rb, cb, _ = _held_run(lambda: banded.banded_solve_batched(ab, bb))
    rel = float((_band_matvec64(ab, rb.x, kb) - bb.double()).norm(dim=1)
                .div(bb.double().norm(dim=1)).max())
    print(f"banded [{BAND_B}, {nb_}] kb={kb}: ok {int(rb.ok.sum())} of "
          f"{BAND_B}, float64 residual {rel:.3e} (tol {TOL_STRUCT}), "
          f"launches {sum(cb.values())}")
    if not bool(rb.ok.all()) or not rel <= TOL_STRUCT:
        raise AssertionError("the banded solve is off")
    idx = torch.arange(nb_, device=dev)
    dcol = idx[None, :] - idx[:, None]            # j − i
    band = (dcol.abs() <= kb)
    dense = torch.zeros(BAND_B, nb_, nb_, device=dev)
    rows_, cols_ = band.nonzero(as_tuple=True)
    dense[:, rows_, cols_] = ab[:, kb - (cols_ - rows_), cols_]
    out["ms"]["banded"], out["lib_ms"]["banded"] = _time_pair(
        f"banded [{BAND_B}, {nb_}] kb={kb}", card,
        lambda: banded.banded_solve_batched(ab, bb),
        lambda: torch.linalg.solve(dense, bb[:, :, None]),
        lib_name="torch.linalg.solve (dense)")
    out["dev_ms"]["banded"] = _busy(
        "banded", lambda: banded.banded_solve_batched(ab, bb),
        out["ms"]["banded"])
    return out


def _vdm_nodes(bsz, n, g, dev):
    """Chebyshev points of [-1, 1] with a small per-lane jitter, ordered
    (the JAX tests' nodes)."""
    base = torch.cos(math.pi * (torch.arange(n, device=dev) + 0.5) / n)
    return torch.sort(base[None] + 0.05 * torch.randn(
        bsz, n, generator=g, device=dev) / n, dim=1).values


def drive_vandermonde(dev, card, g):
    """Björck–Pereyra, primal (interpolation of exp(x)) and dual (a moment
    problem), at [16, 32].  Monomial interpolation at n = 32 is past f32's
    reach (cond V ≈ 1e13 and more: the float64 run of the same recurrences
    leaves residuals of 1e-10 … 1e-8, the f32 one of order 1, the JAX
    package's too), so there the card's result is held NaN-equal bitwise
    against the same recurrences on the host (each step an IEEE-rounded
    elementwise op) and its flags must be clean; accuracy is held at
    n = 10, the JAX tests' size, against numpy's float64 dense solve
    (2e-3, the JAX tests' tolerance).  Times beside ``torch.linalg.solve``
    on the dense matrix."""
    import numpy as np

    from linalg_solver_tpu_torch.ops import structured

    out = {}
    for n in (VDM_N, 10):
        xs = _vdm_nodes(VDM_B, n, g, dev)
        V = structured.vandermonde_dense_batched(xs.double())
        f = torch.exp(xs) if n == VDM_N else torch.randn(
            VDM_B, n, generator=g, device=dev)
        w = torch.rand(VDM_B, n, generator=g, device=dev)
        mom = (V.transpose(1, 2) @ w.double()[:, :, None])[..., 0].float()
        for dual, rhs in ((False, f), (True, mom)):
            fn = (structured.vandermonde_solve_t_batched if dual
                  else structured.vandermonde_solve_batched)
            name = f"vandermonde{'-dual' if dual else ''}-{n}"
            r, c, _ = _held_run(lambda: fn(xs, rhs))
            if n == VDM_N:
                rh = fn(xs.cpu(), rhs.cpu())
                same = nan_equal(r.x.cpu(), rh.x) and torch.equal(
                    r.ok.cpu(), rh.ok)
                print(f"{name} [{VDM_B}, {n}]: ok {int(r.ok.sum())} of "
                      f"{VDM_B}, bitwise the host's run of the same "
                      f"recurrences {same}, launches {sum(c.values())}")
                if not same or not bool(r.ok.all()):
                    raise AssertionError(f"{name} differs from the host")
                M = V.transpose(1, 2) if dual else V
                out[name] = _time_pair(
                    f"{name} [{VDM_B}, {n}]", card, lambda: fn(xs, rhs),
                    lambda: torch.linalg.solve(M.float(), rhs[:, :, None]),
                    warmup=2, iters=10, lib_name="torch.linalg.solve "
                    "(dense)")
                out[name + "-dev_ms"] = _busy(name, lambda: fn(xs, rhs),
                                              out[name][0])
                continue
            M = (V.transpose(1, 2) if dual else V).cpu().numpy()
            want = np.linalg.solve(M, rhs.double().cpu().numpy()[:, :, None]
                                   )[:, :, 0]
            # the JAX tests' elementwise rtol = atol = 2e-3
            err = float((np.abs(r.x.double().cpu().numpy() - want)
                         / (1.0 + np.abs(want))).max())
            print(f"{name} [{VDM_B}, {n}]: ok {int(r.ok.sum())} of {VDM_B}, "
                  f"max |x - x64| / (1 + |x64|) {err:.3e} (tol 2e-3)")
            if not bool(r.ok.all()) or not err <= 2e-3:
                raise AssertionError(f"{name} is off")
    return out


def drive_blocksparse_kron(dev, card):
    """Phases 68-69: a symmetric block-sparse operator (n = 2048, 64-wide
    blocks, 5 % of them: the diagonal and 10 pairs off it) solved by GMRES
    with block Jacobi and its 3 largest eigenpairs by Krylov–Schur, B = 8,
    held against float64 ``eigvalsh`` of the dense operator; the
    Kronecker solve, sum and least squares at B = 16, m = n = 64
    ([96, 64] ⊗ [96, 64]), both Schur kernels held on the Kronecker sum's
    first Schur input; residuals in float64; times beside the library on
    the dense operator."""
    import numpy as np

    from linalg_solver_tpu_torch.ops import blocksparse, kron, krylov, schur

    rng = np.random.RandomState(68)
    nbk, bs = BSP_N // BSP_BS, BSP_BS
    A = np.zeros((BSP_N, BSP_N), np.float32)
    pairs = set()
    while len(pairs) < BSP_PAIRS:
        i, j = sorted(int(v) for v in rng.randint(nbk, size=2))
        if i != j:
            pairs.add((i, j))
    # symmetric, as a stiffness matrix is: the pattern and the values
    for i, j in [(i, i) for i in range(nbk)] + sorted(pairs):
        blk = rng.randn(bs, bs) * 0.3
        if i == j:
            blk = (blk + blk.T) / 2
        A[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = blk
        A[j * bs:(j + 1) * bs, i * bs:(i + 1) * bs] = blk.T
    A += 8.0 * np.eye(BSP_N, dtype=np.float32)
    A[:bs, :bs] += np.diag([20.0, 15.0, 11.0] + [0.0] * (bs - 3)
                           ).astype(np.float32)
    op = blocksparse.blocksparse_from_dense(A, bs, device=dev)
    dense = torch.from_numpy(A).to(dev).expand(BSP_B, BSP_N, BSP_N)
    g = torch.Generator(device=dev).manual_seed(68)
    b = torch.randn(BSP_B, BSP_N, generator=g, device=dev)
    krylov.reset_host_reads()
    r, c, _ = _held_run(lambda: blocksparse.blocksparse_solve(op, b,
                                                              tol=TOL_KRY))
    rel = _rel_resid64(dense, b, r.x)
    print(f"blocksparse gmres n={BSP_N} bs={bs} ({op.blocks.shape[0]} of "
          f"{nbk * nbk} blocks) B={BSP_B}: converged {int(r.converged.sum())}"
          f", iters {int(r.iters)}, host reads {krylov.HOST_READS}, float64 "
          f"residual {rel:.3e} (tol {4 * TOL_KRY}), launches "
          f"{sum(c.values())}")
    if not bool(r.converged.all()) or not rel <= 4 * TOL_KRY:
        raise AssertionError("the block-sparse solve is off")
    _check_reads("blocksparse gmres", krylov.HOST_READS, int(r.iters) // 32,
                 krylov.GMRES_CHUNK)
    mv = blocksparse.make_blocksparse_matvec(op)
    y1, y2 = mv(b), mv(b)
    if not torch.equal(y1, y2):
        raise AssertionError("the block matvec is not repeatable")
    out = {"ms": {}, "lib_ms": {}, "dev_ms": {}}
    out["ms"]["blocksparse"], out["lib_ms"]["blocksparse"] = _time_pair(
        f"blocksparse gmres n={BSP_N} B={BSP_B}", card,
        lambda: blocksparse.blocksparse_solve(op, b, tol=TOL_KRY),
        lambda: torch.linalg.solve(dense, b[:, :, None]),
        lib_name="torch.linalg.solve (dense)")
    out["dev_ms"]["blocksparse"] = _busy(
        "blocksparse gmres", lambda: blocksparse.blocksparse_solve(
            op, b, tol=TOL_KRY), out["ms"]["blocksparse"])
    out["ms"]["matvec"], _ = _time_pair(
        f"blocksparse matvec B={BSP_B}", card, lambda: mv(b), None,
        warmup=3, iters=20)
    re_, ce, _ = _held_run(lambda: blocksparse.blocksparse_eigs(
        op, 3, batch=BSP_B, m=32, max_restarts=60))
    top = re_.real.sort(dim=1, descending=True).values
    want = torch.linalg.eigvalsh(dense[0].double()).flip(0)[:3]
    lam_err = float((top.double() - want).abs().max())
    print(f"blocksparse eigs k=3 m=32 batch={BSP_B}: restarts {re_.restarts}, "
          f"converged {int(re_.converged.sum())} of {re_.converged.numel()}, "
          f"resid max {float(re_.resid.max()):.3e}, largest eigenvalues "
          f"{top[0].tolist()}, against float64 eigvalsh {want.tolist()}: "
          f"max error {lam_err:.3e} (tol {TOL_BSP_EIG}), imaginary parts "
          f"max {float(re_.imag.abs().max()):.3e}, launches {ce}")
    if not bool(re_.converged.all()) or not lam_err <= TOL_BSP_EIG:
        raise AssertionError("block-sparse eigenpairs are off")

    gk = torch.Generator(device=dev).manual_seed(69)
    m = KRON_M
    ka = torch.randn(KRON_B, m, m, generator=gk, device=dev) + m ** 0.5 * 2 \
        * torch.eye(m, device=dev)
    kbm = torch.randn(KRON_B, m, m, generator=gk, device=dev) + m ** 0.5 * 2 \
        * torch.eye(m, device=dev)
    kc = torch.randn(KRON_B, m * m, generator=gk, device=dev)
    K = kron.kron_batched(ka, kbm)
    x, c1, _ = _held_run(lambda: kron.kron_solve_batched(ka, kbm, kc))
    rel = _rel_resid64(K, kc, x)
    print(f"kron_solve [{KRON_B}, {m}x{m} (x) {m}x{m}]: float64 residual "
          f"{rel:.3e} (tol {TOL_STRUCT}), launches {sum(c1.values())}")
    if not rel <= TOL_STRUCT:
        raise AssertionError("kron_solve is off")
    out["ms"]["kron_solve"], out["lib_ms"]["kron_solve"] = _time_pair(
        "kron_solve", card, lambda: kron.kron_solve_batched(ka, kbm, kc),
        lambda: torch.linalg.solve(K, kc[:, :, None]),
        lib_name="torch.linalg.solve (dense)")
    del K
    sa = torch.randn(KRON_B, m, m, generator=gk, device=dev) + m * \
        torch.eye(m, device=dev)
    sb = torch.randn(KRON_B, m, m, generator=gk, device=dev) + m * \
        torch.eye(m, device=dev)
    run_schur, seen = schur._run_schur, []

    def run_rec(a_, *rest):
        seen.append((a_.clone(), rest))
        return run_schur(a_, *rest)

    schur._run_schur = run_rec
    try:
        rs, cs, _ = _held_run(lambda: kron.kronsum_solve_batched(sa, sb, kc))
    finally:
        schur._run_schur = run_schur
    eye = torch.eye(m, device=dev)
    Ks = (torch.einsum("bij,kl->bikjl", sa, eye)
          + torch.einsum("ij,bkl->bikjl", eye, sb)).reshape(KRON_B, m * m,
                                                            m * m)
    rel = _rel_resid64(Ks, kc, rs.x)
    print(f"kronsum_solve [{KRON_B}, {m} (+) {m}]: ok {int(rs.ok.sum())} of "
          f"{KRON_B}, float64 residual {rel:.3e} (tol 1e-3), launches {cs}")
    if not bool(rs.ok.all()) or not rel <= 1e-3 or cs["chase"] < 1:
        raise AssertionError("kronsum_solve is off")
    a0, rest = seen[0]
    err, _, _ = hold_schur(a0, rest[3], "on kronsum's first Schur input "
                           f"{list(a0.shape)}", rest[2], *rest[4:])
    out["ms"]["kronsum"], out["lib_ms"]["kronsum"] = _time_pair(
        "kronsum_solve", card, lambda: kron.kronsum_solve_batched(sa, sb, kc),
        lambda: torch.linalg.solve(Ks, kc[:, :, None]),
        lib_name="torch.linalg.solve (dense)")
    del Ks
    ma, na = KRON_LSQ
    la = torch.randn(KRON_B, ma, na, generator=gk, device=dev)
    lb = torch.randn(KRON_B, ma, na, generator=gk, device=dev)
    lc = torch.randn(KRON_B, ma * ma, generator=gk, device=dev)
    (xl, okl), cl, _ = _held_run(lambda: kron.kron_lstsq_batched(la, lb, lc))
    # optimality through the factors in float64: Kᵀ(c − K x) against
    # ‖K‖_F ‖c − K x‖, ‖K‖_F = ‖A‖_F ‖B‖_F
    l64, b64 = la.double(), lb.double()
    rr = lc.double() - kron.kron_matvec_batched(l64, b64, xl.double())
    ne = kron.kron_matvec_batched(l64.transpose(1, 2), b64.transpose(1, 2),
                                  rr).norm(dim=1) / (
        l64.norm(dim=(1, 2)) * b64.norm(dim=(1, 2)) * rr.norm(dim=1))
    ne = float(ne.max())
    print(f"kron_lstsq [{KRON_B}, {ma}x{na} (x) {ma}x{na}]: ok "
          f"{int(okl.sum())} of {KRON_B}, normal-equations residual in "
          f"float64 {ne:.3e} (tol 1e-5), launches {sum(cl.values())}")
    if not bool(okl.all()) or not ne <= 1e-5:
        raise AssertionError("kron_lstsq is off")
    KL = kron.kron_batched(la, lb)
    out["ms"]["kron_lstsq"], out["lib_ms"]["kron_lstsq"] = _time_pair(
        "kron_lstsq", card, lambda: kron.kron_lstsq_batched(la, lb, lc),
        lambda: torch.linalg.lstsq(KL, lc[:, :, None]),
        lib_name="torch.linalg.lstsq (dense)", lib_runs=(1, 2))
    del KL
    out["chase"] = ce["chase"] + cs["chase"]
    out["window"] = ce["schur_window"] + cs["schur_window"]
    out["err"] = err
    out["counts"] = {"eigs": ce, "kronsum": cs}
    return out



# ---------------------------------------------------------------------------
# 70-77. the mesh layer on a 1-rank NCCL world: the batch-sharded
# BatchedSolver, the training step, the distributed LU, dd, tall, Krylov
# and eigh families, the sharded spectral pipeline, dryrun_multichip
# ---------------------------------------------------------------------------

MESH_LU_N, MESH_LU_NB = 2048, 128      # one system, the panel width
MESH_TALL = (16384, 256)               # lstsq and the tall SVD
MESH_RSVD = (16384, 1024, 16)          # the randomized SVD: [M, n], rank k
MESH_KRY_N = 1024
MESH_EIG_N = 256
MESH_SPEC = (32, 64)                   # spectral_pipeline_sharded B, n
TOL_MESH_LU = 1e-5                     # float32 LU: max|Ax - b| / max|b|
TOL_MESH_DD = 1e-10                    # dd: the same, float64 residual
TOL_MESH_TALL = 1e-4                   # against float64 numpy, relative
TOL_MESH_EIG = 1e-5                    # eigenvalues / sigma, relative
TOL_MESH_TRAIN = 1e-4                  # the first step against float64


def _record_kw(module, name):
    """Wrap ``module.name``: every call's positional and keyword arguments
    and its result are kept.  Returns (calls, off)."""
    calls = []
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, wrapped)
    return calls, lambda: setattr(module, name, orig)


def _event_ms(fn, warmup=1, iters=3):
    """CUDA-event ms of ``fn()`` (median of ``iters`` after ``warmup``)."""
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    return cuda_time(fn, warmup=warmup, iters=iters) * 1e3


def start_world(dev):
    """A 1-rank NCCL world on the card (no launcher, no environment
    variables: a HashStore) and its (1, 1) ("dp", "tp") mesh."""
    import torch.distributed as dist

    from linalg_solver_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    mesh = make_mesh(dp=1, tp=1)
    print(f"mesh: NCCL world of {dist.get_world_size()} rank, backend "
          f"{dist.get_backend()}, mesh {mesh.mesh.tolist()} "
          f"{mesh.mesh_dim_names}")
    return mesh


def drive_mesh_batch(dev, card, mesh):
    """Phase 70: ``BatchedSolver(mesh=...)`` on the (1, 1) mesh: solve at
    B = N = 256 (kernel 1), inverse at B = 1024, N = 64 (kernel 2), det
    (kernel 6) and rank (kernel 3) at B = N = 256 (``det_batch``), each
    under a ``CommMeter`` (no collective), bitwise the unsharded call, its
    kernel launches counted (set to 0 just before, read just after) and
    held against the kernel's plain version on the arrays the path gave
    it; times beside the unsharded call, and for the inverse the device
    time of 20 profiled calls of each and the host's time for the axes
    and the slice alone."""
    from linalg_solver_tpu_torch.models.solver import (BatchedSolver,
                                                       batch_shard_axes)
    from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_panel
    from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
    from linalg_solver_tpu_torch.parallel import comm
    from linalg_solver_tpu_torch.parallel.mesh import shard
    from linalg_solver_tpu_torch.utils.benchmarking import device_time

    sharded, plain = BatchedSolver(mesh=mesh), BatchedSolver()
    a, b = bench_batch(dev)
    ai = inverse_batch(B_INV, N_INV, 70, dev)
    ad = det_batch(dev)
    cases = (("solve", (a, b), (sf, "solve_fused_rbt"), "fused"),
             ("inverse", (ai,), (inv_rbt, "inverse_rbt_fused"), "inv_rbt"),
             ("det", (ad,), (lu_panel, "panel_factor_masked"), "lu_panel"),
             ("rank", (ad,), None, "gauss_jordan"))
    counts, err, ms = {}, {}, {}
    for op, args, wrap, key in cases:
        # kernel 3's launches keep their held lanes (record_gj)
        rec, off = _record_kw(*wrap) if wrap else record_gj()
        reset_all_counts()
        try:
            with comm.CommMeter() as meter:
                got = getattr(sharded, op)(*args)
            torch.cuda.synchronize()
            c = all_counts()
        finally:
            off()
        want = getattr(plain, op)(*args)
        same = nan_equal(got, want) if got.is_floating_point() else \
            torch.equal(got, want)
        launched = {k: v for k, v in c.items() if v}
        print(f"mesh BatchedSolver(mesh).{op} {list(args[0].shape)}: "
              f"collectives {meter.as_dict()}, bitwise the unsharded call "
              f"{same}, launches {launched}")
        if meter.as_dict() != {"calls": {}, "bytes": {}} or not same \
                or c[key] < 1:
            raise AssertionError(f"the sharded {op} is off: {launched}")
        counts[key] = c[key]
        if key == "gauss_jordan":
            hold_gj_launches(rec, f"on the sharded rank {list(ad.shape)}")
            err[key] = 0.0
        elif key == "lu_panel":
            err[key] = hold_masked([(a_, o_) for a_, _, o_ in rec],
                                   "on the sharded det")
        else:
            e = 0.0
            for a_, kw_, out_ in rec:
                ref = (sf.solve_fused_rbt_reference(*a_, **kw_)
                       if key == "fused" else
                       inv_rbt.inverse_rbt_fused_reference(*a_, **kw_))
                rel, *rest = (compare(*out_, *ref) if key == "fused" else
                              compare_inverse(*out_, *ref, slice(0, 0)))
                why = rest[-1]
                if why is not None or not rel <= TOL_KERNEL:
                    raise AssertionError(f"kernel {key} on the sharded {op} "
                                         f"disagrees with its plain version")
                e = max(e, rest[-2])
            err[key] = e
            print(f"kernel {key} vs plain on the sharded {op}: {len(rec)} "
                  f"launches held (tol {TOL_KERNEL}, max abs diff {e:.3e})")
        t_sh = _event_ms(lambda: getattr(sharded, op)(*args))
        t_pl = _event_ms(lambda: getattr(plain, op)(*args))
        ms[op] = {"sharded_ms": t_sh, "unsharded_ms": t_pl}
        print(f"time mesh {op} {list(args[0].shape)}: sharded {t_sh:.4f} ms, "
              f"unsharded {t_pl:.4f} ms ({card})")
        if op == "inverse":
            # where the sharded call's extra time goes: the device time of
            # each (20 profiled calls: late in this process the profiler
            # can drop a lone call's one kernel record) and the host's
            # bookkeeping (the axes and the slice) alone
            for side, sv, t_ev in (("sharded", sharded, t_sh),
                                   ("unsharded", plain, t_pl)):
                d_ms = device_time(sv.inverse, ai, warmup=1, iters=20) * 1e3
                ms[op][f"{side}_device_ms"] = d_ms if d_ms > 0 else None
                print(f"device time mesh {side} {op}: " + (
                    f"{d_ms:.4f} ms of {t_ev:.4f} ms a call, busy share "
                    f"{d_ms / t_ev:.3f}" if d_ms > 0 else
                    "not measured (the profiler recorded no device entry)"))
            t0 = time.perf_counter()
            for _ in range(1000):
                shard(ai, mesh, batch_shard_axes(mesh, ai.shape[0]))
            ms[op]["bookkeeping_ms"] = time.perf_counter() - t0
            print(f"time mesh {op}: the sharded call's axes and slice on the "
                  f"host {ms[op]['bookkeeping_ms']:.4f} ms a call ({card})")
    return {"counts": counts, "err": err, "ms": ms}


def drive_mesh_train(dev, card, mesh):
    """Phase 71: three training steps at B = N = 256 on the (1, 1) mesh:
    the loss falls, and the first step's parameters equal the float64
    step M₀ − lr·mean_b A_bᵀ r_b b_bᵀ computed on the host within
    TOL_MESH_TRAIN of the step's length."""
    import numpy as np

    from linalg_solver_tpu_torch.models.solver import (init_train_state,
                                                       make_training_step)

    g = torch.Generator(device=dev).manual_seed(71)
    a = torch.randn(B, N, N, generator=g, device=dev) / N ** 0.5 \
        + torch.eye(N, device=dev)
    b = torch.randn(B, N, generator=g, device=dev)
    lr = 1e-2
    step = make_training_step(mesh, lr=lr)
    state = init_train_state(N, device=dev)
    losses, states = [], []
    for _ in range(3):
        state, loss = step(state, a, b)
        losses.append(float(loss))
        states.append(state.params.clone())
    a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
    r = np.einsum("bij,bj->bi", a64, b64) - b64
    grad = np.einsum("bji,bj,bk->ik", a64, r, b64) / B
    exact = np.eye(N) - lr * grad
    rel = float(np.abs(states[0].double().cpu().numpy() - exact).max()
                / np.abs(exact - np.eye(N)).max())
    print(f"mesh training 3 steps B={B} N={N}: losses {losses}, step "
          f"{int(state.step)}; the first step against float64 {rel:.3e} of "
          f"its length (tol {TOL_MESH_TRAIN})")
    if not (losses[0] > losses[1] > losses[2]) or not rel <= TOL_MESH_TRAIN \
            or int(state.step) != 3:
        raise AssertionError("the training step is off")
    ms = _event_ms(lambda: step(state, a, b))
    print(f"time mesh training step B={B} N={N}: {ms:.4f} ms ({card})")
    return {"losses": losses, "rel": rel, "ms": ms}


def drive_mesh_lu(dev, card, mesh):
    """Phase 72: ``distributed_solve``, ``distributed_det`` and
    ``distributed_solve_dd`` on one N = 2048 system (Gaussian + 4√N·I),
    nb = 128, on the (1, 1) mesh's tp axis: residuals (float32 ≤
    TOL_MESH_LU, dd ≤ TOL_MESH_DD, max|Ax − b| / max|b| in float64), the
    solve's collectives equal to ``comm.model_lu_solve``, det against
    float64 ``slogdet``; times beside ``torch.linalg.solve`` / ``det``."""
    import numpy as np

    from linalg_solver_tpu_torch.parallel import comm
    from linalg_solver_tpu_torch.parallel.distributed_dd import (
        distributed_solve_dd)
    from linalg_solver_tpu_torch.parallel.distributed_lu import (
        distributed_det, distributed_solve)

    n, nb = MESH_LU_N, MESH_LU_NB
    g = torch.Generator(device=dev).manual_seed(72)
    a = torch.randn(n, n, generator=g, device=dev) + 4.0 * n ** 0.5 * \
        torch.eye(n, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    reset_all_counts()
    with comm.CommMeter() as meter:
        x = distributed_solve(a, b, mesh, axis="tp", nb=nb)
    torch.cuda.synchronize()
    launched = {k: v for k, v in all_counts().items() if v}

    def resid(x_):
        r = a.double() @ x_.double() - b.double()
        return float(r.abs().max() / b.double().abs().max())

    model = comm.model_lu_solve(n, nb)
    r32 = resid(x)
    dd = distributed_solve_dd(a, b, mesh, axis="tp", nb=nb)
    rdd = resid(dd.x_hi.double() + dd.x_lo.double())
    det = distributed_det(a / (4.0 * n ** 0.5), mesh, axis="tp", nb=nb)
    sgn, logdet = np.linalg.slogdet((a / (4.0 * n ** 0.5)).double().cpu()
                                    .numpy())
    det_rel = float(abs(float(det) - sgn * np.exp(logdet))
                    / np.exp(logdet))
    print(f"mesh distributed LU N={n} nb={nb}: solve residual {r32:.3e} "
          f"(tol {TOL_MESH_LU}), collectives {meter.as_dict()} (model "
          f"{model}), kernels {launched}; dd residual {rdd:.3e} (tol "
          f"{TOL_MESH_DD}), ok {bool(dd.ok)}; det of A/(4 sqrt N) against "
          f"float64 slogdet {det_rel:.3e} (tol {TOL_DET})")
    if not r32 <= TOL_MESH_LU or meter.as_dict() != model \
            or not rdd <= TOL_MESH_DD or not bool(dd.ok) \
            or not det_rel <= TOL_DET:
        raise AssertionError("the distributed LU family is off")
    ms = {
        "distributed_solve": _event_ms(
            lambda: distributed_solve(a, b, mesh, axis="tp", nb=nb), 0, 1),
        "torch.linalg.solve": _event_ms(
            lambda: torch.linalg.solve(a, b), 1, 3),
        "distributed_det": _event_ms(
            lambda: distributed_det(a, mesh, axis="tp", nb=nb), 0, 1),
        "torch.linalg.det": _event_ms(lambda: torch.linalg.det(a), 1, 3),
        "distributed_solve_dd": _event_ms(
            lambda: distributed_solve_dd(a, b, mesh, axis="tp", nb=nb), 0, 1),
        "torch.linalg.solve float64": _event_ms(
            lambda: torch.linalg.solve(a.double(), b.double()), 1, 3),
    }
    print(f"time mesh distributed LU N={n} nb={nb} (ms): {json.dumps(ms)} "
          f"({card})")
    return {"ms": ms, "resid": r32, "dd_resid": rdd, "det_rel": det_rel,
            "collectives": meter.as_dict()}


def drive_mesh_tall(dev, card, mesh):
    """Phase 73: ``distributed_lstsq`` and ``distributed_svd_tall`` on a
    Gaussian [16384, 256], ``distributed_randomized_svd`` (k = 16) on a
    [16384, 1024] of rank 16 with σ = 1 … 1e-2 built in float64 on the
    host: x against numpy's float64 ``lstsq``, σ against numpy's float64
    ``svd`` (the rank-16 matrix's σ are its construction's), relative
    TOL_MESH_TALL; times beside ``torch.linalg.lstsq`` / ``svd``."""
    import numpy as np

    from linalg_solver_tpu_torch.parallel.distributed_tall import (
        distributed_lstsq, distributed_randomized_svd, distributed_svd_tall)

    M, n = MESH_TALL
    rng = np.random.RandomState(73)
    a64 = rng.randn(M, n)
    b64 = rng.randn(M)
    a, b = (torch.from_numpy(t).float().to(dev) for t in (a64, b64))
    x = distributed_lstsq(a, b, mesh, axis="dp")
    x64 = np.linalg.lstsq(a.double().cpu().numpy(),
                          b.double().cpu().numpy(), rcond=None)[0]
    x_rel = float(np.abs(x.double().cpu().numpy() - x64).max()
                  / np.abs(x64).max())
    svd = distributed_svd_tall(a, mesh, axis="dp")
    s64 = np.linalg.svd(a.double().cpu().numpy(), compute_uv=False)
    s_rel = float(np.abs(svd.s.double().cpu().numpy() - s64).max() / s64[0])
    rec = float(((svd.U * svd.s) @ svd.V.T - a).abs().max() / a.abs().max())
    Mr, nr, k = MESH_RSVD
    U, _ = np.linalg.qr(rng.randn(Mr, k))
    V, _ = np.linalg.qr(rng.randn(nr, k))
    sk = np.logspace(0, -2, k)
    ar = torch.from_numpy((U * sk) @ V.T).float().to(dev)
    rs = distributed_randomized_svd(ar, mesh, k=k, axis="dp")
    r_rel = float(np.abs(rs.s.double().cpu().numpy() - sk).max() / sk[0])
    print(f"mesh tall [{M}, {n}]: lstsq x against float64 {x_rel:.3e}, "
          f"svd_tall sigma {s_rel:.3e}, reconstruction {rec:.3e}, ok "
          f"{bool(svd.ok)}; randomized_svd k={k} of [{Mr}, {nr}] sigma "
          f"{r_rel:.3e}, valid {int(rs.valid.sum())} of {k}, ok "
          f"{bool(rs.ok)} (tol {TOL_MESH_TALL})")
    if max(x_rel, s_rel, rec, r_rel) > TOL_MESH_TALL or not bool(svd.ok) \
            or not bool(rs.ok) or not bool(rs.valid.all()):
        raise AssertionError("the tall family is off")
    ms = {
        "distributed_lstsq": _event_ms(
            lambda: distributed_lstsq(a, b, mesh, axis="dp")),
        "torch.linalg.lstsq": _event_ms(
            lambda: torch.linalg.lstsq(a, b[:, None])),
        "distributed_svd_tall": _event_ms(
            lambda: distributed_svd_tall(a, mesh, axis="dp")),
        "torch.linalg.svd": _event_ms(
            lambda: torch.linalg.svd(a, full_matrices=False)),
        "distributed_randomized_svd": _event_ms(
            lambda: distributed_randomized_svd(ar, mesh, k=k, axis="dp")),
        "torch.svd_lowrank": _event_ms(
            lambda: torch.svd_lowrank(ar, q=k + 8, niter=2)),
    }
    print(f"time mesh tall (ms): {json.dumps(ms)} ({card})")
    return {"ms": ms}


def drive_mesh_krylov(dev, card, mesh):
    """Phase 74: ``distributed_cg`` (G Gᵀ/n + 4I), ``distributed_bicgstab``
    and ``distributed_gmres`` (Gaussian + 4√n·I) at n = 1024 on the mesh's
    dp axis: converged, the float64 residual within 4·tol, one all-gather
    a matvec (the meter's bytes 4·n each); times beside
    ``torch.linalg.solve``."""
    from linalg_solver_tpu_torch.parallel import comm
    from linalg_solver_tpu_torch.parallel import distributed_krylov as dk

    n = MESH_KRY_N
    g = torch.Generator(device=dev).manual_seed(74)
    G = torch.randn(n, n, generator=g, device=dev)
    spd = G @ G.T / n + 4.0 * torch.eye(n, device=dev)
    gen = torch.randn(n, n, generator=g, device=dev) + 4.0 * n ** 0.5 * \
        torch.eye(n, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    out = {}
    for name, a in (("distributed_cg", spd), ("distributed_bicgstab", gen),
                    ("distributed_gmres", gen)):
        fn = getattr(dk, name)
        with comm.CommMeter() as meter:
            r = fn(a, b, mesh, axis="dp", tol=TOL_KRY)
        res = _rel_resid64(a[None], b[None], r.x[None])
        m = meter.as_dict()
        print(f"mesh {name} n={n}: converged {bool(r.converged)}, iters "
              f"{int(r.iters)}, float64 residual {res:.3e} (tol 4 x "
              f"{TOL_KRY}), collectives {m}")
        if not bool(r.converged) or not res <= 4 * TOL_KRY or \
                set(m["calls"]) != {"all_gather"} or \
                m["bytes"]["all_gather"] != 4 * n * m["calls"]["all_gather"]:
            raise AssertionError(f"{name} is off")
        out[name] = {"iters": int(r.iters), "all_gathers":
                     m["calls"]["all_gather"], "ms": _event_ms(
                         lambda: fn(a, b, mesh, axis="dp", tol=TOL_KRY))}
    lib = _event_ms(lambda: torch.linalg.solve(gen, b))
    print(f"time mesh krylov n={n} (ms): {json.dumps(out)}, "
          f"torch.linalg.solve {lib:.4f} ({card})")
    out["torch.linalg.solve"] = lib
    return out


def drive_mesh_eigh(dev, card, mesh):
    """Phase 75: ``distributed_eigh`` of a symmetric Gaussian n = 256 and
    ``distributed_svd_jacobi`` of a Gaussian [256, 256] on the mesh's tp
    axis: eigenvalues and σ (sorted) against float64 ``eigvalsh`` /
    ``svdvals`` within TOL_MESH_EIG of the largest, converged, the eigh's
    collectives equal to ``comm.model_eigh_adaptive`` at its sweeps;
    times beside ``torch.linalg.eigh`` / ``svd``."""
    from linalg_solver_tpu_torch.parallel import comm
    from linalg_solver_tpu_torch.parallel.distributed_eigh import (
        distributed_eigh, distributed_svd_jacobi)

    n = MESH_EIG_N
    g = torch.Generator(device=dev).manual_seed(75)
    G = torch.randn(n, n, generator=g, device=dev)
    s = (G + G.T) / 2
    with comm.CommMeter() as meter:
        e = distributed_eigh(s, mesh, axis="tp")
    k = int(e.sweeps_used)
    w64 = torch.linalg.eigvalsh(s.double())
    w_rel = float((torch.sort(e.w.double()).values - w64).abs().max()
                  / w64.abs().max())
    model = comm.model_eigh_adaptive(n, 1, n // 2, k)
    sv = distributed_svd_jacobi(G, mesh, axis="tp")
    s64 = torch.linalg.svdvals(G.double())
    s_rel = float((torch.sort(sv.s.double(), descending=True).values - s64)
                  .abs().max() / s64[0])
    print(f"mesh distributed_eigh n={n}: sweeps_used {k}, converged "
          f"{bool(e.converged)} (offnorm {float(e.offnorm):.3e}), eigenvalues "
          f"against float64 {w_rel:.3e} (tol {TOL_MESH_EIG}), collectives "
          f"{meter.as_dict()} (model {model}); distributed_svd_jacobi "
          f"sweeps_used {int(sv.sweeps_used)}, converged "
          f"{bool(sv.converged)}, sigma against float64 {s_rel:.3e}")
    if not bool(e.converged) or not w_rel <= TOL_MESH_EIG or \
            meter.as_dict() != model or not bool(sv.converged) or \
            not s_rel <= TOL_MESH_EIG:
        raise AssertionError("the distributed eigen family is off")
    ms = {"distributed_eigh": _event_ms(
              lambda: distributed_eigh(s, mesh, axis="tp")),
          "torch.linalg.eigh": _event_ms(lambda: torch.linalg.eigh(s)),
          "distributed_svd_jacobi": _event_ms(
              lambda: distributed_svd_jacobi(G, mesh, axis="tp")),
          "torch.linalg.svd": _event_ms(lambda: torch.linalg.svd(G))}
    print(f"time mesh eigen n={n} (ms): {json.dumps(ms)} ({card})")
    return {"ms": ms, "sweeps": k, "svd_sweeps": int(sv.sweeps_used)}


def drive_mesh_spectral(dev, card, mesh):
    """Phase 76: ``spectral_pipeline_sharded`` at B = 32, n = 64
    (``spectral_input``'s class at n = 64: ``P diag(λ) P⁻¹`` with λ = 1,
    2, 5): no collective, bitwise ``spectral_pipeline(method="schur")`` on
    the same batch, its kernels counted, the Schur kernels held on one
    eager sweep of the batch (``hold_schur``) and kernel 3's launches on
    their kept lanes; time beside the unsharded pipeline."""
    from linalg_solver_tpu_torch.models import spectral
    from linalg_solver_tpu_torch.parallel import comm

    bsz, n = MESH_SPEC
    eigs = (1.0,) * (n - 2 * (n // 3)) + (2.0,) * (n // 3) + (5.0,) * (n // 3)
    a = spectral_input(dev, eigs=eigs, seed=76)[:bsz]
    kept, off = record_gj()
    reset_all_counts()
    try:
        with comm.CommMeter() as meter:
            rep = spectral.spectral_pipeline_sharded(a, mesh, tol=TOL_SPEC)
        torch.cuda.synchronize()
        c = all_counts()
    finally:
        off()
    ref = spectral.spectral_pipeline(a, tol=TOL_SPEC)
    same = all(nan_equal(x, y) if x.is_floating_point() else torch.equal(x, y)
               for x, y in zip(rep, ref))
    launched = {k: v for k, v in c.items() if v}
    print(f"mesh spectral_pipeline_sharded B={bsz} n={n}: collectives "
          f"{meter.as_dict()}, bitwise the unsharded pipeline {same}, "
          f"diagonalizable {int(rep.diagonalizable.sum())} of {bsz}, "
          f"launches {launched}")
    if meter.as_dict() != {"calls": {}, "bytes": {}} or not same or \
            not bool(rep.diagonalizable.all()) or not c["chase"] or \
            not c["gauss_jordan"]:
        raise AssertionError("the sharded spectral pipeline is off")
    hold_gj_launches(kept, "on the sharded spectral core")
    err = hold_schur(a, False, "on the sharded spectral batch")[0]
    ms = {"sharded": _event_ms(lambda: spectral.spectral_pipeline_sharded(
              a, mesh, tol=TOL_SPEC)),
          "unsharded": _event_ms(lambda: spectral.spectral_pipeline(
              a, tol=TOL_SPEC))}
    print(f"time mesh spectral B={bsz} n={n} (ms): {json.dumps(ms)} ({card})")
    return {"counts": {k: c[k] for k in ("chase", "schur_window",
                                         "gauss_jordan", "inv_rbt",
                                         "butterfly", "lu_nopivot")},
            "err": err, "ms": ms}


def drive_mesh(dev, card):
    """Phases 70-77 on a 1-rank NCCL world (``start_world``), closed at
    the end; phase 77 is ``graft_entry.dryrun_multichip(1)``, its kernel
    launches counted and each held against its plain version (it must
    launch kernel 1 only).  Returns each phase's figures and the kernel
    launches of the whole block."""
    import torch.distributed as dist

    from linalg_solver_tpu_torch import graft_entry
    from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf

    t0 = time.perf_counter()
    mesh = start_world(dev)
    try:
        out = {"batch": drive_mesh_batch(dev, card, mesh),
               "train": drive_mesh_train(dev, card, mesh),
               "lu": drive_mesh_lu(dev, card, mesh),
               "tall": drive_mesh_tall(dev, card, mesh),
               "krylov": drive_mesh_krylov(dev, card, mesh),
               "eigh": drive_mesh_eigh(dev, card, mesh),
               "spectral": drive_mesh_spectral(dev, card, mesh)}
        rec, off = _record_kw(sf, "solve_fused_rbt")
        reset_all_counts()
        try:
            fig = graft_entry.dryrun_multichip(1)
            torch.cuda.synchronize()
            c = all_counts()
        finally:
            off()
        out["dryrun"] = {"figures": fig, "counts": {
            k: v for k, v in c.items() if v}}
        print(f"mesh dryrun_multichip(1): {json.dumps(out['dryrun'])}")
        # every launch of the dryrun is held against its plain version
        if set(out["dryrun"]["counts"]) - {"fused"} \
                or len(rec) != c["fused"]:
            raise AssertionError(f"the dryrun launched kernels it does not "
                                 f"hold: {out['dryrun']['counts']}, "
                                 f"{len(rec)} fused calls recorded")
        e = 0.0
        for a_, kw_, out_ in rec:
            rel, *rest = compare(*out_,
                                 *sf.solve_fused_rbt_reference(*a_, **kw_))
            if rest[-1] is not None or not rel <= TOL_KERNEL:
                raise AssertionError("kernel fused on the dryrun disagrees "
                                     "with its plain version")
            e = max(e, rest[-2])
        out["dryrun"]["fused_err"] = e
        print(f"kernel fused vs plain on the dryrun: {len(rec)} launches "
              f"held (tol {TOL_KERNEL}, max abs diff {e:.3e})")
    finally:
        dist.destroy_process_group()
    counts = dict.fromkeys(all_counts(), 0)
    for src in (out["batch"]["counts"], out["spectral"]["counts"],
                out["dryrun"]["counts"]):
        for k, v in src.items():
            counts[k] += v
    out["counts"] = counts
    out["seconds"] = time.perf_counter() - t0
    print(f"mesh phases 70-77: {out['seconds']:.2f} s, kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return out


# 78. the exact eigen stack's radicals on the card's host, with no sympy
RADICAL_GOLDEN = "tests/data_torch/eigen_radicals.tex"
#: (name, integer rows, the sections written): eigenvalues, eigenvalues
#: over R, the geometric multiplicities, and diagonalize where the port
#: writes its result (not for a successful one with cubic radicals)
RADICAL_MATRICES = [
    ("real-quadratic", [[1, 2], [3, 4]], ("eig", "real", "geom", "diag")),
    ("rational-and-sqrt3", [[2, 1, 1], [1, 3, 0], [1, 0, 1]],
     ("eig", "real", "geom", "diag")),
    ("complex-quadratic", [[1, 1], [-1, 2]], ("eig", "real", "geom", "diag")),
    ("companion-x3-2", [[0, 0, 2], [1, 0, 0], [0, 1, 0]],
     ("eig", "real", "geom")),
    ("companion-x3-3x+1", [[0, 0, -1], [1, 0, 3], [0, 1, 0]],
     ("eig", "real", "geom")),
    ("companion-x5-x-1", [[0, 0, 0, 0, 1], [1, 0, 0, 0, 1], [0, 1, 0, 0, 0],
                          [0, 0, 1, 0, 0], [0, 0, 0, 1, 0]],
     ("eig", "real", "geom", "diag")),
    ("irreducible-cubic", [[1, -2, -2], [3, 1, 0], [2, 1, 3]],
     ("eig", "real", "geom")),
    ("two-sqrt33-blocks", [[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 1, 2],
                           [0, 0, 3, 4]], ("eig", "real", "geom", "diag")),
]


def radical_section(Matrix, capture, log, cformat, exact, rows, part):
    """One section of a matrix's eigen text through a package's ``Matrix``
    (``capture``/``log``/``cformat`` that package's; ``exact`` makes an
    integer its exact number): ``eig`` and ``real`` the logs of
    ``eigenvalues()`` and ``eigenvalues(real_only=True)``, ``geom`` one
    line ``eigenvalue & algebraic & geometric`` a root, ``diag`` the text
    of ``diagonalize()``'s result."""
    def make():
        return Matrix([[exact(x) for x in row] for row in rows])

    if part in ("eig", "real"):
        return capture(lambda: make().eigenvalues(real_only=part == "real"))
    box = []
    if part == "geom":
        capture(lambda: box.append(
            make().eigenvalues_with_geometric_multiplicities()))
        return "\n".join(r"%s & %d & %d \\" % (cformat(e), alg, geom)
                         for e, (alg, geom) in box[0].items())
    capture(lambda: box.append(make().diagonalize()))
    return capture(lambda: log(r"%s", box[0]))


def radical_text(Matrix, capture, log, cformat, exact):
    """The golden file's text: every section of ``RADICAL_MATRICES``, each
    under a ``%% name part`` line."""
    out = []
    for name, rows, parts in RADICAL_MATRICES:
        for part in parts:
            out.append(f"%% {name} {part}")
            out.append(radical_section(Matrix, capture, log, cformat, exact,
                                       rows, part))
    return "\n".join(out) + "\n"


def drive_radicals():
    """Phase 78: the exact eigen stack's cubic and binomial radicals, the
    empty root set of a quintic, eigenspaces and diagonalizations over
    Q(sqrt d) and geometric multiplicities over Q[t]/(f), written by the
    port (which imports no sympy) on this host with the Python planner
    engine and held byte for byte against ``RADICAL_GOLDEN``, which a CPU
    test holds the JAX package to.  Launches no kernel.  Returns the
    seconds."""
    import os
    import pathlib
    from fractions import Fraction

    from linalg_solver_tpu_torch.exact import Matrix
    from linalg_solver_tpu_torch.utils.fmt import cformat
    from linalg_solver_tpu_torch.utils.trace import capture_logs, log

    t0 = time.perf_counter()
    saved = os.environ.get("LINALG_TPU_NATIVE")
    os.environ["LINALG_TPU_NATIVE"] = "0"
    try:
        text = radical_text(Matrix, capture_logs, log, cformat, Fraction)
    finally:
        if saved is None:
            os.environ.pop("LINALG_TPU_NATIVE", None)
        else:
            os.environ["LINALG_TPU_NATIVE"] = saved
    golden = (pathlib.Path(__file__).resolve().parent / RADICAL_GOLDEN
              ).read_text(encoding="utf-8")
    seconds = time.perf_counter() - t0
    same = text == golden
    print(f"radicals phase 78: {len(RADICAL_MATRICES)} matrices, "
          f"{text.count('%% ')} sections, equal to {RADICAL_GOLDEN} byte "
          f"for byte: {same}, {seconds:.3f} s")
    if not same:
        got, want = text.splitlines(), golden.splitlines()
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                print(f"radicals: first difference at line {i + 1}:\n"
                      f"  port:   {a[:300]}\n  golden: {b[:300]}")
                break
        raise AssertionError(f"the radical eigen text differs from "
                             f"{RADICAL_GOLDEN}")
    return seconds


# 79. the rest of sympy's roots on the card's host, sympy, mpmath and jax
# refused
ROOTS_GOLDEN = "tests/data_torch/eigen_roots.tex"
#: (name, integer rows, exact?): an exact matrix is handed over as exact
#: numbers, the others as Python ints (a non-fraction-free AddRow then
#: makes float coefficients, as it does in the JAX package)
def _companion(coeffs):
    """The companion matrix of the monic polynomial ``coeffs`` (highest
    degree first): its characteristic polynomial."""
    n = len(coeffs) - 1
    rows = [[0] * n for _ in range(n)]
    for i in range(1, n):
        rows[i][i - 1] = 1
    for i in range(n):
        rows[i][n - 1] = -coeffs[n - i]
    return rows


ROOT_MATRICES = [
    ("float-a", [[1, 1, -5, -1], [3, 2, 1, -1], [2, 0, 4, -2],
                 [3, -3, -1, -3]], False),
    ("float-b", [[-4, 4, -1, 3], [4, -3, -1, -4], [-4, 5, 0, 2],
                 [3, -4, 0, 1]], False),
    ("float-c", [[0, 3, 2, -4], [-1, 3, -1, -4], [3, 0, 3, -2],
                 [4, 3, 4, -1]], False),
    ("ferrari-x4-x-1", _companion([1, 0, 0, -1, -1]), True),
    ("ferrari-complex-x4+x+1", _companion([1, 0, 0, 1, 1]), True),
    ("ferrari-negative-x4-3x3-x2+3x-1", _companion([1, -3, -1, 3, -1]),
     True),
    ("decompose-x4-10x2+1", _companion([1, 0, -10, 0, 1]), True),
    ("decompose-x4-2x2-2", _companion([1, 0, -2, 0, -2]), True),
    ("cyclotomic-phi5", _companion([1, 1, 1, 1, 1]), True),
    ("cyclotomic-phi9", _companion([1, 0, 0, 1, 0, 0, 1]), True),
    ("cyclotomic-phi7", _companion([1, 1, 1, 1, 1, 1, 1]), True),
    ("binomial-x5+2", _companion([1, 0, 0, 0, 0, 2]), True),
    ("binomial-x7-3", _companion([1, 0, 0, 0, 0, 0, 0, -3]), True),
    ("zassenhaus-x6-12x4+21x2-2", _companion([1, 0, -12, 0, 21, 0, -2]),
     True),
]


def roots_text(Matrix, capture, exact):
    """The golden file's text: ``eigenvalues()`` and ``eigenvalues(
    real_only=True)`` of every matrix of ``ROOT_MATRICES`` through a
    package's ``Matrix`` and ``capture``, each under a ``%% name part``
    line (``exact`` makes an integer the package's exact number)."""
    out = []
    for name, rows, is_exact in ROOT_MATRICES:
        for part in ("eig", "real"):
            conv = exact if is_exact else int
            out.append(f"%% {name} {part}")
            out.append(capture(lambda: Matrix(
                [[conv(x) for x in row] for row in rows]).eigenvalues(
                    real_only=part == "real")))
    return "\n".join(out) + "\n"


class _Refused:
    """A meta path finder that refuses to import the named packages."""

    def __init__(self, names):
        self.names = names

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"{name} is refused in this phase")
        return None


def drive_roots():
    """Phase 79: float-coefficient polynomials (``nroots``), Ferrari's
    quartic, decompositions, cyclotomic polynomials, binomials and an
    exact factorization over Z, written by the port on this host with
    sympy, mpmath, jax and the JAX package refused (their modules removed
    from ``sys.modules`` and their imports raising) and held byte for byte
    against ``ROOTS_GOLDEN``.  Launches no kernel.  Returns the seconds."""
    import os
    import pathlib
    from fractions import Fraction

    from linalg_solver_tpu_torch.exact import Matrix
    from linalg_solver_tpu_torch.utils.trace import capture_logs

    refused = ("sympy", "mpmath", "jax", "linalg_solver_tpu")
    saved_modules = {k: v for k, v in sys.modules.items()
                     if k.split(".")[0] in refused}
    for k in saved_modules:
        del sys.modules[k]
    finder = _Refused(refused)
    sys.meta_path.insert(0, finder)
    saved = os.environ.get("LINALG_TPU_NATIVE")
    os.environ["LINALG_TPU_NATIVE"] = "0"
    t0 = time.perf_counter()
    try:
        text = roots_text(Matrix, capture_logs, Fraction)
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved_modules)
        if saved is None:
            os.environ.pop("LINALG_TPU_NATIVE", None)
        else:
            os.environ["LINALG_TPU_NATIVE"] = saved
    seconds = time.perf_counter() - t0
    golden = (pathlib.Path(__file__).resolve().parent / ROOTS_GOLDEN
              ).read_text(encoding="utf-8")
    same = text == golden
    print(f"roots phase 79: {len(ROOT_MATRICES)} matrices, "
          f"{text.count('%% ')} sections with sympy, mpmath and jax "
          f"refused, equal to {ROOTS_GOLDEN} byte for byte: {same}, "
          f"{seconds:.3f} s")
    if not same:
        got, want = text.splitlines(), golden.splitlines()
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                print(f"roots: first difference at line {i + 1}:\n"
                      f"  port:   {a[:300]}\n  golden: {b[:300]}")
                break
        raise AssertionError(f"the roots text differs from {ROOTS_GOLDEN}")
    return seconds


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; there is no CPU path")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}")
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from linalg_solver_tpu_torch.ops import dispatch, rbt
    from linalg_solver_tpu_torch.ops.kernels import _build
    from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
    from linalg_solver_tpu_torch.utils import systems
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. kernel against its plain version, same diagonals, at a shape of
    # each variant (N = 100, 200 and 226: a narrower last panel)
    shapes = ((8, 64, 1), (8, 64, 8), (8, 100, 2), (8, 200, 1), (8, 226, 2),
              (B, N, 1), (8, 512, 1))
    for bsz, n, k in shapes:
        du, dv = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
        a, b = probe_batch(bsz, n, k, du, dv, dev)
        x, bad = sf.solve_fused_rbt(a, b, du, dv)
        torch.cuda.synchronize()
        x_ref, bad_ref = sf.solve_fused_rbt_reference(a, b, du, dv)
        rel, worst, abs_err, why = compare(x, bad, x_ref, bad_ref)
        flagged = bad.nonzero().flatten().tolist()
        print(f"kernel vs plain B={bsz} N={n} k={k} (variant "
              f"{sf.variant(n, k)}): max rel diff {rel:.3e} in system {worst} "
              f"(tol {TOL_KERNEL}), flagged {flagged}")
        if why is not None or not rel <= TOL_KERNEL:
            raise AssertionError(f"kernel disagrees with plain version: "
                                 f"{why or rel}")
        if flagged != FLAGGED:
            raise AssertionError(f"flagged {flagged}, expected {FLAGGED}")
        if (bsz, n, k) == (8, 64, 1):
            control = (a, b, du, dv, x_ref, bad_ref)
        if bsz == B:
            bench_abs_err = abs_err
    variants = sorted({sf.variant(n, k) for _, n, k in shapes})
    if variants != [0, 1, 2]:
        raise AssertionError(f"phase 3 reached kernel-1 variants {variants} "
                             f"only")

    # the same check must fail for a kernel without refinement: the
    # values of the small-pivot system 7 are off by >= 2e-3 before it,
    # whether or not the loose unrefined gate also flags it
    a, b, du, dv, x_ref, bad_ref = control
    x0, bad0 = sf.solve_fused_rbt(a, b, du, dv, ir_steps=0)
    rel0 = float((x0[7] - x_ref[7]).abs().max() / x_ref[7].abs().max())
    print(f"control, kernel ir_steps=0 vs plain ir_steps=2 B=8 N=64 k=1: "
          f"small-pivot system 7 max rel diff {rel0:.3e} (must exceed "
          f"{TOL_KERNEL}), flagged by the kernel {bool(bad0[7])}, by the "
          f"plain version {bool(bad_ref[7])}")
    if bool(bad_ref[7]) or not rel0 > TOL_KERNEL:
        raise AssertionError("the kernel check cannot see a kernel "
                             "without refinement")

    # 4. the main path
    a, b = bench_batch(dev)
    sf.LAUNCHES = 0
    x = dispatch.solve_batched(a, b, backend="auto")
    torch.cuda.synchronize()
    launches = sf.LAUNCHES
    resid = float(worst_resid(a, b, x).max())
    print(f"main path solve_batched(auto) B={B} N={N}: launches {launches}, "
          f"worst residual {resid:.3e} (tol {TOL_RESID}), x {tuple(x.shape)}")
    if launches < 1:
        raise AssertionError("the main path did not launch the kernel")
    if launches != 1:
        raise AssertionError("a clean batch was flagged (rescue launched)")
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        raise AssertionError("main path output has the wrong shape or non-finite values")
    if not resid <= TOL_RESID:
        raise AssertionError(f"main path residual {resid}")

    a2 = a.clone()
    a2[5, :16, :16] = 0.0     # full rank, zero leading minor: solved
    a2[9] = 0.0               # exactly singular: non-finite
    # a zero pivot under the main draw: flagged, solved by the redraw
    a2[12] = systems.pivot_system(
        a[12], *rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev)), 0.0)
    sf.LAUNCHES = 0
    x2 = dispatch.solve_batched(a2, b, backend="auto")
    torch.cuda.synchronize()
    r2 = worst_resid(a2, b, x2)
    others = [i for i in range(B) if i not in (5, 9, 12)]
    same = all(torch.equal(x2[i], x[i]) for i in others)
    print(f"rescue: launches {sf.LAUNCHES}, zero-minor system residual "
          f"{float(r2[5]):.3e}, redraw system residual {float(r2[12]):.3e}, "
          f"singular system finite={bool(torch.isfinite(x2[9]).all())}, "
          f"other systems bitwise unchanged={same}")
    if sf.LAUNCHES != 2:
        raise AssertionError("rescue did not rerun the kernel exactly once")
    if not float(r2[[5, 12]].max()) <= TOL_RESID:
        raise AssertionError("rescue left a solvable system unsolved")
    if bool(torch.isfinite(x2[9]).all()):
        raise AssertionError("singular system came back finite")
    if not same:
        raise AssertionError("the rescue changed a system it was not given")

    # 5. times at B = N = 256
    flops = B * (2.0 / 3.0 * N**3 + 2.0 * N**2)
    du, dv = rbt.default_diags(N, rbt.MAIN_SEEDS, str(dev))
    times = {
        "kernel solve_fused_rbt": cuda_time(
            sf.solve_fused_rbt, a, b, du, dv, warmup=3, iters=20),
        "plain solve_fused_rbt_reference": cuda_time(
            sf.solve_fused_rbt_reference, a, b, du, dv, warmup=1, iters=3),
        "solve_batched(auto)": cuda_time(
            dispatch.solve_batched, a, b, warmup=3, iters=20),
        "torch.linalg.solve": cuda_time(
            lambda a_, b_: torch.linalg.solve(a_, b_.unsqueeze(-1)),
            a, b, warmup=3, iters=20),
    }
    for what, t in times.items():
        print(f"time {what}: {t * 1e3:.4f} ms, {flops / t / 1e9:.2f} GFLOP/s "
              f"(B={B} N={N}, {card})")

    # 6-9. the inverse
    inv_errs = check_inverse_kernels(dev)
    inv_launches = drive_inverse_path(dev)
    gj_launches, gj_err = drive_pivoted_path(dev)
    inv_times = time_inverse(dev, card)

    # 10-13. the phase engine
    bf_err = check_phase_kernels(dev)
    check_phase_solve(dev)
    phase = drive_phase_paths(dev)
    ph_times = time_phase(dev, card, phase["solve_panels"])

    # 14-17. kernel 6 and its paths, the large-N branch
    k6_err = check_panel_kernel(dev)
    k6 = drive_panel_paths(dev)
    large_launches, large_err, large = drive_large_paths(dev)
    drive_library_routes(dev)
    k6_times = time_panel_paths(dev, card, k6["panels"], k6["det_input"],
                                large)

    # 18. kernels 3 and 2 at their large shapes; every variant's resources
    gj_large_launches, gj_large_err, gj_shapes = drive_pivoted_large(dev, card)
    inv_large_launches, inv_large_err, inv_shapes = drive_inverse_large(
        dev, card)
    print("kernel variants (registers, spill bytes, blocks an SM): "
          + json.dumps(variant_attributes()))

    # 19-22. kernel 3's big reach (variant 3) and the paths that take it,
    # the blocked RREF, the loop, the serving run, their times
    check_variant3(dev)
    big = drive_big_reach_paths(dev)
    loops, grad_launches = drive_loop_paths(dev)
    serve_launches = serving_run(dev)
    v3_shapes = time_new_paths(dev, card, big, loops)

    # 23-26. the device eigen stack (BASELINE configs 4 and 5) at
    # examples/bench_spectral.py's size, the defective control, times
    jordan = drive_jordan(dev)
    spec = drive_spectral(dev)
    eig_counts = drive_defective(dev, jordan)
    eig_shapes = time_eigen_paths(dev, card, jordan, spec)
    for c in spec["launches"].values():
        eig_counts = {k: eig_counts[k] + c[k] for k in c}
    eig_counts["gauss_jordan"] += jordan["launches"]

    # 27-31. the real Schur solver and the spectral pipeline's Schur
    # routes at the same size, the sweep eager and as a graph, times
    schur_out = drive_schur(dev)
    spec_schur = drive_schur_spectral(dev)
    schur_times, chase_shapes, window_shapes = time_schur_paths(
        dev, card, schur_out, spec_schur)
    eig_counts = {k: eig_counts[k] + spec_schur["launches"][k]
                  for k in eig_counts}

    # 32-35. serving on one GPU: BatchedSolver's lstsq, svd, rcond and
    # det_exact at full size, checked, then timed beside the library
    t0 = time.perf_counter()
    family, _ = drive_family(dev)
    time_family(dev, card, family)
    print(f"serving phase: {time.perf_counter() - t0:.2f} s")

    # 36-45. the eigenvector family: eig_batched and what is built on it,
    # at the Schur cells' width, checked on the host in float64, timed
    t0 = time.perf_counter()
    eigf = drive_eig_family(dev)
    time_eig_family(dev, card, eigf)
    print(f"eigenvector family phase: {time.perf_counter() - t0:.2f} s")

    # 46-52. ordered Schur forms (the trsyl kernel), pseudospectra, matrix
    # functions, nearness and fitting at full width, checked on the host in
    # float64, timed
    t0 = time.perf_counter()
    mf = drive_matfun(dev)
    _, trsyl_shapes = time_matfun(dev, card, mf)
    print(f"matrix-function phase: {time.perf_counter() - t0:.2f} s")

    # 53. BASELINE config 1's exact text path on this host (no sympy): the
    # native planner's build, the derivation against its golden file, both
    # planner engines, the card's pivot events replayed into LaTeX
    drive_text(dev)

    # 54. the CLI: its six exact sections on this host for three seeds,
    # byte for byte the golden files, then --device on the card
    cli_out = drive_cli(dev)

    # 55-57. the tridiagonal family: the Sturm bisection kernel, the
    # twisted factorization's vectors, cyclic reduction, randomized SVD
    t0 = time.perf_counter()
    st = drive_sturm(dev, card)
    drive_getvec(dev, card)
    drive_tridiag_rsvd(dev, card)
    print(f"tridiagonal phase: {time.perf_counter() - t0:.2f} s")
    cli_counts = {k: cli_out["counts"].get(k, 0)
                  for k in ("inv_rbt", "gauss_jordan", "butterfly",
                            "lu_nopivot", "chase", "schur_window")}

    # 58-60. the f64-class layer in float64, the complex layer on the real
    # kernels (the complex elimination kernel), the linalg namespace
    t0 = time.perf_counter()
    ddo = drive_dd(dev, card)
    cxo = drive_complex(dev, card)
    lao = drive_linalg(dev, card)
    print(f"dd, complex and linalg phases: {time.perf_counter() - t0:.2f} s")
    slice_counts = {}
    for c in (*ddo["counts"].values(), *cxo["counts"].values(),
              lao["counts"]):
        for k, v in c.items():
            slice_counts[k] = slice_counts.get(k, 0) + v
    slice_counts["complex_gauss"] += cxo["det_launches"]

    # 61-69: the rest of the LU family (the hybrid and recursive engines,
    # the pivoted rescue, lu_large's pivoted diagonal engine), the flagship
    # step's twin, the Krylov solvers, LOBPCG, Arnoldi, the structured,
    # banded, block-sparse and Kronecker solves
    t0 = time.perf_counter()
    lu21 = drive_rbt_engines(dev, card)
    graft = drive_graft(dev, card)
    kry = drive_krylov(dev, card)
    lob = drive_lobpcg(dev, card)
    arn = drive_arnoldi(dev, card)
    st21 = drive_structured(dev, card)
    bk = drive_blocksparse_kron(dev, card)
    print(f"phases 61-69: {time.perf_counter() - t0:.2f} s")
    print("phases 61-69 times (ms; lib_ms the library call beside each; "
          "dev_ms the device's share): " + json.dumps({
              "lu_family": {"ms": lu21["ms"], "lib_ms": lu21["lib_ms"]},
              "graft": {"ms": graft["ms"], "lib_ms": graft["lib_ms"]},
              "krylov": {k: kry[k] for k in ("ms", "lib_ms", "dev_ms",
                                             "reads", "iters")},
              "lobpcg": lob,
              "arnoldi": {k: arn[k] for k in ("ms", "lib_ms", "shift_ms",
                                              "shift_lib_ms", "restarts")},
              "structured": st21,
              "blocksparse_kron": {k: bk[k] for k in ("ms", "lib_ms",
                                                      "dev_ms")}}))
    # 70-77: the mesh layer on a 1-rank NCCL world
    mesh = drive_mesh(dev, card)
    print("phases 70-77 times (ms; the card's, beside the library or the "
          "unsharded call): " + json.dumps({
              "batch": mesh["batch"]["ms"], "train": mesh["train"]["ms"],
              "lu": mesh["lu"]["ms"], "tall": mesh["tall"]["ms"],
              "krylov": mesh["krylov"], "eigh": mesh["eigh"]["ms"],
              "spectral": mesh["spectral"]["ms"]}))
    # 78: the exact eigen stack's radicals, on the host
    radicals_s = drive_radicals()
    print(f"phase 78 time: {radicals_s:.3f} s")
    # 79: the rest of sympy's roots, on the host, sympy and mpmath refused
    roots_s = drive_roots()
    print(f"phase 79 time: {roots_s:.3f} s")
    new_counts = {
        "fused": graft["launches"],
        "butterfly": sum(c["butterfly"] for c in lu21["counts"].values()),
        "lu_nopivot": sum(c["lu_nopivot"] for c in lu21["counts"].values()),
        "lu_panel": sum(c["lu_panel"] for c in lu21["counts"].values()),
        "chase": arn["chase"] + bk["chase"],
        "schur_window": arn["window"] + bk["window"],
    }
    new_err = {"fused": graft["err"], "butterfly": lu21["bf_err"],
               "lu_nopivot": lu21["panel_err"], "lu_panel": lu21["k6_err"],
               "chase": max(arn["err"], bk["err"]),
               "schur_window": max(arn["err"], bk["err"])}

    # bounds from this run's shapes: bytes each input read and each output
    # written once; operations those the inputs need
    w = 2 * N_INV
    bounds = {
        "solve_fused_rbt": bound(
            4 * (B * N * N + 2 * B * N + 4 * N) + B,
            B * (2 / 3 * N**3 + 12 * N**2 + 2 * N**2 * (1 + 2 * 2))),
        "inverse_rbt_fused": bound(*inverse_work(B_INV, N_INV)),
        "gauss_jordan_tiled": bound(*pivoted_work(B_INV, N_INV, w)),
        "butterfly_two_sided": bound(4 * (2 * B * N * N + 4 * N),
                                     12 * B * N * N),
        "panel_factor_nopivot": bound(*nopivot_work(phase["solve_panels"])),
        "panel_factor_masked": bound(*panel_work(k6["panels"])),
        "francis_chase": bound(*chase_work(*schur_out["main"][:3])),
        "window_schur": (window_shapes[0]["bound_ms"],
                         window_shapes[0]["bound_by"]),
        "trsyl_masked": (trsyl_shapes[0]["bound_ms"],
                         trsyl_shapes[0]["bound_by"]),
        "sturm_bisect": (st["shapes"][1]["bound_ms"],
                         st["shapes"][1]["bound_by"]),
        "sturm_count": (st["count"]["bound_ms"], st["count"]["bound_by"]),
        "gauss_pivots_complex": (cxo["shapes"][0]["bound_ms"],
                                 cxo["shapes"][0]["bound_by"]),
    }
    rows = [{
        "name": "solve_fused_rbt",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/solve_fused.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/solve_fused_kernel.py:180",
        "launches": launches,
        "max_abs_err": bench_abs_err,
        "ms": times["kernel solve_fused_rbt"] * 1e3,
        "plain_ms": times["plain solve_fused_rbt_reference"] * 1e3,
        "library_ms": times["torch.linalg.solve"] * 1e3,
    }, {
        "name": "inverse_rbt_fused",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/inv_rbt.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/inv_rbt_kernel.py:125",
        "launches": (inv_launches + inv_large_launches
                     + eig_counts["inv_rbt"] + cli_counts["inv_rbt"]),
        "max_abs_err": max(inv_errs["inv_rbt"], inv_large_err,
                           cli_out["err"]["inv_rbt"]),
        "ms": inv_times["kernel inverse_rbt_fused, device"] * 1e3,
        "host_ms": inv_times["kernel inverse_rbt_fused"] * 1e3,
        "plain_ms": inv_times["plain inverse_rbt_fused_reference"] * 1e3,
        "library_ms": inv_times["torch.linalg.inv"] * 1e3,
        "large_shapes": inv_shapes,
    }, {
        "name": "gauss_jordan_tiled",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/gauss_jordan.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/gj_kernel.py:55",
        "launches": (gj_launches + gj_large_launches + big["launches"]
                     + grad_launches + serve_launches
                     + eig_counts["gauss_jordan"]
                     + cli_counts["gauss_jordan"]),
        "max_abs_err": max(inv_errs["gauss_jordan"], gj_err, gj_large_err,
                           cli_out["err"]["gauss_jordan"]),
        "ms": inv_times["kernel gauss_jordan_tiled [A|I]"] * 1e3,
        "plain_ms": inv_times["plain gauss_jordan_reference [A|I]"] * 1e3,
        "library_ms": inv_times["torch.linalg.inv"] * 1e3,
        "large_shapes": gj_shapes + v3_shapes + eig_shapes,
    }, {
        "name": "butterfly_two_sided",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/butterfly.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/butterfly_kernel.py:91",
        "launches": (phase["butterfly_launches"] + large_launches
                     + eig_counts["butterfly"] + mf["counts"]["butterfly"]
                     + cli_counts["butterfly"]),
        "max_abs_err": max(bf_err, phase["butterfly_err"], large_err,
                           spec_schur["bf_err"], mf["bf_err"]),
        "ms": ph_times["kernel butterfly_two_sided, device"] * 1e3,
        "host_ms": ph_times["kernel butterfly_two_sided"] * 1e3,
        "plain_ms": ph_times["plain butterfly_two_sided_reference"] * 1e3,
        "library_ms": None,
        "matfun_launches": {k: v["butterfly"]
                            for k, v in mf["launches"].items()
                            if v["butterfly"]},
    }, {
        "name": "panel_factor_nopivot",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/lu_nopivot.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/lu_nopivot_kernel.py:41",
        "launches": (phase["panel_launches"] + eig_counts["lu_nopivot"]
                     + mf["counts"]["lu_nopivot"] + cli_counts["lu_nopivot"]),
        "max_abs_err": max(phase["panel_err"], spec_schur["panel_err"],
                           mf["panel_err"]),
        "ms": ph_times[
            "kernel panel_factor_nopivot, the 8 solve panels, device"] * 1e3,
        "host_ms": ph_times[
            "kernel panel_factor_nopivot, the 8 solve panels"] * 1e3,
        "plain_ms": ph_times[
            "plain panel_factor_nopivot_reference, the 8 solve panels"] * 1e3,
        "library_ms": ph_times[
            "library lu_factor_ex(pivot=False), the 8 solve panels"] * 1e3,
        "matfun_launches": {k: v["lu_nopivot"]
                            for k, v in mf["launches"].items()
                            if v["lu_nopivot"]},
    }, {
        "name": "panel_factor_masked",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/lu_panel.cu",
        "replaces": "linalg_solver_tpu/ops/pallas/lu_panel_kernel.py:49",
        "launches": k6["launches"] + mf["counts"]["lu_panel"],
        "max_abs_err": max(k6_err, k6["err"], mf["k6_err"]),
        "ms": k6_times[
            "kernel panel_factor_masked, the 4 mixed-path panels"] * 1e3,
        "plain_ms": k6_times[
            "plain panel_factor_masked_reference, the 4 panels"] * 1e3,
        "library_ms": k6_times[
            "library lu_factor_ex on the unpivoted rows, the 4 panels"] * 1e3,
    }, {
        "name": "francis_chase",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/schur_chase.cu",
        # no Pallas kernel: the XLA scan of _chase_step (schur.py:869-891)
        "replaces": "linalg_solver_tpu/ops/schur.py:893",
        "launches": (schur_out["launches"] + spec_schur["chase"]
                     + eigf["chase"] + mf["counts"]["chase"]
                     + cli_counts["chase"]),
        "max_abs_err": max(schur_out["err"], spec_schur["err"],
                           eigf["err"], cli_out["err"]["chase"]),
        "ms": chase_shapes[0]["ms"],
        "plain_ms": chase_shapes[0]["plain_ms"],
        "library_ms": None,
        "large_shapes": chase_shapes,
        "sweep_eager_ms": schur_times["sweep eager"] * 1e3,
        "sweep_graph_ms": schur_times["sweep graph"] * 1e3,
        "eig_family_launches": {k: v["chase"]
                                for k, v in eigf["launches"].items()},
        "matfun_launches": {k: v["chase"] for k, v in mf["launches"].items()
                            if v["chase"]},
    }, {
        "name": "window_schur",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/schur_window.cu",
        # no Pallas kernel: the AED round's lax.while_loop (schur.py:571-597)
        "replaces": "linalg_solver_tpu/ops/schur.py:586",
        "launches": (schur_out["window"]
                     + spec_schur["launches"]["schur_window"]
                     + eigf["window"] + mf["counts"]["schur_window"]
                     + cli_counts["schur_window"]),
        "max_abs_err": max(schur_out["err"], spec_schur["err"],
                           eigf["err"]),
        "ms": window_shapes[0]["ms"],
        "plain_ms": window_shapes[0]["plain_ms"],
        "library_ms": None,
        # the bound counts the steps the dead-step rule leaves to run; the
        # bound on every step of every sweep beside it
        "live_steps": window_shapes[0]["live_steps"],
        "all_steps": window_shapes[0]["all_steps"],
        "bound_ms_all_steps": window_shapes[0]["bound_ms_all_steps"],
        "large_shapes": window_shapes,
        "eig_family_launches": {k: v["window"]
                                for k, v in eigf["launches"].items()},
        "matfun_launches": {k: v["schur_window"]
                            for k, v in mf["launches"].items()
                            if v["schur_window"]},
    }, {
        "name": "trsyl_masked",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/trsyl.cu",
        # no Pallas kernel: the nested XLA scans of _trsyl_masked
        # (ordschur.py:637, :649)
        "replaces": "linalg_solver_tpu/ops/ordschur.py:510",
        "launches": mf["counts"]["trsyl"],
        "max_abs_err": mf["err"],
        "ms": trsyl_shapes[0]["ms"],
        "plain_ms": trsyl_shapes[0]["plain_ms"],
        "library_ms": None,
        "large_shapes": trsyl_shapes,
        "matfun_launches": {k: v["trsyl"] for k, v in mf["launches"].items()
                            if v["trsyl"]},
    }, {
        "name": "sturm_bisect",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/sturm.cu",
        # no Pallas kernel: the XLA while loop of the bisection
        # (sturm.py:113-123) around the scan of sturm_count_batched (:60-77)
        "replaces": "linalg_solver_tpu/ops/sturm.py:87",
        "launches": st["launches"],
        "max_abs_err": st["err"],
        "ms": st["shapes"][1]["ms"],
        "plain_ms": st["shapes"][1]["plain_ms"],
        "library_ms": st["shapes"][1]["library_ms"],
        "large_shapes": st["shapes"],
        "cli_launches": cli_out["counts"],
    }, {
        "name": "sturm_count",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/sturm.cu",
        # no Pallas kernel: the XLA scan of the count (sturm.py:60-77)
        "replaces": "linalg_solver_tpu/ops/sturm.py:41",
        "launches": st["count"]["launches"],
        "max_abs_err": st["count"]["err"],
        "ms": st["count"]["ms"],
        "plain_ms": st["count"]["plain_ms"],
        "library_ms": None,
        "shape": st["count"]["shape"],
        "float64_ms": st["count"]["float64_ms"],
    }, {
        "name": "gauss_pivots_complex",
        "route": "cuda",
        "source": "linalg_solver_tpu_torch/csrc/complex_gauss.cu",
        # no Pallas kernel: the XLA fori_loop of _gauss_pivots_complex
        # (complexlin.py:73-132)
        "replaces": "linalg_solver_tpu/ops/complexlin.py:61",
        "launches": slice_counts["complex_gauss"],
        "max_abs_err": cxo["err"],
        "ms": cxo["shapes"][0]["ms"],
        "plain_ms": cxo["shapes"][0]["plain_ms"],
        "library_ms": cxo["shapes"][0]["library_ms"],
        "large_shapes": cxo["shapes"],
    }]
    # the launches of phases 58-60 on the kernels of earlier slices
    for row, key in (("solve_fused_rbt", "fused"),
                     ("inverse_rbt_fused", "inv_rbt"),
                     ("gauss_jordan_tiled", "gauss_jordan"),
                     ("butterfly_two_sided", "butterfly"),
                     ("panel_factor_nopivot", "lu_nopivot"),
                     ("panel_factor_masked", "lu_panel"),
                     ("francis_chase", "chase"),
                     ("window_schur", "schur_window")):
        r = next(x for x in rows if x["name"] == row)
        r["launches"] += slice_counts[key]
        r["dd_complex_linalg_launches"] = slice_counts[key]
    # the launches of phases 61-69 on the kernels they run
    for row, key in (("solve_fused_rbt", "fused"),
                     ("butterfly_two_sided", "butterfly"),
                     ("panel_factor_nopivot", "lu_nopivot"),
                     ("panel_factor_masked", "lu_panel"),
                     ("francis_chase", "chase"),
                     ("window_schur", "schur_window")):
        r = next(x for x in rows if x["name"] == row)
        r["launches"] += new_counts[key]
        r["phases_61_69_launches"] = new_counts[key]
        r["max_abs_err"] = max(r["max_abs_err"], new_err[key])
    # the launches of phases 70-77 (the mesh) on the kernels they run
    mesh_err = {**mesh["batch"]["err"], "chase": mesh["spectral"]["err"],
                "schur_window": mesh["spectral"]["err"]}
    mesh_err["fused"] = max(mesh_err["fused"], mesh["dryrun"]["fused_err"])
    for row, key in (("solve_fused_rbt", "fused"),
                     ("inverse_rbt_fused", "inv_rbt"),
                     ("gauss_jordan_tiled", "gauss_jordan"),
                     ("butterfly_two_sided", "butterfly"),
                     ("panel_factor_nopivot", "lu_nopivot"),
                     ("panel_factor_masked", "lu_panel"),
                     ("francis_chase", "chase"),
                     ("window_schur", "schur_window")):
        r = next(x for x in rows if x["name"] == row)
        r["launches"] += mesh["counts"][key]
        r["mesh_launches"] = mesh["counts"][key]
        r["max_abs_err"] = max(r["max_abs_err"], mesh_err.get(key, 0.0))
    k6 = next(x for x in rows if x["name"] == "panel_factor_masked")
    k6["max_abs_err"] = max(k6["max_abs_err"], ddo["k6_err"])
    for row in rows:
        row["bound_ms"], row["bound_by"] = bounds[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
