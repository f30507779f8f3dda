#!/usr/bin/env python3
"""GPU smoke run of goma_tpu_torch, the PyTorch/CUDA port of goma_tpu.

    python3 chip_smoke.py

Needs one CUDA device (NVIDIA H100, sm_90a) and nvcc; exits non-zero on any
failure and when CUDA is unavailable. Fifty-two main paths of the three
kernels, each read with its own launch counts: the cavity's ``gmres+ndlu`` (phases 2-6) and
``tpu_direct`` (phases 8-10), the buoyant-convection deck's ``gmres+ndlu``
(phases 12-13), the viscoelastic channel's ``gmres+ndlu`` (phase 15),
``tpu_direct`` (phase 16) and transient start-up (phase 17), the
level-set static bubble's ``gmres_ndlu`` (phase 19) and ``tpu_direct``
(phase 20) rungs on the transient driver, the cavity's pipelined and
sequential Newton loops (phase 21), the ALE slot coater's ``gmres_ndlu``
(phase 23) and ``tpu_direct`` (phase 24) rungs on the quality-guarded
adaptive driver, and the buoyant deck's ``tpu_direct`` rung (phase 25);
the axisymmetric die deck's ``gmres_ndlu`` (phase 30) and ``tpu_direct``
(phase 31) rungs; the tilted cavity's (phases 33-34) and the periodic
channel's (phases 36-37) two rungs; the lid-speed continuation of the
64x64 cavity on both rungs (phases 39-40) and its augmenting condition
(phase 41); the 96x48 immersed cylinder (overset multipliers) on both
rungs (phases 45-46); the 64x64 thermal slider bearing (phase 48) and
drying film (phase 49) on 3D surface shells, each on both rungs; the
128x128 edge-element cavity (phase 51) and the 160x32 nodal waveguide
(phase 52), each on both rungs; the 128x64 conforming FSI column (phase
54) and the 128x128 Richards infiltration (phase 55), each on both rungs;
the 128x32 suspension channel (phase 57) and the 96x24 reacting wall
channel (phase 58), each on both rungs; the 96x48 laser melt pool (phase
60) and wetting drop (phase 61), each on both rungs; the 96x96
projection cavity (phase 63) and the 48x48 buoyant cavity split into
three matrices (phase 64), each on both rungs; the cylinder on pivoted
fronts, the cavity on a tree mixing kernel and pivoted levels and the
recycled two-level cavity (phase 66);
the bordered solver's ``ndlu`` base on the 20x10
cylinder (phase 47) is read the same way as a cross-check, not a main
path; then goma_tpu's other preconditioners and linear
solvers, which run no hand kernel (their stages are torch ops): every
option on the 8x8 cavity (phase 26), the two-level preconditioner on the
64x64 cavity (phase 27) and the 48x48 buoyant deck (phase 28), and the
host ``direct`` rung on the 48x48 static bubble (phase 29); small axisymmetric, property-model and
post-processing decks on cuda and cpu (phase 32); ``Problem.residual``
against ``Problem.assemble`` and the numerical-Jacobian check on the card
(phase 35); small decks of the strong conditions on cuda and cpu (phase
38); the flux sensitivity (phase 42), the Bratu fold (phase 43) and the
bifurcation and stability decks (phase 44) on the host ``direct`` solves
and SciPy eigensolves goma_tpu runs them on, their assembly and
derivative actions on the card. Every ``gmres`` deck with
``tol_update == 0`` runs the pipelined Newton loop, as in goma_tpu; the
buoyant, viscoelastic and cavity phases hold goma_tpu's linear iteration
counts under it. Phases:

1. build every kernel, one nvcc per source, all started together: the
   front LU ``goma_tpu_torch/csrc/batched_lu.cu``, the front substitution
   ``goma_tpu_torch/csrc/batched_trsv.cu`` and the front gather
   ``goma_tpu_torch/csrc/front_gather.cu`` (sm_90a); print each build time
   and ptxas report (phase 7's build is this one); the CPU side (see
   ``start_cpu_side``) starts and phase 2 runs while nvcc does;
2. set up the main deck: the Re=100 lid-driven cavity on a 64x64 QUAD9 mesh
   (Q2/Q1, 37,507 dof), float32 Jacobian, the ``gmres+ndlu`` options;
3. hold the kernel against its plain PyTorch twin on the card, float32 and
   float64, at every nested-dissection level shape (nn fronts of size m)
   of that deck, on random fronts whose zero, tiny and negative pivots make
   the static-pivot boost fire; check the kernel's launch plan (cluster
   size, threads, shared memory) against the wrapper's ``_plan``; print
   each level's plan, errors and the median CUDA-event ms of the kernel,
   the twin and ``lu_factor_ex(pivot=False)`` beside the bound.
   Then the real fully-summed block of every ND level, built on the card
   from the deck's CSR values and the children's Schur complements as
   ``NDLU.factor`` builds it, at the state the main path factors;
4. solve the 8x8 cavity on the GPU and on the CPU with the same options and
   require the same Newton iteration count;
5. the main path: one warm-up Newton solve, ``reset_lagged()``, one timed
   solve; require convergence to 1e-6, that every ND level of every
   factorization went through the front-LU and front-gather kernels
   (launch counters), and the Ghia et al. (1982) Re=100 centerline
   velocity;
6. kernel vs twin again on every level's real fronts, at the converged
   state; one factorization of the tree split into gather, extend-add,
   front LU and inverses + Schur (CUDA events, ``factor_split_ms``);
8. the substitution kernel against its twin, float32 and float64, lower and
   upper, at all 9 ND level shapes of the ``tpu_direct`` deck: the real
   packed LUs of its factorization at x = 0, with the real own-segments of
   one solve and with seeded random right-hand sides; check the kernel's
   launch plan against the wrapper's ``_plan`` on every call; print each
   level's plan, errors, the median CUDA-event ms of the kernel, its loop
   twin and ``torch.linalg.solve_triangular``, and the profiler's device ms
   of kernel and library beside the bound (on no level may the kernel take
   more device time than the library, both timed by CUDA-graph replay for
   this gate); in total also the host time per
   call; then the device time of one dependent step (the slope between two
   single fronts) and the chain floor it gives one solve;
9. solve the 8x8 cavity with ``tpu_direct`` on the GPU and on the CPU and
   require the same Newton count and x within phase 4's bound;
10. the ``tpu_direct`` main path on the 64x64 deck (``bench._cavity_opts(
    "tpu_direct")``): one warm-up solve, ``reset_lagged()``, one timed solve;
    require convergence to 1e-6, the Ghia check, that every substitution of
    the timed solve ran the kernel at every level (2 x levels x solves) and
    every factorization the front-LU and front-gather kernels (levels x
    factorizations each), and
    that x agrees with phase 5's ``gmres+ndlu`` solution; print each
    iteration's refinement sweeps, relative residual and fresh or lagged
    factor, the asm/slv buckets, s/iteration, and one factorization split
    as in phase 6;
11. the front-gather kernel against its plain version on every level's
    real slot map of both 64x64 trees, float32 and float64 values, and on a
    map with indices out of range: exact (max |diff| = 0). Then, per
    factorization of each tree, the CUDA-event and profiler device ms of
    the kernel, its plain version, ``torch.index_select`` (one library call
    computing the same function on these in-range maps) and the
    scatter-set that ``NDLU.front`` ran before (timed here only), beside
    the byte bound and the maps' device memory;
12. the buoyant-convection deck (bench.bench_buoyant, BASELINE config #2:
    momentum + continuity + energy + species, the generic AD assembly) at
    8x8 on cuda and on cpu: the same Newton count, x within a stated bound;
13. the buoyant main path at 48x48 (40,037 dof), bench.py's options:
    the front-LU kernel against its twin on the real fronts of every level
    of its tree (m up to 437) at x = 0, and on random boosted fronts at its
    9 level shapes with the kernel, ``lu_factor_ex`` and bound timed as in
    phase 3; the factorization split of phase 6; the substitution kernel as
    in phase 8 on the 18 substitutions of one solve of an
    ``NDLU(invert=False)`` built on the same pattern and ordering (the same
    tree, m up to 437; every level's packed LU kept); one warm-up solve,
    ``reset_lagged()``, one timed solve; require
    convergence to 1e-6 in 6 +- 1 Newton iterations (goma_tpu's record),
    and front-gather and front-LU launches = levels x factorizations; print
    the ND levels, norms, linear iterations, asm/slv and s/iteration, and
    the gather times of phase 11 on its tree;
14. the viscoelastic channel (bench.bench_viscoelastic, BASELINE config #4:
    EVSS-F/DEVSS Oldroyd-B, Wi ~ 1.5, the generic AD assembly with 50 local
    dofs) at 8x4 on cuda and on cpu, ``gmres+ndlu`` and ``tpu_direct``
    with bench.py's options: the same Newton count, x within a stated bound;
15. the viscoelastic ``gmres+ndlu`` main path at 64x32 (33,930 dof): the
    front-LU kernel against its twin on the real fronts of every level of
    its tree (s up to 604) at x = 0 and at the converged state, with each
    level's growth and boosted pivots; random boosted fronts at its 9 level
    shapes (kernel, twin, ``lu_factor_ex``, bound); the factorization split; the
    gather exact and timed as in phase 11; one warm-up solve,
    ``reset_lagged()``, one timed solve; require convergence to 1e-8 in
    5 +- 1 Newton iterations (goma_tpu's record) and front-gather and
    front-LU launches = levels x factorizations; print the ND levels, norms,
    linear iterations, asm/slv, s/iteration and where an iteration's time
    goes (prep, CSR values, factorization, apply: ms, and kernels a call
    but for the CSR values);
16. the viscoelastic ``tpu_direct`` main path at 64x32: the substitution
    kernel as in phase 8 on the 18 substitutions of one solve (m up to 604),
    with the device ns per dependent step at the two top levels; the front
    LU on that tree's real fronts; one warm-up solve, ``reset_lagged()``,
    one timed solve; require convergence to 1e-8, substitution launches =
    2 x levels x solves, front-LU and front-gather launches = levels x
    factorizations, and x within a stated bound of phase 15's;
17. the transient start-up through ``TransientSolver``: the deck with
    ``transient=True`` on Momentum and VEStress, x0 = 0, backward Euler
    dt 0.05 to t = 0.25 without adaptation, phase 15's Newton options; at
    8x4 on cuda and on cpu (the same Newton count in every step, x within
    phase 14's bound), then at 64x32: require 5 accepted steps of dt 0.05,
    each converged, and front-LU and front-gather launches = levels x
    factorizations; print every step record, the factorizations and s per
    Newton iteration;
18. the level-set static bubble (bench.bench_two_phase, BASELINE config
    #5: transient Momentum, Continuity, CSF surface tension, the level-set
    advection; the generic AD assembly) at 8x8 on cuda and on cpu, both
    rungs, two backward-Euler steps of dt 0.02: the same Newton count in
    every step, x within a stated bound;
19. its ``gmres_ndlu`` rung at 48x48 (30,628 dof), bench.py's options and
    timing (``bench._transient_sec_per_iter``: a warm leg over [0, 0.04],
    then ``reset_lagged()`` and the timed leg to 0.08 from the warm leg's
    x, t and xdot): the front LU on its real fronts at the initial state
    and at the end state (growth, floor, limit), random boosted fronts at
    its 8 level shapes (kernel, twin, ``lu_factor_ex``, bound), the gather
    exact and timed; require 2 converged timed steps, front-LU and
    front-gather launches = levels x factorizations and the Laplace jump
    within 8% of sigma / r0 = 2; print steps, Newton and linear
    iterations per step, factorizations, s/iteration, asm/slv and dp;
20. its ``tpu_direct`` rung on the same problem: the substitution kernel
    as in phase 8 on the 16 substitutions of one solve; the two legs;
    require substitution launches = 2 x levels x solves, front-LU and
    front-gather launches = levels x factorizations, and the end state
    within a stated bound of phase 19's;
21. the 64x64 cavity's ``gmres+ndlu`` deck through the pipelined loop
    (``solve``) and through ``_solve_sequential``, in turns: linear
    iterations [1, 12, 12, 10] in each, norm sequences within a stated
    relative bound; print s/iteration, host syncs per Newton iteration
    (``torch.cuda.set_sync_debug_mode("warn")``) and discarded speculative
    solves of each;
22. the ALE slot coater (examples/slot_coater.py::build and
    bench.bench_slot_coater, BASELINE config #3: transient Momentum,
    Continuity and elliptic mesh motion, capillary and kinematic face
    kernels on the free surface, the quality-guarded adaptive driver) at
    16x4 on cuda and on cpu: the golden deck of
    tests/golden/newton_trace_slot_coater.json on ``tpu_direct`` (accepted
    steps Newton [8, 8, 8, 6, 5], the second attempt failed and halved) and
    bench.py's ``gmres_ndlu`` rung over the warm leg: the same attempts on
    both devices, x within a stated bound;
23. its ``gmres_ndlu`` rung at 96x24 (40,253 dof, 40 local dofs, 60
    free-surface faces), bench.py's options: the front LU on its real
    fronts at the first and the last factorization (growth, boosted
    pivots, floor, limit), random boosted fronts at its 9 level shapes
    (kernel, twin, ``lu_factor_ex``, bound), the gather exact and timed,
    one factorization split; bench.py's warm leg [0, 0.04], then
    ``reset_lagged()`` and the timed leg to 0.08: every attempt printed
    (t, dt, accepted / rejected by error / failed Newton / rejected by
    quality, Newton and linear iterations, min detJ), the factorizations,
    discarded speculative solves, asm/slv and bench's s/iteration; require
    goma_tpu's accepted steps in each leg (Newton +-1 each, every one
    converged), min detJ > 0 at the end, the free-surface heights at ten x
    positions within a stated bound of goma_tpu's, and front-LU and
    front-gather launches = levels x factorizations;
24. its ``tpu_direct`` rung (the deck's own options, leaf 96: its own
    10-level tree, 20 substitutions a solve): the substitution kernel as in
    phase 8 on the 20 substitutions of one solve, with the device ns per
    dependent step at the levels above m = 500; the front LU on its real
    fronts at the first and the last factorization; the gather exact and
    timed; the factorization split; the same legs, prints and checks as
    phase 23, and substitution launches = 2 x levels x solves;
25. the 48x48 buoyant deck on bench.py's ``tpu_direct`` rung (leaf 256):
    6 +- 1 Newton iterations, the launch counts of phase 10, x within a
    stated bound of phase 13's ``gmres+ndlu`` solution;
26. the 8x8 cavity (float64, tol 1e-8) with each of goma_tpu's other
    preconditioners and solvers (``SMALL_OPTIONS``: auto, two-level with
    either smoother or the ``"inv"`` coarse solve, block Jacobi,
    FieldSplit, PCD, BiCGStab, host direct, bf16 storage) on cuda and on
    cpu: the same Newton count, linear iterations per step within a
    stated bound, x within phase 4's bound; each printed beside
    goma_tpu's counts;
27. the 64x64 cavity on bench.py's ``twolevel`` kind (float32 Jacobian,
    Vanka smoother, one sweep, restart 240): one warm-up solve,
    ``reset_lagged()``, one timed solve; require convergence to 1e-6,
    goma_tpu's Newton count +-1 (``TWOLEVEL_REF``, from
    scripts/twolevel_reference.py), the same linear iterations in both
    solves (the Galerkin sum is deterministic) and x within a stated
    bound of phase 5's; print s/iteration, the buckets, the linear
    iterations, factorizations, host syncs per Newton iteration, one
    factorization split (Vanka inverses, Galerkin coarse build, coarse LU)
    and one apply split (smoother, restrict + prolong, coarse solve,
    operator) by CUDA events, the kernels of one apply, one coarse solve
    by LU against the explicit float32 inverse (CUDA events and graph
    replay, each beside its byte bound) and torch's peak memory;
28. the same for the 48x48 buoyant deck on bench.py's third rung (restart
    160, maxiter 1000), one solve, 6 +- 1 Newton iterations, x against
    phase 13's;
29. the 48x48 static bubble on the host ``direct`` rung
    (bench.bench_two_phase("direct"): float64 prep, SuperLU on the host),
    phase 19's legs: 2 converged steps a leg with phase 19's Newton count
    +-1 each, the Laplace jump within 8% of 2, the end state within a
    stated bound of phase 19's; s/iteration printed;
30. the axisymmetric die deck (examples/axisym_die_swirl.py::run restated:
    Momentum, SwirlMomentum, Continuity and Energy in swirling
    coordinates, 40 local dofs) at 64x32 (35,685 dof) on ``gmres_ndlu``
    (float32 Jacobian, leaf 192, tol 1e-9): the front LU on its real
    fronts at x = 0 and at the converged state, random boosted fronts at
    its 9 level shapes (kernel, twin, ``lu_factor_ex``, bound), the
    factorization split, the gather exact and timed; one warm-up solve,
    ``reset_lagged()``, one timed solve; require goma_tpu's Newton count
    +-1 (``AX_REF_NEWTON``, from scripts/axisym_reference.py), the
    centre-line u_z within ``AX_UZ_TOL`` and the wall heat flux and the
    outlet flow rate (``post.sideset_integral``) within ``AX_INT_RTOL`` of
    goma_tpu's, and front-LU and front-gather launches = levels x
    factorizations; print s/iteration, the linear counts beside goma_tpu's,
    asm/slv, the launches by kind and where an iteration's time goes;
31. its ``tpu_direct`` rung (leaf 192, ``ndlu_refine=1``): the
    substitution kernel as in phase 8 on the 18 substitutions of one solve
    (against ``solve_triangular`` by graph replay), the front LU on the
    real fronts, the gather exact; the same solves, prints and gates as
    phase 30, substitution launches = 2 x levels x solves, and x within
    ``AX_PATHS_TOL`` of phase 30's;
32. on cuda and on cpu, the same Newton count and x within ``AX_X_TOL``:
    the 12x10 die deck on both rungs, the axisymmetric Oldroyd-B pipe of
    tests/test_axisym_ve.py (``AxisymHoopStress``), the power-law channel
    of tests/test_more_physics.py, the axisymmetric linear-elastic
    dilation of tests/test_axisym.py (each also against its exact
    solution) and the 8x8 cavity; ``post.stream_function`` of the cavity's
    cpu velocity on both devices, psi within 1e-9;
33. the 64x64 cavity tilted by 30 degrees (tests/test_rotation.py's deck:
    every wall a rotated normal/tangent constraint, the lid's tangent
    velocity -1; 512 rotated nodes, 1,024 constraint rows, the cavity's
    own pattern and tree) on phase 5's ``gmres_ndlu`` options: the front
    LU on its real fronts at x = 0 and at the converged state, random
    boosted fronts at its 9 level shapes (kernel, twin, ``lu_factor_ex``,
    bound), the factorization split, the gather exact and timed; one
    warm-up solve, ``reset_lagged()``, one timed solve and one more
    (s/iteration over two calls); require goma_tpu's record
    (``TILT_REF``, from scripts/rotation_reference.py: Newton +-1, each
    step's linear iterations within REF_LIN_TOL, x at 24 sampled dofs
    within REF_X_TOL), front-LU and front-gather launches = levels x
    factorizations, and phase 5's solution rotated into the tilted frame
    within TILT_AXIS_TOL (Newton within 1 of phase 5's); print where an
    iteration's time goes (kernels a prep);
34. its ``tpu_direct`` rung (phase 10's options): the substitution kernel
    as in phase 8 on the 18 substitutions of one solve, the front LU on
    the real fronts, the gather exact, the factorization split; the same
    solves and gates as phase 33 with substitution launches = 2 x levels
    x solves, and x within BC_PATHS_TOL of phase 33's;
35. ``Problem.residual`` (the residual-only pass) against ``assemble``'s R
    and the vals-free prep's R, float64, at x = 0 and at the converged
    state of the 64x64 cavity and the tilted cavity: within RESID_RTOL,
    the three timed; a prep's and a matvec's kernels on each deck (what
    the rotated rows add); ``utils.numjac`` on a 16x16 tilted cavity on
    the card: ``ok``;
36. the 64x32 x-periodic Poiseuille channel (tests/test_periodic.py's
    deck: body force, convection on, 65 slave nodes sharing their roots'
    dofs, an 8-level aliased tree) on ``gmres_ndlu``: the level shapes
    (every separator 1 < s <= 1000) and the kernels on the tree as in
    phase 33; the same solves; goma_tpu's record (``PER_REF``: Newton
    +-1 and x; the linear counts printed beside goma_tpu's [240, 2], not
    gated: the first GMRES solve stagnates in every run and stops where
    the stagnation test fires), u within PER_U_TOL of G y (1 - y) /
    (2 mu), v within PER_V_TOL;
37. its ``tpu_direct`` rung, as phase 34 runs the tilted cavity's, with
    the profile checks;
38. on cuda and on cpu, float64, the same Newton count and x within
    BC_X_TOL: the slip-wall channel, the two mesh-sliding point-constraint
    decks (the plane also on ``gmres`` + NDLU), a point-load deck (host
    direct and ``gmres``), a row-injection deck on ``gmres`` (its solver
    takes the ELL operator, never the element matvec), a
    parametric-Dirichlet deck, the doubly periodic corner chain, the 3-D
    HEX27 manufactured Navier-Stokes deck and a transient conduction run
    with ``variable_stats=True``;
39. the continuation deck: the 64x64 cavity (37,507 dof, the cavity's own
    pattern and tree) with mu 0.01 and the lid's u the parametric
    Dirichlet value params["U"] (Re = 100 U), continued by
    ``continue_problem(make_params, 1.0, 4.0, dlam0=0.5, x0=0,
    first_order=True)`` on phase 5's ``gmres_ndlu`` options, every count
    set to 0 just before and read just after: each step's U, Newton and
    predictor linear iterations beside goma_tpu's record (``CONT_REF``,
    from scripts/continuation_reference.py), s, factorizations and
    launches; require goma_tpu's accepted U sequence, Newton +-1 a step,
    the predictor counts within REF_LIN_TOL or CONT_PRED_RTOL, x at 24
    sampled dofs of every step within REF_X_TOL, the minimum of u/U on
    x = 0.5 at U = 4 within 2% of Ghia et al.'s Re 400 value (-0.32726),
    every dR/dU by the exact jvp route (``_dR_dlam.routes``), front-LU and
    front-gather launches = levels x factorizations; then each kernel
    against its plain version on the fronts of the run's last
    factorization;
40. the same on phase 10's ``tpu_direct`` options (its predictor solves
    GMRES on the two-level preconditioner ``precond="auto"`` names, as
    goma_tpu's does), with substitution launches = 2 x levels x solves and
    the substitution kernel on a solve with the last factor;
41. the augmenting condition on phase 39's deck (``gmres_ndlu``,
    ``linear_tol=1e-8``): U such that u at the node nearest (0.5, 0.2813)
    equals goma_tpu's value at U = 3, from the accepted step below 3;
    require U within CONT_AC_TOL of 3 and of goma_tpu's, Newton +-1, the
    launches of phase 39;
42. dF/dU of the lid's x-traction at U = 4 (``post.flux_sensitivity``, the
    state polished by host ``direct`` solves to 1e-10): within
    CONT_FLUX_RTOL of goma_tpu's and of the central difference over two
    direct solves at U +- 1e-3, by the exact route;
43. the Bratu turning point on the 64x64 QUAD9 square (16,641 dof, the
    generic AD assembly and nested jvps on the card, host ``direct``
    solves): first-order continuation 0 -> 6, ``arclength_continue``
    around the fold, ``detect_folds``, ``fold_track``; goma_tpu's branch,
    lam_c within CONT_FOLD_TOL of goma_tpu's and 0.02 of 6.808;
44. pitchfork (lambda* = pi^2 within 1e-3) and Hopf (b* = 1 + a^2,
    omega = a within 1e-8) at tests/test_bifurcation2.py's sizes; the
    growth rates of examples/rayleigh_benard_3d_stability.py::sweep(Ra=700)
    and examples/film_stability.py::run() restated (the film's eigensolves
    from scripts/arpack_start.py's start vector, as goma_tpu's record), of
    the plane-Couette 3D-of-2D driver and of ``solve_stability_device`` on
    the 8x8 heat spectrum, each within CONT_SIG_RTOL of goma_tpu's;
45. the immersed cylinder (examples/immersed_cylinder.py's problem restated:
    QUAD9 on [0, 2] x [0, 1], Stokes, a BAR circle of 134 segments carrying
    P0 multipliers, 42,463 dof, the float32 Jacobian) under
    bench._cavity_opts("gmres+ndlu", tol=1e-9, max_iter=10): the finalize
    and overset-set setup times; the ND tree against goma_tpu's record
    (``OVS_REF``, from scripts/overset_reference.py) before any solve; the
    kernels on its real fronts at x = 0 (the multiplier rows go last in
    their fronts and the GESP boost fires on their zero pivots), the
    front LU at the tree's level shapes, the gather exact and timed, the
    factorization split; one warm-up solve, ``reset_lagged()``, one timed
    solve; goma_tpu's Newton +-1, linear iterations, x at 24 dofs within
    REF_X_TOL, the drag (the multipliers' x-traction times the segment
    length) within OVS_DRAG_RTOL; launches = levels x factorizations; the
    front LU and the gather on the fronts of the run's last factorization;
46. the same on ``tpu_direct`` (phase 10's options at tol 1e-9), with the
    substitution kernel on one solve's substitutions at x = 0 and on the
    last factorization, and substitution launches = 2 x levels x solves;
47. on cuda and on cpu: the example's own 20x10 deck on host ``direct``,
    on ``gmres`` with ``precond="auto"`` (the constraint-aware Vanka) and
    bordered on the ``ndlu`` base (substitution launches = 2 x levels x
    base solves on the card, x within 1e-6 of the monolithic solve); the
    two-layer contact resistance, the DG stress decay channel, the HEX27
    edge line source and the FILL_CA wetting deck: the same Newton count
    on both devices and goma_tpu's (``OVS_SMALL_REF``), x within
    OVS_SMALL_X_TOL between the devices, the drag, temperature jump, decay
    rate, flux and force within OVS_SMALL_RTOL of goma_tpu's;
48. the thermal slider bearing (``scripts/shell_decks.py``: Reynolds
    lubrication and shell energy with SUPG on the QUAD9 shell that
    ``attach_shell_block`` lays on the z = 0 face of a 64x64x1 HEX27 box
    with no bulk equation; a tilted pad gap, mu = 1e-2 exp(-2 T); 33,282
    dof) under bench._cavity_opts(kind, tol=1e-9, max_iter=12) restated,
    float64 Jacobian, on ``gmres+ndlu`` then ``tpu_direct``: the tree
    against goma_tpu's record (``SHELL_REF``, from
    scripts/shell_reference.py) before any solve; the kernels on its real
    fronts at x = 0; a warm-up solve, ``reset_lagged()``, a timed solve
    with the counts set to 0 just before and read just after; goma_tpu's
    Newton +-1, the load and p_max within SHELL_P_RTOL, T at 24 dofs
    within SHELL_X_TOL; launches = levels x factorizations (and 2 x levels
    x solves); the kernels on the timed run's first and last
    factorization;
49. the drying particle-laden film (film pressure, height and particles on
    the z = 0 face of a 64x64x1 HEX27 box, 49,923 dof), five
    Crank-Nicolson steps of dt = 0.02/lambda from the leveling mode, on
    both rungs as phase 48: goma_tpu's Newton +-1 on every step, the
    amplitude within SHELL_AMP_RTOL of its exact decay, H and C at 24 dofs
    within SHELL_X_TOL, the launch identities, the kernels on the timed
    run's first and last factorization;
50. goma_tpu's shell tests' decks (``shell_decks.SMALL``) at their own
    sizes on the card: each test's own exact-solution gate, goma_tpu's
    Newton count and its readings within SHELL_SMALL_RTOL;
51. the lossy edge-element cavity (``scripts/em_decks.py``: both parts of
    ``EMWaveEdge``, omega 6, sigma_em 0.5, a Gaussian source, PEC on the
    128x128 QUAD9 unit square; 66,048 N1 dofs) under
    bench._cavity_opts(kind, tol=1e-9, max_iter=8) restated, float64
    Jacobian, on ``gmres+ndlu`` then ``tpu_direct``: the tree against
    goma_tpu's record (``EM_REF``, from scripts/em_reference.py) before
    any solve; the kernels on its real fronts at x = 0 with the boosted
    pivots counted; a warm-up solve, ``reset_lagged()``, a timed solve with
    the counts set to 0 just before and read just after; goma_tpu's Newton
    count (exactly on ``tpu_direct``, +-1 on ``gmres+ndlu``), x at 24 dofs
    within EM_X_RTOL of goma_tpu's rung and of its float64 solution; the
    launch identities; the kernels on the timed run's first and last
    factorization;
52. the lossy nodal waveguide (both parts of ``EMWave`` on the 160x32
    QUAD9 [0, 2] x [0, 0.4] with ``EMAbsorbingBC`` on the right; 83,460
    dof, 5.27M nnz) on both rungs as phase 51;
53. goma_tpu's tests' decks of the slice (``em_decks.SMALL``: EM, edge
    elements, acoustics, electrode kinetics, species flux models and the
    scalar transport fields) at their own sizes on the card: each test's
    own gate, goma_tpu's Newton count and its readings within
    EM_SMALL_RTOL;
54. the conforming FSI column (``scripts/solid_decks.py``: a Stokes fluid
    on [0, 1]^2 pressurized by ``FlowPressure`` pushes a Q2 solid on
    [1, 2] x [0, 1] through ``tie_fluid_solid``; 128x64 QUAD9, 70,789
    dof, row injections, so the full prep and the ELL operator) under
    bench._cavity_opts(kind, tol=1e-9, max_iter=12) restated, float64
    Jacobian: (a) the linear solid at P0 = 0.2 on ``tpu_direct`` against
    the exact uniaxial-strain displacement (within 2e-5 P0), the tree,
    the launches and x against goma_tpu's, and the kernels against
    their plain versions on the fronts of its timed solve's one
    factorization and on one solve's substitutions; (b) the St.
    Venant-Kirchhoff solid at P0 = 2 on ``gmres+ndlu`` then
    ``tpu_direct``: the tree against goma_tpu's record (``SOLID_REF``,
    from scripts/solid_reference.py) before any solve; the kernels on its
    real fronts at x = 0; a warm-up solve, ``reset_lagged()``, a timed
    solve with the counts set to 0 just before and read just after;
    goma_tpu's Newton count (exactly on ``tpu_direct``, +-1 on
    ``gmres+ndlu``), x at 24 dofs within SOLID_X_RTOL of max |x| from
    goma_tpu's rung and its float64 solution; the launch identities; the
    kernels on the timed run's first and last factorization;
55. the Richards infiltration slab (Celia et al.'s van Genuchten soil,
    Q2 ``PorousFlow`` on a 128x128 QUAD9 100 cm square, 66,049 dof),
    thirty backward-Euler steps from dt = 50 s without adaptation, 40
    Newton iterations allowed a step, on both rungs (the transient
    driver; the wetting front moves about five elements): the tree
    against goma_tpu's; the kernels on its real fronts at x = 0;
    ``reset_lagged()`` and the timed run (no warm-up: it would double the
    phase) with the counts set to 0 just before and read just after;
    goma_tpu's step records (t, dt and the Newton count of every step,
    exactly on ``tpu_direct``, +-1 a step on ``gmres+ndlu``), x at 24 dofs
    and the head down the wetted top within SOLID_X_RTOL of max |x|, the
    front's depth goma_tpu's; the launch identities; the kernels on the
    timed run's first and last factorization;
56. goma_tpu's tests' decks of solid mechanics and porous media
    (``solid_decks.SMALL``) at their own sizes on cuda and on cpu: each
    test's own gate, goma_tpu's Newton count, its readings within
    SOLID_SMALL_RTOL on the card, and the same Newton count and x within
    SOLID_SMALL_X_TOL on both devices;
57. the suspension channel (``scripts/closure_decks.py``: Navier-Stokes
    Q2/Q1 with the Krieger-Dougherty viscosity, the q-tensor Phillips
    migration flux of Phillips et al. (1992) and the projected shear rate
    on a 128x32 QUAD9 [0, 8] x [0, 1] channel at phi = 0.4) on both rungs
    through the transient driver, ten backward-Euler steps without
    adaptation: the tree against goma_tpu's (``CLOSURE_REF``, from
    scripts/closure_reference.py); the kernels on its real fronts at the
    initial state; the timed run with the counts set to 0 just before and
    read just after; goma_tpu's step records (Newton exactly on
    ``tpu_direct``, +-1 a step on ``gmres+ndlu``), phi up x = 4 and x = 8
    and x at 24 dofs within CLOSURE_X_RTOL of max |x|, phi moved by more
    than 1e-3 at SUSP_MOVED_MIN or more node rows of each line; the launch
    identities; the kernels on the run's last factorization;
58. the reacting wall channel (Navier-Stokes at Re 10, two species and
    energy on 96x24 QUAD9; Chemkin gas chemistry with REV, Troe falloff
    and third-body steps; PLACID surface chemistry on the heated bottom
    wall) steady on both rungs: ``reset_lagged()`` and a timed solve (no
    warm-up);
    goma_tpu's Newton count (exactly on ``tpu_direct``, +-1 on
    ``gmres+ndlu`` where goma_tpu's own run of it converged finite), x at
    24 dofs within CLOSURE_X_RTOL of goma_tpu's ``tpu_direct`` record and
    float64 solution, the wall temperature rise and outlet conversion
    printed, PLACID at every wall quadrature point on the card against the
    CPU (z and sdot within PLACID_RTOL, the same iteration counts); the
    launch identities and the kernels as phase 57;
59. goma_tpu's tests' decks of the slice (``closure_decks.SMALL``) and the
    32x16 RANS channel at their own sizes on cuda and on cpu: each test's
    own gate, goma_tpu's Newton count, its readings within
    CLOSURE_SMALL_RTOL on the card, the same Newton count and x within
    CLOSURE_SMALL_X_TOL on both devices; the vorticity direction and its
    tangent on the card against the CPU at 4,096 seeded velocity gradients
    (EIG_RTOL) and at degenerate ones (printed);
60. the laser melt pool (``scripts/ls_decks.py``: Navier-Stokes Q2/Q1,
    energy and the SUPG fill equation with level-set properties on a
    96x48 QUAD9 [0, 2] x [0, 1] domain, liquid below y = 0.6; Hysing's
    CSF, the embedded laser and Kanouff vapor fluxes, the Kanouff recoil
    pressure, the latent heat; level-set slip side walls, a gas-outlet
    top) on both rungs through the transient driver, six backward-Euler
    steps without adaptation: the tree against goma_tpu's (``LS_REF``,
    from scripts/ls_reference.py); the kernels on its real fronts at the
    initial state; the timed run with the counts set to 0 just before and
    read just after; goma_tpu's step records (Newton exactly on
    ``tpu_direct``, +-1 a step on ``gmres+ndlu``), x at 24 dofs within
    LS_X_RTOL of max |x| from goma_tpu's rung and its float64 solution,
    the peak temperature and the interface height under the beam within
    LS_READ_RTOL; the launch identities; the kernels on the run's
    last factorization;
61. the wetting drop (a half disc of radius 0.5 on the bottom wall of a
    96x48 [-1, 1] x [0, 1] domain: Navier-Stokes with the XFEM pressure
    enrichment, the SUPG fill equation, the solved normal with the div n
    CSF force and the solved curvature; the wall angle, level-set slip
    and curvature wall terms) on both rungs, six backward-Euler steps, as
    phase 60: the contact line, the curvature on the interface, the drop
    area and the largest speed within LS_READ_RTOL;
62. goma_tpu's tests' decks of the slice (``ls_decks.SMALL``) at their
    own sizes on cuda and on cpu: each test's own gate, goma_tpu's Newton
    count, its readings within LS_SMALL_RTOL on the card, the same Newton
    count and x within LS_SMALL_X_TOL on both devices;
63. the projection-split lid-driven cavity (``scripts/split_decks.py``:
    ``ProjectionSolver`` at Re 100 on a 96x96 QUAD9 mesh, u* (Q2) 74,498
    dof and the Q1 pressure increment 9,409 dof, 20 steps of dt 0.05 from
    rest) on both rungs: both trees against goma_tpu's (``SPLIT_REF``,
    from scripts/split_reference.py); the kernels on both trees' real
    fronts at the first step; the run with the counts set to 0 just
    before and read just after; every step's Newton counts of both
    sub-solves goma_tpu's (exactly on ``tpu_direct``, +-1 on
    ``gmres+ndlu``); u and p at 24 moving nodes within SPLIT_X_RTOL of
    max |x| from goma_tpu's rung and its float64 solution; the kinetic
    energy, max |DIV_VELOCITY|, the primary vortex (STREAM) and the
    vorticity there within SPLIT_READ_RTOL; the launch identities summed
    over both trees; the kernels on each tree's first and last
    factorization;
64. bench.py's 48x48 buoyant cavity split into three matrices (the flow,
    the temperature, the species: ``SegregatedSolver``'s Picard loop) on
    both rungs, as phase 63: goma_tpu's outer count and every sub-solve's
    Newton count; each matrix's x at 24 dofs; T and u against goma_tpu's
    coupled solution within 2x goma_tpu's own reading; the derived
    catalog entries of the converged state against goma_tpu's record and
    (``tpu_direct``) against the port's CPU projection of the same x; 16
    tracers through the converged velocity against goma_tpu's;
65. goma_tpu's tests' decks of the slice (``split_decks.SMALL``) at their
    own sizes on cuda and on cpu, as phase 62;
66. NDLU's pivoted front-LU routes and GCRO-DR recycling: (a) phase 45's
    cylinder and options with the preconditioner's NDLU on
    ``front_lu="lax"`` (every level pivoted, panels of 128): one
    factorization timed on the pivoted and on the kernel route, the exact
    zero pivots the library LU left, the warm-up and timed solves, x and
    drag within phase 45's gates of goma_tpu's record, no front-LU kernel
    launch, the Newton and linear counts printed beside goma_tpu's and
    phase 45's (not gated); (b) the 64x64 cavity on phase 10's
    ``tpu_direct`` options at leaf PIV_LEAF (leaves of s = 1239 > 1000 on
    the pivoted route, five kernel levels): one solve, x within
    X_PATHS_TOL of phase 10's, the front-LU and substitution launches of
    the kernel levels only; (c) phase 27's two-level cavity with
    ``recycle_k=8``: warm-up, ``reset_lagged()``, a timed solve with its
    host syncs counted, goma_tpu's Newton count +-1 (RECYCLE_REF), x
    within TWOLEVEL_X_TOL of phase 5's, the linear counts beside goma_tpu's
    and phase 27's, s/iteration and the host harvest's time; then the
    12x12 cavity on ``tpu_direct`` at leaf 2048 (one pivoted level, s =
    1419) and the 8x8 cavity's ``gmres+ndlu`` on ``front_lu="lax"`` on cuda
    and on cpu: the same Newton count, x within 1e-5.

The plain versions that the kernel checks hold the kernels against run as
CUDA graphs, captured once per shape and replayed (``plain_call``); the
CPU runs the card's are held against run in a child process
(``start_cpu_side``). Each phase prints its time (``phase N: s``), and the
run its total, before the last three lines of output: the kernel summary
(JSON, with each kernel's bound, plain-version and library-call times),
the card's name and power limit (nvidia-smi), and ``{"ok": true, "device":
...}``.
"""

import json
import os
import pickle
import statistics
import subprocess
import sys
import time
import types
import weakref
from concurrent.futures import ThreadPoolExecutor
from collections import OrderedDict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

# Tolerances of kernel vs twin, relative to max|twin LU|. The kernel
# factors in float64 and rounds a float32 front's factor once; the twin
# eliminates in the working dtype. Until the EM slice the kernel also
# eliminated float32 fronts in float32, in its blocked order, and the
# readings below are that kernel's; the 128x128 edge cavity's level (32, 86)
# (growth 587) then read 2.29x the twin's distance from float64, past
# ACC_RATIO, and the float32 elimination went. The fronts checked here have growth
# max|LU|/max|A| <= 1.07 on the cavity and <= 2.09 on the buoyant tree. On
# the H100 the largest float32 reading over every real ND level is 2.45e-6
# (the cavity's top front, m=323, whose own float32 rounding floor against
# float64 is 1.9e-4); all other fronts, the buoyant tree's m=437 top front
# included, read <= 2.5e-7. The float32 limit sits 8x above that reading
# and 10x below that floor. float64: readings <= 3.6e-15 (1e-16 roundoff).
# Fronts with large growth (random Gaussian fronts without a weighted
# diagonal reach 1e4-1e6) push any two float32 orderings apart by O(1);
# random fronts like that are not what the main path factors, so they are
# not checked here. The viscoelastic tree's real fronts grow further than
# the other decks': <= 5.5 at x = 0, but 233-662 on levels 1-4 (and 31.6
# on the m=604 level) at the converged state, where the unpivoted
# elimination of the stress and velocity-gradient rows meets small pivots
# (none boosted). There the float32 rounding floor itself (twin vs float64
# twin on the same block) reaches 1.0e-3 (level 4), and kernel vs twin
# reads up to 3.1e-4 (level 4; 2.1e-4 on level 2), each within 2x that
# floor (H100, the same readings in two runs): two float32 factorizations
# cannot be required closer than their own floors. So a real front's
# float32 limit is the larger of 2e-5 and ACC_RATIO x the twin's floor on
# that block, and the kernel must still be within ACC_RATIO x the twin's
# floor of float64 (check_real_fronts prints growth, floor and limit); the
# float64 kernel's float32 factor sits within one rounding of it.
TOL = {torch.float32: 2e-5, torch.float64: 1e-11}
# The kernel's float32 LU must be as accurate as the twin's: its distance
# from the float64 twin at most this multiple of the twin's (the float32
# elimination the kernel had before the EM slice read <= 1.05 on the real
# fronts of the earlier decks).
ACC_RATIO = 2.0
RE = 100.0
N_MAIN = 64
# Ghia, Ghia & Shin (1982), Re=100: u at the cavity centre and the minimum
# of u along the vertical centreline. The 64x64 Q2 solution must be within
# a few per mille; the tolerance also covers the ~1% spread between Ghia and
# later spectral references.
GHIA_U_CENTER, GHIA_U_MIN, GHIA_TOL = -0.20581, -0.21090, 0.01
KERNELS = ("batched_lu", "batched_trsv", "front_gather")
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels use no tensor cores), both at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# buoyant deck (bench.bench_buoyant): size, Rayleigh and Prandtl numbers, and
# goma_tpu's recorded Newton count (BENCH_r05.json: 6 iterations)
N_BUOY, RA, PR, BUOY_NEWTON = 48, 1e4, 0.71, 6
# max |x_cuda - x_cpu| / (1 + |x_cpu|) on the 8x8 buoyant deck: both stop at
# ||R||_2 <= 1e-6 after float32-Jacobian inexact steps whose sums run in
# another order on the card; on the CPU the port and goma_tpu read 3e-8 of
# the hydrostatic pressure (Ra Pr = 7100) and pass 1e-5 + 1e-6 |x|
BUOY_X_TOL = 1e-4
# Substitution kernel vs twin, relative to max|twin x|: the kernel sums each
# row in blocks of FMAs in float64 registers (float32 fronts too), the twin
# by a row dot in the working dtype, so they differ by the twin's rounding.
# On the H100 the largest readings over the 18 substitutions of one solve
# of the 64x64 tpu_direct deck and of the 48x48 buoyant tree, real and
# random right-hand sides, are 2.63e-7 (float32) and 5.5e-16 (float64)
# with the blocked kernel (1.97e-7 and 1.95e-15 with the column sweep it
# replaced); the limits are the ones set for that sweep. The float32
# kernel's distance from the float64 twin is at most 1.2x the float32
# twin's in those readings, mostly 0.3-0.7x (ACC_RATIO allows 2x). On the
# 128x128 edge cavity's tpu_direct tree (level 6, (8, 142), upper sweep)
# the float32 twin itself reads more than 2e-6 from the float64 twin (the
# H100 read kernel vs twin 2.125e-6 there), so a float32 substitution's
# limit is, as a real front's LU limit is, the larger of 2e-6 and
# ACC_RATIO x the twin's own float32 floor on that block; the kernel must
# still be within ACC_RATIO x that floor of float64. The float64 limit is
# built the same way one precision up (the same deck's level 5 read 2.63e-14
# there): the larger of 2e-14 and ACC_RATIO x the float64 twin's distance
# from the substitution in numpy's extended precision (``trsv_extended``),
# and the float64 kernel within that limit of it (a fixed floor: at a few
# ulps, 5.96e-16 against the twin's 2.59e-16 on a well-conditioned level of
# that tree, a ratio is noise).
TRSV_TOL = {torch.float32: 2e-6, torch.float64: 2e-14}
# max |x_tpu_direct - x_gmres| over the 64x64 solution: both paths stop at
# ||R||_2 <= 1e-6, GMRES's last inexact step at 6.3e-7 and tpu_direct's at
# 6.8e-9, so they differ by the GMRES endpoint's error. H100 reading
# 1.36e-5; the limit sits ~4x above.
X_PATHS_TOL = 5e-5
# viscoelastic channel (bench.bench_viscoelastic): 64x32 QUAD9, goma_tpu's
# recorded Newton count (BENCH_r05.json: 5 iterations), its tolerance
N_VE, VE_NEWTON, VE_TOL = 32, 5, 1e-8
# max |x_cuda - x_cpu| / (1 + |x_cpu|) on the 8x4 viscoelastic deck (both
# paths, and the transient start-up): both stop at ||R||_2 <= 1e-8 after
# float32-Jacobian steps whose sums run in another order on the card; on the
# CPU the port and goma_tpu read 3e-10 (gmres+ndlu) and 1.3e-10
# (tpu_direct). The limit allows the last inexact GMRES step's error.
VE_X_TOL = 1e-5
# max |x_tpu_direct - x_gmres| / (1 + |x_gmres|) over the 64x32 solution:
# GMRES's last step is inexact (eta >= 1e-3); on the CPU the two paths
# differ by 2.4e-7 at 8x4 and 1.8e-7 at 16x8 (max|x| = 4)
VE_PATHS_TOL = 1e-5
# goma_tpu's linear iterations per Newton iteration on the main paths
# (BENCH_r05.json and the H100 runs in PERF.md): they must not move when
# gmres takes the pipelined loop
CAVITY_LINEAR = [1, 12, 12, 10]
BUOY_LINEAR = [1, 7, 5, 6, 11, 5]
VE_LINEAR = [1, 40, 61, 3, 2]
VE_STARTUP_NEWTON = [3, 3, 3, 2, 2]
# static bubble (bench.bench_two_phase, BASELINE config #5): 48x48 QUAD9 on
# [-1, 1]^2, sigma = 1, r0 = 0.5, eps = 0.2; the Laplace jump
# dp = median p(r < 0.3) - median p(r > 0.8) within 8% of sigma / r0 = 2
# (goma_tpu's own check, tests/test_examples.py)
N_BUBBLE, BUBBLE_DP, BUBBLE_DP_RTOL = 48, 2.0, 0.08
# max |x_cuda - x_cpu| / (1 + |x_cpu|) on the 8x8 static bubble (both
# rungs, two backward-Euler steps): both stop at ||R||_2 <= 1e-8 after
# float32-Jacobian steps whose sums run in another order on the card; on the
# CPU the port and goma_tpu read <= 1.9e-10 on both rungs
BUBBLE_X_TOL = 1e-6
# max |x_tpu_direct - x_gmres| / (1 + |x_gmres|) at the end of the 48x48
# bubble's timed leg: GMRES's last step in each time step is inexact (eta
# >= 1e-6) and tpu_direct's refined to its guard, both below ||R||_2 1e-8
BUBBLE_PATHS_TOL = 1e-5
# pipelined against sequential loop on the 64x64 cavity, the same card and
# run: the same operations in the same order, so the norm sequences agree
# up to the card's run-to-run rounding (equal on the CPU)
PIPE_NORM_RTOL = 1e-6
# ALE slot coater (bench.bench_slot_coater, BASELINE config #3): 96x24
# QUAD9, the warm leg [0, 0.04], then ``reset_lagged()`` and the timed leg
# to 0.08 (bench.py's timed leg is 0.08 long and ends at 0.12; this script
# stops at 0.08)
SC_NX, SC_NY, SC_WARM_T, SC_END_T = 96, 24, 0.04, 0.08
# goma_tpu's bench_slot_coater make() at 96x24 on a CPU (float64 state,
# the rung's own Jacobian dtype; PERF.md): Newton iterations of each
# accepted step, per rung and leg. The port must take as many accepted
# steps in each leg, each within +-1 Newton iteration.
SC_REF_NEWTON = {
    "gmres_ndlu": {"warm": [9, 6, 5, 4, 5, 5, 5, 5, 5, 6, 6, 7, 5, 7, 6, 5, 7],
                   "timed": [7, 5, 7, 7]},
    "tpu_direct": {"warm": [9, 6, 5, 4, 3, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5],
                   "timed": [6, 5, 5, 6]}}
# ... and the free-surface height h = H + dy at ten x positions at t = 0.08
# (the two rungs agree to 1e-8 there)
SC_REF_HEIGHTS = [(1.5, 1.0), (1.7708333333333333, 0.8664828698028335),
                  (2.0625, 0.7213600993805077), (2.333333333333333, 0.6017343229752568),
                  (2.6041666666666665, 0.5265602076588211),
                  (2.895833333333333, 0.49385794647024905),
                  (3.1666666666666665, 0.48605483324683363),
                  (3.4375, 0.4847341399442603), (3.7291666666666665, 0.4864633414111058),
                  (4.0, 0.4951784456734436)]
# |h_port - h_goma_tpu| at those points: each step stops at a row-scaled
# ||R||_2 <= 3e-8 after inexact float32-Jacobian steps (gmres_ndlu) or
# refined float32 factors (tpu_direct). H100 readings 6.5e-11 (gmres_ndlu)
# and 1.1e-8 (tpu_direct, whose steps stop elsewhere below the tolerance)
SC_H_TOL = 1e-6
# the golden trace tests/golden/newton_trace_slot_coater.json (16x4, dt
# 0.02 without adaptation, forcing "fixed"): Newton per accepted step
SC_GOLDEN_NEWTON = [8, 8, 8, 6, 5]
# max |x_cuda - x_cpu| / (1 + |x_cpu|) at the end of the 16x4 runs (golden
# deck on tpu_direct, warm leg on gmres_ndlu with the float32 Jacobian):
# the same steps on both devices, each stopped at a row-scaled ||R||_2 <=
# 3e-8. H100 readings 6.7e-15 (tpu_direct) and 8.4e-10 (gmres_ndlu)
SC_X_TOL = 1e-7
# max |x_tpu_direct - x_gmres| / (1 + |x_gmres|) on the 48x48 buoyant deck:
# both stop at ||R||_2 <= 1e-6 (gmres's last step inexact, eta >= 1e-3);
# the pressure carries the hydrostatic head (Ra Pr = 7100). H100 reading
# 1.2e-5
BUOY_PATHS_TOL = 1e-4
# goma_tpu's 8x8 cavity (float64, NewtonOptions(tol_residual=1e-8) plus
# each option; JAX x64 on a CPU, 5 Newton iterations each): linear
# iterations per Newton step, recorded here because this script imports no
# goma_tpu (tests/test_torch_solvers.py holds the port to goma_tpu live).
# Entries: (options, TwoLevel.coarse_solve, goma_tpu's counts)
SMALL_OPTIONS = {
    "auto (twolevel, vanka)": ({}, None, [26, 37, 35, 30, 34]),
    "twolevel bj": (dict(precond="twolevel", smoother="bj"), None,
                    [33, 44, 41, 35, 41]),
    "block_jacobi": (dict(precond="block_jacobi"), None,
                     [231, 435, 304, 220, 333]),
    "fieldsplit": (dict(precond="fieldsplit"), None, [102, 117, 114, 105, 115]),
    "pcd": (dict(precond="pcd"), None, [128, 143, 129, 107, 131]),
    "bicgstab": (dict(linear_solver="bicgstab"), None, [600, 54, 55, 52, 55]),
    "direct": (dict(linear_solver="direct"), None, [1, 1, 1, 1, 1]),
    "bf16": (dict(precond_dtype="bf16"), None, [26, 37, 35, 30, 35]),
    "bf16-coarse": (dict(precond_dtype="bf16-coarse"), None,
                    [26, 37, 35, 30, 34]),
    "coarse inv": ({}, "inv", [42, 60, 55, 43, 55]),
}
# linear iterations per step may differ between cuda and cpu by this much
# (the card rounds its sums in another order): 2, but PCD's dense Ap
# inverse is applied in float32, and its counts move by up to 18 under a
# 1e-7 relative perturbation of Fp on the CPU; BiCGStab's by up to 4
# under a 1e-15 perturbation of the smoother (tests/test_torch_solvers.py)
SMALL_LIN_TOL = {"pcd": 20, "bicgstab": 5}
SMALL_LIN_TOL_DEFAULT = 2
# goma_tpu's two-level records on a CPU (scripts/twolevel_reference.py,
# float32 Jacobian, one solve from x = 0; jax 0.9.0): the 64x64 cavity on
# bench.py's twolevel kind (200.5 s of solve) and the 48x48 buoyant deck on
# its third rung (1834 s: every GMRES solve stops at linear_maxiter, 1000
# rounded up to whole restarts of 160)
TWOLEVEL_REF = {"cavity": {"newton": 4, "linear": [62, 166, 168, 130]},
                "buoyant": {"newton": 6, "linear": [1120] * 6}}
# max |x_twolevel - x_gmres+ndlu| on the 64x64 cavity: both stop at
# ||R||_2 <= 1e-6 after inexact float32 steps (the tpu_direct rung's bound;
# H100 reading 1.39e-5)
TWOLEVEL_X_TOL = 5e-5
# max |x_twolevel - x_gmres+ndlu| / (1 + |x_gmres+ndlu|) on the 48x48
# buoyant deck: every GMRES solve of the two-level rung stops at its cap
# (1,120 iterations), so each Newton step is inexact and the converged
# state (||R||_2 <= 1e-6) differs from the gmres+ndlu one by more than the
# direct rungs do, nearly all of it in the pressure (hydrostatic head up
# to 8,250) near its pinned zero. goma_tpu's own two-level state lies
# 2.22e-3 from its own gmres_ndlu state there (CPU,
# scripts/twolevel_reference.py --x-out / --rung gmres_ndlu --x-ref); the
# port may lie no farther from phase 13's (H100 reading 6.9e-4)
BUOY_TWOLEVEL_X_TOL = 2.2e-3
# the static bubble's host direct rung (bench.bench_two_phase("direct")):
# the end state against phase 19's gmres_ndlu state, max |dx| / (1 + |x|)
BUBBLE_DIRECT_TOL = 1e-5
# the axisymmetric die deck (examples/axisym_die_swirl.py::run: Momentum,
# SwirlMomentum, Continuity and Energy, coord="swirling"; L = 2, R = 1,
# G = 4, Re = 10, Omega = 0.5), float32 Jacobian, 64x32 QUAD9
AX_NZ, AX_NR, AX_TOL = 64, 32, 1e-9
# goma_tpu's record of phases 30/31 (scripts/axisym_reference.py --nz 64
# --nr 32: float64 state, float32 Jacobian, CPU, jax 0.9.0): Newton and
# linear iterations, the centre-line u_z (max over the axis nodes), the
# wall heat flux (heat_flux over "top") and the outlet flow rate
# (flow_rate over "right"), each per radian
AX_REF_NEWTON = {"gmres_ndlu": 4, "tpu_direct": 4}
AX_REF_LINEAR = {"gmres_ndlu": [1, 61, 3, 3], "tpu_direct": [1, 1, 1, 1]}
AX_REF_UZ = {"gmres_ndlu": 10.291610481451187,
             "tpu_direct": 10.291610481242259}
AX_REF_HEAT = {"gmres_ndlu": -4.508528485741448,
               "tpu_direct": -4.508528485763462}
AX_REF_FLOW = {"gmres_ndlu": 2.556064207900879,
               "tpu_direct": 2.556064207868944}
# |u_z - goma_tpu's|: both stop at ||R||_2 <= 1e-9 after inexact float32
# steps; goma_tpu's two rungs read 2.1e-10 apart
AX_UZ_TOL = 1e-6
# |integral - goma_tpu's| / |goma_tpu's| for the heat flux and the flow
# rate: goma_tpu's two rungs read 5e-12 and 1.2e-11 apart; a state error of
# 1e-9 moves either by ~1e-9
AX_INT_RTOL = 1e-6
# max |x_tpu_direct - x_gmres| / (1 + |x_gmres|) over the 64x32 die
AX_PATHS_TOL = 1e-6
# max |x_cuda - x_cpu| / (1 + |x_cpu|) on phase 32's small decks: each
# stops at ||R||_2 <= 1e-9 (the 12x10 die's float32 steps, the others'
# float64 host direct solves), x of order 10
AX_X_TOL = 1e-7
# phases 33-38: rotated conditions, point conditions, row injection,
# parametric Dirichlet and periodicity. The tilted cavity: the 64x64
# Re = 100 cavity's mesh rotated by 30 degrees, every wall a rotated
# constraint (tests/test_rotation.py's deck at 64x64), float32 Jacobian
TILT_N, TILT_THETA = 64, np.pi / 6
# the periodic channel: [0, 2] x [0, 1], 64x32 QUAD9, x-periodic, body
# force G = 2, mu 0.5, rho 1, convection on (tests/test_periodic.py's
# Poiseuille deck at 64x32), float32 Jacobian
PER_NX, PER_NY, PER_G, PER_MU = 64, 32, 2.0, 0.5
# goma_tpu's record of phases 33-34 and 36-37 (scripts/rotation_reference.py
# --deck tilted --n 64 / --deck periodic --n 32: float64 state, float32
# Jacobian, bench._cavity_opts' options, CPU, jax 0.9.0): Newton and linear
# iterations, x at 24 evenly spaced dofs
REF_SAMPLES = 24
TILT_REF = {
    "gmres_ndlu": {"newton": 4, "linear": [1, 12, 12, 10], "x_samples": [
        0.0, -0.01374232886109894, 0.0007563980568079387, -0.03149763359760982,
        -0.03255463481036713, 0.01271526843720494, -0.10782967449631542,
        -0.09415838667700882, -0.01171185589464585, -0.05963329243240878,
        -0.08494397353933891, -0.09702294047019677, -0.18432500006747432,
        0.055750828512827866, -0.1683876026559119, -0.15485236219228682,
        0.04220053876633756, 0.16967524879873963, 0.06623744600074133,
        0.16386254519602517, -0.05116800901305396, -0.05717987874231767,
        0.3632431227961206, 9.001291368054808]},
    "tpu_direct": {"newton": 4, "linear": [1, 1, 1, 1], "x_samples": [
        0.0, -0.013742255846021902, 0.0007563128795268472, -0.03149742319907261,
        -0.032554388854155465, 0.01271512422819531, -0.10782893869925642,
        -0.09415770211722586, -0.011711807323921646, -0.05963287573428631,
        -0.08494350374382598, -0.09702272157279387, -0.18432420646940612,
        0.0557504947789364, -0.16838808810527084, -0.15485209434514732,
        0.04219945399946276, 0.16967395200724436, 0.06627884957906749,
        0.16386120380393826, -0.051127072859950905, -0.05717999303618027,
        0.36324272457506523, 9.001331503363462]}}
PER_REF = {
    "gmres_ndlu": {"newton": 2, "linear": [240, 2], "x_samples": [
        0.0, 3.033229223348144e-11, 0.1440429688549898,
        1.3326229009180679e-11, -2.0468782224725146e-10,
        -3.7988456824677996e-10, 0.3750000007927383, 0.417480469760676,
        -8.072902346611954e-10, 3.629878619904048e-10, 0.4921875002600018,
        1.2305179097893415e-09, 1.8429773263051175e-09, 0.4921874995966391,
        -1.1689564871630864e-09, 2.584420144557953e-08, 0.4174804686324478,
        0.37500000053921667, 2.3099921975244797e-10, -2.156106404527236e-10,
        2.0954757928848267e-08, 0.14404296900269742, 9.36140054363932e-12,
        0.0]},
    "tpu_direct": {"newton": 2, "linear": [1, 1], "x_samples": [
        0.0, 3.787264973516987e-11, 0.14404296874835695,
        -1.6230971154447626e-11, 2.2179429710705745e-13,
        -1.578634088897497e-11, 0.37499999996430844, 0.4174804685856642,
        5.817817968099e-11, -7.506672084990006e-11, 0.49218749995734984,
        7.824200431532862e-11, -5.478927210108738e-11, 0.49218749996207706,
        3.0750064364526665e-11, 7.381809066136016e-09, 0.41748046878299816,
        0.37499999998544586, -2.192817115433276e-10, -1.3947896316191768e-11,
        7.226659439482988e-09, 0.14404296878821574, 8.722103099789236e-12,
        0.0]}}
# GMRES iterations a Newton step: within this many of goma_tpu's (the die
# read one more on one step on the card, PR 10)
REF_LIN_TOL = 2
# x at the sampled dofs against goma_tpu's, max |dx| / (1 + |x|): both stop
# at ||R||_2 <= 1e-6 after inexact float32 steps; goma_tpu's own two rungs
# read 4.1e-5 apart on the tilted deck (the pressure)
REF_X_TOL = 1e-4
# the tilted solution against phase 5's axis-aligned one rotated into the
# tilted frame, max |dx| / (1 + |x|) over velocity and pressure: the two
# decks stop at ||R||_2 <= 1e-6 after inexact float32 steps on different
# rounding paths (H100 reading: velocity 1.15e-5, pressure 5.41e-5;
# goma_tpu's own two rungs read 4.1e-5 apart in the pressure)
TILT_AXIS_TOL = 2e-4
# a deck's tpu_direct solution against its gmres_ndlu one, max |dx| /
# (1 + |x|), on the tilted cavity and the periodic channel: both stop at
# ||R||_2 <= 1e-6, gmres_ndlu after inexact float32 steps (H100 reading on
# the tilted cavity 5.7e-5; goma_tpu's own two rungs 4.1e-5)
BC_PATHS_TOL = 2e-4
# the periodic channel against u = G y (1 - y) / (2 mu) and v = 0, max
# abs over the nodes: u is O(0.5); the float32-Jacobian path stops at
# ||R||_2 <= 1e-6
PER_U_TOL, PER_V_TOL = 1e-5, 1e-5
# Problem.residual against assemble's R and the vals-free prep's R on the
# card, float64: max |diff| / max |R| (the same operations; readings 0 on
# the CPU)
RESID_RTOL = 1e-12
# phase 38's small decks, cuda against cpu, max |dx| / (1 + |x|): float64
# Jacobians, host direct or GMRES to 1e-12
BC_X_TOL = 1e-11
# phases 39-44: continuation and linear stability. The lid-speed cavity:
# the 64x64 cavity with mu 0.01 and the lid's u the parametric Dirichlet
# value params["U"] (Re = 100 U), float32 Jacobian, continued U 1 -> 4
CONT_N, CONT_MU = 64, 0.01
# Ghia et al. (1982) Table I, Re 400: min u on x = 0.5 (at y = 0.2813)
GHIA400_U_MIN, GHIA400_RTOL = -0.32726, 0.02
# a predictor solve's linear iterations: within the larger of REF_LIN_TOL
# and this share of goma_tpu's (tpu_direct's predictor solves run 214-262
# iterations of GMRES to 1e-10 on the two-level preconditioner factored
# from the unscaled values, as goma_tpu runs them)
CONT_PRED_RTOL = 0.1
# the augmenting condition's target node, and its U against 3 and against
# goma_tpu's: the target is u from a solve at U = 3 to ||R||_2 <= 1e-6
# (inexact float32 steps), and goma_tpu's AC lands 1.4e-6 from 3
CONT_AC_POINT, CONT_AC_TOL = (0.5, 0.2813), 1e-5
# dF/dU against goma_tpu's and the central difference, relative: both on a
# state polished to 1e-10 by float64 direct solves (goma_tpu's exact and
# central-difference values read 1.4e-9 apart)
CONT_FLUX_RTOL = 1e-6
# the Bratu deck: 64x64 QUAD9; its arclength lambda and its fold against
# goma_tpu's
CONT_BRATU_N, CONT_ARC_TOL, CONT_FOLD_TOL = 64, 1e-6, 1e-6
# growth rates against goma_tpu's, relative
CONT_SIG_RTOL = 1e-6
# the film's eigensolves start ARPACK from scripts/arpack_start.py's vector
# of this seed, as goma_tpu's record did (at beta 0.4 no pair passes the
# purification and the start vector picks among an unconverged cluster)
FILM_ARPACK_SEED = 0
# goma_tpu's record of phases 39-44 (scripts/continuation_reference.py
# --part cavity --n 64, --part bratu --n 64, --part small: float64 state,
# float32 Jacobian on the cavity, bench._cavity_opts' options, CPU, jax
# 0.9.0): the accepted U, Newton iterations, predictor linear iterations
# and x at 24 evenly spaced dofs of each step, min u/U on x = 0.5 at U = 4;
# the AC's dof, start, target, U, Newton count and norms; F and dF/dU at
# U = 4; the Bratu branch and fold; the small decks' bifurcation points
# and growth rates
CONT_REF = {'gmres_ndlu': {'lam': [1.0, 1.5, 2.25, 3.375, 4.0], 'newton': [4,
    3, 3, 4, 3], 'predictor_linear': [12, 14, 19, 27], 'u_min_centre_line':
    -0.3287460984522568, 'x_samples': [[0.0, -0.000855946445653899,
    0.005538034215533116, -0.017510651614429662, 0.016135984755237587,
    0.0176623197949084, -0.050311534055936136, -0.06325618672053679,
    -0.07643789602661855, 0.043480646549141966, -0.03021773359796498,
    -0.220466977389151, -0.10466618755162926, -0.10104084845079342,
    -0.156308065263147, -0.0430883344670292, -0.15628090178142884,
    0.20505948185746092, 0.06626787572167814, 0.2063281638402259,
    -0.05114014769424102, -0.20722232612388325, 0.012776708355886512,
    9.001314812489], [0.0, -0.0017594939417833189, 0.009281614641992064,
    -0.030155354352473296, 0.028336448504433065, 0.031436741187995665,
    -0.09442458084754435, -0.11087264227444393, -0.14442687203199966,
    0.08675890433642053, -0.049221476773936956, -0.3848339911896801,
    -0.14916561823292795, -0.18557647291891044, -0.16690015736628538,
    -0.036144189724154785, -0.17829081946729275, 0.31865802488482586,
    0.07541735011909623, 0.3359997533389105, -0.08185714254432241,
    -0.2829097712244675, 0.02277802327517975, 14.226254361918109], [0.0,
    -0.003994686246976187, 0.015904413882964263, -0.05694545428764286,
    0.057334185812123906, 0.058938473616841236, -0.19282842399138644,
    -0.209667572541548, -0.2938187204749738, 0.17253796220666118,
    -0.08548568385526778, -0.5909783426000104, -0.20875033261427234,
    -0.3180134349859145, -0.11026097008823399, -0.004708242559217979,
    -0.1395001281216537, 0.4901764244250444, 0.0502564258131315,
    0.5392756302366024, -0.1424876615019457, -0.38094651341702956,
    0.039193557853934635, 23.01966331341464], [0.0, -0.009514509185628128,
    0.027012727395884895, -0.11743443935461073, 0.12938059751058972,
    0.11126035964806391, -0.39736088314225526, -0.40520772897161805,
    -0.5970882127753612, 0.2826490729332818, -0.14868564666062412,
    -0.7217504207502543, -0.25708637725449535, -0.48852033787539995,
    -0.011602995241332792, 0.07798261923994687, -0.051185079415517976,
    0.7299852970327265, -0.07297315447431174, 0.8642529979855453,
    -0.2612477652182861, -0.5068416336036989, 0.0666752186976396,
    38.41544730081205], [0.0, -0.01380810049851533, 0.033455047084174794,
    -0.16166546427916728, 0.18321512621196234, 0.14397264302495927,
    -0.5268245792942707, -0.531814665831007, -0.7916007499720763,
    0.3189514333727175, -0.18599565758563585, -0.7468966776706338,
    -0.2657505807974303, -0.5641707530827205, 0.0320119013446174,
    0.13659408830494613, -0.001887472371890908, 0.8543560985972363,
    -0.1813782432145672, 1.0560963090259747, -0.33986202354208217,
    -0.566926721725622, 0.08320501547353842, 48.138745197476055]]},
    'tpu_direct': {'lam': [1.0, 1.5, 2.25, 3.375, 4.0], 'newton': [4, 2, 3, 3,
    2], 'predictor_linear': [214, 227, 242, 262], 'u_min_centre_line':
    -0.32874612503447365, 'x_samples': [[0.0, -0.0008560074054218615,
    0.00553824414794152, -0.017511551859337355, 0.016136866029135877,
    0.01766314233741495, -0.05031465818421465, -0.06325955098993821,
    -0.07644197357666821, 0.04348308794524397, -0.030218831730787248,
    -0.22047538405796768, -0.10466812912675398, -0.10104389987503369,
    -0.15630580633508923, -0.043086148318222016, -0.15627699610021026,
    0.20506591895901793, 0.066278849678806, 0.20634047746625075,
    -0.05112707271105835, -0.2072238272070921, 0.01277699228984824,
    9.00133150291201], [0.0, -0.0017595031628619222, 0.009281656591030371,
    -0.030155445796718566, 0.028336516778507317, 0.03143686432294795,
    -0.09442493810034568, -0.11087284913729398, -0.14442688585469032,
    0.08675890590519597, -0.04922147846666394, -0.3848343312532573,
    -0.1491652863606459, -0.18557662905026995, -0.16689890487653308,
    -0.03614397828551569, -0.17829088353496386, 0.31865739849736446,
    0.07541700509086868, 0.3359997021058621, -0.0818573413338991,
    -0.28290990470370975, 0.02277796616854616, 14.226254337600956], [0.0,
    -0.003994681878991751, 0.01590441050306019, -0.056945466097729235,
    0.057334197145744344, 0.05893846011618235, -0.19282837866033078,
    -0.20966756206383122, -0.29381868226741664, 0.172537978151505,
    -0.08548568248392037, -0.5909783252184331, -0.20875034006178061,
    -0.3180134418589036, -0.11026100686551969, -0.0047082174405660045,
    -0.1395001561332071, 0.4901764601074524, 0.05025643393346595,
    0.5392756939373924, -0.14248764663756322, -0.3809465432734741,
    0.03919355834703378, 23.01966337965704], [0.0, -0.009514509593762575,
    0.02701272223819218, -0.11743442035763992, 0.12938059155779685,
    0.11126035912371877, -0.39736089022011156, -0.4052077657344391,
    -0.5970882017301301, 0.2826490479795924, -0.14868564977724322,
    -0.721750421993005, -0.2570863595149611, -0.4885203409267337,
    -0.011603007943187464, 0.0779826130834013, -0.051185078289634305,
    0.72998527160159, -0.07297315430842535, 0.8642529882308482,
    -0.2612477987142913, -0.506841618452329, 0.06667521802145618,
    38.41544730483959], [0.0, -0.013808103202105843, 0.0334550522490459,
    -0.1616654533499758, 0.1832151120005745, 0.14397266026967281,
    -0.5268246314245536, -0.531814695414074, -0.791600782513409,
    0.31895143789534974, -0.18599565490880665, -0.7468966632015807,
    -0.2657505422670936, -0.5641707569326334, 0.03201196401531539,
    0.13659411368303556, -0.0018874529412517926, 0.8543561158745863,
    -0.18137825513349737, 1.056096328437176, -0.3398620552829275,
    -0.5669267230917437, 0.0832050148981515, 48.13874522528291]]}, 'ac':
    {'dof': 10618, 'start': 2.25, 'target': -0.8829638489160061, 'p':
    2.9999986375241128, 'iters': 3, 'res_norms': [0.3262066138959199,
    0.003981090583357513, 4.1977621658243344e-05, 1.2573937407753257e-07]},
    'flux': {'F': 1.100002971486906, 'dF_dU': 0.33971732946406047,
    'central_difference': 0.33971732898807616, 'h': 0.001}, 'bratu': {'lam':
    [0.0, 1.0, 2.5, 4.75, 6.0], 'newton': [0, 2, 2, 3, 3], 'arc_lam': [6.0,
    6.177886276004049, 6.373105976310538, 6.568719494004536,
    6.731981346487176, 6.807955198996741, 6.715873154856334,
    6.431512440847872], 'arc_newton': [0, 2, 3, 3, 3, 3, 3, 3], 'folds': [5],
    'fold_lam': 6.808124457169645, 'fold_iters': 3}, 'small': {'pitchfork':
    {'lam': 9.869736469197013, 'iters': 2, 'converged': True}, 'hopf': {'b':
    2.6899999999943667, 'omega': 1.2999999999925085, 'iters': 5, 'converged':
    True}, 'rb_sweep': [[1.2, -1.8705245979796907], [1.8,
    0.04155504963399331], [2.221, 0.4688221765221141], [2.8,
    -0.1079162936339314], [3.6, -2.897109060779844]], 'film': [[0.2,
    -0.0014868959705569944, -0.0014926375362896798], [0.4,
    -0.009928107315118534, -0.009946356238387022], [0.8, -0.07181276056379876,
    -0.07184933230283652], [1.5, -0.3500930922064, -0.35011998130697547]],
    'couette': [[0.5, -1.1543599106060125], [2.0, -2.9696508533473507]],
    'heat_device': [-78.99727217857367, -49.36856389720157,
    -49.36856389263032, -19.739855578785836]}}
# device_ms's guard tensor and its kernel's name (_guard_kernel)
_GUARD = []
# the boosted pivots per level of every real-front check, by its label
BOOSTED = {}
# the value checks made on the latest trees (checked_before): [nd, runs]
# pairs, the latest last, at most _CHECKED_TREES of them
_CHECKED = []
_CHECKED_TREES = 3
# lu_shapes's results by (level shapes, time_twin)
_LU_SHAPES = {}
# check_substitutions's timed results by the level shapes (split_tree)
_TRSV_SHAPES = {}


_T0 = time.perf_counter()


def log(msg):
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cavity_problem(n, device, Re=RE):
    """The port's counterpart of __graft_entry__._cavity_problem(n)."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import Continuity, Momentum

    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    # lid = interior top nodes only: the corners stay with the u=0 walls
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    mesh.nodesets["lid"] = top[(xt > xt.min()) & (xt < xt.max())]
    eqs = [Momentum(dim=2, interp="Q2", transient=False), Continuity(interp="Q1")]
    prob = Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0 / Re}, device=device)
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("lid", "velocity", 0, 1.0)
    prob.add_dirichlet("lid", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = torch.float32  # bench.py's mixed precision
    return prob


def cavity_opts(tol=1e-6, max_iter=20):
    """bench._cavity_opts("gmres+ndlu") restated (bench.py imports jax),
    with its deep-tolerance branch (tol < 1e-8: loose float32 Krylov
    solves, the standard Eisenstat-Walker endgame)."""
    from goma_tpu_torch.solvers import NewtonOptions

    deep = tol < 1e-8
    return NewtonOptions(max_iter=max_iter, tol_residual=tol, linear_tol=1e-4,
                         precond="ndlu", linear_solver="gmres",
                         gmres_restart=60, linear_maxiter=240,
                         ndlu_leaf_max=192, prep32_tol=3e-6,
                         ew_eta_floor=1e-3 if deep else 0.0,
                         ew_endgame="standard" if deep else "tighten")


def boosted_fronts(nn, m, seed):
    """Random fronts with decoupled zero, tiny and tiny-negative pivots (the
    boost fires on each) and negative regular pivots."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nn, m, m))
    d = np.arange(m)
    A[:, d, d] += np.where(rng.random((nn, m)) < 0.3, -2.0, 2.0) * m
    for k, v in ((0, 0.0), (m // 3, 1e-13), (m // 2, -1e-14), (m - 1, 0.0)):
        A[:, k, :] = 0.0
        A[:, :, k] = 0.0
        A[:, k, k] = v
    return A


def direct_opts(tol=1e-6, max_iter=20):
    """bench._cavity_opts("tpu_direct") restated (bench.py imports jax)."""
    from goma_tpu_torch.solvers import NewtonOptions

    return NewtonOptions(max_iter=max_iter, tol_residual=tol,
                         linear_solver="tpu_direct", ndlu_leaf_max=192,
                         ndlu_refine=1)


def timed_build(name):
    """(seconds, nvcc/ptxas report) of building ``csrc/<name>.cu``."""
    from goma_tpu_torch import cuda_build

    t0 = time.perf_counter()
    _, report = cuda_build.build(name)
    return time.perf_counter() - t0, report


def build_kernels():
    """Phase 1: build every kernel, all nvcc runs started together, and
    load each. Returns {name: (seconds, nvcc/ptxas report)}."""
    from goma_tpu_torch import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
    for name, (sec, report) in builds.items():
        cuda_build.load(name)
        log(f"build: {name}.cu in {sec:.2f} s")
        log(report)
    log(f"build: all {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    return builds


def median_ms(fn, reps):
    """Median of per-call CUDA-event times (ms) after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def event_call(fn):
    """(fn(), CUDA-event ms of that one call)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


# the plain versions' CUDA graphs, one per (function, inputs' shapes,
# strides and dtypes, options), the latest kept while their estimated
# memory (3x the largest input each: the captured LU's copy of its front
# and one update temporary) stays within PLAIN_GRAPH_BYTES; graphs whose
# inputs have the same shape, strides and dtype share the input buffers
_PLAIN_GRAPHS = OrderedDict()
_PLAIN_INPUTS = weakref.WeakValueDictionary()
PLAIN_GRAPH_BYTES = 24 * 2 ** 30


def plain_call(fn, *args, **kw):
    """(fn(*args, **kw), the CUDA-event ms of that call) for a plain
    version ``fn`` of card tensors: its launches, a Python loop of small
    kernels (m column or row steps), are captured once per shape in a CUDA
    graph and replayed, each call copying ``args`` into the graph's inputs
    (of the same strides) first. The same kernels on the same inputs, so
    the same result as an eager call; the time is the replay's, no longer
    the host's launch loop."""
    specs = tuple((a.shape, a.stride(), a.dtype) for a in args)
    key = (fn.__name__, specs, tuple(sorted(kw.items())))
    entry = _PLAIN_GRAPHS.get(key)
    if entry is None:
        static = []
        for spec, a in zip(specs, args):
            buf = _PLAIN_INPUTS.get(spec)
            if buf is None:
                buf = _PLAIN_INPUTS[spec] = torch.empty_strided(
                    a.shape, a.stride(), dtype=a.dtype, device=a.device)
            buf.copy_(a)
            static.append(buf)
        graph, out = capture(lambda: fn(*static, **kw))
        size = 3 * max(a.numel() * a.element_size() for a in args)
        entry = _PLAIN_GRAPHS[key] = (graph, static, out, size)
        while sum(e[3] for e in _PLAIN_GRAPHS.values()) > PLAIN_GRAPH_BYTES:
            _PLAIN_GRAPHS.popitem(last=False)
    else:
        _PLAIN_GRAPHS.move_to_end(key)
    graph, static, out, _ = entry
    for buf, a in zip(static, args):
        buf.copy_(a)
    _, ms = event_call(graph.replay)
    return out.clone(), ms


def check_kernel(A, name, tol=None):
    """Kernel vs twin on one batch, within ``tol`` (by default ``TOL``);
    returns (kernel LU, twin LU, max abs err, rel err, the twin's CUDA-event
    ms on this call)."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu, batched_lu_reference

    before = batched_lu.launches
    got = batched_lu(A)
    torch.cuda.synchronize()
    if batched_lu.launches != before + 1:
        raise RuntimeError(f"{name}: the kernel did not launch")
    ref, twin_ms = plain_call(batched_lu_reference, A)
    abs_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = abs_err / scale
    tol = TOL[A.dtype] if tol is None else tol
    if not np.isfinite(rel) or rel > tol:
        raise RuntimeError(f"{name}: kernel vs twin rel err {rel:.3e} > "
                           f"{tol:.1e}")
    return got, ref, abs_err, rel, twin_ms


def lu_shapes(shapes, label, time_twin):
    """Phase 3 (and 13): the front-LU kernel against its twin on random
    boosted fronts at every (nn, m) level shape, float32 and float64; the
    kernel's launch plan against the wrapper's; median CUDA-event ms of the
    kernel and ``lu_factor_ex(pivot=False)`` per shape, and the twin's
    (``time_twin``) on the one call that checks the kernel. The fronts are
    a function of the shapes, so a set of shapes checked before is not
    checked again. Returns (max abs err, {dtype: [kernel, twin, library] ms
    summed over the shapes})."""
    from goma_tpu_torch.solvers.batched_lu import _plan, batched_lu, kernel_plan

    key = (tuple(shapes), time_twin)
    if key in _LU_SHAPES:
        first, out = _LU_SHAPES[key]
        log(f"kernel {label}: the level shapes of {first}, checked and timed "
            "there")
        return out
    max_abs = 0.0
    tot = {dt: [0.0, 0.0, 0.0] for dt in (torch.float32, torch.float64)}
    fronts = {(nn, m): torch.as_tensor(boosted_fronts(nn, m, seed=m),
                                       device="cuda") for nn, m in set(shapes)}
    for dt in (torch.float32, torch.float64):
        for nn, m in shapes:
            plan = kernel_plan(nn, m, dt)
            if plan[:4] != _plan(nn, m, dt) or plan[4] < 1:
                raise RuntimeError(f"batched_lu ({nn},{m}) {dt}: kernel plan "
                                   f"{plan} != wrapper plan {_plan(nn, m, dt)}")
            A = fronts[(nn, m)].to(dt)
            _, _, a_err, rel, p_ms = check_kernel(A, f"{label} {dt} ({nn},{m})")
            max_abs = max(max_abs, a_err)
            k_ms = median_ms(lambda: batched_lu(A), 10)
            p_ms = p_ms if time_twin else float("nan")
            # the library's unpivoted batched LU: no GESP boost, so it
            # computes the same function only where no pivot is boosted
            l_ms = median_ms(lambda: torch.linalg.lu_factor_ex(A, pivot=False), 10)
            tot[dt] = [a + b for a, b in zip(tot[dt], (k_ms, p_ms, l_ms))]
            log(f"kernel {label} {str(dt)[6:]} (nn={nn:3d}, m={m:3d}): cluster "
                f"{plan[0]:2d} x {plan[2]} threads, {plan[3]} B shared, "
                f"{plan[4]} clusters resident; rel err {rel:.2e}, kernel "
                f"{k_ms:.4f} ms, twin {p_ms:.3f} ms, lu_factor_ex {l_ms:.4f} ms, "
                f"bound {lu_bound([(nn, m)])[0]:.5f} ms")
    bnd = lu_bound(shapes)
    for dt, (k, tw, lib) in tot.items():
        log(f"kernel {label}: one factorization's fronts (all {len(shapes)} "
            f"level shapes), {str(dt)[6:]}: kernel {k:.4f} ms, twin {tw:.3f} ms, "
            f"lu_factor_ex(pivot=False) {lib:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}, float32)")
    _LU_SHAPES[key] = (label, (max_abs, tot))
    return max_abs, tot


def _checked_runs(nd):
    """The value checks kept for ``nd`` (a new entry, the oldest tree's
    dropped past ``_CHECKED_TREES``)."""
    for entry in _CHECKED:
        if entry[0] is nd:
            return entry[1]
    _CHECKED.append([nd, []])
    del _CHECKED[:-_CHECKED_TREES]
    return _CHECKED[-1][1]


def checked_before(nd, vals, kind, label):
    """The record of an earlier ``kind`` check ("fronts" or "gather") on
    ``nd`` with values equal to ``vals`` (the same inputs give the same
    result), or None; logs the match. Only the latest trees' values are
    kept (``_CHECKED_TREES``)."""
    for v, kd, lab, rec in _checked_runs(nd):
        if kd == kind and v.shape == vals.shape and v.dtype == vals.dtype \
                and torch.equal(v, vals):
            log(f"{kind} {label}: the same CSR values as {lab}, checked there")
            return rec
    return None


def remember_check(nd, vals, kind, label, rec):
    """Keep ``rec`` for ``checked_before``."""
    _checked_runs(nd).append((vals.clone(), kind, label, rec))


def check_real_fronts(nd, vals, label):
    """Kernel vs twin on the real fully-summed block of every ND level of
    ``nd`` for the equilibrated CSR values ``vals``: each level's front
    assembled on the card from the values and the children's Schur
    complements, exactly as NDLU.factor does, in the factor dtype (float32),
    and the same blocks cast to float64. For float32 it also prints the
    distance of kernel and twin from the float64 twin on the same block:
    the float32 rounding floor, which the kernel must share with the twin;
    the float32 limit is ``TOL`` or, on a block whose floor is higher,
    ``ACC_RATIO`` times the twin's floor (see ``TOL``). Returns the max abs
    error; each level's boosted-pivot count goes to ``BOOSTED[label]``.
    Values this tree's fronts were checked on before are not checked
    again (``checked_before``)."""
    rec = checked_before(nd, vals, "fronts", label)
    if rec is not None:
        BOOSTED[label] = list(BOOSTED[rec[1]])
        return rec[0]
    vals_ext = nd.front_values(vals)
    max_abs = 0.0
    S = None
    BOOSTED[label] = []
    for li, lev in enumerate(nd.levels):
        F = nd.front(li, vals_ext, S)
        A = F[:, :lev.smax, :lev.smax].contiguous()
        name = f"{label} level {li} real fronts"
        got, ref, a_err, rel, _ = check_kernel(A, name, tol=float("inf"))
        a64 = A.double()
        _, exact, a_err64, rel64, _ = check_kernel(a64, name + " float64")
        sc = exact.abs().max().item()
        k64 = (got.double() - exact).abs().max().item() / sc
        t64 = (ref.double() - exact).abs().max().item() / sc
        grow = sc / a64.abs().max().item()
        lim = max(TOL[torch.float32], ACC_RATIO * t64)
        if not np.isfinite(rel) or rel > lim:
            raise RuntimeError(f"{name}: kernel vs twin rel err {rel:.3e} > "
                               f"{lim:.1e} (growth {grow:.2e}, twin vs float64 "
                               f"{t64:.2e})")
        # pivots the GESP boost set to +-tau (tau = 1e-8 max|diag A| a front)
        tau = 1e-8 * A.diagonal(dim1=1, dim2=2).abs().amax(dim=1, keepdim=True)
        piv = got.diagonal(dim1=1, dim2=2).abs()
        boosted = int(((piv - tau).abs() <= 1e-6 * tau).sum())
        BOOSTED[label].append(boosted)
        if k64 > ACC_RATIO * t64:
            raise RuntimeError(f"{label} level {li}: float32 kernel is {k64:.2e} "
                               f"from float64, the twin {t64:.2e}")
        log(f"real fronts {label} level {li} (nn={lev.nn:3d}, m={lev.smax:3d}): "
            f"max|LU|/max|A| {grow:.2e}, {boosted} boosted pivots; "
            f"float32 kernel vs twin {rel:.2e} (limit {lim:.1e}; "
            f"kernel vs float64 {k64:.2e}, twin vs float64 {t64:.2e}); "
            f"float64 kernel vs twin {rel64:.2e}")
        max_abs = max(max_abs, a_err, a_err64)
        _, S = nd.factor_level(li, F)
    remember_check(nd, vals, "fronts", label, (max_abs, label))
    return max_abs


def mem_line() -> str:
    """torch's device memory: allocated, reserved (cached) and the peak."""
    g = 2 ** 30
    return (f"torch memory {torch.cuda.memory_allocated() / g:.1f} GiB "
            f"allocated, {torch.cuda.memory_reserved() / g:.1f} reserved, "
            f"peak {torch.cuda.max_memory_allocated() / g:.1f}")


def _guard_kernel():
    """The guard of ``device_ms``: a one-element tensor, an in-place op on it
    that nothing else in this script launches (int16 xor), and the name of
    that op's kernel, learned once from a profiler window of guards only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not _GUARD:
        g = torch.zeros(1, dtype=torch.int16, device="cuda")
        g.bitwise_xor_(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                g.bitwise_xor_(1)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        if len(names) != 1:
            raise RuntimeError("torch.profiler: a window of four guard "
                               f"kernels holds the kernel names {names}")
        _GUARD.extend([g, names.pop()])
    return _GUARD


_CAPTURE_STREAM = []


def capture_stream():
    """The side stream every CUDA graph of the run is captured on."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    return _CAPTURE_STREAM[0]


def capture(fn):
    """(a CUDA graph of ``fn()``, its output in the graph's memory pool),
    captured on ``capture_stream()`` after the work queued so far. Without
    ``torch.cuda.graph``'s synchronize and ``empty_cache`` on every
    capture: those hand the caching allocator's free blocks back to CUDA,
    so the allocations after each capture went to cudaMalloc again."""
    s = capture_stream()
    s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    return graph, out


def graph_ms(fn, reps=20):
    """Device time per call of ``fn`` without the host's launch overhead and
    without the profiler: ``reps`` calls captured in one CUDA graph (after a
    warm-up call on the capture stream), the median of five replays between
    two CUDA events, over ``reps``. The replay runs the kernels back to
    back, so the time includes the ~1 us the card takes between two graph
    nodes."""
    s = capture_stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g, _ = capture(lambda: [fn() for _ in range(reps)])
    return median_ms(g.replay, 5) / reps


def device_ms(fn, reps, launches=None, required=True, graph=False):
    """Device time per call of ``fn`` (sum of its kernels' durations, ms;
    the mean over ``reps`` calls) and kernels launched per call, from
    torch.profiler, after one warm-up call. Unlike CUDA events around a
    call, this leaves out the host's launch overhead and the device's idle
    gaps.

    The profiler at times comes back without the records of the first
    kernels launched in a profiling session, and late in a long run (some
    hundreds of sessions into the process) without most of a session's
    records (on the viscoelastic tree, whatever the memory in use; a fresh
    process reads the same tree whole). So one session times all ``reps``
    calls: it opens with two guard kernels (``_guard_kernel``) and each
    call is followed by one, and the records are cut at the guards into
    one segment a call (records before the first guard are dropped). Only
    complete segments count and nothing is scaled: a segment is complete
    when it holds ``launches`` records, where the caller knows how many
    kernels one call launches; otherwise the most records held by at least
    two segments (a lost guard merges two calls into one segment, lost
    records shorten one; neither repeats at the top). Up to three sessions
    are taken until ``reps`` segments are complete. Failing that, where
    ``fn`` can be captured in a CUDA graph (``graph=True``) it logs the
    counts and times ``fn`` by ``graph_ms`` instead (kernels a call:
    ``launches``); where the caller reads the number only as a diagnostic
    (``required=False``) it logs the counts and returns (nan, None): not
    measured; else it raises with the counts seen. Segments left out are
    logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    guard, guard_name = _guard_kernel()
    fn()
    torch.cuda.synchronize()
    need = reps if launches is not None else max(reps, 2)
    counts, totals = [], []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            guard.bitwise_xor_(1)
            guard.bitwise_xor_(1)
            for _ in range(reps):
                fn()
                guard.bitwise_xor_(1)
            torch.cuda.synchronize()
        seen = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        seg = None
        for e in seen:
            if e.name != guard_name:
                if seg is not None:
                    seg.append(e)
                continue
            if seg:
                counts.append(len(seg))
                totals.append(sum(x.device_time_total for x in seg) / 1000.0)
            seg = []
        if launches is not None:
            per_call = launches
        else:
            per_call = max((c for c in counts if counts.count(c) >= 2), default=0)
        full = [t for c, t in zip(counts, totals) if c == per_call]
        if per_call > 0 and len(full) >= need:
            if len(full) < len(counts) or len(counts) < reps:
                log(f"device_ms: {len(full)} complete segments of {per_call} "
                    f"records (records per segment {counts})")
            return sum(full) / len(full), per_call
    free, total = torch.cuda.mem_get_info()
    msg = ("torch.profiler gave too few complete segments of kernel records: "
           f"wanted {need} with "
           f"{launches if launches is not None else 'the same top'} records "
           f"each, saw {counts} ({mem_line()}, {free / 2**30:.1f} of "
           f"{total / 2**30:.1f} GiB free on the card)")
    if graph:
        ms = graph_ms(fn)
        log(f"device_ms: {msg}; timed by CUDA-graph replay instead: "
            f"{ms:.4f} ms a call")
        return ms, launches
    if required:
        raise RuntimeError(msg)
    log(f"device_ms: not measured ({msg})")
    return float("nan"), None


def check_trsv(lu, rhs, lower, name, tol=None):
    """Substitution kernel vs twin on one batch, within ``tol`` (by default
    ``TRSV_TOL``); returns (kernel x, twin x, max abs err, rel err, the
    twin's CUDA-event ms on this call)."""
    from goma_tpu_torch.solvers.batched_trsv import (batched_trsv,
                                                     batched_trsv_reference)

    before = batched_trsv.launches
    got = batched_trsv(lu, rhs, lower)
    torch.cuda.synchronize()
    if batched_trsv.launches != before + 1:
        raise RuntimeError(f"{name}: the substitution kernel did not launch")
    ref, twin_ms = plain_call(batched_trsv_reference, lu, rhs, lower=lower)
    abs_err = (got - ref).abs().max().item()
    rel = abs_err / ref.abs().max().item()
    tol = TRSV_TOL[lu.dtype] if tol is None else tol
    if not np.isfinite(rel) or rel > tol:
        raise RuntimeError(f"{name}: substitution kernel vs twin rel err "
                           f"{rel:.3e} > {tol:.1e}")
    return got, ref, abs_err, rel, twin_ms


def trsv_extended(L, rhs, lower):
    """The substitution of ``check_trsv`` in numpy's extended precision
    (longdouble) on the host, from float64 data: the yardstick of the
    float64 substitutions' own rounding. ``L`` is the packed LU of float64
    values as a longdouble numpy array (nn, m, m) (exact: every float64 is
    a longdouble); unit lower or upper, batched over fronts; returns a
    longdouble array (nn, m)."""
    b = rhs.double().cpu().numpy().astype(np.longdouble)
    m = b.shape[1]
    x = np.zeros_like(b)
    for i in (range(m) if lower else range(m - 1, -1, -1)):
        if lower:
            x[:, i] = b[:, i] - np.sum(L[:, i, :i] * x[:, :i], axis=1)
        else:
            x[:, i] = (b[:, i] - np.sum(L[:, i, i + 1:] * x[:, i + 1:],
                                        axis=1)) / L[:, i, i]
    return x


def check_substitutions(calls, label, timed=True):
    """Phase 8 (and 13): kernel vs twin on every recorded substitution
    (float32 as recorded, and cast to float64), with its real right-hand
    side and a seeded random one; the float32 kernel must be as accurate as
    the float32 twin against the float64 twin; the kernel's launch plan
    must be the wrapper's; on no level may the kernel take more device time
    than ``torch.linalg.solve_triangular``, both timed for this gate by
    CUDA-graph replay (``graph_ms``): late in a long run the profiler once
    read the library far under the time it takes in a fresh process
    (0.0189 ms at (1, 512); ``scripts/torch_trsv_library_probe.py`` reads
    it there). The twin's times are its CUDA-event times on the calls that
    check the kernel with the real right-hand side; the profiler reads the
    device time of the two top levels and of any level above m = 500 (the
    ones callers read per dependent step), the graph replay that of the
    others. Not ``timed`` (a second check on a tree whose shapes a first
    one timed): the gates only, every level's device time from the graph
    replay; returns {"max_abs", "levels"}. Else returns {"max_abs", "ms":
    per-dtype [kernel, twin, solve_triangular] sums of per-call CUDA-event
    medians, "device_ms": {"kernel", "solve_triangular"} for one float32
    solve's calls by the profiler, "run_ms": CUDA events around one solve's
    kernel calls, "host_us": (run_ms - kernel device ms) per call,
    "levels": per call
    (level, nn, m, lower, kernel device ms, solve_triangular device ms)}."""
    from goma_tpu_torch.solvers.batched_trsv import (_plan, batched_trsv,
                                                     kernel_plan)

    def lib(lu, rhs, lower):
        return torch.linalg.solve_triangular(lu, rhs.unsqueeze(2),
                                             upper=not lower,
                                             unitriangular=lower)

    max_abs = 0.0
    tot = {dt: [0.0, 0.0, 0.0] for dt in (torch.float32, torch.float64)}
    n_lev = len(calls) // 2
    levels = []
    for ci, (lu32, seg32, lower) in enumerate(calls):
        li = ci if lower else 2 * n_lev - 1 - ci
        nn, m = seg32.shape
        sweep = "lower" if lower else "upper"
        for dt in (torch.float32, torch.float64):
            plan = kernel_plan(nn, m, dt)
            if plan[:4] != _plan(nn, m, dt) or plan[4] < 1:
                raise RuntimeError(f"batched_trsv ({nn},{m}) {dt}: kernel plan "
                                   f"{plan} != wrapper plan {_plan(nn, m, dt)}")
        plan = kernel_plan(nn, m, torch.float32)
        rnd = torch.as_tensor(np.random.default_rng(ci).standard_normal(
            (nn, m)), device=lu32.device)
        lu64 = lu32.double()
        # taken to longdouble once for both right-hand sides
        L_ext = lu64.cpu().numpy().astype(np.longdouble)
        errs, twin_ms = [], {}
        for kind, rhs in (("real", seg32.double()), ("random", rnd)):
            name = f"trsv {label} level {li} (nn={nn}, m={m}) {sweep} {kind}"
            inf = float("inf")
            got64, exact, a64, r64, tw64 = check_trsv(
                lu64, rhs, lower, name + " float64", tol=inf)
            got, ref, a32, r32, tw32 = check_trsv(lu32, rhs.float(), lower,
                                                  name, tol=inf)
            if kind == "real":
                twin_ms = {torch.float32: tw32, torch.float64: tw64}
            # float32: the twin's own floor on this block against the
            # float64 twin (see TRSV_TOL); float64 the same one precision
            # up, against the substitution in extended precision
            sc = exact.abs().max().item()
            k64 = (got.double() - exact).abs().max().item() / sc
            t64 = (ref.double() - exact).abs().max().item() / sc
            lim = max(TRSV_TOL[torch.float32], ACC_RATIO * t64)
            ext = trsv_extended(L_ext, rhs, lower)
            sce = float(np.max(np.abs(ext)))
            k64e, t64e = (float(np.max(np.abs(
                x.cpu().numpy().astype(np.longdouble) - ext)) / sce)
                for x in (got64, exact))
            lim64 = max(TRSV_TOL[torch.float64], ACC_RATIO * t64e)
            line = (f"{kind} f32 {r32:.2e} (limit {lim:.1e}; kernel/twin vs "
                    f"f64 {k64:.2e}/{t64:.2e}) f64 {r64:.2e} (limit "
                    f"{lim64:.1e}; kernel/twin vs extended {k64e:.2e}/"
                    f"{t64e:.2e})")
            # a float32 unit roundoff floor keeps a twin that happens to land
            # exactly from failing the ratio on a last-bit difference
            if (not r32 <= lim or k64 > ACC_RATIO * max(t64, 2.0 ** -24)
                    or not r64 <= lim64 or k64e > lim64):
                raise RuntimeError(f"{name}: substitution kernel outside its "
                                   f"gates: {line}")
            errs.append(line)
            max_abs = max(max_abs, a32, a64)
        k_gr = graph_ms(lambda: batched_trsv(lu32, seg32, lower))
        l_gr = graph_ms(lambda: lib(lu32, seg32, lower))
        if timed:
            ms = []
            for dt, lu, rhs in ((torch.float32, lu32, seg32),
                                (torch.float64, lu64, seg32.double())):
                t = (median_ms(lambda: batched_trsv(lu, rhs, lower), 20),
                     twin_ms[dt], median_ms(lambda: lib(lu, rhs, lower), 20))
                tot[dt] = [a + b for a, b in zip(tot[dt], t)]
                ms.append(t)
            times = (f"ms f32 kernel/twin/solve_triangular "
                     f"{ms[0][0]:.3f}/{ms[0][1]:.3f}/{ms[0][2]:.3f}, f64 "
                     f"{ms[1][0]:.3f}/{ms[1][1]:.3f}/{ms[1][2]:.3f}; f32 device "
                     "ms kernel / solve_triangular")
            if li >= n_lev - 2 or m > 500:
                # the levels whose device time a caller reads per step
                k_dev = device_ms(lambda: batched_trsv(lu32, seg32, lower),
                                  5, 1, graph=True)[0]
                l_dev, l_kern = device_ms(lambda: lib(lu32, seg32, lower), 5,
                                          graph=True)
                times += (f" {k_dev:.4f} (1 record a call) / {l_dev:.4f} "
                          f"({l_kern} records a call), by graph replay")
            else:
                k_dev, l_dev = k_gr, l_gr
                times += " by graph replay"
        else:
            k_dev, l_dev = k_gr, l_gr
            times = "f32 device ms kernel / solve_triangular by graph replay"
        log(f"trsv {label} level {li} (nn={nn:3d}, m={m:3d}) {sweep}: "
            f"{plan[2]} threads, {plan[3]} B shared, {plan[4]} CTAs an SM; "
            f"{'; '.join(errs)}; {times} {k_gr:.4f} / {l_gr:.4f}, bound "
            f"{trsv_bound([(lu32, seg32, lower)])[0]:.5f}")
        levels.append((li, nn, m, lower, k_dev, l_dev))
        if k_gr > l_gr:
            raise RuntimeError(f"trsv {label} level {li} {sweep}: the kernel "
                               f"takes {k_gr:.4f} ms of device time, "
                               f"solve_triangular {l_gr:.4f} (CUDA-graph "
                               f"replay; profiler {k_dev:.4f} / {l_dev:.4f})")
    if not timed:
        return {"max_abs": max_abs, "levels": levels}
    for dt, (k, tw, lb) in tot.items():
        log(f"trsv {label}: one solve's substitutions ({len(calls)} calls), "
            f"{str(dt)[6:]}: kernel {k:.3f} ms, twin {tw:.3f} ms, "
            f"solve_triangular {lb:.3f} ms (CUDA events around each call)")
    # the plain version's thousands of small kernels per solve are left to
    # the event times above: no profiler window of them is complete
    runs = {
        "kernel": lambda: [batched_trsv(lu, b, lo) for lu, b, lo in calls],
        "solve_triangular": lambda: [lib(lu, b, lo) for lu, b, lo in calls],
    }
    dev = {k: device_ms(fn, 5, len(calls) if k == "kernel" else None,
                        graph=True)
           for k, fn in runs.items()}
    run_ms = median_ms(runs["kernel"], 20)
    host_us = 1e3 * (run_ms - dev["kernel"][0]) / len(calls)
    log(f"trsv {label}: one solve's substitutions, float32, device time "
        "(torch.profiler, complete windows only, or graph replay as logged): "
        + ", ".join(f"{k} {ms:.3f} ms in {n} kernels a call"
                    for k, (ms, n) in dev.items())
        + f"; CUDA events around the {len(calls)} kernel calls {run_ms:.3f} ms"
        f", i.e. {host_us:.1f} us of host time per call above the kernel")
    return {"max_abs": max_abs, "ms": tot,
            "device_ms": {k: ms for k, (ms, _) in dev.items()},
            "run_ms": run_ms, "host_us": host_us, "levels": levels}


def trsv_step_ns():
    """Device ns per dependent step of the substitution kernel: the slope
    between single float32 fronts of 224 and 448 rows (7 and 14 blocks, the
    sizes of the trees' top fronts), lower and upper sweeps averaged. One
    front's time is its steps times this, plus the kernel's start. The
    largest front the kernel takes (1024 rows) is timed beside them."""
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv

    t = {}
    for m in (224, 448, 1024):
        rng = np.random.default_rng(m)
        A = rng.standard_normal((1, m, m)) / m
        A[:, np.arange(m), np.arange(m)] += 2.0
        lu = torch.as_tensor(A, dtype=torch.float32, device="cuda")
        b = torch.as_tensor(rng.standard_normal((1, m)), dtype=torch.float32,
                            device="cuda")
        t[m] = sum(device_ms(lambda: batched_trsv(lu, b, lo), 10, 1)[0]
                   for lo in (True, False)) / 2
    step = 1e6 * (t[448] - t[224]) / 224
    log(f"trsv: one dependent step costs {step:.1f} ns of device time "
        f"(single fronts: m=224 {t[224]:.4f} ms, m=448 {t[448]:.4f} ms; "
        f"m=1024 {t[1024]:.4f} ms, {1e6 * t[1024] / 1024:.1f} ns a step)")
    return step


def factor_split_ms(nd, vals, label, reps=5):
    """Median CUDA-event ms of one factorization of ``nd``, split into
    front gather (``NDLU.gather``), extend-add (``NDLU.extend_add``), front
    LU (``NDLU.factor_front``) and inverses or X/Y + Schur
    (``NDLU.factor_rest``), each summed over the levels. Returns
    {piece: ms}."""
    names = ("gather", "extend-add", "front LU", "inverses + Schur")
    n_lev = len(nd.levels)
    runs = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4 * n_lev + 1)]
        S = None
        vals_ext = nd.front_values(vals)
        ev[0].record()
        for li in range(n_lev):
            F = nd.gather(li, vals_ext)
            ev[4 * li + 1].record()
            F = nd.extend_add(li, F, S)
            ev[4 * li + 2].record()
            lu = nd.factor_front(li, F)
            ev[4 * li + 3].record()
            _, S = nd.factor_rest(li, F, *lu)
            ev[4 * li + 4].record()
        ev[-1].synchronize()
        runs.append([sum(ev[4 * li + j].elapsed_time(ev[4 * li + j + 1])
                         for li in range(n_lev)) for j in range(4)])
    split = {n: statistics.median(r[j] for r in runs[1:])
             for j, n in enumerate(names)}
    log(f"factorization split {label} (CUDA events, all {n_lev} levels): "
        + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split.items())
        + f"; total {sum(split.values()):.3f} ms")
    return split


def bound_ms(nbytes, flops):
    """The least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the float32 operations over the float32 rate; and
    which of the two sets it."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def lu_bound(shapes, esize=4):
    """batched_lu bound over (nn, m) front batches: each front read and
    written once; per front sum_k (m-k-1) divisions + 2 (m-k-1)^2 FMA
    operations, i.e. ~2m^3/3."""
    nbytes = sum(2 * nn * m * m * esize for nn, m in shapes)
    flops = sum(nn * ((m - 1) * m / 2 + (m - 1) * m * (2 * m - 1) / 3)
                for nn, m in shapes)
    return bound_ms(nbytes, flops)


def trsv_bound(calls, esize=4):
    """batched_trsv bound over recorded (lu, rhs, lower) calls: the triangle
    the substitution reads (strict lower, or upper with the diagonal), the
    right-hand side read and the result written; one multiply-add per
    triangle entry plus one division per row of an upper sweep."""
    nbytes = flops = 0
    for lu, rhs, lower in calls:
        nn, m = rhs.shape
        tri = m * (m - 1) // 2 if lower else m * (m + 1) // 2
        nbytes += nn * (tri + 2 * m) * esize
        flops += nn * (m * (m - 1) + (0 if lower else m))
    return bound_ms(nbytes, flops)


def check_gathers(nd, vals, label):
    """Phase 11: the front-gather kernel against its plain version on every
    level's real slot map of ``nd``, with float32 and float64 values, and on
    a seeded map with indices out of range (negative and past the end). A
    gather is exact: every result must equal the plain one. Returns the max
    abs difference (0). Values this tree's gathers were checked on before
    are not checked again (``checked_before``)."""
    from goma_tpu_torch.solvers.front_gather import (front_gather,
                                                     front_gather_reference)

    rec = checked_before(nd, vals, "gather", label)
    if rec is not None:
        return rec

    gen = torch.Generator(device=vals.device).manual_seed(0)
    max_abs = 0.0
    for dt in (torch.float32, torch.float64):
        v = torch.cat([vals.new_zeros(1), vals]).to(dt)
        bad = torch.randint(-1000, v.numel() + 1000, (1_000_003,),
                            generator=gen, device=v.device, dtype=torch.int32)
        maps = [(f"level {li}", tb["gmap"]) for li, tb in enumerate(nd.tabs)]
        for name, g in maps + [("out-of-range map", bad)]:
            before = front_gather.launches
            got = front_gather(v, g)
            torch.cuda.synchronize()
            if front_gather.launches != before + 1:
                raise RuntimeError(f"gather {label} {name}: the kernel did not launch")
            ref = front_gather_reference(v, g)
            err = (got - ref).abs().max().item()
            max_abs = max(max_abs, err)
            if not torch.equal(got, ref):
                raise RuntimeError(f"gather {label} {name} {dt}: kernel differs "
                                   f"from its plain version by {err:.3e}")
    log(f"gather {label}: kernel == plain on all {len(nd.tabs)} level maps and "
        "an out-of-range map, float32 and float64 (max |diff| 0)")
    remember_check(nd, vals, "gather", label, max_abs)
    return max_abs


def gather_times(nd, vals, label):
    """Per factorization of ``nd`` (all levels, the factor dtype): median
    CUDA-event ms and profiler device ms of the kernel, its plain version,
    ``torch.index_select`` (one library call computing the same function on
    these in-range maps) and the scatter-set it replaced (zeros +
    index-put, as ``NDLU.front`` ran before; timed here only); the byte
    bound (each map read once, each front written once, the values read
    once: each CSR entry lies in one level's map). Returns {name: (event
    ms, device ms)} and the bound."""
    from goma_tpu_torch.solvers.front_gather import (front_gather,
                                                     front_gather_reference)

    v = nd.front_values(vals)
    vraw = vals.to(nd.dtype)
    maps = [tb["gmap"] for tb in nd.tabs]
    dev = v.device
    plans = [(g.numel(), torch.as_tensor(lev.a_lin.astype(np.int64), device=dev),
              torch.as_tensor(lev.a_src.astype(np.int64), device=dev))
             for lev, g in zip(nd.levels, maps)]

    def scatter_set():
        out = []
        for L, lin, src in plans:
            F = torch.zeros(L, dtype=nd.dtype, device=dev)
            F[lin] = vraw[src]
            out.append(F)
        return out

    runs = {
        "kernel": lambda: [front_gather(v, g) for g in maps],
        "plain": lambda: [front_gather_reference(v, g) for g in maps],
        "index_select": lambda: [torch.index_select(v, 0, g) for g in maps],
        "scatter_set": scatter_set,
    }
    out = {k: (median_ms(fn, 10), device_ms(fn, 5, required=False)[0])
           for k, fn in runs.items()}
    slots = sum(g.numel() for g in maps)
    es = v.element_size()
    nbytes = (4 + es) * slots + es * v.numel()
    bound = bound_ms(nbytes, 0)
    log(f"gather {label}: {len(maps)} level maps, {slots} slots, maps "
        f"{4 * slots / 2**20:.1f} MiB on the device; per factorization "
        f"({str(nd.dtype)[6:]}, {nbytes / 1e6:.1f} MB): " + ", ".join(
            f"{k} {e:.3f} ms ({d:.3f} device)" for k, (e, d) in out.items())
        + f"; bound {bound[0]:.3f} ms ({bound[1]})")
    return out, bound


def buoyant_problem(n, device):
    """bench.bench_buoyant's deck restated (bench.py imports jax): QUAD9,
    Ra = 1e4, Pr = 0.71, Boussinesq body force, heated left wall."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import Continuity, Energy, Momentum, Species
    from goma_tpu_torch.physics.materials import BoussinesqBodyForce

    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh, [Momentum(dim=2, transient=False), Continuity(),
               Energy(interp="Q2", transient=False),
               Species(n_species=1, interp="Q2", transient=False)],
        {"rho": 1.0, "mu": PR, "k": 1.0, "Cp": 1.0, "diffusivity": 1.0,
         "body_force": BoussinesqBodyForce([0.0, RA * PR], beta=-1.0, T0=0.5)},
        device=device)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = torch.float32
    return prob


def buoyant_opts():
    """bench.bench_buoyant("gmres_ndlu")'s options restated."""
    from goma_tpu_torch.solvers import NewtonOptions

    return NewtonOptions(max_iter=15, tol_residual=1e-6, linear_tol=1e-4,
                         precond="ndlu", linear_solver="gmres",
                         gmres_restart=60, linear_maxiter=240,
                         ndlu_leaf_max=256, ew_eta_floor=1e-3,
                         ew_endgame="standard")


def ghia_check(prob, x, label):
    mesh = prob.mesh
    on = np.abs(mesh.coords[:, 0] - 0.5) < 1e-12
    ys = mesh.coords[on, 1]
    ux = x[prob.dofmap.dof_of_node_svar[on, prob.dofmap.svar("velocity", 0)]]
    u_c, u_min = float(ux[np.argmin(np.abs(ys - 0.5))]), float(ux.min())
    log(f"Ghia check {label}: u(0.5,0.5) = {u_c:.5f} (Ghia {GHIA_U_CENTER}), "
        f"min u on x=0.5: {u_min:.5f} (Ghia {GHIA_U_MIN})")
    if abs(u_c - GHIA_U_CENTER) > GHIA_TOL or abs(u_min - GHIA_U_MIN) > GHIA_TOL:
        raise RuntimeError(f"{label} solution disagrees with Ghia et al. Re=100")


def solve_from_zero(solver):
    """(converged, Newton iterations, x, summary) of one solve of
    ``solver`` from x = 0."""
    prob = solver.problem
    r = solver.solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
    return r.converged, r.iters, r.x, r.summary()


def check_cuda_cpu(label, cuda, cpu, tol, relative=False):
    """A run on the card against the same run on the CPU, each a
    ``solve_from_zero`` record: both converged, the same Newton count, x
    within ``tol`` (max |dx|, over 1 + |x_cpu| where ``relative``)."""
    for d, (converged, _, _, summary) in (("cuda", cuda), ("cpu", cpu)):
        if not converged:
            raise RuntimeError(f"{label} did not converge on {d}:\n{summary}")
    dx = (rel_dx(cuda[2], cpu[2]) if relative
          else float(np.abs(cuda[2] - cpu[2]).max()))
    log(f"cross-check {label}: Newton its cuda {cuda[1]} cpu {cpu[1]}, max "
        f"|x_cuda - x_cpu|{' / (1 + |x_cpu|)' if relative else ''} = {dx:.2e}")
    if cuda[1] != cpu[1] or dx > tol:
        raise RuntimeError(f"{label}: cuda and cpu differ (Newton {cuda[1]} / "
                           f"{cpu[1]}, x {dx:.2e} > {tol:.0e})")


def cavity8_run(opts_fn, device):
    """Phases 4 and 9's run on ``device``: the 8x8 cavity under
    ``opts_fn()``."""
    from goma_tpu_torch.solvers import NewtonSolver

    return solve_from_zero(NewtonSolver(cavity_problem(8, device), opts_fn()))


def cavity8_cpu_runs():
    """Phases 4 and 9's CPU runs, by label."""
    cpu = torch.device("cpu")
    return {"gmres+ndlu": cavity8_run(cavity_opts, cpu),
            "tpu_direct": cavity8_run(direct_opts, cpu)}


def cross_check_8x8(opts_fn, label):
    """Phases 4 and 9: the 8x8 cavity on cuda and on cpu, same options (the
    CPU run from ``cpu_runs``): the same Newton count, x within 1e-5."""
    check_cuda_cpu(f"8x8 {label}", cavity8_run(opts_fn, torch.device("cuda")),
                   cpu_runs("cavity8", cavity8_cpu_runs)[label], 1e-5)


def buoyant8_run(device):
    """Phase 12's run on ``device``: the 8x8 buoyant deck."""
    from goma_tpu_torch.solvers import NewtonSolver

    return solve_from_zero(NewtonSolver(buoyant_problem(8, device),
                                        buoyant_opts()))


def cross_check_buoyant8():
    """Phase 12: the 8x8 buoyant deck on cuda and on cpu (the CPU run from
    ``cpu_runs``): the same Newton count, x within BUOY_X_TOL."""
    check_cuda_cpu("8x8 buoyant", buoyant8_run(torch.device("cuda")),
                   cpu_runs("buoyant8", lambda: buoyant8_run(torch.device("cpu"))),
                   BUOY_X_TOL, relative=True)


def ve_problem(n, device, transient=False):
    """bench.bench_viscoelastic's deck restated (bench.py imports jax): the
    EVSS-F/DEVSS Oldroyd-B channel on a (2n)x(n) QUAD9 mesh of [0, 2] x
    [0, 1], lam = 1, mu_p = 1, mu_s = 0.5, pressure gradient G = 2 (Wi ~
    1.5), u, v on Q2 and p, 3 stress and 4 velocity-gradient components on
    Q1, the Newtonian profile at inflow and outflow. ``transient`` switches
    the time derivative on in Momentum and VEStress (their defaults)."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import (Continuity, Momentum,
                                        VelocityGradientProjection, VEStress)

    lam, mu_p, mu_s, G, H = 1.0, 1.0, 0.5, 2.0, 1.0
    mesh = rectangle_mesh(2 * n, n, elem="QUAD9", xlim=(0, 2.0), ylim=(0, H))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh,
        [Momentum(dim=2, transient=transient, convection=False,
                  ve_stress_modes=1, devss_mu=mu_p),
         Continuity(),
         VEStress(0, dim=2, lam=lam, mu_p=mu_p, model="oldroyd_b",
                  interp="Q1", transient=transient),
         VelocityGradientProjection(dim=2, interp="Q1")],
        {"rho": 0.0, "mu": mu_s, "body_force": np.array([G, 0.0])},
        device=device)
    uex = lambda c: G / (2 * (mu_p + mu_s)) * c[:, 1] * (H - c[:, 1])  # noqa: E731
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, uex)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = torch.float32
    return prob


def ve_opts():
    """bench.bench_viscoelastic("gmres_ndlu")'s options restated."""
    from goma_tpu_torch.solvers import NewtonOptions

    return NewtonOptions(max_iter=25, tol_residual=VE_TOL, linear_tol=1e-4,
                         precond="ndlu", linear_solver="gmres",
                         gmres_restart=60, linear_maxiter=240,
                         ndlu_leaf_max=192, ew_eta_floor=1e-3,
                         ew_endgame="standard")


def ve_direct_opts():
    """bench.bench_viscoelastic("tpu_direct")'s options restated."""
    from goma_tpu_torch.solvers import NewtonOptions

    return NewtonOptions(max_iter=25, tol_residual=VE_TOL,
                         linear_solver="tpu_direct", ndlu_leaf_max=192)


def ve_time_opts():
    """Phase 17's time stepping: backward Euler, dt 0.05 to t = 0.25, no
    adaptation (on this DAE deck goma_tpu's adaptive controller collapses
    dt on the algebraic pressure and gradient rows)."""
    from goma_tpu_torch.solvers.transient import TimeOptions

    return TimeOptions(dt0=0.05, t_end=0.25, theta=0.0, adapt=False)


def rel_dx(a, b):
    """max |a - b| / (1 + |b|)."""
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def warm_then_timed(solver, x_init, params, label, warm=True):
    """The main-path protocol: one warm-up solve (unless not ``warm``),
    ``reset_lagged()``, every factorization, solve and launch count set to
    0, one timed solve. Returns (result, seconds, {"lu", "trsv", "gather":
    launches})."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather

    if warm:
        t0 = time.perf_counter()
        res_w = solver.solve(x_init, params)
        torch.cuda.synchronize()
        log(f"{label} warm-up: {time.perf_counter() - t0:.2f} s, "
            f"iters={res_w.iters}, lin={res_w.linear_iters}, "
            f"converged={res_w.converged}")
    solver.reset_lagged()
    solver.n_factor = solver._ndlu_nfactor = solver.n_discarded = 0
    solver.direct_log = []
    if solver._ndlu is not None:
        solver._ndlu.n_solve = 0
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(x_init, params)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
                "gather": front_gather.launches}
    iters = max(res.iters, 1)
    log(res.summary())
    for i, (sweeps, rel, fresh) in enumerate(solver.direct_log):
        log(f"{label} it {i}: {sweeps} refinement sweeps, rel residual "
            f"{rel:.3e}, {'fresh' if fresh else 'lagged'} factor")
    solves = (f" NDLU solves={solver._ndlu.n_solve}"
              if solver._ndlu is not None else "")
    log(f"{label}: iters={res.iters} converged={res.converged} "
        f"lin={res.linear_iters} factorizations="
        f"{solver.n_factor + solver._ndlu_nfactor}{solves} discarded "
        f"speculative solves={solver.n_discarded} front-LU launches="
        f"{launches['lu']} front-gather launches={launches['gather']} "
        f"substitution launches={launches['trsv']}")
    log(f"{label}: asm {res.assembly_time / iters * 1000:.1f} ms + slv "
        f"{res.solve_time / iters * 1000:.1f} ms per iteration, "
        f"{sec / iters:.4f} s/iter (total {sec:.3f} s)")
    return res, sec, launches


def where_time_goes(prob, nd, vals, x0, params, label):
    """Median CUDA-event ms and profiler device ms (kernels a call) of each
    piece of an iteration's work: the vals-free prep, the CSR values, one
    factorization of ``nd`` and one apply (``NDLU.solve``). The CSR values
    run the prep's element kernels (one launch more), so only their event
    time is taken: a profiler window of the generic prep's thousands of
    host ops takes seconds."""
    facs = nd.factor(vals)
    rb = torch.ones(prob.dofmap.n_dof, dtype=nd.dtype, device=vals.device)
    pieces = {
        "prep (_assemble_fast)": lambda: prob._assemble_fast(x0, params),
        "CSR values (_assemble_with_elem)":
            lambda: prob._assemble_with_elem(x0, params),
        "factorization (NDLU.factor)": lambda: nd.factor(vals),
        "apply (NDLU.solve)": lambda: nd.solve(facs, rb),
    }
    for name, fn in pieces.items():
        ev_ms = median_ms(fn, 3)
        if name.startswith("CSR values"):
            log(f"{label}: {name} {ev_ms:.3f} ms (CUDA events)")
            continue
        dv_ms, n_k = device_ms(fn, 2, required=False)
        log(f"{label}: {name} {ev_ms:.3f} ms (CUDA events), {dv_ms:.3f} ms "
            f"device time in {n_k} kernels")


def nd_levels(nd):
    """(nn, s, b) of every level of ``nd``, checked against the front
    kernels' gate 1 < s <= 1000."""
    levels = [(lev.nn, lev.smax, lev.bmax) for lev in nd.levels]
    if not all(1 < m <= 1000 for _, m, _ in levels):
        raise RuntimeError(f"ND tree has a level outside 1 < s <= 1000: {levels}")
    return levels


VE8_RUNS = ("gmres+ndlu", "tpu_direct", "transient")


def ve8_run(label, device):
    """One of phase 14's runs on ``device``: the 8x4 viscoelastic deck on
    ``gmres+ndlu`` or ``tpu_direct`` steady, or the transient start-up;
    (failure message or None, Newton count(s), x, log line or None)."""
    from goma_tpu_torch.solvers import NewtonSolver
    from goma_tpu_torch.solvers.transient import TransientSolver

    opts_fn = ve_direct_opts if label == "tpu_direct" else ve_opts
    p = ve_problem(4, device, transient=label == "transient")
    x0 = np.zeros(p.dofmap.n_dof)
    if label == "transient":
        r = TransientSolver(p, opts_fn(), ve_time_opts()).run(x0, p.base_params())
        bad = (None if len(r.steps) == 5 and all(s.converged for s in r.steps)
               else f"8x4 VE start-up on {device}: {r.steps}")
        return bad, [s.newton_iters for s in r.steps], r.x, None
    r = NewtonSolver(p, opts_fn()).solve(x0, p.base_params())
    bad = (None if r.converged else f"8x4 VE deck {label} did not converge "
           f"on {device}:\n{r.summary()}")
    return bad, r.iters, r.x, (f"8x4 VE {label} on {device}: Newton {r.iters}, "
                               f"linear {r.linear_iters}, ||R||_2 "
                               f"{r.res_norms[-1][1]:.3e}")


def cross_check_ve():
    """Phases 14 and 17 (first part): the 8x4 viscoelastic deck on cuda and
    on cpu (the CPU runs from ``cpu_runs``), ``gmres+ndlu`` and
    ``tpu_direct`` steady and the transient start-up; the same Newton
    counts (every step's), x within VE_X_TOL."""
    cpu = cpu_runs("ve8", lambda: {label: ve8_run(label, torch.device("cpu"))
                                   for label in VE8_RUNS})
    for label in VE8_RUNS:
        its, xs = {}, {}
        for d, run in (("cuda", ve8_run(label, torch.device("cuda"))),
                       ("cpu", cpu[label])):
            bad, its[d], xs[d], line = run
            if bad:
                raise RuntimeError(bad)
            if line:
                log(line)
        dx = rel_dx(xs["cuda"], xs["cpu"])
        log(f"cross-check 8x4 viscoelastic {label}: Newton cuda {its['cuda']} "
            f"cpu {its['cpu']}, max |x_cuda - x_cpu| / (1 + |x_cpu|) = "
            f"{dx:.2e}")
        if its["cuda"] != its["cpu"] or dx > VE_X_TOL:
            raise RuntimeError(f"8x4 viscoelastic {label}: cuda and cpu differ "
                               f"(Newton {its}, x {dx:.2e} > {VE_X_TOL:.0e})")


def ve_gmres_phase(dev):
    """Phase 15: the viscoelastic gmres+ndlu main path at 64x32 and the
    kernels on its tree. Returns the numbers the kernel summary reads."""
    from goma_tpu_torch.solvers import NewtonSolver

    t0 = time.perf_counter()
    prob = ve_problem(N_VE, dev)
    solver = NewtonSolver(prob, ve_opts())
    nd = solver.precond
    levels = nd_levels(nd)
    slots = sum(nn * (m + b) ** 2 for nn, m, b in levels)
    log(f"viscoelastic setup: {2 * N_VE}x{N_VE}, {prob.dofmap.n_dof} dof, "
        f"{prob.pattern.nnz} nnz, {len(levels)} ND levels (nn, s, b) = "
        f"{levels}, {slots} front slots, {time.perf_counter() - t0:.1f} s")
    params = prob.base_params()
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)

    def scaled(x):
        """The CSR values the main path factors at ``x``."""
        return solver._scaled_vals(x, params, solver._prepare_fast(x, params)[2])

    vals = scaled(x0)
    max_abs = check_real_fronts(nd, vals, "viscoelastic x=0")
    shapes = [(nn, m) for nn, m, _ in levels]
    lu_abs, lu_ms = lu_shapes(shapes, "viscoelastic", time_twin=True)
    factor_split_ms(nd, vals, "viscoelastic tree")
    gather_abs = check_gathers(nd, vals, "viscoelastic tree")
    g_times, g_bound = gather_times(nd, vals, "viscoelastic tree")

    res, _, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof), params,
                                 "viscoelastic gmres+ndlu")
    if not res.converged or res.res_norms[-1][1] > VE_TOL:
        raise RuntimeError(f"viscoelastic main path did not converge to {VE_TOL}")
    if abs(res.iters - VE_NEWTON) > 1:
        raise RuntimeError(f"viscoelastic main path took {res.iters} Newton "
                           f"iterations, not {VE_NEWTON} +- 1")
    if res.linear_iters != VE_LINEAR:
        raise RuntimeError(f"viscoelastic main path: linear iterations "
                           f"{res.linear_iters} != {VE_LINEAR}")
    nf = solver.n_factor
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"viscoelastic front-LU launches {ln['lu']} / "
                           f"front-gather launches {ln['gather']} != "
                           f"{len(levels)} levels x {nf} factorizations")
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError("viscoelastic solution has the wrong shape or "
                           "non-finite values")
    xc = torch.as_tensor(x, dtype=prob.dtype, device=dev)
    max_abs = max(max_abs, lu_abs,
                  check_real_fronts(nd, scaled(xc), "viscoelastic converged"))
    where_time_goes(prob, nd, vals, x0, params, "viscoelastic")
    return {"prob": prob, "x": x, "launches": ln, "max_abs": max_abs,
            "lu_ms": lu_ms, "lu_bound": lu_bound(shapes),
            "gather_abs": gather_abs, "g_times": g_times, "g_bound": g_bound}


def ve_direct_phase(dev, prob, x_gmres):
    """Phase 16: the viscoelastic tpu_direct main path at 64x32 and the
    substitution kernel on its tree. Returns the numbers the kernel summary
    reads."""
    from goma_tpu_torch.solvers import NewtonSolver

    t0 = time.perf_counter()
    solver = NewtonSolver(prob, ve_direct_opts())
    params = prob.base_params()
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
    R, vals, _, scale, _ = solver._prepare(x0, params)
    nd = solver._direct_ndlu(vals)
    levels = nd_levels(nd)
    log(f"viscoelastic tpu_direct setup: {len(levels)} ND levels (nn, s, b) = "
        f"{levels}, {time.perf_counter() - t0:.1f} s")
    max_abs = check_real_fronts(nd, vals, "viscoelastic tpu_direct x=0")
    calls = []
    nd.solve(nd.factor(vals), scale * R, trace=calls)
    if len(calls) != 2 * len(levels):
        raise RuntimeError(f"one viscoelastic solve made {len(calls)} "
                           f"substitutions, not 2 x {len(levels)} levels")
    trsv = check_substitutions(calls, "viscoelastic")
    # device ns per dependent step of the two top levels, lower and upper
    # sweeps averaged: each front's m steps run one after another
    step_ns = {}
    for li in (len(levels) - 2, len(levels) - 1):
        t = [1e6 * k / m for lv, nn, m, _, k, _ in trsv["levels"] if lv == li]
        nn, m, _ = levels[li]
        step_ns[f"({nn}, {m})"] = sum(t) / len(t)
    log(f"trsv viscoelastic: device ns per dependent step (level device time "
        f"/ m, both sweeps averaged): " + ", ".join(
            f"level {k} {v:.1f} ns" for k, v in step_ns.items()))

    res, _, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof), params,
                                 "viscoelastic tpu_direct")
    if not res.converged or res.res_norms[-1][1] > VE_TOL:
        raise RuntimeError(f"viscoelastic tpu_direct did not converge to {VE_TOL}")
    solves, nf = nd.n_solve, solver._ndlu_nfactor
    if solves < 1 or ln["trsv"] != 2 * len(levels) * solves:
        raise RuntimeError(f"viscoelastic substitution launches {ln['trsv']} "
                           f"!= 2 x {len(levels)} levels x {solves} solves")
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"viscoelastic tpu_direct front-LU launches "
                           f"{ln['lu']} / front-gather launches {ln['gather']} "
                           f"!= {len(levels)} levels x {nf} factorizations")
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError("viscoelastic tpu_direct solution has the wrong "
                           "shape or non-finite values")
    dx = rel_dx(x, x_gmres)
    log(f"viscoelastic tpu_direct vs gmres+ndlu: max |x_direct - x_gmres| / "
        f"(1 + |x_gmres|) = {dx:.3e}")
    if dx > VE_PATHS_TOL:
        raise RuntimeError(f"viscoelastic tpu_direct and gmres+ndlu solutions "
                           f"differ by {dx:.3e} > {VE_PATHS_TOL:.0e}")
    factor_split_ms(nd, vals, "viscoelastic tpu_direct tree")
    return {"launches": ln, "max_abs": max_abs, "trsv": trsv,
            "bound": trsv_bound(calls), "step_ns": step_ns}


def ve_transient_phase(dev):
    """Phase 17 (second part): the start-up of the 64x32 deck through
    ``TransientSolver``. Returns the launch counts."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather
    from goma_tpu_torch.solvers.transient import TransientSolver

    t0 = time.perf_counter()
    prob = ve_problem(N_VE, dev, transient=True)
    ts = TransientSolver(prob, ve_opts(), ve_time_opts())
    n_lev = len(nd_levels(ts.newton.precond))
    log(f"viscoelastic transient setup: {time.perf_counter() - t0:.1f} s")
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ts.run(np.zeros(prob.dofmap.n_dof), prob.base_params())
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
          "gather": front_gather.launches}
    for s in r.steps:
        log(f"viscoelastic transient step: {s}")
    nf = ts.newton.n_factor
    its = sum(s.newton_iters for s in r.steps)
    log(f"viscoelastic transient: {len(r.steps)} steps to t = {r.t:.4f}, "
        f"{its} Newton iterations, {nf} factorizations, front-LU launches "
        f"{ln['lu']}, front-gather launches {ln['gather']}; {sec:.3f} s, "
        f"{sec / max(its, 1):.4f} s per Newton iteration")
    if (len(r.steps) != 5 or r.n_failures or abs(r.t - 0.25) > 1e-12
            or not all(s.converged and abs(s.dt - 0.05) < 1e-12 for s in r.steps)):
        raise RuntimeError(f"viscoelastic start-up did not take 5 converged "
                           f"steps of dt 0.05: {r.steps}")
    if [s.newton_iters for s in r.steps] != VE_STARTUP_NEWTON:
        raise RuntimeError(f"viscoelastic start-up: Newton per step "
                           f"{[s.newton_iters for s in r.steps]} != "
                           f"{VE_STARTUP_NEWTON}")
    if nf < 1 or ln["lu"] != n_lev * nf or ln["gather"] != n_lev * nf:
        raise RuntimeError(f"viscoelastic transient front-LU launches "
                           f"{ln['lu']} / front-gather launches {ln['gather']} "
                           f"!= {n_lev} levels x {nf} factorizations")
    if not np.all(np.isfinite(r.x)):
        raise RuntimeError("viscoelastic start-up state is not finite")
    return ln


def bubble_problem(n, device):
    """bench.bench_two_phase's static bubble restated (bench.py imports
    jax): QUAD9 n x n on [-1, 1]^2, transient Momentum, Continuity, the CSF
    surface tension (sigma = 1) and the level-set advection (Q2, no SUPG),
    rho = mu = 1, no-slip walls, pressure pinned at node 0, float32
    Jacobian. Returns (problem, x0 with F0 = |x| - r0, params with
    ls_eps = 0.2)."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import (Continuity, CSFSurfaceTension,
                                        FillEquation, Momentum)

    mesh = rectangle_mesh(n, n, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, transient=True), Continuity(),
                          CSFSurfaceTension(dim=2, sigma=1.0),
                          FillEquation(interp="Q2", supg=0.0, transient=True)],
                   {"rho": 1.0, "mu": 1.0}, device=device)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = torch.float32
    F0 = np.linalg.norm(mesh.coords, axis=1) - 0.5
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, F0)
    params = prob.base_params(ls_eps=torch.tensor(0.2, dtype=prob.dtype,
                                                  device=prob.device))
    return prob, x0, params


def bubble_opts(rung):
    """bench.bench_two_phase's Newton options for ``rung``."""
    from goma_tpu_torch.solvers import NewtonOptions

    if rung == "gmres_ndlu":
        return NewtonOptions(max_iter=10, tol_residual=1e-8,
                             linear_solver="gmres", precond="ndlu",
                             linear_tol=1e-6, gmres_restart=60,
                             linear_maxiter=240, ndlu_leaf_max=256)
    return NewtonOptions(max_iter=10, tol_residual=1e-8,
                         linear_solver="tpu_direct")


def bubble_solver(prob, rung):
    """bench.bench_two_phase's TransientSolver: backward Euler, dt 0.02,
    no adaptation, the warm leg to t = 0.04."""
    from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver

    return TransientSolver(prob, bubble_opts(rung),
                           TimeOptions(dt0=0.02, t_end=0.04, adapt=False))


def laplace_jump(prob, x):
    """dp = median p(r < 0.3) - median p(r > 0.8), bench.py's reading."""
    p = prob.get_nodal_field(x, "pressure")
    rr = np.linalg.norm(prob.mesh.coords, axis=1)
    return float(np.nanmedian(p[rr < 0.3]) - np.nanmedian(p[rr > 0.8]))


def step_params(params, x, dt):
    """The params of a backward-Euler step of ``dt`` from ``x``: the
    Jacobian the step factors is ct M + K(x) with ct = 1/dt."""
    p = dict(params)
    ct = 1.0 / dt
    p["ct"] = torch.tensor(ct, dtype=params["hist"].dtype,
                           device=params["hist"].device)
    p["hist"] = torch.as_tensor(-ct * x, dtype=params["hist"].dtype,
                                device=params["hist"].device)
    return p


BUBBLE8_RUNGS = ("gmres_ndlu", "tpu_direct")


def bubble8_run(rung, device):
    """One of phase 18's runs on ``device``: the 8x8 static bubble's two
    backward-Euler steps on ``rung``; (failure message or None, Newton per
    step, x)."""
    prob, x0, params = bubble_problem(8, device)
    r = bubble_solver(prob, rung).run(x0, params)
    bad = (None if len(r.steps) == 2 and all(s.converged for s in r.steps)
           else f"8x8 bubble {rung} on {device}: {r.steps}")
    return bad, [s.newton_iters for s in r.steps], r.x


def cross_check_bubble():
    """Phase 18: the 8x8 static bubble on cuda and on cpu (the CPU runs from
    ``cpu_runs``), both rungs, bench.py's two backward-Euler steps: the same
    Newton count in every step, x within BUBBLE_X_TOL."""
    cpu = cpu_runs("bubble8", lambda: {r: bubble8_run(r, torch.device("cpu"))
                                       for r in BUBBLE8_RUNGS})
    for rung in BUBBLE8_RUNGS:
        its, xs = {}, {}
        for d, run in (("cuda", bubble8_run(rung, torch.device("cuda"))),
                       ("cpu", cpu[rung])):
            bad, its[d], xs[d] = run
            if bad:
                raise RuntimeError(bad)
        dx = rel_dx(xs["cuda"], xs["cpu"])
        log(f"cross-check 8x8 static bubble {rung}: Newton per step cuda "
            f"{its['cuda']} cpu {its['cpu']}, max |x_cuda - x_cpu| / (1 + "
            f"|x_cpu|) = {dx:.2e}")
        if its["cuda"] != its["cpu"] or dx > BUBBLE_X_TOL:
            raise RuntimeError(f"8x8 static bubble {rung}: cuda and cpu differ "
                               f"(Newton {its}, x {dx:.2e} > {BUBBLE_X_TOL:.0e})")


def transient_legs(ts, x0, params, label):
    """bench._transient_sec_per_iter's protocol: a warm leg over [0, 0.04],
    then ``reset_lagged()``, every factorization, solve and launch count
    set to 0, and the timed leg to t = 0.08 from the warm leg's x, t and
    xdot. (bench.py carries the lagged factor into the timed leg; the reset
    makes the timed leg factor, so its kernels launch in the run that is
    read.) Returns (timed-leg result, seconds, launches, per-step Newton
    results, warm-leg result)."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather

    sv = ts.newton
    t0 = time.perf_counter()
    r1 = ts.run(x0, params)
    torch.cuda.synchronize()
    log(f"{label} warm leg: {time.perf_counter() - t0:.2f} s, "
        f"{len(r1.steps)} steps, Newton {[s.newton_iters for s in r1.steps]}")
    sv.reset_lagged()
    sv.n_factor = sv._ndlu_nfactor = sv.n_discarded = 0
    sv.direct_log = []
    if sv._ndlu is not None:
        sv._ndlu.n_solve = 0
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    per_step = []
    ts.topts.t_end = 0.08
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = ts.run(r1.x, params, t0=r1.t, xdot0=r1.xdot,
                callback=lambda t, x, xdot, res: per_step.append(res))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
          "gather": front_gather.launches}
    nit = sum(s.newton_iters for s in r2.steps if s.converged)
    asm = sum(r.assembly_time for r in per_step)
    slv = sum(r.solve_time for r in per_step)
    for s, r in zip(r2.steps, per_step):
        log(f"{label} timed step t={s.t:.4f} dt={s.dt:.3g}: Newton "
            f"{s.newton_iters}, linear {r.linear_iters}, ||R||_2 "
            f"{[f'{n[1]:.3e}' for n in r.res_norms]}")
    solves = (f", NDLU solves {sv._ndlu.n_solve}" if sv._ndlu is not None
              else "")
    log(f"{label} timed leg: {len(r2.steps)} steps to t = {r2.t:.4f}, {nit} "
        f"Newton iterations, factorizations {sv.n_factor + sv._ndlu_nfactor}"
        f"{solves}, discarded speculative solves {sv.n_discarded}, launches "
        f"front-LU {ln['lu']} front-gather {ln['gather']} substitution "
        f"{ln['trsv']}; asm {asm / max(nit, 1) * 1e3:.1f} ms + slv "
        f"{slv / max(nit, 1) * 1e3:.1f} ms per iteration, "
        f"{sec / max(nit, 1):.4f} s/iter (total {sec:.3f} s)")
    if (len(r2.steps) != 2 or r2.n_failures or abs(r2.t - 0.08) > 1e-12
            or not all(s.converged for s in r2.steps)):
        raise RuntimeError(f"{label}: the timed leg did not take 2 converged "
                           f"steps to t = 0.08: {r2.steps}")
    if not np.all(np.isfinite(r2.x)) or r2.x.shape != x0.shape:
        raise RuntimeError(f"{label}: end state has the wrong shape or "
                           "non-finite values")
    return r2, sec, ln, per_step, r1


def bubble_gmres_phase(dev):
    """Phase 19: the static bubble's gmres_ndlu rung at 48x48 and the
    kernels on its tree. Returns the numbers the kernel summary reads."""
    t0 = time.perf_counter()
    prob, x0, params = bubble_problem(N_BUBBLE, dev)
    ts = bubble_solver(prob, "gmres_ndlu")
    solver = ts.newton
    nd = solver.precond
    levels = nd_levels(nd)
    slots = sum(nn * (m + b) ** 2 for nn, m, b in levels)
    log(f"two-phase setup: {N_BUBBLE}x{N_BUBBLE}, {prob.dofmap.n_dof} dof, "
        f"{prob.pattern.nnz} nnz, {len(levels)} ND levels (nn, s, b) = "
        f"{levels}, {slots} front slots, {time.perf_counter() - t0:.1f} s")

    def scaled(x):
        """The CSR values the main path factors in a step from ``x``."""
        xt = torch.as_tensor(x, dtype=prob.dtype, device=dev)
        p = step_params(params, x, 0.02)
        return solver._scaled_vals(xt, p, solver._prepare_fast(xt, p)[2])

    vals = scaled(x0)
    max_abs = check_real_fronts(nd, vals, "two-phase x0")
    shapes = [(nn, m) for nn, m, _ in levels]
    lu_abs, lu_ms = lu_shapes(shapes, "two-phase", time_twin=True)
    gather_abs = check_gathers(nd, vals, "two-phase tree")
    g_times, g_bound = gather_times(nd, vals, "two-phase tree")

    res, _, ln, _, warm = transient_legs(ts, x0, params, "two-phase gmres_ndlu")
    nf = solver.n_factor
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"two-phase front-LU launches {ln['lu']} / "
                           f"front-gather launches {ln['gather']} != "
                           f"{len(levels)} levels x {nf} factorizations")
    dp = laplace_jump(prob, res.x)
    log(f"two-phase gmres_ndlu: Laplace jump dp = {dp:.5f} (sigma / r0 = "
        f"{BUBBLE_DP}, rel err {abs(dp - BUBBLE_DP) / BUBBLE_DP:.4f})")
    if not abs(dp - BUBBLE_DP) <= BUBBLE_DP_RTOL * BUBBLE_DP:
        raise RuntimeError(f"two-phase Laplace jump {dp:.4f} not within "
                           f"{BUBBLE_DP_RTOL:.0%} of {BUBBLE_DP}")
    max_abs = max(max_abs, lu_abs,
                  check_real_fronts(nd, scaled(res.x), "two-phase end state"))
    newton = {leg: [st.newton_iters for st in r.steps]
              for leg, r in (("warm", warm), ("timed", res))}
    return {"prob": prob, "params": params, "x": res.x, "launches": ln,
            "newton": newton,
            "max_abs": max_abs, "lu_ms": lu_ms, "lu_bound": lu_bound(shapes),
            "gather_abs": gather_abs, "g_times": g_times, "g_bound": g_bound}


def bubble_direct_phase(dev, prob, params, x_gmres):
    """Phase 20: the static bubble's tpu_direct rung at 48x48 and the
    substitution kernel on its tree. Returns the numbers the kernel summary
    reads."""
    t0 = time.perf_counter()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              np.linalg.norm(prob.mesh.coords, axis=1) - 0.5)
    ts = bubble_solver(prob, "tpu_direct")
    solver = ts.newton
    xt = torch.as_tensor(x0, dtype=prob.dtype, device=dev)
    p = step_params(params, x0, 0.02)
    R, vals, _, scale, _ = solver._prepare(xt, p)
    nd = solver._direct_ndlu(vals)  # the NDLU the rung will use
    levels = nd_levels(nd)
    log(f"two-phase tpu_direct setup: {len(levels)} ND levels (nn, s, b) = "
        f"{levels}, {time.perf_counter() - t0:.1f} s")
    calls = []
    nd.solve(nd.factor(vals), scale * R, trace=calls)
    if len(calls) != 2 * len(levels):
        raise RuntimeError(f"one two-phase solve made {len(calls)} "
                           f"substitutions, not 2 x {len(levels)} levels")
    trsv = check_substitutions(calls, "two-phase")

    res, _, ln, _, _ = transient_legs(ts, x0, params, "two-phase tpu_direct")
    solves, nf = nd.n_solve, solver._ndlu_nfactor
    if solves < 1 or ln["trsv"] != 2 * len(levels) * solves:
        raise RuntimeError(f"two-phase substitution launches {ln['trsv']} != "
                           f"2 x {len(levels)} levels x {solves} solves")
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"two-phase tpu_direct front-LU launches "
                           f"{ln['lu']} / front-gather launches {ln['gather']} "
                           f"!= {len(levels)} levels x {nf} factorizations")
    for i, (sweeps, rel, fresh) in enumerate(solver.direct_log):
        log(f"two-phase tpu_direct solve {i}: {sweeps} refinement sweeps, rel "
            f"residual {rel:.3e}, {'fresh' if fresh else 'lagged'} factor")
    dp = laplace_jump(prob, res.x)
    dx = rel_dx(res.x, x_gmres)
    log(f"two-phase tpu_direct: dp = {dp:.5f}; vs gmres_ndlu: max |x_direct "
        f"- x_gmres| / (1 + |x_gmres|) = {dx:.3e}")
    if dx > BUBBLE_PATHS_TOL:
        raise RuntimeError(f"two-phase tpu_direct and gmres_ndlu end states "
                           f"differ by {dx:.3e} > {BUBBLE_PATHS_TOL:.0e}")
    return {"launches": ln, "trsv": trsv, "bound": trsv_bound(calls)}


def count_syncs(fn):
    """(fn(), host syncs): the synchronizing CUDA operations torch reports
    under ``set_sync_debug_mode("warn")`` while ``fn`` runs."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def pipelined_phase(solver, x_init, params):
    """Phase 21: the 64x64 cavity's gmres+ndlu deck (phase 5's solver),
    which ``solve`` routes to the pipelined loop, against
    ``_solve_sequential`` on the same deck, in turns (pipelined,
    sequential, sequential, pipelined), each from ``reset_lagged()``: the
    same Newton and linear iterations (CAVITY_LINEAR), norms within
    PIPE_NORM_RTOL; s/iteration, host syncs per Newton iteration and
    discarded speculative solves of each. Returns the launches of each
    loop's last run."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.front_gather import front_gather

    loops = {"pipelined": solver.solve, "sequential": solver._solve_sequential}
    runs = {k: [] for k in loops}
    for name in ("pipelined", "sequential", "sequential", "pipelined"):
        solver.reset_lagged()
        solver.n_factor = solver.n_discarded = 0
        batched_lu.launches = front_gather.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, syncs = count_syncs(lambda: loops[name](x_init, params))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        its = max(res.iters, 1)
        ln = {"lu": batched_lu.launches, "gather": front_gather.launches,
              "trsv": 0}
        runs[name].append((res, ln))
        log(f"pipelined vs sequential, {name}: iters={res.iters} converged="
            f"{res.converged} lin={res.linear_iters} ||R||_2="
            f"{[f'{n[1]:.6e}' for n in res.res_norms]}; {sec / its:.4f} s/iter "
            f"(asm {res.assembly_time / its * 1e3:.1f} ms + slv "
            f"{res.solve_time / its * 1e3:.1f} ms); {syncs} host syncs, "
            f"{syncs / its:.1f} per Newton iteration; discarded speculative "
            f"solves {solver.n_discarded}; factorizations {solver.n_factor}, "
            f"front-LU launches {ln['lu']}")
        if not res.converged or res.linear_iters != CAVITY_LINEAR:
            raise RuntimeError(f"cavity {name} loop: linear iterations "
                               f"{res.linear_iters} != {CAVITY_LINEAR}")
        nf = solver.n_factor
        if nf < 1 or ln["lu"] != len(solver.precond.levels) * nf:
            raise RuntimeError(f"cavity {name} loop: front-LU launches "
                               f"{ln['lu']} != levels x {nf} factorizations")
    ref = runs["sequential"][0][0].res_norms
    worst = 0.0
    for res, _ in runs["pipelined"] + runs["sequential"]:
        for a, b in zip(res.res_norms, ref):
            worst = max(worst, max(abs(u - v) / max(abs(v), 1e-300)
                                   for u, v in zip(a, b)))
    log(f"pipelined vs sequential: norm sequences within rel {worst:.2e} "
        f"(limit {PIPE_NORM_RTOL:.0e})")
    if worst > PIPE_NORM_RTOL:
        raise RuntimeError(f"pipelined and sequential norm sequences differ by "
                           f"rel {worst:.2e} > {PIPE_NORM_RTOL:.0e}")
    return {k: v[-1][1] for k, v in runs.items()}


def slot_coater_problem(nx, ny, rung, device, t_end=SC_WARM_T,
                        newton_overrides=None):
    """examples/slot_coater.py::build restated (it imports goma_tpu), with
    bench.bench_slot_coater's options for ``rung``: ``gmres_ndlu`` (float32
    Jacobian, ``precond="ndlu"``, leaf 256, linear_tol 1e-5, the loose-eta
    endgame, prep32_tol 3e-6) or ``tpu_direct`` (the deck's own options:
    float64 Jacobian, linear_tol 1e-9, damp 0.9, leaf 96). Transient
    Momentum + Continuity + EllipticMesh, capillary and kinematic face
    kernels on the free surface, the quality-guarded adaptive driver.
    ``finalize`` keeps the first Dirichlet spec at a duplicated dof (the
    values agree there). Returns (problem, TransientSolver, x0)."""
    from goma_tpu_torch.bc import CapillaryBC, KinematicBC
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.mesh.mesh import SideSet
    from goma_tpu_torch.physics import Continuity, EllipticMesh, Momentum
    from goma_tpu_torch.solvers import NewtonOptions
    from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver

    U, mu, rho, sigma, x_die, L, H = 1.0, 0.1, 0.05, 1.0, 1.5, 4.0, 1.0
    mesh = rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, L), ylim=(0, H))
    # split the top side set at the die lip, snapped to an element boundary
    ss = mesh.sidesets["top"]
    xc, xr = [], []
    for e, f in zip(ss.elems, ss.faces):
        bi, le = mesh.global_elem_block(int(e))
        xs_f = mesh.coords[mesh.blocks[bi].conn[le], 0]
        xc.append(xs_f.mean())
        xr.append(xs_f.max())
    xc, xr = np.asarray(xc), np.asarray(xr)
    die = xc < x_die
    x_lip = xr[die].max()
    mesh.sidesets["die"] = SideSet(ss.elems[die], ss.faces[die])
    mesh.sidesets["free"] = SideSet(ss.elems[~die], ss.faces[~die])
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    mesh.nodesets["die_nodes"] = top[xt <= x_lip + 1e-12]
    mesh.nodesets["free_nodes"] = top[xt >= x_lip - 1e-12]
    prob = Problem(mesh, [Momentum(dim=2, transient=True), Continuity(),
                          EllipticMesh(2)],
                   {"rho": rho, "mu": mu, "sigma": sigma}, device=device)
    couette = lambda c: U * (1 - c[:, 1] / H)  # noqa: E731
    for ns, var, comp, val in (
            ("bottom", "velocity", 0, U), ("bottom", "velocity", 1, 0.0),
            ("bottom", "mesh_displacement", 0, 0.0),
            ("bottom", "mesh_displacement", 1, 0.0),
            ("left", "velocity", 0, couette), ("left", "velocity", 1, 0.0),
            ("left", "mesh_displacement", 0, 0.0),
            ("left", "mesh_displacement", 1, 0.0),
            ("free_nodes", "mesh_displacement", 0, 0.0)):
        prob.add_dirichlet(ns, var, comp, val)
    prob.add_face_kernel("free", CapillaryBC(dim=2, p_ext=0.0))
    prob.add_face_kernel("free", KinematicBC(dim=2, penalty=1e3))
    for ns, var, comp, val in (
            ("right", "velocity", 0, U), ("right", "velocity", 1, 0.0),
            ("right", "mesh_displacement", 0, 0.0),
            ("die_nodes", "velocity", 0, 0.0), ("die_nodes", "velocity", 1, 0.0),
            ("die_nodes", "mesh_displacement", 0, 0.0),
            ("die_nodes", "mesh_displacement", 1, 0.0)):
        prob.add_dirichlet(ns, var, comp, val)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity", 0,
                              couette)

    def dy0(c):
        s = np.clip((c[:, 0] - x_lip) / 1.0, 0.0, 1.0)
        h_t = H + (0.5 * H - H) * s * s * (3 - 2 * s)
        return (h_t - H) * (c[:, 1] / H)

    x0 = prob.set_nodal_field(x0, "mesh_displacement", 1, dy0)
    for ns in ("bottom", "left", "die_nodes"):
        d = prob.dofmap.dof_of_node_svar[mesh.nodesets[ns],
                                         prob.dofmap.svar("mesh_displacement", 1)]
        x0[d[d >= 0]] = 0.0
    nopts = dict(max_iter=20, tol_residual=3e-8, linear_solver="tpu_direct",
                 linear_tol=1e-9, precond="twolevel", gmres_restart=40,
                 linear_maxiter=1200, damp=0.9)
    if rung == "gmres_ndlu":
        prob.jacobian_dtype = torch.float32
        nopts.update(linear_solver="gmres", precond="ndlu", gmres_restart=60,
                     linear_maxiter=240, ndlu_leaf_max=256, linear_tol=1e-5,
                     ew_eta_floor=1e-3, ew_endgame="standard", prep32_tol=3e-6)
    nopts.update(newton_overrides or {})
    ts = TransientSolver(prob, NewtonOptions(**nopts), TimeOptions(
        dt0=0.01, t_end=t_end, theta=0.0, adapt=True, eps_time=1e3,
        rel_tol=1.0, growth_cap=2.0, max_dt=0.5, quality_guard=True,
        max_failures=25))
    return prob, ts, x0


def record_attempts(ts):
    """Log every attempt of ``ts``'s driver: a list of dicts (t, dt,
    Newton and linear iterations, converged, min detJ, outcome), filled by
    wrapping the Newton solve and the quality reduction; ``classify``
    names each outcome after a run."""
    from goma_tpu_torch.post.quality import make_quality_fn

    log_ = []
    solve, quality = ts.newton.solve, make_quality_fn(ts.problem)

    def rec_solve(x, p):
        r = solve(x, p)
        log_.append({"t": float(p["time"]), "dt": 1.0 / float(p["ct"]),
                     "newton": r.iters, "linear": sum(r.linear_iters),
                     "converged": bool(r.converged), "min_detJ": None,
                     "res": r})
        return r

    def rec_quality(x):
        out = quality(x)
        log_[-1]["min_detJ"] = out[0]  # read by classify, after the run
        return out

    ts.newton.solve, ts._quality_fn = rec_solve, rec_quality
    return log_


def classify(attempts, steps):
    """Name each attempt's outcome: accepted (its end time is the next
    accepted step's), failed Newton, rejected by quality (min detJ <= 0)
    or rejected by the error test."""
    k = 0
    for a in attempts:
        if a["min_detJ"] is not None:
            a["min_detJ"] = float(a["min_detJ"])
        if not a["converged"]:
            a["outcome"] = "failed Newton"
        elif a["min_detJ"] is not None and a["min_detJ"] <= 0.0:
            a["outcome"] = "rejected by quality"
        elif k < len(steps) and abs(steps[k].t - a["t"]) < 1e-12:
            a["outcome"] = "accepted"
            k += 1
        else:
            a["outcome"] = "rejected by error"
    if k != len(steps):
        raise RuntimeError("the attempt log does not hold every accepted step")


def record_factor_vals(nd):
    """Keep the CSR values of the first and the last factorization of
    ``nd`` (``NDLU.factor`` wrapped): {"first", "last", "n"}."""
    seen = {"n": 0}
    factor = nd.factor

    def rec(vals, *a, **k):
        seen.setdefault("first", vals)
        seen["last"], seen["n"] = vals, seen["n"] + 1
        return factor(vals, *a, **k)

    nd.factor = rec
    return seen


def free_surface_heights(prob, x):
    """h = H + dy at ten free-surface nodes (the ends included), sorted by
    x: [(x, h)]."""
    dy = prob.get_nodal_field(x, "mesh_displacement", 1)
    free = prob.mesh.nodesets["free_nodes"]
    xs = prob.mesh.coords[free, 0]
    order = np.argsort(xs)
    xs, h = xs[order], 1.0 + dy[free][order]
    idx = np.linspace(0, len(xs) - 1, 10).round().astype(int)
    return [(float(xs[i]), float(h[i])) for i in idx]


def slot_legs(ts, x0, params, label):
    """bench._transient_sec_per_iter's protocol on the slot coater: the
    warm leg [0, SC_WARM_T], then ``reset_lagged()``, every factorization,
    solve and launch count set to 0, and the timed leg to SC_END_T from the
    warm leg's x, t and xdot. Prints every attempt of both legs and the
    timed leg's factorizations, discarded speculative solves, asm/slv and
    bench's s/iter (converged steps' Newton iterations over the leg's wall
    time). Returns (warm result, timed result, seconds, launches, timed
    attempts)."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather

    sv = ts.newton
    attempts = record_attempts(ts)
    legs = []
    for leg in ("warm", "timed"):
        if leg == "timed":
            sv.reset_lagged()
            sv.n_factor = sv._ndlu_nfactor = sv.n_discarded = 0
            sv.direct_log = []
            if sv._ndlu is not None:
                sv._ndlu.n_solve = 0
            batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
            ts.topts.t_end = SC_END_T
            attempts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = (ts.run(x0, params) if leg == "warm" else
             ts.run(legs[0].x, params, t0=legs[0].t, xdot0=legs[0].xdot))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        classify(attempts, r.steps)
        for a in attempts:
            mn = "-" if a["min_detJ"] is None else f"{a['min_detJ']:.4e}"
            log(f"{label} {leg} attempt t={a['t']:.6f} dt={a['dt']:.6g}: "
                f"{a['outcome']}, Newton {a['newton']}, linear {a['linear']}, "
                f"min detJ {mn}")
        nit = sum(s.newton_iters for s in r.steps if s.converged)
        asm = sum(a["res"].assembly_time for a in attempts)
        slv = sum(a["res"].solve_time for a in attempts)
        log(f"{label} {leg} leg: {len(attempts)} attempts, {len(r.steps)} "
            f"accepted to t = {r.t:.4f}, Newton per accepted step "
            f"{[s.newton_iters for s in r.steps]}; {sec:.3f} s, "
            f"{sec / max(nit, 1):.4f} s/iter (bench's: converged steps' "
            f"{nit} Newton iterations); asm {asm:.3f} s + slv {slv:.3f} s")
        legs.append(r)
    ln = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
          "gather": front_gather.launches}
    solves = (f", NDLU solves {sv._ndlu.n_solve}" if sv._ndlu is not None
              else "")
    log(f"{label} timed leg: factorizations {sv.n_factor + sv._ndlu_nfactor}"
        f"{solves}, discarded speculative solves {sv.n_discarded}, launches "
        f"front-LU {ln['lu']} front-gather {ln['gather']} substitution "
        f"{ln['trsv']}")
    return legs[0], legs[1], sec, ln, list(attempts)


def check_slot_result(prob, rung, warm, timed, label):
    """The slot coater's end state against goma_tpu's 96x24 record: every
    accepted step converged, the same number of accepted steps in each leg
    with Newton +-1 per step, min detJ > 0 at the end, the free-surface
    heights within SC_H_TOL. Returns (min detJ, heights)."""
    from goma_tpu_torch.post.quality import element_quality

    ref = SC_REF_NEWTON[rung]
    for leg, r in (("warm", warm), ("timed", timed)):
        its = [s.newton_iters for s in r.steps]
        if not all(s.converged for s in r.steps):
            raise RuntimeError(f"{label} {leg} leg: an accepted step did not "
                               f"converge: {r.steps}")
        if len(its) != len(ref[leg]) or any(abs(a - b) > 1 for a, b in
                                            zip(its, ref[leg])):
            raise RuntimeError(f"{label} {leg} leg: Newton per accepted step "
                               f"{its}, goma_tpu {ref[leg]} (same count of "
                               "steps, +-1 each required)")
    if abs(timed.t - SC_END_T) > 1e-12:
        raise RuntimeError(f"{label}: the timed leg ended at t = {timed.t}")
    x = timed.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: end state has the wrong shape or "
                           "non-finite values")
    q = element_quality(prob, x)
    h = free_surface_heights(prob, x)
    dh = max(abs(a[1] - b[1]) for a, b in zip(h, SC_REF_HEIGHTS))
    dxs = max(abs(a[0] - b[0]) for a, b in zip(h, SC_REF_HEIGHTS))
    log(f"{label}: end min detJ {q.min_detJ:.6e}, max detJ {q.max_detJ:.6e}, "
        f"jacobian quality {q.jac_quality:.4f}; free surface (x, h) at t = "
        f"{timed.t:.4f}: " + ", ".join(f"({a:.4f}, {b:.6f})" for a, b in h)
        + f"; max |h - h_goma_tpu| = {dh:.3e} (limit {SC_H_TOL:.0e})")
    if not q.min_detJ > 0.0:
        raise RuntimeError(f"{label}: tangled mesh at the end (min detJ "
                           f"{q.min_detJ:.3e})")
    if dxs > 1e-12 or dh > SC_H_TOL:
        raise RuntimeError(f"{label}: free-surface heights differ from "
                           f"goma_tpu's by {dh:.3e} > {SC_H_TOL:.0e}")
    return q.min_detJ, h


SLOT_CASES = ("golden tpu_direct", "gmres_ndlu warm leg")


def slot_cross_check_run(case, dev):
    """One case of phase 22 on ``dev``: (attempts (t, dt, Newton, outcome),
    the end state, the accepted steps' Newton counts)."""
    if case.startswith("golden"):
        prob, ts, x0 = slot_coater_problem(
            16, 4, "tpu_direct", dev, t_end=0.06,
            newton_overrides=dict(forcing="fixed"))
        ts.topts.adapt, ts.topts.dt0 = False, 0.02
    else:
        prob, ts, x0 = slot_coater_problem(16, 4, "gmres_ndlu", dev)
    att = record_attempts(ts)
    r = ts.run(x0, prob.base_params())
    classify(att, r.steps)
    return ([(round(a["t"], 12), round(a["dt"], 12), a["newton"], a["outcome"])
             for a in att], np.asarray(r.x), [s.newton_iters for s in r.steps])


def cross_check_slot_coater(devices=("cuda", "cpu")):
    """Phase 22: the 16x4 slot coater on each of ``devices``: the golden
    deck (dt 0.02 without adaptation, forcing "fixed") on ``tpu_direct``,
    accepted steps' Newton SC_GOLDEN_NEWTON with the second attempt failed
    and halved; bench.py's ``gmres_ndlu`` rung over the warm leg: the same
    attempts (t, dt, Newton iterations, outcome) on both devices. x within
    SC_X_TOL for both. The CPU runs come from ``cpu_runs``."""
    for case in SLOT_CASES:
        runs = {}
        for d in devices:
            if d == "cpu":
                runs[d] = cpu_runs("slot", lambda: {
                    c: slot_cross_check_run(c, torch.device("cpu"))
                    for c in SLOT_CASES})[case]
            else:
                runs[d] = slot_cross_check_run(case, torch.device(d))
        a, b = devices
        (la, xa, its), (lb, xb, _) = runs[a], runs[b]
        dx = rel_dx(xa, xb)
        log(f"cross-check 16x4 slot coater {case}: {len(la)} attempts, "
            f"accepted Newton {its}; attempts {a} == {b}: {la == lb}; max "
            f"|x_{a} - x_{b}| / (1 + |x_{b}|) = {dx:.2e}")
        for t, dt, n, out in la:
            log(f"  attempt t={t:.6f} dt={dt:.6g}: Newton {n}, {out}")
        if la != lb or dx > SC_X_TOL:
            raise RuntimeError(f"16x4 slot coater {case}: {a} and {b} differ "
                               f"(attempts {la} / {lb}, x {dx:.2e} > "
                               f"{SC_X_TOL:.0e})")
        if case.startswith("golden") and (
                its != SC_GOLDEN_NEWTON or la[1][3] != "failed Newton"
                or la[2][1] != 0.01):
            raise RuntimeError(f"16x4 golden slot coater: Newton {its} != "
                               f"{SC_GOLDEN_NEWTON} or the second attempt was "
                               f"not failed and halved: {la[:3]}")


def slot_step_params(params, x, dt, t):
    """The params of a backward-Euler step of ``dt`` from ``x`` ending at
    ``t``."""
    p = step_params(params, x, dt)
    p["time"] = torch.tensor(t, dtype=p["hist"].dtype, device=p["hist"].device)
    return p


def slot_gmres_phase(dev):
    """Phase 23: the slot coater's gmres_ndlu rung at 96x24 and the kernels
    on its tree. Returns the numbers the kernel summary reads."""
    t0 = time.perf_counter()
    prob, ts, x0 = slot_coater_problem(SC_NX, SC_NY, "gmres_ndlu", dev)
    params = prob.base_params()
    solver = ts.newton
    nd = solver.precond
    levels = nd_levels(nd)
    slots = sum(nn * (m + b) ** 2 for nn, m, b in levels)
    log(f"slot coater setup: {SC_NX}x{SC_NY}, {prob.dofmap.n_dof} dof, "
        f"{prob.pattern.nnz} nnz, {prob.dofmap.blocks[0].n_ldof} local dofs, "
        f"{sum(f.face_elems.size for f in prob.face_sets)} free-surface faces, "
        f"{len(prob.bc_dup_log)} duplicated Dirichlet rows; gmres_ndlu tree "
        f"{len(levels)} ND levels (nn, s, b) = {levels}, {slots} front slots, "
        f"{time.perf_counter() - t0:.1f} s")

    def scaled(x, dt, t):
        """The CSR values the main path factors in a step of ``dt`` from
        ``x``."""
        xt = torch.as_tensor(x, dtype=prob.dtype, device=dev)
        p = slot_step_params(params, x, dt, t)
        return solver._scaled_vals(xt, p, solver._prepare_fast(xt, p)[2])

    vals = scaled(x0, 0.01, 0.01)  # the first step's state
    shapes = [(nn, m) for nn, m, _ in levels]
    lu_abs, lu_ms = lu_shapes(shapes, "slot coater", time_twin=True)
    gather_abs = check_gathers(nd, vals, "slot coater gmres_ndlu tree")
    g_times, g_bound = gather_times(nd, vals, "slot coater gmres_ndlu tree")
    factor_split_ms(nd, vals, "slot coater gmres_ndlu tree")

    fvals = record_factor_vals(nd)
    warm, timed, _, ln, _ = slot_legs(ts, x0, params, "slot coater gmres_ndlu")
    nf = solver.n_factor
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"slot coater front-LU launches {ln['lu']} / "
                           f"front-gather launches {ln['gather']} != "
                           f"{len(levels)} levels x {nf} factorizations")
    check_slot_result(prob, "gmres_ndlu", warm, timed, "slot coater gmres_ndlu")
    # the front LU on the real fronts of the run's first and last
    # factorization (the kinematic penalty 1e3 sits in the mesh rows)
    max_abs = max(lu_abs, *(check_real_fronts(
        nd, fvals[k], f"slot coater gmres_ndlu {k} of {fvals['n']} "
        "factorizations") for k in ("first", "last")))
    return {"prob": prob, "x": timed.x, "launches": ln, "max_abs": max_abs,
            "lu_ms": lu_ms, "lu_bound": lu_bound(shapes),
            "gather_abs": gather_abs, "g_times": g_times, "g_bound": g_bound}


def slot_direct_phase(dev, x_gmres):
    """Phase 24: the slot coater's tpu_direct rung at 96x24 (its own leaf-96
    tree) and the kernels on that tree. Returns the numbers the kernel
    summary reads."""
    t0 = time.perf_counter()
    prob, ts, x0 = slot_coater_problem(SC_NX, SC_NY, "tpu_direct", dev)
    params = prob.base_params()
    solver = ts.newton
    xt = torch.as_tensor(x0, dtype=prob.dtype, device=dev)
    R, vals, _, scale, _ = solver._prepare(
        xt, slot_step_params(params, x0, 0.01, 0.01))
    nd = solver._direct_ndlu(vals)  # the NDLU the rung will use
    levels = nd_levels(nd)
    slots = sum(nn * (m + b) ** 2 for nn, m, b in levels)
    log(f"slot coater tpu_direct setup: {len(levels)} ND levels (nn, s, b) = "
        f"{levels}, {slots} front slots, {time.perf_counter() - t0:.1f} s")
    calls = []
    nd.solve(nd.factor(vals), scale * R, trace=calls)
    if len(calls) != 2 * len(levels):
        raise RuntimeError(f"one slot coater solve made {len(calls)} "
                           f"substitutions, not 2 x {len(levels)} levels")
    trsv = check_substitutions(calls, "slot coater")
    step_ns = {}
    for li, (nn, m, _) in enumerate(levels):
        if m > 500:
            t = [1e6 * k / m for lv, _, _, _, k, _ in trsv["levels"] if lv == li]
            step_ns[f"({nn}, {m})"] = sum(t) / len(t)
    log("trsv slot coater: device ns per dependent step (level device time / "
        "m, both sweeps averaged) at the levels above m = 500: " + ", ".join(
            f"{k} {v:.1f} ns" for k, v in step_ns.items()))
    gather_abs = check_gathers(nd, vals, "slot coater tpu_direct tree")
    gather_times(nd, vals, "slot coater tpu_direct tree")
    factor_split_ms(nd, vals, "slot coater tpu_direct tree")

    fvals = record_factor_vals(nd)
    warm, timed, _, ln, _ = slot_legs(ts, x0, params, "slot coater tpu_direct")
    solves, nf = nd.n_solve, solver._ndlu_nfactor
    if solves < 1 or ln["trsv"] != 2 * len(levels) * solves:
        raise RuntimeError(f"slot coater substitution launches {ln['trsv']} "
                           f"!= 2 x {len(levels)} levels x {solves} solves")
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"slot coater tpu_direct front-LU launches "
                           f"{ln['lu']} / front-gather launches {ln['gather']} "
                           f"!= {len(levels)} levels x {nf} factorizations")
    check_slot_result(prob, "tpu_direct", warm, timed, "slot coater tpu_direct")
    log(f"slot coater tpu_direct vs gmres_ndlu at t = {SC_END_T}: max "
        f"|x_direct - x_gmres| / (1 + |x_gmres|) = "
        f"{rel_dx(timed.x, x_gmres):.3e}")
    max_abs = max(check_real_fronts(
        nd, fvals[k], f"slot coater tpu_direct {k} of {fvals['n']} "
        "factorizations") for k in ("first", "last"))
    return {"launches": ln, "max_abs": max_abs, "trsv": trsv,
            "bound": trsv_bound(calls), "step_ns": step_ns,
            "gather_abs": gather_abs}


def buoyant_direct_opts():
    """bench.bench_buoyant("tpu_direct")'s options restated."""
    from goma_tpu_torch.solvers import NewtonOptions

    return NewtonOptions(max_iter=15, tol_residual=1e-6,
                         linear_solver="tpu_direct", ndlu_leaf_max=256)


def buoyant_direct_phase(bprob, bx):
    """Phase 25: the 48x48 buoyant deck on bench.py's tpu_direct rung:
    6 +- 1 Newton iterations, substitution launches = 2 x levels x solves,
    front-LU and front-gather launches = levels x factorizations, x within
    BUOY_PATHS_TOL of phase 13's gmres+ndlu solution ``bx``."""
    from goma_tpu_torch.solvers import NewtonSolver

    solver = NewtonSolver(bprob, buoyant_direct_opts())
    res, _, ln = warm_then_timed(solver, np.zeros(bprob.dofmap.n_dof),
                                 bprob.base_params(), "buoyant tpu_direct")
    nd = solver._ndlu
    levels = nd_levels(nd)
    log(f"buoyant tpu_direct tree: {len(levels)} ND levels (nn, s, b) = "
        f"{levels}")
    if not res.converged or res.res_norms[-1][1] > 1e-6:
        raise RuntimeError("buoyant tpu_direct did not converge to 1e-6")
    if abs(res.iters - BUOY_NEWTON) > 1:
        raise RuntimeError(f"buoyant tpu_direct took {res.iters} Newton "
                           f"iterations, not {BUOY_NEWTON} +- 1")
    solves, nf = nd.n_solve, solver._ndlu_nfactor
    if solves < 1 or ln["trsv"] != 2 * len(levels) * solves:
        raise RuntimeError(f"buoyant substitution launches {ln['trsv']} != "
                           f"2 x {len(levels)} levels x {solves} solves")
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"buoyant tpu_direct front-LU launches {ln['lu']} / "
                           f"front-gather launches {ln['gather']} != "
                           f"{len(levels)} levels x {nf} factorizations")
    dx = rel_dx(res.x, bx)
    log(f"buoyant tpu_direct vs gmres+ndlu: max |x_direct - x_gmres| / "
        f"(1 + |x_gmres|) = {dx:.3e}")
    if not np.all(np.isfinite(res.x)) or dx > BUOY_PATHS_TOL:
        raise RuntimeError(f"buoyant tpu_direct and gmres+ndlu solutions "
                           f"differ by {dx:.3e} > {BUOY_PATHS_TOL:.0e}")
    return ln


def small_option_run(name, dev):
    """The 8x8 cavity (float64) with option ``name`` of SMALL_OPTIONS on
    ``dev``: (Newton result, seconds, preconditioner kind)."""
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver

    kw, coarse_solve, _ = SMALL_OPTIONS[name]
    p8 = cavity_problem(8, dev)
    p8.jacobian_dtype = None
    sv = NewtonSolver(p8, NewtonOptions(tol_residual=1e-8, **kw))
    if coarse_solve:
        sv.precond.coarse_solve = coarse_solve
    t0 = time.perf_counter()
    r = sv.solve(np.zeros(p8.dofmap.n_dof), p8.base_params())
    return r, time.perf_counter() - t0, sv._precond_kind


def small_options_phase():
    """Phase 26: the 8x8 cavity (float64) with each of goma_tpu's other
    preconditioners and linear solvers (SMALL_OPTIONS) on cuda and on cpu:
    the same Newton count, linear iterations per step within
    SMALL_LIN_TOL, x within phase 4's bound; each option's counts printed
    beside goma_tpu's. The CPU runs come from ``cpu_runs``."""
    cpu = cpu_runs("options", lambda: {
        name: small_option_run(name, torch.device("cpu"))
        for name in SMALL_OPTIONS})
    for name, (kw, coarse_solve, ref) in SMALL_OPTIONS.items():
        (rc, tc, kind), (rp, tp_, _) = (
            small_option_run(name, torch.device("cuda", 0)), cpu[name])
        tol = SMALL_LIN_TOL.get(name, SMALL_LIN_TOL_DEFAULT)
        dx = float(np.abs(rc.x - rp.x).max())
        log(f"8x8 cavity {name} ({kind}): Newton cuda {rc.iters} cpu "
            f"{rp.iters}; linear cuda {rc.linear_iters} cpu "
            f"{rp.linear_iters} goma_tpu {ref}; max |x_cuda - x_cpu| = "
            f"{dx:.2e}; {tc:.2f} s cuda, {tp_:.2f} s cpu")
        if not (rc.converged and rp.converged) or rc.iters != rp.iters:
            raise RuntimeError(f"8x8 cavity {name}: Newton differs between "
                               f"cuda and cpu ({rc.iters}, {rp.iters}, "
                               f"converged {rc.converged}, {rp.converged})")
        if len(rc.linear_iters) != len(rp.linear_iters) or any(
                abs(a - b) > tol for a, b in zip(rc.linear_iters,
                                                 rp.linear_iters)):
            raise RuntimeError(f"8x8 cavity {name}: linear iterations differ "
                               f"by more than {tol} per step")
        if dx > 1e-5:
            raise RuntimeError(f"8x8 cavity {name}: cuda and cpu solutions "
                               f"differ by {dx:.2e}")


def twolevel_opts(deck):
    """bench._cavity_opts("twolevel") and bench.bench_buoyant's third
    rung, restated (bench.py imports jax)."""
    from goma_tpu_torch.solvers import NewtonOptions

    if deck == "cavity":
        return NewtonOptions(max_iter=20, tol_residual=1e-6, linear_tol=1e-4,
                             gmres_restart=240, linear_maxiter=480,
                             precond="twolevel", smooth_sweeps=1)
    return NewtonOptions(max_iter=15, tol_residual=1e-6, linear_tol=1e-4,
                         precond="twolevel", smooth_sweeps=1,
                         gmres_restart=160, linear_maxiter=1000)


def coarse_apply_as(tl, mode, coarse, rc):
    """The coarse solve of ``tl`` with ``coarse_solve`` set to ``mode``."""
    keep, tl.coarse_solve = tl.coarse_solve, mode
    try:
        return tl._coarse_apply(coarse, rc)
    finally:
        tl.coarse_solve = keep


def replay_ms(fn):
    """graph_ms(fn), or nan (logged) where ``fn`` cannot be captured."""
    try:
        return graph_ms(fn)
    except RuntimeError as e:
        log(f"CUDA-graph replay: not measured ({str(e).splitlines()[0]})")
        return float("nan")


def twolevel_phase(prob, label, deck, x_ref, x_tol, relative, warm_up=True):
    """Phases 27 and 28: ``deck``'s two-level options (Vanka smoother,
    dense Galerkin coarse LU) on ``prob`` through the pipelined loop: one
    warm-up solve (``warm_up``), ``reset_lagged()``, one timed solve with
    its host syncs counted; require convergence to 1e-6, goma_tpu's Newton
    count +-1 (TWOLEVEL_REF), the same linear iterations in both solves
    (the coarse sum is deterministic) and x within ``x_tol`` of ``x_ref``
    (max |dx|, over 1 + |x_ref| where ``relative``); print
    s/iteration, the buckets, factorizations, host syncs per Newton
    iteration, one factorization split (Vanka inverses, Galerkin coarse
    build, coarse LU) and one apply split (smoother, restrict + prolong,
    coarse solve, operator) by CUDA events, kernels per apply, and one
    coarse solve by LU against the explicit inverse (``"inv"``) with each
    one's byte bound. Returns the solution and the timed solve's linear
    iterations."""
    from goma_tpu_torch.solvers import NewtonSolver

    dev = prob.device
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = NewtonSolver(prob, twolevel_opts(deck))
    tl = solver.precond
    nl = [tuple(tl.bj.tables[f"vk:pos{bi}"].shape[:2]) for bi in range(tl.bj.nb)]
    log(f"{label} setup: {prob.dofmap.n_dof} dof, precond "
        f"{solver._precond_kind} ({type(tl.bj).__name__} blocks (ne, nl) = "
        f"{nl}, coarse_solve {tl.coarse_solve}), nc = {tl.nc} "
        f"({tl.n_elliptic} elliptic), coarse pattern {tl._c_nnz} entries, "
        f"Galerkin expansion {tl.tables['ac_rep'].numel()} terms, "
        f"{time.perf_counter() - t0:.1f} s")
    if solver._precond_kind != "twolevel" or tl.coarse_solve != "lu":
        raise RuntimeError(f"{label}: not the two-level LU preconditioner")
    x_init = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    warm = None
    if warm_up:
        t0 = time.perf_counter()
        warm = solver.solve(x_init, params)
        torch.cuda.synchronize()
        log(f"{label} warm-up: {time.perf_counter() - t0:.2f} s, iters="
            f"{warm.iters}, lin={warm.linear_iters}, converged="
            f"{warm.converged}")
    solver.reset_lagged()
    solver.n_factor = solver.n_discarded = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, syncs = count_syncs(lambda: solver.solve(x_init, params))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    its = max(res.iters, 1)
    ref = TWOLEVEL_REF[deck]
    log(res.summary())
    log(f"{label}: iters={res.iters} (goma_tpu {ref['newton']}) converged="
        f"{res.converged} lin={res.linear_iters} (goma_tpu {ref['linear']}) "
        f"factorizations={solver.n_factor} discarded speculative solves="
        f"{solver.n_discarded}; asm {res.assembly_time / its * 1e3:.1f} ms + "
        f"slv {res.solve_time / its * 1e3:.1f} ms per iteration, "
        f"{sec / its:.4f} s/iter (total {sec:.3f} s); {syncs} host syncs, "
        f"{syncs / its:.1f} per Newton iteration")
    if not res.converged or res.res_norms[-1][1] > 1e-6:
        raise RuntimeError(f"{label} did not converge to 1e-6")
    if abs(res.iters - ref["newton"]) > 1:
        raise RuntimeError(f"{label}: {res.iters} Newton iterations, not "
                           f"goma_tpu's {ref['newton']} +- 1")
    if warm is not None and warm.linear_iters != res.linear_iters:
        raise RuntimeError(f"{label}: two solves from x = 0 took different "
                           f"linear iterations ({warm.linear_iters}, "
                           f"{res.linear_iters})")
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: solution has the wrong shape or "
                           "non-finite values")
    dx = rel_dx(x, x_ref) if relative else float(np.abs(x - x_ref).max())
    dm = prob.dofmap
    by_var = []
    for v in dm.vars:
        for c in range(v.ncomp):
            d = dm.dof_of_node_svar[:, dm.svar(v.name, c)]
            d = d[d >= 0]
            by_var.append(f"{v.name}[{c}] {np.abs(x - x_ref)[d].max():.2e} "
                          f"(max|x| {np.abs(x_ref[d]).max():.3g})")
    l2 = [float(solver._prepare_fast(torch.as_tensor(
        v, dtype=prob.dtype, device=dev), params)[1][1]) for v in (x, x_ref)]
    log(f"{label} vs gmres+ndlu: max |dx|{' / (1 + |x|)' if relative else ''}"
        f" = {dx:.3e}; max |dx| by field: {', '.join(by_var)}; ||R||_2 at "
        f"the two solutions {l2[0]:.3e}, {l2[1]:.3e}")
    if dx > x_tol:
        raise RuntimeError(f"{label}: {dx:.3e} from the gmres+ndlu solution "
                           f"(limit {x_tol:.0e})")

    # one factorization and one apply, split, at x = 0
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
    R, _, scale, aux = solver._prepare_fast(x0, params)
    vals = solver._scaled_vals(x0, params, scale)
    Binv = tl.bj.factor(vals)
    Ac = tl.coarse_matrix(vals)
    lu = tl.factor_coarse(Ac)
    mv = solver._matvec(scale, aux)
    r = (scale * R).to(vals.dtype)
    rc = tl.restrict(r)
    fac = (Binv, lu, mv)
    f_ms = {"Vanka inverses": median_ms(lambda: tl.bj.factor(vals), 3),
            "Galerkin coarse build": median_ms(lambda: tl.coarse_matrix(vals), 3),
            "coarse LU": median_ms(lambda: tl.factor_coarse(Ac), 3)}
    log(f"{label} factorization split (CUDA events): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in f_ms.items())
        + f"; whole factor {median_ms(lambda: tl.factor(vals, mv), 3):.3f} ms")
    a_ms = {"smoother (one sweep)": median_ms(lambda: tl.bj.apply(Binv, r), 10),
            "restrict + prolong": median_ms(
                lambda: tl.prolong(tl.restrict(r)), 10),
            "coarse solve": median_ms(lambda: tl._coarse_apply(lu, rc), 10),
            "operator (element matvec)": median_ms(lambda: mv(r), 10)}
    apply_ms = median_ms(lambda: tl.apply(fac, r), 10)
    dev_ms, kern = device_ms(lambda: tl.apply(fac, r), 3, required=False)
    log(f"{label} apply split (CUDA events): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in a_ms.items())
        + f"; one V({tl.pre_sweeps},{tl.post_sweeps}) apply {apply_ms:.3f} ms, "
        f"{dev_ms:.3f} ms device time in {kern} kernels")
    # the coarse solve: LU against goma_tpu's TPU choice, the explicit
    # float32 saddle-split inverse
    t0 = time.perf_counter()
    keep, tl.coarse_solve = tl.coarse_solve, "inv"
    inv = tl.factor_coarse(Ac)
    tl.coarse_solve = keep
    torch.cuda.synchronize()
    inv_fac_s = time.perf_counter() - t0
    z_lu = coarse_apply_as(tl, "lu", lu, rc)
    z_inv = coarse_apply_as(tl, "inv", inv, rc)
    rel = float((z_inv - z_lu).abs().max() / z_lu.abs().max())
    nc2 = tl.nc * tl.nc * Ac.element_size()
    times = {}
    for mode, coarse, nbytes in (("lu", lu, 2 * nc2), ("inv", inv, nc2)):
        fn = lambda m=mode, c=coarse: coarse_apply_as(tl, m, c, rc)  # noqa: E731
        times[mode] = (median_ms(fn, 10), replay_ms(fn),
                       bound_ms(nbytes, 2.0 * tl.nc * tl.nc)[0])
        log(f"{label} coarse solve {mode!r} at nc = {tl.nc}: "
            f"{times[mode][0]:.3f} ms (CUDA events), {times[mode][1]:.3f} ms "
            f"(CUDA-graph replay), byte bound {times[mode][2]:.4f} ms "
            f"({nbytes / 1e6:.0f} MB)")
    log(f"{label} coarse: LU factor {f_ms['coarse LU']:.1f} ms, inverse "
        f"{inv_fac_s * 1e3:.1f} ms (one call, host clock); inv vs lu "
        f"solution rel {rel:.2e}; {mem_line()}")
    del inv, lu, Ac, Binv, fac, solver, tl
    return x, res.linear_iters


def bubble_host_direct_phase(dev, ref):
    """Phase 29: the 48x48 static bubble on the host ``direct`` rung
    (bench.bench_two_phase("direct"): the plain float64 prep, SuperLU on
    the host), phase 19's two legs; require 2 converged steps a leg, each
    with the gmres_ndlu rung's Newton count +-1 (``ref``), dp within 8% of
    2, and the end state within BUBBLE_DIRECT_TOL of phase 19's."""
    from goma_tpu_torch.solvers import NewtonOptions
    from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver

    t0 = time.perf_counter()
    prob, x0, params = bubble_problem(N_BUBBLE, dev)
    ts = TransientSolver(prob, NewtonOptions(max_iter=10, tol_residual=1e-8,
                                             linear_solver="direct"),
                         TimeOptions(dt0=0.02, t_end=0.04, adapt=False))
    log(f"two-phase direct setup: {prob.dofmap.n_dof} dof, "
        f"{prob.pattern.nnz} nnz, precond built: {ts.newton.precond}, "
        f"{time.perf_counter() - t0:.1f} s")
    res, _, _, _, warm = transient_legs(ts, x0, params, "two-phase direct")
    got = {leg: [st.newton_iters for st in r.steps]
           for leg, r in (("warm", warm), ("timed", res))}
    log(f"two-phase direct: Newton per step {got}, gmres_ndlu {ref['newton']}")
    for leg in ("warm", "timed"):
        a, b = got[leg], ref["newton"][leg]
        if len(a) != len(b) or any(abs(u - v) > 1 for u, v in zip(a, b)):
            raise RuntimeError(f"two-phase direct {leg} leg: Newton {a} not "
                               f"within 1 of gmres_ndlu's {b}")
    dp = laplace_jump(prob, res.x)
    dx = rel_dx(res.x, ref["x"])
    log(f"two-phase direct: dp = {dp:.5f}; vs gmres_ndlu: max |dx| / "
        f"(1 + |x|) = {dx:.3e}")
    if not abs(dp - BUBBLE_DP) <= BUBBLE_DP_RTOL * BUBBLE_DP:
        raise RuntimeError(f"two-phase direct Laplace jump {dp:.4f} not "
                           f"within {BUBBLE_DP_RTOL:.0%} of {BUBBLE_DP}")
    if dx > BUBBLE_DIRECT_TOL:
        raise RuntimeError(f"two-phase direct end state {dx:.3e} from "
                           f"gmres_ndlu's (limit {BUBBLE_DIRECT_TOL:.0e})")


def die_problem(nz, nr, device):
    """examples/axisym_die_swirl.py::run's deck restated (the example
    imports jax): a (z, r) pipe [0, 2] x [0, 1] in swirling coordinates,
    Momentum, SwirlMomentum and Energy on Q2, Continuity on Q1 (40 local
    dofs), the body force G e_z, a rotating hot wall, a cold inlet and its
    Dirichlet specs in its order (the wall's temperature and the inlet's
    meet at one corner node: the first spec, the wall's, is kept, with a
    warning); float32 Jacobian as on the main paths."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import (Continuity, Energy, Momentum,
                                        SwirlMomentum)

    R, omega = 1.0, 0.5
    mesh = rectangle_mesh(nz, nr, elem="QUAD9", xlim=(0, 2.0), ylim=(0, R))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh,
        [Momentum(dim=2, interp="Q2", transient=False),
         SwirlMomentum(interp="Q2", transient=False),
         Continuity(interp="Q1"),
         Energy(interp="Q2", transient=False)],
        {"rho": 1.0, "mu": 0.1, "k": 1.0, "Cp": 1.0, "body_force": (4.0, 0.0)},
        coord="swirling", device=device)
    prob.add_dirichlet("top", "velocity", 0, 0.0)
    prob.add_dirichlet("top", "swirl", 0, omega * R)
    prob.add_dirichlet("top", "temperature", 0, 1.0)
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    prob.add_dirichlet("bottom", "swirl", 0, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = torch.float32
    return prob


def die_opts(rung):
    """Phase 30's (gmres_ndlu) and 31's (tpu_direct) Newton options."""
    from goma_tpu_torch.solvers import NewtonOptions

    if rung == "gmres_ndlu":
        return NewtonOptions(max_iter=12, tol_residual=AX_TOL,
                             linear_solver="gmres", precond="ndlu",
                             linear_tol=1e-4, gmres_restart=60,
                             linear_maxiter=240, ndlu_leaf_max=192)
    return NewtonOptions(max_iter=12, tol_residual=AX_TOL,
                         linear_solver="tpu_direct", ndlu_leaf_max=192,
                         ndlu_refine=1)


def die_outputs(prob, x):
    """The centre-line u_z (max over the axis nodes, as the example reports
    it), and through ``sideset_integral`` the wall heat flux over "top" and
    the outlet flow rate over "right", each per radian."""
    from goma_tpu_torch.post import flow_rate, heat_flux, sideset_integral

    uz = prob.get_nodal_field(x, "velocity", 0)
    axis = np.abs(prob.mesh.coords[:, 1]) < 1e-12
    params = prob.base_params()
    return (float(np.nanmax(uz[axis])),
            float(sideset_integral(prob, "top", heat_flux)(x, params)),
            float(sideset_integral(prob, "right", flow_rate)(x, params)))


def check_die_result(prob, res, rung, label):
    """Phase 30/31's gates against goma_tpu's record: convergence to
    AX_TOL in goma_tpu's Newton count +-1, u_z within AX_UZ_TOL, the heat
    flux and the flow rate within AX_INT_RTOL; the linear counts printed
    beside goma_tpu's."""
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: the solution has the wrong shape or "
                           "non-finite values")
    if not res.converged or res.res_norms[-1][1] > AX_TOL:
        raise RuntimeError(f"{label} did not converge to {AX_TOL}")
    if abs(res.iters - AX_REF_NEWTON[rung]) > 1:
        raise RuntimeError(f"{label} took {res.iters} Newton iterations, not "
                           f"goma_tpu's {AX_REF_NEWTON[rung]} +- 1")
    uz, q, f = die_outputs(prob, x)
    du = abs(uz - AX_REF_UZ[rung])
    dq = abs(q - AX_REF_HEAT[rung]) / abs(AX_REF_HEAT[rung])
    df = abs(f - AX_REF_FLOW[rung]) / abs(AX_REF_FLOW[rung])
    log(f"{label}: linear {res.linear_iters} (goma_tpu "
        f"{AX_REF_LINEAR[rung]}); centre-line u_z {uz!r} (goma_tpu "
        f"{AX_REF_UZ[rung]!r}, |diff| {du:.2e}); wall heat flux {q!r} "
        f"(rel diff {dq:.2e}); outlet flow rate {f!r} (rel diff {df:.2e})")
    if du > AX_UZ_TOL:
        raise RuntimeError(f"{label}: u_z {uz!r} is {du:.2e} from goma_tpu's "
                           f"> {AX_UZ_TOL:.0e}")
    if dq > AX_INT_RTOL or df > AX_INT_RTOL:
        raise RuntimeError(f"{label}: heat flux / flow rate {dq:.2e} / "
                           f"{df:.2e} from goma_tpu's > {AX_INT_RTOL:.0e}")


def die_gmres_phase(dev):
    """Phase 30: the axisymmetric die deck's gmres_ndlu rung at 64x32 and
    the kernels on its tree. Returns the numbers the kernel summary
    reads."""
    from goma_tpu_torch.solvers import NewtonSolver

    t0 = time.perf_counter()
    prob = die_problem(AX_NZ, AX_NR, dev)
    solver = NewtonSolver(prob, die_opts("gmres_ndlu"))
    nd = solver.precond
    levels = nd_levels(nd)
    slots = sum(nn * (m + b) ** 2 for nn, m, b in levels)
    log(f"die setup: {AX_NZ}x{AX_NR}, {prob.dofmap.n_dof} dof, "
        f"{prob.pattern.nnz} nnz, {prob.dofmap.blocks[0].n_ldof} local dofs, "
        f"leaf {solver.opts.ndlu_leaf_max}, {len(levels)} ND levels (nn, s, "
        f"b) = {levels}, {slots} front slots, "
        f"{time.perf_counter() - t0:.1f} s")
    params = prob.base_params()
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)

    def scaled(x):
        """The CSR values the main path factors at ``x``."""
        return solver._scaled_vals(x, params, solver._prepare_fast(x, params)[2])

    vals = scaled(x0)
    max_abs = check_real_fronts(nd, vals, "die x=0")
    shapes = [(nn, m) for nn, m, _ in levels]
    lu_abs, lu_ms = lu_shapes(shapes, "die", time_twin=True)
    factor_split_ms(nd, vals, "die tree")
    gather_abs = check_gathers(nd, vals, "die tree")
    g_times, g_bound = gather_times(nd, vals, "die tree")

    res, _, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof), params,
                                 "die gmres_ndlu")
    check_die_result(prob, res, "gmres_ndlu", "die gmres_ndlu")
    nf = solver.n_factor
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"die front-LU launches {ln['lu']} / front-gather "
                           f"launches {ln['gather']} != {len(levels)} levels "
                           f"x {nf} factorizations")
    xc = torch.as_tensor(res.x, dtype=prob.dtype, device=dev)
    max_abs = max(max_abs, lu_abs,
                  check_real_fronts(nd, scaled(xc), "die converged"))
    where_time_goes(prob, nd, vals, x0, params, "die")
    return {"prob": prob, "x": res.x, "launches": ln, "max_abs": max_abs,
            "lu_ms": lu_ms, "lu_bound": lu_bound(shapes),
            "gather_abs": gather_abs, "g_times": g_times, "g_bound": g_bound}


def die_direct_phase(dev, prob, x_gmres):
    """Phase 31: the die deck's tpu_direct rung at 64x32 and the
    substitution kernel on its tree. Returns the numbers the kernel summary
    reads."""
    from goma_tpu_torch.solvers import NewtonSolver

    t0 = time.perf_counter()
    solver = NewtonSolver(prob, die_opts("tpu_direct"))
    params = prob.base_params()
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
    R, vals, _, scale, _ = solver._prepare(x0, params)
    nd = solver._direct_ndlu(vals)  # the NDLU the rung will use
    levels = nd_levels(nd)
    log(f"die tpu_direct setup: {len(levels)} ND levels (nn, s, b) = "
        f"{levels}, {time.perf_counter() - t0:.1f} s")
    max_abs = check_real_fronts(nd, vals, "die tpu_direct x=0")
    calls = []
    nd.solve(nd.factor(vals), scale * R, trace=calls)
    if len(calls) != 2 * len(levels):
        raise RuntimeError(f"one die solve made {len(calls)} substitutions, "
                           f"not 2 x {len(levels)} levels")
    trsv = check_substitutions(calls, "die")
    step_ns = {}
    for li in (len(levels) - 2, len(levels) - 1):
        t = [1e6 * k / m for lv, nn, m, _, k, _ in trsv["levels"] if lv == li]
        nn, m, _ = levels[li]
        step_ns[f"({nn}, {m})"] = sum(t) / len(t)
    log("trsv die: device ns per dependent step (level device time / m, "
        "both sweeps averaged): " + ", ".join(
            f"level {k} {v:.1f} ns" for k, v in step_ns.items()))
    gather_abs = check_gathers(nd, vals, "die tpu_direct tree")

    res, _, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof), params,
                                 "die tpu_direct")
    check_die_result(prob, res, "tpu_direct", "die tpu_direct")
    solves, nf = nd.n_solve, solver._ndlu_nfactor
    if solves < 1 or ln["trsv"] != 2 * len(levels) * solves:
        raise RuntimeError(f"die substitution launches {ln['trsv']} != 2 x "
                           f"{len(levels)} levels x {solves} solves")
    if nf < 1 or ln["lu"] != len(levels) * nf or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"die tpu_direct front-LU launches {ln['lu']} / "
                           f"front-gather launches {ln['gather']} != "
                           f"{len(levels)} levels x {nf} factorizations")
    dx = rel_dx(res.x, x_gmres)
    log(f"die tpu_direct vs gmres_ndlu: max |x_direct - x_gmres| / "
        f"(1 + |x_gmres|) = {dx:.3e}")
    if dx > AX_PATHS_TOL:
        raise RuntimeError(f"die tpu_direct and gmres_ndlu solutions differ "
                           f"by {dx:.3e} > {AX_PATHS_TOL:.0e}")
    factor_split_ms(nd, vals, "die tpu_direct tree")
    return {"launches": ln, "max_abs": max_abs, "trsv": trsv,
            "bound": trsv_bound(calls), "step_ns": step_ns,
            "gather_abs": gather_abs}


def axisym_small_decks(device):
    """Phase 32's decks on ``device``: ({name: (Newton count, x)}, the 8x8
    cavity's Problem). The 12x10 die on both rungs; the axisymmetric
    Oldroyd-B pipe of tests/test_axisym_ve.py (3x10, AxisymHoopStress)
    against its exact viscometric solution; the power-law channel of
    tests/test_more_physics.py against its analytic profile; the
    axisymmetric linear-elastic dilation of tests/test_axisym.py (exact
    d_r = 0.1 r); the 8x8 cavity, whose stream function the phase takes."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.fem.fields import MESH_VAR
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import (AxisymHoopStress, Continuity,
                                        LinearElasticMesh, Momentum,
                                        VelocityGradientProjection, VEStress)
    from goma_tpu_torch.physics.materials import PowerLawViscosity
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver

    out = {}

    def solve(name, prob, opts, x0=None):
        x0 = np.zeros(prob.dofmap.n_dof) if x0 is None else x0
        r = NewtonSolver(prob, opts).solve(x0, prob.base_params())
        if not r.converged or not np.all(np.isfinite(r.x)):
            raise RuntimeError(f"{name} on {device} did not converge:\n"
                               f"{r.summary()}")
        out[name] = (r.iters, r.x)
        return r.x

    for rung in ("gmres_ndlu", "tpu_direct"):
        solve(f"die 12x10 {rung}", die_problem(12, 10, device), die_opts(rung))

    direct = NewtonOptions(max_iter=12, linear_solver="direct")
    G, mu_s, mu_p, lam = 4.0, 0.5, 0.5, 0.2
    mesh = rectangle_mesh(3, 10, elem="QUAD9", xlim=(0, 1), ylim=(0, 1.0))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh,
        [Momentum(dim=2, interp="Q2", transient=False, convection=False,
                  ve_stress_modes=1, devss_mu=mu_p),
         Continuity(interp="Q1"),
         VEStress(0, dim=2, lam=lam, mu_p=mu_p, interp="Q2", transient=False,
                  supg=0.0),
         AxisymHoopStress(0, lam=lam, mu_p=mu_p, interp="Q2",
                          transient=False, supg=0.0),
         VelocityGradientProjection(dim=2, interp="Q1")],
        {"rho": 1.0, "mu": mu_s, "body_force": (G, 0.0)},
        coord="cylindrical", device=device)
    prof = lambda c: G * (1.0 - c[:, 1] ** 2) / (4 * (mu_s + mu_p))  # noqa: E731
    for ns in ("top", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, prof)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x = solve("Oldroyd-B pipe 3x10", prob, direct)
    uz = prob.get_nodal_field(x, "velocity", 0)
    stt = prob.get_nodal_field(x, "stress0_tt")
    ok, okt = ~np.isnan(uz), ~np.isnan(stt)
    e_u = float(np.abs(uz[ok] - prof(mesh.coords[ok])).max())
    e_t = float(np.abs(stt[okt]).max())
    if e_u > 1e-8 or e_t > 1e-8:
        raise RuntimeError(f"Oldroyd-B pipe on {device}: u_z {e_u:.2e} from "
                           f"the viscometric profile, S_tt {e_t:.2e} from 0")

    m_c, n_c, Gp, H = 1.0, 0.6, 2.0, 1.0
    mesh = rectangle_mesh(4, 24, elem="QUAD9", xlim=(0, 0.25), ylim=(0, H))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)

    def uex(c):
        r = (n_c / (n_c + 1.0)) * (Gp / m_c) ** (1.0 / n_c)
        return r * ((H / 2) ** ((n_c + 1) / n_c)
                    - np.abs(c[:, 1] - H / 2) ** ((n_c + 1) / n_c))

    prob = Problem(mesh, [Momentum(dim=2, transient=False, convection=False),
                          Continuity()],
                   {"rho": 1.0, "mu": PowerLawViscosity(m=m_c, n=n_c),
                    "body_force": np.array([Gp, 0.0])}, device=device)
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, uex)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x = solve("power-law channel 4x24", prob,
              NewtonOptions(max_iter=20, tol_residual=1e-9,
                            linear_solver="direct"),
              prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity", 0,
                                   uex))
    u = prob.get_nodal_field(x, "velocity", 0)
    ok = ~np.isnan(u)
    err = np.abs(u[ok] - uex(mesh.coords[ok])).max() / uex(mesh.coords[ok]).max()
    if err > 0.01:
        raise RuntimeError(f"power-law channel on {device}: {err:.2e} from "
                           "the analytic profile (goma_tpu's bound 0.01)")

    mesh = rectangle_mesh(5, 5, elem="QUAD9", xlim=(0, 1), ylim=(0.5, 1.5))
    prob = Problem(mesh, [LinearElasticMesh(dim=2, interp="Q2")],
                   {"mesh_shear_modulus": 1.0, "mesh_lambda": 2.0},
                   coord="cylindrical", device=device)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, MESH_VAR, 0, 0.0)
        prob.add_dirichlet(ns, MESH_VAR, 1, lambda X: 0.1 * X[:, 1])
    prob.finalize()
    x = solve("elastic dilation 5x5", prob,
              NewtonOptions(max_iter=5, linear_solver="direct"))
    d = prob.get_nodal_field(x, MESH_VAR, 1)
    if np.abs(d - 0.1 * mesh.coords[:, 1]).max() > 1e-10:
        raise RuntimeError(f"elastic dilation on {device}: d_r is not 0.1 r")

    cav = cavity_problem(8, device)
    solve("cavity 8x8", cav, cavity_opts())
    return out, cav


def axisym_cpu_half():
    """Phase 32's CPU runs: the decks' {name: (Newton count, x)} and the
    stream function of the 8x8 cavity from its own velocity."""
    from goma_tpu_torch.post import stream_function

    t0 = time.perf_counter()
    got, cav = axisym_small_decks(torch.device("cpu"))
    psi = stream_function(cav, got["cavity 8x8"][1])
    return got, psi, time.perf_counter() - t0


def axisym_small_phase():
    """Phase 32: phase 32's decks (``axisym_small_decks``) on cuda and on
    cpu (the CPU runs from ``cpu_runs``): the same Newton count and x within
    AX_X_TOL (the cavity within phase 4's 1e-5: it stops at 1e-6 after
    inexact float32 steps); then ``post.stream_function`` on each device
    from the cpu cavity's velocity: psi within 1e-9 of max |psi| and its
    minimum printed."""
    from goma_tpu_torch.post import stream_function

    t0 = time.perf_counter()
    got_c, cav_c = axisym_small_decks(torch.device("cuda"))
    log(f"phase 32 decks on cuda: {time.perf_counter() - t0:.1f} s")
    got_p, psi_p, sec = cpu_runs("axisym", axisym_cpu_half)
    log(f"phase 32 decks on cpu: {sec:.1f} s (in the CPU side)")
    for name, (it_c, x_c) in got_c.items():
        it_p, x_p = got_p[name]
        dx = rel_dx(x_c, x_p)
        tol = 1e-5 if name == "cavity 8x8" else AX_X_TOL
        log(f"{name}: Newton cuda {it_c} cpu {it_p}, max |dx| / (1 + |x|) "
            f"{dx:.2e}")
        if it_c != it_p or not dx <= tol:
            raise RuntimeError(f"{name}: cuda and cpu differ (Newton {it_c} / "
                               f"{it_p}, x {dx:.2e} > {tol:.0e})")
    psi = {"cuda": stream_function(cav_c, got_p["cavity 8x8"][1]), "cpu": psi_p}
    dpsi = float(np.abs(psi["cuda"] - psi["cpu"]).max()
                 / np.abs(psi["cpu"]).max())
    log(f"stream function of the 8x8 cavity: min psi cuda "
        f"{psi['cuda'].min():.6f} cpu {psi['cpu'].min():.6f}, max |dpsi| / "
        f"max |psi| {dpsi:.2e}")
    if not np.all(np.isfinite(psi["cuda"])) or not dpsi <= 1e-9:
        raise RuntimeError(f"stream function: cuda and cpu differ by "
                           f"{dpsi:.2e} > 1e-9")


def tilted_problem(n, device, theta=TILT_THETA, jacobian_dtype=torch.float32):
    """tests/test_rotation.py's tilted cavity at n x n: the Re = 100
    lid-driven cavity's mesh rotated by ``theta``; walls first (rotated
    normal and tangent constraints of 0 on left, right and bottom), then
    the lid (normal 0, tangent -1: the frame tangent of the lid is -Rot e_x);
    pressure pinned at node 0. The lid's end nodes repeat the walls'
    tangent constraint: the first claim, the wall's, is kept (goma_tpu's
    warning). Float32 Jacobian as on the main paths."""
    import warnings

    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import Continuity, Momentum

    c, s = np.cos(theta), np.sin(theta)
    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.coords = mesh.coords @ np.array([[c, -s], [s, c]]).T
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": 1.0 / RE}, device=device)
    for d in ("normal", "tangent"):
        prob.add_rotated_dirichlet(("left", "right", "bottom"), "velocity", d, 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "normal", 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "tangent", -1.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prob.finalize()
    prob.jacobian_dtype = jacobian_dtype
    return prob


def periodic_problem(nx, ny, device):
    """tests/test_periodic.py's Poiseuille channel at nx x ny: [0, 2] x
    [0, 1], "right" identified with "left" (translation (2, 0)), no-slip
    walls at y = 0 and 1, the body force (G, 0) drives it, convection on;
    pressure pinned at node 0; float32 Jacobian."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import Continuity, Momentum

    mesh = rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 1.0))
    prob = Problem(mesh, [Momentum(dim=2, transient=False), Continuity()],
                   {"rho": 1.0, "mu": PER_MU, "body_force": [PER_G, 0.0]},
                   device=device)
    prob.add_periodic("left", "right", translation=[2.0, 0.0])
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = torch.float32
    return prob


def check_record(prob, res, ref, label, tol, linear=True):
    """A main path's result against goma_tpu's record ``ref``: converged
    to ``tol``, finite, goma_tpu's Newton count +-1, each step's linear
    iterations within REF_LIN_TOL (``linear``; printed beside goma_tpu's
    either way), x at the record's sampled dofs within REF_X_TOL (max
    |dx| / (1 + |x|)). Returns that reading."""
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: the solution has the wrong shape or "
                           "non-finite values")
    if not res.converged or res.res_norms[-1][1] > tol:
        raise RuntimeError(f"{label} did not converge to {tol}")
    samples = np.linspace(0, prob.dofmap.n_dof - 1, REF_SAMPLES).astype(np.int64)
    dx = rel_dx(x[samples], np.asarray(ref["x_samples"]))
    lin_ok = (len(res.linear_iters) == len(ref["linear"]) and all(
        abs(a - b) <= REF_LIN_TOL for a, b in zip(res.linear_iters, ref["linear"])))
    log(f"{label}: Newton {res.iters} (goma_tpu {ref['newton']}), linear "
        f"{res.linear_iters} (goma_tpu {ref['linear']}); x at "
        f"{REF_SAMPLES} sampled dofs {dx:.2e} from goma_tpu's "
        f"(max |dx| / (1 + |x|))")
    if abs(res.iters - ref["newton"]) > 1:
        raise RuntimeError(f"{label} took {res.iters} Newton iterations, not "
                           f"goma_tpu's {ref['newton']} +- 1")
    if linear and not lin_ok and len(res.linear_iters) == len(ref["linear"]):
        raise RuntimeError(f"{label}: linear iterations {res.linear_iters} "
                           f"not within {REF_LIN_TOL} of goma_tpu's "
                           f"{ref['linear']}")
    if dx > REF_X_TOL:
        raise RuntimeError(f"{label}: x is {dx:.2e} from goma_tpu's at the "
                           f"sampled dofs > {REF_X_TOL:.0e}")
    return dx


def more_calls(solver, x_init, params, label, n=1):
    """``n`` further timed solves after ``warm_then_timed``'s, each from
    ``reset_lagged()`` (the s/iteration spread over two calls). Returns
    the s/iteration of each."""
    out = []
    for _ in range(n):
        solver.reset_lagged()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(x_init, params)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        it = max(res.iters, 1)
        out.append(sec / it)
        log(f"{label} again: iters={res.iters} lin={res.linear_iters}, asm "
            f"{res.assembly_time / it * 1000:.1f} ms + slv "
            f"{res.solve_time / it * 1000:.1f} ms per iteration, "
            f"{sec / it:.4f} s/iter")
    return out


def gmres_tree_phase(prob, solver, label, vals=None, at="x=0"):
    """The kernels on a ``gmres_ndlu`` deck's tree, as phases 15 and 30
    hold them: the front LU on its real fronts at x = 0 (or on the CSR
    values ``vals`` a run factored, named ``at``) and on random boosted
    fronts at its level shapes (kernel, twin, ``lu_factor_ex``, bound),
    the factorization split, the gather exact and timed. Returns the
    numbers the kernel summary reads, and the values."""
    nd = solver.precond
    levels = nd_levels(nd)
    if vals is None:
        params = prob.base_params()
        x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device="cuda")
        vals = solver._scaled_vals(x0, params,
                                   solver._prepare_fast32(x0, params)[2])
    max_abs = check_real_fronts(nd, vals, f"{label} {at}")
    shapes = [(nn, m) for nn, m, _ in levels]
    lu_abs, lu_ms = lu_shapes(shapes, label, time_twin=True)
    factor_split_ms(nd, vals, f"{label} tree")
    gather_abs = check_gathers(nd, vals, f"{label} tree")
    g_times, g_bound = gather_times(nd, vals, f"{label} tree")
    return {"max_abs": max(max_abs, lu_abs), "lu_ms": lu_ms,
            "lu_bound": lu_bound(shapes), "gather_abs": gather_abs,
            "g_times": g_times, "g_bound": g_bound, "vals": vals}


def direct_tree_phase(prob, solver, label, vals=None, at="x=0"):
    """The kernels on a ``tpu_direct`` deck's tree, as phases 16 and 31
    hold them: the front LU on its real fronts at x = 0 (or on the CSR
    values ``vals`` a run factored, named ``at``, then with a seeded
    right-hand side), the substitution kernel on the substitutions of one
    solve (against ``solve_triangular`` by graph replay), the device ns
    per dependent step at the two top levels, the gather exact. Returns
    the numbers the summary reads."""
    if vals is None:
        x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device="cuda")
        R, vals, _, scale, _ = solver._prepare(x0, prob.base_params())
        rhs = scale * R
    else:
        rhs = torch.as_tensor(np.random.default_rng(49).standard_normal(
            prob.dofmap.n_dof), dtype=prob.dtype, device="cuda")
    nd = solver._direct_ndlu(vals)  # the NDLU the rung will use
    levels = nd_levels(nd)
    log(f"{label} setup: {len(levels)} ND levels (nn, s, b) = {levels}, "
        f"{sum(nn * (m + b) ** 2 for nn, m, b in levels)} front slots")
    max_abs = check_real_fronts(nd, vals, f"{label} {at}")
    calls = []
    nd.solve(nd.factor(vals), rhs, trace=calls)
    if len(calls) != 2 * len(levels):
        raise RuntimeError(f"one {label} solve made {len(calls)} "
                           f"substitutions, not 2 x {len(levels)} levels")
    trsv = check_substitutions(calls, label)
    step_ns = {}
    for li in (len(levels) - 2, len(levels) - 1):
        t = [1e6 * k / m for lv, nn, m, _, k, _ in trsv["levels"] if lv == li]
        nn, m, _ = levels[li]
        step_ns[f"({nn}, {m})"] = sum(t) / len(t)
    log(f"trsv {label}: device ns per dependent step (level device time / "
        "m, both sweeps averaged): " + ", ".join(
            f"level {k} {v:.1f} ns" for k, v in step_ns.items()))
    gather_abs = check_gathers(nd, vals, f"{label} tree")
    factor_split_ms(nd, vals, f"{label} tree")
    return {"nd": nd, "levels": levels, "max_abs": max_abs, "trsv": trsv,
            "bound": trsv_bound(calls), "step_ns": step_ns,
            "gather_abs": gather_abs}


def check_launches(solver, ln, levels, label, direct=False):
    """Front-LU and front-gather launches = levels x factorizations (and,
    ``direct``, substitution launches = 2 x levels x NDLU solves) in the
    main path's timed solve (``check_split_launches`` of one tree)."""
    check_split_launches([("tree", solver, levels)], ln, label, direct)


def tilted_gmres_phase(dev, x_axis, axis_iters):
    """Phase 33: the 64x64 tilted cavity on ``gmres_ndlu`` (phase 5's
    options): the kernels on its tree; one warm-up solve,
    ``reset_lagged()``, one timed solve and one more; goma_tpu's record
    (``check_record``); the solution against phase 5's axis-aligned
    ``x_axis`` rotated into the tilted frame (Newton within 1 of its
    ``axis_iters``, TILT_AXIS_TOL); the front LU on the real fronts at the
    converged state; where an iteration's time goes."""
    from goma_tpu_torch.solvers import NewtonSolver

    t0 = time.perf_counter()
    prob = tilted_problem(TILT_N, dev)
    solver = NewtonSolver(prob, cavity_opts())
    rd = prob._rotation
    levels = nd_levels(solver.precond)
    log(f"tilted setup: {TILT_N}x{TILT_N} cavity rotated by "
        f"{np.degrees(TILT_THETA):.0f} degrees, {prob.dofmap.n_dof} dof, "
        f"{prob.pattern.nnz} nnz, {rd.dofs.shape[0]} rotated nodes, "
        f"{rd.con_rows.size} constraint rows, {len(levels)} ND levels (nn, "
        f"s, b) = {levels}, {sum(nn * (m + b) ** 2 for nn, m, b in levels)} "
        f"front slots, {time.perf_counter() - t0:.1f} s")
    tree = gmres_tree_phase(prob, solver, "tilted")
    params = prob.base_params()
    x_init = np.zeros(prob.dofmap.n_dof)
    res, sec, ln = warm_then_timed(solver, x_init, params, "tilted gmres_ndlu")
    check_launches(solver, ln, len(levels), "tilted gmres_ndlu")
    check_record(prob, res, TILT_REF["gmres_ndlu"], "tilted gmres_ndlu", 1e-6)
    s_iter = [sec / max(res.iters, 1)] + more_calls(solver, x_init, params,
                                                    "tilted gmres_ndlu")
    log(f"tilted gmres_ndlu: s/iter over two calls {s_iter}")
    # the axis-aligned solution rotated into the tilted frame: the decks
    # share the mesh's numbering, so node k of one is node k of the other
    c, s = np.cos(TILT_THETA), np.sin(TILT_THETA)
    ua = np.stack([prob.get_nodal_field(x_axis, "velocity", k) for k in (0, 1)])
    ut = np.stack([prob.get_nodal_field(res.x, "velocity", k) for k in (0, 1)])
    du = rel_dx(ut, np.array([[c, -s], [s, c]]) @ ua)
    pa = prob.get_nodal_field(x_axis, "pressure")
    pt = prob.get_nodal_field(res.x, "pressure")
    ok = ~np.isnan(pa)
    dp = rel_dx(pt[ok], pa[ok])
    log(f"tilted vs the axis-aligned cavity rotated: Newton {res.iters} vs "
        f"{axis_iters}; velocity {du:.2e}, pressure {dp:.2e} (max |dx| / "
        "(1 + |x|))")
    if abs(res.iters - axis_iters) > 1 or max(du, dp) > TILT_AXIS_TOL:
        raise RuntimeError(f"tilted cavity vs the axis-aligned one rotated: "
                           f"Newton {res.iters} / {axis_iters}, velocity "
                           f"{du:.2e}, pressure {dp:.2e} > {TILT_AXIS_TOL:.0e}")
    xc = torch.as_tensor(res.x, dtype=prob.dtype, device=dev)
    nd = solver.precond
    tree["max_abs"] = max(tree["max_abs"], check_real_fronts(
        nd, solver._scaled_vals(xc, params, solver._prepare_fast32(
            xc, params)[2]), "tilted converged"))
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
    where_time_goes(prob, nd, tree.pop("vals"), x0, params, "tilted")
    return {"prob": prob, "x": res.x, "launches": ln, **tree}


def tilted_direct_phase(dev, prob, x_gmres):
    """Phase 34: the tilted cavity on ``tpu_direct`` (phase 10's options):
    the kernels on its tree (``direct_tree_phase``); one warm-up solve,
    ``reset_lagged()``, one timed solve and one more; goma_tpu's record;
    x within BC_PATHS_TOL of phase 33's."""
    from goma_tpu_torch.solvers import NewtonSolver

    solver = NewtonSolver(prob, direct_opts())
    tree = direct_tree_phase(prob, solver, "tilted tpu_direct")
    params = prob.base_params()
    x_init = np.zeros(prob.dofmap.n_dof)
    res, sec, ln = warm_then_timed(solver, x_init, params, "tilted tpu_direct")
    check_launches(solver, ln, len(tree["levels"]), "tilted tpu_direct",
                   direct=True)
    check_record(prob, res, TILT_REF["tpu_direct"], "tilted tpu_direct", 1e-6)
    s_iter = [sec / max(res.iters, 1)] + more_calls(solver, x_init, params,
                                                    "tilted tpu_direct")
    log(f"tilted tpu_direct: s/iter over two calls {s_iter}")
    dx = rel_dx(res.x, x_gmres)
    log(f"tilted tpu_direct vs gmres_ndlu: max |dx| / (1 + |x|) {dx:.3e}")
    if dx > BC_PATHS_TOL:
        raise RuntimeError(f"tilted tpu_direct and gmres_ndlu solutions "
                           f"differ by {dx:.3e} > {BC_PATHS_TOL:.0e}")
    tree.pop("nd")
    return {"launches": ln, **tree}


def residual_phase(decks):
    """Phase 35: ``Problem.residual`` (the residual-only pass) against
    ``Problem.assemble``'s R and the vals-free prep's R on the card, in
    float64, at x = 0 and at each deck's converged state, within RESID_RTOL
    of max |R|; the three timed by CUDA events; the kernels of a prep and
    of an element matvec on each deck, and how many more the second deck's
    rows take. Then
    ``utils.numjac.numerical_jacobian_check`` on a 16x16 tilted cavity on
    the card (float64, 20 columns): ``ok``."""
    from goma_tpu_torch.utils.numjac import numerical_jacobian_check

    kern = {}
    for label, prob, x in decks:
        params = prob.base_params()
        for state, xs in (("x=0", np.zeros(prob.dofmap.n_dof)),
                          ("converged", x)):
            xt = torch.as_tensor(xs, dtype=prob.dtype, device="cuda")
            r = prob.residual(xt, params)
            R, vals = prob.assemble(xt, params)
            Rf = prob._assemble_fast(xt, params)[0]
            sc = max(float(R.abs().max()), 1e-300)
            e1 = float((r - R).abs().max()) / sc
            e2 = float((r - Rf).abs().max()) / sc
            if r.dtype != torch.float64 or vals.shape[0] != prob.pattern.nnz:
                raise RuntimeError(f"{label}: residual/assemble dtype or shape")
            log(f"residual vs assemble {label} {state}: max |r - R| / max |R| "
                f"{e1:.2e}, vs the vals-free prep's R {e2:.2e}")
            if not (e1 <= RESID_RTOL and e2 <= RESID_RTOL):
                raise RuntimeError(f"{label} {state}: residual differs from "
                                   f"assemble's R by {e1:.2e} / the prep's by "
                                   f"{e2:.2e} > {RESID_RTOL:.0e}")
        xt = torch.as_tensor(x, dtype=prob.dtype, device="cuda")
        t = {name: median_ms(fn, 5) for name, fn in (
            ("residual", lambda: prob.residual(xt, params)),
            ("assemble", lambda: prob.assemble(xt, params)),
            ("_assemble_fast", lambda: prob._assemble_fast(xt, params)))}
        log(f"residual vs assemble {label}: CUDA-event ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in t.items()))
        # what the row surgery costs a prep and a Krylov matvec: the
        # kernels of each (the decks differ in their strong conditions only)
        _, rs, aux = prob._assemble_fast(xt, params)
        scale = 1.0 / torch.sqrt(rs)
        v = torch.ones_like(scale)
        for name, fn in (("prep", lambda: prob._assemble_fast(xt, params)),
                         ("matvec", lambda: prob.element_matvec(None, aux,
                                                                scale, v))):
            dv, n_k = device_ms(fn, 5, required=False)
            kern[(label, name)] = n_k
            log(f"row surgery {label}: one {name} {median_ms(fn, 10):.3f} ms "
                f"(CUDA events), {dv:.3f} ms device time in {n_k} kernels")
    (a, _, _), (b, _, _) = decks
    log("row surgery: the " + b + " deck's rotated and constraint rows add "
        + ", ".join(f"{kern[(b, k)] - kern[(a, k)]} kernels to a {k}"
                    for k in ("prep", "matvec")) + f" of the {a} deck's")
    p16 = tilted_problem(16, torch.device("cuda", 0), jacobian_dtype=None)
    x16 = 0.1 * np.random.default_rng(16).standard_normal(p16.dofmap.n_dof)
    chk = numerical_jacobian_check(p16, x16, p16.base_params(), n_columns=20)
    log(f"numjac 16x16 tilted cavity on the card: {chk.report()}")
    if not chk.ok:
        raise RuntimeError("numerical Jacobian check failed on the card")


def check_periodic(prob, res, label):
    """The periodic channel's exact solution: u = G y (1 - y) / (2 mu)
    within PER_U_TOL, v within PER_V_TOL."""
    y = prob.mesh.coords[:, 1]
    u = prob.get_nodal_field(res.x, "velocity", 0)
    v = prob.get_nodal_field(res.x, "velocity", 1)
    eu = float(np.nanmax(np.abs(u - PER_G * y * (1 - y) / (2 * PER_MU))))
    ev = float(np.nanmax(np.abs(v)))
    log(f"{label}: max |u - u_Poiseuille| {eu:.2e}, max |v| {ev:.2e}")
    if eu > PER_U_TOL or ev > PER_V_TOL:
        raise RuntimeError(f"{label}: {eu:.2e} from the Poiseuille profile "
                           f"(> {PER_U_TOL:.0e}) or |v| {ev:.2e} > "
                           f"{PER_V_TOL:.0e}")


def periodic_gmres_phase(dev):
    """Phase 36: the 64x32 periodic channel on ``gmres_ndlu`` (phase 5's
    options): the aliased tree's level shapes (every separator 1 < s <=
    1000) and the kernels on it (``gmres_tree_phase``); the warm-up,
    reset, timed solve and one more; goma_tpu's record; the Poiseuille
    profile."""
    from goma_tpu_torch.solvers import NewtonSolver

    t0 = time.perf_counter()
    prob = periodic_problem(PER_NX, PER_NY, dev)
    solver = NewtonSolver(prob, cavity_opts())
    alias = prob.dofmap.node_alias
    levels = nd_levels(solver.precond)
    log(f"periodic setup: {PER_NX}x{PER_NY} channel, "
        f"{int((alias != np.arange(alias.size)).sum())} slave nodes, "
        f"{prob.dofmap.n_dof} dof, {prob.pattern.nnz} nnz, "
        f"{prob.dofmap.blocks[0].n_ldof} local dofs, {len(levels)} ND levels "
        f"(nn, s, b) = {levels} (every separator 1 < s <= 1000), "
        f"{sum(nn * (m + b) ** 2 for nn, m, b in levels)} front slots, "
        f"{time.perf_counter() - t0:.1f} s")
    tree = gmres_tree_phase(prob, solver, "periodic")
    tree.pop("vals")
    params = prob.base_params()
    x_init = np.zeros(prob.dofmap.n_dof)
    res, sec, ln = warm_then_timed(solver, x_init, params,
                                   "periodic gmres_ndlu")
    check_launches(solver, ln, len(levels), "periodic gmres_ndlu")
    # the first GMRES solve stagnates in every run (goma_tpu's CPU run at
    # its 240 cap, the port's CPU run 120, the H100 180): where the 0.999
    # stagnation test fires is rounding's choice, so the linear counts are
    # printed, not gated; the Newton count and x are
    check_record(prob, res, PER_REF["gmres_ndlu"], "periodic gmres_ndlu", 1e-6,
                 linear=False)
    check_periodic(prob, res, "periodic gmres_ndlu")
    s_iter = [sec / max(res.iters, 1)] + more_calls(solver, x_init, params,
                                                    "periodic gmres_ndlu")
    log(f"periodic gmres_ndlu: s/iter over two calls {s_iter}")
    return {"prob": prob, "x": res.x, "launches": ln, **tree}


def periodic_direct_phase(dev, prob, x_gmres):
    """Phase 37: the periodic channel on ``tpu_direct`` (phase 10's
    options), as phase 34 runs the tilted cavity's, with the profile."""
    from goma_tpu_torch.solvers import NewtonSolver

    solver = NewtonSolver(prob, direct_opts())
    tree = direct_tree_phase(prob, solver, "periodic tpu_direct")
    params = prob.base_params()
    x_init = np.zeros(prob.dofmap.n_dof)
    res, sec, ln = warm_then_timed(solver, x_init, params,
                                   "periodic tpu_direct")
    check_launches(solver, ln, len(tree["levels"]), "periodic tpu_direct",
                   direct=True)
    check_record(prob, res, PER_REF["tpu_direct"], "periodic tpu_direct", 1e-6)
    check_periodic(prob, res, "periodic tpu_direct")
    s_iter = [sec / max(res.iters, 1)] + more_calls(solver, x_init, params,
                                                    "periodic tpu_direct")
    log(f"periodic tpu_direct: s/iter over two calls {s_iter}")
    dx = rel_dx(res.x, x_gmres)
    log(f"periodic tpu_direct vs gmres_ndlu: max |dx| / (1 + |x|) {dx:.3e}")
    if dx > BC_PATHS_TOL:
        raise RuntimeError(f"periodic tpu_direct and gmres_ndlu solutions "
                           f"differ by {dx:.3e} > {BC_PATHS_TOL:.0e}")
    tree.pop("nd")
    return {"launches": ln, **tree}


def bc_small_decks(device):
    """Phase 38's decks on ``device``, float64 throughout: {name: (Newton
    count, x)}. The slip-wall channel (tests/test_rotation.py:71) against
    its analytic profile; mesh nodes sliding on a plane and on a parabola
    (tests/test_pointwise.py:16, :48; the plane deck also on ``gmres`` +
    NDLU through the element matvec's point-constraint rows); a
    conduction deck with a nonlinear point load (host direct and
    ``gmres``); a row-injection deck on ``gmres``, whose solver must take
    the ELL operator and never the element matvec; a parametric-Dirichlet
    deck (T = lam x on the bottom, lam from params); the doubly periodic
    corner chain (tests/test_periodic.py:105, the four corners one dof);
    the 3-D HEX27 manufactured Navier-Stokes deck (tests/test_3d.py:50,
    ``box_mesh(3, 3, 3)``, its body force by ``torch.func``); a transient
    conduction run with ``variable_stats=True`` (its tables printed)."""
    from torch.func import hessian, jacfwd, vmap

    from goma_tpu_torch.bc.pointwise import plane, surface
    from goma_tpu_torch.fem import Equation, Problem
    from goma_tpu_torch.mesh import box_mesh, rectangle_mesh
    from goma_tpu_torch.physics import (Continuity, EllipticMesh, Energy,
                                        Momentum, Species)
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
    from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver

    out = {}
    direct = NewtonOptions(max_iter=10, tol_residual=1e-11,
                           linear_solver="direct")
    gmres = lambda pc: NewtonOptions(max_iter=10, tol_residual=1e-11,  # noqa: E731
                                     linear_solver="gmres", precond=pc,
                                     linear_tol=1e-12)

    def solve(name, prob, opts, params=None, check=None):
        solver = NewtonSolver(prob, opts)
        if check is not None:
            check(solver)
        r = solver.solve(np.zeros(prob.dofmap.n_dof),
                         prob.base_params() if params is None else params)
        if not r.converged or not np.all(np.isfinite(r.x)):
            raise RuntimeError(f"{name} on {device} did not converge:\n"
                               f"{r.summary()}")
        out[name] = (r.iters, r.x)
        return r.x

    # the slip-wall channel
    mesh = rectangle_mesh(4, 6, elem="QUAD9", xlim=(0, 0.5), ylim=(0, 1.0))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False,
                                   convection=False), Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": 0.5, "body_force": np.array([1.0, 0.0])},
                   device=device)
    uex = lambda c: (c[:, 1] - 0.5 * c[:, 1] ** 2) / 0.5  # noqa: E731
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, uex)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "normal", 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x = solve("slip-wall channel", prob, direct)
    if np.abs(prob.get_nodal_field(x, "velocity", 0) - uex(mesh.coords)).max() > 1e-9:
        raise RuntimeError(f"slip-wall channel on {device}: not the profile")

    # mesh nodes sliding on a plane / a parabola
    for shape, g in (("plane", plane([-0.2, 1.0], 0.0)),
                     ("parabola", surface(lambda x: x[1] - 0.1 * x[0] * (1 - x[0])))):
        mesh = rectangle_mesh(6, 6, elem="QUAD9")
        prob = Problem(mesh, [EllipticMesh(2)], {}, device=device)
        for ns, k in (("top", 0), ("top", 1), ("left", 0), ("right", 0)):
            prob.add_dirichlet(ns, "mesh_displacement", k, 0.0)
        prob.add_point_constraint("bottom", "mesh_displacement", 1, g)
        prob.finalize()
        solve(f"sliding mesh ({shape})", prob, direct)
        if shape == "plane":
            solve("sliding mesh (plane) gmres", prob, gmres("ndlu"))

    # a nonlinear point load on a conduction deck
    def heat():
        return Problem(rectangle_mesh(4, 4, elem="QUAD9"),
                       [Energy(interp="Q2", transient=False, convection=False)],
                       {"k": 1.0}, device=device)

    prob = heat()
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_point_load("right", "temperature",
                        lambda q, X, p: 0.5 * q + 0.2 * q ** 3 - 0.3 * (1.0 + X[1]))
    prob.finalize()
    solve("point load", prob, direct)
    solve("point load gmres", prob, gmres("ndlu"))

    # row injection: the species row of the right wall into the temperature
    # row, the species row replaced by the tie c - T = 0
    prob = Problem(rectangle_mesh(4, 4, elem="QUAD9"),
                   [Energy(interp="Q2", transient=False, convection=False),
                    Species(n_species=1, interp="Q2", transient=False,
                            convection=False)],
                   {"k": 1.0, "diffusivity": 0.5}, device=device)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("top", "species", 0, 0.0)
    prob.add_row_inject("right", "species", "temperature")
    prob.add_point_constraint("right", ["species", "temperature"], 0,
                              lambda q, X, p: q[0] - q[1])
    prob.finalize()
    calls = []

    def ell_operator(solver):
        if solver._use_elem_mv or solver._fast_prep or solver._ell is None:
            raise RuntimeError("row injection: the solver did not take the "
                               "ELL operator")
        real = prob.element_matvec
        prob.element_matvec = lambda *a: calls.append(1) or real(*a)

    solve("row injection gmres", prob, gmres("block_jacobi"), check=ell_operator)
    if calls:
        raise RuntimeError("row injection: the element matvec ran")

    # parametric Dirichlet
    prob = heat()
    prob.add_dirichlet("left", "temperature", 0, 0.25)
    prob.add_dirichlet("bottom", "temperature", 0, lambda c, p: p["lam"] * c[:, 0])
    prob.add_dirichlet("top", "temperature", 0, 0.0)
    prob.finalize()
    lam = torch.tensor(1.7, dtype=torch.float64, device=device)
    x = solve("parametric Dirichlet", prob, direct, prob.base_params(lam=lam))
    m = prob.mesh
    bot = np.setdiff1d(m.nodesets["bottom"], m.nodesets["left"])
    if np.abs(prob.get_nodal_field(x, "temperature")[bot]
              - 1.7 * m.coords[bot, 0]).max() > 1e-12:
        raise RuntimeError(f"parametric Dirichlet on {device}: T != lam x")

    # the doubly periodic corner chain
    class PoissonMMS(Equation):
        def __init__(self):
            super().__init__("temperature", 1, "Q1")

        def residual(self, fv, mat, params):
            gT = fv.grad["temperature"][:, 0, :]
            f = (2 * np.pi) ** 2 * torch.sin(2 * np.pi * fv.x[:, 0])
            return (torch.einsum("qk,qik->qi", gT, fv.gphi["temperature"])
                    - f[:, None] * fv.phi["temperature"])[:, None, :]

    mesh = rectangle_mesh(4, 4, elem="QUAD4")
    prob = Problem(mesh, [[PoissonMMS()]], [{}], device=device)
    prob.add_periodic("left", "right")
    prob.add_periodic("bottom", "top")
    mesh.nodesets["pin"] = np.array([5], dtype=np.int32)
    prob.add_dirichlet("pin", "temperature", 0, 0.0)
    prob.finalize()
    corners = [np.argmin(np.sum(np.abs(mesh.coords - np.array(c)), axis=1))
               for c in ((0, 0), (1, 0), (0, 1), (1, 1))]
    if len({int(prob.dofmap.dof_of_node_svar[c, 0]) for c in corners}) != 1:
        raise RuntimeError("doubly periodic chain: the corners are not one dof")
    solve("doubly periodic chain", prob, direct)

    # the 3-D manufactured Navier-Stokes deck
    def u_exact(x):
        X, Y, Z = x[0], x[1], x[2]
        return torch.stack([torch.sin(np.pi * Y) * Z * (1 - Z),
                            torch.sin(np.pi * Z) * X * (1 - X),
                            torch.sin(np.pi * X) * Y * (1 - Y)]) * 0.1

    def p_exact(x):
        return torch.cos(np.pi * x[0]) * x[1] + x[2]

    def f_point(x):
        lap = torch.stack([torch.trace(hessian(lambda y, a=a: u_exact(y)[a])(x))
                           for a in range(3)])
        return jacfwd(u_exact)(x) @ u_exact(x) - 0.7 * lap + jacfwd(p_exact)(x)

    mesh = box_mesh(3, 3, 3, elem="HEX27")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=3, interp="Q2", transient=False),
                          Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": 0.7,
                    "body_force": lambda fv, mat, p: vmap(f_point)(fv.x)},
                   device=device)
    exact = lambda c: vmap(u_exact)(torch.as_tensor(c)).numpy()  # noqa: E731

    def wall(k):  # a one-argument value: evaluated once, at finalize
        return lambda c: exact(c)[:, k]

    for ns in ("left", "right", "top", "bottom", "front", "back"):
        for k in range(3):
            prob.add_dirichlet(ns, "velocity", k, wall(k))
    prob.add_dirichlet("pin", "pressure", 0,
                       float(p_exact(torch.as_tensor(mesh.coords[0]))))
    prob.finalize()
    x = solve("3-D manufactured Navier-Stokes", prob, direct)
    U = np.stack([prob.get_nodal_field(x, "velocity", k) for k in range(3)], 1)
    if np.abs(U - exact(mesh.coords)).max() > 1.5e-3:
        raise RuntimeError(f"3-D Navier-Stokes on {device}: velocity error "
                           "above goma_tpu's 1.5e-3")

    # a transient run with variable_stats
    mesh = rectangle_mesh(4, 4, elem="QUAD9")
    prob = Problem(mesh, [Energy(interp="Q2", transient=True, convection=False)],
                   {"rho": 1.0, "Cp": 1.0, "k": 1.0}, device=device)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "temperature", 0,
                              lambda c: np.sin(np.pi * c[:, 0])
                              * np.sin(np.pi * c[:, 1]))
    ts = TransientSolver(prob, direct, TimeOptions(
        dt0=0.01, t_end=0.02, adapt=False, verbose=True, variable_stats=True))
    r = ts.run(x0, prob.base_params())
    out["transient variable_stats"] = (sum(s.newton_iters for s in r.steps), r.x)
    return out


def bc_small_phase():
    """Phase 38: phase 38's decks (``bc_small_decks``) on cuda and on cpu
    (the CPU runs from ``cpu_runs``): the same Newton count and x within
    BC_X_TOL."""
    t0 = time.perf_counter()
    got = {"cuda": bc_small_decks(torch.device("cuda"))}
    log(f"phase 38 decks on cuda: {time.perf_counter() - t0:.1f} s")
    got["cpu"] = cpu_runs("bc", lambda: bc_small_decks(torch.device("cpu")))
    for name, (it_c, x_c) in got["cuda"].items():
        it_p, x_p = got["cpu"][name]
        dx = rel_dx(x_c, x_p)
        log(f"{name}: Newton cuda {it_c} cpu {it_p}, max |dx| / (1 + |x|) "
            f"{dx:.2e}")
        if it_c != it_p or not dx <= BC_X_TOL:
            raise RuntimeError(f"{name}: cuda and cpu differ (Newton {it_c} / "
                               f"{it_p}, x {dx:.2e} > {BC_X_TOL:.0e})")


def lid_cavity_problem(n, device):
    """The continuation deck: ``cavity_problem(n)`` with mu = CONT_MU and the
    lid's u the parametric Dirichlet value params["U"] (Re = 100 U),
    float32 Jacobian."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import Continuity, Momentum

    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    mesh.nodesets["lid"] = top[(xt > xt.min()) & (xt < xt.max())]
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": CONT_MU}, device=device)
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("lid", "velocity", 0, lambda c, p: p["U"])
    prob.add_dirichlet("lid", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = torch.float32
    return prob


def scalar_params(prob, key):
    """make_params(v): the problem's base params with ``key`` the 0-d tensor
    v on its device (v a float, or a tensor carrying a tangent)."""
    def make_params(v):
        return prob.base_params(**{key: torch.as_tensor(
            v, dtype=prob.dtype, device=prob.device)})
    return make_params


def reset_counts():
    """Every kernel's launch count and ``_dR_dlam``'s route counts to 0."""
    from goma_tpu_torch.continuation.conti import _dR_dlam
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather

    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    _dR_dlam.routes.update(jvp=0, central_difference=0)
    torch.cuda.synchronize()


def read_counts():
    """({"lu", "trsv", "gather": launches}, {"jvp", "central_difference"})."""
    from goma_tpu_torch.continuation.conti import _dR_dlam
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather

    torch.cuda.synchronize()
    return ({"lu": batched_lu.launches, "trsv": batched_trsv.launches,
             "gather": front_gather.launches}, dict(_dR_dlam.routes))


@contextmanager
def continuation_probe():
    """While a continuation runs (its Newton solver is its own): every
    Newton solve's end (host clock after a synchronize, Newton iterations,
    convergence, the launches and factorizations so far, the solver),
    every predictor solve's linear iterations (``_solve_gmres``, which only
    the continuation layer calls), and each NDLU's last factored CSR
    values. The class methods are restored on exit."""
    from goma_tpu_torch.solvers import NewtonSolver
    from goma_tpu_torch.solvers.ndlu import NDLU

    rec = {"solves": [], "pred": [], "factored": {}}
    solve, pred, factor = NewtonSolver.solve, NewtonSolver._solve_gmres, NDLU.factor

    def solve_rec(self, x0, params):
        res = solve(self, x0, params)
        ln, _ = read_counts()
        rec["solves"].append({
            "t": time.perf_counter(), "iters": res.iters,
            "converged": res.converged, "launches": ln, "solver": self,
            "factorizations": self.n_factor + self._ndlu_nfactor})
        return res

    def pred_rec(self, vals, R, *a, **k):
        out = pred(self, vals, R, *a, **k)
        rec["pred"].append(int(out.iters))
        return out

    def factor_rec(self, vals, *a, **k):
        rec["factored"][id(self)] = (self, vals)
        return factor(self, vals, *a, **k)

    NewtonSolver.solve, NewtonSolver._solve_gmres = solve_rec, pred_rec
    NDLU.factor = factor_rec
    try:
        yield rec
    finally:
        NewtonSolver.solve, NewtonSolver._solve_gmres = solve, pred
        NDLU.factor = factor


def continuation_phase(dev, rung):
    """Phases 39 (``gmres_ndlu``) and 40 (``tpu_direct``): the 64x64 lid-speed
    cavity continued by ``continue_problem(make_params, 1.0, 4.0, dlam0=0.5,
    x0=0, first_order=True)`` (Re 100 -> 400) on the rung's options, every
    count set to 0 just before and read just after. Prints each step (U,
    Newton and predictor linear iterations beside goma_tpu's, s, launches
    and factorizations) and requires goma_tpu's accepted U sequence
    (``CONT_REF``), Newton +-1 a step, the predictor's linear iterations
    within REF_LIN_TOL or CONT_PRED_RTOL, x at the sampled dofs of every
    step within
    REF_X_TOL, u/U's minimum on x = 0.5 at U = 4 within
    ``GHIA400_RTOL`` of Ghia's Re 400 value, every predictor's dR/dU by the
    exact jvp route, front-LU and front-gather launches = levels x NDLU
    factorizations and (``tpu_direct``) substitution launches = 2 x levels
    x NDLU solves. Then each kernel against its plain version on the fronts
    of the run's last NDLU factorization (and, ``tpu_direct``, on the
    substitutions of a solve with that factor)."""
    from goma_tpu_torch.continuation import continue_problem

    label = f"continuation {rung}"
    t_phase = time.perf_counter()
    prob = lid_cavity_problem(CONT_N, dev)
    ref = CONT_REF[rung]
    opts = cavity_opts() if rung == "gmres_ndlu" else direct_opts()
    make_params = scalar_params(prob, "U")
    n = prob.dofmap.n_dof
    reset_counts()
    t0 = time.perf_counter()
    with continuation_probe() as rec:
        steps = continue_problem(prob, make_params, 1.0, 4.0, 0.5, np.zeros(n),
                                 opts, first_order=True)
    sec = time.perf_counter() - t0
    ln, routes = read_counts()
    solves = rec["solves"]
    solver = solves[-1]["solver"]
    log(f"{label}: {len(steps)} steps in {sec:.2f} s, {len(solves)} Newton "
        f"solves, {len(rec['pred'])} predictor solves; launches {ln}; "
        f"_dR_dlam routes {routes}")
    samples = np.linspace(0, n - 1, REF_SAMPLES).astype(np.int64)
    lams = [float(s.lam) for s in steps]
    t_prev, ln_prev, f_prev = t0, {k: 0 for k in ln}, 0
    for k, (s, sv) in enumerate(zip(steps, solves)):
        d_ln = {q: sv["launches"][q] - ln_prev[q] for q in ln}
        pl = rec["pred"][k - 1] if k else "-"
        rl = ref["predictor_linear"][k - 1] if k else "-"
        log(f"{label} step {k}: U = {s.lam:.4f} (goma_tpu {ref['lam'][k]:.4f}), "
            f"Newton {s.newton_iters} (goma_tpu {ref['newton'][k]}), predictor "
            f"linear {pl} (goma_tpu {rl}), {sv['t'] - t_prev:.3f} s, "
            f"factorizations {sv['factorizations'] - f_prev}, launches {d_ln}, "
            f"x at {REF_SAMPLES} dofs {rel_dx(s.x[samples], np.asarray(ref['x_samples'][k])):.2e} "
            "from goma_tpu's")
        t_prev, ln_prev, f_prev = sv["t"], sv["launches"], sv["factorizations"]
    if len(solves) != len(steps):
        raise RuntimeError(f"{label}: {len(solves) - len(steps)} rejected steps "
                           "(goma_tpu's run had none)")
    if len(lams) != len(ref["lam"]) or max(abs(a - b) for a, b in
                                           zip(lams, ref["lam"])) > 1e-12:
        raise RuntimeError(f"{label}: accepted U {lams} != goma_tpu's {ref['lam']}")
    if any(abs(s.newton_iters - r) > 1 for s, r in zip(steps, ref["newton"])):
        raise RuntimeError(f"{label}: Newton {[s.newton_iters for s in steps]} "
                           f"not within 1 of goma_tpu's {ref['newton']}")
    if len(rec["pred"]) != len(ref["predictor_linear"]) or any(
            abs(a - b) > max(REF_LIN_TOL, CONT_PRED_RTOL * b) for a, b in
            zip(rec["pred"], ref["predictor_linear"])):
        raise RuntimeError(f"{label}: predictor linear iterations {rec['pred']} "
                           f"not within {REF_LIN_TOL} or {CONT_PRED_RTOL:.0%} "
                           f"of goma_tpu's {ref['predictor_linear']}")
    for k, s in enumerate(steps):
        if not np.all(np.isfinite(s.x)) or s.x.shape != (n,):
            raise RuntimeError(f"{label} step {k}: wrong shape or non-finite x")
        dx = rel_dx(s.x[samples], np.asarray(ref["x_samples"][k]))
        if dx > REF_X_TOL:
            raise RuntimeError(f"{label} step {k}: x is {dx:.2e} from goma_tpu's "
                               f"> {REF_X_TOL:.0e}")
    line = np.abs(prob.mesh.coords[:, 0] - 0.5) < 1e-9
    u_min = float(np.nanmin(prob.get_nodal_field(steps[-1].x, "velocity", 0)[line])
                  / steps[-1].lam)
    log(f"{label}: min u/U on x = 0.5 at U = 4 (Re 400) {u_min:.5f} (Ghia "
        f"{GHIA400_U_MIN}, goma_tpu {ref['u_min_centre_line']:.5f})")
    if abs(u_min - GHIA400_U_MIN) > GHIA400_RTOL * abs(GHIA400_U_MIN):
        raise RuntimeError(f"{label}: min u/U {u_min:.5f} not within "
                           f"{GHIA400_RTOL:.0%} of Ghia's {GHIA400_U_MIN}")
    if routes["central_difference"] or routes["jvp"] != len(rec["pred"]):
        raise RuntimeError(f"{label}: dR/dU routes {routes}, not the exact jvp "
                           f"for each of {len(rec['pred'])} predictors")
    # the NDLU the rung factors on: the preconditioner, or tpu_direct's own
    nd_last = [(nd, v) for nd, v in rec["factored"].values()
               if nd.invert == (rung == "gmres_ndlu")]
    if len(nd_last) != 1:
        raise RuntimeError(f"{label}: {len(nd_last)} NDLUs factored, not one")
    nd, vals = nd_last[0]
    levels = len(nd.levels)
    direct = rung == "tpu_direct"
    nfac = solver._ndlu_nfactor if direct else solver.n_factor
    if nfac < 1 or ln["lu"] != levels * nfac or ln["gather"] != levels * nfac:
        raise RuntimeError(f"{label}: front-LU launches {ln['lu']} / front-gather "
                           f"launches {ln['gather']} != {levels} levels x {nfac} "
                           "factorizations")
    if direct and (nd.n_solve < 1 or ln["trsv"] != 2 * levels * nd.n_solve):
        raise RuntimeError(f"{label}: substitution launches {ln['trsv']} != 2 x "
                           f"{levels} levels x {nd.n_solve} solves")
    out = {"prob": prob, "steps": steps, "launches": ln,
           "max_abs": check_real_fronts(nd, vals, f"{label} last factorization"),
           "gather_abs": check_gathers(nd, vals, f"{label} tree")}
    if direct:
        calls = []
        rhs = torch.as_tensor(np.random.default_rng(39).standard_normal(n),
                              dtype=vals.dtype, device=vals.device)
        nd.solve(nd.factor(vals), rhs, trace=calls)
        out["trsv"] = check_substitutions(calls, label)
    log(f"phase {39 if rung == 'gmres_ndlu' else 40} ({label}): "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def augmenting_phase(prob, steps):
    """Phase 41: the augmenting condition on the 64x64 lid-speed cavity
    (``gmres_ndlu`` options, ``linear_tol=1e-8``): find U such that u at the
    node nearest CONT_AC_POINT equals the value goma_tpu's solve at U = 3
    reaches, from the accepted step below 3 (``CONT_REF["ac"]``). Requires
    convergence, |U - 3| <= CONT_AC_TOL, U within CONT_AC_TOL of goma_tpu's,
    goma_tpu's Newton count +-1, the exact route, and front-LU and
    front-gather launches = levels x factorizations."""
    import dataclasses

    from goma_tpu_torch.continuation import (AugmentedNewtonSolver,
                                             AugmentingCondition)

    t_phase = time.perf_counter()
    ref = CONT_REF["ac"]
    coords = prob.mesh.coords
    node = int(np.argmin(np.sum((coords - np.array(CONT_AC_POINT)) ** 2, axis=1)))
    dof = int(prob.dofmap.dof_of_node_svar[node, prob.dofmap.svar("velocity", 0)])
    if dof != ref["dof"]:
        raise RuntimeError(f"AC: dof {dof} != goma_tpu's {ref['dof']}")
    start = next(s for s in steps if s.lam == ref["start"])
    target = ref["target"]
    ac = AugmentingCondition(key="U", g=lambda x, p: x[dof] - target, p0=start.lam)
    opts = dataclasses.replace(cavity_opts(), linear_tol=1e-8)
    solver = AugmentedNewtonSolver(prob, [ac], opts)
    reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(start.x, scalar_params(prob, "U")(start.lam))
    sec = time.perf_counter() - t0
    ln, routes = read_counts()
    U = float(res.p[0])
    nf = solver.solver.n_factor
    log(f"AC: from U = {start.lam} to u(node {node}) = {target:.6f}: U = {U:.10f} "
        f"(goma_tpu {ref['p']:.10f}), converged {res.converged}, {res.iters} "
        f"Newton (goma_tpu {ref['iters']}), norms {res.res_norms} (goma_tpu "
        f"{ref['res_norms']}), {sec:.2f} s, {nf} factorizations, launches {ln}, "
        f"_dR_dlam routes {routes} (its dR/dU is its own jvp)")
    if not res.converged or abs(U - 3.0) > CONT_AC_TOL or abs(U - ref["p"]) > CONT_AC_TOL:
        raise RuntimeError(f"AC: U = {U} (converged {res.converged}) not within "
                           f"{CONT_AC_TOL:.0e} of 3 and of goma_tpu's {ref['p']}")
    if abs(res.iters - ref["iters"]) > 1:
        raise RuntimeError(f"AC: {res.iters} Newton, not goma_tpu's {ref['iters']} +- 1")
    if routes["central_difference"]:
        raise RuntimeError(f"AC: dR/dU took the central difference {routes}")
    levels = len(solver.solver.precond.levels)
    if nf < 1 or ln["lu"] != levels * nf or ln["gather"] != levels * nf:
        raise RuntimeError(f"AC: front-LU launches {ln['lu']} / front-gather "
                           f"launches {ln['gather']} != {levels} levels x {nf} "
                           "factorizations")
    log(f"phase 41 (augmenting condition): {time.perf_counter() - t_phase:.1f} s")
    return {"launches": ln}


def flux_phase(prob, x4):
    """Phase 42: dF/dU of the lid's x-traction (``traction_integrand(0)``
    over "top") at U = 4, on phase 39's state polished by the host ``direct``
    rung to 1e-10: ``post.flux_sensitivity`` (its dR/dU by the exact jvp
    route) within CONT_FLUX_RTOL of goma_tpu's and of the central
    difference over two direct solves at U +- 1e-3."""
    from goma_tpu_torch.post import sideset_integral, traction_integrand
    from goma_tpu_torch.post.postproc import flux_sensitivity
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver

    t_phase = time.perf_counter()
    ref = CONT_REF["flux"]
    mp = scalar_params(prob, "U")
    direct = NewtonOptions(max_iter=8, tol_residual=1e-10, linear_solver="direct")
    r4 = NewtonSolver(prob, direct).solve(x4, mp(4.0))
    if not r4.converged:
        raise RuntimeError("flux: the U = 4 state did not polish to 1e-10")
    F = sideset_integral(prob, "top", traction_integrand(0))
    dev_x = torch.as_tensor(r4.x, dtype=prob.dtype, device=prob.device)
    F4 = float(F(dev_x, mp(4.0)))
    reset_counts()
    t0 = time.perf_counter()
    dF = float(flux_sensitivity(prob, F, r4.x, mp(4.0), "U"))
    sec = time.perf_counter() - t0
    _, routes = read_counts()
    h = ref["h"]
    Fh = []
    for U in (4.0 + h, 4.0 - h):
        r = NewtonSolver(prob, direct).solve(r4.x, mp(U))
        Fh.append(float(F(torch.as_tensor(r.x, dtype=prob.dtype,
                                          device=prob.device), mp(U))))
    cd = (Fh[0] - Fh[1]) / (2 * h)
    log(f"flux: F = {F4:.10f} (goma_tpu {ref['F']:.10f}), dF/dU = {dF:.10f} "
        f"(goma_tpu {ref['dF_dU']:.10f}; central difference {cd:.10f}, "
        f"goma_tpu's {ref['central_difference']:.10f}), {sec:.2f} s, routes {routes}")
    if routes != {"jvp": 1, "central_difference": 0}:
        raise RuntimeError(f"flux: dR/dU routes {routes}, not one exact jvp")
    for name, v in (("goma_tpu's", ref["dF_dU"]), ("the central difference", cd)):
        if abs(dF - v) > CONT_FLUX_RTOL * abs(v):
            raise RuntimeError(f"flux: dF/dU {dF} not within {CONT_FLUX_RTOL:.0e} "
                               f"of {name} {v}")
    log(f"phase 42 (flux sensitivity): {time.perf_counter() - t_phase:.1f} s")


def bratu_problem(n, device):
    """-lap T = lam e^T on the n x n QUAD9 unit square, T = 0 on the
    boundary (tests/test_continuation.py's Bratu deck)."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import Energy

    def source(fv, mat, params):
        return params["lam"] * torch.exp(fv.val["temperature"][:, 0])

    prob = Problem(rectangle_mesh(n, n, elem="QUAD9"),
                   [Energy(interp="Q2", transient=False, convection=False)],
                   {"k": 1.0, "heat_source": source}, device=device)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    return prob


def bratu_phase(dev):
    """Phase 43: the Bratu turning point on the 64x64 QUAD9 square (16,641
    dof; the generic AD assembly and the nested jvps on the card, the host
    ``direct`` solves goma_tpu's fold tracker defaults to): first-order
    continuation 0 -> 6, ``arclength_continue`` from 6 (ds0 4, lam_scale 5,
    7 steps), ``detect_folds``, ``fold_track`` from the step before the
    fold. Requires goma_tpu's lambda sequences and Newton counts
    (``CONT_REF["bratu"]``; arclength lambda within CONT_ARC_TOL), lam_c
    within CONT_FOLD_TOL of goma_tpu's and within 0.02 of 6.808, and every
    dR/dlam by the exact route."""
    from goma_tpu_torch.continuation import (arclength_continue,
                                             continue_problem, detect_folds,
                                             fold_track)
    from goma_tpu_torch.solvers import NewtonOptions

    t_phase = time.perf_counter()
    ref = CONT_REF["bratu"]
    prob = bratu_problem(CONT_BRATU_N, dev)
    mp = scalar_params(prob, "lam")
    reset_counts()
    t0 = time.perf_counter()
    steps = continue_problem(prob, mp, 0.0, 6.0, 1.0, np.zeros(prob.dofmap.n_dof),
                             NewtonOptions(max_iter=12, tol_residual=1e-10,
                                           linear_solver="direct"))
    t1 = time.perf_counter()
    arc = arclength_continue(prob, mp, 6.0, steps[-1].x, ds0=4.0, n_steps=7,
                             newton_options=NewtonOptions(
                                 max_iter=12, tol_residual=1e-9,
                                 linear_solver="direct"), lam_scale=5.0)
    folds = detect_folds(arc)
    t2 = time.perf_counter()
    if not folds:
        raise RuntimeError(f"Bratu: no fold on the arclength branch "
                           f"{[a.lam for a in arc]}")
    i = folds[0] - 1
    fr = fold_track(prob, mp, arc[i].lam, arc[i].x,
                    NewtonOptions(linear_solver="direct"), tol=1e-8)
    t3 = time.perf_counter()
    _, routes = read_counts()
    lams = [float(s.lam) for s in steps]
    arc_lams = [float(a.lam) for a in arc]
    log(f"Bratu {prob.dofmap.n_dof} dof: continuation U {lams} Newton "
        f"{[s.newton_iters for s in steps]} (goma_tpu {ref['lam']} "
        f"{ref['newton']}) {t1 - t0:.2f} s; arclength {arc_lams} Newton "
        f"{[a.newton_iters for a in arc]} (goma_tpu {ref['arc_lam']} "
        f"{ref['arc_newton']}) {t2 - t1:.2f} s, folds {folds}; fold_track "
        f"lam_c = {fr.lam:.10f} (goma_tpu {ref['fold_lam']:.10f}), "
        f"{fr.iters} iterations (goma_tpu {ref['fold_iters']}), norms "
        f"{fr.res_norms}, {t3 - t2:.2f} s; routes {routes}")
    if lams != ref["lam"] or [s.newton_iters for s in steps] != ref["newton"]:
        raise RuntimeError("Bratu: the continuation is not goma_tpu's")
    if (folds != ref["folds"] or len(arc_lams) != len(ref["arc_lam"])
            or max(abs(a - b) for a, b in zip(arc_lams, ref["arc_lam"])) > CONT_ARC_TOL
            or [a.newton_iters for a in arc] != ref["arc_newton"]):
        raise RuntimeError("Bratu: the arclength branch is not goma_tpu's")
    if (not fr.converged or abs(fr.lam - ref["fold_lam"]) > CONT_FOLD_TOL
            or abs(fr.lam - 6.808) > 0.02):
        raise RuntimeError(f"Bratu: lam_c {fr.lam} (converged {fr.converged}) "
                           f"not within {CONT_FOLD_TOL:.0e} of goma_tpu's "
                           f"{ref['fold_lam']} and 0.02 of 6.808")
    if routes["central_difference"] or not routes["jvp"]:
        raise RuntimeError(f"Bratu: dR/dlam routes {routes}")
    log(f"phase 43 (Bratu fold): {time.perf_counter() - t_phase:.1f} s")


def film_problem(dev, zmode, ny=12, rho=0.01, g=8.0):
    """examples/film_stability.py::run's film restated: a viscous film
    (depth 1, mu 1, sigma 1, rho 0.01, g 8) on a no-slip floor with a free
    capillary top, ALE, plus the z-mode equations (``zmode``)."""
    from goma_tpu_torch.bc import CapillaryBC, KinematicBC
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import (CapillaryZNormal, Continuity,
                                        EllipticMesh, Momentum, zmode_equations)

    mesh = rectangle_mesh(2, ny, elem="QUAD9", xlim=(0, 0.25), ylim=(0, 1.0))
    eqs = [Momentum(dim=2, interp="Q2", transient=True), Continuity(interp="Q1"),
           EllipticMesh(dim=2, interp="Q2")]
    if zmode:
        eqs += zmode_equations(dim=2)
    prob = Problem(mesh, eqs, {"rho": rho, "mu": 1.0, "sigma": 1.0,
                               "body_force": np.array([0.0, -g])}, device=dev)
    for c in (0, 1):
        prob.add_dirichlet("bottom", "velocity", c, 0.0)
        prob.add_dirichlet("bottom", "mesh_displacement", c, 0.0)
    if zmode:
        prob.add_dirichlet("bottom", "nm_w", 0, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "mesh_displacement", 0, 0.0)
    prob.add_face_kernel("top", CapillaryBC(dim=2))
    prob.add_face_kernel("top", KinematicBC(dim=2))
    if zmode:
        prob.add_face_kernel("top", CapillaryZNormal(dim=2))
    prob.finalize()
    return prob


def stability_phase(dev):
    """Phase 44: the pitchfork (10x1) and Hopf (3x3 Brusselator) decks of
    tests/test_bifurcation2.py (lambda* = pi^2 within 1e-3, b* = 1 + a^2 and
    omega = a within 1e-8, each within 1e-8 of goma_tpu's); the growth rates
    of examples/rayleigh_benard_3d_stability.py::sweep(Ra=700) and
    examples/film_stability.py::run() restated (film within 2% of its exact
    dispersion), of the plane-Couette 3D-of-2D driver of
    tests/test_normal_mode.py, and of ``solve_stability_device`` on the 8x8
    heat spectrum, each within CONT_SIG_RTOL of goma_tpu's
    (``CONT_REF["small"]``). The Jacobians, mass matrices and derivative
    actions on the card, the eigensolves' small systems on the host."""
    from goma_tpu_torch.continuation import (solve_stability,
                                             solve_stability_3d_of_2d,
                                             solve_stability_3d_of_2d_ale)
    from goma_tpu_torch.continuation.bifurcation import (hopf_track,
                                                         pitchfork_track)
    from goma_tpu_torch.continuation.stability import solve_stability_device
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import (Continuity, Energy, Momentum,
                                        NormalModeContinuity, NormalModeEnergy,
                                        NormalModeMomentum, NormalModeW, Species)
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
    from scripts import arpack_start

    t_phase = time.perf_counter()
    ref = CONT_REF["small"]

    def close(name, got, want, rtol):
        got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        log(f"{name}: {got.tolist()} (goma_tpu {want.tolist()}), max rel "
            f"diff {err:.2e}")
        if got.shape != want.shape or not err <= rtol:
            raise RuntimeError(f"{name}: not within {rtol:.0e} of goma_tpu's")

    # pitchfork: u'' + lam u - u^3 = 0
    prob = Problem(rectangle_mesh(10, 1, elem="QUAD9"),
                   [Species(1, interp="Q2", transient=False, convection=False)],
                   {"diffusivity": 1.0, "species_source":
                    lambda fv, mat, params: params["lam"] * fv.val["species"]
                    - fv.val["species"] ** 3}, device=dev)
    prob.add_dirichlet("left", "species", 0, 0.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.finalize()
    psi = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0,
                               lambda X: np.sin(np.pi * X[:, 0]))
    pf = pitchfork_track(prob, scalar_params(prob, "lam"), lam0=9.3,
                         x0=np.zeros(prob.dofmap.n_dof), psi=psi)
    log(f"pitchfork: lam* = {pf.lam:.12f} (pi^2 {np.pi ** 2:.12f}, goma_tpu "
        f"{ref['pitchfork']['lam']:.12f}), {pf.iters} iterations")
    if (not pf.converged or abs(pf.lam - np.pi ** 2) > 1e-3 * np.pi ** 2
            or abs(pf.lam - ref["pitchfork"]["lam"]) > 1e-8):
        raise RuntimeError(f"pitchfork: lam* {pf.lam}")
    # Hopf: the Brusselator, a = 1.3
    a = 1.3

    def brus(fv, mat, params):
        u, v = fv.val["species"][:, 0], fv.val["species"][:, 1]
        b = params["b"]
        return torch.stack([a - (b + 1.0) * u + u * u * v, b * u - u * u * v], 1)

    prob = Problem(rectangle_mesh(3, 3, elem="QUAD4"),
                   [Species(2, interp="Q1", transient=True, convection=False)],
                   {"diffusivity": torch.tensor([0.02, 0.05], dtype=torch.float64,
                                                device=dev),
                    "species_source": brus}, device=dev)
    prob.finalize()
    b0 = 1.0 + a * a + 0.25
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, a)
    x0 = prob.set_nodal_field(x0, "species", 1, b0 / a)
    hp = hopf_track(prob, scalar_params(prob, "b"), lam0=b0, omega0=1.15 * a,
                    x0=x0, tol=1e-9)
    log(f"Hopf: b* = {hp.lam:.12f} (1 + a^2 = {1 + a * a:.12f}, goma_tpu "
        f"{ref['hopf']['b']:.12f}), omega = {abs(hp.omega):.12f} (a = {a}, "
        f"goma_tpu {ref['hopf']['omega']:.12f}), {hp.iters} iterations")
    for got, exact, rec in ((hp.lam, 1 + a * a, ref["hopf"]["b"]),
                            (abs(hp.omega), a, ref["hopf"]["omega"])):
        if not hp.converged or abs(got - exact) > 1e-8 * exact or abs(got - rec) > 1e-8:
            raise RuntimeError(f"Hopf: {got} vs exact {exact}, goma_tpu {rec}")
    # Rayleigh-Benard, Ra = 700, the example's wavenumbers
    mesh = rectangle_mesh(3, 6, elem="QUAD9", xlim=(0, 0.5), ylim=(0, 1))
    prob = Problem(mesh, [NormalModeMomentum(), NormalModeW(),
                          NormalModeContinuity(), NormalModeEnergy()],
                   {"rho": 1.0, "mu": 1.0, "k": 1.0, "Cp": 1.0,
                    "buoyancy": (0.0, 700.0)},
                   external_fields=("u0", "v0", "T0"), device=dev)
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "nm_velocity", 1, 0.0)
        prob.add_dirichlet(ns, "nm_temperature", 0, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "nm_velocity", 0, 0.0)
    prob.finalize()
    z = np.zeros(mesh.n_nodes)
    sig = []
    for b, _ in ref["rb_sweep"]:
        p = prob.base_params(beta=torch.tensor(b, dtype=prob.dtype, device=dev),
                             ext_u0=z, ext_v0=z, ext_T0=1.0 - mesh.coords[:, 1])
        sig.append(float(solve_stability(prob, np.zeros(prob.dofmap.n_dof), p,
                                         n_modes=2, shift=0.5).growth_rates.real.max()))
    close("Rayleigh-Benard Ra 700 growth rates", sig,
          [s for _, s in ref["rb_sweep"]], CONT_SIG_RTOL)
    # the film
    base = film_problem(dev, zmode=False)
    res = NewtonSolver(base, NewtonOptions(max_iter=6, tol_residual=1e-11,
                                           linear_solver="direct")).solve(
        np.zeros(base.dofmap.n_dof), base.base_params())
    if not res.converged:
        raise RuntimeError("film: the base state did not converge")
    ext = film_problem(dev, zmode=True)
    sig = []
    for b, _, se in ref["film"]:
        # goma_tpu's record was taken from the same ARPACK start vector
        with arpack_start.fixed_start(FILM_ARPACK_SEED):
            (_, s, _), = solve_stability_3d_of_2d_ale(ext, base, res.x, [b],
                                                      n_modes=4, shift=se)
        if abs(s - se) > 0.02 * abs(se):
            raise RuntimeError(f"film: beta {b}: {s} not within 2% of the exact {se}")
        sig.append(s)
    close("film growth rates", sig, [s for _, s, _ in ref["film"]], CONT_SIG_RTOL)
    # plane Couette through the 3D-of-2D driver
    mesh = rectangle_mesh(3, 8, elem="QUAD9", xlim=(0, 0.5), ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    base = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")], {"rho": 1.0, "mu": 0.1},
                   device=dev)
    for ns in ("left", "right", "top", "bottom"):
        base.add_dirichlet(ns, "velocity", 0, lambda c: c[:, 1])
        base.add_dirichlet(ns, "velocity", 1, 0.0)
    base.add_dirichlet("pin", "pressure", 0, 0.0)
    base.finalize()
    res = NewtonSolver(base, NewtonOptions(max_iter=8, tol_residual=1e-10,
                                           linear_solver="direct")).solve(
        np.zeros(base.dofmap.n_dof), base.base_params())
    out = solve_stability_3d_of_2d(base, res.x, betas=[b for b, _ in ref["couette"]],
                                   mat={"rho": 1.0, "mu": 0.1}, n_modes=3, shift=0.0)
    close("plane Couette growth rates", [s for _, s, _ in out],
          [s for _, s in ref["couette"]], CONT_SIG_RTOL)
    # the device Arnoldi on the heat spectrum
    prob = Problem(rectangle_mesh(8, 8, elem="QUAD9"),
                   [Energy(interp="Q2", transient=True, convection=False)],
                   {"rho": 1.0, "Cp": 1.0, "k": 1.0}, device=dev)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    r = solve_stability_device(prob, np.zeros(prob.dofmap.n_dof),
                               prob.base_params(), n_modes=4,
                               shift=-2 * np.pi ** 2)
    close("heat spectrum (device Arnoldi)", sorted(r.growth_rates.real),
          ref["heat_device"], CONT_SIG_RTOL)
    log(f"phase 44 (bifurcations and stability): {time.perf_counter() - t_phase:.1f} s")


# ---- phases 45-47: the overset, interface and edge coupling sets
OVS_NX, OVS_NY, OVS_NSEG, OVS_RADIUS = 96, 48, 134, 0.2
# goma_tpu's record of the immersed cylinder on both device rungs
# (``python3 scripts/overset_reference.py --part cylinder --nx 96 --ny 48
# --nseg 134``, goma_tpu on a CPU, float64 state, float32 Jacobian)
OVS_REF = {'gmres+ndlu': {'converged': True,
                'drag': 48.49879252370282,
                'levels': [[236, 192], [128, 192], [64, 63], [32, 104],
                           [16, 133], [8, 278], [4, 186], [2, 418],
                           [1, 287]],
                'linear': [1, 3],
                'newton': 2,
                'x_samples': [0.0, 0.33913601184242265, 0.08019596290251947,
                              0.060622986495494545, 1.6753720922881437,
                              -0.165062965139481, 0.9318134606525479,
                              0.8423208434152637, 0.8847646971966036,
                              -0.2693670917185295, 41.78073483717906,
                              0.8248649362621971, -0.0013931963681413596,
                              0.8240232767634015, 0.021287626281026123,
                              0.8700957704171641, 0.8385407478710741,
                              0.894503464071566, -0.20961343269718913,
                              5.968788456573553, 0.4144948486123702,
                              0.34279832465888194, 0.5719155591787302,
                              -13.08044190780489]},
 'n_dof': 42463,
 'n_lm': 268,
 'nnz': 1705281,
 'nseg': 134,
 'nx': 96,
 'ny': 48,
 'tpu_direct': {'converged': True,
                'drag': 48.49879252194283,
                'levels': [[236, 192], [128, 192], [64, 63], [32, 104],
                           [16, 133], [8, 278], [4, 186], [2, 418],
                           [1, 287]],
                'linear': [1, 1],
                'newton': 2,
                'x_samples': [0.0, 0.3391360118422113, 0.08019596290245808,
                              0.060622986495472625, 1.6753720922880377,
                              -0.1650629651392229, 0.9318134606521454,
                              0.8423208434154145, 0.884764697196525,
                              -0.269367091718009, 41.78073483794899,
                              0.8248649362622993, -0.0013931963680379842,
                              0.8240232767634438, 0.021287626281460446,
                              0.8700957704168406, 0.8385407478709254,
                              0.8945034640721838, -0.20961343269839525,
                              5.968788456569475, 0.4144948486122508,
                              0.3427983246590746, 0.571915559178325,
                              -13.080441901008658]}}
# goma_tpu's record of the small decks (``--part small``)
OVS_SMALL_REF = {'bordered': {'converged': True, 'drag': 47.43937276331011, 'iters': 1},
 'contact': {'T_a': 0.8333333333333334,
             'T_b': 0.6666666666666666,
             'newton': 1},
 'dg': {'newton': 2, 'rate': -2.0004080338730756},
 'direct': {'converged': True,
            'drag': 47.43937276331009,
            'linear': [1],
            'newton': 1},
 'edge': {'flux': 2.499999999999972, 'newton': 1},
 'gmres_auto': {'converged': True,
                'drag': 47.43937276331011,
                'linear': [1097, 1412],
                'newton': 2},
 'wetting': {'force': [-0.459982248551977, -0.6569227314062618]}}
# the drag against goma_tpu's, relative
OVS_DRAG_RTOL = 1e-6
# the small decks' scalar readings (drag, jump, rate, flux, force) against
# goma_tpu's, relative: float64 on both sides, the same operations
OVS_SMALL_RTOL = 1e-8
# cuda against cpu on the small decks: phase 4's bound, max |dx|
OVS_SMALL_X_TOL = 1e-5


def overset_problem(nx, ny, nseg, device):
    """examples/immersed_cylinder.py's problem restated in the port: QUAD9
    on [0, 2] x [0, 1], Stokes mu = 1, parabolic inflow, a BAR circle of
    radius 0.2 at (0.8, 0.5) of ``nseg`` segments carrying P0 multipliers
    (``OversetLM``) tied to the fluid by ``OversetNoSlip``; the float32
    Jacobian bench.py sets. Returns (problem, bar block, overset-set
    seconds, finalize seconds)."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import circle_block, rectangle_mesh
    from goma_tpu_torch.physics import (Continuity, Momentum, OversetLM,
                                        OversetNoSlip)

    mesh = rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 1.0))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    bi = circle_block(mesh, (0.8, 0.5), OVS_RADIUS, n=nseg, name="cylinder")
    prob = Problem(mesh, [
        [Momentum(dim=2, interp="Q2", transient=False, convection=False),
         Continuity(interp="Q1")], [OversetLM(dim=2)]],
        [{"rho": 1.0, "mu": 1.0}, {}], device=device)
    prob.add_dirichlet("left", "velocity", 0, lambda c: 4 * c[:, 1] * (1 - c[:, 1]))
    prob.add_dirichlet("top", "velocity", 0, 0.0)
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    for ns in ("left", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_overset(bi, 0, OversetNoSlip(dim=2))
    # finalize's own build of the overset sets (kd-tree, isoparametric
    # inversions, bases), timed by an instance-level wrapper
    build, t_ovs = prob._build_overset_sets, []

    def timed_build_sets():
        t0 = time.perf_counter()
        sets = build()
        t_ovs.append(time.perf_counter() - t0)
        return sets

    prob._build_overset_sets = timed_build_sets
    t0 = time.perf_counter()
    prob.finalize()
    t_fin = time.perf_counter() - t0
    del prob._build_overset_sets
    prob.jacobian_dtype = torch.float32
    return prob, bi, t_ovs[0], t_fin


def overset_drag(prob, x, bi):
    """The multipliers' x-traction times the segment length, summed."""
    bd = prob.dofmap.blocks[bi]
    s = bd.slot("lm")
    lam = np.asarray(x)[bd.gather[:, s.start:s.start + s.size]]
    return float(lam[:, 0].sum() * 2 * np.pi * OVS_RADIUS / bd.gather.shape[0])


def check_ref_levels(nd, ref, label):
    """The ND tree's (fronts, fully-summed size) per level against
    goma_tpu's record, before any solve; the kernels' gate 1 < s <= 1000."""
    levels = nd_levels(nd)
    shapes = [[nn, m] for nn, m, _ in levels]
    log(f"{label} tree: {len(levels)} levels (nn, s, b) = {levels}; goma_tpu "
        f"(nn, s) = {ref['levels']}")
    if shapes != ref["levels"]:
        raise RuntimeError(f"{label}: ND tree {shapes} != goma_tpu's {ref['levels']}")
    return levels


def overset_phase(dev, kind, prob=None, bi=None):
    """Phases 45 (``gmres+ndlu``) and 46 (``tpu_direct``): the 96x48 immersed
    cylinder (134 segments) under ``bench._cavity_opts(kind, tol=1e-9,
    max_iter=10)``. The overset deck assembles the plain CSR values on every
    rung (the coupling sets are not in the element matvec's aux) and its
    multiplier rows go last in every front (``_saddle_mask`` with ``lm`` on
    ``gmres+ndlu``, ``zero_diag_defer_mask`` on ``tpu_direct``), so the GESP
    boost of the front LU fires on their zero pivots. The tree against
    goma_tpu's; the kernels on its real fronts at x = 0; one warm-up solve,
    ``reset_lagged()``, one timed solve (counts set to 0 just before and
    read just after); goma_tpu's Newton count +-1, linear iterations,
    x at 24 dofs and drag (``OVS_DRAG_RTOL``); launches = levels x
    factorizations (and 2 x levels x solves); each kernel against its
    plain version on the fronts of the timed run's last factorization."""
    from goma_tpu_torch.solvers import NewtonSolver

    label = f"overset {kind}"
    t_phase = time.perf_counter()
    ref = OVS_REF[kind]
    if prob is None:
        prob, bi, t_ovs, t_fin = overset_problem(OVS_NX, OVS_NY, OVS_NSEG, dev)
        log(f"overset setup: {OVS_NX}x{OVS_NY}, {OVS_NSEG} segments, "
            f"{prob.dofmap.n_dof} dof ({2 * OVS_NSEG} multipliers, goma_tpu "
            f"{OVS_REF['n_dof']}), {prob.pattern.nnz} nnz (goma_tpu "
            f"{OVS_REF['nnz']}), {prob.ovs_sets[0].gather.shape[0]} overset "
            f"rows; finalize {t_fin:.2f} s, of it the overset sets {t_ovs:.2f} s")
        if (prob.dofmap.n_dof, prob.pattern.nnz) != (OVS_REF["n_dof"], OVS_REF["nnz"]):
            raise RuntimeError("overset deck: dof or nnz count differs from goma_tpu's")
    direct = kind == "tpu_direct"
    opts = (direct_opts if direct else cavity_opts)(tol=1e-9, max_iter=10)
    solver = NewtonSolver(prob, opts)
    if solver._use_elem_mv or solver._elem_asm_only:
        raise RuntimeError(f"{label}: the coupling sets must take the CSR operator")
    params = prob.base_params()
    if direct:
        # the full prep's values at x = 0, the NDLU the rung will use, the
        # kernels on its real fronts and the substitutions of one solve
        tree = direct_tree_phase(prob, solver, label)
        nd = tree.pop("nd")
        check_ref_levels(nd, ref, label)
    else:
        x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
        vals = solver._prepare(x0, params)[1]  # what the first factor sees
        nd = solver.precond
        levels = check_ref_levels(nd, ref, label)
        shapes = [(nn, m) for nn, m, _ in levels]
        tree = {"max_abs": check_real_fronts(nd, vals, f"{label} x=0"),
                "gather_abs": check_gathers(nd, vals, f"{label} tree")}
        lu_abs, tree["lu_ms"] = lu_shapes(shapes, label, time_twin=True)
        tree["max_abs"] = max(tree["max_abs"], lu_abs)
        tree["lu_bound"] = lu_bound(shapes)
        tree["g_times"], tree["g_bound"] = gather_times(nd, vals, f"{label} tree")
        factor_split_ms(nd, vals, f"{label} tree")
    levels = nd.levels
    seen = record_factor_vals(nd)
    x_init = np.zeros(prob.dofmap.n_dof)
    res, sec, ln = warm_then_timed(solver, x_init, params, label)
    check_launches(solver, ln, len(levels), label, direct=direct)
    check_record(prob, res, ref, label, 1e-9)
    d = overset_drag(prob, res.x, bi)
    log(f"{label}: drag {d:.12f} (goma_tpu {ref['drag']:.12f}), relative "
        f"difference {abs(d - ref['drag']) / abs(ref['drag']):.2e}")
    if abs(d - ref["drag"]) > OVS_DRAG_RTOL * abs(ref["drag"]):
        raise RuntimeError(f"{label}: drag {d} not within {OVS_DRAG_RTOL:.0e} "
                           f"of goma_tpu's {ref['drag']}")
    tree["max_abs"] = max(tree["max_abs"], check_real_fronts(
        nd, seen["last"], f"{label} last factorization"))
    tree["gather_abs"] = max(tree["gather_abs"], check_gathers(
        nd, seen["last"], f"{label} last factorization"))
    del nd.factor  # record_factor_vals's wrapper
    if direct:
        calls = []
        rhs = torch.as_tensor(np.random.default_rng(46).standard_normal(
            prob.dofmap.n_dof), dtype=prob.dtype, device=dev)
        nd.solve(nd.factor(seen["last"]), rhs, trace=calls)
        last = check_substitutions(calls, f"{label} last factorization",
                                   timed=False)
        tree["trsv"]["max_abs"] = max(tree["trsv"]["max_abs"], last["max_abs"])
    log(f"phase {46 if direct else 45} ({label}): {sec / max(res.iters, 1):.4f} "
        f"s/iter, phase {time.perf_counter() - t_phase:.1f} s")
    return {"prob": prob, "bi": bi, "x": res.x, "launches": ln,
            "newton": res.iters, "linear": res.linear_iters, **tree}


def interface_strip(device):
    """tests/test_interface.py's two-layer contact resistance: [0,1]^2 split
    at x = 0.5 into QUAD4 blocks A (k 2) and B (k 0.5), B's interface nodes
    split, the exchange coefficient 4. Returns (problem, A nodes, B
    nodes)."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import Block, Mesh
    from goma_tpu_torch.mesh.interface import (find_interface_faces,
                                               split_interface)
    from goma_tpu_torch.physics import Energy, InterfaceExchange

    gx, gy = 9, 3
    X, Y = np.meshgrid(np.linspace(0, 1, gx), np.linspace(0, 1, gy), indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    ca, cb = [], []
    for j in range(2):
        for i in range(8):
            c = [j * gx + i, j * gx + i + 1, (j + 1) * gx + i + 1, (j + 1) * gx + i]
            (ca if i < 4 else cb).append(c)
    mesh = Mesh(2, coords, [Block("A", "QUAD4", np.asarray(ca, dtype=np.int32)),
                            Block("B", "QUAD4", np.asarray(cb, dtype=np.int32))])
    mesh.nodesets = {"left": np.where(np.isclose(coords[:, 0], 0.0))[0].astype(np.int32),
                     "right": np.where(np.isclose(coords[:, 0], 1.0))[0].astype(np.int32)}
    mesh.sidesets = {}
    pairs = find_interface_faces(mesh, 0, 1)
    orig, new = split_interface(mesh, pairs)
    E = lambda: Energy(interp="Q1", transient=False, convection=False)  # noqa: E731
    prob = Problem(mesh, [[E()], [E()]], [{"rho": 1.0, "Cp": 1.0, "k": 2.0},
                                          {"rho": 1.0, "Cp": 1.0, "k": 0.5}],
                   device=device)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.add_interface_kernel(pairs, InterfaceExchange("temperature", coeff=4.0))
    prob.finalize()
    return prob, orig, new


def dg_channel(device):
    """tests/test_viscoelastic.py's DG stress decay channel (16x2 QUAD9,
    uniform U = 1, P1E Oldroyd-B stress lam 0.5, interior-face upwinding,
    inflow closure s_in = (1, 0.5, 0.25))."""
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.mesh.interface import interior_face_pairs
    from goma_tpu_torch.physics import (Continuity, DGStressInflow,
                                        DGStressUpwind, Momentum, VEStress)

    mesh = rectangle_mesh(16, 2, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 0.25))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1"),
                          VEStress(0, dim=2, lam=0.5, mu_p=1.0, interp="P1E",
                                   supg=0.0, use_projected_gradient=False,
                                   transient=False)],
                   {"rho": 0.0, "mu": 1.0}, device=device)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 1.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_interface_kernel(interior_face_pairs(mesh, 0),
                              DGStressUpwind(0, lam=0.5))
    prob.add_face_kernel("left", DGStressInflow(0, lam=0.5, s_in=[1.0, 0.5, 0.25]))
    prob.finalize()
    return prob


def edge_box(device):
    """tests/test_edge_wetting_bcs.py's line source: a 3x3x3 HEX27 box,
    steady conduction, the bottom held at 0, a line load of 2.5 on the
    top & right edge curve."""
    from goma_tpu_torch.bc.edge import EdgeTraction
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import box_mesh
    from goma_tpu_torch.physics import Energy

    prob = Problem(box_mesh(3, 3, 3, elem="HEX27"),
                   [Energy(interp="Q2", transient=False, convection=False)],
                   {"k": 1.0}, device=device)
    prob.add_dirichlet("bottom", "temperature", 0, 0.0)
    prob.add_edge_kernel("top", "right", EdgeTraction("temperature", 1, 2.5))
    prob.finalize()
    return prob


def wetting_box(device):
    """tests/test_edge_wetting_bcs.py's FILL_CA deck (8x4 QUAD9 level set,
    the Young force at 55 degrees, sigma 0.8) at its planar interface
    through (0.5, 0) at 65 degrees. Returns (problem, x)."""
    from goma_tpu_torch.bc.wetting import FillContactAngle
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.physics import Continuity, FillEquation, Momentum

    mesh = rectangle_mesh(8, 4, elem="QUAD9")
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1"), FillEquation(interp="Q2")],
                   {"rho": 1.0, "mu": 1.0}, device=device)
    prob.add_face_kernel("bottom", FillContactAngle(dim=2, theta_deg=55.0,
                                                    sigma=0.8, eps=0.15))
    prob.finalize()
    th = np.deg2rad(65.0)
    nf = np.array([-np.sin(th), -np.cos(th)])
    x = np.zeros(prob.dofmap.n_dof)
    dF = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar("fill")]
    ok = dF >= 0
    x[dF[ok]] = (mesh.coords[ok] - [0.5, 0.0]) @ nf
    return prob, x


def overset_small_decks(device):
    """The small decks of phase 47 on one device: {name: (Newton count, x,
    reading, linear iterations)} and the bordered solve's launches."""
    from goma_tpu_torch.post import heat_flux, sideset_integral
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
    from goma_tpu_torch.solvers.bordered import (BorderedNewtonSolver,
                                                 multiplier_dof_mask)

    out = {}
    prob, bi, _, _ = overset_problem(20, 10, 28, device)
    prob.jacobian_dtype = None
    x0 = np.zeros(prob.dofmap.n_dof)
    for name, opts in (
            ("direct", NewtonOptions(max_iter=8, tol_residual=1e-9,
                                     linear_solver="direct")),
            ("gmres_auto", NewtonOptions(
                max_iter=6, tol_residual=1e-9, linear_solver="gmres",
                precond="auto", linear_tol=1e-9, gmres_restart=160,
                linear_maxiter=4000, forcing="fixed", precond_lag=False))):
        solver = NewtonSolver(prob, opts)
        if name == "gmres_auto" and solver._precond_kind != "vanka":
            raise RuntimeError(f"overset gmres auto: precond {solver._precond_kind}, "
                               "not the constraint-aware vanka")
        res = solver.solve(x0, prob.base_params())
        if not res.converged:
            raise RuntimeError(f"overset 20x10 {name} did not converge on "
                               f"{device}:\n{res.summary()}")
        out[name] = (res.iters, res.x, overset_drag(prob, res.x, bi),
                     res.linear_iters)
    reset_counts()
    bs = BorderedNewtonSolver(prob, multiplier_dof_mask(prob), NewtonOptions(
        max_iter=8, tol_residual=1e-8), base_solver="ndlu")
    bres = bs.solve(x0, prob.base_params())
    ln, _ = read_counts()
    if not bres.converged:
        raise RuntimeError(f"bordered 20x10 did not converge on {device}")
    out["bordered"] = (bres.iters, bres.x, overset_drag(prob, bres.x, bi), [])
    levels = len(bs._ndlu.levels)
    if device.type == "cuda" and (
            ln["trsv"] != 2 * levels * bs._ndlu.n_solve
            or ln["lu"] != levels * (bres.iters) or ln["gather"] != ln["lu"]):
        raise RuntimeError(f"bordered: launches {ln} != levels {levels} x "
                           f"{bres.iters} factorizations / 2 x levels x "
                           f"{bs._ndlu.n_solve} solves")
    mono = out["direct"][1]
    dmono = float(np.linalg.norm(bres.x - mono) / np.linalg.norm(mono))
    if dmono > 1e-6:
        raise RuntimeError(f"bordered vs monolithic on {device}: {dmono:.2e} > 1e-6")

    direct = NewtonOptions(max_iter=8, tol_residual=1e-11, linear_solver="direct")
    ip, orig, new = interface_strip(device)
    r = NewtonSolver(ip, direct).solve(np.zeros(ip.dofmap.n_dof), ip.base_params())
    T = ip.get_nodal_field(r.x, "temperature")
    out["contact"] = (r.iters, r.x, float(T[orig].mean() - T[new].mean()), [])
    dp = dg_channel(device)
    r = NewtonSolver(dp, direct).solve(np.zeros(dp.dofmap.n_dof), dp.base_params())
    bd = dp.dofmap.blocks[0]
    vals = r.x[bd.gather[:, bd.slot("stress0").start]]
    xc = dp.mesh.coords[dp.mesh.blocks[0].conn].mean(axis=1)[:, 0]
    order = np.argsort(xc)
    out["dg"] = (r.iters, r.x, float(np.polyfit(xc[order], np.log(vals[order]), 1)[0]), [])
    ep = edge_box(device)
    r = NewtonSolver(ep, NewtonOptions(max_iter=5, linear_solver="direct")).solve(
        np.zeros(ep.dofmap.n_dof), ep.base_params())
    F = sideset_integral(ep, "bottom", heat_flux)
    out["edge"] = (r.iters, r.x, float(F(torch.as_tensor(r.x, device=device),
                                         ep.base_params())), [])
    wp, wx = wetting_box(device)
    R = wp.assemble(torch.as_tensor(wx, device=device), wp.base_params())[0].cpu().numpy()
    out["wetting"] = (0, R, [float(-R[dd[dd >= 0]].sum()) for dd in (
        wp.dofmap.dof_of_node_svar[:, wp.dofmap.svar("velocity", c)]
        for c in range(2))], [])
    for name, (it, x, v, lin) in out.items():
        if not np.all(np.isfinite(x)):
            raise RuntimeError(f"{name} on {device}: non-finite values")
    return out, ln


def overset_small_phase():
    """Phase 47: the small decks on cuda and on cpu (the example's own 20x10
    deck on host ``direct``, on ``gmres`` with ``precond="auto"`` (the
    constraint-aware Vanka) and bordered on the ``ndlu`` base against the
    monolithic solve; the two-layer contact resistance; the DG stress decay
    channel; the HEX27 edge line source; the FILL_CA wetting deck): the
    same Newton count on both devices and goma_tpu's (+-1 on GMRES), x
    within OVS_SMALL_X_TOL between the devices, each scalar reading within
    OVS_SMALL_RTOL of goma_tpu's record. Returns the bordered solve's
    launches on the card."""
    t0 = time.perf_counter()
    runs = {"cuda": overset_small_decks(torch.device("cuda", 0)),
            "cpu": cpu_runs("overset", lambda: overset_small_decks(
                torch.device("cpu")))}
    (cu, ln), (cp, _) = runs["cuda"], runs["cpu"]
    ref = OVS_SMALL_REF
    want = {"direct": (ref["direct"]["newton"], ref["direct"]["drag"]),
            "gmres_auto": (ref["gmres_auto"]["newton"], ref["gmres_auto"]["drag"]),
            "bordered": (ref["bordered"]["iters"], ref["bordered"]["drag"]),
            "contact": (ref["contact"]["newton"],
                        ref["contact"]["T_a"] - ref["contact"]["T_b"]),
            "dg": (ref["dg"]["newton"], ref["dg"]["rate"]),
            "edge": (ref["edge"]["newton"], ref["edge"]["flux"]),
            "wetting": (0, ref["wetting"]["force"])}
    for name, (it_ref, v_ref) in want.items():
        (it_c, x_c, v_c, lin_c), (it_p, x_p, v_p, lin_p) = cu[name], cp[name]
        dx = float(np.abs(x_c - x_p).max())
        dv = float(np.max(np.abs(np.subtract(v_c, v_ref)) / np.abs(v_ref)))
        lin = f", linear cuda {lin_c} cpu {lin_p} (goma_tpu " \
              f"{ref[name]['linear']})" if name == "gmres_auto" else ""
        log(f"overset small {name}: Newton cuda {it_c} cpu {it_p} (goma_tpu "
            f"{it_ref}){lin}; max |x_cuda - x_cpu| {dx:.2e}; reading {v_c} "
            f"(goma_tpu {v_ref}, relative {dv:.2e})")
        slack = 1 if name == "gmres_auto" else 0
        if it_c != it_p or abs(it_c - it_ref) > slack:
            raise RuntimeError(f"overset small {name}: Newton cuda {it_c} cpu "
                               f"{it_p} goma_tpu {it_ref}")
        if dx > OVS_SMALL_X_TOL or dv > OVS_SMALL_RTOL:
            raise RuntimeError(f"overset small {name}: x {dx:.2e} between the "
                               f"devices or reading {dv:.2e} from goma_tpu's")
    log(f"phase 47 (overset, interface, edge and wetting small decks, cuda and "
        f"cpu): {time.perf_counter() - t0:.1f} s; bordered launches {ln}")
    return ln


# ---- phases 48-50: the shell and lubrication layer
SHELL_N = 64
# goma_tpu's record of the 64x64 bearing and film on both device rungs and
# of the small shell decks (``python3 scripts/shell_reference.py --part
# bearing|film --n 64`` and ``--part small``, goma_tpu on a CPU, float64
# state and Jacobian, float32 NDLU factors)
SHELL_REF = {'bearing': {'gmres+ndlu': {'T_min': 0.7816109297889136,
                            'T_samples': [1.0, 0.8266035206199066,
                                          0.9305438085281154,
                                          0.7916619747775642,
                                          0.8681823072384448,
                                          0.9864815599290638,
                                          0.8188538873651655,
                                          0.916058334946045,
                                          0.7877858142685049,
                                          0.8562494691297601,
                                          0.9731520005387008,
                                          0.8103919226423764,
                                          0.9044511696963435,
                                          0.7842973233376801,
                                          0.8469177083756496,
                                          0.957642520597749,
                                          0.8040723500603288,
                                          0.8912142694681369,
                                          0.7824404034772758,
                                          0.8364388518024489,
                                          0.9452212687705788,
                                          0.7973653896032957,
                                          0.8806705518477296,
                                          0.7816109297889153],
                            'converged': True,
                            'levels': [[180, 138], [128, 192], [64, 64],
                                       [32, 72], [16, 144], [8, 88], [4, 202],
                                       [2, 188], [1, 258]],
                            'linear': [1, 61, 32, 30, 14],
                            'load': 122.74007863715266,
                            'newton': 5,
                            'p_max': 296.10562458937744},
             'n': 64,
             'n_dof': 33282,
             'nnz': 1052676,
             'tpu_direct': {'T_min': 0.7816109297885315,
                            'T_samples': [1.0, 0.8266035206194926,
                                          0.9305438085278515,
                                          0.7916619747771783,
                                          0.8681823072380639,
                                          0.9864815599289876,
                                          0.8188538873647931,
                                          0.9160583349457301,
                                          0.7877858142681381,
                                          0.8562494691294366,
                                          0.9731520005385061,
                                          0.8103919226420322,
                                          0.9044511696960489,
                                          0.7842973233373174,
                                          0.8469177083753171,
                                          0.957642520597497,
                                          0.8040723500599618,
                                          0.8912142694677939,
                                          0.7824404034769025,
                                          0.836438851802055,
                                          0.9452212687703566,
                                          0.7973653896029003,
                                          0.8806705518473508,
                                          0.7816109297885316],
                            'converged': True,
                            'levels': [[180, 138], [128, 192], [64, 64],
                                       [32, 72], [16, 144], [8, 88], [4, 202],
                                       [2, 188], [1, 258]],
                            'linear': [1, 1, 1, 1],
                            'load': 122.74007864500497,
                            'newton': 4,
                            'p_max': 296.1056246105355}},
 'film': {'dt': 0.00015398973382026504,
          'gmres+ndlu': {'C_samples': [0.20000469247296496,
                                       0.20000529887680246,
                                       0.20000478917864672,
                                       0.20000555350981009,
                                       0.20000504064931243,
                                       0.20000478608493763, 0.2000052872209118,
                                       0.2000049454392992, 0.20000535058360136,
                                       0.20000511977159063,
                                       0.20000503958625923,
                                       0.20000515203288455,
                                       0.20000515269521782,
                                       0.20000504018268978,
                                       0.20000512378303725,
                                       0.20000535299851202,
                                       0.20000495009781286,
                                       0.20000529506626816, 0.200004787141867,
                                       0.20000505029372553,
                                       0.20000556021310859,
                                       0.20000479528873394, 0.200005310916057,
                                       0.2000046924729652],
                         'H_samples': [1.088747331456, 0.9701114917282551,
                                       1.0679883932998808, 0.9273948134113119,
                                       1.017490638945967, 1.068635679602764,
                                       0.9722596199079911, 1.036098925550378,
                                       0.9611667321872366, 1.0026880353692948,
                                       1.017646154370948, 0.9966537472863053,
                                       0.996525821933112, 1.017534614300789,
                                       1.0019414783691445, 0.9607479323539151,
                                       1.0351784122389218, 0.9708796192498584,
                                       1.0684133561456226, 1.0156445894126247,
                                       0.9263173104091532, 1.066702735065031,
                                       0.9680078617802993,
                                       1.0887473314564406],
                         'amplitude': 0.09052563615798337,
                         'converged': [True, True, True, True, True],
                         'exact': 0.09048374180359596,
                         'levels': [[24, 108], [256, 186], [128, 72], [64, 96],
                                    [32, 108], [16, 216], [8, 132], [4, 303],
                                    [2, 282], [1, 387]],
                         'newton': [2, 3, 2, 2, 2],
                         't': 0.0007699486691013252},
          'n': 64,
          'n_dof': 49923,
          'nnz': 2368521,
          'tpu_direct': {'C_samples': [0.2000046924713563, 0.20000529887500038,
                                       0.2000047891769227, 0.20000555350799498,
                                       0.20000504064757693,
                                       0.20000478608326117,
                                       0.20000528721905678,
                                       0.20000494543753686,
                                       0.20000535058178298, 0.2000051197698286,
                                       0.20000503958458193, 0.2000051520310659,
                                       0.20000515269344946, 0.2000050401809565,
                                       0.20000512378133148,
                                       0.20000535299675362,
                                       0.20000495009609745, 0.200005295064463,
                                       0.20000478714024117,
                                       0.20000505029204357,
                                       0.20000556021122762,
                                       0.20000479528705487,
                                       0.20000531091419935,
                                       0.20000469247135635],
                         'H_samples': [1.088747331478117, 0.970111491715187,
                                       1.0679883932784582, 0.9273948134135492,
                                       1.0174906389247809, 1.0686356795825027,
                                       0.9722596198895144, 1.0360989255209374,
                                       0.9611667321701726, 1.0026880353612515,
                                       1.0176461543574835, 0.9966537472695259,
                                       0.996525821915565, 1.0175346142866493,
                                       1.0019414783615894, 0.9607479323371406,
                                       1.0351784122094694, 0.97087961923156,
                                       1.0684133561247158, 1.015644589391755,
                                       0.9263173104125905, 1.066702735042247,
                                       0.9680078617670462,
                                       1.0887473314781153],
                         'amplitude': 0.09052563615458814,
                         'converged': [True, True, True, True, True],
                         'exact': 0.09048374180359596,
                         'levels': [[24, 108], [256, 186], [128, 72], [64, 96],
                                    [32, 108], [16, 216], [8, 132], [4, 303],
                                    [2, 282], [1, 387]],
                         'newton': [2, 2, 2, 1, 1],
                         't': 0.0007699486691013252}},
 'small': {'capillary_leveling': {'newton': 40,
                                  'reading': [0.0008187407262020829]},
           'closed_cell_imbibition': {'newton': 107,
                                      'reading': [0.1409740376965769]},
           'closed_cell_numjac': {'newton': 0,
                                  'reading': [0.010766423283027198,
                                              0.8200068996882612]},
           'end_advective_outflow': {'newton': 1,
                                     'reading': [0.5000000000000016]},
           'end_flux_arc': {'newton': 1, 'reading': [-0.30586738060144597]},
           'end_flux_reynolds': {'newton': 1, 'reading': [-298.6666666666621]},
           'film_evaporation': {'newton': 14,
                                'reading': [0.7, 0.1429732225300093]},
           'flow_developed': {'newton': 0, 'reading': [24999.999999999975]},
           'gamma1_symm_end': {'newton': 1,
                               'reading': [0.17706090419948883,
                                           1.5707438159873894]},
           'gasn_dissolution': {'newton': 126,
                                'reading': [0.14111995817424222,
                                            0.6716798204199335]},
           'hermite_beam': {'newton': 1,
                            'reading': [0.028799999999999954,
                                        0.04799999999999992]},
           'hex_face_shell': {'newton': 1, 'reading': [0.4999999999999999]},
           'laplace_beltrami_cylinder': {'newton': 1,
                                         'reading': [0.001556876034941146]},
           'lub_curvature_circle': {'newton': 2,
                                    'reading': [3.3154835908911817]},
           'lub_film_junction': {'newton': 1,
                                 'reading': [0.3720930232558165,
                                             0.006697674418604652]},
           'open_cell_diffusion': {'newton': 40,
                                   'reading': [0.0007408379047573403]},
           'power_law_squeeze_0.5': {'newton': 4,
                                     'reading': [42.19938163199112]},
           'power_law_squeeze_1': {'newton': 1,
                                   'reading': [75.05627813672284]},
           'reynolds_on_shell': {'newton': 1, 'reading': [4.9999989561933615]},
           'sheet_end_slope': {'newton': 2, 'reading': [0.05003298812526194]},
           'sheet_weak_terms': {'newton': 0,
                                'reading': [0.0024305555555555565,
                                            -1.4000000000000004,
                                            -1.0400000000000003]},
           'shell_bulk_conduction': {'newton': 1,
                                     'reading': [0.16445142389885864,
                                                 0.0022810330152199386]},
           'shell_elastica': {'newton': 4,
                              'reading': [-0.3144302789466909, 1.0]},
           'shell_energy_fin': {'newton': 1, 'reading': [0.5003914666102481]},
           'shell_species_exact': {'newton': 1,
                                   'reading': [0.23471082706634985]},
           'shell_species_source': {'newton': 2,
                                    'reading': [0.24000000000000005]},
           'surf_div_v': {'newton': 1, 'reading': [0.7000000000000003]},
           'surface_charge_decay': {'newton': 100,
                                    'reading': [1.305251921580142]},
           'tangent_traction_lubp': {'newton': 0,
                                     'reading': [-2.000000000000001,
                                                 -1.0400000000000003]},
           'tension_sheet_parabola': {'newton': 3,
                                      'reading': [0.025083537454270548]},
           'tension_sheet_stiffer': {'newton': 2,
                                     'reading': [0.025083537454270548,
                                                 0.006251277179301697]},
           'tensioned_string': {'newton': 1, 'reading': [0.24999999999999822]},
           'tfmp_free_flux': {'newton': 0,
                              'reading': [-8.533333333333334e-05,
                                          -0.000617142857142857]},
           'tfmp_squeeze': {'newton': 178,
                            'reading': [0.8571496284479801,
                                        4.000875517609771]},
           'two_layer_stack': {'newton': 63,
                               'reading': [0.4999999999999013,
                                           0.5000000000000981]},
           'velo_normal_lub': {'newton': 1,
                               'reading': [0.007499999945102146]}}}
# T (bearing), H and C (film) at the record's sampled dofs against
# goma_tpu's, absolute
SHELL_X_TOL = 1e-6
# the bearing's load (mean pad pressure) and p_max against goma_tpu's,
# relative
SHELL_P_RTOL = 1e-6
# the film amplitude against its exact leveling decay 0.1 exp(-lambda t)
# (tests/test_shell_film.py's gate)
SHELL_AMP_RTOL = 0.05
# the small decks' readings against goma_tpu's, relative: float64 on both
# sides, the same operations
SHELL_SMALL_RTOL = 1e-8


def shell_namespace(device):
    """scripts/shell_decks.py's package namespace for the port on
    ``device`` (the decks are written once for both packages)."""
    import goma_tpu_torch.bc.sheet as sheet
    import goma_tpu_torch.bc.shell_end as shell_end
    import goma_tpu_torch.fem as fem
    import goma_tpu_torch.fem.equations as equations
    import goma_tpu_torch.fem.fields as fields
    import goma_tpu_torch.mesh as mesh
    import goma_tpu_torch.physics as physics
    import goma_tpu_torch.solvers as solvers
    import goma_tpu_torch.solvers.transient as transient
    from scripts import shell_decks

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    return shell_decks.namespace(mesh, fem, physics, equations, fields,
                                 shell_end, sheet, solvers, transient, torch,
                                 arr, device=device)


def shell_setup(deck, dev, ref):
    """The 64x64 bearing or film deck on the card, checked against
    goma_tpu's dof and nnz counts. Returns (problem, x0)."""
    from scripts import shell_decks

    t0 = time.perf_counter()
    P = shell_namespace(dev)
    if deck == "bearing":
        prob, bi = shell_decks.bearing(P, SHELL_N)
        x0 = np.zeros(prob.dofmap.n_dof)
    else:
        prob, bi, x0 = shell_decks.film(P, SHELL_N)
    blk = prob.mesh.blocks[bi]
    log(f"{deck} setup: {SHELL_N}x{SHELL_N} HEX27 bulk with no equation, "
        f"{blk.n_elem} {blk.elem_type} shell elements, "
        f"{np.unique(blk.conn).size} shell nodes, {prob.dofmap.n_dof} dof "
        f"(goma_tpu {ref['n_dof']}), {prob.pattern.nnz} nnz (goma_tpu "
        f"{ref['nnz']}); {time.perf_counter() - t0:.2f} s")
    if (prob.dofmap.n_dof, prob.pattern.nnz) != (ref["n_dof"], ref["nnz"]):
        raise RuntimeError(f"{deck} deck: dof or nnz count differs from "
                           "goma_tpu's")
    return prob, x0


def shell_kernels_after(nd, seen, tree, label, direct, prob,
                        keys=("first", "last")):
    """Each kernel against its plain version on the fronts of a run's
    factorizations ``keys`` (the values ``record_factor_vals`` kept), the
    substitutions of a solve with the last factor on ``tpu_direct``."""
    if "first" in keys and seen["first"] is seen["last"]:
        keys = ("first",)  # one factorization
    for key in keys:
        tree["max_abs"] = max(tree["max_abs"], check_real_fronts(
            nd, seen[key], f"{label} {key} factorization"))
        tree["gather_abs"] = max(tree["gather_abs"], check_gathers(
            nd, seen[key], f"{label} {key} factorization"))
    if direct:
        calls = []
        rhs = torch.as_tensor(np.random.default_rng(48).standard_normal(
            prob.dofmap.n_dof), dtype=prob.dtype, device="cuda")
        nd.solve(nd.factor(seen["last"]), rhs, trace=calls)
        last = check_substitutions(calls, f"{label} last factorization",
                                   timed=False)
        tree["trsv"]["max_abs"] = max(tree["trsv"]["max_abs"], last["max_abs"])


def shell_tree(prob, solver, label, direct, vals=None, at="x=0"):
    """The kernels on the deck's tree at x = 0 or on the CSR values
    ``vals`` (phases 30-31's ``gmres_tree_phase`` / ``direct_tree_phase``).
    Returns (NDLU, the numbers the summary reads)."""
    if direct:
        tree = direct_tree_phase(prob, solver, label, vals, at)
        return tree.pop("nd"), tree
    tree = gmres_tree_phase(prob, solver, label, vals, at)
    del tree["vals"]
    return solver.precond, tree


def bearing_phase(dev, kind, prob=None):
    """Phase 48: the 64x64 thermal slider bearing (Reynolds lubrication and
    shell energy on a QUAD9 surface shell, 33,282 dof) under
    bench._cavity_opts(kind, tol=1e-9, max_iter=12) restated, float64
    Jacobian, on ``gmres+ndlu`` and then ``tpu_direct``: the ND tree against
    goma_tpu's before any solve; the kernels on its real fronts at x = 0;
    one warm-up solve, ``reset_lagged()``, one timed solve (counts set to 0
    just before and read just after); goma_tpu's Newton +-1, the load and
    p_max within SHELL_P_RTOL, T at 24 dofs within SHELL_X_TOL; launches =
    levels x factorizations (and 2 x levels x solves); each kernel on the
    fronts of the timed run's first and last factorization."""
    from goma_tpu_torch.solvers import NewtonSolver
    from scripts import shell_decks

    label = f"bearing {kind}"
    t_phase = time.perf_counter()
    ref = SHELL_REF["bearing"][kind]
    if prob is None:
        prob, _ = shell_setup("bearing", dev, SHELL_REF["bearing"])
    direct = kind == "tpu_direct"
    solver = NewtonSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=12))
    nd, tree = shell_tree(prob, solver, label, direct)
    check_ref_levels(nd, ref, label)
    seen = record_factor_vals(nd)
    res, sec, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof),
                                   prob.base_params(), label)
    check_launches(solver, ln, len(nd.levels), label, direct=direct)
    if not res.converged or res.res_norms[-1][1] > 1e-9:
        raise RuntimeError(f"{label} did not converge to 1e-9")
    if abs(res.iters - ref["newton"]) > 1:
        raise RuntimeError(f"{label} took {res.iters} Newton iterations, not "
                           f"goma_tpu's {ref['newton']} +- 1")
    rd = shell_decks.bearing_readings(prob, res.x)
    dT = float(np.abs(np.subtract(rd["T_samples"], ref["T_samples"])).max())
    dp = {k: abs(rd[k] - ref[k]) / abs(ref[k]) for k in ("load", "p_max")}
    log(f"{label}: Newton {res.iters} (goma_tpu {ref['newton']}), linear "
        f"{res.linear_iters} (goma_tpu {ref['linear']}); load {rd['load']:.9f} "
        f"(goma_tpu {ref['load']:.9f}, relative {dp['load']:.2e}), p_max "
        f"{rd['p_max']:.7f} (goma_tpu {ref['p_max']:.7f}, {dp['p_max']:.2e}), "
        f"T_min {rd['T_min']:.6f}; T at {len(rd['T_samples'])} dofs max "
        f"|dT| {dT:.2e}")
    if max(dp.values()) > SHELL_P_RTOL or dT > SHELL_X_TOL:
        raise RuntimeError(f"{label}: load/p_max {dp} or T {dT:.2e} off "
                           "goma_tpu's")
    del nd.factor  # record_factor_vals's wrapper
    shell_kernels_after(nd, seen, tree, label, direct, prob)
    log(f"phase 48 ({label}): {sec / max(res.iters, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"prob": prob, "launches": ln, **tree}


def film_phase(dev, kind, prob=None, x0=None):
    """Phase 49: the 64x64 drying particle-laden film (film pressure,
    height and particles on a QUAD9 surface shell, 49,923 dof) under the
    same options, five Crank-Nicolson steps of dt = 0.02/lambda from the
    leveling mode's initial state, on ``gmres+ndlu`` and then
    ``tpu_direct``: one warm-up run (it builds the ``tpu_direct`` NDLU from
    its first values, as the rung does), the tree against goma_tpu's,
    ``reset_lagged()``, one timed run (counts set to 0 just before and
    read just after); every step converged with goma_tpu's Newton +-1, the
    amplitude within SHELL_AMP_RTOL of 0.1 exp(-lambda t), H and C at 24
    dofs within SHELL_X_TOL; the launch identities; the kernels (as phase
    48 holds them at x = 0) on the timed run's first factorization, and on
    its last."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather
    from goma_tpu_torch.solvers.transient import TransientSolver
    from scripts import shell_decks

    label = f"film {kind}"
    t_phase = time.perf_counter()
    ref = SHELL_REF["film"][kind]
    if prob is None:
        prob, x0 = shell_setup("film", dev, SHELL_REF["film"])
    direct = kind == "tpu_direct"
    ts = TransientSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=12), shell_decks.film_time_options(
            shell_namespace(dev)))
    sv = ts.newton
    params = prob.base_params()
    t0 = time.perf_counter()
    rw = ts.run(x0, params)
    torch.cuda.synchronize()
    log(f"{label} warm-up: {time.perf_counter() - t0:.2f} s, Newton "
        f"{[s.newton_iters for s in rw.steps]}")
    nd = sv._ndlu if direct else sv.precond
    check_ref_levels(nd, ref, label)
    seen = record_factor_vals(nd)
    sv.reset_lagged()
    sv.n_factor = sv._ndlu_nfactor = sv.n_discarded = 0
    if sv._ndlu is not None:
        sv._ndlu.n_solve = 0
    per_step = []
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ts.run(x0, params, callback=lambda t, x, xdot, res: per_step.append(res))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
          "gather": front_gather.launches}
    check_launches(sv, ln, len(nd.levels), label, direct=direct)
    nit = sum(s.newton_iters for s in r.steps)
    asm = sum(q.assembly_time for q in per_step)
    slv = sum(q.solve_time for q in per_step)
    for s, q in zip(r.steps, per_step):
        log(f"{label} step t={s.t:.6f}: Newton {s.newton_iters}, linear "
            f"{q.linear_iters}")
    newton = [s.newton_iters for s in r.steps]
    rd = shell_decks.film_readings(prob, r.x, r.t)
    dH = float(np.abs(np.subtract(rd["H_samples"], ref["H_samples"])).max())
    dC = float(np.abs(np.subtract(rd["C_samples"], ref["C_samples"])).max())
    amp = rd["amplitude"] / rd["exact"] - 1
    log(f"{label}: {len(r.steps)} steps to t = {r.t:.6g}, Newton {newton} "
        f"(goma_tpu {ref['newton']}), factorizations "
        f"{sv.n_factor + sv._ndlu_nfactor}, launches front-LU {ln['lu']} "
        f"front-gather {ln['gather']} substitution {ln['trsv']}; amplitude "
        f"{rd['amplitude']:.7f} (exact decay {rd['exact']:.7f}, {amp:+.2e}; "
        f"goma_tpu {ref['amplitude']:.7f}); H, C at 24 dofs max |d| "
        f"{dH:.2e}, {dC:.2e}; asm {asm / max(nit, 1) * 1e3:.1f} ms + slv "
        f"{slv / max(nit, 1) * 1e3:.1f} ms per iteration, "
        f"{sec / max(nit, 1):.4f} s/iter (total {sec:.3f} s)")
    if (len(r.steps) != shell_decks.FILM_STEPS or r.n_failures
            or not all(s.converged for s in r.steps)):
        raise RuntimeError(f"{label}: not {shell_decks.FILM_STEPS} converged "
                           f"steps: {r.steps}")
    if any(abs(a - b) > 1 for a, b in zip(newton, ref["newton"])):
        raise RuntimeError(f"{label}: Newton per step {newton} not within 1 "
                           f"of goma_tpu's {ref['newton']}")
    if abs(amp) > SHELL_AMP_RTOL or max(dH, dC) > SHELL_X_TOL:
        raise RuntimeError(f"{label}: amplitude {amp:+.2e} or H/C {dH:.2e}/"
                           f"{dC:.2e} off")
    del nd.factor  # record_factor_vals's wrapper
    _, tree = shell_tree(prob, sv, label, direct, seen["first"],
                         "first factorization")
    shell_kernels_after(nd, seen, tree, label, direct, prob, keys=("last",))
    log(f"phase 49 ({label}): {sec / max(nit, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"prob": prob, "x0": x0, "launches": ln, **tree}


def shell_small_phase():
    """Phase 50: goma_tpu's shell tests' decks (``scripts/shell_decks.py``
    ``SMALL``: tests/test_shell.py, test_shell3d.py, test_shell_end.py,
    test_shell_film.py, test_shell_porous.py, test_shell_breadth2.py,
    test_sheet_bc.py, test_lub_film_junction.py and two of
    test_shell_rheo.py) at their own sizes and on their own solvers, on the
    card: each deck's own exact-solution gate, goma_tpu's Newton count
    (within 1, and within 2% summed over a transient's steps) and its
    readings within SHELL_SMALL_RTOL (``SHELL_REF["small"]``). The CPU
    copies of these decks are the port's tests'."""
    from scripts import shell_decks

    t0 = time.perf_counter()
    P = shell_namespace(torch.device("cuda", 0))
    for name, deck in shell_decks.SMALL.items():
        t = time.perf_counter()
        out = deck(P)
        ref = SHELL_REF["small"][name]
        dv = float(np.max(np.abs(np.subtract(out["reading"], ref["reading"]))
                          / np.abs(ref["reading"])))
        log(f"shell small {name}: Newton {out['newton']} (goma_tpu "
            f"{ref['newton']}), reading {out['reading']} (relative "
            f"{dv:.2e}), {time.perf_counter() - t:.2f} s")
        if abs(out["newton"] - ref["newton"]) > max(1, 0.02 * ref["newton"]):
            raise RuntimeError(f"shell small {name}: Newton {out['newton']} "
                               f"vs goma_tpu's {ref['newton']}")
        if dv > SHELL_SMALL_RTOL:
            raise RuntimeError(f"shell small {name}: reading {dv:.2e} from "
                               "goma_tpu's")
    log(f"phase 50 (small shell decks on the card): "
        f"{time.perf_counter() - t0:.1f} s")


# ---- phases 51-53: Nedelec edge elements, EM, acoustics, electrochemistry
EM_CAVITY_N = 128
EM_WG_NX, EM_WG_NY = 160, 32
# goma_tpu's record of the 128x128 edge cavity and the 160x32 waveguide on
# both device rungs and on the float64 host ``direct`` rung, and of the
# small decks (``python3 scripts/em_reference.py --part cavity --n 128``,
# ``--part waveguide --nx 160 --ny 32`` and ``--part small``; goma_tpu on
# a CPU, float64 state and Jacobian, float32 NDLU factors)
EM_REF = {'cavity': {'direct': {'newton': 1,
                       'x_max': 0.0005507152062018655,
                       'x_norm': 0.02513919160768973,
                       'x_samples': [0.0, -0.00012017812950437809,
                                     0.00011235312636653822,
                                     1.869573318355672e-05,
                                     0.00010050376683980403,
                                     6.790739633817658e-05,
                                     -3.733675398653025e-05,
                                     0.00024679134628568226,
                                     -5.659277697191971e-05,
                                     7.063270352158186e-05,
                                     9.626817241133755e-05,
                                     -5.714379533623537e-06,
                                     -4.0793102396875254e-05,
                                     -0.00010256511856344955,
                                     -7.099419089537304e-05,
                                     5.5327907863611315e-05,
                                     -0.00011623856864279567,
                                     3.9019764987520745e-05,
                                     -7.310170677948068e-05,
                                     -0.00011534427701584864,
                                     -2.4364156554346227e-05,
                                     -6.144397870666029e-05,
                                     0.00011809375276138005, 0.0]},
            'gmres+ndlu': {'converged': True,
                           'dx_direct': 2.0923989471797076e-08,
                           'levels': [[378, 158], [256, 192], [128, 42],
                                      [64, 60], [32, 86], [16, 116], [8, 142],
                                      [4, 168], [2, 224], [1, 406]],
                           'linear': [1, 1, 1],
                           'newton': 3,
                           'x_max': 0.0005507152075737787,
                           'x_norm': 0.02513919152276564,
                           'x_samples': [2.4135695612242936e-16,
                                         -0.00012017814102753726,
                                         0.00011235312533725529,
                                         1.8695732157399425e-05,
                                         0.00010050376547872549,
                                         6.79073968785396e-05,
                                         -3.733675345595844e-05,
                                         0.0002467913438056963,
                                         -5.6592776939674444e-05,
                                         7.063270295193518e-05,
                                         9.62681734489582e-05,
                                         -5.714378261694358e-06,
                                         -4.0793102087392265e-05,
                                         -0.0001025651182828059,
                                         -7.099419067924532e-05,
                                         5.532790864551318e-05,
                                         -0.00011623856463163895,
                                         3.901976641505824e-05,
                                         -7.310170690604332e-05,
                                         -0.00011534427752091308,
                                         -2.4364157123653073e-05,
                                         -6.144397695969161e-05,
                                         0.00011809375354138007, 0.0]},
            'n': 128,
            'n_dof': 66048,
            'nnz': 918528,
            'tpu_direct': {'converged': True,
                           'dx_direct': 6.063867179974998e-09,
                           'levels': [[378, 158], [256, 192], [128, 42],
                                      [64, 60], [32, 86], [16, 116], [8, 142],
                                      [4, 168], [2, 224], [1, 406]],
                           'linear': [1],
                           'newton': 1,
                           'x_max': 0.0005507152054361913,
                           'x_norm': 0.0251391917048455,
                           'x_samples': [2.406386721831577e-16,
                                         -0.00012017813060741793,
                                         0.00011235312708150636,
                                         1.8695732630994825e-05,
                                         0.00010050376636033813,
                                         6.790739647002676e-05,
                                         -3.733675193040423e-05,
                                         0.00024679134847329005,
                                         -5.659277765737853e-05,
                                         7.0632703861678e-05,
                                         9.626817207109588e-05,
                                         -5.714379244743372e-06,
                                         -4.079310268785549e-05,
                                         -0.00010256511752816413,
                                         -7.099419073600612e-05,
                                         5.532790791687694e-05,
                                         -0.00011623857198225954,
                                         3.9019764256214934e-05,
                                         -7.310170727883532e-05,
                                         -0.0001153442759786172,
                                         -2.4364155943578904e-05,
                                         -6.144397985172458e-05,
                                         0.00011809375271114067, 0.0]}},
 'small': {'acoustic_piston': {'newton': 1,
                               'reading': [1.2090420901340881e-05]},
           'acoustic_plane_wave': {'newton': 1,
                                   'reading': [8.45654954687546e-05]},
           'alloy_evaporation': {'newton': 2, 'reading': [0.666324282164713]},
           'binary_stefan_maxwell': {'newton': 1, 'reading': [0.4]},
           'bond_equilibrium': {'newton': 2, 'reading': [0.27384877586729656]},
           'bond_viscosity': {'newton': 0,
                              'reading': [1.0, 11.25205166766762,
                                          6.12602583383381]},
           'butler_volmer_electrode': {'newton': 7,
                                       'reading': [0.18171365245194773]},
           'charged_surface_gradient': {'newton': 1,
                                        'reading': [0.00999998418247099]},
           'current_bv_rowsum': {'newton': 0, 'reading': [-90.78405549233068]},
           'current_sic': {'newton': 1, 'reading': [1.6000002666664788]},
           'edge_constant_patch': {'newton': 1,
                                   'reading': [0.8514693182963211]},
           'edge_hex': {'newton': 1,
                        'reading': [0.04959743495338282,
                                    0.012227242778843475]},
           'edge_te_mode': {'newton': 1,
                            'reading': [0.0006800081382200492,
                                        0.00017108581425828205]},
           'edge_te_mode_tri': {'newton': 1,
                                'reading': [0.0002151415393297466,
                                            5.465700047576579e-05]},
           'electrodeposition_velocity': {'newton': 0,
                                          'reading': [0.004179764038197392]},
           'electromigration_boltzmann': {'newton': 2,
                                          'reading': [0.22313039579631244]},
           'em_h_farfield_rowsum': {'newton': 0,
                                    'reading': [-1.3063945294843615]},
           'em_h_lossy_decay': {'newton': 1,
                                'reading': [0.015125859269611382]},
           'em_h_plane_wave': {'newton': 1,
                               'reading': [0.00018211080011748537,
                                           0.0002058534386202729]},
           'em_lossy_decay': {'newton': 1, 'reading': [0.015181662923005832]},
           'em_plane_wave': {'newton': 1,
                             'reading': [0.00018211080011329428,
                                         0.00020585343861537734]},
           'generalized_fickian': {'newton': 1,
                                   'reading': [3.643487340447336]},
           'hor_flux_potential': {'newton': 2,
                                  'reading': [0.9998991613056033]},
           'hor_orr_kinetics': {'newton': 1, 'reading': [0.9999998942796056]},
           'koh_etch': {'newton': 0,
                        'reading': [1.2606411007852091e-06,
                                    1.1901554592631833e-06,
                                    -1.410636516474286e-07,
                                    -3.292391397086763e-06]},
           'light_beer_lambert': {'newton': 1,
                                  'reading': [0.6694440242676689]},
           'light_fresnel_two_layer': {'newton': 1,
                                       'reading': [0.2947682758581274]},
           'ls_acoustic_radiation': {'newton': 0,
                                     'reading': [0.2662773961177306]},
           'ni_current_total': {'newton': 0,
                                'reading': [-0.021168796390986858]},
           'ni_deposition_balance': {'newton': 1,
                                     'reading': [0.024956396223080317,
                                                 0.03747819811154009]},
           'numjac_em_edge': {'newton': 0, 'reading': [576.0, 792.0, 648.0]},
           'pem_water': {'newton': 0,
                         'reading': [2.3273892584213043e-05,
                                     4.498345438806935e-10]},
           'phillips_migration': {'newton': 124,
                                  'reading': [0.00011424302476638274, 118.0]},
           'projection_shear_rate': {'newton': 2,
                                     'reading': [1.9999999999999998]},
           'residence_time': {'newton': 1, 'reading': [1.0000000000000004]},
           'shear_rate_couette': {'newton': 2,
                                  'reading': [0.8000000000000002]},
           'species_flux_numjac': {'newton': 0, 'reading': [936.0, 384.0]},
           'surface_charge': {'newton': 1, 'reading': [0.4000000000000001]},
           'surface_electric_field': {'newton': 1,
                                      'reading': [1.4999999999079272]},
           'suspension_flux_crafted': {'newton': 0,
                                       'reading': [-0.10036799999999999]},
           'ternary_sm_relations': {'newton': 0,
                                    'reading': [-0.19722222222222227,
                                                0.3277777777777779]}},
 'waveguide': {'direct': {'newton': 1,
                          'x_max': 1.0,
                          'x_norm': 114.86659035589743,
                          'x_samples': [0.0, 4.227805946155721e-17,
                                        -0.23976170875753658,
                                        0.7550312692354741,
                                        -1.0616799515260267e-15,
                                        -0.936786785582904, 0.3125579657566515,
                                        4.452165658716132e-16,
                                        0.15456034696532245,
                                        0.5380328220171288,
                                        -1.4074407899193148e-15,
                                        -0.8368264328314831,
                                        0.5585862473482642,
                                        4.876396406046794e-16,
                                        0.5198884742599182,
                                        0.14903961696332893,
                                        -9.908465559343442e-16,
                                        -0.4792130459762734,
                                        0.6463312867749185,
                                        5.921136224357705e-16,
                                        0.7447478552614998,
                                        -0.3022940195927914,
                                        4.7019235016640756e-18,
                                        -0.013632482170714012]},
               'gmres+ndlu': {'converged': True,
                              'dx_direct': 2.113712516127464e-08,
                              'levels': [[442, 192], [256, 192], [128, 100],
                                         [64, 136], [32, 140], [16, 324],
                                         [8, 236], [4, 408], [2, 260],
                                         [1, 260]],
                              'linear': [1, 1],
                              'newton': 2,
                              'x_max': 1.0,
                              'x_norm': 114.86659163937352,
                              'x_samples': [0.0, 8.779648274290634e-17,
                                            -0.2397617157798962,
                                            0.7550312768430238,
                                            4.634889816786208e-16,
                                            -0.9367867880650421,
                                            0.3125579782687926,
                                            4.1965647356683413e-17,
                                            0.15456034581117659,
                                            0.5380328286780014,
                                            9.50395033188941e-16,
                                            -0.8368264349204535,
                                            0.5585862674541909,
                                            -8.033809142962431e-17,
                                            0.519888478112753,
                                            0.14903962145360614,
                                            7.662223335565794e-16,
                                            -0.47921304713027235,
                                            0.6463313079120436,
                                            -5.055117275457783e-17,
                                            0.744747862302225,
                                            -0.30229401737207173,
                                            8.178353272484523e-17,
                                            -0.013632482425676879]},
               'n_dof': 83460,
               'nnz': 5267472,
               'nx': 160,
               'ny': 32,
               'tpu_direct': {'converged': True,
                              'dx_direct': 2.5663515756946254e-10,
                              'levels': [[442, 192], [256, 192], [128, 100],
                                         [64, 136], [32, 140], [16, 324],
                                         [8, 236], [4, 408], [2, 260],
                                         [1, 260]],
                              'linear': [1],
                              'newton': 1,
                              'x_max': 1.0,
                              'x_norm': 114.86659037052463,
                              'x_samples': [0.0, 6.815299612798009e-17,
                                            -0.23976170867222477,
                                            0.7550312692701302,
                                            -1.0541497781044038e-15,
                                            -0.9367867856284374,
                                            0.31255796597271973,
                                            4.537013042273419e-16,
                                            0.15456034704874166,
                                            0.538032822022244,
                                            -1.3956595185854688e-15,
                                            -0.8368264328712006,
                                            0.5585862476048994,
                                            4.939202320377589e-16,
                                            0.519888474363699,
                                            0.14903961693453227,
                                            -9.73569899253276e-16,
                                            -0.47921304601258113,
                                            0.6463312870002962,
                                            6.1417823545303875e-16,
                                            0.7447478553376613,
                                            -0.3022940196704705,
                                            -1.020122570961697e-16,
                                            -0.013632481995890323]}}}
# x at the record's sampled dofs against goma_tpu's rung and against its
# float64 direct solution, max |dx| / max |x_direct|: both rungs stop at
# ||R|| <= 1e-9 after float32-factored steps, and their x carries that
# factor's rounding: goma_tpu's own two rungs read 1.9e-8 (cavity) and
# 2.1e-8 (waveguide) apart at full size, the port's CPU run against
# goma_tpu's 2.3e-7 on the 64x64 cavity's gmres+ndlu rung
EM_X_RTOL = 1e-6
# the small decks' readings against goma_tpu's, relative: float64 on both
# sides, the same operations (readings within 2.7e-10 on the CPU; the
# plane-wave and TE-mode readings are errors against exact fields)
EM_SMALL_RTOL = 1e-8


def em_namespace(device):
    """scripts/em_decks.py's namespace for the port on ``device``."""
    from scripts import em_decks

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    return em_decks.namespace("goma_tpu_torch", torch, arr, device=device)


def em_setup(deck, dev):
    """The 128x128 edge cavity or the 160x32 waveguide on the card, checked
    against goma_tpu's dof and nnz counts."""
    from scripts import em_decks

    t0 = time.perf_counter()
    P = em_namespace(dev)
    ref = EM_REF[deck]
    if deck == "cavity":
        prob = em_decks.edge_cavity(P, EM_CAVITY_N)
        what = (f"{EM_CAVITY_N}x{EM_CAVITY_N} QUAD9, EMWaveEdge real + imag "
                "(N1 edge dofs on the midside nodes)")
    else:
        prob = em_decks.waveguide(P, EM_WG_NX, EM_WG_NY)
        what = (f"{EM_WG_NX}x{EM_WG_NY} QUAD9, EMWave real + imag (Q2) with "
                "EMAbsorbingBC on the right")
    signed = prob.dofmap.blocks[0].edge_signs is not None
    log(f"em {deck} setup: {what}, {prob.dofmap.n_dof} dof (goma_tpu "
        f"{ref['n_dof']}), {prob.pattern.nnz} nnz (goma_tpu {ref['nnz']}), "
        f"edge signs {'yes' if signed else 'none (consistently oriented)'}; "
        f"{time.perf_counter() - t0:.2f} s")
    if (prob.dofmap.n_dof, prob.pattern.nnz) != (ref["n_dof"], ref["nnz"]):
        raise RuntimeError(f"em {deck} deck: dof or nnz count differs from "
                           "goma_tpu's")
    return prob


def em_phase(dev, deck, kind, prob=None):
    """Phases 51 (the 128x128 lossy edge-element cavity) and 52 (the
    160x32 lossy nodal waveguide), each on ``gmres+ndlu`` and then
    ``tpu_direct`` under bench._cavity_opts(kind, tol=1e-9, max_iter=8)
    restated, float64 Jacobian: the ND tree against goma_tpu's before any
    solve; the kernels on its real fronts at x = 0 (boosted pivots
    counted: both decks are indefinite); one warm-up solve,
    ``reset_lagged()``, one timed solve (counts set to 0 just before and
    read just after); goma_tpu's Newton count (exactly on ``tpu_direct``,
    +-1 on ``gmres+ndlu``), x at 24 dofs within EM_X_RTOL of goma_tpu's
    rung and of its float64 solution; the launch identities; each kernel
    on the fronts of the timed run's first and last factorization."""
    from goma_tpu_torch.solvers import NewtonSolver
    from scripts import em_decks

    label = f"em {deck} {kind}"
    t_phase = time.perf_counter()
    ref = EM_REF[deck][kind]
    if prob is None:
        prob = em_setup(deck, dev)
    direct = kind == "tpu_direct"
    solver = NewtonSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=8))
    nd, tree = shell_tree(prob, solver, label, direct)
    check_ref_levels(nd, ref, label)
    seen = record_factor_vals(nd)
    res, sec, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof),
                                   prob.base_params(), label)
    check_launches(solver, ln, len(nd.levels), label, direct=direct)
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: the solution has the wrong shape or "
                           "non-finite values")
    if not res.converged or res.res_norms[-1][1] > 1e-9:
        raise RuntimeError(f"{label} did not converge to 1e-9")
    rd = em_decks.readings(x)
    xd = EM_REF[deck]["direct"]
    dx_ref = float(np.abs(np.subtract(rd["x_samples"], ref["x_samples"])).max()
                   / xd["x_max"])
    dx_f64 = float(np.abs(np.subtract(rd["x_samples"], xd["x_samples"])).max()
                   / xd["x_max"])
    dn = abs(rd["x_norm"] - ref["x_norm"]) / ref["x_norm"]
    log(f"{label}: Newton {res.iters} (goma_tpu {ref['newton']}), linear "
        f"{res.linear_iters} (goma_tpu {ref['linear']}); ||x|| "
        f"{rd['x_norm']:.10g} (goma_tpu {ref['x_norm']:.10g}, relative "
        f"{dn:.2e}), max |x| {rd['x_max']:.6e}; x at 24 dofs max |dx| / max "
        f"|x| {dx_ref:.2e} from goma_tpu's rung (within 1e-8: "
        f"{'yes' if dx_ref <= 1e-8 else 'no'}), {dx_f64:.2e} from its float64 "
        f"solution (goma_tpu's rung {ref['dx_direct']:.2e})")
    newton_ok = (res.iters == ref["newton"] if direct
                 else abs(res.iters - ref["newton"]) <= 1)
    if not newton_ok:
        raise RuntimeError(f"{label} took {res.iters} Newton iterations, not "
                           f"goma_tpu's {ref['newton']}"
                           + ("" if direct else " +- 1"))
    if max(dx_ref, dx_f64) > EM_X_RTOL:
        raise RuntimeError(f"{label}: x {dx_ref:.2e} from goma_tpu's / "
                           f"{dx_f64:.2e} from its float64 solution > "
                           f"{EM_X_RTOL:.0e}")
    del nd.factor  # record_factor_vals's wrapper
    shell_kernels_after(nd, seen, tree, label, direct, prob)
    boosted = {k[len(label) + 1:]: v for k, v in BOOSTED.items()
               if k.startswith(label + " ")}
    log(f"{label}: boosted pivots per level of the real fronts {boosted}")
    phase = 51 if deck == "cavity" else 52
    log(f"phase {phase} ({label}): {sec / max(res.iters, 1):.4f} s/iter, "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"prob": prob, "launches": ln, **tree}


def em_small_phase():
    """Phase 53: goma_tpu's tests' decks of the slice (``em_decks.SMALL``:
    tests/test_em.py, test_em_edge.py, test_acoustic_bc.py,
    test_electrode_ni.py, test_species_flux.py, test_solved_aux_fields.py,
    test_bc_catalog3.py's residence-time and light decks and
    test_shell_rheo.py's shear-rate projection and surface electric field)
    at their own sizes and on their own solvers, on the card: each deck's
    own gate, goma_tpu's Newton count (within 1, and within 2% summed over
    the transient deck's steps) and its readings within EM_SMALL_RTOL. The
    CPU copies of these decks are the port's tests'."""
    from scripts import em_decks

    t0 = time.perf_counter()
    P = em_namespace(torch.device("cuda", 0))
    for name, deck in em_decks.SMALL.items():
        t = time.perf_counter()
        out = deck(P)
        ref = EM_REF["small"][name]
        dv = float(np.max(np.abs(np.subtract(out["reading"], ref["reading"]))
                          / np.abs(ref["reading"])))
        log(f"em small {name}: Newton {out['newton']} (goma_tpu "
            f"{ref['newton']}), reading {out['reading']} (relative "
            f"{dv:.2e}), {time.perf_counter() - t:.2f} s")
        if abs(out["newton"] - ref["newton"]) > max(1, 0.02 * ref["newton"]):
            raise RuntimeError(f"em small {name}: Newton {out['newton']} vs "
                               f"goma_tpu's {ref['newton']}")
        if not dv <= EM_SMALL_RTOL:
            raise RuntimeError(f"em small {name}: reading {dv:.2e} from "
                               "goma_tpu's")
    log(f"phase 53 (small EM, acoustic, electrochemical and transport decks "
        f"on the card): {time.perf_counter() - t0:.1f} s")



# ---- phases 54-56: solid mechanics and porous media
FSI_NX, FSI_NY = 128, 64
RICH_N = 128
FSI_P0 = {"linear": 0.2, "nonlinear": 2.0}
# goma_tpu's record of the 128x64 FSI column (run (a) on tpu_direct, run
# (b) on both device rungs and on the float64 host direct rung), of the
# 128x128 Richards slab on both rungs and of the small decks
# (``python3 scripts/solid_reference.py --part fsi --nx 128 --ny 64``,
# ``GOMA_BENCH_BUDGET_S=100000 ... --part richards --n 128`` and ``--part
# small``; goma_tpu on a CPU, float64 state and Jacobian, float32 NDLU
# factors)
SOLID_REF = {'fsi': {'linear': {'tpu_direct': {'exact_err': 8.472046397756117e-10,
                                   'levels': [[346, 171], [256, 192],
                                              [128, 76], [64, 102], [32, 151],
                                              [16, 186], [8, 224], [4, 232],
                                              [2, 597], [1, 348]],
                                   'linear': [1],
                                   'newton': 1,
                                   'x_max': 0.20000001250681648,
                                   'x_norm': 13.013700267877713,
                                   'x_samples': [0.0, 0.006624999262164813,
                                                 3.586689221976906e-15,
                                                 0.003812499461014706,
                                                 -1.1040004385694801e-13,
                                                 7.512757704871498e-15,
                                                 -1.8149078416870679e-12,
                                                 8.612670522297762e-15,
                                                 0.002874999564930794,
                                                 -1.3086925774761838e-13,
                                                 7.943817573183812e-15,
                                                 0.004687499350601976,
                                                 6.55505887490599e-14,
                                                 2.877691441855707e-12,
                                                 4.30025517065789e-15,
                                                 0.19999999999983975,
                                                 0.0037499994427075997,
                                                 -1.815214667220021e-14,
                                                 0.0009374998470159099,
                                                 -1.1219317241516755e-11,
                                                 0.1999999999997886,
                                                 1.1883437744032404e-12,
                                                 2.0583740870900262e-15,
                                                 0.0]}},
         'n_dof': 70789,
         'nnz': 2562463,
         'nonlinear': {'direct': {'newton': 4,
                                  'x_max': 2.000000000000023,
                                  'x_norm': 130.1827984557997,
                                  'x_samples': [0.0, 0.07653247975422267,
                                                7.432002755383119e-18,
                                                0.044042276084977225,
                                                6.895052735956519e-17,
                                                5.934136954317094e-17,
                                                1.9977803133670042e-17,
                                                -1.410546818399785e-16,
                                                0.033212208195228736,
                                                1.0524086597168907e-16,
                                                2.3949359136604777e-16,
                                                0.05415033944874252,
                                                -1.6214183926750555e-16,
                                                -5.410065167024401e-17,
                                                -2.2020420822386082e-17,
                                                1.9999999999999998,
                                                0.04332027155899406,
                                                -1.3236827215235599e-16,
                                                0.010830067889748503,
                                                2.0746016217053804e-17, 2.0,
                                                -2.6739957879441885e-17,
                                                -2.056130833488359e-17,
                                                -8.271806125530277e-25]},
                       'gmres+ndlu': {'dx_direct': 2.4516041280397687e-10,
                                      'levels': [[346, 171], [256, 192],
                                                 [128, 76], [64, 102],
                                                 [32, 151], [16, 186],
                                                 [8, 224], [4, 232], [2, 597],
                                                 [1, 348]],
                                      'linear': [1, 7, 8, 6],
                                      'newton': 4,
                                      'x_max': 2.000000000002329,
                                      'x_norm': 130.1827984559435,
                                      'x_samples': [0.0, 0.07653248020245987,
                                                    9.766198993045435e-18,
                                                    0.04404227657529805,
                                                    7.558582041992336e-17,
                                                    4.5219282314300865e-17,
                                                    -1.1462960071407889e-10,
                                                    -1.4006539973854474e-16,
                                                    0.033212208491854425,
                                                    1.125193817007855e-16,
                                                    2.2829336519280056e-16,
                                                    0.054150339580364096,
                                                    -1.6248330109276052e-16,
                                                    2.820904095550411e-10,
                                                    -2.2601118415782224e-17,
                                                    2.0000000000000004,
                                                    0.04332027153410206,
                                                    -1.2731904722973353e-16,
                                                    0.010830067961857058,
                                                    -3.6120606289264157e-10,
                                                    2.0000000000000004,
                                                    8.847181778864538e-11,
                                                    -2.1970554472934198e-17,
                                                    0.0]},
                       'tpu_direct': {'dx_direct': 3.74700270810986e-16,
                                      'levels': [[346, 171], [256, 192],
                                                 [128, 76], [64, 102],
                                                 [32, 151], [16, 186],
                                                 [8, 224], [4, 232], [2, 597],
                                                 [1, 348]],
                                      'linear': [1, 1, 1, 1],
                                      'newton': 4,
                                      'x_max': 2.0000000000000235,
                                      'x_norm': 130.1827984557997,
                                      'x_samples': [0.0, 0.07653247975422192,
                                                    1.1681188029523921e-17,
                                                    0.04404227608497666,
                                                    7.268603744878779e-17,
                                                    6.733717998364271e-17,
                                                    2.2061460479016005e-17,
                                                    -1.3634985437651783e-16,
                                                    0.03321220819522828,
                                                    1.0844621047106377e-16,
                                                    2.346346274660119e-16,
                                                    0.05415033944874184,
                                                    -1.5522770149088354e-16,
                                                    -4.814448938675374e-17,
                                                    -2.1994101429242512e-17,
                                                    2.0, 0.043320271558993484,
                                                    -1.3248913565950642e-16,
                                                    0.010830067889748343,
                                                    1.3762511123789939e-18,
                                                    2.0,
                                                    -2.370469233560564e-17,
                                                    -2.3571315454656113e-17,
                                                    0.0]}}},
 'richards': {'gmres+ndlu': {'failures': 0,
                             'front_depth': 1.171875,
                             'levels': [[384, 165], [256, 192], [128, 54],
                                        [64, 77], [32, 84], [16, 143],
                                        [8, 183], [4, 272], [2, 165],
                                        [1, 257]],
                             'profile': [-75.0, -86.75973864241962,
                                         -123.23454998761714,
                                         -371.5606268572672,
                                         -1338.5659704667999,
                                         -1009.8888291540188,
                                         -1010.4477039782452,
                                         -1001.7048965920745,
                                         -999.6029740336018,
                                         -1000.1852137474672,
                                         -999.8712973581402,
                                         -1000.0199476054023,
                                         -999.9794827729788,
                                         -1000.0025977151142,
                                         -999.9969977423364,
                                         -1000.0003531342162,
                                         -999.9995845867461,
                                         -1000.000044317029,
                                         -999.9999468717513,
                                         -1000.0000050024693,
                                         -999.9999937589572,
                                         -1000.0000005122174,
                                         -999.9999993239024,
                                         -1000.0000000475862,
                                         -999.9999999327034,
                                         -1000.0000000037784,
                                         -999.9999999940875,
                                         -1000.0000000001778,
                                         -999.9999999996161,
                                         -999.9999999999802,
                                         -1000.0000000000025,
                                         -999.9999999999916,
                                         -1000.0000000000069,
                                         -999.9999999999978,
                                         -1000.0000000000014,
                                         -999.9999999999993, -1000.0,
                                         -999.9999999999999,
                                         -999.9999999999999, -1000.0,
                                         -999.9999999999998, -75.0,
                                         -86.75973864241813,
                                         -123.23454998761963,
                                         -371.5606268572286,
                                         -1338.5659704667328,
                                         -1009.888829154043,
                                         -1010.4477039782164,
                                         -1001.7048965920775,
                                         -999.6029740335981,
                                         -1000.1852137474671,
                                         -999.8712973581394,
                                         -1000.0199476054024,
                                         -999.9794827729788,
                                         -1000.0025977151142,
                                         -999.9969977423364,
                                         -1000.0003531342161,
                                         -999.9995845867461,
                                         -1000.0000443170289,
                                         -999.9999468717513,
                                         -1000.0000050024693,
                                         -999.9999937589573,
                                         -1000.0000005122175,
                                         -999.9999993239023,
                                         -1000.0000000475862,
                                         -999.9999999327034,
                                         -1000.0000000037782,
                                         -999.9999999940875,
                                         -1000.0000000001778,
                                         -999.9999999996161,
                                         -999.9999999999802,
                                         -1000.0000000000025,
                                         -999.9999999999917,
                                         -1000.000000000007,
                                         -999.9999999999981,
                                         -1000.0000000000017,
                                         -999.9999999999993,
                                         -1000.0000000000001,
                                         -999.9999999999999, -1000.0, -1000.0,
                                         -1000.0],
                             'steps': [[12.5, 12.5, 19, True],
                                       [18.75, 6.25, 13, True],
                                       [21.875, 3.125, 11, True],
                                       [25.0, 3.125, 5, True],
                                       [28.125, 3.125, 4, True],
                                       [31.25, 3.125, 5, True],
                                       [34.375, 3.125, 4, True],
                                       [37.5, 3.125, 4, True],
                                       [40.625, 3.125, 4, True],
                                       [43.75, 3.125, 3, True],
                                       [46.875, 3.125, 4, True],
                                       [50.0, 3.125, 5, True],
                                       [53.125, 3.125, 4, True],
                                       [56.25, 3.125, 6, True],
                                       [59.375, 3.125, 5, True],
                                       [62.5, 3.125, 5, True],
                                       [65.625, 3.125, 5, True],
                                       [68.75, 3.125, 5, True],
                                       [71.875, 3.125, 5, True],
                                       [75.0, 3.125, 4, True],
                                       [78.125, 3.125, 4, True],
                                       [81.25, 3.125, 4, True],
                                       [84.375, 3.125, 4, True],
                                       [87.5, 3.125, 4, True],
                                       [90.625, 3.125, 4, True],
                                       [93.75, 3.125, 5, True],
                                       [96.875, 3.125, 5, True],
                                       [100.0, 3.125, 5, True],
                                       [103.125, 3.125, 6, True],
                                       [106.25, 3.125, 6, True]],
                             'x_max': 1338.5659704668549,
                             'x_norm': 255496.4845051551,
                             'x_samples': [-1000.0, -1000.0, -1000.0, -1000.0,
                                           -999.9999999999999, -1000.0,
                                           -1000.0, -1000.0, -1000.0, -1000.0,
                                           -1000.0, -999.9999999999998,
                                           -1000.0, -1000.0, -1000.0, -1000.0,
                                           -1000.0, -1000.0, -1000.0, -1000.0,
                                           -999.9999999999981,
                                           -999.9999993239024,
                                           -1000.0199476054025, -75.0]},
              'n_dof': 66049,
              'nnz': 1050625,
              'tpu_direct': {'failures': 0,
                             'front_depth': 2.734375,
                             'levels': [[384, 165], [256, 192], [128, 54],
                                        [64, 77], [32, 84], [16, 143],
                                        [8, 183], [4, 272], [2, 165],
                                        [1, 257]],
                             'profile': [-75.0, -79.17021221386406,
                                         -84.53379340807328,
                                         -91.77046540492621,
                                         -102.21059431267525,
                                         -120.25909361209958,
                                         -162.64841709214053,
                                         -375.28363888235214,
                                         -1049.8727299805169,
                                         -1012.114074774711,
                                         -996.4667202261852,
                                         -999.8865446167553,
                                         -999.6615343212588,
                                         -999.9735868817194,
                                         -999.9789626569102,
                                         -999.9979380832265,
                                         -999.9989261304869,
                                         -999.9998661199096,
                                         -999.9999544440208,
                                         -999.9999921659044,
                                         -999.9999985609574,
                                         -999.9999995630972,
                                         -1000.0000000015415,
                                         -999.9999999739069,
                                         -1000.0000000074581,
                                         -999.9999999981741,
                                         -1000.0000000011383,
                                         -999.9999999998613,
                                         -1000.0000000001273,
                                         -999.9999999999902,
                                         -1000.0000000000116,
                                         -999.9999999999992,
                                         -1000.0000000000006,
                                         -999.9999999999998,
                                         -999.9999999999998, -1000.0,
                                         -999.9999999999998, -1000.0,
                                         -999.9999999999998, -1000.0,
                                         -999.9999999999998, -75.0,
                                         -79.17021221386406,
                                         -84.53379340807327,
                                         -91.77046540492607,
                                         -102.21059431267516,
                                         -120.25909361209948,
                                         -162.64841709214016,
                                         -375.2836388823481,
                                         -1049.872729980516,
                                         -1012.1140747747113,
                                         -996.466720226185, -999.8865446167553,
                                         -999.6615343212586,
                                         -999.9735868817193,
                                         -999.9789626569101,
                                         -999.9979380832265,
                                         -999.9989261304868,
                                         -999.9998661199097,
                                         -999.9999544440209,
                                         -999.9999921659044,
                                         -999.9999985609575,
                                         -999.9999995630974,
                                         -1000.0000000015418,
                                         -999.9999999739073,
                                         -1000.0000000074585,
                                         -999.9999999981741,
                                         -1000.0000000011382,
                                         -999.9999999998613,
                                         -1000.0000000001276,
                                         -999.9999999999903,
                                         -1000.0000000000117,
                                         -999.9999999999992,
                                         -1000.0000000000006,
                                         -999.9999999999998,
                                         -999.9999999999999, -1000.0, -1000.0,
                                         -1000.0, -1000.0, -1000.0, -1000.0],
                             'steps': [[25.0, 25.0, 14, True],
                                       [50.0, 25.0, 11, True],
                                       [75.0, 25.0, 15, True],
                                       [100.0, 25.0, 17, True],
                                       [125.0, 25.0, 5, True],
                                       [137.5, 12.5, 20, True],
                                       [150.0, 12.5, 5, True],
                                       [162.5, 12.5, 4, True],
                                       [175.0, 12.5, 4, True],
                                       [187.5, 12.5, 5, True],
                                       [200.0, 12.5, 5, True],
                                       [212.5, 12.5, 4, True],
                                       [225.0, 12.5, 4, True],
                                       [237.5, 12.5, 4, True],
                                       [250.0, 12.5, 4, True],
                                       [262.5, 12.5, 6, True],
                                       [275.0, 12.5, 4, True],
                                       [287.5, 12.5, 4, True],
                                       [300.0, 12.5, 4, True],
                                       [312.5, 12.5, 4, True],
                                       [325.0, 12.5, 3, True],
                                       [337.5, 12.5, 4, True],
                                       [350.0, 12.5, 4, True],
                                       [362.5, 12.5, 4, True],
                                       [375.0, 12.5, 4, True],
                                       [387.5, 12.5, 4, True],
                                       [400.0, 12.5, 4, True],
                                       [412.5, 12.5, 4, True],
                                       [425.0, 12.5, 4, True],
                                       [437.5, 12.5, 4, True]],
                             'x_max': 1049.872729980527,
                             'x_norm': 253140.11953929614,
                             'x_samples': [-1000.0, -1000.0, -1000.0, -1000.0,
                                           -999.9999999999998, -1000.0,
                                           -1000.0, -1000.0, -1000.0,
                                           -999.9999999999998, -1000.0,
                                           -999.9999999999998,
                                           -999.9999999999998,
                                           -999.9999999999999,
                                           -999.9999999999998,
                                           -999.9999999999998,
                                           -999.9999999999998, -1000.0,
                                           -1000.0, -1000.0,
                                           -999.9999999999998,
                                           -1000.0000000015418,
                                           -999.8865446167554, -75.0]}},
 'small': {'bar_vibration': {'newton': 240,
                             'reading': [-0.0008136277530390386]},
           'contact_floor': {'newton': 2, 'reading': [-0.05008000000000002]},
           'contact_separated': {'newton': 1,
                                 'reading': [0.05000000000000016]},
           'coulomb_acoustic': {'newton': 2,
                                'reading': [0.0018357679125827677]},
           'coulomb_block': {'newton': 2, 'reading': [0.0038350298472111174]},
           'elec_capacitor': {'newton': 2, 'reading': [-9.000000000000007]},
           'flow_gradv_outflow': {'newton': 1,
                                  'reading': [-5.599999999999984,
                                              16.799999999999965]},
           'force_sic': {'newton': 2,
                         'reading': [0.0029945240921076402,
                                     -0.004137344909095722]},
           'fsi_pressurized': {'newton': 1, 'reading': [0.008000000000000037]},
           'hyst_loop': {'newton': 0,
                         'reading': [0.26199082252610484, 0.9999999999999997]},
           'hyst_main_curves': {'newton': 0,
                                'reading': [0.95, 0.19517831998159696]},
           'hyst_richards': {'newton': 27,
                             'reading': [0.8211989377124301,
                                         0.6215396181456134,
                                         0.5460186936255553,
                                         0.7165596604542963, 0.790112128374074,
                                         0.8752883487159192]},
           'hyst_threshold': {'newton': 0,
                              'reading': [0.95, 0.34972220141897714, 0.95]},
           'kelvin_density': {'newton': 0,
                              'reading': [0.02349997274713496,
                                          0.02525859995188838,
                                          0.02525859995188838]},
           'latent_heat_slab': {'newton': 1, 'reading': [0.6250000000000041]},
           'overset_fsi_wall': {'newton': 1, 'reading': [0.06000000000000018]},
           'plane_strain_stretch': {'newton': 1,
                                    'reading': [0.02000000000000001,
                                                0.002500000000000032]},
           'porous_flux_extraction': {'newton': 2,
                                      'reading': [0.8571428571428551]},
           'porous_flux_saturated': {'newton': 2,
                                     'reading': [1.199999999999996]},
           'porous_ls_wicking': {'newton': 2,
                                 'reading': [2.499999999999995,
                                             0.6999999999999978]},
           'sink_conservation': {'newton': 44,
                                 'reading': [0.28861309700971094,
                                             0.2892525833331287]},
           'sink_exponential': {'newton': 60, 'reading': [0.5402413499891561]},
           'slope_ramp': {'newton': 3, 'reading': [0.049971414358039465]},
           'surface_viscosity_moment': {'newton': 0,
                                        'reading': [1.1899999999999997]},
           'total_ale_tie': {'newton': 3, 'reading': [0.05]},
           'traction_bar': {'newton': 1, 'reading': [0.06250000000000032]},
           'two_phase_closed': {'newton': 203,
                                'reading': [0.2762082310015096,
                                            0.27620412507884995]},
           'two_phase_hydrostatic': {'newton': 4,
                                     'reading': [-0.9999999999999732,
                                                 0.39999999999999997]},
           'two_phase_numjac': {'newton': 0, 'reading': [648.0]},
           'vnorm_leak': {'newton': 1, 'reading': [0.29999999999999993]}}}
# x at the record's sampled dofs against goma_tpu's rung (and its float64
# solution), max |dx| / max |x|: the rungs stop at ||R|| <= 1e-9 after
# float32-factored steps (goma_tpu's own gmres+ndlu rung reads 2.5e-10
# from its float64 solution on the FSI column)
SOLID_X_RTOL = 1e-6
# the exact uniaxial-strain displacement of run (a), relative to P0 (the
# test's own gate)
FSI_EXACT_RTOL = 2e-5
# the small decks' readings against goma_tpu's, relative (float64 on both
# sides, the same operations: within 1e-12 on the CPU), and x on cuda
# against cpu, max |dx| / (1 + |x|)
SOLID_SMALL_RTOL = 1e-8
SOLID_SMALL_X_TOL = 1e-8


def solid_namespace(device):
    """scripts/solid_decks.py's namespace for the port on ``device``."""
    from scripts import solid_decks

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    return solid_decks.namespace("goma_tpu_torch", torch, arr, device=device)


def solid_setup(deck, dev, model=None):
    """The 128x64 FSI column (``model`` "linear" or "nonlinear") or the
    128x128 Richards slab on the card, checked against goma_tpu's dof and
    nnz counts. Returns (problem, x0)."""
    from scripts import solid_decks

    t0 = time.perf_counter()
    P = solid_namespace(dev)
    ref = SOLID_REF[deck]
    if deck == "fsi":
        prob = solid_decks.fsi_column(P, FSI_NX, FSI_NY, model, FSI_P0[model])
        x0 = np.zeros(prob.dofmap.n_dof)
        what = (f"{FSI_NX}x{FSI_NY} QUAD9, Stokes Q2/Q1 fluid + {model} Q2 "
                f"solid, P0 = {FSI_P0[model]}, {len(prob._inject_specs)} row "
                "injections")
    else:
        prob, x0 = solid_decks.richards(P, RICH_N)
        what = f"{RICH_N}x{RICH_N} QUAD9, Q2 PorousFlow (van Genuchten)"
    log(f"{deck} setup: {what}, {prob.dofmap.n_dof} dof (goma_tpu "
        f"{ref['n_dof']}), {prob.pattern.nnz} nnz (goma_tpu {ref['nnz']}); "
        f"{time.perf_counter() - t0:.2f} s")
    if (prob.dofmap.n_dof, prob.pattern.nnz) != (ref["n_dof"], ref["nnz"]):
        raise RuntimeError(f"{deck} deck: dof or nnz count differs from "
                           "goma_tpu's")
    return prob, x0


def csr_tree(prob, solver, label, direct, ref):
    """The kernels on the tree of a deck that takes the full prep (a row
    injection): the tree against goma_tpu's record, the front LU on its
    real fronts at x = 0 (the full prep's values, what the first factor
    sees) and at its level shapes, the factorization split, the gather
    exact and timed; on ``tpu_direct`` also the substitutions of one
    solve (``direct_tree_phase``). Returns (NDLU, the numbers the summary
    reads)."""
    if direct:
        tree = direct_tree_phase(prob, solver, label)
        nd = tree.pop("nd")
        check_ref_levels(nd, ref, label)
        return nd, tree
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device="cuda")
    vals = solver._prepare(x0, prob.base_params())[1]
    nd = solver.precond
    levels = check_ref_levels(nd, ref, label)
    shapes = [(nn, m) for nn, m, _ in levels]
    tree = {"max_abs": check_real_fronts(nd, vals, f"{label} x=0"),
            "gather_abs": check_gathers(nd, vals, f"{label} tree")}
    lu_abs, tree["lu_ms"] = lu_shapes(shapes, label, time_twin=True)
    tree["max_abs"] = max(tree["max_abs"], lu_abs)
    tree["lu_bound"] = lu_bound(shapes)
    tree["g_times"], tree["g_bound"] = gather_times(nd, vals, f"{label} tree")
    factor_split_ms(nd, vals, f"{label} tree")
    return nd, tree


def x_against(rd, ref, label, direct_rec=None):
    """max |dx| / max |x| at the 24 sampled dofs from goma_tpu's rung (and
    its float64 solution); raises beyond SOLID_X_RTOL."""
    scale = (direct_rec or ref)["x_max"]
    dx = float(np.abs(np.subtract(rd["x_samples"], ref["x_samples"])).max()
               / scale)
    d64 = (float(np.abs(np.subtract(rd["x_samples"],
                                    direct_rec["x_samples"])).max() / scale)
           if direct_rec else 0.0)
    log(f"{label}: ||x|| {rd['x_norm']:.10g} (goma_tpu {ref['x_norm']:.10g}), "
        f"max |x| {rd['x_max']:.6e}; x at 24 dofs max |dx| / max |x| "
        f"{dx:.2e} from goma_tpu's rung"
        + (f", {d64:.2e} from its float64 solution" if direct_rec else ""))
    if max(dx, d64) > SOLID_X_RTOL:
        raise RuntimeError(f"{label}: x {dx:.2e} / {d64:.2e} from goma_tpu's "
                           f"> {SOLID_X_RTOL:.0e}")
    return dx


def fsi_phase(dev, model, kind, prob=None):
    """Phase 54: the 128x64 conforming FSI column, run (a) (``model``
    "linear", P0 = 0.2, ``tpu_direct`` only) or run (b) ("nonlinear",
    P0 = 2) on ``kind``, under bench._cavity_opts(kind, tol=1e-9,
    max_iter=12) restated, float64 Jacobian (see the module docstring).
    Run (a) factors once a solve, at x = 0: the kernels are held against
    their plain versions on the fronts of its timed solve's factorization
    and on one solve's substitutions (run (b) holds them at its level
    shapes, times them and splits the factorization)."""
    from goma_tpu_torch.solvers import NewtonSolver
    from scripts import solid_decks

    label = f"fsi {model} {kind}"
    t_phase = time.perf_counter()
    ref = SOLID_REF["fsi"][model][kind]
    if prob is None:
        prob, _ = solid_setup("fsi", dev, model)
    direct = kind == "tpu_direct"
    solver = NewtonSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=12))
    if solver._use_elem_mv or solver._elem_asm_only:
        raise RuntimeError(f"{label}: a row injection must take the full prep "
                           "and the CSR operator")
    if model == "nonlinear":
        nd, tree = csr_tree(prob, solver, label, direct, ref)
    else:
        x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device="cuda")
        nd = solver._direct_ndlu(solver._prepare(x0, prob.base_params())[1])
        check_ref_levels(nd, ref, label)
        tree = {"max_abs": 0.0, "gather_abs": 0.0, "trsv": {"max_abs": 0.0}}
    seen = record_factor_vals(nd)
    res, sec, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof),
                                   prob.base_params(), label)
    check_launches(solver, ln, len(nd.levels), label, direct=direct)
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: the solution has the wrong shape or "
                           "non-finite values")
    if not res.converged or res.res_norms[-1][1] > 1e-9:
        raise RuntimeError(f"{label} did not converge to 1e-9")
    log(f"{label}: Newton {res.iters} (goma_tpu {ref['newton']}), linear "
        f"{res.linear_iters} (goma_tpu {ref['linear']})")
    newton_ok = (res.iters == ref["newton"] if direct
                 else abs(res.iters - ref["newton"]) <= 1)
    if not newton_ok:
        raise RuntimeError(f"{label} took {res.iters} Newton iterations, not "
                           f"goma_tpu's {ref['newton']}"
                           + ("" if direct else " +- 1"))
    x_against(solid_decks.readings(x), ref, label,
              SOLID_REF["fsi"][model].get("direct"))
    if model == "linear":
        P0 = FSI_P0[model]
        eu, umax, ep = solid_decks.fsi_exact_error(prob, x, P0)
        log(f"{label}: solid max |u - P0 (L - x)/(2G + lambda)| {eu:.3e} "
            f"(gate {FSI_EXACT_RTOL * P0:.1e}, goma_tpu {ref['exact_err']:.3e}),"
            f" fluid max |u| {umax:.2e}, max |p - P0| {ep:.2e}")
        if eu > FSI_EXACT_RTOL * P0 or umax > 1e-6 or ep > 1e-6:
            raise RuntimeError(f"{label}: not the exact uniaxial-strain "
                               "solution with a static fluid")
    log(f"phase 54 ({label}): {sec / max(res.iters, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del nd.factor  # record_factor_vals's wrapper
    if (solver._ndlu if direct else solver.precond) is not nd:
        raise RuntimeError(f"{label}: the rung factored another NDLU")
    # run (a): the timed solve's one factorization (the warm-up's is "first")
    shell_kernels_after(nd, seen, tree, label, direct, prob,
                        keys=("first", "last") if model == "nonlinear"
                        else ("last",))
    return {"prob": prob, "launches": ln, **tree}


def richards_phase(dev, kind, prob=None, x0=None):
    """Phase 55: the 128x128 Richards slab on ``kind`` (see the module
    docstring): the transient driver with bench._cavity_opts(kind,
    tol=1e-9, max_iter=solid_decks.RICHARDS_MAX_ITER) restated, float64
    Jacobian. Gates: goma_tpu's step records, the end state's 24 sampled
    dofs and its head down the wetted top (``solid_decks.profile``) within
    SOLID_X_RTOL of max |x|, and the front's depth goma_tpu's."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather
    from goma_tpu_torch.solvers.transient import TransientSolver
    from scripts import solid_decks

    label = f"richards {kind}"
    t_phase = time.perf_counter()
    ref = SOLID_REF["richards"][kind]
    if prob is None:
        prob, x0 = solid_setup("richards", dev)
    direct = kind == "tpu_direct"
    P = solid_namespace(dev)
    ts = TransientSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=solid_decks.RICHARDS_MAX_ITER),
        solid_decks.richards_time(P))
    sv = ts.newton
    nd, tree = shell_tree(prob, sv, label, direct)
    check_ref_levels(nd, ref, label)
    params = prob.base_params()
    seen = record_factor_vals(nd)
    sv.reset_lagged()
    sv.n_factor = sv._ndlu_nfactor = sv.n_discarded = 0
    sv.direct_log = []
    if sv._ndlu is not None:
        sv._ndlu.n_solve = 0
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    per_step = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ts.run(x0, params, callback=lambda t, x, xdot, res: per_step.append(res))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
          "gather": front_gather.launches}
    check_launches(sv, ln, len(nd.levels), label, direct=direct)
    steps = solid_decks.step_records(r)
    nit = sum(s[2] for s in steps if s[3])
    asm = sum(x.assembly_time for x in per_step)
    slv = sum(x.solve_time for x in per_step)
    for s, x in zip(r.steps, per_step):
        log(f"{label} step t={s.t:.1f} dt={s.dt:.4g}: Newton {s.newton_iters},"
            f" linear {x.linear_iters}")
    log(f"{label}: {len(steps)} steps to t = {r.t:.1f} s, {r.n_failures} "
        f"failed attempts, {nit} Newton iterations, factorizations "
        f"{sv.n_factor + sv._ndlu_nfactor}, launches front-LU {ln['lu']} "
        f"front-gather {ln['gather']} substitution {ln['trsv']}; asm "
        f"{asm / max(nit, 1) * 1e3:.1f} ms + slv {slv / max(nit, 1) * 1e3:.1f}"
        f" ms per iteration, {sec / max(nit, 1):.4f} s/iter (total "
        f"{sec:.3f} s)")
    rs = ref["steps"]
    ok = (len(steps) == len(rs) and r.n_failures == ref["failures"]
          and all(abs(a[0] - b[0]) <= 1e-9 * b[0] and a[1] == b[1] and a[3]
                  for a, b in zip(steps, rs))
          and all((a[2] == b[2]) if direct else abs(a[2] - b[2]) <= 1
                  for a, b in zip(steps, rs)))
    if not ok:
        raise RuntimeError(f"{label}: step records {steps} (failures "
                           f"{r.n_failures}) are not goma_tpu's {rs} "
                           f"(failures {ref['failures']})")
    if r.x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(r.x)):
        raise RuntimeError(f"{label}: the end state has the wrong shape or "
                           "non-finite values")
    x_against(solid_decks.readings(r.x), ref, label)
    front = solid_decks.front_depth(prob, r.x)
    prof = solid_decks.profile(prob, r.x)
    dp = float(np.abs(np.subtract(prof, ref["profile"])).max() / ref["x_max"])
    log(f"{label}: head at the {len(prof)} nodes of x = 0 and x = 50 within "
        f"{solid_decks.PROFILE_DEPTH:g} cm of the top, max |dh| / max |x| "
        f"{dp:.2e} from goma_tpu's; heads from the top down at x = 50: "
        + ", ".join(f"{v:.1f}" for v in prof[len(prof) // 2:]))
    if len(prof) != len(ref["profile"]) or dp > SOLID_X_RTOL:
        raise RuntimeError(f"{label}: the head down the wetted top is "
                           f"{dp:.2e} from goma_tpu's > {SOLID_X_RTOL:.0e}")
    if front != ref["front_depth"]:
        raise RuntimeError(f"{label}: the wetting front is {front} cm deep, "
                           f"goma_tpu's {ref['front_depth']} cm")
    del nd.factor  # record_factor_vals's wrapper
    shell_kernels_after(nd, seen, tree, label, direct, prob)
    log(f"phase 55 ({label}): {sec / max(nit, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"prob": prob, "x0": x0, "launches": ln, **tree}


def solid_small_phase(devices=("cuda", "cpu")):
    """Phase 56: goma_tpu's tests' decks of solid mechanics and porous
    media (``solid_decks.SMALL``: tests/test_solid.py, test_contact.py,
    test_fsi_conforming.py, test_bc_traction.py but its air film,
    test_overset.py's elastic wall, test_porous_sink.py,
    test_porous_twophase.py, test_hysteresis.py, the porous decks of
    test_ca_edge_porous.py and test_lub_film_junction.py's wicking flux) at
    their own sizes and on their own solvers, on cuda and cpu: each deck's
    own gate, goma_tpu's Newton count, the readings within
    SOLID_SMALL_RTOL on the card, and the same Newton count and x within
    SOLID_SMALL_X_TOL on both devices."""
    from scripts import solid_decks

    t0 = time.perf_counter()
    runs = {d: (cpu_runs("solid", lambda: small_deck_runs(
        solid_decks.SMALL, solid_namespace(torch.device("cpu"))))
        if d == "cpu" else small_deck_runs(
            solid_decks.SMALL, solid_namespace(torch.device(d))))
        for d in devices}
    for name in solid_decks.SMALL:
        ref = SOLID_REF["small"][name]
        outs = {d: runs[d][name] for d in devices}
        out = outs[devices[0]]
        dv = float(np.max(np.abs(np.subtract(out["reading"], ref["reading"]))
                          / np.maximum(np.abs(ref["reading"]), 1e-300)))
        dx = max(float(np.max(np.abs(o["x"] - out["x"])
                              / (1.0 + np.abs(out["x"]))))
                 for o in outs.values())
        log(f"solid small {name}: Newton " + ", ".join(
            f"{d} {o['newton']}" for d, o in outs.items())
            + f" (goma_tpu {ref['newton']}), reading {out['reading']} "
            f"(relative {dv:.2e}), x {devices} max |dx| / (1 + |x|) "
            f"{dx:.2e}; " + ", ".join(f"{d} {o['seconds']:.2f} s"
                                      for d, o in outs.items()))
        if any(o["newton"] != ref["newton"] for o in outs.values()):
            raise RuntimeError(f"solid small {name}: Newton counts "
                               f"{[o['newton'] for o in outs.values()]} vs "
                               f"goma_tpu's {ref['newton']}")
        if not dv <= SOLID_SMALL_RTOL:
            raise RuntimeError(f"solid small {name}: reading {dv:.2e} from "
                               "goma_tpu's")
        if not dx <= SOLID_SMALL_X_TOL:
            raise RuntimeError(f"solid small {name}: x {dx:.2e} between "
                               "devices")
    log(f"phase 56 (small solid and porous decks on {' and '.join(devices)})"
        f": {time.perf_counter() - t0:.1f} s")


def solid_phases(dev):
    """Phases 54-56 in order: the FSI column's run (a) and run (b) on both
    rungs, the Richards slab on both rungs, the small decks on cuda and
    cpu. Returns the five main paths' records (run (a), FSI ``gmres+ndlu``
    and ``tpu_direct``, Richards ``gmres+ndlu`` and ``tpu_direct``)."""
    t_sol = time.perf_counter()
    fsa = fsi_phase(dev, "linear", "tpu_direct")
    fsg = fsi_phase(dev, "nonlinear", "gmres+ndlu")
    fsd = fsi_phase(dev, "nonlinear", "tpu_direct", fsg.pop("prob"))
    rcg = richards_phase(dev, "gmres+ndlu")
    rcd = richards_phase(dev, "tpu_direct", rcg.pop("prob"), rcg.pop("x0"))
    for rec in (fsa, fsd, rcd):
        rec.pop("prob")
        rec.pop("x0", None)
    solid_small_phase()
    log(f"phases 54-56 (solid mechanics and porous media): "
        f"{time.perf_counter() - t_sol:.1f} s; {mem_line()}")
    return fsa, fsg, fsd, rcg, rcd


# ---- phases 57-59: closures (suspensions, gas and surface kinetics, QMOM,
# Spalart-Allmaras)
SUSP_NX, SUSP_NY = 128, 32
REACT_NX, REACT_NY = 96, 24
# goma_tpu's record of phases 57-59 (scripts/closure_reference.py on a CPU:
# --part suspension, --part reacting, --part small)
CLOSURE_REF = {'suspension': {'nx': 128,
                'ny': 32,
                'n_dof': 58629,
                'nnz': 3758617,
                'steps_nominal': 10,
                'gmres+ndlu': {'steps': [[0.05, 0.05, 6, True],
                                         [0.07500000000000001,
                                          0.025,
                                          6,
                                          True],
                                         [0.1, 0.025, 4, True],
                                         [0.125, 0.025, 3, True],
                                         [0.15, 0.025, 3, True],
                                         [0.175, 0.025, 3, True],
                                         [0.19999999999999998,
                                          0.025,
                                          3,
                                          True],
                                         [0.22499999999999998,
                                          0.025,
                                          2,
                                          True],
                                         [0.24999999999999997,
                                          0.025,
                                          2,
                                          True],
                                         [0.27499999999999997,
                                          0.025,
                                          2,
                                          True]],
                               'failures': 0,
                               't': 0.27499999999999997,
                               'phi': [[0.38293766708572496,
                                        0.387491677836406,
                                        0.3917274119261699,
                                        0.39434374601255845,
                                        0.3966546553177776,
                                        0.3978653084381031,
                                        0.398877912880042,
                                        0.3993282052958551,
                                        0.3996847745819522,
                                        0.3998213975237482,
                                        0.39992385284511833,
                                        0.3999581343794733,
                                        0.3999823628976153,
                                        0.39998970941404477,
                                        0.3999944793177079,
                                        0.39999605611897066,
                                        0.39999689834750196,
                                        0.3999971924641884,
                                        0.39999711895936574,
                                        0.3999983913180285,
                                        0.3999994182534525,
                                        0.3999955213809584,
                                        0.39999087938470357,
                                        0.4000113189427829,
                                        0.4000362433604066,
                                        0.3999519295265272,
                                        0.399839295321567,
                                        0.400289326404484,
                                        0.40110646045247683,
                                        0.4004124116011114,
                                        0.3988115414904218,
                                        0.4008448923498206,
                                        0.5226441642667357,
                                        0.40084489234978193,
                                        0.39881154149042236,
                                        0.40041241160111063,
                                        0.4011064604524724,
                                        0.4002893264044814,
                                        0.39983929532156326,
                                        0.399951929526525,
                                        0.40003624336040916,
                                        0.40001131894279424,
                                        0.3999908793847313,
                                        0.3999955213809515,
                                        0.39999941825343144,
                                        0.3999983913180317,
                                        0.3999971189593802,
                                        0.3999971924642031,
                                        0.39999689834749963,
                                        0.3999960561189724,
                                        0.3999944793177259,
                                        0.3999897094140484,
                                        0.39998236289760314,
                                        0.39995813437945943,
                                        0.3999238528451215,
                                        0.3998213975237576,
                                        0.399684774581964,
                                        0.3993282052958499,
                                        0.39887791288003743,
                                        0.39786530843807993,
                                        0.39665465531777755,
                                        0.39434374601254385,
                                        0.39172741192619587,
                                        0.3874916778363807,
                                        0.38293766708570975],
                                       [0.31386844732333846,
                                        0.33890803395183616,
                                        0.3716381895517434,
                                        0.3907438080728575,
                                        0.41596804784697244,
                                        0.4083867516673555,
                                        0.40432287001052136,
                                        0.4053367692053953,
                                        0.4086145748544424,
                                        0.4049960369103051,
                                        0.4094816002433042,
                                        0.4040332773787691,
                                        0.4148699108381265,
                                        0.4019484456960152,
                                        0.40537916281109904,
                                        0.40239554046601,
                                        0.4023906203279391,
                                        0.40172077192153677,
                                        0.4010291798045404,
                                        0.4011409923284153,
                                        0.40052518542187526,
                                        0.4007112755053668,
                                        0.4002156751671423,
                                        0.4004090017170548,
                                        0.4000253788286249,
                                        0.4002126240297137,
                                        0.39999607530470627,
                                        0.40047346382319554,
                                        0.40090371160471944,
                                        0.40371677230050207,
                                        0.40719705833554654,
                                        0.4112085437227017,
                                        0.4135146822114194,
                                        0.4112085437227052,
                                        0.40719705833555386,
                                        0.40371677230050573,
                                        0.40090371160471167,
                                        0.4004734638232019,
                                        0.39999607530471615,
                                        0.40021262402972296,
                                        0.40002537882866085,
                                        0.4004090017170328,
                                        0.400215675167273,
                                        0.4007112755051959,
                                        0.40052518542567467,
                                        0.40114099232433215,
                                        0.40102917982575786,
                                        0.40172077189984184,
                                        0.4023906203721777,
                                        0.4023955404586435,
                                        0.40537916276380875,
                                        0.4019484457673947,
                                        0.4148699106509612,
                                        0.4040332774828405,
                                        0.40948160018183843,
                                        0.40499603687494545,
                                        0.4086145749030477,
                                        0.40533676920161116,
                                        0.40432287001185846,
                                        0.4083867516677771,
                                        0.4159680478469719,
                                        0.3907438080725439,
                                        0.3716381895513521,
                                        0.33890803395184615,
                                        0.31386844732348734]],
                               'moved_rows': [19, 47],
                               'levels': [[74, 127],
                                          [254, 192],
                                          [128, 177],
                                          [64, 100],
                                          [32, 144],
                                          [16, 268],
                                          [8, 192],
                                          [4, 424],
                                          [2, 326],
                                          [1, 281]],
                               'x_norm': 17622.557894540183,
                               'x_max': 468.92854022504247,
                               'x_samples': [0.0,
                                             0.19232755020767106,
                                             7.810826266625688e-12,
                                             0.3996847745819861,
                                             0.39995813947624886,
                                             -6.669580085026558e-06,
                                             0.00027843990832678353,
                                             0.3999984657791175,
                                             1.347041997354227,
                                             1.4200779341205514,
                                             335.7825345486222,
                                             -0.00034114748531754866,
                                             1.510299181946486,
                                             2.0271747542367117e-08,
                                             -3.090192256488305e-12,
                                             0.3999908793843979,
                                             0.3999984180199357,
                                             1.1236292639404977,
                                             63.125211581626566,
                                             0.39995814089821513,
                                             4.406476428642701,
                                             0.4447641869361938,
                                             -2.4079888364812785e-10,
                                             12.477452005420053]},
                'tpu_direct': {'steps': [[0.05, 0.05, 6, True],
                                         [0.07500000000000001,
                                          0.025,
                                          6,
                                          True],
                                         [0.1, 0.025, 4, True],
                                         [0.125, 0.025, 2, True],
                                         [0.15, 0.025, 2, True],
                                         [0.175, 0.025, 2, True],
                                         [0.19999999999999998,
                                          0.025,
                                          2,
                                          True],
                                         [0.22499999999999998,
                                          0.025,
                                          2,
                                          True],
                                         [0.24999999999999997,
                                          0.025,
                                          2,
                                          True],
                                         [0.27499999999999997,
                                          0.025,
                                          2,
                                          True]],
                               'failures': 0,
                               't': 0.27499999999999997,
                               'phi': [[0.38293766709008403,
                                        0.387491677839998,
                                        0.3917274119286918,
                                        0.3943437460136194,
                                        0.3966546553173554,
                                        0.3978653084369147,
                                        0.3988779128783299,
                                        0.39932820529428326,
                                        0.39968477458068485,
                                        0.39982139752284124,
                                        0.399923852844578,
                                        0.39995813437912714,
                                        0.3999823628974463,
                                        0.3999897094139505,
                                        0.3999944793176682,
                                        0.39999605611894573,
                                        0.3999968983474991,
                                        0.3999971924641889,
                                        0.39999711895936363,
                                        0.39999839131803266,
                                        0.3999994182534806,
                                        0.39999552138095473,
                                        0.39999087938464306,
                                        0.4000113189427998,
                                        0.4000362433606194,
                                        0.3999519295265655,
                                        0.3998392953210655,
                                        0.40028932640476383,
                                        0.40110646045454157,
                                        0.4004124116002785,
                                        0.39881154147943415,
                                        0.40084489234656606,
                                        0.5226441643042755,
                                        0.40084489234655024,
                                        0.3988115414794697,
                                        0.4004124116002797,
                                        0.40110646045453036,
                                        0.4002893264047624,
                                        0.39983929532106793,
                                        0.39995192952656633,
                                        0.40003624336061927,
                                        0.4000113189428006,
                                        0.39999087938464445,
                                        0.39999552138095584,
                                        0.3999994182534815,
                                        0.39999839131803455,
                                        0.39999711895936635,
                                        0.3999971924641913,
                                        0.3999968983475011,
                                        0.3999960561189476,
                                        0.3999944793176699,
                                        0.3999897094139537,
                                        0.3999823628974506,
                                        0.399958134379131,
                                        0.3999238528445813,
                                        0.3998213975228442,
                                        0.3996847745806873,
                                        0.39932820529428553,
                                        0.39887791287833174,
                                        0.3978653084369166,
                                        0.39665465531735705,
                                        0.39434374601361905,
                                        0.3917274119286895,
                                        0.38749167784000305,
                                        0.38293766709009563],
                                       [0.31386844731732105,
                                        0.3389080339369688,
                                        0.3716381895415021,
                                        0.39074380808568343,
                                        0.4159680478107481,
                                        0.4083867517658893,
                                        0.4043228702092594,
                                        0.40533676899142246,
                                        0.4086145744576576,
                                        0.4049960370077703,
                                        0.409481601105826,
                                        0.4040332773500506,
                                        0.4148699110402456,
                                        0.4019484457059779,
                                        0.4053791628776876,
                                        0.4023955403745235,
                                        0.40239062046881824,
                                        0.40172077192629174,
                                        0.4010291800234465,
                                        0.4011409921901992,
                                        0.4005251856253584,
                                        0.4007112754361773,
                                        0.40021567520651374,
                                        0.40040900171929855,
                                        0.4000253788286164,
                                        0.40021262403147084,
                                        0.3999960753055077,
                                        0.40047346382160215,
                                        0.4009037115998037,
                                        0.40371677229732056,
                                        0.4071970583378695,
                                        0.4112085437301109,
                                        0.4135146822206221,
                                        0.4112085437301102,
                                        0.40719705833786823,
                                        0.4037167722973196,
                                        0.4009037115998033,
                                        0.400473463821602,
                                        0.39999607530550757,
                                        0.40021262403147073,
                                        0.40002537882861633,
                                        0.4004090017192986,
                                        0.400215675206514,
                                        0.4007112754361775,
                                        0.40052518562535844,
                                        0.4011409921901994,
                                        0.4010291800234469,
                                        0.40172077192629196,
                                        0.4023906204688187,
                                        0.4023955403745234,
                                        0.4053791628776892,
                                        0.4019484457059773,
                                        0.41486991104024884,
                                        0.4040332773500515,
                                        0.40948160110582105,
                                        0.40499603700776937,
                                        0.40861457445765687,
                                        0.40533676899142196,
                                        0.40432287020925795,
                                        0.40838675176588823,
                                        0.4159680478107459,
                                        0.3907438080856831,
                                        0.37163818954150224,
                                        0.3389080339369703,
                                        0.313868447317323]],
                               'moved_rows': [19, 47],
                               'levels': [[74, 127],
                                          [254, 192],
                                          [128, 177],
                                          [64, 100],
                                          [32, 144],
                                          [16, 268],
                                          [8, 192],
                                          [4, 424],
                                          [2, 326],
                                          [1, 281]],
                               'x_norm': 17622.55789385478,
                               'x_max': 468.9285402076166,
                               'x_samples': [0.0,
                                             0.19232755020091832,
                                             7.816277708759129e-12,
                                             0.3996847745806984,
                                             0.39995813947591596,
                                             -6.669578987848276e-06,
                                             0.0002784399065324494,
                                             0.39999846577912396,
                                             1.3470419973569692,
                                             1.4200779341291783,
                                             335.78253453499093,
                                             -0.00034114748520552927,
                                             1.5102991819448919,
                                             2.0271753862786488e-08,
                                             -3.0940422812238226e-12,
                                             0.39999087938434497,
                                             0.3999984180199396,
                                             1.1236292639373562,
                                             63.12521158093326,
                                             0.39995814089787274,
                                             4.406476428669179,
                                             0.44476418692587033,
                                             -2.4080002431557e-10,
                                             12.477452006818636]}},
 'reacting': {'nx': 96,
              'ny': 24,
              'n_dof': 49710,
              'nnz': 4313532,
              'b_seed': 0.01,
              'gmres+ndlu': {'converged': True,
                             'finite': True,
                             'newton': 4,
                             'linear': [1, 5, 4, 4],
                             'levels': [[12, 113],
                                        [232, 187],
                                        [128, 186],
                                        [64, 133],
                                        [32, 144],
                                        [16, 213],
                                        [8, 344],
                                        [4, 640],
                                        [2, 444],
                                        [1, 382]],
                             'wall_dT': 63.893146315428,
                             'conversion': 0.5124213645185863,
                             'x_norm': 30765.51109822448,
                             'x_max': 363.893146315428,
                             'x_samples': [0.0,
                                           4.140873114085732,
                                           0.3398413913661427,
                                           0.6562499995432484,
                                           0.4366754540332759,
                                           0.9895822524430984,
                                           1.0908984737233516,
                                           0.5365722890963441,
                                           0.9969158212921415,
                                           4.058877937646512e-13,
                                           1.4765625000394202,
                                           308.45994765950417,
                                           310.98651056279874,
                                           0.3196433722800175,
                                           0.6171557087586024,
                                           0.04389232325220794,
                                           1.2395833333333233,
                                           3.59087311408793,
                                           0.15158075795008527,
                                           0.8333333169828777,
                                           0.276324068892886,
                                           0.4582959579966911,
                                           0.5421044517466472,
                                           315.6372197682511]},
              'tpu_direct': {'converged': True,
                             'finite': True,
                             'newton': 4,
                             'linear': [1, 1, 1, 1],
                             'levels': [[12, 113],
                                        [232, 187],
                                        [128, 186],
                                        [64, 133],
                                        [32, 144],
                                        [16, 213],
                                        [8, 344],
                                        [4, 640],
                                        [2, 444],
                                        [1, 382]],
                             'wall_dT': 63.89314630958239,
                             'conversion': 0.5124213645328324,
                             'x_norm': 30765.51109821705,
                             'x_max': 363.8931463095824,
                             'x_samples': [0.0,
                                           4.14087311408573,
                                           0.3398413913710299,
                                           0.6562499995432484,
                                           0.4366754540932805,
                                           0.9895822524430983,
                                           1.090898473723351,
                                           0.5365722890918397,
                                           0.9969158212921414,
                                           4.058794372970164e-13,
                                           1.4765625000394205,
                                           308.4599476595199,
                                           310.98651056286025,
                                           0.3196433722961197,
                                           0.6171557087388919,
                                           0.04389232325220894,
                                           1.2395833333333237,
                                           3.5908731140879286,
                                           0.1515807579501429,
                                           0.8333333169828777,
                                           0.27632406889479133,
                                           0.45829595799669115,
                                           0.5421044517466468,
                                           315.63721976838696]},
              'direct': {'newton': 4,
                         'converged': True,
                         'wall_dT': 63.89314630957716,
                         'conversion': 0.5124213645325801,
                         'x_norm': 30765.511098217037,
                         'x_max': 363.89314630957716,
                         'x_samples': [0.0,
                                       4.14087311408573,
                                       0.33984139137102987,
                                       0.6562499995432484,
                                       0.4366754540932804,
                                       0.9895822524430984,
                                       1.0908984737233518,
                                       0.5365722890917747,
                                       0.9969158212921414,
                                       4.0570634782728916e-13,
                                       1.4765625000394205,
                                       308.45994765951997,
                                       310.98651056286025,
                                       0.3196433722961196,
                                       0.6171557087388927,
                                       0.04389232325220891,
                                       1.2395833333333237,
                                       3.5908731140879304,
                                       0.15158075795014286,
                                       0.8333333169828777,
                                       0.2763240688947913,
                                       0.45829595799669115,
                                       0.5421044517466468,
                                       315.63721976838696]}},
 'small': {'particle_settling': {'newton': 1,
                                 'reading': [-0.002380952380952382]},
           'two_way_drag': {'newton': 0, 'reading': [2440.0, 0.0]},
           'reaction_diffusion': {'newton': 4,
                                  'reading': [0.6375707491754274]},
           'reversible_equilibrium': {'newton': 2,
                                      'reading': [0.1999999999999999,
                                                  0.8000000000000002]},
           'exothermic': {'newton': 4, 'reading': [2.9886534979119292]},
           'adaptive_closure': {'newton': 0, 'reading': [1.1013888888888894]},
           'moments_growth': {'newton': 25,
                              'reading': [1.0,
                                          1.4,
                                          2.1200639999999984,
                                          3.5122759679999978]},
           'sa_decay': {'newton': 112,
                        'reading': [0.04967744661162761, 0.005]},
           'vorticity_direction': {'newton': 2, 'reading': [1.0]},
           'rans': {'newton': 7, 'reading': [0.05, 1.4961198620643223]},
           'placid_langmuir': {'newton': 0,
                               'reading': [0.9848473784006324,
                                           0.8904037235457368,
                                           0.9653440541790659,
                                           0.9794178364991168,
                                           0.9853622342997583,
                                           0.9886424446989034,
                                           0.9907216511227137,
                                           0.9921573841499837,
                                           0.9932083283835974]},
           'placid_deposition': {'newton': 0,
                                 'reading': [0.02714224916566998,
                                             0.97285775083433,
                                             0.25,
                                             0.75]}}}
# x at 24 dofs and phi up the lines x = 4 and x = 8 against goma_tpu's
# record, max |dx| / max |x| (as phases 54-55)
CLOSURE_X_RTOL = 1e-6
# node rows on each line where phi must move by more than 1e-3
SUSP_MOVED_MIN = 8
# PLACID at every wall point on the card against the CPU: z and sdot,
# max |d| / max |.|
PLACID_RTOL = 1e-10
# the small decks' readings against goma_tpu's, relative, and x on cuda
# against cpu, max |dx| / (1 + |x|)
CLOSURE_SMALL_RTOL = 1e-8
CLOSURE_SMALL_X_TOL = 1e-8
# the vorticity direction on the card against the CPU where the rate of
# strain's spectral gap is at least 1e-6 (value and tangent)
EIG_RTOL = 1e-10


def closure_namespace(device):
    """scripts/closure_decks.py's namespace for the port on ``device``."""
    from scripts import closure_decks

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    return closure_decks.namespace("goma_tpu_torch", torch, arr,
                                   device=device)


def closure_setup(deck, dev):
    """The 128x32 suspension channel or the 96x24 reacting wall channel on
    the card, checked against goma_tpu's dof and nnz counts. Returns
    (problem, x0)."""
    from scripts import closure_decks as cd

    t0 = time.perf_counter()
    P = closure_namespace(dev)
    ref = CLOSURE_REF[deck]
    if deck == "suspension":
        prob, x0 = cd.suspension(P, SUSP_NX, SUSP_NY)
        what = (f"{SUSP_NX}x{SUSP_NY} QUAD9, Navier-Stokes Q2/Q1 + q-tensor "
                "Phillips migration (Q2) + projected shear rate (Q1)")
    else:
        prob, x0 = cd.reacting(P, REACT_NX, REACT_NY)
        what = (f"{REACT_NX}x{REACT_NY} QUAD9, Navier-Stokes Q2/Q1 + "
                "Species(2) + Energy (Q2), Chemkin gas chemistry, PLACID "
                "wall flux")
    log(f"{deck} setup: {what}, {prob.dofmap.n_dof} dof (goma_tpu "
        f"{ref['n_dof']}), {prob.pattern.nnz} nnz (goma_tpu {ref['nnz']}); "
        f"{time.perf_counter() - t0:.2f} s")
    if (prob.dofmap.n_dof, prob.pattern.nnz) != (ref["n_dof"], ref["nnz"]):
        raise RuntimeError(f"{deck} deck: dof or nnz count differs from "
                           "goma_tpu's")
    return prob, x0


def closure_tree(prob, solver, label, direct, x0):
    """The kernels on the deck's tree at its initial state ``x0`` (the CSR
    values the rung's first factorization sees; x = 0 is no state of these
    decks: T = 0 K); see ``shell_tree``."""
    params = prob.base_params()
    xt = torch.as_tensor(np.asarray(x0), dtype=prob.dtype, device="cuda")
    if direct:
        vals = solver._prepare(xt, params)[1]
    else:
        vals = solver._scaled_vals(xt, params,
                                   solver._prepare_fast32(xt, params)[2])
    return shell_tree(prob, solver, label, direct, vals, at="x0")


def suspension_phase(dev, kind, prob=None, x0=None):
    """Phase 57: the 128x32 suspension channel on ``kind``: the transient
    driver, ten backward-Euler steps of ``closure_decks.SUSP_DT`` without
    adaptation, bench._cavity_opts(kind, tol=1e-9, max_iter=12) restated.
    Gates: goma_tpu's step records (Newton exactly on ``tpu_direct``, +-1
    a step on ``gmres+ndlu``), phi up x = 4 and x = 8 and x at 24 dofs
    within CLOSURE_X_RTOL of max |x| from goma_tpu's, phi moved by more
    than 1e-3 at SUSP_MOVED_MIN or more node rows of each line; the launch
    identities; the kernels on the run's last factorization (its first is
    the initial state's, held before the run)."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather
    from goma_tpu_torch.solvers.transient import TransientSolver
    from scripts import closure_decks as cd

    label = f"suspension {kind}"
    t_phase = time.perf_counter()
    ref = CLOSURE_REF["suspension"][kind]
    if prob is None:
        prob, x0 = closure_setup("suspension", dev)
    direct = kind == "tpu_direct"
    P = closure_namespace(dev)
    ts = TransientSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=cd.SUSP_MAX_ITER), cd.suspension_time(P))
    sv = ts.newton
    nd, tree = closure_tree(prob, sv, label, direct, x0)
    check_ref_levels(nd, ref, label)
    params = prob.base_params()
    seen = record_factor_vals(nd)
    sv.reset_lagged()
    sv.n_factor = sv._ndlu_nfactor = sv.n_discarded = 0
    sv.direct_log = []
    if sv._ndlu is not None:
        sv._ndlu.n_solve = 0
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    per_step = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ts.run(x0, params, callback=lambda t, x, xdot, res: per_step.append(res))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
          "gather": front_gather.launches}
    check_launches(sv, ln, len(nd.levels), label, direct=direct)
    steps = cd.step_records(r)
    nit = sum(s[2] for s in steps if s[3])
    asm = sum(x.assembly_time for x in per_step)
    slv = sum(x.solve_time for x in per_step)
    for s, x in zip(r.steps, per_step):
        log(f"{label} step t={s.t:.3f} dt={s.dt:.4g}: Newton "
            f"{s.newton_iters}, linear {x.linear_iters}")
    dts = [cd.SUSP_DT] + [s[1] for s in steps]
    halved = sum(1 for a, b in zip(dts, dts[1:]) if b < a)
    log(f"{label}: {len(steps)} steps to t = {r.t:.3f}, dt halved {halved} "
        f"time(s) after a failed attempt, {nit} Newton iterations (goma_tpu "
        f"{sum(s[2] for s in ref['steps'] if s[3])}), factorizations "
        f"{sv.n_factor + sv._ndlu_nfactor}, launches front-LU {ln['lu']} "
        f"front-gather {ln['gather']} substitution {ln['trsv']}; asm "
        f"{asm / max(nit, 1) * 1e3:.1f} ms + slv {slv / max(nit, 1) * 1e3:.1f}"
        f" ms per iteration, {sec / max(nit, 1):.4f} s/iter (total "
        f"{sec:.3f} s)")
    rs = ref["steps"]
    ok = (len(steps) == len(rs) and r.n_failures == ref["failures"]
          and all(abs(a[0] - b[0]) <= 1e-9 * b[0] and a[1] == b[1] and a[3]
                  for a, b in zip(steps, rs))
          and all((a[2] == b[2]) if direct else abs(a[2] - b[2]) <= 1
                  for a, b in zip(steps, rs)))
    if not ok:
        raise RuntimeError(f"{label}: step records {steps} (failures "
                           f"{r.n_failures}) are not goma_tpu's {rs} "
                           f"(failures {ref['failures']})")
    if r.x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(r.x)):
        raise RuntimeError(f"{label}: the end state has the wrong shape or "
                           "non-finite values")
    x_against(cd.readings(r.x), ref, label)
    phi = cd.phi_profiles(prob, r.x)
    dphi = max(float(np.abs(np.subtract(a, b)).max())
               for a, b in zip(phi, ref["phi"])) / ref["x_max"]
    moved = cd.moved_rows(prob, r.x, x0)
    for xl, prof in zip(cd.SUSP_LINES, phi):
        log(f"{label}: phi up x = {xl:g} ({len(prof)} node rows, every 4th): "
            + ", ".join(f"{v:.5f}" for v in prof[::4]))
    log(f"{label}: phi at the {sum(len(p) for p in phi)} nodes of x = 4 and "
        f"x = 8, max |dphi| / max |x| {dphi:.2e} from goma_tpu's; node rows "
        f"where phi moved by more than 1e-3: {moved} (goma_tpu "
        f"{ref['moved_rows']})")
    if [len(p) for p in phi] != [len(p) for p in ref["phi"]] \
            or dphi > CLOSURE_X_RTOL:
        raise RuntimeError(f"{label}: phi profiles {dphi:.2e} from "
                           f"goma_tpu's > {CLOSURE_X_RTOL:.0e}")
    if min(moved) < SUSP_MOVED_MIN:
        raise RuntimeError(f"{label}: phi moved at {moved} node rows, fewer "
                           f"than {SUSP_MOVED_MIN} on a line")
    del nd.factor  # record_factor_vals's wrapper
    # the run's first factorization is the initial state's: checked above
    shell_kernels_after(nd, seen, tree, label, direct, prob, keys=("last",))
    log(f"phase 57 ({label}): {sec / max(nit, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"prob": prob, "x0": x0, "launches": ln, **tree}


def placid_wall_check(prob, x, label):
    """PLACID at every bottom-wall quadrature point of the state ``x``
    (``closure_decks.wall_points``) on the card against the CPU: z and
    sdot within PLACID_RTOL, the same iteration counts."""
    from scripts import closure_decks as cd

    X, T = cd.wall_points(prob, x)
    outs = []
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        z, sd, conv, it = cd.wall_placid(closure_namespace(torch.device(d)),
                                         X, T)
        outs.append([t.cpu().numpy() for t in (z, sd, conv, it)]
                    + [time.perf_counter() - t0])
    (zc, sc, cc, ic, tc), (zh, sh, ch, ih, th) = outs
    dz = float(np.abs(zc - zh).max() / np.abs(zh).max())
    ds = float(np.abs(sc - sh).max() / np.abs(sh).max())
    trips = {int(k): int(v) for k, v in zip(*np.unique(ic, return_counts=True))}
    log(f"{label}: PLACID at {len(T)} wall points, card against CPU: z "
        f"{dz:.2e}, sdot {ds:.2e} relative, iterations {trips} (card) "
        f"{'equal' if np.array_equal(ic, ih) else 'DIFFER'} on the CPU, "
        f"converged {int(cc.sum())}/{len(cc)}; B fraction at the wall "
        f"{X[:, 1].min():.3e}-{X[:, 1].max():.3e}; {tc:.2f} s / {th:.2f} s")
    if not (dz <= PLACID_RTOL and ds <= PLACID_RTOL and np.array_equal(ic, ih)
            and np.array_equal(cc, ch) and cc.all()):
        raise RuntimeError(f"{label}: PLACID on the card differs from the CPU "
                           f"(z {dz:.2e}, sdot {ds:.2e}) or did not converge")


def reacting_phase(dev, kind, prob=None, x0=None):
    """Phase 58: the 96x24 reacting wall channel, steady, on ``kind`` under
    bench._cavity_opts(kind, tol=1e-9, max_iter=12) restated: the tree
    against goma_tpu's before any solve; the kernels on its real fronts at
    the initial state; ``reset_lagged()`` and one timed solve, no warm-up
    (counts set to 0 just before and read just after); goma_tpu's
    Newton count (exactly on ``tpu_direct``; on ``gmres+ndlu`` +-1 where
    goma_tpu's own run of that rung converged finite, else printed beside
    it); x at 24 dofs within CLOSURE_X_RTOL of max |x| from goma_tpu's
    ``tpu_direct`` record and its float64 solution; the wall temperature
    rise and outlet conversion; PLACID at every wall point against the
    CPU (``placid_wall_check``); the launch identities; the kernels on the
    timed run's last factorization (the first is the initial state's, held
    before the run)."""
    from goma_tpu_torch.solvers import NewtonSolver
    from scripts import closure_decks as cd

    label = f"reacting {kind}"
    t_phase = time.perf_counter()
    rec = CLOSURE_REF["reacting"]
    ref = rec[kind]
    if prob is None:
        prob, x0 = closure_setup("reacting", dev)
    direct = kind == "tpu_direct"
    solver = NewtonSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=cd.REACT_MAX_ITER))
    nd, tree = closure_tree(prob, solver, label, direct, x0)
    check_ref_levels(nd, ref, label)
    seen = record_factor_vals(nd)
    # no warm-up (as phase 55): each reacting solve is ~1 s a Newton
    # iteration of PLACID face prep, and the tree's checks above warmed up
    res, sec, ln = warm_then_timed(solver, x0, prob.base_params(), label,
                                   warm=False)
    check_launches(solver, ln, len(nd.levels), label, direct=direct)
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: the solution has the wrong shape or "
                           "non-finite values")
    if not res.converged or res.res_norms[-1][1] > 1e-9:
        raise RuntimeError(f"{label} did not converge to 1e-9")
    out = cd.reacting_outputs(prob, x)
    ref_ok = ref["converged"] and ref["finite"]
    log(f"{label}: Newton {res.iters}, linear {res.linear_iters}; goma_tpu "
        f"{kind}: Newton {ref['newton']}, linear {ref['linear']}, converged "
        f"{ref['converged']}, finite {ref['finite']}; wall temperature rise "
        f"{out['wall_dT']:.6f} K (goma_tpu {rec['tpu_direct']['wall_dT']:.6f}),"
        f" outlet conversion {out['conversion']:.8f} (goma_tpu "
        f"{rec['tpu_direct']['conversion']:.8f})")
    newton_ok = (res.iters == ref["newton"] if direct
                 else not ref_ok or abs(res.iters - ref["newton"]) <= 1)
    if not newton_ok:
        raise RuntimeError(f"{label} took {res.iters} Newton iterations, not "
                           f"goma_tpu's {ref['newton']}"
                           + ("" if direct else " +- 1"))
    x_against(cd.readings(x), rec["tpu_direct"], label, rec["direct"])
    placid_wall_check(prob, x, label)
    del nd.factor  # record_factor_vals's wrapper
    # the run's first factorization is the initial state's: checked above
    shell_kernels_after(nd, seen, tree, label, direct, prob, keys=("last",))
    log(f"phase 58 ({label}): {sec / max(res.iters, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"prob": prob, "x0": x0, "launches": ln, **tree}


def vorticity_direction_check():
    """The vorticity direction (the middle eigenvector of the rate of
    strain, ``VorticityDirection.vort_dir``) and its tangent on the card
    against the CPU at 4,096 seeded 2D and 3D velocity gradients, where the
    spectral gap is at least 1e-6: within EIG_RTOL. At the degenerate
    points (zero shear and a pure rotation: E = 0, a triple eigenvalue)
    both devices' values are printed: ``eigh`` may pick another basis
    there, and the tangent is 0 on both; simple shear (-gd, 0, gd) gives
    e_z on both."""
    from goma_tpu_torch.physics.suspension import VorticityDirection

    rng = np.random.default_rng(59)
    degenerate = np.zeros((3, 3, 3))
    degenerate[1, 0, 1], degenerate[1, 1, 0] = 1.0, -1.0   # pure rotation
    degenerate[2, 0, 1] = 2.0                               # simple shear
    grads = [rng.standard_normal((2048, 2, 2)),
             rng.standard_normal((2048, 3, 3)), degenerate]
    tangents = [rng.standard_normal(g.shape) for g in grads]

    def vd(gg):
        return VorticityDirection.vort_dir(
            types.SimpleNamespace(grad={"velocity": gg}))

    res = {}
    for d, dev in (("cuda", torch.device("cuda", 0)),
                   ("cpu", torch.device("cpu"))):
        res[d] = []
        for g, dg in zip(grads, tangents):
            v, t = torch.func.jvp(vd, (torch.as_tensor(g, device=dev),),
                                  (torch.as_tensor(dg, device=dev),))
            res[d].append((v.cpu().numpy(), t.cpu().numpy()))
    worst = 0.0
    for k, name in ((0, "2D"), (1, "3D")):
        g = grads[k]
        E = np.zeros((len(g), 3, 3))
        d = g.shape[1]
        E[:, :d, :d] = g + np.swapaxes(g, 1, 2)
        lam = np.linalg.eigvalsh(E)
        ok = np.minimum(lam[:, 1] - lam[:, 0], lam[:, 2] - lam[:, 1]) >= 1e-6
        (vc, tc), (vh, th) = res["cuda"][k], res["cpu"][k]
        dv = float(np.abs(vc[ok] - vh[ok]).max())
        dt = float(np.abs(tc[ok] - th[ok]).max() / np.abs(th[ok]).max())
        worst = max(worst, dv, dt)
        log(f"vorticity direction {name}: {int(ok.sum())}/{len(ok)} points "
            f"with a gap >= 1e-6, card against CPU: value {dv:.2e}, tangent "
            f"{dt:.2e} relative")
    (vc, tc), (vh, th) = res["cuda"][2], res["cpu"][2]
    for i, name in enumerate(("zero shear (triple)", "pure rotation (triple)",
                              "simple shear (simple)")):
        log(f"vorticity direction at {name}: card {np.round(vc[i], 12)}, "
            f"CPU {np.round(vh[i], 12)}; tangent max |t| card "
            f"{np.abs(tc[i]).max():.2e}, CPU {np.abs(th[i]).max():.2e}")
    if worst > EIG_RTOL or not np.allclose(np.abs(vc[2]), [0, 0, 1]):
        raise RuntimeError(f"vorticity direction on the card differs from "
                           f"the CPU by {worst:.2e}")


def closure_small_phase(devices=("cuda", "cpu")):
    """Phase 59: goma_tpu's tests' decks of the slice (``closure_decks.
    SMALL``: tests/test_suspension.py, test_kinetics.py,
    test_adaptive_wheeler.py's closure deck, test_more_physics.py's moment
    cascade, test_physics_breadth.py's SA decay (to ``SA_T_END``),
    test_solved_aux_fields.py's vorticity direction, test_placid.py's
    Langmuir and deposition cases) and the 32x16 RANS channel at their own
    sizes on their own solvers, on cuda and cpu: each deck's own gate,
    goma_tpu's Newton count, the readings within CLOSURE_SMALL_RTOL on the
    card, and the same Newton count and x within CLOSURE_SMALL_X_TOL on
    both devices; then ``vorticity_direction_check``."""
    from scripts import closure_decks as cd

    t0 = time.perf_counter()
    runs = {d: (cpu_runs("closure", lambda: small_deck_runs(
        cd.SMALL, closure_namespace(torch.device("cpu"))))
        if d == "cpu" else small_deck_runs(
            cd.SMALL, closure_namespace(torch.device(d))))
        for d in devices}
    for name in cd.SMALL:
        ref = CLOSURE_REF["small"][name]
        outs = {d: runs[d][name] for d in devices}
        out = outs[devices[0]]
        dv = float(np.max(np.abs(np.subtract(out["reading"], ref["reading"]))
                          / np.maximum(np.abs(ref["reading"]), 1e-300)))
        dx = max(float(np.max(np.abs(o["x"] - out["x"])
                              / (1.0 + np.abs(out["x"]))))
                 for o in outs.values())
        log(f"closure small {name}: Newton " + ", ".join(
            f"{d} {o['newton']}" for d, o in outs.items())
            + f" (goma_tpu {ref['newton']}), reading {out['reading']} "
            f"(relative {dv:.2e}), x {devices} max |dx| / (1 + |x|) "
            f"{dx:.2e}; " + ", ".join(f"{d} {o['seconds']:.2f} s"
                                      for d, o in outs.items()))
        if any(o["newton"] != ref["newton"] for o in outs.values()):
            raise RuntimeError(f"closure small {name}: Newton counts "
                               f"{[o['newton'] for o in outs.values()]} vs "
                               f"goma_tpu's {ref['newton']}")
        if not dv <= CLOSURE_SMALL_RTOL:
            raise RuntimeError(f"closure small {name}: reading {dv:.2e} from "
                               "goma_tpu's")
        if not dx <= CLOSURE_SMALL_X_TOL:
            raise RuntimeError(f"closure small {name}: x {dx:.2e} between "
                               "devices")
    vorticity_direction_check()
    log(f"phase 59 (small closure decks on {' and '.join(devices)}): "
        f"{time.perf_counter() - t0:.1f} s")


def closure_phases(dev):
    """Phases 57-59 in order: the suspension channel on both rungs, the
    reacting wall channel on both rungs, the small decks on cuda and cpu.
    Returns the four main paths' records (suspension ``gmres+ndlu`` and
    ``tpu_direct``, reacting ``gmres+ndlu`` and ``tpu_direct``)."""
    t_cl = time.perf_counter()
    sg = suspension_phase(dev, "gmres+ndlu")
    sd = suspension_phase(dev, "tpu_direct", sg.pop("prob"), sg.pop("x0"))
    rg = reacting_phase(dev, "gmres+ndlu")
    rd = reacting_phase(dev, "tpu_direct", rg.pop("prob"), rg.pop("x0"))
    for rec in (sd, rd):
        rec.pop("prob")
        rec.pop("x0")
    closure_small_phase()
    log(f"phases 57-59 (closures): {time.perf_counter() - t_cl:.1f} s; "
        f"{mem_line()}")
    return sg, sd, rg, rd


# ---- phases 60-62: fluid and level-set boundary conditions (slip laws,
# heat and mass fluxes, LS wall conditions, XFEM pressure, CSF variants,
# solved curvature and normal, extension velocity, embedded laser, recoil
# and latent-heat terms, surface domains)
LS_NX, LS_NY = 96, 48
# goma_tpu's record of phases 60-62 (scripts/ls_reference.py --part melt,
# --part drop, --part small: float64 state, float32 NDLU factors on the
# device rungs, bench._cavity_opts' options, CPU, jax 0.9.0)
LS_REF = {'melt': {'nx': 96,
          'ny': 48,
          'n_dof': 79637,
          'nnz': 5706313,
          'steps_nominal': 6,
          'initial': {'T_peak': 1.0, 'interface_y': 0.6},
          'gmres+ndlu': {'steps': [[0.005, 0.005, 3, True],
                                   [0.01, 0.005, 3, True],
                                   [0.015, 0.005, 3, True],
                                   [0.02, 0.005, 3, True],
                                   [0.025, 0.005, 3, True],
                                   [0.03, 0.0049999999999999975, 3, True]],
                         'failures': 0,
                         't': 0.03,
                         'T_peak': 1.1360429724466843,
                         'x_norm': 144.99105840116874,
                         'x_max': 1.1360429724466843,
                         'x_samples': [0.0, -0.0002857864179924321,
                                       -0.0005984839643124143,
                                       -9.985737682545927e-05,
                                       0.0002278605635603003,
                                       0.0002137711133222694,
                                       0.00043694450889930305,
                                       1.0148807841409768, 1.0032359011569303,
                                       1.0001104876202835,
                                       0.0010209353827937654,
                                       -0.0009368679194873118,
                                       0.06583190096492054,
                                       0.010120206402387649,
                                       -0.00010121637793164914,
                                       -0.0007440554038143334,
                                       0.0003300359110599997,
                                       0.0017552100993430862,
                                       0.0010462901936336962,
                                       0.0010398764068633374,
                                       -0.000526420216490217,
                                       1.033260757489182, 1.0058763524248844,
                                       0.3999908198157124],
                         'levels': [[332, 184], [256, 192], [128, 118],
                                    [64, 166], [32, 231], [16, 242], [8, 284],
                                    [4, 454], [2, 726], [1, 717]],
                         'interface_y': 0.5998724064301344},
          'tpu_direct': {'steps': [[0.005, 0.005, 3, True],
                                   [0.01, 0.005, 3, True],
                                   [0.015, 0.005, 3, True],
                                   [0.02, 0.005, 3, True],
                                   [0.025, 0.005, 2, True],
                                   [0.03, 0.0049999999999999975, 2, True]],
                         'failures': 0,
                         't': 0.03,
                         'T_peak': 1.1360429724601708,
                         'x_norm': 144.9910583998982,
                         'x_max': 1.1360429724601708,
                         'x_samples': [0.0, -0.00028578641805655157,
                                       -0.0005984839629493932,
                                       -9.985737712993369e-05,
                                       0.00022786056362747206,
                                       0.00021377111347811216,
                                       0.00043694450731267856,
                                       1.0148807841294407, 1.0032359011528202,
                                       1.0001104876201565,
                                       0.001020935383590634,
                                       -0.000936867930867047,
                                       0.06583190092752983,
                                       0.010120206090328493,
                                       -0.00010121637656314472,
                                       -0.0007440554021745168,
                                       0.00033003592146072116,
                                       0.0017552100940593535,
                                       0.0010462901948200393,
                                       0.0010398764041129305,
                                       -0.0005264202144783053,
                                       1.0332607574557304, 1.0058763524163408,
                                       0.3999908198168298],
                         'levels': [[332, 184], [256, 192], [128, 118],
                                    [64, 166], [32, 231], [16, 242], [8, 284],
                                    [4, 454], [2, 726], [1, 717]],
                         'interface_y': 0.5998724063048196},
          'direct': {'steps': [[0.005, 0.005, 3, True], [0.01, 0.005, 3, True],
                               [0.015, 0.005, 3, True], [0.02, 0.005, 3, True],
                               [0.025, 0.005, 2, True],
                               [0.03, 0.0049999999999999975, 2, True]],
                     'failures': 0,
                     't': 0.03,
                     'T_peak': 1.1360429724601708,
                     'x_norm': 144.9910583998982,
                     'x_max': 1.1360429724601708,
                     'x_samples': [0.0, -0.00028578641805656,
                                   -0.0005984839629493956,
                                   -9.985737712993662e-05,
                                   0.00022786056362747553,
                                   0.0002137711134781193,
                                   0.00043694450731267465, 1.0148807841294407,
                                   1.0032359011528202, 1.0001104876201565,
                                   0.0010209353835906637,
                                   -0.0009368679308671478, 0.06583190092751505,
                                   0.010120206090329665,
                                   -0.00010121637656316357,
                                   -0.0007440554021744881,
                                   0.0003300359214606755, 0.001755210094059302,
                                   0.001046290194820049, 0.001039876404112982,
                                   -0.0005264202144783316, 1.0332607574557302,
                                   1.0058763524163408, 0.3999908198168298],
                     'interface_y': 0.5998724063048196}},
 'drop': {'nx': 96,
          'ny': 48,
          'n_dof': 79928,
          'nnz': 7189840,
          'steps_nominal': 6,
          'initial': {'contact_line': 0.5,
                      'kappa': 2.002905432006311,
                      'kappa_exact': 2.0,
                      'area': 0.39321218294263943,
                      'u_max': 0.0},
          'gmres+ndlu': {'steps': [[0.0025, 0.0025, 5, True],
                                   [0.005, 0.0025, 5, True],
                                   [0.0075, 0.0025, 6, True],
                                   [0.01, 0.0025, 4, True],
                                   [0.0125, 0.0025, 4, True],
                                   [0.015, 0.0024999999999999988, 4, True]],
                         'failures': 0,
                         't': 0.015,
                         'contact_line': 0.4955044489802539,
                         'kappa': 3.09240390080627,
                         'kappa_exact': 2.0,
                         'area': 0.39319703767531544,
                         'u_max': 0.12789191173687225,
                         'x_norm': 763.9169758660718,
                         'x_max': 344.44194912236463,
                         'x_samples': [0.0, -0.0747660254674632,
                                       -0.19655006471397538,
                                       0.8958273042004133,
                                       -0.0020806788177068465,
                                       0.30861959132034844,
                                       -0.013075661452742473,
                                       0.005664487929028065,
                                       -0.005308771338737008,
                                       -9.17187035867974e-15,
                                       -0.7780255514448342, 1.9424541185924102,
                                       0.050056358602622475,
                                       -0.0020592873221789015,
                                       -2.5999570183180805e-20,
                                       -0.005886520230776649,
                                       0.0016106028317972132,
                                       0.0024724773608556976,
                                       0.8932892413714795,
                                       0.00014594164086755563,
                                       -0.0006768166431043757,
                                       0.013656388541865532,
                                       0.6556338286780732, 0.710320398004356],
                         'levels': [[302, 180], [256, 192], [128, 131],
                                    [64, 184], [32, 254], [16, 258], [8, 315],
                                    [4, 485], [2, 808], [1, 780]]},
          'tpu_direct': {'steps': [[0.0025, 0.0025, 4, True],
                                   [0.005, 0.0025, 4, True],
                                   [0.0075, 0.0025, 4, True],
                                   [0.01, 0.0025, 3, True],
                                   [0.0125, 0.0025, 2, True],
                                   [0.015, 0.0024999999999999988, 2, True]],
                         'failures': 0,
                         't': 0.015,
                         'contact_line': 0.4955044489807614,
                         'kappa': 3.0924039011387623,
                         'kappa_exact': 2.0,
                         'area': 0.39319703767525943,
                         'u_max': 0.12789191175752615,
                         'x_norm': 763.9169753154157,
                         'x_max': 344.4419491117246,
                         'x_samples': [0.0, -0.07476602546343016,
                                       -0.19655006471395398,
                                       0.8958273042004465,
                                       -0.0020806788215802204,
                                       0.3086195913203494,
                                       -0.013075661452442208,
                                       0.005664487929363341,
                                       -0.005308771339698052,
                                       -9.171870360672581e-15,
                                       -0.7780255514449177, 1.942454118590518,
                                       0.05005635860261028,
                                       -0.0020592873223220557,
                                       -2.599957018759354e-20,
                                       -0.005886520231005746,
                                       0.0016106028318729909,
                                       0.0024724773609603066,
                                       0.8932892413698611,
                                       0.0001459416408742083,
                                       -0.0006768166431449939,
                                       0.013656388537308573,
                                       0.6556338286780726,
                                       0.7103203978888334],
                         'levels': [[302, 180], [256, 192], [128, 131],
                                    [64, 184], [32, 254], [16, 258], [8, 315],
                                    [4, 485], [2, 808], [1, 780]]},
          'direct': {'steps': [[0.0025, 0.0025, 4, True],
                               [0.005, 0.0025, 4, True],
                               [0.0075, 0.0025, 4, True],
                               [0.01, 0.0025, 3, True],
                               [0.0125, 0.0025, 2, True],
                               [0.015, 0.0024999999999999988, 2, True]],
                     'failures': 0,
                     't': 0.015,
                     'contact_line': 0.49550444898076185,
                     'kappa': 3.0924039011398503,
                     'kappa_exact': 2.0,
                     'area': 0.3931970376752592,
                     'u_max': 0.12789191175750075,
                     'x_norm': 763.9169753154079,
                     'x_max': 344.44194911172457,
                     'x_samples': [0.0, -0.07476602546347247,
                                   -0.19655006471395398, 0.8958273042004467,
                                   -0.00208067882158031, 0.3086195913203494,
                                   -0.013075661452440497, 0.005664487929362847,
                                   -0.005308771339697992,
                                   -9.171870360673012e-15, -0.7780255514449175,
                                   1.9424541185905142, 0.05005635860261028,
                                   -0.00205928732232194,
                                   -2.5999570187593996e-20,
                                   -0.005886520231005153, 0.001610602831872836,
                                   0.0024724773609600364, 0.8932892413701912,
                                   0.0001459416408741841,
                                   -0.0006768166431449392,
                                   0.013656388537252828, 0.6556338286780726,
                                   0.7103203978888153]}},
 'small': {'distng_stefan': {'newton': 15, 'reading': [0.5000000000032766]},
           'ls_wall_angle': {'newton': 0, 'reading': [0.07868934781213137]},
           'ls_ca_h': {'newton': 0, 'reading': [0.0]},
           'ls_attach': {'newton': 0, 'reading': [0.011278718158903155, 0.0]},
           'ls_q_source': {'newton': 1, 'reading': [0.7053950771122649]},
           'ls_qrad': {'newton': 1, 'reading': [0.6999999999999973]},
           'ls_recoil': {'newton': 1, 'reading': [2.5013154841144285]},
           'csf_div_n': {'newton': 2,
                         'reading': [2.123790635159185, 0.003403115026941648]},
           'csf_div_s_n': {'newton': 2,
                           'reading': [2.079814917464353,
                                       0.001886557396403663]},
           'csf_hysing': {'newton': 3,
                          'reading': [2.0864736060842826,
                                      0.0018961750374382267,
                                      0.0018989559856658718]},
           'csf_denner': {'newton': 1,
                          'reading': [2.0860847989279763,
                                      0.0018914724941418164]},
           'csf_denner_normal': {'newton': 2,
                                 'reading': [2.086085747376585,
                                             0.0018914850349519034]},
           'ls_latent_heat': {'newton': 0, 'reading': [3.99416094176596]},
           'extv_callable': {'newton': 1, 'reading': [1.0]},
           'extv_kinematic': {'newton': 1, 'reading': [1.0]},
           'extv_latent': {'newton': 1, 'reading': [-0.07]},
           'fill_ext_v': {'newton': 2,
                          'reading': [0.10000000000000009,
                                      0.39999999999999997]},
           'velo_normal_ls': {'newton': 13,
                              'reading': [6.442300730536864e-06,
                                          0.20483316862257742,
                                          2.2608749027209717e-05,
                                          0.20483316862257742]},
           'velo_tangent_ls': {'newton': 2, 'reading': [0.7000000000000028]},
           'ls_adc': {'newton': 0,
                      'reading': [1.0, 8.0, 0.0, 0.0, 0.8972138009695755]},
           'surfdomain_mass_flux': {'newton': 1,
                                    'reading': [0.5999999999999992]},
           'sdc_stefan_flow': {'newton': 1, 'reading': [0.19999999999999996]},
           'sdc_numjac': {'newton': 0, 'reading': [336.0, 0.0]},
           'xfem_bubble': {'newton': 4,
                           'reading': [0.001188817063630705,
                                       0.00028071135443932484,
                                       2.041845299774548]},
           'ls_curvature_circle': {'newton': 1,
                                   'reading': [0.010800342178558653,
                                               0.0830205811821817]},
           'power_law_slip': {'newton': 6,
                              'reading': [1.0, 1.0000000000000007]},
           'electrokinetic_slip': {'newton': 1,
                                   'reading': [-5.853658536585392]},
           'level_set_slip': {'newton': 4, 'reading': [1.0, 1.0]},
           'slip_heating': {'newton': 2, 'reading': [0.15624999999999858]},
           'qvapor_slab': {'newton': 6, 'reading': [300.145006263686]},
           'laser_weld': {'newton': 1, 'reading': [8.24817230354014]},
           'ls_embedded_dirichlet': {'newton': 2,
                                     'reading': [1.9999994484401094]},
           'ls_flow_pressure': {'newton': 3, 'reading': [2.5007192075593125]},
           'latent_heat_internal': {'newton': 1,
                                    'reading': [0.24999999999999728]},
           'species_kinematic': {'newton': 1,
                                 'reading': [0.11538461538461575]},
           'air_film_slip': {'newton': 6, 'reading': [6.500996977365337]}}}
# x at 24 dofs against goma_tpu's rung and its float64 solution, relative
# to max |x|; each deck's readings, relative
LS_X_RTOL = 1e-6
LS_READ_RTOL = 1e-6
# the small decks: readings against goma_tpu's, relative; x between the
# card and the CPU, relative to 1 + |x|
LS_SMALL_RTOL = 1e-8
LS_SMALL_X_TOL = 1e-8


def ls_namespace(device):
    """scripts/ls_decks.py's namespace for the port on ``device``."""
    from scripts import ls_decks

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    return ls_decks.namespace("goma_tpu_torch", torch, arr, device=device)


def ls_deck(deck):
    """(build, time options, outputs, max_iter) of the melt pool or the
    wetting drop."""
    from scripts import ls_decks as ld

    if deck == "melt":
        return ld.melt_pool, ld.melt_time, ld.melt_outputs, ld.MELT_MAX_ITER
    return ld.wetting_drop, ld.drop_time, ld.drop_outputs, ld.DROP_MAX_ITER


def ls_setup(deck, dev):
    """The 96x48 laser melt pool or wetting drop on the card, checked
    against goma_tpu's dof and nnz counts. Returns (problem, x0,
    params)."""
    t0 = time.perf_counter()
    ref = LS_REF[deck]
    prob, x0, params = ls_deck(deck)[0](ls_namespace(dev), LS_NX, LS_NY)
    what = ("Navier-Stokes Q2/Q1 + energy + SUPG fill (Q2), Hysing CSF, "
            "embedded laser and vapor fluxes, Kanouff recoil, latent heat, "
            "level-set slip and gas-outlet walls" if deck == "melt" else
            "Navier-Stokes Q2/Q1 + XFEM pressure (Q1) + SUPG fill (Q2) + "
            "solved normal (Q1) with div-n CSF + solved curvature (Q1), "
            "wall angle, level-set slip, curvature wall terms")
    log(f"{deck} setup: {LS_NX}x{LS_NY} QUAD9, {what}, {prob.dofmap.n_dof} "
        f"dof (goma_tpu {ref['n_dof']}), {prob.pattern.nnz} nnz (goma_tpu "
        f"{ref['nnz']}); {time.perf_counter() - t0:.2f} s")
    if (prob.dofmap.n_dof, prob.pattern.nnz) != (ref["n_dof"], ref["nnz"]):
        raise RuntimeError(f"{deck} deck: dof or nnz count differs from "
                           "goma_tpu's")
    return prob, x0, params


def ls_tree(prob, solver, label, direct, x0, params, dt):
    """The kernels on the deck's tree at the CSR values the rung's first
    factorization sees: the first backward-Euler step's Jacobian at its
    predictor ``x0`` (ct = 1/dt, the history -ct x0; the steady Jacobian
    at x0, which no step factors, has thousands of boosted pivots)."""
    xt = torch.as_tensor(np.asarray(x0), dtype=prob.dtype, device="cuda")
    p = dict(params)
    p["ct"] = torch.tensor(1.0 / dt, dtype=prob.dtype, device="cuda")
    p["hist"] = -p["ct"] * xt
    p["time"] = torch.tensor(dt, dtype=prob.dtype, device="cuda")
    if direct:
        vals = solver._prepare(xt, p)[1]
    else:
        vals = solver._scaled_vals(xt, p, solver._prepare_fast32(xt, p)[2])
    return shell_tree(prob, solver, label, direct, vals, at="first step")


def ls_phase(dev, deck, kind, setup=None):
    """Phase 60 (``deck`` "melt") or 61 ("drop"): the 96x48 deck on
    ``kind`` under the transient driver, ``ls_decks``' backward-Euler steps
    without adaptation, bench._cavity_opts(kind, tol=1e-9, max_iter=12)
    restated. Gates: the tree against goma_tpu's before any solve; every
    kept step's (t, dt, Newton) goma_tpu's on ``tpu_direct`` (Newton +-1
    on ``gmres+ndlu``); x at 24 dofs within LS_X_RTOL of max |x| from
    goma_tpu's rung and its float64 solution; each reading within
    LS_READ_RTOL; the launch identities (counts set to 0 just before the
    run and read just after); the kernels on the first step's Jacobian
    before the run (``ls_tree``: on ``tpu_direct`` the substitutions of
    one solve, timed) and the front LU and the gather on the run's first
    and last factorization. Logs s/iter, the asm and slv buckets and a
    factorization's split."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather
    from goma_tpu_torch.solvers.transient import TransientSolver
    from scripts import ls_decks as ld

    phase = 60 if deck == "melt" else 61
    label = f"{deck} {kind}"
    t_phase = time.perf_counter()
    rec = LS_REF[deck]
    ref = rec[kind]
    prob, x0, params = setup if setup is not None else ls_setup(deck, dev)
    _, time_opts, outputs, max_iter = ls_deck(deck)
    direct = kind == "tpu_direct"
    P = ls_namespace(dev)
    ts = TransientSolver(prob, (direct_opts if direct else cavity_opts)(
        tol=1e-9, max_iter=max_iter), time_opts(P))
    sv = ts.newton
    nd, tree = ls_tree(prob, sv, label, direct, x0, params, ts.topts.dt0)
    check_ref_levels(nd, ref, label)
    seen = record_factor_vals(nd)
    sv.reset_lagged()
    sv.n_factor = sv._ndlu_nfactor = sv.n_discarded = 0
    sv.direct_log = []
    if sv._ndlu is not None:
        sv._ndlu.n_solve = 0
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    per_step = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ts.run(x0, params, callback=lambda t, x, xdot, res: per_step.append(res))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = {"lu": batched_lu.launches, "trsv": batched_trsv.launches,
          "gather": front_gather.launches}
    check_launches(sv, ln, len(nd.levels), label, direct=direct)
    steps = ld.step_records(r)
    nit = sum(s[2] for s in steps if s[3])
    asm = sum(x.assembly_time for x in per_step)
    slv = sum(x.solve_time for x in per_step)
    for s, x in zip(r.steps, per_step):
        log(f"{label} step t={s.t:.4f} dt={s.dt:.4g}: Newton "
            f"{s.newton_iters}, linear {x.linear_iters}")
    log(f"{label}: {len(steps)} steps to t = {r.t:.4f}, {nit} Newton "
        f"iterations (goma_tpu {sum(s[2] for s in ref['steps'] if s[3])}), "
        f"factorizations {sv.n_factor + sv._ndlu_nfactor}, launches front-LU "
        f"{ln['lu']} front-gather {ln['gather']} substitution {ln['trsv']}; "
        f"asm {asm / max(nit, 1) * 1e3:.1f} ms + slv "
        f"{slv / max(nit, 1) * 1e3:.1f} ms per iteration, "
        f"{sec / max(nit, 1):.4f} s/iter (total {sec:.3f} s)")
    rs = ref["steps"]
    ok = (len(steps) == len(rs) and r.n_failures == ref["failures"]
          and all(abs(a[0] - b[0]) <= 1e-9 * b[0] and a[1] == b[1] and a[3]
                  for a, b in zip(steps, rs))
          and all((a[2] == b[2]) if direct else abs(a[2] - b[2]) <= 1
                  for a, b in zip(steps, rs)))
    if not ok:
        raise RuntimeError(f"{label}: step records {steps} (failures "
                           f"{r.n_failures}) are not goma_tpu's {rs} "
                           f"(failures {ref['failures']})")
    if r.x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(r.x)):
        raise RuntimeError(f"{label}: the end state has the wrong shape or "
                           "non-finite values")
    dx = float(np.abs(np.subtract(ld.readings(r.x)["x_samples"],
                                  ref["x_samples"])).max() / ref["x_max"])
    d64 = float(np.abs(np.subtract(ld.readings(r.x)["x_samples"],
                                   rec["direct"]["x_samples"])).max()
                / rec["direct"]["x_max"])
    out = outputs(P, prob, r.x)
    dread = {k: abs(v - ref[k]) / max(abs(ref[k]), 1e-300)
             for k, v in out.items()}
    log(f"{label}: x at 24 dofs max |dx| / max |x| {dx:.2e} from goma_tpu's "
        f"rung, {d64:.2e} from its float64 solution; readings "
        + ", ".join(f"{k} {v:.10g} (goma_tpu {ref[k]:.10g}, {dread[k]:.1e})"
                    for k, v in out.items()))
    if max(dx, d64) > LS_X_RTOL:
        raise RuntimeError(f"{label}: x {dx:.2e} / {d64:.2e} from goma_tpu's "
                           f"> {LS_X_RTOL:.0e}")
    if max(dread.values()) > LS_READ_RTOL:
        raise RuntimeError(f"{label}: readings {dread} from goma_tpu's > "
                           f"{LS_READ_RTOL:.0e}")
    del nd.factor  # record_factor_vals's wrapper
    # the run's first factorization is the first step's, held before the
    # run (checked_before skips it where the values are equal); the front
    # LU and the gather on the last one, whose substitutions repeat the
    # first step's gates on a factor of the same tree
    shell_kernels_after(nd, seen, tree, label, False, prob)
    log(f"phase {phase} ({label}): {sec / max(nit, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"setup": (prob, x0, params), "launches": ln, **tree}


def ls_small_phase(devices=("cuda", "cpu")):
    """Phase 62: goma_tpu's tests' decks of the slice (``ls_decks.SMALL``:
    tests/test_ls_embedded_bc.py, test_ls_cap_variants.py,
    test_ext_velocity.py, test_ls_velo_bc.py with ``apply_ls_adc`` on a
    fixed seed, test_surface_domain.py, test_ls_round2.py's XFEM bubble,
    test_level_set.py's curvature circle, test_bc_catalog3.py's slip, vapor,
    laser, embedded Dirichlet and flow-pressure decks,
    test_acoustic_bc.py's latent heat, test_electrode_ni.py's kinematic
    species, test_bc_traction.py's air film) at their own sizes on their
    own solvers, on cuda and cpu (the CPU half in the child process): each
    deck's own gate, goma_tpu's Newton count, the readings within
    LS_SMALL_RTOL on the card, and the same Newton count and x within
    LS_SMALL_X_TOL on both devices."""
    from scripts import ls_decks as ld

    t0 = time.perf_counter()
    check_small_decks("ls small", "ls", ld.SMALL, ls_namespace, LS_REF["small"],
                      LS_SMALL_RTOL, LS_SMALL_X_TOL, devices)
    log(f"phase 62 (small level-set and fluid-condition decks on "
        f"{' and '.join(devices)}): {time.perf_counter() - t0:.1f} s")


def check_small_decks(label, group, decks, namespace, ref, rtol, x_tol,
                      devices):
    """Every deck of ``decks`` (goma_tpu's tests' decks) on each of
    ``devices`` (the CPU's from the child's ``group`` runs, ``cpu_runs``):
    its own gate inside, goma_tpu's count (``ref``), the readings within
    ``rtol`` of goma_tpu's on the first device, the same count and x within
    ``x_tol`` (of 1 + |x|) on every device."""
    runs = {d: (cpu_runs(group, lambda: small_deck_runs(
        decks, namespace(torch.device("cpu"))))
        if d == "cpu" else small_deck_runs(decks,
                                           namespace(torch.device(d))))
        for d in devices}
    for name in decks:
        r = ref[name]
        outs = {d: runs[d][name] for d in devices}
        out = outs[devices[0]]
        dv = float(np.max(np.abs(np.subtract(out["reading"], r["reading"]))
                          / np.maximum(np.abs(r["reading"]), 1e-300)))
        dx = max(float(np.max(np.abs(o["x"] - out["x"])
                              / (1.0 + np.abs(out["x"]))))
                 for o in outs.values())
        log(f"{label} {name}: Newton " + ", ".join(
            f"{d} {o['newton']}" for d, o in outs.items())
            + f" (goma_tpu {r['newton']}), reading {out['reading']} "
            f"(relative {dv:.2e}), x {devices} max |dx| / (1 + |x|) "
            f"{dx:.2e}; " + ", ".join(f"{d} {o['seconds']:.2f} s"
                                      for d, o in outs.items()))
        if any(o["newton"] != r["newton"] for o in outs.values()):
            raise RuntimeError(f"{label} {name}: Newton counts "
                               f"{[o['newton'] for o in outs.values()]} vs "
                               f"goma_tpu's {r['newton']}")
        if not dv <= rtol:
            raise RuntimeError(f"{label} {name}: reading {dv:.2e} from "
                               "goma_tpu's")
        if not dx <= x_tol:
            raise RuntimeError(f"{label} {name}: x {dx:.2e} between devices")


def ls_phases(dev):
    """Phases 60-62 in order: the melt pool on both rungs, the wetting drop
    on both rungs, the small decks on cuda and cpu. Returns the four main
    paths' records (melt ``gmres+ndlu`` and ``tpu_direct``, drop
    ``gmres+ndlu`` and ``tpu_direct``)."""
    t_ls = time.perf_counter()
    mg = ls_phase(dev, "melt", "gmres+ndlu")
    md = ls_phase(dev, "melt", "tpu_direct", mg.pop("setup"))
    dg = ls_phase(dev, "drop", "gmres+ndlu")
    dd = ls_phase(dev, "drop", "tpu_direct", dg.pop("setup"))
    for rec in (md, dd):
        rec.pop("setup")
    ls_small_phase()
    log(f"phases 60-62 (fluid and level-set conditions): "
        f"{time.perf_counter() - t_ls:.1f} s; {mem_line()}")
    return mg, md, dg, dd


# ---- phases 63-65: derived fields, particle tracing, the projection and
# segregated drivers (scripts/split_decks.py)
SPLIT_PROJ_N, SPLIT_SEG_N = 96, 48
# python3 scripts/split_reference.py --part projection / --part segregated
# / --part small (goma_tpu on a CPU; float64 state and Jacobian, float32
# NDLU factors)
SPLIT_REF = json.loads("""\
{"projection": {"n": 96, "steps": 20, "dt": 0.05, "n_dof": {"ustar": 74498,
"pphi": 9409}, "direct": {"newton": {"ustar": [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
1, 1, 1, 1, 1, 1, 1, 1, 1], "pphi": [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
1, 1, 1, 1, 1, 1]}, "t": 1.0000000000000002, "kinetic_energy":
0.023110024509045896, "div_max": 216.2356932423257, "vortex_node": 30811,
"vortex_x": 0.6458333333333333, "vortex_y": 0.828125, "psi_vortex":
-0.0731569950877464, "vorticity_vortex": -3.5208392258902634, "moving_share":
0.8936884211656688, "x_max": 3.6165096126587284, "gate_nodes": [1052, 3748,
5687, 7418, 9037, 10621, 12150, 13673, 15184, 16679, 18174, 19650, 21129,
22606, 24075, 25539, 27000, 28464, 29927, 31397, 32861, 34322, 35785, 37247],
"gate": [-0.01000154449878515, -0.02878218564673839, -0.039518388627445285,
-0.04504879593531844, -0.01939642096541168, -0.001016270025701827,
-0.0020026312936681683, -0.024924664524642155, -0.07662511653616548,
-0.08678407173414626, -0.034878449235331885, -0.07768085780362549,
-0.1300254318649831, -0.037104818857002654, -0.1859267593973272,
-0.12349902654996357, -0.115697718259497, -0.11298598795994134,
-0.03558274683912829, 0.053037042975211925, 0.04952207956056455,
0.30278557357547137, 0.6702862632187904, 1.0, 0.0001341096164004353,
0.0022445821792828123, 0.0023165230662524792, 0.0059810582766263234,
-0.024885746459774937, 0.009968810049841811, -0.016151357194822507,
-0.05050644769907007, -0.04208802375305209, 0.030441799541663376,
0.07746256130294939, -0.11559041224778366, 0.03215246730796555,
0.11495245980964343, -0.12893870805927335, 0.10962502449361118,
-0.29792060378186497, 0.06094116379496041, 0.18205319133521985,
-0.01710017730233011, 0.10840758233285813, -0.11258929465376478,
0.007276735593850555, 0.0, 0.004366416596913594, 0.0036776047493763475,
0.004778452398540026, 0.0037268831718659094, 0.012998204662596873,
-0.0008802362230122826, 0.013287636767596653, 0.015518251309218271,
0.011764233490024794, -0.0027994338121515813, -0.011204944957516068,
0.02193114078330323, -0.008411874390504078, -0.023116849913752877,
0.013966251064678836, -0.030736458230668274, 0.05061190389020897,
-0.03527500497655909, -0.06929704128075498, -0.03064786212361409,
-0.05962779782455872, 0.0724788220783286, -0.042335991726441105,
2.8977675855786567]}, "gmres+ndlu": {"newton": {"ustar": [2, 3, 3, 3, 3, 3, 3,
3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3], "pphi": [2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
2, 2, 2, 2, 2, 2, 2, 2, 2, 2]}, "t": 1.0000000000000002, "kinetic_energy":
0.023110024508305804, "div_max": 216.23569323706994, "vortex_node": 30811,
"vortex_x": 0.6458333333333333, "vortex_y": 0.828125, "psi_vortex":
-0.0731569950846258, "vorticity_vortex": -3.520839225382769, "moving_share":
0.8936884211656688, "x_max": 3.6165096124463285, "gate_nodes": [1052, 3748,
5687, 7418, 9037, 10621, 12150, 13673, 15184, 16679, 18174, 19650, 21129,
22606, 24075, 25539, 27000, 28464, 29927, 31397, 32861, 34322, 35785, 37247],
"gate": [-0.01000154449785468, -0.028782185643528007, -0.03951838862216984,
-0.045048795929054364, -0.019396420962136434, -0.0010162700255934038,
-0.0020026312932608665, -0.024924664518589854, -0.07662511652247461,
-0.08678407172458918, -0.034878449233490365, -0.07768085780093342,
-0.13002543186297508, -0.03710481885648728, -0.1859267593992757,
-0.12349902655276865, -0.11569771824250481, -0.1129859879792453,
-0.035582746845566136, 0.05303704295319027, 0.049522079562016735,
0.3027855735382268, 0.6702862631950453, 1.0, 0.00013410961640070447,
0.00224458217880711, 0.002316523065565236, 0.005981058275134678,
-0.02488574645579689, 0.009968810049057123, -0.01615135719302728,
-0.05050644768959502, -0.04208802374742218, 0.03044179953343153,
0.07746256129534228, -0.11559041222961121, 0.03215246730205939,
0.1149524598020692, -0.1289387080223196, 0.1096250244819144,
-0.29792060381160546, 0.060941163801519004, 0.18205319134389525,
-0.01710017727981221, 0.10840758232910973, -0.11258929465169887,
0.007276735593709431, 0.0, 0.0043664164912020015, 0.0036776046431055208,
0.004778452292704097, 0.0037268830662452682, 0.01299820455730389,
-0.0008802363297605025, 0.013287636663577306, 0.015518251203818964,
0.011764233384940198, -0.0027994339169401436, -0.011204945064878073,
0.021931140680136515, -0.008411874492003842, -0.02311685001860122,
0.01396625095768478, -0.03073645833376477, 0.0506119037815162,
-0.03527500507947348, -0.06929704138456658, -0.030647862230758563,
-0.059627797927924386, 0.07247882198763594, -0.04233599181578558,
2.897767585360448], "levels": {"ustar": [[410, 174], [256, 192], [128, 76],
[64, 108], [32, 106], [16, 188], [8, 188], [4, 334], [2, 372], [1, 642]],
"pphi": [[62, 161], [32, 186], [16, 34], [8, 35], [4, 52], [2, 58], [1,
110]]}}, "tpu_direct": {"newton": {"ustar": [1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
2, 2, 2, 2, 2, 2, 2, 2, 2], "pphi": [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
1, 1, 1, 1, 1, 1]}, "t": 1.0000000000000002, "kinetic_energy":
0.02311002450905376, "div_max": 216.23569324230627, "vortex_node": 30811,
"vortex_x": 0.6458333333333333, "vortex_y": 0.828125, "psi_vortex":
-0.07315699508772476, "vorticity_vortex": -3.5208392258611183, "moving_share":
0.8936884211656688, "x_max": 3.6165096125269525, "gate_nodes": [1052, 3748,
5687, 7418, 9037, 10621, 12150, 13673, 15184, 16679, 18174, 19650, 21129,
22606, 24075, 25539, 27000, 28464, 29927, 31397, 32861, 34322, 35785, 37247],
"gate": [-0.010001544498785602, -0.028782185646842304, -0.0395183886276814,
-0.0450487959355196, -0.019396420965477525, -0.0010162700256744304,
-0.0020026312936562004, -0.024924664524621443, -0.07662511653614643,
-0.08678407173419729, -0.03487844923535504, -0.07768085780375784,
-0.13002543186507456, -0.037104818856996014, -0.18592675939744271,
-0.12349902655008538, -0.11569771826055325, -0.11298598796005867,
-0.03558274683912414, 0.05303704297555089, 0.049522079560624765,
0.302785573574603, 0.6702862632188663, 1.0, 0.00013410961645790766,
0.0022445821793818485, 0.0023165230663264023, 0.005981058276583926,
-0.024885746459828967, 0.009968810049911748, -0.016151357194829127,
-0.05050644769915849, -0.0420880237531022, 0.03044179954162037,
0.07746256130283974, -0.11559041224789968, 0.032152467307961126,
0.11495245980960088, -0.12893870805950922, 0.10962502449362196,
-0.29792060378157326, 0.060941163794976494, 0.18205319133521058,
-0.01710017729878341, 0.10840758233288915, -0.11258929464932009,
0.007276735593878125, 0.0, 0.0043664164631307, 0.0036776046155897455,
0.004778452264741147, 0.003726883038099992, 0.012998204528539475,
-0.0008802363563543662, 0.013287636633822214, 0.015518251175388215,
0.01176423335496489, -0.002799433946031373, -0.011204945090890596,
0.021931140649216963, -0.008411874524218516, -0.023116850047444765,
0.013966250930750395, -0.0307364583640359, 0.05061190375676434,
-0.03527500511033281, -0.06929704141429421, -0.03064786225882138,
-0.05962779795831243, 0.07247882194498295, -0.042335991860535264,
2.897767585446234], "levels": {"ustar": [[410, 174], [256, 192], [128, 76],
[64, 108], [32, 106], [16, 188], [8, 188], [4, 334], [2, 372], [1, 642]],
"pphi": [[62, 161], [32, 186], [16, 34], [8, 35], [4, 52], [2, 58], [1,
110]]}}}, "segregated": {"n": 48, "relax": 0.8, "tol": 1e-08, "n_dof": {"flow":
21219, "temperature": 9409, "species": 9409}, "coupled": {"newton": 7, "T":
[1.0, 0.41016772800286005, 0.24056390025360486, 0.1854524970104904,
0.09885948769549058, 0.7172636376299895, 0.34746286754382905,
0.3350338556199232, 0.3264586178160453, 0.07590599404191005,
0.5974409473205475, 0.4769245278952084, 0.5234213033253037, 0.4199669622462824,
0.9429955052799186, 0.680036800336608, 0.665382753323857, 0.6578458216527908,
0.31538338435125085, 0.9086418047118696, 0.8179879845416517, 0.763091087552916,
0.6049854090437181, 0.0], "ux": [0.0, -5.988713830721165, -11.870680138905168,
-14.006841446117056, -4.6199593757978334, -2.8981722702482804,
-12.071596680734384, -12.16939843875866, -7.86481081571686,
-0.6112045272411224, -0.9512368298755433, -1.688853909641683,
1.6926881391302113, 1.1689456980969817, 0.3639053169733528, 7.6741898240070086,
12.130304653357703, 12.324157247980775, 3.50175140394443, 4.031188213712846,
13.76315955848027, 11.962085117296898, 6.073819594689734, 0.0], "uy": [0.0,
0.15269463297695052, 0.4373244096836095, -1.5322932661397368,
-6.779700118697807, 11.659206107614317, 4.279967929834656, 0.20140070801050092,
-10.853583424031047, -10.11340250866239, 17.254069712331088, 4.114609975008286,
-3.695154482221671, -16.536700199528475, 8.061305915654616, 11.50889685199941,
0.10950563510473175, -4.036931518459551, -11.596571489485795,
6.613543163746993, 1.739690289935271, -0.43273021249598287,
-0.1253846180547542, 0.0], "T_max": 1.0, "u_max": 19.671760324306064},
"tracers_rungs": 3.531204217921413e-10, "gmres+ndlu": {"outer": 16, "newton":
{"flow": [3, 5, 5, 4, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 1], "temperature": [2,
4, 3, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 0], "species": [2, 4, 3, 3, 3, 3, 3,
2, 2, 2, 2, 1, 1, 1, 1, 0]}, "levels": {"flow": [[126, 174], [64, 187], [32,
62], [16, 92], [8, 93], [4, 187], [2, 120], [1, 243]], "temperature": [[64,
156], [32, 27], [16, 39], [8, 39], [4, 79], [2, 48], [1, 97]], "species": [[64,
156], [32, 27], [16, 39], [8, 39], [4, 79], [2, 48], [1, 97]]}, "flow":
{"x_max": 8250.534618356418, "x_samples": [0.0, -5.772849927399219,
993.341046486033, -14.865713403756708, -6.523930483566392, 1942.2510170467874,
-10.491515876018722, -12.223797447410135, -11.508896852423318, 0.0,
-1.6247261836683984, 3.6951544891371553, 1.692688113112363, 1.6247261836673712,
4383.465393632406, 12.152843459241305, 12.223797447409446, 10.491515876018022,
0.0, 6489.796564923339, 0.5984693041241067, -0.4322899757922819,
5.772849927399756, 7099.9999984501965]}, "temperature": {"x_max":
0.999999999966638, "x_samples": [0.999999999966638, 0.4101677257674453,
0.24056389894828817, 0.18545249591210738, 0.09885948767158169,
0.7172636374352628, 0.3474628673429157, 0.3350338542376031, 0.3264586172063493,
0.0759059943672114, 0.5974409474810315, 0.47692452874946967,
0.5234213024949752, 0.41996696201056005, 0.9429955049983777, 0.680036800801966,
0.6653827547161115, 0.6578458218414596, 0.3153833845550095, 0.9086418046793563,
0.8179879855710115, 0.7630910888289533, 0.6049854111972942, 0.0]}, "species":
{"x_max": 0.999999999966638, "x_samples": [0.999999999966638,
0.4101677257674453, 0.24056389894828817, 0.18545249591210738,
0.09885948767158169, 0.7172636374352628, 0.3474628673429157,
0.3350338542376031, 0.3264586172063493, 0.0759059943672114, 0.5974409474810315,
0.47692452874946967, 0.5234213024949752, 0.41996696201056005,
0.9429955049983777, 0.680036800801966, 0.6653827547161115, 0.6578458218414596,
0.3153833845550095, 0.9086418046793563, 0.8179879855710115, 0.7630910888289533,
0.6049854111972942, 0.0]}, "vs_coupled": {"T": 2.2354147422021242e-09, "u":
2.3285078329728204e-09}, "derived": {"VORTICITY": {"max": 425.6864522891912,
"at": [-2.365569451651802, 102.0436221552426, 88.76320392897358,
12.829979921880396, 15.98980327113625, -10.318954796360405, -57.52044983684444,
-82.17016670027698, -103.80301148291667, 180.86738988941374,
-101.9999701580968, -103.43600902357053, -102.01947470224835,
-108.33065185738833, 210.79255376926648, -101.20403243723486,
-83.87187444093414, -55.4265600491793, -28.441352665447738, 21.630583593138414,
11.332861094992957, 88.86581027597002, 105.67110272857512,
-2.365569451655505]}, "SHEAR_RATE": {"max": 425.45814462759495, "at":
[-1.8858906538288387, 109.073028616671, 91.00841954923617, 68.4469683630935,
114.95885508090366, 114.35334434392911, 51.12448606157272, 25.02173890503493,
41.68819653109603, 190.89966796018012, 51.942070037119116, 21.165121838407828,
23.235640560875275, 54.18316712052926, 216.78107966510075, 45.115652100346196,
24.04630534346681, 47.83045050426956, 117.74455541593618, 112.85341308313878,
71.29907395954814, 91.68701505628181, 111.13032480979956,
-1.8858906538290248]}, "DIV_VELOCITY": {"max": 0.6311993564131299, "at":
[0.0018887121204322862, -0.04025596780365869, 0.010087384449019134,
-0.025189166747993187, 0.038077265749494625, -0.13444111366646475,
-0.01073342803538838, 0.0032082312716322325, 0.00921887274761313,
0.1486287098533863, -0.0380896849431101, -0.005409050827177224,
0.007409910771569666, 0.028468234737514777, -0.07369893023228818,
-0.016645759804309435, -0.00035355957559070637, 0.005045785813470293,
0.0471976770631729, -0.05935085815334035, -0.03612993675862579,
0.02291382370484393, 0.002814671516002975, 0.0018887119855624792]},
"PRESSURE_NODAL": {"max": 8250.534618356418, "at": [5.620504062164854e-16,
592.5729665013715, 1024.5839721739778, 1427.3225216000712, 1787.086382657574,
1771.2044843985755, 1955.343605192955, 2200.1437678129696, 2532.8603685334024,
2877.575697889313, 3112.2160862418064, 3298.147151815837, 3592.1854385539,
3992.4031214438905, 4501.172511355236, 4759.799642017031, 5013.143174825302,
5356.205991762576, 5760.351528126299, 6522.240528463118, 6763.272618128922,
6949.532200060945, 7113.095654270412, 7099.999998450196]}, "STRESS_TENSOR":
{"max": 302.07647522894604, "at": [0.3438275748236864, -0.013461313449909614,
-0.34114560361267254, -12.521863258108302, -76.51414902977812,
12.464699783827111, -12.757453967147553, -63.36198436683616, 12.77177805306516,
31.589789696821345, -36.98704530181757, -31.625558313603495, 81.38895049972487,
7.109580962132475, -81.33488078236057, -81.1236904190491, 10.371270030313946,
80.9327840376427, -35.79328959070318, 5.974936098772594, 35.778048122892926,
4.8056394529841455, 17.123857060635036, -4.801083764578427, 24.908759628304907,
-15.982513383495647, -24.895668829003295, 37.366846208712126,
130.4928724181508, -37.15579344072032, -29.168073358499406,
-22.645101598279343, 29.11398600588019, -1.217832508861467, 14.966350884235094,
1.2101516566868755, 0.17716487891543625, 16.520944102970383,
-0.1666428056198073, -30.236343378402616, -23.78279638536009,
30.276768271729885, 29.99596228223361, 150.86687257902858, -30.10061476316346,
27.05055195107372, -17.12546855691296, -27.07418892999584, 5.8507814269172655,
16.026970359882146, -5.851283481514604, -33.04454420782366, 7.942376030848,
33.05170922367879, -83.42886199102868, -0.05015146228592238, 83.49588269245841,
79.23525428989726, 11.49711872667022, -79.31953250847499, 34.97405341766563,
-36.71121241926008, -35.02535792786287, -12.240118196145584,
-63.94829466413631, 12.27265582580646, -10.559883111914926, -78.27425054696566,
10.56387994546765, 0.3438275747381061, -0.013461313525542569,
-0.3411456037186073]}, "SPEED": {"max": 19.67517633570808, "at":
[-0.002214287121778176, 6.023223344931183, 11.904459155408992,
14.106796804026938, 8.207115852489071, 12.048319053842903, 12.805747514971216,
12.169002928309954, 13.403162999445996, 10.187776297791636, 17.295466857663484,
4.4344324618384965, 4.044331479110031, 16.57714621861749, 8.0388381193835,
13.831377632827474, 12.128740375708098, 12.96724390877209, 12.100014744865845,
7.7415184820756275, 13.894495435529075, 11.994881525992307, 6.111060369570835,
-0.002214287121503427]}, "KINETIC_ENERGY": {"max": 193.5484846743311, "at":
[0.00031982750727085527, 17.88615305568145, 70.67829313826012,
99.47607851120766, 33.585846835977044, 72.59542656585533, 82.00175920488829,
74.07273050232845, 89.84153352024228, 51.142488861316416, 149.47034530922565,
9.835858005470424, 8.13499998456676, 137.44545402228852, 32.80675415171577,
95.61741263030697, 73.58401581917907, 84.07624444069668, 73.23495511188139,
29.935668581841647, 96.48952386404694, 71.75948228118433, 18.403799372238087,
0.00031982750726998764]}, "ENERGY_FLUX": {"max": 3.5322694173371465, "at":
[3.3758670912207793, -6.229880095116643e-05, 1.5090567206624323,
0.22453120995838532, 0.35659625653995314, -0.09515258164059595,
0.3256762941726469, -0.4381969684420783, 0.7110767643469188,
-0.39010910243323244, 3.1895898819200403, -0.1389498925149762,
0.5416726198804076, -0.475277165565985, 0.03751580165341128,
-0.819416071556702, 0.5953296176613337, -0.9365013412361232,
1.8112495360144636, -0.2147180623274887, 1.7325177435287966,
-0.6421847733448452, 0.04728961256293471, -0.8232003070145578,
0.018914060366807015, -0.8238352249945952, 1.6104141985914058,
-0.6622592240792198, 1.8180432408507277, -0.16113698917310582,
0.6518267275341897, -0.9270338877957106, 0.04254982801069961,
-0.8318770968117266, 0.47786891699145245, -0.48671512630724545,
3.0785478227504584, -0.15318539760302424, 0.7283731893161982,
-0.3604824011059289, 0.3349785323808613, -0.4425775313808151,
0.345398001051687, -0.10512169584198745, 1.400699899221075,
0.21426424126107943, 3.375867091218713, -6.229880083065288e-05]}, "DENSITY":
{"max": 1.0000000000000002, "at": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
0.9999999999999999, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
1.0, 1.0, 1.0, 1.0, 1.0]}, "VISCOSITY": {"max": 0.7100000000000003, "at":
[0.7100000000000001, 0.7100000000000001, 0.71, 0.71, 0.71, 0.7100000000000001,
0.71, 0.71, 0.7100000000000002, 0.71, 0.7100000000000001, 0.7099999999999999,
0.7100000000000001, 0.71, 0.71, 0.7099999999999999, 0.7099999999999999, 0.71,
0.71, 0.71, 0.7099999999999999, 0.7099999999999999, 0.71, 0.7099999999999999]},
"STREAM": {"max": 5.0736745876312215, "at": [0.0, -0.13664295924658487,
-0.5589371728152412, -1.1156489785632133, -0.5409951842630262,
-0.6763597698870356, -2.774447404791695, -3.8412572469184365,
-3.262070585916814, -0.22867752122612559, -2.5481374913537893,
-4.827224773255013, -4.867884429585229, -2.7241678723827256,
-0.13375241222256612, -3.145594601332361, -3.8417504045487005,
-2.8177423740627394, -0.7976326440021808, -0.47118539645462026,
-1.0986126393559263, -0.5634720373083629, -0.1380850172075774, 0.0]},
"NS_RESIDUALS": {"max": 1.3612465375291596, "at": [0.0, 0.0,
6.7763572531021055e-12, 0.2809835706773578, 7.451816941284051e-13,
0.08233741010999385, 1.2685408279367039e-12, 0.12692055138799674,
5.689670956599002e-12, 0.03384466143956022, -1.8840040638679056e-11,
0.4910598072733884, -3.837891738328879e-11, 0.47601206998445267,
-1.9184653865522705e-13, 0.22944273966530793, -3.934259110494207e-11,
0.4470358313605867, 1.4139800441625994e-12, 0.051997495496530544,
-1.1937117960769683e-11, 0.2044697548609431, -4.4024228706973645e-12,
0.3266069090759913, 1.007194327939942e-12, 0.179242274134646,
2.564670698035343e-11, 0.2875232447779439, -1.6237425759247932e-12,
1.2915350867276645, 1.5134560271690134e-11, 0.46560592220143665,
-4.3743148327313475e-12, 0.9113010988620008, 2.347633198951371e-11,
0.4505568578946754, 4.9507133719441305e-11, 0.43176222612391507,
-9.81356662599353e-12, 0.6222824956876849, -2.4158453015843406e-13,
0.2801071687859924, -3.91986443304404e-12, 0.5226016619827902,
-6.227907078937278e-12, 0.2072085628620357, 0.0, 0.0]}}, "tracers": {"end":
[0.33382645760283225, 0.8396487951679725, 0.6673204654860079,
0.731929883898053, 0.789982263813111, 0.6638486409560606, 0.8492308490222682,
0.7883482083976574, 0.26357815136815405, 0.7659226540639669,
0.48784808266807406, 0.6276917888702772, 0.6565113732979662,
0.4756057924484459, 0.8246511673560702, 0.3832793679432571,
0.17534883264390147, 0.6167206320567455, 0.34348862670204944,
0.5243942075515481, 0.5121519173318889, 0.37230821112970425,
0.7364218486317967, 0.23407734593603738, 0.15076915097774418,
0.21165179160226008, 0.2100177361868456, 0.33615135904395405,
0.3326795345139166, 0.2680701161019661, 0.6661735423971226, 0.160351204832037],
"alive": [true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true]}}, "tpu_direct": {"outer": 16, "newton": {"flow":
[2, 4, 4, 3, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1], "temperature": [1, 1, 2, 2,
2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0], "species": [1, 1, 2, 2, 2, 2, 1, 1, 1, 1,
1, 1, 1, 1, 1, 0]}, "levels": {"flow": [[126, 174], [64, 187], [32, 62], [16,
92], [8, 93], [4, 187], [2, 120], [1, 243]], "temperature": [[64, 156], [32,
27], [16, 39], [8, 39], [4, 79], [2, 48], [1, 97]], "species": [[64, 156], [32,
27], [16, 39], [8, 39], [4, 79], [2, 48], [1, 97]]}, "flow": {"x_max":
8250.534618624411, "x_samples": [0.0, -5.772849926156774, 993.3410465107054,
-14.865713404134901, -6.523930484664313, 1942.2510173142514,
-10.491515870621681, -12.22379744245935, -11.508896849920268, 0.0,
-1.6247261859834041, 3.695154489671672, 1.692688115782639, 1.6247261859832554,
4383.465394164377, 12.152843456537434, 12.223797442459292, 10.491515870621656,
0.0, 6489.796565141086, 0.5984693018081086, -0.4322899771530106,
5.772849926157184, 7099.999998463565]}, "temperature": {"x_max":
0.999999999967232, "x_samples": [0.999999999967232, 0.410167725964319,
0.2405638993023126, 0.1854524962790151, 0.09885948771416975,
0.7172636373901724, 0.3474628674587295, 0.33503385472210834,
0.3264586176631264, 0.07590599445841927, 0.5974409473445852,
0.4769245287422741, 0.5234213024959211, 0.4199669621344174, 0.942995504930463,
0.6800368003582009, 0.6653827542225432, 0.6578458217105407, 0.3153833845945929,
0.9086418046457707, 0.8179879852190124, 0.7630910884623838, 0.6049854110105966,
0.0]}, "species": {"x_max": 0.999999999967232, "x_samples": [0.999999999967232,
0.410167725964319, 0.2405638993023126, 0.1854524962790151, 0.09885948771416975,
0.7172636373901724, 0.3474628674587295, 0.33503385472210834,
0.3264586176631264, 0.07590599445841927, 0.5974409473445852,
0.4769245287422741, 0.5234213024959211, 0.4199669621344174, 0.942995504930463,
0.6800368003582009, 0.6653827542225432, 0.6578458217105407, 0.3153833845945929,
0.9086418046457707, 0.8179879852190124, 0.7630910884623838, 0.6049854110105966,
0.0]}, "vs_coupled": {"T": 2.0385410581802432e-09, "u":
2.0843821959449957e-09}, "derived": {"VORTICITY": {"max": 425.6864521296996,
"at": [-2.3655694501533806, 102.04362210500544, 88.76320392079963,
12.829979856671825, 15.989803236310312, -10.318954768112736,
-57.52044974021458, -82.17016672153191, -103.8030114487441, 180.86738985170422,
-101.99997009573077, -103.43600899313499, -102.01947467269653,
-108.33065179550299, 210.79255374192724, -101.20403240357521,
-83.87187446499372, -55.42655994734913, -28.44135262708893, 21.630583565882755,
11.332861027746796, 88.86581026587513, 105.67110267742345,
-2.365569450158588]}, "SHEAR_RATE": {"max": 425.4581444682503, "at":
[-1.8858906526319008, 109.07302857851091, 91.00841953542466, 68.44696831791343,
114.95885508151673, 114.35334426557957, 51.124486064986144, 25.021738877057274,
41.688196522068935, 190.8996679125589, 51.94207002513577, 21.16512183971584,
23.235640561713158, 54.18316710827232, 216.78107963186335, 45.11565208572879,
24.046305318933307, 47.83045051052247, 117.74455533140997, 112.85341308808285,
71.29907391559078, 91.68701504482867, 111.13032476823152,
-1.8858906526338628]}, "DIV_VELOCITY": {"max": 0.6311993559516575, "at":
[0.001888712091640462, -0.040255967913320194, 0.01008738445071401,
-0.025189166721351654, 0.03807726573178192, -0.13444111350839236,
-0.010733428027206875, 0.0032082312714442284, 0.00921887273129907,
0.14862870972414677, -0.038089684845840015, -0.005409050818630374,
0.00740991078476131, 0.028468234704742933, -0.07369893018549788,
-0.016645759770041162, -0.0003535595662359177, 0.0050457858012264495,
0.04719767701902686, -0.05935085817222535, -0.036129936737568355,
0.022913823798110577, 0.002814671482057094, 0.0018887119795684948]},
"PRESSURE_NODAL": {"max": 8250.534618624411, "at": [5.620504062164854e-16,
592.5729665199837, 1024.583972175828, 1427.3225217079403, 1787.0863828895551,
1771.2044847432578, 1955.3436056537455, 2200.1437683309496, 2532.8603690579257,
2877.5756983563833, 3112.216086837431, 3298.147152550153, 3592.1854392918794,
3992.403122049666, 4501.172511829062, 4759.799642538579, 5013.143175344212,
5356.205992230188, 5760.351528485605, 6522.240528707082, 6763.272618250556,
6949.532200069666, 7113.095654303979, 7099.999998463564]}, "STRESS_TENSOR":
{"max": 302.07647511582354, "at": [0.34382757465267655, -0.01346131346248701,
-0.341145603482547, -12.521863237337643, -76.51414900558498,
12.464699762900729, -12.757454011694584, -63.36198434795881,
12.771778097614597, 31.589789677057183, -36.98704527668482, -31.6255582938015,
81.38895049923828, 7.1095809725248325, -81.33488078189914, -81.12369036179773,
10.371270036145974, 80.9327839806158, -35.79328959122321, 5.974936110009137,
35.77804812342457, 4.805639466342115, 17.123857036311694, -4.8010837779366655,
24.908759622756296, -15.982513380238561, -24.89566882347785, 37.36684617134657,
130.49287239339216, -37.15579340353828, -29.168073363779268,
-22.64510157749834, 29.113986011298174, -1.2178324859652814, 14.96635088697311,
1.2101516338028262, 0.1771649062034407, 16.52094410332913,
-0.16664283288907963, -30.23634338304005, -23.78279636533392,
30.276768276320787, 29.99596225279093, 150.86687256096826, -30.10061473365434,
27.050551941647687, -17.12546855239789, -27.074188920521145, 5.850781440769003,
16.026970336261833, -5.851283495353056, -33.044544208688755, 7.942376046878278,
33.0517092245265, -83.42886193110527, -0.05015145071194863, 83.4958826324723,
79.23525429189543, 11.497118737281973, -79.31953251049998, 34.97405339914824,
-36.711212394041546, -35.02535790931559, -12.240118241949206,
-63.948294647158974, 12.272655871742522, -10.559883086912032,
-78.27425052046637, 10.563879920416554, 0.343827574583058,
-0.013461313525154532, -0.3411456035720708]}, "SPEED": {"max":
19.6751763286252, "at": [-0.0022142871197623035, 6.023223343442872,
11.904459152216866, 14.106796805060789, 8.20711585491327, 12.048319048013349,
12.805747509388059, 12.16900292324847, 13.403162993613755, 10.1877762971917,
17.29546685154125, 4.434432463278913, 4.0443314807445825, 16.577146213012565,
8.038838119096868, 13.831377627021682, 12.128740370432727, 12.967243903375838,
12.100014739151701, 7.741518484592954, 13.894495436692845, 11.994881523136197,
6.11106036792233, -0.0022142871195315675]}, "KINETIC_ENERGY": {"max":
193.5484845349844, "at": [0.0003198275068843633, 17.886153046907978,
70.67829310031188, 99.47607852586611, 33.58584685591901, 72.59542649558294,
82.0017591333783, 74.07273044072559, 89.84153344206989, 51.14248885547121,
149.47034520347128, 9.835858011805337, 8.134999991159034, 137.44545392930203,
32.80675414927447, 95.61741254999787, 73.58401575519356, 84.07624437068947,
73.2349550427004, 29.935668601337163, 96.48952388030905, 71.75948224699421,
18.40379936237921, 0.0003198275068839724]}, "ENERGY_FLUX": {"max":
3.532269416785392, "at": [3.3758670895440703, -6.229880140106308e-05,
1.5090567215898885, 0.2245312100204319, 0.35659625520733196,
-0.09515258199808271, 0.32567629548090127, -0.43819696905000594,
0.7110767652310108, -0.3901091032122222, 3.189589881524958,
-0.13894989057435722, 0.5416726184009946, -0.4752771647197645,
0.037515800568531724, -0.819416071203888, 0.5953296188327148,
-0.9365013401029693, 1.8112495381769502, -0.21471806236395097,
1.7325177421191604, -0.6421847736846743, 0.047289611921263595,
-0.8232003040855606, 0.018914059675704382, -0.823835221944477,
1.6104141971611865, -0.6622592243474671, 1.818043243030487,
-0.16113698920631933, 0.6518267287995411, -0.9270338867274921,
0.04254982702384394, -0.8318770964767652, 0.47786891539050447,
-0.4867151255322296, 3.078547822057313, -0.1531853954655335,
0.7283731900531496, -0.3604824018213285, 0.33497853379314246,
-0.44257753199399114, 0.34539799982773334, -0.10512169621952004,
1.400699900085753, 0.214264241394354, 3.3758670895441045,
-6.22988014352028e-05]}, "DENSITY": {"max": 1.0000000000000002, "at": [1.0,
1.0, 1.0, 1.0, 1.0, 1.0, 0.9999999999999999, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]}, "VISCOSITY": {"max":
0.7100000000000003, "at": [0.7100000000000001, 0.7100000000000001, 0.71, 0.71,
0.71, 0.7100000000000001, 0.71, 0.71, 0.7100000000000002, 0.71,
0.7100000000000001, 0.7099999999999999, 0.7100000000000001, 0.71, 0.71,
0.7099999999999999, 0.7099999999999999, 0.71, 0.71, 0.71, 0.7099999999999999,
0.7099999999999999, 0.71, 0.7099999999999999]}, "STREAM": {"max":
5.073674586308197, "at": [0.0, -0.13664295921829953, -0.5589371726453523,
-1.1156489788460837, -0.5409951845031912, -0.6763597695451335,
-2.774447403448717, -3.8412572461920758, -3.2620705854538357,
-0.22867752122116952, -2.5481374903561598, -4.827224771843784,
-4.867884428178703, -2.724167871322665, -0.13375241222182607,
-3.1455946008940847, -3.8417504038695, -2.817742372708857, -0.7976326436037353,
-0.47118539666849596, -1.0986126396549625, -0.5634720371573174,
-0.13808501717519958, 0.0]}, "NS_RESIDUALS": {"max": 1.3612465375372553, "at":
[0.0, 0.0, 2.55351295663786e-14, 0.28098357087223924, -1.0662581928500003e-12,
0.08233741024890584, 5.790812274142354e-12, 0.12692055157158677,
6.24389429049188e-13, 0.033844661436159384, -1.765698698363849e-12,
0.49105980727286663, -2.0414317296836953e-11, 0.4760120700650184,
2.5153212845907547e-12, 0.22944273991887806, 1.7090594104221568e-11,
0.447035831736847, 1.8474111129762605e-13, 0.05199749554046407,
-4.247269203005999e-12, 0.20446975489597463, -1.305400232354259e-11,
0.3266069091335595, 6.114220241215662e-12, 0.17924227410858684,
9.347023155470424e-12, 0.28752324469596857, -1.786336447489727e-13,
1.2915350866637567, -8.171241461241152e-12, 0.4656059220130291,
-6.699695080808694e-12, 0.911301098367175, 1.0317080523236655e-11,
0.45055685784812416, 4.117605278210415e-12, 0.43176222609963305,
-1.061123411361109e-12, 0.6222824956990962, -2.8634872251132037e-12,
0.28010716869998475, 1.8525181388895362e-12, 0.522601661702069, 0.0,
0.2072085627706599, 0.0, 0.0]}}, "tracers": {"end": [0.3338264572497642,
0.8396487951725088, 0.6673204652248026, 0.7319298839656233, 0.7899822636553029,
0.663848641121476, 0.8492308489323926, 0.788348208371505, 0.26357815107822596,
0.7659226539616412, 0.4878480825834185, 0.6276917889290675, 0.6565113732632658,
0.4756057924940473, 0.8246511673892181, 0.383279368156557, 0.17534883261078035,
0.6167206318434454, 0.3434886267367355, 0.5243942075059604, 0.5121519174165835,
0.3723082110709348, 0.736421848921774, 0.23407734603836247,
0.15076915106760702, 0.21165179162849368, 0.21001773634469723,
0.33615135887852327, 0.3326795347751968, 0.2680701160343796, 0.666173542750243,
0.16035120482749424], "alive": [true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true]}}}, "small":
{"derived_manufactured": {"newton": 0, "reading": [1.9621484375000005,
1.4042470702838217, 3.0000000000000058]}, "derived_custom": {"newton": 0,
"reading": [3.0000000000000004]}, "derived_ls_normal": {"newton": 0, "reading":
[0.44721359549995787, 0.8944271909999162]}, "derived_density_residual":
{"newton": 0, "reading": [0.15972222222222235, 2.916666666666668]},
"derived_porous": {"newton": 0, "reading": [0.5740844152658378,
0.039113440217178816]}, "derived_strain_diffusion": {"newton": 0, "reading":
[-5.454545454545454]}, "particle_rigid_rotation": {"newton": 0, "reading":
[0.00031853073662412197, 0.39999987317225605]}, "particle_leaves": {"newton":
0, "reading": [1.0, 0.5]}, "inertial_terminal": {"newton": 0, "reading":
[-348.3252009391423, -862.2819038636253]}, "inertial_buoyancy": {"newton": 0,
"reading": [5.0, 5.0, 0.0, 0.0]}, "projection_poiseuille": {"newton": 128,
"reading": [0.0008651312092583657, 0.10621448010792209, 0.1249999975512939]},
"subcycled_fine_dt": {"newton": 3, "reading": [0.3152753221838682]},
"subcycle_stiff_species": {"newton": 0, "reading": [0.0007987867810972857,
0.0013606916152101643]}, "subcycle_sweeps_raise": {"newton": 0, "reading":
[2.0]}, "segregated_natural_convection": {"newton": 12, "reading": [12.0,
3.6203254807957994]}}}""")
# u and p at the gate's moving nodes (and each matrix's x at 24 dofs) from
# goma_tpu's rung and its float64 solution, relative to max |x|; the
# projection cavity's readings, relative
SPLIT_X_RTOL = 1e-6
SPLIT_READ_RTOL = 1e-6
# the segregated T and u against the coupled solution: 2x goma_tpu's own
# segregated-against-coupled reading, and no looser than this
SPLIT_COUPLED_CAP = 1e-5
# derived fields: the card against the port's CPU projection of the same x,
# and against goma_tpu's record, each relative to the field's max
SPLIT_DERIVED_DEV_RTOL = 1e-12
SPLIT_DERIVED_RTOL = 1e-6
# tracer end positions from goma_tpu's record, of the cavity's size (1)
SPLIT_TRACER_TOL = 1e-8
# the small decks: readings against goma_tpu's, relative; x between the
# card and the CPU, relative to 1 + |x|
SPLIT_SMALL_RTOL = 1e-8
SPLIT_SMALL_X_TOL = 1e-8


def split_namespace(device):
    """scripts/split_decks.py's namespace for the port on ``device``."""
    from scripts import split_decks

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    return split_decks.namespace("goma_tpu_torch", torch, arr, device=device)


def split_nd(solver, prob, params, direct):
    """The NDLU a rung's run will factor, before the run: the
    preconditioner of ``gmres+ndlu``, or the ``tpu_direct`` LU built from
    the values of the first iteration's prep at x = 0 (as the run builds
    it)."""
    if not direct:
        return solver.precond
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device="cuda")
    return solver._direct_ndlu(solver._prepare(x0, params)[1])


def split_tree(nd, seen, prob, label, direct, timed):
    """The kernels on one tree of a split deck, on the CSR values of the
    run's first and last factorization (``record_factor_vals``): the front
    LU and the gather against their plain versions on the real fronts and
    level maps of both; on ``tpu_direct`` the substitutions of one solve
    with the first factor against their plain versions. ``timed`` (as
    scripts/split_phases.py runs it) also times, on ``gmres+ndlu``, the
    level shapes' random boosted fronts (kernel, plain version,
    ``lu_factor_ex``, bound; once per set of shapes) and one
    factorization's gathers, and on ``tpu_direct`` the substitutions (once
    per set of shapes). Returns the numbers the summary reads."""
    levels = nd_levels(nd)
    tree = {"levels": levels, "max_abs": 0.0, "gather_abs": 0.0}
    for key in ("first", "last") if seen["last"] is not seen["first"] \
            else ("first",):
        tree["max_abs"] = max(tree["max_abs"], check_real_fronts(
            nd, seen[key], f"{label} {key} factorization"))
        tree["gather_abs"] = max(tree["gather_abs"], check_gathers(
            nd, seen[key], f"{label} {key} factorization"))
    if timed and not direct:
        shapes = [(nn, m) for nn, m, _ in levels]
        lu_abs, tree["lu_ms"] = lu_shapes(shapes, label, time_twin=True)
        tree["max_abs"] = max(tree["max_abs"], lu_abs)
        tree["lu_bound"] = lu_bound(shapes)
        tree["g_times"], tree["g_bound"] = gather_times(
            nd, seen["first"], f"{label} tree")
    if direct:
        calls = []
        rhs = torch.as_tensor(np.random.default_rng(47).standard_normal(
            prob.dofmap.n_dof), dtype=prob.dtype, device="cuda")
        nd.solve(nd.factor(seen["first"]), rhs, trace=calls)
        if len(calls) != 2 * len(levels):
            raise RuntimeError(f"one {label} solve made {len(calls)} "
                               f"substitutions, not 2 x {len(levels)} levels")
        key = tuple((b.shape, lo) for _, b, lo in calls)
        if not timed or key in _TRSV_SHAPES:
            gates = check_substitutions(calls, label, timed=False)
            tree["trsv"] = {"max_abs": gates["max_abs"]}
            if timed:
                first, rec = _TRSV_SHAPES[key]
                log(f"trsv {label}: the level shapes of {first}, timed there")
                tree["trsv"] = {**rec, "max_abs": gates["max_abs"]}
        else:
            tree["trsv"] = check_substitutions(calls, label)
            _TRSV_SHAPES[key] = (label, tree["trsv"])
        tree["bound"] = trsv_bound(calls)
        if "levels" in tree["trsv"] and "device_ms" in tree["trsv"]:
            # device ns per dependent step at the two top levels (level
            # device time / m, both sweeps averaged)
            tree["step_ns"] = {}
            for li in range(max(len(levels) - 2, 0), len(levels)):
                t = [1e6 * k / m for lv, nn, m, _, k, _
                     in tree["trsv"]["levels"] if lv == li]
                tree["step_ns"][f"({levels[li][0]}, {levels[li][1]})"] = (
                    sum(t) / len(t))
    return tree


def split_trees(solvers, probs, params, label, direct, ref_levels):
    """Before a split deck's run: each tree's NDLU against goma_tpu's
    levels, its factorizations recorded (``record_factor_vals``), its
    solver reset. Returns ({name: (NDLU, recorded values)}, [(name,
    solver, levels)] for ``check_split_launches``)."""
    nds, parts = {}, []
    for key, sv in solvers.items():
        nd = split_nd(sv, probs[key], params[key], direct)
        levels = check_ref_levels(nd, {"levels": ref_levels[key]},
                                  f"{label} {key}")
        nds[key] = (nd, record_factor_vals(nd))
        parts.append((key, sv, len(levels)))
        reset_solver(sv)
    return nds, parts


def split_checks(nds, probs, label, direct, timed):
    """After a split deck's run: ``split_tree`` on every tree. Returns
    {name: the numbers the summary reads}."""
    trees = {}
    for key, (nd, seen) in nds.items():
        del nd.factor  # record_factor_vals's wrapper
        trees[key] = split_tree(nd, seen, probs[key], f"{label} {key}",
                                direct, timed)
    return trees


def reset_solver(sv):
    """A rung's solver with nothing lagged and its counts at 0."""
    sv.reset_lagged()
    sv.n_factor = sv._ndlu_nfactor = sv.n_discarded = 0
    sv.direct_log = []
    if sv._ndlu is not None:
        sv._ndlu.n_solve = 0


def check_split_launches(parts, ln, label, direct):
    """Front-LU and front-gather launches = the sum over the split's trees
    of levels x factorizations, and on ``tpu_direct`` substitution
    launches = the sum of 2 x levels x NDLU solves; every tree factored.
    ``parts``: [(name, solver, levels)]."""
    nf = {k: (sv._ndlu_nfactor if direct else sv.n_factor)
          for k, sv, _ in parts}
    want = sum(nlev * nf[k] for k, _, nlev in parts)
    if min(nf.values()) < 1 or ln["lu"] != want or ln["gather"] != want:
        raise RuntimeError(f"{label}: front-LU launches {ln['lu']} / "
                           f"front-gather launches {ln['gather']} != "
                           + " + ".join(f"{nlev} levels x {nf[k]} ({k})"
                                        for k, _, nlev in parts))
    if direct:
        ns = {k: sv._ndlu.n_solve for k, sv, _ in parts}
        want = sum(2 * nlev * ns[k] for k, _, nlev in parts)
        if min(ns.values()) < 1 or ln["trsv"] != want:
            raise RuntimeError(f"{label}: substitution launches {ln['trsv']} "
                               "!= " + " + ".join(
                                   f"2 x {nlev} levels x {ns[k]} ({k})"
                                   for k, _, nlev in parts))
    return nf


def rel_max(a, b, scale):
    """max |a - b| / scale."""
    return float(np.max(np.abs(np.subtract(a, b)))) / scale


def projection_phase(dev, kind, post=None, timed=False):
    """Phase 63 on ``kind``: the 96x96 projection cavity (split_decks:
    u* of 74,498 dof and the Q1 pressure increment of 9,409, dt 0.05 from
    rest, PROJ_STEPS steps) under bench._cavity_opts(kind, tol=1e-9,
    max_iter=PROJ_MAX_ITER) restated, float64 Jacobian. After the run the
    kernels on each tree's first and last factorization (``split_tree``).
    Gates:
    both trees goma_tpu's; every step's Newton counts of both sub-solves
    goma_tpu's on ``tpu_direct`` (+-1 on ``gmres+ndlu``); u and p at the
    gate's 24 moving nodes within SPLIT_X_RTOL of max |x| from goma_tpu's
    rung and its float64 solution; the kinetic energy, max |DIV_VELOCITY|,
    the primary vortex's node and strength (STREAM) and VORTICITY there
    within SPLIT_READ_RTOL of goma_tpu's; more than a third of the
    velocity nodes moving; the launch identities. ``post``: the readings'
    velocity-pressure carrier of an earlier call (the same mesh);
    ``timed``: see ``split_tree``."""
    from scripts import split_decks as sd

    t_phase = time.perf_counter()
    rec = SPLIT_REF["projection"]
    ref = rec[kind]
    direct = kind == "tpu_direct"
    label = f"projection {kind}"
    P = split_namespace(dev)
    t0 = time.perf_counter()
    ps = sd.projection_cavity(P, SPLIT_PROJ_N, (direct_opts if direct else
                                                cavity_opts)(
        tol=1e-9, max_iter=sd.PROJ_MAX_ITER))
    n_dof = {"ustar": ps.prob_u.dofmap.n_dof, "pphi": ps.prob_p.dofmap.n_dof}
    log(f"{label} setup: {SPLIT_PROJ_N}x{SPLIT_PROJ_N} QUAD9, u* (Q2) "
        f"{n_dof['ustar']} dof, pressure increment (Q1) {n_dof['pphi']} dof "
        f"(goma_tpu {rec['n_dof']}); {time.perf_counter() - t0:.2f} s")
    if n_dof != rec["n_dof"]:
        raise RuntimeError(f"{label}: dof counts differ from goma_tpu's")
    dt = torch.tensor(sd.PROJ_DT, dtype=torch.float64, device="cuda")
    probs = {"ustar": ps.prob_u, "pphi": ps.prob_p}
    solvers = {"ustar": ps.solver_u, "pphi": ps.solver_p}
    # step 1's parameters: every field at rest
    nds, parts = split_trees(solvers, probs, {k: p.base_params(dt=dt)
                                              for k, p in probs.items()},
                             label, direct, ref["levels"])
    reset_counts()
    t0 = time.perf_counter()
    res, counts = sd.run_projection(P, ps, rec["steps"], rec["dt"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = read_counts()[0]
    nf = check_split_launches(parts, ln, label, direct)
    nit = sum(counts["ustar"]) + sum(counts["pphi"])
    log(f"{label}: {rec['steps']} steps to t = {res.t:.3f}; Newton u* "
        f"{counts['ustar']} (goma_tpu {ref['newton']['ustar']}), increment "
        f"{counts['pphi']} (goma_tpu {ref['newton']['pphi']}); factorizations "
        f"{nf}; launches front-LU {ln['lu']} front-gather {ln['gather']} "
        f"substitution {ln['trsv']}; {sec:.3f} s, {sec / rec['steps']:.4f} "
        f"s/step, {sec / max(nit, 1):.4f} s/iter")
    for key in ("ustar", "pphi"):
        a, b = counts[key], ref["newton"][key]
        if len(a) != len(b) or not all(
                (x == y) if direct else abs(x - y) <= 1 for x, y in zip(a, b)):
            raise RuntimeError(f"{label}: {key} Newton counts {a} are not "
                               f"goma_tpu's {b}")
    post = post or sd.flow_post_problem(P, ps.mesh, ps.mat)
    out = sd.projection_outputs(P, ps, res, ref["gate_nodes"], post)
    u = np.asarray(res.u)
    if not (np.all(np.isfinite(u)) and np.all(np.isfinite(res.p))):
        raise RuntimeError(f"{label}: non-finite end state")
    moving = np.linalg.norm(u[ref["gate_nodes"]], axis=1)
    dx = rel_max(out["gate"], ref["gate"], ref["x_max"])
    d64 = rel_max(out["gate"], rec["direct"]["gate"], rec["direct"]["x_max"])
    keys = ("kinetic_energy", "div_max", "psi_vortex", "vortex_x",
            "vortex_y", "vorticity_vortex")
    dread = {k: abs(out[k] - ref[k]) / max(abs(ref[k]), 1e-300) for k in keys}
    log(f"{label}: u, p at {len(ref['gate_nodes'])} moving nodes (speed "
        f"{moving.min():.3g}-{moving.max():.3g}) max |dx| / max |x| "
        f"{dx:.2e} from goma_tpu's rung, {d64:.2e} from its float64 "
        f"solution; {out['moving_share']:.3f} of the velocity nodes move; "
        + ", ".join(f"{k} {out[k]:.10g} (goma_tpu {ref[k]:.10g}, "
                    f"{dread[k]:.1e})" for k in keys)
        + f"; vortex node {out['vortex_node']} (goma_tpu "
        f"{ref['vortex_node']})")
    if max(dx, d64) > SPLIT_X_RTOL:
        raise RuntimeError(f"{label}: u, p {dx:.2e} / {d64:.2e} from "
                           f"goma_tpu's > {SPLIT_X_RTOL:.0e}")
    if (max(dread.values()) > SPLIT_READ_RTOL
            or out["vortex_node"] != ref["vortex_node"]):
        raise RuntimeError(f"{label}: readings {dread} from goma_tpu's")
    if out["moving_share"] <= 1 / 3 or moving.min() <= sd.MOVING:
        raise RuntimeError(f"{label}: the flow does not move enough")
    trees = split_checks(nds, probs, label, direct, timed)
    log(f"phase 63 ({label}): {sec / rec['steps']:.4f} s/step, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": ln, "trees": trees, "sec": sec, "post": post}


def segregated_phase(dev, kind, timed=False):
    """Phase 64 on ``kind``: the 48x48 buoyant cavity split into three
    matrices (split_decks: the flow, 21,219 dof; the temperature and the
    species, 9,409 each) under ``SegregatedSolver`` (tol 1e-8, up to 60
    outer iterations, goma_tpu's relaxation), every sub-solve on
    bench._cavity_opts(kind, tol=1e-9, max_iter=SEG_MAX_ITER) restated,
    float64 Jacobian. After the run the kernels on each tree's first and
    last factorization (``split_tree``). Gates: the trees goma_tpu's; goma_tpu's outer count and every
    sub-solve's Newton count (exactly on ``tpu_direct``, +-1 on
    ``gmres+ndlu``); each matrix's x at 24 dofs within SPLIT_X_RTOL of max
    |x|; T and u at 24 nodes against goma_tpu's coupled (one-matrix, float64
    host direct) solution within 2x goma_tpu's own reading and
    SPLIT_COUPLED_CAP; the derived catalog entries (SEG_DERIVED) within
    SPLIT_DERIVED_RTOL of goma_tpu's record at the sampled nodes (and on
    ``tpu_direct`` each within SPLIT_DERIVED_DEV_RTOL of the port's CPU
    projection of the same x); 16 tracers' end positions within
    SPLIT_TRACER_TOL of goma_tpu's; the launch identities. ``timed``: see
    ``split_tree``."""
    from scripts import split_decks as sd

    t_phase = time.perf_counter()
    rec = SPLIT_REF["segregated"]
    ref = rec[kind]
    direct = kind == "tpu_direct"
    label = f"segregated {kind}"
    P = split_namespace(dev)
    t0 = time.perf_counter()
    solver, probs, _ = sd.segregated_cavity(
        P, SPLIT_SEG_N, (direct_opts if direct else cavity_opts)(
            tol=1e-9, max_iter=sd.SEG_MAX_ITER), rec["relax"])
    n_dof = {k: p.dofmap.n_dof for k, p in probs.items()}
    log(f"{label} setup: {SPLIT_SEG_N}x{SPLIT_SEG_N} QUAD9, {n_dof} dof "
        f"(goma_tpu {rec['n_dof']}), relaxation {rec['relax']}; "
        f"{time.perf_counter() - t0:.2f} s")
    if n_dof != rec["n_dof"]:
        raise RuntimeError(f"{label}: dof counts differ from goma_tpu's")
    # the first outer iteration: every field at rest
    nds, parts = split_trees(solver._solvers, probs,
                             {k: p.base_params() for k, p in probs.items()},
                             label, direct, ref["levels"])
    reset_counts()
    t0 = time.perf_counter()
    res, counts = sd.run_segregated(solver)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln = read_counts()[0]
    nf = check_split_launches(parts, ln, label, direct)
    nit = sum(sum(c) for c in counts.values())
    log(f"{label}: {res.outer_iters} outer iterations (goma_tpu "
        f"{ref['outer']}), converged {res.converged}; Newton "
        + "; ".join(f"{k} {c} (goma_tpu {ref['newton'][k]})"
                    for k, c in counts.items())
        + f"; factorizations {nf}; launches front-LU {ln['lu']} front-gather "
        f"{ln['gather']} substitution {ln['trsv']}; {sec:.3f} s, "
        f"{sec / max(nit, 1):.4f} s/iter, {sec / res.outer_iters:.4f} s an "
        "outer iteration")
    if not res.converged or res.outer_iters != ref["outer"]:
        raise RuntimeError(f"{label}: {res.outer_iters} outer iterations "
                           f"(converged {res.converged}), goma_tpu "
                           f"{ref['outer']}")
    for key, c in counts.items():
        b = ref["newton"][key]
        if len(c) != len(b) or not all(
                (x == y) if direct else abs(x - y) <= 1 for x, y in zip(c, b)):
            raise RuntimeError(f"{label}: {key} Newton counts {c} are not "
                               f"goma_tpu's {b}")
    out = sd.segregated_outputs(P, probs, res, derived=False)
    dxs = {k: rel_max(out[k]["x_samples"], ref[k]["x_samples"],
                      ref[k]["x_max"]) for k in probs}
    c = rec["coupled"]
    f = out["fields"]
    vs = {"T": rel_max(f["T"], c["T"], c["T_max"]),
          "u": max(rel_max(f["ux"], c["ux"], c["u_max"]),
                   rel_max(f["uy"], c["uy"], c["u_max"]))}
    lim = {k: min(2.0 * ref["vs_coupled"][k], SPLIT_COUPLED_CAP) for k in vs}
    log(f"{label}: x at 24 dofs max |dx| / max |x| from goma_tpu's "
        + ", ".join(f"{k} {v:.2e}" for k, v in dxs.items())
        + "; against the coupled solution " + ", ".join(
            f"{k} {vs[k]:.2e} (goma_tpu {ref['vs_coupled'][k]:.2e}, limit "
            f"{lim[k]:.2e})" for k in vs))
    if max(dxs.values()) > SPLIT_X_RTOL:
        raise RuntimeError(f"{label}: x {dxs} from goma_tpu's > "
                           f"{SPLIT_X_RTOL:.0e}")
    if any(vs[k] > lim[k] for k in vs):
        raise RuntimeError(f"{label}: T / u {vs} from the coupled solution "
                           f"above {lim}")
    trees = split_checks(nds, probs, label, direct, timed)
    derived_phase(P, probs, res.x, ref, label, cpu=direct)
    log(f"phase 64 ({label}): {sec / max(nit, 1):.4f} s/iter, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": ln, "trees": trees, "sec": sec}


def split_derived_cpu(xs):
    """The port's CPU projection of SEG_DERIVED on the segregated state
    ``xs`` (the 48x48 matrices built on the CPU)."""
    from scripts import split_decks as sd

    P = split_namespace(torch.device("cpu"))
    _, probs, _ = sd.segregated_cavity(P, SPLIT_SEG_N)
    return sd.segregated_derived(P, probs, xs)


def derived_phase(P, probs, xs, ref, label, cpu):
    """Phase 64's derived fields and tracers on the converged state ``xs``
    (see ``segregated_phase``); ``cpu``: the fields held against the port's
    CPU projection too (the child's "derived" runs)."""
    from scripts import split_decks as sd

    t0 = time.perf_counter()
    if cpu:
        request_cpu_side("derived", {k: np.asarray(v) for k, v in xs.items()})
    card = sd.segregated_derived(P, probs, xs)
    t_card = time.perf_counter() - t0
    nodes = sd.samples(probs["flow"].mesh.n_nodes)
    cpu = cpu_runs("derived", lambda: split_derived_cpu(xs)) if cpu else None
    for name, f in card.items():
        r = ref["derived"][name]
        got = sd.derived_reading(f, nodes)
        dg = rel_max(got["at"], r["at"], r["max"])
        dm = abs(got["max"] - r["max"]) / r["max"]
        line = (f"{label} {name}: shape {tuple(f.shape)}, max {got['max']:.6g}"
                f" (goma_tpu {r['max']:.6g}); at 24 nodes {dg:.2e} of max "
                f"from goma_tpu's")
        if cpu is not None:
            # DIV_VELOCITY is the trace of the velocity gradient, a
            # cancellation where the flow is nearly solenoidal (max |div|
            # 0.63 where the gradient reaches 425): its card-vs-CPU
            # difference is read against the gradient's scale, max
            # SHEAR_RATE, and printed against its own max too
            own = rel_max(f, cpu[name], float(np.abs(cpu[name]).max()))
            dc = own
            line += f", card vs CPU {own:.2e} of max"
            if name == "DIV_VELOCITY":
                dc = rel_max(f, cpu[name],
                             float(np.abs(cpu["SHEAR_RATE"]).max()))
                line += f", {dc:.2e} of max SHEAR_RATE"
            if not dc <= SPLIT_DERIVED_DEV_RTOL:
                raise RuntimeError(f"{line}: card vs CPU > "
                                   f"{SPLIT_DERIVED_DEV_RTOL:.0e}")
        log(line)
        if not np.all(np.isfinite(f)) or max(dg, dm) > SPLIT_DERIVED_RTOL:
            raise RuntimeError(f"{line}: > {SPLIT_DERIVED_RTOL:.0e}")
    t1 = time.perf_counter()
    tr = sd.trace(P, probs, xs)
    end = np.asarray(tr.positions[-1]).ravel()
    dp = float(np.abs(end - np.asarray(ref["tracers"]["end"])).max())
    log(f"{label}: {len(sd.SEG_DERIVED)} derived fields on the card "
        f"{t_card:.2f} s; {sd.SEG_TRACERS} tracers, {tr.positions.shape[0] - 1}"
        f" RK4 steps of {sd.SEG_TRACE_DT} in {time.perf_counter() - t1:.2f} "
        f"s: end positions max |dx| {dp:.2e} from goma_tpu's (its two rungs "
        f"{SPLIT_REF['segregated']['tracers_rungs']:.2e} apart)")
    if (dp > SPLIT_TRACER_TOL or list(tr.alive) != ref["tracers"]["alive"]
            or not np.all(np.isfinite(end))):
        raise RuntimeError(f"{label}: tracers {dp:.2e} from goma_tpu's > "
                           f"{SPLIT_TRACER_TOL:.0e}")


def split_small_phase(devices=("cuda", "cpu")):
    """Phase 65: goma_tpu's tests' decks of the slice (``split_decks.SMALL``:
    tests/test_derived.py's six, test_tools.py's two particle traces,
    test_flux_sens_particles.py's two inertial particles,
    test_projection.py's Poiseuille start-up, test_segregated_subcycle.py's
    three and test_more_physics.py's segregated natural convection) at
    their own sizes on their own solvers, on cuda and cpu (the CPU half in
    the child process, group "split"): each deck's own gate, goma_tpu's
    Newton (or step, outer) count, the readings within SPLIT_SMALL_RTOL on
    the card, and the same count and x within SPLIT_SMALL_X_TOL on both
    devices."""
    from scripts import split_decks as sd

    t0 = time.perf_counter()
    check_small_decks("split small", "split", sd.SMALL, split_namespace,
                      SPLIT_REF["small"], SPLIT_SMALL_RTOL, SPLIT_SMALL_X_TOL,
                      devices)
    log(f"phase 65 (small derived-field, particle, projection and segregated "
        f"decks on {' and '.join(devices)}): {time.perf_counter() - t0:.1f} s")


def split_phases(dev, timed=False):
    """Phases 63-65 in order: the projection cavity on both rungs, the
    three-matrix buoyant cavity on both rungs (its derived fields held
    against the port's CPU projection on the ``tpu_direct`` state), the
    small decks on cuda and cpu; ``timed``: the new
    trees' kernels timed too (``split_tree``; scripts/split_phases.py).
    Returns the four main paths' records (projection ``gmres+ndlu`` and
    ``tpu_direct``, segregated ``gmres+ndlu`` and ``tpu_direct``)."""
    t_split = time.perf_counter()
    pg = projection_phase(dev, "gmres+ndlu", timed=timed)
    pd = projection_phase(dev, "tpu_direct", pg.pop("post"), timed)
    pd.pop("post")
    sg = segregated_phase(dev, "gmres+ndlu", timed=timed)
    sdr = segregated_phase(dev, "tpu_direct", timed)
    split_small_phase()
    log(f"phases 63-65 (derived fields, particles, projection and segregated "
        f"drivers): {time.perf_counter() - t_split:.1f} s; {mem_line()}")
    return pg, pd, sg, sdr


# ---- the CPU halves of phases 22, 26, 47, 56, 59, 62, 64 and 65, beside
# the card's phases
# ---- phase 66: NDLU's pivoted front-LU routes and GCRO-DR recycling
# goma_tpu's record of the 64x64 cavity on bench.py's twolevel kind with 8
# recycled vectors (``python3 scripts/recycle_reference.py --n 64 --k 8``,
# goma_tpu on a CPU, float32 Jacobian; 244.6 s of solve)
RECYCLE_REF = {"newton": 4, "linear": [62, 166, 168, 130]}
RECYCLE_K = 8
# the 64x64 cavity's tpu_direct tree at this leaf size: 32 leaves of
# s = 1239 > 1000 (the pivoted route, panels of 128) under 5 kernel levels
PIV_LEAF = 1536
# the 12x12 cavity at leaf 2048: one level, s = 1419 (all pivoted), and the
# 8x8 cavity's gmres+ndlu on front_lu="lax": cuda against cpu
PIV_SMALL = {"12x12 tpu_direct leaf 2048": (12, "tpu_direct", "auto"),
             "8x8 gmres+ndlu lax": (8, "gmres+ndlu", "lax")}


def pivoted_small_run(name, device):
    """One of phase 66's small decks on ``device`` (``solve_from_zero``)."""
    import dataclasses

    from goma_tpu_torch.solvers import NewtonSolver

    n, rung, route = PIV_SMALL[name]
    if rung == "tpu_direct":
        opts = dataclasses.replace(direct_opts(), ndlu_leaf_max=2048)
    else:
        opts = cavity_opts()
    solver = NewtonSolver(cavity_problem(n, device), opts)
    if solver.precond is not None:
        solver.precond.front_lu = route
    return solve_from_zero(solver)


def pivoted_small_phase():
    """Phase 66's small decks on cuda and on cpu (the CPU runs from
    ``cpu_runs``): the same Newton count, x within phase 4's 1e-5."""
    cpu = cpu_runs("pivoted", lambda: {
        name: pivoted_small_run(name, torch.device("cpu")) for name in PIV_SMALL})
    for name in PIV_SMALL:
        check_cuda_cpu(name, pivoted_small_run(name, torch.device("cuda")),
                       cpu[name], 1e-5)


def pivoted_cylinder_phase(prob, bi, kernel_route):
    """Phase 66(a): phase 45's deck and options (the 96x48 immersed
    cylinder, 42,463 dof, ``gmres+ndlu`` to 1e-9, float32 Jacobian) with
    the preconditioner's NDLU set to ``front_lu="lax"`` (lu_block 128:
    every level with s > 128 through the blocked panel LU): one
    factorization at x = 0 by CUDA events on the pivoted route and on the
    kernel's, with the exact zero pivots the library LU left; one warm-up
    solve, ``reset_lagged()``, one timed solve; gates: converged, x at the
    24 dofs within REF_X_TOL of goma_tpu's record and the drag within
    OVS_DRAG_RTOL, no front-LU kernel launch, front-gather launches =
    levels x factorizations. The Newton and linear counts are printed
    beside goma_tpu's (pivoted fronts) and phase 45's (the kernel's route),
    not gated: ROADMAP Queue 3's open question."""
    from goma_tpu_torch.solvers import NewtonSolver

    label = "pivoted cylinder gmres+ndlu"
    ref = OVS_REF["gmres+ndlu"]
    solver = NewtonSolver(prob, cavity_opts(tol=1e-9, max_iter=10))
    nd = solver.precond
    nd.front_lu = "lax"
    if nd.lu_block != 128:
        raise RuntimeError(f"{label}: lu_block {nd.lu_block}, not 128")
    levels = check_ref_levels(nd, ref, label)
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device="cuda")
    params = prob.base_params()
    vals = solver._prepare(x0, params)[1]
    nd.zero_pivots = 0
    facs = nd.factor(vals)
    zero = int(nd.zero_pivots)
    finite = all(bool(torch.isfinite(t).all()) for f in facs for t in f
                 if t is not None and t.is_floating_point())
    piv_ms = median_ms(lambda: nd.factor(vals), 3)
    nd.front_lu = "auto"
    ker_ms = median_ms(lambda: nd.factor(vals), 3)
    nd.front_lu = "lax"
    log(f"{label}: one factorization at x = 0 (CUDA events): pivoted route "
        f"{piv_ms:.3f} ms, kernel route {ker_ms:.3f} ms; m per level "
        f"{[f[0].shape[-1] for f in facs]}, perm on every level "
        f"{all(f[2] is not None for f in facs)}; fronts with an exact zero "
        f"pivot (lu_factor_ex info > 0) {zero}; factors finite {finite}")
    if not finite or not all(f[2] is not None for f in facs):
        raise RuntimeError(f"{label}: the pivoted factors are not finite or "
                           "a level took the kernel")
    del facs
    res, sec, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof), params,
                                   label)
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: the solution has the wrong shape or "
                           "non-finite values")
    if not res.converged or res.res_norms[-1][1] > 1e-9:
        raise RuntimeError(f"{label} did not converge to 1e-9")
    samples = np.linspace(0, prob.dofmap.n_dof - 1, REF_SAMPLES).astype(np.int64)
    dx = rel_dx(x[samples], np.asarray(ref["x_samples"]))
    d = overset_drag(prob, x, bi)
    drel = abs(d - ref["drag"]) / abs(ref["drag"])
    log(f"{label}: Newton {res.iters} linear {res.linear_iters}; goma_tpu "
        f"(pivoted fronts) {ref['newton']} {ref['linear']}; phase 45 (the "
        f"kernel's route) {kernel_route[0]} {kernel_route[1]}; x at "
        f"{REF_SAMPLES} sampled dofs {dx:.2e} from goma_tpu's (max |dx| / (1 + "
        f"|x|)); drag {d:.12f} (goma_tpu {ref['drag']:.12f}), relative "
        f"{drel:.2e}; {sec / max(res.iters, 1):.4f} s/iter")
    if dx > REF_X_TOL:
        raise RuntimeError(f"{label}: x is {dx:.2e} from goma_tpu's > "
                           f"{REF_X_TOL:.0e}")
    if drel > OVS_DRAG_RTOL:
        raise RuntimeError(f"{label}: drag {d} not within {OVS_DRAG_RTOL:.0e} "
                           f"of goma_tpu's {ref['drag']}")
    nf = solver.n_factor
    if ln["lu"] != 0 or nf < 1 or ln["gather"] != len(levels) * nf:
        raise RuntimeError(f"{label}: front-LU launches {ln['lu']} (must be 0) "
                           f"/ front-gather launches {ln['gather']} != "
                           f"{len(levels)} levels x {nf} factorizations")
    return {"launches": ln, "newton": res.iters, "linear": res.linear_iters,
            "piv_ms": piv_ms, "kernel_ms": ker_ms, "zero_pivots": zero}


def mixed_tree_phase(prob, xd):
    """Phase 66(b): the 64x64 cavity on phase 10's ``tpu_direct`` options
    at leaf PIV_LEAF, whose leaves exceed the kernel's s <= 1000 under the
    port's "auto": those levels take the pivoted route (padded to panels of
    128), the others the front-LU and substitution kernels, in one tree.
    One solve from x = 0 (``solve_refined`` with refinement each step),
    counts set to 0 just before and read just after; gates: converged to
    1e-6, x within X_PATHS_TOL of phase 10's, front-LU launches = kernel
    levels x factorizations, gather launches = levels x factorizations,
    substitution launches = 2 x kernel levels x NDLU solves."""
    import dataclasses

    from goma_tpu_torch.solvers import NewtonSolver

    label = "mixed tree tpu_direct"
    t0 = time.perf_counter()
    solver = NewtonSolver(prob, dataclasses.replace(direct_opts(),
                                                    ndlu_leaf_max=PIV_LEAF))
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device="cuda")
    vals = solver._prepare(x0, prob.base_params())[1]
    nd = solver._direct_ndlu(vals)
    levels = [(lev.nn, lev.smax, lev.bmax) for lev in nd.levels]
    kern = sum(1 < s <= 1000 for _, s, _ in levels)
    log(f"{label} setup: leaf {PIV_LEAF}, {len(levels)} levels (nn, s, b) = "
        f"{levels}: {kern} on the kernels, {len(levels) - kern} pivoted; "
        f"{time.perf_counter() - t0:.1f} s")
    if not 0 < kern < len(levels):
        raise RuntimeError(f"{label}: the tree does not mix kernel and "
                           "pivoted levels")
    res, sec, ln = warm_then_timed(solver, np.zeros(prob.dofmap.n_dof),
                                   prob.base_params(), label, warm=False)
    if not res.converged or res.res_norms[-1][1] > 1e-6:
        raise RuntimeError(f"{label} did not converge to 1e-6")
    dx = float(np.abs(res.x - xd).max())
    nf, ns = solver._ndlu_nfactor, nd.n_solve
    log(f"{label}: Newton {res.iters}, max |x - x_phase10| = {dx:.3e}; "
        f"factorizations {nf}, NDLU solves {ns}; launches front-LU "
        f"{ln['lu']} (= {kern} x {nf}), front-gather {ln['gather']} (= "
        f"{len(levels)} x {nf}), substitution {ln['trsv']} (= 2 x {kern} x "
        f"{ns}); {sec / max(res.iters, 1):.4f} s/iter")
    if dx > X_PATHS_TOL:
        raise RuntimeError(f"{label}: x differs from phase 10's by {dx:.3e} > "
                           f"{X_PATHS_TOL:.0e}")
    if (nf < 1 or ns < 1 or ln["lu"] != kern * nf
            or ln["gather"] != len(levels) * nf or ln["trsv"] != 2 * kern * ns):
        raise RuntimeError(f"{label}: launches {ln} do not match {kern} kernel "
                           f"levels of {len(levels)}, {nf} factorizations, "
                           f"{ns} solves")
    return {"launches": ln}


def recycle_phase(prob, x_ref, plain_linear):
    """Phase 66(c): phase 27's deck and options (the 64x64 cavity on
    bench.py's twolevel kind: Vanka, one sweep, restart 240, float32
    Jacobian) with ``recycle_k=RECYCLE_K``: one warm-up solve,
    ``reset_lagged()`` (which drops the recycled space), one timed solve
    with its host syncs counted; gates: converged to 1e-6, goma_tpu's
    Newton count +-1 (RECYCLE_REF), x within TWOLEVEL_X_TOL of phase 5's.
    Printed: the linear iterations a solve beside goma_tpu's and phase
    27's without recycling, s/iteration and the host harvest's seconds a
    solve."""
    import dataclasses

    from goma_tpu_torch.solvers import NewtonSolver

    label = "recycled cavity twolevel"
    solver = NewtonSolver(prob, dataclasses.replace(twolevel_opts("cavity"),
                                                    recycle_k=RECYCLE_K))
    x_init, params = np.zeros(prob.dofmap.n_dof), prob.base_params()
    t0 = time.perf_counter()
    warm = solver.solve(x_init, params)
    torch.cuda.synchronize()
    log(f"{label} warm-up: {time.perf_counter() - t0:.2f} s, iters="
        f"{warm.iters}, lin={warm.linear_iters}, converged={warm.converged}")
    solver.reset_lagged()
    if solver._recycle_U is not None:
        raise RuntimeError(f"{label}: reset_lagged() kept the recycled space")
    solver.n_factor = solver.n_discarded = 0
    solver.harvest_s = []
    reset_counts()
    t0 = time.perf_counter()
    res, syncs = count_syncs(lambda: solver.solve(x_init, params))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ln, _ = read_counts()
    its = max(res.iters, 1)
    log(res.summary())
    log(f"{label}: Newton {res.iters} (goma_tpu {RECYCLE_REF['newton']}), "
        f"linear {res.linear_iters} (goma_tpu {RECYCLE_REF['linear']}; phase "
        f"27 without recycling {plain_linear}); {sec / its:.4f} s/iter (total "
        f"{sec:.3f} s), {syncs} host syncs ({syncs / max(sum(res.linear_iters), 1):.2f}"
        f" a linear iteration); host harvest {len(solver.harvest_s)} times, "
        + ", ".join(f"{h * 1e3:.1f}" for h in solver.harvest_s)
        + f" ms; recycled space {tuple(solver._recycle_U.shape) if solver._recycle_U is not None else None}")
    if not res.converged or res.res_norms[-1][1] > 1e-6:
        raise RuntimeError(f"{label} did not converge to 1e-6")
    if abs(res.iters - RECYCLE_REF["newton"]) > 1:
        raise RuntimeError(f"{label}: {res.iters} Newton iterations, not "
                           f"goma_tpu's {RECYCLE_REF['newton']} +- 1")
    dx = float(np.abs(res.x - x_ref).max())
    log(f"{label} vs gmres+ndlu: max |dx| = {dx:.3e}")
    if dx > TWOLEVEL_X_TOL:
        raise RuntimeError(f"{label}: {dx:.3e} from phase 5's solution "
                           f"(limit {TWOLEVEL_X_TOL:.0e})")
    return {"launches": ln}


def pivoted_phases(dev, cavity, x_gmres, x_direct, overset, kernel_route,
                   plain_linear):
    """Phase 66: the cylinder on pivoted fronts, the mixed tree, the
    recycled cavity and the small decks on cuda and cpu."""
    t_phase = time.perf_counter()
    out = {"pivoted cylinder gmres_ndlu": pivoted_cylinder_phase(
        *overset, kernel_route)}
    out["mixed tree tpu_direct"] = mixed_tree_phase(cavity, x_direct)
    out["recycled cavity twolevel"] = recycle_phase(cavity, x_gmres,
                                                    plain_linear)
    pivoted_small_phase()
    log(f"phase 66 (pivoted fronts and GCRO-DR): "
        f"{time.perf_counter() - t_phase:.1f} s; {mem_line()}")
    return out


_CPU_SIDE = {"proc": None, "stem": None, "log": None, "out": None}


def small_deck_runs(decks, P):
    """{name: the deck's output with its seconds} of every deck of
    ``decks`` in namespace ``P``."""
    out = {}
    for name, deck in decks.items():
        t = time.perf_counter()
        out[name] = deck(P)
        out[name]["seconds"] = time.perf_counter() - t
    return out


def cpu_side_runs(stem):
    """The CPU runs that phases 4, 9, 12, 14, 18, 22, 26, 32, 38, 47, 56,
    59, 62, 65 and 66 hold the card's against (the 8x8 cavity on both
    rungs, the 8x8 buoyant deck, the 8x4 viscoelastic decks, the 8x8 static
    bubble, the 16x4 slot coater's two cases, the 8x8 cavity with every
    other option, the small axisymmetric and strong-condition decks, the
    small overset, solid, porous, closure, level-set and split-solver decks
    and the pivoted small decks), each group pickled to
    ``<stem>_<group>.pkl`` as it ends, in the order the card needs them;
    then phase 64's derived fields on the state the card hands over
    (``request_cpu_side``), pickled to ``<stem>_derived.pkl``.
    ``start_cpu_side`` runs this in a child process while the card runs the
    phases before them."""
    from scripts import closure_decks, ls_decks, solid_decks, split_decks

    cpu = torch.device("cpu")
    groups = (
        ("cavity8", cavity8_cpu_runs),
        ("buoyant8", lambda: buoyant8_run(cpu)),
        ("ve8", lambda: {label: ve8_run(label, cpu) for label in VE8_RUNS}),
        ("bubble8", lambda: {r: bubble8_run(r, cpu) for r in BUBBLE8_RUNGS}),
        ("slot", lambda: {c: slot_cross_check_run(c, cpu) for c in SLOT_CASES}),
        ("options", lambda: {name: small_option_run(name, cpu)
                             for name in SMALL_OPTIONS}),
        ("axisym", axisym_cpu_half),
        ("bc", lambda: bc_small_decks(cpu)),
        ("overset", lambda: overset_small_decks(cpu)),
        ("solid", lambda: small_deck_runs(solid_decks.SMALL,
                                          solid_namespace(cpu))),
        ("closure", lambda: small_deck_runs(closure_decks.SMALL,
                                            closure_namespace(cpu))),
        ("ls", lambda: small_deck_runs(ls_decks.SMALL, ls_namespace(cpu))),
        ("split", lambda: small_deck_runs(split_decks.SMALL,
                                          split_namespace(cpu))),
        ("pivoted", lambda: {name: pivoted_small_run(name, cpu)
                             for name in PIV_SMALL}),
        ("derived", lambda: split_derived_cpu(wait_request(stem, "derived"))))
    for key, run in groups:
        path = f"{stem}_{key}.pkl"
        with open(f"{path}.tmp", "wb") as f:
            pickle.dump(run(), f)
        os.replace(f"{path}.tmp", path)


def wait_request(stem, key, limit=1800.0):
    """In the child: the input ``request_cpu_side`` hands over for the
    ``key`` runs, once the main process has written it (the child ends
    when its parent has gone or after ``limit`` seconds)."""
    path = Path(f"{stem}_{key}_in.pkl")
    t0 = time.perf_counter()
    while not path.exists():
        if os.getppid() == 1 or time.perf_counter() - t0 > limit:
            raise SystemExit(f"no {key} input for the CPU side")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def request_cpu_side(key, payload):
    """Hand ``payload`` to the child of ``start_cpu_side`` for its ``key``
    runs (``wait_request``); nothing when no child runs."""
    if _CPU_SIDE["proc"] is None:
        return
    path = Path(f"{_CPU_SIDE['stem']}_{key}_in.pkl")
    with open(f"{path}.tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(f"{path}.tmp", path)


def start_cpu_side():
    """Start ``cpu_side_runs`` in a child process that sees no CUDA device
    (two torch, OpenMP and BLAS threads, the lowest scheduling priority),
    writing into the git-ignored build directory."""
    here = Path(__file__).resolve().parent
    build = here / "goma_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    stem, log_path = build / "cpu_side", build / "cpu_side.log"
    for old in build.glob("cpu_side_*.pkl"):
        old.unlink()
    # the decks' helpers synchronize the card around their launch counts;
    # the child has none, so synchronize is a no-op there
    # the child runs at the lowest priority: the card's phases are
    # host-bound, and where the host has fewer free cores than threads the
    # child's runs, which the card's phases wait for only at their CPU
    # halves, slowed every phase beside them (1.2-1.6x in one run)
    code = (f"import os, sys; os.nice(19); sys.path.insert(0, {str(here)!r}); "
            "import torch; torch.set_num_threads(2); "
            "torch.cuda.synchronize = lambda *a, **k: None; import chip_smoke; "
            f"chip_smoke.cpu_side_runs({str(stem)!r})")
    logf = open(log_path, "w")
    _CPU_SIDE.update(stem=stem, log=log_path, out={}, proc=subprocess.Popen(
        [sys.executable, "-c", code], cwd=here, stdout=logf,
        stderr=subprocess.STDOUT, env=dict(
            os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
            OPENBLAS_NUM_THREADS="2", MKL_NUM_THREADS="2")))
    logf.close()
    log(f"CPU side: the CPU runs of phases 4, 9, 12, 14, 18, 22, 26, 32, 38, "
        f"47, 56, 59, 62, 64, 65 and 66 started in process "
        f"{_CPU_SIDE['proc'].pid}")


def cpu_runs(key, compute):
    """The CPU runs ``key`` from the child ``start_cpu_side`` started
    (waiting for its group; the child's failure fails the phase), or
    ``compute()`` here when no child runs."""
    proc = _CPU_SIDE["proc"]
    if proc is None:
        return compute()
    if key not in _CPU_SIDE["out"]:
        t0 = time.perf_counter()
        path = Path(f"{_CPU_SIDE['stem']}_{key}.pkl")
        while not path.exists():
            if proc.poll() is not None and not path.exists():
                tail = _CPU_SIDE["log"].read_text()[-3000:]
                raise RuntimeError(f"the CPU side exited {proc.returncode} "
                                   f"without its {key} runs:\n{tail}")
            time.sleep(0.2)
        with open(path, "rb") as f:
            _CPU_SIDE["out"][key] = pickle.load(f)
        log(f"CPU side: the {key} runs (waited {time.perf_counter() - t0:.1f}"
            " s here)")
    return _CPU_SIDE["out"][key]


def stop_cpu_side():
    """Stop the child of ``start_cpu_side`` if it still runs."""
    proc = _CPU_SIDE["proc"]
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def phase_clock():
    """``lap(label)`` logs the seconds since the previous ``lap`` (or since
    this call) as ``phase <label>: <s> s``, one line a phase."""
    last = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        log(f"phase {label}: {now - last[0]:.1f} s")
        last[0] = now
    return lap


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available (this script "
                         "runs the port on a GPU only)")
    try:
        return run_phases()
    finally:
        stop_cpu_side()


def run_phases() -> int:
    """Every phase in order (see the module docstring)."""
    from goma_tpu_torch.solvers import NewtonSolver
    from goma_tpu_torch.solvers.ndlu import NDLU, node_clusters
    from goma_tpu_torch.solvers.twolevel import _saddle_mask

    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    lap = phase_clock()

    # ---- 1. (and 7.) build every kernel, all nvcc runs started together;
    # the CPU side starts and phase 2 sets up on the host meanwhile (no
    # kernel is called before the build is joined)
    start_cpu_side()
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(build_kernels)

        # ---- 2. main deck set-up (host)
        t0 = time.perf_counter()
        prob = cavity_problem(N_MAIN, dev)
        solver = NewtonSolver(prob, cavity_opts())
        levels = solver.precond.levels
        shapes = [(lev.nn, lev.smax) for lev in levels]
        log(f"setup: {N_MAIN}x{N_MAIN} cavity, {prob.dofmap.n_dof} dof, "
            f"{prob.pattern.nnz} nnz, {len(levels)} ND levels (nn, m) = "
            f"{shapes}, {time.perf_counter() - t0:.1f} s")
        built.result()
    lap("1-2")

    # ---- 3. kernel vs twin on the card
    max_abs, lu_ms = lu_shapes(shapes, "cavity", time_twin=True)
    lu_bnd = lu_bound(shapes)

    # the main path's one factorization is at x = 0 with the float32 prep
    params = prob.base_params()
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)

    def scaled32(x):
        """The CSR values the main path factors at ``x`` (float32 prep)."""
        return solver._scaled_vals(x, params, solver._prepare_fast32(x, params)[2])

    max_abs = max(max_abs, check_real_fronts(solver.precond, scaled32(x0), "x=0"))
    lap("3")

    # ---- 4. small cross-check: GPU vs CPU on the 8x8 cavity
    cross_check_8x8(cavity_opts, "gmres+ndlu")
    lap("4")

    # ---- 5. main path
    x_init = np.zeros(prob.dofmap.n_dof)
    res, _, ln = warm_then_timed(solver, x_init, params, "main path")
    launches, g_launches = ln["lu"], ln["gather"]
    if not res.converged or res.res_norms[-1][1] > 1e-6:
        raise RuntimeError("main path did not converge to 1e-6")
    if solver.n_factor < 1 or launches != len(levels) * solver.n_factor:
        raise RuntimeError(f"front-LU launches {launches} != {len(levels)} levels "
                           f"x {solver.n_factor} factorizations")
    if g_launches != len(levels) * solver.n_factor:
        raise RuntimeError(f"front-gather launches {g_launches} != {len(levels)} "
                           f"levels x {solver.n_factor} factorizations")
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError("main path solution has the wrong shape or non-finite values")
    ghia_check(prob, x, "gmres+ndlu")
    lap("5")

    # ---- 6. kernel vs twin on the real fronts at the converged state
    xc = torch.as_tensor(x, dtype=prob.dtype, device=dev)
    max_abs = max(max_abs, check_real_fronts(solver.precond, scaled32(xc),
                                             "converged"))
    factor_split_ms(solver.precond, scaled32(x0), "cavity gmres+ndlu tree")
    lap("6")

    # ---- 8. substitution kernel vs twin on the tpu_direct deck's factors
    t0 = time.perf_counter()
    dsolver = NewtonSolver(prob, direct_opts())
    R, dvals, _, dscale, _ = dsolver._prepare(x0, params)
    nd = dsolver._direct_ndlu(dvals)  # the NDLU the main path will use
    dlev = [(lev.nn, lev.smax, lev.bmax) for lev in nd.levels]
    log(f"tpu_direct setup: {len(dlev)} ND levels (nn, m, boundary) = {dlev}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(1 < m <= 1000 for _, m, _ in dlev):
        raise RuntimeError("tpu_direct tree has a level outside 1 < s <= 1000")
    calls = []
    nd.solve(nd.factor(dvals), dscale * R, trace=calls)
    if len(calls) != 2 * len(dlev):
        raise RuntimeError(f"one solve made {len(calls)} substitutions, "
                           f"not 2 x {len(dlev)} levels")
    trsv = check_substitutions(calls, "cavity")
    step_ns = trsv_step_ns()
    chain_floor_ms = 1e-6 * step_ns * sum(rhs.shape[1] for _, rhs, _ in calls)
    log(f"trsv: chain floor of one cavity solve's {len(calls)} substitutions "
        f"(sum of m x one step of this kernel as measured above: the "
        f"design's own chain, not a limit of the card): "
        f"{chain_floor_ms:.4f} ms; byte bound {trsv_bound(calls)[0]:.4f} ms")
    lap("8")

    # ---- 9. small cross-check of the tpu_direct path: GPU vs CPU
    cross_check_8x8(direct_opts, "tpu_direct")
    lap("9")

    # ---- 10. the tpu_direct main path
    dres, _, ln = warm_then_timed(dsolver, x_init, params, "tpu_direct")
    d_trsv, d_lu, d_gather = ln["trsv"], ln["lu"], ln["gather"]
    d_solves, d_fac = nd.n_solve, dsolver._ndlu_nfactor
    if not dres.converged or dres.res_norms[-1][1] > 1e-6:
        raise RuntimeError("tpu_direct main path did not converge to 1e-6")
    if d_solves < 1 or d_trsv != 2 * len(dlev) * d_solves:
        raise RuntimeError(f"substitution launches {d_trsv} != 2 x {len(dlev)} "
                           f"levels x {d_solves} solves")
    if d_fac < 1 or d_lu != len(dlev) * d_fac or d_gather != len(dlev) * d_fac:
        raise RuntimeError(f"front-LU launches {d_lu} / front-gather launches "
                           f"{d_gather} != {len(dlev)} levels x {d_fac} "
                           "factorizations")
    xd = dres.x
    if xd.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(xd)):
        raise RuntimeError("tpu_direct solution has the wrong shape or "
                           "non-finite values")
    ghia_check(prob, xd, "tpu_direct")
    dx_paths = float(np.abs(xd - x).max())
    log(f"tpu_direct vs gmres+ndlu: max |x_direct - x_gmres| = {dx_paths:.3e}")
    if dx_paths > X_PATHS_TOL:
        raise RuntimeError(f"tpu_direct and gmres+ndlu solutions differ by "
                           f"{dx_paths:.3e} > {X_PATHS_TOL:.0e}")
    split = factor_split_ms(nd, dvals, "cavity tpu_direct tree")
    bD = dscale * R
    facs = nd.factor(dvals)
    solve_ms = median_ms(lambda: nd.solve(facs, bD), 10)
    solve_dev, solve_kern = device_ms(lambda: nd.solve(facs, bD), 5)
    fac_dev, fac_kern = device_ms(lambda: nd.factor(dvals), 3)
    log(f"tpu_direct: one factorization {sum(split.values()):.3f} ms (CUDA "
        f"events, the split above); one NDLU.solve {solve_ms:.3f} ms "
        f"(CUDA events); device time (torch.profiler): factorization "
        f"{fac_dev:.3f} ms in {fac_kern:.0f} kernels, NDLU.solve "
        f"{solve_dev:.3f} ms in {solve_kern:.0f} kernels")
    lap("10")

    # ---- 11. the front-gather kernel on both 64x64 trees
    gvals = scaled32(x0)
    gather_abs = max(check_gathers(solver.precond, gvals, "gmres+ndlu tree"),
                     check_gathers(nd, dvals, "tpu_direct tree"))
    gather_times(solver.precond, gvals, "gmres+ndlu tree")
    gather_times(nd, dvals, "tpu_direct tree")
    lap("11")

    # ---- 12. small cross-check of the buoyant deck: GPU vs CPU
    cross_check_buoyant8()
    lap("12")

    # ---- 13. the buoyant main path (48x48)
    t0 = time.perf_counter()
    bprob = buoyant_problem(N_BUOY, dev)
    bsolver = NewtonSolver(bprob, buoyant_opts())
    bnd = bsolver.precond
    blev = [(lev.nn, lev.smax, lev.bmax) for lev in bnd.levels]
    log(f"buoyant setup: {N_BUOY}x{N_BUOY}, {bprob.dofmap.n_dof} dof, "
        f"{bprob.pattern.nnz} nnz, {len(blev)} ND levels (nn, m, boundary) = "
        f"{blev}, {time.perf_counter() - t0:.1f} s")
    if not all(1 < m <= 1000 for _, m, _ in blev):
        raise RuntimeError("buoyant tree has a level outside 1 < s <= 1000")
    bparams = bprob.base_params()
    bx0 = torch.zeros(bprob.dofmap.n_dof, dtype=bprob.dtype, device=dev)
    bR, _, bscale, _ = bsolver._prepare_fast(bx0, bparams)
    bvals = bsolver._scaled_vals(bx0, bparams, bscale)
    # the front LU on the buoyant tree's own fronts (m up to 437), at the
    # state its one factorization runs at
    max_abs = max(max_abs, check_real_fronts(bnd, bvals, "buoyant x=0"))
    bshapes = [(nn, m) for nn, m, _ in blev]
    b_abs, b_lu_ms = lu_shapes(bshapes, "buoyant", time_twin=False)
    max_abs = max(max_abs, b_abs)
    b_lu_bnd = lu_bound(bshapes)
    factor_split_ms(bnd, bvals, "buoyant tree")
    # the substitution kernel on the buoyant tree (m up to 437, shapes the
    # cavity never shows): a second NDLU of the same pattern, ordering and
    # leaf size, built with invert=False as a tpu_direct solver builds its own
    bo = bsolver.opts
    bsub = NDLU(bprob.pattern, leaf_max=bo.ndlu_leaf_max, dtype=bnd.dtype,
                defer_dofs=_saddle_mask(bprob), invert=False,
                clusters=node_clusters(bprob) if bo.ndlu_cluster else None,
                device=dev)
    if [(lev.nn, lev.smax, lev.bmax) for lev in bsub.levels] != blev:
        raise RuntimeError("the invert=False buoyant NDLU has another tree "
                           "than the preconditioner's")
    bfacs_sub = bsub.factor(bvals)
    if not all(perm is None and fwd is bwd and fwd.shape == (nn, m, m)
               for (fwd, bwd, perm, _, _), (nn, m, _) in zip(bfacs_sub, blev)):
        raise RuntimeError("NDLU(invert=False).factor did not keep the packed "
                           "LU of every level")
    bcalls = []
    bsub.solve(bfacs_sub, bscale * bR, trace=bcalls)
    if len(bcalls) != 2 * len(blev):
        raise RuntimeError(f"one buoyant solve made {len(bcalls)} "
                           f"substitutions, not 2 x {len(blev)} levels")
    btrsv = check_substitutions(bcalls, "buoyant")
    btrsv_bnd = trsv_bound(bcalls)
    del bsub, bfacs_sub, bcalls
    gather_abs = max(gather_abs, check_gathers(bnd, bvals, "buoyant tree"))
    g_times, g_bound = gather_times(bnd, bvals, "buoyant tree")
    bres, _, ln = warm_then_timed(bsolver, np.zeros(bprob.dofmap.n_dof),
                                  bparams, "buoyant")
    b_lu, b_gather, b_trsv = ln["lu"], ln["gather"], ln["trsv"]
    if not bres.converged or bres.res_norms[-1][1] > 1e-6:
        raise RuntimeError("buoyant main path did not converge to 1e-6")
    if abs(bres.iters - BUOY_NEWTON) > 1:
        raise RuntimeError(f"buoyant main path took {bres.iters} Newton "
                           f"iterations, not {BUOY_NEWTON} +- 1")
    if bres.linear_iters != BUOY_LINEAR:
        raise RuntimeError(f"buoyant main path: linear iterations "
                           f"{bres.linear_iters} != {BUOY_LINEAR}")
    nf = bsolver.n_factor
    if nf < 1 or b_lu != len(blev) * nf or b_gather != len(blev) * nf:
        raise RuntimeError(f"buoyant front-LU launches {b_lu} / front-gather "
                           f"launches {b_gather} != {len(blev)} levels x {nf} "
                           "factorizations")
    bx = bres.x
    if bx.shape != (bprob.dofmap.n_dof,) or not np.all(np.isfinite(bx)):
        raise RuntimeError("buoyant solution has the wrong shape or "
                           "non-finite values")
    where_time_goes(bprob, bnd, bvals, bx0, bparams, "buoyant")
    del bsolver, bnd, bvals  # bprob stays for phase 25
    lap("13")

    # ---- 14. small cross-check of the viscoelastic deck: GPU vs CPU
    log(f"before the viscoelastic phases: {mem_line()}")
    cross_check_ve()
    lap("14")

    # ---- 15.-16. the viscoelastic main paths (64x32)
    ve = ve_gmres_phase(dev)
    lap("15")
    vd = ve_direct_phase(dev, ve.pop("prob"), ve["x"])
    lap("16")

    # ---- 17. the transient start-up (the 8x4 cross-check ran in phase 14)
    vt = ve_transient_phase(dev)
    lap("17")
    log(f"after the viscoelastic phases: {mem_line()}")

    # ---- 18. small cross-check of the static bubble: GPU vs CPU
    cross_check_bubble()
    lap("18")

    # ---- 19.-20. the static bubble's two rungs (48x48)
    tp = bubble_gmres_phase(dev)
    lap("19")
    td = bubble_direct_phase(dev, tp.pop("prob"), tp.pop("params"), tp["x"])
    lap("20")
    log(f"after the two-phase phases: {mem_line()}")

    # ---- 21. the pipelined Newton loop against the sequential one (64x64
    # cavity, phase 5's solver)
    pipe = pipelined_phase(solver, x_init, params)
    lap("21")

    # ---- 22. small cross-check of the ALE slot coater: GPU vs CPU
    cross_check_slot_coater()
    lap("22")

    # ---- 23.-24. the slot coater's two rungs (96x24)
    sc = slot_gmres_phase(dev)
    lap("23")
    sd = slot_direct_phase(dev, sc.pop("x"))
    lap("24")
    del sc["prob"]
    log(f"after the slot coater phases: {mem_line()}")

    # ---- 25. the buoyant deck's tpu_direct rung (48x48)
    bd_ln = buoyant_direct_phase(bprob, bx)
    lap("25")

    # ---- 26. goma_tpu's other preconditioners and solvers, 8x8 cuda vs cpu
    small_options_phase()
    lap("26")

    # ---- 27. the 64x64 cavity on bench.py's twolevel kind
    _, tl_linear = twolevel_phase(prob, "cavity twolevel", "cavity", x,
                                  TWOLEVEL_X_TOL, relative=False)
    lap("27")

    # ---- 28. the 48x48 buoyant deck on bench.py's third rung (twolevel)
    twolevel_phase(bprob, "buoyant twolevel", "buoyant", bx,
                   BUOY_TWOLEVEL_X_TOL, relative=True, warm_up=False)
    lap("28")
    del bprob
    log(f"after the two-level phases: {mem_line()}")

    # ---- 29. the 48x48 static bubble on the host direct rung
    bubble_host_direct_phase(dev, tp)
    lap("29")

    # ---- 30.-31. the axisymmetric die deck's two rungs (64x32)
    dg = die_gmres_phase(dev)
    lap("30")
    dd = die_direct_phase(dev, dg.pop("prob"), dg["x"])
    lap("31")
    log(f"after the die phases: {mem_line()}")

    # ---- 32. small axisymmetric, property-model and post-processing decks
    axisym_small_phase()
    lap("32")

    # ---- 33.-34. the tilted cavity's two rungs (64x64)
    tg = tilted_gmres_phase(dev, x, res.iters)
    lap("33")
    tdr = tilted_direct_phase(dev, tg["prob"], tg["x"])
    lap("34")

    # ---- 35. residual against assemble on the card, numjac
    residual_phase([("cavity 64x64", prob, x),
                    ("tilted 64x64", tg.pop("prob"), tg["x"])])
    lap("35")
    log(f"after the tilted phases: {mem_line()}")

    # ---- 36.-37. the periodic channel's two rungs (64x32)
    pg = periodic_gmres_phase(dev)
    lap("36")
    pdr = periodic_direct_phase(dev, pg.pop("prob"), pg["x"])
    lap("37")
    log(f"after the periodic phases: {mem_line()}")

    # ---- 38. small decks of this slice's conditions, cuda vs cpu
    bc_small_phase()
    lap("38")

    # ---- 39.-40. the 64x64 lid-speed continuation on both rungs
    t_cont = time.perf_counter()
    cg = continuation_phase(dev, "gmres_ndlu")
    cd = continuation_phase(dev, "tpu_direct")
    del cd["prob"], cd["steps"]

    # ---- 41.-42. the augmenting condition and the flux sensitivity
    ca = augmenting_phase(cg["prob"], cg["steps"])
    flux_phase(cg.pop("prob"), cg.pop("steps")[-1].x)

    # ---- 43.-44. the Bratu fold; bifurcations and stability
    bratu_phase(dev)
    stability_phase(dev)
    log(f"phases 39-44 (continuation and stability): "
        f"{time.perf_counter() - t_cont:.1f} s; {mem_line()}")
    lap("39-44")

    # ---- 45.-46. the 96x48 immersed cylinder (overset multipliers) on both
    # rungs; 47. the small coupling-set decks, cuda and cpu
    t_ovs = time.perf_counter()
    og = overset_phase(dev, "gmres+ndlu")
    od = overset_phase(dev, "tpu_direct", og.pop("prob"), og.pop("bi"))
    ovs = (od.pop("prob"), od.pop("bi"))  # phase 66 solves it again
    bl = overset_small_phase()
    log(f"phases 45-47 (coupling sets): {time.perf_counter() - t_ovs:.1f} s; "
        f"{mem_line()}")
    lap("45-47")

    # ---- 48.-49. the 64x64 thermal slider bearing and drying film (surface
    # shells) on both rungs; 50. the small shell decks on the card
    t_sh = time.perf_counter()
    sbg = bearing_phase(dev, "gmres+ndlu")
    sbd = bearing_phase(dev, "tpu_direct", sbg.pop("prob"))
    del sbd["prob"]
    sfg = film_phase(dev, "gmres+ndlu")
    sfd = film_phase(dev, "tpu_direct", sfg.pop("prob"), sfg.pop("x0"))
    del sfd["prob"], sfd["x0"]
    shell_small_phase()
    log(f"phases 48-50 (shells and lubrication): "
        f"{time.perf_counter() - t_sh:.1f} s; {mem_line()}")
    lap("48-50")

    # ---- 51.-52. the 128x128 edge-element cavity and the 160x32 nodal
    # waveguide on both rungs; 53. the small decks of the slice on the card
    t_em = time.perf_counter()
    ecg = em_phase(dev, "cavity", "gmres+ndlu")
    ecd = em_phase(dev, "cavity", "tpu_direct", ecg.pop("prob"))
    del ecd["prob"]
    ewg = em_phase(dev, "waveguide", "gmres+ndlu")
    ewd = em_phase(dev, "waveguide", "tpu_direct", ewg.pop("prob"))
    del ewd["prob"]
    em_small_phase()
    log(f"phases 51-53 (Nedelec, EM and electrochemistry): "
        f"{time.perf_counter() - t_em:.1f} s; {mem_line()}")
    lap("51-53")

    # ---- 54-56. solid mechanics and porous media
    fsa, fsg, fsd, rcg, rcd = solid_phases(dev)
    lap("54-56")

    # ---- 57-59. closures: suspensions, kinetics, PLACID, QMOM, SA
    clsg, clsd, clrg, clrd = closure_phases(dev)
    lap("57-59")

    # ---- 60-62. fluid and level-set conditions: the laser melt pool and
    # the wetting drop on both rungs, the small decks on cuda and cpu
    lsmg, lsmd, lsdg, lsdd = ls_phases(dev)
    lap("60-62")

    # ---- 63-65. derived fields, particle tracing, the projection and
    # segregated drivers: the projection cavity and the three-matrix
    # buoyant cavity on both rungs, the small decks on cuda and cpu
    spg, spd, ssg, ssd = split_phases(dev)
    lap("63-65")

    # ---- 66. NDLU's pivoted front LUs (the cylinder on pivoted fronts, a
    # tree mixing kernel and pivoted levels) and GCRO-DR recycling
    piv = pivoted_phases(dev, prob, x, xd, ovs, (og["newton"], og["linear"]),
                         tl_linear)
    del ovs
    lap("66")

    # ---- kernel summary
    trsv_bnd = trsv_bound(calls)
    more_paths = {"viscoelastic gmres+ndlu": ve["launches"],
                "viscoelastic tpu_direct": vd["launches"],
                "viscoelastic transient": vt,
                "two-phase gmres_ndlu": tp["launches"],
                "two-phase tpu_direct": td["launches"],
                "cavity pipelined": pipe["pipelined"],
                "cavity sequential": pipe["sequential"],
                "slot coater gmres_ndlu": sc["launches"],
                "slot coater tpu_direct": sd["launches"],
                "buoyant tpu_direct": bd_ln,
                "die gmres_ndlu": dg["launches"],
                "die tpu_direct": dd["launches"],
                "tilted gmres_ndlu": tg["launches"],
                "tilted tpu_direct": tdr["launches"],
                "periodic gmres_ndlu": pg["launches"],
                "periodic tpu_direct": pdr["launches"],
                "continuation gmres_ndlu": cg["launches"],
                "continuation tpu_direct": cd["launches"],
                "augmenting condition gmres_ndlu": ca["launches"],
                "overset gmres_ndlu": og["launches"],
                "overset tpu_direct": od["launches"],
                "bearing gmres_ndlu": sbg["launches"],
                "bearing tpu_direct": sbd["launches"],
                "film gmres_ndlu": sfg["launches"],
                "film tpu_direct": sfd["launches"],
                "em cavity gmres_ndlu": ecg["launches"],
                "em cavity tpu_direct": ecd["launches"],
                "em waveguide gmres_ndlu": ewg["launches"],
                "em waveguide tpu_direct": ewd["launches"],
                "fsi linear tpu_direct": fsa["launches"],
                "fsi gmres_ndlu": fsg["launches"],
                "fsi tpu_direct": fsd["launches"],
                "richards gmres_ndlu": rcg["launches"],
                "richards tpu_direct": rcd["launches"],
                "suspension gmres_ndlu": clsg["launches"],
                "suspension tpu_direct": clsd["launches"],
                "reacting gmres_ndlu": clrg["launches"],
                "reacting tpu_direct": clrd["launches"],
                "melt pool gmres_ndlu": lsmg["launches"],
                "melt pool tpu_direct": lsmd["launches"],
                "wetting drop gmres_ndlu": lsdg["launches"],
                "wetting drop tpu_direct": lsdd["launches"],
                "projection gmres_ndlu": spg["launches"],
                "projection tpu_direct": spd["launches"],
                "segregated gmres_ndlu": ssg["launches"],
                "segregated tpu_direct": ssd["launches"],
                **{k: v["launches"] for k, v in piv.items()}}
    # a small deck's launches, read as a cross-check: not a main path
    cross_checks = {"bordered ndlu 20x10": bl}

    def deck_keys(prefix, rec, kind):
        """A deck's numbers of one kernel for the summary line."""
        if kind == "lu":
            t, b = rec["lu_ms"][torch.float32], rec["lu_bound"]
            return {f"{prefix}_ms": t[0], f"{prefix}_plain_ms": t[1],
                    f"{prefix}_library_ms": t[2], f"{prefix}_bound_ms": b[0]}
        if kind == "gather":
            t = rec["g_times"]
            return {f"{prefix}_ms": t["kernel"][0],
                    f"{prefix}_plain_ms": t["plain"][0],
                    f"{prefix}_library_ms": t["index_select"][0],
                    f"{prefix}_bound_ms": rec["g_bound"][0]}
        t = rec["trsv"]
        return {f"{prefix}_ms": t["ms"][torch.float32][0],
                f"{prefix}_plain_ms": t["ms"][torch.float32][1],
                f"{prefix}_library_ms": t["ms"][torch.float32][2],
                f"{prefix}_bound_ms": rec["bound"][0],
                f"{prefix}_device_ms": t["device_ms"]["kernel"],
                f"{prefix}_library_device_ms": t["device_ms"]["solve_triangular"],
                f"{prefix}_step_ns": rec["step_ns"]}

    def split_abs(key):
        """The largest kernel-vs-plain difference of phases 63-64's trees."""
        recs = [t for r in (spg, spd, ssg, ssd) for t in r["trees"].values()]
        if key == "trsv":
            return max(t["trsv"]["max_abs"] for t in recs if "trsv" in t)
        return max(t[key] for t in recs)

    def path_launches(kind):
        return {k: ln[kind] for k, ln in more_paths.items()}

    def cross_check_launches(kind):
        return {k: ln[kind] for k, ln in cross_checks.items()}
    print(json.dumps({"kernels": [{
        "name": "batched_lu",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/batched_lu.cu",
        "replaces": "goma_tpu/solvers/pallas_lu.py:39",
        "launches": launches + d_lu + b_lu + sum(path_launches("lu").values()),
        "launches_by_path": {"gmres+ndlu": launches, "tpu_direct": d_lu,
                             "buoyant gmres+ndlu": b_lu, **path_launches("lu")},
        "cross_check_launches": cross_check_launches("lu"),
        "max_abs_err": max(max_abs, ve["max_abs"], vd["max_abs"],
                           tp["max_abs"], sc["max_abs"], sd["max_abs"],
                           dg["max_abs"], dd["max_abs"], tg["max_abs"],
                           tdr["max_abs"], pg["max_abs"], pdr["max_abs"],
                           cg["max_abs"], cd["max_abs"], og["max_abs"],
                           od["max_abs"], sbg["max_abs"], sbd["max_abs"],
                           sfg["max_abs"], sfd["max_abs"], ecg["max_abs"],
                           ecd["max_abs"], ewg["max_abs"], ewd["max_abs"],
                           fsa["max_abs"], fsg["max_abs"], fsd["max_abs"],
                           rcg["max_abs"], rcd["max_abs"], clsg["max_abs"],
                           clsd["max_abs"], clrg["max_abs"],
                           clrd["max_abs"], lsmg["max_abs"], lsmd["max_abs"],
                           lsdg["max_abs"], lsdd["max_abs"],
                           split_abs("max_abs")),
        "ms": lu_ms[torch.float32][0],
        "plain_ms": lu_ms[torch.float32][1],
        "bound_ms": lu_bnd[0],
        "bound_by": lu_bnd[1],
        "library_ms": lu_ms[torch.float32][2],
        "buoyant_ms": b_lu_ms[torch.float32][0],
        "buoyant_library_ms": b_lu_ms[torch.float32][2],
        "buoyant_bound_ms": b_lu_bnd[0],
        "viscoelastic_ms": ve["lu_ms"][torch.float32][0],
        "viscoelastic_plain_ms": ve["lu_ms"][torch.float32][1],
        "viscoelastic_library_ms": ve["lu_ms"][torch.float32][2],
        "viscoelastic_bound_ms": ve["lu_bound"][0],
        "two_phase_ms": tp["lu_ms"][torch.float32][0],
        "two_phase_plain_ms": tp["lu_ms"][torch.float32][1],
        "two_phase_library_ms": tp["lu_ms"][torch.float32][2],
        "two_phase_bound_ms": tp["lu_bound"][0],
        "slot_coater_ms": sc["lu_ms"][torch.float32][0],
        "slot_coater_plain_ms": sc["lu_ms"][torch.float32][1],
        "slot_coater_library_ms": sc["lu_ms"][torch.float32][2],
        "slot_coater_bound_ms": sc["lu_bound"][0],
        "die_ms": dg["lu_ms"][torch.float32][0],
        "die_plain_ms": dg["lu_ms"][torch.float32][1],
        "die_library_ms": dg["lu_ms"][torch.float32][2],
        "die_bound_ms": dg["lu_bound"][0],
        **deck_keys("tilted", tg, "lu"),
        **deck_keys("periodic", pg, "lu"),
        **deck_keys("overset", og, "lu"),
        **deck_keys("bearing", sbg, "lu"),
        **deck_keys("film", sfg, "lu"),
        **deck_keys("em_cavity", ecg, "lu"),
        **deck_keys("em_waveguide", ewg, "lu"),
        **deck_keys("fsi", fsg, "lu"),
        **deck_keys("richards", rcg, "lu"),
        **deck_keys("suspension", clsg, "lu"),
        **deck_keys("reacting", clrg, "lu"),
        **deck_keys("melt_pool", lsmg, "lu"),
        **deck_keys("wetting_drop", lsdg, "lu"),
    }, {
        "name": "batched_trsv",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/batched_trsv.cu",
        "replaces": "goma_tpu/solvers/pallas_lu.py:67",
        "launches": d_trsv + b_trsv + sum(path_launches("trsv").values()),
        "launches_by_path": {"tpu_direct": d_trsv, **path_launches("trsv")},
        "cross_check_launches": cross_check_launches("trsv"),
        "max_abs_err": max(trsv["max_abs"], btrsv["max_abs"],
                           vd["trsv"]["max_abs"], td["trsv"]["max_abs"],
                           sd["trsv"]["max_abs"], dd["trsv"]["max_abs"],
                           tdr["trsv"]["max_abs"], pdr["trsv"]["max_abs"],
                           cd["trsv"]["max_abs"], od["trsv"]["max_abs"],
                           sbd["trsv"]["max_abs"], sfd["trsv"]["max_abs"],
                           ecd["trsv"]["max_abs"], ewd["trsv"]["max_abs"],
                           fsa["trsv"]["max_abs"], fsd["trsv"]["max_abs"],
                           rcd["trsv"]["max_abs"], clsd["trsv"]["max_abs"],
                           clrd["trsv"]["max_abs"], lsmd["trsv"]["max_abs"],
                           lsdd["trsv"]["max_abs"], split_abs("trsv")),
        "ms": trsv["ms"][torch.float32][0],
        "plain_ms": trsv["ms"][torch.float32][1],
        "bound_ms": trsv_bnd[0],
        "bound_by": trsv_bnd[1],
        "library_ms": trsv["ms"][torch.float32][2],
        "device_ms": trsv["device_ms"]["kernel"],
        "library_device_ms": trsv["device_ms"]["solve_triangular"],
        "run_ms": trsv["run_ms"],
        "host_us_per_call": trsv["host_us"],
        "step_ns": step_ns,
        "chain_floor_ms": chain_floor_ms,
        "buoyant_ms": btrsv["ms"][torch.float32][0],
        "buoyant_library_ms": btrsv["ms"][torch.float32][2],
        "buoyant_bound_ms": btrsv_bnd[0],
        "buoyant_device_ms": btrsv["device_ms"]["kernel"],
        "buoyant_library_device_ms": btrsv["device_ms"]["solve_triangular"],
        "viscoelastic_ms": vd["trsv"]["ms"][torch.float32][0],
        "viscoelastic_plain_ms": vd["trsv"]["ms"][torch.float32][1],
        "viscoelastic_library_ms": vd["trsv"]["ms"][torch.float32][2],
        "viscoelastic_bound_ms": vd["bound"][0],
        "viscoelastic_device_ms": vd["trsv"]["device_ms"]["kernel"],
        "viscoelastic_library_device_ms":
            vd["trsv"]["device_ms"]["solve_triangular"],
        "viscoelastic_step_ns": vd["step_ns"],
        "two_phase_ms": td["trsv"]["ms"][torch.float32][0],
        "two_phase_plain_ms": td["trsv"]["ms"][torch.float32][1],
        "two_phase_library_ms": td["trsv"]["ms"][torch.float32][2],
        "two_phase_bound_ms": td["bound"][0],
        "two_phase_device_ms": td["trsv"]["device_ms"]["kernel"],
        "two_phase_library_device_ms":
            td["trsv"]["device_ms"]["solve_triangular"],
        "slot_coater_ms": sd["trsv"]["ms"][torch.float32][0],
        "slot_coater_plain_ms": sd["trsv"]["ms"][torch.float32][1],
        "slot_coater_library_ms": sd["trsv"]["ms"][torch.float32][2],
        "slot_coater_bound_ms": sd["bound"][0],
        "slot_coater_device_ms": sd["trsv"]["device_ms"]["kernel"],
        "slot_coater_library_device_ms":
            sd["trsv"]["device_ms"]["solve_triangular"],
        "slot_coater_step_ns": sd["step_ns"],
        "die_ms": dd["trsv"]["ms"][torch.float32][0],
        "die_plain_ms": dd["trsv"]["ms"][torch.float32][1],
        "die_library_ms": dd["trsv"]["ms"][torch.float32][2],
        "die_bound_ms": dd["bound"][0],
        "die_device_ms": dd["trsv"]["device_ms"]["kernel"],
        "die_library_device_ms": dd["trsv"]["device_ms"]["solve_triangular"],
        "die_step_ns": dd["step_ns"],
        **deck_keys("tilted", tdr, "trsv"),
        **deck_keys("periodic", pdr, "trsv"),
        **deck_keys("overset", od, "trsv"),
        **deck_keys("bearing", sbd, "trsv"),
        **deck_keys("film", sfd, "trsv"),
        **deck_keys("em_cavity", ecd, "trsv"),
        **deck_keys("em_waveguide", ewd, "trsv"),
        **deck_keys("fsi", fsd, "trsv"),
        **deck_keys("richards", rcd, "trsv"),
        **deck_keys("suspension", clsd, "trsv"),
        **deck_keys("reacting", clrd, "trsv"),
        **deck_keys("melt_pool", lsmd, "trsv"),
        **deck_keys("wetting_drop", lsdd, "trsv"),
    }, {
        "name": "front_gather",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/front_gather.cu",
        "replaces": "scripts/attic/exp_front_gather.py:130",
        "launches": (g_launches + d_gather + b_gather
                     + sum(path_launches("gather").values())),
        "launches_by_path": {"gmres+ndlu": g_launches, "tpu_direct": d_gather,
                             "buoyant gmres+ndlu": b_gather,
                             **path_launches("gather")},
        "cross_check_launches": cross_check_launches("gather"),
        "max_abs_err": max(gather_abs, ve["gather_abs"], tp["gather_abs"],
                           sc["gather_abs"], sd["gather_abs"],
                           dg["gather_abs"], dd["gather_abs"],
                           tg["gather_abs"], tdr["gather_abs"],
                           pg["gather_abs"], pdr["gather_abs"],
                           cg["gather_abs"], cd["gather_abs"],
                           og["gather_abs"], od["gather_abs"],
                           sbg["gather_abs"], sbd["gather_abs"],
                           sfg["gather_abs"], sfd["gather_abs"],
                           ecg["gather_abs"], ecd["gather_abs"],
                           ewg["gather_abs"], ewd["gather_abs"],
                           fsa["gather_abs"], fsg["gather_abs"],
                           fsd["gather_abs"],
                           rcg["gather_abs"], rcd["gather_abs"],
                           clsg["gather_abs"], clsd["gather_abs"],
                           clrg["gather_abs"], clrd["gather_abs"],
                           lsmg["gather_abs"], lsmd["gather_abs"],
                           lsdg["gather_abs"], lsdd["gather_abs"],
                           split_abs("gather_abs")),
        "ms": g_times["kernel"][0],
        "plain_ms": g_times["plain"][0],
        "bound_ms": g_bound[0],
        "bound_by": g_bound[1],
        "library_ms": g_times["index_select"][0],
        "viscoelastic_ms": ve["g_times"]["kernel"][0],
        "viscoelastic_plain_ms": ve["g_times"]["plain"][0],
        "viscoelastic_library_ms": ve["g_times"]["index_select"][0],
        "viscoelastic_bound_ms": ve["g_bound"][0],
        "two_phase_ms": tp["g_times"]["kernel"][0],
        "two_phase_plain_ms": tp["g_times"]["plain"][0],
        "two_phase_library_ms": tp["g_times"]["index_select"][0],
        "two_phase_bound_ms": tp["g_bound"][0],
        "slot_coater_ms": sc["g_times"]["kernel"][0],
        "slot_coater_plain_ms": sc["g_times"]["plain"][0],
        "slot_coater_library_ms": sc["g_times"]["index_select"][0],
        "slot_coater_bound_ms": sc["g_bound"][0],
        "die_ms": dg["g_times"]["kernel"][0],
        "die_plain_ms": dg["g_times"]["plain"][0],
        "die_library_ms": dg["g_times"]["index_select"][0],
        "die_bound_ms": dg["g_bound"][0],
        **deck_keys("tilted", tg, "gather"),
        **deck_keys("periodic", pg, "gather"),
        **deck_keys("overset", og, "gather"),
        **deck_keys("bearing", sbg, "gather"),
        **deck_keys("film", sfg, "gather"),
        **deck_keys("em_cavity", ecg, "gather"),
        **deck_keys("em_waveguide", ewg, "gather"),
        **deck_keys("fsi", fsg, "gather"),
        **deck_keys("richards", rcg, "gather"),
        **deck_keys("suspension", clsg, "gather"),
        **deck_keys("reacting", clrg, "gather"),
        **deck_keys("melt_pool", lsmg, "gather"),
        **deck_keys("wetting_drop", lsdg, "gather"),
    }]}))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
