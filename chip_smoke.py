#!/usr/bin/env python3
"""GPU smoke run of goma_tpu_torch, the PyTorch/CUDA port of goma_tpu.

    python3 chip_smoke.py

Needs one CUDA device (NVIDIA H100, sm_90a) and nvcc; exits non-zero on any
failure and when CUDA is unavailable. Three main paths, each read with its
own launch counts: the cavity's ``gmres+ndlu`` (phases 2-6) and
``tpu_direct`` (phases 8-10), and the buoyant-convection deck's
``gmres+ndlu`` (phases 12-13). Phases:

1. build every kernel, one nvcc per source, all started together: the
   front LU ``goma_tpu_torch/csrc/batched_lu.cu``, the front substitution
   ``goma_tpu_torch/csrc/batched_trsv.cu`` and the front gather
   ``goma_tpu_torch/csrc/front_gather.cu`` (sm_90a); print each build time
   and ptxas report (phase 7's build is this one);
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
   more device time than the library); in total also the host time per
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
    the gather times of phase 11 on its tree.

The last three lines of output: the kernel summary (JSON, with each
kernel's bound, plain-version and library-call times), the card's name and
power limit (nvidia-smi), and ``{"ok": true, "device": ...}``.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Tolerances of kernel vs twin, relative to max|twin LU|. The two run the
# same operations in the same dtype and differ only in FMA contraction (one
# rounding per update in the kernel, two in the twin), amplified by the
# growth of unpivoted elimination. The fronts checked here have growth
# max|LU|/max|A| <= 1.07 on the cavity and <= 2.09 on the buoyant tree. On
# the H100 the largest float32 reading over every real ND level is 2.45e-6
# (the cavity's top front, m=323, whose own float32 rounding floor against
# float64 is 1.9e-4); all other fronts, the buoyant tree's m=437 top front
# included, read <= 2.5e-7. The float32 limit sits 8x above that reading
# and 10x below that floor. float64: readings <= 3.6e-15 (1e-16 roundoff).
# Fronts with large growth (random Gaussian fronts without a weighted
# diagonal reach 1e4-1e6) push any two float32 orderings apart by O(1);
# they are not what the main path factors, so they are not checked here.
TOL = {torch.float32: 2e-5, torch.float64: 1e-11}
# The kernel's float32 LU must be as accurate as the twin's: its distance
# from the float64 twin at most this multiple of the twin's (readings
# <= 1.05 on the real fronts).
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
# twin's in those readings, mostly 0.3-0.7x (ACC_RATIO allows 2x).
TRSV_TOL = {torch.float32: 2e-6, torch.float64: 2e-14}
# max |x_tpu_direct - x_gmres| over the 64x64 solution: both paths stop at
# ||R||_2 <= 1e-6, GMRES's last inexact step at 6.3e-7 and tpu_direct's at
# 6.8e-9, so they differ by the GMRES endpoint's error. H100 reading
# 1.36e-5; the limit sits ~4x above.
X_PATHS_TOL = 5e-5
# device_ms's guard tensor and its kernel's name (_guard_kernel)
_GUARD = []


def log(msg):
    print(msg, flush=True)


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
    """bench._cavity_opts("gmres+ndlu") restated (bench.py imports jax)."""
    from goma_tpu_torch.solvers import NewtonOptions

    return NewtonOptions(max_iter=max_iter, tol_residual=tol, linear_tol=1e-4,
                         precond="ndlu", linear_solver="gmres",
                         gmres_restart=60, linear_maxiter=240,
                         ndlu_leaf_max=192, prep32_tol=3e-6,
                         ew_eta_floor=0.0, ew_endgame="tighten")


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


def check_kernel(A, name):
    """Kernel vs twin on one batch; returns (kernel LU, twin LU, max abs
    err, rel err)."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu, batched_lu_reference

    before = batched_lu.launches
    got = batched_lu(A)
    torch.cuda.synchronize()
    if batched_lu.launches != before + 1:
        raise RuntimeError(f"{name}: the kernel did not launch")
    ref = batched_lu_reference(A)
    abs_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = abs_err / scale
    if not np.isfinite(rel) or rel > TOL[A.dtype]:
        raise RuntimeError(f"{name}: kernel vs twin rel err {rel:.3e} > "
                           f"{TOL[A.dtype]:.0e}")
    return got, ref, abs_err, rel


def lu_shapes(shapes, label, time_twin):
    """Phase 3 (and 13): the front-LU kernel against its twin on random
    boosted fronts at every (nn, m) level shape, float32 and float64; the
    kernel's launch plan against the wrapper's; median CUDA-event ms of the
    kernel, the twin (``time_twin``) and ``lu_factor_ex(pivot=False)`` per
    shape. Returns (max abs err, {dtype: [kernel, twin, library] ms summed
    over the shapes})."""
    from goma_tpu_torch.solvers.batched_lu import (_plan, batched_lu,
                                                   batched_lu_reference,
                                                   kernel_plan)

    max_abs = 0.0
    tot = {dt: [0.0, 0.0, 0.0] for dt in (torch.float32, torch.float64)}
    for dt in (torch.float32, torch.float64):
        for nn, m in shapes:
            plan = kernel_plan(nn, m, dt)
            if plan[:4] != _plan(nn, m, dt) or plan[4] < 1:
                raise RuntimeError(f"batched_lu ({nn},{m}) {dt}: kernel plan "
                                   f"{plan} != wrapper plan {_plan(nn, m, dt)}")
            A = torch.as_tensor(boosted_fronts(nn, m, seed=m), dtype=dt,
                                device="cuda")
            _, _, a_err, rel = check_kernel(A, f"{label} {dt} ({nn},{m})")
            max_abs = max(max_abs, a_err)
            k_ms = median_ms(lambda: batched_lu(A), 20)
            p_ms = median_ms(lambda: batched_lu_reference(A), 5) if time_twin \
                else float("nan")
            # the library's unpivoted batched LU: no GESP boost, so it
            # computes the same function only where no pivot is boosted
            l_ms = median_ms(lambda: torch.linalg.lu_factor_ex(A, pivot=False), 20)
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
    return max_abs, tot


def check_real_fronts(nd, vals, label):
    """Kernel vs twin on the real fully-summed block of every ND level of
    ``nd`` for the equilibrated CSR values ``vals``: each level's front
    assembled on the card from the values and the children's Schur
    complements, exactly as NDLU.factor does, in the factor dtype (float32),
    and the same blocks cast to float64. For float32 it also prints the
    distance of kernel and twin from the float64 twin on the same block:
    the float32 rounding floor, which the kernel must share with the twin.
    Returns the max abs error."""
    vals_ext = nd.front_values(vals)
    max_abs = 0.0
    S = None
    for li, lev in enumerate(nd.levels):
        F = nd.front(li, vals_ext, S)
        A = F[:, :lev.smax, :lev.smax].contiguous()
        got, ref, a_err, rel = check_kernel(A, f"{label} level {li} real fronts")
        a64 = A.double()
        _, exact, a_err64, rel64 = check_kernel(a64, f"{label} level {li} "
                                                "real fronts float64")
        sc = exact.abs().max().item()
        k64 = (got.double() - exact).abs().max().item() / sc
        t64 = (ref.double() - exact).abs().max().item() / sc
        grow = sc / a64.abs().max().item()
        if k64 > ACC_RATIO * t64:
            raise RuntimeError(f"{label} level {li}: float32 kernel is {k64:.2e} "
                               f"from float64, the twin {t64:.2e}")
        log(f"real fronts {label} level {li} (nn={lev.nn:3d}, m={lev.smax:3d}): "
            f"max|LU|/max|A| {grow:.2e}; float32 kernel vs twin {rel:.2e} "
            f"(kernel vs float64 {k64:.2e}, twin vs float64 {t64:.2e}); "
            f"float64 kernel vs twin {rel64:.2e}")
        max_abs = max(max_abs, a_err, a_err64)
        _, S = nd.factor_level(li, F)
    return max_abs


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


def device_ms(fn, reps, launches=None):
    """Device time per call of ``fn`` (sum of its kernels' durations, ms;
    the mean over ``reps`` calls) and kernels launched per call, from
    torch.profiler, after one warm-up call. Unlike CUDA events around a
    call, this leaves out the host's launch overhead and the device's idle
    gaps.

    The profiler at times comes back without the record of the first
    kernel launched in a window, for many windows in a row (a window of one
    kernel is then empty, one of five reads 0.8x). So every call gets a
    window of its own that opens with two guard kernels (``_guard_kernel``)
    and closes with one; the guards' records are taken off by name. Only
    complete windows count and nothing is scaled. A window is complete when
    its first record is a guard's and it holds ``launches`` other records,
    where the caller knows how many kernels one call launches; otherwise
    the most other records seen in any window, with at least two windows
    holding that many (lost records do not repeat the same count at the
    top). Up to ``reps + 12`` windows are taken until ``reps`` are
    complete; failing that, or on a window with more than ``launches``
    records, it raises with the counts seen. Windows left out are
    logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    guard, guard_name = _guard_kernel()
    fn()
    torch.cuda.synchronize()
    need = reps if launches is not None else max(reps, 2)
    counts, totals, full = [], [], []
    for _ in range(reps + 12):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            guard.bitwise_xor_(1)
            guard.bitwise_xor_(1)
            fn()
            guard.bitwise_xor_(1)
            torch.cuda.synchronize()
        seen = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        inner = [e for e in seen if e.name != guard_name]
        if not seen or seen[0].name != guard_name:
            inner = []  # the record lost at the start may be one of fn's
        counts.append(len(inner))
        totals.append(sum(e.device_time_total for e in inner) / 1000.0)
        per_call = launches if launches is not None else max(counts)
        if counts[-1] > per_call:
            break
        if counts[-1] < per_call:
            time.sleep(0.05)
        full = [t for c, t in zip(counts, totals) if c == per_call]
        if per_call > 0 and len(full) >= need:
            if len(full) < len(counts):
                log(f"device_ms: {len(counts) - len(full)} of {len(counts)} "
                    f"profiler windows lacked records and were left out "
                    f"(records per window {counts})")
            return sum(full) / len(full), per_call
    raise RuntimeError("torch.profiler gave too few complete windows of "
                       f"kernel records: wanted {need} with "
                       f"{launches if launches is not None else 'the same top'}"
                       f" records each, saw {counts}")


def check_trsv(lu, rhs, lower, name):
    """Substitution kernel vs twin on one batch; returns (kernel x, twin x,
    max abs err, rel err)."""
    from goma_tpu_torch.solvers.batched_trsv import (batched_trsv,
                                                     batched_trsv_reference)

    before = batched_trsv.launches
    got = batched_trsv(lu, rhs, lower)
    torch.cuda.synchronize()
    if batched_trsv.launches != before + 1:
        raise RuntimeError(f"{name}: the substitution kernel did not launch")
    ref = batched_trsv_reference(lu, rhs, lower)
    abs_err = (got - ref).abs().max().item()
    rel = abs_err / ref.abs().max().item()
    if not np.isfinite(rel) or rel > TRSV_TOL[lu.dtype]:
        raise RuntimeError(f"{name}: substitution kernel vs twin rel err "
                           f"{rel:.3e} > {TRSV_TOL[lu.dtype]:.0e}")
    return got, ref, abs_err, rel


def check_substitutions(calls, label):
    """Phase 8 (and 13): kernel vs twin on every recorded substitution
    (float32 as recorded, and cast to float64), with its real right-hand
    side and a seeded random one; the float32 kernel must be as accurate as
    the float32 twin against the float64 twin; the kernel's launch plan
    must be the wrapper's; on no level may the kernel take more device time
    than ``torch.linalg.solve_triangular``. Returns {"max_abs", "ms":
    per-dtype [kernel, twin, solve_triangular] sums of per-call CUDA-event
    medians, "device_ms": {"kernel", "solve_triangular"} for one float32
    solve's calls by the profiler, "run_ms": CUDA events around one solve's kernel calls,
    "host_us": (run_ms - kernel device ms) per call}."""
    from goma_tpu_torch.solvers.batched_trsv import (_plan, batched_trsv,
                                                     batched_trsv_reference,
                                                     kernel_plan)

    def lib(lu, rhs, lower):
        return torch.linalg.solve_triangular(lu, rhs.unsqueeze(2),
                                             upper=not lower,
                                             unitriangular=lower)

    max_abs = 0.0
    tot = {dt: [0.0, 0.0, 0.0] for dt in (torch.float32, torch.float64)}
    n_lev = len(calls) // 2
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
        errs = []
        for kind, rhs in (("real", seg32.double()), ("random", rnd)):
            name = f"trsv {label} level {li} (nn={nn}, m={m}) {sweep} {kind}"
            got, ref, a32, r32 = check_trsv(lu32, rhs.float(), lower, name)
            _, exact, a64, r64 = check_trsv(lu64, rhs, lower, name + " float64")
            sc = exact.abs().max().item()
            k64 = (got.double() - exact).abs().max().item() / sc
            t64 = (ref.double() - exact).abs().max().item() / sc
            # a float32 unit roundoff floor keeps a twin that happens to land
            # exactly from failing the ratio on a last-bit difference
            if k64 > ACC_RATIO * max(t64, 2.0 ** -24):
                raise RuntimeError(f"{name}: float32 kernel is {k64:.2e} from "
                                   f"float64, the twin {t64:.2e}")
            errs.append(f"{kind} f32 {r32:.2e} (kernel/twin vs f64 {k64:.2e}/"
                        f"{t64:.2e}) f64 {r64:.2e}")
            max_abs = max(max_abs, a32, a64)
        ms = []
        for dt, lu, rhs in ((torch.float32, lu32, seg32),
                            (torch.float64, lu64, seg32.double())):
            t = (median_ms(lambda: batched_trsv(lu, rhs, lower), 20),
                 median_ms(lambda: batched_trsv_reference(lu, rhs, lower), 3),
                 median_ms(lambda: lib(lu, rhs, lower), 20))
            tot[dt] = [a + b for a, b in zip(tot[dt], t)]
            ms.append(t)
        k_dev = device_ms(lambda: batched_trsv(lu32, seg32, lower), 5, 1)[0]
        l_dev, l_kern = device_ms(lambda: lib(lu32, seg32, lower), 5)
        log(f"trsv {label} level {li} (nn={nn:3d}, m={m:3d}) {sweep}: "
            f"{plan[2]} threads, {plan[3]} B shared, {plan[4]} CTAs an SM; "
            f"{'; '.join(errs)}; ms f32 kernel/twin/solve_triangular "
            f"{ms[0][0]:.3f}/{ms[0][1]:.3f}/{ms[0][2]:.3f}, f64 {ms[1][0]:.3f}/"
            f"{ms[1][1]:.3f}/{ms[1][2]:.3f}; f32 device ms kernel "
            f"{k_dev:.4f} (1 record a call), solve_triangular {l_dev:.4f} "
            f"({l_kern} records a call), bound "
            f"{trsv_bound([(lu32, seg32, lower)])[0]:.5f}")
        if k_dev > l_dev:
            raise RuntimeError(f"trsv {label} level {li} {sweep}: the kernel "
                               f"takes {k_dev:.4f} ms of device time, "
                               f"solve_triangular {l_dev:.4f}")
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
    dev = {k: device_ms(fn, 5, len(calls) if k == "kernel" else None)
           for k, fn in runs.items()}
    run_ms = median_ms(runs["kernel"], 20)
    host_us = 1e3 * (run_ms - dev["kernel"][0]) / len(calls)
    log(f"trsv {label}: one solve's substitutions, float32, device time "
        "(torch.profiler, complete windows only): "
        + ", ".join(f"{k} {ms:.3f} ms in {n} kernels a call"
                    for k, (ms, n) in dev.items())
        + f"; CUDA events around the {len(calls)} kernel calls {run_ms:.3f} ms"
        f", i.e. {host_us:.1f} us of host time per call above the kernel")
    return {"max_abs": max_abs, "ms": tot,
            "device_ms": {k: ms for k, (ms, _) in dev.items()},
            "run_ms": run_ms, "host_us": host_us}


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
    LU (``NDLU.front_lu``) and inverses or X/Y + Schur
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
            lu = nd.front_lu(li, F)
            ev[4 * li + 3].record()
            _, S = nd.factor_rest(li, F, lu)
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
    abs difference (0)."""
    from goma_tpu_torch.solvers.front_gather import (front_gather,
                                                     front_gather_reference)

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
    out = {k: (median_ms(fn, 10), device_ms(fn, 5)[0]) for k, fn in runs.items()}
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


def cross_check_8x8(opts_fn, label):
    """Phases 4 and 9: the 8x8 cavity on cuda and on cpu, same options."""
    from goma_tpu_torch.solvers import NewtonSolver

    its, xs = {}, {}
    for d in ("cuda", "cpu"):
        p8 = cavity_problem(8, torch.device(d))
        r8 = NewtonSolver(p8, opts_fn()).solve(np.zeros(p8.dofmap.n_dof),
                                               p8.base_params())
        if not r8.converged:
            raise RuntimeError(f"8x8 cavity {label} did not converge on {d}:\n"
                               f"{r8.summary()}")
        its[d], xs[d] = r8.iters, r8.x
    dx = float(np.abs(xs["cuda"] - xs["cpu"]).max())
    log(f"cross-check 8x8 {label}: Newton its cuda {its['cuda']} cpu "
        f"{its['cpu']}, max |x_cuda - x_cpu| = {dx:.2e}")
    if its["cuda"] != its["cpu"]:
        raise RuntimeError(f"8x8 cavity {label}: Newton iteration counts differ "
                           "between cuda and cpu")
    if dx > 1e-5:
        raise RuntimeError(f"8x8 cavity {label}: cuda and cpu solutions differ "
                           f"by {dx:.2e}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available (this script "
                         "runs the port on a GPU only)")
    from goma_tpu_torch import cuda_build
    from goma_tpu_torch.solvers import NewtonSolver
    from goma_tpu_torch.solvers.batched_lu import batched_lu
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv
    from goma_tpu_torch.solvers.front_gather import front_gather
    from goma_tpu_torch.solvers.ndlu import NDLU, node_clusters
    from goma_tpu_torch.solvers.twolevel import _saddle_mask

    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. (and 7.) build every kernel, all nvcc runs started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
    for name, (sec, report) in builds.items():
        cuda_build.load(name)
        log(f"build: {name}.cu in {sec:.2f} s")
        log(report)
    log(f"build: all {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")

    # ---- 2. main deck set-up (host)
    t0 = time.perf_counter()
    prob = cavity_problem(N_MAIN, dev)
    solver = NewtonSolver(prob, cavity_opts())
    levels = solver.precond.levels
    shapes = [(lev.nn, lev.smax) for lev in levels]
    log(f"setup: {N_MAIN}x{N_MAIN} cavity, {prob.dofmap.n_dof} dof, "
        f"{prob.pattern.nnz} nnz, {len(levels)} ND levels (nn, m) = {shapes}, "
        f"{time.perf_counter() - t0:.1f} s")

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

    # ---- 4. small cross-check: GPU vs CPU on the 8x8 cavity
    cross_check_8x8(cavity_opts, "gmres+ndlu")

    # ---- 5. main path
    x_init = np.zeros(prob.dofmap.n_dof)
    t0 = time.perf_counter()
    res_w = solver.solve(x_init, params)
    torch.cuda.synchronize()
    tw = time.perf_counter() - t0
    log(f"main path warm-up: {tw:.2f} s, iters={res_w.iters}, "
        f"lin={res_w.linear_iters}, converged={res_w.converged}")
    solver.reset_lagged()
    batched_lu.launches = front_gather.launches = batched_trsv.launches = 0
    solver.n_factor = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(x_init, params)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches, g_launches = batched_lu.launches, front_gather.launches
    iters = max(res.iters, 1)
    log(res.summary())
    log(f"main path: iters={res.iters} converged={res.converged} "
        f"lin={res.linear_iters} factorizations={solver.n_factor} "
        f"front-LU launches={launches} front-gather launches={g_launches}")
    log(f"main path: asm {res.assembly_time / iters * 1000:.1f} ms + slv "
        f"{res.solve_time / iters * 1000:.1f} ms per iteration, "
        f"{t_total / iters:.4f} s/iter (total {t_total:.3f} s)")
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

    # ---- 6. kernel vs twin on the real fronts at the converged state
    xc = torch.as_tensor(x, dtype=prob.dtype, device=dev)
    max_abs = max(max_abs, check_real_fronts(solver.precond, scaled32(xc),
                                             "converged"))
    factor_split_ms(solver.precond, scaled32(x0), "cavity gmres+ndlu tree")

    # ---- 8. substitution kernel vs twin on the tpu_direct deck's factors
    t0 = time.perf_counter()
    dsolver = NewtonSolver(prob, direct_opts())
    R, dvals, _, dscale = dsolver._prepare_direct(x0, params)
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

    # ---- 9. small cross-check of the tpu_direct path: GPU vs CPU
    cross_check_8x8(direct_opts, "tpu_direct")

    # ---- 10. the tpu_direct main path
    t0 = time.perf_counter()
    res_w = dsolver.solve(x_init, params)
    torch.cuda.synchronize()
    log(f"tpu_direct warm-up: {time.perf_counter() - t0:.2f} s, "
        f"iters={res_w.iters}, converged={res_w.converged}")
    dsolver.reset_lagged()
    dsolver.direct_log = []
    dsolver._ndlu_nfactor = 0
    nd.n_solve = 0
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dres = dsolver.solve(x_init, params)
    torch.cuda.synchronize()
    dt_total = time.perf_counter() - t0
    d_trsv, d_lu = batched_trsv.launches, batched_lu.launches
    d_gather = front_gather.launches
    d_solves, d_fac = nd.n_solve, dsolver._ndlu_nfactor
    diters = max(dres.iters, 1)
    log(dres.summary())
    for i, (sweeps, rel, fresh) in enumerate(dsolver.direct_log):
        log(f"tpu_direct it {i}: {sweeps} refinement sweeps, rel residual "
            f"{rel:.3e}, {'fresh' if fresh else 'lagged'} factor")
    log(f"tpu_direct: iters={dres.iters} converged={dres.converged} "
        f"factorizations={d_fac} NDLU solves={d_solves} front-LU launches="
        f"{d_lu} front-gather launches={d_gather} substitution launches="
        f"{d_trsv}")
    log(f"tpu_direct: asm {dres.assembly_time / diters * 1000:.1f} ms + slv "
        f"{dres.solve_time / diters * 1000:.1f} ms per iteration, "
        f"{dt_total / diters:.4f} s/iter (total {dt_total:.3f} s)")
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

    # ---- 11. the front-gather kernel on both 64x64 trees
    gvals = scaled32(x0)
    gather_abs = max(check_gathers(solver.precond, gvals, "gmres+ndlu tree"),
                     check_gathers(nd, dvals, "tpu_direct tree"))
    gather_times(solver.precond, gvals, "gmres+ndlu tree")
    gather_times(nd, dvals, "tpu_direct tree")

    # ---- 12. small cross-check of the buoyant deck: GPU vs CPU
    its, xs = {}, {}
    for d in ("cuda", "cpu"):
        p8 = buoyant_problem(8, torch.device(d))
        r8 = NewtonSolver(p8, buoyant_opts()).solve(np.zeros(p8.dofmap.n_dof),
                                                    p8.base_params())
        if not r8.converged:
            raise RuntimeError(f"8x8 buoyant deck did not converge on {d}:\n"
                               f"{r8.summary()}")
        its[d], xs[d] = r8.iters, r8.x
    bdx = float(np.max(np.abs(xs["cuda"] - xs["cpu"]) / (1.0 + np.abs(xs["cpu"]))))
    log(f"cross-check 8x8 buoyant: Newton its cuda {its['cuda']} cpu "
        f"{its['cpu']}, max |x_cuda - x_cpu| / (1 + |x_cpu|) = {bdx:.2e}")
    if its["cuda"] != its["cpu"] or bdx > BUOY_X_TOL:
        raise RuntimeError("8x8 buoyant deck: cuda and cpu differ (Newton "
                           f"{its}, x {bdx:.2e} > {BUOY_X_TOL:.0e})")

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
    if not all(fwd is bwd and fwd.shape == (nn, m, m)
               for (fwd, bwd, _, _), (nn, m, _) in zip(bfacs_sub, blev)):
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
    bx_init = np.zeros(bprob.dofmap.n_dof)
    t0 = time.perf_counter()
    res_w = bsolver.solve(bx_init, bparams)
    torch.cuda.synchronize()
    log(f"buoyant warm-up: {time.perf_counter() - t0:.2f} s, "
        f"iters={res_w.iters}, lin={res_w.linear_iters}, "
        f"converged={res_w.converged}")
    bsolver.reset_lagged()
    bsolver.n_factor = 0
    batched_lu.launches = batched_trsv.launches = front_gather.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bres = bsolver.solve(bx_init, bparams)
    torch.cuda.synchronize()
    bt_total = time.perf_counter() - t0
    b_lu, b_gather, b_trsv = (batched_lu.launches, front_gather.launches,
                              batched_trsv.launches)
    biters = max(bres.iters, 1)
    log(bres.summary())
    log(f"buoyant: iters={bres.iters} converged={bres.converged} "
        f"lin={bres.linear_iters} factorizations={bsolver.n_factor} "
        f"front-LU launches={b_lu} front-gather launches={b_gather} "
        f"substitution launches={b_trsv}")
    log(f"buoyant: asm {bres.assembly_time / biters * 1000:.1f} ms + slv "
        f"{bres.solve_time / biters * 1000:.1f} ms per iteration, "
        f"{bt_total / biters:.4f} s/iter (total {bt_total:.3f} s)")
    if not bres.converged or bres.res_norms[-1][1] > 1e-6:
        raise RuntimeError("buoyant main path did not converge to 1e-6")
    if abs(bres.iters - BUOY_NEWTON) > 1:
        raise RuntimeError(f"buoyant main path took {bres.iters} Newton "
                           f"iterations, not {BUOY_NEWTON} +- 1")
    nf = bsolver.n_factor
    if nf < 1 or b_lu != len(blev) * nf or b_gather != len(blev) * nf:
        raise RuntimeError(f"buoyant front-LU launches {b_lu} / front-gather "
                           f"launches {b_gather} != {len(blev)} levels x {nf} "
                           "factorizations")
    bx = bres.x
    if bx.shape != (bprob.dofmap.n_dof,) or not np.all(np.isfinite(bx)):
        raise RuntimeError("buoyant solution has the wrong shape or "
                           "non-finite values")
    # where a buoyant iteration's time goes: median CUDA-event ms and
    # profiler device ms (kernels per call) of each piece of work
    bfacs = bnd.factor(bvals)
    rb = torch.ones(bprob.dofmap.n_dof, dtype=bnd.dtype, device=dev)
    pieces = {
        "prep (_assemble_fast)": lambda: bprob._assemble_fast(bx0, bparams),
        "CSR values (_assemble_with_elem)":
            lambda: bprob._assemble_with_elem(bx0, bparams),
        "factorization (NDLU.factor)": lambda: bnd.factor(bvals),
        "preconditioner apply (NDLU.solve)": lambda: bnd.solve(bfacs, rb),
    }
    for name, fn in pieces.items():
        ev_ms = median_ms(fn, 5)
        dv_ms, n_k = device_ms(fn, 3)
        log(f"buoyant: {name} {ev_ms:.3f} ms (CUDA events), {dv_ms:.3f} ms "
            f"device time in {n_k:.0f} kernels")

    # ---- 14. kernel summary
    trsv_bnd = trsv_bound(calls)
    print(json.dumps({"kernels": [{
        "name": "batched_lu",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/batched_lu.cu",
        "replaces": "goma_tpu/solvers/pallas_lu.py:39",
        "launches": launches + d_lu + b_lu,
        "launches_by_path": {"gmres+ndlu": launches, "tpu_direct": d_lu,
                             "buoyant gmres+ndlu": b_lu},
        "max_abs_err": max_abs,
        "ms": lu_ms[torch.float32][0],
        "plain_ms": lu_ms[torch.float32][1],
        "bound_ms": lu_bnd[0],
        "bound_by": lu_bnd[1],
        "library_ms": lu_ms[torch.float32][2],
        "buoyant_ms": b_lu_ms[torch.float32][0],
        "buoyant_library_ms": b_lu_ms[torch.float32][2],
        "buoyant_bound_ms": b_lu_bnd[0],
    }, {
        "name": "batched_trsv",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/batched_trsv.cu",
        "replaces": "goma_tpu/solvers/pallas_lu.py:67",
        "launches": d_trsv + b_trsv,
        "launches_by_path": {"tpu_direct": d_trsv},
        "max_abs_err": max(trsv["max_abs"], btrsv["max_abs"]),
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
    }, {
        "name": "front_gather",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/front_gather.cu",
        "replaces": "scripts/attic/exp_front_gather.py:130",
        "launches": g_launches + d_gather + b_gather,
        "launches_by_path": {"gmres+ndlu": g_launches, "tpu_direct": d_gather,
                             "buoyant gmres+ndlu": b_gather},
        "max_abs_err": gather_abs,
        "ms": g_times["kernel"][0],
        "plain_ms": g_times["plain"][0],
        "bound_ms": g_bound[0],
        "bound_by": g_bound[1],
        "library_ms": g_times["index_select"][0],
    }]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
