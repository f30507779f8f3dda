#!/usr/bin/env python3
"""GPU smoke run of goma_tpu_torch, the PyTorch/CUDA port of goma_tpu.

    python3 chip_smoke.py

Needs one CUDA device (NVIDIA H100, sm_90a) and nvcc; exits non-zero on any
failure and when CUDA is unavailable. Two main paths, each read with its own
launch counts: ``gmres+ndlu`` (phases 2-6) and ``tpu_direct`` (phases 8-10).
Phases:

1. build every kernel, one nvcc per source, all started together: the
   front LU ``goma_tpu_torch/csrc/batched_lu.cu`` and the front substitution
   ``goma_tpu_torch/csrc/batched_trsv.cu`` (sm_90a); print each build time
   and ptxas report (phase 7's build is this one);
2. set up the main deck: the Re=100 lid-driven cavity on a 64x64 QUAD9 mesh
   (Q2/Q1, 37,507 dof), float32 Jacobian, the ``gmres+ndlu`` options;
3. hold the kernel against its plain PyTorch twin on the card, float32 and
   float64, at every nested-dissection level shape (nn fronts of size m)
   of that deck, on random fronts whose zero, tiny and negative pivots make
   the static-pivot boost fire; print errors and median CUDA-event times.
   Then the real fully-summed block of every ND level, built on the card
   from the deck's CSR values and the children's Schur complements as
   ``NDLU.factor`` builds it, at the state the main path factors;
4. solve the 8x8 cavity on the GPU and on the CPU with the same options and
   require the same Newton iteration count;
5. the main path: one warm-up Newton solve, ``reset_lagged()``, one timed
   solve; require convergence to 1e-6, that every ND level of every
   factorization went through the kernel (launch counter), and the Ghia et
   al. (1982) Re=100 centerline velocity;
6. kernel vs twin again on every level's real fronts, at the converged
   state;
8. the substitution kernel against its twin, float32 and float64, lower and
   upper, at all 9 ND level shapes of the ``tpu_direct`` deck: the real
   packed LUs of its factorization at x = 0, with the real own-segments of
   one solve and with seeded random right-hand sides; print errors and the
   median CUDA-event ms of the kernel, its loop twin and
   ``torch.linalg.solve_triangular``, per shape and in total;
9. solve the 8x8 cavity with ``tpu_direct`` on the GPU and on the CPU and
   require the same Newton count and x within phase 4's bound;
10. the ``tpu_direct`` main path on the 64x64 deck (``bench._cavity_opts(
    "tpu_direct")``): one warm-up solve, ``reset_lagged()``, one timed solve;
    require convergence to 1e-6, the Ghia check, that every substitution of
    the timed solve ran the kernel at every level (2 x levels x solves) and
    every factorization the front-LU kernel (levels x factorizations), and
    that x agrees with phase 5's ``gmres+ndlu`` solution; print each
    iteration's refinement sweeps, relative residual and fresh or lagged
    factor, the asm/slv buckets, s/iteration, and the CUDA-event ms of one
    factorization split into front assembly (``NDLU.front``) and the rest.

The last three lines of output: the kernel summary (JSON), the card's name
and power limit (nvidia-smi), and ``{"ok": true, "device": ...}``.
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
# max|LU|/max|A| <= 1.07. On the H100 the largest float32 reading over
# every real ND level of the main deck is 2.45e-6 (the top front, m=323,
# whose own float32 rounding floor against float64 is 1.9e-4); all other
# fronts read <= 1.8e-7. The float32 limit sits 8x above that reading and
# 10x below that floor. float64: readings <= 3.6e-15 (1e-16 roundoff).
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
KERNELS = ("batched_lu", "batched_trsv")
# Substitution kernel vs twin, relative to max|twin x|: the kernel sums each
# row by a column sweep of FMAs (float32 fronts in a float64 register), the
# twin by a row dot in the working dtype, so they differ by the twin's
# rounding. On the H100 the largest readings over the 18 substitutions of
# one solve of the 64x64 tpu_direct deck, real and random right-hand sides,
# are 1.97e-7 (float32) and 1.95e-15 (float64); the limits sit 10x above.
# The float32 kernel's distance from the float64 twin is at most 1.0x the
# float32 twin's in those readings (ACC_RATIO allows 2x).
TRSV_TOL = {torch.float32: 2e-6, torch.float64: 2e-14}
# max |x_tpu_direct - x_gmres| over the 64x64 solution: both paths stop at
# ||R||_2 <= 1e-6, GMRES's last inexact step at 6.3e-7 and tpu_direct's at
# 6.8e-9, so they differ by the GMRES endpoint's error. H100 reading
# 1.36e-5; the limit sits ~4x above.
X_PATHS_TOL = 5e-5


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


def check_real_fronts(solver, x, params, label):
    """Kernel vs twin on the real fully-summed block of every ND level at
    state ``x``: each level's front assembled on the card from the
    equilibrated CSR values and the children's Schur complements, exactly
    as NDLU.factor does, in the factor dtype (float32), and the same blocks
    cast to float64. For float32 it also prints the distance of kernel and
    twin from the float64 twin on the same block: the float32 rounding
    floor, which the kernel must share with the twin. Returns the max abs
    error."""
    from goma_tpu_torch.solvers.batched_lu import batched_lu_reference

    nd = solver.precond
    _, _, scale, _ = solver._prepare_fast32(x, params)
    vals = solver._scaled_vals(x, params, scale)
    max_abs = 0.0
    S = None
    for li, lev in enumerate(nd.levels):
        F = nd.front(li, vals, S)
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


def device_ms(fn, reps):
    """Device time per call of ``fn`` (sum of its kernels' durations, ms)
    and kernels launched per call, from torch.profiler, after one warm-up
    call. Unlike CUDA events around a call, this leaves out the host's
    launch overhead and the device's idle gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.device_time_total for e in kernels) / 1000.0 / reps,
            len(kernels) / reps)


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


def check_substitutions(calls):
    """Phase 8: kernel vs twin on every recorded substitution (float32 as
    recorded, and cast to float64), with its real right-hand side and a
    seeded random one; the float32 kernel must be as accurate as the
    float32 twin against the float64 twin. Returns (max abs err, per-dtype
    total ms of kernel, twin, solve_triangular)."""
    from goma_tpu_torch.solvers.batched_trsv import (batched_trsv,
                                                     batched_trsv_reference)

    max_abs = 0.0
    tot = {dt: [0.0, 0.0, 0.0] for dt in (torch.float32, torch.float64)}
    n_lev = len(calls) // 2
    for ci, (lu32, seg32, lower) in enumerate(calls):
        li = ci if lower else 2 * n_lev - 1 - ci
        nn, m = seg32.shape
        rnd = torch.as_tensor(np.random.default_rng(ci).standard_normal(
            (nn, m)), device=lu32.device)
        lu64 = lu32.double()
        errs = []
        for kind, rhs in (("real", seg32.double()), ("random", rnd)):
            name = (f"trsv level {li} (nn={nn}, m={m}) "
                    f"{'lower' if lower else 'upper'} {kind}")
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
            b3 = rhs.unsqueeze(2)
            t = (median_ms(lambda: batched_trsv(lu, rhs, lower), 20),
                 median_ms(lambda: batched_trsv_reference(lu, rhs, lower), 3),
                 median_ms(lambda: torch.linalg.solve_triangular(
                     lu, b3, upper=not lower, unitriangular=lower), 20))
            tot[dt] = [a + b for a, b in zip(tot[dt], t)]
            ms.append(t)
        log(f"trsv level {li} (nn={nn:3d}, m={m:3d}) "
            f"{'lower' if lower else 'upper'}: {'; '.join(errs)}; ms f32 "
            f"kernel/twin/solve_triangular {ms[0][0]:.3f}/{ms[0][1]:.3f}/"
            f"{ms[0][2]:.3f}, f64 {ms[1][0]:.3f}/{ms[1][1]:.3f}/{ms[1][2]:.3f}")
    for dt, (k, tw, lib) in tot.items():
        log(f"trsv: one solve's substitutions ({len(calls)} calls), "
            f"{str(dt)[6:]}: kernel {k:.3f} ms, twin {tw:.3f} ms, "
            f"solve_triangular {lib:.3f} ms (CUDA events around each call)")
    runs = {
        "kernel": lambda: [batched_trsv(lu, b, lo) for lu, b, lo in calls],
        "twin": lambda: [batched_trsv_reference(lu, b, lo)
                         for lu, b, lo in calls],
        "solve_triangular": lambda: [torch.linalg.solve_triangular(
            lu, b.unsqueeze(2), upper=not lo, unitriangular=lo)
            for lu, b, lo in calls],
    }
    dev = {k: device_ms(fn, 1 if k == "twin" else 5) for k, fn in runs.items()}
    log("trsv: one solve's substitutions, float32, device time (torch."
        "profiler): " + ", ".join(f"{k} {ms:.3f} ms in {n:.0f} kernels"
                                  for k, (ms, n) in dev.items()))
    return max_abs, tot


def factor_split_ms(nd, vals, reps=5):
    """Median CUDA-event ms of one factorization: front assembly
    (``NDLU.front``, all levels) and the rest (``factor_level``)."""
    n_lev = len(nd.levels)
    fronts, rest = [], []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n_lev + 1)]
        S = None
        ev[0].record()
        for li in range(n_lev):
            F = nd.front(li, vals, S)
            ev[2 * li + 1].record()
            _, S = nd.factor_level(li, F)
            ev[2 * li + 2].record()
        ev[-1].synchronize()
        fronts.append(sum(ev[2 * li].elapsed_time(ev[2 * li + 1])
                          for li in range(n_lev)))
        rest.append(sum(ev[2 * li + 1].elapsed_time(ev[2 * li + 2])
                        for li in range(n_lev)))
    return statistics.median(fronts[1:]), statistics.median(rest[1:])


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
    from goma_tpu_torch.solvers.batched_lu import batched_lu, batched_lu_reference
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv

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
    max_abs = 0.0
    ms_sum = {torch.float32: 0.0, torch.float64: 0.0}
    plain_sum = {torch.float32: 0.0, torch.float64: 0.0}
    for dt in (torch.float32, torch.float64):
        for nn, m in shapes:
            A = torch.as_tensor(boosted_fronts(nn, m, seed=m), dtype=dt, device=dev)
            _, _, a_err, rel = check_kernel(A, f"{dt} ({nn},{m})")
            max_abs = max(max_abs, a_err)
            k_ms = median_ms(lambda: batched_lu(A), 20)
            p_ms = median_ms(lambda: batched_lu_reference(A), 5)
            ms_sum[dt] += k_ms
            plain_sum[dt] += p_ms
            log(f"kernel {str(dt)[6:]} (nn={nn:3d}, m={m:3d}): rel err {rel:.2e}, "
                f"kernel {k_ms:.3f} ms, twin {p_ms:.3f} ms")
    log(f"kernel: one factorization's fronts (all {len(shapes)} level shapes), "
        f"float32: kernel {ms_sum[torch.float32]:.3f} ms, twin "
        f"{plain_sum[torch.float32]:.3f} ms; float64: kernel "
        f"{ms_sum[torch.float64]:.3f} ms, twin {plain_sum[torch.float64]:.3f} ms")

    # the main path's one factorization is at x = 0 with the float32 prep
    params = prob.base_params()
    x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
    max_abs = max(max_abs, check_real_fronts(solver, x0, params, "x=0"))

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
    batched_lu.launches = 0
    solver.n_factor = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(x_init, params)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = batched_lu.launches
    iters = max(res.iters, 1)
    log(res.summary())
    log(f"main path: iters={res.iters} converged={res.converged} "
        f"lin={res.linear_iters} factorizations={solver.n_factor} "
        f"front-LU launches={launches}")
    log(f"main path: asm {res.assembly_time / iters * 1000:.1f} ms + slv "
        f"{res.solve_time / iters * 1000:.1f} ms per iteration, "
        f"{t_total / iters:.4f} s/iter (total {t_total:.3f} s)")
    if not res.converged or res.res_norms[-1][1] > 1e-6:
        raise RuntimeError("main path did not converge to 1e-6")
    if solver.n_factor < 1 or launches != len(levels) * solver.n_factor:
        raise RuntimeError(f"front-LU launches {launches} != {len(levels)} levels "
                           f"x {solver.n_factor} factorizations")
    x = res.x
    if x.shape != (prob.dofmap.n_dof,) or not np.all(np.isfinite(x)):
        raise RuntimeError("main path solution has the wrong shape or non-finite values")
    ghia_check(prob, x, "gmres+ndlu")

    # ---- 6. kernel vs twin on the real fronts at the converged state
    xc = torch.as_tensor(x, dtype=prob.dtype, device=dev)
    max_abs = max(max_abs, check_real_fronts(solver, xc, params, "converged"))

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
    trsv_abs, trsv_ms = check_substitutions(calls)

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
    batched_lu.launches = 0
    batched_trsv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dres = dsolver.solve(x_init, params)
    torch.cuda.synchronize()
    dt_total = time.perf_counter() - t0
    d_trsv, d_lu = batched_trsv.launches, batched_lu.launches
    d_solves, d_fac = nd.n_solve, dsolver._ndlu_nfactor
    diters = max(dres.iters, 1)
    log(dres.summary())
    for i, (sweeps, rel, fresh) in enumerate(dsolver.direct_log):
        log(f"tpu_direct it {i}: {sweeps} refinement sweeps, rel residual "
            f"{rel:.3e}, {'fresh' if fresh else 'lagged'} factor")
    log(f"tpu_direct: iters={dres.iters} converged={dres.converged} "
        f"factorizations={d_fac} NDLU solves={d_solves} front-LU launches="
        f"{d_lu} substitution launches={d_trsv}")
    log(f"tpu_direct: asm {dres.assembly_time / diters * 1000:.1f} ms + slv "
        f"{dres.solve_time / diters * 1000:.1f} ms per iteration, "
        f"{dt_total / diters:.4f} s/iter (total {dt_total:.3f} s)")
    if not dres.converged or dres.res_norms[-1][1] > 1e-6:
        raise RuntimeError("tpu_direct main path did not converge to 1e-6")
    if d_solves < 1 or d_trsv != 2 * len(dlev) * d_solves:
        raise RuntimeError(f"substitution launches {d_trsv} != 2 x {len(dlev)} "
                           f"levels x {d_solves} solves")
    if d_fac < 1 or d_lu != len(dlev) * d_fac:
        raise RuntimeError(f"front-LU launches {d_lu} != {len(dlev)} levels x "
                           f"{d_fac} factorizations")
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
    front_ms, rest_ms = factor_split_ms(nd, dvals)
    bD = dscale * R
    facs = nd.factor(dvals)
    solve_ms = median_ms(lambda: nd.solve(facs, bD), 10)
    solve_dev, solve_kern = device_ms(lambda: nd.solve(facs, bD), 5)
    fac_dev, fac_kern = device_ms(lambda: nd.factor(dvals), 3)
    log(f"tpu_direct: one factorization {front_ms + rest_ms:.3f} ms = front "
        f"assembly (NDLU.front, all levels) {front_ms:.3f} ms + the rest "
        f"(factor_level) {rest_ms:.3f} ms; one NDLU.solve {solve_ms:.3f} ms "
        f"(CUDA events); device time (torch.profiler): factorization "
        f"{fac_dev:.3f} ms in {fac_kern:.0f} kernels, NDLU.solve "
        f"{solve_dev:.3f} ms in {solve_kern:.0f} kernels")

    # ---- 11. kernel summary
    print(json.dumps({"kernels": [{
        "name": "batched_lu",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/batched_lu.cu",
        "replaces": "goma_tpu/solvers/pallas_lu.py:39",
        "launches": launches + d_lu,
        "launches_by_path": {"gmres+ndlu": launches, "tpu_direct": d_lu},
        "max_abs_err": max_abs,
        "ms": ms_sum[torch.float32],
        "plain_ms": plain_sum[torch.float32],
    }, {
        "name": "batched_trsv",
        "route": "cuda",
        "source": "goma_tpu_torch/csrc/batched_trsv.cu",
        "replaces": "goma_tpu/solvers/pallas_lu.py:67",
        "launches": d_trsv,
        "launches_by_path": {"tpu_direct": d_trsv},
        "max_abs_err": trsv_abs,
        "ms": trsv_ms[torch.float32][0],
        "plain_ms": trsv_ms[torch.float32][1],
        "solve_triangular_ms": trsv_ms[torch.float32][2],
    }]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
