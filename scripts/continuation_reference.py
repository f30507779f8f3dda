#!/usr/bin/env python3
"""goma_tpu's record of the continuation and stability decks of
``chip_smoke.py`` phases 39-44, on the CPU (JAX, float64 state):

- ``--part cavity``: the lid-driven cavity on an n x n QUAD9 mesh, mu 0.01,
  the lid's u the parametric Dirichlet value params["U"] (Re = 100 U),
  continued by ``continue_problem(make_params, 1.0, 4.0, dlam0=0.5, x0=0,
  first_order=True)`` on each rung (``bench._cavity_opts("gmres+ndlu")``
  and ``("tpu_direct")``, float32 Jacobian): the accepted U sequence, the
  Newton iterations and the state at 24 evenly spaced dofs of every step,
  the linear iterations of every predictor solve, the minimum of u/U on
  the vertical centre line at U = 4 (Ghia et al. 1982, Re 400: -0.32726);
  then, on the ``gmres+ndlu`` options with ``linear_tol=1e-8``, the
  augmenting condition "u at the node nearest (0.5, 0.2813) equals its
  value at U = 3" (the target from a Newton solve at U = 3, the AC started
  at the accepted step below 3), and at U = 4 (the continued state
  polished on the host ``direct`` rung to 1e-10) the flux sensitivity
  dF/dU of the lid's x-traction (``traction_integrand(0)`` over "top") and
  its central difference over two direct solves at U +- 1e-3;
- ``--part bratu``: -lap T = lam e^T on the n x n QUAD9 unit square, host
  ``direct``: ``continue_problem`` 0 -> 6 (dlam0 1), ``arclength_continue``
  from 6 (ds0 4, lam_scale 5, 7 steps), ``detect_folds``, ``fold_track``
  from the step before the fold;
- ``--part small``: the pitchfork (10x1) and Hopf (3x3 Brusselator) decks
  of tests/test_bifurcation2.py, the growth rates of
  examples/rayleigh_benard_3d_stability.py::sweep(Ra=700) and
  examples/film_stability.py::run() (its eigensolves from
  ``scripts/arpack_start.py``'s start vector of seed 0), the plane-Couette 3D-of-2D driver of
  tests/test_normal_mode.py and ``solve_stability_device`` on the 8x8 heat
  spectrum.

``chip_smoke.py`` carries these numbers as its ``CONT_REF`` constants.

    python3 scripts/continuation_reference.py --part cavity --n 64 --out c.json
    python3 scripts/continuation_reference.py --part bratu --n 64 --out b.json
    python3 scripts/continuation_reference.py --part small --out s.json

Run times (one process on a CPU sandbox, jax 0.9.0): ``--part cavity
--n 64`` 459 s (the ``gmres_ndlu`` rung 40 s, ``tpu_direct`` 350 s, most of
it its predictors' two-level GMRES, the AC 25 s, the flux phase 18 s),
``--part bratu --n 64`` 31 s, ``--part small`` 19 s.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts.arpack_start import fixed_start  # noqa: E402

N_SAMPLES = 24
MU = 0.01
AC_POINT = (0.5, 0.2813)


def lid_cavity(n):
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Momentum

    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    mesh.nodesets["lid"] = top[(xt > xt.min()) & (xt < xt.max())]
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")], {"rho": 1.0, "mu": MU})
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("lid", "velocity", 0, lambda c, p: p["U"])
    prob.add_dirichlet("lid", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = jnp.float32
    return prob


def options(rung, **kw):
    """bench._cavity_opts(rung)'s Newton options (chip_smoke.py's
    ``cavity_opts`` and ``direct_opts``)."""
    from goma_tpu.solvers import NewtonOptions

    if rung == "gmres_ndlu":
        base = dict(max_iter=20, tol_residual=1e-6, linear_tol=1e-4,
                    precond="ndlu", linear_solver="gmres", gmres_restart=60,
                    linear_maxiter=240, ndlu_leaf_max=192, prep32_tol=3e-6,
                    ew_eta_floor=0.0, ew_endgame="tighten")
    else:
        base = dict(max_iter=20, tol_residual=1e-6, linear_solver="tpu_direct",
                    ndlu_leaf_max=192, ndlu_refine=1)
    base.update(kw)
    return NewtonOptions(**base)


def maker(prob, key):
    def make_params(v):
        return prob.base_params(**{key: jnp.asarray(v, dtype=prob.dtype)})
    return make_params


def predictor_iterations():
    """Wrap goma_tpu's ``_dR_dlam`` and ``NewtonSolver._linsolve_gmres`` so
    the linear iterations of each predictor solve (the first solve after
    ``_dR_dlam``) land in the returned list."""
    import goma_tpu.continuation.conti as conti
    from goma_tpu.solvers.newton import NewtonSolver

    out, armed = [], [False]
    dR, lin = conti._dR_dlam, NewtonSolver._linsolve_gmres

    def dR_armed(*a, **k):
        armed[0] = True
        return dR(*a, **k)

    def lin_rec(self, *a, **k):
        res = lin(self, *a, **k)
        if armed[0]:
            armed[0] = False
            out.append(int(res[0].iters if isinstance(res, tuple) else res.iters))
        return res

    conti._dR_dlam = dR_armed
    NewtonSolver._linsolve_gmres = lin_rec
    return out


def centre_line_min(prob, x, U):
    u = prob.get_nodal_field(x, "velocity", 0)
    line = np.abs(prob.mesh.coords[:, 0] - 0.5) < 1e-9
    return float(np.nanmin(u[line]) / U)


def cavity_part(n):
    from goma_tpu.continuation import (AugmentedNewtonSolver,
                                       AugmentingCondition, continue_problem)
    from goma_tpu.post import sideset_integral, traction_integrand
    from goma_tpu.post.postproc import flux_sensitivity
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    prob = lid_cavity(n)
    n_dof = prob.dofmap.n_dof
    samples = np.linspace(0, n_dof - 1, N_SAMPLES).astype(np.int64)
    mp = maker(prob, "U")
    rec = {"n": n, "n_dof": n_dof, "sample_dofs": samples.tolist()}
    pred = predictor_iterations()
    for rung in ("gmres_ndlu", "tpu_direct"):
        pred.clear()
        t0 = time.time()
        steps = continue_problem(prob, mp, 1.0, 4.0, 0.5, np.zeros(n_dof),
                                 options(rung), first_order=True)
        sec = time.time() - t0
        rec[rung] = {
            "seconds": sec, "lam": [float(s.lam) for s in steps],
            "newton": [int(s.newton_iters) for s in steps],
            "predictor_linear": list(pred),
            "x_samples": [np.asarray(s.x)[samples].tolist() for s in steps],
            "u_min_centre_line": centre_line_min(prob, steps[-1].x, 4.0)}
        print(rung, {k: v for k, v in rec[rung].items() if k != "x_samples"},
              flush=True)
        if rung == "gmres_ndlu":
            xs = {float(s.lam): np.asarray(s.x) for s in steps}
    # the augmenting condition: the target from a solve at U = 3
    coords = prob.mesh.coords
    node = int(np.argmin(np.sum((coords - np.array(AC_POINT)) ** 2, axis=1)))
    dof = int(prob.dofmap.dof_of_node_svar[node, prob.dofmap.svar("velocity", 0)])
    below = max(u for u in xs if u < 3.0)
    r3 = NewtonSolver(prob, options("gmres_ndlu")).solve(xs[below], mp(3.0))
    target = float(np.asarray(r3.x)[dof])
    t0 = time.time()
    ac = AugmentingCondition(key="U", g=lambda x, p: x[dof] - target, p0=below)
    ares = AugmentedNewtonSolver(prob, [ac], options(
        "gmres_ndlu", linear_tol=1e-8)).solve(xs[below], mp(below))
    rec["ac"] = {"node": node, "dof": dof, "start": below, "target": target,
                 "U3_newton": int(r3.iters), "p": float(ares.p[0]),
                 "converged": bool(ares.converged), "iters": int(ares.iters),
                 "res_norms": [float(v) for v in ares.res_norms],
                 "seconds": time.time() - t0}
    print("ac", rec["ac"], flush=True)
    # the flux sensitivity at U = 4, on the polished state
    direct = NewtonOptions(max_iter=8, tol_residual=1e-10, linear_solver="direct")
    prob.jacobian_dtype = None
    x4 = NewtonSolver(prob, direct).solve(xs[4.0], mp(4.0)).x
    F = sideset_integral(prob, "top", traction_integrand(0))
    t0 = time.time()
    dF = float(flux_sensitivity(prob, F, x4, mp(4.0), "U"))
    h = 1e-3
    Fh = []
    for U in (4.0 + h, 4.0 - h):
        r = NewtonSolver(prob, direct).solve(x4, mp(U))
        Fh.append(float(F(jnp.asarray(r.x), mp(U))))
    rec["flux"] = {"F": float(F(jnp.asarray(x4), mp(4.0))), "dF_dU": dF,
                   "central_difference": (Fh[0] - Fh[1]) / (2 * h), "h": h,
                   "x4_samples": np.asarray(x4)[samples].tolist(),
                   "seconds": time.time() - t0}
    print("flux", {k: v for k, v in rec["flux"].items() if k != "x4_samples"},
          flush=True)
    return rec


def bratu_problem(n):
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Energy

    def source(fv, mat, params):
        return params["lam"] * jnp.exp(fv.val["temperature"][:, 0])

    prob = Problem(rectangle_mesh(n, n, elem="QUAD9"),
                   [Energy(interp="Q2", transient=False, convection=False)],
                   {"k": 1.0, "heat_source": source})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    return prob


def bratu_part(n):
    from goma_tpu.continuation import (arclength_continue, continue_problem,
                                       detect_folds, fold_track)
    from goma_tpu.solvers import NewtonOptions

    prob = bratu_problem(n)
    mp = maker(prob, "lam")
    t0 = time.time()
    steps = continue_problem(prob, mp, 0.0, 6.0, 1.0, np.zeros(prob.dofmap.n_dof),
                             NewtonOptions(max_iter=12, tol_residual=1e-10,
                                           linear_solver="direct"))
    arc = arclength_continue(prob, mp, 6.0, steps[-1].x, ds0=4.0, n_steps=7,
                             newton_options=NewtonOptions(
                                 max_iter=12, tol_residual=1e-9,
                                 linear_solver="direct"), lam_scale=5.0)
    folds = detect_folds(arc)
    i = folds[0] - 1
    fr = fold_track(prob, mp, arc[i].lam, arc[i].x,
                    NewtonOptions(linear_solver="direct"), tol=1e-8)
    rec = {"n": n, "n_dof": prob.dofmap.n_dof,
           "lam": [float(s.lam) for s in steps],
           "newton": [int(s.newton_iters) for s in steps],
           "arc_lam": [float(s.lam) for s in arc],
           "arc_newton": [int(s.newton_iters) for s in arc], "folds": folds,
           "fold_lam": float(fr.lam), "fold_iters": int(fr.iters),
           "fold_converged": bool(fr.converged),
           "fold_res_norms": [float(v) for v in fr.res_norms],
           "seconds": time.time() - t0}
    print("bratu", rec, flush=True)
    return rec


def small_part():
    import examples.film_stability as film
    import examples.rayleigh_benard_3d_stability as rb
    from goma_tpu.continuation.bifurcation import hopf_track, pitchfork_track
    from goma_tpu.continuation.stability import (solve_stability_3d_of_2d,
                                                 solve_stability_device)
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Energy, Momentum, Species
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    rec = {}
    # pitchfork: u'' + lam u - u^3 = 0 on 10x1
    mesh = rectangle_mesh(10, 1, elem="QUAD9")
    prob = Problem(mesh, [Species(1, interp="Q2", transient=False,
                                  convection=False)],
                   {"diffusivity": 1.0, "species_source":
                    lambda fv, mat, params: params["lam"] * fv.val["species"]
                    - fv.val["species"] ** 3})
    prob.add_dirichlet("left", "species", 0, 0.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.finalize()
    psi = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0,
                               lambda X: np.sin(np.pi * X[:, 0]))
    pf = pitchfork_track(prob, maker(prob, "lam"), lam0=9.3,
                         x0=np.zeros(prob.dofmap.n_dof), psi=psi)
    rec["pitchfork"] = {"lam": float(pf.lam), "iters": int(pf.iters),
                        "converged": bool(pf.converged)}
    # Hopf: the Brusselator, a = 1.3
    a = 1.3

    def brus(fv, mat, params):
        u, v = fv.val["species"][:, 0], fv.val["species"][:, 1]
        b = params["b"]
        return jnp.stack([a - (b + 1.0) * u + u * u * v, b * u - u * u * v], 1)

    prob = Problem(rectangle_mesh(3, 3, elem="QUAD4"),
                   [Species(2, interp="Q1", transient=True, convection=False)],
                   {"diffusivity": jnp.array([0.02, 0.05]),
                    "species_source": brus})
    prob.finalize()
    b0 = 1.0 + a * a + 0.25
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, a)
    x0 = prob.set_nodal_field(x0, "species", 1, b0 / a)
    hp = hopf_track(prob, maker(prob, "b"), lam0=b0, omega0=1.15 * a, x0=x0,
                    tol=1e-9)
    rec["hopf"] = {"b": float(hp.lam), "omega": float(abs(hp.omega)),
                   "iters": int(hp.iters), "converged": bool(hp.converged)}
    # stability growth rates
    rec["rb_sweep"] = [[float(b), float(s)] for b, s in rb.sweep(Ra=700.0)]
    # ARPACK from a fixed start vector (scripts/arpack_start.py): at beta
    # 0.4 the start vector picks among an unconverged cluster
    with fixed_start(0):
        rec["film"] = [[float(b), float(s), float(se)]
                       for b, s, se in film.run()]
    mesh = rectangle_mesh(3, 8, elem="QUAD9", xlim=(0, 0.5), ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    base = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")], {"rho": 1.0, "mu": 0.1})
    for ns in ("left", "right", "top", "bottom"):
        base.add_dirichlet(ns, "velocity", 0, lambda c: c[:, 1])
        base.add_dirichlet(ns, "velocity", 1, 0.0)
    base.add_dirichlet("pin", "pressure", 0, 0.0)
    base.finalize()
    res = NewtonSolver(base, NewtonOptions(max_iter=8, tol_residual=1e-10,
                                           linear_solver="direct")).solve(
        np.zeros(base.dofmap.n_dof), base.base_params())
    rec["couette"] = [[float(b), float(s)] for b, s, _ in solve_stability_3d_of_2d(
        base, res.x, betas=(0.5, 2.0), mat={"rho": 1.0, "mu": 0.1}, n_modes=3,
        shift=0.0)]
    prob = Problem(rectangle_mesh(8, 8, elem="QUAD9"),
                   [Energy(interp="Q2", transient=True, convection=False)],
                   {"rho": 1.0, "Cp": 1.0, "k": 1.0})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    r = solve_stability_device(prob, np.zeros(prob.dofmap.n_dof),
                               prob.base_params(), n_modes=4,
                               shift=-2 * np.pi**2)
    rec["heat_device"] = sorted(float(s) for s in r.growth_rates.real)
    print("small", rec, flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("cavity", "bratu", "small"), required=True)
    ap.add_argument("--n", type=int, default=64, help="cells a side")
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    t0 = time.time()
    if args.part == "cavity":
        rec = cavity_part(args.n)
    elif args.part == "bratu":
        rec = bratu_part(args.n)
    else:
        rec = small_part()
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
