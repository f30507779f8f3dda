#!/usr/bin/env python3
"""goma_tpu's record of its two-level (p-multigrid) solver on the CPU: the
64x64 lid-driven cavity on bench.py's ``twolevel`` kind
(``bench._cavity_opts("twolevel")``, float32 Jacobian) or the 48x48
buoyant deck on bench.bench_buoyant's third rung (``precond="twolevel"``,
``smooth_sweeps=1``, restart 160, float32 Jacobian), one Newton solve from
x = 0: the preconditioner kind, the coarse space, the Newton and linear
iterations, the residual norms and the time. ``chip_smoke.py`` holds the
PyTorch port's phases 27 and 28 to these counts (``TWOLEVEL_REF``).
``--rung gmres_ndlu`` runs the deck's ``gmres+ndlu`` options instead;
``--x-out`` saves the solution and ``--x-ref`` prints its distance from a
saved one, max |x - x_ref| / (1 + |x_ref|), the measure of
``BUOY_TWOLEVEL_X_TOL`` in ``chip_smoke.py``.

    python3 scripts/twolevel_reference.py --deck cavity [--n 64]
    python3 scripts/twolevel_reference.py --deck buoyant [--n 48] [--x-out tl.npy]
    python3 scripts/twolevel_reference.py --deck buoyant --rung gmres_ndlu \
        --x-ref tl.npy

Runs goma_tpu (JAX, float64 state on the CPU); at full size a deck takes
minutes (the dense coarse LU of 12,675 and 12,005 unknowns on the host)
and several GB of memory. Writes the record as JSON to ``--out``.
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


def cavity(n, rung):
    """bench.bench_cavity's problem and its ``twolevel`` (or
    ``gmres+ndlu``) kind."""
    import bench
    from __graft_entry__ import _cavity_problem

    prob = _cavity_problem(n)
    prob.jacobian_dtype = jnp.float32
    return prob, bench._cavity_opts("gmres+ndlu" if rung == "gmres_ndlu"
                                    else "twolevel")


def buoyant(n, rung):
    """bench.bench_buoyant's deck and its third rung's options (or its
    first rung's, ``gmres_ndlu``)."""
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Energy, Momentum, Species
    from goma_tpu.physics.materials import BoussinesqBodyForce
    from goma_tpu.solvers import NewtonOptions

    Ra, Pr = 1e4, 0.71
    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh,
        [Momentum(dim=2, transient=False), Continuity(),
         Energy(interp="Q2", transient=False),
         Species(n_species=1, interp="Q2", transient=False)],
        {"rho": 1.0, "mu": Pr, "k": 1.0, "Cp": 1.0, "diffusivity": 1.0,
         "body_force": BoussinesqBodyForce([0.0, Ra * Pr], beta=-1.0, T0=0.5)})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = jnp.float32
    if rung == "gmres_ndlu":
        return prob, NewtonOptions(max_iter=15, tol_residual=1e-6,
                                   linear_tol=1e-4, precond="ndlu",
                                   linear_solver="gmres", gmres_restart=60,
                                   linear_maxiter=240, ndlu_leaf_max=256,
                                   ew_eta_floor=1e-3, ew_endgame="standard")
    return prob, NewtonOptions(max_iter=15, tol_residual=1e-6, linear_tol=1e-4,
                               precond="twolevel", smooth_sweeps=1,
                               gmres_restart=160, linear_maxiter=1000)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck", choices=("cavity", "buoyant"), required=True)
    ap.add_argument("--n", type=int, default=None,
                    help="elements a side (default 64 cavity, 48 buoyant)")
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    ap.add_argument("--rung", choices=("twolevel", "gmres_ndlu"),
                    default="twolevel")
    ap.add_argument("--x-out", default=None,
                    help="the converged state as a .npy file (default: none)")
    ap.add_argument("--x-ref", default=None,
                    help="a saved state (.npy) to measure the solution against")
    args = ap.parse_args()
    from goma_tpu.solvers import NewtonSolver
    from goma_tpu.solvers.twolevel import coarse_dof_count

    n = args.n or (64 if args.deck == "cavity" else 48)
    t0 = time.perf_counter()
    prob, opts = (cavity if args.deck == "cavity" else buoyant)(n, args.rung)
    solver = NewtonSolver(prob, opts)
    setup = time.perf_counter() - t0
    nc, ndof = coarse_dof_count(prob)
    t0 = time.perf_counter()
    res = solver.solve(jnp.zeros(ndof, dtype=prob.dtype), prob.base_params())
    sec = time.perf_counter() - t0
    record = {
        "deck": args.deck, "rung": args.rung, "n": n, "n_dof": ndof,
        "nnz": int(prob.pattern.nnz), "nc": nc,
        "precond": solver._precond_kind,
        "converged": bool(res.converged), "newton": int(res.iters),
        "linear": [int(v) for v in res.linear_iters],
        "res_l2": [float(r[1]) for r in res.res_norms],
        "setup_s": setup, "solve_s": sec,
        "asm_s": res.assembly_time, "slv_s": res.solve_time,
        "jax": jax.__version__, "backend": jax.default_backend(),
    }
    if args.rung == "twolevel":
        record["smoother"] = type(solver.precond.bj).__name__
        record["coarse_solve"] = solver.precond.coarse_solve
    x = np.asarray(res.x)
    if args.x_ref:
        x_ref = np.load(args.x_ref)
        record["x_ref"] = args.x_ref
        record["max_dx_rel"] = float(np.max(np.abs(x - x_ref)
                                            / (1.0 + np.abs(x_ref))))
    print(res.summary())
    print(json.dumps(record))
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    if args.x_out:
        np.save(args.x_out, x)
    return 0 if res.converged else 1


if __name__ == "__main__":
    sys.exit(main())
