#!/usr/bin/env python3
"""goma_tpu's record of the solid and porous decks of ``chip_smoke.py``
phases 54-56, on the CPU (JAX, float64 state and Jacobian, float32 NDLU
factors). The decks are ``scripts/solid_decks.py``'s, built here with
goma_tpu's modules:

- ``--part fsi``: the conforming FSI column at ``--nx`` x ``--ny``: run (a),
  the linear solid at P0 = 0.2 on ``tpu_direct`` from x = 0 (its distance
  from the exact uniaxial-strain displacement), and run (b), the
  St. Venant-Kirchhoff solid at P0 = 2.0 on each device rung, each under
  ``bench._cavity_opts(kind, tol=1e-9, max_iter=12)``: the Newton and
  linear iterations, ||x||_2, max |x|, x at 24 evenly spaced dofs and the
  rung's ND tree (fronts, fully-summed size) per level; and the same
  readings of run (b)'s float64 solution (host ``direct``, SuperLU);
- ``--part richards``: the Richards infiltration slab at ``--n`` x ``--n``
  from the initial head, ``--steps`` backward-Euler steps from dt =
  ``solid_decks.RICHARDS_DT`` without adaptation on each device rung
  (``max_iter`` ``solid_decks.RICHARDS_MAX_ITER``): every kept step's (t,
  dt, Newton iterations), the failures, the readings of the end state,
  its head down the wetted top (``solid_decks.profile``) and the front's
  depth;
- ``--part small``: every deck of ``solid_decks.SMALL`` (goma_tpu's tests
  of the slice at their own sizes): its Newton count and its readings.

``chip_smoke.py`` carries these numbers as its ``SOLID_REF`` constants.

    python3 scripts/solid_reference.py --part fsi --nx 128 --ny 64 --out f.json
    GOMA_BENCH_BUDGET_S=100000 \
        python3 scripts/solid_reference.py --part richards --n 128 --out r.json
    python3 scripts/solid_reference.py --part small --out s.json

Importing bench.py arms a SIGALRM at its budget (``GOMA_BENCH_BUDGET_S``,
1700 s by default) + 60 s; the full-size Richards record takes longer.
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

from scripts import solid_decks  # noqa: E402

FSI_P0 = {"linear": 0.2, "nonlinear": 2.0}


def levels(nd):
    return [[int(lev.nn), int(lev.smax)] for lev in nd.levels]


def _rung(prob, kind, solve, max_iter=12):
    from bench import _cavity_opts

    from goma_tpu.solvers import NewtonSolver

    solver = NewtonSolver(prob, _cavity_opts(kind, tol=1e-9,
                                             max_iter=max_iter))
    t0 = time.time()
    rec = solve(solver)
    nd = solver.precond if kind == "gmres+ndlu" else solver._ndlu
    rec.update(seconds=time.time() - t0, levels=levels(nd))
    print(kind, {k: v for k, v in rec.items() if k != "x_samples"},
          flush=True)
    return rec


def fsi_part(P, nx, ny):
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    def rung(prob, kind, P0=None):
        """``kind`` from x = 0; with ``P0`` also the distance from the
        exact displacement (the linear solid)."""
        def solve(solver):
            res = solver.solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
            rec = {"converged": bool(res.converged), "newton": int(res.iters),
                   "linear": [int(v) for v in res.linear_iters],
                   **solid_decks.readings(res.x)}
            if P0 is not None:
                eu, umax, ep = solid_decks.fsi_exact_error(prob, res.x, P0)
                rec.update(exact_err=eu, u_fluid_max=umax, p_err=ep)
            return rec

        return _rung(prob, kind, solve)

    prob = solid_decks.fsi_column(P, nx, ny, "linear", FSI_P0["linear"])
    rec = {"n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz,
           "linear": {"tpu_direct": rung(prob, "tpu_direct",
                                         FSI_P0["linear"])}}
    prob = solid_decks.fsi_column(P, nx, ny, "nonlinear", FSI_P0["nonlinear"])
    out = {kind: rung(prob, kind) for kind in ("gmres+ndlu", "tpu_direct")}
    t0 = time.time()
    res = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-11, linear_solver="direct")).solve(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    out["direct"] = {"seconds": time.time() - t0, "newton": int(res.iters),
                     **solid_decks.readings(res.x)}
    for kind in ("gmres+ndlu", "tpu_direct"):
        dx = np.subtract(out[kind]["x_samples"], out["direct"]["x_samples"])
        out[kind]["dx_direct"] = float(np.abs(dx).max()
                                       / out["direct"]["x_max"])
        print(f"{kind}: max |x - x_direct| / max |x_direct| at the samples "
              f"{out[kind]['dx_direct']:.3e}", flush=True)
    rec["nonlinear"] = out
    return rec


def richards_part(P, n, steps):
    from bench import _cavity_opts

    prob, x0 = solid_decks.richards(P, n)
    rec = {"n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz,
           "steps_nominal": steps}
    for kind in ("gmres+ndlu", "tpu_direct"):
        ts = P.TransientSolver(
            prob, _cavity_opts(kind, tol=1e-9,
                               max_iter=solid_decks.RICHARDS_MAX_ITER),
            solid_decks.richards_time(P, steps))
        t0 = time.time()
        res = ts.run(x0, prob.base_params())
        s = ts.newton
        nd = s.precond if kind == "gmres+ndlu" else s._ndlu
        rec[kind] = {"seconds": time.time() - t0,
                     "steps": solid_decks.step_records(res),
                     "failures": int(res.n_failures), "t": float(res.t),
                     "front_depth": solid_decks.front_depth(prob, res.x),
                     "profile": solid_decks.profile(prob, res.x),
                     "levels": levels(nd), **solid_decks.readings(res.x)}
        print(kind, {k: v for k, v in rec[kind].items()
                     if k not in ("x_samples", "profile")},
              flush=True)
    return rec


def small_part(P):
    rec = {}
    for name, deck in solid_decks.SMALL.items():
        t0 = time.time()
        out = deck(P)
        rec[name] = {"newton": out["newton"], "reading": out["reading"],
                     "seconds": time.time() - t0}
        print(name, rec[name], flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("fsi", "richards", "small"),
                    required=True)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=solid_decks.RICHARDS_STEPS)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    P = solid_decks.namespace("goma_tpu", jnp, jnp.asarray)
    t0 = time.time()
    if args.part == "fsi":
        rec = {"nx": args.nx, "ny": args.ny, **fsi_part(P, args.nx, args.ny)}
    elif args.part == "richards":
        rec = {"n": args.n, **richards_part(P, args.n, args.steps)}
    else:
        rec = small_part(P)
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
