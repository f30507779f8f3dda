#!/usr/bin/env python3
"""goma_tpu's record of the closure decks of ``chip_smoke.py`` phases
57-59, on the CPU (JAX, float64 state and Jacobian, float32 NDLU factors).
The decks are ``scripts/closure_decks.py``'s, built here with goma_tpu's
modules:

- ``--part suspension``: the suspension channel at ``--nx`` x ``--ny``,
  ``--steps`` backward-Euler steps of ``closure_decks.SUSP_DT`` without
  adaptation on each device rung (``bench._cavity_opts(kind, tol=1e-9,
  max_iter=closure_decks.SUSP_MAX_ITER)``): every kept step's (t, dt,
  Newton iterations), the failures, phi up the lines x = 4 and x = 8 at
  the end (``closure_decks.phi_profiles``), the rows there where phi moved
  by more than 1e-3, the readings of the end state and the rung's ND tree
  (fronts, fully-summed size) per level;
- ``--part reacting``: the reacting wall channel at ``--nx`` x ``--ny``,
  steady Newton on each device rung (``bench._cavity_opts(kind, tol=1e-9,
  max_iter=closure_decks.REACT_MAX_ITER)``): converged or not, finite or
  not (the float32 prep of ``gmres+ndlu``), the Newton and linear
  iterations, the wall temperature rise and outlet conversion, the
  readings and the tree; and the float64 solution (host ``direct``).
  ``--b-seed 0`` starts from B = 0 everywhere instead (the state where
  goma_tpu's float32 kinetics and its PLACID face Jacobian give NaN);
- ``--part small``: every deck of ``closure_decks.SMALL`` (goma_tpu's tests
  of the slice at their own sizes): its Newton count and its readings.

``chip_smoke.py`` carries these numbers as its ``CLOSURE_REF`` constants.

    GOMA_BENCH_BUDGET_S=100000 \\
        python3 scripts/closure_reference.py --part suspension --out s.json
    python3 scripts/closure_reference.py --part reacting --out r.json
    python3 scripts/closure_reference.py --part small --out m.json

Importing bench.py arms a SIGALRM at its budget (``GOMA_BENCH_BUDGET_S``,
1700 s by default) + 60 s; the full-size suspension record takes longer.
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

from scripts import closure_decks as cd  # noqa: E402


def levels(nd):
    return [[int(lev.nn), int(lev.smax)] for lev in nd.levels]


def suspension_part(P, nx, ny, steps):
    from bench import _cavity_opts

    prob, x0 = cd.suspension(P, nx, ny)
    rec = {"n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz,
           "steps_nominal": steps,
           "phi0": cd.phi_profiles(prob, x0)}
    for kind in ("gmres+ndlu", "tpu_direct"):
        ts = P.TransientSolver(prob, _cavity_opts(
            kind, tol=1e-9, max_iter=cd.SUSP_MAX_ITER),
            cd.suspension_time(P, steps))
        t0 = time.time()
        res = ts.run(x0, prob.base_params())
        s = ts.newton
        nd = s.precond if kind == "gmres+ndlu" else s._ndlu
        rec[kind] = {"seconds": time.time() - t0,
                     "steps": cd.step_records(res),
                     "failures": int(res.n_failures), "t": float(res.t),
                     "phi": cd.phi_profiles(prob, res.x),
                     "moved_rows": cd.moved_rows(prob, res.x, x0),
                     "levels": levels(nd), **cd.readings(res.x)}
        print(kind, {k: v for k, v in rec[kind].items()
                     if k not in ("x_samples", "phi")}, flush=True)
    return rec


def reacting_part(P, nx, ny, b_seed):
    from bench import _cavity_opts

    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    prob, x0 = cd.reacting(P, nx, ny)
    if b_seed is not None:
        x0 = prob.set_nodal_field(x0, "species", 1, b_seed)
    rec = {"n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz,
           "b_seed": cd.REACT_B_SEED if b_seed is None else b_seed}
    for kind in ("gmres+ndlu", "tpu_direct"):
        solver = NewtonSolver(prob, _cavity_opts(
            kind, tol=1e-9, max_iter=cd.REACT_MAX_ITER))
        t0 = time.time()
        res = solver.solve(x0, prob.base_params())
        x = np.asarray(res.x)
        nd = solver.precond if kind == "gmres+ndlu" else solver._ndlu
        r = {"seconds": time.time() - t0, "converged": bool(res.converged),
             "finite": bool(np.all(np.isfinite(x))),
             "res_norms": [float(v[1]) for v in res.res_norms],
             "newton": int(res.iters),
             "linear": [int(v) for v in res.linear_iters],
             "levels": levels(nd)}
        if r["finite"]:
            r.update(**cd.reacting_outputs(prob, x), **cd.readings(x))
        rec[kind] = r
        print(kind, {k: v for k, v in r.items() if k != "x_samples"},
              flush=True)
    t0 = time.time()
    res = NewtonSolver(prob, NewtonOptions(
        max_iter=cd.REACT_MAX_ITER, tol_residual=1e-11,
        linear_solver="direct")).solve(x0, prob.base_params())
    rec["direct"] = {"seconds": time.time() - t0, "newton": int(res.iters),
                     "converged": bool(res.converged),
                     **cd.reacting_outputs(prob, res.x),
                     **cd.readings(res.x)}
    print("direct", {k: v for k, v in rec["direct"].items()
                     if k != "x_samples"}, flush=True)
    return rec


def small_part(P):
    rec = {}
    for name, deck in cd.SMALL.items():
        t0 = time.time()
        out = deck(P)
        rec[name] = {"newton": out["newton"], "reading": out["reading"],
                     "seconds": time.time() - t0}
        print(name, rec[name], flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("suspension", "reacting", "small"),
                    required=True)
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--steps", type=int, default=cd.SUSP_STEPS)
    ap.add_argument("--b-seed", type=float, default=None,
                    help="reacting: B everywhere at the start (default: "
                    "closure_decks.REACT_B_SEED off the inlet, 0 on it)")
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    P = cd.namespace("goma_tpu", jnp, jnp.asarray)
    t0 = time.time()
    if args.part == "suspension":
        nx, ny = args.nx or 128, args.ny or 32
        rec = {"nx": nx, "ny": ny, **suspension_part(P, nx, ny, args.steps)}
    elif args.part == "reacting":
        nx, ny = args.nx or 96, args.ny or 24
        rec = {"nx": nx, "ny": ny, **reacting_part(P, nx, ny, args.b_seed)}
    else:
        rec = small_part(P)
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
