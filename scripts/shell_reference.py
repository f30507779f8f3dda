#!/usr/bin/env python3
"""goma_tpu's record of the shell and lubrication decks of
``chip_smoke.py`` phases 48-50, on the CPU (JAX, float64 state). The decks
are ``scripts/shell_decks.py``'s, built here with goma_tpu's modules:

- ``--part bearing``: the thermal slider bearing at ``--n`` x ``--n``
  solved from x = 0 under ``bench._cavity_opts(kind, tol=1e-9,
  max_iter=12)`` on each device rung ("gmres+ndlu" and "tpu_direct"; the
  Jacobian at the problem's float64, the NDLU factors float32; with
  bench.py's float32 Jacobian the 64x64 bearing's ``gmres+ndlu`` rung
  stalls short of 1e-9 in goma_tpu): the Newton and linear
  iterations, the load (mean pad pressure), p_max, T_min, T at 24 evenly
  spaced temperature dofs and the rung's ND tree (fronts, fully-summed
  size) per level;
- ``--part film``: the drying film at ``--n`` x ``--n``, five
  Crank-Nicolson steps on each rung under the same options: the Newton
  count of each step, the film amplitude against its exact leveling
  decay, H and C at 24 evenly spaced dofs, the ND tree;
- ``--part small``: every deck of ``shell_decks.SMALL`` (goma_tpu's shell
  tests at their own sizes): its Newton count (summed over a transient's
  steps) and its readings.

``chip_smoke.py`` carries these numbers as its ``SHELL_REF`` constants.

    python3 scripts/shell_reference.py --part bearing --n 64 --out b.json
    python3 scripts/shell_reference.py --part film --n 64 --out f.json
    python3 scripts/shell_reference.py --part small --out s.json
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

from scripts import shell_decks  # noqa: E402


def goma_tpu_namespace():
    import goma_tpu.bc.sheet as sheet
    import goma_tpu.bc.shell_end as shell_end
    import goma_tpu.fem as fem
    import goma_tpu.fem.equations as equations
    import goma_tpu.fem.fields as fields
    import goma_tpu.mesh as mesh
    import goma_tpu.physics as physics
    import goma_tpu.solvers as solvers
    import goma_tpu.solvers.transient as transient

    return shell_decks.namespace(mesh, fem, physics, equations, fields,
                                 shell_end, sheet, solvers, transient, jnp,
                                 jnp.asarray)


def levels(nd):
    return [[int(lev.nn), int(lev.smax)] for lev in nd.levels]


def bearing_part(P, n):
    from bench import _cavity_opts

    prob, bi = shell_decks.bearing(P, n)
    rec = {"n": n, "n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz}
    for kind in ("gmres+ndlu", "tpu_direct"):
        t0 = time.time()
        solver = P.NewtonSolver(prob, _cavity_opts(kind, tol=1e-9, max_iter=12))
        res = solver.solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
        nd = solver.precond if kind == "gmres+ndlu" else solver._ndlu
        rec[kind] = {"seconds": time.time() - t0,
                     "converged": bool(res.converged), "newton": int(res.iters),
                     "linear": [int(v) for v in res.linear_iters],
                     "levels": levels(nd),
                     **shell_decks.bearing_readings(prob, res.x)}
        print(kind, {k: v for k, v in rec[kind].items() if k != "T_samples"},
              flush=True)
    return rec


def film_part(P, n):
    from bench import _cavity_opts

    prob, bi, x0 = shell_decks.film(P, n)
    rec = {"n": n, "n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz,
           "dt": shell_decks.FILM_DT}
    for kind in ("gmres+ndlu", "tpu_direct"):
        t0 = time.time()
        ts = P.TransientSolver(prob, _cavity_opts(kind, tol=1e-9, max_iter=12),
                               shell_decks.film_time_options(P))
        r = ts.run(x0, prob.base_params())
        solver = ts.newton
        nd = solver.precond if kind == "gmres+ndlu" else solver._ndlu
        rec[kind] = {"seconds": time.time() - t0,
                     "converged": [bool(s.converged) for s in r.steps],
                     "newton": [int(s.newton_iters) for s in r.steps],
                     "levels": levels(nd),
                     **shell_decks.film_readings(prob, r.x, r.t)}
        print(kind, {k: v for k, v in rec[kind].items()
                     if not k.endswith("_samples")}, flush=True)
    return rec


def small_part(P):
    rec = {}
    for name, deck in shell_decks.SMALL.items():
        t0 = time.time()
        out = deck(P)
        rec[name] = {"newton": out["newton"], "reading": out["reading"],
                     "seconds": time.time() - t0}
        print(name, rec[name], flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("bearing", "film", "small"), required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    P = goma_tpu_namespace()
    t0 = time.time()
    if args.part == "bearing":
        rec = bearing_part(P, args.n)
    elif args.part == "film":
        rec = film_part(P, args.n)
    else:
        rec = small_part(P)
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
