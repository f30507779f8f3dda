#!/usr/bin/env python3
"""goma_tpu's record of the wave and electrochemical decks of
``chip_smoke.py`` phases 51-53, on the CPU (JAX, float64 state and
Jacobian, float32 NDLU factors). The decks are ``scripts/em_decks.py``'s,
built here with goma_tpu's modules:

- ``--part cavity``: the lossy edge-element cavity at ``--n`` x ``--n``
  solved from x = 0 under ``bench._cavity_opts(kind, tol=1e-9,
  max_iter=8)`` on each device rung ("gmres+ndlu" and "tpu_direct"): the
  Newton and linear iterations, ||x||_2, max |x|, x at 24 evenly spaced
  dofs and the rung's ND tree (fronts, fully-summed size) per level; and
  the same readings of the float64 solution (host ``direct`` rung,
  SuperLU), against which the float32 factors' own error is read;
- ``--part waveguide``: the lossy nodal waveguide at ``--nx`` x ``--ny``,
  the same readings;
- ``--part small``: every deck of ``em_decks.SMALL`` (goma_tpu's tests of
  the slice at their own sizes): its Newton count and its readings.

``chip_smoke.py`` carries these numbers as its ``EM_REF`` constants.

    python3 scripts/em_reference.py --part cavity --n 128 --out c.json
    python3 scripts/em_reference.py --part waveguide --nx 160 --ny 32 --out w.json
    python3 scripts/em_reference.py --part small --out s.json
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

from scripts import em_decks  # noqa: E402


def levels(nd):
    return [[int(lev.nn), int(lev.smax)] for lev in nd.levels]


def rung_part(prob, max_iter=8):
    """Both device rungs on ``prob`` from x = 0."""
    from bench import _cavity_opts

    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    rec = {"n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz}
    for kind in ("gmres+ndlu", "tpu_direct"):
        t0 = time.time()
        solver = NewtonSolver(prob, _cavity_opts(kind, tol=1e-9,
                                                 max_iter=max_iter))
        res = solver.solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
        nd = solver.precond if kind == "gmres+ndlu" else solver._ndlu
        rec[kind] = {"seconds": time.time() - t0,
                     "converged": bool(res.converged), "newton": int(res.iters),
                     "linear": [int(v) for v in res.linear_iters],
                     "levels": levels(nd), **em_decks.readings(res.x)}
        print(kind, {k: v for k, v in rec[kind].items() if k != "x_samples"},
              flush=True)
    t0 = time.time()
    res = NewtonSolver(prob, NewtonOptions(
        max_iter=3, tol_residual=1e-12, linear_solver="direct")).solve(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    rec["direct"] = {"seconds": time.time() - t0, "newton": int(res.iters),
                     **em_decks.readings(res.x)}
    for kind in ("gmres+ndlu", "tpu_direct"):
        dx = np.subtract(rec[kind]["x_samples"], rec["direct"]["x_samples"])
        rec[kind]["dx_direct"] = float(np.abs(dx).max()
                                       / rec["direct"]["x_max"])
        print(f"{kind}: max |x - x_direct| / max |x_direct| at the samples "
              f"{rec[kind]['dx_direct']:.3e}", flush=True)
    return rec


def small_part(P):
    rec = {}
    for name, deck in em_decks.SMALL.items():
        t0 = time.time()
        out = deck(P)
        rec[name] = {"newton": out["newton"], "reading": out["reading"],
                     "seconds": time.time() - t0}
        print(name, rec[name], flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("cavity", "waveguide", "small"),
                    required=True)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--nx", type=int, default=160)
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    P = em_decks.namespace("goma_tpu", jnp, jnp.asarray)
    t0 = time.time()
    if args.part == "cavity":
        rec = {"n": args.n, **rung_part(em_decks.edge_cavity(P, args.n))}
    elif args.part == "waveguide":
        rec = {"nx": args.nx, "ny": args.ny,
               **rung_part(em_decks.waveguide(P, args.nx, args.ny))}
    else:
        rec = small_part(P)
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
