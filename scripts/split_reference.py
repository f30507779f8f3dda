#!/usr/bin/env python3
"""goma_tpu's record of the split-solver decks of ``chip_smoke.py`` phases
63-65, on the CPU (JAX, float64 state and Jacobian, float32 NDLU factors).
The decks are ``scripts/split_decks.py``'s, built here with goma_tpu's
modules:

- ``--part projection``: the projection-split lid-driven cavity at ``--n``
  x ``--n``, ``--steps`` steps of ``split_decks.PROJ_DT`` from rest, on
  host ``direct`` (float64, first: its end state picks the gate's moving
  nodes) and on each device rung (``bench._cavity_opts(kind, tol=1e-9,
  max_iter=split_decks.PROJ_MAX_ITER)``): each step's Newton counts of the
  u* and pressure-increment solves, the end state's readings
  (``projection_outputs``) and each rung's two ND trees (fronts,
  fully-summed size) per level;
- ``--part segregated``: the buoyant cavity at ``--n`` x ``--n`` as one
  matrix on host ``direct`` (tol 1e-10: the coupled solution), then split
  into three matrices on each device rung (``SegregatedSolver``, tol
  ``SEG_TOL``, relaxation ``--relax``, by default ``SEG_RELAX``, the
  relaxation goma_tpu's loop needs): the outer count, each sub-solve's
  Newton counts, x at 24 dofs of each matrix, T and u at 24 nodes against
  the coupled solution, the derived catalog entries and the tracers, and
  each matrix's ND tree;
- ``--part small``: every deck of ``split_decks.SMALL``: its Newton count
  and its readings.

``chip_smoke.py`` carries these numbers as its ``SPLIT_REF`` constants.

    python3 scripts/split_reference.py --part projection --out p.json
    python3 scripts/split_reference.py --part segregated --out s.json
    python3 scripts/split_reference.py --part small --out m.json
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

from scripts import split_decks as sd  # noqa: E402

RUNGS = ("gmres+ndlu", "tpu_direct")


def levels(solver, kind):
    nd = solver.precond if kind == "gmres+ndlu" else solver._ndlu
    return [[int(lev.nn), int(lev.smax)] for lev in nd.levels]


def rung_opts(P, kind, max_iter, tol=1e-9):
    from bench import _cavity_opts

    if kind == "direct":
        return P.NewtonOptions(max_iter=max_iter, tol_residual=tol,
                               linear_solver="direct")
    return _cavity_opts(kind, tol=tol, max_iter=max_iter)


def projection_part(P, n, steps):
    rec = {"n": n, "steps": steps, "dt": sd.PROJ_DT}
    nodes = None
    for kind in ("direct",) + RUNGS:
        ps = sd.projection_cavity(P, n, rung_opts(P, kind, sd.PROJ_MAX_ITER))
        rec.setdefault("n_dof", {"ustar": ps.prob_u.dofmap.n_dof,
                                 "pphi": ps.prob_p.dofmap.n_dof})
        t0 = time.time()
        res, counts = sd.run_projection(P, ps, steps)
        r = {"seconds": time.time() - t0, "newton": counts,
             **sd.projection_outputs(P, ps, res, nodes)}
        nodes = r["gate_nodes"]
        if kind != "direct":
            r["levels"] = {"ustar": levels(ps.solver_u, kind),
                           "pphi": levels(ps.solver_p, kind)}
        rec[kind] = r
        print(kind, {k: v for k, v in r.items() if k not in ("gate",)},
              flush=True)
    return rec


def segregated_part(P, n, relax):
    rec = {"n": n, "relax": relax, "tol": sd.SEG_TOL}
    cp = sd.coupled_cavity(P, n)
    t0 = time.time()
    rc = P.NewtonSolver(cp, P.NewtonOptions(
        max_iter=15, tol_residual=1e-10, linear_solver="direct")).solve(
        np.zeros(cp.dofmap.n_dof), cp.base_params())
    assert rc.converged
    T, ux, uy = sd.coupled_fields(cp, np.asarray(rc.x))
    nodes = sd.samples(cp.mesh.n_nodes)
    rec["coupled"] = {"newton": int(rc.iters), "seconds": time.time() - t0,
                      "T": T[nodes].tolist(), "ux": ux[nodes].tolist(),
                      "uy": uy[nodes].tolist(),
                      "T_max": float(np.abs(T).max()),
                      "u_max": float(np.abs(np.stack([ux, uy])).max())}
    print("coupled", rc.iters, flush=True)
    for kind in RUNGS:
        solver, probs, _ = sd.segregated_cavity(
            P, n, rung_opts(P, kind, sd.SEG_MAX_ITER), relax)
        rec.setdefault("n_dof", {k: p.dofmap.n_dof for k, p in probs.items()})
        t0 = time.time()
        res, counts = sd.run_segregated(solver)
        sec = time.time() - t0
        out = sd.segregated_outputs(P, probs, res)
        f, c = out["fields"], rec["coupled"]
        out["vs_coupled"] = {
            "T": float(np.abs(np.subtract(f["T"], c["T"])).max() / c["T_max"]),
            "u": float(max(np.abs(np.subtract(f["ux"], c["ux"])).max(),
                           np.abs(np.subtract(f["uy"], c["uy"])).max())
                       / c["u_max"])}
        out.update(seconds=sec, newton=counts,
                   history=[h for h in res.history if h[0] == "outer"],
                   levels={k: levels(solver._solvers[k], kind)
                           for k in probs})
        rec[kind] = out
        print(kind, {k: out[k] for k in ("outer", "converged", "vs_coupled",
                                         "seconds", "newton", "levels")},
              flush=True)
    a, b = (np.asarray(rec[k]["tracers"]["end"]) for k in RUNGS)
    rec["tracers_rungs"] = float(np.abs(a - b).max())
    print("tracers between rungs", rec["tracers_rungs"], flush=True)
    return rec


def small_part(P):
    rec = {}
    for name, deck in sd.SMALL.items():
        t0 = time.time()
        out = deck(P)
        rec[name] = {"newton": out["newton"], "reading": out["reading"],
                     "seconds": time.time() - t0}
        print(name, rec[name], flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("projection", "segregated", "small"),
                    required=True)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--steps", type=int, default=sd.PROJ_STEPS)
    ap.add_argument("--relax", type=float, default=sd.SEG_RELAX)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    P = sd.namespace("goma_tpu", jnp, jnp.asarray)
    t0 = time.time()
    if args.part == "projection":
        rec = projection_part(P, args.n or sd.PROJ_N, args.steps)
    elif args.part == "segregated":
        rec = segregated_part(P, args.n or sd.SEG_N, args.relax)
    else:
        rec = small_part(P)
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
