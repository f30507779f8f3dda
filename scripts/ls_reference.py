#!/usr/bin/env python3
"""goma_tpu's record of the level-set decks of ``chip_smoke.py`` phases
60-62, on the CPU (JAX, float64 state and Jacobian, float32 NDLU factors).
The decks are ``scripts/ls_decks.py``'s, built here with goma_tpu's
modules:

- ``--part melt`` / ``--part drop``: the laser melt pool or the wetting
  drop at ``--nx`` x ``--ny``, ``--steps`` backward-Euler steps without
  adaptation on each device rung (``bench._cavity_opts(kind, tol=1e-9,
  max_iter=ls_decks.MELT_MAX_ITER / DROP_MAX_ITER)``): every kept step's
  (t, dt, Newton iterations, converged), the failures, the deck's readings
  (``melt_outputs``: peak T and the interface height under the beam;
  ``drop_outputs``: the contact line, the curvature on the interface, the
  drop's area and the largest speed), x at 24 dofs and the rung's ND tree
  (fronts, fully-summed size) per level; and the float64 solution of the
  same steps on host ``direct``;
- ``--part small``: every deck of ``ls_decks.SMALL`` (goma_tpu's tests of
  the slice at their own sizes): its Newton count and its readings.

``chip_smoke.py`` carries these numbers as its ``LS_REF`` constants.

    python3 scripts/ls_reference.py --part melt --out m.json
    python3 scripts/ls_reference.py --part drop --out d.json
    python3 scripts/ls_reference.py --part small --out s.json
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

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts import ls_decks as ld  # noqa: E402

DECKS = {"melt": (ld.melt_pool, ld.melt_time, ld.melt_outputs,
                  ld.MELT_MAX_ITER, ld.MELT_STEPS),
         "drop": (ld.wetting_drop, ld.drop_time, ld.drop_outputs,
                  ld.DROP_MAX_ITER, ld.DROP_STEPS)}


def levels(nd):
    return [[int(lev.nn), int(lev.smax)] for lev in nd.levels]


def deck_part(P, deck, nx, ny, steps):
    from bench import _cavity_opts

    build, time_opts, outputs, max_iter, _ = DECKS[deck]
    prob, x0, params = build(P, nx, ny)
    rec = {"n_dof": prob.dofmap.n_dof, "nnz": prob.pattern.nnz,
           "steps_nominal": steps, "initial": outputs(P, prob, x0)}
    kinds = {"gmres+ndlu": _cavity_opts("gmres+ndlu", tol=1e-9,
                                        max_iter=max_iter),
             "tpu_direct": _cavity_opts("tpu_direct", tol=1e-9,
                                        max_iter=max_iter),
             "direct": P.NewtonOptions(max_iter=max_iter, tol_residual=1e-9,
                                       linear_solver="direct")}
    for kind, opts in kinds.items():
        ts = P.TransientSolver(prob, opts, time_opts(P, steps))
        t0 = time.time()
        res = ts.run(x0, params)
        r = {"seconds": time.time() - t0, "steps": ld.step_records(res),
             "failures": int(res.n_failures), "t": float(res.t),
             **outputs(P, prob, res.x), **ld.readings(res.x)}
        if kind != "direct":
            s = ts.newton
            r["levels"] = levels(s.precond if kind == "gmres+ndlu"
                                 else s._ndlu)
        rec[kind] = r
        print(kind, {k: v for k, v in r.items() if k != "x_samples"},
              flush=True)
    return rec


def small_part(P):
    rec = {}
    for name, deck in ld.SMALL.items():
        t0 = time.time()
        out = deck(P)
        rec[name] = {"newton": out["newton"], "reading": out["reading"],
                     "seconds": time.time() - t0}
        print(name, rec[name], flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("melt", "drop", "small"),
                    required=True)
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--ny", type=int, default=48)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    P = ld.namespace("goma_tpu", jnp, jnp.asarray)
    t0 = time.time()
    if args.part == "small":
        rec = small_part(P)
    else:
        steps = args.steps or DECKS[args.part][4]
        rec = {"nx": args.nx, "ny": args.ny,
               **deck_part(P, args.part, args.nx, args.ny, steps)}
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
