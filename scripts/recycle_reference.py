#!/usr/bin/env python3
"""goma_tpu's record of GCRO-DR recycling on the CPU: the 64x64 lid-driven
cavity on bench.py's ``twolevel`` kind (``bench._cavity_opts("twolevel")``:
Vanka smoother, one sweep, restart 240, float32 Jacobian) with
``recycle_k`` harmonic-Ritz vectors carried between its GMRES solves, one
Newton solve from x = 0: the Newton and linear iterations, which solves
harvested a recycled space, the residual norms and the time. ``chip_smoke.py`` holds the PyTorch port's phase 66(c)
to these counts (``RECYCLE_REF``).

    python3 scripts/recycle_reference.py [--n 64] [--k 8] [--out rec.json]

Runs goma_tpu (JAX, float64 state on the CPU); at full size the solve takes
minutes (the dense coarse LU of 12,675 unknowns on the host) and several GB
of memory. Writes the record as JSON to ``--out``.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64, help="elements a side")
    ap.add_argument("--k", type=int, default=8, help="recycle_k")
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    import dataclasses

    from goma_tpu.solvers import NewtonSolver
    from scripts.twolevel_reference import cavity

    t0 = time.perf_counter()
    prob, opts = cavity(args.n, "twolevel")
    opts = dataclasses.replace(opts, recycle_k=args.k)
    solver = NewtonSolver(prob, opts)
    # which solves harvested a space for the next one (None: none)
    harvests, harvest = [], solver._dr_harvest

    def recorded_harvest(*a, **k):
        U = harvest(*a, **k)
        harvests.append(None if U is None else list(U.shape))
        return U

    solver._dr_harvest = recorded_harvest
    setup = time.perf_counter() - t0
    ndof = prob.dofmap.n_dof
    t0 = time.perf_counter()
    res = solver.solve(jnp.zeros(ndof, dtype=prob.dtype), prob.base_params())
    sec = time.perf_counter() - t0
    record = {
        "deck": "cavity", "n": args.n, "n_dof": ndof, "recycle_k": args.k,
        "gmres_restart": opts.gmres_restart, "precond": solver._precond_kind,
        "converged": bool(res.converged), "newton": int(res.iters),
        "linear": [int(v) for v in res.linear_iters],
        "harvests": harvests,
        "res_l2": [float(r[1]) for r in res.res_norms],
        "setup_s": setup, "solve_s": sec,
        "jax": jax.__version__, "backend": jax.default_backend(),
    }
    print(res.summary())
    print(json.dumps(record))
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    return 0 if res.converged else 1


if __name__ == "__main__":
    sys.exit(main())
