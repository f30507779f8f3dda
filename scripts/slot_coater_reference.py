#!/usr/bin/env python3
"""goma_tpu's record of the ALE slot coater (BASELINE config #3) on the
CPU: bench.bench_slot_coater's make() for one rung, its warm leg [0, 0.04],
``reset_lagged()``, then the timed leg to ``--t-end`` (0.08), with every
attempt of both legs (t, dt, Newton iterations, converged, linear
iterations, min detJ), the accepted steps, the free-surface heights at ten
x positions and the end min detJ. ``chip_smoke.py`` holds the PyTorch port
to these counts and heights (``SC_REF_NEWTON``, ``SC_REF_HEIGHTS``).

    python3 scripts/slot_coater_reference.py gmres_ndlu [--nx 96 --ny 24]
    python3 scripts/slot_coater_reference.py tpu_direct [--nx 96 --ny 24]

Runs goma_tpu (JAX, float64 on the CPU); at 96x24 each rung takes several
minutes and a few GB of memory. Writes the record as JSON to ``--out``.
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


def build(rung, nx, ny):
    """bench.bench_slot_coater's make() for ``rung`` at nx x ny."""
    import examples.slot_coater as sc

    if rung == "gmres_ndlu":
        return sc.build(nx=nx, ny=ny, t_end=0.04, linear_solver="gmres",
                        jacobian_dtype=jnp.float32,
                        newton_overrides=dict(
                            precond="ndlu", gmres_restart=60,
                            linear_maxiter=240, ndlu_leaf_max=256,
                            linear_tol=1e-5, ew_eta_floor=1e-3,
                            ew_endgame="standard", prep32_tol=3e-6))
    return sc.build(nx=nx, ny=ny, t_end=0.04, linear_solver=rung)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rung", choices=("gmres_ndlu", "tpu_direct"))
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--ny", type=int, default=24)
    ap.add_argument("--t-end", type=float, default=0.08)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    from goma_tpu.post.quality import make_quality_fn

    prob, ts, x0 = build(args.rung, args.nx, args.ny)
    params = prob.base_params()
    attempts = []
    solve, quality = ts.newton.solve, make_quality_fn(prob)

    def rec_solve(x, p):
        r = solve(x, p)
        attempts.append({"t": float(p["time"]), "dt": 1.0 / float(p["ct"]),
                         "newton": r.iters, "converged": bool(r.converged),
                         "linear": [int(n) for n in r.linear_iters]})
        return r

    def rec_quality(x):
        out = quality(x)
        attempts[-1]["min_detJ"] = float(out[0])
        return out

    ts.newton.solve, ts._quality_fn = rec_solve, rec_quality
    record = {"rung": args.rung, "nx": args.nx, "ny": args.ny}
    r = None
    for leg in ("warm", "timed"):
        attempts.clear()
        t0 = time.time()
        if leg == "warm":
            r = ts.run(x0, params)
        else:
            ts.newton.reset_lagged()
            ts.topts.t_end = args.t_end
            r = ts.run(r.x, params, t0=r.t, xdot0=r.xdot)
        record[leg] = {
            "seconds": time.time() - t0, "attempts": list(attempts),
            "accepted": [{"t": s.t, "dt": s.dt, "newton": s.newton_iters,
                          "err_time": s.err_time} for s in r.steps]}
        print(f"{leg} leg: {len(attempts)} attempts, {len(r.steps)} accepted, "
              f"Newton per accepted step {[s.newton_iters for s in r.steps]}",
              flush=True)
        for a in attempts:
            print(f"  t={a['t']:.6f} dt={a['dt']:.6g} Newton {a['newton']} "
                  f"converged {a['converged']} linear {sum(a['linear'])} "
                  f"min detJ {a.get('min_detJ')}", flush=True)
    dy = prob.get_nodal_field(r.x, "mesh_displacement", 1)
    free = prob.mesh.nodesets["free_nodes"]
    xs = prob.mesh.coords[free, 0]
    order = np.argsort(xs)
    xs, h = xs[order], 1.0 + dy[free][order]
    idx = np.linspace(0, len(xs) - 1, 10).round().astype(int)
    record["heights"] = [(float(xs[i]), float(h[i])) for i in idx]
    record["min_detJ"] = float(quality(r.x)[0])
    print(f"heights (x, h) at t = {r.t:.4f}: {record['heights']}; end min "
          f"detJ {record['min_detJ']}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
