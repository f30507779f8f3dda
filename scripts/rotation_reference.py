#!/usr/bin/env python3
"""goma_tpu's record of the two decks of ``chip_smoke.py`` phases 33-36 on
the CPU, for each rung one Newton solve from x = 0 with the options those
phases run (``bench._cavity_opts("gmres+ndlu")`` and ``("tpu_direct")``,
float32 Jacobian):

- ``--deck tilted``: the Re = 100 lid-driven cavity on an n x n QUAD9 mesh
  rotated by 30 degrees, every wall a rotated constraint (walls first:
  normal and tangent 0 on left, right and bottom; then the lid: normal 0,
  tangent -1), pressure pinned at node 0 (tests/test_rotation.py's deck);
- ``--deck periodic``: the x-periodic channel [0, 2] x [0, 1] on an
  (2n) x n QUAD9 mesh, driven by the body force G = 2 (mu 0.5, rho 1,
  convection on), walls at y = 0 and 1, pressure pinned at node 0
  (tests/test_periodic.py's Poiseuille deck).

It records the Newton and linear iteration counts, the residual norms,
and x at 24 evenly spaced dofs; for the tilted deck also the solution
rotated back into the cavity's frame at the centre and the minimum of u
on the vertical centre line (Ghia's two numbers), for the periodic deck
max |u - u_exact| and max |v|. ``chip_smoke.py`` carries these numbers as
its ``TILT_REF`` and ``PER_REF`` constants.

    python3 scripts/rotation_reference.py --deck tilted --n 64 --out t.json
    python3 scripts/rotation_reference.py --deck periodic --n 32 --out p.json

Runs goma_tpu (JAX, float64 state) on the CPU; at these sizes each rung
takes about a minute.
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

RE, THETA = 100.0, np.pi / 6
G, MU = 2.0, 0.5
N_SAMPLES = 24


def tilted_problem(n):
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Momentum

    c, s = np.cos(THETA), np.sin(THETA)
    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.coords = mesh.coords @ np.array([[c, -s], [s, c]]).T
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")], {"rho": 1.0, "mu": 1.0 / RE})
    for d in ("normal", "tangent"):
        prob.add_rotated_dirichlet(("left", "right", "bottom"), "velocity", d, 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "normal", 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "tangent", -1.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = jnp.float32
    return prob


def periodic_problem(n):
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Momentum

    mesh = rectangle_mesh(2 * n, n, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 1.0))
    prob = Problem(mesh, [Momentum(dim=2, transient=False), Continuity()],
                   {"rho": 1.0, "mu": MU, "body_force": [G, 0.0]})
    prob.add_periodic("left", "right", translation=[2.0, 0.0])
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = jnp.float32
    return prob


def options(rung):
    """bench._cavity_opts(rung)'s Newton options (chip_smoke.py's
    ``cavity_opts`` and ``direct_opts``)."""
    from goma_tpu.solvers import NewtonOptions

    if rung == "gmres_ndlu":
        return NewtonOptions(max_iter=20, tol_residual=1e-6, linear_tol=1e-4,
                             precond="ndlu", linear_solver="gmres",
                             gmres_restart=60, linear_maxiter=240,
                             ndlu_leaf_max=192, prep32_tol=3e-6,
                             ew_eta_floor=0.0, ew_endgame="tighten")
    return NewtonOptions(max_iter=20, tol_residual=1e-6,
                         linear_solver="tpu_direct", ndlu_leaf_max=192,
                         ndlu_refine=1)


def outputs(deck, prob, x):
    """The deck's scalar outputs (see the module docstring)."""
    u = prob.get_nodal_field(x, "velocity", 0)
    v = prob.get_nodal_field(x, "velocity", 1)
    xy = prob.mesh.coords
    if deck == "periodic":
        y = xy[:, 1]
        return {"max_u_err": float(np.nanmax(np.abs(u - G * y * (1 - y) / (2 * MU)))),
                "max_abs_v": float(np.nanmax(np.abs(v)))}
    c, s = np.cos(THETA), np.sin(THETA)
    X = xy @ np.array([[c, -s], [s, c]])  # back into the cavity's frame
    ua = c * u + s * v
    centre = np.argmin(np.sum((X - 0.5) ** 2, axis=1))
    line = np.abs(X[:, 0] - 0.5) < 1e-9
    return {"u_centre": float(ua[centre]), "u_min_centre_line": float(np.min(ua[line]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck", choices=("tilted", "periodic"), required=True)
    ap.add_argument("--rung", choices=("gmres_ndlu", "tpu_direct", "both"),
                    default="both")
    ap.add_argument("--n", type=int, default=64,
                    help="cells a side (tilted); cells across (periodic)")
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    from goma_tpu.solvers import NewtonSolver

    prob = (tilted_problem if args.deck == "tilted" else periodic_problem)(args.n)
    params = prob.base_params()
    n_dof = prob.dofmap.n_dof
    samples = np.linspace(0, n_dof - 1, N_SAMPLES).astype(np.int64)
    record = {"deck": args.deck, "n": args.n, "n_dof": n_dof,
              "sample_dofs": samples.tolist()}
    rungs = (("gmres_ndlu", "tpu_direct") if args.rung == "both"
             else (args.rung,))
    for rung in rungs:
        t0 = time.time()
        res = NewtonSolver(prob, options(rung)).solve(np.zeros(n_dof), params)
        sec = time.time() - t0
        x = np.asarray(res.x)
        rec = {"seconds": sec, "converged": bool(res.converged),
               "newton": res.iters,
               "linear": [int(k) for k in res.linear_iters],
               "res_norms": [[float(v) for v in k] for k in res.res_norms],
               "x_samples": x[samples].tolist(),
               **outputs(args.deck, prob, x)}
        record[rung] = rec
        print(f"{args.deck} {rung}: {res.iters} Newton its, linear "
              f"{rec['linear']}, converged {res.converged}, {sec:.1f} s",
              flush=True)
        print(res.summary(), flush=True)
        print({k: v for k, v in rec.items() if k not in ("res_norms",)},
              flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
