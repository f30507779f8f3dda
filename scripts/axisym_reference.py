#!/usr/bin/env python3
"""goma_tpu's record of the axisymmetric die deck (examples/axisym_die_swirl.py:
Momentum, SwirlMomentum, Continuity and Energy in swirling coordinates) on
the CPU: for each rung, one Newton solve from x = 0 with the options
``chip_smoke.py`` phases 30-31 run, and its Newton and linear iteration
counts, residual norms, the centre-line u_z (max over the axis nodes, as
the example reports it), the wall heat flux (``heat_flux`` over "top")
and the outlet flow rate (``flow_rate`` over "right"). ``chip_smoke.py``
carries these numbers as its ``AX_REF_*`` constants.

    python3 scripts/axisym_reference.py [--nz 64 --nr 32] [--rung gmres_ndlu]

Runs goma_tpu (JAX, float64 state, float32 Jacobian as on the port's main
path) on the CPU; at 64x32 each rung takes well under a minute. Writes
the record as JSON to ``--out``.
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

# examples/axisym_die_swirl.py::run's deck: L = 2, R = 1, G = 4, Re = 10
# (mu = 0.1), rho = 1, Omega = 0.5
L, R, G, MU, RHO, OMEGA = 2.0, 1.0, 4.0, 0.1, 1.0, 0.5


def die_problem(nz, nr):
    """examples/axisym_die_swirl.py::run's Problem at nz x nr, its
    Dirichlet specs in its order, float32 Jacobian."""
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Energy, Momentum, SwirlMomentum

    mesh = rectangle_mesh(nz, nr, elem="QUAD9", xlim=(0, L), ylim=(0, R))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh,
        [Momentum(dim=2, interp="Q2", transient=False),
         SwirlMomentum(interp="Q2", transient=False),
         Continuity(interp="Q1"),
         Energy(interp="Q2", transient=False)],
        {"rho": RHO, "mu": MU, "k": 1.0, "Cp": 1.0, "body_force": (G, 0.0)},
        coord="swirling")
    prob.add_dirichlet("top", "velocity", 0, 0.0)
    prob.add_dirichlet("top", "swirl", 0, OMEGA * R)
    prob.add_dirichlet("top", "temperature", 0, 1.0)
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    prob.add_dirichlet("bottom", "swirl", 0, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = jnp.float32
    return prob


def options(rung):
    """chip_smoke.py's phase 30 (gmres_ndlu) and 31 (tpu_direct) options."""
    from goma_tpu.solvers import NewtonOptions

    if rung == "gmres_ndlu":
        return NewtonOptions(max_iter=12, tol_residual=1e-9,
                             linear_solver="gmres", precond="ndlu",
                             linear_tol=1e-4, gmres_restart=60,
                             linear_maxiter=240, ndlu_leaf_max=192)
    return NewtonOptions(max_iter=12, tol_residual=1e-9,
                         linear_solver="tpu_direct", ndlu_leaf_max=192,
                         ndlu_refine=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rung", choices=("gmres_ndlu", "tpu_direct", "both"),
                    default="both")
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--nr", type=int, default=32)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    from goma_tpu.post.postproc import (flow_rate, heat_flux,
                                        sideset_integral)
    from goma_tpu.solvers import NewtonSolver

    prob = die_problem(args.nz, args.nr)
    params = prob.base_params()
    axis = np.abs(prob.mesh.coords[:, 1]) < 1e-12
    q_wall = sideset_integral(prob, "top", heat_flux)
    q_out = sideset_integral(prob, "right", flow_rate)
    record = {"nz": args.nz, "nr": args.nr, "n_dof": prob.dofmap.n_dof}
    rungs = (("gmres_ndlu", "tpu_direct") if args.rung == "both"
             else (args.rung,))
    for rung in rungs:
        t0 = time.time()
        res = NewtonSolver(prob, options(rung)).solve(
            np.zeros(prob.dofmap.n_dof), params)
        sec = time.time() - t0
        uz = prob.get_nodal_field(res.x, "velocity", 0)
        rec = {"seconds": sec, "converged": bool(res.converged),
               "newton": res.iters,
               "linear": [int(n) for n in res.linear_iters],
               "res_norms": [[float(v) for v in n] for n in res.res_norms],
               "uz_axis": float(np.nanmax(uz[axis])),
               "heat_flux_top": float(q_wall(res.x, params)),
               "flow_rate_right": float(q_out(res.x, params))}
        record[rung] = rec
        print(f"{rung}: {res.iters} Newton its, linear {rec['linear']}, "
              f"converged {res.converged}, {sec:.1f} s", flush=True)
        print(res.summary(), flush=True)
        print(f"{rung}: uz_axis {rec['uz_axis']!r} heat_flux_top "
              f"{rec['heat_flux_top']!r} flow_rate_right "
              f"{rec['flow_rate_right']!r}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
