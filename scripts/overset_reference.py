#!/usr/bin/env python3
"""goma_tpu's record of the overset, interface and edge decks of
``chip_smoke.py`` phases 45-47, on the CPU (JAX, float64 state):

- ``--part cylinder``: examples/immersed_cylinder.py's problem (QUAD9 on
  [0, 2] x [0, 1], Stokes mu = 1, parabolic inflow, a circle of radius 0.2
  at (0.8, 0.5) of ``--nseg`` segments carrying P0 multipliers) at
  ``--nx`` x ``--ny``, solved from x = 0 under
  ``bench._cavity_opts(kind, tol=1e-9, max_iter=10)`` on each device rung
  ("gmres+ndlu" and "tpu_direct", float32 Jacobian as bench.py sets it):
  the Newton and linear iterations, the residual norms, the drag (the
  multipliers' x-traction times the segment length, summed), the state at
  24 evenly spaced dofs and each rung's ND tree (fronts, fully-summed
  size) per level;
- ``--part small``: the example's own 20x10 deck (28 segments) on the host
  ``direct`` rung and on ``gmres`` with ``precond="auto"`` (the
  constraint-aware Vanka; tests/test_overset_iterative.py's options), the
  bordered Newton solve on the ``ndlu`` base (tests/test_bordered.py's
  options), the two-layer contact resistance of tests/test_interface.py,
  the DG stress decay channel of tests/test_viscoelastic.py (16x2), the
  HEX27 edge line source of tests/test_edge_wetting_bcs.py (3x3x3) and its
  FILL_CA wetting deck (8x4).

``chip_smoke.py`` carries these numbers as its ``OVS_REF`` and
``OVS_SMALL_REF`` constants.

    python3 scripts/overset_reference.py --part cylinder --nx 96 --ny 48 \\
        --nseg 134 --out cyl.json
    python3 scripts/overset_reference.py --part small --out small.json
    python3 scripts/overset_reference.py --part cylinder --front-lu pallas

``--front-lu pallas`` runs the cylinder's ``gmres+ndlu`` rung alone with
the preconditioner's front LU pinned to goma_tpu's unpivoted kernel
(interpret mode on the CPU), the route the port's kernel takes.

Run times (one CPU process, jax 0.9.0): ``--part cylinder
--nx 96 --ny 48 --nseg 134`` 34.5 s (each rung ~15 s, most of it jit
compiles); ``--part small`` 41.4 s (the Vanka-GMRES deck 20 s, the
bordered solve's vmapped NDLU solve 13 s).
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

N_SAMPLES = 24
RADIUS = 0.2


def cylinder(nx, ny, nseg):
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import circle_block, rectangle_mesh
    from goma_tpu.physics import Continuity, Momentum, OversetLM, OversetNoSlip

    mesh = rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 1.0))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    bi = circle_block(mesh, (0.8, 0.5), RADIUS, n=nseg, name="cylinder")
    prob = Problem(mesh, [
        [Momentum(dim=2, interp="Q2", transient=False, convection=False),
         Continuity(interp="Q1")], [OversetLM(dim=2)]],
        [{"rho": 1.0, "mu": 1.0}, {}])
    prob.add_dirichlet("left", "velocity", 0, lambda c: 4 * c[:, 1] * (1 - c[:, 1]))
    prob.add_dirichlet("top", "velocity", 0, 0.0)
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    for ns in ("left", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_overset(bi, 0, OversetNoSlip(dim=2))
    prob.finalize()
    return prob, bi


def drag(prob, x, bi):
    bd = prob.dofmap.blocks[bi]
    s = bd.slot("lm")
    lam = np.asarray(x)[bd.gather[:, s.start:s.start + s.size]]
    return float(lam[:, 0].sum() * 2 * np.pi * RADIUS / bd.gather.shape[0])


def samples(prob, x):
    idx = np.linspace(0, prob.dofmap.n_dof - 1, N_SAMPLES).astype(np.int64)
    return np.asarray(x)[idx].tolist()


def levels(nd):
    return [[int(lev.nn), int(lev.smax)] for lev in nd.levels]


def cylinder_part(nx, ny, nseg, front_lu=None):
    from bench import _cavity_opts
    from goma_tpu.solvers import NewtonSolver

    prob, bi = cylinder(nx, ny, nseg)
    prob.jacobian_dtype = jnp.float32
    rec = {"nx": nx, "ny": ny, "nseg": nseg, "n_dof": prob.dofmap.n_dof,
           "nnz": prob.pattern.nnz,
           "n_lm": int(2 * prob.dofmap.blocks[bi].gather.shape[0])}
    for kind in ("gmres+ndlu",) if front_lu else ("gmres+ndlu", "tpu_direct"):
        t0 = time.time()
        solver = NewtonSolver(prob, _cavity_opts(kind, tol=1e-9, max_iter=10))
        if front_lu:
            # the preconditioner's front LU route, pinned from here as the
            # port's CPU tests pin it ("pallas": the unpivoted kernel, in
            # interpret mode off a TPU)
            solver.precond.front_lu = front_lu
            rec["front_lu"] = front_lu
        res = solver.solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
        nd = solver.precond if kind == "gmres+ndlu" else solver._ndlu
        rec[kind] = {"seconds": time.time() - t0,
                     "converged": bool(res.converged), "newton": int(res.iters),
                     "linear": [int(v) for v in res.linear_iters],
                     "res_norms": [[float(v) for v in r] for r in res.res_norms],
                     "drag": drag(prob, res.x, bi),
                     "x_samples": samples(prob, res.x), "levels": levels(nd)}
        print(kind, {k: v for k, v in rec[kind].items() if k != "x_samples"},
              flush=True)
    return rec


def small_part():
    from goma_tpu.fem import Problem
    from goma_tpu.mesh import box_mesh, rectangle_mesh
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    rec = {}
    prob, bi = cylinder(20, 10, 28)
    x0 = np.zeros(prob.dofmap.n_dof)
    for name, opts in (
            ("direct", NewtonOptions(max_iter=8, tol_residual=1e-9,
                                     linear_solver="direct")),
            ("gmres_auto", NewtonOptions(
                max_iter=6, tol_residual=1e-9, linear_solver="gmres",
                precond="auto", linear_tol=1e-9, gmres_restart=160,
                linear_maxiter=4000, forcing="fixed", precond_lag=False))):
        t0 = time.time()
        res = NewtonSolver(prob, opts).solve(x0, prob.base_params())
        rec[name] = {"seconds": time.time() - t0, "newton": int(res.iters),
                     "linear": [int(v) for v in res.linear_iters],
                     "converged": bool(res.converged),
                     "drag": drag(prob, res.x, bi),
                     "x_samples": samples(prob, res.x)}
        print(name, {k: v for k, v in rec[name].items() if k != "x_samples"},
              flush=True)
    from goma_tpu.solvers.bordered import (BorderedNewtonSolver,
                                           multiplier_dof_mask)

    t0 = time.time()
    bres = BorderedNewtonSolver(prob, multiplier_dof_mask(prob), NewtonOptions(
        max_iter=8, tol_residual=1e-8), base_solver="ndlu").solve(
        x0, prob.base_params())
    rec["bordered"] = {"seconds": time.time() - t0, "iters": int(bres.iters),
                       "converged": bool(bres.converged),
                       "drag": drag(prob, bres.x, bi),
                       "x_samples": samples(prob, bres.x)}
    print("bordered", {k: v for k, v in rec["bordered"].items()
                       if k != "x_samples"}, flush=True)

    # two-layer contact resistance (tests/test_interface.py)
    from goma_tpu.mesh.interface import find_interface_faces, split_interface
    from goma_tpu.mesh.mesh import Block, Mesh
    from goma_tpu.physics import Energy, InterfaceExchange

    gx, gy = 9, 3
    X, Y = np.meshgrid(np.linspace(0, 1, gx), np.linspace(0, 1, gy), indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    ca, cb = [], []
    for j in range(2):
        for i in range(8):
            c = [j * gx + i, j * gx + i + 1, (j + 1) * gx + i + 1, (j + 1) * gx + i]
            (ca if i < 4 else cb).append(c)
    mesh = Mesh(2, coords, [Block("A", "QUAD4", np.asarray(ca, dtype=np.int32)),
                            Block("B", "QUAD4", np.asarray(cb, dtype=np.int32))])
    mesh.nodesets = {"left": np.where(np.isclose(coords[:, 0], 0.0))[0].astype(np.int32),
                     "right": np.where(np.isclose(coords[:, 0], 1.0))[0].astype(np.int32)}
    mesh.sidesets = {}
    pairs = find_interface_faces(mesh, 0, 1)
    orig, new = split_interface(mesh, pairs)
    ip = Problem(mesh, [[Energy(interp="Q1", transient=False, convection=False)],
                        [Energy(interp="Q1", transient=False, convection=False)]],
                 [{"rho": 1.0, "Cp": 1.0, "k": 2.0}, {"rho": 1.0, "Cp": 1.0, "k": 0.5}])
    ip.add_dirichlet("left", "temperature", 0, 1.0)
    ip.add_dirichlet("right", "temperature", 0, 0.0)
    ip.add_interface_kernel(pairs, InterfaceExchange("temperature", coeff=4.0))
    ip.finalize()
    r = NewtonSolver(ip, NewtonOptions(max_iter=4, tol_residual=1e-11,
                                       linear_solver="direct")).solve(
        np.zeros(ip.dofmap.n_dof), ip.base_params())
    T = ip.get_nodal_field(r.x, "temperature")
    rec["contact"] = {"newton": int(r.iters), "T_a": float(T[orig].mean()),
                      "T_b": float(T[new].mean())}
    print("contact", rec["contact"], flush=True)

    # the DG stress decay channel (tests/test_viscoelastic.py)
    from goma_tpu.mesh.interface import interior_face_pairs
    from goma_tpu.physics import Continuity, Momentum, VEStress
    from goma_tpu.physics.viscoelastic import DGStressInflow, DGStressUpwind

    mesh = rectangle_mesh(16, 2, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 0.25))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    dp = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                        Continuity(interp="Q1"),
                        VEStress(0, dim=2, lam=0.5, mu_p=1.0, interp="P1E",
                                 supg=0.0, use_projected_gradient=False,
                                 transient=False)], {"rho": 0.0, "mu": 1.0})
    for ns in ("left", "right", "top", "bottom"):
        dp.add_dirichlet(ns, "velocity", 0, 1.0)
        dp.add_dirichlet(ns, "velocity", 1, 0.0)
    dp.add_dirichlet("pin", "pressure", 0, 0.0)
    dp.add_interface_kernel(interior_face_pairs(mesh, 0), DGStressUpwind(0, lam=0.5))
    dp.add_face_kernel("left", DGStressInflow(0, lam=0.5, s_in=[1.0, 0.5, 0.25]))
    dp.finalize()
    r = NewtonSolver(dp, NewtonOptions(max_iter=8, tol_residual=1e-11,
                                       linear_solver="direct")).solve(
        np.zeros(dp.dofmap.n_dof), dp.base_params())
    bd = dp.dofmap.blocks[0]
    s = bd.slot("stress0")
    vals = r.x[bd.gather[:, s.start]]
    xc = mesh.coords[mesh.blocks[0].conn].mean(axis=1)[:, 0]
    order = np.argsort(xc)
    rec["dg"] = {"newton": int(r.iters),
                 "rate": float(np.polyfit(xc[order], np.log(vals[order]), 1)[0])}
    print("dg", rec["dg"], flush=True)

    # the HEX27 edge line source (tests/test_edge_wetting_bcs.py)
    from goma_tpu.bc.edge import EdgeTraction
    from goma_tpu.post import heat_flux, sideset_integral

    mesh = box_mesh(3, 3, 3, elem="HEX27")
    ep = Problem(mesh, [Energy(interp="Q2", transient=False, convection=False)],
                 {"k": 1.0})
    ep.add_dirichlet("bottom", "temperature", 0, 0.0)
    ep.add_edge_kernel("top", "right", EdgeTraction("temperature", 1, 2.5))
    ep.finalize()
    r = NewtonSolver(ep, NewtonOptions(max_iter=5, linear_solver="direct")).solve(
        np.zeros(ep.dofmap.n_dof), ep.base_params())
    F = sideset_integral(ep, "bottom", heat_flux)
    rec["edge"] = {"newton": int(r.iters),
                   "flux": float(F(jnp.asarray(r.x), ep.base_params()))}
    print("edge", rec["edge"], flush=True)

    # the FILL_CA wetting deck (tests/test_edge_wetting_bcs.py)
    from goma_tpu.bc.wetting import FillContactAngle
    from goma_tpu.physics.level_set import FILL_VAR, FillEquation

    mesh = rectangle_mesh(8, 4, elem="QUAD9")
    wp = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                        Continuity(interp="Q1"), FillEquation(interp="Q2")],
                 {"rho": 1.0, "mu": 1.0})
    wp.add_face_kernel("bottom", FillContactAngle(dim=2, theta_deg=55.0,
                                                  sigma=0.8, eps=0.15))
    wp.finalize()
    th = np.deg2rad(65.0)
    nf = np.array([-np.sin(th), -np.cos(th)])
    x = np.zeros(wp.dofmap.n_dof)
    dF = wp.dofmap.dof_of_node_svar[:, wp.dofmap.svar(FILL_VAR)]
    ok = dF >= 0
    x[dF[ok]] = (mesh.coords[ok] - [0.5, 0.0]) @ nf
    R, _ = wp.assemble(jnp.asarray(x), wp.base_params())
    R = np.asarray(R)
    rec["wetting"] = {"force": [float(-R[d[d >= 0]].sum()) for d in (
        wp.dofmap.dof_of_node_svar[:, wp.dofmap.svar("velocity", c)]
        for c in range(2))]}
    print("wetting", rec["wetting"], flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("cylinder", "small"), required=True)
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--ny", type=int, default=48)
    ap.add_argument("--nseg", type=int, default=134)
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    ap.add_argument("--front-lu", choices=("pallas", "lax"), default=None,
                    help="cylinder: the gmres+ndlu rung only, its NDLU's "
                         "front LU route pinned (default: goma_tpu's own)")
    args = ap.parse_args()
    t0 = time.time()
    if args.part == "cylinder":
        rec = cylinder_part(args.nx, args.ny, args.nseg, args.front_lu)
    else:
        rec = small_part()
    rec["total_seconds"] = time.time() - t0
    print(f"{args.part}: {rec['total_seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
