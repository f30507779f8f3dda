"""BASELINE config #3, the ALE slot coater (examples/slot_coater.py::build,
bench.bench_slot_coater: transient Momentum + Continuity + EllipticMesh,
capillary and kinematic face kernels on the free surface, the quality-
guarded adaptive transient driver) in the PyTorch port against goma_tpu.

- The deck restated in the port (``slot_coater`` below) at 16x4 against
  goma_tpu's ``build``: the same dofs, Dirichlet rows and values,
  ``bc_dup_log`` (13 entries: the first spec kept, as goma_tpu keeps it),
  x0 and face set; at a seeded state R, the CSR values, the row sums of
  the vals-free prep and the element matvec (block and face Jacobians),
  float64: rel 1e-10 of each array's max (readings ~1e-15).
- The golden trace tests/golden/newton_trace_slot_coater.json (16x4, dt
  0.02, no adaptation, forcing "fixed"; goma_tpu's host ``direct``) with
  the port's ``tpu_direct``, by tests/test_reference_parity.py's rule:
  Newton counts exact ([8, 8, 8, 6, 5]), each step's err_time within one
  decade; the second attempt fails Newton and is halved (dt 0.02, 0.01,
  ...).
- bench.py's ``gmres_ndlu`` options at 16x4 over the warm leg [0, 0.04]
  with the adaptive controller, float64 (Jacobian and factor) and with
  the bench's float32 Jacobian: the same attempts as goma_tpu (t, dt,
  accepted / failed Newton / rejected by the error test) and the same
  Newton count in each, x within 1e-8 (float64) and 1e-6 (float32
  Jacobian) of max|x| (both stop at a row-scaled ||R||_2 <= 3e-8 after
  inexact steps). goma_tpu's NDLU runs the port's unpivoted front LU
  (its Pallas kernel in interpret mode), as in the other port tests.

The port runs in one torch thread here (``one_torch_thread``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.slot_coater as jsc
from goma_tpu_torch.interop import params_from_numpy
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
# bench.bench_slot_coater("gmres_ndlu")'s Newton overrides
BENCH_GMRES = dict(precond="ndlu", gmres_restart=60, linear_maxiter=240,
                   ndlu_leaf_max=256, linear_tol=1e-5, ew_eta_floor=1e-3,
                   ew_endgame="standard", prep32_tol=3e-6)



def slot_coater(nx=32, ny=8, U=1.0, mu=0.1, rho=0.05, sigma=1.0, x_die=1.5,
                L=4.0, H=1.0, t_end=6.0, linear_solver="tpu_direct",
                verbose=False, jacobian_dtype=None, newton_overrides=None,
                device="cpu"):
    """examples/slot_coater.py::build restated line for line in the port:
    (prob, ts, x0). The default rung is ``tpu_direct`` (the example's
    host ``direct`` is a later slice of the port). The die BCs come last, but ``finalize`` keeps the FIRST
    spec at a duplicated dof (mm_bc_conflict.c's rule, as goma_tpu does);
    the values agree at every duplicated node."""
    from goma_tpu_torch.bc import CapillaryBC, KinematicBC
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.mesh import rectangle_mesh
    from goma_tpu_torch.mesh.mesh import SideSet
    from goma_tpu_torch.physics import Continuity, EllipticMesh, Momentum
    from goma_tpu_torch.solvers import NewtonOptions
    from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver

    mesh = rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, L), ylim=(0, H))
    # split the top side set at the die lip, snapped to an element boundary
    ss = mesh.sidesets["top"]
    xc, xr = [], []
    for e, f in zip(ss.elems, ss.faces):
        bi, le = mesh.global_elem_block(int(e))
        xs_f = mesh.coords[mesh.blocks[bi].conn[le], 0]
        xc.append(xs_f.mean())
        xr.append(xs_f.max())
    xc, xr = np.asarray(xc), np.asarray(xr)
    die = xc < x_die
    x_lip = xr[die].max()
    mesh.sidesets["die"] = SideSet(ss.elems[die], ss.faces[die])
    mesh.sidesets["free"] = SideSet(ss.elems[~die], ss.faces[~die])
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    # the contact node (x = x_lip) is in both sets
    mesh.nodesets["die_nodes"] = top[xt <= x_lip + 1e-12]
    mesh.nodesets["free_nodes"] = top[xt >= x_lip - 1e-12]

    prob = Problem(mesh, [Momentum(dim=2, transient=True), Continuity(),
                          EllipticMesh(2)],
                   {"rho": rho, "mu": mu, "sigma": sigma}, device=device)
    # web (bottom): moving wall, mesh fixed
    prob.add_dirichlet("bottom", "velocity", 0, U)
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    prob.add_dirichlet("bottom", "mesh_displacement", 0, 0.0)
    prob.add_dirichlet("bottom", "mesh_displacement", 1, 0.0)
    # inflow: Couette feed with flux q = U*H/2
    prob.add_dirichlet("left", "velocity", 0, lambda c: U * (1 - c[:, 1] / H))
    prob.add_dirichlet("left", "velocity", 1, 0.0)
    prob.add_dirichlet("left", "mesh_displacement", 0, 0.0)
    prob.add_dirichlet("left", "mesh_displacement", 1, 0.0)
    # free surface: capillary + kinematic; nodes slide vertically
    prob.add_dirichlet("free_nodes", "mesh_displacement", 0, 0.0)
    prob.add_face_kernel("free", CapillaryBC(dim=2, p_ext=0.0))
    prob.add_face_kernel("free", KinematicBC(dim=2, penalty=1e3))
    # outflow: plug flow on the web
    prob.add_dirichlet("right", "velocity", 0, U)
    prob.add_dirichlet("right", "velocity", 1, 0.0)
    prob.add_dirichlet("right", "mesh_displacement", 0, 0.0)
    # die lip: no slip, mesh fixed
    prob.add_dirichlet("die_nodes", "velocity", 0, 0.0)
    prob.add_dirichlet("die_nodes", "velocity", 1, 0.0)
    prob.add_dirichlet("die_nodes", "mesh_displacement", 0, 0.0)
    prob.add_dirichlet("die_nodes", "mesh_displacement", 1, 0.0)
    prob.finalize()

    x0 = np.zeros(prob.dofmap.n_dof)
    x0 = prob.set_nodal_field(x0, "velocity", 0, lambda c: U * (1 - c[:, 1] / H))
    # precondition the mesh near the drawn-film shape (smoothstep from H to
    # q/U downstream of the lip)
    h_inf = 0.5 * H

    def dy0(c):
        x, y = c[:, 0], c[:, 1]
        s = np.clip((x - x_lip) / 1.0, 0.0, 1.0)
        blend = s * s * (3 - 2 * s)
        h_t = H + (h_inf - H) * blend
        return (h_t - H) * (y / H)

    x0 = prob.set_nodal_field(x0, "mesh_displacement", 1, dy0)
    # keep Dirichlet-fixed mesh rows at zero
    for ns in ("bottom", "left", "die_nodes"):
        nodes = mesh.nodesets[ns]
        d = prob.dofmap.dof_of_node_svar[nodes, prob.dofmap.svar("mesh_displacement", 1)]
        x0[d[d >= 0]] = 0.0

    if jacobian_dtype is not None:
        prob.jacobian_dtype = jacobian_dtype
    nopts = dict(max_iter=20, tol_residual=3e-8, linear_solver=linear_solver,
                 linear_tol=1e-9, precond="twolevel", gmres_restart=40,
                 linear_maxiter=1200, damp=0.9)
    nopts.update(newton_overrides or {})
    ts = TransientSolver(
        prob, NewtonOptions(**nopts),
        TimeOptions(dt0=0.01, t_end=t_end, theta=0.0, adapt=True, eps_time=1e3,
                    rel_tol=1.0, growth_cap=2.0, max_dt=0.5, quality_guard=True,
                    max_failures=25, verbose=verbose))
    return prob, ts, x0


def _attempts(ts):
    """Record every Newton solve of ``ts`` (its time, dt, iterations and
    whether it converged) into a list returned here."""
    log = []
    solve = ts.newton.solve

    def rec(x, p):
        r = solve(x, p)
        log.append((round(float(p["time"]), 12), round(1.0 / float(p["ct"]), 12),
                    r.iters, bool(r.converged)))
        return r

    ts.newton.solve = rec
    return log


def test_slot_coater_deck_and_assembly_match():
    pj, _, x0j = jsc.build(nx=16, ny=4)
    pt, _, x0t = slot_coater(16, 4)
    assert pt.dofmap.n_dof == pj.dofmap.n_dof
    np.testing.assert_array_equal(pt.dirichlet_dofs, pj.dirichlet_dofs)
    np.testing.assert_array_equal(pt.dirichlet_vals, pj.dirichlet_vals)
    assert pt.bc_dup_log == pj.bc_dup_log and len(pt.bc_dup_log) == 13
    np.testing.assert_array_equal(x0t, x0j)
    assert [f.name for f in pt.face_sets] == [f.name for f in pj.face_sets] == ["free"]
    np.testing.assert_array_equal(pt.face_sets[0].face_elems,
                                  pj.face_sets[0].face_elems)
    np.testing.assert_array_equal(pt._tables["tg"].numpy(), pj._tgather_pos)
    np.testing.assert_array_equal(pt._tables["nnztg"].numpy(), pj._nnz_tgather)

    rng = np.random.default_rng(17)
    n = pj.dofmap.n_dof
    x = x0j + 0.01 * rng.standard_normal(n)
    p = {"ct": 50.0, "hist": -50.0 * x0j, "time": 0.02,
         "dirichlet_val": np.asarray(pj.dirichlet_vals)}
    jp = pj.base_params()
    jp["ct"], jp["hist"] = jnp.asarray(p["ct"]), jnp.asarray(p["hist"])
    jp["time"] = jnp.asarray(p["time"])
    tp = params_from_numpy(p, device="cpu")
    xj, xt = jnp.asarray(x), torch.as_tensor(x)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return np.abs(a - b).max() / np.abs(b).max()

    Rj, vj = pj._assemble_jit(xj, jp)
    Rt, vt = pt._assemble(xt, tp)
    assert rel(Rt, Rj) <= 1e-10 and rel(vt, vj) <= 1e-10
    Rj2, rsj, auxj = jax.jit(pj._assemble_fast)(xj, jp)
    Rt2, rst, auxt = pt._assemble_fast(xt, tp)
    # (blockJ, faceJ, pc_dg, pl_dfs), goma_tpu's aux: no point rows here
    assert len(auxt) == len(auxj) == 4 and len(auxt[1]) == 1
    assert auxt[2] == auxt[3] == ()
    assert rel(Rt2, Rj2) <= 1e-10 and rel(rst, rsj) <= 1e-10
    scale = 1.0 / np.sqrt(np.asarray(rsj))
    v = rng.standard_normal(n)
    yj = pj.element_matvec(None, auxj, jnp.asarray(scale), jnp.asarray(scale * v))
    yt = pt.element_matvec(None, auxt, torch.as_tensor(scale),
                           torch.as_tensor(scale * v))
    assert rel(yt, yj) <= 1e-10


def _check(trace, gold, max_extra_iters=0, log10_tol=1.0, floor=1e-11):
    """tests/test_reference_parity.py's rule: Newton counts exact (up to
    ``max_extra_iters``), each err_time within ``log10_tol`` decades;
    values below ``floor`` compare as equal."""
    gi, ti = gold["newton_iters"], trace["newton_iters"]
    assert len(ti) == len(gi), (ti, gi)
    for a, b in zip(ti, gi):
        assert abs(a - b) <= max_extra_iters, (ti, gi)
    g, t = gold["err_time"], trace["err_time"]
    assert len(t) == len(g), (t, g)
    for a, b in zip(t, g):
        a, b = max(a, floor), max(b, floor)
        assert abs(np.log10(a) - np.log10(b)) <= log10_tol, (t, g)


def test_slot_coater_golden_trace_tpu_direct():
    with open(os.path.join(GOLD, "newton_trace_slot_coater.json")) as f:
        gold = json.load(f)
    prob, ts, x0 = slot_coater(16, 4, t_end=0.06,
                               newton_overrides=dict(forcing="fixed"))
    ts.topts.adapt = False
    ts.topts.dt0 = 0.02
    log = _attempts(ts)
    r = ts.run(x0, prob.base_params())
    assert all(s.converged for s in r.steps)
    _check({"newton_iters": [s.newton_iters for s in r.steps],
            "err_time": [s.err_time for s in r.steps]}, gold)
    # the second attempt (t = 0.02 -> 0.04) fails Newton and is halved
    assert not log[1][3] and log[1][1] == 0.02 and log[2][1] == 0.01
    assert [s.dt for s in r.steps][:2] == [0.02, 0.01]


def _warm_leg(pkg, mixed):
    """bench.py's gmres_ndlu rung at 16x4 over the warm leg [0, 0.04] in one
    package: (attempts, TransientResult)."""
    kw = dict(BENCH_GMRES)
    if not mixed:
        kw["ndlu_dtype"] = "float64"
    if pkg == "jax":
        prob, ts, x0 = jsc.build(nx=16, ny=4, t_end=0.04, linear_solver="gmres",
                                 jacobian_dtype=jnp.float32 if mixed else None,
                                 newton_overrides=kw)
        ts.newton.precond.front_lu = "pallas"
    else:
        prob, ts, x0 = slot_coater(16, 4, t_end=0.04, linear_solver="gmres",
                                   jacobian_dtype=torch.float32 if mixed else None,
                                   newton_overrides=kw)
    log = _attempts(ts)
    return log, ts.run(x0, prob.base_params())


@pytest.mark.parametrize("mixed", [False, True])
def test_slot_coater_gmres_warm_leg_matches_goma_tpu(mixed):
    lj, rj = _warm_leg("jax", mixed)
    lt, rt = _warm_leg("torch", mixed)
    assert lt == lj
    assert [(s.t, s.dt, s.newton_iters) for s in rt.steps] == \
        [(s.t, s.dt, s.newton_iters) for s in rj.steps]
    assert abs(rt.t - 0.04) < 1e-12 and len(rt.steps) >= 5
    assert any(not c for *_, c in lt)  # a failed Newton solve was halved
    np.testing.assert_allclose(rt.x, rj.x, rtol=0,
                               atol=(1e-6 if mixed else 1e-8) * np.abs(rj.x).max())
