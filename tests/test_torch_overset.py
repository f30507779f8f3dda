"""Overset (fictitious-domain) coupling sets and the bordered Newton solver
of the PyTorch port against goma_tpu, each deck built in both packages on
the CPU in float64 (the port in one torch thread).

The decks restate goma_tpu's tests/test_overset.py (the Couette channel
with an immersed line, aligned and not, and moved and finalized again; the
two-way solid coupling waits for the solid equations),
tests/test_overset_iterative.py (GMRES with the constraint-aware Vanka
that ``precond="auto"`` picks on a multiplier saddle), tests/test_bordered.py
(the bordered Schur solve on the ``ndlu`` and host ``direct`` base
solvers) and examples/immersed_cylinder.py (its own 20x10 deck, on the
host ``direct`` rung and on bench.py's two device rungs).

Tolerances: the host tables (combined gathers, points, weights, bases)
equal; R and the CSR values within 1e-10 of each array's max (the same
operations summed in another order; readings ~1e-16); Newton and linear
counts equal; x within 1e-9 (1 + |x|) on the float64 host rungs and the
Couette GMRES deck, and the drag (the multipliers' line integral) within
1e-8 relative; x within 1e-6 on the device rungs (float32 factors) and on
the closed-contour GMRES deck (every solve at its step cap), 1e-7 on the
bordered solve's float32 ``ndlu`` base (each test says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.fem as jfem
import goma_tpu.mesh as jmesh
import goma_tpu.physics as jphys
import goma_tpu_torch.fem as tfem
import goma_tpu_torch.mesh as tmesh
import goma_tpu_torch.physics as tphys
from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

JAX = (jmesh, jfem, jphys, jnp.asarray, {})
TORCH = (tmesh, tfem, tphys, lambda v: torch.tensor(v, dtype=torch.float64),
         {"device": "cpu"})
RTOL = 1e-10
X_TOL = 1e-9


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _dx(a, b):
    return float(np.max(np.abs(_np(a) - _np(b)) / (1.0 + np.abs(_np(b)))))


def couette(pkg, y_c=0.3, ny=10, U_s=0.4, U_top=1.0, mu=0.7, nseg=7):
    """tests/test_overset.py::couette_overset, unsolved."""
    mesh_m, fem, phys, arr, kw = pkg
    mesh = mesh_m.rectangle_mesh(4, ny, elem="QUAD9", xlim=(0, 0.8), ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    line = np.stack([np.linspace(0, 0.8, nseg + 1),
                     np.full(nseg + 1, y_c)], axis=1)
    bi = mesh_m.polyline_block(mesh, line, name="wall")
    prob = fem.Problem(mesh, [
        [phys.Momentum(dim=2, interp="Q2", transient=False, convection=False),
         phys.Continuity(interp="Q1")],
        [phys.OversetLM(dim=2)]], [{"rho": 1.0, "mu": mu}, {}], **kw)
    prob.add_dirichlet("top", "velocity", 0, U_top)
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_overset(bi, 0, phys.OversetNoSlip(
        dim=2, u_target=lambda x, params: arr([U_s, 0.0])))
    prob.finalize()
    return mesh, prob


def cylinder(pkg, nx=20, ny=10, n_seg=28, center=(0.8, 0.5), radius=0.2,
             mu=1.0, ylen=1.0, inflow="parabolic"):
    """examples/immersed_cylinder.py::run's deck (and, with a uniform
    inflow, tests/test_overset_iterative.py's and tests/test_bordered.py's),
    unsolved. Returns (problem, bar block)."""
    mesh_m, fem, phys, arr, kw = pkg
    mesh = mesh_m.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, ylen))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    bi = mesh_m.circle_block(mesh, center, radius, n=n_seg, name="cylinder")
    prob = fem.Problem(mesh, [
        [phys.Momentum(dim=2, interp="Q2", transient=False, convection=False),
         phys.Continuity(interp="Q1")],
        [phys.OversetLM(dim=2)]], [{"rho": 1.0, "mu": mu}, {}], **kw)
    if inflow == "parabolic":
        prob.add_dirichlet("left", "velocity", 0,
                           lambda c: 4 * c[:, 1] * (1 - c[:, 1]))
        prob.add_dirichlet("top", "velocity", 0, 0.0)
        prob.add_dirichlet("bottom", "velocity", 0, 0.0)
        for ns in ("left", "top", "bottom"):
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
    else:
        prob.add_dirichlet("left", "velocity", 0, 1.0)
        prob.add_dirichlet("left", "velocity", 1, 0.0)
        for ns in ("top", "bottom"):
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_overset(bi, 0, phys.OversetNoSlip(dim=2))
    prob.finalize()
    return prob, bi


def drag(prob, x, bi, radius=0.2):
    """The multipliers' x-traction times the segment length, summed."""
    bd = prob.dofmap.blocks[bi]
    s = bd.slot("lm")
    lam = np.asarray(x)[bd.gather[:, s.start:s.start + s.size]]
    return float(lam[:, 0].sum() * 2 * np.pi * radius / bd.gather.shape[0])


@pytest.fixture(scope="module")
def cyl20():
    """The example's 20x10 deck in both packages, shared by the rungs (an
    overset deck assembles the plain values on every rung, so the
    Jacobian dtype bench.py sets is not read)."""
    (pj, bi), (pt, _) = cylinder(JAX), cylinder(TORCH)
    return pj, pt, bi


@pytest.fixture(scope="module")
def cyl10():
    """tests/test_bordered.py's 10x5 deck (10 segments) in both packages."""
    (pj, bi), (pt, _) = cylinder(JAX, 10, 5, 10), cylinder(TORCH, 10, 5, 10)
    return pj, pt, bi


def _solve(pj, pt, jopts, topts, x0=None):
    x0 = np.zeros(pt.dofmap.n_dof) if x0 is None else x0
    rj = JSolver(pj, jopts).solve(x0, pj.base_params())
    rt = NewtonSolver(pt, topts).solve(x0, pt.base_params())
    assert rj.converged and rt.converged, (rj.summary(), rt.summary())
    assert rt.iters == rj.iters, (rt.iters, rj.iters)
    assert rt.linear_iters == rj.linear_iters, (rt.linear_iters, rj.linear_iters)
    return rj, rt


def test_overset_tables_equal(cyl10):
    """The host build of the overset set (kd-tree, isoparametric inversion):
    the same combined gathers, points, arc weights and background bases as
    goma_tpu's, and the same CSR pattern."""
    pj, pt, _ = cyl10
    sj, st = pj.ovs_sets[0], pt.ovs_sets[0]
    np.testing.assert_array_equal(st.gather, sj.gather)
    assert st.nlb == sj.nlb
    np.testing.assert_array_equal(st.xq, sj.xq)
    np.testing.assert_array_equal(st.wq, sj.wq)
    assert sorted(st.Nf) == sorted(sj.Nf)
    for k in sj.Nf:
        np.testing.assert_array_equal(st.Nf[k], sj.Nf[k])
    for key in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(pt.pattern, key),
                                      getattr(pj.pattern, key))


@pytest.mark.parametrize("deck", ["cylinder", "couette"])
def test_overset_system_matches_goma_tpu(deck, cyl10):
    """R and the CSR values at a seeded state (the multiplier rows, the
    reaction rows and the BAR block's zero P0 rows with their pattern
    entries) within 1e-10 of goma_tpu's; ``residual`` equals ``assemble``'s
    R to 1e-12."""
    if deck == "cylinder":
        pj, pt, _ = cyl10
    else:
        (_, pj), (_, pt) = couette(JAX, y_c=0.37, ny=8), couette(TORCH, y_c=0.37, ny=8)
    x = np.random.default_rng(13).standard_normal(pt.dofmap.n_dof)
    Rj, vj = pj.assemble(jnp.asarray(x), pj.base_params())
    Rt, vt = pt.assemble(torch.as_tensor(x), pt.base_params())
    assert _rel(Rt, Rj) <= RTOL
    assert _rel(vt, vj) <= RTOL
    assert _rel(pt.residual(torch.as_tensor(x), pt.base_params()), Rt) <= 1e-12


def test_immersed_cylinder_direct_drag(cyl20):
    """examples/immersed_cylinder.py's 20x10 deck (28 segments, 2,009 dof)
    on the host ``direct`` rung: goma_tpu's Newton count, x within 1e-9,
    the drag within 1e-8 relative of goma_tpu's (47.43937276)."""
    pj, pt, bi = cyl20
    assert pt.dofmap.n_dof == pj.dofmap.n_dof == 2009
    rj, rt = _solve(pj, pt, JOptions(max_iter=8, tol_residual=1e-9,
                                     linear_solver="direct"),
                    NewtonOptions(max_iter=8, tol_residual=1e-9,
                                  linear_solver="direct"))
    assert _dx(rt.x, rj.x) <= X_TOL
    dj, dt = drag(pj, rj.x, bi), drag(pt, rt.x, bi)
    assert abs(dt - dj) <= 1e-8 * abs(dj)
    assert abs(dt - 47.43937276) < 1e-7


def bench_opts(pkg_opts, kind, tol=1e-9, max_iter=10):
    """bench._cavity_opts(kind, tol, max_iter) in either package."""
    if kind == "gmres+ndlu":
        deep = tol < 1e-8
        return pkg_opts(max_iter=max_iter, tol_residual=tol, linear_tol=1e-4,
                        precond="ndlu", linear_solver="gmres",
                        gmres_restart=60, linear_maxiter=240,
                        ndlu_leaf_max=192, prep32_tol=3e-6,
                        ew_eta_floor=1e-3 if deep else 0.0,
                        ew_endgame="standard" if deep else "tighten")
    return pkg_opts(max_iter=max_iter, tol_residual=tol,
                    linear_solver="tpu_direct", ndlu_leaf_max=192,
                    ndlu_refine=1)


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_immersed_cylinder_device_rungs(kind, cyl20):
    """The 20x10 deck on bench.py's two device rungs: goma_tpu's Newton and
    linear counts (the multiplier and pressure rows deferred in the ND
    tree), x within 1e-6 (the float32 factors' refinement floor) and the
    drag within 1e-8."""
    pj, pt, bi = cyl20
    rj, rt = _solve(pj, pt, bench_opts(JOptions, kind),
                    bench_opts(NewtonOptions, kind))
    assert _dx(rt.x, rj.x) <= 1e-6
    assert abs(drag(pt, rt.x, bi) - drag(pj, rj.x, bi)) <= 1e-8 * abs(drag(pj, rj.x, bi))


@pytest.mark.parametrize("case", ["aligned", "nonaligned", "moved"])
def test_overset_couette(case):
    """tests/test_overset.py: the aligned line (exact piecewise-linear
    profile to the P0 mortar's 1e-3, the mean multiplier the shear
    traction jump to 1e-4), the non-aligned line, and the line moved to
    y = 0.52 and the Problem finalized again (the flow below it locked);
    every solve held to goma_tpu's x within 1e-9."""
    U_s, U_top, mu = 0.4, 1.0, 0.7
    y_c, ny = {"aligned": (0.3, 10), "nonaligned": (0.37, 8),
               "moved": (0.31, 10)}[case]
    if case == "moved":
        U_s = 0.0
    opts = dict(max_iter=8, tol_residual=1e-11, linear_solver="direct")
    xs = []
    meshes = []
    for pkg, (S, O) in ((JAX, (JSolver, JOptions)),
                        (TORCH, (NewtonSolver, NewtonOptions))):
        mesh, prob = couette(pkg, y_c=y_c, ny=ny, U_s=U_s, U_top=U_top, mu=mu)
        res = S(prob, O(**opts)).solve(np.zeros(prob.dofmap.n_dof),
                                       prob.base_params())
        assert res.converged
        out = [(prob, res)]
        if case == "moved":
            mesh.coords[mesh.nodesets["wall"], 1] = 0.52
            prob.finalize()
            res2 = S(prob, O(**opts)).solve(np.zeros(prob.dofmap.n_dof),
                                            prob.base_params())
            assert res2.converged
            out.append((prob, res2))
        xs.append(out)
        meshes.append(mesh)
    for (pj, rj), (pt, rt) in zip(*xs):
        assert rt.iters == rj.iters
        assert _dx(rt.x, rj.x) <= X_TOL
    mesh, (pt, rt) = meshes[1], xs[1][-1]
    ux = pt.get_nodal_field(rt.x, "velocity", 0)
    y = mesh.coords[:, 1]
    if case == "aligned":
        exact = np.where(y <= y_c, U_s * y / y_c,
                         U_s + (U_top - U_s) * (y - y_c) / (1 - y_c))
        m = ~np.isnan(ux)
        np.testing.assert_allclose(ux[m], exact[m], atol=1e-3)
        bd = pt.dofmap.blocks[1]
        lam_x = rt.x[bd.gather[:, bd.slot("lm").start]]
        tau_jump = mu * ((U_top - U_s) / (1 - y_c) - U_s / y_c)
        np.testing.assert_allclose(lam_x.mean(), tau_jump, rtol=1e-4)
    elif case == "moved":
        wall = mesh.nodesets["wall"]
        probe = ~np.isnan(ux) & (np.abs(y - 0.45) < 0.03) & (np.arange(len(y)) < wall.min())
        assert np.nanmax(np.abs(ux[probe])) < 0.05


GMRES_AUTO = dict(tol_residual=1e-9, linear_solver="gmres", precond="auto",
                  linear_tol=1e-9, gmres_restart=160, linear_maxiter=4000,
                  forcing="fixed", precond_lag=False)


@pytest.mark.parametrize("deck", ["couette", "cylinder"])
def test_overset_gmres_constraint_aware_vanka(deck):
    """tests/test_overset_iterative.py: ``precond="auto"`` picks the
    constraint-aware Vanka (the overset rows' gathers as extra Schwarz
    blocks); GMRES then takes goma_tpu's Newton and linear counts. On the
    Couette deck x lands within 1e-9 of goma_tpu's iterate. On the closed
    contour every GMRES solve of both packages stops at the 4,000-step cap
    (the fictitious interior stalls the Krylov solves, as goma_tpu's test
    says), so each iterate carries its unconverged Krylov residual and
    rounding differences grow over 8,000 steps: x within 1e-6 there
    (goma_tpu's own bound against the direct solve is 1e-3)."""
    if deck == "couette":
        (_, pj), (_, pt) = couette(JAX), couette(TORCH)
        kw = dict(GMRES_AUTO, max_iter=8, tol_residual=1e-10,
                  linear_tol=1e-10, gmres_restart=120, linear_maxiter=3000)
        x_tol = X_TOL
    else:
        (pj, _), (pt, _) = (cylinder(p, 10, 6, 24, (0.7, 0.6), 0.22, 0.05,
                                     1.2, "uniform") for p in (JAX, TORCH))
        kw = dict(GMRES_AUTO, max_iter=6)
        x_tol = 1e-6
    solver = NewtonSolver(pt, NewtonOptions(**kw))
    assert solver._precond_kind == "vanka"
    rj, rt = _solve(pj, pt, JOptions(**kw), NewtonOptions(**kw))
    assert _dx(rt.x, rj.x) <= x_tol


@pytest.mark.parametrize("base", ["ndlu", "direct"])
def test_bordered_matches_goma_tpu(base, cyl10):
    """tests/test_bordered.py: the multiplier mask (one 2-vector per
    segment), the bordered Schur solve on the 10x5 deck (10 segments) on
    the ``ndlu`` base (against the monolithic host solve to 1e-6, the
    test's bound) and on the host ``direct`` base; goma_tpu's iteration
    count, x within 1e-9 of goma_tpu's bordered iterate on the host base
    and within 1e-7 on ``ndlu`` (float32 factors refined twice: each
    package's iterate carries its own ~1e-9 residual)."""
    from goma_tpu.solvers.bordered import BorderedNewtonSolver as JB
    from goma_tpu_torch.solvers.bordered import (BorderedNewtonSolver,
                                                 multiplier_dof_mask)

    ns, tol, x_tol = (10, 1e-8, 1e-7) if base == "ndlu" else (10, 1e-9, X_TOL)
    pj, pt, _ = cyl10
    mask = multiplier_dof_mask(pt)
    assert mask.sum() == 2 * ns
    x0 = np.zeros(pt.dofmap.n_dof)
    rj = JB(pj, mask, JOptions(max_iter=8, tol_residual=tol),
            base_solver=base).solve(x0, pj.base_params())
    rt = BorderedNewtonSolver(pt, mask, NewtonOptions(max_iter=8, tol_residual=tol),
                              base_solver=base).solve(x0, pt.base_params())
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    assert _dx(rt.x, rj.x) <= x_tol
    if base == "ndlu":
        mono = NewtonSolver(pt, NewtonOptions(max_iter=8, tol_residual=1e-9,
                                              linear_solver="direct")).solve(
            x0, pt.base_params())
        assert np.linalg.norm(rt.x - mono.x) / np.linalg.norm(mono.x) < 1e-6
    else:
        assert np.abs(rt.x[mask]).max() > 1e-3
