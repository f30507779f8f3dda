"""Periodicity of the PyTorch port against goma_tpu: ``add_periodic``
aliases each slave node to its root's dofs (``build_dofmap(...,
node_alias=)``, union-find roots for chained corners), so the dofmap, the
CSR pattern and everything built on them change. Each deck is built in both
packages on the CPU in float64 (the port in one torch thread).

- tests/test_periodic.py's decks: the periodic Poisson manufactured
  solution (16x4), the body-force Poiseuille channel (6x8) on host direct
  and on ``gmres`` with the two-level preconditioner (its stabilized
  Galerkin coarse space, ``coarse_reg``), and the doubly periodic corner
  chain (4x4 QUAD4: the four corners share one dof).
- A periodic Couette channel on the fused Navier-Stokes block: a slave
  node's (u, v) pair in ``fastns.node_gather`` is its root's.
- For each: the dofmap (``node_alias``, every dof table) and the CSR
  pattern EQUAL to goma_tpu's; at a seeded state R, the CSR values, the
  residual-only pass, the vals-free prep's R and row sums and the element
  matvec within 1e-12 (``test_torch_bc_rows._same_system``); Newton with
  goma_tpu's iteration and linear counts and x within 1e-9 (1 + |x|)
  (``_same_newton``; the two-level run's bounds are in its test), and
  each deck's own check from goma_tpu's test.
"""

import jax.numpy as jnp
import numpy as np
import torch

from goma_tpu.fem.equations import Equation as JEquation
from goma_tpu_torch.fem.equations import Equation as TEquation
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_bc_rows import _same_newton, _same_system
from test_torch_host import JAX_PKG, TORCH_PKG, cpu
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)


def poisson_mms(pkg, interp="Q2"):
    """tests/test_periodic.py's ``_PoissonMMS``: -lap(u) = (2 pi)^2
    sin(2 pi x), in the package's own Equation base and math."""
    xp, base = (jnp, JEquation) if pkg is JAX_PKG else (torch, TEquation)

    class PoissonMMS(base):
        def __init__(self):
            super().__init__("temperature", 1, interp)

        def residual(self, fv, mat, params):
            gT = fv.grad["temperature"][:, 0, :]
            f = (2 * np.pi) ** 2 * xp.sin(2 * np.pi * fv.x[:, 0])
            return (xp.einsum("qk,qik->qi", gT, fv.gphi["temperature"])
                    - f[:, None] * fv.phi["temperature"])[:, None, :]

    return PoissonMMS()


def _same_dofmap(pj, pt):
    dj, dt = pj.dofmap, pt.dofmap
    np.testing.assert_array_equal(dt.node_alias, dj.node_alias)
    for k in ("dof_of_node_svar", "node_dof_start", "node_dof_count"):
        np.testing.assert_array_equal(getattr(dt, k), getattr(dj, k))
    assert dt.n_dof == dj.n_dof
    for a, b in zip(dt.blocks, dj.blocks):
        np.testing.assert_array_equal(a.gather, b.gather)
    np.testing.assert_array_equal(pt.pattern.keys, pj.pattern.keys)


def poisson_deck(pkg):
    mesh_m, fem, _ = pkg
    mesh = mesh_m.rectangle_mesh(16, 4, elem="QUAD9")
    prob = fem.Problem(mesh, [[poisson_mms(pkg)]], [{}], **cpu(pkg))
    prob.add_periodic("left", "right")
    mesh.nodesets["pin"] = np.array([np.argmin(
        np.abs(mesh.coords[:, 0] - 0.25) + np.abs(mesh.coords[:, 1]))],
        dtype=np.int32)
    xpin = mesh.coords[mesh.nodesets["pin"][0], 0]
    prob.add_dirichlet("pin", "temperature", 0, float(np.sin(2 * np.pi * xpin)))
    prob.finalize()
    return prob


def test_periodic_poisson_mms():
    """The left/right pairs share one dof each; the periodic solution is
    within 2e-4 of sin(2 pi x) (goma_tpu's bound)."""
    pj, pt = poisson_deck(JAX_PKG), poisson_deck(TORCH_PKG)
    _same_dofmap(pj, pt)
    x = np.random.default_rng(20).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                       dict(max_iter=4, tol_residual=1e-12,
                            linear_solver="direct"))
    T = pt.get_nodal_field(res.x, "temperature")
    m = pt.mesh
    ln, rn = m.nodesets["left"], m.nodesets["right"]
    ly, ry = np.argsort(m.coords[ln, 1]), np.argsort(m.coords[rn, 1])
    np.testing.assert_array_equal(T[ln[ly]], T[rn[ry]])
    assert np.max(np.abs(T - np.sin(2 * np.pi * m.coords[:, 0]))) < 2e-4


def poiseuille_deck(pkg, nx=6, ny=8):
    """tests/test_periodic.py's periodic channel: x-periodic on [0, 2] x
    [0, 1], driven by the body force G = 2 (mu 0.5), no inflow/outflow
    conditions, convection on."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, 1.0))
    prob = fem.Problem(mesh, [[phys.Momentum(dim=2, transient=False),
                               phys.Continuity()]],
                       [{"rho": 1.0, "mu": 0.5, "body_force": [2.0, 0.0]}],
                       **cpu(pkg))
    prob.add_periodic("left", "right", translation=[2.0, 0.0])
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


def test_periodic_channel_poiseuille():
    """u = G y (1 - y) / (2 mu) within 1e-9 and v within 1e-9 on host
    direct; then ``gmres`` with the two-level preconditioner (goma_tpu's
    options): goma_tpu's Newton count and u within 1e-7 of the profile,
    GMRES within 1 iteration a step of goma_tpu's,
    x within 1e-7 (1 + |x|) and ||R||_2 within rel 1e-4 there, as
    tests/test_torch_solvers.py allows the buoyant deck's two-level run:
    the Hessenberg least squares is an LU solve in the port and
    Gauss-Jordan in goma_tpu, and the body force's pressure head makes the
    step sensitive to that rounding (readings: [18] against [19])."""
    pj, pt = poiseuille_deck(JAX_PKG), poiseuille_deck(TORCH_PKG)
    _same_dofmap(pj, pt)
    x = 0.1 * np.random.default_rng(21).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    x0 = np.zeros(pt.dofmap.n_dof)
    res = _same_newton(pj, pt, x0, dict(max_iter=10, tol_residual=1e-11,
                                        linear_solver="direct"))
    y = pt.mesh.coords[:, 1]
    u_exact = 2.0 * y * (1.0 - y) / (2 * 0.5)
    u = pt.get_nodal_field(res.x, "velocity", 0)
    assert np.max(np.abs(u - u_exact)) < 1e-9 * max(1.0, np.abs(u_exact).max())
    assert np.max(np.abs(pt.get_nodal_field(res.x, "velocity", 1))) < 1e-9
    res2 = _same_newton(pj, pt, x0, dict(
        max_iter=10, tol_residual=1e-9, linear_solver="gmres",
        precond="twolevel", linear_tol=1e-8, gmres_restart=200,
        linear_maxiter=800), lin_tol=1, x_tol=1e-7, norm_rtol=1e-4)
    u2 = pt.get_nodal_field(res2.x, "velocity", 0)
    assert np.max(np.abs(u2 - u_exact)) < 1e-7


def test_doubly_periodic_corner_chain():
    """Both periodic pairs on a 4x4 QUAD4 cell: the union-find roots chain
    the four corners into ONE dof, as goma_tpu's; the pinned problem
    solves."""
    def deck(pkg):
        mesh_m, fem, _ = pkg
        mesh = mesh_m.rectangle_mesh(4, 4, elem="QUAD4")
        prob = fem.Problem(mesh, [[poisson_mms(pkg, interp="Q1")]], [{}],
                           **cpu(pkg))
        prob.add_periodic("left", "right")
        prob.add_periodic("bottom", "top")
        mesh.nodesets["pin"] = np.array([5], dtype=np.int32)
        prob.add_dirichlet("pin", "temperature", 0, 0.0)
        prob.finalize()
        return prob

    pj, pt = deck(JAX_PKG), deck(TORCH_PKG)
    _same_dofmap(pj, pt)
    m, dm = pt.mesh, pt.dofmap
    corners = [np.argmin(np.sum(np.abs(m.coords - np.array(c)), axis=1))
               for c in ((0, 0), (1, 0), (0, 1), (1, 1))]
    assert len({int(dm.dof_of_node_svar[c, 0]) for c in corners}) == 1
    x = np.random.default_rng(22).standard_normal(dm.n_dof)
    _same_system(pj, pt, x)
    _same_newton(pj, pt, np.zeros(dm.n_dof), dict(
        max_iter=4, tol_residual=1e-11, linear_solver="direct"))


def couette_deck(pkg):
    """An x-periodic Couette channel on the fused Navier-Stokes block
    (Galerkin, constant rho and mu, no body force): the top wall moves at
    u = 1, the bottom is fixed."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(4, 4, elem="QUAD9", xlim=(0, 2.0))
    prob = fem.Problem(mesh, [phys.Momentum(dim=2, transient=False),
                              phys.Continuity()], {"rho": 1.0, "mu": 0.2},
                       **cpu(pkg))
    prob.add_periodic("left", "right")
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    for ns, k in (("top", 1), ("bottom", 0), ("bottom", 1)):
        prob.add_dirichlet(ns, "velocity", k, 0.0)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


def test_periodic_deck_on_the_fused_block():
    """The fused kernel's node gather on an aliased dofmap: every slave
    velocity node reads its root's (u, v) pair; the system and Newton on
    ``gmres`` + NDLU and host direct match goma_tpu's; u = y (Couette)."""
    pj, pt = couette_deck(JAX_PKG), couette_deck(TORCH_PKG)
    assert 0 in pt._fast_meta and 0 in pj._fast_meta
    _same_dofmap(pj, pt)
    gnode = pt._tables["fns:gnode0"].numpy()
    alias = pt.dofmap.node_alias
    conn = pt.mesh.blocks[0].conn
    bd = pt.dofmap.blocks[0]
    sl = bd.slot("velocity")
    from goma_tpu_torch.elements import interp_local_nodes

    ln = list(interp_local_nodes("quad", sl.interp))
    root_u = pt.dofmap.dof_of_node_svar[alias[conn[:, ln]],
                                        pt.dofmap.svar("velocity", 0)]
    np.testing.assert_array_equal(gnode, root_u)
    assert np.any(alias[conn[:, ln]] != conn[:, ln])  # slaves are read
    x = 0.1 * np.random.default_rng(23).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    x0 = np.zeros(pt.dofmap.n_dof)
    _same_newton(pj, pt, x0, dict(max_iter=10, tol_residual=1e-10,
                                  linear_solver="gmres", precond="ndlu",
                                  linear_tol=1e-10))
    res = _same_newton(pj, pt, x0, dict(max_iter=10, tol_residual=1e-10,
                                        linear_solver="direct"))
    u = pt.get_nodal_field(res.x, "velocity", 0)
    np.testing.assert_allclose(u, pt.mesh.coords[:, 1], atol=1e-9)
