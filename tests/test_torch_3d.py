"""Three-dimensional decks of the PyTorch port against goma_tpu: goma_tpu's
tests/test_3d.py restated in both packages on the CPU in float64 (the port
in one torch thread). HEX27 blocks take the port's generic AD path
(``vmap(jacfwd)`` over the elements; the fused block is 2-D only).

- The manufactured Navier-Stokes solution on a 3x3x3 HEX27 box (Q2/Q1):
  the body force f = rho u.grad u - mu lap u + grad p of the exact fields
  by each package's own forward AD (``jax.jacfwd``/``jax.hessian``,
  ``torch.func.jacfwd``/``hessian``, nested inside the element
  ``jacfwd``), the exact velocity on every wall. At a seeded state R and
  the CSR values within 1e-12 of goma_tpu's, ``residual`` equal to
  ``assemble``'s R; Newton on host direct with goma_tpu's iteration count
  and x within 1e-9 (1 + |x|); the velocity within 1.5e-3 and the
  pressure within goma_tpu's bounds of the exact fields.
- Poisson on a 4x4x4 HEX27 box with the source 3 pi^2 sin sin sin:
  goma_tpu's Newton options (``gmres`` with its default preconditioner):
  the same Newton and GMRES counts, x within 1e-9, T within 4e-3 of the
  exact solution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_bc_rows import _same_newton, _same_system
from test_torch_host import JAX_PKG, TORCH_PKG, cpu

MU, RHO = 0.7, 1.0


def _fields(xp):
    def u_exact(x):
        X, Y, Z = x[0], x[1], x[2]
        return xp.stack([xp.sin(np.pi * Y) * Z * (1 - Z),
                         xp.sin(np.pi * Z) * X * (1 - X),
                         xp.sin(np.pi * X) * Y * (1 - Y)]) * 0.1

    def p_exact(x):
        return xp.cos(np.pi * x[0]) * x[1] + x[2]

    return u_exact, p_exact


def _body_force(pkg):
    """tests/test_3d.py's ``body_force`` in the package's own AD."""
    if pkg is JAX_PKG:
        xp, jacfwd, hessian, vmap = jnp, jax.jacfwd, jax.hessian, jax.vmap
    else:
        from torch.func import hessian, jacfwd, vmap
        xp = torch
    u_exact, p_exact = _fields(xp)

    def f_point(x):
        gu = jacfwd(u_exact)(x)
        conv = RHO * gu @ u_exact(x)
        lap = xp.stack([xp.trace(hessian(lambda y, a=a: u_exact(y)[a])(x))
                        for a in range(3)])
        return (conv - MU * lap + jacfwd(p_exact)(x)) / RHO

    return lambda fv, mat, params: vmap(f_point)(fv.x)


def _exact_np(pkg, fn, coords):
    if pkg is JAX_PKG:
        return np.asarray(jax.vmap(fn)(jnp.asarray(coords)))
    from torch.func import vmap

    return vmap(fn)(torch.as_tensor(coords)).numpy()


def ns_deck(pkg):
    mesh_m, fem, phys = pkg
    mesh = mesh_m.box_mesh(3, 3, 3, elem="HEX27")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = fem.Problem(mesh, [phys.Momentum(dim=3, interp="Q2", transient=False),
                              phys.Continuity(interp="Q1")],
                       {"rho": RHO, "mu": MU, "body_force": _body_force(pkg)},
                       **cpu(pkg))
    u_exact, p_exact = _fields(jnp if pkg is JAX_PKG else torch)

    def wall(comp):  # a one-argument value: evaluated once, at finalize
        return lambda c: _exact_np(pkg, u_exact, c)[:, comp]

    for ns in ("left", "right", "top", "bottom", "front", "back"):
        for comp in range(3):
            prob.add_dirichlet(ns, "velocity", comp, wall(comp))
    prob.add_dirichlet("pin", "pressure", 0,
                       float(_exact_np(pkg, p_exact, mesh.coords[:1])[0]))
    prob.finalize()
    return prob


def test_manufactured_ns_3d():
    pj, pt = ns_deck(JAX_PKG), ns_deck(TORCH_PKG)
    assert not pt._fast_meta
    np.testing.assert_allclose(pt.dirichlet_vals, pj.dirichlet_vals,
                               rtol=0, atol=1e-15)
    x = 0.05 * np.random.default_rng(30).standard_normal(pt.dofmap.n_dof)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    Rj, vj = pj.assemble(xj, pj.base_params())
    Rt, vt = pt.assemble(xt, pt.base_params())
    rel = lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(  # noqa: E731
        np.asarray(b)).max()
    assert rel(Rt.numpy(), Rj) <= 1e-12 and rel(vt.numpy(), vj) <= 1e-12
    assert rel(pt.residual(xt, pt.base_params()).numpy(), Rj) <= 1e-12
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                       dict(max_iter=8, tol_residual=1e-10,
                            linear_solver="direct"))
    m = pt.mesh
    u_exact, p_exact = _fields(torch)
    U = np.stack([pt.get_nodal_field(res.x, "velocity", c) for c in range(3)], 1)
    assert np.max(np.abs(U - _exact_np(TORCH_PKG, u_exact, m.coords))) < 1.5e-3
    p = pt.get_nodal_field(res.x, "pressure")
    ok = ~np.isnan(p)
    diff = p[ok] - _exact_np(TORCH_PKG, p_exact, m.coords)[ok]
    assert np.max(np.abs(diff)) < 0.15 and np.sqrt(np.mean(diff ** 2)) < 0.06


def poisson_deck(pkg):
    mesh_m, fem, phys = pkg
    xp = jnp if pkg is JAX_PKG else torch
    mesh = mesh_m.box_mesh(4, 4, 4, elem="HEX27")

    def source(fv, mat, params):
        x, y, z = fv.x[:, 0], fv.x[:, 1], fv.x[:, 2]
        return (3 * np.pi ** 2 * xp.sin(np.pi * x) * xp.sin(np.pi * y)
                * xp.sin(np.pi * z))

    prob = fem.Problem(mesh, [phys.Energy(interp="Q2", transient=False,
                                          convection=False)],
                       {"k": 1.0, "heat_source": source}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom", "front", "back"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    return prob


def test_poisson_3d_hex():
    pj, pt = poisson_deck(JAX_PKG), poisson_deck(TORCH_PKG)
    x = np.random.default_rng(31).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                       dict(max_iter=3, tol_residual=1e-10, linear_tol=1e-11,
                            linear_maxiter=2000))
    T = pt.get_nodal_field(res.x, "temperature")
    assert np.max(np.abs(T - np.prod(np.sin(np.pi * pt.mesh.coords), axis=1))) < 4e-3
