"""Boundary-condition row surgery of the PyTorch port against goma_tpu:
rotated frames and rotated constraints, collocated point constraints,
additive point loads, cross-equation row injection and parametric
Dirichlet values, each deck built in both packages on the CPU in float64
(the port in one torch thread).

For every deck (``_same_system``), at a seeded state: ``assemble``'s R and
CSR values, ``residual`` (the residual-only pass) against them, and
goma_tpu's R and values, within 1e-12 of each array's max (the same
operations in the same dtype, summed in another order; readings
~1e-16); where the element matvec serves the deck (no injection), the
vals-free prep's R and row sums and ``element_matvec`` against goma_tpu's
and against the product of the CSR values, 1e-12. Then Newton
(``_same_newton``): equal iteration and linear counts, ||R||_2 within rel
1e-6 (plus 1e-11: inexact GMRES steps leave ~1e-12 between the iterates)
while above 1e-9 (both take the norms in float32), x within 1e-9
(1 + |x|).

The decks restate goma_tpu's own tests: tests/test_rotation.py (the 6x6
cavity tilted by 30 degrees with every wall a rotated constraint, against
the axis-aligned cavity rotated; the slip-wall channel against its
analytic profile), tests/test_pointwise.py:16 and :48 (mesh nodes sliding
on a plane and on a parabola), and all six cases of
tests/test_bc_conflict.py (the same rows kept and dropped, the same
``bc_dup_log`` and ``bc_dup_report``). Added: a point-load deck, a
parametric-Dirichlet deck (a Dirichlet value read from ``params``, and a
static spec that owns part of its rows), and a row-injection deck whose
Newton solver takes goma_tpu's CSR (ELL) operator on ``gmres``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.bc.pointwise as jpw
import goma_tpu_torch.bc.pointwise as tpw
from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import JAX_PKG, TORCH_PKG, cavity, cpu
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

RTOL = 1e-12
THETA = np.pi / 6


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pw(pkg):
    return jpw if pkg is JAX_PKG else tpw


def _same_system(pj, pt, x, pj_params=None, pt_params=None):
    """assemble / residual / the vals-free prep / the element matvec of
    both packages at the state ``x`` (float64), each within RTOL."""
    pj_params = pj_params if pj_params is not None else pj.base_params()
    pt_params = pt_params if pt_params is not None else pt.base_params()
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    Rj, vj = pj.assemble(xj, pj_params)
    Rt, vt = pt.assemble(xt, pt_params)
    assert _rel(Rt, Rj) <= RTOL and _rel(vt, vj) <= RTOL
    assert _rel(pt.residual(xt, pt_params), Rj) <= RTOL
    if pt._inject is not None:
        return Rt, vt
    Rfj, rsj, auxj = pj._assemble_fast(xj, pj_params)
    Rft, rst, auxt = pt._assemble_fast(xt, pt_params)
    assert _rel(Rft, Rfj) <= RTOL and _rel(rst, rsj) <= RTOL
    v = np.random.default_rng(11).standard_normal(pt.dofmap.n_dof)
    yt = pt.element_matvec(None, auxt, None, torch.as_tensor(v))
    yj = pj.element_matvec(None, auxj, None, jnp.asarray(v))
    pat = pt.pattern
    csr = np.zeros(pat.n)
    np.add.at(csr, pat.rows, _np(vt) * v[pat.indices])
    assert _rel(yt, yj) <= RTOL and _rel(yt, csr) <= RTOL
    return Rt, vt


def _same_newton(pj, pt, x0, opts, pj_params=None, pt_params=None,
                 lin_tol=0, x_tol=1e-9, norm_rtol=1e-6):
    """Newton in both packages from ``x0`` with the same options: the
    port's result. ``lin_tol``: linear iterations per step within it;
    ``x_tol``, ``norm_rtol``: the bounds on x and ||R||_2."""
    rj = JSolver(pj, JOptions(**opts)).solve(
        jnp.asarray(x0), pj_params if pj_params is not None else pj.base_params())
    rt = NewtonSolver(pt, NewtonOptions(**opts)).solve(
        x0, pt_params if pt_params is not None else pt.base_params())
    assert rj.converged and rt.converged, (rj.summary(), rt.summary())
    assert rt.iters == rj.iters
    lin_j = [int(i) for i in rj.linear_iters]
    assert len(rt.linear_iters) == len(lin_j)
    assert all(abs(a - b) <= lin_tol for a, b in zip(rt.linear_iters, lin_j)), \
        (rt.linear_iters, lin_j)
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > 1e-9:
            assert abs(l2t - l2j) <= norm_rtol * l2j + 1e-11, (rt.res_norms,
                                                               rj.res_norms)
    assert np.max(np.abs(rt.x - np.asarray(rj.x)) / (1 + np.abs(rj.x))) <= x_tol
    return rt


def tilted_cavity(pkg, n, Re=50.0, theta=THETA):
    """tests/test_rotation.py's tilted cavity: the lid-driven cavity's mesh
    rotated by ``theta``; walls first (rotated normal and tangent
    constraints of 0 on left, right and bottom), then the lid (normal 0,
    tangent -1); pressure pinned at node 0."""
    mesh_m, fem, phys = pkg
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9")
    mesh.coords = mesh.coords @ rot.T
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=False),
                              phys.Continuity(interp="Q1")],
                       {"rho": 1.0, "mu": 1.0 / Re}, **cpu(pkg))
    for d in ("normal", "tangent"):
        prob.add_rotated_dirichlet(("left", "right", "bottom"), "velocity", d, 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "normal", 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "tangent", -1.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    with warnings.catch_warnings():
        # the lid's corners repeat the walls' tangent constraint: the
        # first (the wall's) is kept, as in goma_tpu
        warnings.simplefilter("ignore", UserWarning)
        prob.finalize()
    return prob


def test_tilted_cavity_matches_goma_tpu_and_the_axis_aligned_cavity():
    """The 6x6 tilted cavity: its rotation tables equal goma_tpu's, its
    system and its Newton solve (host direct) match goma_tpu's, and the
    solution is the axis-aligned cavity's rotated into the tilted frame
    (velocity 1e-8, pressure 1e-7: goma_tpu's bounds)."""
    n, Re = 6, 50.0
    pj, pt = tilted_cavity(JAX_PKG, n, Re), tilted_cavity(TORCH_PKG, n, Re)
    rj, rt = pj._rotation, pt._rotation
    for k in ("pos", "entry_node", "dofs", "con_rows", "con_entry_pos",
              "con_dofs"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k))
    for k in ("Q", "con_coeff", "con_value"):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=0,
                                   atol=1e-15)
    assert pt.bc_dup_log == pj.bc_dup_log and len(pt.bc_dup_log) == 4
    x = 0.1 * np.random.default_rng(0).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    opts = dict(max_iter=10, tol_residual=1e-10, linear_solver="direct")
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof), opts)

    pa = cavity(TORCH_PKG, n, Re=Re)
    ra = NewtonSolver(pa, NewtonOptions(**opts)).solve(
        np.zeros(pa.dofmap.n_dof), pa.base_params())
    assert res.iters == ra.iters
    c, s = np.cos(THETA), np.sin(THETA)
    rot = np.array([[c, -s], [s, c]])
    ua = np.stack([pa.get_nodal_field(ra.x, "velocity", k) for k in (0, 1)])
    ut = np.stack([pt.get_nodal_field(res.x, "velocity", k) for k in (0, 1)])
    np.testing.assert_allclose(ut.T, (rot @ ua).T, atol=1e-8)
    p_a = pa.get_nodal_field(ra.x, "pressure")
    p_t = pt.get_nodal_field(res.x, "pressure")
    ok = ~np.isnan(p_a)
    np.testing.assert_allclose(p_t[ok], p_a[ok], atol=1e-7)


def test_tilted_cavity_gmres_ndlu_matches_goma_tpu():
    """The tilted cavity on ``gmres`` + NDLU through the element matvec
    (rotated rows and constraint rows in ``_matvec_post``): goma_tpu's
    Newton and GMRES counts and iterates."""
    pj, pt = tilted_cavity(JAX_PKG, 6), tilted_cavity(TORCH_PKG, 6)
    _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                 dict(max_iter=10, tol_residual=1e-10, linear_solver="gmres",
                      precond="ndlu", linear_tol=1e-8))


def slip_channel(pkg):
    """tests/test_rotation.py::test_slip_wall_channel's deck: body-force
    flow between a no-slip bottom and a free-slip top (a rotated normal
    constraint only), the analytic profile at both ends."""
    mesh_m, fem, phys = pkg
    G, mu, H = 1.0, 0.5, 1.0
    mesh = mesh_m.rectangle_mesh(4, 6, elem="QUAD9", xlim=(0, 0.5), ylim=(0, H))
    prob = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=False,
                                            convection=False),
                              phys.Continuity(interp="Q1")],
                       {"rho": 1.0, "mu": mu, "body_force": np.array([G, 0.0])},
                       **cpu(pkg))
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    uex = lambda c: G / mu * (H * c[:, 1] - 0.5 * c[:, 1] ** 2)  # noqa: E731
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, uex)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "normal", 0.0)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob, uex


def test_slip_wall_channel():
    (pj, _), (pt, uex) = slip_channel(JAX_PKG), slip_channel(TORCH_PKG)
    x = 0.1 * np.random.default_rng(1).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                       dict(max_iter=8, tol_residual=1e-10,
                            linear_solver="direct"))
    u = pt.get_nodal_field(res.x, "velocity", 0)
    np.testing.assert_allclose(u, uex(pt.mesh.coords), atol=1e-9)
    np.testing.assert_allclose(u[pt.mesh.nodesets["top"]], 1.0 / 0.5 / 2,
                               atol=1e-9)


def sliding_mesh(pkg, shape):
    """tests/test_pointwise.py's decks: an elliptic mesh whose bottom nodes
    slide on the plane y = 0.2 x (``shape="plane"``) or on the parabola
    y = 0.1 x (1 - x) (``"surface"``), the y-row replaced by the point
    constraint."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(6, 6, elem="QUAD9")
    prob = fem.Problem(mesh, [phys.EllipticMesh(2)], {}, **cpu(pkg))
    prob.add_dirichlet("top", "mesh_displacement", 0, 0.0)
    prob.add_dirichlet("top", "mesh_displacement", 1, 0.0)
    prob.add_dirichlet("left", "mesh_displacement", 0, 0.0)
    prob.add_dirichlet("right", "mesh_displacement", 0, 0.0)
    pw = _pw(pkg)
    g = (pw.plane([-0.2, 1.0], 0.0) if shape == "plane" else
         pw.surface(lambda x: x[1] - 0.1 * x[0] * (1 - x[0])))
    prob.add_point_constraint("bottom", "mesh_displacement", 1, g)
    prob.finalize()
    return prob


@pytest.mark.parametrize("shape", ["plane", "surface"])
def test_mesh_nodes_slide_on_a_surface(shape):
    pj, pt = sliding_mesh(JAX_PKG, shape), sliding_mesh(TORCH_PKG, shape)
    np.testing.assert_array_equal(pt._point_sets[0].rows, pj._point_sets[0].rows)
    x = 0.05 * np.random.default_rng(2).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                       dict(max_iter=8, tol_residual=1e-11,
                            linear_solver="direct"))
    bot = pt.mesh.nodesets["bottom"]
    xb = pt.mesh.coords[bot, 0] + pt.get_nodal_field(res.x, "mesh_displacement", 0)[bot]
    yb = pt.mesh.coords[bot, 1] + pt.get_nodal_field(res.x, "mesh_displacement", 1)[bot]
    want = 0.2 * xb if shape == "plane" else 0.1 * xb * (1 - xb)
    np.testing.assert_allclose(yb, want, atol=1e-10)


def test_geometry_helpers_match_goma_tpu():
    """``roll`` and ``moving_plane`` (and ``plane``, ``surface``) give
    goma_tpu's values and forward derivatives at seeded points."""
    from torch.func import jacfwd

    rng = np.random.default_rng(3)
    d, X0 = rng.standard_normal(2), rng.standard_normal(2)
    cases = [("roll", ([0.3, -0.2], 1.5)), ("moving_plane", ([0.6, 0.8], 0.1, 2.0)),
             ("plane", ([-0.2, 1.0], 0.3))]
    pj = {"time": jnp.asarray(0.7)}
    pt = {"time": torch.tensor(0.7, dtype=torch.float64)}
    import jax

    for name, args in cases:
        gj, gt = getattr(jpw, name)(*args), getattr(tpw, name)(*args)
        dj, dt = jnp.asarray(d), torch.as_tensor(d)
        Xj, Xt = jnp.asarray(X0), torch.as_tensor(X0)
        assert abs(float(gt(dt, Xt, pt)) - float(gj(dj, Xj, pj))) <= 1e-14
        np.testing.assert_allclose(
            _np(jacfwd(gt)(dt, Xt, pt)), np.asarray(jax.jacfwd(gj)(dj, Xj, pj)),
            rtol=1e-13, atol=1e-15)


def heat(pkg, n=4, elem="QUAD9", interp="Q2"):
    """A steady conduction deck (Energy, no convection) on the unit
    square, unfinalized."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem=elem)
    prob = fem.Problem(mesh, [phys.Energy(interp=interp, transient=False,
                                          convection=False)],
                       {"k": 1.0}, **cpu(pkg))
    return prob


def point_load_deck(pkg):
    """Conduction with a nonlinear nodal load (a cooling law)
    f(T, X) = 0.5 T + 0.2 T^3 - 0.3 (1 + X_y) added to the temperature rows
    of the right wall, T = 1 on the left."""
    prob = heat(pkg)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_point_load("right", "temperature",
                        lambda q, X, p: 0.5 * q + 0.2 * q ** 3
                        - 0.3 * (1.0 + X[1]))
    prob.finalize()
    return prob


def test_point_load():
    """The load's rows, its CSR positions and its row Jacobians (the
    operator's ``pl_dfs``) match goma_tpu's; Newton on host direct and on
    gmres through the element matvec."""
    pj, pt = point_load_deck(JAX_PKG), point_load_deck(TORCH_PKG)
    np.testing.assert_array_equal(pt._point_loads[0].entry_pos,
                                  pj._point_loads[0].entry_pos)
    x = np.random.default_rng(4).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    x0 = np.zeros(pt.dofmap.n_dof)
    _same_newton(pj, pt, x0, dict(max_iter=10, tol_residual=1e-11,
                                  linear_solver="direct"))
    _same_newton(pj, pt, x0, dict(max_iter=10, tol_residual=1e-11,
                                  linear_solver="gmres", precond="ndlu",
                                  linear_tol=1e-10))


def param_dirichlet_deck(pkg):
    """Conduction with the bottom wall's value T = lam x read from
    ``params`` at every assembly (goma_tpu's continuation hook), a static
    spec on the left wall registered FIRST (it owns the shared corner) and
    T = 0 on the top."""
    prob = heat(pkg)
    prob.add_dirichlet("left", "temperature", 0, 0.25)
    prob.add_dirichlet("bottom", "temperature", 0,
                       lambda c, p: p["lam"] * c[:, 0])
    prob.add_dirichlet("top", "temperature", 0, 0.0)
    prob.finalize()
    return prob


def test_parametric_dirichlet():
    """The placeholder values (0 after ``nan_to_num``), the entries the
    parametric spec owns, and the system and Newton solve at lam = 1.7
    match goma_tpu's; the bottom row holds lam x, the shared corner the
    left wall's 0.25."""
    pj, pt = param_dirichlet_deck(JAX_PKG), param_dirichlet_deck(TORCH_PKG)
    np.testing.assert_array_equal(pt.dirichlet_dofs, pj.dirichlet_dofs)
    np.testing.assert_array_equal(pt.dirichlet_vals, pj.dirichlet_vals)
    (dj, cj, _), = pj._param_dirichlet
    (dt, ct, _), = pt._param_dirichlet
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ct, cj)
    lam = 1.7
    pjp = pj.base_params(lam=jnp.asarray(lam))
    ptp = pt.base_params(lam=torch.tensor(lam, dtype=torch.float64))
    x = np.random.default_rng(5).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x, pjp, ptp)
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                       dict(max_iter=5, tol_residual=1e-11,
                            linear_solver="direct"), pjp, ptp)
    T = pt.get_nodal_field(res.x, "temperature")
    m = pt.mesh
    bot = np.setdiff1d(m.nodesets["bottom"], m.nodesets["left"])
    np.testing.assert_allclose(T[bot], lam * m.coords[bot, 0], atol=1e-12)
    corner = np.intersect1d(m.nodesets["bottom"], m.nodesets["left"])
    np.testing.assert_allclose(T[corner], 0.25, atol=1e-12)


def inject_deck(pkg):
    """Two uncoupled conduction fields (temperature, species) with the
    species row of the right wall injected into the temperature row there
    (flux continuity) and replaced by the tie c - T = 0 (a two-variable
    point constraint on the from-row, as goma_tpu's LUBP_SH_FP_MATCH)."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(4, 4, elem="QUAD9")
    prob = fem.Problem(mesh, [phys.Energy(interp="Q2", transient=False,
                                          convection=False),
                              phys.Species(n_species=1, interp="Q2",
                                           transient=False, convection=False)],
                       {"k": 1.0, "diffusivity": 0.5}, **cpu(pkg))
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("top", "species", 0, 0.0)
    prob.add_row_inject("right", "species", "temperature")
    prob.add_point_constraint("right", ["species", "temperature"], 0,
                              lambda q, X, p: q[0] - q[1])
    prob.finalize()
    return prob


def test_row_injection_takes_the_ell_operator():
    """The widened pattern, the injection's positions, the system, and
    Newton on ``gmres``: the port's solver, as goma_tpu's, turns the
    element matvec off (no vals-free prep, the plain ``_assemble`` values
    and the ELL operator, the sequential loop) and gives goma_tpu's
    iterates; the host ``direct`` rung as well."""
    pj, pt = inject_deck(JAX_PKG), inject_deck(TORCH_PKG)
    np.testing.assert_array_equal(pt.pattern.keys, pj.pattern.keys)
    for k in pj._inject:
        np.testing.assert_array_equal(pt._inject[k], pj._inject[k])
    x = np.random.default_rng(6).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    opts = dict(max_iter=6, tol_residual=1e-11, linear_solver="gmres",
                precond="block_jacobi", linear_tol=1e-12)
    st, sj = NewtonSolver(pt, NewtonOptions(**opts)), JSolver(pj, JOptions(**opts))
    assert not st._use_elem_mv and not st._fast_prep and st._ell is not None
    assert not sj._use_elem_mv and not sj._fast_prep
    calls = []
    real = pt.element_matvec
    pt.element_matvec = lambda *a: calls.append(1) or real(*a)
    x0 = np.zeros(pt.dofmap.n_dof)
    res = _same_newton(pj, pt, x0, opts)
    assert not calls
    _same_newton(pj, pt, x0, dict(max_iter=6, tol_residual=1e-11,
                                  linear_solver="direct"))
    # the tie holds on the right wall below its top corner (where the
    # species Dirichlet takes the row)
    m = pt.mesh
    r = np.setdiff1d(m.nodesets["right"], m.nodesets["top"])
    np.testing.assert_allclose(pt.get_nodal_field(res.x, "species")[r],
                               pt.get_nodal_field(res.x, "temperature")[r],
                               atol=1e-10)


# ---- tests/test_bc_conflict.py, all six cases, in both packages
def _conflict_deck(pkg, case):
    mesh_m, fem, phys = pkg
    quad9 = case.startswith("rotated")
    mesh = mesh_m.rectangle_mesh(4, 4, elem="QUAD9" if quad9 else "QUAD4")
    if quad9:
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        prob = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=False),
                                  phys.Continuity(interp="Q1")],
                           {"rho": 1.0, "mu": 1.0}, **cpu(pkg))
    else:
        prob = fem.Problem(mesh, [phys.Energy(interp="Q1", transient=False,
                                              convection=False)], {},
                           **cpu(pkg))
    if case == "dirichlet_first":
        prob.add_dirichlet("top", "temperature", 0, 2.0)
        prob.add_dirichlet("left", "temperature", 0, 5.0)
    elif case == "dirichlet_swamps_point":
        prob.add_dirichlet("bottom", "temperature", 0, 1.0)
        prob.add_point_constraint("bottom", "temperature", 0,
                                  lambda q, c, params: q[0] - 99.0)
        prob.add_dirichlet("top", "temperature", 0, 0.0)
    elif case == "rotated_displaced":
        prob.add_dirichlet("top", "velocity", 0, 3.0)
        prob.add_rotation(("top",), "velocity")
        prob.add_rotated_dirichlet(("top",), "velocity", "normal", 0.0)
        for ns in ("left", "right", "bottom"):
            prob.add_dirichlet(ns, "velocity", 0, 0.0)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
    elif case == "rotated_dropped":
        for ns in ("top", "left", "right", "bottom"):
            prob.add_dirichlet(ns, "velocity", 0, 0.0)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_rotation(("top",), "velocity")
        prob.add_rotated_dirichlet(("top",), "velocity", "normal", 7.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
    elif case == "point_first_claim":
        prob.add_dirichlet("top", "temperature", 0, 0.0)
        prob.add_point_constraint("bottom", "temperature", 0,
                                  lambda q, c, params: q[0] - 1.0)
        prob.add_point_constraint("left", "temperature", 0,
                                  lambda q, c, params: q[0] - 2.0)
    elif case == "dup_report":
        prob.add_dirichlet("top", "temperature", 0, 2.0)
        prob.add_dirichlet("left", "temperature", 0, 5.0)
        prob.add_point_constraint("top", "temperature", 0,
                                  lambda q, c, params: q[0] - 9.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        prob.finalize()
    return prob, sorted({str(m.message) for m in w})


CONFLICT_WARNS = {"dirichlet_first": "first spec takes precedence",
                  "dirichlet_swamps_point": None, "rotated_displaced": "moved",
                  "rotated_dropped": "dropped",
                  "point_first_claim": "first strong claim wins",
                  "dup_report": "first spec"}


@pytest.mark.parametrize("case", list(CONFLICT_WARNS))
def test_bc_conflict_resolution(case):
    """Each case of tests/test_bc_conflict.py: the same warnings, Dirichlet
    rows and values, rotated constraint rows, point-constraint rows,
    ``bc_dup_log`` and ``bc_dup_report`` as goma_tpu; the system and the
    host direct Newton solve match, and the kept condition holds."""
    (pj, wj), (pt, wt) = _conflict_deck(JAX_PKG, case), _conflict_deck(TORCH_PKG, case)
    assert wt == wj
    want = CONFLICT_WARNS[case]
    assert (want is None and not wt) or any(want in m for m in wt), wt
    np.testing.assert_array_equal(pt.dirichlet_dofs, pj.dirichlet_dofs)
    np.testing.assert_array_equal(pt.dirichlet_vals, pj.dirichlet_vals)
    assert (pt._rotation is None) == (pj._rotation is None)
    if pt._rotation is not None:
        np.testing.assert_array_equal(pt._rotation.con_rows, pj._rotation.con_rows)
    assert len(pt._point_sets) == len(pj._point_sets)
    for a, b in zip(pt._point_sets, pj._point_sets):
        np.testing.assert_array_equal(a.rows, b.rows)
    assert pt.bc_dup_log == pj.bc_dup_log
    assert pt.bc_dup_report() == pj.bc_dup_report()
    x = 0.3 * np.random.default_rng(7).standard_normal(pt.dofmap.n_dof)
    _same_system(pj, pt, x)
    res = _same_newton(pj, pt, np.zeros(pt.dofmap.n_dof),
                       dict(max_iter=8, linear_solver="direct"))
    m, dm = pt.mesh, pt.dofmap
    if case == "dirichlet_swamps_point":
        assert not pt._point_sets
        T = pt.get_nodal_field(res.x, "temperature")
        np.testing.assert_allclose(T[m.nodesets["bottom"]], 1.0, atol=1e-10)
    if case == "rotated_displaced":
        top = [k for k in m.nodesets["top"]
               if k not in m.nodesets["left"] and k not in m.nodesets["right"]]
        uy = {int(dm.dof_of_node_svar[k, dm.svar("velocity", 1)]) for k in top}
        assert set(int(r) for r in pt._rotation.con_rows) <= uy
        np.testing.assert_allclose(
            pt.get_nodal_field(res.x, "velocity", 1)[top], 0.0, atol=1e-9)
        np.testing.assert_allclose(
            pt.get_nodal_field(res.x, "velocity", 0)[top], 3.0, atol=1e-9)
    if case == "rotated_dropped":
        assert pt._rotation.con_rows.size == 0
    if case == "point_first_claim":
        corner = np.intersect1d(m.nodesets["bottom"], m.nodesets["left"])[0]
        np.testing.assert_allclose(pt.get_nodal_field(res.x, "temperature")[corner],
                                   1.0, atol=1e-10)
    if case == "dup_report":
        rep = pt.bc_dup_report()
        assert "DIRICHLET precedence" in rep and "first occurrence kept" in rep
        p2 = heat(TORCH_PKG, elem="QUAD4", interp="Q1")
        p2.add_dirichlet("top", "temperature", 0, 1.0)
        p2.finalize()
        assert "no duplicate" in p2.bc_dup_report()
