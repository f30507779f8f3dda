"""Interface (paired-face) sets, 3D edge sets, the discontinuous-stress
kernels and the wetting kernels of the PyTorch port against goma_tpu, each
deck built in both packages on the CPU in float64 (the port in one torch
thread).

The decks restate goma_tpu's tests/test_interface.py (the two-block strip
split at x = 0.5: contact resistance, Henry partition, Flory-Huggins VLE,
kinetic exchange, the cross-variable match, the density-weighted mass-flux
continuity and the cross-coupled Jacobian; the Fresnel light jump waits
for the light equations), tests/test_viscoelastic.py's DG stress decay
channel (16x2, P1E stress) and tests/test_numjac_new_kernels.py's DG
numjac deck, and tests/test_edge_wetting_bcs.py (the HEX27 edge curve's
measure, line source, tangential and normal edge velocity, the contact
angle edge kernels; every wetting face kernel and correlation).

Tolerances: host pairings equal; R and the CSR values within 1e-10 of each
array's max (the same operations summed in another order; readings
~1e-16); Newton counts equal; x within 1e-9 (1 + |x|); the interface jump
values, the DG decay rate and the edge line-source flux within 1e-8 of
goma_tpu's (relative where the value is O(1)); the correlations within
1e-12 relative.
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

J = {"mesh": jmesh, "fem": jfem, "phys": jphys, "kw": {},
     "mi": "goma_tpu.mesh.interface", "bc": "goma_tpu.bc",
     "pi": "goma_tpu.physics.interface", "ve": "goma_tpu.physics.viscoelastic",
     "S": JSolver, "O": JOptions}
T = {"mesh": tmesh, "fem": tfem, "phys": tphys, "kw": {"device": "cpu"},
     "mi": "goma_tpu_torch.mesh.interface", "bc": "goma_tpu_torch.bc",
     "pi": "goma_tpu_torch.physics.interface",
     "ve": "goma_tpu_torch.physics.viscoelastic",
     "S": NewtonSolver, "O": NewtonOptions}
RTOL = 1e-10
X_TOL = 1e-9


def _mod(name):
    import importlib

    return importlib.import_module(name)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _dx(a, b):
    return float(np.max(np.abs(_np(a) - _np(b)) / (1.0 + np.abs(_np(b)))))


def _assemble(prob, x):
    if isinstance(prob, tfem.Problem):
        return prob.assemble(torch.as_tensor(x), prob.base_params())
    return prob.assemble(jnp.asarray(x), prob.base_params())


def _same_system(pj, pt, x):
    Rj, vj = _assemble(pj, x)
    Rt, vt = _assemble(pt, x)
    assert _rel(Rt, Rj) <= RTOL
    assert _rel(vt, vj) <= RTOL
    return _np(Rt)


def strip(P, nx=4, ny=2):
    """tests/test_interface.py::_two_block_strip: [0,1]^2 split at x=0.5
    into blocks A and B, QUAD4, interface pairs found and B's nodes split.
    Returns (mesh, pairs, orig, new)."""
    mm = P["mesh"]
    gx, gy = 2 * nx + 1, ny + 1
    X, Y = np.meshgrid(np.linspace(0, 1, gx), np.linspace(0, 1, gy),
                       indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    conn_a, conn_b = [], []
    for j in range(ny):
        for i in range(2 * nx):
            c = [j * gx + i, j * gx + i + 1, (j + 1) * gx + i + 1,
                 (j + 1) * gx + i]
            (conn_a if i < nx else conn_b).append(c)
    mesh = mm.Mesh(2, coords, [
        mm.Block("A", "QUAD4", np.asarray(conn_a, dtype=np.int32)),
        mm.Block("B", "QUAD4", np.asarray(conn_b, dtype=np.int32))])
    mesh.nodesets = {
        "left": np.where(np.isclose(coords[:, 0], 0.0))[0].astype(np.int32),
        "right": np.where(np.isclose(coords[:, 0], 1.0))[0].astype(np.int32)}
    mesh.sidesets = {}
    mi = _mod(P["mi"])
    pairs = mi.find_interface_faces(mesh, 0, 1)
    orig, new = mi.split_interface(mesh, pairs)
    return mesh, pairs, orig, new


def interface_deck(P, case):
    """One tests/test_interface.py deck, unsolved: (problem, x0, orig,
    new, mesh)."""
    fem, ph, pi = P["fem"], P["phys"], _mod(P["pi"])
    nx = 6 if case == "flory" else 4
    mesh, pairs, orig, new = strip(P, nx)
    kw = P["kw"]
    E = lambda: ph.Energy(interp="Q1", transient=False, convection=False)  # noqa: E731
    S = lambda: ph.Species(1, interp="Q1", transient=False, convection=False)  # noqa: E731
    x0 = None
    if case == "contact":
        prob = fem.Problem(mesh, [[E()], [E()]], [
            {"rho": 1.0, "Cp": 1.0, "k": 2.0}, {"rho": 1.0, "Cp": 1.0, "k": 0.5}], **kw)
        prob.add_dirichlet("left", "temperature", 0, 1.0)
        prob.add_dirichlet("right", "temperature", 0, 0.0)
        prob.add_interface_kernel(pairs, ph.InterfaceExchange("temperature", coeff=4.0))
    elif case in ("henry", "kinetic", "flory"):
        D = {"henry": (1.5, 0.4), "kinetic": (1.0, 0.5), "flory": (1.2, 0.3)}[case]
        prob = fem.Problem(mesh, [[S()], [S()]], [{"diffusivity": D[0]},
                                                  {"diffusivity": D[1]}], **kw)
        lo, hi = (0.01, 0.5) if case == "flory" else (1.0, 0.0)
        prob.add_dirichlet("left", "species", 0, lo)
        prob.add_dirichlet("right", "species", 0, hi)
        k = {"henry": ph.InterfaceExchange("species", coeff=1e8, K=2.0),
             "kinetic": ph.InterfaceExchange("species", coeff=3.0, K=1.5),
             "flory": ph.InterfaceExchange(
                 "species", coeff=1e8,
                 K=pi.flory_huggins_partition(0.8, 50.0, 0.6))}[case]
        prob.add_interface_kernel(pairs, k)
    elif case == "match":
        prob = fem.Problem(mesh, [[S()], [E()]], [
            {"diffusivity": 1.0}, {"rho": 1.0, "Cp": 1.0, "k": 0.6}], **kw)
        prob.add_dirichlet("left", "species", 0, 1.0)
        prob.add_dirichlet("right", "temperature", 0, 0.2)
        prob.add_interface_kernel(pairs, pi.InterfaceMatch(
            "species", "temperature", coeff=1e8,
            g_b=lambda sbv, mat, params: 2.0 * sbv.val["temperature"][:, 0],
            scale_b=0.7))
    else:  # massflux
        eqs = [[_mod(P["fem"].__name__ + ".equations").PassiveVar(
            "velocity", 2, "Q1", reg=1e-10)] for _ in range(2)]
        prob = fem.Problem(mesh, eqs, [{"rho": 3.0}, {"rho": 1.0}], **kw)
        an = np.unique(mesh.blocks[0].conn)
        mesh.nodesets["aset"] = an.astype(np.int32)
        prob.add_dirichlet("aset", "velocity", 0, 0.5)
        prob.add_dirichlet("aset", "velocity", 1, 0.0)
        bn = np.setdiff1d(np.unique(mesh.blocks[1].conn), an)
        inner_b = bn[~np.isclose(mesh.coords[bn, 0], 0.5)]
        mesh.nodesets["bset"] = inner_b.astype(np.int32)
        prob.add_dirichlet("bset", "velocity", 0, 0.0)
        prob.add_dirichlet("bset", "velocity", 1, 0.0)
        prob.add_interface_kernel(pairs, pi.MassFluxContinuity(dim=2))
    prob.finalize()
    if case == "flory":
        x0 = np.full(prob.dofmap.n_dof, 0.1)
    return prob, x0, orig, new, mesh


def test_interface_pairs_equal():
    """find_interface_faces, split_interface and interior_face_pairs: the
    same pairs, the same split nodes and connectivity as goma_tpu's."""
    mj, pj, oj, nj = strip(J)
    mt, pt, ot, nt = strip(T)
    for k in ("elems_a", "faces_a", "elems_b", "faces_b"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(pj, k))
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(mt.coords, mj.coords)
    np.testing.assert_array_equal(mt.blocks[1].conn, mj.blocks[1].conn)
    qj = _mod(J["mi"]).interior_face_pairs(jmesh.rectangle_mesh(3, 2), 0)
    qt = _mod(T["mi"]).interior_face_pairs(tmesh.rectangle_mesh(3, 2), 0)
    for k in ("elems_a", "faces_a", "elems_b", "faces_b"):
        np.testing.assert_array_equal(getattr(qt, k), getattr(qj, k))


@pytest.mark.parametrize("case", ["contact", "henry", "flory", "kinetic",
                                  "match", "massflux"])
def test_interface_decks_match_goma_tpu(case):
    """Each interface deck of tests/test_interface.py solved on the host
    ``direct`` rung in both packages: goma_tpu's Newton count, x within
    1e-9 (1e-7 on the penalty decks, whose condition numbers are ~1e8),
    the interface values on both sides (original and split nodes) within
    1e-8 of goma_tpu's, and the test's exact solution (contact
    resistance: the jump q/h; Henry: c_a = K c_b; mass flux: the B side
    carries rho_a/rho_b u)."""
    pj, x0, oj, nj, mj = interface_deck(J, case)
    pt, _, ot, nt, mt = interface_deck(T, case)
    x0 = np.zeros(pt.dofmap.n_dof) if x0 is None else x0
    tol = {"flory": 1e-11, "contact": 1e-11, "kinetic": 1e-11}.get(case, 1e-9)
    it = {"flory": 20, "massflux": 5}.get(case, 6)
    rj = JSolver(pj, JOptions(max_iter=it, tol_residual=tol,
                              linear_solver="direct")).solve(x0, pj.base_params())
    rt = NewtonSolver(pt, NewtonOptions(max_iter=it, tol_residual=tol,
                                        linear_solver="direct")).solve(
        x0, pt.base_params())
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    # the penalty decks (coeff 1e8, 1e6) have condition numbers ~1e8: the
    # two SuperLU solves' last-bit differences grow to ~1e-9 in x there
    x_tol = 1e-7 if case in ("henry", "flory", "match", "massflux") else X_TOL
    assert _dx(rt.x, rj.x) <= x_tol
    var = {"contact": "temperature", "massflux": "velocity"}.get(case, "species")
    va = pt.get_nodal_field(rt.x, var)
    ja = pj.get_nodal_field(rj.x, var)
    if case == "match":
        va = pt.get_nodal_field(rt.x, "temperature")
        ja = pj.get_nodal_field(rj.x, "temperature")
    for nodes in (ot, nt):
        np.testing.assert_allclose(va[nodes], ja[nodes], rtol=1e-8, atol=1e-12)
    if case == "contact":
        q = 1.0 / (0.5 / 2.0 + 0.5 / 0.5 + 1.0 / 4.0)
        np.testing.assert_allclose(va[ot].mean() - va[nt].mean(), q / 4.0,
                                   atol=1e-9)
    elif case == "henry":
        np.testing.assert_allclose(va[ot].mean(), 2.0 * va[nt].mean(), atol=1e-6)
    elif case == "massflux":
        np.testing.assert_allclose(va[nt], 3.0 * 0.5, atol=1e-8)


def test_interface_system_and_numjac():
    """tests/test_interface.py::test_interface_jacobian_cross_coupling: R
    and the CSR values (with the cross-block entries) at a seeded state
    within 1e-10 of goma_tpu's; the port's AD Jacobian against its finite
    differences (``utils.numjac``)."""
    from goma_tpu_torch.utils.numjac import numerical_jacobian_check

    decks = []
    for P in (J, T):
        mesh, pairs, _, _ = strip(P, 3)
        E = P["phys"].Energy
        prob = P["fem"].Problem(mesh, [
            [E(interp="Q1", transient=False, convection=False)],
            [E(interp="Q1", transient=False, convection=False)]],
            [{"rho": 1.0, "Cp": 1.0, "k": 1.0}, {"rho": 1.0, "Cp": 1.0, "k": 3.0}],
            **P["kw"])
        prob.add_interface_kernel(pairs, P["phys"].InterfaceExchange(
            "temperature", coeff=2.5, K=1.3))
        prob.finalize()
        decks.append(prob)
    x = np.random.RandomState(0).randn(decks[1].dofmap.n_dof)
    _same_system(*decks, x)
    chk = numerical_jacobian_check(decks[1], x, decks[1].base_params(),
                                   n_columns=14)
    assert chk.ok, chk.report()


def dg_deck(P, nx=16, ny=2, L=2.0, H=0.25, lam=0.5, rho=0.0, U=1.0):
    """tests/test_viscoelastic.py::test_dg_stress_advection_decay's channel
    (P1E stress, interior-face upwinding, inflow closure), unsolved."""
    ph, ve = P["phys"], _mod(P["ve"])
    mesh = P["mesh"].rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, L),
                                    ylim=(0, H))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = P["fem"].Problem(mesh, [
        ph.Momentum(dim=2, interp="Q2", transient=False),
        ph.Continuity(interp="Q1"),
        ph.VEStress(0, dim=2, lam=lam, mu_p=1.0, interp="P1E", supg=0.0,
                    use_projected_gradient=False, transient=False)],
        {"rho": rho, "mu": 1.0}, **P["kw"])
    if U is not None:
        for ns in ("left", "right", "top", "bottom"):
            prob.add_dirichlet(ns, "velocity", 0, U)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_interface_kernel(_mod(P["mi"]).interior_face_pairs(mesh, 0),
                              ve.DGStressUpwind(0, lam=lam))
    prob.add_face_kernel("left", ve.DGStressInflow(
        0, lam=lam, s_in=[1.0, 0.5, 0.25] if U is not None else (1.0, 0.2, 0.1)))
    prob.finalize()
    return mesh, prob


def test_dg_stress_decay_matches_goma_tpu():
    """The DG stress decay channel: goma_tpu's Newton count, x within 1e-9,
    the fitted decay rate within 1e-8 of goma_tpu's (and of the exact
    -1/(U lam) to the test's 2%), the component ratio exact to 1e-6."""
    sols = []
    for P in (J, T):
        mesh, prob = dg_deck(P)
        res = P["S"](prob, P["O"](max_iter=8, tol_residual=1e-11,
                                  linear_solver="direct")).solve(
            np.zeros(prob.dofmap.n_dof), prob.base_params())
        assert res.converged
        bd = prob.dofmap.blocks[0]
        s = bd.slot("stress0")
        vals = res.x[bd.gather[:, s.start]]
        xc = mesh.coords[mesh.blocks[0].conn].mean(axis=1)[:, 0]
        order = np.argsort(xc)
        rate = np.polyfit(xc[order], np.log(vals[order]), 1)[0]
        ratio = res.x[bd.gather[:, s.start + s.nbf]] / vals
        sols.append((res, rate, ratio))
    (rj, aj, _), (rt, at, qt) = sols
    assert rt.iters == rj.iters
    assert _dx(rt.x, rj.x) <= X_TOL
    assert abs(at - aj) <= 1e-8 * abs(aj)
    np.testing.assert_allclose(at, -1.0 / 0.5, rtol=0.02)
    np.testing.assert_allclose(qt, 0.5, rtol=1e-6)


def test_dg_stress_system_and_numjac():
    """tests/test_numjac_new_kernels.py::test_numjac_dg_stress: the 4x2
    deck with free velocity, R and the CSR values at its seeded state
    within 1e-10 of goma_tpu's; the port's AD Jacobian against finite
    differences."""
    from goma_tpu_torch.utils.numjac import numerical_jacobian_check

    decks = [dg_deck(P, nx=4, ny=2, L=1.0, H=0.5, lam=0.3, rho=1.0,
                     U=None)[1] for P in (J, T)]
    x = 0.1 * np.random.RandomState(11).randn(decks[1].dofmap.n_dof)
    _same_system(*decks, x)
    chk = numerical_jacobian_check(decks[1], x, decks[1].base_params(),
                                   n_columns=16)
    assert chk.ok, chk.report()


def edge_deck(P, kernel, n=(2, 2, 2), stokes=False, ylim=(0.0, 1.0)):
    """A HEX27 box with one edge kernel on the top & right curve."""
    ph, edge = P["phys"], _mod(P["bc"] + ".edge")
    mesh = P["mesh"].box_mesh(*n, elem="HEX27", ylim=ylim)
    if stokes:
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        eqs = [ph.Momentum(dim=3, interp="Q2", transient=False,
                           convection=False), ph.Continuity(interp="Q1")]
        mat = {"rho": 1.0, "mu": 1.0}
    else:
        eqs = [ph.Energy(interp="Q2", transient=False, convection=False)]
        mat = {"k": 1.0}
    prob = P["fem"].Problem(mesh, eqs, mat, **P["kw"])
    if stokes:
        for ns in ("bottom", "left"):
            for c in range(3):
                prob.add_dirichlet(ns, "velocity", c, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
    else:
        prob.add_dirichlet("bottom", "temperature", 0, 0.0)
    name, args, kw = kernel
    prob.add_edge_kernel("top", "right", getattr(edge, name)(*args, **kw))
    prob.finalize()
    return mesh, prob


EDGE_KERNELS = {
    "VeloTangentEdge": ("stokes", (), {"dim": 3, "value": 1.0,
                                       "penalty": 1e6}),
    "VeloNormalEdge": ("stokes", (), {"dim": 3, "penalty": 1.0}),
    "CAEdge": ("mesh", (1.2,), {"penalty": 1.0}),
    "VarCAEdge": ("mesh", (1.2, 0.3), {"v_web": (0.2, 0.1, 0.3)}),
    "MovingCAEdge": ("stokes", (1.2, 1.6, 2.0), {"var": "velocity"}),
    "CAEdgeOrFix": ("mesh", (1.2, (0.5, 0.5, 1.0), (0.0, 1.0, 0.0)),
                    {"penalty": 1.0}),
}


@pytest.mark.parametrize("name", sorted(EDGE_KERNELS))
def test_edge_kernel_system_matches_goma_tpu(name):
    """Each edge kernel on the top & right curve of a 2x2x2 HEX27 box: the
    velocity kernels (and MOVING_CA on the momentum rows) on a Stokes deck,
    the contact-angle kernels on the mesh rows on a pseudo-solid mesh deck
    (its normals move with the mesh, so AD carries the mesh
    sensitivities): the same edge tables as goma_tpu's, and R and the CSR
    values at a seeded state within 1e-10 of goma_tpu's."""
    deck, args, kw = EDGE_KERNELS[name]
    decks = []
    for P in (J, T):
        if deck == "stokes":
            _, prob = edge_deck(P, (name, args, kw), stokes=True)
        else:
            mesh = P["mesh"].box_mesh(2, 2, 2, elem="HEX27")
            prob = P["fem"].Problem(
                mesh, [P["phys"].LinearElasticMesh(dim=3)],
                {"lame_mu": 1.0, "lame_lambda": 0.5}, **P["kw"])
            prob.add_edge_kernel("top", "right", getattr(
                _mod(P["bc"] + ".edge"), name)(*args, **kw))
            prob.finalize()
        decks.append(prob)
    ej, et = decks[0].edge_sets[0], decks[1].edge_sets[0]
    np.testing.assert_array_equal(et.edge_elems, ej.edge_elems)
    for k in ej.etabs:
        np.testing.assert_array_equal(et.etabs[k], ej.etabs[k])
    x = 0.05 * np.random.default_rng(5).standard_normal(decks[1].dofmap.n_dof)
    _same_system(*decks, x)


def test_edge_line_source_and_measure():
    """tests/test_edge_wetting_bcs.py: the top & right curve of a 2x3x2
    box (length 2) carries a unit line load onto the edge's nodes only
    (R summing to -2 over the temperature rows, within 1e-10 of goma_tpu's
    R); the 3x3x3 box with a line source of 2.5 and a Dirichlet bottom
    solved on the host ``direct`` rung: goma_tpu's Newton count, x within
    1e-9, the bottom's heat flux within 1e-8 of goma_tpu's and of 2.5."""
    decks = [edge_deck(P, ("EdgeTraction", ("temperature", 1, 1.0), {}),
                       n=(2, 3, 2), ylim=(0.0, 2.0)) for P in (J, T)]
    (mesh, pt), pj = decks[1], decks[0][1]
    assert pt.edge_sets[0].edge_elems.shape[0] == 3
    R = _same_system(pj, pt, np.zeros(pt.dofmap.n_dof))
    d = pt.dofmap.dof_of_node_svar[:, pt.dofmap.svar("temperature")]
    load = R[d[d >= 0]]
    np.testing.assert_allclose(load.sum(), -2.0, rtol=1e-12)
    c = mesh.coords[d >= 0][np.abs(load) > 1e-14]
    np.testing.assert_allclose(c[:, [0, 2]], 1.0, atol=1e-12)

    flux = []
    for P, tens in ((J, jnp.asarray), (T, torch.as_tensor)):
        _, prob = edge_deck(P, ("EdgeTraction", ("temperature", 1, 2.5), {}),
                            n=(3, 3, 3))
        res = P["S"](prob, P["O"](max_iter=5, linear_solver="direct")).solve(
            np.zeros(prob.dofmap.n_dof), prob.base_params())
        assert res.converged
        post = _mod(P["phys"].__name__.replace("physics", "post"))
        Fb = post.sideset_integral(prob, "bottom", post.heat_flux)
        flux.append((res, float(Fb(tens(res.x), prob.base_params()))))
    (rj, fj), (rt, ft) = flux
    assert rt.iters == rj.iters
    assert _dx(rt.x, rj.x) <= X_TOL
    assert abs(ft - fj) <= 1e-8 * abs(fj)
    np.testing.assert_allclose(abs(ft), 2.5, rtol=1e-8)


def wetting_deck(P, kernels):
    """The 8x4 QUAD9 level-set deck of tests/test_edge_wetting_bcs.py with
    face kernels ``{sideset: (name, kwargs)}``, at the planar interface
    through (0.5, 0) at 65 degrees to the bottom wall. Returns (problem,
    x)."""
    ph, wet = P["phys"], _mod(P["bc"] + ".wetting")
    ls = _mod(P["phys"].__name__ + ".level_set")
    mesh = P["mesh"].rectangle_mesh(8, 4, elem="QUAD9")
    prob = P["fem"].Problem(mesh, [
        ph.Momentum(dim=2, interp="Q2", transient=False),
        ph.Continuity(interp="Q1"), ls.FillEquation(interp="Q2")],
        {"rho": 1.0, "mu": 1.0}, **P["kw"])
    for ss, (name, kw) in kernels.items():
        prob.add_face_kernel(ss, getattr(wet, name)(**kw))
    prob.finalize()
    th = np.deg2rad(65.0)
    nf = np.array([-np.sin(th), -np.cos(th)])
    x = np.zeros(prob.dofmap.n_dof)
    dF = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar("fill")]
    ok = dF >= 0
    x[dF[ok]] = (mesh.coords[ok] - [0.5, 0.0]) @ nf
    x = x + 0.01 * np.random.default_rng(3).standard_normal(x.shape)
    return prob, x


WETTING = {
    "speed": {"bottom": ("LSWettingSpeed", dict(
        dim=2, theta_s_deg=60.0, alpha=0.2, model="blake", v0=0.7, g=2.0,
        depth=0.1)),
        "top": ("LSWettingSpeed", dict(dim=2, theta_s_deg=60.0, alpha=0.2,
                                       model="hoffman", g=2.0, depth=0.1)),
        "left": ("LSWettingSpeed", dict(dim=2, theta_s_deg=60.0, alpha=0.3,
                                        model="cox", g=2.0, depth=0.1)),
        "right": ("LSWettingSpeed", dict(dim=2, theta_s_deg=60.0, alpha=0.3,
                                         model="shik", v0=0.7, g=2.0,
                                         depth=0.1))},
    "window": {"bottom": ("HysteresisWetting", dict(
        dim=2, theta_adv_deg=100.0, theta_rec_deg=60.0, alpha=0.2,
        beta_adv=0.5, beta_rec=0.25, depth=0.1)),
        "top": ("LSWettingSpeed", dict(dim=2, theta_s_deg=60.0, alpha=0.2,
                                       model="linear", beta=0.5, depth=0.1)),
        "left": ("CapRepulse", dict(dim=2, dist_fn=lambda x: 2.0 - x[:, 1],
                                    P_rep=3.0, hscale=0.1, repexp=2.0,
                                    betainv=0.5)),
        "right": ("RepulsiveForce", dict(dim=2, pr=0.3, plane=(1.0, 0.0, 0.0, -1.5),
                                         friction=0.2, var="velocity"))},
    "young": {"bottom": ("FillContactAngle", dict(dim=2, theta_deg=55.0,
                                                  sigma=0.8, eps=0.15)),
              "top": ("WettingTension", dict(dim=2, wetting_tension=0.8,
                                             eps=0.15))},
}


@pytest.mark.parametrize("group", sorted(WETTING))
def test_wetting_kernels_match_goma_tpu(group):
    """Every wetting face kernel (the five wetting-speed models, the
    hysteresis window, CAP_REPULSE with its slip term, REP_FORCE with
    friction, FILL_CA and WETTING_TENSION) on the level-set deck: R and the
    CSR values at the tilted-interface state within 1e-10 of goma_tpu's;
    FILL_CA's total force is the sharp Young traction to the test's
    6e-3."""
    decks = [wetting_deck(P, WETTING[group]) for P in (J, T)]
    R = _same_system(decks[0][0], decks[1][0], decks[1][1])
    if group == "young":
        pt, x = wetting_deck(T, {"bottom": WETTING["young"]["bottom"]})
        th = np.deg2rad(65.0)
        nf = np.array([-np.sin(th), -np.cos(th)])
        dF = pt.dofmap.dof_of_node_svar[:, pt.dofmap.svar("fill")]
        ok = dF >= 0
        x[dF[ok]] = (pt.mesh.coords[ok] - [0.5, 0.0]) @ nf
        R = _np(_assemble(pt, x)[0])
        tot = [R[d[d >= 0]].sum() for d in (
            pt.dofmap.dof_of_node_svar[:, pt.dofmap.svar("velocity", c)]
            for c in range(2))]
        ca = np.deg2rad(55.0)
        np.testing.assert_allclose(-np.array(tot), 0.8 * np.array(
            [-np.cos(ca), -np.sin(ca)]), rtol=6e-3)


def test_wetting_correlations_match_goma_tpu():
    """hoffman_correlation_ca, cox_f / cox_wetting_ca and
    shik_wetting_speed against goma_tpu's on a sweep of angles, 1e-12
    relative."""
    import goma_tpu.bc.wetting as jw
    import goma_tpu_torch.bc.wetting as tw

    th = np.deg2rad(np.linspace(20.0, 170.0, 16))
    t = torch.as_tensor(th)
    pairs = [
        (tw.hoffman_correlation_ca(torch.cos(t)),
         jw.hoffman_correlation_ca(jnp.cos(jnp.asarray(th)))),
        (tw.cox_f(t, 0.1), jw.cox_f(jnp.asarray(th), 0.1)),
        (tw.cox_wetting_ca(t, np.deg2rad(60.0), lam=0.1, eps_slip=1e-3,
                           q_inner=0.2, q_outer=0.1),
         jw.cox_wetting_ca(jnp.asarray(th), np.deg2rad(60.0), lam=0.1,
                           eps_slip=1e-3, q_inner=0.2, q_outer=0.1)),
        (tw.shik_wetting_speed(torch.cos(t), np.cos(np.deg2rad(60.0)),
                               np.deg2rad(150.0), 0.7, 2.0),
         jw.shik_wetting_speed(jnp.cos(jnp.asarray(th)),
                               np.cos(np.deg2rad(60.0)), np.deg2rad(150.0),
                               0.7, 2.0))]
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12, atol=0)
