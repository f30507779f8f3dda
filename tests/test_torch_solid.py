"""Solid mechanics of the PyTorch port against goma_tpu:
``physics/solid.py`` (the real solid, its dynamics, strain measures and
ties), ``bc/fluid.FlowPressure``, ``bc/traction.py``, ``bc/contact.py`` and
the two-way overset coupling (``OversetFSI`` with
``Problem.add_overset(solid=...)``). Each deck is built in both packages on
the CPU in float64 (the port in one torch thread) from
``scripts/solid_decks.py``, written once for both.

Tolerances: R and the CSR values of ``assemble`` (goma_tpu's jitted one)
within 1e-12 of each array's max at seeded states (readings ~1e-15); the
float32 element Jacobians within 1e-6 (inside the standing mixed-precision
allowance of 1e-5); goma_tpu's test decks on the host ``direct`` rung with the
same Newton count and x within 1e-10 (1 + |x|); the 8x4 FSI column on
bench.py's two device rungs (float32 factors) with the same Newton and
linear counts and ND levels and x within 1e-8 (1 + |x|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.physics.solid as j_solid
import goma_tpu.solvers as j_solvers
import goma_tpu_torch.physics.solid as t_solid
import goma_tpu_torch.solvers as t_solvers
from scripts import solid_decks as sd
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_overset import bench_opts

JAX = sd.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = sd.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _state(prob, P, seed, scale=0.05, ct=2.0):
    """A seeded state: x, and params with ct and a seeded history (so every
    rate term is live)."""
    rng = np.random.default_rng(seed)
    x = scale * rng.standard_normal(prob.dofmap.n_dof)
    params = prob.base_params()
    params["ct"] = P.arr(np.float64(ct))
    params["hist"] = P.arr(scale * rng.standard_normal(prob.dofmap.n_dof))
    return x, params


# ----------------------------------------------------------- element cases
def _solid_dynamic(P):
    """Nonlinear real solid with inertia, thermal strain and a constant
    body force, its kinematics and a transient energy equation."""
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    S = P.solid
    prob = P.Problem(mesh, [S.RealSolid(2, interp="Q2", model="nonlinear",
                                        dynamic=True),
                            S.SolidKinematics(2, interp="Q2"),
                            P.phys.Energy(interp="Q2", transient=True,
                                          convection=False)],
                     {"lame_mu": 3.0, "lame_lambda": 2.0, "solid_rho": 1.5,
                      "solid_thermexp": 0.1, "solid_ref_temp": 0.2,
                      "solid_body_force": (0.3, -0.4), "rho": 1.0, "Cp": 1.0,
                      "k": 1.0}, **P.kw)
    prob.add_dirichlet("left", "solid_displacement", 0, 0.0)
    prob.finalize()
    return prob


def _solid_linear(P):
    """Linear real solid with thermal strain and a body-force callable of
    the reference coordinates."""
    xp = P.xp
    mesh = P.mesh.rectangle_mesh(2, 3, elem="QUAD9")
    prob = P.Problem(mesh, [P.solid.RealSolid(2, interp="Q2", model="linear"),
                            P.phys.Energy(interp="Q2", transient=False,
                                          convection=False)],
                     {"lame_mu": 2.5, "lame_lambda": 1.5, "solid_rho": 0.7,
                      "solid_thermexp": 0.3, "k": 1.0,
                      "solid_body_force": lambda fv, m, p: xp.stack(
                          [fv.X0[:, 1], -fv.X0[:, 0] ** 2], 1)}, **P.kw)
    prob.finalize()
    return prob


def _strains(P, nonlinear=True):
    """Current and running-maximum von Mises strain of a solid field."""
    S = P.solid
    mesh = P.mesh.rectangle_mesh(2, 2, elem="QUAD9")
    prob = P.Problem(mesh, [S.RealSolid(2, interp="Q2", model="nonlinear"),
                            S.CurStrain(interp="Q1", nonlinear=nonlinear),
                            S.MaxStrain(interp="Q1", nonlinear=nonlinear)],
                     {"lame_mu": 3.0, "lame_lambda": 2.0}, **P.kw)
    prob.finalize()
    return prob


def _solid_faces(P):
    """Every solid-side face kernel on one linear solid: tractions
    (constant and callable), rigid contact (AD gradient and analytic),
    friction (sliding, acoustic), slope (rotated and SLOPEX) and
    FORCE_SIC."""
    xp, S, tr, ct = P.xp, P.solid, P.traction, P.contact
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    prob = P.Problem(mesh, [S.RealSolid(2, interp="Q2", model="linear")],
                     {"lame_mu": 3.0, "lame_lambda": 2.0}, **P.kw)
    V = "solid_displacement"
    prob.add_face_kernel("top", S.SolidTraction(2, [0.1, -0.3]))
    prob.add_face_kernel("top", S.SolidTraction(
        2, lambda s, m, p: xp.stack([s.x[:, 0] ** 2, xp.sin(s.x[:, 0])], 1)))
    prob.add_face_kernel("bottom", ct.RigidContactPenalty(
        2, ct.halfspace([0.2, 1.0], 0.01), 50.0))
    prob.add_face_kernel("bottom", ct.RigidContactPenalty(
        2, lambda x: x[1] - 0.1 * x[0] ** 2 + 0.02, 30.0,
        grad_g=lambda x: xp.stack([-0.2 * x[0], xp.ones_like(x[1])])))
    prob.add_face_kernel("bottom", tr.CoulombFriction(
        2, mu_f=0.3, var=V, slide_velocity=(0.4, 0.1), acoustic_velocity=2.0))
    prob.add_face_kernel("left", tr.CoulombFriction(2, mu_f=0.2, var=V))
    prob.add_face_kernel("right", tr.SlopeBC(2, slope=(1.0, 0.05), var=V,
                                             penalty=10.0))
    prob.add_face_kernel("right", tr.SlopeBC(2, slope=(0.3, 1.0), comp=0,
                                             var=V, penalty=5.0))
    prob.add_face_kernel("left", tr.ForceSIC(2, force=(-0.1, 0.02), var=V,
                                             penalty=20.0))
    prob.finalize()
    return prob


def _fluid_faces(P):
    """The fluid-side kernels: FLOW_PRESSURE (callable p0, hydrostatic),
    ELEC_TRACTION, FLOW_GRADV (pressure field; datum, transposed, penalty)
    and the FSI velocity tie against a passive solid displacement."""
    xp, ph, tr = P.xp, P.phys, P.traction
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    prob = P.Problem(mesh, [ph.Momentum(dim=2, interp="Q2", transient=True),
                            ph.Continuity(interp="Q1"), ph.Potential(),
                            P.eqs.PassiveVar("solid_displacement", 2, "Q2")],
                     {"rho": 1.0, "mu": 0.8, "permittivity": 1.7}, **P.kw)
    prob.add_face_kernel("left", P.fluid_bc.FlowPressure(
        dim=2, p0=lambda s, m, p: 0.3 + s.x[:, 1], rho=2.0, g=(0.0, -9.8),
        x0=(0.0, 0.5)))
    prob.add_face_kernel("top", tr.ElecTraction(dim=2))
    prob.add_face_kernel("top", tr.ElecTraction(dim=2, permittivity=0.6,
                                                etm=2.0))
    prob.add_face_kernel("right", tr.FlowGradV(dim=2))
    prob.add_face_kernel("right", tr.FlowGradV(dim=2, p_datum=0.2,
                                               transpose=True, penalty=3.0))
    prob.add_face_kernel("bottom", P.solid.FSIVelocityTie(dim=2,
                                                          penalty=50.0))
    prob.finalize()
    return prob


def _mesh_tie(P):
    """TOTAL_ALE: a nonlinear solid with an elliptic mesh tied to it on the
    right."""
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
    prob = P.Problem(mesh, [P.solid.RealSolid(2, interp="Q1",
                                              model="nonlinear"),
                            P.phys.EllipticMesh(2, interp="Q1")],
                     {"lame_mu": 3.0, "lame_lambda": 2.0}, **P.kw)
    prob.add_dirichlet("left", "mesh_displacement", 0, 0.0)
    P.solid.tie_mesh_to_solid(prob, "right", 2)
    prob.finalize()
    return prob


ELEMENT_CASES = {
    "solid_dynamic": _solid_dynamic,
    "solid_linear": _solid_linear,
    "strains": _strains,
    "strains_small": lambda P: _strains(P, nonlinear=False),
    "solid_faces": _solid_faces,
    "fluid_faces": _fluid_faces,
    "mesh_tie": _mesh_tie,
    "fluid_solid_tie": lambda P: sd.fsi_column(P, 4, 2, "nonlinear", 0.5),
    "overset_fsi": sd.overset_fsi_wall_problem,
}


@functools.lru_cache(maxsize=None)
def _pair(case):
    """The case's problem in both packages, built once per module (so
    goma_tpu's jitted assembly compiles once for the tests that share
    it)."""
    return ELEMENT_CASES[case](JAX), ELEMENT_CASES[case](TORCH)


@pytest.mark.parametrize("case", list(ELEMENT_CASES))
def test_assembled_system_matches(case):
    """R and the CSR values of ``assemble`` at a seeded state (x, ct = 2
    and a seeded history) within 1e-12 of goma_tpu's jitted assembly: the real solid (linear, St.
    Venant-Kirchhoff, thermal, body forces, inertia) and its kinematics,
    the strain measures, every face kernel of the slice, the mesh and
    fluid ties (point constraints and the row injection) and the overset
    coupling with the solid's rows and rates."""
    out = []
    for P, prob in zip((JAX, TORCH), _pair(case)):
        x, params = _state(prob, P, 3)
        R, vals = prob.assemble(P.arr(x), params)
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.isfinite(Rt).all() and np.isfinite(Vt).all()
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


def test_max_strain_old_state_matches():
    """``MaxStrain`` with a step size in params (ms_old = ms - dt ms_dot;
    goma_tpu tests ``if dt`` in Python, so its assembly is jitted here with
    dt a constant of the trace): R and the CSR values within 1e-12."""
    out = []
    for P, prob in zip((JAX, TORCH), _pair("strains")):
        x, params = _state(prob, P, 5)
        if P is JAX:
            R, vals = jax.jit(lambda x, p: prob._assemble(x, {**p, "dt": 0.1}))(
                P.arr(x), params)
        else:
            R, vals = prob.assemble(P.arr(x), {**params, "dt": 0.1})
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


# ------------------------------------------------------------ AD edges
@pytest.mark.parametrize("jdt", ["float64", "float32"])
def test_von_mises_root_at_zero_strain(jdt):
    """The ``1e-300`` under the von Mises root (``solid.py:238``): at zero
    strain the float64 Jacobian is finite (the floor keeps the root at
    1e-150) and equals goma_tpu's; in float32 the floor rounds to 0 and the
    root's derivative is 0 * inf, NaN, in goma_tpu and in the port at the
    same entries (no guard added). float64: the CSR values of
    ``assemble``; float32: the element Jacobians of the mixed-precision
    prep (the St. Venant-Kirchhoff solid's and the strain measures'),
    within 1e-6 of goma_tpu's (which computes parts of them in float64)
    where finite."""
    out = []
    for P, prob in zip((JAX, TORCH), _pair("strains")):
        x0 = P.arr(np.zeros(prob.dofmap.n_dof))
        if jdt == "float64":
            out.append(_np(prob.assemble(x0, prob.base_params())[1]))
            continue
        prob.jacobian_dtype = getattr(P.xp, jdt)
        try:
            _, _, aux = prob._assemble_fast(x0, prob.base_params())
        finally:
            prob.jacobian_dtype = None
        out.append(_np(aux[0][0]))
    Jj, Jt = out
    assert np.array_equal(np.isnan(Jt), np.isnan(Jj))
    assert np.isnan(Jt).any() == (jdt == "float32")
    ok = np.isfinite(Jj)
    assert np.abs(Jt[ok] - Jj[ok]).max() <= (RTOL if jdt == "float64"
                                             else 1e-6) * np.abs(Jj[ok]).max()


def test_max_strain_tie_tangent():
    """``MaxStrain``'s max(vmE, ms_old) at an exact tie: the forward-mode
    tangent of ``torch.maximum`` is half of each side's, as
    ``jnp.maximum``'s, and the residual's derivative with respect to the
    running maximum ms at a tie (ms_old = ms = vmE, steady) equals
    goma_tpu's."""
    a, b = 0.37, 0.37
    tj = jax.jvp(jnp.maximum, (jnp.float64(a), jnp.float64(b)),
                 (jnp.float64(1.0), jnp.float64(3.0)))[1]
    tt = torch.func.jvp(torch.maximum, (torch.tensor(a, dtype=torch.float64),
                                        torch.tensor(b, dtype=torch.float64)),
                        (torch.tensor(1.0, dtype=torch.float64),
                         torch.tensor(3.0, dtype=torch.float64)))[1]
    assert float(tj) == float(tt) == 2.0

    class FV:
        pass

    g = np.array([[[0.02, 0.01], [-0.03, 0.015]]])
    out = []
    for mod, arr, jac in ((j_solid, jnp.asarray, jax.jacfwd),
                          (t_solid, torch.as_tensor, torch.func.jacfwd)):
        eq = mod.MaxStrain(nonlinear=True)
        # each package's own vmE, so the tie is exact in both
        vm = mod.von_mises_strain(_fv(FV, arr, g, 0.0), nonlinear=True)[0]

        def r(ms, arr=arr, eq=eq):
            return eq.residual(_fv(FV, arr, g, ms), {}, {})

        out.append(_np(jac(r)(vm)))
    assert np.abs(out[1] - out[0]).max() <= 1e-15
    assert np.abs(out[0]).max() > 0


def _fv(FV, arr, g, ms):
    """One quadrature point: solid gradient ``g`` (1, 2, 2), a Q1 basis,
    the running maximum ``ms`` at rest."""
    fv = FV()
    fv.grad = {"solid_displacement": arr(g)}
    ms = arr(ms)
    fv.val = {"max_strain": ms.reshape(1, 1) if hasattr(ms, "reshape")
              else ms}
    fv.dot = {"max_strain": 0.0 * fv.val["max_strain"]}
    fv.phi = {"max_strain": arr(np.array([[0.1, 0.2, 0.3, 0.4]]))}
    return fv


# ----------------------------------------------------------------- decks
@pytest.mark.parametrize("deck", list(sd.SOLID_SMALL))
def test_solid_decks_match(deck):
    """goma_tpu's tests/test_solid.py, tests/test_contact.py,
    tests/test_fsi_conforming.py, tests/test_bc_traction.py (but its air
    film, a later slice) and tests/test_overset.py's elastic wall, each
    with its own gate, in both packages on the host ``direct`` rung (the
    bar's 240 Crank-Nicolson steps under the transient driver): the same
    Newton count and x (or R) within 1e-10 (1 + |x|)."""
    oj = sd.SMALL[deck](JAX)
    ot = sd.SMALL[deck](TORCH)
    assert ot["newton"] == oj["newton"]
    assert np.max(np.abs(ot["x"] - oj["x"]) / (1.0 + np.abs(oj["x"]))) <= 1e-10


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_fsi_column_device_rungs(kind):
    """The 8x4 St. Venant-Kirchhoff FSI column of phase 54 (P0 = 2) from
    x = 0 on bench.py's two device rungs (``_cavity_opts(kind, tol=1e-9,
    max_iter=12)``; a row injection, so the full prep and the ELL
    operator): goma_tpu's Newton and linear counts and ND levels, x within
    1e-8 (1 + |x|)."""
    pj = sd.fsi_column(JAX, 8, 4, "nonlinear", 2.0)
    pt = sd.fsi_column(TORCH, 8, 4, "nonlinear", 2.0)
    assert (pt.dofmap.n_dof, pt.pattern.nnz) == (pj.dofmap.n_dof,
                                                 pj.pattern.nnz)
    sj = j_solvers.NewtonSolver(pj, bench_opts(j_solvers.NewtonOptions, kind,
                                               max_iter=12))
    st = t_solvers.NewtonSolver(pt, bench_opts(t_solvers.NewtonOptions, kind,
                                               max_iter=12))
    x0 = np.zeros(pt.dofmap.n_dof)
    rj = sj.solve(x0, pj.base_params())
    rt = st.solve(x0, pt.base_params())
    assert rj.converged and rt.converged, (rj.summary(), rt.summary())
    assert (rt.iters, rt.linear_iters) == (rj.iters, rj.linear_iters)
    ndj = sj.precond if kind == "gmres+ndlu" else sj._ndlu
    ndt = st.precond if kind == "gmres+ndlu" else st._ndlu
    assert [(lv.nn, lv.smax) for lv in ndt.levels] == \
        [(int(lv.nn), int(lv.smax)) for lv in ndj.levels]
    assert np.max(np.abs(rt.x - rj.x) / (1.0 + np.abs(rj.x))) <= 1e-8
