"""The closure decks (suspensions, gas and surface kinetics, moments,
turbulence), written once for both packages.

Every function here takes a package namespace ``P`` (see ``namespace``):
goma_tpu's modules and ``jax.numpy`` from ``scripts/closure_reference.py``
and the port's tests, the port's modules and ``torch`` from
``chip_smoke.py``. Callables are written in the operations ``jax.numpy``
and ``torch`` share, so one deck is one definition. This module imports
neither package: ``namespace`` imports the one it is given by name.

- ``suspension(P, nx, ny)``: a concentrated pressure-driven suspension in
  a channel [0, 8] x [0, 1] (``nx`` x ``ny`` QUAD9): ``Momentum`` +
  ``Continuity`` (Q2/Q1, rho 1) with the Krieger-Dougherty viscosity
  ``SuspensionViscosity(mu0=1, Cmax=0.68, n=-1.82)``, the q-tensor
  Phillips migration flux ``QTensorHydroSpecies`` (Q2) with the constants
  of Phillips et al. (1992, Phys. Fluids A 4(1):30): Kc 0.41, Kmu 0.62,
  phi_max 0.68, n -1.82, particle radius a = H/16, goma_tpu's default
  ``qweights`` (1.0, 0.8, 0.5), and the shear rate projected onto a Q1
  field (``ProjectionEquation``, as tests/test_suspension.py). Parabolic
  inflow u = 6 y (1 - y) with phi = 0.4, no-slip walls, a natural outflow.
  ``SUSP_STEPS`` backward-Euler steps of dt ``SUSP_DT`` without adaptation
  from the developed flow at uniform phi (``suspension_time``):
  ``phi_profiles`` reads phi up the lines x = 4 and x = 8.
- ``reacting(P, nx, ny)``: a reacting wall channel [0, 4] x [0, 1]
  (``nx`` x ``ny`` QUAD9): ``Momentum`` + ``Continuity`` (rho 1, mu 0.1:
  Re 10 on the mean speed and the height), ``Species(2)`` (A, B) and
  ``Energy`` (Q2). Gas chemistry from the Chemkin-II text ``REACT_MECH``
  (a reversible step with a REV card, a (+M) falloff with LOW and TROE, a
  third body with efficiencies; Ea in cal/mol) through ``species_source``
  and ``heat_source``; PLACID surface chemistry on the bottom wall
  (``WALL_MECH``: adsorption, desorption and deposition into a two-species
  bulk phase, releasing B) through ``NormalFlux("species",
  surface_kinetics_flux(...), ncomp=2)``; the bottom wall heated by a
  constant flux. Inflow: parabolic, A = 1, B = 0, T = 300 K.
- ``rans_channel(P, nx, ny)``: a Navier-Stokes channel with
  ``SpalartAllmaras`` and ``SATurbulentViscosity`` (the coupled RANS path).
- ``SMALL``: goma_tpu's tests' decks of the slice at their own sizes, on
  their own solvers (host ``direct``; the transient ones under the
  transient solver), each checking the test's own gate and returning its
  Newton count, its readings and its solution (or residual).
"""

from __future__ import annotations

import importlib
import types

import numpy as np

from scripts.em_decks import _project
from scripts.shell_decks import _np, _out, _solve, close, gate, samples
from scripts.solid_decks import step_records  # noqa: F401  (re-exported)

# ------------------------------------------------------------ suspension
SUSP_L, SUSP_H = 8.0, 1.0
SUSP_PHI0 = 0.4
SUSP_KC, SUSP_KMU, SUSP_PHIMAX, SUSP_NEXP = 0.41, 0.62, 0.68, -1.82
SUSP_A = SUSP_H / 16.0
SUSP_QW = (1.0, 0.8, 0.5)
# dt: the Phillips flux piles particles onto the centreline, where the
# shear rate vanishes; at 128 x 32 a step of dt 1 fails in goma_tpu and at
# 64 x 16 phi there passes phi_max by t = 2. From dt 0.05 goma_tpu's second
# attempt fails (the predictor extrapolates the first step's growth of the
# centreline peak; dt 0.025 fails there too) and the transient solver
# halves dt to 0.025: ten steps reach t = 0.275 and move phi by more than
# 1e-3 at 19 and 47 node rows of the lines x = 4 and x = 8.
SUSP_DT, SUSP_STEPS, SUSP_MAX_ITER = 0.05, 10, 12
SUSP_LINES = (4.0, 8.0)

# --------------------------------------------------------------- reacting
REACT_L, REACT_H = 4.0, 1.0
REACT_MU, REACT_K, REACT_D, REACT_T_IN = 0.1, 0.05, 0.05, 300.0
REACT_Q_WALL = 5.0
REACT_PRESSURE = 101325.0
REACT_DH = {0: -20.0, 1: -20.0, 2: -20.0}
REACT_B_SEED = 0.01
REACT_MAX_ITER = 12
REACT_MECH = """
! A -> B by three kinds of gas step; Ea in cal/mol
ELEMENTS
X
END
SPECIES
A B
END
REACTIONS CAL/MOLE
A <=> B            200.0  0.0  5000.0
REV / 20.0 0.0 5000.0 /
A (+M) => B (+M)   300.0  0.0  5000.0
LOW / 600.0 0.0 5000.0 /
TROE / 0.6 200.0 1000.0 /
A + M => B + M     100.0  0.0  5000.0
B/2.0/
END
"""
# [A(g), B(g) | S, A(s) | D1, D2]: A + S -> A(s), A(s) -> A + S,
# A(s) -> B + S + D1, A(s) -> B + S + D2
WALL_MECH = {"nu": [[-1, 0, -1, 1, 0, 0], [1, 0, 1, -1, 0, 0],
                    [0, 1, 1, -1, 1, 0], [0, 1, 1, -1, 0, 1]],
             "A": [0.05, 0.5, 0.3, 0.9], "n_gas": 2,
             "phases": [("site", 2), ("bulk", 2)], "sden0": [0.08]}

# ------------------------------------------------------------------ RANS
RANS_NU, RANS_NUT_IN = 0.01, 0.05
# tests/test_physics_breadth.py's SA decay runs its adaptive steps (dt near
# 4e-5 under its error control) to t = 0.5, ~10,000 Newton iterations; the
# decks stop at SA_T_END (module docstring of ``sa_decay``)
SA_T_END = 0.005


def namespace(pkg: str, xp, arr, device=None):
    """The namespace the decks read for package ``pkg`` ("goma_tpu" or
    "goma_tpu_torch"): its mesh generators, Problem, the physics modules of
    the slice, ``fem.equations``, ``bc.free_surface``, the solvers,
    ``utils.numjac``, the array module ``xp``, ``arr`` (a numpy array onto
    the package's device) and the Problem's device keyword."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    solvers, transient = mod("solvers"), mod("solvers.transient")
    return types.SimpleNamespace(
        pkg=pkg, mesh=mod("mesh"), Problem=mod("fem").Problem,
        phys=mod("physics"), susp=mod("physics.suspension"),
        kin=mod("physics.kinetics"), chemkin=mod("physics.chemkin"),
        placid=mod("physics.placid"), pop=mod("physics.population"),
        turb=mod("physics.turbulence"), acoustic=mod("physics.acoustic"),
        materials=mod("physics.materials"), eqs=mod("fem.equations"),
        free_surface=mod("bc.free_surface"), numjac=mod("utils.numjac"),
        NewtonOptions=solvers.NewtonOptions,
        NewtonSolver=solvers.NewtonSolver, TimeOptions=transient.TimeOptions,
        TransientSolver=transient.TransientSolver, xp=xp, arr=arr,
        kw={} if device is None else {"device": device})


def readings(x):
    """||x||_2, max |x| and x at the 24 sampled dofs of a solution."""
    x = _np(x)
    return {"x_norm": float(np.linalg.norm(x)),
            "x_max": float(np.abs(x).max()),
            "x_samples": x[samples(x.size)].tolist()}


def _nodes_at(mesh, x=None, y=None):
    """Nodes on the line x = ``x`` (sorted by y) or y = ``y`` (by x)."""
    c = mesh.coords
    if x is not None:
        on = np.flatnonzero(np.abs(c[:, 0] - x) < 1e-9)
        return on[np.argsort(c[on, 1])]
    on = np.flatnonzero(np.abs(c[:, 1] - y) < 1e-9)
    return on[np.argsort(c[on, 0])]


def _trapz(f, y):
    return float(np.sum(0.5 * (f[1:] + f[:-1]) * np.diff(y)))


# ------------------------------------------------------------ suspension
def _shear_rate_source(P):
    def src(fv, mat, params):
        return P.materials.shear_rate(fv)[:, None]
    return src


def suspension(P, nx, ny):
    """The suspension channel (module docstring), finalized. Returns
    (problem, x0): x0 the developed Poiseuille flow u = 6 y (1 - y) at
    uniform phi = 0.4 with its pressure 12 mu(0.4) (L - x) and its shear
    rate |6 (1 - 2 y)|."""
    ph = P.phys
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, SUSP_L),
                                 ylim=(0, SUSP_H))
    eqs = [ph.Momentum(dim=2, interp="Q2", transient=True),
           ph.Continuity(interp="Q1"),
           P.susp.QTensorHydroSpecies(
               Kc=SUSP_KC, Kmu=SUSP_KMU, a_rad=SUSP_A, mu0=1.0,
               maxpack=SUSP_PHIMAX, nexp=SUSP_NEXP, interp="Q2",
               qweights=SUSP_QW),
           P.acoustic.ProjectionEquation("shear_rate", 1,
                                         _shear_rate_source(P), interp="Q1")]
    mat = {"rho": 1.0, "mu": P.materials.SuspensionViscosity(
        mu0=1.0, Cmax=SUSP_PHIMAX, n=SUSP_NEXP)}
    prob = P.Problem(mesh, eqs, mat, **P.kw)
    uin = lambda c: 6.0 * c[:, 1] * (1.0 - c[:, 1])  # noqa: E731
    prob.add_dirichlet("left", "velocity", 0, uin)
    prob.add_dirichlet("left", "species", 0, SUSP_PHI0)
    for ns in ("left", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
    prob.finalize()
    c = mesh.coords
    x0 = np.zeros(prob.dofmap.n_dof)
    x0 = prob.set_nodal_field(x0, "velocity", 0, uin(c))
    x0 = prob.set_nodal_field(x0, "species", 0, SUSP_PHI0)
    x0 = prob.set_nodal_field(x0, "shear_rate", 0,
                              np.abs(6.0 * (1.0 - 2.0 * c[:, 1])))
    mu = (1.0 - SUSP_PHI0 / SUSP_PHIMAX) ** SUSP_NEXP
    x0 = prob.set_nodal_field(x0, "pressure", 0, 12.0 * mu * (SUSP_L - c[:, 0]))
    return prob, x0


def suspension_time(P, steps=SUSP_STEPS):
    """Backward Euler at dt ``SUSP_DT`` without adaptation, ``steps``
    steps."""
    return P.TimeOptions(dt0=SUSP_DT, t_end=steps * SUSP_DT, max_steps=steps,
                         adapt=False, theta=0.0)


def phi_profiles(prob, x):
    """phi at every node of the lines x = 4 and x = 8, each from the
    bottom wall up (the lines' node rows)."""
    phi = prob.get_nodal_field(_np(x), "species", 0)
    return [phi[_nodes_at(prob.mesh, x=xl)].tolist() for xl in SUSP_LINES]


def moved_rows(prob, x, x0, tol=1e-3):
    """The number of node rows on each line of ``phi_profiles`` where phi
    moved by more than ``tol`` from ``x0``."""
    return [int(np.sum(np.abs(np.subtract(a, b)) > tol))
            for a, b in zip(phi_profiles(prob, x), phi_profiles(prob, x0))]


# ------------------------------------------------------------- reacting
def wall_mech(P):
    """``WALL_MECH`` in package ``P``."""
    return P.placid.SurfaceMechanism(**WALL_MECH)


def reacting(P, nx, ny):
    """The reacting wall channel (module docstring), finalized. Returns
    (problem, x0): x0 the inflow profile everywhere, A = 1, T = 300 K and
    B = ``REACT_B_SEED`` off the inlet (goma_tpu's PLACID face Jacobian is
    NaN where a wall gas fraction is exactly 0; see ROADMAP Queue 3)."""
    ph = P.phys
    net, species = P.chemkin.parse_chemkin(REACT_MECH, dH=REACT_DH)
    assert species == ["A", "B"]
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, REACT_L),
                                 ylim=(0, REACT_H))
    eqs = [ph.Momentum(dim=2, interp="Q2", transient=False),
           ph.Continuity(interp="Q1"),
           ph.Species(n_species=2, interp="Q2", transient=False),
           ph.Energy(interp="Q2", transient=False)]
    mat = {"rho": 1.0, "mu": REACT_MU, "k": REACT_K, "Cp": 1.0,
           "diffusivity": np.array([REACT_D, REACT_D]),
           "species_source": net.species_source,
           "heat_source": net.heat_source}
    prob = P.Problem(mesh, eqs, mat, **P.kw)
    uin = lambda c: 6.0 * c[:, 1] * (1.0 - c[:, 1])  # noqa: E731
    prob.add_dirichlet("left", "velocity", 0, uin)
    for ns in ("left", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("left", "species", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, REACT_T_IN)
    prob.add_face_kernel("bottom", P.free_surface.NormalFlux(
        "species", P.placid.surface_kinetics_flux(
            wall_mech(P), species_ids=[0, 1], pressure=REACT_PRESSURE,
            mode=P.placid.SFLUX_RESIDUAL), ncomp=2))
    prob.add_face_kernel("bottom", P.free_surface.NormalFlux(
        "temperature", REACT_Q_WALL))
    prob.finalize()
    c = mesh.coords
    x0 = np.zeros(prob.dofmap.n_dof)
    x0 = prob.set_nodal_field(x0, "velocity", 0, uin(c))
    x0 = prob.set_nodal_field(x0, "species", 0, 1.0)
    x0 = prob.set_nodal_field(x0, "species", 1,
                              np.where(c[:, 0] > 1e-12, REACT_B_SEED, 0.0))
    x0 = prob.set_nodal_field(x0, "temperature", 0, REACT_T_IN)
    return prob, x0


def reacting_outputs(prob, x):
    """The wall temperature rise max T(y=0) - T_in (K) and the outlet
    conversion 1 - (flow-weighted mean A at x = L)."""
    x = _np(x)
    T = prob.get_nodal_field(x, "temperature", 0)
    A = prob.get_nodal_field(x, "species", 0)
    u = prob.get_nodal_field(x, "velocity", 0)
    bot = _nodes_at(prob.mesh, y=0.0)
    out = _nodes_at(prob.mesh, x=REACT_L)
    y = prob.mesh.coords[out, 1]
    flux = _trapz(u[out] * A[out], y) / _trapz(u[out], y)
    return {"wall_dT": float(T[bot].max() - REACT_T_IN),
            "conversion": float(1.0 - flux)}


_GAUSS3 = np.array([-np.sqrt(0.6), 0.0, np.sqrt(0.6)])


def wall_points(prob, x):
    """The gas fractions (A, B) and the temperature at the three Gauss
    points of every bottom-wall face (the face rule of a QUAD9 side),
    (n, 2) and (n,), from the nodal fields of ``x``: the states PLACID
    solves at."""
    x = _np(x)
    bot = _nodes_at(prob.mesh, y=0.0)
    xi = _GAUSS3
    N = np.stack([xi * (xi - 1) / 2, 1 - xi**2, xi * (xi + 1) / 2], 1)
    out = []
    for f in [prob.get_nodal_field(x, "species", 0),
              prob.get_nodal_field(x, "species", 1),
              prob.get_nodal_field(x, "temperature", 0)]:
        v = f[bot]
        faces = np.stack([v[0:-1:2], v[1::2], v[2::2]], 1)
        out.append((faces @ N.T).reshape(-1))
    return np.maximum(np.stack(out[:2], 1), 0.0), out[2]


def wall_placid(P, X, T):
    """PLACID at the wall points (``wall_points``) in package ``P`` as the
    flux closure runs it: (z, sdot, converged, iterations)."""
    arr = P.arr
    n = len(T)
    mech = wall_mech(P)
    return P.placid.placid_points(
        mech, P.placid.SFLUX_RESIDUAL, P.placid.BULK_DEPOSITION, 1.0,
        arr(X), arr(T), arr(np.full(n, REACT_PRESSURE)),
        arr(np.full((n, mech.dim), 1.0 / mech.dim)))


# ------------------------------------------------------------------ RANS
def rans_channel(P, nx=32, ny=16):
    """A steady Navier-Stokes channel [0, 4] x [0, 1] (``nx`` x ``ny``
    QUAD9, rho 1) with ``SpalartAllmaras`` (Q2, nu 0.01) feeding
    ``SATurbulentViscosity``: parabolic inflow with nu_t = 0.2 y (1 - y)
    (0.05 on the axis), nu_t = 0 and no slip on the walls (the wall distance from ``wall_distance``),
    a natural outflow. Returns (problem, x0, params)."""
    ph, T = P.phys, P.turb
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 4.0),
                                 ylim=(0, 1.0))
    eqs = [ph.Momentum(dim=2, interp="Q2", transient=False),
           ph.Continuity(interp="Q1"),
           T.SpalartAllmaras(nu=RANS_NU, interp="Q2", transient=False)]
    prob = P.Problem(mesh, eqs, {"rho": 1.0, "mu": T.SATurbulentViscosity(
        mu=RANS_NU)}, external_fields=("wall_distance",), **P.kw)
    uin = lambda c: 6.0 * c[:, 1] * (1.0 - c[:, 1])  # noqa: E731
    prob.add_dirichlet("left", "velocity", 0, uin)
    nut_in = lambda c: RANS_NUT_IN * 4.0 * c[:, 1] * (1.0 - c[:, 1])  # noqa: E731
    prob.add_dirichlet("left", T.SA_VAR, 0, nut_in)
    for ns in ("left", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, T.SA_VAR, 0, 0.0)
    prob.finalize()
    c = mesh.coords
    x0 = np.zeros(prob.dofmap.n_dof)
    x0 = prob.set_nodal_field(x0, "velocity", 0, uin(c))
    x0 = prob.set_nodal_field(x0, T.SA_VAR, 0, nut_in(c))
    d = T.wall_distance(mesh, ["top", "bottom"])
    return prob, x0, prob.base_params(ext_wall_distance=P.arr(d))


def rans(P):
    """``rans_channel`` at 32 x 16 on host ``direct``: converged, nu_t
    below its inflow peak and above -2% of it (Q2 undershoot at the
    walls)."""
    prob, x0, params = rans_channel(P)
    res = P.NewtonSolver(prob, P.NewtonOptions(
        max_iter=15, tol_residual=1e-10, linear_solver="direct")).solve(
        x0, params)
    gate(res.converged, "RANS channel did not converge")
    nut = prob.get_nodal_field(_np(res.x), P.turb.SA_VAR, 0)
    gate(np.nanmin(nut) > -0.02 * RANS_NUT_IN
         and np.nanmax(nut) <= RANS_NUT_IN + 1e-12, "nu_t out of its range")
    out = _nodes_at(prob.mesh, x=4.0)
    u = prob.get_nodal_field(_np(res.x), "velocity", 0)[out]
    return _out(res.iters, [float(np.nanmax(nut)), float(u.max())], res.x)


# ---------------------------------------------------------- small decks
# tests/test_suspension.py
def particle_settling(P):
    """tests/test_suspension.py::test_particle_settling_terminal_velocity."""
    C0, drho, g, mu_f, a = 0.2, 1.5, -2.0, 0.7, 0.05
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
    pm = P.susp.ParticleMomentum(2, interp="Q1", rho_p=2.0, mu_p=0.0,
                                 a_rad=a, mu_f=mu_f, del_rho=drho,
                                 gravity=[0.0, g], C0=C0, transient=False,
                                 convection=False)
    prob = P.Problem(mesh, [pm], {}, **P.kw)
    prob.finalize()
    res = _solve(P, prob, max_iter=6, tol=1e-12)
    vt = C0 * drho * g / (4.5 * mu_f * C0 / a**2)
    vy = prob.get_nodal_field(_np(res.x), "pvelocity", 1)
    vx = prob.get_nodal_field(_np(res.x), "pvelocity", 0)
    gate(close(vy, vt, 1e-10) and close(vx, 0.0, 0, 1e-12), "terminal velocity")
    return _out(res.iters, [vy.mean()], res.x)


def two_way_problem(P):
    """tests/test_suspension.py::test_two_way_coupled_drag_jacobian's deck:
    fluid + particle momentum (two-way drag) + q-tensor migration +
    projected shear rate on 3 x 3 QUAD9. Returns (problem, its seeded
    state)."""
    ph = P.phys
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    pm = P.susp.ParticleMomentum(2, interp="Q2", rho_p=2.0, mu_p=0.1,
                                 a_rad=0.1, mu_f=1.0, del_rho=1.0,
                                 gravity=[0.0, -1.0], C0=None,
                                 transient=False)
    eqs = [ph.Momentum(2, transient=False), ph.Continuity(), pm,
           P.susp.QTensorHydroSpecies(Kc=0.4, Kmu=0.6, convection=False,
                                      transient=False),
           P.acoustic.ProjectionEquation("shear_rate", 1,
                                         _shear_rate_source(P), interp="Q1")]
    prob = P.Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0,
                                 "body_force": P.susp.particle_drag_force(pm)},
                     **P.kw)
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.finalize()
    rng = np.random.RandomState(1)
    x = 0.05 * rng.randn(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "species", 0,
                             0.3 + 0.05 * rng.rand(mesh.n_nodes))
    x = prob.set_nodal_field(x, "shear_rate", 0, 0.5 + rng.rand(mesh.n_nodes))
    return prob, x


def two_way_drag(P):
    """tests/test_suspension.py::test_two_way_coupled_drag_jacobian: the AD
    Jacobian of ``two_way_problem`` against finite differences at its
    seeded state."""
    prob, x = two_way_problem(P)
    chk = P.numjac.numerical_jacobian_check(prob, x, prob.base_params(),
                                            n_columns=10, h=1e-6)
    gate(chk.ok, chk.report())
    R = _np(prob.assemble(P.arr(x), prob.base_params())[0])
    return _out(0, [chk.n_checked, chk.n_bad], R)


# tests/test_kinetics.py
def _species_prob(P, nx, ny, eqs, mat):
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9")
    return mesh, P.Problem(mesh, eqs, mat, **P.kw)


def reaction_diffusion(P):
    """tests/test_kinetics.py::test_reaction_diffusion_steady_profile."""
    net = P.kin.ReactionNetwork(nu=[[-2, 1]], A=[3.0], T_ref=1.0)
    mesh, prob = _species_prob(P, 12, 2, [P.phys.Species(
        n_species=2, interp="Q2", transient=False, convection=False)],
        {"diffusivity": np.array([1.0, 1.0]),
         "species_source": net.species_source})
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "species", 0, 1.0)
        prob.add_dirichlet(ns, "species", 1, 0.0)
    prob.finalize()
    res = _solve(P, prob, np.full(prob.dofmap.n_dof, 0.5), max_iter=12,
                 tol=1e-10)
    cA = prob.get_nodal_field(_np(res.x), "species", 0)
    cB = prob.get_nodal_field(_np(res.x), "species", 1)
    gate(0 < np.nanmin(cA) < 1.0 and close(cA + 2 * cB, 1.0, 0, 1e-9),
         "reaction-diffusion stoichiometry")
    return _out(res.iters, [np.nanmin(cA)], res.x)


def reversible_equilibrium(P):
    """tests/test_kinetics.py::test_reversible_reaction_equilibrium."""
    Ke = 4.0
    net = P.kin.ReactionNetwork(nu=[[-1, 1]], A=[10.0], K_eq=[Ke], T_ref=1.0)
    mesh, prob = _species_prob(P, 4, 4, [P.phys.Species(
        n_species=2, interp="Q2", transient=False, convection=False)],
        {"diffusivity": np.array([1.0, 1.0]),
         "species_source": net.species_source})
    prob.add_dirichlet("left", "species", 0, 0.2)
    prob.add_dirichlet("left", "species", 1, 0.2 * Ke)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, 1.0)
    res = _solve(P, prob, x0, max_iter=25, tol=1e-10)
    cA = prob.get_nodal_field(_np(res.x), "species", 0)
    cB = prob.get_nodal_field(_np(res.x), "species", 1)
    gate(close(cA, 0.2, 0, 1e-8) and close(cB / cA, Ke, 1e-7),
         "equilibrium ratio")
    return _out(res.iters, [np.nanmean(cA), np.nanmean(cB)], res.x)


def exothermic(P):
    """tests/test_kinetics.py::test_exothermic_heat_release_coupling."""
    net = P.kin.ReactionNetwork(nu=[[-1]], A=[2.0], Ea=[1.0], dH=[-10.0])
    mesh, prob = _species_prob(P, 8, 2, [
        P.phys.Species(n_species=1, interp="Q2", transient=False,
                       convection=False),
        P.phys.Energy(interp="Q2", transient=False, convection=False)],
        {"diffusivity": 1.0, "k": 1.0, "species_source": net.species_source,
         "heat_source": net.heat_source})
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "species", 0, 1.0)
        prob.add_dirichlet(ns, "temperature", 0, 1.0)
    prob.finalize()
    res = _solve(P, prob, np.full(prob.dofmap.n_dof, 1.0), max_iter=15,
                 tol=1e-10)
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    gate(np.nanmax(T) > 1.0 + 1e-3, "no heat release")
    return _out(res.iters, [np.nanmax(T)], res.x)


# tests/test_adaptive_wheeler.py, tests/test_more_physics.py
def _two_delta(w, L):
    return np.array([sum(wi * Li**k for wi, Li in zip(w, L)) for k in range(4)])


def adaptive_closure(P):
    """tests/test_adaptive_wheeler.py::
    test_moment_equations_adaptive_closure_runs: R of the plain and the
    adaptive closure on a realizable uniform state, equal."""
    xp = P.xp
    m_set = _two_delta((0.3, 0.7), (1.0, 3.0))
    Rs = []
    for adaptive in (False, True):
        mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
        prob = P.Problem(mesh, [P.pop.MomentEquations(
            growth=lambda L: 0.5 * xp.ones_like(L), nucleation_rate=0.1,
            L0=0.5, interp="Q1", transient=False, supg=0.0,
            adaptive=adaptive)], {}, **P.kw)
        prob.finalize()
        x = np.zeros(prob.dofmap.n_dof)
        for k in range(4):
            x = prob.set_nodal_field(x, "moments", k, m_set[k])
        Rs.append(_np(prob.assemble(P.arr(x), prob.base_params())[0]))
    gate(np.all(np.isfinite(Rs[1])) and close(Rs[1], Rs[0], 0, 1e-12),
         "adaptive closure differs from the plain one")
    return _out(0, [np.abs(Rs[1]).max()], Rs[1])


def moments_growth(P):
    """tests/test_more_physics.py::test_moments_growth_ode: constant
    growth, Crank-Nicolson to t = 0.5 against the moment cascade."""
    from scipy.integrate import solve_ivp

    xp = P.xp
    G = 0.4
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
    prob = P.Problem(mesh, [P.pop.MomentEquations(
        growth=lambda L: G * xp.ones_like(L), interp="Q1", transient=True,
        supg=0.0)], {}, **P.kw)
    prob.finalize()
    m0 = np.array([1.0, 1.2, 1.6, 2.4])
    x0 = np.zeros(prob.dofmap.n_dof)
    for k in range(4):
        x0 = prob.set_nodal_field(x0, "moments", k, m0[k])
    res = P.TransientSolver(prob, P.NewtonOptions(
        max_iter=8, tol_residual=1e-11, linear_solver="direct"),
        P.TimeOptions(dt0=0.02, t_end=0.5, adapt=False, theta=0.5)).run(
        x0, prob.base_params())
    ref = solve_ivp(lambda t, m: [0.0] + [k * G * m[k - 1] for k in (1, 2, 3)],
                    (0, 0.5), m0, rtol=1e-10, atol=1e-12).y[:, -1]
    got = np.array([np.nanmean(prob.get_nodal_field(_np(res.x), "moments", k))
                    for k in range(4)])
    gate(close(got, ref, 1e-4), "moment cascade")
    return _out(sum(s.newton_iters for s in res.steps), got, res.x)


# tests/test_physics_breadth.py
def sa_decay(P, t_end=SA_T_END):
    """tests/test_physics_breadth.py::test_spalart_allmaras_uniform_decay:
    uniform nu_t, constant wall distance, the destruction ODE under the
    adaptive transient driver, to ``t_end`` (the test's own 0.5 takes
    ~10,000 steps of ~0.05-0.1 s each in the port's generic assembly of
    this 4-element deck, host-bound on either device; cut to SA_T_END),
    held to the scipy integral of the same right-hand side at the time
    reached."""
    from scipy.integrate import solve_ivp

    T = P.turb
    nu, d = 1e-2, 0.5
    mesh = P.mesh.rectangle_mesh(4, 1, elem="QUAD4", xlim=(0, 1.0),
                                 ylim=(0, 0.1))
    prob = P.Problem(mesh, [T.SpalartAllmaras(nu=nu, transient=True,
                                              supg=0.0)],
                     {}, external_fields=("wall_distance",), **P.kw)
    prob.finalize()
    nut0 = 0.05
    x0 = np.full(prob.dofmap.n_dof, nut0)
    params = prob.base_params(ext_wall_distance=P.arr(np.full(mesh.n_nodes,
                                                              d)))

    def rhs(t, y):
        nut = y[0]
        chi = nut / nu
        fv2 = 1 - chi / (1 + chi * T.fv1(chi))
        Stilde = max(nut / (T.KAPPA**2 * d**2) * fv2, 0.0)
        rr = np.clip(nut / (max(Stilde, 1e-10) * T.KAPPA**2 * d**2), 0, 10)
        g = rr + T.CW2 * (rr**6 - rr)
        fw = g * ((1 + T.CW3**6) / (g**6 + T.CW3**6)) ** (1 / 6)
        return [0.1355 * Stilde * nut - T.CW1 * fw * (nut / d) ** 2]

    res = P.TransientSolver(prob, P.NewtonOptions(
        max_iter=8, tol_residual=1e-11, linear_solver="direct"),
        P.TimeOptions(dt0=1e-3, t_end=t_end, adapt=True, eps_time=1e-4,
                      rel_tol=1e-6)).run(x0, params)
    ref = solve_ivp(rhs, (0, res.t), [nut0], rtol=1e-10, atol=1e-12).y[0, -1]
    got = float(np.mean(prob.get_nodal_field(_np(res.x), "turb_nu")))
    gate(close(got, ref, 2e-3), "SA decay")
    return _out(sum(s.newton_iters for s in res.steps), [got, res.t], res.x)


# tests/test_solved_aux_fields.py
def vorticity_direction(P):
    """tests/test_solved_aux_fields.py::test_vorticity_direction_planar_shear:
    u = (y, 0) projected, the solved middle eigenvector e_z and q =
    diag(1, 1, 1/2)."""
    xp = P.xp
    mesh = P.mesh.rectangle_mesh(5, 5, elem="QUAD4")
    prob = P.Problem(mesh, [
        _project(P, "velocity", lambda x: xp.stack([x[:, 1], 0.0 * x[:, 0]],
                                                   1), 2),
        P.susp.VorticityDirection()], {}, **P.kw)
    prob.finalize()
    res = _solve(P, prob, max_iter=10, tol=1e-11)
    vd = np.stack([prob.get_nodal_field(_np(res.x), "vort_dir", a)
                   for a in range(3)], axis=1)
    q = _np(P.susp.qtensor_from_vort_dir(types.SimpleNamespace(
        val={"vort_dir": P.arr(vd)})))
    gate(close(np.abs(vd[:, 2]), 1.0, 0, 1e-9) and close(vd[:, :2], 0.0, 0, 1e-9)
         and close(q[0], np.diag([1.0, 1.0, 0.5]), 0, 1e-9),
         "vorticity direction")
    return _out(res.iters, [vd[:, 2].mean()], res.x)


# tests/test_placid.py
def _langmuir(P, kf=2.0, kr=0.5):
    return P.placid.SurfaceMechanism(nu=[[-1, -1, 1], [1, 1, -1]], A=[kf, kr],
                                     n_gas=1, phases=[("site", 2)],
                                     sden0=[3.0])


def placid_langmuir(P):
    """tests/test_placid.py::test_langmuir_isotherm and
    test_langmuir_vmap_batch: the coverage theta = K c / (1 + K c) at one
    point and along the isotherm (a batch of points), no net gas flux."""
    pl = P.placid
    kf, kr = 2.0, 0.5
    mech = _langmuir(P, kf, kr)
    R = P.kin._UNITS["si"][0]
    T, Pr = 300.0, 101325.0
    Xs = np.concatenate([[0.4], np.linspace(0.05, 0.9, 8)])
    theta = (kf / kr) * Xs * Pr / (R * T) / (1 + (kf / kr) * Xs * Pr / (R * T))
    z, sd = [], []
    for X in Xs:
        zi, si, ci = pl.placid(mech, pl.SFLUX_INITIALIZE, pl.BULK_DEPOSITION,
                               1.0, P.arr([X]), T, Pr, P.arr([0.5, 0.5]))
        gate(bool(ci), "Langmuir point did not converge")
        z.append(_np(zi))
        sd.append(_np(si))
    z, sd = np.array(z), np.array(sd)
    c = Xs[0] * Pr / (R * T)
    gate(close(z[:, 1], theta, 1e-7) and close(z[0, 0], 1 - theta[0], 1e-8)
         and abs(sd[0, 0]) < 1e-10 * kf * c * 3.0, "Langmuir isotherm")
    return _out(0, z[:, 1], np.concatenate([z.ravel(), sd.ravel()]))


def placid_deposition(P):
    """tests/test_placid.py::test_bulk_deposition_fractions and
    test_surface_kinetics_flux_closure: bulk fractions at the
    deposition-rate ratios, and the flux closure at equilibrium."""
    pl = P.placid
    kf, kr, k1, k2 = 5.0, 0.5, 0.3, 0.9
    mech = pl.SurfaceMechanism(
        nu=[[-1, -1, 1, 0, 0], [1, 1, -1, 0, 0], [0, 1, -1, 1, 0],
            [0, 1, -1, 0, 1]], A=[kf, kr, k1, k2], n_gas=1,
        phases=[("site", 2), ("bulk", 2)], sden0=[2.0])
    R = P.kin._UNITS["si"][0]
    T, Pr, X = 300.0, 101325.0, 0.3
    z, sd, conv = pl.placid(mech, pl.SFLUX_INITIALIZE, pl.BULK_DEPOSITION, 1.0,
                            P.arr([X]), T, Pr, P.arr([0.5, 0.5, 0.5, 0.5]))
    z, sd = _np(z), _np(sd)
    Kp = kf * X * Pr / (R * T) / (kr + k1 + k2)
    gate(bool(conv) and close(z[1], Kp / (1 + Kp), 1e-7)
         and close(z[2], k1 / (k1 + k2), 1e-7)
         and close(z[3], k2 / (k1 + k2), 1e-7)
         and close(z[0] + z[1], 1.0, 1e-10), "deposition fractions")
    fl = pl.surface_kinetics_flux(_langmuir(P), species_ids=[0],
                                  time_scale=1.0, pressure=101325.0,
                                  mode=pl.SFLUX_INITIALIZE)
    q = _np(fl(types.SimpleNamespace(val={
        "species": P.arr([[0.4], [0.1]]),
        "temperature": P.arr([[300.0], [300.0]])}), {}, {}))
    gate(q.shape == (2, 1) and np.all(np.abs(q) < 1e-8), "flux closure")
    return _out(0, z, np.concatenate([z, sd, q.ravel()]))


SMALL = {
    "particle_settling": particle_settling,
    "two_way_drag": two_way_drag,
    "reaction_diffusion": reaction_diffusion,
    "reversible_equilibrium": reversible_equilibrium,
    "exothermic": exothermic,
    "adaptive_closure": adaptive_closure,
    "moments_growth": moments_growth,
    "sa_decay": sa_decay,
    "vorticity_direction": vorticity_direction,
    "rans": rans,
    "placid_langmuir": placid_langmuir,
    "placid_deposition": placid_deposition,
}
