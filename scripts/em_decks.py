"""The wave and electrochemical decks, written once for both packages.

Every function here takes a package namespace ``P`` (see ``namespace``):
goma_tpu's modules and ``jax.numpy`` from ``scripts/em_reference.py`` and
the port's tests, the port's modules and ``torch`` from ``chip_smoke.py``.
Material and source callables are written in the operations ``jax.numpy``
and ``torch`` share (``exp``, ``sin``, ``cos``, ``stack(..., 1)``,
``zeros_like``), so one deck is one definition. This module imports
neither package: ``namespace`` imports the one it is given by name.

- ``edge_cavity(P, n)``: the lossy edge-element cavity, ``EMWaveEdge``
  real and imaginary parts (omega 6, mu_m = eps = 1, sigma_em 0.5) on
  [0, 1]^2 meshed ``rectangle_mesh(n, n, elem="QUAD9")``, the source J_re
  = g (1, 0.5), g = exp(-((x - 0.3)^2 + (y - 0.6)^2)/0.005), PEC on all
  four sides (both parts' edge circulations 0).
- ``waveguide(P, nx, ny)``: the lossy nodal waveguide of
  tests/test_em.py's decks, ``EMWave`` real and imaginary parts (omega
  2 pi, sigma_em 0.5, Q2) on [0, 2] x [0, 0.4]: E_y = 1 + 0i on the left,
  E_x = 0 on every side, ``EMAbsorbingBC`` on the right.
- ``SMALL``: goma_tpu's tests' decks of the slice at their own sizes, on
  their own solvers (host ``direct``; the transient one under the
  transient solver), each checking the test's own gate and returning its
  Newton count, its readings and its solution (or residual).
"""

from __future__ import annotations

import importlib
import types

import numpy as np

from scripts.shell_decks import (_direct, _np, _out, _solve, close, gate,
                                 samples)

EDGE_OMEGA = 6.0
WG_OMEGA = 2 * np.pi
SIGMA = 0.5


def namespace(pkg: str, xp, arr, device=None):
    """The namespace the decks read for package ``pkg`` ("goma_tpu" or
    "goma_tpu_torch"): its mesh generators, Problem, the physics modules of
    the slice, ``fem.equations``, the solvers, ``utils.numjac``, the array
    module ``xp``, ``arr`` (a numpy array onto the package's device) and
    the Problem's device keyword."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    solvers, transient = mod("solvers"), mod("solvers.transient")
    return types.SimpleNamespace(
        pkg=pkg, mesh=mod("mesh"), Problem=mod("fem").Problem,
        phys=mod("physics"), em=mod("physics.em"),
        acoustic=mod("physics.acoustic"), electro=mod("physics.electro"),
        flux=mod("physics.species_flux"),
        scalar=mod("physics.scalar_transport"), shell=mod("physics.shell"),
        level_set=mod("physics.level_set"),
        materials=mod("physics.materials"), eqs=mod("fem.equations"),
        numjac=mod("utils.numjac"), NewtonOptions=solvers.NewtonOptions,
        NewtonSolver=solvers.NewtonSolver, TimeOptions=transient.TimeOptions,
        TransientSolver=transient.TransientSolver, xp=xp, arr=arr,
        kw={} if device is None else {"device": device})


def readings(x):
    """||x||_2, max |x| and x at the 24 sampled dofs of a solution."""
    x = _np(x)
    return {"x_norm": float(np.linalg.norm(x)),
            "x_max": float(np.abs(x).max()),
            "x_samples": x[samples(x.size)].tolist()}


# ------------------------------------------------------- the two main decks
def edge_materials(xp):
    """The edge cavity's material dict in the array module ``xp``."""
    def J_re(fv, mat, params):
        x, y = fv.x[:, 0], fv.x[:, 1]
        g = xp.exp(-((x - 0.3) ** 2 + (y - 0.6) ** 2) / 0.005)
        return xp.stack([g, 0.5 * g], 1)

    return {"mu_m": 1.0, "eps": 1.0, "sigma_em": SIGMA, "J_re": J_re}


def edge_cavity(P, n):
    """The lossy edge-element cavity (see the module docstring),
    finalized, unsolved."""
    em = P.em
    mesh = P.mesh.rectangle_mesh(n, n, elem="QUAD9", xlim=(0, 1), ylim=(0, 1))
    prob = P.Problem(mesh, [em.EMWaveEdge("real", omega=EDGE_OMEGA),
                            em.EMWaveEdge("imag", omega=EDGE_OMEGA)],
                     edge_materials(P.xp), **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        for var in (em.EDGE_RE, em.EDGE_IM):
            prob.add_dirichlet(ns, var, 0, 0.0)
    prob.finalize()
    return prob


def waveguide(P, nx, ny):
    """The lossy nodal waveguide (see the module docstring), finalized,
    unsolved."""
    em = P.em
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, 0.4))
    prob = P.Problem(mesh, [em.EMWave("real", omega=WG_OMEGA, dim=2),
                            em.EMWave("imag", omega=WG_OMEGA, dim=2)],
                     {"mu_m": 1.0, "eps": 1.0, "sigma_em": SIGMA}, **P.kw)
    prob.add_dirichlet("left", em.E_RE, 1, 1.0)
    prob.add_dirichlet("left", em.E_IM, 1, 0.0)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, em.E_RE, 0, 0.0)
        prob.add_dirichlet(ns, em.E_IM, 0, 0.0)
    for part in ("real", "imag"):
        prob.add_face_kernel("right", em.EMAbsorbingBC(part, omega=WG_OMEGA,
                                                       dim=2))
    prob.finalize()
    return prob


# -------------------------------------------------------------- small decks
# (scripts/shell_decks.py's helpers: ``_solve`` runs the host direct rung,
# default tolerance 1e-11; the decks pass their tests' own)
def _residual(P, prob, x0, params=None):
    return _np(prob.residual(P.arr(x0), params or prob.base_params()))


def _all_nodes(mesh, name="all"):
    mesh.nodesets[name] = np.arange(mesh.n_nodes, dtype=np.int32)


# tests/test_em.py
def _plane_wave(P, H, lossy):
    em = P.em
    k = 2 * np.pi
    if lossy:
        mesh = P.mesh.rectangle_mesh(40, 4, elem="QUAD9", xlim=(0, 2.0),
                                     ylim=(0, 0.5))
    else:
        mesh = P.mesh.rectangle_mesh(32, 6, elem="QUAD9", xlim=(0, 2.0),
                                     ylim=(0, 0.75))
    Eq, Bc = (em.EMWaveH, em.EMAbsorbingBCH) if H else (em.EMWave,
                                                        em.EMAbsorbingBC)
    RE, IM = (em.H_RE, em.H_IM) if H else (em.E_RE, em.E_IM)
    mat = {"mu_m": 1.0, "eps": 1.0}
    if lossy:
        mat["sigma_em"] = 1.0
    prob = P.Problem(mesh, [Eq("real", omega=k, dim=2),
                            Eq("imag", omega=k, dim=2)], mat, **P.kw)
    prob.add_dirichlet("left", RE, 1, 1.0)
    prob.add_dirichlet("left", IM, 1, 0.0)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, RE, 0, 0.0)
        prob.add_dirichlet(ns, IM, 0, 0.0)
    for part in ("real", "imag"):
        prob.add_face_kernel("right", Bc(part, omega=k, dim=2))
    prob.finalize()
    res = _solve(P, prob, tol=1e-10)
    gate(res.iters <= 2 or lossy, "more than one Newton step")
    re = prob.get_nodal_field(res.x, RE, 1)
    im = prob.get_nodal_field(res.x, IM, 1)
    c = mesh.coords
    mask = ~np.isnan(re)
    if lossy:
        kc = k * np.sqrt(1 - 1j / k)
        kc = kc if kc.imag < 0 else -kc
        err = np.max(np.abs(re[mask] + 1j * im[mask]
                            - np.exp(-1j * kc * c[mask, 0])))
        gate(err < (0.12 if H else 0.08), f"lossy decay error {err}")
        return _out(res.iters, [err], res.x)
    err_re = np.nanmax(np.abs(re - np.cos(k * c[:, 0])))
    err_im = np.nanmax(np.abs(im + np.sin(k * c[:, 0])))
    amp = np.sqrt(re[mask] ** 2 + im[mask] ** 2)
    gate(err_re < 0.03 and err_im < 0.03 and close(amp, 1.0, 0, 0.03),
         f"plane wave errors {err_re} {err_im}")
    return _out(res.iters, [err_re, err_im], res.x)


def em_plane_wave(P):
    """tests/test_em.py::test_em_plane_wave_absorbing."""
    return _plane_wave(P, H=False, lossy=False)


def em_lossy_decay(P):
    """tests/test_em.py::test_em_lossy_decay."""
    return _plane_wave(P, H=False, lossy=True)


def em_h_plane_wave(P):
    """tests/test_em.py::test_em_h_plane_wave_absorbing."""
    return _plane_wave(P, H=True, lossy=False)


def em_h_lossy_decay(P):
    """tests/test_em.py::test_em_h_lossy_decay."""
    return _plane_wave(P, H=True, lossy=True)


# tests/test_em_edge.py
def _exact_circulations(P, mesh, Efun, family):
    """Exact int E . t dl per edge (5-point Gauss), keyed by the midside
    node that carries the edge's dof; the global direction is low -> high
    node id."""
    shapes = importlib.import_module(f"{P.pkg}.elements.shapes")
    conn = mesh.blocks[0].conn
    edges = {}
    for (c0, c1), m in zip(shapes.NEDELEC_EDGE_CORNERS[family],
                           shapes.interp_local_nodes(family, "N1")):
        for e in range(conn.shape[0]):
            a, b = int(conn[e, c0]), int(conn[e, c1])
            edges[int(conn[e, m])] = (min(a, b), max(a, b))
    gp, gw = np.polynomial.legendre.leggauss(5)
    circ = {}
    for mid, (n0, n1) in edges.items():
        p0, p1 = mesh.coords[n0], mesh.coords[n1]
        t = p1 - p0
        pts = p0[None, :] + (gp[:, None] + 1) / 2 * t[None, :]
        circ[mid] = float(np.sum(gw / 2 * (Efun(pts) @ t)))
    return circ


def _edge_solve(P, mesh, source, pec, dim=2, tol=1e-12):
    em = P.em
    prob = P.Problem(mesh, [em.EMWaveEdge("real", omega=1.0, dim=dim)],
                     {"mu_m": 1.0, "eps": 1.0, "J_im": source}, **P.kw)
    if pec:
        sides = ("left", "right", "top", "bottom") + (
            ("front", "back") if dim == 3 else ())
        for ns in sides:
            prob.add_dirichlet(ns, em.EDGE_RE, 0, 0.0)
    prob.finalize()
    res = _solve(P, prob, tol=tol)
    gate(res.iters <= 2, "more than one Newton step")
    return prob, res


def _edge_error(P, prob, res, mesh, Efun, family):
    got = prob.get_nodal_field(res.x, prob.equations[0][0].var, 0)
    exact = _exact_circulations(P, mesh, Efun, family)
    mids = np.array(sorted(exact))
    e = np.array([exact[m] for m in mids])
    return float(np.linalg.norm(got[mids] - e) / np.linalg.norm(e))


def edge_constant_patch(P):
    """tests/test_em_edge.py::test_edge_constant_patch."""
    E0 = np.array([0.3, -0.7])
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9", xlim=(0, 1), ylim=(0, 1))
    prob, res = _edge_solve(P, mesh, tuple(-E0), pec=False)
    got = prob.get_nodal_field(res.x, P.em.EDGE_RE, 0)
    exact = _exact_circulations(
        P, mesh, lambda p: np.broadcast_to(E0, (len(p), 2)), "quad")
    err = max(abs(got[m] - c) for m, c in exact.items())
    gate(err < 1e-9, f"patch error {err}")
    return _out(res.iters, [np.linalg.norm(res.x)], res.x)


def _te_mode(P, n, elem):
    xp = P.xp
    k2 = 2 * np.pi ** 2

    def Efun(p):
        x, y = p[:, 0], p[:, 1]
        return np.stack([-np.pi * np.cos(np.pi * x) * np.sin(np.pi * y),
                         np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)], 1)

    def source(fv, mat, params):
        x, y = fv.x[:, 0], fv.x[:, 1]
        return (k2 - 1.0) * xp.stack(
            [-np.pi * xp.cos(np.pi * x) * xp.sin(np.pi * y),
             np.pi * xp.sin(np.pi * x) * xp.cos(np.pi * y)], 1)

    mesh = P.mesh.rectangle_mesh(n, n, elem=elem, xlim=(0, 1), ylim=(0, 1))
    prob, res = _edge_solve(P, mesh, source, pec=True)
    fam = "tri" if elem.startswith("TRI") else "quad"
    return _edge_error(P, prob, res, mesh, Efun, fam), res


def _te_convergence(P, elem, bound):
    e8, _ = _te_mode(P, 8, elem)
    e16, res = _te_mode(P, 16, elem)
    gate(e16 < bound and e8 / e16 > 1.7, f"TE(1,1) errors {e8} {e16}")
    return _out(res.iters, [e8, e16], res.x)


def edge_te_mode(P):
    """tests/test_em_edge.py::test_edge_te_mode_convergence."""
    return _te_convergence(P, "QUAD9", 0.05)


def edge_te_mode_tri(P):
    """tests/test_em_edge.py::test_edge_te_mode_tri_whitney (edge signs)."""
    return _te_convergence(P, "TRI6", 0.06)


def edge_hex(P):
    """tests/test_em_edge.py::test_edge_hex_3d_manufactured."""
    xp = P.xp

    def source(fv, mat, params):
        Ez = xp.sin(np.pi * fv.x[:, 0]) * xp.sin(np.pi * fv.x[:, 1])
        z = xp.zeros_like(Ez)
        return (2 * np.pi ** 2 - 1.0) * xp.stack([z, z, Ez], 1)

    def Efun(p):
        Ez = np.sin(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1])
        return np.stack([0 * Ez, 0 * Ez, Ez], axis=1)

    errs = []
    for n in (4, 8):
        mesh = P.mesh.box_mesh(n, n, n, elem="HEX27")
        prob, res = _edge_solve(P, mesh, source, pec=True, dim=3, tol=1e-11)
        errs.append(_edge_error(P, prob, res, mesh, Efun, "hex"))
    gate(errs[1] < 0.06 and errs[0] / errs[1] > 1.7, f"hex errors {errs}")
    return _out(res.iters, errs, res.x)


# tests/test_acoustic_bc.py
def acoustic_piston(P):
    """tests/test_acoustic_bc.py::test_acoustic_velocity_piston."""
    ac = P.acoustic
    k, v, L = 2 * np.pi, 0.7, 2.0
    mesh = P.mesh.rectangle_mesh(40, 3, elem="QUAD9", xlim=(0, L),
                                 ylim=(0, 0.3))
    prob = P.Problem(mesh, [ac.AcousticHelmholtz("real", k),
                            ac.AcousticHelmholtz("imag", k)], {}, **P.kw)
    for part in ("real", "imag"):
        prob.add_face_kernel("left", ac.AcousticVelocityBC(part, v))
        prob.add_face_kernel("right", ac.SommerfeldBC(part, k))
    prob.finalize()
    res = _solve(P, prob, tol=1e-10)
    pr = prob.get_nodal_field(res.x, ac.APR, 0)
    pi = prob.get_nodal_field(res.x, ac.API, 0)
    A = -v * (1 + 1j) / k
    exact = A * np.exp(-1j * k * mesh.coords[:, 0])
    err = max(np.abs(pr - exact.real).max(), np.abs(pi - exact.imag).max())
    gate(err <= 0.02 * abs(A), f"piston error {err}")
    return _out(res.iters, [err], res.x)


def ls_acoustic_radiation(P):
    """tests/test_acoustic_bc.py::test_ls_acoustic_radiation_total_force
    (the residual at a prescribed state)."""
    ac, ls = P.acoustic, P.level_set
    P0, omega, ars = 2.0, 3.0, 0.8
    mesh = P.mesh.rectangle_mesh(8, 4, elem="QUAD9")
    _all_nodes(mesh)
    eqs = [P.phys.Momentum(dim=2, interp="Q2", transient=False),
           P.phys.Continuity(interp="Q1"),
           ls.FillEquation(interp="Q2", supg=0.0, transient=False),
           ac.AcousticHelmholtz("real", 1.0), ac.AcousticHelmholtz("imag", 1.0),
           ac.LSAcousticRadiation(dim=2, omega=omega, ars_jump=ars)]
    prob = P.Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.add_dirichlet("all", ls.FILL_VAR, 0, lambda c: c[:, 0] - 0.5)
    prob.add_dirichlet("all", ac.APR, 0, P0)
    prob.add_dirichlet("all", ac.API, 0, 0.0)
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    x0 = prob.set_nodal_field(x0, ls.FILL_VAR, 0, mesh.coords[:, 0] - 0.5)
    x0 = prob.set_nodal_field(x0, ac.APR, 0, P0)
    R = _residual(P, prob, x0, prob.base_params(ls_eps=P.arr(0.15)))
    dm = prob.dofmap
    du = dm.dof_of_node_svar[:, dm.svar("velocity", 0)]
    tot = R[du[du >= 0]].sum()
    f_exact = ars * P0 ** 2 / (4 * omega)
    gate(close(-tot, f_exact, 5e-3), f"radiation force {-tot} {f_exact}")
    return _out(0, [-tot], R)


# tests/test_electrode_ni.py
F_NI, R_NI = 96487.0, 8.314
_NI_STATE = ((0, 0.05), (1, 0.9), (2, 1e-3), (3, 1e-3), (4, 1e-3))


def _Q4(x_ni, ct, PHI_E, Phi_S, T):
    d = 2 * F_NI / (R_NI * T) * (PHI_E - Phi_S + 0.2363)
    return (1.07e-05 / (2 * F_NI)) * (
        np.exp(-0.21 * d) * ct * x_ni / 0.001 - np.exp(0.79 * d))


def ni_deposition_balance(P):
    """tests/test_electrode_ni.py::test_ni_deposition_diffusion_balance."""
    from scipy.optimize import brentq

    D, L, x_bulk, ct, PHI_E, T = 1e-4, 1.0, 0.05, 55.0, -0.45, 298.15
    mesh = P.mesh.rectangle_mesh(10, 2, elem="QUAD9", xlim=(0, L),
                                 ylim=(0, 0.2))
    prob = P.Problem(mesh, [P.phys.Species(5, interp="Q2", transient=False,
                                           convection=False),
                            P.electro.Potential()], {"diffusivity": D}, **P.kw)
    for comp, val in _NI_STATE:
        prob.add_dirichlet("left", "species", comp, val)
    prob.add_dirichlet("left", "voltage", 0, 0.0)
    prob.add_dirichlet("right", "voltage", 0, 0.0)
    prob.add_face_kernel("right", P.electro.NickelPlatingFlux(
        mode=0, PHI_E=PHI_E, T=T, c_total=ct, ncomp=5))
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    for comp, val in _NI_STATE:
        x0 = prob.set_nodal_field(x0, "species", comp, val)
    res = _solve(P, prob, x0, max_iter=25, tol=1e-12)
    c = prob.get_nodal_field(res.x, "species", 0)
    xs = c[np.isclose(mesh.coords[:, 0], L)].mean()
    mid = c[np.isclose(mesh.coords[:, 0], 0.5)].mean()
    xs_ex = brentq(lambda x: D * (x_bulk - x) / L - _Q4(x, ct, PHI_E, 0.0, T),
                   0.0, x_bulk)
    gate(close(xs, xs_ex, 1e-6) and close(mid, 0.5 * (x_bulk + xs), 1e-6),
         f"surface fraction {xs} {xs_ex}")
    return _out(res.iters, [xs, mid], res.x)


def ni_current_total(P):
    """tests/test_electrode_ni.py::test_ni_current_mode_total."""
    ct, PHI_E, T = 55.0, -0.3, 298.15
    st = ((0, 0.04), (1, 0.95), (2, 2e-3), (3, 1e-3), (4, 5e-4))
    mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Species(5, interp="Q2", transient=False,
                                           convection=False),
                            P.electro.Potential()], {"diffusivity": 1.0},
                     **P.kw)
    _all_nodes(mesh)
    for comp, val in st:
        prob.add_dirichlet("all", "species", comp, val)
    mesh.nodesets["notright"] = np.where(
        mesh.coords[:, 0] < 1.0 - 1e-9)[0].astype(np.int32)
    prob.add_dirichlet("notright", "voltage", 0, 0.0)
    prob.add_face_kernel("right", P.electro.NickelPlatingFlux(
        mode="current", PHI_E=PHI_E, T=T, c_total=ct, ncomp=5))
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    for comp, val in st:
        x0 = prob.set_nodal_field(x0, "species", comp, val)
    R = _residual(P, prob, x0)
    dm = prob.dofmap
    dv = dm.dof_of_node_svar[:, dm.svar("voltage", 0)]
    tot = R[dv[dv >= 0]].sum()
    FRT = F_NI / (R_NI * T)
    Q1 = (0.289 / F_NI) * np.exp(-0.11 * FRT * PHI_E) * ct * 2e-3 / 0.001
    Q2 = (8.80e-09 / F_NI) * np.exp(-0.4 * FRT * (PHI_E + 0.8280))
    d3 = 2 * FRT * (PHI_E + 0.3648)
    Q3 = (1.34 / (2 * F_NI)) * (ct / 0.001) * (
        np.exp(-0.33 * d3) * 5e-4 - np.exp(0.67 * d3) * 1e-3)
    i_exact = Q1 + Q2 + 2 * Q3 + 2 * _Q4(0.04, ct, PHI_E, 0.0, T)
    gate(close(tot, i_exact, 1e-9), f"current {tot} {i_exact}")
    return _out(0, [tot], R)


def current_sic(P):
    """tests/test_electrode_ni.py::test_current_sic_linear_conductor."""
    V0, i0, perm, L = 2.0, 0.6, 1.5, 1.0
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9", xlim=(0, L),
                                 ylim=(0, 0.2))
    prob = P.Problem(mesh, [P.electro.Potential()], {"permittivity": perm},
                     **P.kw)
    prob.add_dirichlet("left", "voltage", 0, V0)
    prob.add_face_kernel("right", P.electro.CurrentSIC(i_app=i0, perm=perm))
    prob.finalize()
    res = _solve(P, prob, max_iter=5, tol=1e-10)
    V = prob.get_nodal_field(res.x, "voltage", 0)
    m = np.isfinite(V)
    gate(close(V[m], V0 - (i0 / perm) * mesh.coords[m, 0], 0, 1e-6),
         "potential not linear")
    return _out(res.iters, [V[m].min()], res.x)


def alloy_evaporation(P):
    """tests/test_electrode_ni.py::test_alloy_evaporation_flux."""
    Tm, c0, c1, c2, c3 = 1.0, -2.0, 1.3, 0.4, 0.05
    y_inf, D = 0.1, 1.0
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.2))
    _all_nodes(mesh)
    eqs = [P.phys.Species(1, interp="Q2", transient=False, convection=False),
           P.phys.Energy(interp="Q2", transient=False, convection=False)]
    prob = P.Problem(mesh, eqs, {"diffusivity": D, "rho": 1, "Cp": 1, "k": 1},
                     **P.kw)
    prob.add_dirichlet("all", "temperature", 0, lambda c: 1.0 + 0.5 * c[:, 0])
    prob.add_dirichlet("left", "species", 0, 0.8)
    prob.add_face_kernel("right", P.electro.AlloyEvapFlux(
        Tm, c0, c1, c2, c3, y_inf))
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, 0.8)
    res = _solve(P, prob, x0, max_iter=10, tol=1e-12)
    y = prob.get_nodal_field(res.x, "species", 0)
    ys = y[np.isclose(mesh.coords[:, 0], 1.0)].mean()
    dT = 1.5 - Tm
    k = np.exp(c0 + c1 * dT - c2 * dT ** 2 + c3 * dT ** 3)
    ys_ex = (D * 0.8 + k * y_inf) / (D + k)
    gate(close(ys, ys_ex, 1e-7), f"surface fraction {ys} {ys_ex}")
    return _out(res.iters, [ys], res.x)


def surface_charge(P):
    """tests/test_electrode_ni.py::test_surface_charge_constraint."""
    z = (1.0, -2.0)
    mesh = P.mesh.rectangle_mesh(6, 2, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.2))
    prob = P.Problem(mesh, [P.phys.Species(2, interp="Q2", transient=False,
                                           convection=False)],
                     {"diffusivity": 1.0}, **P.kw)
    prob.add_dirichlet("left", "species", 0, 0.4)
    prob.add_dirichlet("left", "species", 1, 0.1)
    rn = mesh.nodesets["right"]
    prob.add_point_constraint("right", "species", 1,
                              P.electro.surface_charge_constraint(z, 0.0, 1))
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, 0.4)
    x0 = prob.set_nodal_field(x0, "species", 1, 0.1)
    res = _solve(P, prob, x0, max_iter=8, tol=1e-11)
    c0 = prob.get_nodal_field(res.x, "species", 0)
    c1 = prob.get_nodal_field(res.x, "species", 1)
    gate(close(z[0] * c0[rn] + z[1] * c1[rn], 0.0, 0, 1e-10),
         "surface charge not neutral")
    return _out(res.iters, [c0[rn].mean()], res.x)


def electrodeposition_velocity(P):
    """tests/test_electrode_ni.py::test_electrodeposition_velocity_closure
    (the closure at a prescribed state, no Problem)."""
    ct, PHI_E, T, Vm = 55.0, -0.4, 298.15, 6.59
    x_ni, x_h, x_oh, x_nioh = 0.03, 1e-3, 2e-3, 8e-4
    sfv = types.SimpleNamespace(
        x=P.arr(np.zeros((3, 2))),
        val={"species": P.arr(np.tile([[x_ni, 0.95, x_h, x_oh, x_nioh]],
                                      (3, 1))),
             "voltage": P.arr(np.zeros((3, 1)))})
    v = _np(P.electro.electrodeposition_velocity(PHI_E, T, Vm, c_total=ct)(
        sfv, {}, {}))
    d3 = 2 * F_NI / (R_NI * T) * (PHI_E + 0.3648)
    Q3 = (1.34 / (2 * F_NI)) * (ct / 0.001) * (
        np.exp(-0.33 * d3) * x_nioh - np.exp(0.67 * d3) * x_oh)
    exact = Vm * (Q3 + _Q4(x_ni, ct, PHI_E, 0.0, T))
    gate(close(v, exact, 1e-12), f"deposition velocity {v} {exact}")
    return _out(0, v[:1], v)


def _with_without(P, build):
    """R with a face kernel minus R without it at the deck's state
    (``build(P, with_kernel) -> (problem, x0)``)."""
    p1, x1 = build(P, True)
    p0, x0 = build(P, False)
    return _residual(P, p1, x1) - _residual(P, p0, x0), p1


def pem_water(P):
    """tests/test_electrode_ni.py::test_pem_water_flux_values."""
    ai0, Ha, cref, aa, ac, T, U0, nd, V = (
        1.2e3, 1e-3, 4e-5, 0.5, 0.5, 353.0, 0.0, 1.2, 0.7)
    c0, phi0 = 2.5e-5, 0.12
    out = []
    for side in ("anode", "cathode"):
        def build(P, with_kernel):
            mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD9")
            _all_nodes(mesh, "alln")
            mesh.nodesets["notright"] = np.where(
                mesh.coords[:, 0] < 1.0 - 1e-9)[0].astype(np.int32)
            prob = P.Problem(mesh, [
                P.phys.Species(1, interp="Q2", transient=False,
                               convection=False),
                P.eqs.PassiveVar("voltage", 1, "Q2", reg=1e-10)],
                {"diffusivity": 1.0}, **P.kw)
            prob.add_dirichlet("notright", "species", 0, c0)
            prob.add_dirichlet("alln", "voltage", 0, phi0)
            if with_kernel:
                prob.add_face_kernel("right", P.electro.PEMWaterFlux(
                    side, ai0, Ha, cref, aa, ac, T, U0, nd, V=V))
            prob.finalize()
            x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof),
                                      "species", 0, c0)
            return prob, prob.set_nodal_field(x0, "voltage", 0, phi0)

        dR, prob = _with_without(P, build)
        dm = prob.dofmap
        dS = dm.dof_of_node_svar[:, dm.svar("species", 0)]
        tot = dR[dS[dS >= 0]].sum()
        if side == "anode":
            q = -ai0 * Ha * np.sqrt(c0 / cref) * 0.5 * (aa + ac) \
                * (phi0 + U0) / (8.314 * T) * nd
        else:
            grp = ac * 96487.0 / (8.314 * T) * (V - phi0 - U0)
            q = -(nd + 2.0) * (ai0 * Ha / (4 * 96487.0)) * (c0 / cref) \
                * np.exp(-grp)
        gate(close(tot, -q, 1e-10), f"{side} flux {tot} {-q}")
        out.append((tot, dR))
    return _out(0, [t for t, _ in out], np.concatenate([d for _, d in out]))


def koh_etch(P):
    """tests/test_electrode_ni.py::test_koh_etch_flux_values."""
    T, rho_H2O, rho_KOH = 353.0, 0.9, 5e-4
    vals = (rho_H2O, rho_KOH, 1e-5, 1e-5)
    R_rate = float(_np(P.flux.koh_si_etch_rate_100(
        P.arr(rho_H2O), P.arr(rho_KOH), T)))
    rho_si, mw_si = 2.3290, 28.0855
    mws = (18.01528, 17.008, 2 * 1.00794, 28.0855 + 2 * 15.9994 + 2 * 17.008)
    st = (2.0, 2.0, -2.0, -1.0)
    tots, dRs = [], []
    for comp in range(4):
        def build(P, with_kernel):
            mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD9")
            mesh.nodesets["nr2"] = np.where(
                mesh.coords[:, 0] < 1.0 - 1e-9)[0].astype(np.int32)
            prob = P.Problem(mesh, [P.phys.Species(
                4, interp="Q2", transient=False, convection=False)],
                {"diffusivity": 1.0}, **P.kw)
            for k, v in enumerate(vals):
                prob.add_dirichlet("nr2", "species", k, v)
            if with_kernel:
                prob.add_face_kernel("right", P.flux.KOHSiEtchFlux(comp, T))
            prob.finalize()
            x0 = np.zeros(prob.dofmap.n_dof)
            for k, v in enumerate(vals):
                x0 = prob.set_nodal_field(x0, "species", k, v)
            return prob, x0

        dR, prob = _with_without(P, build)
        dm = prob.dofmap
        dS = dm.dof_of_node_svar[:, dm.svar("species", comp)]
        tot = dR[dS[dS >= 0]].sum()
        q = st[comp] * rho_si / mw_si * mws[comp] * R_rate
        gate(close(tot, q, 1e-10), f"etch flux {comp}: {tot} {q}")
        tots.append(tot)
        dRs.append(dR)
    return _out(0, tots, np.concatenate(dRs))


def charged_surface_gradient(P):
    """tests/test_electrode_ni.py::test_charged_surface_gradient_pin."""
    D, z, T, q0, dVdx = 0.5, 2.0, 298.15, 0.01, -0.002
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.2))
    _all_nodes(mesh, "all3")
    prob = P.Problem(mesh, [
        P.phys.Species(1, interp="Q2", transient=False, convection=False),
        P.eqs.PassiveVar("voltage", 1, "Q2", reg=1e-10)],
        {"diffusivity": D}, **P.kw)
    prob.add_dirichlet("left", "species", 0, 0.3)
    prob.add_dirichlet("all3", "voltage", 0, lambda c: dVdx * c[:, 0])
    prob.add_face_kernel("right", P.flux.ChargedSurfaceGradient(
        value=q0, z=z, T=T, penalty=1e6))
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, 0.3)
    x0 = prob.set_nodal_field(x0, "voltage", 0, dVdx * mesh.coords[:, 0])
    res = _solve(P, prob, x0, max_iter=10, tol=1e-11)
    c = prob.get_nodal_field(res.x, "species", 0)
    xs = mesh.coords[:, 0]
    row = np.isclose(mesh.coords[:, 1], 0.1)
    o = np.argsort(xs[row])
    cr, xr = c[row][o], xs[row][o]
    dcdx = (3 * cr[-1] - 4 * cr[-2] + cr[-3]) / (xr[-1] - xr[-3])
    flux = -D * dcdx - D * z * cr[-1] * 96487.0 / (8.314 * T) * dVdx
    gate(close(flux, q0, 5e-4), f"pinned flux {flux}")
    return _out(res.iters, [flux], res.x)


# tests/test_species_flux.py
_SM3 = [[0.0, 1.0, 2.0], [1.0, 0.0, 0.5], [2.0, 0.5, 0.0]]


def binary_stefan_maxwell(P):
    """tests/test_species_flux.py::test_binary_stefan_maxwell_is_fickian."""
    mesh = P.mesh.rectangle_mesh(6, 2, elem="QUAD4")
    prob = P.Problem(mesh, [P.flux.StefanMaxwellSpecies(
        1, D=[[0.0, 0.7], [0.7, 0.0]], c_total=2.0, transient=False,
        convection=False)], {}, **P.kw)
    prob.add_dirichlet("left", "species", 0, 0.2)
    prob.add_dirichlet("right", "species", 0, 0.6)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, 0.4)
    res = _solve(P, prob, x0, max_iter=8, tol=1e-11)
    Y = prob.get_nodal_field(res.x, "species", 0)
    gate(close(Y, 0.2 + 0.4 * mesh.coords[:, 0], 0, 1e-9), "not linear")
    return _out(res.iters, [Y.mean()], res.x)


def ternary_sm_relations(P):
    """tests/test_species_flux.py::test_ternary_sm_fluxes_satisfy_relations
    (the pointwise flux solve alone)."""
    eq = P.flux.StefanMaxwellSpecies(2, D=_SM3, c_total=1.5)
    x = np.array([[0.3, 0.5, 0.2]])
    gx = np.array([[[0.1, -0.2], [0.05, 0.3], [-0.15, -0.1]]])
    J = _np(eq._fluxes(P.arr(x), P.arr(gx)))[0]
    Dm = np.array(_SM3) + np.diag([np.inf] * 3)
    ok = close(J.sum(axis=0), 0.0, 0, 1e-12)
    for i in range(2):
        rhs = sum((x[0, i] * J[j] - x[0, j] * J[i]) / (1.5 * Dm[i, j])
                  for j in range(3) if j != i)
        ok = ok and close(gx[0, i], rhs, 0, 1e-12)
    gate(ok, "Stefan-Maxwell relations")
    return _out(0, J.ravel()[:2], J)


def _linear(a, b):
    return lambda X: a + b * X[:, 0]


def generalized_fickian(P):
    """tests/test_species_flux.py::test_generalized_fickian_cross_diffusion."""
    mesh = P.mesh.rectangle_mesh(4, 3, elem="QUAD4")
    prob = P.Problem(mesh, [P.flux.GeneralizedFickianSpecies(
        2, D=[[1.0, 0.3], [0.1, 0.5]], transient=False, convection=False)],
        {}, **P.kw)
    lin = ((0.1, 0.5), (0.9, -0.4))
    for w, (a, b) in enumerate(lin):
        for ns, val in (("left", a), ("right", a + b)):
            prob.add_dirichlet(ns, "species", w, val)
        for ns in ("bottom", "top"):
            prob.add_dirichlet(ns, "species", w, _linear(a, b))
    prob.finalize()
    res = _solve(P, prob, max_iter=6, tol=1e-11)
    for w, (a, b) in enumerate(lin):
        Y = prob.get_nodal_field(res.x, "species", w)
        gate(close(Y, a + b * mesh.coords[:, 0], 0, 1e-9), "not linear")
    return _out(res.iters, [np.linalg.norm(res.x)], res.x)


def _phillips(P, Kc=0.41, Kmu=0.62):
    mesh = P.mesh.rectangle_mesh(2, 12, elem="QUAD4")

    def gd_source(fv, mat, params):
        return (1.0 + 2.0 * fv.x[:, 1])[:, None]

    prob = P.Problem(mesh, [
        P.flux.HydroSpecies(Kc=Kc, Kmu=Kmu, mu0=1.0, maxpack=0.68,
                            nexp=-1.82, convection=False),
        P.acoustic.ProjectionEquation("shear_rate", 1, gd_source,
                                      interp="Q1")], {}, **P.kw)
    prob.finalize()
    return mesh, prob


def phillips_migration(P):
    """tests/test_species_flux.py::test_phillips_migration_steady_invariant
    (backward-Euler steps of the adaptive transient driver to t = 60)."""
    Kc, Kmu = 0.41, 0.62
    mesh, prob = _phillips(P, Kc, Kmu)
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, 0.3)
    x0 = prob.set_nodal_field(x0, "shear_rate", 0,
                              lambda X: 1.0 + 2.0 * X[:, 1])
    ts = P.TransientSolver(prob, _direct(P, 10, 1e-10), P.TimeOptions(
        dt0=0.05, t_end=60.0, adapt=True, max_dt=8.0, theta=0.0))
    r = ts.run(x0, prob.base_params())
    Y = prob.get_nodal_field(r.x, "species", 0)
    gd = 1.0 + 2.0 * mesh.coords[:, 1]
    mu_rel = np.maximum(1.0 - Y / 0.68, 1e-2) ** (-1.82)
    inv = gd * Y * mu_rel ** (Kmu / Kc)
    gate(inv.std() / inv.mean() < 0.02 and abs(Y.mean() - 0.3) < 5e-3,
         f"Phillips invariant {inv.std() / inv.mean()}")
    return _out(sum(s.newton_iters for s in r.steps),
                [inv.std() / inv.mean(), len(r.steps)], r.x)


def species_flux_numjac(P):
    """tests/test_species_flux.py::test_species_flux_jacobians_match_fd
    (the AD Jacobian against central differences on 12 columns)."""
    rng = np.random.RandomState(3)
    mesh, prob = _phillips(P)
    x = np.zeros(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "species", 0,
                             0.25 + 0.1 * rng.rand(mesh.n_nodes))
    x = prob.set_nodal_field(x, "shear_rate", 0, 1.0 + rng.rand(mesh.n_nodes))
    chk = P.numjac.numerical_jacobian_check(prob, x, prob.base_params(),
                                            n_columns=12)
    gate(chk.ok, chk.report())
    mesh2 = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
    prob2 = P.Problem(mesh2, [P.flux.StefanMaxwellSpecies(
        2, D=_SM3, transient=False, convection=False)], {}, **P.kw)
    prob2.add_dirichlet("left", "species", 0, 0.3)
    prob2.finalize()
    x2 = np.zeros(prob2.dofmap.n_dof)
    x2 = prob2.set_nodal_field(x2, "species", 0,
                               0.3 + 0.05 * rng.rand(mesh2.n_nodes))
    x2 = prob2.set_nodal_field(x2, "species", 1,
                               0.4 + 0.05 * rng.rand(mesh2.n_nodes))
    chk2 = P.numjac.numerical_jacobian_check(prob2, x2, prob2.base_params(),
                                             n_columns=12)
    gate(chk2.ok, chk2.report())
    n = [chk.n_checked, chk2.n_checked]
    return _out(0, n, np.array(n + [chk.n_bad, chk2.n_bad], dtype=float))


# tests/test_solved_aux_fields.py, tests/test_bc_catalog3.py,
# tests/test_shell_rheo.py
def _project(P, var, fn, ncomp):
    """tests/test_ext_velocity.py's ``Project``: R = (u - u_ex(x)) phi."""
    class Project(P.eqs.Equation):
        def residual(self, fv, mat, params):
            u = fv.val[self.var]
            return (u - fn(fv.x))[:, :, None] * fv.phi[self.var][:, None, :]

    return Project(var, ncomp, "Q1")


def bond_equilibrium(P):
    """tests/test_solved_aux_fields.py::test_bond_evolution_shear_equilibrium."""
    xp = P.xp
    gd0, k1, k2, n0, a, b = 2.0, 1.5, 0.8, 1.0, 1.2, 0.7
    mesh = P.mesh.rectangle_mesh(6, 6, elem="QUAD4")
    prob = P.Problem(mesh, [
        _project(P, "velocity", lambda x: xp.stack(
            [gd0 * x[:, 1], 0.0 * x[:, 0]], 1), 2),
        P.scalar.BondEvolution(k1, k2, n0, aexp=a, bexp=b, transient=False)],
        {}, **P.kw)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "bond", 0, 0.5)
    res = _solve(P, prob, x0, max_iter=15, tol=1e-11)
    nn = prob.get_nodal_field(res.x, "bond", 0)
    nn_eq = k2 * gd0 ** b * n0 / (k1 * gd0 ** a + k2 * gd0 ** b)
    gate(close(nn, nn_eq, 1e-8), "bond structure off equilibrium")
    return _out(res.iters, [nn.mean()], res.x)


def bond_viscosity(P):
    """tests/test_solved_aux_fields.py::test_bond_viscosity_closure."""
    g = np.zeros((3, 2, 2))
    g[:, 0, 1] = 2.0
    fv = types.SimpleNamespace(val={"bond": P.arr([[0.0], [1.0], [0.5]])},
                               grad={"velocity": P.arr(g)})
    mu0, mu_inf, tau_y, fexp = 10.0, 1.0, 3.0, 0.9
    mu = _np(P.materials.BondViscosity(mu0, mu_inf, aexp=1.0, tau_y=tau_y,
                                       fexp=fexp)(fv, {}, {}))
    yv = tau_y * (1.0 - np.exp(-fexp * 2.0)) / 2.0
    gate(close(mu[0], mu_inf, 1e-12) and close(mu[1], mu0 + yv, 1e-10)
         and close(mu[2], mu_inf + 0.5 * (mu0 - mu_inf) + 0.5 * yv, 1e-10),
         f"bond viscosity {mu}")
    return _out(0, mu, mu)


def residence_time(P):
    """tests/test_bc_catalog3.py::test_residence_time_plug_flow."""
    U = 2.0
    mesh = P.mesh.rectangle_mesh(8, 3, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, 0.5))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False),
                            P.phys.Continuity(interp="Q1"),
                            P.scalar.ResidenceTime(interp="Q1", supg=0.5)],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, U)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_dirichlet("left", "restime", 0, 0.0)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity", 0, U)
    res = _solve(P, prob, x0, max_iter=25, tol=1e-11)
    tau = prob.get_nodal_field(res.x, "restime", 0)
    m = ~np.isnan(tau)
    gate(close(tau[m], mesh.coords[m, 0] / U, 0, 1e-8), "tau != x/U")
    return _out(res.iters, [tau[m].max()], res.x)


def light_beer_lambert(P):
    """tests/test_bc_catalog3.py::test_light_intensity_beer_lambert."""
    I0, beta = 3.0, 1.5
    mesh = P.mesh.rectangle_mesh(48, 2, elem="QUAD9", xlim=(0, 1.0),
                                 ylim=(0, 0.1))
    prob = P.Problem(mesh, [P.scalar.LightIntensity(
        direction=(1.0, 0.0), beta=beta, interp="Q1", supg=0.2)], {}, **P.kw)
    prob.add_dirichlet("left", "light_intp", 0, I0)
    prob.finalize()
    res = _solve(P, prob, max_iter=25, tol=1e-11)
    I = prob.get_nodal_field(res.x, "light_intp", 0)  # noqa: E741
    m = ~np.isnan(I)
    gate(close(I[m], I0 * np.exp(-beta * mesh.coords[m, 0]), 3e-3),
         "not Beer-Lambert")
    return _out(res.iters, [I[m].min()], res.x)


def shear_rate_couette(P):
    """tests/test_shell_rheo.py::test_shear_rate_projection_couette."""
    U = 0.8
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9")
    _all_nodes(mesh)
    prob = P.Problem(mesh, [P.eqs.PassiveVar("velocity", 2, "Q2"),
                            P.scalar.ShearRateProjection(interp="Q2")], {},
                     **P.kw)
    prob.add_dirichlet("all", "velocity", 0, lambda c: U * c[:, 1])
    prob.add_dirichlet("all", "velocity", 1, 0.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=4, tol=1e-10)
    gd = prob.get_nodal_field(res.x, "shear_rate_proj", 0)
    gate(close(gd, U, 0, 1e-8), "shear rate != U")
    return _out(res.iters, [gd.mean()], res.x)


def surface_electric_field(P):
    """tests/test_shell_rheo.py::test_shell_grad_surface_electric_field."""
    sh = P.shell
    k_el, Ds, V0 = 2.0, 0.5, 3.0
    mesh = P.mesh.rectangle_mesh(8, 4, elem="QUAD9")
    bi = sh.attach_shell_block(mesh, "bottom", "qs_shell")
    prob = P.Problem(mesh, [
        [P.electro.Potential(),
         P.eqs.PassiveVar("surface_charge", 1, "Q2", reg=1e-8)],
        [sh.SurfaceCharge(surf_diff=Ds, interp="Q2")]], [{}, {}], **P.kw)
    _all_nodes(mesh, "allb")
    prob.add_dirichlet("allb", "voltage", 0, lambda c: V0 * c[:, 1])
    sn = np.unique(mesh.blocks[bi].conn)
    c = mesh.coords
    mesh.nodesets["qs_ends"] = sn[np.isclose(c[sn, 0], 0.0)
                                  | np.isclose(c[sn, 0], 1.0)].astype(np.int32)
    prob.add_dirichlet("qs_ends", "surface_charge", 0, 0.0)
    prob.add_face_kernel("bottom", sh.ShellGradBC(
        "surface_charge", sh.bulk_normal_current(k_el), sign=1.0))
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "voltage", 0,
                              V0 * c[:, 1])
    res = _solve(P, prob, x0, max_iter=5, tol=1e-11)
    qs = prob.get_nodal_field(res.x, "surface_charge", 0)
    exact = k_el * V0 / (2 * Ds) * c[sn, 0] * (1 - c[sn, 0])
    gate(close(qs[sn], exact, 0, 1e-5), "surface charge profile")
    return _out(res.iters, [qs[sn].max()], res.x)


# the other goma_tpu tests of the slice's classes: tests/test_more_physics.py,
# test_physics_breadth.py, test_bc_catalog2.py, test_bc_catalog4.py,
# test_bc_machinery_audit.py, test_interface.py, test_numjac_new_kernels.py
def acoustic_plane_wave(P):
    """tests/test_more_physics.py::test_acoustic_plane_wave."""
    ac = P.acoustic
    k = 2 * np.pi
    mesh = P.mesh.rectangle_mesh(40, 1, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, 0.05))
    prob = P.Problem(mesh, [ac.AcousticHelmholtz("real", k, interp="Q2"),
                            ac.AcousticHelmholtz("imag", k, interp="Q2")],
                     {}, **P.kw)
    prob.add_dirichlet("left", ac.APR, 0, 1.0)
    prob.add_dirichlet("left", ac.API, 0, 0.0)
    for part in ("real", "imag"):
        prob.add_face_kernel("right", ac.SommerfeldBC(part, k))
    prob.finalize()
    res = _solve(P, prob, tol=1e-10)
    pr = prob.get_nodal_field(res.x, ac.APR)
    pi = prob.get_nodal_field(res.x, ac.API)
    x = mesh.coords[:, 0]
    err = max(np.abs(pr - np.cos(k * x)).max(), np.abs(pi + np.sin(k * x)).max())
    gate(err < 2e-2 and close(np.sqrt(pr ** 2 + pi ** 2), 1.0, 0, 2e-2),
         f"plane wave error {err}")
    return _out(res.iters, [err], res.x)


def projection_shear_rate(P):
    """tests/test_more_physics.py::test_projection_shear_rate."""
    shear_rate = P.materials.shear_rate
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9")
    prob = P.Problem(mesh, [
        P.phys.Momentum(dim=2, transient=False), P.phys.Continuity(),
        P.acoustic.ProjectionEquation(
            "shear_rate", 1, lambda fv, m, p: shear_rate(fv)[:, None],
            interp="Q1")], {"rho": 0.0, "mu": 1.0}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, lambda c: 2.0 * c[:, 1])
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=5, tol=1e-10)
    gd = prob.get_nodal_field(res.x, "shear_rate")
    gate(close(gd[~np.isnan(gd)], 2.0, 0, 1e-8), "shear rate != 2")
    return _out(res.iters, [np.nanmean(gd)], res.x)


def butler_volmer_electrode(P):
    """tests/test_physics_breadth.py::test_butler_volmer_electrode (its
    ``line_mesh``: a 10x1 QUAD4 strip of height 0.1)."""
    from scipy.optimize import brentq

    el = P.electro
    kappa, L = 2.0, 1.0
    i0, aa, ac, Vm = 0.5, 0.5, 0.5, 0.2
    mesh = P.mesh.rectangle_mesh(10, 1, elem="QUAD4", xlim=(0, L),
                                 ylim=(0, 0.1))
    prob = P.Problem(mesh, [el.Potential(interp="Q1")], {"kappa": kappa},
                     **P.kw)
    prob.add_dirichlet("right", "voltage", 0, 0.0)
    prob.add_face_kernel("left", el.ButlerVolmerBC(i0, aa, ac, Vm))
    prob.finalize()
    res = _solve(P, prob, max_iter=12, tol=1e-12)
    V = prob.get_nodal_field(res.x, "voltage")
    Vs = V[mesh.nodesets["left"]].mean()
    f = el.FARADAY / (el.GAS_R * 298.15)
    v_exact = brentq(lambda v: kappa * v / L - i0 * (
        np.exp(aa * f * (Vm - v)) - np.exp(-ac * f * (Vm - v))), -1, 1)
    R_only = _residual(P, prob, res.x)
    R_full = _np(prob.assemble(P.arr(res.x), prob.base_params())[0])
    gate(close(Vs, v_exact, 1e-8)
         and close(V, Vs * (1 - mesh.coords[:, 0] / L), 0, 1e-8)
         and close(R_only, R_full, 0, 1e-12), f"electrode potential {Vs}")
    return _out(res.iters, [Vs], res.x)


def hor_orr_kinetics(P):
    """tests/test_physics_breadth.py::test_hor_orr_surface_kinetics."""
    el = P.electro
    D, c0, L = 1.0, 1.0, 1.0
    ai0, H, n, ac, U0, beta, cref, V, T = (2.0, 1.0, 4.0, 0.5, 0.2, 1.0, 1.0,
                                           0.4, 298.15)
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9", xlim=(0, L),
                                 ylim=(0, 0.25))
    prob = P.Problem(mesh, [P.phys.Species(n_species=1, interp="Q2",
                                           transient=False, convection=False)],
                     {"D": D}, **P.kw)
    prob.add_dirichlet("left", "species", 0, c0)
    prob.add_face_kernel("right", el.ORRFlux(
        ai0=ai0, H=H, n=n, alpha_c=ac, U0=U0, beta=beta, cref=cref, V=V, T=T))
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, c0)
    res = _solve(P, prob, x0, max_iter=12, tol=1e-12)
    c = prob.get_nodal_field(res.x, "species", 0)
    rate0 = ai0 * H / (n * el.FARADAY) * np.exp(
        -ac * el.FARADAY / (el.GAS_R * T) * (V - U0))
    m = rate0 * c0 / (D + rate0 * L)
    gate(close(c, c0 - m * mesh.coords[:, 0], 0, 1e-10), "not linear")
    return _out(res.iters, [c.min()], res.x)


def electromigration_boltzmann(P):
    """tests/test_physics_breadth.py::test_species_electromigration_boltzmann."""
    el = P.electro
    D, z, V1, c0, L = 1.0, 1.0, 0.2, 1.0, 1.0
    um = 1.5 / (el.FARADAY * 0.2)
    mesh = P.mesh.rectangle_mesh(10, 2, elem="QUAD9", xlim=(0, L),
                                 ylim=(0, 0.25))
    prob = P.Problem(mesh, [P.phys.Species(n_species=1, interp="Q2",
                                           transient=False, convection=False),
                            el.Potential(interp="Q2")],
                     {"diffusivity": D, "kappa": 1.0, "charge": (z,),
                      "mobility": (um,)}, **P.kw)
    prob.add_dirichlet("left", "species", 0, c0)
    prob.add_dirichlet("left", "voltage", 0, 0.0)
    prob.add_dirichlet("right", "voltage", 0, V1)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, c0)
    res = _solve(P, prob, x0, max_iter=12, tol=1e-12)
    c = prob.get_nodal_field(res.x, "species", 0)
    exact = c0 * np.exp(-z * um * el.FARADAY * V1 * mesh.coords[:, 0] / L / D)
    gate(close(c, exact, 0, 2e-4), "not the Boltzmann profile")
    return _out(res.iters, [c.min()], res.x)


def hor_flux_potential(P):
    """tests/test_bc_catalog2.py::test_hor_flux_runs_and_couples_potential."""
    el = P.electro
    mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Species(n_species=1, interp="Q2",
                                           transient=False, convection=False),
                            el.Potential(interp="Q2")],
                     {"diffusivity": 1.0, "kappa": 1.0}, **P.kw)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("left", "voltage", 0, 0.0)
    prob.add_dirichlet("right", "voltage", 0, 0.05)
    prob.add_face_kernel("right", el.HORFlux(
        ai0=1.0, H=1.0, n=1.0, alpha_a=0.5, alpha_c=0.5, U0=0.0, beta=1.0,
        cref=1.0, V=0.3))
    prob.finalize()
    res = _solve(P, prob, np.full(prob.dofmap.n_dof, 0.5), max_iter=10,
                 tol=1e-10)
    dm = prob.dofmap
    d = dm.dof_of_node_svar[:, dm.svar("species")]
    c = res.x[d[d >= 0]]
    xs = mesh.coords[d >= 0][:, 0]
    gate(np.all(np.isfinite(c)) and c[xs > 1 - 1e-9].mean()
         < c[xs < 1e-9].mean(), "HOR does not consume at the right")
    return _out(res.iters, [c.min()], res.x)


def suspension_flux_crafted(P):
    """tests/test_bc_catalog4.py::test_suspension_flux_crafted."""
    Kc, Kmu, a, Y0, g1, rho = 0.41, 0.62, 0.8, 0.3, 2.5, 1.7
    mesh = P.mesh.rectangle_mesh(5, 4, elem="QUAD4")
    hydro = P.flux.HydroSpecies(Kc=Kc, Kmu=Kmu, a_rad=a, interp="Q1",
                                transient=False, convection=False)

    def build(P, with_bc):
        prob = P.Problem(mesh, [hydro, P.eqs.PassiveVar("shear_rate", 1, "Q1")],
                         {"rho": rho}, **P.kw)
        if with_bc:
            prob.add_face_kernel("right", P.flux.SuspensionFlux(hydro, rho=rho))
        prob.finalize()
        x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0,
                                  Y0)
        return prob, prob.set_nodal_field(x0, "shear_rate", 0,
                                          g1 * mesh.coords[:, 0])

    dR, prob = _with_without(P, build)
    dm = prob.dofmap
    d = dm.dof_of_node_svar[:, dm.svar("species", 0)]
    got = dR[d[d >= 0]].sum()
    want = rho * (-Kc * a * a * Y0 * Y0 * g1)
    gate(close(got, want, 1e-12), f"suspension flux {got} {want}")
    return _out(0, [got], dR)


def current_bv_rowsum(P):
    """tests/test_bc_machinery_audit.py::test_current_bv2_rowsum."""
    el = P.electro
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    prob = P.Problem(mesh, [el.Potential(interp="Q2")], {"kappa": 1.0},
                     **P.kw)
    i0, aa, ac, Vm, T = 0.7, 0.5, 0.5, 0.2, 298.15
    prob.add_face_kernel("right", el.ButlerVolmerBC(i0, aa, ac, Vm, T=T))
    prob.finalize()
    V0 = -0.05
    R = _np(prob.assemble(P.arr(np.full(prob.dofmap.n_dof, V0)),
                          prob.base_params())[0])
    rows = prob.dofmap.node_dofs("voltage", mesh.sideset_nodes("right"), 0)
    f = el.FARADAY / (el.GAS_R * T)
    i_an = i0 * (np.exp(aa * f * (Vm - V0)) - np.exp(-ac * f * (Vm - V0)))
    tot = float(R[rows].sum())
    gate(close(tot, -i_an, 1e-10), f"electrode current {tot}")
    return _out(0, [tot], R)


def em_h_farfield_rowsum(P):
    """tests/test_bc_machinery_audit.py::test_em_hi_farfield_rowsum."""
    em = P.em
    omega, eps, mu_m = 2.0, 1.5, 1.0
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    prob = P.Problem(mesh, [em.EMWaveH("real", omega, dim=2),
                            em.EMWaveH("imag", omega, dim=2)],
                     {"eps": eps, "mu_m": mu_m}, **P.kw)
    prob.add_face_kernel("right", em.EMAbsorbingBCH("imag", omega, dim=2))
    prob.finalize()
    H_re = np.array([0.3, -0.8])
    x = np.zeros(prob.dofmap.n_dof)
    for c in range(2):
        x = prob.set_nodal_field(x, em.H_RE, c, H_re[c])
    R = _np(prob.assemble(P.arr(x), prob.base_params())[0])
    k = omega * np.sqrt(mu_m * eps)
    nodes = mesh.sideset_nodes("right")
    sums = []
    for c, Ht in ((0, 0.0), (1, H_re[1])):
        tot = float(R[prob.dofmap.node_dofs(em.H_IM, nodes, c)].sum())
        gate(abs(tot - (k / eps) * Ht) <= 1e-12 + 1e-9 * abs((k / eps) * Ht),
             f"H far field row sum {c}: {tot}")
        sums.append(tot)
    return _out(0, sums[1:], R)


def light_fresnel_two_layer(P):
    """tests/test_interface.py::test_light_fresnel_jump_two_layer (its
    two-block QUAD4 strip, 5 + 5 x 2, split at x = 0.5)."""
    import importlib

    mi = importlib.import_module(f"{P.pkg}.mesh.interface")
    I0, b_up, b_down, n_up, n_down = 1.0, 0.5, 1.2, 1.0, 1.5
    nx, ny = 5, 2
    gx = 2 * nx + 1
    X, Y = np.meshgrid(np.linspace(0, 1, gx), np.linspace(0, 1, ny + 1),
                       indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    conn_a, conn_b = [], []
    for j in range(ny):
        for i in range(2 * nx):
            c = [j * gx + i, j * gx + i + 1, (j + 1) * gx + i + 1,
                 (j + 1) * gx + i]
            (conn_a if i < nx else conn_b).append(c)
    mesh = P.mesh.Mesh(2, coords, [
        P.mesh.Block("A", "QUAD4", np.asarray(conn_a, dtype=np.int32)),
        P.mesh.Block("B", "QUAD4", np.asarray(conn_b, dtype=np.int32))])
    mesh.nodesets = {"left": np.where(np.isclose(coords[:, 0], 0.0))[0]
                     .astype(np.int32)}
    mesh.sidesets = {}
    pairs = mi.find_interface_faces(mesh, 0, 1)
    mi.split_interface(mesh, pairs)
    sc = P.scalar
    prob = P.Problem(mesh, [
        [sc.LightIntensity((1.0, 0.0), b_up, interp="Q1", supg=0.5)],
        [sc.LightIntensity((1.0, 0.0), b_down, interp="Q1", supg=0.5)]],
        [{"refindex": n_up}, {"refindex": n_down}], **P.kw)
    prob.add_dirichlet("left", "light_intp", 0, I0)
    flipped = mi.InterfacePairs(block_a=pairs.block_b, block_b=pairs.block_a,
                                elems_a=pairs.elems_b, faces_a=pairs.faces_b,
                                elems_b=pairs.elems_a, faces_b=pairs.faces_a)
    prob.add_interface_kernel(flipped, sc.LightFresnelJump())
    prob.finalize()
    res = _solve(P, prob, max_iter=6, tol=1e-11)
    Ip = prob.get_nodal_field(res.x, "light_intp", 0)
    x = mesh.coords[:, 0]
    R = ((n_down - n_up) / (n_down + n_up)) ** 2
    Yf = (n_up / n_down) ** 2 * (1 - R)
    right = np.unique(mesh.blocks[1].conn)
    right = right[x[right] > 0.5 + 1e-9]
    left = np.unique(mesh.blocks[0].conn)
    left = left[x[left] < 0.5 - 1e-9]
    gate(close(Ip[right], Yf * I0 * np.exp(-b_up * 0.5)
               * np.exp(-b_down * (x[right] - 0.5)), 2e-2)
         and close(Ip[left], I0 * np.exp(-b_up * x[left]), 2e-2),
         "Fresnel transmission")
    return _out(res.iters, [Ip[right].max()], res.x)


def numjac_em_edge(P):
    """tests/test_numjac_new_kernels.py::test_numjac_em_edge: the edge
    curl-curl's AD columns against central differences (QUAD9, signed
    TRI6, HEX27)."""
    em = P.em
    n = []
    cases = [(P.mesh.rectangle_mesh(3, 3, elem=e), 2, 2.0, 0.3, 17, 2)
             for e in ("QUAD9", "TRI6")]
    cases.append((P.mesh.box_mesh(2, 2, 2, elem="HEX27"), 3, 1.5, None, 19,
                  1))
    for mesh, dim, omega, sigma, seed, parts in cases:
        mat = {"mu_m": 1.0, "eps": 1.0}
        if sigma is not None:
            mat["sigma_em"] = sigma
        eqs = [em.EMWaveEdge(p, omega=omega, dim=dim)
               for p in ("real", "imag")[:parts]]
        prob = P.Problem(mesh, eqs, mat, **P.kw)
        prob.finalize()
        x = 0.1 * np.random.RandomState(seed).randn(prob.dofmap.n_dof)
        chk = P.numjac.numerical_jacobian_check(prob, x, prob.base_params(),
                                                n_columns=12)
        gate(chk.ok, chk.report())
        n.append(chk.n_checked)
    return _out(0, n, np.array(n, dtype=float))


EM_SMALL = {
    "em_plane_wave": em_plane_wave,
    "em_lossy_decay": em_lossy_decay,
    "em_h_plane_wave": em_h_plane_wave,
    "em_h_lossy_decay": em_h_lossy_decay,
    "edge_constant_patch": edge_constant_patch,
    "edge_te_mode": edge_te_mode,
    "edge_te_mode_tri": edge_te_mode_tri,
    "edge_hex": edge_hex,
    "em_h_farfield_rowsum": em_h_farfield_rowsum,
    "numjac_em_edge": numjac_em_edge,
}
ELECTRO_SMALL = {
    "acoustic_piston": acoustic_piston,
    "ls_acoustic_radiation": ls_acoustic_radiation,
    "ni_deposition_balance": ni_deposition_balance,
    "ni_current_total": ni_current_total,
    "current_sic": current_sic,
    "alloy_evaporation": alloy_evaporation,
    "surface_charge": surface_charge,
    "electrodeposition_velocity": electrodeposition_velocity,
    "pem_water": pem_water,
    "koh_etch": koh_etch,
    "charged_surface_gradient": charged_surface_gradient,
    "binary_stefan_maxwell": binary_stefan_maxwell,
    "ternary_sm_relations": ternary_sm_relations,
    "generalized_fickian": generalized_fickian,
    "phillips_migration": phillips_migration,
    "species_flux_numjac": species_flux_numjac,
    "bond_equilibrium": bond_equilibrium,
    "bond_viscosity": bond_viscosity,
    "residence_time": residence_time,
    "light_beer_lambert": light_beer_lambert,
    "shear_rate_couette": shear_rate_couette,
    "surface_electric_field": surface_electric_field,
    "acoustic_plane_wave": acoustic_plane_wave,
    "projection_shear_rate": projection_shear_rate,
    "butler_volmer_electrode": butler_volmer_electrode,
    "hor_orr_kinetics": hor_orr_kinetics,
    "electromigration_boltzmann": electromigration_boltzmann,
    "hor_flux_potential": hor_flux_potential,
    "suspension_flux_crafted": suspension_flux_crafted,
    "current_bv_rowsum": current_bv_rowsum,
    "light_fresnel_two_layer": light_fresnel_two_layer,
}
SMALL = {**EM_SMALL, **ELECTRO_SMALL}
