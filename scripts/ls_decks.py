"""The fluid and level-set boundary-condition decks (slip laws, heat and
mass fluxes, level-set wall conditions, XFEM pressure, CSF variants, the
solved curvature and normal, the extension velocity, the embedded laser,
recoil and latent-heat terms, surface domains), written once for both
packages.

Every function here takes a package namespace ``P`` (see ``namespace``):
goma_tpu's modules and ``jax.numpy`` from ``scripts/ls_reference.py`` and
the port's tests, the port's modules and ``torch`` from ``chip_smoke.py``.
Callables are written in the operations ``jax.numpy`` and ``torch`` share,
so one deck is one definition. This module imports neither package:
``namespace`` imports the one it is given by name.

- ``melt_pool(P, nx, ny)``: a laser spot melt pool on [0, 2] x [0, 1]
  (``nx`` x ``ny`` QUAD9). Liquid (F < 0) below y = 0.6, gas above, with
  ``LevelSetProperty`` rho, mu, k and Cp (gas/liquid 0.1 for rho, mu and k,
  0.5 for Cp). ``Momentum`` (transient), ``Continuity`` (Q1), ``Energy``
  (Q2, transient), ``FillEquation`` (Q2, SUPG, transient), ``CSFHysing``
  (sigma ``MELT_SIGMA``, dt in params), ``LSEmbeddedFlux("temperature",
  qlaser_flux(...))`` with a beam centred at (1, 0.6), ``LSEmbeddedFlux``
  with ``qvapor_flux(T_boil)`` (the Kanouff ``vapor_cool`` fit),
  ``LSRecoilPressure(kanouff_recoil(T_boil))`` and ``LSLatentHeat``. Side
  walls: ``LevelSetSlip`` and no normal velocity; the bottom no-slip at
  T = 1; the top ``LSNoPenetration`` (closed to the liquid, open to the
  gas). ``MELT_STEPS`` backward-Euler steps of ``MELT_DT`` from rest at
  T = 1 (``melt_time``). The numbers: the beam's power 1 and radius 0.15,
  T_boil 1.05, dt 0.005. At 96 x 48 goma_tpu's ``gmres+ndlu`` rung (the
  deep-tolerance branch: loose float32 Krylov solves, so about three
  digits a Newton step) failed the first attempt at dt 0.02 with power 8
  and took 10 Newton iterations at the halved dt; at power 2 and dt 0.01
  it failed and halved again. From rest the laser's whole source is the
  first residual, so the power sets the first step's Newton count: power
  1 at dt 0.005 takes 3 a step on every rung, and the peak temperature
  still passes T_boil within the run, so the recoil, vapor-loss and
  latent-heat terms all act.
- ``wetting_drop(P, nx, ny)``: a drop relaxing on a wall, [-1, 1] x [0, 1]
  (``nx`` x ``ny`` QUAD9): a half disc of radius 0.5 on the bottom wall at
  90 degrees; the gas has 0.1 of the liquid's rho and mu. ``Momentum``
  (transient), ``Continuity`` (Q1), ``XFEMPressureContinuity`` and
  ``XFEMPressureMomentum`` (Q1), ``FillEquation`` (Q2), ``SolvedNormal``
  (Q1) with ``CSFDivN``, ``LSCurvature`` (Q1). The bottom carries
  ``LSWallAngle(60)`` on the fill rows, ``LevelSetSlip`` with no normal
  velocity and ``LSCurvatureWallAngle(60)``; the other walls
  ``LSCurvatureBoundary`` and no slip; the pressure pinned at a top
  corner. ``DROP_STEPS`` backward-Euler steps of ``DROP_DT``. In
  goma_tpu's convention the wall angle is the one between the fill
  gradient (into the gas) and the outward wall normal, so 60 degrees is a
  liquid-side angle of 120 and the drop beads up; ``LSCurvatureWallAngle``
  takes the supplementary angle, 120 (tests/test_ls_embedded_bc.py pairs
  them so). The numbers: dt 0.0025 and the XFEM regularization 1e-4. At
  96 x 48 with dt 0.01 (or 0.005) and goma_tpu's default 1e-8,
  goma_tpu's ``gmres+ndlu`` rung took 7-9 Newton iterations in the first
  steps: the float32 factor of the enrichment rows of uncut elements (a
  1e-8 mass) preconditions poorly (30-60 GMRES iterations a solve); 1e-4
  keeps those rows at a scale the float32 factor resolves, and every step
  takes at most 6.
- ``SMALL``: goma_tpu's tests' decks of the slice at their own sizes, on
  their own solvers (host ``direct``; the transient one under the
  transient solver), each checking the test's own gate and returning its
  Newton count, its readings and its solution (or residual).
"""

from __future__ import annotations

import importlib
import math
import types

import numpy as np

from scripts.shell_decks import _np, _out, close, gate, samples
from scripts.solid_decks import step_records  # noqa: F401  (re-exported)

# ------------------------------------------------------------- melt pool
MELT_L, MELT_H, MELT_Y0 = 2.0, 1.0, 0.6
MELT_BEAM = (1.0, 0.6)
MELT_EPS = 0.05              # ls_eps: 2.4 element widths at 96 x 48
MELT_SIGMA = 0.5
MELT_POWER, MELT_RADIUS = 1.0, 0.15
MELT_T0, MELT_T_BOIL = 1.0, 1.05
# the Kanouff fits are in K and Pa (J/m^2 s): T_scale 1 keeps the "ice"
# set (T_boil < 2000), the scales bring both to this deck's units
MELT_P_SCALE, MELT_Q_SCALE = 1e-3, 1e-7
MELT_LATENT = 0.5
MELT_BETA_WET, MELT_BETA_DRY = 1.0, 0.1
MELT_DT, MELT_STEPS, MELT_MAX_ITER = 0.005, 6, 12

# ---------------------------------------------------------- wetting drop
DROP_R, DROP_ANGLE, DROP_WALL_PENALTY = 0.5, 60.0, 1e3
DROP_EPS = 0.05
DROP_XFEM_REG = 1e-4
DROP_SIGMA = 1.0
DROP_BETA_WET, DROP_BETA_DRY = 0.05, 0.05
DROP_DT, DROP_STEPS, DROP_MAX_ITER = 0.0025, 6, 12


def namespace(pkg: str, xp, arr, device=None):
    """The namespace the decks read for package ``pkg`` ("goma_tpu" or
    "goma_tpu_torch"): its mesh generators and mesh classes, Problem, the
    physics package and ``physics.level_set``, the condition modules of
    the slice, ``fem.equations``, ``mesh.interface``, the solvers,
    ``utils.numjac``, ``post``, the array module ``xp``, ``arr`` (a numpy
    array onto the package's device) and the Problem's device keyword."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    solvers, transient = mod("solvers"), mod("solvers.transient")
    return types.SimpleNamespace(
        pkg=pkg, mesh=mod("mesh"), meshmod=mod("mesh.mesh"),
        Problem=mod("fem").Problem, phys=mod("physics"),
        ls=mod("physics.level_set"), fluid=mod("physics.fluid"),
        bc=mod("bc"), lse=mod("bc.ls_embedded"),
        sdom=mod("bc.surface_domain"), eqs=mod("fem.equations"),
        interface=mod("mesh.interface"), numjac=mod("utils.numjac"),
        post=mod("post"), NewtonOptions=solvers.NewtonOptions,
        NewtonSolver=solvers.NewtonSolver, TimeOptions=transient.TimeOptions,
        TransientSolver=transient.TransientSolver, xp=xp, arr=arr,
        kw={} if device is None else {"device": device})


def readings(x):
    """||x||_2, max |x| and x at the 24 sampled dofs of a solution."""
    x = _np(x)
    return {"x_norm": float(np.linalg.norm(x)),
            "x_max": float(np.abs(x).max()),
            "x_samples": x[samples(x.size)].tolist()}


def _all_nodes(mesh):
    mesh.nodesets["all"] = np.arange(mesh.n_nodes, dtype=np.int32)


def _ls_params(P, prob, eps, **extra):
    """base_params with ``ls_eps`` and any other scalar entries, as
    tensors of the package."""
    p = dict(prob.base_params())
    for k, v in {"ls_eps": eps, **extra}.items():
        p[k] = P.arr(np.float64(v))
    return p


def _newton(P, prob, x0, params, max_iter, tol, **kw):
    res = P.NewtonSolver(prob, P.NewtonOptions(
        max_iter=max_iter, tol_residual=tol, linear_solver="direct",
        **kw)).solve(x0, params)
    gate(res.converged, "Newton did not converge")
    return res


# ------------------------------------------------------------- melt pool
def melt_materials(P):
    """The melt pool's liquid (F < 0) and gas (F > 0) properties."""
    LP = P.ls.LevelSetProperty
    return {"rho": LP(1.0, 0.1), "mu": LP(1.0, 0.1), "k": LP(1.0, 0.1),
            "Cp": LP(1.0, 0.5)}


def melt_pool(P, nx, ny):
    """The laser melt pool (module docstring), finalized. Returns
    (problem, x0, params): x0 at rest with F = y - 0.6 and T = 1; params
    with ``ls_eps`` and the Hysing ``dt``."""
    ls, bcm = P.ls, P.bc
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, MELT_L),
                                 ylim=(0, MELT_H))
    eqs = [P.phys.Momentum(dim=2, interp="Q2", transient=True),
           P.phys.Continuity(interp="Q1"),
           P.phys.Energy(interp="Q2", transient=True),
           ls.FillEquation(interp="Q2", supg=0.5, transient=True),
           ls.CSFHysing(dim=2, sigma=MELT_SIGMA),
           ls.LSEmbeddedFlux("temperature", ls.qlaser_flux(
               MELT_POWER, MELT_RADIUS, MELT_BEAM)),
           ls.LSEmbeddedFlux("temperature", ls.qvapor_flux(
               MELT_T_BOIL, q_scale=MELT_Q_SCALE)),
           ls.LSRecoilPressure(dim=2, p_fn=ls.kanouff_recoil(
               MELT_T_BOIL, P_scale=MELT_P_SCALE)),
           ls.LSLatentHeat(MELT_LATENT, interp="Q2")]
    prob = P.Problem(mesh, eqs, melt_materials(P), **P.kw)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_face_kernel(ns, bcm.LevelSetSlip(
            dim=2, beta_wet=MELT_BETA_WET, beta_dry=MELT_BETA_DRY,
            eps_ls=MELT_EPS))
    for c in (0, 1):
        prob.add_dirichlet("bottom", "velocity", c, 0.0)
    prob.add_dirichlet("bottom", "temperature", 0, MELT_T0)
    prob.add_face_kernel("top", bcm.LSNoPenetration(dim=2, length=MELT_EPS))
    prob.finalize()
    c = mesh.coords
    x0 = np.zeros(prob.dofmap.n_dof)
    x0 = prob.set_nodal_field(x0, "fill", 0, c[:, 1] - MELT_Y0)
    x0 = prob.set_nodal_field(x0, "temperature", 0, MELT_T0)
    return prob, x0, _ls_params(P, prob, MELT_EPS, dt=MELT_DT)


def melt_time(P, steps=MELT_STEPS):
    """Backward Euler at dt ``MELT_DT`` without adaptation, ``steps``
    steps."""
    return P.TimeOptions(dt0=MELT_DT, t_end=steps * MELT_DT, max_steps=steps,
                         adapt=False, theta=0.0)


def _crossings(segs, axis, at):
    """The other coordinate where the facets ``segs`` (n, 2, 2) cross the
    line coordinate ``axis`` = ``at``."""
    a, b = segs[:, 0], segs[:, 1]
    da, db = a[:, axis] - at, b[:, axis] - at
    hit = (da * db <= 0.0) & (np.abs(da - db) > 1e-300)
    t = da[hit] / (da[hit] - db[hit])
    o = 1 - axis
    return a[hit, o] + t * (b[hit, o] - a[hit, o])


def melt_outputs(P, prob, x):
    """The peak temperature and the interface height under the beam (the
    lowest zero-contour crossing of x = 1; the depression is y0 minus it,
    read as the height: the depression itself is 1e-4 and its relative
    value moves with the solver's tolerance)."""
    x = _np(x)
    T = prob.get_nodal_field(x, "temperature", 0)
    F = prob.get_nodal_field(x, "fill", 0)
    ys = _crossings(P.ls.interface_facets(prob.mesh, F), 0, MELT_BEAM[0])
    return {"T_peak": float(np.nanmax(T)),
            "interface_y": float(ys.min()) if ys.size else float("nan")}


# ---------------------------------------------------------- wetting drop
def wetting_drop(P, nx, ny):
    """The wetting drop (module docstring), finalized. Returns (problem,
    x0, params): x0 at rest with F the signed distance to the half disc,
    its unit normal and curvature 1/r."""
    ls, lse, bcm = P.ls, P.lse, P.bc
    LP = ls.LevelSetProperty
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(-1.0, 1.0),
                                 ylim=(0.0, 1.0))
    c = mesh.coords
    mesh.nodesets["pin"] = np.array([int(np.argmin(
        (c[:, 0] - 1.0) ** 2 + (c[:, 1] - 1.0) ** 2))], dtype=np.int32)
    eqs = [P.phys.Momentum(dim=2, interp="Q2", transient=True),
           P.phys.Continuity(interp="Q1"),
           ls.XFEMPressureContinuity(interp="Q1", eps_reg=DROP_XFEM_REG),
           ls.XFEMPressureMomentum(dim=2),
           ls.FillEquation(interp="Q2", supg=0.5, transient=True),
           ls.SolvedNormal(dim=2, interp="Q1"),
           ls.CSFDivN(dim=2, sigma=DROP_SIGMA),
           ls.LSCurvature(interp="Q1")]
    prob = P.Problem(mesh, eqs, {"rho": LP(1.0, 0.1), "mu": LP(1.0, 0.1)},
                     **P.kw)
    prob.add_face_kernel("bottom", lse.LSWallAngle(DROP_ANGLE,
                                                     penalty=DROP_WALL_PENALTY))
    prob.add_face_kernel("bottom", bcm.LevelSetSlip(
        dim=2, beta_wet=DROP_BETA_WET, beta_dry=DROP_BETA_DRY,
        eps_ls=DROP_EPS))
    prob.add_face_kernel("bottom", lse.LSCurvatureWallAngle(180.0 - DROP_ANGLE))
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    for ns in ("left", "right", "top"):
        prob.add_face_kernel(ns, ls.LSCurvatureBoundary())
        for k in (0, 1):
            prob.add_dirichlet(ns, "velocity", k, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    r = np.hypot(c[:, 0], c[:, 1])
    rs = np.maximum(r, 1e-12)
    x0 = np.zeros(prob.dofmap.n_dof)
    x0 = prob.set_nodal_field(x0, "fill", 0, r - DROP_R)
    x0 = prob.set_nodal_field(x0, ls.NORMAL_VAR, 0, c[:, 0] / rs)
    x0 = prob.set_nodal_field(x0, ls.NORMAL_VAR, 1, c[:, 1] / rs)
    x0 = prob.set_nodal_field(x0, "ls_curvature", 0, 1.0 / np.maximum(r, 0.1))
    return prob, x0, _ls_params(P, prob, DROP_EPS)


def drop_time(P, steps=DROP_STEPS):
    """Backward Euler at dt ``DROP_DT`` without adaptation, ``steps``
    steps."""
    return P.TimeOptions(dt0=DROP_DT, t_end=steps * DROP_DT, max_steps=steps,
                         adapt=False, theta=0.0)


def drop_outputs(P, prob, x):
    """The contact line (the zero of F along the bottom wall, x > 0), the
    solved curvature on the interface (mean over the Q1 nodes within
    DROP_EPS / 2 of it) against 1 / R, the drop's area (``ls_volume`` of
    -F) and the largest speed."""
    x = _np(x)
    mesh = prob.mesh
    F = prob.get_nodal_field(x, "fill", 0)
    segs = P.ls.interface_facets(mesh, F)
    xs = _crossings(segs, 1, 0.0)
    kap = prob.get_nodal_field(x, "ls_curvature", 0)
    near = np.isfinite(kap) & (np.abs(F) < 0.5 * DROP_EPS)
    u = prob.get_nodal_field(x, "velocity", 0)
    v = prob.get_nodal_field(x, "velocity", 1)
    return {"contact_line": float(xs[xs > 0].max()) if (xs > 0).any()
            else float("nan"),
            "kappa": float(kap[near].mean()), "kappa_exact": 1.0 / DROP_R,
            "area": float(P.ls.ls_volume(mesh, -F, DROP_EPS)),
            "u_max": float(np.nanmax(np.hypot(u, v)))}


# ---------------------------------------------------------- small decks
def _frozen(P, var, ncomp=1, interp="Q1"):
    """tests/test_ext_velocity.py's ``Frozen``: a zero-residual variable
    held by Dirichlet rows."""
    class Frozen(P.eqs.Equation):
        def residual(self, fv, mat, params):
            z = 0.0 * fv.val[self.var][:, :, None]
            return z * fv.phi[self.var][:, None, :]

    return Frozen(var, ncomp, interp)


def _project(P, var, fn, ncomp=1, interp="Q1"):
    """tests/test_ext_velocity.py's ``Project``: R = (u - u_ex(x)) phi."""
    class Project(P.eqs.Equation):
        def residual(self, fv, mat, params):
            u = fv.val[self.var]
            return (u - fn(fv.x))[:, :, None] * fv.phi[self.var][:, None, :]

    return Project(var, ncomp, interp)


def _pin_fill(P, g, interp="Q2"):
    """tests/test_ls_embedded_bc.py's ``_PinFill``: R = (F - g(x)) phi."""
    class Pin(P.eqs.Equation):
        def residual(self, fv, mat, params):
            v = fv.val["fill"][:, 0]
            return ((v - g(fv.x))[:, None] * fv.phi["fill"])[:, None, :]

    return Pin("fill", 1, interp)


# tests/test_ls_embedded_bc.py
def distng_stefan(P):
    """test_distng_stefan_front_exact: DYDISTNG pins the top to T = 1,
    h = k T_melt / q = 0.5."""
    k, qflux, Tm = 1.0, 2.0, 1.0
    mesh = P.mesh.rectangle_mesh(6, 8, elem="QUAD9")

    class InFlux(P.eqs.FaceKernel):
        def residual(self, sfv, mat, params):
            return (-qflux * sfv.phi["temperature"])[:, None, :]

    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False,
                                          convection=False),
                            P.phys.EllipticMesh(2)],
                     {"rho": 1.0, "Cp": 1.0, "k": k, "lame_mu": 1.0,
                      "lame_lambda": 1.0}, **P.kw)
    prob.add_dirichlet("bottom", "temperature", 0, 0.0)
    prob.add_face_kernel("top", InFlux("temperature", 1))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "mesh_displacement", 0, 0.0)
    prob.add_dirichlet("bottom", "mesh_displacement", 1, 0.0)
    top = mesh.nodesets["top"]
    P.lse.add_distng(prob, top, Tm, comp=1, dim=2)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof),
                              "mesh_displacement", 1, -0.4 * mesh.coords[:, 1])
    x0 = prob.set_nodal_field(x0, "temperature", 0,
                              qflux / k * 0.6 * mesh.coords[:, 1])
    res = _newton(P, prob, x0, prob.base_params(), 25, 1e-10, damp=0.8)
    dy = prob.get_nodal_field(_np(res.x), "mesh_displacement", 1)
    y_top = mesh.coords[top, 1] + dy[top]
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    gate(close(y_top, k * Tm / qflux, 1e-8) and close(T[top], Tm, 1e-8),
         "Stefan front")
    return _out(res.iters, [y_top.mean()], res.x)


def _fill_only(P, mesh, kernel_ss, interp="Q1"):
    class Dummy(P.eqs.Equation):
        def residual(self, fv, mat, params):
            return 0.0 * fv.phi["fill"][:, None, :]

    prob = P.Problem(mesh, [Dummy("fill", 1, interp)], {}, **P.kw)
    for ss, k in kernel_ss:
        prob.add_face_kernel(ss, k)
    prob.finalize()
    return prob


def ls_wall_angle(P):
    """test_ls_wall_angle_residual_zero_when_satisfied: R = 0 at the
    prescribed angle, not at another."""
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD4")
    th = 55.0
    nF = np.array([np.sin(np.deg2rad(th)), -np.cos(np.deg2rad(th))])
    F = nF[0] * mesh.coords[:, 0] + nF[1] * mesh.coords[:, 1]
    Rs = []
    for ang in (th, th + 20.0):
        prob = _fill_only(P, mesh, [("bottom", P.lse.LSWallAngle(
            ang, penalty=1.0))])
        x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, F)
        Rs.append(_np(prob.residual(P.arr(x), prob.base_params())))
    gate(np.abs(Rs[0]).max() < 1e-12 and np.abs(Rs[1]).max() > 1e-3,
         "wall angle residual")
    return _out(0, [np.abs(Rs[1]).max()], np.concatenate(Rs))


def ls_ca_h(P):
    """test_ls_ca_h_straight_interface_consistency: kappa ~ 0 with the
    contact-angle wall term at the true angle."""
    th = 60.0
    mesh = P.mesh.rectangle_mesh(10, 10, elem="QUAD9")
    nF = np.array([np.sin(np.deg2rad(th)), -np.cos(np.deg2rad(th))])
    line = lambda c: nF[0] * (c[:, 0] - 0.5) + nF[1] * c[:, 1]  # noqa: E731
    prob = P.Problem(mesh, [_frozen(P, "fill", interp="Q2"),
                            P.ls.LSCurvature(interp="Q1")], {}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "fill", 0, line)
        prob.add_face_kernel(ns, P.lse.LSCurvatureWallAngle(180.0 - th)
                             if ns == "bottom" else P.ls.LSCurvatureBoundary())
    _all_nodes(mesh)
    prob.add_dirichlet("all", "fill", 0, line)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              line(mesh.coords))
    res = _newton(P, prob, x0, prob.base_params(), 5, 1e-11)
    kap = prob.get_nodal_field(_np(res.x), "ls_curvature", 0)
    kmax = float(np.abs(kap[np.isfinite(kap)]).max())
    gate(kmax < 5e-2, "straight-interface curvature")
    return _out(res.iters, [kmax], res.x)


def ls_attach(P):
    """test_ls_attach_band_localization: the attach term near the contact
    line, none far from it."""
    s = math.sin(math.pi / 4)
    out = []
    for shift in (0.0, 3.0):
        mesh = P.mesh.rectangle_mesh(8, 8, elem="QUAD9")
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        prob = P.Problem(mesh, [P.phys.Momentum(dim=2), P.phys.Continuity(),
                                P.ls.FillEquation(interp="Q2",
                                                  transient=False)],
                         {"rho": 1.0, "mu": 1.0}, **P.kw)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
        prob.add_face_kernel("bottom", P.lse.LSAttach(2, v_attach=1.0,
                                                      penalty=1.0, eps=0.2))
        prob.finalize()
        c = mesh.coords
        x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                                 s * (c[:, 0] - 0.5) + s * c[:, 1] + shift)
        R = _np(prob.residual(P.arr(x), prob.base_params()))
        uy = prob.dofmap.dof_of_node_svar[mesh.nodesets["bottom"],
                                          prob.dofmap.svar("velocity", 1)]
        out.append(R)
        out.append(float(np.abs(R[uy]).max()))
    gate(out[1] > 1e-4 and out[3] < 1e-12, "attach band")
    return _out(0, [out[1], out[3]], np.concatenate([out[0], out[2]]))


def ls_q_source(P):
    """test_ls_embedded_flux_q_source_exact: the tent profile of an
    embedded source q0 = 3."""
    k, q0 = 1.0, 3.0
    mesh = P.mesh.rectangle_mesh(20, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False),
                            _pin_fill(P, lambda X: X[:, 0] - 0.5),
                            P.ls.LSEmbeddedFlux("temperature", q0)],
                     {"k": k, "rho": 0.0, "Cp": 0.0}, **P.kw)
    prob.add_dirichlet("left", "temperature", 0, 0.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              mesh.coords[:, 0] - 0.5)
    res = _newton(P, prob, x0, _ls_params(P, prob, 0.1), 8, 1e-11)
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    xq = np.flatnonzero(np.abs(mesh.coords[:, 0] - 0.25) < 1e-12)
    mid = np.flatnonzero(np.abs(mesh.coords[:, 0] - 0.5) < 1e-12)
    gate(close(T[xq], q0 * 0.25 / (2 * k), 1e-6)
         and np.all(T[mid] < q0 / 4.0) and np.all(T[mid] > 0.8 * q0 / 4.0),
         "embedded source")
    return _out(res.iters, [T[mid].mean()], res.x)


def ls_qrad(P):
    """test_ls_qrad_equilibrates_to_ambient: T = Tref."""
    Tref = 0.7
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False),
                            _pin_fill(P, lambda X: X[:, 0] - 0.5),
                            P.ls.LSEmbeddedFlux("temperature", P.ls.qrad_flux(
                                htc=5.0, Tref=Tref))],
                     {"k": 1.0, "rho": 0.0, "Cp": 0.0}, **P.kw)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              mesh.coords[:, 0] - 0.5)
    x0 = prob.set_nodal_field(x0, "temperature", 0, 0.2)
    res = _newton(P, prob, x0, _ls_params(P, prob, 0.1), 10, 1e-11)
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    gate(close(T, Tref, 0, 1e-8), "QRAD equilibrium")
    return _out(res.iters, [T.mean()], res.x)


def ls_recoil(P):
    """test_ls_recoil_pressure_flat_interface_jump: p(liquid) - p(vapor)
    = p_r."""
    pr = 2.5
    mesh = P.mesh.rectangle_mesh(16, 4, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([len(mesh.coords) - 1], dtype=np.int32)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, transient=False),
                            P.phys.Continuity(),
                            _pin_fill(P, lambda X: X[:, 0] - 0.5),
                            P.ls.LSRecoilPressure(dim=2, p_fn=pr)],
                     {"rho": 0.0, "mu": 1.0}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              mesh.coords[:, 0] - 0.5)
    res = _newton(P, prob, x0, _ls_params(P, prob, 0.15), 8, 1e-10)
    x = _np(res.x)
    u = prob.get_nodal_field(x, "velocity", 0)
    p = prob.get_nodal_field(x, "pressure", 0)
    xs, ys = mesh.coords[:, 0], mesh.coords[:, 1]
    corner = np.isclose(xs * 16 % 1, 0) & np.isclose(ys * 4 % 1, 0)
    jump = np.mean(p[corner & (xs < 0.2)]) - np.mean(p[corner & (xs > 0.8)])
    gate(np.max(np.abs(u)) < 5e-3 * pr and close(jump, pr, 1e-2),
         "recoil jump")
    return _out(res.iters, [jump], x)


# tests/test_ls_cap_variants.py
CAP_SIGMA, CAP_R, CAP_EPS = 1.0, 0.5, 0.25


def _cap_bubble(P, extra, need_normal=False):
    ls = P.ls
    mesh = P.mesh.rectangle_mesh(12, 12, elem="QUAD9", xlim=(-1, 1),
                                 ylim=(-1, 1))
    _all_nodes(mesh)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    eqs = [P.phys.Momentum(dim=2, interp="Q2", transient=False,
                           convection=False),
           P.phys.Continuity(interp="Q1"),
           ls.FillEquation(interp="Q2", supg=0.0, transient=False)]
    if need_normal:
        eqs.append(ls.SolvedNormal(dim=2, interp="Q1"))
    prob = P.Problem(mesh, eqs + extra, {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.add_dirichlet("all", "fill", 0,
                       lambda X: CAP_R - np.linalg.norm(X, axis=1))
    for ns in ("left", "right", "top", "bottom"):
        for k in range(2):
            prob.add_dirichlet(ns, "velocity", k, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return mesh, prob


def _cap_solve(P, mesh, prob, dt=0.0, seed=False):
    extra = {"dt": dt} if dt else {}
    x0 = np.zeros(prob.dofmap.n_dof)
    if seed:
        x0 = prob.set_nodal_field(x0, "fill", 0,
                                  CAP_R - np.linalg.norm(mesh.coords, axis=1))
    res = _newton(P, prob, x0, _ls_params(P, prob, CAP_EPS, **extra), 8, 1e-8)
    x = _np(res.x)
    p = prob.get_nodal_field(x, "pressure")
    rr = np.where(np.isfinite(p), np.linalg.norm(mesh.coords, axis=1), np.inf)
    rc = np.where(np.isfinite(p), np.linalg.norm(
        mesh.coords - np.array([-1.0, -1.0]), axis=1), np.inf)
    jump = p[int(np.argmin(rr))] - p[int(np.argmin(rc))]
    u = prob.get_nodal_field(x, "velocity", 0)
    v = prob.get_nodal_field(x, "velocity", 1)
    spur = float(np.nanmax(np.hypot(np.nan_to_num(u), np.nan_to_num(v))))
    return res, jump, spur


def _cap_gate(jump):
    gate(abs(jump - CAP_SIGMA / CAP_R) < 0.12 * CAP_SIGMA / CAP_R,
         f"Laplace jump {jump}")


def csf_div_n(P, surface_div=False):
    """test_csf_div_n_static_bubble (and test_csf_div_s_n_static_bubble
    with ``surface_div``)."""
    mesh, prob = _cap_bubble(P, [P.ls.CSFDivN(dim=2, sigma=CAP_SIGMA,
                                              surface_div=surface_div)],
                             need_normal=True)
    res, jump, spur = _cap_solve(P, mesh, prob, seed=True)
    _cap_gate(jump)
    return _out(res.iters, [jump, spur], res.x)


def csf_hysing(P):
    """test_csf_hysing_static_bubble_and_damping."""
    m0, p0 = _cap_bubble(P, [P.ls.CSFSurfaceTension(dim=2, sigma=CAP_SIGMA)])
    r0, base_jump, base_spur = _cap_solve(P, m0, p0)
    mesh, prob = _cap_bubble(P, [P.ls.CSFHysing(dim=2, sigma=CAP_SIGMA,
                                                scale=1.0)])
    res, jump, spur = _cap_solve(P, mesh, prob, dt=0.05, seed=True)
    _cap_gate(jump)
    gate(abs(jump - base_jump) < 0.02 * CAP_SIGMA / CAP_R
         and spur <= base_spur * (1.0 + 1e-8), "Hysing damping")
    return _out(r0.iters + res.iters, [jump, spur, base_spur], res.x)


def csf_denner(P, solved_normal=False):
    """test_csf_denner_companion (and
    test_csf_denner_solved_normal_variant with ``solved_normal``)."""
    mesh, prob = _cap_bubble(P, [
        P.ls.CSFSurfaceTension(dim=2, sigma=CAP_SIGMA),
        P.ls.CSFDennerDiffusion(dim=2, sigma=CAP_SIGMA, scale=2.0,
                                use_solved_normal=solved_normal)],
        need_normal=solved_normal)
    res, jump, spur = _cap_solve(P, mesh, prob, dt=0.05, seed=True)
    _cap_gate(jump)
    return _out(res.iters, [jump, spur], res.x)


def ls_latent_heat(P):
    """test_ls_latent_heat_total_source: the band source totals
    rho L u_n."""
    rho, Lh, un = 2.0, 5.0, 0.4
    mesh = P.mesh.rectangle_mesh(8, 4, elem="QUAD9")
    _all_nodes(mesh)
    prob = P.Problem(mesh, [
        P.phys.Energy(interp="Q2", transient=False, convection=False),
        P.ls.FillEquation(interp="Q2", supg=0.0, transient=False),
        P.eqs.PassiveVar("velocity", 2, "Q2"),
        P.ls.LSLatentHeat(Lh, interp="Q2")], {"rho": rho, "Cp": 1.0, "k": 1.0},
        **P.kw)
    prob.add_dirichlet("all", "fill", 0, lambda c: c[:, 0] - 0.5)
    prob.add_dirichlet("all", "velocity", 0, un)
    prob.add_dirichlet("all", "velocity", 1, 0.0)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              mesh.coords[:, 0] - 0.5)
    x0 = prob.set_nodal_field(x0, "velocity", 0, un)
    R = _np(prob.residual(P.arr(x0), _ls_params(P, prob, 0.15)))
    dm = prob.dofmap
    dT = dm.dof_of_node_svar[:, dm.svar("temperature", 0)]
    tot = R[dT[dT >= 0]].sum()
    gate(close(-tot, rho * Lh * un, 5e-3), "latent heat total")
    return _out(0, [-tot], R)


# tests/test_ext_velocity.py
def _frozen_fill(P, eqs, n=16):
    mesh = P.mesh.rectangle_mesh(n, n, elem="QUAD4")
    _all_nodes(mesh)
    prob = P.Problem(mesh, [_frozen(P, "fill")] + eqs, {}, **P.kw)
    prob.add_dirichlet("all", "fill", 0, lambda c: c[:, 0] - 0.5)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              mesh.coords[:, 0] - 0.5)
    return mesh, prob, x0


def extv_callable(P):
    """test_extension_velocity_extends_interface_speed."""
    ls = P.ls
    mesh, prob, x0 = _frozen_fill(P, [ls.ExtensionVelocity(),
                                      ls.LSExtVKinematic(
                                          vnorm=lambda fv, m, p: fv.x[:, 1]
                                          + 0.5)])
    res = _newton(P, prob, x0, _ls_params(P, prob, 0.15), 6, 1e-11)
    v = prob.get_nodal_field(_np(res.x), ls.EXT_V_VAR, 0)
    gate(close(v, mesh.coords[:, 1] + 0.5, 0, 1e-8), "extension")
    return _out(res.iters, [v.mean()], res.x)


def extv_kinematic(P):
    """test_extv_kinematic_fluid_velocity."""
    ls, xp = P.ls, P.xp
    mesh, prob, x0 = _frozen_fill(P, [
        _project(P, "velocity", lambda x: xp.stack(
            [x[:, 1] + 0.5, 0.0 * x[:, 0]], 1), ncomp=2),
        ls.ExtensionVelocity(), ls.LSExtVKinematic()])
    res = _newton(P, prob, x0, _ls_params(P, prob, 0.15), 8, 1e-11)
    v = prob.get_nodal_field(_np(res.x), ls.EXT_V_VAR, 0)
    gate(close(v, mesh.coords[:, 1] + 0.5, 0, 1e-7), "kinematic extension")
    return _out(res.iters, [v.mean()], res.x)


def extv_latent(P):
    """test_extv_latent_melt_speed."""
    ls = P.ls
    g, L, dT, dt_avg = 2.0, 0.7, 0.3, 1.5
    mesh, prob, x0 = _frozen_fill(P, [
        _project(P, "temperature", lambda x: (g * x[:, 0])[:, None]),
        ls.ExtensionVelocity(),
        ls.LSExtVLatent(L_coeff=L, T_ref=g * 0.5 - dT, dt_avg=dt_avg)], n=24)
    x0 = prob.set_nodal_field(x0, "temperature", 0, lambda c: g * c[:, 0])
    res = _newton(P, prob, x0, _ls_params(P, prob, 0.12), 10, 1e-11)
    v = prob.get_nodal_field(_np(res.x), ls.EXT_V_VAR, 0)
    v_exact = -L * dT / (dt_avg * g)
    mid = np.abs(mesh.coords[:, 0] - 0.5) < 1e-9
    half = L * g * 0.12 / (2 * dt_avg * g) * 1.2
    gate(mid.sum() > 0 and close(v[mid], v_exact, 0.02)
         and (v < v_exact + half).all() and (v > v_exact - half).all(),
         "latent melt speed")
    return _out(res.iters, [v[mid].mean()], res.x)


def fill_ext_v(P):
    """test_fill_ext_v_front_translation: F(t) = x - x0 - V t."""
    ls = P.ls
    V, x0f, t_end = 0.25, 0.3, 0.4
    mesh = P.mesh.rectangle_mesh(16, 8, elem="QUAD4")
    _all_nodes(mesh)
    prob = P.Problem(mesh, [ls.FillExtV(), _frozen(P, ls.EXT_V_VAR)], {},
                     **P.kw)
    prob.add_dirichlet("all", ls.EXT_V_VAR, 0, V)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0,
                              lambda c: c[:, 0] - x0f)
    x0 = prob.set_nodal_field(x0, ls.EXT_V_VAR, 0, V)
    r = P.TransientSolver(prob, P.NewtonOptions(
        max_iter=8, tol_residual=1e-10, linear_solver="direct"),
        P.TimeOptions(t_end=t_end, dt0=0.05, adapt=False, theta=0.0)).run(
        x0, _ls_params(P, prob, 0.1))
    F = prob.get_nodal_field(_np(r.x), "fill", 0)
    gate(close(F, mesh.coords[:, 0] - x0f - V * t_end, 0, 2e-3),
         "front translation")
    return _out(sum(s.newton_iters for s in r.steps), [F.mean(), r.t], r.x)


# tests/test_ls_velo_bc.py
def _ls_cavity(P, F_fn, kernel):
    mesh = P.mesh.rectangle_mesh(10, 10, elem="QUAD9")
    _all_nodes(mesh)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False),
                            P.phys.Continuity(interp="Q1"),
                            P.ls.FillEquation(interp="Q2", supg=0.0,
                                              transient=False)],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.add_dirichlet("all", "fill", 0, F_fn)
    for ns in ("left", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 0,
                       lambda c: 16 * c[:, 0]**2 * (1 - c[:, 0])**2)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_face_kernel("right", kernel)
    prob.finalize()
    res = _newton(P, prob, np.zeros(prob.dofmap.n_dof),
                  _ls_params(P, prob, 0.2), 10, 1e-9)
    x = _np(res.x)
    u = prob.get_nodal_field(x, "velocity", 0)
    c = mesh.coords
    m = (np.isclose(c[:, 0], 1.0) & ~np.isnan(u) & (c[:, 1] < 1.0 - 1e-9)
         & (c[:, 1] > 1e-9))
    return res, float(np.max(np.abs(u[m])))


def velo_normal_ls(P):
    """test_velo_normal_ls_liquid_blocks, _gas_opens and
    _leak_angle_gate."""
    NP = P.bc.LSNoPenetration
    runs = [_ls_cavity(P, F, NP(dim=2, length=ln, leak_angle_deg=ang,
                                penalty=1e6))
            for F, ln, ang in ((lambda c: -1.0 + 0 * c[:, 0], 0.1, 135.0),
                               (lambda c: 1.0 + 0 * c[:, 0], 0.1, 135.0),
                               (lambda c: c[:, 1] - 0.5, 2.0, 135.0),
                               (lambda c: c[:, 1] - 0.5, 2.0, 45.0))]
    liquid, gas, closed, opened = (r[1] for r in runs)
    gate(liquid < 1e-4 and gas > 1e-2 and opened > 10 * closed
         and opened > 1e-2, "LS no-penetration gates")
    return _out(sum(r[0].iters for r in runs), [liquid, gas, closed, opened],
                np.concatenate([_np(r[0].x) for r in runs]))


def velo_tangent_ls(P):
    """test_velo_tangent_ls_couette: u = U y."""
    U = 0.7
    mesh = P.mesh.rectangle_mesh(6, 6, elem="QUAD9")
    _all_nodes(mesh)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False, convection=False),
                            P.phys.Continuity(interp="Q1"),
                            P.ls.FillEquation(interp="Q2", supg=0.0,
                                              transient=False)],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.add_dirichlet("all", "fill", 0, lambda c: -1.0 + 0 * c[:, 0])
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, lambda c: U * c[:, 1])
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_face_kernel("top", P.bc.LSNoPenetration(
        dim=2, vnormal=-U, tangential=True, length=0.1, penalty=1e6))
    prob.finalize()
    res = _newton(P, prob, np.zeros(prob.dofmap.n_dof),
                  _ls_params(P, prob, 0.2), 10, 1e-9)
    u = prob.get_nodal_field(_np(res.x), "velocity", 0)
    m = ~np.isnan(u)
    gate(close(u[m], U * mesh.coords[m, 1], 0, 2e-4), "tangent Couette")
    return _out(res.iters, [u[m].max()], res.x)


ADC_SEED = 7


def ls_adc(P):
    """test_ls_adc_capture_and_gates with numpy's ``default_rng(ADC_SEED)``:
    the near drop captures, the far and the edge-on ones never do; the
    reading is every draw's outcome and the captured F."""
    mesh = P.mesh.rectangle_mesh(10, 6, elem="QUAD9", xlim=(0, 1),
                                 ylim=(0, 0.6))
    c = mesh.coords
    rng = np.random.default_rng(ADC_SEED)
    F = 0.2 - np.sqrt((c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.25) ** 2)
    F_new, ev = P.ls.apply_ls_adc(mesh, F, "bottom", capture_angle_deg=25.0,
                                  capture_distance=0.1, capture_rate=1e4,
                                  dt=0.1, rng=rng)
    moved = np.where(F_new != F)[0]
    F_far = 0.1 - np.sqrt((c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.45) ** 2)
    far = [P.ls.apply_ls_adc(mesh, F_far, "bottom", capture_angle_deg=25.0,
                             capture_distance=0.02, capture_rate=10.0,
                             dt=0.01, rng=rng)[1] for _ in range(20)]
    _, ev_perp = P.ls.apply_ls_adc(mesh, c[:, 0] - 0.5, "bottom",
                                   capture_angle_deg=25.0,
                                   capture_distance=0.5, capture_rate=1e4,
                                   dt=1.0, rng=rng)
    gate(ev and moved.size > 0 and np.allclose(c[moved, 1], 0.0)
         and not any(far) and not ev_perp, "ADC capture and gates")
    return _out(0, [float(ev), moved.size, float(any(far)), float(ev_perp),
                    rng.random()], F_new)


# tests/test_surface_domain.py
def _two_block_strip(P, nx, ny):
    gx, gy = 2 * nx + 1, ny + 1
    X, Y = np.meshgrid(np.linspace(0, 1, gx), np.linspace(0, 1, gy),
                       indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    conn_a, conn_b = [], []
    for j in range(ny):
        for i in range(2 * nx):
            q = [j * gx + i, j * gx + i + 1, (j + 1) * gx + i + 1,
                 (j + 1) * gx + i]
            (conn_a if i < nx else conn_b).append(q)
    B = P.meshmod.Block
    mesh = P.meshmod.Mesh(2, coords, [
        B("A", "QUAD4", np.asarray(conn_a, dtype=np.int32)),
        B("B", "QUAD4", np.asarray(conn_b, dtype=np.int32))])
    mesh.nodesets = {
        "left": np.where(np.isclose(coords[:, 0], 0.0))[0].astype(np.int32),
        "right": np.where(np.isclose(coords[:, 0], 1.0))[0].astype(np.int32)}
    mesh.sidesets = {}
    return mesh


def _strip_problem(P, nx, D, mtc, Yc):
    mesh = _two_block_strip(P, nx, 2)
    pairs = P.interface.find_interface_faces(mesh, 0, 1)
    orig, new = P.interface.split_interface(mesh, pairs)
    sp = lambda: [P.phys.Species(1, interp="Q1", transient=False,  # noqa: E731
                                 convection=False)]
    prob = P.Problem(mesh, [sp(), sp()], [{"diffusivity": D[0]},
                                          {"diffusivity": D[1]}], **P.kw)
    prob.add_interface_kernel(pairs, P.sdom.SurfDomainMassFlux(mtc=mtc,
                                                               Y_c=Yc))
    return mesh, prob, orig, new


def surfdomain_mass_flux(P):
    """test_surfdomain_mass_flux_exact."""
    Da, Db, mtc, Yc = 1.5, 0.4, 2.0, 0.0
    mesh, prob, orig, new = _strip_problem(P, 4, (Da, Db), mtc, Yc)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.finalize()
    res = _newton(P, prob, np.zeros(prob.dofmap.n_dof), prob.base_params(),
                  4, 1e-11)
    Y = prob.get_nodal_field(_np(res.x), "species")
    q = mtc * (1.0 - Yc) / (1.0 + 0.5 * mtc / Da)
    x = mesh.coords[:, 0]
    exact = np.where(x <= 0.5, 1.0 - q * x / Da, q * (1.0 - x) / Db)
    exact[new] = 0.5 * q / Db
    gate(close(Y, exact, 0, 1e-9)
         and close(Y[orig].mean(), 1.0 - 0.5 * q / Da, 0, 1e-9),
         "surface-domain flux")
    return _out(res.iters, [Y[orig].mean()], res.x)


def sdc_stefan_flow(P):
    """test_sdc_stefan_flow_induced_velocity: v_y = W S / rho."""
    W, S, rho = 0.8, 0.25, 1.0
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9")
    prob = P.Problem(mesh, [[P.phys.Momentum(2, interp="Q2", transient=False,
                                             convection=False),
                             P.phys.Continuity(interp="Q1")]],
                     [{"rho": rho, "mu": 1.0}], **P.kw)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
    prob.add_dirichlet("top", "pressure", 0, 0.0)
    prob.add_face_kernel("bottom", P.sdom.SDCStefanFlow(
        2, [W], lambda sfv, mat, params: S + 0.0 * sfv.x[:, :1],
        penalty=1e8))
    prob.finalize()
    res = _newton(P, prob, np.zeros(prob.dofmap.n_dof), prob.base_params(),
                  6, 1e-9)
    x = _np(res.x)
    vy = prob.get_nodal_field(x, "velocity", 1)
    vx = prob.get_nodal_field(x, "velocity", 0)
    gate(close(vy, W * S / rho, 0, 1e-6) and close(vx, 0.0, 0, 1e-6),
         "Stefan flow")
    return _out(res.iters, [np.nanmean(vy)], x)


def sdc_numjac(P):
    """test_sdc_jacobian_ad_vs_fd."""
    mesh, prob, _, _ = _strip_problem(P, 3, (1.0, 2.0), 1.7, 0.3)
    prob.finalize()
    x = np.random.RandomState(0).randn(prob.dofmap.n_dof)
    chk = P.numjac.numerical_jacobian_check(prob, x, prob.base_params(),
                                            n_columns=14)
    gate(chk.ok, chk.report())
    R = _np(prob.residual(P.arr(x), prob.base_params()))
    return _out(0, [chk.n_checked, chk.n_bad], R)


# tests/test_ls_round2.py
def xfem_bubble(P):
    """test_xfem_static_bubble_pressure_jump: the enriched pressure's
    Laplace jump within 5% of sigma / R and its spurious currents below
    half the plain ones."""
    ls = P.ls
    sigma, R = 1.0, 0.5
    out = {}
    xs = []
    newton = 0
    for xfem in (False, True):
        mesh = P.mesh.rectangle_mesh(16, 16, elem="QUAD9", xlim=(-1, 1),
                                     ylim=(-1, 1))
        _all_nodes(mesh)
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        eqs = [P.phys.Momentum(dim=2, interp="Q2", transient=False,
                               convection=False),
               P.phys.Continuity(interp="Q1"),
               ls.FillEquation(interp="Q2", supg=0.0, transient=False),
               ls.CSFSurfaceTension(dim=2, sigma=sigma)]
        if xfem:
            eqs += [ls.XFEMPressureContinuity(interp="Q1"),
                    ls.XFEMPressureMomentum(dim=2)]
        prob = P.Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0}, **P.kw)
        prob.add_dirichlet("all", "fill", 0,
                           lambda X: R - np.linalg.norm(X, axis=1))
        for ns in ("left", "right", "top", "bottom"):
            prob.add_dirichlet(ns, "velocity", 0, 0.0)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
        prob.finalize()
        res = _newton(P, prob, np.zeros(prob.dofmap.n_dof),
                      _ls_params(P, prob, 0.2), 6, 1e-9)
        x = _np(res.x)
        newton += res.iters
        xs.append(x)
        umax = np.nanmax(np.hypot(prob.get_nodal_field(x, "velocity", 0),
                                  prob.get_nodal_field(x, "velocity", 1)))
        p = prob.get_nodal_field(x, "pressure")
        center = int(np.argmin(np.linalg.norm(mesh.coords, axis=1)))
        corner = int(np.argmin(np.linalg.norm(mesh.coords - np.array(
            [-1, -1]), axis=1)))
        out[xfem] = (float(umax), float(p[center] - p[corner]))
    gate(abs(out[True][1] - sigma / R) < 0.05 * sigma / R
         and out[True][0] < 0.5 * out[False][0], f"XFEM bubble {out}")
    return _out(newton, [out[False][0], out[True][0], out[True][1]],
                np.concatenate(xs))


# tests/test_level_set.py
def ls_curvature_circle(P):
    """test_ls_curvature_circle: kappa = 1 / r off a circle centred
    outside the domain."""
    cx, cy, R = -0.2, 0.5, 0.5
    mesh = P.mesh.rectangle_mesh(16, 16, elem="QUAD9")
    _all_nodes(mesh)
    prob = P.Problem(mesh, [_frozen(P, "fill", interp="Q2"),
                            P.ls.LSCurvature(interp="Q2")], {}, **P.kw)
    dist = lambda c: np.sqrt((c[:, 0] - cx) ** 2 + (c[:, 1] - cy) ** 2) - R  # noqa: E731
    prob.add_dirichlet("all", "fill", 0, dist)
    for ss in ("left", "right", "top", "bottom"):
        prob.add_face_kernel(ss, P.ls.LSCurvatureBoundary())
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, dist)
    res = _newton(P, prob, x0, prob.base_params(), 3, 1e-11)
    kap = prob.get_nodal_field(_np(res.x), "ls_curvature", 0)
    r = np.sqrt((mesh.coords[:, 0] - cx) ** 2 + (mesh.coords[:, 1] - cy) ** 2)
    rel = np.abs(kap * r - 1.0)
    gate(np.percentile(rel, 90) < 0.03 and rel.max() < 0.12, "curvature")
    return _out(res.iters, [np.percentile(rel, 90), rel.max()], res.x)


# tests/test_bc_catalog3.py
def _couette(P, mu, slip_kernel, nx=4, ny=8, extra=(), mat=None):
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 0.5),
                                 ylim=(0, 1.0))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    _all_nodes(mesh)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False),
                            P.phys.Continuity(interp="Q1")] + list(extra),
                     {"rho": 1.0, "mu": mu, **(mat or {})}, **P.kw)
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_face_kernel("bottom", slip_kernel)
    return mesh, prob


def _cat_solve(P, prob, x0=None, params=None):
    return _newton(P, prob, np.zeros(prob.dofmap.n_dof) if x0 is None else x0,
                   prob.base_params() if params is None else params, 25, 1e-11)


def power_law_slip(P):
    """test_power_law_slip_couette and _reduces_to_navier."""
    outs = []
    for m, beta, exact in (
            (2.0, 2.0, lambda y: (np.sqrt(5.0) - 1) / 2 * (1 - y) + y),
            (1.0, 2.0, lambda y: (y + 1.0) / 2.0)):
        mesh, prob = _couette(P, 0.5, P.bc.PowerLawSlip(dim=2, beta=beta, m=m))
        prob.finalize()
        res = _cat_solve(P, prob)
        ux = prob.get_nodal_field(_np(res.x), "velocity", 0)
        ok = ~np.isnan(ux)
        gate(close(ux[ok], exact(mesh.coords[ok, 1]), 0,
                   2e-6 if m == 2.0 else 1e-7), f"power-law slip m={m}")
        outs.append(res)
    return _out(sum(r.iters for r in outs), [_np(r.x).max() for r in outs],
                np.concatenate([_np(r.x) for r in outs]))


def electrokinetic_slip(P):
    """test_electrokinetic_slip_helmholtz_smoluchowski."""
    mu, epsp, zeta, V0, L, H, beta = 0.5, 2.0, -0.25, 3.0, 0.5, 1.0, 0.05
    mesh = P.mesh.rectangle_mesh(4, 8, elem="QUAD9", xlim=(0, L), ylim=(0, H))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False),
                            P.phys.Continuity(interp="Q1"),
                            P.phys.Potential(interp="Q2")],
                     {"rho": 1.0, "mu": mu, "kappa": 1.0}, **P.kw)
    prob.add_dirichlet("top", "velocity", 0, 0.0)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_dirichlet("left", "voltage", 0, V0)
    prob.add_dirichlet("right", "voltage", 0, 0.0)
    prob.add_face_kernel("bottom", P.bc.ElectrokineticSlip(
        dim=2, permittivity=epsp, zeta=zeta, beta=beta))
    prob.finalize()
    res = _cat_solve(P, prob)
    u0 = abs(epsp * zeta * V0 / L / mu) / (1.0 + beta * mu / H)
    ux = prob.get_nodal_field(_np(res.x), "velocity", 0)
    y = mesh.coords[:, 1]
    ok = ~np.isnan(ux)
    u_bot = ux[ok & np.isclose(y, 0.0)]
    gate(np.allclose(np.abs(u_bot), u0, atol=1e-6)
         and close(ux[ok], np.sign(u_bot[0]) * u0 * (1.0 - y[ok]), 0, 1e-6),
         "electrokinetic slip")
    return _out(res.iters, [u_bot[0]], res.x)


def level_set_slip(P):
    """test_level_set_slip_wet_dry_limits."""
    mu, bw, bd, eps_ls = 0.5, 2.0, 0.02, 0.1
    outs = []
    for F0, beta in ((1.0, bw), (-1.0, bd)):
        mesh, prob = _couette(P, mu, P.bc.LevelSetSlip(
            dim=2, beta_wet=bw, beta_dry=bd, eps_ls=eps_ls), nx=3, ny=6,
            extra=[P.ls.FillEquation(interp="Q2", transient=False,
                                     supg=0.0)])
        prob.add_dirichlet("all", "fill", 0, F0)
        prob.finalize()
        res = _cat_solve(P, prob)
        Ls = mu * beta
        ux = prob.get_nodal_field(_np(res.x), "velocity", 0)
        ok = ~np.isnan(ux)
        gate(close(ux[ok], (mesh.coords[ok, 1] + Ls) / (1.0 + Ls), 0, 1e-7),
             "level-set slip")
        outs.append(res)
    return _out(sum(r.iters for r in outs), [_np(r.x).max() for r in outs],
                np.concatenate([_np(r.x) for r in outs]))


def slip_heating(P):
    """test_slip_heating_couette: T(y) = q0 (H - y) / k."""
    mu, beta, k = 0.5, 2.0, 0.8
    Ls = mu * beta
    q0 = (Ls / (1.0 + Ls)) ** 2 / beta
    mesh, prob = _couette(P, mu, P.bc.NavierSlip(dim=2, beta=beta),
                          extra=[P.phys.Energy(interp="Q2", transient=False)],
                          mat={"k": k, "Cp": 1.0})
    prob.add_dirichlet("top", "temperature", 0, 0.0)
    prob.add_face_kernel("bottom", P.bc.SlipHeating(dim=2, beta=beta))
    prob.finalize()
    res = _cat_solve(P, prob)
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    ok = ~np.isnan(T)
    gate(close(T[ok], q0 * (1.0 - mesh.coords[ok, 1]) / k, 0, 1e-7),
         "slip heating")
    return _out(res.iters, [np.nanmax(T)], res.x)


def qvapor_slab(P):
    """test_qvapor_slab_exact: linear through (T0, T_top), T_top from the
    Kanouff balance by bisection."""
    T0, T_boil, k, H = 400.0, 300.0, 50.0, 1.0
    qv = P.ls.vapor_cool(T_boil, T_scale=1.0, q_scale=1e-3)
    lo, hi = T_boil, T0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if k * (T0 - mid) / H - float(_np(qv(P.arr(np.float64(mid))))) > 0:
            lo = mid
        else:
            hi = mid
    T_top = 0.5 * (lo + hi)
    mesh = P.mesh.rectangle_mesh(3, 6, elem="QUAD9", xlim=(0, 0.5),
                                 ylim=(0, H))
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False,
                                          convection=False)],
                     {"k": k, "rho": 1.0, "Cp": 1.0}, **P.kw)
    prob.add_dirichlet("bottom", "temperature", 0, T0)
    prob.add_face_kernel("top", P.bc.QVaporFlux(T_boil=T_boil, q_scale=1e-3))
    prob.finalize()
    res = _cat_solve(P, prob, np.full(prob.dofmap.n_dof, T0))
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    ok = ~np.isnan(T)
    gate(T_boil < T_top < T0 and close(
        T[ok], T0 + (T_top - T0) * mesh.coords[ok, 1] / H, 2e-7),
        "vapor slab")
    return _out(res.iters, [T_top], res.x)


def laser_weld(P):
    """test_laser_weld_energy_balance: the bottom's convective loss equals
    the absorbed Gaussian power."""
    Pw, w, xc, h, L = 10.0, 0.3, 1.0, 5.0, 2.0
    mesh = P.mesh.rectangle_mesh(16, 6, elem="QUAD9", xlim=(0, L),
                                 ylim=(0, 0.5))
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False,
                                          convection=False)],
                     {"k": 1.0, "rho": 1.0, "Cp": 1.0}, **P.kw)
    prob.add_face_kernel("top", P.bc.LaserWeldFlux(power=Pw, radius=w,
                                                   center=(xc, 0.5)))
    prob.add_face_kernel("bottom", P.bc.ConvectiveHeatFlux(h=h, T_inf=0.0))
    prob.finalize()
    res = _cat_solve(P, prob)
    q_bot = P.post.sideset_integral(
        prob, "bottom",
        lambda sfv, mat, params: h * sfv.val["temperature"][:, 0])
    out = float(_np(q_bot(res.x, prob.base_params())))
    R = -math.log(1.0 - 0.4522)
    a = math.sqrt(R) / w
    p_in = Pw * 2.0 * R * (math.sqrt(math.pi) / (2.0 * a)) * (
        math.erf(a * (L - xc)) + math.erf(a * xc))
    gate(close(out, p_in, 1e-6), "laser energy balance")
    return _out(res.iters, [out], res.x)


def ls_embedded_dirichlet(P):
    """test_ls_embedded_dirichlet_temperature: T = 2 on the band,
    piecewise linear off it."""
    mesh = P.mesh.rectangle_mesh(32, 2, elem="QUAD9", xlim=(0, 1),
                                 ylim=(0, 0.1))
    _all_nodes(mesh)
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False,
                                          convection=False),
                            P.ls.FillEquation(interp="Q2", transient=False,
                                              supg=0.0),
                            P.ls.LSEmbeddedDirichlet("temperature", 2.0,
                                                     penalty=1e8,
                                                     interp="Q2")],
                     {"k": 1.0, "rho": 1.0, "Cp": 1.0}, **P.kw)
    prob.add_dirichlet("left", "temperature", 0, 0.0)
    prob.add_dirichlet("right", "temperature", 0, 3.0)
    prob.add_dirichlet("all", "fill", 0, lambda c: c[:, 0] - 0.5)
    prob.finalize()
    res = _cat_solve(P, prob, params=_ls_params(P, prob, 0.06))
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    x = mesh.coords[:, 0]
    ok = ~np.isnan(T)
    good = close(T[ok & (np.abs(x - 0.5) < 0.04)], 2.0, 0, 1e-5)
    for xa, xb in ((0.125, 0.25), (0.09375, 0.28125)):
        Ta, Tb = T[ok & np.isclose(x, xa)][0], T[ok & np.isclose(x, xb)][0]
        Tc = T[ok & np.isclose(x, 1 - xa)][0]
        Td = T[ok & np.isclose(x, 1 - xb)][0]
        good = good and close(Tb / Ta, xb / xa, 1e-6) and close(
            (3 - Td) / (3 - Tc), xb / xa, 1e-6)
    order = np.argsort(x[ok])
    gate(good and np.all(np.diff(T[ok][order]) > -1e-5), "embedded Dirichlet")
    return _out(res.iters, [T[ok & np.isclose(x, 0.5)].mean()], res.x)


def ls_flow_pressure(P):
    """test_ls_flow_pressure_static_jump: p(+) - p(-) = P at rest."""
    P0 = 2.5
    mesh = P.mesh.rectangle_mesh(24, 6, elem="QUAD9", xlim=(0, 1),
                                 ylim=(0, 0.25))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    _all_nodes(mesh)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False),
                            P.phys.Continuity(interp="Q1"),
                            P.ls.FillEquation(interp="Q2", transient=False,
                                              supg=0.0),
                            P.ls.LSFlowPressure(dim=2, p0=P0)],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_dirichlet("all", "fill", 0, lambda c: c[:, 0] - 0.5)
    prob.finalize()
    res = _cat_solve(P, prob, params=_ls_params(P, prob, 0.1))
    x = _np(res.x)
    u = prob.get_nodal_field(x, "velocity", 0)
    p = prob.get_nodal_field(x, "pressure", 0)
    xc = mesh.coords[:, 0]
    left = ~np.isnan(p) & (xc < 0.5 - 0.12)
    right = ~np.isnan(p) & (xc > 0.5 + 0.12)
    jump = np.nanmean(p[right]) - np.nanmean(p[left])
    gate(np.nanmax(np.abs(u)) < 1e-3 and close(p[left], 0.0, 0, 5e-3)
         and close(jump, P0, 1e-3), "flow-pressure jump")
    return _out(res.iters, [jump], x)


# tests/test_acoustic_bc.py, test_electrode_ni.py, test_bc_traction.py
def _strip_1d(P, eqs, mat):
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9", xlim=(0, 1.0),
                                 ylim=(0, 0.2))
    _all_nodes(mesh)
    prob = P.Problem(mesh, eqs + [P.eqs.PassiveVar("velocity", 2, "Q2")], mat,
                     **P.kw)
    return mesh, prob


def latent_heat_internal(P):
    """test_acoustic_bc.py::test_latent_heat_internal_flux:
    T = Tb - rho L v_n x / k."""
    rho, L_h, vn, k, Tb = 2.0, 5.0, 0.3, 4.0, 1.0
    mesh, prob = _strip_1d(P, [P.phys.Energy(interp="Q2", transient=False,
                                             convection=False)],
                           {"rho": rho, "Cp": 1.0, "k": k})
    prob.add_dirichlet("left", "temperature", 0, Tb)
    prob.add_dirichlet("all", "velocity", 0, vn)
    prob.add_dirichlet("all", "velocity", 1, 0.0)
    prob.add_face_kernel("right", P.bc.LatentHeatInternal(L_h))
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity", 0, vn)
    res = _newton(P, prob, x0, prob.base_params(), 5, 1e-11)
    T = prob.get_nodal_field(_np(res.x), "temperature", 0)
    gate(close(T, Tb - rho * L_h * vn / k * mesh.coords[:, 0], 0, 1e-8),
         "latent heat internal")
    return _out(res.iters, [T.min()], res.x)


def species_kinematic(P):
    """test_electrode_ni.py::test_species_kinematic_flux_balance."""
    D, L, Yb, vn = 0.5, 1.0, 0.3, 0.8
    mesh, prob = _strip_1d(P, [P.phys.Species(1, interp="Q2", transient=False,
                                              convection=False)],
                           {"diffusivity": D, "rho": 1.0})
    prob.add_dirichlet("left", "species", 0, Yb)
    prob.add_dirichlet("all", "velocity", 0, vn)
    prob.add_dirichlet("all", "velocity", 1, 0.0)
    prob.add_face_kernel("right", P.bc.SpeciesKinematicFlux())
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, Yb)
    x0 = prob.set_nodal_field(x0, "velocity", 0, vn)
    res = _newton(P, prob, x0, prob.base_params(), 10, 1e-11)
    Y = prob.get_nodal_field(_np(res.x), "species", 0)
    Ys = Y[np.isclose(mesh.coords[:, 0], L)].mean()
    gate(close(Ys, D * Yb / (D + vn * L), 1e-8), "kinematic species")
    return _out(res.iters, [Ys], res.x)


def air_film_slip(P):
    """test_bc_traction.py::test_air_film_slip_navier_equivalence: AIR_FILM
    (gas_flow 0) gives NavierSlip's solution (beta 1/gas_mu, all
    components)."""
    gas_mu, U = 3.0, 0.4
    xs, newton = [], 0
    for kern in (P.bc.AirFilmSlip(dim=2, gas_mu=gas_mu, v_s=(0.2, 0.0)),
                 P.bc.NavierSlip(dim=2, beta=1.0 / gas_mu, u_wall=(0.2, 0.0),
                                 tangential_only=False)):
        mesh = P.mesh.rectangle_mesh(5, 3, elem="QUAD9")
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        p = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                             transient=False),
                             P.phys.Continuity(interp="Q1")],
                      {"rho": 1.0, "mu": 1.0}, **P.kw)
        p.add_dirichlet("top", "velocity", 0, U)
        for ns, c in (("top", 1), ("left", 0), ("left", 1), ("right", 0),
                      ("right", 1)):
            p.add_dirichlet(ns, "velocity", c, 0.0)
        p.add_dirichlet("pin", "pressure", 0, 0.0)
        p.add_face_kernel("bottom", kern)
        p.finalize()
        r = _newton(P, p, np.zeros(p.dofmap.n_dof), p.base_params(), 8, 1e-10)
        newton += r.iters
        xs.append(_np(r.x))
    gate(close(xs[0], xs[1], 0, 1e-10), "air film against Navier slip")
    return _out(newton, [xs[0].max()], xs[0])


SMALL = {
    "distng_stefan": distng_stefan,
    "ls_wall_angle": ls_wall_angle,
    "ls_ca_h": ls_ca_h,
    "ls_attach": ls_attach,
    "ls_q_source": ls_q_source,
    "ls_qrad": ls_qrad,
    "ls_recoil": ls_recoil,
    "csf_div_n": csf_div_n,
    "csf_div_s_n": lambda P: csf_div_n(P, surface_div=True),
    "csf_hysing": csf_hysing,
    "csf_denner": csf_denner,
    "csf_denner_normal": lambda P: csf_denner(P, solved_normal=True),
    "ls_latent_heat": ls_latent_heat,
    "extv_callable": extv_callable,
    "extv_kinematic": extv_kinematic,
    "extv_latent": extv_latent,
    "fill_ext_v": fill_ext_v,
    "velo_normal_ls": velo_normal_ls,
    "velo_tangent_ls": velo_tangent_ls,
    "ls_adc": ls_adc,
    "surfdomain_mass_flux": surfdomain_mass_flux,
    "sdc_stefan_flow": sdc_stefan_flow,
    "sdc_numjac": sdc_numjac,
    "xfem_bubble": xfem_bubble,
    "ls_curvature_circle": ls_curvature_circle,
    "power_law_slip": power_law_slip,
    "electrokinetic_slip": electrokinetic_slip,
    "level_set_slip": level_set_slip,
    "slip_heating": slip_heating,
    "qvapor_slab": qvapor_slab,
    "laser_weld": laser_weld,
    "ls_embedded_dirichlet": ls_embedded_dirichlet,
    "ls_flow_pressure": ls_flow_pressure,
    "latent_heat_internal": latent_heat_internal,
    "species_kinematic": species_kinematic,
    "air_film_slip": air_film_slip,
}
