"""The solid-mechanics and porous-media decks, written once for both
packages.

Every function here takes a package namespace ``P`` (see ``namespace``):
goma_tpu's modules and ``jax.numpy`` from ``scripts/solid_reference.py``
and the port's tests, the port's modules and ``torch`` from
``chip_smoke.py``. Callables are written in the operations ``jax.numpy``
and ``torch`` share, so one deck is one definition. This module imports
neither package: ``namespace`` imports the one it is given by name.

- ``fsi_column(P, nx, ny, model, P0)``: the conforming FSI column of
  tests/test_fsi_conforming.py at ``nx`` x ``ny`` QUAD9 on [0, 2] x [0, 1]:
  a Stokes fluid on [0, 1]^2 (Q2/Q1, mu = 1) pressurized by
  ``FlowPressure(p0=P0)`` on its left side pushes a solid on [1, 2] x
  [0, 1] (Q2, G = 10, lambda = 5, ``model`` "linear" or "nonlinear")
  through ``tie_fluid_solid``; the solid's right end is fixed and its top
  and bottom slide (uniaxial strain). The linear solid's exact
  displacement is u = P0 (L - x)/(2G + lambda).
- ``richards(P, n)``: Richards infiltration into a 100 cm x 100 cm slab
  (``n`` x ``n`` QUAD9, Q2 ``PorousFlow``) with the van Genuchten soil of
  Celia, Bouloutas & Zarba (1990, Water Resour. Res. 26(7)): alpha =
  0.0335 /cm, n = 2, theta_s = 0.368, theta_r = 0.102, K_s = 0.00922 cm/s,
  pressure head in cm, gravity (0, -1); head -1000 cm at the start and at
  the bottom, -75 cm at the top. ``richards_time`` takes
  ``RICHARDS_STEPS`` backward-Euler steps from dt = ``RICHARDS_DT`` s
  without adaptation (a failed step halves dt, as the transient driver
  does), each Newton solve allowed ``RICHARDS_MAX_ITER`` iterations: at
  128 x 128 the wetting front moves about five elements (3.9 cm) in 900 s.
  ``profile`` reads the head down the wetted top of the slab.
- ``SMALL``: goma_tpu's tests' decks of the slice at their own sizes, on
  their own solvers (host ``direct``; the transient ones under the
  transient solver), each checking the test's own gate and returning its
  Newton count, its readings and its solution.
"""

from __future__ import annotations

import importlib
import types

import numpy as np

from scripts.shell_decks import _np, _out, _solve, close, gate, samples

FSI_G, FSI_LAM, FSI_L = 10.0, 5.0, 2.0
RICHARDS_DT, RICHARDS_STEPS, RICHARDS_MAX_ITER = 50.0, 30, 40
PROFILE_DEPTH = 16.0
VG_ALPHA, VG_N = 0.0335, 2.0
THETA_S, THETA_R, K_S = 0.368, 0.102, 0.00922
H_INIT, H_TOP = -1000.0, -75.0


def namespace(pkg: str, xp, arr, device=None):
    """The namespace the decks read for package ``pkg`` ("goma_tpu" or
    "goma_tpu_torch"): its mesh generators and mesh classes, Problem, the
    physics and condition modules of the slice, ``fem.equations``, the
    solvers, ``post.postproc``, ``utils.numjac``, the array module ``xp``,
    ``arr`` (a numpy array onto the package's device) and the Problem's
    device keyword."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    solvers, transient = mod("solvers"), mod("solvers.transient")
    return types.SimpleNamespace(
        pkg=pkg, mesh=mod("mesh"), meshm=mod("mesh.mesh"),
        interface=mod("mesh.interface"), immersed=mod("mesh.immersed"),
        Problem=mod("fem").Problem, phys=mod("physics"),
        solid=mod("physics.solid"), porous=mod("physics.porous"),
        overset=mod("physics.overset"), fluid_bc=mod("bc.fluid"),
        traction=mod("bc.traction"), contact=mod("bc.contact"),
        leak=mod("bc.porous_leak"), free_surface=mod("bc.free_surface"),
        eqs=mod("fem.equations"), MESH_VAR=mod("fem.fields").MESH_VAR,
        post=mod("post.postproc"), numjac=mod("utils.numjac"),
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


# ------------------------------------------------------------ FSI column
def fsi_mesh(P, nx=8, ny=4, xsplit=1.0, L=FSI_L, H=1.0):
    """tests/test_fsi_conforming.py::_fsi_mesh: the fluid block left of
    ``xsplit``, the solid block right of it, the interface side set of the
    fluid block and the fluid's left inlet side set."""
    m0 = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, L), ylim=(0, H))
    blk = m0.blocks[0]
    xc = m0.coords[blk.conn].mean(axis=1)[:, 0]
    left = xc < xsplit
    mesh = P.meshm.Mesh(2, m0.coords, [
        P.meshm.Block("fluid", blk.elem_type, blk.conn[left]),
        P.meshm.Block("solid", blk.elem_type, blk.conn[~left])])
    c = mesh.coords
    mesh.nodesets = {
        "left": np.where(np.isclose(c[:, 0], 0.0))[0].astype(np.int32),
        "right": np.where(np.isclose(c[:, 0], L))[0].astype(np.int32),
        "iface": np.where(np.isclose(c[:, 0], xsplit))[0].astype(np.int32)}
    fn = np.unique(mesh.blocks[0].conn)
    sn = np.unique(mesh.blocks[1].conn)
    mesh.nodesets["fluid_tb"] = fn[
        (np.isclose(c[fn, 1], 0.0) | np.isclose(c[fn, 1], H))].astype(np.int32)
    mesh.nodesets["solid_tb"] = sn[
        (np.isclose(c[sn, 1], 0.0) | np.isclose(c[sn, 1], H))].astype(np.int32)
    mesh.sidesets = {}
    pairs = P.interface.find_interface_faces(mesh, 0, 1)
    mesh.sidesets["iface_fluid"] = P.meshm.SideSet(elems=pairs.elems_a,
                                                   faces=pairs.faces_a)
    fl = [e for e in range(mesh.blocks[0].n_elem)
          if np.isclose(c[mesh.blocks[0].conn[e]][:, 0].min(), 0.0)]
    mesh.sidesets["left"] = P.meshm.SideSet(
        elems=np.asarray(fl, dtype=np.int32),
        faces=np.full(len(fl), 3, dtype=np.int32))
    return mesh


def fsi_column(P, nx=8, ny=4, model="linear", P0=0.2):
    """The pressurized FSI column (module docstring), finalized, unsolved."""
    mesh = fsi_mesh(P, nx, ny)
    ph, S = P.phys, P.solid
    eqs = [[ph.Momentum(dim=2, interp="Q2", transient=False,
                        convection=False), ph.Continuity(interp="Q1")],
           [S.RealSolid(dim=2, interp="Q2", model=model)]]
    mats = [{"rho": 1.0, "mu": 1.0},
            {"lame_mu": FSI_G, "lame_lambda": FSI_LAM}]
    prob = P.Problem(mesh, eqs, mats, **P.kw)
    prob.add_face_kernel("left", P.fluid_bc.FlowPressure(dim=2, p0=P0))
    prob.add_dirichlet("fluid_tb", "velocity", 0, 0.0)
    prob.add_dirichlet("fluid_tb", "velocity", 1, 0.0)
    prob.add_dirichlet("right", S.SOLID_VAR, 0, 0.0)
    prob.add_dirichlet("right", S.SOLID_VAR, 1, 0.0)
    prob.add_dirichlet("solid_tb", S.SOLID_VAR, 1, 0.0)
    S.tie_fluid_solid(prob, "iface", dim=2)
    prob.finalize()
    return prob


def fsi_exact_error(prob, x, P0):
    """max |u - P0 (L - x)/(2G + lambda)| over the solid's nodes (the
    linear solid's exact uniaxial-strain displacement), max |u_fluid| and
    max |p - P0| over the fluid's nodes."""
    mesh = prob.mesh
    dx = prob.get_nodal_field(_np(x), "solid_displacement", 0)
    sn = np.unique(mesh.blocks[1].conn)
    fn = np.unique(mesh.blocks[0].conn)
    u_ex = P0 / (2 * FSI_G + FSI_LAM) * (FSI_L - mesh.coords[sn, 0])
    u = prob.get_nodal_field(_np(x), "velocity", 0)[fn]
    p = prob.get_nodal_field(_np(x), "pressure", 0)[fn]
    return (float(np.abs(dx[sn] - u_ex).max()), float(np.nanmax(np.abs(u))),
            float(np.nanmax(np.abs(p[np.isfinite(p)] - P0))))


# ------------------------------------------------------------- Richards
def richards(P, n):
    """The Richards infiltration slab (module docstring), finalized.
    Returns (problem, x0)."""
    s_res = THETA_R / THETA_S
    vg = P.porous.VanGenuchten(alpha=VG_ALPHA, n=VG_N, s_res=s_res)
    mesh = P.mesh.rectangle_mesh(n, n, elem="QUAD9", xlim=(0, 100.0),
                                 ylim=(0, 100.0))
    mat = {"permeability": K_S, "mu_liquid": 1.0, "porosity": THETA_S,
           "rho_liquid": 1.0, "gravity_vec": (0.0, -1.0)}
    prob = P.Problem(mesh, [P.porous.PorousFlow(model=vg, interp="Q2")],
                     mat, **P.kw)
    prob.add_dirichlet("bottom", "porous_pressure", 0, H_INIT)
    prob.add_dirichlet("top", "porous_pressure", 0, H_TOP)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "porous_pressure",
                              0, H_INIT)
    top = prob.dofmap.node_dofs("porous_pressure", mesh.nodesets["top"], 0)
    x0[top] = H_TOP
    return prob, x0


def richards_time(P, steps=RICHARDS_STEPS):
    """Backward Euler from dt0 = ``RICHARDS_DT`` without adaptation, to
    ``steps`` accepted steps or t = ``steps`` dt0, whichever comes first."""
    return P.TimeOptions(dt0=RICHARDS_DT, t_end=steps * RICHARDS_DT,
                         max_steps=steps, adapt=False, theta=0.0)


def step_records(res):
    """(t, dt, Newton iterations, converged) of every attempt a transient
    run kept."""
    return [[float(s.t), float(s.dt), int(s.newton_iters), bool(s.converged)]
            for s in res.steps]


def front_depth(prob, x):
    """The wetting front's depth below the top (cm): 100 minus the height
    of the lowest node wetter than h = -500 cm."""
    h = prob.get_nodal_field(_np(x), "porous_pressure", 0)
    y = prob.mesh.coords[:, 1]
    wet = np.isfinite(h) & (h > -500.0)
    return float(100.0 - y[wet].min()) if wet.any() else 0.0


def profile(prob, x, depth=PROFILE_DEPTH):
    """The head (cm) at every node of the lines x = 0 and x = 50 cm within
    ``depth`` cm of the top, each line from the top down: the front and
    the rows behind it."""
    h = prob.get_nodal_field(_np(x), "porous_pressure", 0)
    xy = prob.mesh.coords
    out = []
    for x_line in (0.0, 50.0):
        on = np.flatnonzero((np.abs(xy[:, 0] - x_line) < 1e-9)
                            & (xy[:, 1] >= 100.0 - depth - 1e-9))
        out += h[on[np.argsort(-xy[on, 1])]].tolist()
    return out


# ---------------------------------------------------------- small decks
def _all_nodes(mesh, name="all"):
    mesh.nodesets[name] = np.arange(mesh.n_nodes, dtype=np.int32)


MU, LAM = 3.0, 2.0


# tests/test_solid.py
def plane_strain_stretch(P):
    """tests/test_solid.py::test_plane_strain_uniaxial_stretch."""
    L, delta = 1.0, 0.02
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9")
    prob = P.Problem(mesh, [P.solid.RealSolid(2, interp="Q2", model="linear")],
                     {"lame_mu": MU, "lame_lambda": LAM}, **P.kw)
    prob.add_dirichlet("left", "solid_displacement", 0, 0.0)
    prob.add_dirichlet("right", "solid_displacement", 0, delta)
    c = mesh.coords
    mesh.nodesets["pin"] = np.where(np.isclose(c[:, 1], 0.5) & (
        np.isclose(c[:, 0] % L, 0.0) | np.isclose(c[:, 0], L)))[0]
    prob.add_dirichlet("pin", "solid_displacement", 1, 0.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=5)
    dx = prob.get_nodal_field(res.x, "solid_displacement", 0)
    dy = prob.get_nodal_field(res.x, "solid_displacement", 1)
    nu = LAM / (LAM + 2.0 * MU)
    gate(close(dx, delta * c[:, 0] / L, 0, 1e-10)
         and close(dy, -nu * delta / L * (c[:, 1] - 0.5), 0, 1e-10),
         "plane-strain stretch")
    return _out(res.iters, [dx.max(), dy.max()], res.x)


def traction_bar(P):
    """tests/test_solid.py::test_traction_loaded_bar."""
    t = 0.5
    mesh = P.mesh.rectangle_mesh(6, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.solid.RealSolid(2, interp="Q2", model="linear")],
                     {"lame_mu": MU, "lame_lambda": LAM}, **P.kw)
    prob.add_dirichlet("left", "solid_displacement", 0, 0.0)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(f"sideset:{ns}", "solid_displacement", 1, 0.0)
    prob.add_dirichlet("sideset:top", "solid_displacement", 1, 0.0)
    _all_nodes(mesh)
    prob.add_dirichlet("all", "solid_displacement", 1, 0.0)
    prob.add_face_kernel("right", P.solid.SolidTraction(2, [t, 0.0]))
    prob.finalize()
    res = _solve(P, prob, max_iter=5)
    dx = prob.get_nodal_field(res.x, "solid_displacement", 0)
    gate(close(dx, t * mesh.coords[:, 0] / (LAM + 2 * MU), 0, 1e-9),
         "traction-loaded bar")
    return _out(res.iters, dx.max(), res.x)


def bar_vibration(P):
    """tests/test_solid.py::test_bar_axial_vibration (240 Crank-Nicolson
    steps)."""
    rho, A, L = 2.0, 1e-3, 1.0
    omega = np.pi / (2 * L) * np.sqrt((LAM + 2 * MU) / rho)
    mesh = P.mesh.rectangle_mesh(10, 1, elem="QUAD9")
    S = P.solid
    prob = P.Problem(mesh, [S.RealSolid(2, interp="Q2", model="linear",
                                        dynamic=True),
                            S.SolidKinematics(2, interp="Q2")],
                     {"lame_mu": MU, "lame_lambda": LAM, "solid_rho": rho},
                     **P.kw)
    prob.add_dirichlet("left", "solid_displacement", 0, 0.0)
    prob.add_dirichlet("left", "solid_velocity", 0, 0.0)
    _all_nodes(mesh)
    prob.add_dirichlet("all", "solid_displacement", 1, 0.0)
    prob.add_dirichlet("all", "solid_velocity", 1, 0.0)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof),
                              "solid_displacement", 0,
                              lambda X: A * np.sin(np.pi * X[:, 0] / (2 * L)))
    t_end = 0.6 * 2 * np.pi / omega
    res = P.TransientSolver(prob, P.NewtonOptions(
        max_iter=6, tol_residual=1e-12, linear_solver="direct"),
        P.TimeOptions(dt0=t_end / 240, t_end=t_end, adapt=False, theta=0.5,
                      bootstrap_be=False)).run(x0, prob.base_params())
    dx = prob.get_nodal_field(res.x, "solid_displacement", 0)
    tip = np.where(np.isclose(mesh.coords[:, 0], L))[0]
    got = dx[tip].mean()
    gate(abs(got - A * np.cos(omega * res.t)) <= 2e-2 * A, "bar vibration")
    return _out(sum(s.newton_iters for s in res.steps), got, res.x)


def total_ale_tie(P):
    """tests/test_solid.py::test_total_ale_tie_and_jacobian."""
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD4")
    prob = P.Problem(mesh, [P.solid.RealSolid(2, interp="Q1",
                                              model="nonlinear"),
                            P.phys.EllipticMesh(2, interp="Q1")],
                     {"lame_mu": MU, "lame_lambda": LAM}, **P.kw)
    delta = 0.05
    prob.add_dirichlet("left", "solid_displacement", 0, 0.0)
    prob.add_dirichlet("left", "solid_displacement", 1, 0.0)
    prob.add_dirichlet("right", "solid_displacement", 0, delta)
    prob.add_dirichlet("right", "solid_displacement", 1, 0.0)
    prob.add_dirichlet("left", "mesh_displacement", 0, 0.0)
    prob.add_dirichlet("left", "mesh_displacement", 1, 0.0)
    P.solid.tie_mesh_to_solid(prob, "right", 2)
    prob.finalize()
    res = _solve(P, prob, max_iter=12)
    right = mesh.nodesets["right"]
    for c in range(2):
        dm = prob.get_nodal_field(res.x, "mesh_displacement", c)
        ds = prob.get_nodal_field(res.x, "solid_displacement", c)
        gate(close(dm[right], ds[right], 0, 1e-10), "mesh tied to solid")
    dmx = prob.get_nodal_field(res.x, "mesh_displacement", 0)
    gate(dmx.max() <= delta + 1e-9 and dmx.min() >= -1e-9, "mesh bounded")
    x = _np(res.x) + 1e-3 * np.random.RandomState(0).randn(prob.dofmap.n_dof)
    chk = P.numjac.numerical_jacobian_check(prob, x, prob.base_params(),
                                            n_columns=10)
    gate(chk.ok, chk.report())
    return _out(res.iters, dmx.max(), res.x)


# tests/test_contact.py
def _column(P, nx, ny):
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9")
    prob = P.Problem(mesh, [P.solid.RealSolid(2, interp="Q2", model="linear")],
                     {"lame_mu": MU, "lame_lambda": LAM}, **P.kw)
    _all_nodes(mesh)
    prob.add_dirichlet("all", "solid_displacement", 0, 0.0)
    return mesh, prob


def contact_floor(P):
    """tests/test_contact.py::test_column_pressed_onto_floor."""
    T, k = 0.4, 5e3
    mesh, prob = _column(P, 3, 6)
    prob.add_face_kernel("top", P.solid.SolidTraction(2, [0.0, -T]))
    prob.add_face_kernel("bottom", P.contact.RigidContactPenalty(
        2, P.contact.halfspace([0.0, 1.0], 0.0), k))
    prob.finalize()
    res = _solve(P, prob, max_iter=25)
    dy = prob.get_nodal_field(res.x, "solid_displacement", 1)
    y = mesh.coords[:, 1]
    pen, eps = T / k, T / (LAM + 2 * MU)
    gate(close(dy, -pen - eps * y, 0, 1e-6)
         and abs(dy[mesh.nodesets["bottom"]].mean() + pen) < 1e-8,
         "column on the floor")
    return _out(res.iters, dy.min(), res.x)


def contact_separated(P):
    """tests/test_contact.py::test_no_contact_when_separated."""
    T, k = 0.4, 5e3
    mesh, prob = _column(P, 2, 4)
    prob.add_dirichlet("bottom", "solid_displacement", 1, 0.0)
    prob.add_face_kernel("top", P.solid.SolidTraction(2, [0.0, +T]))
    prob.add_face_kernel("bottom", P.contact.RigidContactPenalty(
        2, P.contact.halfspace([0.0, 1.0], -0.05), k))
    prob.finalize()
    res = _solve(P, prob, max_iter=8)
    dy = prob.get_nodal_field(res.x, "solid_displacement", 1)
    gate(close(dy, T / (LAM + 2 * MU) * mesh.coords[:, 1], 0, 1e-9),
         "free stretch")
    return _out(res.iters, dy.max(), res.x)


# tests/test_fsi_conforming.py
def fsi_pressurized(P):
    """tests/test_fsi_conforming.py::test_fsi_pressurized_column."""
    P0 = 0.2
    prob = fsi_column(P, 8, 4, "linear", P0)
    res = _solve(P, prob, max_iter=8, tol=1e-10)
    eu, umax, ep = fsi_exact_error(prob, res.x, P0)
    gate(eu <= 2e-5 * P0 and umax < 1e-6 and ep <= 1e-8, "FSI column")
    dx = prob.get_nodal_field(_np(res.x), "solid_displacement", 0)
    return _out(res.iters, np.nanmax(dx), res.x)


# tests/test_bc_traction.py
def _newton(P, prob, max_iter, tol):
    return _solve(P, prob, max_iter=max_iter, tol=tol)


def elec_capacitor(P):
    """tests/test_bc_traction.py::test_elec_traction_capacitor_pressure."""
    E0, perm = 3.0, 2.0
    ph = P.phys
    mesh = P.mesh.rectangle_mesh(8, 8, elem="QUAD9")
    prob = P.Problem(mesh, [ph.Momentum(dim=2, interp="Q2", transient=False),
                            ph.Continuity(interp="Q1"), ph.Potential()],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.add_dirichlet("bottom", "voltage", 0, 0.0)
    prob.add_dirichlet("top", "voltage", 0, -E0)
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_face_kernel("top", P.traction.ElecTraction(dim=2,
                                                        permittivity=perm))
    prob.finalize()
    res = _newton(P, prob, 6, 1e-10)
    u = prob.get_nodal_field(res.x, "velocity", 0)
    v = prob.get_nodal_field(res.x, "velocity", 1)
    p = prob.get_nodal_field(res.x, "pressure", 0)
    gate(np.nanmax(np.abs(u)) < 1e-9 and np.nanmax(np.abs(v)) < 1e-9
         and close(p[~np.isnan(p)], -0.5 * perm * E0 ** 2, 0, 1e-8),
         "capacitor pressure")
    return _out(res.iters, np.nanmean(p), res.x)


def flow_gradv_outflow(P):
    """tests/test_bc_traction.py::test_flow_gradv_poiseuille_outflow."""
    mu, umax, L, H = 0.7, 1.0, 3.0, 1.0
    ph = P.phys
    mesh = P.mesh.rectangle_mesh(18, 6, elem="QUAD9", xlim=(0, L),
                                 ylim=(0, H))
    prob = P.Problem(mesh, [ph.Momentum(dim=2, interp="Q2", transient=False),
                            ph.Continuity(interp="Q1")],
                     {"rho": 1.0, "mu": mu}, **P.kw)
    prob.add_dirichlet("left", "velocity", 0,
                       lambda c: 4 * umax * c[:, 1] * (H - c[:, 1]) / H ** 2)
    prob.add_dirichlet("left", "velocity", 1, 0.0)
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_face_kernel("right", P.traction.FlowGradV(dim=2, p_datum=0.0))
    prob.finalize()
    res = _newton(P, prob, 8, 1e-10)
    c = mesh.coords
    u = prob.get_nodal_field(res.x, "velocity", 0)
    p = prob.get_nodal_field(res.x, "pressure", 0)
    out = np.isclose(c[:, 0], L) & ~np.isnan(u)
    dpdx = -8.0 * mu * umax / H ** 2
    pin = ~np.isnan(p)
    fit = np.polyfit(c[pin, 0], p[pin], 1)
    gate(close(u[out], 4 * umax * c[out, 1] * (H - c[out, 1]) / H ** 2, 0,
               2e-3 * umax)
         and abs(fit[0] - dpdx) <= 2e-2 * abs(dpdx)
         and abs(fit[0] * L + fit[1]) < 2e-2 * abs(dpdx * L),
         "fully developed outflow")
    return _out(res.iters, fit, res.x)


def _block(P, n, traction, bottom):
    """The 2D elastic block of the friction tests: base y-fixed, one base
    node x-pinned, ``traction`` (top, left, right) weak tractions and the
    ``bottom`` face kernel."""
    G, lam = 10.0, 5.0
    mesh = P.mesh.rectangle_mesh(n, n, elem="QUAD9")
    M = P.MESH_VAR
    prob = P.Problem(mesh, [P.phys.LinearElasticMesh(dim=2)],
                     {"mesh_shear_modulus": G, "mesh_lambda": lam}, **P.kw)
    prob.add_dirichlet("bottom", M, 1, 0.0)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob.add_dirichlet("pin", M, 0, 0.0)
    for side, t in zip(("top", "left", "right"), traction):
        prob.add_face_kernel(side, P.solid.SolidTraction(dim=2, traction=t,
                                                         var=M))
    prob.add_face_kernel("bottom", bottom)
    prob.finalize()
    A = np.array([[2 * G + lam, lam], [lam, 2 * G + lam]])
    return mesh, prob, A, G


def coulomb_block(P):
    """tests/test_bc_traction.py::test_coulomb_friction_block_shear."""
    N, mu_f = 0.1, 0.3
    mesh, prob, A, G = _block(P, 8, ((mu_f * N, -N), (0.0, -mu_f * N),
                                     (0.0, mu_f * N)),
                              P.traction.CoulombFriction(
                                  dim=2, mu_f=mu_f, var=P.MESH_VAR,
                                  slide_velocity=(1.0, 0.0)))
    res = _newton(P, prob, 8, 1e-9)
    dx = prob.get_nodal_field(res.x, P.MESH_VAR, 0)
    dy = prob.get_nodal_field(res.x, P.MESH_VAR, 1)
    c = mesh.coords
    exx, eyy = np.linalg.solve(A, [0.0, -N])
    exy = mu_f * N / (2 * G)
    gate(close(dx, exx * c[:, 0] + 2 * exy * c[:, 1], 0, 1e-4)
         and close(dy, eyy * c[:, 1], 0, 1e-4), "Coulomb block")
    return _out(res.iters, dx.max(), res.x)


def coulomb_acoustic(P):
    """tests/test_bc_traction.py::test_coulomb_friction_acoustic_reduction."""
    N, mu_f, v_slide, v_ac = 0.1, 0.3, 1.0, 2.0
    mu_eff = mu_f * (2.0 / np.pi) * np.arcsin(v_slide / v_ac)
    mesh, prob, A, G = _block(P, 6, ((mu_eff * N, -N), (0.0, -mu_eff * N),
                                     (0.0, mu_eff * N)),
                              P.traction.CoulombFriction(
                                  dim=2, mu_f=mu_f, var=P.MESH_VAR,
                                  slide_velocity=(v_slide, 0.0),
                                  acoustic_velocity=v_ac))
    res = _newton(P, prob, 8, 1e-9)
    dx = prob.get_nodal_field(res.x, P.MESH_VAR, 0)
    c = mesh.coords
    exx, _ = np.linalg.solve(A, [0.0, -N])
    gate(close(dx, exx * c[:, 0] + 2 * mu_eff * N / (2 * G) * c[:, 1], 0,
               1e-4), "acoustic friction")
    return _out(res.iters, dx.max(), res.x)


def slope_ramp(P):
    """tests/test_bc_traction.py::test_slope_bc_tilts_boundary."""
    eps_s = 0.05
    M = P.MESH_VAR
    mesh = P.mesh.rectangle_mesh(6, 6, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.LinearElasticMesh(dim=2)],
                     {"mesh_shear_modulus": 5.0, "mesh_lambda": 2.0}, **P.kw)
    for ns in ("bottom", "left", "right"):
        prob.add_dirichlet(ns, M, 0, 0.0)
    prob.add_dirichlet("bottom", M, 1, 0.0)
    c = mesh.coords
    mesh.nodesets["tl"] = np.where(np.isclose(c[:, 0], 0.0)
                                   & np.isclose(c[:, 1], 1.0))[0].astype(np.int32)
    prob.add_dirichlet("tl", M, 1, 0.0)
    prob.add_face_kernel("top", P.traction.SlopeBC(dim=2, slope=(1.0, eps_s),
                                                   penalty=1e6))
    prob.finalize()
    res = _newton(P, prob, 10, 1e-9)
    dy = prob.get_nodal_field(res.x, M, 1)
    top = np.isclose(c[:, 1], 1.0)
    fit = np.polyfit(c[top, 0], dy[top], 1)[0]
    gate(abs(fit - eps_s) <= 5e-2 * eps_s, "slope ramp")
    return _out(res.iters, fit, res.x)


def force_sic(P):
    """tests/test_bc_traction.py::test_force_sic_matches_weak_traction."""
    N, tau, G, lam = 0.1, 0.03, 10.0, 5.0
    M = P.MESH_VAR
    mesh = P.mesh.rectangle_mesh(6, 6, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.LinearElasticMesh(dim=2)],
                     {"mesh_shear_modulus": G, "mesh_lambda": lam}, **P.kw)
    prob.add_dirichlet("bottom", M, 0, 0.0)
    prob.add_dirichlet("bottom", M, 1, 0.0)
    prob.add_face_kernel("top", P.traction.ForceSIC(dim=2, force=(-N, -tau),
                                                    penalty=1e5))
    prob.add_face_kernel("left", P.solid.SolidTraction(
        dim=2, traction=(0.0, -tau), var=M))
    prob.add_face_kernel("right", P.solid.SolidTraction(
        dim=2, traction=(0.0, tau), var=M))
    prob.finalize()
    res = _newton(P, prob, 10, 1e-9)
    dx = prob.get_nodal_field(res.x, M, 0)
    dy = prob.get_nodal_field(res.x, M, 1)
    c = mesh.coords
    A = np.array([[2 * G + lam, lam], [lam, 2 * G + lam]])
    _, eyy = np.linalg.solve(A, [0.0, -N])
    mid = np.isclose(c[:, 0], 0.5)
    fy = np.polyfit(c[mid, 1], dy[mid], 1)[0]
    fx = np.polyfit(c[mid, 1], dx[mid], 1)[0]
    gate(abs(fy - eyy) <= 5e-2 * abs(eyy)
         and abs(fx - tau / G) <= 5e-2 * abs(tau / G), "FORCE_SIC")
    return _out(res.iters, [fx, fy], res.x)


def surface_viscosity_moment(P):
    """tests/test_bc_traction.py::test_surface_viscosity_stretch_moment."""
    a, mu_s, k_s = 0.7, 1.3, 0.4
    mesh = P.mesh.rectangle_mesh(6, 3, elem="QUAD9")
    mesh.nodesets["notbot"] = np.where(mesh.coords[:, 1] > 1e-9)[0].astype(
        np.int32)
    eqs = [P.eqs.PassiveVar("velocity", 2, "Q2", reg=1e-12)]

    def delta_R(ufun):
        probs = []
        for kern in (True, False):
            p = P.Problem(mesh, eqs, {}, **P.kw)
            p.add_dirichlet("notbot", "velocity", 0, lambda c: ufun(c)[0])
            p.add_dirichlet("notbot", "velocity", 1, lambda c: ufun(c)[1])
            if kern:
                p.add_face_kernel("bottom", P.free_surface.SurfaceViscosity(
                    dim=2, mu_s=mu_s, kappa_s=k_s))
            p.finalize()
            probs.append(p)
        x0 = np.zeros(probs[0].dofmap.n_dof)
        for comp in (0, 1):
            x0 = probs[0].set_nodal_field(x0, "velocity", comp,
                                          ufun(mesh.coords)[comp])
        R = [_np(p.residual(P.arr(x0), p.base_params())) for p in probs]
        return R[0] - R[1], probs[0]

    dR, p1 = delta_R(lambda c: (a * c[:, 0], -a * c[:, 1]))
    dm = p1.dofmap
    d = dm.dof_of_node_svar[:, dm.svar("velocity", 0)]
    ok = d >= 0
    mom = float((mesh.coords[ok, 0] * dR[d[ok]]).sum())
    dR2, _ = delta_R(lambda c: (0.3 * c[:, 1], 0.0 * c[:, 0]))
    gate(close(mom, (k_s + mu_s) * a, 1e-10) and np.abs(dR2).max() < 1e-12,
         "surface viscosity moment")
    return _out(0, mom, np.concatenate([dR, dR2]))


# tests/test_porous_sink.py
def sink_exponential(P):
    """tests/test_porous_sink.py::test_sink_mass_exponential."""
    tau, smax, k2, rho = 2.0, 0.8, 1.5, 1.0
    mesh = P.mesh.rectangle_mesh(2, 2, elem="QUAD4")
    prob = P.Problem(mesh, [P.porous.PorousSinkMass(model=None, interp="Q1")],
                     {"rho_liquid": rho, "sink_linear": (tau, smax, k2, 0.0)},
                     **P.kw)
    prob.finalize()
    res = P.TransientSolver(prob, P.NewtonOptions(
        max_iter=6, tol_residual=1e-12, linear_solver="direct"),
        P.TimeOptions(dt0=0.005, t_end=0.3, theta=0.5, adapt=False)).run(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    exact = smax * (1.0 - np.exp(-rho * tau * k2 / smax * res.t))
    gate(close(res.x, exact, 2e-4), "sink exponential")
    return _out(sum(s.newton_iters for s in res.steps), _np(res.x).mean(),
                res.x)


def sink_conservation(P):
    """tests/test_porous_sink.py::test_sink_conservation_sealed_box."""
    por = P.porous
    vg = por.VanGenuchten(alpha=1.0, n=2.0, s_res=0.1)
    tau, smax, k2, rho, phi_por = 1.0, 0.5, 1.0, 1.0, 0.3
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
    mat = {"rho_liquid": rho, "permeability": 1.0, "porosity": phi_por,
           "mu_liquid": 1.0, "sink_linear": (tau, smax, k2, 0.0)}
    prob = P.Problem(mesh, [por.PorousFlow(model=vg, interp="Q1"),
                            por.PorousSinkMass(model=vg, interp="Q1")], mat,
                     **P.kw)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "porous_pressure",
                              0, -0.3)
    f = P.post.volume_integral(
        prob, lambda fv, m, prm: phi_por * rho
        * vg.saturation(fv.val["porous_pressure"][:, 0])
        + fv.val["sink_mass"][:, 0])
    m0 = float(f(P.arr(x0), prob.base_params()))
    res = P.TransientSolver(prob, P.NewtonOptions(
        max_iter=8, tol_residual=1e-11, linear_solver="direct"),
        P.TimeOptions(dt0=0.01, t_end=0.2, theta=0.5, adapt=False)).run(
        x0, prob.base_params())
    m1 = float(f(P.arr(res.x), prob.base_params()))
    s_end = prob.get_nodal_field(_np(res.x), "sink_mass", 0)
    gate(np.nanmin(s_end) > 1e-3 and abs(m1 - m0) / abs(m0) < 5e-3,
         "sealed-box conservation")
    return _out(sum(s.newton_iters for s in res.steps), [m0, m1], res.x)


# tests/test_porous_twophase.py
TWO_PHASE_MAT = {"permeability": 0.1, "porosity": 0.4, "mu_liquid": 1.0,
                 "mu_gas": 0.05, "rho_liquid": 1.0, "rho_gas": 0.1,
                 "gravity_vec": [0.0, -1.0]}


def _two_phase(P, transient=True, compressible=False):
    mesh = P.mesh.rectangle_mesh(2, 8, elem="QUAD4")
    vg = P.porous.VanGenuchten(alpha=2.0, n=2.0)
    prob = P.Problem(mesh, [P.porous.TwoPhasePorous(
        vg, transient=transient, compressible=compressible)],
        dict(TWO_PHASE_MAT), **P.kw)
    return mesh, prob


def two_phase_hydrostatic(P):
    """tests/test_porous_twophase.py::test_hydrostatic_equilibrium."""
    mesh, prob = _two_phase(P, transient=False)
    prob.add_dirichlet("bottom", "porous_pressure", 0, 0.0)
    prob.add_dirichlet("bottom", "porous_pressure", 1, 0.5)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "porous_pressure",
                              0, lambda X: -0.9 * X[:, 1])
    x0 = prob.set_nodal_field(x0, "porous_pressure", 1,
                              lambda X: 0.5 - 0.08 * X[:, 1])
    res = _solve(P, prob, x0, max_iter=15)
    pl = prob.get_nodal_field(res.x, "porous_pressure", 0)
    pg = prob.get_nodal_field(res.x, "porous_pressure", 1)
    y = mesh.coords[:, 1]
    gate(close(pl, -y, 0, 1e-9) and close(pg, 0.5 - 0.1 * y, 0, 1e-9),
         "two-phase hydrostatics")
    return _out(res.iters, [pl.min(), pg.min()], res.x)


def two_phase_closed(P):
    """tests/test_porous_twophase.py::
    test_closed_domain_conserves_phase_content (adaptive backward Euler to
    t = 8)."""
    mesh, prob = _two_phase(P, transient=True, compressible=True)
    prob.finalize()
    eq = prob.equations[0][0]

    def liquid_content(fv, mat, params):
        pc = fv.val["porous_pressure"][:, 1] - fv.val["porous_pressure"][:, 0]
        return TWO_PHASE_MAT["porosity"] * eq._sat_of_pc(pc)

    content = P.post.volume_integral(prob, liquid_content)
    mat_ng = dict(TWO_PHASE_MAT)
    mat_ng.pop("gravity_vec")
    prob.materials = [mat_ng]
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "porous_pressure",
                              0, lambda X: -0.3 - 0.2 * np.sin(np.pi * X[:, 1]))
    x0 = prob.set_nodal_field(x0, "porous_pressure", 1, 0.1)
    params = prob.base_params()
    c0 = float(content(P.arr(x0), params))
    res = P.TransientSolver(prob, P.NewtonOptions(
        max_iter=10, tol_residual=1e-10, linear_solver="direct"),
        P.TimeOptions(dt0=0.02, t_end=8.0, adapt=True, max_dt=1.5,
                      theta=0.0)).run(x0, params)
    c1 = float(content(P.arr(res.x), params))
    pc = (prob.get_nodal_field(_np(res.x), "porous_pressure", 1)
          - prob.get_nodal_field(_np(res.x), "porous_pressure", 0))
    gate(close(c1, c0, 1e-4) and pc.std() < 2e-4 * max(abs(pc.mean()), 1.0),
         "two-phase closed box")
    return _out(len(res.steps), [c0, c1], res.x)


def two_phase_numjac(P):
    """tests/test_porous_twophase.py::test_twophase_jacobian_matches_fd."""
    mesh, prob = _two_phase(P, transient=True, compressible=True)
    prob.finalize()
    rng = np.random.RandomState(2)
    x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "porous_pressure",
                             0, -0.5 + 0.1 * rng.rand(mesh.n_nodes))
    x = prob.set_nodal_field(x, "porous_pressure", 1,
                             0.8 + 0.1 * rng.rand(mesh.n_nodes))
    p = prob.base_params()
    p["ct"] = P.arr(np.float64(3.0))
    chk = P.numjac.numerical_jacobian_check(prob, x, p, n_columns=12, h=1e-6)
    gate(chk.ok, chk.report())
    return _out(0, chk.n_checked, x)


# tests/test_hysteresis.py
def _hyst(P, **kw):
    for k, v in (("s_max", 0.95), ("beta_w", 1.2), ("alpha_w", 2.0),
                 ("s_min", 0.08), ("beta_d", 1.0), ("alpha_d", 3.0)):
        kw.setdefault(k, v)
    return P.porous.TanhHystSaturation(**kw)


def _S(P, m, pc, st):
    return _np(m.saturation_pc(P.arr(np.atleast_1d(pc)),
                               *(P.arr(st[k]) for k in m.EXT_FIELDS)))


def hyst_main_curves(P):
    """tests/test_hysteresis.py::test_main_curves_monotone_and_bounded."""
    m = _hyst(P, draining_initial=True)
    st = {k: np.full(200, v[0]) for k, v in m.init_state(1).items()}
    S = _S(P, m, np.linspace(0.05, 50.0, 200), st)
    gate(np.all(S <= 1.0) and np.all(S >= 0.0)
         and np.all(np.diff(S) <= 1e-12) and S[0] > 0.9 and S[-1] < 0.2,
         "main curves")
    return _out(0, [S[0], S[-1]], S)


def hyst_loop(P):
    """tests/test_hysteresis.py::test_hysteresis_loop."""
    m = _hyst(P, draining_initial=True, s_max=1.0)
    st = {k: v.copy() for k, v in m.init_state(1).items()}
    pcs = np.linspace(0.1, 10.0, 30)
    S_drain = []
    for pc in pcs:
        st = m.update_state(st, np.array([-pc]), np.array([-1.0]))
        S_drain.append(float(_S(P, m, pc, st)[0]))
    gate(st["hyst_curve"][0] == 1.0, "stays draining")
    S_rev = S_drain[-1]
    st = m.update_state(st, np.array([-10.0]), np.array([+1.0]))
    S_wet = [float(_S(P, m, pc, st)[0]) for pc in pcs[::-1]]
    mid = len(pcs) // 2
    gate(st["hyst_curve"][0] == 0.0
         and abs(st["hyst_sat_switch"][0] - S_rev) <= 1e-12
         and abs(st["hyst_pc_switch"][0] - 10.0) <= 1e-12
         and abs(float(_S(P, m, 10.0, st)[0]) - S_rev) <= 1e-10
         and all(np.diff(S_wet) >= -1e-12)
         and abs(S_wet[-1 - mid] - S_drain[mid]) > 1e-3, "hysteresis loop")
    return _out(0, [S_rev, S_wet[-1]], np.array(S_drain + S_wet))


def hyst_threshold(P):
    """tests/test_hysteresis.py::test_switch_threshold_blocks_noise."""
    m = _hyst(P, switch_threshold=0.5)
    st2 = m.update_state(m.init_state(3), np.array([-5.0, -5.0, -5.0]),
                         np.array([0.1, 0.6, 0.1]))
    gate(list(st2["hyst_curve"]) == [1.0, 0.0, 1.0], "switch threshold")
    return _out(0, st2["hyst_sat_switch"], np.concatenate(
        [st2[k] for k in m.EXT_FIELDS]))


def hyst_richards(P):
    """tests/test_hysteresis.py::test_richards_hyst_transient_drain_rewet."""
    mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD4", xlim=(0, 1),
                                 ylim=(0, 0.5))
    m = _hyst(P, switch_threshold=8.0)
    xp = P.xp
    prob = P.Problem(mesh, [P.porous.PorousFlow(model=m, interp="Q1",
                                                transient=True)],
                     {"permeability": 1e-2, "mu_liquid": 1.0,
                      "porosity": 0.3},
                     external_fields=list(m.EXT_FIELDS), **P.kw)
    prob.add_dirichlet("left", "porous_pressure", 0,
                       lambda c, params: params["p_bc"] * xp.ones_like(c[:, 0]))
    prob.finalize()
    state = m.init_state(mesh.coords.shape[0])
    x = np.full(prob.dofmap.n_dof, -1.0)
    solver = P.NewtonSolver(prob, P.NewtonOptions(
        max_iter=30, tol_residual=1e-9, linear_solver="direct"))
    dt = 0.05
    p_traj = [-1.0, -1.6, -2.4, -2.8, -2.2, -1.6, -1.2]
    S_seen, iters, xs = [], 0, []
    for pbc in p_traj[1:]:
        params = prob.base_params(
            p_bc=P.arr(np.float64(pbc)),
            **{f"ext_{k}": v for k, v in state.items()})
        params["ct"] = P.arr(np.float64(1.0 / dt))
        params["hist"] = P.arr(-x / dt)
        res = solver.solve(x, params)
        gate(res.converged, "hysteretic Richards step")
        iters += res.iters
        xn = _np(res.x)
        state = m.update_state(state, xn, (xn - x) / dt)
        x = xn
        xs.append(x)
        S_seen.append(float(_S(P, m, max(-x[0], 1e-5),
                               {k: v[:1] for k, v in state.items()})[0]))
    gate(state["hyst_curve"][0] == 0.0 and S_seen[-1] > S_seen[2],
         "drained then rewetted")
    return _out(iters, S_seen, np.concatenate(xs))


# tests/test_ca_edge_porous.py (its porous and leak parts)
def kelvin_density(P):
    """tests/test_ca_edge_porous.py::test_kelvin_gas_density_formula."""
    mat = {"vapor_Mw": 0.018, "gas_R": 8.314, "rho_liquid": 1000.0,
           "vapor_T": 300.0, "vapor_Psat": 3500.0}
    rho = _np(P.leak.kelvin_gas_density(P.arr(np.array([-1e7, 0.0, 5.0])),
                                        mat, {}))
    rho_sat = 0.018 / (8.314 * 300.0) * 3500.0
    gate(close(rho[1:], rho_sat, 1e-12) and close(
        rho[0], rho_sat * np.exp(-1e7 * 0.018 / (1000.0 * 8.314 * 300.0)),
        1e-12), "Kelvin density")
    return _out(0, rho, rho)


def _porous_column(P, k_m, k_m1=0.0, p_0=0.0):
    mesh = P.mesh.rectangle_mesh(1, 8, elem="QUAD4", xlim=(0, 0.1),
                                 ylim=(0, 1.0))
    vg = P.porous.VanGenuchten(alpha=1.0, n=2.0)
    mat = {"permeability": 0.5, "mu_liquid": 1.0, "porosity": 0.4,
           "vapor_Psat": 1.0, "vapor_Mw": 1.0, "gas_R": 1.0, "vapor_T": 1.0,
           "rho_liquid": 1.0}
    prob = P.Problem(mesh, [P.porous.PorousFlow(model=vg, interp="Q1",
                                                transient=False)], mat, **P.kw)
    prob.add_dirichlet("bottom", "porous_pressure", 0, 2.0)
    prob.add_face_kernel("top", P.leak.PorousMassFlux(k_m, Y_c=0.0, k_m1=k_m1,
                                                      p_0=p_0))
    prob.finalize()
    res = _solve(P, prob, max_iter=12, tol=1e-11)
    d = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar("porous_pressure", 0)]
    return prob, mat, res, _np(res.x)[d]


def porous_flux_saturated(P):
    """tests/test_ca_edge_porous.py::test_porous_mass_flux_saturated_column."""
    prob, mat, res, p = _porous_column(P, k_m=1.0)
    q, K = mat["porosity"], mat["permeability"] / mat["mu_liquid"]
    gate(close(p, 2.0 - q / K * prob.mesh.coords[:, 1], 0, 1e-8),
         "saturated evaporation profile")
    return _out(res.iters, p.min(), res.x)


def porous_flux_extraction(P):
    """tests/test_ca_edge_porous.py::test_porous_mass_flux_extraction_term."""
    prob, mat, res, p = _porous_column(P, k_m=1.0, k_m1=0.5, p_0=0.0)
    phi_p, K = mat["porosity"], mat["permeability"]
    s = -(phi_p + phi_p * 0.5 * 2.0) / (K + phi_p * 0.5)
    gate(p.min() > 0.0 and close(p, 2.0 + s * prob.mesh.coords[:, 1], 0, 1e-8),
         "extraction profile")
    return _out(res.iters, p.min(), res.x)


def latent_heat_slab(P):
    """tests/test_ca_edge_porous.py::test_latent_heat_flux_slab."""
    L, mdot, k = 3.0, 0.25, 2.0
    mesh = P.mesh.rectangle_mesh(1, 6, elem="QUAD9", xlim=(0, 0.2),
                                 ylim=(0, 1.0))
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False,
                                          convection=False)], {"k": k}, **P.kw)
    prob.add_dirichlet("bottom", "temperature", 0, 1.0)
    prob.add_face_kernel("top", P.leak.LatentHeatFlux([(L, mdot)]))
    prob.finalize()
    res = _solve(P, prob, max_iter=12, tol=1e-11)
    d = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar("temperature", 0)]
    T = _np(res.x)[d]
    gate(close(T, 1.0 - L * mdot / k * mesh.coords[:, 1], 0, 1e-10),
         "latent-heat slab")
    return _out(res.iters, T.min(), res.x)


def vnorm_leak(P):
    """tests/test_ca_edge_porous.py::test_vnorm_leak_uniform_suction."""
    v0 = 0.3
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, transient=False),
                            P.phys.Continuity(interp="Q1")],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    prob.add_dirichlet("bottom", "velocity", 1, v0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_face_kernel("top", P.leak.VNormLeak(dim=2, leak=v0, penalty=1e6))
    prob.finalize()
    res = _solve(P, prob, max_iter=12, tol=1e-11)
    dm = prob.dofmap
    ux = _np(res.x)[dm.dof_of_node_svar[:, dm.svar("velocity", 0)]]
    uy = _np(res.x)[dm.dof_of_node_svar[:, dm.svar("velocity", 1)]]
    gate(close(ux, 0.0, 0, 1e-6) and close(uy, v0, 0, 1e-6), "VNORM_LEAK")
    return _out(res.iters, uy.mean(), res.x)


# tests/test_overset.py
FSI_WALL = (1.0, 0.7, 5.0, 0.3)  # U, mu_f, mu_L, y_c


def overset_fsi_wall_problem(P):
    """tests/test_overset.py::test_overset_fsi_elastic_wall's problem, an
    elastic strip whose top face, a bar block of multipliers, is immersed
    in a Couette flow (two-way ``OversetFSI``), finalized."""
    U, mu_f, mu_L, y_c = FSI_WALL
    mesh = P.mesh.rectangle_mesh(4, 10, elem="QUAD9", xlim=(0, 0.8),
                                 ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    solid = P.mesh.rectangle_mesh(4, 3, elem="QUAD9", xlim=(0, 0.8),
                                  ylim=(0, y_c))
    sbi = P.immersed.merge_mesh(mesh, solid, prefix="s")
    bbi = P.phys.attach_shell_block(mesh, "s:top", "ifc")
    ph = P.phys
    eqs = [[ph.Momentum(dim=2, interp="Q2", transient=False,
                        convection=False), ph.Continuity(interp="Q1")],
           [P.solid.RealSolid(dim=2, interp="Q2", model="linear")],
           [P.overset.OversetLM(dim=2)]]
    mats = [{"rho": 1.0, "mu": mu_f},
            {"lame_mu": mu_L, "lame_lambda": 2.0, "solid_rho": 1.0}, {}]
    prob = P.Problem(mesh, eqs, mats, **P.kw)
    prob.add_dirichlet("top", "velocity", 0, U)
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    for c in (0, 1):
        prob.add_dirichlet("s:bottom", "solid_displacement", c, 0.0)
    mesh.nodesets["s:all"] = np.unique(mesh.blocks[sbi].conn)
    prob.add_dirichlet("s:all", "solid_displacement", 1, 0.0)
    prob.add_overset(bbi, 0, P.overset.OversetFSI(dim=2),
                     solid=(sbi, "s:top"))
    prob.finalize()
    return prob


def overset_fsi_wall(P):
    """tests/test_overset.py::test_overset_fsi_elastic_wall."""
    U, mu_f, mu_L, y_c = FSI_WALL
    prob = overset_fsi_wall_problem(P)
    mesh = prob.mesh
    res = _solve(P, prob, max_iter=8, tol=1e-10)
    ux = prob.get_nodal_field(_np(res.x), "velocity", 0)
    y = mesh.coords[:, 1]
    fl = ~np.isnan(ux) & (np.abs(y - y_c) < 1e-9)
    tau = mu_f * U / (1 - y_c)
    dx = prob.get_nodal_field(_np(res.x), "solid_displacement", 0)
    d_top = np.nanmean(dx[mesh.nodesets["s:top"]])
    sl = mesh.nodesets["s:left"]
    gate(np.nanmax(np.abs(ux[fl])) < 5e-3
         and abs(d_top - tau * y_c / mu_L) <= 0.05 * tau * y_c / mu_L
         and close(dx[sl], tau * mesh.coords[sl, 1] / mu_L, 0,
                   0.05 * tau * y_c / mu_L), "overset FSI wall")
    return _out(res.iters, d_top, res.x)


# tests/test_lub_film_junction.py
def porous_ls_wicking(P):
    """tests/test_lub_film_junction.py::test_porous_ls_wicking_flux."""
    pc1, perm_c = 2.5, 10.0
    iters, xs, reads = 0, [], []
    for Fval, expect in ((-1.0, pc1), (1.0, 0.7)):
        mesh = P.mesh.rectangle_mesh(6, 2, elem="QUAD4", xlim=(0, 1),
                                     ylim=(0, 0.2))
        _all_nodes(mesh)
        prob = P.Problem(mesh, [P.porous.PorousFlow(interp="Q1",
                                                    transient=False),
                                P.eqs.PassiveVar("fill", 1, "Q1")],
                         {"permeability": 1.0, "mu_liquid": 1.0}, **P.kw)
        prob.add_dirichlet("all", "fill", 0, Fval)
        if Fval > 0:
            prob.add_dirichlet("left", "porous_pressure", 0, 0.7)
        prob.add_face_kernel("right", P.leak.PorousLSWickingFlux(
            perm_c=perm_c, pc1=pc1, eps=0.25))
        prob.finalize()
        x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, Fval)
        res = _solve(P, prob, x0, max_iter=8, tol=1e-11)
        p = prob.get_nodal_field(_np(res.x), "porous_pressure", 0)
        gate(close(p[np.isfinite(p)], expect, 0, 1e-8), "wicking flux")
        iters += res.iters
        xs.append(_np(res.x))
        reads.append(float(np.nanmean(p)))
    return _out(iters, reads, np.concatenate(xs))


SOLID_SMALL = {
    "plane_strain_stretch": plane_strain_stretch,
    "traction_bar": traction_bar,
    "bar_vibration": bar_vibration,
    "total_ale_tie": total_ale_tie,
    "contact_floor": contact_floor,
    "contact_separated": contact_separated,
    "fsi_pressurized": fsi_pressurized,
    "elec_capacitor": elec_capacitor,
    "flow_gradv_outflow": flow_gradv_outflow,
    "coulomb_block": coulomb_block,
    "coulomb_acoustic": coulomb_acoustic,
    "slope_ramp": slope_ramp,
    "force_sic": force_sic,
    "surface_viscosity_moment": surface_viscosity_moment,
    "overset_fsi_wall": overset_fsi_wall,
}
POROUS_SMALL = {
    "sink_exponential": sink_exponential,
    "sink_conservation": sink_conservation,
    "two_phase_hydrostatic": two_phase_hydrostatic,
    "two_phase_closed": two_phase_closed,
    "two_phase_numjac": two_phase_numjac,
    "hyst_main_curves": hyst_main_curves,
    "hyst_loop": hyst_loop,
    "hyst_threshold": hyst_threshold,
    "hyst_richards": hyst_richards,
    "kelvin_density": kelvin_density,
    "porous_flux_saturated": porous_flux_saturated,
    "porous_flux_extraction": porous_flux_extraction,
    "latent_heat_slab": latent_heat_slab,
    "vnorm_leak": vnorm_leak,
    "porous_ls_wicking": porous_ls_wicking,
}
SMALL = {**SOLID_SMALL, **POROUS_SMALL}
