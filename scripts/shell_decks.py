"""The shell and lubrication decks, written once for both packages.

Every function here takes a package namespace ``P`` (see ``namespace``):
goma_tpu's modules and ``jax.numpy`` from ``scripts/shell_reference.py``
and the port's tests, the port's modules and ``torch`` from
``chip_smoke.py``. The material callables are written in the operations
``jax.numpy`` and ``torch`` share (``exp``, ``stack(..., 1)``,
``ones_like``, ``full_like``), so one deck is one definition. This module
imports neither package.

- ``bearing(P, n)``: the thermal slider bearing, Reynolds lubrication and
  shell energy on the bottom face (z = 0) of [0, 1]^2 x [0, 0.05] meshed
  ``box_mesh(n, n, 1, elem="HEX27")`` (QUAD9 shell, HEX27 bulk with no
  equation): gap h = 2e-3 - 1e-3 x, wall velocity (1, 0, 0), mu =
  1e-2 exp(-2 T), the film flux q = -h^3/(12 mu) grad p + h U/2 carried
  into the energy equation (SUPG 1), ambient loss 1e-3; p = 0 on the
  pad's edges, T = 1 on x = 0.
- ``film(P, n)``: the drying particle-laden film on the top face (z = 0)
  of [0, 1]^2 x [-0.05, 0]: film pressure, height and particles (Q2), mu
  = sigma = 1, D 1e-2, CONC_POWER evaporation (0.05, 1, 0.6), H0 = 1 +
  0.1 cos(pi x) cos(pi y), the consistent capillary pressure, C0 = 0.2;
  Crank-Nicolson steps of dt = 0.02 / lambda, lambda = sigma (2 pi^2)^2 /
  (3 mu) the leveling rate of the mode.
- ``SMALL``: goma_tpu's shell tests' decks at their own sizes, on their
  own solvers (host ``direct``, under the transient solver for the
  transient ones), each checking the test's own gate and returning its
  readings.
"""

from __future__ import annotations

import types

import numpy as np

N_SAMPLES = 24


def namespace(mesh, fem, physics, equations, fields, bc_shell_end, bc_sheet,
              solvers, transient, xp, arr, device=None):
    """The package namespace the decks read: the mesh, fem and physics
    packages, ``fem.equations``, ``fem.fields``, the shell-end and sheet
    condition modules, ``solvers`` (NewtonOptions, NewtonSolver) and
    ``solvers.transient``, the array module ``xp``, ``arr`` (a numpy array
    onto the package's device) and the Problem's device keyword."""
    import importlib

    mod = lambda name: importlib.import_module(  # noqa: E731
        f"{physics.__name__}.{name}")
    return types.SimpleNamespace(
        mesh=mesh, Problem=fem.Problem, phys=physics, shell=mod("shell"),
        lub=mod("lubrication"), film=mod("shell_film"),
        porous=mod("shell_porous"), eqs=equations, MESH_VAR=fields.MESH_VAR,
        shell_end=bc_shell_end, sheet=bc_sheet,
        NewtonOptions=solvers.NewtonOptions, NewtonSolver=solvers.NewtonSolver,
        TimeOptions=transient.TimeOptions,
        TransientSolver=transient.TransientSolver, xp=xp, arr=arr,
        kw={} if device is None else {"device": device})


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def gate(ok, msg):
    if not ok:
        raise AssertionError(msg)


def close(a, b, rtol=1e-7, atol=0.0):
    """numpy's ``assert_allclose`` test: |a - b| <= atol + rtol |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def samples(n_dof):
    """The 24 evenly spaced dofs the records read."""
    return np.linspace(0, n_dof - 1, N_SAMPLES).astype(np.int64)


def var_dofs(prob, var, nodes=None):
    """The dofs of ``var`` (component 0) at ``nodes`` (default every node
    that carries it)."""
    d = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar(var, 0)]
    d = d if nodes is None else d[nodes]
    return d[d >= 0]


# ------------------------------------------------------------------ bearing
BEARING_U = (1.0, 0.0, 0.0)


def bearing_materials(xp):
    """The bearing's material dict in the array module ``xp``."""
    def gap(fv, mat, params):
        return 2e-3 + (1e-3 - 2e-3) * fv.x[:, 0]

    def mu_lub(fv, mat, params):
        return 1e-2 * xp.exp(-2.0 * fv.val["shell_temperature"][:, 0])

    def lub_flux(fv, mat, params):
        h = gap(fv, mat, params)
        mob = h ** 3 / (12.0 * mu_lub(fv, mat, params))
        gp = fv.grad["lub_pressure"][:, 0, :]
        return xp.stack([-mob * gp[:, k] + 0.5 * h * BEARING_U[k]
                         for k in range(3)], 1)

    return {"gap": gap, "mu_lub": mu_lub, "lub_flux": lub_flux,
            "wall_velocity": np.array(BEARING_U), "rho": 1.0, "Cp": 1.0,
            "k": 1.0, "ht_coeff": 1e-3, "ht_tamb": 0.0}


def bearing(P, n):
    """The thermal slider bearing (see the module docstring), unsolved.
    Returns (problem, shell block)."""
    mesh = P.mesh.box_mesh(n, n, 1, elem="HEX27", zlim=(0.0, 0.05))
    bi = P.phys.attach_shell_block(mesh, "bottom", "pad")
    sn = np.unique(mesh.blocks[bi].conn)
    c = mesh.coords[sn]
    edge = (np.isclose(c[:, 0], 0.0) | np.isclose(c[:, 0], 1.0)
            | np.isclose(c[:, 1], 0.0) | np.isclose(c[:, 1], 1.0))
    mesh.nodesets["pad_edge"] = sn[edge].astype(np.int32)
    mesh.nodesets["pad_inlet"] = sn[np.isclose(c[:, 0], 0.0)].astype(np.int32)
    prob = P.Problem(mesh, [[], [P.lub.ReynoldsFilm(interp="Q2"),
                                 P.film.ShellEnergy(interp="Q2", supg=1.0)]],
                     [{}, bearing_materials(P.xp)], **P.kw)
    prob.add_dirichlet("pad_edge", "lub_pressure", 0, 0.0)
    prob.add_dirichlet("pad_inlet", "shell_temperature", 0, 1.0)
    prob.finalize()
    return prob, bi


def bearing_readings(prob, x):
    """The load (mean pad pressure over the shell nodes), p_max, T_min and
    T at 24 evenly spaced temperature dofs."""
    x = _np(x)
    p = x[var_dofs(prob, "lub_pressure")]
    T = x[var_dofs(prob, "shell_temperature")]
    return {"load": float(p.mean()), "p_max": float(p.max()),
            "T_min": float(T.min()),
            "T_samples": T[samples(T.size)].tolist()}


# --------------------------------------------------------------------- film
FILM_EPS, FILM_SIGMA, FILM_MU = 0.1, 1.0, 1.0
FILM_LAMBDA = FILM_SIGMA * (2.0 * np.pi ** 2) ** 2 / (3.0 * FILM_MU)
FILM_DT = 0.02 / FILM_LAMBDA
FILM_STEPS = 5


def film(P, n):
    """The drying film (see the module docstring), unsolved. Returns
    (problem, shell block, x0)."""
    mesh = P.mesh.box_mesh(n, n, 1, elem="HEX27", zlim=(-0.05, 0.0))
    bi = P.phys.attach_shell_block(mesh, "top", "film")
    prob = P.Problem(mesh, [[], [P.film.FilmPressure(interp="Q2", transient=True),
                                 P.film.FilmHeight(interp="Q2"),
                                 P.film.FilmParticles(interp="Q2",
                                                      transient=True)]],
                     [{}, {"mu": FILM_MU, "sigma": FILM_SIGMA,
                           "D_partc": 1e-2,
                           "evap": P.film.conc_power_evap(0.05, 1.0, 0.6)}],
                     **P.kw)
    prob.finalize()
    xs, ys = mesh.coords[:, 0], mesh.coords[:, 1]
    mode = np.cos(np.pi * xs) * np.cos(np.pi * ys)
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "film_height", 0,
                              1.0 + FILM_EPS * mode)
    x0 = prob.set_nodal_field(x0, "film_pressure", 0,
                              FILM_SIGMA * FILM_EPS * 2.0 * np.pi ** 2 * mode)
    x0 = prob.set_nodal_field(x0, "film_conc", 0, 0.2)
    return prob, bi, x0


def film_time_options(P):
    return P.TimeOptions(dt0=FILM_DT, t_end=FILM_STEPS * FILM_DT, theta=0.5,
                         adapt=False)


def film_readings(prob, x, t):
    """The amplitude 0.5 (max H - min H) over the shell with its exact
    leveling decay 0.1 exp(-lambda t), H and C at 24 evenly spaced dofs."""
    x = _np(x)
    H = x[var_dofs(prob, "film_height")]
    C = x[var_dofs(prob, "film_conc")]
    return {"t": float(t), "amplitude": float(0.5 * (H.max() - H.min())),
            "exact": float(FILM_EPS * np.exp(-FILM_LAMBDA * t)),
            "H_samples": H[samples(H.size)].tolist(),
            "C_samples": C[samples(C.size)].tolist()}


# -------------------------------------------------------------- small decks
def _direct(P, max_iter=3, tol=1e-11):
    return P.NewtonOptions(max_iter=max_iter, tol_residual=tol,
                           linear_solver="direct")


def _solve(P, prob, x0=None, **kw):
    res = P.NewtonSolver(prob, _direct(P, **kw)).solve(
        np.zeros(prob.dofmap.n_dof) if x0 is None else x0, prob.base_params())
    gate(res.converged, "Newton did not converge")
    return res


def _run(P, prob, x0, dt, t_end, theta=1.0, max_iter=8, tol=1e-12):
    r = P.TransientSolver(prob, _direct(P, max_iter, tol), P.TimeOptions(
        dt0=dt, t_end=t_end, adapt=False, theta=theta)).run(
        x0, prob.base_params())
    gate(all(s.converged for s in r.steps), "a step did not converge")
    return r


def _ends(mesh, ns, L, name):
    mesh.nodesets[name] = np.array(
        [n for n in mesh.nodesets[ns] if abs(mesh.coords[n, 0]) < 1e-12
         or abs(mesh.coords[n, 0] - L) < 1e-12], dtype=np.int32)


def _out(newton, reading, x):
    return {"newton": int(newton), "reading": [float(v) for v in
                                               np.atleast_1d(reading)],
            "x": _np(x)}


def tensioned_string(P):
    """tests/test_shell.py::test_tensioned_string_parabola."""
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9", xlim=(0, 2.0))
    P.phys.attach_shell_block(mesh, "bottom", "string")
    T, q = 3.0, 1.5
    prob = P.Problem(mesh, [[], [P.shell.TensionedString(T, q, interp="Q2")]],
                     [{}, {}], **P.kw)
    _ends(mesh, "bottom", 2.0, "string_ends")
    prob.add_dirichlet("string_ends", "shell_deflection", 0, 0.0)
    prob.finalize()
    res = _solve(P, prob)
    w = prob.get_nodal_field(res.x, "shell_deflection")
    bot = mesh.nodesets["bottom"]
    xb = mesh.coords[bot, 0]
    gate(close(w[bot], q * xb * (2.0 - xb) / (2 * T), atol=1e-10),
         "string parabola")
    return _out(res.iters, w[bot].max(), res.x)


def reynolds_on_shell(P):
    """tests/test_shell.py::test_reynolds_on_shell_block."""
    mu, U, h1, h2, L = 0.1, 2.0, 0.2, 0.1, 1.0
    mesh = P.mesh.rectangle_mesh(30, 1, elem="QUAD9", xlim=(0, L), ylim=(0, 0.05))
    P.phys.attach_shell_block(mesh, "bottom", "film")
    gap = lambda fv, mat, params: h1 + (h2 - h1) * fv.x[:, 0] / L  # noqa: E731
    prob = P.Problem(mesh, [[], [P.lub.ReynoldsFilm(interp="Q2")]],
                     [{}, {"gap": gap, "mu_lub": mu,
                           "wall_velocity": np.array([U, 0.0])}], **P.kw)
    _ends(mesh, "bottom", L, "film_ends")
    prob.add_dirichlet("film_ends", "lub_pressure", 0, 0.0)
    prob.finalize()
    res = _solve(P, prob)
    p = prob.get_nodal_field(res.x, "lub_pressure")
    bot = mesh.nodesets["bottom"]
    xb = np.sort(mesh.coords[bot, 0])
    pb = p[bot][np.argsort(mesh.coords[bot, 0])]
    xs = np.linspace(0, L, 4001)
    h = h1 + (h2 - h1) * xs / L
    a = np.trapezoid(6 * mu * U / h**2, xs)
    b = np.trapezoid(12 * mu / h**3, xs)
    pr = np.cumsum((6 * mu * U / h**2 - 12 * mu * a / b / h**3)) * (xs[1] - xs[0])
    pr -= pr[0]
    gate(close(pb, np.interp(xb, xs, pr), atol=0.02 * np.abs(pr).max()),
         "Reynolds profile")
    return _out(res.iters, pb.max(), res.x)


def shell_bulk_conduction(P):
    """tests/test_shell.py::test_shell_bulk_coupled_conduction."""
    def solve(ks):
        mesh = P.mesh.rectangle_mesh(6, 6, elem="QUAD9")
        E = P.phys.Energy(interp="Q2", transient=False, convection=False)
        if ks is not None:
            P.phys.attach_shell_block(mesh, "bottom", "cond")
            eqs, mats = [[E], [P.shell.ShellConduction(ks, interp="Q2")]], \
                [{"k": 1.0}, {}]
        else:
            eqs, mats = [[E]], [{"k": 1.0}]
        prob = P.Problem(mesh, eqs, mats, **P.kw)
        prob.add_dirichlet("left", "temperature", 0, 1.0)
        prob.add_dirichlet("top", "temperature", 0, 0.0)
        prob.finalize()
        res = _solve(P, prob)
        return mesh, prob.get_nodal_field(res.x, "temperature"), res

    mesh0, T_none, _ = solve(None)
    _, T_zero, _ = solve(0.0)
    gate(close(T_zero, T_none, atol=1e-12), "ks = 0 changes the bulk")
    _, T_big, res = solve(50.0)
    bot = mesh0.nodesets["bottom"]
    order = np.argsort(mesh0.coords[bot, 0])
    s0, s1 = np.std(T_none[bot][order]), np.std(T_big[bot][order])
    gate(s0 > 1e-3 and s1 < 0.3 * s0, f"profile std {s0:.3e} -> {s1:.3e}")
    return _out(res.iters, [s0, s1], res.x)


def shell_elastica(P):
    """tests/test_shell.py::test_shell_structure_elastica."""
    D, Pl, L = 2.0, 1.5, 2.0
    mesh = P.mesh.rectangle_mesh(8, 2, elem="QUAD9", xlim=(0, L))
    P.phys.attach_shell_block(mesh, "bottom", "sheet")
    eqs = [[], [P.shell.ShellCurvature(bend_stiffness=D, interp="Q2"),
                P.shell.ShellTension(bend_stiffness=D, interp="Q2")]]
    prob = P.Problem(mesh, eqs, [{}, {"p_load": Pl}], **P.kw)
    _ends(mesh, "bottom", L, "sheet_ends")
    ends = mesh.nodesets["sheet_ends"]
    prob.add_dirichlet("sheet_ends", "sh_K", 0, 0.0)
    prob.add_dirichlet("bottom", "sh_tens", 0, 0.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=6)
    K = prob.get_nodal_field(res.x, "sh_K")
    bot = mesh.nodesets["bottom"]
    xb = mesh.coords[bot, 0]
    gate(close(K[bot], -Pl * xb * (L - xb) / (2 * D), atol=1e-9),
         "elastica parabola")
    prob2 = P.Problem(mesh, eqs, [{}, {"p_load": Pl}], **P.kw)
    prob2.add_dirichlet("sheet_ends", "sh_K", 0, 0.0)
    mesh.nodesets["sheet_left"] = ends[:1]
    prob2.add_dirichlet("sheet_left", "sh_tens", 0, 1.0)
    prob2.finalize()
    res2 = _solve(P, prob2, max_iter=12)
    K2 = prob2.get_nodal_field(res2.x, "sh_K")[bot]
    T2 = prob2.get_nodal_field(res2.x, "sh_tens")[bot]
    C = T2 + D * K2**2 / 2
    span = np.nanmax(D * K2**2 / 2) - np.nanmin(D * K2**2 / 2)
    gate(np.nanstd(C) < 0.05 * span, f"first integral {np.nanstd(C):.3e}")
    return _out(res2.iters, [np.nanmin(K2), np.nanmax(T2)], res2.x)


def tfmp_squeeze(P):
    """tests/test_shell.py::test_tfmp_sealed_squeeze_film."""
    h0, S0, P0, a = 0.2, 0.6, 1.0, 0.5
    mesh = P.mesh.rectangle_mesh(6, 1, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.05))
    P.phys.attach_shell_block(mesh, "bottom", "film")
    xp = P.xp

    def gap(fv, mat, params):
        return h0 * (1.0 - a * params["time"]) * xp.ones_like(fv.x[:, 0])

    prob = P.Problem(mesh, [[], [P.lub.TFMPMass(interp="Q2", transient=True),
                                 P.lub.TFMPBound(interp="Q2", transient=True)]],
                     [{}, {"gap": gap, "mu_l": 1.0, "mu_g": 0.5,
                           "rho_g": lambda p: 0.8 * p}], **P.kw)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "tfmp_sat", 0, S0)
    x0 = prob.set_nodal_field(x0, "tfmp_pres", 0, P0)
    r = _run(P, prob, x0, 0.005, 0.6, theta=0.5, max_iter=10)
    bot = mesh.nodesets["bottom"]
    S = prob.get_nodal_field(r.x, "tfmp_sat")[bot]
    Pr = prob.get_nodal_field(r.x, "tfmp_pres")[bot]
    h = h0 * (1 - a * r.t)
    eS = np.abs(S / (S0 * h0 / h) - 1).max()
    eP = np.abs(Pr / (P0 * h0 * (1 - S0) / (h - h0 * S0)) - 1).max()
    gate(eS <= 2e-4 and eP <= 2e-3, f"squeeze film S {eS:.2e} P {eP:.2e}")
    return _out(sum(s.newton_iters for s in r.steps), [S.mean(), Pr.mean()], r.x)


def hermite_beam(P):
    """tests/test_shell.py::test_hermite_beam_bending."""
    EI, q, L = 2.0, 1.5, 2.0
    mesh = P.mesh.rectangle_mesh(5, 1, elem="QUAD9", xlim=(0, L), ylim=(0, 0.1))
    P.phys.attach_shell_block(mesh, "bottom", "beam")
    blk = mesh.blocks[-1]
    blk.elem_type = "BAR2"
    blk.conn = blk.conn[:, :2].copy()
    prob = P.Problem(mesh, [[], [P.shell.BeamBending(EI=EI, load=q)]],
                     [{}, {}], **P.kw)
    _ends(mesh, "bottom", L, "beam_ends")
    prob.add_dirichlet("beam_ends", "beam_w", 0, 0.0)
    prob.add_dirichlet("beam_ends", "beam_w", 1, 0.0)
    prob.finalize()
    res = _solve(P, prob, tol=1e-12)
    w = prob.get_nodal_field(res.x, "beam_w", 0)
    s = prob.get_nodal_field(res.x, "beam_w", 1)
    nodes = np.unique(blk.conn)
    xb = mesh.coords[nodes, 0]
    gate(close(w[nodes], q * xb**2 * (L - xb) ** 2 / (24 * EI), atol=1e-12)
         and close(s[nodes], q * (2 * xb * (L - xb) ** 2 - 2 * xb**2 * (L - xb))
                   / (24 * EI), atol=1e-12), "Hermite beam")
    return _out(res.iters, [w[nodes].max(), s[nodes].max()], res.x)


def _cylinder_surface_mesh(P, n_theta, n_z, R, H):
    th = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    zz = np.linspace(0, H, n_z + 1)
    coords = np.array([[R * np.cos(t), R * np.sin(t), z] for z in zz for t in th])

    def nid(i, k):
        return k * n_theta + (i % n_theta)

    conn = [[nid(i, k), nid(i + 1, k), nid(i + 1, k + 1), nid(i, k + 1)]
            for k in range(n_z) for i in range(n_theta)]
    mesh = P.mesh.Mesh(3, coords, [P.mesh.Block(
        "wall", "QUAD4", np.asarray(conn, dtype=np.int32))])
    mesh.nodesets = {
        "bottom": np.arange(n_theta, dtype=np.int32),
        "top": np.arange(n_z * n_theta, (n_z + 1) * n_theta, dtype=np.int32)}
    mesh.sidesets = {}
    return mesh


def laplace_beltrami_cylinder(P):
    """tests/test_shell3d.py::test_laplace_beltrami_on_cylinder."""
    R, H = 1.0, 2.0
    mesh = _cylinder_surface_mesh(P, 32, 8, R, H)
    prob = P.Problem(mesh, [P.shell.ShellConduction(1.0, interp="Q1")], {},
                     **P.kw)
    prob.add_dirichlet("bottom", "temperature", 0, lambda X: X[:, 0] / R)
    prob.add_dirichlet("top", "temperature", 0, 0.0)
    prob.finalize()
    res = _solve(P, prob)
    T = prob.get_nodal_field(res.x, "temperature")
    theta = np.arctan2(mesh.coords[:, 1], mesh.coords[:, 0])
    z = mesh.coords[:, 2]
    err = np.abs(T - np.cos(theta) * np.sinh((H - z) / R) / np.sinh(H / R)).max()
    gate(err < 0.02, f"Laplace-Beltrami {err:.2e}")
    return _out(res.iters, err, res.x)


def hex_face_shell(P):
    """tests/test_shell3d.py::test_attach_shell_on_hex_face_and_couple."""
    mesh = P.mesh.box_mesh(3, 3, 3, elem="HEX8")
    bi = P.phys.attach_shell_block(mesh, "top", "lid")
    gate(mesh.blocks[bi].elem_type == "QUAD4"
         and mesh.blocks[bi].conn.shape == (9, 4), "shell block layout")
    gate(set(mesh.blocks[bi].conn.ravel().tolist())
         <= set(mesh.nodesets["top"].tolist()), "shell nodes off the top")
    prob = P.Problem(mesh, [[P.phys.Energy(interp="Q1", transient=False,
                                           convection=False)],
                            [P.shell.ShellConduction(50.0, interp="Q1")]],
                     [{"rho": 1.0, "Cp": 1.0, "k": 1.0}, {}], **P.kw)
    prob.add_dirichlet("bottom", "temperature", 0, 0.0)
    prob.add_dirichlet("top", "temperature", 0, 1.0)
    prob.finalize()
    res = _solve(P, prob)
    T = prob.get_nodal_field(res.x, "temperature")
    gate(close(T, mesh.coords[:, 2], atol=1e-9), "1D conduction")
    return _out(res.iters, T.mean(), res.x)


def end_flux_reynolds(P):
    """tests/test_shell_end.py::test_reynolds_film_end_flux_exact."""
    mu, U, h, L, Q = 0.3, 1.2, 0.15, 2.0, 0.05
    mesh = P.mesh.rectangle_mesh(16, 1, elem="QUAD9", xlim=(0, L), ylim=(0, 0.05))
    bi = P.phys.attach_shell_block(mesh, "bottom", "film")
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="film_end")
    gate(len(ends) == 2, "two film ends")
    prob = P.Problem(mesh, [[], [P.lub.ReynoldsFilm(interp="Q2")]],
                     [{}, {"gap": h, "mu_lub": mu,
                           "wall_velocity": np.array([U, 0.0])}], **P.kw)
    prob.add_face_kernel("film_end_0", P.shell_end.EndpointFlux("lub_pressure", Q))
    mesh.nodesets["film_right"] = np.array(
        [n for n in mesh.nodesets["bottom"]
         if abs(mesh.coords[n, 0] - L) < 1e-12], dtype=np.int32)
    prob.add_dirichlet("film_right", "lub_pressure", 0, 0.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=6)
    p = prob.get_nodal_field(res.x, "lub_pressure")
    bot = mesh.nodesets["bottom"]
    xb = mesh.coords[bot, 0]
    ex = (U * h / 2 + Q) * 12 * mu / h**3 * (xb - L)
    gate(np.all(np.abs(p[bot] - ex) <= 1e-9 + 1e-9 * np.abs(ex)),
         "end-flux pressure")
    return _out(res.iters, p[bot].min(), res.x)


def end_flux_arc(P):
    """tests/test_shell_end.py::test_conduction_end_flux_on_curved_arc."""
    L, ks, g = 1.0, 2.5, 0.7
    mesh = P.mesh.rectangle_mesh(24, 2, elem="QUAD9", xlim=(0, L))
    y0 = mesh.coords[:, 1].copy()
    mesh.coords[:, 1] = y0 + 0.2 * np.sin(np.pi * mesh.coords[:, 0] / L) * (1 - y0)
    bi = P.phys.attach_shell_block(mesh, "bottom", "wire")
    P.shell_end.shell_end_sidesets(mesh, bi, prefix="wire_end")
    prob = P.Problem(mesh, [[], [P.shell.ShellConduction(ks, var="temperature",
                                                         interp="Q2")]],
                     [{}, {}], **P.kw)
    prob.add_face_kernel("wire_end_1", P.shell_end.EndpointFlux("temperature", g))
    mesh.nodesets["wire_left"] = np.array(
        [n for n in mesh.nodesets["bottom"] if abs(mesh.coords[n, 0]) < 1e-12],
        dtype=np.int32)
    prob.add_dirichlet("wire_left", "temperature", 0, 0.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=6)
    T = prob.get_nodal_field(res.x, "temperature")
    nodes = np.unique(mesh.blocks[bi].conn)
    nd = nodes[np.argsort(mesh.coords[nodes, 0])]
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(mesh.coords[nd], axis=0), axis=1))])
    ex = -(g / ks) * s
    gate(np.all(np.abs(T[nd] - ex) <= 5e-5 + 5e-4 * np.abs(ex)), "arc flux")
    return _out(res.iters, T[nd].min(), res.x)


def end_advective_outflow(P):
    """tests/test_shell_end.py::test_endpoint_advective_outflow_conserves."""
    U, D, L, F = 2.0, 0.05, 4.0, 1.0
    mesh = P.mesh.rectangle_mesh(80, 1, elem="QUAD9", xlim=(0, L), ylim=(0, 0.02))
    bi = P.phys.attach_shell_block(mesh, "bottom", "film")
    P.shell_end.shell_end_sidesets(mesh, bi, prefix="ad_end")
    xp = P.xp

    class CurveAdvDiff(P.eqs.Equation):
        def __init__(self):
            super().__init__("conc", 1, "Q2")

        def residual(self, fv, mat, params):
            c = fv.val["conc"][:, 0]
            gc = fv.grad["conc"][:, 0, :]
            u = xp.stack([xp.full_like(c, float(v)) for v in mat["u_adv"]], 1)
            flux = u * c[:, None] - mat["D"] * gc
            return -xp.einsum("qk,qik->qi", flux, fv.gphi["conc"])[:, None, :]

    prob = P.Problem(mesh, [[], [CurveAdvDiff()]],
                     [{}, {"u_adv": np.array([U, 0.0]), "D": D}], **P.kw)
    prob.add_face_kernel("ad_end_0", P.shell_end.EndpointFlux("conc", -F))
    prob.add_face_kernel("ad_end_1", P.shell_end.EndpointAdvectiveOutflow(
        "conc", velocity="u_adv"))
    prob.finalize()
    res = _solve(P, prob, max_iter=6)
    c = prob.get_nodal_field(res.x, "conc")
    bot = mesh.nodesets["bottom"]
    xb = mesh.coords[bot, 0]
    mid = bot[(xb > 1.0) & (xb < 3.5)]
    gate(np.abs(c[mid] / (F / U) - 1).max() <= 1e-6, "outflow plateau")
    return _out(res.iters, c[mid].mean(), res.x)


def _film_mesh(P, nx=24, L=1.0):
    mesh = P.mesh.rectangle_mesh(nx, 1, elem="QUAD9", xlim=(0, L), ylim=(0, 0.05))
    return mesh, P.phys.attach_shell_block(mesh, "bottom", "film")


def capillary_leveling(P):
    """tests/test_shell_film.py::test_capillary_leveling_rate."""
    L, h0, eps, sigma, mu = 1.0, 1.0, 1e-3, 1.0, 1.0
    k = np.pi / L
    lam = sigma * h0**3 * k**4 / (3.0 * mu)
    mesh, bi = _film_mesh(P, nx=28, L=L)
    prob = P.Problem(mesh, [[], [P.film.FilmPressure(interp="Q2", transient=True),
                                 P.film.FilmHeight(interp="Q2")]],
                     [{}, {"mu": mu, "sigma": sigma}], **P.kw)
    prob.finalize()
    xs = mesh.coords[:, 0]
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "film_height", 0,
                              h0 + eps * np.cos(k * xs))
    x0 = prob.set_nodal_field(x0, "film_pressure", 0,
                              sigma * eps * k**2 * np.cos(k * xs))
    t_end = 0.2 / lam
    r = _run(P, prob, x0, t_end / 40, t_end, theta=0.5, tol=1e-10)
    sn = np.unique(mesh.blocks[bi].conn)
    H = prob.get_nodal_field(r.x, "film_height", 0)[sn]
    amp = 0.5 * (H.max() - H.min())
    expect = eps * np.exp(-lam * r.t)
    gate(abs(amp / expect - 1) <= 0.05, f"leveling {amp} vs {expect}")
    return _out(sum(s.newton_iters for s in r.steps), amp, r.x)


def film_evaporation(P):
    """tests/test_shell_film.py::test_film_evaporation_concentrates_particles."""
    H0, C0, E = 1.0, 0.1, 0.5
    mesh, bi = _film_mesh(P, nx=6)
    prob = P.Problem(mesh, [[], [P.film.FilmPressure(interp="Q2", transient=True),
                                 P.film.FilmHeight(interp="Q2"),
                                 P.film.FilmParticles(interp="Q2", transient=True)]],
                     [{}, {"mu": 1.0, "sigma": 1.0, "evap": E, "D_partc": 0.0}],
                     **P.kw)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "film_height", 0, H0)
    x0 = prob.set_nodal_field(x0, "film_conc", 0, C0)
    r = _run(P, prob, x0, 0.05, 0.6, theta=0.5, tol=1e-11)
    sn = np.unique(mesh.blocks[bi].conn)
    H = prob.get_nodal_field(r.x, "film_height", 0)[sn]
    C = prob.get_nodal_field(r.x, "film_conc", 0)[sn]
    eH = np.abs(H / (H0 - E * r.t) - 1).max()
    eC = np.abs(C / (C0 * H0 / (H0 - E * r.t)) - 1).max()
    gate(eH <= 1e-6 and eC <= 1e-3, f"evaporation H {eH:.2e} C {eC:.2e}")
    return _out(sum(s.newton_iters for s in r.steps), [H.mean(), C.mean()], r.x)


def shell_energy_fin(P):
    """tests/test_shell_film.py::test_shell_energy_fin_exact."""
    L, Hk, ht, T0, Tamb = 1.0, 0.05, 4.0, 2.0, 0.5
    m = np.sqrt(ht / Hk)
    mesh, bi = _film_mesh(P, nx=30, L=L)
    prob = P.Problem(mesh, [[], [P.film.ShellEnergy(interp="Q2", transient=False)]],
                     [{}, {"rho": 1.0, "Cp": 1.0, "k": Hk, "gap": 1.0,
                           "ht_coeff": ht, "ht_tamb": Tamb}], **P.kw)
    prob.add_dirichlet("left", "shell_temperature", 0, T0)
    prob.finalize()
    res = _solve(P, prob, max_iter=5)
    T = prob.get_nodal_field(res.x, "shell_temperature", 0)
    sn = np.unique(mesh.blocks[1].conn)
    xs = mesh.coords[sn, 0]
    ex = Tamb + (T0 - Tamb) * np.cosh(m * (L - xs)) / np.cosh(m * L)
    gate(np.all(np.abs(T[sn] - ex) <= 2e-3 + 2e-3 * np.abs(ex)), "fin profile")
    return _out(res.iters, T[sn].min(), res.x)


def shell_species_exact(P):
    """tests/test_shell_film.py::test_shell_species_advection_diffusion_exact."""
    L, H, D, q = 1.0, 0.2, 0.05, 0.04
    Pe = q * L / (H * D)
    mesh, bi = _film_mesh(P, nx=40, L=L)
    xp = P.xp
    qf = lambda fv, mat, params: xp.stack(  # noqa: E731
        [xp.full_like(fv.x[:, 0], q), xp.zeros_like(fv.x[:, 0])], 1)
    prob = P.Problem(mesh, [[], [P.film.ShellSpecies(interp="Q2", transient=False)]],
                     [{}, {"D_shell": D, "gap": H, "lub_flux": qf}], **P.kw)
    prob.add_dirichlet("left", "shell_species", 0, 0.0)
    prob.add_dirichlet("right", "shell_species", 0, 1.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=5)
    c = prob.get_nodal_field(res.x, "shell_species", 0)
    sn = np.unique(mesh.blocks[1].conn)
    xs = mesh.coords[sn, 0]
    ex = (np.exp(Pe * xs / L) - 1.0) / (np.exp(Pe) - 1.0)
    gate(np.all(np.abs(c[sn] - ex) <= 2e-3 + 2e-3 * np.abs(ex)), "species layer")
    return _out(res.iters, c[sn].mean(), res.x)


def shell_species_source(P):
    """tests/test_shell_film.py::test_shell_species_source_decay_transient."""
    H, s, t_end = 0.5, 0.3, 0.4
    mesh, bi = _film_mesh(P, nx=6)
    prob = P.Problem(mesh, [[], [P.film.ShellSpecies(interp="Q2", transient=True)]],
                     [{}, {"D_shell": 0.01, "gap": H,
                           "shell_species_source": s}], **P.kw)
    prob.finalize()
    r = P.TransientSolver(prob, _direct(P, 6, 1e-12), P.TimeOptions(
        dt0=0.05, t_end=t_end, adapt=False)).run(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    c = prob.get_nodal_field(r.x, "shell_species", 0)
    sn = np.unique(mesh.blocks[1].conn)
    gate(np.all(np.abs(c[sn] - s / H * t_end) <= 1e-10 + 1e-8 * s / H * t_end),
         "species source")
    return _out(sum(st.newton_iters for st in r.steps), c[sn].mean(), r.x)


MAT_CLOSED = {"porosity": 0.4, "pore_radius": 0.02, "pore_height": 1.0,
              "mu": 1.0, "sigma": 1.0, "contact_angle_deg": 30.0,
              "P0": 0.2, "nbar": 1.0, "lub_pressure": 0.5}
MAT_GASN = {"porosity": 0.4, "pore_radius": 0.02, "pore_height": 1.0,
            "mu": 1.0, "sigma": 1.0, "contact_angle_deg": 30.0,
            "P0": 0.2, "lub_pressure": 0.5,
            "Patm": 0.15, "henry": 2.0, "RT": 1.0, "gas_diffusivity": 0.3}


def _vz(m, S, n):
    k = m["porosity"] * m["pore_radius"] ** 2 / 8.0
    Pcap = 2 * m["sigma"] * np.cos(np.deg2rad(m["contact_angle_deg"])) \
        / m["pore_radius"]
    H = m["pore_height"]
    dPdz = (m["P0"] * n / (1.0 - S) - m["lub_pressure"] - Pcap) / (S * H)
    return -(k / m["mu"]) * dPdz / (m["porosity"] * H)


def _porous_mesh(P, nx=8, L=1.0, name="porous"):
    mesh = P.mesh.rectangle_mesh(nx, 1, elem="QUAD9", xlim=(0, L), ylim=(0, 0.05))
    return mesh, P.phys.attach_shell_block(mesh, "bottom", name)


def closed_cell_imbibition(P):
    """tests/test_shell_porous.py::test_closed_cell_imbibition_ode."""
    from scipy.integrate import solve_ivp

    mesh, bi = _porous_mesh(P, nx=4)
    prob = P.Problem(mesh, [[], [P.porous.PorousShellClosed(interp="Q2")]],
                     [{}, dict(MAT_CLOSED)], **P.kw)
    prob.finalize()
    S0 = 0.05
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "shell_sat_closed", 0, S0)
    r = _run(P, prob, x0, 0.02, 2.0, theta=0.5)
    sn = np.unique(mesh.blocks[bi].conn)
    S = prob.get_nodal_field(r.x, "shell_sat_closed", 0)[sn]
    ref = solve_ivp(lambda t, s: _vz(MAT_CLOSED, s, MAT_CLOSED["nbar"]),
                    (0, r.t), [S0], rtol=1e-10, atol=1e-12).y[0, -1]
    gate(S.std() < 1e-10 and abs(S.mean() / ref - 1) <= 2e-3 and S.mean() > S0,
         f"imbibition {S.mean()} vs {ref}")
    return _out(sum(s.newton_iters for s in r.steps), S.mean(), r.x)


def open_cell_diffusion(P):
    """tests/test_shell_porous.py::test_open_cell_diffusion_rate."""
    L, c, kperm, mu, phi_p, Hl = 1.0, 0.5, 0.01, 1.0, 0.4, 1.0
    lam = kperm / (mu * phi_p * c) * (np.pi / L) ** 2
    mesh, bi = _porous_mesh(P, nx=20, L=L)
    prob = P.Problem(mesh, [[], [P.porous.PorousShellOpen(interp="Q2",
                                                          transient=True)]],
                     [{}, {"porosity": phi_p, "permeability": kperm, "mu": mu,
                           "gap": Hl,
                           "retention": P.porous.linear_retention(S0=0.5, c=c)}],
                     **P.kw)
    prob.finalize()
    eps = 1e-3
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "shell_press_open", 0,
                              eps * np.cos(np.pi / L * mesh.coords[:, 0]))
    t_end = 0.3 / lam
    r = _run(P, prob, x0, t_end / 40, t_end, theta=0.5)
    sn = np.unique(mesh.blocks[bi].conn)
    Pr = prob.get_nodal_field(r.x, "shell_press_open", 0)[sn]
    amp = 0.5 * (Pr.max() - Pr.min())
    gate(abs(amp / (eps * np.exp(-lam * r.t)) - 1) <= 0.03, "open-cell decay")
    return _out(sum(s.newton_iters for s in r.steps), amp, r.x)


def two_layer_stack(P):
    """tests/test_shell_porous.py::test_two_layer_stack_conserves_and_equilibrates."""
    mesh, bi = _porous_mesh(P, nx=4)
    H1, H2, p1, p2, G = 1.0, 2.0, 0.5, 0.25, 5.0
    mat = {"gap_1": H1, "porosity_1": p1, "diffusivity_1": 0.0,
           "gap_2": H2, "porosity_2": p2, "diffusivity_2": 0.0,
           "exchange_G": G, "pcap_1": lambda s: 1.0 - s,
           "pcap_2": lambda s: 1.0 - s}
    prob = P.Problem(mesh, [[], [P.porous.PorousShellStackLayer(0, 2, interp="Q2"),
                                 P.porous.PorousShellStackLayer(1, 2, interp="Q2")]],
                     [{}, mat], **P.kw)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "shell_sat_1", 0, 0.8)
    x0 = prob.set_nodal_field(x0, "shell_sat_2", 0, 0.2)
    r = _run(P, prob, x0, 0.05, 5.0, theta=0.5)
    sn = np.unique(mesh.blocks[bi].conn)
    S1 = prob.get_nodal_field(r.x, "shell_sat_1", 0)[sn].mean()
    S2 = prob.get_nodal_field(r.x, "shell_sat_2", 0)[sn].mean()
    tot0 = H1 * p1 * 0.8 + H2 * p2 * 0.2
    gate(abs((H1 * p1 * S1 + H2 * p2 * S2) / tot0 - 1) <= 1e-8
         and abs(S1 - S2) <= 1e-3, "stack conservation")
    return _out(sum(s.newton_iters for s in r.steps), [S1, S2], r.x)


def closed_cell_numjac(P):
    """tests/test_shell_porous.py::test_closed_cell_lub_sink_numjac."""
    import scipy.sparse as sp

    mesh, bi = _porous_mesh(P, nx=4)
    mat = dict(MAT_CLOSED)
    del mat["lub_pressure"]
    mat["gap"] = 0.3
    mat["mu_lub"] = 1.0
    prob = P.Problem(mesh, [[], [P.porous.PorousShellClosed(interp="Q2"),
                                 P.lub.ReynoldsFilm(interp="Q2", transient=False),
                                 P.porous.LubPorousSink(interp="Q2")]],
                     [{}, mat], **P.kw)
    prob.finalize()
    rng = np.random.RandomState(0)
    x = np.zeros(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "shell_sat_closed", 0,
                             0.3 + 0.1 * rng.rand(mesh.n_nodes))
    x = prob.set_nodal_field(x, "lub_pressure", 0, 0.2 * rng.rand(mesh.n_nodes))
    params = prob.base_params()
    R0, vals = (_np(a) for a in prob._assemble(P.arr(x), params))
    A = sp.csr_matrix((vals, prob.pattern.indices, prob.pattern.indptr),
                      shape=(prob.pattern.n,) * 2)
    h, worst = 1e-6, 0.0
    for j in rng.choice(prob.dofmap.n_dof, 6, replace=False):
        xp_ = x.copy()
        xp_[j] += h
        fd = (_np(prob._assemble(P.arr(xp_), params)[0]) - R0) / h
        col = A[:, j].toarray()[:, 0]
        worst = max(worst, float(np.max(np.abs(col - fd) / (5e-6 + 2e-4 * np.abs(fd)))))
    gate(worst <= 1.0, f"FD Jacobian {worst:.2f} of its tolerance")
    return _out(0, [np.linalg.norm(R0), np.abs(vals).sum()], x)


def gasn_dissolution(P):
    """tests/test_shell_breadth2.py::test_gasn_dissolution_ode."""
    from scipy.integrate import solve_ivp

    mesh, bi = _porous_mesh(P, nx=4, name="shell")
    prob = P.Problem(mesh, [[], [P.porous.PorousShellClosed(interp="Q2"),
                                 P.porous.PorousShellGasN(interp="Q2")]],
                     [{}, dict(MAT_GASN)], **P.kw)
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "shell_sat_closed", 0, 0.05)
    x0 = prob.set_nodal_field(x0, "shell_sat_gasn", 0, 1.0)
    r = _run(P, prob, x0, 0.02, 2.0, theta=0.5)
    sn = np.unique(mesh.blocks[bi].conn)
    S = prob.get_nodal_field(r.x, "shell_sat_closed", 0)[sn]
    n = prob.get_nodal_field(r.x, "shell_sat_gasn", 0)[sn]
    m = MAT_GASN
    Z = m["RT"] * m["gas_diffusivity"] / (m["pore_height"] ** 2 * m["henry"])

    def rhs(t, y):
        return [_vz(m, y[0], y[1]),
                -Z / y[0] * (y[1] / (1.0 - y[0]) - m["Patm"] / m["P0"])]

    ref = solve_ivp(rhs, (0, r.t), [0.05, 1.0], rtol=1e-10, atol=1e-12)
    gate(S.std() < 1e-10 and n.std() < 1e-10
         and abs(S.mean() / ref.y[0, -1] - 1) <= 2e-3
         and abs(n.mean() / ref.y[1, -1] - 1) <= 2e-3 and n.mean() < 1.0,
         "gas dissolution")
    return _out(sum(s.newton_iters for s in r.steps), [S.mean(), n.mean()], r.x)


def power_law_squeeze(P, nexp):
    """tests/test_shell_breadth2.py::test_power_law_squeeze_pressure."""
    L, h0, c, m = 1.0, 0.2, 0.05, 2.0
    mesh, bi = _porous_mesh(P, nx=10, L=L, name="shell")
    xp = P.xp
    mat = {"gap": lambda fv, mt, p: (h0 - c * p["time"]) * xp.ones_like(fv.x[:, 0]),
           "m_lub": m, "n_exp": nexp}
    prob = P.Problem(mesh, [[], [P.lub.ReynoldsFilmPowerLaw(interp="Q2",
                                                            transient=True)]],
                     [{}, mat], **P.kw)
    sn = np.unique(mesh.blocks[bi].conn)
    mesh.nodesets["lub_right"] = sn[np.isclose(mesh.coords[sn, 0], L)]
    prob.add_dirichlet("lub_right", "lub_pressure", 0, 0.0)
    prob.finalize()
    coef0 = (2 * nexp / (2 * nexp + 1)) * (h0 / 2) ** ((2 * nexp + 1) / nexp)
    x0 = prob.set_nodal_field(
        np.zeros(prob.dofmap.n_dof), "lub_pressure", 0,
        lambda cc: 1.3 * m * (c / coef0) ** nexp
        * (L ** (nexp + 1) - cc[:, 0] ** (nexp + 1)) / (nexp + 1))
    r = _run(P, prob, x0, 1e-3, 1e-3, theta=1.0, max_iter=12)
    h = h0 - c * r.t
    coef = (2 * nexp / (2 * nexp + 1)) * (h / 2) ** ((2 * nexp + 1) / nexp)
    xs = mesh.coords[sn, 0]
    Pr = prob.get_nodal_field(r.x, "lub_pressure", 0)[sn]
    ex = m * (c / coef) ** nexp * (L ** (nexp + 1) - xs ** (nexp + 1)) / (nexp + 1)
    err = np.max(np.abs(Pr - ex)) / np.max(np.abs(ex))
    gate(err < 2e-3, f"power-law squeeze {err:.2e}")
    return _out(sum(s.newton_iters for s in r.steps), Pr.max(), r.x)


def lub_curvature_circle(P):
    """tests/test_shell_breadth2.py::test_lubrication_curvature_circle."""
    r0, alpha = 0.3, 0.12
    mesh = P.mesh.rectangle_mesh(24, 24, elem="QUAD4")
    xp = P.xp

    class PinField(P.eqs.Equation):
        def __init__(self):
            super().__init__("fill", 1, "Q1")

        def residual(self, fv, mat, params):
            tgt = xp.sqrt((fv.x[:, 0] - 0.5) ** 2 + (fv.x[:, 1] - 0.5) ** 2) - r0
            d = fv.val["fill"][:, 0] - tgt
            return (d[:, None] * fv.phi["fill"])[:, None, :]

    prob = P.Problem(mesh, [[PinField(), P.lub.LubricationCurvature()]],
                     [{"curv_diff": 0.05, "ls_alpha": alpha}], **P.kw)
    prob.finalize()
    res = _solve(P, prob, max_iter=6)
    F = prob.get_nodal_field(res.x, "fill", 0)
    kap = prob.get_nodal_field(res.x, "lub_curv", 0)
    band = np.abs(F) < 0.4 * alpha
    med = float(np.median(kap[band]))
    gate(band.sum() > 10 and abs(med * r0 - 1) <= 0.08, f"kappa {med}")
    return _out(res.iters, med, res.x)


def surface_charge_decay(P):
    """tests/test_shell_breadth2.py::test_surface_charge_decay."""
    L, Ds = 1.0, 0.05
    mesh, bi = _porous_mesh(P, nx=12, L=L, name="shell")
    prob = P.Problem(mesh, [[], [P.shell.SurfaceCharge(Ds, interp="Q2")]],
                     [{}, {}], **P.kw)
    prob.finalize()
    sn = np.unique(mesh.blocks[bi].conn)
    xs = mesh.coords[sn, 0]
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "surface_charge", 0,
                              lambda c: 1.0 + 0.5 * np.cos(np.pi * c[:, 0] / L))
    r = _run(P, prob, x0, 0.01, 1.0, theta=0.5, max_iter=6)
    qs = prob.get_nodal_field(r.x, "surface_charge", 0)[sn]
    ex = 1.0 + 0.5 * np.exp(-Ds * (np.pi / L) ** 2 * r.t) * np.cos(np.pi * xs / L)
    gate(np.max(np.abs(qs - ex)) < 2e-3, "charge decay")
    return _out(sum(s.newton_iters for s in r.steps), qs.max(), r.x)


def _web(P, T=2.0, p=0.4, nx=16, penalty=1e4):
    mesh = P.mesh.rectangle_mesh(nx, 4, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.EllipticMesh(2)],
                     {"lame_mu": 1e-3, "lame_lambda": 1e-3}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, P.MESH_VAR, 0, 0.0)
    for ns in ("top", "left", "right"):
        prob.add_dirichlet(ns, P.MESH_VAR, 1, 0.0)
    prob.add_face_kernel("bottom", P.sheet.TensionSheet(
        2, tension=T, normal_comp=1, load=p, include_fluid_stress=False,
        penalty=penalty))
    prob.finalize()
    return mesh, prob


def tension_sheet_parabola(P):
    """tests/test_sheet_bc.py::test_tension_sheet_parabola."""
    T, p = 2.0, 0.4
    mesh, prob = _web(P, T=T, p=p)
    res = _solve(P, prob, max_iter=10, tol=1e-10)
    dy = prob.get_nodal_field(res.x, P.MESH_VAR, 1)
    web = mesh.nodesets["bottom"]
    xs = mesh.coords[web, 0]
    inner = (xs > 1e-9) & (xs < 1 - 1e-9)
    ex = p * xs * (1.0 - xs) / (2.0 * T)
    gate(np.all(np.abs(dy[web][inner] - ex[inner]) <= 1e-6 + 1.2e-2 * ex[inner])
         and abs(dy[web].max() / (p / (8 * T)) - 1) <= 1.2e-2, "web parabola")
    return _out(res.iters, dy[web].max(), res.x)


def tension_sheet_stiffer(P):
    """tests/test_sheet_bc.py::test_tension_sheet_stiffer_web_deflects_less."""
    out = []
    for T in (2.0, 8.0):
        _, prob = _web(P, T=T)
        res = _solve(P, prob, max_iter=10, tol=1e-10)
        out.append((res, np.nanmax(prob.get_nodal_field(res.x, P.MESH_VAR, 1))))
    gate(out[1][1] < 0.3 * out[0][1], "stiffer web")
    return _out(out[1][0].iters, [out[0][1], out[1][1]], out[1][0].x)


def sheet_end_slope(P):
    """tests/test_sheet_bc.py::test_sheet_end_slope_natural_term."""
    T, s0, pen = 2.0, 0.05, 500.0
    mesh = P.mesh.rectangle_mesh(8, 4, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.EllipticMesh(2)], {}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, P.MESH_VAR, 0, 0.0)
    prob.add_dirichlet("top", P.MESH_VAR, 1, 0.0)
    prob.add_dirichlet("left", P.MESH_VAR, 1, 0.0)
    prob.add_face_kernel("bottom", P.sheet.TensionSheet(
        2, tension=T, normal_comp=1, load=0.0, include_fluid_stress=False,
        penalty=pen))
    web = mesh.nodesets["bottom"]
    mesh.nodesets["web_r"] = np.array([web[np.argmax(mesh.coords[web, 0])]],
                                      dtype=np.int64)
    P.sheet.add_sheet_end_slope(prob, "web_r", pen * T, s0, sign=1.0)
    prob.finalize()
    res = _solve(P, prob, max_iter=10)
    dy = prob.get_nodal_field(res.x, P.MESH_VAR, 1)
    ex = s0 * mesh.coords[web, 0]
    gate(np.all(np.abs(dy[web] - ex) <= 2e-4 + 0.05 * np.abs(ex)), "end slope")
    return _out(res.iters, dy[web].max(), res.x)


def lub_film_junction(P):
    """tests/test_lub_film_junction.py::
    test_lub_film_junction_flux_and_pressure_continuity."""
    P0, H1, H2, mu, xj = 1.0, 0.4, 0.3, 1.0, 0.5
    mesh = P.mesh.rectangle_mesh(8, 1, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.05))
    ss = mesh.sidesets["bottom"]
    xc = np.array([mesh.coords[mesh.blocks[0].conn[e]][:, 0].mean()
                   for e in ss.elems])
    left = xc < xj
    mesh.sidesets["bot_lub"] = P.mesh.SideSet(elems=ss.elems[left],
                                              faces=ss.faces[left])
    mesh.sidesets["bot_film"] = P.mesh.SideSet(elems=ss.elems[~left],
                                               faces=ss.faces[~left])
    bl = P.phys.attach_shell_block(mesh, "bot_lub", "lub")
    bf = P.phys.attach_shell_block(mesh, "bot_film", "film")
    eqs = [[] for _ in mesh.blocks]
    mats = [{} for _ in mesh.blocks]
    eqs[bl] = [P.lub.ReynoldsFilm(interp="Q2")]
    mats[bl] = {"gap": H1, "mu_lub": mu}
    eqs[bf] = [P.film.FilmPressure(interp="Q2", transient=False),
               P.film.FilmHeight(interp="Q2")]
    mats[bf] = {"mu": mu, "sigma": 1.0}
    prob = P.Problem(mesh, eqs, mats, **P.kw)
    ln = np.unique(mesh.blocks[bl].conn)
    fn = np.unique(mesh.blocks[bf].conn)
    junction = np.intersect1d(ln, fn)
    gate(junction.size == 1, "one junction node")
    mesh.nodesets["junction"] = junction.astype(np.int32)
    mesh.nodesets["lub_in"] = ln[np.isclose(mesh.coords[ln, 0], 0.0)].astype(np.int32)
    mesh.nodesets["film_out"] = fn[np.isclose(mesh.coords[fn, 0], 1.0)].astype(np.int32)
    mesh.nodesets["film_all"] = fn.astype(np.int32)
    prob.add_dirichlet("lub_in", "lub_pressure", 0, P0)
    prob.add_dirichlet("film_out", "film_pressure", 0, 0.0)
    prob.add_dirichlet("film_all", "film_height", 0, H2)
    P.lub.tie_lub_film(prob, "junction")
    prob.finalize()
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "film_height", 0, H2)
    res = _solve(P, prob, x0, max_iter=6)
    mA, mB = H1**3 / (12.0 * mu), H2**3 / (3.0 * mu)
    Q = P0 / (xj / mA + (1 - xj) / mB)
    pl = prob.get_nodal_field(res.x, "lub_pressure", 0)
    pf = prob.get_nodal_field(res.x, "film_pressure", 0)
    c = mesh.coords
    el = max(abs(pl[n] - (P0 - Q * c[n, 0] / mA)) for n in ln)
    ef = max(abs(pf[n] - Q * (1 - c[n, 0]) / mB) for n in fn)
    j = junction[0]
    gate(el < 1e-8 * P0 and ef < 1e-8 * P0 and abs(pl[j] - pf[j]) < 1e-10,
         f"junction {el:.2e} {ef:.2e}")
    return _out(res.iters, [pl[j], Q], res.x)


def velo_normal_lub(P):
    """tests/test_lub_film_junction.py::test_velo_normal_lub_end_flux."""
    P0, H, mu, L = 1.0, 0.3, 1.0, 1.0
    mesh = P.mesh.rectangle_mesh(6, 3, elem="QUAD9", xlim=(0, L), ylim=(0, 0.3))
    bi = P.phys.attach_shell_block(mesh, "bottom", "lub")
    eqs = [[P.phys.Momentum(dim=2, interp="Q2", transient=False, convection=False),
            P.phys.Continuity(interp="Q1")],
           [P.lub.ReynoldsFilm(interp="Q2"), P.eqs.PassiveVar("velocity", 2, "Q2")]]
    prob = P.Problem(mesh, eqs, [{"rho": 1.0, "mu": mu}, {"gap": H, "mu_lub": mu}],
                     **P.kw)
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="lub_end")
    ln = np.unique(mesh.blocks[bi].conn)
    mesh.nodesets["lub_in"] = ln[np.isclose(mesh.coords[ln, 0], 0.0)].astype(np.int32)
    mesh.nodesets["lub_out"] = ln[np.isclose(mesh.coords[ln, 0], L)].astype(np.int32)
    mesh.nodesets["pin"] = np.array([int(ln[1])], dtype=np.int32)
    prob.add_dirichlet("lub_in", "lub_pressure", 0, P0)
    prob.add_dirichlet("lub_out", "lub_pressure", 0, 0.0)
    rn = mesh.nodesets["right"]
    mesh.nodesets["right_nc"] = rn[mesh.coords[rn, 1] > 1e-9].astype(np.int32)
    for ns in ("top", "left", "right_nc"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_face_kernel(ends[1], P.lub.LubEndKinematic(
        dim=2, var="velocity", lubflux=0.0, penalty=1e8))
    prob.finalize()
    res = _solve(P, prob, max_iter=6, tol=1e-10)
    u = prob.get_nodal_field(res.x, "velocity", 0)
    end = ln[np.isclose(mesh.coords[ln, 0], L)]
    want = H**3 * P0 / (12.0 * mu * L) / H
    gate(np.all(np.abs(u[end] / want - 1) <= 1e-6), "end velocity")
    return _out(res.iters, u[end].mean(), res.x)


def _dR(P, make):
    """R of ``make(True)`` minus R of ``make(False)`` at the state ``make``
    returns (the kernels' own rows)."""
    (p1, x), (p0, _) = make(True), make(False)
    R1 = _np(p1.residual(P.arr(x), p1.base_params()))
    R0 = _np(p0.residual(P.arr(x), p0.base_params()))
    return p1, R1 - R0


def tfmp_free_flux(P):
    """tests/test_lub_film_junction.py::test_tfmp_free_flux_values."""
    h, mu_l, mu_g, S0, dPdx = 0.2, 1.5, 0.7, 0.4, 3.0
    mesh = P.mesh.rectangle_mesh(6, 2, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.1))
    bi = P.phys.attach_shell_block(mesh, "bottom", "tfmp")
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="tf_end")

    def make(with_kernels):
        prob = P.Problem(mesh, [[], [P.lub.TFMPMass(interp="Q2", transient=False),
                                     P.lub.TFMPBound(interp="Q2", transient=False)]],
                         [{}, {"gap": h, "mu_l": mu_l, "mu_g": mu_g}], **P.kw)
        if with_kernels:
            prob.add_face_kernel(ends[1], P.lub.TFMPFreeFlux("liquid"))
            prob.add_face_kernel(ends[1], P.lub.TFMPFreeFlux("gas"))
        prob.finalize()
        x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "tfmp_pres", 0,
                                  dPdx * mesh.coords[:, 0])
        return prob, prob.set_nodal_field(x0, "tfmp_sat", 0, S0)

    prob, dR = _dR(P, make)
    q_l = -(h**3 / (12 * mu_l)) * S0**3 * dPdx
    q_g = -(h**3 / (12 * mu_g)) * (1 - S0) ** 3 * dPdx
    sl, sg = dR[var_dofs(prob, "tfmp_sat")].sum(), dR[var_dofs(prob, "tfmp_pres")].sum()
    gate(abs(sl / q_l - 1) <= 1e-12 and abs(sg / q_g - 1) <= 1e-12, "TFMP fluxes")
    return _out(0, [sl, sg], dR)


def flow_developed(P):
    """tests/test_lub_film_junction.py::test_shell_flow_developed_penalty."""
    dPdx = 2.5
    mesh = P.mesh.rectangle_mesh(6, 2, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.1))
    bi = P.phys.attach_shell_block(mesh, "bottom", "film")
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="fd_end")

    def make(with_kernels):
        prob = P.Problem(mesh, [[], [P.film.FilmPressure(interp="Q2", transient=False),
                                     P.film.FilmHeight(interp="Q2")]],
                         [{}, {"mu": 1.0, "sigma": 1.0}], **P.kw)
        if with_kernels:
            prob.add_face_kernel(ends[1], P.lub.ShellFlowDeveloped(penalty=1e4))
        prob.finalize()
        x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "film_pressure", 0,
                                  dPdx * mesh.coords[:, 0])
        return prob, prob.set_nodal_field(x0, "film_height", 0, 0.5)

    prob, dR = _dR(P, make)
    s = dR[var_dofs(prob, "film_pressure")].sum()
    gate(abs(s / (1e4 * dPdx) - 1) <= 1e-12, "flow developed")
    return _out(0, s, dR)


def tangent_traction_lubp(P):
    """tests/test_lub_film_junction.py::test_shell_tangent_traction_and_lubp_load."""
    T, pl, scale = (2.0, 0.5), 1.3, 0.8
    mesh = P.mesh.rectangle_mesh(6, 3, elem="QUAD9")
    mesh.nodesets["all"] = np.arange(mesh.n_nodes, dtype=np.int32)

    def make(with_kernels):
        prob = P.Problem(mesh, [P.phys.LinearElasticMesh(dim=2),
                                P.eqs.PassiveVar("lub_pressure", 1, "Q2")],
                         {"mesh_shear_modulus": 1.0, "mesh_lambda": 1.0}, **P.kw)
        prob.add_dirichlet("all", "lub_pressure", 0, pl)
        if with_kernels:
            prob.add_face_kernel("bottom", P.sheet.ShellTangentTraction(
                dim=2, traction=T))
            prob.add_face_kernel("bottom", P.sheet.LubPressureLoad(dim=2,
                                                                   scale=scale))
        prob.finalize()
        return prob, prob.set_nodal_field(np.zeros(prob.dofmap.n_dof),
                                          "lub_pressure", 0, pl)

    prob, dR = _dR(P, make)
    dm = prob.dofmap
    fx, fy = (dR[d[d >= 0]].sum() for d in (
        dm.dof_of_node_svar[:, dm.svar(P.MESH_VAR, c)] for c in range(2)))
    gate(abs(fx / -2.0 - 1) <= 1e-12 and abs(fy / (-scale * pl) - 1) <= 1e-12,
         "tangent traction / lub load")
    return _out(0, [fx, fy], dR)


def sheet_weak_terms(P):
    """tests/test_lub_film_junction.py::test_sheet_weak_terms_and_shear_to_shell."""
    fac, dyds = 0.7, 1.4
    mesh = P.mesh.rectangle_mesh(6, 3, elem="QUAD9")

    def make(with_kernels):
        prob = P.Problem(mesh, [P.phys.LinearElasticMesh(dim=2)],
                         {"mesh_shear_modulus": 1.0, "mesh_lambda": 1.0}, **P.kw)
        if with_kernels:
            prob.add_face_kernel("bottom", P.sheet.SdetWeak(dim=2, factor=fac))
            prob.add_face_kernel("bottom", P.sheet.ShMesh2Weak(dim=2, dy_ds=dyds))
        prob.finalize()
        return prob, np.zeros(prob.dofmap.n_dof)

    prob, dR = _dR(P, make)
    dm = prob.dofmap
    sx, sy = (dR[d[d >= 0]].sum() for d in (
        dm.dof_of_node_svar[:, dm.svar(P.MESH_VAR, c)] for c in range(2)))
    sdet = (1.0 / 6.0) / 2.0
    gate(abs(sx / (0.5 * fac * sdet**2) - 1) <= 1e-12
         and abs(sy / -dyds - 1) <= 1e-12, "sdet / mesh2 terms")

    U, mu = 0.8, 1.3
    mesh2 = P.mesh.rectangle_mesh(6, 3, elem="QUAD9")
    P.phys.attach_shell_block(mesh2, "bottom", "web")
    mesh2.nodesets["all2"] = np.arange(mesh2.n_nodes, dtype=np.int32)

    def make2(with_kernels):
        eqs = [[P.eqs.PassiveVar("velocity", 2, "Q2"),
                P.eqs.PassiveVar("sh_tens", 1, "Q2", reg=1e-10)],
               [P.eqs.PassiveVar("sh_tens", 1, "Q2", reg=1e-10)]]
        prob = P.Problem(mesh2, eqs, [{"mu": mu}, {}], **P.kw)
        prob.add_dirichlet("all2", "velocity", 0, lambda c: U * c[:, 1])
        prob.add_dirichlet("all2", "velocity", 1, 0.0)
        if with_kernels:
            prob.add_face_kernel("bottom", P.shell.ShellGradBC(
                "sh_tens", P.sheet.bulk_shear_to_tension(1.0)))
        prob.finalize()
        return prob, prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity",
                                          0, U * mesh2.coords[:, 1])

    p2, dR2 = _dR(P, make2)
    tot = dR2[var_dofs(p2, "sh_tens")].sum()
    gate(abs(abs(tot) / (mu * U) - 1) <= 1e-10, "shear to shell")
    return _out(0, [sx, sy, tot], np.concatenate([dR, dR2]))


def surf_div_v(P):
    """tests/test_shell_rheo.py::test_shell_surf_div_v_exact_linear."""
    a = 0.7
    mesh = P.mesh.rectangle_mesh(6, 3, elem="QUAD9")
    bi = P.phys.attach_shell_block(mesh, "bottom", "rheo")
    mesh.nodesets["all"] = np.arange(mesh.n_nodes, dtype=np.int32)
    eqs = [[P.eqs.PassiveVar("velocity", 2, "Q2")],
           [P.shell.ShellSurfDivV(interp="Q2"), P.eqs.PassiveVar("velocity", 2, "Q2")]]
    prob = P.Problem(mesh, eqs, [{}, {}], **P.kw)
    prob.add_dirichlet("all", "velocity", 0, lambda c: a * c[:, 0])
    prob.add_dirichlet("all", "velocity", 1, lambda c: -a * c[:, 1])
    prob.finalize()
    res = _solve(P, prob, max_iter=4, tol=1e-10)
    g1 = prob.get_nodal_field(res.x, "surf_div_v", 0)
    sn = np.unique(mesh.blocks[bi].conn)
    gate(close(g1[sn], a, atol=1e-9), "surface divergence")
    return _out(res.iters, g1[sn].mean(), res.x)


def gamma1_symm_end(P):
    """tests/test_shell_rheo.py::test_gamma1_deriv_symm_end."""
    a = 1.0
    mesh = P.mesh.rectangle_mesh(10, 3, elem="QUAD9")
    bi = P.phys.attach_shell_block(mesh, "bottom", "rheo")
    mesh.nodesets["all"] = np.arange(mesh.n_nodes, dtype=np.int32)
    eqs = [[P.eqs.PassiveVar("velocity", 2, "Q2")],
           [P.shell.ShellSurfDivV(interp="Q2"), P.eqs.PassiveVar("velocity", 2, "Q2")]]
    prob = P.Problem(mesh, eqs, [{}, {"surf_div_diff": 0.05}], **P.kw)
    prob.add_dirichlet("all", "velocity", 0, lambda c: a * c[:, 0] ** 2)
    prob.add_dirichlet("all", "velocity", 1, 0.0)
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="rheo_end")
    prob.add_face_kernel(ends[1], P.shell.Gamma1DerivBC(g=0.0, penalty=1e6))
    prob.finalize()
    res = _solve(P, prob, max_iter=4, tol=1e-9)
    g1 = prob.get_nodal_field(res.x, "surf_div_v", 0)
    sn = np.unique(mesh.blocks[bi].conn)
    order = np.argsort(mesh.coords[sn, 0])
    vals, xs = g1[sn][order], mesh.coords[sn, 0][order]
    k = len(vals) // 2
    end = (vals[-1] - vals[-2]) / (xs[-1] - xs[-2])
    mid = (vals[k + 1] - vals[k - 1]) / (xs[k + 1] - xs[k - 1])
    gate(abs(end) < 0.25 * abs(mid) and abs(mid - 2 * a) < 0.6 * a,
         f"symmetry end {end} {mid}")
    return _out(res.iters, [end, mid], res.x)


SMALL = {
    "tensioned_string": tensioned_string,
    "reynolds_on_shell": reynolds_on_shell,
    "shell_bulk_conduction": shell_bulk_conduction,
    "shell_elastica": shell_elastica,
    "tfmp_squeeze": tfmp_squeeze,
    "hermite_beam": hermite_beam,
    "laplace_beltrami_cylinder": laplace_beltrami_cylinder,
    "hex_face_shell": hex_face_shell,
    "end_flux_reynolds": end_flux_reynolds,
    "end_flux_arc": end_flux_arc,
    "end_advective_outflow": end_advective_outflow,
    "capillary_leveling": capillary_leveling,
    "film_evaporation": film_evaporation,
    "shell_energy_fin": shell_energy_fin,
    "shell_species_exact": shell_species_exact,
    "shell_species_source": shell_species_source,
    "closed_cell_imbibition": closed_cell_imbibition,
    "open_cell_diffusion": open_cell_diffusion,
    "two_layer_stack": two_layer_stack,
    "closed_cell_numjac": closed_cell_numjac,
    "gasn_dissolution": gasn_dissolution,
    "power_law_squeeze_1": lambda P: power_law_squeeze(P, 1.0),
    "power_law_squeeze_0.5": lambda P: power_law_squeeze(P, 0.5),
    "lub_curvature_circle": lub_curvature_circle,
    "surface_charge_decay": surface_charge_decay,
    "tension_sheet_parabola": tension_sheet_parabola,
    "tension_sheet_stiffer": tension_sheet_stiffer,
    "sheet_end_slope": sheet_end_slope,
    "lub_film_junction": lub_film_junction,
    "velo_normal_lub": velo_normal_lub,
    "tfmp_free_flux": tfmp_free_flux,
    "flow_developed": flow_developed,
    "tangent_traction_lubp": tangent_traction_lubp,
    "sheet_weak_terms": sheet_weak_terms,
    "surf_div_v": surf_div_v,
    "gamma1_symm_end": gamma1_symm_end,
}
