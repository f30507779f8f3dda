"""The derived-field, particle-tracing and split-solver decks (the
projection and segregated drivers), written once for both packages.

Every function here takes a package namespace ``P`` (see ``namespace``):
goma_tpu's modules and ``jax.numpy`` from ``scripts/split_reference.py``
and the port's tests, the port's modules and ``torch`` from
``chip_smoke.py``. Callables are written in the operations ``jax.numpy``
and ``torch`` share, so one deck is one definition. This module imports
neither package: ``namespace`` imports the one it is given by name.

- ``projection_cavity(P, n, opts)``: the Re 100 lid-driven cavity
  (``__graft_entry__._cavity_problem``'s walls, lid and density 1,
  viscosity 0.01) split by ``ProjectionSolver``: u* (Q2) with the lid
  u = 1, v = 0 on ``lid`` and no slip on the other walls, the Q1 pressure
  increment pinned at node 0. ``run_projection`` takes ``PROJ_STEPS``
  steps of ``PROJ_DT`` from rest and records each step's Newton counts of
  both sub-solves; ``projection_outputs`` reads the end state: the kinetic
  energy, max |DIV_VELOCITY|, the primary vortex's node and strength
  (STREAM), VORTICITY there, the share of velocity nodes faster than
  ``MOVING`` of the lid speed, and u and p at the gate's nodes.
- ``segregated_cavity(P, n, opts)``: BASELINE #2's buoyant cavity
  (bench.py ``bench_buoyant``: Ra 1e4, Pr 0.71, hot left and cold right
  walls, species 1 on the left and 0 on the right) split into three
  matrices, as Goma's multi-matrix runs split it: the flow (``Momentum`` +
  ``Continuity``, T an external field, ``boussinesq`` the deck's body
  force reproducing ``BoussinesqBodyForce([0, Ra Pr], beta=-1, T0=0.5)``
  from ``fv.ext``), the temperature (``Energy``, advected by the external
  u, v through its heat source) and the species (``Species``, advected the
  same way through its source). ``SegregatedSolver`` with tol
  ``SEG_TOL``, up to ``SEG_MAX_OUTER`` outer iterations and relaxation
  ``SEG_RELAX``. ``coupled_cavity`` is the same deck as one matrix (bench's
  deck); ``segregated_outputs`` reads the converged state: the derived
  catalog entries ``SEG_DERIVED`` at the sampled nodes and their maxima,
  and ``SEG_TRACERS`` massless tracers (RK4) traced through the velocity.
- ``SMALL``: goma_tpu's tests of the slice at their own sizes
  (tests/test_derived.py, test_tools.py's two particle tests,
  test_flux_sens_particles.py's two inertial particles, test_projection.py,
  test_segregated_subcycle.py, test_more_physics.py's segregated natural
  convection), each checking the test's own gate and returning its Newton
  count, its readings and an output vector.
"""

from __future__ import annotations

import importlib
import types

import numpy as np

from scripts.shell_decks import _np, _out, close, gate, samples

# ----------------------------------------------------- projection cavity
PROJ_N = 96
PROJ_RE = 100.0
PROJ_DT, PROJ_STEPS = 0.05, 20
PROJ_MAX_ITER = 6
MOVING = 0.01          # a moving node: speed above 1% of the lid's
N_GATE = 24            # the gate's nodes (u, v and p at each)

# ----------------------------------------------- segregated buoyant cavity
SEG_N = 48
SEG_RA, SEG_PR = 1e4, 0.71
# goma_tpu's Picard loop at 48 x 48 (host direct): relaxation 1.0 has not
# converged after 60 outer iterations (the update shrinks 0.94 a sweep),
# 0.9 converges in 28, 0.8 in 16
SEG_TOL, SEG_MAX_OUTER, SEG_RELAX = 1e-8, 60, 0.8
SEG_MAX_ITER = 10
SEG_DERIVED = ("VORTICITY", "SHEAR_RATE", "DIV_VELOCITY", "PRESSURE_NODAL",
               "STRESS_TENSOR", "SPEED", "KINETIC_ENERGY", "ENERGY_FLUX",
               "DENSITY", "VISCOSITY", "STREAM", "NS_RESIDUALS")
# 16 tracers on a 4 x 4 grid of the cavity's interior, RK4 steps of
# SEG_TRACE_DT to SEG_TRACE_T
SEG_TRACERS = 16
SEG_TRACE_DT, SEG_TRACE_T = 0.0025, 0.05


def namespace(pkg: str, xp, arr, device=None):
    """The namespace the decks read for package ``pkg`` ("goma_tpu" or
    "goma_tpu_torch"): its mesh generators, Problem, ``fem.equations``,
    the physics package, ``physics.materials``, ``post``, ``post.derived``, ``post.particles``,
    the solvers (Newton, projection, segregated, transient), the array
    module ``xp``, ``arr`` (a numpy array onto the package's device) and
    the Problem's device keyword."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    solvers, transient = mod("solvers"), mod("solvers.transient")
    return types.SimpleNamespace(
        pkg=pkg, mesh=mod("mesh"), Problem=mod("fem").Problem,
        eqs=mod("fem.equations"), phys=mod("physics"),
        materials=mod("physics.materials"),
        post=mod("post"), derived=mod("post.derived"),
        particles=mod("post.particles"), seg=mod("solvers.segregated"),
        NewtonOptions=solvers.NewtonOptions,
        NewtonSolver=solvers.NewtonSolver,
        ProjectionSolver=solvers.ProjectionSolver,
        TimeOptions=transient.TimeOptions,
        TransientSolver=transient.TransientSolver, xp=xp, arr=arr,
        kw={} if device is None else {"device": device})


def count_newton(solver, into: list):
    """Wrap ``solver.solve`` to append each call's Newton count to
    ``into``; returns a function that undoes the wrapper."""
    solve = solver.solve

    def rec(x0, params):
        r = solve(x0, params)
        into.append(int(r.iters))
        return r

    solver.solve = rec
    return lambda: delattr(solver, "solve")


# ----------------------------------------------------- projection cavity
def projection_cavity(P, n, opts=None):
    """The projection-split lid-driven cavity on an ``n`` x ``n`` QUAD9
    mesh (module docstring); ``opts`` the NewtonOptions of both
    sub-solves (None: goma_tpu's host ``direct`` default)."""
    mesh = P.mesh.rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    mesh.nodesets["lid"] = top[(xt > xt.min()) & (xt < xt.max())]

    def bc_u(prob):
        for ns in ("left", "right", "bottom"):
            prob.add_dirichlet(ns, "ustar", 0, 0.0)
            prob.add_dirichlet(ns, "ustar", 1, 0.0)
        prob.add_dirichlet("lid", "ustar", 0, 1.0)
        prob.add_dirichlet("lid", "ustar", 1, 0.0)

    def bc_p(prob):
        prob.add_dirichlet("pin", "pphi", 0, 0.0)

    return P.ProjectionSolver(mesh, {"rho": 1.0, "mu": 1.0 / PROJ_RE}, bc_u,
                              bc_p, newton_options=opts, **P.kw)


def run_projection(P, ps, steps=PROJ_STEPS, dt=PROJ_DT):
    """``steps`` projection steps of ``dt`` from rest. Returns (result,
    {"ustar": Newton counts a step, "pphi": ...})."""
    counts = {"ustar": [], "pphi": []}
    undo = [count_newton(ps.solver_u, counts["ustar"]),
            count_newton(ps.solver_p, counts["pphi"])]
    try:
        n = ps.mesh.n_nodes
        res = ps.run(np.zeros((n, 2)), np.zeros(n), dt, steps)
    finally:
        for u in undo:
            u()
    return res, counts


def gate_nodes(u):
    """``N_GATE`` nodes evenly spaced over the nodes of ``u`` (n_nodes, 2)
    that move faster than ``MOVING``."""
    moving = np.flatnonzero(np.linalg.norm(u, axis=1) > MOVING)
    return moving[np.linspace(0, moving.size - 1, N_GATE).astype(np.int64)]


def flow_post_problem(P, mesh, mat):
    """A Problem carrying velocity (Q2) and pressure (Q1) on ``mesh``, no
    conditions: the carrier of the catalog's velocity entries."""
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, transient=False),
                            P.phys.Continuity()], mat, **P.kw)
    prob.finalize()
    return prob


def projection_outputs(P, ps, res, nodes=None, post=None):
    """The end state's readings (module docstring). ``nodes``: the gate's
    nodes (default ``gate_nodes`` of this state); ``post``: a
    ``flow_post_problem`` of the same mesh (default: built here)."""
    u, p = _np(res.u), _np(res.p)
    post = post or flow_post_problem(P, ps.mesh, ps.mat)
    x = np.zeros(post.dofmap.n_dof)
    x = post.set_nodal_field(x, "velocity", 0, u[:, 0])
    x = post.set_nodal_field(x, "velocity", 1, u[:, 1])
    x = post.set_nodal_field(x, "pressure", 0, p)
    der = P.derived
    div = der.derived_nodal_field(post, x, "DIV_VELOCITY")
    psi = der.derived_nodal_field(post, x, "STREAM")
    vort = der.derived_nodal_field(post, x, "VORTICITY")
    ke = der.project_to_nodes(post, x, der.CATALOG["KINETIC_ENERGY"])
    ke_int = float(_np(P.post.volume_integral(
        post, der.CATALOG["KINETIC_ENERGY"])(x, post.base_params())))
    c = int(np.argmax(np.abs(psi)))
    speed = np.linalg.norm(u, axis=1)
    nodes = gate_nodes(u) if nodes is None else np.asarray(nodes)
    return {"t": float(res.t), "kinetic_energy": ke_int,
            "ke_nodal_max": float(np.abs(ke).max()),
            "div_max": float(np.abs(div).max()),
            "vortex_node": c, "vortex_x": float(ps.mesh.coords[c, 0]),
            "vortex_y": float(ps.mesh.coords[c, 1]),
            "psi_vortex": float(psi[c]), "vorticity_vortex": float(vort[c]),
            "moving_share": float(np.mean(speed > MOVING)),
            "x_max": float(max(np.abs(u).max(), np.abs(p).max())),
            "gate_nodes": [int(i) for i in nodes],
            "gate": np.concatenate([u[nodes, 0], u[nodes, 1],
                                    p[nodes]]).tolist()}


# ----------------------------------------------- segregated buoyant cavity
def _walls(mesh):
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)


def _flow_bcs(prob):
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)


def _hot_cold(prob, var):
    prob.add_dirichlet("left", var, 0, 1.0)
    prob.add_dirichlet("right", var, 0, 0.0)


def boussinesq(P):
    """The flow's body force from the external temperature:
    ``BoussinesqBodyForce([0, Ra Pr], beta=-1, T0=0.5)`` of ``fv.ext``."""
    xp = P.xp
    g = SEG_RA * SEG_PR

    def force(fv, mat, params):
        T = fv.ext["T"]
        return xp.stack([xp.zeros_like(T), g * (1.0 - (-1.0) * (T - 0.5))], 1)

    return force


def advection_source(P, var):
    """-(u . grad c) of the external velocity (ux, uy): moved into an
    Energy heat source (``var`` "temperature", (nq,)) or a Species source
    ("species", (nq, 1)), it gives the coupled deck's advection term."""
    xp = P.xp

    def source(fv, mat, params):
        u = xp.stack([fv.ext["ux"], fv.ext["uy"]], 1)
        g = fv.grad[var]  # (nq, 1, dim)
        s = -xp.einsum("qk,qwk->qw", u, g)
        return s[:, 0] if var == "temperature" else s

    return source


def segregated_cavity(P, n, opts=None, relax=SEG_RELAX):
    """The three-matrix buoyant cavity (module docstring). Returns
    (SegregatedSolver, {name: Problem}, x0 {name: zeros})."""
    mesh = P.mesh.rectangle_mesh(n, n, elem="QUAD9")
    _walls(mesh)
    ph = P.phys
    flow = P.Problem(mesh, [ph.Momentum(dim=2, transient=False),
                            ph.Continuity()],
                     {"rho": 1.0, "mu": SEG_PR, "body_force": boussinesq(P)},
                     external_fields=("T",), **P.kw)
    _flow_bcs(flow)
    flow.finalize()
    temp = P.Problem(mesh, [ph.Energy(interp="Q2", transient=False)],
                     {"rho": 1.0, "Cp": 1.0, "k": 1.0,
                      "heat_source": advection_source(P, "temperature")},
                     external_fields=("ux", "uy"), **P.kw)
    _hot_cold(temp, "temperature")
    temp.finalize()
    spec = P.Problem(mesh, [ph.Species(n_species=1, interp="Q2",
                                       transient=False)],
                     {"diffusivity": 1.0,
                      "species_source": advection_source(P, "species")},
                     external_fields=("ux", "uy"), **P.kw)
    _hot_cold(spec, "species")
    spec.finalize()

    def velocity(x):
        return {"ux": np.nan_to_num(flow.get_nodal_field(x, "velocity", 0)),
                "uy": np.nan_to_num(flow.get_nodal_field(x, "velocity", 1))}

    subs = [P.seg.SubProblem("flow", flow, velocity, newton_options=opts),
            P.seg.SubProblem("temperature", temp, lambda x: {
                "T": np.nan_to_num(temp.get_nodal_field(x, "temperature"))},
                newton_options=opts),
            P.seg.SubProblem("species", spec, lambda x: {},
                             newton_options=opts)]
    probs = {"flow": flow, "temperature": temp, "species": spec}
    solver = P.seg.SegregatedSolver(subs, max_outer=SEG_MAX_OUTER,
                                    tol=SEG_TOL, relax=relax)
    return solver, probs, {k: np.zeros(p.dofmap.n_dof)
                           for k, p in probs.items()}


def run_segregated(solver):
    """``solver.solve`` from zero, each sub-solve's Newton count recorded.
    Returns (result, {name: Newton counts in solve order})."""
    counts = {s.name: [] for s in solver.subs}
    undo = [count_newton(solver._solvers[s.name], counts[s.name])
            for s in solver.subs]
    try:
        res = solver.solve({s.name: np.zeros(s.problem.dofmap.n_dof)
                            for s in solver.subs})
    finally:
        for u in undo:
            u()
    return res, counts


def coupled_cavity(P, n):
    """bench.py's ``bench_buoyant`` deck as one matrix, float64 Jacobian."""
    mesh = P.mesh.rectangle_mesh(n, n, elem="QUAD9")
    _walls(mesh)
    ph = P.phys
    prob = P.Problem(
        mesh, [ph.Momentum(dim=2, transient=False), ph.Continuity(),
               ph.Energy(interp="Q2", transient=False),
               ph.Species(n_species=1, interp="Q2", transient=False)],
        {"rho": 1.0, "mu": SEG_PR, "k": 1.0, "Cp": 1.0, "diffusivity": 1.0,
         "body_force": P.materials.BoussinesqBodyForce(
             [0.0, SEG_RA * SEG_PR], beta=-1.0, T0=0.5)}, **P.kw)
    _flow_bcs(prob)
    _hot_cold(prob, "temperature")
    _hot_cold(prob, "species")
    prob.finalize()
    return prob


def coupled_fields(prob, x):
    """(T, u_x, u_y) per node of a coupled or segregated state: ``prob`` a
    Problem carrying them, or ``(probs, xs)`` of the segregated split."""
    if isinstance(prob, dict):
        fl, tp = prob["flow"], prob["temperature"]
        return (tp.get_nodal_field(x["temperature"], "temperature"),
                fl.get_nodal_field(x["flow"], "velocity", 0),
                fl.get_nodal_field(x["flow"], "velocity", 1))
    return (prob.get_nodal_field(x, "temperature"),
            prob.get_nodal_field(x, "velocity", 0),
            prob.get_nodal_field(x, "velocity", 1))


def tracer_starts():
    """The ``SEG_TRACERS`` starts: a 4 x 4 grid at 0.2, 0.4, 0.6, 0.8."""
    g = np.array([0.2, 0.4, 0.6, 0.8])
    return np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)


def derived_entry(P, probs, xs, name):
    """Catalog entry ``name`` on the segregated state: ENERGY_FLUX on the
    temperature matrix, the rest on the flow matrix. NS_RESIDUALS is read
    with the external temperature at 0 (the buoyancy load the converged
    flow carries: at the converged T the map is Newton's tolerance)."""
    if name == "ENERGY_FLUX":
        tp = probs["temperature"]
        fl = probs["flow"]
        params = tp.base_params(
            ext_ux=np.nan_to_num(fl.get_nodal_field(xs["flow"], "velocity", 0)),
            ext_uy=np.nan_to_num(fl.get_nodal_field(xs["flow"], "velocity", 1)))
        return P.derived.derived_nodal_field(tp, xs["temperature"], name,
                                             params)
    fl = probs["flow"]
    T = 0.0 if name == "NS_RESIDUALS" else np.nan_to_num(
        probs["temperature"].get_nodal_field(xs["temperature"], "temperature"))
    params = fl.base_params(ext_T=np.broadcast_to(
        np.asarray(T, dtype=np.float64), (fl.mesh.n_nodes,)).copy())
    return P.derived.derived_nodal_field(fl, xs["flow"], name, params)


def segregated_derived(P, probs, xs):
    """{name: nodal field (host numpy)} of every entry of ``SEG_DERIVED``."""
    return {name: np.asarray(derived_entry(P, probs, xs, name))
            for name in SEG_DERIVED}


def trace(P, probs, xs):
    """The tracers' final positions and alive flags through the
    segregated state's velocity."""
    tr = P.particles.trace_particles(probs["flow"], xs["flow"],
                                     tracer_starts(), SEG_TRACE_T,
                                     SEG_TRACE_DT)
    return tr


def segregated_outputs(P, probs, res, derived=True):
    """The converged state's readings: outer iterations, x at the 24
    sampled dofs of each matrix with its max |x|, T and u at the sampled
    nodes, each derived entry at the sampled nodes with its max, the
    tracers' end positions."""
    xs = res.x
    out = {"outer": int(res.outer_iters), "converged": bool(res.converged)}
    for k, x in xs.items():
        x = _np(x)
        out[k] = {"x_max": float(np.abs(x).max()),
                  "x_samples": x[samples(x.size)].tolist()}
    nodes = samples(probs["flow"].mesh.n_nodes)
    T, ux, uy = coupled_fields(probs, xs)
    out["fields"] = {"T": T[nodes].tolist(), "ux": ux[nodes].tolist(),
                     "uy": uy[nodes].tolist(),
                     "T_max": float(np.nanmax(np.abs(T))),
                     "u_max": float(np.nanmax(np.abs(np.stack([ux, uy]))))}
    if derived:
        out["derived"] = {k: derived_reading(v, nodes) for k, v in
                          segregated_derived(P, probs, xs).items()}
        tr = trace(P, probs, xs)
        out["tracers"] = {"end": _np(tr.positions[-1]).tolist(),
                          "alive": [bool(a) for a in tr.alive],
                          "steps": int(tr.positions.shape[0] - 1)}
    return out


def derived_reading(field, nodes):
    """A derived field at ``nodes`` (flattened) with its max |value|."""
    f = np.asarray(field)
    return {"max": float(np.abs(f).max()), "at": f[nodes].ravel().tolist()}


# ------------------------------------------------------------ small decks
def _flow_problem(P):
    """tests/test_derived.py's ``_flow_problem``."""
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9")
    prob = P.Problem(
        mesh,
        [P.phys.Momentum(2, transient=False), P.phys.Continuity(),
         P.phys.Energy(interp="Q2", transient=False, convection=False)],
        {"rho": 2.0, "mu": 0.5, "k": 3.0}, **P.kw)
    prob.finalize()
    return mesh, prob


def derived_manufactured(P):
    """tests/test_derived.py::test_derived_fields_on_manufactured_state."""
    mesh, prob = _flow_problem(P)
    x = np.zeros(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "velocity", 0, lambda X: X[:, 1] ** 2)
    x = prob.set_nodal_field(x, "velocity", 1, lambda X: X[:, 0])
    x = prob.set_nodal_field(x, "pressure", 0, lambda X: X[:, 0] + 2 * X[:, 1])
    x = prob.set_nodal_field(x, "temperature", 0, lambda X: X[:, 0] ** 2)
    X = mesh.coords
    d = lambda name: P.derived.derived_nodal_field(prob, x, name)  # noqa: E731
    f = {k: d(k) for k in ("VORTICITY", "DIV_VELOCITY", "SHEAR_RATE",
                           "PRESSURE_NODAL", "STRESS_TENSOR", "ENERGY_FLUX",
                           "KINETIC_ENERGY", "SPEED")}
    gate(close(f["VORTICITY"], 1.0 - 2 * X[:, 1], 0, 1e-8), "vorticity")
    gate(close(f["DIV_VELOCITY"], 0.0, 0, 1e-8), "divergence")
    gate(close(f["SHEAR_RATE"], np.abs(2 * X[:, 1] + 1.0), 0, 1e-6),
         "shear rate")
    gate(close(f["PRESSURE_NODAL"], X[:, 0] + 2 * X[:, 1], 0, 1e-8),
         "pressure")
    tau = f["STRESS_TENSOR"]
    gate(close(tau[:, 0], 0.0, 0, 1e-8) and close(tau[:, 2], 0.0, 0, 1e-8)
         and close(tau[:, 1], 0.5 * (2 * X[:, 1] + 1.0), 0, 1e-8), "stress")
    qf = f["ENERGY_FLUX"]
    gate(close(qf[:, 0], -3.0 * 2 * X[:, 0], 0, 1e-7)
         and close(qf[:, 1], 0.0, 0, 1e-8), "energy flux")
    gate(close(f["KINETIC_ENERGY"], 0.5 * 2.0 * (X[:, 1] ** 4 + X[:, 0] ** 2),
               0, 6e-2), "kinetic energy")
    gate(close(f["SPEED"], np.sqrt(X[:, 1] ** 4 + X[:, 0] ** 2), 0, 4e-2),
         "speed")
    xo = np.concatenate([np.ravel(v) for v in f.values()])
    return _out(0, [f["KINETIC_ENERGY"].max(), f["SPEED"].max(),
                    f["SHEAR_RATE"].max()], xo)


def derived_custom(P):
    """tests/test_derived.py::test_custom_projection."""
    mesh, prob = _flow_problem(P)
    x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "temperature", 0,
                             lambda X: 3.0 * X[:, 1])
    out = P.derived.project_to_nodes(
        prob, x, lambda fv, mat, params: fv.grad["temperature"][:, 0, 1])
    gate(close(out, 3.0, 0, 1e-8), "custom projection")
    return _out(0, [out.mean()], out)


def derived_ls_normal(P):
    """tests/test_derived.py::test_ls_normal_projection."""
    class Carrier(P.eqs.Equation):
        def __init__(self):
            super().__init__("fill", 1, "Q2")

        def residual(self, fv, mat, params):
            z = 0.0 * fv.val["fill"][:, :, None]
            return z * fv.phi["fill"][:, None, :]

    mesh = P.mesh.rectangle_mesh(5, 5, elem="QUAD9")
    prob = P.Problem(mesh, [Carrier()], {}, **P.kw)
    prob.finalize()
    f = (mesh.coords[:, 0] + 2 * mesh.coords[:, 1]) / np.sqrt(5)
    x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, f)
    n = P.derived.derived_nodal_field(prob, x, "LS_NORMAL")
    gate(close(n[:, 0], 1 / np.sqrt(5), 0, 1e-10)
         and close(n[:, 1], 2 / np.sqrt(5), 0, 1e-10), "LS normal")
    return _out(0, [n[:, 0].mean(), n[:, 1].mean()], n.ravel())


def derived_density_residual(P):
    """tests/test_derived.py::test_density_viscosity_and_residual_fields."""
    mesh, prob = _flow_problem(P)
    x = np.zeros(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "velocity", 0, lambda X: X[:, 1] ** 2)
    x = prob.set_nodal_field(x, "temperature", 0, lambda X: X[:, 0] ** 2)
    d = P.derived
    rho = d.derived_nodal_field(prob, x, "DENSITY")
    mu = d.derived_nodal_field(prob, x, "VISCOSITY")
    gate(close(rho, 2.0, 0, 1e-10) and close(mu, 0.5, 0, 1e-10),
         "density and viscosity")
    Rn = d.residual_nodal_field(prob, x, "velocity")
    Rn2 = d.derived_nodal_field(prob, x, "NS_RESIDUALS")
    gate(Rn.shape == (mesh.n_nodes, 2) and close(Rn, Rn2, 1e-7)
         and np.abs(Rn[:, 0]).max() > 0, "NS residual map")
    return _out(0, [np.abs(Rn).max(), np.abs(Rn).sum()],
                np.concatenate([rho, mu, Rn.ravel()]))


def derived_porous(P):
    """tests/test_derived.py::test_porous_saturation_fields."""
    mesh = P.mesh.rectangle_mesh(8, 8, elem="QUAD4")
    model = P.phys.VanGenuchten(alpha=1.5, n=2.0)
    prob = P.Problem(mesh, [P.phys.PorousFlow(model=model, interp="Q1",
                                              transient=False)],
                     {"permeability": 1.0, "mu": 1.0}, **P.kw)
    prob.finalize()
    pfun = lambda X: -(0.5 + X[:, 1])  # noqa: E731
    x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "porous_pressure",
                             0, pfun)
    X = mesh.coords
    inter = (X[:, 1] > 1e-9) & (X[:, 1] < 1 - 1e-9)
    d = P.derived
    s = d.derived_nodal_field(prob, x, "POROUS_SATURATION")
    pc = d.derived_nodal_field(prob, x, "CAPILLARY_PRESSURE")
    kr = d.derived_nodal_field(prob, x, "REL_LIQ_PERM")
    pin = P.arr(pfun(X[inter]))
    gate(close(s[inter], _np(model.saturation(pin)), 0, 6e-3)
         and close(pc[inter], -pfun(X[inter]), 0, 1e-8)
         and close(kr[inter], _np(model.krel(pin)), 0, 6e-3), "porous fields")
    return _out(0, [s.mean(), kr.mean()], np.concatenate([s, pc, kr]))


def derived_strain_diffusion(P):
    """tests/test_derived.py::test_strain_and_diffusion_fields."""
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9")
    prob = P.Problem(
        mesh, [P.phys.LinearElasticMesh(dim=2),
               P.phys.Species(n_species=1, transient=False, convection=False)],
        {"diffusivity": 2.0}, **P.kw)
    prob.finalize()
    x = np.zeros(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "mesh_displacement", 0, lambda X: 0.1 * X[:, 0])
    x = prob.set_nodal_field(x, "mesh_displacement", 1,
                             lambda X: -0.05 * X[:, 1])
    x = prob.set_nodal_field(x, "species", 0, lambda X: 3.0 * X[:, 0])
    d = lambda name: P.derived.derived_nodal_field(prob, x, name)  # noqa: E731
    eps, i1, i2, dv = (d("STRAIN_TENSOR"), d("FIRST_INVAR_STRAIN"),
                       d("SEC_INVAR_STRAIN"), d("DIFFUSION_VECTORS"))
    gate(close(eps[:, 0], 0.1, 0, 1e-8) and close(eps[:, 1], 0.0, 0, 1e-8)
         and close(eps[:, 2], -0.05, 0, 1e-8) and close(i1, 0.05, 0, 1e-8)
         and close(i2, -0.005, 0, 1e-8)
         and close(dv[:, 0], -2.0 * 3.0 / 1.1, 0, 1e-7)
         and close(dv[:, 1], 0.0, 0, 1e-7), "strain and diffusion")
    return _out(0, [dv[:, 0].mean()], np.concatenate(
        [eps.ravel(), i1, i2, dv.ravel()]))


def _rigid_rotation(P):
    mesh = P.mesh.rectangle_mesh(10, 10, elem="QUAD9", xlim=(-1, 1),
                                 ylim=(-1, 1))
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, transient=False),
                            P.phys.Continuity()], {"rho": 1.0, "mu": 1.0},
                     **P.kw)
    prob.finalize()
    x = np.zeros(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "velocity", 0, lambda c: -c[:, 1])
    x = prob.set_nodal_field(x, "velocity", 1, lambda c: c[:, 0])
    return prob, x


def particle_rigid_rotation(P):
    """tests/test_tools.py::test_particle_tracing_rigid_rotation."""
    prob, x = _rigid_rotation(P)
    pa = P.particles
    pts = np.array([[0.3, 0.2], [-0.5, 0.1], [0.05, -0.6]])
    v = pa.FieldSampler(prob).sample(x, "velocity", pts)
    gate(close(v, np.stack([-pts[:, 1], pts[:, 0]], axis=1), 0, 1e-10),
         "sampled rotation")
    tr = pa.trace_particles(prob, x, np.array([[0.4, 0.0]]),
                            t_end=np.pi / 2, dt=0.01)
    end, t = tr.positions[-1, 0], tr.times[-1]
    rads = np.linalg.norm(tr.positions[:, 0, :], axis=1)
    gate(bool(tr.alive.all()) and close(end, [0.4 * np.cos(t),
                                              0.4 * np.sin(t)], 0, 2e-5)
         and close(rads, 0.4, 0, 2e-4), "tracer circle")
    return _out(0, list(end), tr.positions.ravel())


def particle_leaves(P):
    """tests/test_tools.py::test_particles_leave_domain."""
    mesh = P.mesh.rectangle_mesh(5, 5, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, transient=False),
                            P.phys.Continuity()], {"mu": 1.0}, **P.kw)
    prob.finalize()
    x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity", 0, 1.0)
    tr = P.particles.trace_particles(prob, x, np.array([[0.9, 0.5]]),
                                     t_end=0.5, dt=0.05)
    gate(not tr.alive.any() and tr.positions[-1, 0, 0] <= 1.0 + 1e-6,
         "the particle leaves")
    return _out(0, list(tr.positions[-1, 0]), tr.positions.ravel())


def _still_box(P, ylim, pin):
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD9", xlim=(0, 10), ylim=ylim)
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False),
                            P.phys.Continuity(interp="Q1")],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    if pin:
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        for ns in ("left", "right", "bottom", "top"):
            prob.add_dirichlet(ns, "velocity", 0, 0.0)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return mesh, prob


def inertial_terminal(P):
    """tests/test_flux_sens_particles.py::
    test_inertial_particle_terminal_velocity."""
    _, prob = _still_box(P, (-1000, 10), pin=True)
    x = np.zeros(prob.dofmap.n_dof)
    a, rho_p, mu, g = 0.1, 8.0, 0.05, -980.0
    m = rho_p * 4.0 / 3.0 * np.pi * a**3
    C = 6.0 * np.pi * mu * a
    v_t, tau = m * g / C, m / C
    tr = P.particles.trace_inertial_particles(
        prob, x, np.array([[5.0, 5.0]]), t_end=8 * tau, dt=tau / 200,
        radius=a, rho_p=rho_p, mu=mu, rho_f=0.0, gravity=(0.0, g))
    t = tr.times[-1]
    y_exact = 5.0 + v_t * (t - tau * (1 - np.exp(-t / tau)))
    gate(bool(tr.alive[0])
         and close(tr.velocities[-1, 0, 1], v_t * (1 - np.exp(-8.0)), 2e-2)
         and close(tr.positions[-1, 0, 1], y_exact, 2e-2), "terminal velocity")
    return _out(0, [tr.velocities[-1, 0, 1], tr.positions[-1, 0, 1]],
                np.concatenate([tr.positions[-1, 0], tr.velocities[-1, 0]]))


def inertial_buoyancy(P):
    """tests/test_flux_sens_particles.py::
    test_inertial_particle_pressure_gradient_buoyancy."""
    mesh, prob = _still_box(P, (0, 10), pin=False)
    rho_f, g = 2.0, -980.0
    x = np.zeros(prob.dofmap.n_dof)
    dm = prob.dofmap
    dp = dm.dof_of_node_svar[:, dm.svar("pressure")]
    ok = dp >= 0
    x[dp[ok]] = rho_f * g * mesh.coords[ok, 1]
    tr = P.particles.trace_inertial_particles(
        prob, x, np.array([[5.0, 5.0]]), t_end=0.05, dt=1e-4, radius=0.1,
        rho_p=rho_f, mu=0.05, rho_f=rho_f, gravity=(0.0, g))
    gate(bool(tr.alive[0]) and close(tr.positions[-1, 0], [5.0, 5.0], 0, 1e-6)
         and close(tr.velocities[-1, 0], [0.0, 0.0], 0, 1e-6), "buoyancy")
    return _out(0, list(tr.positions[-1, 0]) + list(tr.velocities[-1, 0]),
                np.concatenate([tr.positions[-1, 0], tr.velocities[-1, 0]]))


def poiseuille_exact(y, t, G, mu, rho, nmax=61):
    """tests/test_projection.py's series solution."""
    nu = mu / rho
    u = G / (2 * mu) * y * (1 - y)
    for k in range(1, nmax, 2):
        u -= (4 * G / (mu * np.pi**3 * k**3)) * np.sin(k * np.pi * y) * np.exp(
            -nu * k**2 * np.pi**2 * t)
    return u


def projection_poiseuille(P):
    """tests/test_projection.py::test_projection_startup_poiseuille: 40
    steps of 0.005, then 120 of 0.02 to the steady parabola."""
    G, mu, rho = 1.0, 1.0, 1.0
    mesh = P.mesh.rectangle_mesh(3, 10, elem="QUAD9", xlim=(0, 0.6),
                                 ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)

    def bc_u(prob):
        for ns in ("top", "bottom"):
            prob.add_dirichlet(ns, "ustar", 0, 0.0)
        for ns in ("top", "bottom", "left", "right"):
            prob.add_dirichlet(ns, "ustar", 1, 0.0)

    def bc_p(prob):
        prob.add_dirichlet("pin", "pphi", 0, 0.0)

    ps = P.ProjectionSolver(mesh, {"rho": rho, "mu": mu,
                                   "body_force": (G, 0.0)}, bc_u, bc_p, **P.kw)
    counts = {"ustar": [], "pphi": []}
    undo = [count_newton(ps.solver_u, counts["ustar"]),
            count_newton(ps.solver_p, counts["pphi"])]
    res = ps.run(np.zeros((mesh.n_nodes, 2)), np.zeros(mesh.n_nodes), 0.005,
                 40)
    y = mesh.coords[:, 1]
    err = np.max(np.abs(res.u[:, 0] - poiseuille_exact(y, res.t, G, mu, rho)))
    vmax = np.max(np.abs(res.u[:, 1]))
    res2 = ps.run(res.u, res.p, 0.02, 120)
    for u in undo:
        u()
    err2 = np.max(np.abs(res2.u[:, 0] - G / (2 * mu) * y * (1 - y)))
    gate(err < 4e-3 and vmax < 2e-3 and err2 < 2e-3, "Poiseuille start-up")
    return _out(sum(counts["ustar"]) + sum(counts["pphi"]),
                [err, res.u[:, 0].max(), res2.u[:, 0].max()],
                np.concatenate([res.u.ravel(), res.p, res2.u.ravel(),
                                res2.p]))


def _heat_problem(P):
    mesh = P.mesh.rectangle_mesh(6, 6, elem="QUAD4")
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q1", transient=True,
                                          convection=False)],
                     {"rho": 1.0, "Cp": 1.0, "k": 1.0}, **P.kw)
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    return mesh, prob


def _direct(P, max_iter, tol=1e-12):
    return P.NewtonOptions(max_iter=max_iter, tol_residual=tol,
                           linear_solver="direct")


def subcycled_fine_dt(P):
    """tests/test_segregated_subcycle.py::
    test_subcycled_matches_fine_dt_trajectory."""
    _, prob = _heat_problem(P)
    x0 = prob.set_nodal_field(
        np.zeros(prob.dofmap.n_dof), "temperature", 0,
        lambda c: np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]))
    nopt = _direct(P, 6)
    seg = P.seg.SegregatedTransientSolver(
        [P.seg.SubProblem("T", prob, lambda x: {}, newton_options=nopt,
                          subcycle_count=4)],
        dt=0.02, t_end=0.06, theta=0.0)
    r = seg.run({"T": x0})
    ref = P.TransientSolver(prob, nopt, P.TimeOptions(
        dt0=0.005, max_dt=0.005, t_end=0.06, theta=0.0, max_steps=20,
        adapt=False))
    rr = ref.run(x0, prob.base_params())
    gate(r.steps == 3 and close(r.x["T"], _np(rr.x), 0, 1e-9)
         and close(r.xdot["T"], _np(rr.xdot), 0, 1e-7), "subcycled trajectory")
    return _out(r.steps, [np.abs(r.x["T"]).max()],
                np.concatenate([r.x["T"], r.xdot["T"]]))


def subcycle_stiff_species(P):
    """tests/test_segregated_subcycle.py::test_coupled_subcycle_stiff_species
    (the three runs: unsubcycled, 8 subcycles, the fine-dt reference)."""
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD4")
    lam = 40.0

    def run(sub_k, dt=0.05):
        probT = P.Problem(
            mesh, [P.phys.Energy(interp="Q1", transient=True,
                                 convection=False)],
            {"rho": 1.0, "Cp": 1.0, "k": 1.0}, **P.kw)
        for ns in ("left", "right", "top", "bottom"):
            probT.add_dirichlet(ns, "temperature", 0, 0.0)
        probT.finalize()
        probS = P.Problem(
            mesh, [P.phys.Species(1, interp="Q1", transient=True,
                                  convection=False)],
            {"diffusivity": 0.01,
             "species_source": lambda fv, mat, params:
                 -lam * fv.val["species"] + fv.ext["T_field"][:, None]},
            external_fields=["T_field"], **P.kw)
        probS.finalize()
        nopt = _direct(P, 8)
        x0T = probT.set_nodal_field(
            np.zeros(probT.dofmap.n_dof), "temperature", 0,
            lambda c: np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]))
        seg = P.seg.SegregatedTransientSolver(
            [P.seg.SubProblem("T", probT, lambda x: {
                "T_field": probT.get_nodal_field(x, "temperature", 0)},
                newton_options=nopt),
             P.seg.SubProblem("S", probS, lambda x: {}, newton_options=nopt,
                              subcycle_count=sub_k)],
            dt=dt, t_end=0.2, theta=0.0)
        return seg.run({"T": x0T, "S": np.zeros(probS.dofmap.n_dof)}).x["S"]

    S_coarse, S_sub, S_ref = run(1), run(8), run(1, dt=0.05 / 8)
    err_sub = np.max(np.abs(S_sub - S_ref))
    err_coarse = np.max(np.abs(S_coarse - S_ref))
    gate(err_sub < 0.75 * err_coarse, "subcycling gains")
    return _out(0, [err_sub, err_coarse],
                np.concatenate([S_coarse, S_sub, S_ref]))


def subcycle_sweeps_raise(P):
    """tests/test_segregated_subcycle.py::test_subcycle_with_sweeps_raises
    (and the subcycle count's own check)."""
    _, prob = _heat_problem(P)
    raised = []
    for kw, sub in (({"subcycles": 2}, 2), ({}, 0)):
        try:
            P.seg.SegregatedTransientSolver(
                [P.seg.SubProblem("T", prob, lambda x: {},
                                  subcycle_count=sub)],
                dt=0.1, t_end=0.2, **kw)
        except ValueError as e:
            raised.append(str(e))
    gate(len(raised) == 2 and "not supported" in raised[0]
         and "expected to be > 0" in raised[1], "the ValueErrors")
    return _out(0, [len(raised)], np.zeros(1))


def segregated_natural_convection(P):
    """tests/test_more_physics.py::test_segregated_natural_convection."""
    xp = P.xp
    Ra_f = 1e3
    mesh = P.mesh.rectangle_mesh(6, 6, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)

    def temp_bcs(prob):
        prob.add_dirichlet("left", "temperature", 0, 1.0)
        prob.add_dirichlet("right", "temperature", 0, 0.0)

    ph = P.phys
    mono = P.Problem(
        mesh, [ph.Momentum(dim=2, transient=False), ph.Continuity(),
               ph.Energy(interp="Q2", transient=False)],
        {"rho": 1.0, "mu": 1.0, "k": 1.0, "Cp": 1.0,
         "body_force": P.materials.BoussinesqBodyForce([0.0, Ra_f], beta=1.0,
                                                       T0=0.0)}, **P.kw)
    _flow_bcs(mono)
    temp_bcs(mono)
    mono.finalize()
    rm = P.NewtonSolver(mono, P.NewtonOptions(
        max_iter=12, tol_residual=1e-10, linear_solver="direct")).solve(
        np.zeros(mono.dofmap.n_dof), mono.base_params())
    gate(rm.converged, "monolithic solve")

    def ext_boussinesq(fv, mat, params):
        T = fv.ext["T"]
        return xp.stack([xp.zeros_like(T), Ra_f * (1.0 - T)], 1)

    flow = P.Problem(mesh, [ph.Momentum(dim=2, transient=False),
                            ph.Continuity()],
                     {"rho": 1.0, "mu": 1.0, "body_force": ext_boussinesq},
                     external_fields=("T",), **P.kw)
    _flow_bcs(flow)
    flow.finalize()

    class AdvectedEnergy(ph.Energy):
        def residual(self, fv, mat, params):
            gT = fv.grad["temperature"][:, 0, :]
            u = xp.stack([fv.ext["ux"], fv.ext["uy"]], 1)
            adv = xp.einsum("qk,qk->q", u, gT)
            c = (xp.einsum("q,qi->qi", adv, fv.phi["temperature"])
                 + xp.einsum("qk,qik->qi", gT, fv.gphi["temperature"]))
            return c[:, None, :]

    temp = P.Problem(mesh, [AdvectedEnergy(interp="Q2", transient=False)],
                     {}, external_fields=("ux", "uy"), **P.kw)
    temp_bcs(temp)
    temp.finalize()
    subs = [
        P.seg.SubProblem("temp", temp, lambda x: {"T": np.nan_to_num(
            temp.get_nodal_field(x, "temperature"))}),
        P.seg.SubProblem("flow", flow, lambda x: {
            "ux": np.nan_to_num(flow.get_nodal_field(x, "velocity", 0)),
            "uy": np.nan_to_num(flow.get_nodal_field(x, "velocity", 1))}),
    ]
    seg = P.seg.SegregatedSolver(subs, max_outer=40, tol=1e-9)
    for s in subs:
        seg._solvers[s.name].opts.linear_solver = "direct"
        seg._solvers[s.name].opts.tol_residual = 1e-11
    res = seg.solve({"temp": np.zeros(temp.dofmap.n_dof),
                     "flow": np.zeros(flow.dofmap.n_dof)})
    T_seg = temp.get_nodal_field(res.x["temp"], "temperature")
    T_mono = mono.get_nodal_field(_np(rm.x), "temperature")
    u_seg = flow.get_nodal_field(res.x["flow"], "velocity", 0)
    u_mono = mono.get_nodal_field(_np(rm.x), "velocity", 0)
    gate(res.converged and close(T_seg, T_mono, 0, 1e-6)
         and close(u_seg, u_mono, 0, 1e-5), "segregated against monolithic")
    return _out(res.outer_iters, [res.outer_iters, np.abs(u_seg).max()],
                np.concatenate([res.x["temp"], res.x["flow"]]))


SMALL = {
    "derived_manufactured": derived_manufactured,
    "derived_custom": derived_custom,
    "derived_ls_normal": derived_ls_normal,
    "derived_density_residual": derived_density_residual,
    "derived_porous": derived_porous,
    "derived_strain_diffusion": derived_strain_diffusion,
    "particle_rigid_rotation": particle_rigid_rotation,
    "particle_leaves": particle_leaves,
    "inertial_terminal": inertial_terminal,
    "inertial_buoyancy": inertial_buoyancy,
    "projection_poiseuille": projection_poiseuille,
    "subcycled_fine_dt": subcycled_fine_dt,
    "subcycle_stiff_species": subcycle_stiff_species,
    "subcycle_sweeps_raise": subcycle_sweeps_raise,
    "segregated_natural_convection": segregated_natural_convection,
}
