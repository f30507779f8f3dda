"""The level-set slice of the PyTorch port (``physics/level_set.py``,
``Problem.set_nodal_field``/``get_nodal_field``) against goma_tpu.

- ``heaviside``, ``delta``, ``sharp_heaviside`` and the forward derivative
  of ``heaviside`` on a grid through and around the band, float64: 1e-15
  of each array's max (readings: 0).
- The host helpers on goma_tpu's test meshes: ``interface_facets`` and
  ``renormalize`` on tests/test_level_set.py's 20x20 QUAD4 mesh and its
  distorted circle, ``ls_volume`` and ``renormalize_mass`` on
  tests/test_ls_round2.py's 24x24 QUAD9 mesh and its field, and the 3D
  marching-tetrahedra facets and triangle distances on a 4x4x4 HEX8 box:
  1e-12 (the same numpy operations; readings 0).
- Element residuals and Jacobians of the two-phase block (transient
  Momentum with level-set rho and mu, Continuity, ``CSFSurfaceTension``,
  ``FillEquation`` with SUPG 0 and 0.5) on a 4x4 QUAD9 mesh at a seeded
  random state whose fill values put most quadrature points in the band,
  float64: rel 1e-10 of each variable's rows' max.
- bench.bench_two_phase's static bubble (BASELINE config #5) at 8x8 over
  its 2 backward-Euler steps of dt 0.02, both rungs (``gmres_ndlu``:
  bench.py's options; ``tpu_direct``), with a float64 Jacobian and factor
  and with the bench's float32 Jacobian: the same Newton count in every
  step and the same tpu_direct factorizations, x within 1e-9 in float64
  and 1e-6 with the float32 Jacobian (both stop at ||R||_2 <= 1e-8 after
  inexact or refined float32 steps; readings <= 1.9e-10), the Laplace jump
  within 1e-6 of goma_tpu's (2.2566 at this size). On the tpu_direct rung a
  first step marked rejected makes both drivers halve dt, drop the lagged
  factor and refactor on the retry: the same step records and
  factorizations, x within 1e-6 (reading 3.0e-8). goma_tpu's NDLU runs the
  unpivoted front LU the port runs, as in tests/test_torch_tpu_direct.py.
- One window of examples/two_phase_bubble.py::run_rising at 4x8 (level-set
  rho and mu, a callable gravity, SUPG 0.5) followed by ``renormalize`` and
  ``interface_facets``: the same Newton count in every step, x within 1e-8
  of max|x| (the hydrostatic pressure, ~170) before and after
  renormalization (readings 2.6e-9 and 1.7e-10: both stop at a row-scaled
  ||R||_2 <= 1e-7), the facets within 1e-7 (reading 2.4e-9). The window
  steps a fixed dt of 0.01 to t = 0.05: run_rising's adaptive controller
  collapses dt to ~1e-6 within three steps on this 4x8 deck in both
  packages (the hydrostatic pressure the first step sets up reads as
  predictor error), so the adaptive window would never end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.physics.level_set as jls
import goma_tpu_torch.physics.level_set as tls
from goma_tpu.solvers import ndlu as jndlu
from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers.transient import TimeOptions as JTime
from goma_tpu.solvers.transient import TransientSolver as JTransient
from goma_tpu_torch.interop import params_from_numpy
from goma_tpu_torch.solvers import NewtonOptions
from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver
from test_torch_host import JAX_PKG, TORCH_PKG, cpu
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

SOLVERS = {id(JAX_PKG): (JOptions, JTime, JTransient),
           id(TORCH_PKG): (NewtonOptions, TimeOptions, TransientSolver)}
# bench.bench_two_phase's rungs
RUNGS = {"gmres_ndlu": dict(max_iter=10, tol_residual=1e-8,
                            linear_solver="gmres", precond="ndlu",
                            linear_tol=1e-6, gmres_restart=60,
                            linear_maxiter=240, ndlu_leaf_max=256),
         "tpu_direct": dict(max_iter=10, tol_residual=1e-8,
                            linear_solver="tpu_direct")}
EPS = 0.2


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def test_level_set_functions_match():
    eps = 0.1
    F = np.concatenate([np.linspace(-0.5, 0.5, 2001), [-eps, eps, 0.0]])
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    for name in ("heaviside", "delta"):
        got = _np(getattr(tls, name)(Ft, eps))
        want = _np(getattr(jls, name)(Fj, eps))
        assert got.dtype == np.float64
        assert np.abs(got - want).max() <= 1e-15 * np.abs(want).max(), name
    np.testing.assert_array_equal(_np(tls.sharp_heaviside(Ft)),
                                  _np(jls.sharp_heaviside(Fj)))
    # the forward derivative the element Jacobians see, eps a 0-d tensor as
    # params["ls_eps"] is
    dt_ = torch.func.vmap(torch.func.jacfwd(
        lambda f: tls.heaviside(f, torch.tensor(eps, dtype=torch.float64))))(Ft)
    dj = jax.vmap(jax.jacfwd(lambda f: jls.heaviside(f, jnp.asarray(eps))))(Fj)
    assert np.abs(_np(dt_) - _np(dj)).max() <= 1e-15 * np.abs(_np(dj)).max()


def _meshes(pkg):
    mesh_m = pkg[0]
    m2 = mesh_m.rectangle_mesh(20, 20, elem="QUAD4", xlim=(-1, 1), ylim=(-1, 1))
    m9 = mesh_m.rectangle_mesh(24, 24, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    m3 = mesh_m.box_mesh(4, 4, 4, elem="HEX8", xlim=(-1, 1), ylim=(-1, 1),
                         zlim=(-1, 1))
    return m2, m9, m3


@pytest.mark.parametrize("case", ["renormalize_quad4", "renormalize_mass_quad9",
                                  "facets_hex8"])
def test_host_helpers_match(case):
    (jm2, jm9, jm3), (tm2, tm9, tm3) = _meshes(JAX_PKG), _meshes(TORCH_PKG)
    if case == "renormalize_quad4":
        d = np.linalg.norm(jm2.coords, axis=1) - 0.5
        F = np.tanh(3 * d) * (1.3 + 0.5 * jm2.coords[:, 0])
        pairs = [(tls.interface_facets(tm2, F), jls.interface_facets(jm2, F)),
                 (tls.renormalize(tm2, F), jls.renormalize(jm2, F))]
    elif case == "renormalize_mass_quad9":
        r = np.linalg.norm(jm9.coords, axis=1)
        F = (0.55 ** 2 - r ** 2) * (1.0 + 0.3 * jm9.coords[:, 0])
        eps = 0.12
        pairs = [(tls.ls_volume(tm9, F, eps), jls.ls_volume(jm9, F, eps)),
                 (tls.renormalize(tm9, F), jls.renormalize(jm9, F)),
                 (tls.renormalize_mass(tm9, F, eps),
                  jls.renormalize_mass(jm9, F, eps))]
    else:
        r = np.linalg.norm(jm3.coords - 0.1, axis=1)
        F = (r - 0.6) * (1.0 + 0.2 * jm3.coords[:, 2])
        facets = tls.interface_facets(tm3, F)
        assert facets.shape[1:] == (3, 3) and facets.shape[0] > 0
        pairs = [(facets, jls.interface_facets(jm3, F)),
                 (tls.renormalize(tm3, F), jls.renormalize(jm3, F))]
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)


def _two_phase_block(pkg, supg):
    """The static bubble's equations with level-set rho and mu, on a 4x4
    QUAD9 mesh (the fused Navier-Stokes path does not take this block)."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(4, 4, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    prob = fem.Problem(
        mesh,
        [phys.Momentum(dim=2, transient=True), phys.Continuity(),
         phys.CSFSurfaceTension(dim=2, sigma=0.7),
         phys.FillEquation(interp="Q2", supg=supg, transient=True)],
        {"rho": phys.LevelSetProperty(minus=1.0, plus=3.0),
         "mu": phys.LevelSetProperty(minus=0.2, plus=1.0)}, **cpu(pkg))
    prob.add_dirichlet("left", "velocity", 0, 0.0)
    prob.finalize()
    return prob


@pytest.mark.parametrize("supg", [0.0, 0.5])
def test_two_phase_element_residual_and_jacobian_match(supg):
    pj, pt = _two_phase_block(JAX_PKG, supg), _two_phase_block(TORCH_PKG, supg)
    assert not pt._fast_meta
    rng = np.random.default_rng(11)
    n = pj.dofmap.n_dof
    x = rng.standard_normal(n)
    F = rng.uniform(-0.3, 0.3, pj.mesh.coords.shape[0])
    x = pj.set_nodal_field(x, "fill", 0, F)
    np.testing.assert_array_equal(pt.set_nodal_field(x, "fill", 0, F), x)
    np.testing.assert_array_equal(pt.get_nodal_field(x, "pressure"),
                                  pj.get_nodal_field(x, "pressure"))
    hist = rng.standard_normal(n)
    jp = pj.base_params(ls_eps=jnp.asarray(EPS))
    jp["ct"], jp["hist"] = jnp.asarray(4.0), jnp.asarray(hist)
    tp = params_from_numpy({"ct": 4.0, "hist": hist, "time": 0.0,
                            "dirichlet_val": np.asarray(pj.dirichlet_vals)},
                           device="cpu")
    tp["ls_eps"] = torch.tensor(EPS, dtype=torch.float64)
    rj, Jj = jax.jit(lambda xx, pp: pj._elem_rj_parts(xx, pp, pj._tables)[:2])(
        jnp.asarray(x), jp)
    rt, Jt, _, _ = pt._elem_rj_parts(torch.as_tensor(x), tp, pt._tables)
    rj, Jj = np.asarray(rj[0]), np.asarray(Jj[0])
    rt, Jt = rt[0].numpy(), Jt[0].numpy()
    assert np.isfinite(Jt).all() and np.isfinite(rt).all()
    for s in pt.dofmap.blocks[0].slots:  # each variable's rows apart
        rows = slice(s.start, s.start + s.size)
        for a, b in ((rt, rj), (Jt, Jj)):
            err = np.abs(a[:, rows] - b[:, rows]).max()
            assert err <= 1e-10 * np.abs(b[:, rows]).max(), (s.var, err)


def bubble(pkg, n, sigma=1.0, r0=0.5):
    """bench.bench_two_phase's static bubble (examples/two_phase_bubble.py
    run_static) on an n x n QUAD9 mesh of [-1, 1]^2, and its x0."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = fem.Problem(
        mesh,
        [phys.Momentum(dim=2, transient=True), phys.Continuity(),
         phys.CSFSurfaceTension(dim=2, sigma=sigma),
         phys.FillEquation(interp="Q2", supg=0.0, transient=True)],
        {"rho": 1.0, "mu": 1.0}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    F0 = np.linalg.norm(mesh.coords, axis=1) - r0
    return prob, prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, F0)


def _jax_unpivoted(ts, prob, x0, params, dt):
    """goma_tpu's NDLU runs the port's unpivoted front LU: the gmres
    preconditioner's front_lu, or the lazily built tpu_direct NDLU made as
    goma_tpu makes it, from the first iteration's equilibrated values (the
    first step's predictor is x0)."""
    sj = ts.newton
    if sj.opts.linear_solver == "gmres":
        sj.precond.front_lu = "pallas"
        return
    p = dict(params)
    p["ct"] = jnp.asarray(1.0 / dt)
    p["hist"] = jnp.asarray(-x0 / dt)
    p["time"] = jnp.asarray(dt)
    vals = sj._prep(jnp.asarray(x0), p, sj._ntab["ell"])[1]
    sj._ndlu = jndlu.NDLU(
        prob.pattern, leaf_max=sj.opts.ndlu_leaf_max,
        dtype=jnp.dtype(sj.opts.ndlu_dtype), front_lu="pallas",
        defer_dofs=jndlu.zero_diag_defer_mask(prob.pattern,
                                              jax.device_get(vals)),
        clusters=jndlu.node_clusters(prob))


@functools.lru_cache(maxsize=None)
def _static(pkg_name, rung, mixed, fail_first=False):
    """The static bubble's two steps in one package: (TransientResult, the
    Laplace jump dp, tpu_direct factorizations). ``fail_first`` marks the
    first Newton solve unconverged, so the driver halves dt, drops the
    lagged factors and retries."""
    pkg = JAX_PKG if pkg_name == "jax" else TORCH_PKG
    Opts, Time, Solver = SOLVERS[id(pkg)]
    prob, x0 = bubble(pkg, 8)
    kw = dict(RUNGS[rung])
    if mixed:
        prob.jacobian_dtype = jnp.float32 if pkg is JAX_PKG else torch.float32
    else:
        kw["ndlu_dtype"] = "float64"
    ts = Solver(prob, Opts(**kw), Time(dt0=0.02, t_end=0.04, adapt=False))
    if pkg is JAX_PKG:
        params = prob.base_params(ls_eps=jnp.asarray(EPS))
        _jax_unpivoted(ts, prob, x0, params, 0.02)
    else:
        params = prob.base_params(ls_eps=torch.tensor(EPS, dtype=prob.dtype))
    if fail_first:
        solve, resets = ts.newton.solve, ts.newton.reset_lagged
        ts.newton.resets = 0

        def first_fails(x, p):
            r = solve(x, p)
            if ts.newton.resets == 0:
                r.converged = False
            return r

        def reset_lagged():
            ts.newton.resets += 1
            resets()
            assert ts.newton._ndlu_fac is None

        ts.newton.solve, ts.newton.reset_lagged = first_fails, reset_lagged
    res = ts.run(x0, params)
    p = prob.get_nodal_field(res.x, "pressure")
    rr = np.linalg.norm(prob.mesh.coords, axis=1)
    dp = np.nanmedian(p[rr < 0.3]) - np.nanmedian(p[rr > 0.8])
    return res, dp, ts.newton._ndlu_nfactor


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("rung", ["gmres_ndlu", "tpu_direct"])
def test_static_bubble_matches_goma_tpu(rung, mixed):
    rj, dpj, nfj = _static("jax", rung, mixed)
    rt, dpt, nft = _static("torch", rung, mixed)
    assert len(rt.steps) == len(rj.steps) == 2 and rt.n_failures == 0
    assert all(s.converged for s in rt.steps)
    assert [s.newton_iters for s in rt.steps] == [s.newton_iters for s in rj.steps]
    assert abs(rt.t - 0.04) < 1e-12 and nft == nfj
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6 if mixed else 1e-9)
    # the Laplace jump sigma / r0 = 2 at this coarse size, as goma_tpu's
    # tests/test_examples.py holds at 12x12 (8% there)
    assert abs(dpt - dpj) <= 1e-6 and dpt == pytest.approx(2.0, rel=0.2)


def _rising(pkg):
    """examples/two_phase_bubble.py::run_rising at n = 4 (a 4x8 QUAD9 mesh
    of [0, 1] x [0, 2]), one window of 5 backward-Euler steps of dt 0.01,
    then renormalize and interface_facets, with precond="ndlu" (the port
    refuses goma_tpu's "auto"). Returns (result, x after renormalization,
    facets)."""
    mesh_m, fem, phys = pkg
    Opts, Time, Solver = SOLVERS[id(pkg)]
    xp = jnp if pkg is JAX_PKG else torch
    mesh = mesh_m.rectangle_mesh(4, 8, elem="QUAD9", xlim=(0, 1), ylim=(0, 2))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    rho = phys.LevelSetProperty(minus=1.0, plus=10.0)
    mu = phys.LevelSetProperty(minus=0.1, plus=1.0)

    def gravity(fv, mat, params):
        r = rho(fv, mat, params)
        return xp.stack([xp.zeros_like(r), -9.8 * xp.ones_like(r)], 1)

    prob = fem.Problem(
        mesh,
        [phys.Momentum(dim=2, transient=True), phys.Continuity(),
         phys.CSFSurfaceTension(dim=2, sigma=0.5),
         phys.FillEquation(interp="Q2", supg=0.5, transient=True)],
        {"rho": rho, "mu": mu, "body_force": gravity}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    F0 = np.linalg.norm(mesh.coords - np.array([0.5, 0.5]), axis=1) - 0.25
    x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, F0)
    ts = Solver(prob,
                Opts(max_iter=10, tol_residual=1e-7, linear_tol=1e-8,
                     linear_maxiter=1500, gmres_restart=80, precond="ndlu"),
                Time(dt0=0.01, t_end=0.05, adapt=False))
    if pkg is JAX_PKG:
        ts.newton.precond.front_lu = "pallas"
        eps = jnp.asarray(0.1)
    else:
        eps = torch.tensor(0.1, dtype=prob.dtype)
    res = ts.run(x, prob.base_params(ls_eps=eps))
    ls = jls if pkg is JAX_PKG else tls
    F = prob.get_nodal_field(res.x, "fill")
    xr = prob.set_nodal_field(res.x, "fill", 0, ls.renormalize(mesh, F))
    return res, xr, ls.interface_facets(mesh, prob.get_nodal_field(xr, "fill"))


def test_rising_bubble_window_matches_goma_tpu():
    rj, xj, fj = _rising(JAX_PKG)
    rt, xt, ft = _rising(TORCH_PKG)
    assert len(rt.steps) == len(rj.steps) == 5 and rt.n_failures == 0
    assert [s.newton_iters for s in rt.steps] == [s.newton_iters for s in rj.steps]
    assert all(s.converged for s in rt.steps) and abs(rt.t - 0.05) < 1e-12
    xmax = np.abs(rj.x).max()
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8 * xmax)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8 * xmax)
    assert ft.shape == fj.shape and ft.shape[0] > 0
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-7)


def test_static_bubble_tpu_direct_halve_and_retry_matches_goma_tpu():
    """A rejected first step on the tpu_direct rung: both drivers halve dt,
    drop the lagged NDLU factor (``reset_lagged``) and refactor on the
    retry; the same step records, factorizations and x as goma_tpu."""
    rj, _, nfj = _static("jax", "tpu_direct", True, fail_first=True)
    rt, _, nft = _static("torch", "tpu_direct", True, fail_first=True)
    assert [s.dt for s in rt.steps] == [s.dt for s in rj.steps] == [0.01] * 4
    assert [s.newton_iters for s in rt.steps] == [s.newton_iters for s in rj.steps]
    assert nft == nfj >= 2
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)
