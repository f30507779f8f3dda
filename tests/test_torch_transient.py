"""The transient driver of the PyTorch port (``solvers/transient.py``)
against goma_tpu's ``TransientSolver``.

- goma_tpu's heat-eigenmode decks (tests/test_transient.py: T = sin(pi x)
  sin(pi y) exp(-2 pi^2 t) on QUAD9, Q2 temperature), backward Euler first
  order, Crank-Nicolson second order and the adaptive controller, with the
  Newton options of those tests and ``precond="ndlu"`` in both packages
  (goma_tpu's default "auto" the port refuses), leaf 48 (every ND level of
  the 6x6 and 5x5 decks has 1 < s <= 1000). Each run must give the same
  step records in both packages: the same number of steps and Newton
  iterations per step, t, dt and the predictor-corrector error within rel
  1e-6 (readings <= 7e-9; the adaptive dt sequence feeds each step's error
  into the next dt), the error also 1e-8 absolute (reading 1.2e-9 at an
  error of 1.9e-4), x within 1e-10 (readings <= 4.3e-12); the port's error
  against the exact mode must show the scheme's order as goma_tpu's test
  requires. The tight-target controller run is cut from t_end = 0.02 (794
  steps) to 0.004 to keep the test short.
- The start-up of bench.bench_viscoelastic's deck at 8x4 (``transient=True``
  on Momentum and VEStress, x0 = 0, bench.py's gmres+ndlu options, float32
  Jacobian): 5 backward-Euler steps of dt 0.05 without adaptation, Newton
  [3, 3, 3, 2, 2] in both packages, the same step records, x within 1e-8
  (reading 7.6e-11).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers.transient import TimeOptions as JTime
from goma_tpu.solvers.transient import TransientSolver as JTransient
from goma_tpu_torch.solvers import NewtonOptions
from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver
from test_torch_host import JAX_PKG, TORCH_PKG, cpu, viscoelastic
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_viscoelastic import GMRES

SOLVERS = {id(JAX_PKG): (JOptions, JTime, JTransient),
           id(TORCH_PKG): (NewtonOptions, TimeOptions, TransientSolver)}


def _heat(pkg, n):
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9")
    prob = fem.Problem(mesh, [phys.Energy(interp="Q2", transient=True,
                                          convection=False)],
                       {"rho": 1.0, "Cp": 1.0, "k": 1.0}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    return mesh, prob


@functools.lru_cache(maxsize=None)
def _decay(pkg_name, theta, dt, t_end=0.05, n=6, adapt=False, eps_time=1e-3):
    """tests/test_transient.py::run_decay in one package: (max error against
    the exact mode, TransientResult)."""
    pkg = JAX_PKG if pkg_name == "jax" else TORCH_PKG
    Opts, Time, Solver = SOLVERS[id(pkg)]
    mesh, prob = _heat(pkg, n)
    dofs = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar("temperature")]
    ok = dofs >= 0
    mode = np.sin(np.pi * mesh.coords[ok, 0]) * np.sin(np.pi * mesh.coords[ok, 1])
    x0 = np.zeros(prob.dofmap.n_dof)
    x0[dofs[ok]] = mode
    ts = Solver(prob, Opts(max_iter=6, tol_residual=1e-11, linear_tol=1e-12,
                           precond="ndlu", ndlu_leaf_max=48),
                Time(dt0=dt, t_end=t_end, theta=theta, adapt=adapt,
                     eps_time=eps_time, rel_tol=1e-4))
    res = ts.run(x0, prob.base_params())
    exact = mode * np.exp(-2 * np.pi ** 2 * res.t)
    return float(np.max(np.abs(res.x[dofs[ok]] - exact))), res


def _same_run(rt, rj, x_tol):
    """Step records and final state of the port's run ``rt`` against
    goma_tpu's ``rj``."""
    assert len(rt.steps) == len(rj.steps) and rt.n_failures == rj.n_failures
    assert [s.newton_iters for s in rt.steps] == [s.newton_iters for s in rj.steps]
    assert all(s.converged for s in rt.steps)
    for a, b in zip(rt.steps, rj.steps):
        for f in ("t", "dt", "err_time"):
            va, vb = getattr(a, f), getattr(b, f)
            # err_time also 1e-8 absolute: its weights abs_tol + rel_tol |x|
            # scale x differences up by as much as 1/abs_tol = 1e6
            slack = 1e-8 if f == "err_time" else 0.0
            assert abs(va - vb) <= 1e-6 * abs(vb) + slack, (f, va, vb)
    assert abs(rt.t - rj.t) <= 1e-12
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=x_tol)
    np.testing.assert_allclose(rt.xdot, rj.xdot, rtol=1e-6, atol=x_tol / min(
        s.dt for s in rj.steps))


def _both(*args, **kw):
    (ej, rj), (et, rt) = _decay("jax", *args, **kw), _decay("torch", *args, **kw)
    _same_run(rt, rj, 1e-10)
    return et, rt


def test_heat_backward_euler_first_order():
    e1, _ = _both(0.0, 0.01)
    e2, _ = _both(0.0, 0.005)
    # first order: halving dt roughly halves the error
    assert e1 / e2 == pytest.approx(2.0, rel=0.35), (e1, e2)


def test_heat_crank_nicolson_second_order():
    e1, _ = _both(0.5, 0.01)
    e2, _ = _both(0.5, 0.005)
    assert e1 / e2 == pytest.approx(4.0, rel=0.5), (e1, e2)
    eb, _ = _both(0.0, 0.01)
    assert e1 < 0.3 * eb  # CN beats BE at the same dt


def test_heat_adaptive_dt_controller():
    # tight target: the controller settles dt at the error-target equilibrium
    _, res = _both(0.0, 1e-4, t_end=0.004, adapt=True)
    assert max(s.err_time for s in res.steps[3:]) < 1.5e-3  # eps_time=1e-3
    assert all(s.converged for s in res.steps)
    # loose target: dt grows at the growth cap from a tiny initial step
    _, r2 = _both(0.0, 1e-5, t_end=0.01, n=5, adapt=True, eps_time=1.0)
    dts = [s.dt for s in r2.steps]
    assert dts[3] / dts[2] > 1.4
    assert dts[-1] > 10 * dts[0]


def test_ve_startup_matches_goma_tpu():
    runs = []
    for pkg, jdt in ((JAX_PKG, jnp.float32), (TORCH_PKG, torch.float32)):
        Opts, Time, Solver = SOLVERS[id(pkg)]
        prob = viscoelastic(pkg, 4, transient=True)
        prob.jacobian_dtype = jdt
        ts = Solver(prob, Opts(**GMRES),
                    Time(dt0=0.05, t_end=0.25, theta=0.0, adapt=False))
        runs.append(ts.run(np.zeros(prob.dofmap.n_dof), prob.base_params()))
    rj, rt = runs
    assert [s.newton_iters for s in rt.steps] == [3, 3, 3, 2, 2]
    assert rt.n_failures == 0 and abs(rt.t - 0.25) < 1e-12
    _same_run(rt, rj, 1e-8)


@pytest.mark.parametrize("option", ["quality_guard", "variable_stats"])
def test_time_options_outside_slice_raise(option, capsys):
    """Both options, refused before their slices, now run. ``quality_guard``:
    on a fixed mesh every element keeps detJ > 0, so each step passes the
    guard (tests/test_torch_ale.py and tests/test_torch_slot_coater.py hold
    it on tangled and moving meshes). ``variable_stats`` with ``verbose``:
    each accepted step prints goma_tpu's statistics table
    (``post.stats.format_stats``) to standard error, the same tables as
    goma_tpu prints for the same run (a 4x4 decaying conduction mode, two
    backward-Euler steps), and ``variable_stats`` of the end state is
    goma_tpu's within 1e-12."""
    if option == "quality_guard":
        _, prob = _heat(TORCH_PKG, 2)
        ts = TransientSolver(prob, NewtonOptions(precond="ndlu"),
                             TimeOptions(dt0=0.01, t_end=0.02, adapt=False,
                                         quality_guard=True))
        r = ts.run(np.ones(prob.dofmap.n_dof), prob.base_params())
        assert ts._quality_fn is not None
        assert len(r.steps) == 2 and r.n_failures == 0
        return
    from goma_tpu.post.stats import variable_stats as j_stats
    from goma_tpu_torch.post import variable_stats

    tables, ends = [], []
    for pkg in (JAX_PKG, TORCH_PKG):
        Opts, Time, Solver = SOLVERS[id(pkg)]
        mesh, prob = _heat(pkg, 4)
        x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "temperature",
                                  0, lambda c: np.sin(np.pi * c[:, 0])
                                  * np.sin(np.pi * c[:, 1]))
        ts = Solver(prob, Opts(max_iter=4, tol_residual=1e-11,
                               linear_solver="direct"),
                    Time(dt0=0.01, t_end=0.02, adapt=False, verbose=True,
                         variable_stats=True))
        capsys.readouterr()
        r = ts.run(x0, prob.base_params())
        err = capsys.readouterr().err
        tables.append([ln for ln in err.splitlines()
                       if not ln.startswith("[transient]")])
        ends.append((prob, r.x))
    assert len(tables[1]) == 2 * 2 and tables[1][0].startswith("variable")
    assert tables[1] == tables[0]
    sj = j_stats(*ends[0])
    st = variable_stats(*ends[1])
    assert st.keys() == sj.keys() == {"temperature"}
    for k in ("min", "max", "mean", "l2"):
        assert abs(st["temperature"][k] - sj["temperature"][k]) <= 1e-12 * max(
            1.0, abs(sj["temperature"][k]))
