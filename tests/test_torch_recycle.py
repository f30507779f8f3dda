"""GCRO-DR recycling in the port against goma_tpu's.

- One cycle (``linear.gmres_dr_cycle``) with k = 0 and k = 4 recycled
  vectors on a fixed float64 system (a diagonally dominant random sparse
  matrix, a diagonal preconditioner, the cycle stopping early at its
  tolerance, 10 steps): the same step count, and x, V, H and B within
  1e-10 of their max |.| (one algorithm; the sums are taken in another
  order). With k = 4 the deflated recurrence amplifies a rounding
  difference about 3x a step on this system, in goma_tpu, in the port and
  in a plain numpy rerun alike (V 1.3e-12 apart at 10 steps, 1e-9 at 15),
  so the cycle stops at 10.
- The harvest (``NewtonSolver._dr_harvest``) from the same V, H, B, U and
  C: U within 1e-8 after each column's sign is aligned (the host eigensolve
  of the same pencil; SciPy may flip a vector's sign).
- goma_tpu's ``tests/test_recycle.py`` decks in both packages: the 12x12
  Re 200 cavity on the two-level preconditioner with ``recycle_k`` 0 and 8,
  and the 8x8 transient heat deck with 0 and 6. The same Newton counts, x
  within goma_tpu's own bounds (1e-7 Newton, 1e-8 transient), each solve's
  linear iterations within 2 of goma_tpu's on the Newton deck, and
  goma_tpu's properties in the port (its plain runs, without recycling,
  run in the port only): the recycled total at most the plain total, fewer
  iterations on the last two solves, the same trajectory.
  On the recycled transient run each step's converged Newton iteration
  ends with the pipelined loop's speculative solve of a residual at
  rounding level (~1e-15), thrown away, whose cycle is long enough to
  harvest: the next step's space is rounding noise in either package, so
  those solves are held within 4 (goma_tpu 13, 22, 3, 4, 3; the port 16,
  23, 2, 8, 2), and the first step, before any harvest, exactly.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu.solvers.linear import gmres_dr_cycle as j_cycle
from goma_tpu.solvers.transient import TimeOptions as JTime
from goma_tpu.solvers.transient import TransientSolver as JTransient
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from goma_tpu_torch.solvers.linear import gmres_dr_cycle
from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver
from test_torch_host import JAX_PKG, TORCH_PKG, cpu
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

N = 400
RESTART = 60
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _system():
    """A, b, a diagonal preconditioner and a k = 4 recycled pair (U, C)
    with C = A M U orthonormal, as ``_dr_setup`` makes it."""
    rng = np.random.default_rng(11)
    A = (sp.diags(rng.uniform(1.0, 4.0, N))
         + 0.4 * sp.random(N, N, density=0.02, random_state=3)).toarray()
    b = rng.standard_normal(N)
    dinv = 1.0 / np.diag(A) * rng.uniform(0.8, 1.2, N)
    U = rng.standard_normal((4, N))
    Q, R = np.linalg.qr((A @ (dinv * U).T))
    return A, b, dinv, np.linalg.solve(R.T, U), Q.T


def _cycles(k):
    A, b, dinv, U, C = _system()
    U, C = U[:k], C[:k]
    x0 = 0.01 * np.random.default_rng(5).standard_normal(N)
    At, dt = torch.as_tensor(A), torch.as_tensor(dinv)
    lr, V, H, B = gmres_dr_cycle(lambda v: At @ v, lambda r: dt * r,
                                 torch.as_tensor(b), torch.as_tensor(x0),
                                 torch.as_tensor(U), torch.as_tensor(C),
                                 RESTART, TOL)
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    xj, rnj, cj, Vj, Hj, Bj = j_cycle(lambda v: Aj @ v, lambda r: dj * r,
                                      jnp.asarray(b), jnp.asarray(x0),
                                      jnp.asarray(U), jnp.asarray(C),
                                      RESTART, jnp.asarray(TOL))
    return (lr, V, H, B), tuple(np.asarray(a) for a in (xj, rnj, cj, Vj, Hj, Bj))


def _rel_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("k", [0, 4])
def test_one_cycle_matches_goma_tpu(k):
    (lr, V, H, B), (xj, rnj, cj, Vj, Hj, Bj) = _cycles(k)
    assert lr.iters == int(cj) == 10  # stopped early, at the same step
    assert lr.converged and lr.resnorm <= TOL * lr.bnorm
    assert abs(lr.resnorm - float(rnj)) <= 1e-6 * float(rnj)
    assert _rel_max(lr.x, xj) <= 1e-10
    assert _rel_max(V, Vj) <= 1e-10
    assert _rel_max(H, Hj) <= 1e-10
    assert B.shape == Bj.shape == (k, RESTART)
    if k:
        assert _rel_max(B, Bj) <= 1e-10


def _fake_solver(cls, k):
    """What ``_dr_harvest`` reads of a solver: the options' k (goma_tpu's
    also its two jitted small products)."""
    return types.SimpleNamespace(
        opts=types.SimpleNamespace(recycle_k=k),
        _dr_small_jit=lambda U, C, V: cls._dr_small_mats(None, U, C, V),
        _dr_unew=lambda g_u, g_v, U, V: cls._dr_unew(None, g_u, g_v, U, V))


@pytest.mark.parametrize("k", [0, 4])
def test_harvest_matches_goma_tpu(k):
    """The next solve's U from one cycle's V, H, B (goma_tpu's), with no
    recycled space (k = 0 cycle, four vectors harvested) and with one."""
    A, b, dinv, U, C = _system()
    _, (_, _, cj, Vj, Hj, Bj) = _cycles(k)
    kk = 4
    Uin = U[:k] if k else None
    Un_j = np.asarray(JSolver._dr_harvest(
        _fake_solver(JSolver, kk), None if Uin is None else jnp.asarray(Uin),
        jnp.asarray(C[:k]), jnp.asarray(Vj), jnp.asarray(Hj),
        jnp.asarray(Bj), int(cj)))
    Un_t = NewtonSolver._dr_harvest(
        _fake_solver(NewtonSolver, kk),
        None if Uin is None else torch.as_tensor(Uin),
        torch.as_tensor(C[:k]), torch.as_tensor(Vj), torch.as_tensor(Hj),
        torch.as_tensor(Bj), int(cj)).numpy()
    assert Un_t.shape == Un_j.shape == (kk, N)
    sign = np.sign(np.sum(Un_t * Un_j, axis=1, keepdims=True))
    assert _rel_max(sign * Un_t, Un_j) <= 1e-8
    # a cycle shorter than k + 2 steps harvests nothing
    assert NewtonSolver._dr_harvest(
        _fake_solver(NewtonSolver, kk), None, torch.as_tensor(C[:0]),
        torch.as_tensor(Vj), torch.as_tensor(Hj), torch.as_tensor(Bj),
        kk + 1) is None


def _cavity(pkg, n=12, Re=200.0):
    """goma_tpu's tests/test_recycle.py cavity, from either package."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=False),
                              phys.Continuity(interp="Q1")],
                       {"rho": 1.0, "mu": 1.0 / Re}, **cpu(pkg))
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


@functools.lru_cache(maxsize=None)
def _newton_runs():
    """{recycle_k: (goma_tpu's result or None, the port's result, the
    port's solver)} of the cavity deck: both packages with 8 recycled
    vectors, the port alone without (goma_tpu's test's plain run)."""
    pj, pt = _cavity(JAX_PKG), _cavity(TORCH_PKG)
    out = {}
    for rk in (0, 8):
        kw = dict(max_iter=15, tol_residual=1e-9, linear_tol=1e-6,
                  gmres_restart=120, linear_maxiter=480, precond="twolevel",
                  smooth_sweeps=1, recycle_k=rk)
        rj = JSolver(pj, JOptions(**kw)).solve(
            np.zeros(pj.dofmap.n_dof), pj.base_params()) if rk else None
        st = NewtonSolver(pt, NewtonOptions(**kw))
        rt = st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params())
        out[rk] = (rj, rt, st)
    return out


def test_recycled_newton_matches_goma_tpu():
    rj, rt, st = _newton_runs()[8]
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    assert len(rt.linear_iters) == len(rj.linear_iters)
    assert all(abs(a - int(b)) <= 2
               for a, b in zip(rt.linear_iters, rj.linear_iters))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-7)
    assert st._recycle_U is not None
    assert len(st.harvest_s) == len(rt.linear_iters) + st.n_discarded


def test_recycled_newton_properties_hold_in_port():
    """goma_tpu's own assertions, on the port's runs: the same solution,
    no more Krylov iterations in all, fewer on the last two solves; and
    ``reset_lagged`` drops the recycled space."""
    runs = _newton_runs()
    r0, r1, st = runs[0][1], runs[8][1], runs[8][2]
    assert r0.converged and runs[0][2]._recycle_U is None
    assert runs[0][2].harvest_s == []
    np.testing.assert_allclose(r1.x, r0.x, atol=1e-7)
    assert sum(r1.linear_iters) <= sum(r0.linear_iters)
    assert sum(r1.linear_iters[-2:]) < sum(r0.linear_iters[-2:])
    st.reset_lagged()
    assert st._recycle_U is None and st._fac_cache is None


def _heat(pkg):
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(8, 8, elem="QUAD9")
    prob = fem.Problem(mesh, [phys.Energy(interp="Q2", transient=True,
                                          convection=False)],
                       {"rho": 1.0, "Cp": 1.0, "k": 1.0}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    x0 = prob.set_nodal_field(
        np.zeros(prob.dofmap.n_dof), "temperature", 0,
        lambda c: np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]))
    return prob, x0


@functools.lru_cache(maxsize=None)
def _transient_runs():
    """{recycle_k: [(result, per-step linear iterations, Newton solver)] of
    the transient deck: goma_tpu's and the port's with 6 recycled vectors,
    the port's alone without (goma_tpu's test's plain run)."""
    out = {}
    for rk in (0, 6):
        rec = []
        for pkg, Opt, Solver, Time in (
                (JAX_PKG, JOptions, JTransient, JTime),
                (TORCH_PKG, NewtonOptions, TransientSolver, TimeOptions)):
            if pkg is JAX_PKG and not rk:
                continue
            prob, x0 = _heat(pkg)
            lin = []
            ts = Solver(prob, Opt(max_iter=8, tol_residual=1e-11,
                                  linear_tol=1e-9, gmres_restart=80,
                                  linear_maxiter=320, precond="block_jacobi",
                                  recycle_k=rk),
                        Time(dt0=0.01, max_dt=0.01, t_end=0.05, theta=0.0,
                             adapt=False))
            res = ts.run(x0, prob.base_params(),
                         callback=lambda t, x, xd, r: lin.append(
                             [int(i) for i in r.linear_iters]))
            rec.append((res, lin, ts.newton))
        out[rk] = rec
    return out


def test_recycled_transient_matches_goma_tpu():
    """The recycled space carries across the time steps (one Newton solver
    for the run): the same steps and Newton counts as goma_tpu's, each
    solve's linear iterations within 4 of goma_tpu's (the module docstring
    says why; the first step, before any harvest, exactly), x within 1e-8
    of goma_tpu's and of the port's plain run (goma_tpu's own test)."""
    (rj, lin_j, _), (rt, lin_t, newton) = _transient_runs()[6]
    (r0, lin_0, _), = _transient_runs()[0]
    assert [s.newton_iters for s in rt.steps] == [s.newton_iters
                                                  for s in rj.steps]
    assert [len(a) for a in lin_t] == [len(a) for a in lin_j]
    assert all(abs(a - b) <= 4 for sa, sb in zip(lin_t, lin_j)
               for a, b in zip(sa, sb))
    assert lin_t[0] == lin_j[0] == lin_0[0]
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.x, r0.x, atol=1e-8)
    assert newton._recycle_U is not None
    # every solve harvests, the discarded speculative ones too
    assert len(newton.harvest_s) == (sum(len(a) for a in lin_t)
                                     + newton.n_discarded) > 5
