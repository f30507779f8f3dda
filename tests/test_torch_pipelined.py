"""The pipelined Newton loop of the PyTorch port
(``NewtonSolver._solve_pipelined``, goma_tpu ``newton.py:910``) on the 8x8
Re=100 lid-driven cavity, on the CPU.

- ``_eta_device`` equals the host ``_eta`` on a grid of (||R||_2, previous
  ||R||_2) that holds 0 and the first-iteration sentinel, under both
  endgames, a nonzero floor and fixed forcing, to rel 1e-15 (readings: 0,
  the same float64 operations). At ``prev_l2 == 0`` both keep
  ``linear_tol`` (goma_tpu's ``_eta_device`` returns 0.1 there, a fault of
  the reference the port does not copy).
- ``solve`` routes ``gmres`` with ``tol_update == 0`` to the pipelined
  loop, ``tol_update > 0`` and ``tpu_direct`` to the sequential one.
- The pipelined loop against ``_solve_sequential`` on one deck: equal
  Newton and linear iterations and norms within rel 1e-12 in float64
  (readings: equal), with the deck's options and with a tolerance that
  makes a speculative solve go to waste (counted in ``n_discarded``); under
  the float32 Jacobian with prep32 (the main path's options), also with a
  prep32 threshold that sends the speculating float32 prep into the
  endgame re-prep.
- The pipelined loop against goma_tpu's ``solve()`` (its own pipelined
  loop) at tests/test_torch_newton.py's tolerances, float64 and the mixed
  main-path options.
- The buckets: with the norm-read helper made to cost 50 ms on a fake
  clock, every read lands in ``solve_time`` and none in
  ``assembly_time``, in a solve whose iterations all speculate and in one
  with non-speculating iterations.
"""

import types

import numpy as np
import pytest
import torch

from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from goma_tpu_torch.solvers import linear, newton
from test_torch_host import TORCH_PKG, cavity
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_newton import GMRES_NDLU, _run

F64 = dict(GMRES_NDLU, ndlu_dtype="float64", ndlu_leaf_max=96,
           tol_residual=1e-9)
MIXED = dict(GMRES_NDLU, ndlu_leaf_max=192, prep32_tol=3e-6,
             tol_residual=1e-6)


@pytest.fixture(scope="module")
def decks():
    """The 8x8 cavity in float64, and with a float32 Jacobian."""
    p64 = cavity(TORCH_PKG, 8)
    p32 = cavity(TORCH_PKG, 8)
    p32.jacobian_dtype = torch.float32
    return {False: p64, True: p32}


@pytest.mark.parametrize("opts", [
    dict(), dict(ew_endgame="standard"), dict(ew_eta_floor=1e-3),
    dict(ew_endgame="standard", ew_eta_floor=1e-3, linear_tol=1e-4),
    dict(linear_tol=0.5), dict(tol_residual=0.0), dict(forcing="fixed"),
])
def test_eta_device_equals_host_eta(opts):
    solver = types.SimpleNamespace(opts=NewtonOptions(precond="ndlu", **opts))
    # float32 values stand for the norms the preps return
    l2s = [torch.tensor(v, dtype=torch.float64)
           for v in (0.0, 1e-300, 1e-12, 1e-9, 3e-7, 1e-4, 0.05, 1.0, 1e6)]
    l2s += [torch.tensor(v, dtype=torch.float32) for v in (3e-7, 0.3)]
    prevs = [None, 0.0, 1e-12, 1e-6, 1e-3, 1.0, 4.0, 1e8]
    for l2 in l2s:
        for prev in prevs:
            prev_t = torch.tensor(-1.0 if prev is None else prev,
                                  dtype=l2.dtype)
            host = NewtonSolver._eta(solver, float(l2),
                                     None if prev is None else float(prev_t))
            dev = NewtonSolver._eta_device(solver, l2, prev_t)
            assert dev.dtype == torch.float64
            assert abs(float(dev) - host) <= 1e-15 * host, (l2, prev, host,
                                                            float(dev))
    if opts.get("forcing", "ew") == "ew":
        lt = solver.opts.linear_tol
        # prev_l2 == 0 keeps linear_tol before the clamps, as the host does
        eta0 = float(NewtonSolver._eta_device(solver, torch.tensor(1e3),
                                              torch.tensor(0.0)))
        assert eta0 == NewtonSolver._eta(solver, 1e3, 0.0)
        if not opts.get("ew_eta_floor") and lt < 0.1:
            assert eta0 == lt


@pytest.mark.parametrize("kw,route", [
    (dict(GMRES_NDLU), "_solve_pipelined"),
    (dict(GMRES_NDLU, tol_update=1e-6), "_solve_sequential"),
    (dict(linear_solver="tpu_direct"), "_solve_sequential"),
])
def test_solve_routes_as_goma_tpu(decks, kw, route):
    st = NewtonSolver(decks[False], NewtonOptions(**kw))
    taken = []
    for name in ("_solve_pipelined", "_solve_sequential"):
        setattr(st, name, lambda x0, params, _n=name: taken.append(_n))
    st.solve(np.zeros(decks[False].dofmap.n_dof), decks[False].base_params())
    assert taken == [route]


@pytest.mark.parametrize("mixed,kw,discarded", [
    (False, F64, 0),
    # 5e-8: the last iteration's predictor (10 x 1.7e-4^2 = 2.8e-7) says
    # speculate, the norms read 2.2e-8 and converge: one solve thrown away
    (False, dict(F64, tol_residual=5e-8), 1),
    (True, MIXED, 0),
    # prep32 threshold 1e-3: iteration 3 preps in float32 (predicted 1.7e-3)
    # and speculates; its norms read 1.7e-4, under the threshold, so the
    # float32 solve is thrown away and the iteration re-preps
    (True, dict(MIXED, prep32_tol=1e-3), 1),
])
def test_pipelined_matches_sequential(decks, mixed, kw, discarded):
    prob = decks[mixed]
    x0 = np.zeros(prob.dofmap.n_dof)
    sp = NewtonSolver(prob, NewtonOptions(**kw))
    rp = sp._solve_pipelined(x0, prob.base_params())
    ss = NewtonSolver(prob, NewtonOptions(**kw))
    rs = ss._solve_sequential(x0, prob.base_params())
    assert rp.converged and rs.converged
    assert rp.iters == rs.iters and rp.linear_iters == rs.linear_iters
    for a, b in zip(rp.res_norms, rs.res_norms):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    np.testing.assert_allclose(rp.update_norms, rs.update_norms, rtol=1e-12)
    np.testing.assert_allclose(rp.x, rs.x, rtol=0, atol=1e-12)
    assert sp.n_discarded == discarded and ss.n_discarded == 0


@pytest.mark.parametrize("mixed", [False, True])
def test_pipelined_matches_goma_tpu(monkeypatch, mixed):
    """The port's routed ``solve`` (asserted to be the pipelined loop)
    against goma_tpu's, at tests/test_torch_newton.py's tolerances."""
    def refuse(self, x0, params):
        raise AssertionError("gmres with tol_update == 0 took the sequential loop")

    monkeypatch.setattr(NewtonSolver, "_solve_sequential", refuse)
    rj, rt, st = _run(MIXED if mixed else F64, mixed=mixed)
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    if mixed:
        np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)
        return
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > 1e-8:
            assert abs(l2t - l2j) <= 1e-6 * l2j, (rt.summary(), rj.summary())
    assert len(rt.linear_iters) == len(rj.linear_iters)
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= 1
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)


class _Clock:
    """A perf_counter that moves only when the norm read is charged."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


@pytest.mark.parametrize("case", ["speculating", "non-speculating",
                                  "prep32 re-prep"])
def test_norm_read_is_charged_to_solve_time(decks, monkeypatch, case):
    clock = _Clock()
    monkeypatch.setattr(newton, "time", clock)
    reads = {"loop": 0, "gmres": 0}
    real = linear.read_scalars

    def slow(where):
        def read(tensors):
            clock.t += 0.05
            reads[where] += 1
            return real(tensors)
        return read

    # the loop's own read of the norms, and the first read of every GMRES
    # cycle (which carries the norms on a speculating iteration)
    monkeypatch.setattr(newton, "read_scalars", slow("loop"))
    monkeypatch.setattr(linear, "read_scalars", slow("gmres"))
    kw = {"speculating": dict(F64, max_iter=2),
          "non-speculating": F64,
          "prep32 re-prep": dict(MIXED, prep32_tol=1e-3)}[case]
    prob = decks[case == "prep32 re-prep"]
    st = NewtonSolver(prob, NewtonOptions(**kw))
    res = st.solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
    if case == "speculating":
        assert reads["loop"] == 0 and reads["gmres"] >= 2
    else:
        assert res.converged and reads["loop"] >= 1
    assert res.assembly_time == 0.0
    assert res.solve_time == pytest.approx(0.05 * (reads["loop"] + reads["gmres"]),
                                           rel=1e-12)
