"""Newton on the 8x8 Re=100 lid-driven cavity: the PyTorch port's
``NewtonSolver.solve`` against goma_tpu's, both routed to their pipelined
loops (tests/test_torch_pipelined.py holds the port's pipelined loop
against its sequential one), with goma_tpu's NDLU
front LU switched to its Pallas kernel (interpret mode on the CPU) so both
packages factor with the same unpivoted algorithm.

(a) float64 end to end (Jacobian and NDLU factor), leaf 96, tol 1e-9:
    equal Newton iterations; per-iteration ||R||_2 within rel 1e-6 while
    above 1e-8 (the norms are taken in float32 in both packages, 6e-8
    roundoff; below 1e-8 the residual is at the linear tolerance and
    rounding noise); linear iterations within +-1 (a last-ulp difference
    can move one early-exit test); x within 1e-8.
(b) the main path's options (float32 Jacobian and factor, prep32_tol 3e-6,
    restart 60, leaf 192, tol 1e-6): equal Newton iterations, both
    converged, x within 1e-6 — the last inexact float32 step sets x to
    ~1e-6 of the converged state in either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_host import JAX_PKG, TORCH_PKG, cavity
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

GMRES_NDLU = dict(precond="ndlu", linear_solver="gmres", max_iter=20,
                  linear_tol=1e-4, gmres_restart=60, linear_maxiter=240)


def _run(kw, mixed):
    pj, pt = cavity(JAX_PKG, 8), cavity(TORCH_PKG, 8)
    if mixed:
        pj.jacobian_dtype = jnp.float32
        pt.jacobian_dtype = torch.float32
    sj = JSolver(pj, JOptions(**kw))
    sj.precond.front_lu = "pallas"
    rj = sj.solve(np.zeros(pj.dofmap.n_dof), pj.base_params())
    st = NewtonSolver(pt, NewtonOptions(**kw))
    rt = st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params())
    return rj, rt, st


def test_newton_f64_matches_goma_tpu():
    kw = dict(GMRES_NDLU, ndlu_dtype="float64", ndlu_leaf_max=96,
              tol_residual=1e-9)
    rj, rt, st = _run(kw, mixed=False)
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > 1e-8:
            assert abs(l2t - l2j) <= 1e-6 * l2j, (rt.summary(), rj.summary())
    assert len(rt.linear_iters) == len(rj.linear_iters)
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= 1
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)
    # every factorization ran the front LU on all ND levels (the twin on CPU)
    assert st.n_factor >= 1


def test_newton_main_path_options_match_goma_tpu():
    kw = dict(GMRES_NDLU, ndlu_leaf_max=192, prep32_tol=3e-6,
              tol_residual=1e-6)
    rj, rt, _ = _run(kw, mixed=True)
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)


def test_newton_zero_rhs_is_converged_zero_step():
    """A zero residual on the first iteration gives a zero step without
    NaN (goma_tpu normalizes a zero Krylov residual here)."""
    pt = cavity(TORCH_PKG, 3)
    st = NewtonSolver(pt, NewtonOptions(**GMRES_NDLU))
    R = torch.zeros(pt.dofmap.n_dof, dtype=torch.float64)
    x = torch.zeros_like(R)
    params = pt.base_params()
    _, _, scale, aux = st._prepare_fast(x, params)
    st._cur_x, st._cur_params = x, params
    lr = st._linsolve_gmres(R, scale, aux, tol=1e-6)
    assert lr.converged and lr.iters == 0
    assert torch.count_nonzero(lr.x) == 0


# the reference run's intra-op pool: torch's default on a multi-core host,
# and another count than either case's (the module's autouse fixture runs
# the other tests in one thread)
REF_THREADS = 4


@pytest.mark.parametrize("threads", [1, 3])
def test_newton_result_independent_of_cpu_threads(threads):
    """The mixed-precision CPU run gives the same iterates for any intra-op
    thread count (the tests' tolerances assume it): ``threads`` against
    REF_THREADS."""
    kw = dict(GMRES_NDLU, ndlu_leaf_max=192, prep32_tol=3e-6,
              tol_residual=1e-6)
    pt = cavity(TORCH_PKG, 6)
    pt.jacobian_dtype = torch.float32
    runs = []
    old = torch.get_num_threads()
    try:
        for n in (threads, REF_THREADS):
            torch.set_num_threads(n)
            assert torch.get_num_threads() == n
            runs.append(NewtonSolver(pt, NewtonOptions(**kw)).solve(
                np.zeros(pt.dofmap.n_dof), pt.base_params()))
    finally:
        torch.set_num_threads(old)
    r1, r0 = runs
    assert r1.converged and r0.converged and r1.iters == r0.iters
    np.testing.assert_allclose(r1.x, r0.x, rtol=0, atol=1e-6)


def test_newton_update_norm_convergence_matches_goma_tpu():
    """tol_update > 0 (the reference's correction-norm test) takes the
    sequential loop in both packages: same iterations, norms, x."""
    kw = dict(GMRES_NDLU, ndlu_dtype="float64", tol_residual=1e-14,
              tol_update=1e-6)
    rj, rt, _ = _run(kw, mixed=False)
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    assert len(rt.update_norms) == len(rj.update_norms)
    np.testing.assert_allclose(rt.update_norms, rj.update_norms, rtol=1e-6)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)
