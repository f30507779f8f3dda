"""Newton with ``linear_solver="tpu_direct"`` on the 8x8 Re=100 lid-driven
cavity: the PyTorch port against goma_tpu's ``NewtonSolver``.

On the CPU goma_tpu's NDLU picks its pivoted library LU ("auto" -> "lax"),
while the port runs the kernels' algorithm (unpivoted front LU, kernel
substitution). So each goma_tpu solver gets an NDLU(front_lu="pallas") in
its lazy ``_ndlu`` slot before it solves (interpret mode on the CPU), built
as goma_tpu builds it there: zero-diagonal defer mask of the first
iteration's equilibrated values, mesh-node clusters.

(a) float64 Jacobian and factor, tol 1e-10: equal Newton iterations;
    per-iteration ||R||_2 within rel 1e-6 while above 1e-8 (the norms are
    taken in float32 in both packages; below 1e-8 the residual is at the
    refinement's float64 rounding noise); every linear count 1; x within
    5e-8, as goma_tpu's own ``test_newton_tpu_direct_matches_host_direct``.
(b) the bench's setting (float32 Jacobian and factor, leaf 192, refine 1,
    tol 1e-6): both converge, x within 1e-6. Where float32 refinement lands
    depends on rounding (goma_tpu ``NDLU.solve_refined``), so the iteration
    counts are not required to agree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu.solvers import ndlu as jndlu
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_host import JAX_PKG, TORCH_PKG, cavity
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

DIRECT = dict(linear_solver="tpu_direct", precond="ndlu", max_iter=20)


def _jax_solve(kw, mixed, n=8):
    pj = cavity(JAX_PKG, n)
    if mixed:
        pj.jacobian_dtype = jnp.float32
    sj = JSolver(pj, JOptions(**kw))
    x0 = np.zeros(pj.dofmap.n_dof)
    params = pj.base_params()
    vals = sj._prep(jnp.asarray(x0), params, sj._ntab["ell"])[1]
    sj._ndlu = jndlu.NDLU(
        pj.pattern, leaf_max=sj.opts.ndlu_leaf_max,
        dtype=jnp.dtype(sj.opts.ndlu_dtype), front_lu="pallas",
        defer_dofs=jndlu.zero_diag_defer_mask(pj.pattern,
                                              jax.device_get(vals)),
        clusters=jndlu.node_clusters(pj))
    return sj.solve(x0, params)


def _port_solve(kw, mixed, n=8):
    pt = cavity(TORCH_PKG, n)
    if mixed:
        pt.jacobian_dtype = torch.float32
    st = NewtonSolver(pt, NewtonOptions(**kw))
    return st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params()), st


def test_tpu_direct_f64_matches_goma_tpu():
    kw = dict(DIRECT, ndlu_dtype="float64", ndlu_leaf_max=96, ndlu_refine=1,
              tol_residual=1e-10)
    rj = _jax_solve(kw, mixed=False)
    rt, st = _port_solve(kw, mixed=False)
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > 1e-8:
            assert abs(l2t - l2j) <= 1e-6 * l2j, (rt.summary(), rj.summary())
    assert rt.linear_iters == rj.linear_iters == [1] * rt.iters
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=5e-8)
    assert st.precond is None  # the direct path builds no preconditioner
    assert len(st.direct_log) == rt.iters


def test_tpu_direct_bench_options_match_goma_tpu():
    kw = dict(DIRECT, ndlu_leaf_max=192, ndlu_refine=1, tol_residual=1e-6)
    rj = _jax_solve(kw, mixed=True)
    rt, st = _port_solve(kw, mixed=True)
    assert rj.converged and rt.converged, (rt.summary(), rj.summary())
    assert rt.res_norms[-1][1] < 1e-6
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)
    # every accepted step met the guard max(1e-5, linear_tol)
    assert all(rel <= 1e-5 for _, rel, _ in st.direct_log)


@functools.lru_cache(maxsize=None)
def _lag_runs():
    kw = dict(linear_solver="tpu_direct", max_iter=12, tol_residual=1e-10,
              ndlu_refine=3, ndlu_dtype="float64")
    pt = cavity(TORCH_PKG, 8)
    x0 = np.zeros(pt.dofmap.n_dof)
    s_lag = NewtonSolver(pt, NewtonOptions(**kw, ndlu_lag=True))
    s_nol = NewtonSolver(pt, NewtonOptions(**kw, ndlu_lag=False))
    r1 = s_lag.solve(x0, pt.base_params())
    r2 = s_nol.solve(x0, pt.base_params())
    n0 = s_lag._ndlu_nfactor
    r3 = s_lag.solve(x0, pt.base_params())
    return r1, r2, r3, s_lag._ndlu_nfactor - n0, s_nol._ndlu_nfactor


def test_tpu_direct_lagged_factor_transient_reuse():
    """The port's test_ndlu_lagged_factor_transient_reuse: a lagged factor
    refined against the fresh operator gives the no-lag solution, and a
    second solve from the same start reuses warm factors (fewer fresh
    factorizations than Newton iterations). precond="auto" is accepted:
    this path reads no preconditioner."""
    r1, r2, r3, n_lag, n_nol = _lag_runs()
    assert r1.converged and r2.converged and r3.converged
    np.testing.assert_allclose(r1.x, r2.x, atol=5e-8)
    assert n_nol == r2.iters
    assert n_lag < r3.iters
    np.testing.assert_allclose(r3.x, r1.x, atol=5e-8)


def test_tpu_direct_guard_miss_stops_unconverged(monkeypatch):
    """A refined solve that leaves a relative residual above the guard
    max(1e-5, linear_tol) stops Newton unconverged, with no step taken (a
    fresh factor is not retried)."""
    from goma_tpu_torch.solvers import ndlu as tndlu

    def no_progress(self, facs, b, matvec, **kw):
        return torch.zeros_like(b), 1.0

    monkeypatch.setattr(tndlu.NDLU, "solve_refined", no_progress)
    pt = cavity(TORCH_PKG, 3)
    st = NewtonSolver(pt, NewtonOptions(linear_solver="tpu_direct"))
    r = st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params())
    assert not r.converged and r.iters == 0 and r.linear_iters == []
    assert st._ndlu_nfactor == 1 and st.direct_log == [(0, 1.0, True)]
