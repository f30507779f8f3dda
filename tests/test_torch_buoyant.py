"""The buoyant-convection deck (bench.bench_buoyant, BASELINE config #2:
momentum + continuity + energy + species, QUAD9, Ra = 1e4, Pr = 0.71,
Boussinesq body force) in the PyTorch port against goma_tpu, at 8x8.

- Nested-dissection levels with the main path's saddle deferral and
  mesh-node clusters: EQUAL (host integer data, copied code, the same
  bisection through ``one_nd_bisection``); the clusters keep each node's
  five dofs (u, v, p, T, Y) in one front.
- Newton with ``gmres+ndlu`` and bench.py's options (float32 Jacobian and
  NDLU factor, leaf 256, ``ew_eta_floor=1e-3``, ``ew_endgame="standard"``,
  tol 1e-6), goma_tpu's NDLU front LU switched to its Pallas kernel
  (interpret mode) so both factor with the same unpivoted algorithm:
  equal Newton iterations; linear iterations within +-1; ||R||_2 within
  rel 1e-2 while above 1e-5 (readings <= 4e-4: the two float32 element
  Jacobians differ by float32 rounding, see test_torch_generic_assembly,
  and each inexact step carries that into the next residual; below 1e-5
  the norm is where the last GMRES solve stopped inside its forcing
  tolerance, 2.0e-7 against 2.4e-7, and both must be below 1e-6); x
  within 1e-5 + 1e-6 |x| (the last inexact step leaves x ~1e-6 from the
  converged state in either package; the pressure carries the
  hydrostatic head of the body force, Ra Pr = 7100, read at 3e-8
  relative).
- The same in float64 end to end (Jacobian and factor, tol 1e-9): equal
  Newton and linear iterations, ||R||_2 within rel 1e-6 while above 1e-8
  (the norms are taken in float32 in both packages), x within 1e-8.
- bench.bench_buoyant("tpu_direct") (float32 Jacobian and factor, leaf
  256, tol 1e-6), goma_tpu's lazy NDLU given the unpivoted front LU as in
  tests/test_torch_tpu_direct.py: equal Newton iterations, x within
  1e-5 + 1e-6 |x| (both stop below ||R||_2 1e-6 after refined float32
  steps; the bound of the gmres case).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu.solvers import ndlu as jndlu
from goma_tpu.solvers.twolevel import _saddle_mask as j_saddle
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from goma_tpu_torch.solvers import ndlu as tndlu
from goma_tpu_torch.solvers.twolevel import _saddle_mask as t_saddle
from test_torch_host import JAX_PKG, TORCH_PKG, buoyant
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

# bench.bench_buoyant("gmres_ndlu")
BENCH = dict(max_iter=15, tol_residual=1e-6, linear_tol=1e-4, precond="ndlu",
             linear_solver="gmres", gmres_restart=60, linear_maxiter=240,
             ndlu_leaf_max=256, ew_eta_floor=1e-3, ew_endgame="standard")
# bench.bench_buoyant("tpu_direct")
BENCH_DIRECT = dict(max_iter=15, tol_residual=1e-6, linear_solver="tpu_direct",
                    ndlu_leaf_max=256)


@functools.lru_cache(maxsize=None)
def _pair(n=8):
    return buoyant(JAX_PKG, n), buoyant(TORCH_PKG, n)


@pytest.mark.parametrize("leaf_max", [96, 256])
def test_buoyant_nd_levels_equal(leaf_max):
    pj, pt = _pair()
    np.testing.assert_array_equal(pt.pattern.indices, pj.pattern.indices)
    np.testing.assert_array_equal(t_saddle(pt), j_saddle(pj))
    np.testing.assert_array_equal(tndlu.node_clusters(pt),
                                  jndlu.node_clusters(pj))
    lj = jndlu.build_nd_tree(pj.pattern, leaf_max=leaf_max,
                             defer_dofs=j_saddle(pj),
                             clusters=jndlu.node_clusters(pj))
    lt = tndlu.build_nd_tree(pt.pattern, leaf_max=leaf_max,
                             defer_dofs=t_saddle(pt),
                             clusters=tndlu.node_clusters(pt))
    assert len(lt) == len(lj) > 1
    for a, b in zip(lj, lt):
        assert (b.nn, b.smax, b.bmax, b.cb) == (a.nn, a.smax, a.bmax, a.cb)
        assert 1 < b.smax <= 1000  # inside the front kernel's gate
        for k in ("a_lin", "a_src", "own_w", "bnd_w", "pad_node", "pad_slot"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=k)
    # every node's dofs in one tree node
    cl = tndlu.node_clusters(pt)
    owner = np.empty(pt.dofmap.n_dof, np.int64)
    for li, lev in enumerate(lt):
        for q, row in enumerate(lev.own_w):
            own = row[row < pt.dofmap.n_dof]
            owner[own] = li * 100_000 + q
    for c in np.unique(cl):
        assert np.unique(owner[cl == c]).size == 1


def _solve(kw, mixed):
    pj, pt = _pair()
    pj.jacobian_dtype = jnp.float32 if mixed else None
    pt.jacobian_dtype = torch.float32 if mixed else None
    sj = JSolver(pj, JOptions(**kw))
    x0 = np.zeros(pj.dofmap.n_dof)
    if kw["linear_solver"] == "tpu_direct":
        # goma_tpu's lazy tpu_direct NDLU, built as it builds it, with the
        # unpivoted front LU the port runs
        vals = sj._prep(jnp.asarray(x0), pj.base_params(), sj._ntab["ell"])[1]
        sj._ndlu = jndlu.NDLU(
            pj.pattern, leaf_max=sj.opts.ndlu_leaf_max,
            dtype=jnp.dtype(sj.opts.ndlu_dtype), front_lu="pallas",
            defer_dofs=jndlu.zero_diag_defer_mask(pj.pattern,
                                                  jax.device_get(vals)),
            clusters=jndlu.node_clusters(pj))
    else:
        sj.precond.front_lu = "pallas"
    rj = sj.solve(x0, pj.base_params())
    st = NewtonSolver(pt, NewtonOptions(**kw))
    rt = st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params())
    return rj, rt


def test_buoyant_newton_bench_options_match_goma_tpu():
    rj, rt = _solve(BENCH, mixed=True)
    assert rj.converged and rt.converged, (rt.summary(), rj.summary())
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    assert len(rt.linear_iters) == len(rj.linear_iters)
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= 1, (rt.summary(), rj.summary())
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > 1e-5:
            assert abs(l2t - l2j) <= 1e-2 * l2j, (rt.summary(), rj.summary())
    assert rt.res_norms[-1][1] < 1e-6 and rj.res_norms[-1][1] < 1e-6
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6, atol=1e-5)


def test_buoyant_newton_f64_matches_goma_tpu():
    kw = dict(BENCH, ndlu_dtype="float64", tol_residual=1e-9)
    rj, rt = _solve(kw, mixed=False)
    assert rj.converged and rt.converged, (rt.summary(), rj.summary())
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    assert rt.linear_iters == rj.linear_iters, (rt.summary(), rj.summary())
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > 1e-8:
            assert abs(l2t - l2j) <= 1e-6 * l2j, (rt.summary(), rj.summary())
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)


def test_buoyant_tpu_direct_bench_options_match_goma_tpu():
    rj, rt = _solve(BENCH_DIRECT, mixed=True)
    assert rj.converged and rt.converged, (rt.summary(), rj.summary())
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    assert rt.res_norms[-1][1] < 1e-6 and rj.res_norms[-1][1] < 1e-6
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6, atol=1e-5)
