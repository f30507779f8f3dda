"""NDLU's pivoted front-LU route in the port against goma_tpu's.

goma_tpu factors a front by partial pivoting (``jax.lax.linalg.lu``) on
every level under ``front_lu="lax"`` (its CPU "auto"), and on the levels
its kernel does not take (s == 1 or s > 1000) under ``"pallas"``; with
``lu_block`` the pivoting is restricted to diagonal panels and the front is
identity-padded to whole panels. The port computes the same factors with
``torch.linalg.lu_factor_ex``, ``solve_triangular`` and matmuls, and the
same row permutations.

Systems: goma_tpu's own ``tests/test_ndlu.py`` 8x8 saddle system (the
equilibrated Navier-Stokes Jacobian at rest, zero pressure diagonal,
defer-ordered), the one-dof pattern (s = 1), and the 12x12 cavity at a
seeded state with ``leaf_max=2048`` (one level, s = 1419 > 1000).

Tolerances, each against goma_tpu on the same inputs:
- float64: the permutation of every level equal; fwd, bwd, X, Y within
  1e-12 of their max |.|; x within 1e-12 of goma_tpu's x and within 1e-11
  of scipy's ``spsolve`` (goma_tpu's own bound);
- float32 (``lu_block=24``, three refinement sweeps): the residual below
  1e-12 (goma_tpu's own bound); the factors within 1e-5 of their max
  (float32 rounding, summed in another order);
- goma_tpu's factors carried across and solved by the port: within 1e-12.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from goma_tpu.solvers import ndlu as jndlu
from goma_tpu_torch.fem.sparsity import CSRPattern
from goma_tpu_torch.fem.sparsity import EllOperator as TEll
from goma_tpu_torch.interop import ndlu_factors_from_numpy
from goma_tpu_torch.solvers import ndlu as tndlu
from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver
from test_ndlu import _saddle_system
from test_torch_host import JAX_PKG, TORCH_PKG, cavity
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)


def _port_pattern(pat):
    """goma_tpu's CSR pattern as the port's (the same arrays)."""
    return CSRPattern(pat.n, np.asarray(pat.indptr), np.asarray(pat.indices),
                      np.asarray(pat.rows), np.asarray(pat.keys),
                      np.asarray(pat.diag))


@functools.lru_cache(maxsize=None)
def _saddle():
    prob, pat, vals, b = _saddle_system(8)
    vals, b = np.array(vals), np.array(b)
    A = sp.csr_matrix((vals, pat.indices, pat.indptr), shape=(pat.n, pat.n))
    return pat, _port_pattern(pat), vals, b, A, spla.spsolve(A.tocsc(), b)


@functools.lru_cache(maxsize=None)
def _pair(dtype, lu_block, invert, front_lu="lax"):
    """Both packages' NDLU of the saddle system under ``front_lu`` (goma_tpu
    off a TPU resolves "auto" to "lax"), factored once."""
    jpat, tpat, vals, _, _, _ = _saddle()
    defer = jndlu.zero_diag_defer_mask(jpat, vals)
    jnd = jndlu.NDLU(jpat, leaf_max=64, dtype=jnp.dtype(dtype),
                     lu_block=lu_block, defer_dofs=defer, invert=invert)
    tnd = tndlu.NDLU(tpat, leaf_max=64, dtype=getattr(torch, dtype),
                     lu_block=lu_block, defer_dofs=defer, front_lu=front_lu,
                     invert=invert, device="cpu")
    return tnd, jnd, tnd.factor(torch.as_tensor(vals)), jnd.factor(jnp.asarray(vals))


def _rel_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _check_levels(tnd, ft, fj, tol):
    assert len(ft) == len(fj) == len(tnd.levels) > 2
    for lev, (fwd, bwd, perm, X, Y), (jfwd, jbwd, jperm, jX, jY) in zip(
            tnd.levels, ft, fj):
        assert jperm is not None and perm is not None
        assert np.array_equal(perm.numpy(), np.asarray(jperm))
        assert fwd.shape == np.asarray(jfwd).shape
        assert _rel_max(fwd, jfwd) <= tol
        assert _rel_max(bwd, jbwd) <= tol
        if lev.bmax:
            assert _rel_max(X, jX) <= tol
            assert _rel_max(Y, jY) <= tol
        else:
            assert X is None and np.asarray(jX).size == 0


@pytest.mark.parametrize("lu_block,invert", [(16, False), (16, True),
                                             (None, False)])
def test_pivoted_float64_matches_goma_tpu(lu_block, invert):
    """Blocked (every level s > 16 through the panel loop, the last panel
    identity-padded) and plain pivoted LU, with the explicit inverses and
    with the packed LU: the same permutations, the factors and x."""
    _, _, _, b, _, xs = _saddle()
    tnd, jnd, ft, fj = _pair("float64", lu_block, invert)
    if lu_block:
        assert any(lev.smax % lu_block for lev in tnd.levels)
        assert all(f[0].shape[-1] % lu_block == 0 for f in ft)
    _check_levels(tnd, ft, fj, 1e-12)
    xt = tnd.solve(ft, torch.as_tensor(b)).numpy()
    xj = np.asarray(jnd.solve(fj, jnp.asarray(b)))
    assert _rel_max(xt, xj) <= 1e-12
    assert np.linalg.norm(xt - xs) / np.linalg.norm(xs) < 1e-11
    assert float(tnd.zero_pivots) == 0


def test_pivoted_float32_refined_matches_goma_tpu():
    """goma_tpu's ``test_ndlu_blocked_f32_refined``: float32 blocked factors
    (lu_block=24) plus three refinement sweeps reach float64 backward
    error; the factors stay within float32 rounding of goma_tpu's."""
    _, tpat, vals, b, _, _ = _saddle()
    tnd, _, ft, fj = _pair("float32", 24, False)
    _check_levels(tnd, ft, fj, 1e-5)
    ell = TEll(tpat, device="cpu")
    vt = torch.as_tensor(vals)
    x = tnd.solve_refined(ft, torch.as_tensor(b), lambda v: ell.matvec(vt, v),
                          refine=3)
    r = b - ell.matvec(vt, x).numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-12


@pytest.mark.parametrize("route", ["auto", "pallas", "lax"])
def test_one_dof_front_takes_the_pivoted_route(route):
    """The one-dof pattern (s = 1, outside the kernel's 1 < s <= 1000):
    every route factors it by the plain pivoted LU with the boost, as
    goma_tpu does, and solves to the last bit or two; a zero value is
    boosted to pivot_tol * 1e-30 and counted as a zero pivot."""
    from goma_tpu.fem.sparsity import build_pattern as jbuild
    from goma_tpu_torch.fem.sparsity import build_pattern

    for v in (2.5, -4.0):
        tnd = tndlu.NDLU(build_pattern(1, []), dtype=torch.float64,
                         front_lu=route, invert=route == "lax", device="cpu")
        jnd = jndlu.NDLU(jbuild(1, []), dtype=jnp.float64, front_lu=route,
                         invert=route == "lax")
        assert tnd.levels[0].smax == 1
        ft = tnd.factor(torch.tensor([v], dtype=torch.float64))
        fj = jnd.factor(jnp.asarray([v]))
        assert ft[0][2].tolist() == np.asarray(fj[0][2]).tolist() == [[0]]
        x = float(tnd.solve(ft, torch.tensor([3.0], dtype=torch.float64))[0])
        xj = float(np.asarray(jnd.solve(fj, jnp.asarray([3.0])))[0])
        assert x == pytest.approx(3.0 / v, rel=1e-15)
        assert x == pytest.approx(xj, rel=1e-15)
    tnd = tndlu.NDLU(build_pattern(1, []), dtype=torch.float64,
                     front_lu=route, device="cpu")
    lu = tnd.factor(torch.zeros(1, dtype=torch.float64))[0][0]
    assert float(lu[0, 0, 0]) == 1e-8 * 1e-30
    assert int(tnd.zero_pivots) == 1


@functools.lru_cache(maxsize=None)
def _cavity12():
    """The 12x12 cavity's equilibrated values at a seeded state, and both
    NDLU(invert=False) at leaf_max=2048 (one level, s = 1419)."""
    pj, pt = cavity(JAX_PKG, 12), cavity(TORCH_PKG, 12)
    ts = NewtonSolver(pt, NewtonOptions(precond="ndlu", ndlu_dtype="float64"))
    x = torch.as_tensor(0.3 * np.random.default_rng(7).standard_normal(
        pt.dofmap.n_dof))
    params = pt.base_params()
    R, _, scale, _ = ts._prepare_fast(x, params)
    vals = ts._scaled_vals(x, params, scale).numpy()
    b = (scale * R).numpy()
    defer = tndlu.zero_diag_defer_mask(pt.pattern, vals)
    tnd = tndlu.NDLU(pt.pattern, leaf_max=2048, dtype=torch.float64,
                     defer_dofs=defer, clusters=tndlu.node_clusters(pt),
                     device="cpu")
    jnd = jndlu.NDLU(pj.pattern, leaf_max=2048, dtype=jnp.float64,
                     front_lu="pallas", defer_dofs=defer,
                     clusters=jndlu.node_clusters(pj))
    return pt, vals, b, tnd, jnd, jnd.factor(jnp.asarray(vals))


def test_front_above_kernel_gate_takes_blocked_route():
    """s = 1419 > 1000 under the port's "auto" (goma_tpu's "pallas"): the
    blocked pivoted route at lu_block=128, m = 1536, no kernel substitution;
    x within 1e-11 of goma_tpu's, and goma_tpu's factors carried across
    solve to its x within 1e-12."""
    pt, vals, b, tnd, jnd, fj = _cavity12()
    assert [(lev.nn, lev.smax, lev.bmax) for lev in tnd.levels] == [(1, 1419, 0)]
    assert tnd.front_lu == "auto" and tnd.lu_block == 128
    ft = tnd.factor(torch.as_tensor(vals))
    (lu, _, perm, X, Y), = ft
    assert lu.shape == (1, 1536, 1536) and perm.shape == (1, 1536)
    assert X is None and Y is None
    assert np.array_equal(perm.numpy(), np.asarray(fj[0][2]))
    trace = []
    xt = tnd.solve(ft, torch.as_tensor(b), trace=trace).numpy()
    assert trace == []
    xj = np.asarray(jnd.solve(fj, jnp.asarray(b)))
    assert _rel_max(xt, xj) <= 1e-11
    carried = ndlu_factors_from_numpy(
        [tuple(None if a is None else np.asarray(a) for a in f) for f in fj],
        device="cpu")
    assert carried[0][2].dtype == torch.int64
    assert _rel_max(tnd.solve(carried, torch.as_tensor(b)).numpy(), xj) <= 1e-12


@pytest.mark.parametrize("lu_block,invert", [(16, False), (16, True)])
def test_carried_pivoted_factors_solve_like_goma_tpu(lu_block, invert):
    """goma_tpu's pivoted factors of the saddle system, carried across by
    ``ndlu_factors_from_numpy``, solved by the port."""
    _, _, _, b, _, _ = _saddle()
    tnd, jnd, _, fj = _pair("float64", lu_block, invert)
    facs = ndlu_factors_from_numpy(
        [tuple(None if a is None else np.asarray(a) for a in f) for f in fj],
        device="cpu")
    assert all(f[2] is not None for f in facs)
    xt = tnd.solve(facs, torch.as_tensor(b)).numpy()
    xj = np.asarray(jnd.solve(fj, jnp.asarray(b)))
    assert _rel_max(xt, xj) <= 1e-12
