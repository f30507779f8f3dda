"""NDLU numeric phase and GMRES of the PyTorch port.

System: the equilibrated Jacobian of the 8x8 cavity (saddle rows deferred,
mesh-node clusters, the main path's ND tree) at a seeded random state
whose velocities stay below the lid speed. The same CSR values go to both
packages (the patterns are equal, see test_torch_host), and both cut the
same ND tree (``one_nd_bisection``).

Tolerances (float64):
- solve vs scipy's sparse LU: 1e-9 relative, as goma_tpu's own
  ``test_ndlu_pallas_front_lu_matches_scipy`` — unpivoted static pivoting
  plus explicit inverses lose a few digits to cond(front);
- per-level factors and applies vs goma_tpu NDLU(front_lu="pallas"):
  1e-10 relative — one algorithm, summation order differs in the extend-add
  and the triangular inversion or substitution;
- the port's substitution on goma_tpu's own factors: 1e-12 relative (only
  the substitution's summation order differs);
- GMRES: equal iteration counts, x within 1e-10 relative.

Refinement (``solve_refined``) runs float32 factors of a lagged operator
against the fresh float64 operator, as the lagged ``tpu_direct`` path does:
the same number of residual measurements in both packages, x within 1e-9
relative and the returned relative residual within 1e-6 of goma_tpu's (the
float32 factors differ by their rounding, ~1e-7, which refinement damps;
the readings agree to ~1e-12 in x).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from goma_tpu.fem.sparsity import EllOperator as JEll
from goma_tpu.solvers import ndlu as jndlu
from goma_tpu.solvers.linear import gmres as jax_gmres
from goma_tpu.solvers.twolevel import _saddle_mask as j_saddle
from goma_tpu_torch.fem.sparsity import EllOperator as TEll
from goma_tpu_torch.interop import ndlu_factors_from_numpy
from goma_tpu_torch.solvers import ndlu as tndlu
from goma_tpu_torch.solvers.linear import gmres
from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver
from test_torch_host import JAX_PKG, TORCH_PKG, cavity
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)


def _vals(solver, prob, seed, amp=0.3):
    x = torch.as_tensor(amp * np.random.default_rng(seed).standard_normal(
        prob.dofmap.n_dof))
    params = prob.base_params()
    R, _, scale, _ = solver._prepare_fast(x, params)
    vals = solver._scaled_vals(x, params, scale)
    return vals.numpy(), (scale * R).numpy()


@functools.lru_cache(maxsize=None)
def _system():
    pj, pt = cavity(JAX_PKG, 8), cavity(TORCH_PKG, 8)
    ts = NewtonSolver(pt, NewtonOptions(precond="ndlu", ndlu_dtype="float64"))
    vals, b = _vals(ts, pt, seed=7)
    vals_lag, _ = _vals(ts, pt, seed=8)
    jnd = jndlu.NDLU(pj.pattern, leaf_max=96, dtype=jnp.float64,
                     front_lu="pallas", invert=True, defer_dofs=j_saddle(pj),
                     clusters=jndlu.node_clusters(pj))
    return pj, pt, ts.precond, jnd, vals, vals_lag, b


@functools.lru_cache(maxsize=None)
def _direct(dtype):
    """NDLU(invert=False) of both packages at ``dtype`` ("float32" or
    "float64"), deferred by the values' zero diagonals as the tpu_direct
    path orders them."""
    pj, pt, _, _, vals, _, _ = _system()
    defer = tndlu.zero_diag_defer_mask(pt.pattern, vals)
    nd = tndlu.NDLU(pt.pattern, leaf_max=96, dtype=getattr(torch, dtype),
                    invert=False, defer_dofs=defer,
                    clusters=tndlu.node_clusters(pt))
    jnd = jndlu.NDLU(pj.pattern, leaf_max=96, dtype=jnp.dtype(dtype),
                     front_lu="pallas", invert=False, defer_dofs=defer,
                     clusters=jndlu.node_clusters(pj))
    return nd, jnd, nd.factor(torch.as_tensor(vals)), jnd.factor(jnp.asarray(vals))


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def test_ndlu_solve_matches_scipy():
    pj, pt, nd, jnd, vals, _, b = _system()
    x = nd.solve(nd.factor(torch.as_tensor(vals)), torch.as_tensor(b)).numpy()
    pat = pt.pattern
    A = sp.csr_matrix((vals, pat.indices, pat.indptr), shape=(pat.n, pat.n))
    assert _rel(x, spla.spsolve(A.tocsc(), b)) < 1e-9


def test_ndlu_levels_match_pallas_ndlu():
    pj, pt, nd, jnd, vals, _, b = _system()
    assert len(nd.levels) == len(jnd.levels) > 2
    ft = nd.factor(torch.as_tensor(vals))
    fj = jnd.factor(jnp.asarray(vals))
    for lev, (fwd, bwd, X, Y), (jfwd, jbwd, perm, jX, jY) in zip(nd.levels, ft, fj):
        assert perm is None  # goma_tpu factored this level with its kernel
        assert _rel(fwd, jfwd) < 1e-10
        assert _rel(bwd, jbwd) < 1e-10
        if lev.bmax:
            assert _rel(X, jX) < 1e-10
            assert _rel(Y, jY) < 1e-10
    rng = np.random.default_rng(0)
    for r in (b, rng.standard_normal(pt.dofmap.n_dof)):
        xt = nd.solve(ft, torch.as_tensor(r)).numpy()
        xj = np.asarray(jnd.solve(fj, jnp.asarray(r)))
        assert _rel(xt, xj) < 1e-10


def test_factor_is_front_then_factor_level_per_level():
    """``factor`` is ``front`` + ``factor_level`` level by level, Schur
    complements carried up; the smoke run rebuilds each level's real front
    this way to hold the GPU kernel against its twin."""
    pj, pt, nd, jnd, vals, _, b = _system()
    v = torch.as_tensor(vals)
    facs = nd.factor(v)
    S = None
    for li in range(len(nd.levels)):
        F = nd.front(li, v, S)
        fac, S = nd.factor_level(li, F)
        for got, want in zip(fac, facs[li]):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want)


def test_gmres_matches_jax_gmres():
    """Lagged preconditioner (factored at another state) so GMRES takes a
    real number of steps; CSR (ELL) operator in both packages."""
    pj, pt, nd, jnd, vals, vals_lag, b = _system()
    ft = nd.factor(torch.as_tensor(vals_lag))
    fj = jnd.factor(jnp.asarray(vals_lag))
    tell, jell = TEll(pt.pattern), JEll(pj.pattern)
    vt, vj = torch.as_tensor(vals), jnp.asarray(vals)
    kw = dict(tol=1e-10, restart=30, maxiter=120)
    rt = gmres(lambda v: tell.matvec(vt, v), torch.as_tensor(b),
               precond=lambda r: nd.solve(ft, r), **kw)
    rj = jax_gmres(lambda v: jell.matvec(vj, v), jnp.asarray(b),
                   precond=lambda r: jnd.solve(fj, r), **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters) > 3
    assert _rel(rt.x, rj.x) < 1e-10


def test_gmres_restarts_and_counts_like_jax():
    """Unpreconditioned, restart shorter than convergence: several cycles,
    the same total Arnoldi-step count."""
    pj, pt, nd, jnd, vals, _, b = _system()
    n = pt.dofmap.n_dof
    d = np.random.default_rng(2).uniform(1.0, 3.0, n)
    A = sp.diags(d) + 0.05 * sp.random(n, n, density=0.01, random_state=1)
    A = A.tocsr()
    rhs = np.random.default_rng(3).standard_normal(n)
    kw = dict(tol=1e-9, restart=8, maxiter=200)
    rt = gmres(lambda v: torch.as_tensor(A @ v.numpy()), torch.as_tensor(rhs), **kw)
    rj = jax_gmres(lambda v: jnp.asarray(A.toarray()) @ v, jnp.asarray(rhs), **kw)
    assert rt.iters == int(rj.iters) > 8
    assert _rel(rt.x, rj.x) < 1e-10


def test_factor_rejects_levels_outside_kernel_gate():
    """A 1x1 fully-summed block is goma_tpu's library-LU branch, not this
    slice's kernel path (1 < s <= 1000): it raises instead of falling
    back."""
    from goma_tpu_torch.fem.sparsity import build_pattern
    from goma_tpu_torch.solvers.ndlu import NDLU

    nd = NDLU(build_pattern(1, []), dtype=torch.float64, invert=True)
    assert nd.levels[0].smax == 1
    with pytest.raises(NotImplementedError):
        nd.factor(torch.ones(1, dtype=torch.float64))


def test_ndlu_substitution_levels_match_pallas_ndlu():
    """invert=False: per level the packed LU and X = A21 U^-1, Y = L^-1 A12
    against goma_tpu's, and the substitution solve on two right-hand
    sides."""
    pj, pt, _, _, vals, _, b = _system()
    nd, jnd, ft, fj = _direct("float64")
    assert len(nd.levels) == len(jnd.levels) > 2
    for lev, (fwd, bwd, X, Y), (jfwd, jbwd, perm, jX, jY) in zip(nd.levels, ft, fj):
        assert perm is None and fwd is bwd
        assert _rel(fwd, jfwd) < 1e-10
        if lev.bmax:
            assert _rel(X, jX) < 1e-10
            assert _rel(Y, jY) < 1e-10
    rng = np.random.default_rng(1)
    for r in (b, rng.standard_normal(pt.dofmap.n_dof)):
        xt = nd.solve(ft, torch.as_tensor(r)).numpy()
        xj = np.asarray(jnd.solve(fj, jnp.asarray(r)))
        assert _rel(xt, xj) < 1e-10
    # one substitution per level and direction, deepest level first down
    trace = []
    nd.solve(ft, torch.as_tensor(b), trace=trace)
    n_lev = len(nd.levels)
    assert [lower for _, _, lower in trace] == [True] * n_lev + [False] * n_lev
    assert all(lu is ft[li][0] for li, (lu, _, _) in enumerate(trace[:n_lev]))
    pat = pt.pattern
    A = sp.csr_matrix((vals, pat.indices, pat.indptr), shape=(pat.n, pat.n))
    assert _rel(nd.solve(ft, torch.as_tensor(b)).numpy(),
                spla.spsolve(A.tocsc(), b)) < 1e-9


def test_port_substitution_on_goma_tpu_factors():
    """goma_tpu's own factors, carried across by ndlu_factors_from_numpy,
    solved by the port's substitution."""
    _, pt, _, _, _, _, b = _system()
    nd, jnd, _, fj = _direct("float64")
    facs = ndlu_factors_from_numpy(
        [tuple(None if a is None else np.asarray(a) for a in f) for f in fj])
    assert len(facs) == len(nd.levels)
    xt = nd.solve(facs, torch.as_tensor(b)).numpy()
    xj = np.asarray(jnd.solve(fj, jnp.asarray(b)))
    assert _rel(xt, xj) < 1e-12


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lag,sweeps,xtol", [(0.05, 6, 1e-9), (1.0, 3, 1e-5)])
def test_solve_refined_matches_goma_tpu(fused, lag, sweeps, xtol):
    """float32 factors of a lagged operator (``lag`` of the way to another
    state), refined against the fresh float64 operator to 1e-8 through a
    matvec or a fused sweep: the same residual measurements in both
    packages. At lag 0.05 refinement converges (~20x per sweep) and x agrees
    to 1e-9 (reading ~1e-12); at lag 1.0 it diverges, the 0.9 stall test
    stops it, and the unconverged x keeps the float32 factors' rounding
    difference (reading 1.8e-6, limit 1e-5)."""
    pj, pt, _, _, vals, vals_lag, b = _system()
    nd, jnd, _, _ = _direct("float32")
    v_old = vals + lag * (vals_lag - vals)
    ft, fj = nd.factor(torch.as_tensor(v_old)), jnd.factor(jnp.asarray(v_old))
    tell, jell = TEll(pt.pattern), JEll(pj.pattern)
    vt, vj = torch.as_tensor(vals), jnp.asarray(vals)
    calls = {"t": 0, "j": 0}

    def t_mv(v):
        calls["t"] += 1
        return tell.matvec(vt, v)

    def j_mv(v):
        calls["j"] += 1
        return jell.matvec(vj, v)

    def t_sweep(facs, rhs, x):
        r = rhs - t_mv(x)
        return x + nd.solve(facs, r).to(rhs.dtype), torch.linalg.norm(r)

    def j_sweep(facs, rhs, x):
        r = rhs - j_mv(x)
        return x + jnd.solve(facs, r).astype(rhs.dtype), jnp.linalg.norm(r)

    kw = dict(refine=1, rel_tol=1e-8, max_refine=8, return_rel=True)
    xt, relt = nd.solve_refined(ft, torch.as_tensor(b), t_mv,
                                sweep=t_sweep if fused else None, **kw)
    xj, relj = jnd.solve_refined(fj, jnp.asarray(b), j_mv,
                                 sweep=j_sweep if fused else None, **kw)
    assert calls["t"] == calls["j"] == sweeps
    assert _rel(xt.numpy(), xj) < xtol
    assert relt is not None and relj is not None
    assert (relt <= 1e-8) == (lag < 0.5)
    assert abs(relt - relj) <= 1e-6 * relj
    # the fixed sweeps alone, no tolerance: the last iterate is unmeasured,
    # and still carries the float32 factors' rounding difference (readings
    # 8e-9 at lag 0.05, 5e-6 at lag 1.0)
    xt, relt = nd.solve_refined(ft, torch.as_tensor(b), t_mv, refine=2,
                                return_rel=True)
    assert relt is None
    assert _rel(xt.numpy(), np.asarray(jnd.solve_refined(
        fj, jnp.asarray(b), j_mv, refine=2))) < 1e-4


def test_ndlu_substitution_path_not_in_slice():
    """The substitution path is built; the library-LU front branches are
    not in the slice."""
    from goma_tpu_torch.fem.sparsity import build_pattern
    from goma_tpu_torch.solvers.ndlu import NDLU

    assert not NDLU(build_pattern(4, []), invert=False).invert
    for front_lu in ("lax", "pallas"):
        with pytest.raises(NotImplementedError):
            NDLU(build_pattern(4, []), invert=True, front_lu=front_lu)
