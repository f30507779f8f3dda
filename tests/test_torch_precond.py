"""The preconditioner modules of the PyTorch port against goma_tpu, on the
CPU in float64, through the same numpy inputs:

- ``utils/la.py``: ``gj_inv`` on seeded blocks whose diagonal is made small
  so that partial pivoting must fire (k = 4, 22, 40): equal to goma_tpu's
  to 1e-12 of max|inv| (readings: <= 1e-14); a singular block gives
  non-finite entries in both (its inverse overflows). ``blocked_inv`` and
  ``saddle_split_inv`` at n = 300 with ``max_block`` 128, so that the
  recursion splits twice, to 1e-10 of max|inv|.
- ``BlockJacobi`` and ``Vanka`` factor + apply on the 8x8 cavity and the
  4x4 buoyant deck, on CSR values assembled (by the port) at a seeded
  state and equilibrated by their row sums (as Newton hands them over).
  The port's Vanka applies the unpadded operator; goma_tpu's (with the
  Problem, its padded node-slot layout) must agree to 1e-12 of max|z|
  (readings: ~1e-16).
- ``_fine_to_coarse_weights`` (``cids``, ``wts``, ``nc``, ``n_elliptic``)
  and ``coarse_dof_count`` equal; ``TwoLevel`` restrict/prolong to 1e-14,
  the dense Galerkin ``A_c`` to 1e-13 of max|A_c| (the port sums each
  coarse entry in goma_tpu's order), the V-cycle apply with
  ``coarse_solve="lu"`` to 1e-10 of max|z|; with ``"inv"`` (a float32
  explicit inverse in both, whose rounding the coarse condition number
  amplifies) no farther from the float64 LU apply than twice goma_tpu's.
- ``FieldSplit`` and ``PCDFieldSplit`` applies (PCD's pressure Laplacian
  inverse is float32 in both: 1e-5 of max|z|), ``bicgstab`` on a fixed
  system (the same iterate count and x to 1e-12), ``direct_solve_host``,
  and ``LinearSolveError`` on a singular matrix.

The port runs in one torch thread here (``one_torch_thread``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.fem.sparsity import EllOperator as JEll
from goma_tpu.solvers import linear as jl
from goma_tpu.solvers import pcd as jpcd
from goma_tpu.solvers import twolevel as jtl
from goma_tpu.utils import la as jla
from goma_tpu_torch.fem.sparsity import EllOperator as TEll
from goma_tpu_torch.solvers import linear as tl
from goma_tpu_torch.solvers import pcd as tpcd
from goma_tpu_torch.solvers import twolevel as ttl
from goma_tpu_torch.utils import la as tla
from test_torch_host import JAX_PKG, TORCH_PKG, buoyant, cavity
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)


def t(a):
    return torch.as_tensor(np.array(a))


def close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def decks():
    """(goma_tpu Problem, port Problem, CSR values at a seeded state, a
    seeded vector) for the 8x8 cavity and the 4x4 buoyant deck."""
    rng = np.random.default_rng(7)
    out = {}
    for name, build, n in (("cavity", cavity, 8), ("buoyant", buoyant, 4)):
        pj, pt = build(JAX_PKG, n), build(TORCH_PKG, n)
        x = 0.1 * rng.standard_normal(pj.dofmap.n_dof)
        vals = pt._assemble(t(x), pt.base_params())[1].numpy()
        # symmetrically equilibrated by the row sums, as the Newton loop
        # hands the values to a preconditioner
        rows, cols = pj.pattern.rows, pj.pattern.indices
        d = 1.0 / np.sqrt(np.bincount(rows, np.abs(vals), pj.pattern.n))
        vals = vals * d[rows] * d[cols]
        out[name] = (pj, pt, vals, rng.standard_normal(pj.dofmap.n_dof))
    return out


def pivoting_blocks(k, nb, seed):
    """Seeded (nb, k, k) blocks with a tiny diagonal: the largest entry of
    every column lies off the diagonal, so partial pivoting swaps rows."""
    A = np.random.default_rng(seed).standard_normal((nb, k, k))
    A[:, np.arange(k), np.arange(k)] *= 1e-3
    return A


@pytest.mark.parametrize("k", [4, 22, 40])
def test_gj_inv_matches_goma_tpu(k):
    A = pivoting_blocks(k, 6, seed=k)
    col0 = np.abs(A[:, :, 0])
    assert (col0.argmax(axis=1) != 0).all()  # the first step pivots
    got = tla.gj_inv(t(A)).numpy()
    close(got, jla.gj_inv(jnp.asarray(A)), 1e-12)
    close(got @ A, np.broadcast_to(np.eye(k), A.shape), 1e-9)


def test_gj_inv_singular_block_is_non_finite_in_both():
    """A numerically singular block (last pivot 1e-299 under entries of
    1e12: the inverse overflows) gives non-finite entries in both; a
    pivot at or below 1e-300 is replaced by 1 in both (no inf then)."""
    A = pivoting_blocks(4, 2, seed=3)
    A[1, :3, 3] = 1e12
    A[1, 3] = [0.0, 0.0, 0.0, 1e-299]
    got = tla.gj_inv(t(A)).numpy()
    ref = np.asarray(jla.gj_inv(jnp.asarray(A)))
    assert not np.isfinite(got[1]).all() and not np.isfinite(ref[1]).all()
    close(got[0], ref[0], 1e-12)


@pytest.mark.parametrize("fn", ["blocked_inv", "saddle_split_inv"])
def test_blocked_inverses_recurse_and_match(fn):
    rng = np.random.default_rng(11)
    n, k = 300, 200
    M = rng.standard_normal((n, n)) + 40.0 * np.eye(n)
    args = (k,) if fn == "saddle_split_inv" else ()
    got = getattr(tla, fn)(t(M), *args, max_block=128).numpy()
    ref = np.asarray(getattr(jla, fn)(jnp.asarray(M), *args, max_block=128))
    close(got, ref, 1e-10)
    close(got @ M, np.eye(n), 1e-10)


@pytest.mark.parametrize("deck", ["cavity", "buoyant"])
def test_block_jacobi_matches_goma_tpu(decks, deck):
    pj, pt, vals, r = decks[deck]
    bj = jl.BlockJacobi(pj.pattern, pj.dofmap)
    bt = tl.BlockJacobi(pt.pattern, pt.dofmap, device="cpu")
    for key in bj.tables:
        np.testing.assert_array_equal(bt.tables[key].numpy(), bj.tables[key])
    fj = bj.factor(jnp.asarray(vals))
    ft = bt.factor(t(vals))
    close(ft, fj, 1e-12)
    close(bt.apply(ft, t(r)), bj.apply(fj, jnp.asarray(r)), 1e-12)


@pytest.mark.parametrize("deck", ["cavity", "buoyant"])
def test_vanka_unpadded_apply_matches_goma_tpu_padded(decks, deck):
    pj, pt, vals, r = decks[deck]
    vj = jl.Vanka(pj.pattern, pj.dofmap, problem=pj)
    assert vj.padded  # goma_tpu's default layout on these decks
    vt = tl.Vanka(pt.pattern, pt.dofmap, problem=pt)
    assert not vt.padded
    ft = vt.factor(t(vals))
    # the local inverses against goma_tpu's unpadded factor
    fu = jl.Vanka(pj.pattern, pj.dofmap).factor(jnp.asarray(vals))
    for a, b in zip(ft, fu):
        close(a, b, 1e-12)
    close(vt.apply(ft, t(r)), vj.apply(vj.factor(jnp.asarray(vals)),
                                       jnp.asarray(r)), 1e-12)


@pytest.mark.parametrize("deck", ["cavity", "buoyant"])
def test_coarse_space_equal(decks, deck):
    pj, pt, _, _ = decks[deck]
    for a, b in zip(ttl._fine_to_coarse_weights(pt),
                    jtl._fine_to_coarse_weights(pj)):
        np.testing.assert_array_equal(a, b)
    assert ttl.coarse_dof_count(pt) == jtl.coarse_dof_count(pj)


def test_twolevel_matches_goma_tpu(decks):
    pj, pt, vals, r = decks["cavity"]
    mvj = lambda v, e=JEll(pj.pattern): e.matvec(jnp.asarray(vals), v)  # noqa: E731
    mvt = lambda v, e=TEll(pt.pattern, device="cpu"): e.matvec(t(vals), v)  # noqa: E731
    z = {}
    for cs in ("lu", "inv"):
        kw = dict(smooth_damp=1.0, smoother="vanka", coarse_solve=cs)
        tj, tt = jtl.TwoLevel(pj, **kw), ttl.TwoLevel(pt, **kw)
        fj = tj.factor(jnp.asarray(vals), mvj)
        z[cs] = (tt.apply(tt.factor(t(vals), mvt), t(r)).numpy(),
                 np.asarray(tj.apply(fj, jnp.asarray(r))))
        if cs == "inv":  # goma_tpu keeps its dense A_c beside the inverse
            close(tt.coarse_matrix(t(vals)), fj[1][1], 1e-13)
    assert (tt.nc, tt.n_elliptic) == (tj.nc, tj.n_elliptic)
    rc = np.random.default_rng(5).standard_normal(tt.nc)
    close(tt.restrict(t(r)), tj.restrict(jnp.asarray(r)), 1e-14)
    close(tt.prolong(t(rc)), tj.prolong(jnp.asarray(rc)), 1e-14)
    close(*z["lu"], 1e-10)
    # two float32 explicit inverses of one coarse matrix differ by their
    # rounding times its condition: the port's "inv" apply must be no
    # farther from the float64 LU apply than twice goma_tpu's
    exact = z["lu"][1]
    err_t = np.abs(z["inv"][0] - exact).max()
    err_j = np.abs(z["inv"][1] - exact).max()
    assert 0 < err_t <= 2.0 * err_j, (err_t, err_j)


def test_fieldsplit_matches_goma_tpu(decks):
    pj, pt, vals, r = decks["cavity"]
    sj, st = jl.FieldSplit(pj, mu=0.01), tl.FieldSplit(pt, mu=0.01)
    close(st.inv_shat, sj.inv_shat, 1e-14)
    mvj = lambda v, e=JEll(pj.pattern): e.matvec(jnp.asarray(vals), v)  # noqa: E731
    mvt = lambda v, e=TEll(pt.pattern, device="cpu"): e.matvec(t(vals), v)  # noqa: E731
    close(st.apply(st.factor(t(vals), mvt), t(r)),
          sj.apply(sj.factor(jnp.asarray(vals), mvj), jnp.asarray(r)), 1e-12)


def test_pcd_matches_goma_tpu(decks):
    pj, pt, vals, r = decks["cavity"]
    x = np.random.default_rng(9).standard_normal(pj.dofmap.n_dof)
    kw = dict(mu=0.01, rho=1.0)
    sj, st = jpcd.PCDFieldSplit(pj, **kw), tpcd.PCDFieldSplit(pt, **kw)
    np.testing.assert_array_equal(st.tables["pcd:Apinv"].numpy(),
                                  sj.tables["pcd:Apinv"])
    mvj = lambda v, e=JEll(pj.pattern): e.matvec(jnp.asarray(vals), v)  # noqa: E731
    mvt = lambda v, e=TEll(pt.pattern, device="cpu"): e.matvec(t(vals), v)  # noqa: E731
    fj = sj.factor(jnp.asarray(vals), jnp.asarray(x), 0.5)
    ft = st.factor(t(vals), t(x), 0.5)
    for a, b in zip(ft[1], fj[1]):
        close(a, b, 1e-14)
    close(st.apply((*ft, mvt), t(r)), sj.apply((*fj, mvj), jnp.asarray(r)), 1e-5)


def test_bicgstab_fixed_system_matches_goma_tpu():
    """A 1-D convection-diffusion system, matvec by shifts (elementwise, so
    rounded alike in both), Jacobi-preconditioned."""
    n = 200
    b = np.random.default_rng(13).standard_normal(n)
    lo, di, up = -1.3, 2.6, -0.7

    def mv(v, pkg):
        z = pkg.zeros(1, dtype=v.dtype)
        cat = jnp.concatenate if pkg is jnp else torch.cat
        return di * v + lo * cat([z, v[:-1]]) + up * cat([v[1:], z])

    lj = jl.bicgstab(lambda v: mv(v, jnp), jnp.asarray(b),
                     precond=lambda v: v / di, tol=1e-10)
    lt = tl.bicgstab(lambda v: mv(v, torch), t(b), precond=lambda v: v / di,
                     tol=1e-10)
    assert lt.converged and bool(lj.converged)
    assert lt.iters == int(lj.iters) > 5
    close(lt.x, lj.x, 1e-12)


def test_direct_solve_host_and_singular_matrix(decks):
    pj, pt, vals, r = decks["cavity"]
    x = tl.direct_solve_host(pt.pattern, vals, r)
    np.testing.assert_allclose(x, jl.direct_solve_host(pj.pattern, vals, r),
                               rtol=0, atol=1e-12 * np.abs(x).max())
    bad = vals.copy()
    rows = pt.pattern.rows
    bad[rows == 5] = 0.0  # a zero row
    for pkg in (tl, jl):
        with pytest.raises(pkg.LinearSolveError):
            pkg.direct_solve_host(pt.pattern, bad, r)
