"""Front LU of the PyTorch port against goma_tpu's Pallas kernel.

On the CPU ``goma_tpu_torch.solvers.batched_lu.batched_lu`` runs its plain
PyTorch twin; goma_tpu's ``batched_lu`` runs its Pallas kernel in interpret
mode. Inputs: seeded random fronts whose tiny, zero and negative pivots make
the GESP boost fire (on decoupled rows/columns, so the boost creates no
element growth that would turn rounding into noise), and the real
deepest-level fronts of the 6x6 cavity's nested-dissection factor.
Tolerances, relative to max|LU|: float64 1e-12 and float32 1e-5 — one
algorithm, the same operations; only FMA contraction and rounding of the
rank-1 updates may differ over m <= ~100 steps.

The CUDA kernel itself runs only on a GPU (there is no interpret mode for
it); its comparison with the twin is marked ``gpu`` and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers.pallas_lu import batched_lu as jax_batched_lu
from goma_tpu_torch.solvers.batched_lu import (MAX_SMEM, _plan, batched_lu,
                                               batched_lu_reference,
                                               kernel_plan)
from test_torch_host import TORCH_PKG, cavity

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def boosted_fronts(nn, m, seed):
    """Random fronts, diagonally weighted, with decoupled pivots that are
    exactly zero, tiny positive and tiny negative (each fires the boost),
    plus negative regular pivots."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nn, m, m))
    d = np.arange(m)
    A[:, d, d] += np.where(rng.random((nn, m)) < 0.3, -2.0, 2.0) * m
    for k, v in ((0, 0.0), (m // 3, 1e-13), (m // 2, -1e-14), (m - 1, 0.0)):
        A[:, k, :] = 0.0
        A[:, :, k] = 0.0
        A[:, k, k] = v
    return A


def cavity_fronts(n=6, seed=3):
    """Deepest-level fronts (nn, s, s) of the NDLU factor of the n x n
    cavity's equilibrated Jacobian at a random state whose velocities stay
    below the lid speed (amplitude 0.3). Random O(1) noise would make the
    unpivoted fronts grow ~250x, which a float32 comparison cannot
    separate from its own rounding."""
    from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver

    prob = cavity(TORCH_PKG, n)
    solver = NewtonSolver(prob, NewtonOptions(precond="ndlu", ndlu_leaf_max=48))
    x = torch.as_tensor(0.3 * np.random.default_rng(seed).standard_normal(
        prob.dofmap.n_dof))
    params = prob.base_params()
    _, _, scale, _ = solver._prepare_fast(x, params)
    vals = solver._scaled_vals(x, params, scale)
    nd = solver.precond
    s = nd.levels[0].smax
    return nd.front(0, nd.front_values(vals)).numpy()[:, :s, :s]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nn,m", [(3, 17), (2, 40)])
def test_twin_matches_pallas_on_boosted_fronts(dtype, nn, m):
    A = boosted_fronts(nn, m, seed=m).astype(dtype)
    ref = np.asarray(jax_batched_lu(jnp.asarray(A), interpret=True))
    got = batched_lu(torch.as_tensor(A)).numpy()
    assert got.dtype == dtype
    assert _rel(got, ref) <= TOL[dtype]
    # every boosted pivot is +-tau with tau from the ORIGINAL diagonal
    tau = dtype(1e-8) * np.abs(np.diagonal(A, axis1=1, axis2=2)).max(axis=1)
    diag = np.diagonal(got, axis1=1, axis2=2)
    np.testing.assert_allclose(diag[:, 0], tau, rtol=1e-6)
    np.testing.assert_allclose(diag[:, m // 3], tau, rtol=1e-6)
    np.testing.assert_allclose(diag[:, m // 2], -tau, rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twin_matches_pallas_on_cavity_fronts(dtype):
    A = cavity_fronts().astype(dtype)
    assert A.shape[0] > 1 and A.shape[1] > 1
    ref = np.asarray(jax_batched_lu(jnp.asarray(A), interpret=True))
    got = batched_lu(torch.as_tensor(A)).numpy()
    assert _rel(got, ref) <= TOL[dtype]


def test_twin_is_an_lu_factorization():
    """L @ U reproduces the front where no boost fired."""
    A = boosted_fronts(2, 30, seed=1)
    lu = batched_lu(torch.as_tensor(A)).numpy()
    L = np.tril(lu, -1) + np.eye(30)
    U = np.triu(lu)
    keep = np.ones(30, bool)
    keep[[0, 10, 15, 29]] = False  # the boosted (decoupled) pivots
    LU = L @ U
    np.testing.assert_allclose(LU[:, keep][:, :, keep], A[:, keep][:, :, keep],
                               atol=1e-12 * np.abs(A).max())


def test_launch_counter_counts_only_kernel_launches():
    """On a CPU tensor the wrapper runs the twin, which is not a launch."""
    before = batched_lu.launches
    batched_lu(torch.as_tensor(boosted_fronts(1, 5, seed=0)))
    assert batched_lu.launches == before


# every (nn, m) level shape of the 64x64 cavity tree and the 48x48 buoyant
# tree, and the ends of NDLU's gate 1 < m <= 1000
CAVITY_LEVELS = [(218, 154), (128, 190), (64, 74), (32, 84), (16, 169),
                 (8, 103), (4, 236), (2, 220), (1, 323)]
BUOYANT_LEVELS = [(58, 165), (128, 256), (64, 92), (32, 116), (16, 170),
                  (8, 171), (4, 345), (2, 216), (1, 437)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nn,m", CAVITY_LEVELS + BUOYANT_LEVELS
                         + [(1, 2), (1, 1000)])
def test_launch_plan_fits_the_card(nn, m, dtype):
    """The cluster fills at most the 132 SMs, the panel rows fit the block
    (two rows a thread) and the shared memory fits one CTA."""
    cluster, nb, threads, smem = _plan(nn, m, dtype)
    assert cluster in (1, 2, 4, 8, 16)
    assert cluster == 1 or nn * cluster <= 132
    assert cluster == 1 or m > nb
    assert nb == (32 if dtype == torch.float32 else 16)
    assert threads in (128, 256, 512) and m <= 2 * threads
    assert smem <= MAX_SMEM


def test_launch_plan_fills_the_top_levels():
    """The top levels of the trees get more than one CTA per front."""
    assert [_plan(nn, m, torch.float32)[0] for nn, m in BUOYANT_LEVELS] == \
        [2, 1, 2, 4, 8, 16, 16, 16, 16]
    assert _plan(1, 32, torch.float32)[0] == 1  # a single panel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)])
def test_cuda_kernel_matches_twin(dtype, tol):
    """The hand-written sm_90a kernel against its twin, on the card: the
    main paths' largest shapes, a ragged last panel (m = 33), the smallest
    and largest m of the gate. The input stays unchanged and every boosted
    pivot is +-tau."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for nn, m in ((218, 154), (1, 323), (1, 437), (4, 345), (2, 216),
                  (128, 256), (3, 2), (5, 33), (1, 1000)):
        A = torch.as_tensor(boosted_fronts(nn, m, seed=m), dtype=dtype,
                            device="cuda")
        A0 = A.clone()
        before = batched_lu.launches
        got = batched_lu(A)
        torch.cuda.synchronize()
        assert batched_lu.launches == before + 1
        assert torch.equal(A, A0)
        ref = batched_lu_reference(A)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err <= tol, (nn, m, err)
        tau = 1e-8 * A.diagonal(dim1=1, dim2=2).abs().amax(dim=1)
        diag = got.diagonal(dim1=1, dim2=2)
        # the decoupled pivots are untouched by earlier steps: each one
        # below tau is boosted to +-tau by the sign of its original value
        for k in {0, m // 3, m // 2, m - 1}:
            a = A0[:, k, k]
            want = torch.where(a.abs() < tau,
                               torch.where(a < 0, -tau, tau), a)
            torch.testing.assert_close(diag[:, k], want, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_cuda_plan_matches_the_library():
    """The wrapper's plan is the one the compiled kernel launches with."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dtype in (torch.float32, torch.float64):
        for nn, m in CAVITY_LEVELS + BUOYANT_LEVELS + [(1, 2), (1, 1000)]:
            got = kernel_plan(nn, m, dtype)
            assert got[:4] == _plan(nn, m, dtype)
            assert got[4] >= 1
