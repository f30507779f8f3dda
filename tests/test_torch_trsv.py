"""Front substitution of the PyTorch port against goma_tpu's Pallas kernel.

On the CPU ``goma_tpu_torch.solvers.batched_trsv.batched_trsv`` runs its
plain PyTorch twin; goma_tpu's ``batched_trsv`` runs its Pallas kernel in
interpret mode. Inputs: packed LUs that goma_tpu's ``batched_lu`` (interpret
mode) wrote for seeded random, diagonally weighted fronts, some with a
boosted pivot, and seeded random right-hand sides.

Tolerances, relative to max|x|: float64 1e-12 and float32 1e-5 against the
Pallas kernel (one algorithm: the kernel sums each row's masked products
over all m entries, the twin over the k it needs, so only the summation
order differs over m <= 33 steps); against ``torch.linalg.solve_triangular``
on the same triangle 1e-11 / 1e-4 (another algorithm; the fronts keep
cond(L), cond(U) below ~1e2, so float32 loses at most ~2 digits).

``batched_trsv_blocked_reference`` is plain PyTorch in the CUDA kernel's
blocked order and precision: float64 sums; per block of 32 rows the row sums
against the far columns (three or more blocks back, x rounded to the working
dtype) and against the two nearest blocks (unrounded x), then the
substitution inside the block; the upper sweep multiplies by the reciprocal
pivot. It is held against the Pallas kernel and against the twin at the same
tolerances, and its float32 result must lie no farther from the float64
solution than twice the float32 twin's (the gate the kernel meets on the
card).

The wrapper's launch plan (``_plan``: cluster size, block width, threads,
shared bytes) is pure Python and is checked here at every level shape of the
64x64 cavity and 48x48 buoyant trees and at the edges of the kernel's range.

The CUDA kernel itself runs only on a GPU (there is no interpret mode for
it); its comparison with the twin and of its plan with ``_plan`` is marked
``gpu`` and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers.pallas_lu import batched_lu as jax_batched_lu
from goma_tpu.solvers.pallas_lu import batched_trsv as jax_batched_trsv
from goma_tpu_torch.solvers.batched_trsv import (
    MAX_M, MAX_SMEM, _plan, batched_trsv, batched_trsv_blocked_reference,
    batched_trsv_reference, kernel_plan)

TOL = {np.float64: 1e-12, np.float32: 1e-5}
LIB_TOL = {np.float64: 1e-11, np.float32: 1e-4}


def packed_lu(nn, m, seed, dtype):
    """goma_tpu's packed LU of random diagonally weighted fronts; front 0
    has a decoupled zero pivot, which the GESP boost replaces by tau."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nn, m, m)) + 2.0 * m * np.eye(m)
    if m > 2:
        A[0, m // 2, :] = 0.0
        A[0, :, m // 2] = 0.0
    return np.array(jax_batched_lu(jnp.asarray(A.astype(dtype)),
                                   interpret=True))


# (nn, m) of every nested-dissection level of the 64x64 cavity tree and of
# the 48x48 buoyant tree
CAVITY_LEVELS = [(218, 154), (128, 190), (64, 74), (32, 84), (16, 169),
                 (8, 103), (4, 236), (2, 220), (1, 323)]
BUOYANT_LEVELS = [(58, 165), (128, 256), (64, 92), (32, 116), (16, 170),
                  (8, 171), (4, 345), (2, 216), (1, 437)]
PLAN_EDGES = [(1, 1), (218, 1), (1, 32), (218, 32), (1, 33), (1, 1024),
              (218, 1024)]
SMS = 132


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("m", [1, 7, 33])
def test_twin_matches_pallas_trsv(dtype, lower, m):
    nn = 3
    lu = packed_lu(nn, m, seed=m, dtype=dtype)
    b = np.random.default_rng(100 + m).standard_normal((nn, m)).astype(dtype)
    ref = np.asarray(jax_batched_trsv(jnp.asarray(lu), jnp.asarray(b),
                                      lower=lower, interpret=True))
    got = batched_trsv(torch.as_tensor(lu), torch.as_tensor(b), lower=lower)
    assert got.dtype == torch.from_numpy(lu).dtype
    got = got.numpy()
    assert _rel(got, ref) <= TOL[dtype]
    # the same substitution by the library, on the same triangle
    lib = torch.linalg.solve_triangular(
        torch.as_tensor(lu), torch.as_tensor(b).unsqueeze(2), upper=not lower,
        unitriangular=lower).squeeze(2).numpy()
    assert _rel(got, lib) <= LIB_TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("nn", [1, 5])
@pytest.mark.parametrize("m", [1, 2, 31, 32, 33, 65, 154])
def test_blocked_reference_matches_pallas_and_twin(dtype, lower, nn, m):
    lu = packed_lu(nn, m, seed=m, dtype=dtype)
    b = np.random.default_rng(200 + m).standard_normal((nn, m)).astype(dtype)
    got = batched_trsv_blocked_reference(torch.as_tensor(lu),
                                         torch.as_tensor(b), lower=lower)
    assert got.dtype == torch.from_numpy(lu).dtype and got.shape == (nn, m)
    pallas = np.asarray(jax_batched_trsv(jnp.asarray(lu), jnp.asarray(b),
                                         lower=lower, interpret=True))
    assert _rel(got.numpy(), pallas) <= TOL[dtype]
    twin = batched_trsv_reference(torch.as_tensor(lu), torch.as_tensor(b),
                                  lower=lower)
    assert _rel(got.numpy(), twin.numpy()) <= TOL[dtype]


def test_blocked_reference_block_width_and_inputs():
    """Any block width gives the same substitution (a ragged last block
    too), and the inputs are left as they were."""
    lu = torch.as_tensor(packed_lu(2, 45, seed=3, dtype=np.float64))
    b = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 45)))
    lu0, b0 = lu.clone(), b.clone()
    for lower in (True, False):
        ref = batched_trsv_reference(lu, b, lower=lower)
        for block in (1, 7, 32, 45, 64):
            got = batched_trsv_blocked_reference(lu, b, lower=lower,
                                                 block=block)
            assert _rel(got.numpy(), ref.numpy()) <= 1e-12
        for near in (0, 1, 2, 5):
            got = batched_trsv_blocked_reference(lu, b, lower=lower, block=8,
                                                 near=near)
            assert _rel(got.numpy(), ref.numpy()) <= 1e-12
    assert torch.equal(lu, lu0) and torch.equal(b, b0)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("nn,m", [(5, 154), (2, 323)])
def test_blocked_reference_float32_is_as_accurate_as_the_twin(nn, m, lower):
    """The float64 sums of the kernel's order: the float32 result is at
    most twice as far from the float64 solution as the float32 twin's."""
    lu64 = packed_lu(nn, m, seed=m, dtype=np.float64)
    lu32 = torch.as_tensor(lu64.astype(np.float32))
    b64 = np.random.default_rng(300 + m).standard_normal((nn, m))
    b32 = torch.as_tensor(b64.astype(np.float32))
    exact = batched_trsv_reference(lu32.double(), b32.double(),
                                   lower=lower).numpy()
    got = batched_trsv_blocked_reference(lu32, b32, lower=lower)
    assert got.dtype == torch.float32
    twin = batched_trsv_reference(lu32, b32, lower=lower)
    k64 = _rel(got.double().numpy(), exact)
    t64 = _rel(twin.double().numpy(), exact)
    assert k64 <= 2.0 * max(t64, 2.0 ** -24)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nn,m", CAVITY_LEVELS + BUOYANT_LEVELS + PLAN_EDGES)
def test_plan_fits_the_card(nn, m, dtype):
    cluster, nb, threads, smem = _plan(nn, m, dtype)
    assert nb == 32
    assert threads % 32 == 0 and threads <= 1024
    # a solver, the loaders and at least one updater warp
    assert threads // 32 >= 5
    assert 0 < smem <= MAX_SMEM
    assert cluster >= 1
    if cluster > 1:
        assert nn * cluster <= SMS
    # shared memory holds x and the row sums of every whole block
    esize = 4 if dtype == torch.float32 else 8
    assert smem >= (8 + esize) * (-(-m // nb) * nb)
    # the deep levels (small fronts, more of them than SMs) need two CTAs
    # on an SM to run in one wave
    if nn > SMS and m <= 256:
        assert 2 * smem <= MAX_SMEM and 2 * threads <= 2048


def test_plan_rejects_what_the_kernel_does_not_take():
    assert MAX_M == 1024
    for m in (0, MAX_M + 1):
        with pytest.raises(ValueError):
            _plan(1, m, torch.float32)


def test_twin_divides_by_the_boosted_pivot():
    """The upper sweep divides by the stored pivot: at a boosted zero pivot
    x_k = b_k / tau (its row and column are decoupled)."""
    m = 9
    lu = packed_lu(1, m, seed=5, dtype=np.float64)
    k = m // 2
    tau = lu[0, k, k]
    assert 0 < tau < 1e-6
    b = np.random.default_rng(1).standard_normal((1, m))
    x = batched_trsv(torch.as_tensor(lu), torch.as_tensor(b), lower=False)
    np.testing.assert_allclose(x[0, k].item(), b[0, k] / tau, rtol=1e-14)


def test_wrapper_checks_and_launch_counter():
    """Shapes and dtypes are checked on every device; a CPU tensor runs the
    twin, which is not a launch."""
    lu = torch.as_tensor(packed_lu(2, 5, seed=0, dtype=np.float64))
    b = torch.ones(2, 5, dtype=torch.float64)
    with pytest.raises(ValueError):
        batched_trsv(lu, b[:, :4])
    with pytest.raises(TypeError):
        batched_trsv(lu, b.float())
    before = batched_trsv.launches
    x = batched_trsv(lu, b, lower=True)
    assert batched_trsv.launches == before
    assert torch.equal(x, batched_trsv_reference(lu, b, lower=True))


GPU_SHAPES = [(1, 437), (218, 154), (128, 256), (4, 345), (1, 323), (3, 1),
              (3, 2), (5, 33), (2, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("lower", [True, False])
def test_cuda_kernel_matches_twin(dtype, tol, lower):
    """The hand-written sm_90a kernel against its twin, on the card: the
    top and the deepest level shapes of the cavity and buoyant trees, and
    the edges (one row, two rows, a ragged second block, nearly the largest
    front). One launch per call, inputs unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from goma_tpu_torch.solvers.batched_lu import batched_lu

    for nn, m in GPU_SHAPES:
        rng = np.random.default_rng(m)
        A = rng.standard_normal((nn, m, m)) + 2.0 * m * np.eye(m)
        lu = batched_lu(torch.as_tensor(A, dtype=dtype, device="cuda"))
        b = torch.as_tensor(rng.standard_normal((nn, m)), dtype=dtype,
                            device="cuda")
        lu0, b0 = lu.clone(), b.clone()
        before = batched_trsv.launches
        got = batched_trsv(lu, b, lower=lower)
        torch.cuda.synchronize()
        assert batched_trsv.launches == before + 1
        assert torch.equal(lu, lu0) and torch.equal(b, b0)
        ref = batched_trsv_reference(lu, b, lower=lower)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err <= tol, (nn, m)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_plan_is_the_wrappers(dtype):
    """The library's own launch plan equals ``_plan`` at every level shape
    and edge, and the card can hold at least one such CTA on an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plan is read from the library")
    for nn, m in CAVITY_LEVELS + BUOYANT_LEVELS + PLAN_EDGES:
        plan = kernel_plan(nn, m, dtype)
        assert plan[:4] == _plan(nn, m, dtype), (nn, m)
        assert plan[4] >= (2 if nn > SMS and m <= 256 else 1), (nn, m)
    with pytest.raises(ValueError):
        batched_trsv(torch.zeros(1, MAX_M + 1, MAX_M + 1, dtype=dtype,
                                 device="cuda"),
                     torch.zeros(1, MAX_M + 1, dtype=dtype, device="cuda"))
