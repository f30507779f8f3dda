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

The CUDA kernel itself runs only on a GPU (there is no interpret mode for
it); its comparison with the twin is marked ``gpu`` and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers.pallas_lu import batched_lu as jax_batched_lu
from goma_tpu.solvers.pallas_lu import batched_trsv as jax_batched_trsv
from goma_tpu_torch.solvers.batched_trsv import (batched_trsv,
                                                 batched_trsv_reference)

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("lower", [True, False])
def test_cuda_kernel_matches_twin(dtype, tol, lower):
    """The hand-written sm_90a kernel against its twin, on the card, at the
    largest and the widest level shapes of the 64x64 deck."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from goma_tpu_torch.solvers.batched_lu import batched_lu

    for nn, m in ((218, 154), (1, 323)):
        rng = np.random.default_rng(m)
        A = rng.standard_normal((nn, m, m)) + 2.0 * m * np.eye(m)
        lu = batched_lu(torch.as_tensor(A, dtype=dtype, device="cuda"))
        b = torch.as_tensor(rng.standard_normal((nn, m)), dtype=dtype,
                            device="cuda")
        before = batched_trsv.launches
        got = batched_trsv(lu, b, lower=lower)
        torch.cuda.synchronize()
        assert batched_trsv.launches == before + 1
        ref = batched_trsv_reference(lu, b, lower=lower)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err <= tol
