"""Front gather of the PyTorch port (``solvers/front_gather.py``) and the
NDLU front assembly built on it, against goma_tpu.

- The plain version against ``jnp.take(v, g, mode="clip")``, the body of
  the TPU kernel ``gather_kernel`` (``pallas_gather`` is defined inside
  ``scripts/attic/exp_front_gather.py::main`` and cannot be imported).
  Exact: a gather moves values, it computes nothing.
- ``NDLU.front`` (slot-map gather + one-hot extend-add + pad identity)
  against goma_tpu's scatter-set fronts (``NDLU._factor_body``,
  ``goma_tpu/solvers/ndlu.py:605-617``, restated here on goma_tpu's own
  level tables) on every level of the 8x8 cavity and the 6x6 buoyant deck,
  given the same children's Schur complements: bit for bit. The scatter-set
  and the gather put the same float32 value in every slot; the one-hot
  products select exactly; the adds are the same IEEE operations. One
  exception, stated: XLA's CPU backend flushes subnormal float32 products
  to zero and PyTorch's CPU matmul keeps them (one slot of the 8x8 cavity
  reads 5.2e-39 against 0), so subnormals count as zero in the
  comparison.

The CUDA kernel runs only on a GPU (there is no interpret mode for it);
its comparison with the plain version is marked ``gpu`` and skips
without one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers import ndlu as jndlu
from goma_tpu.solvers.twolevel import _saddle_mask as j_saddle
from goma_tpu_torch.solvers.front_gather import (front_gather,
                                                 front_gather_reference)
from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver
from test_torch_host import JAX_PKG, TORCH_PKG, buoyant, cavity
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)


def _maps(rng, nv, shape):
    """int32 maps with every kind of index: in range, negative, past the
    end."""
    return rng.integers(-5, nv + 5, size=shape).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1,), (1001,), (24, 128)])
def test_plain_gather_matches_jnp_take_clip(dtype, shape):
    rng = np.random.default_rng(len(shape) * 1000 + shape[0])
    v = np.concatenate([[0.0], rng.standard_normal(300)]).astype(dtype)
    g = _maps(rng, v.shape[0], shape)
    want = np.asarray(jnp.take(jnp.asarray(v), jnp.asarray(g), axis=0,
                               mode="clip"))
    got = front_gather(torch.as_tensor(v), torch.as_tensor(g))
    assert got.dtype == torch.from_numpy(v).dtype and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_and_launch_counter():
    """Device, dtype, shape and contiguity are checked on every device; a
    CPU tensor runs the plain version, which is not a launch."""
    v = torch.arange(6, dtype=torch.float32)
    g = torch.tensor([[0, 5, 9], [-1, 2, 3]], dtype=torch.int32)
    with pytest.raises(TypeError):
        front_gather(v, g.long())
    with pytest.raises(TypeError):
        front_gather(v.half(), g)
    with pytest.raises(ValueError):
        front_gather(v.view(2, 3), g)
    with pytest.raises(ValueError):
        front_gather(v[:0], g)
    with pytest.raises(ValueError):
        front_gather(v, g.t())
    before = front_gather.launches
    out = front_gather(v, g)
    assert front_gather.launches == before
    assert out.tolist() == [[0.0, 5.0, 5.0], [0.0, 2.0, 3.0]]
    assert torch.equal(out, front_gather_reference(v, g))


def _jax_fronts(jnd, vals, S_chain):
    """goma_tpu's front assembly, ``NDLU._factor_body`` lines 605-617: a
    unique-index scatter-set of the CSR values, the one-hot extend-add of
    the children's Schur complements (``S_chain[li]``), identity on pad own
    slots."""
    vals32 = jnp.asarray(vals).astype(jnd.dtype)
    out = []
    for lev, tb, S_prev in zip(jnd.levels, jnd.tabs, S_chain):
        f = lev.smax + lev.bmax
        F = jnp.zeros(lev.nn * f * f, jnd.dtype).at[tb["a_lin"]].set(
            vals32[tb["a_src"]], unique_indices=True).reshape(lev.nn, f, f)
        if S_prev is not None and tb["p0"] is not None:
            hi = jax.lax.Precision.HIGHEST
            for P, idx in ((tb["p0"], tb["i0"]), (tb["p1"], tb["i1"])):
                Sc = jnp.asarray(S_prev)[idx].astype(jnd.dtype)
                F = F + jnp.einsum("qfa,qab,qgb->qfg", P, Sc, P, precision=hi)
        if lev.pad_node.shape[0]:
            F = F.at[tb["pad_node"], tb["pad_slot"], tb["pad_slot"]].add(1.0)
        out.append(np.asarray(F))
    return out


@functools.lru_cache(maxsize=None)
def _decks(name):
    """(goma_tpu Problem, port Problem) and the port's NDLU options."""
    if name == "cavity":
        return cavity(JAX_PKG, 8), cavity(TORCH_PKG, 8), 96
    return buoyant(JAX_PKG, 6), buoyant(TORCH_PKG, 6), 96


@pytest.mark.parametrize("name", ["cavity", "buoyant"])
def test_ndlu_fronts_bit_for_bit_against_scatter_set(name):
    pj, pt, leaf = _decks(name)
    solver = NewtonSolver(pt, NewtonOptions(precond="ndlu", ndlu_leaf_max=leaf))
    nd = solver.precond
    x = torch.as_tensor(0.01 * np.random.RandomState(0).randn(pt.dofmap.n_dof))
    params = pt.base_params()
    _, _, scale, _ = solver._prepare_fast(x, params)
    vals = solver._scaled_vals(x, params, scale)
    jnd = jndlu.NDLU(pj.pattern, leaf_max=leaf, dtype=jnp.float32,
                     front_lu="pallas", invert=True, defer_dofs=j_saddle(pj),
                     clusters=jndlu.node_clusters(pj))
    assert len(nd.levels) == len(jnd.levels) > 2
    vals_ext = nd.front_values(vals)
    fronts, S_chain, S = [], [], None
    for li in range(len(nd.levels)):
        S_chain.append(None if S is None else S.numpy())
        F = nd.front(li, vals_ext, S)
        fronts.append(F.numpy())
        _, S = nd.factor_level(li, F)
    tiny = np.finfo(np.float32).tiny
    for li, (got, want) in enumerate(zip(fronts, _jax_fronts(
            jnd, vals.numpy(), S_chain))):
        assert got.dtype == want.dtype == np.float32
        got = np.where(np.abs(got) < tiny, np.float32(0), got)
        np.testing.assert_array_equal(got, want, err_msg=f"level {li}")


def test_ndlu_slot_maps():
    """Each level's dense slot map holds CSR position + 1 at the level's
    entries and 0 everywhere else; ``front`` refuses raw CSR values."""
    _, pt, leaf = _decks("buoyant")
    nd = NewtonSolver(pt, NewtonOptions(precond="ndlu",
                                        ndlu_leaf_max=leaf)).precond
    for lev, tb in zip(nd.levels, nd.tabs):
        f = lev.smax + lev.bmax
        g = tb["gmap"].numpy()
        assert g.dtype == np.int32 and g.shape == (lev.nn * f * f,)
        np.testing.assert_array_equal(g[lev.a_lin], lev.a_src + 1)
        assert np.count_nonzero(g) == lev.a_lin.shape[0]
    assert sum(lev.a_lin.shape[0] for lev in nd.levels) == pt.pattern.nnz
    with pytest.raises(ValueError):
        nd.front(0, torch.zeros(pt.pattern.nnz, dtype=torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_plain(dtype):
    """The hand-written sm_90a kernel against the plain version on the
    card: a level-sized map with out-of-range indices and a ragged length.
    Exact. A map 4 bytes off 16-byte alignment is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(100_001), dtype=dtype, device="cuda")
    g = torch.as_tensor(_maps(rng, v.numel(), 1_000_003), device="cuda")
    for gg in (g, g[:1001]):
        before = front_gather.launches
        got = front_gather(v, gg)
        torch.cuda.synchronize()
        assert front_gather.launches == before + 1
        assert torch.equal(got, front_gather_reference(v, gg))
    before = front_gather.launches
    with pytest.raises(ValueError, match="aligned"):
        front_gather(v, g[1:])
    assert front_gather.launches == before
