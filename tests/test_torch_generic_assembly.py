"""Generic AD assembly of the PyTorch port (``Equation.residual`` +
``torch.func.vmap(torch.func.jacfwd(...))``) against goma_tpu's
(``jax.vmap(jax.jacfwd(...))``), at seeded random states handed to both
packages.

Tolerances:
- element residuals and Jacobians, float64: 1e-12 relative to each array's
  max — the same integrands in the same dtype; only the summation order of
  the einsums and of forward-mode AD differs (a few ulps, amplified by
  cancellation between terms);
- assembled R and CSR values (transpose-gather combine against goma_tpu's
  segment sums), float64: 1e-12;
- the mixed case (float32 Jacobian): 1e-5 on the float32 arrays. The port
  computes its float32 element Jacobian in float32 throughout; goma_tpu,
  run with x64 on, promotes parts of its integrands to float64 (its
  zero-initialized accumulators), so the two differ by float32 rounding
  (~6e-8) over up to 40-term contractions (readings ~4e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu_torch.interop import materials_from_goma, params_from_numpy
from test_torch_host import JAX_PKG, TORCH_PKG, buoyant, cpu
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)


def _mu(fv, mat, params):
    """A shear-thinning-like viscosity written with operators only, so the
    same callable runs on jax and torch arrays."""
    return 0.05 + 0.01 * fv.val["velocity"][:, 0] ** 2


def _k(fv, mat, params):
    return 1.0 + 0.1 * fv.val["temperature"][:, 0]


def _deck(pkg, case):
    """Small decks, one per group of integrand terms, 2x2 QUAD9."""
    if case == "buoyant":
        return buoyant(pkg, 2, transient=True,
                       extra_mat={"heat_source": 0.3, "species_source": 0.2})
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(2, 2, elem="QUAD9")
    if case == "stabilized":
        eqs = [phys.Momentum(dim=2, supg=0.4),
               phys.Continuity(interp="Q2", pspg=0.3)]
        mat = {"rho": 1.3, "mu": _mu, "mass_source": 0.2,
               "body_force": [0.5, -1.0]}
    elif case == "energy":
        eqs = [phys.Energy(interp="Q2")]
        mat = {"rho": 1.2, "Cp": 0.8, "k": _k, "heat_source": 1.5}
    else:  # two species
        eqs = [phys.Species(n_species=2)]
        mat = {"diffusivity": [1.0, 0.3], "species_source": [0.2, -0.1]}
    prob = fem.Problem(mesh, eqs, mat, **cpu(pkg))
    prob.add_dirichlet("left", eqs[0].var, 0, 1.0)
    prob.finalize()
    return prob


def _params(prob, seed):
    rng = np.random.default_rng(seed)
    n = prob.dofmap.n_dof
    return rng.standard_normal(n), {
        "ct": 3.0, "hist": rng.standard_normal(n), "time": 0.0,
        "dirichlet_val": np.asarray(prob.dirichlet_vals)}


def _jax_params(pj, p):
    out = pj.base_params()
    out["ct"] = jnp.asarray(p["ct"])
    out["hist"] = jnp.asarray(p["hist"])
    return out


def _rel(a_torch, b_jax):
    a = a_torch.detach().numpy()
    b = np.asarray(b_jax)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("case", ["buoyant", "stabilized", "energy", "species"])
def test_element_residual_and_jacobian_match(case):
    pj, pt = _deck(JAX_PKG, case), _deck(TORCH_PKG, case)
    assert not pt._fast_meta  # every block takes the generic path
    x, p = _params(pj, seed=21)
    rj, Jj = jax.jit(lambda xx, pp: pj._elem_rj_parts(xx, pp, pj._tables)[:2])(
        jnp.asarray(x), _jax_params(pj, p))
    rt, Jt, _, rst = pt._elem_rj_parts(torch.as_tensor(x),
                                       params_from_numpy(p, device="cpu"),
                                       pt._tables)
    assert rst == [None]
    assert _rel(rt[0], rj[0]) <= 1e-12
    assert _rel(Jt[0], Jj[0]) <= 1e-12


@functools.lru_cache(maxsize=None)
def _buoyant6(mixed):
    pj, pt = buoyant(JAX_PKG, 6), buoyant(TORCH_PKG, 6)
    if mixed:
        pj.jacobian_dtype = jnp.float32
        pt.jacobian_dtype = torch.float32
    # the operating point of goma_tpu's own buoyant ND test
    # (tests/test_ndlu.py::_buoyant): nonzero T couples the Boussinesq block
    x = 0.01 * np.random.RandomState(0).randn(pj.dofmap.n_dof)
    return pj, pt, x


def test_assemble_buoyant_f64_matches():
    pj, pt, x = _buoyant6(False)
    Rj, vj = pj._assemble_jit(jnp.asarray(x), pj.base_params())
    Rt, vt = pt._assemble(torch.as_tensor(x), pt.base_params())
    assert _rel(Rt, Rj) <= 1e-12
    assert _rel(vt, vj) <= 1e-12


def test_assemble_with_elem_buoyant_mixed_matches():
    """float32 Jacobian: the CSR values that the NDLU factors."""
    pj, pt, x = _buoyant6(True)
    Rj, vj, _ = jax.jit(pj._assemble_with_elem)(jnp.asarray(x), pj.base_params())
    Rt, vt, _ = pt._assemble_with_elem(torch.as_tensor(x), pt.base_params())
    assert vt.dtype == torch.float32
    assert _rel(Rt, Rj) <= 1e-12
    assert _rel(vt, vj) <= 1e-5


def test_assemble_fast_buoyant_mixed_matches():
    """float32 Jacobian: row sums, element Jacobians and the element matvec
    through the generic block's ``g`` gather."""
    pj, pt, x = _buoyant6(True)
    Rj, rsj, auxj = jax.jit(pj._assemble_fast)(jnp.asarray(x), pj.base_params())
    Rt, rst, auxt = pt._assemble_fast(torch.as_tensor(x), pt.base_params())
    assert _rel(Rt, Rj) <= 1e-12
    assert _rel(rst, rsj) <= 1e-5
    assert _rel(auxt[0][0], auxj[0][0]) <= 1e-5
    v = np.random.default_rng(5).standard_normal(pj.dofmap.n_dof)
    scale = 1.0 / np.sqrt(np.asarray(rsj))
    yj = pj.element_matvec(None, auxj, jnp.asarray(scale, jnp.float32),
                           jnp.asarray(scale * v, jnp.float32))
    yt = pt.element_matvec(None, auxt, torch.as_tensor(scale, dtype=torch.float32),
                           torch.as_tensor(scale * v, dtype=torch.float32))
    assert _rel(yt, yj) <= 1e-5


def test_element_matvec_is_the_csr_operator():
    """For a generic block the stored element Jacobians, combined through
    the ``g`` gather, reproduce the assembled CSR values' product (the
    Dirichlet-surgered operator), float64."""
    _, pt, x = _buoyant6(False)
    xt = torch.as_tensor(x)
    _, vals, aux = pt._assemble_with_elem(xt, pt.base_params())
    pat = pt.pattern
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(pat.n))
    rows = torch.as_tensor(pat.rows.astype(np.int64))
    cols = torch.as_tensor(pat.indices.astype(np.int64))
    want = torch.zeros(pat.n, dtype=torch.float64).index_add_(
        0, rows, vals * v[cols])
    got = pt.element_matvec(None, aux, None, v)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


def test_materials_from_goma():
    """Scalars pass through; goma_tpu's ``BoussinesqBodyForce`` and each of
    the property models of physics/materials.py (the eight of
    tests/test_torch_axisym.py's table, with their non-default arguments)
    become the port's class with the same attributes, and the translated
    model gives goma_tpu's value on a seeded quadrature-point state within
    1e-13 (test_torch_axisym.test_property_model_matches_goma_tpu's
    state); an unknown callable still refuses."""
    import goma_tpu.physics.materials as jmat
    import goma_tpu_torch.physics.materials as tmat
    from test_torch_axisym import MODELS, _FV

    mat = materials_from_goma({"rho": 1.0, "mu": 0.71, "k": 2,
                               "body_force": jmat.BoussinesqBodyForce(
                                   [0.0, 7100.0], beta=-1.0, T0=0.5)})
    assert (mat["rho"], mat["mu"], mat["k"]) == (1.0, 0.71, 2)
    bf = mat["body_force"]
    assert isinstance(bf, tmat.BoussinesqBodyForce)
    np.testing.assert_array_equal(bf.gravity, [0.0, 7100.0])
    assert (bf.beta, bf.T0, bf.tvar) == (-1.0, 0.5, "temperature")

    rng = np.random.default_rng(12)
    G = rng.standard_normal((5, 2, 2))
    vals = {"temperature": 400.0 + 20.0 * rng.standard_normal((5, 1)),
            "species": rng.uniform(0.05, 0.5, (5, 1)),
            "bond": rng.uniform(0.1, 0.9, (5, 1))}
    fv_j = _FV(jnp.asarray(G), {k: jnp.asarray(v) for k, v in vals.items()})
    fv_t = _FV(torch.as_tensor(G), {k: torch.as_tensor(v)
                                    for k, v in vals.items()})
    assert len(MODELS) == 8
    for name, kw in MODELS.items():
        mj = getattr(jmat, name)(**kw)
        mt = materials_from_goma({"mu": mj})["mu"]
        assert type(mt) is getattr(tmat, name)
        assert vars(mt) == vars(mj)
        want = np.asarray(mj(fv_j, {}, {}))
        got = mt(fv_t, {}, {}).numpy()
        assert np.abs(got - want).max() <= 1e-13 * max(np.abs(want).max(), 1.0)
    with pytest.raises(NotImplementedError):
        materials_from_goma({"mu": lambda fv, mat, params: 1.0})
