"""Quadrature-point field evaluation of the PyTorch port (``fem/fields.py``,
``utils/la.det_and_inv``) against goma_tpu's, float64.

Inputs: one element of a buoyant block (velocity Q2 x2, pressure Q1,
temperature Q2, species Q2 x2) with seeded random local dofs, time
derivatives and node coordinates (the unit square's nodes moved by up to
0.1, so the map is not affine). Tolerance 1e-13 relative to each array's
max: the same closed-form formulas in the same dtype, only the summation
order of the einsums differs (a few ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.fem.fields as jfields
import goma_tpu_torch.fem.fields as tfields
from goma_tpu.utils.la import det_and_inv as j_det_and_inv
from goma_tpu_torch.utils.la import det_and_inv as t_det_and_inv
from test_torch_host import JAX_PKG, TORCH_PKG, cpu
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-13


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _problem(pkg):
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(1, 1, elem="QUAD9")
    prob = fem.Problem(mesh, [phys.Momentum(dim=2), phys.Continuity(),
                              phys.Energy(), phys.Species(n_species=2)],
                       {"rho": 1.0, "mu": 1.0}, **cpu(pkg))
    prob.finalize()
    return prob


@pytest.mark.parametrize("d", [1, 2, 3])
def test_det_and_inv_matches(d):
    J = np.random.default_rng(d).standard_normal((5, 4, d, d)) + 2 * np.eye(d)
    dj, ij = j_det_and_inv(jnp.asarray(J))
    dt, it = t_det_and_inv(torch.as_tensor(J))
    assert _rel(dt.numpy(), dj) <= RTOL
    assert _rel(it.numpy(), ij) <= RTOL
    np.testing.assert_allclose(it.numpy() @ J, np.broadcast_to(np.eye(d), J.shape),
                               atol=1e-12)


def test_block_tables_equal():
    pj, pt = _problem(JAX_PKG), _problem(TORCH_PKG)
    tj, tt = pj.tables[0], pt.tables[0]
    assert (tt.elem_type, tt.dim, tt.nq) == (tj.elem_type, tj.dim, tj.nq)
    for k in ("qwts", "Ng", "dNg"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(tj, k))
    assert sorted(tt.N) == sorted(tj.N)
    for itp in tj.N:
        np.testing.assert_array_equal(tt.N[itp], tj.N[itp])
        np.testing.assert_array_equal(tt.dN[itp], tj.dN[itp])


def test_eval_fieldvars_matches():
    pj, pt = _problem(JAX_PKG), _problem(TORCH_PKG)
    bd = pt.dofmap.blocks[0]
    rng = np.random.default_rng(4)
    q = rng.standard_normal(bd.n_ldof)
    qdot = rng.standard_normal(bd.n_ldof)
    X = pt.mesh.coords[pt.mesh.blocks[0].conn[0]] + \
        0.1 * rng.uniform(-1.0, 1.0, (9, 2))
    fj = jfields.eval_fieldvars(jnp.asarray(q), jnp.asarray(qdot), jnp.asarray(X),
                                pj.tables[0], pj.dofmap.blocks[0].slots,
                                jnp.float64)
    ft = tfields.eval_fieldvars(torch.as_tensor(q), torch.as_tensor(qdot),
                                torch.as_tensor(X), pt.tables[0], bd.slots,
                                torch.float64)
    for k in ("x", "detJ", "wdetJ", "h_elem", "invJ", "X0", "wdetJ0"):
        assert _rel(getattr(ft, k).numpy(), getattr(fj, k)) <= RTOL, k
    assert sorted(ft.val) == sorted(fj.val) == sorted(
        ["velocity", "pressure", "temperature", "species"])
    for d in ("val", "grad", "dot", "phi", "gphi", "gphi0", "grad0"):
        for v in fj.val:
            got, want = getattr(ft, d)[v], getattr(fj, d)[v]
            assert _rel(got.numpy(), want) <= RTOL, (d, v)


def test_fields_outside_slice_raise():
    """Nedelec (N1) tables, refused before the EM slice, are goma_tpu's
    (tests/test_torch_em.py holds their field evaluation). Hermite (H3)
    tables, refused before the shell slice, are goma_tpu's on a bar and
    refused on any other family with goma_tpu's ValueError. A
    mesh-displacement (ALE) variable, refused before the slot coater's
    slice, evaluates (at zero displacement: F = I and the reference frame
    equals the current one)."""
    tn = tfields.build_block_tables("QUAD9", {"N1"}, 3)
    jn = jfields.build_block_tables("QUAD9", {"N1"}, 3)
    np.testing.assert_array_equal(tn.Nvec["N1"], jn.Nvec["N1"])
    np.testing.assert_array_equal(tn.Ncurl["N1"], jn.Ncurl["N1"])
    with pytest.raises(ValueError, match="bar-only"):
        tfields.build_block_tables("QUAD9", {"H3"}, 3)
    tb = tfields.build_block_tables("BAR2", {"H3"}, 3).H3["H3"]
    jb = jfields.build_block_tables("BAR2", {"H3"}, 3).H3["H3"]
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t, j)
    mesh_m, fem, phys = TORCH_PKG
    prob = fem.Problem(mesh_m.rectangle_mesh(1, 1, elem="QUAD9"),
                       [phys.Energy()], device="cpu")
    prob.finalize()
    bd = prob.dofmap.blocks[0]
    ale = [tfields.LocalSlot(tfields.MESH_VAR, 2, "Q2", 9, 0)]
    z = torch.zeros(18, dtype=torch.float64)
    X = torch.as_tensor(prob.mesh.coords[prob.mesh.blocks[0].conn[0]])
    fv = tfields.eval_fieldvars(z, z, X, prob.tables[0], ale, torch.float64)
    eye = torch.eye(2, dtype=torch.float64).expand_as(fv.F)
    assert torch.allclose(fv.F, eye, rtol=0, atol=1e-14)
    assert torch.allclose(fv.wdetJ0, fv.wdetJ, rtol=0, atol=1e-14)
    assert bd.n_ldof == 9
