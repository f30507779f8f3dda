"""The derived nodal fields of the PyTorch port against goma_tpu's
(``post/derived.py``): every catalog entry, ``project_to_nodes`` with a
custom callable, ``residual_nodal_field`` and the porous entries, each on
the same seeded state in both packages, built on the CPU in float64 (the
port in one torch thread); and goma_tpu's tests/test_derived.py decks
(``scripts/split_decks.py``) in both.

Tolerance: each nodal field within 1e-12 of its max |value| (goma_tpu
sums the element contributions on the host with ``np.add.at``, the port on
the device with ``index_add_``: another summation order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import split_decks as sd
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

JAX = sd.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = sd.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _seeded(prob, seed, scale=1.0, var_scale=None):
    """A seeded state: standard normal dofs times ``scale`` (or the
    per-variable scale of ``var_scale``)."""
    x = scale * np.random.default_rng(seed).standard_normal(prob.dofmap.n_dof)
    for var, s in (var_scale or {}).items():
        v = prob.dofmap.var(var)
        for c in range(v.ncomp):
            d = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar(var, c)]
            d = d[d >= 0]
            x[d] *= s
    return x


def _flow(P):
    """Navier-Stokes, energy and one species on a 4 x 3 QUAD9 mesh with a
    temperature-dependent viscosity and density."""
    mesh = P.mesh.rectangle_mesh(4, 3, elem="QUAD9", xlim=(0, 1.3))
    prob = P.Problem(
        mesh, [P.phys.Momentum(2, transient=False), P.phys.Continuity(),
               P.phys.Energy(interp="Q2", transient=False),
               P.phys.Species(n_species=1, transient=False)],
        {"rho": lambda fv, mat, p: 1.5 + 0.1 * fv.val["temperature"][:, 0],
         "mu": lambda fv, mat, p: 0.5 + fv.val["temperature"][:, 0] ** 2,
         "k": 3.0, "diffusivity": 0.7}, **P.kw)
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    prob.finalize()
    return prob


def _flow3d(P):
    mesh = P.mesh.box_mesh(2, 2, 1, elem="HEX27")
    prob = P.Problem(mesh, [P.phys.Momentum(3, transient=False),
                            P.phys.Continuity()], {"rho": 1.0, "mu": 0.3},
                     **P.kw)
    prob.finalize()
    return prob


def _solid(P):
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.RealSolid(dim=2, model="linear")],
                     {"lame_mu": 2.0, "lame_lambda": 3.0}, **P.kw)
    prob.finalize()
    return prob


def _voltage(P):
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
    prob = P.Problem(mesh, [P.phys.Potential(interp="Q1")], {"kappa": 1.0},
                     **P.kw)
    prob.finalize()
    return prob


def _fill(P):
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.FillEquation(interp="Q2")], {}, **P.kw)
    prob.finalize()
    return prob


def _porous(P):
    mesh = P.mesh.rectangle_mesh(4, 4, elem="QUAD4")
    prob = P.Problem(mesh, [P.phys.PorousFlow(
        model=P.phys.VanGenuchten(alpha=1.5, n=2.0), interp="Q1",
        transient=False)], {"permeability": 0.8, "mu": 1.7}, **P.kw)
    prob.finalize()
    return prob


def _ale(P):
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.LinearElasticMesh(dim=2),
                            P.phys.Species(n_species=2, transient=False,
                                           convection=False)],
                     {"diffusivity": 2.0}, **P.kw)
    prob.add_dirichlet("left", "mesh_displacement", 0, 0.0)
    prob.finalize()
    return prob


# (problem builder, seed, state scale or per-variable scales)
DECKS = {"flow": (_flow, 1, {"temperature": 0.3}),
         "flow3d": (_flow3d, 2, {}), "solid": (_solid, 3, {}),
         "voltage": (_voltage, 4, {}), "fill": (_fill, 5, {}),
         "porous": (_porous, 6, {}),
         "ale": (_ale, 7, {"mesh_displacement": 0.03})}
ENTRIES = {
    "flow": ("VORTICITY", "CURL_V", "SHEAR_RATE", "MEAN_SHEAR",
             "DIV_VELOCITY", "PRESSURE_NODAL", "STRESS_TENSOR",
             "ENERGY_FLUX", "CONDUCTION_VECTORS", "SPEED", "KINETIC_ENERGY",
             "DENSITY", "VISCOSITY", "DIFFUSION_VECTORS", "NS_RESIDUALS"),
    "flow3d": ("VORTICITY", "STRESS_TENSOR", "DIV_VELOCITY"),
    "solid": ("VON_MISES_STRESS",),
    "voltage": ("ELECTRIC_FIELD", "ELECTRIC_FIELD_MAG"),
    "fill": ("LS_NORMAL",),
    "porous": ("DARCY_VELOCITY", "POROUS_SATURATION", "CAPILLARY_PRESSURE",
               "REL_LIQ_PERM"),
    "ale": ("STRAIN_TENSOR", "FIRST_INVAR_STRAIN", "SEC_INVAR_STRAIN",
            "DIFFUSION_VECTORS", "MM_RESIDUALS"),
}


@functools.lru_cache(maxsize=None)
def deck(name):
    """(goma_tpu's problem, the port's, the seeded state)."""
    build, seed, scales = DECKS[name]
    pj, pt = build(JAX), build(TORCH)
    return pj, pt, _seeded(pj, seed, var_scale=scales)


def test_catalog_is_goma_tpus():
    import goma_tpu.post.derived as jd
    import goma_tpu_torch.post.derived as td

    assert sorted(td.CATALOG) == sorted(jd.CATALOG)
    assert td._POROUS == jd._POROUS
    tested = {e for v in ENTRIES.values() for e in v}
    assert tested >= set(jd.CATALOG) | set(jd._POROUS) - {"STREAM"}


@pytest.mark.parametrize("name,entry", [(d, e) for d, es in ENTRIES.items()
                                        for e in es])
def test_catalog_entry(name, entry):
    pj, pt, x = deck(name)
    a = JAX.derived.derived_nodal_field(pj, x, entry)
    b = TORCH.derived.derived_nodal_field(pt, x, entry)
    assert isinstance(b, np.ndarray)
    assert np.all(np.isfinite(b))
    assert _rel(b, a) <= RTOL, (entry, _rel(b, a))


def test_stream_function_entry():
    """STREAM routes to ``post.stream_function`` in both packages."""
    pj, pt, _ = deck("flow")
    x = pj.set_nodal_field(np.zeros(pj.dofmap.n_dof), "velocity", 0,
                           lambda X: X[:, 1] * (1 - X[:, 1]) * X[:, 0])
    x = pj.set_nodal_field(x, "velocity", 1, lambda X: -X[:, 0] ** 2)
    a = JAX.derived.derived_nodal_field(pj, x, "STREAM")
    b = TORCH.derived.derived_nodal_field(pt, x, "STREAM")
    assert _rel(b, a) <= 1e-10


@pytest.mark.parametrize("ncomp", [None, 1])
def test_project_to_nodes_custom_callable(ncomp):
    """A deck's own callable, (nq, 2) and (nq,), with params read inside."""
    pj, pt, x = deck("flow")

    def two(fv, mat, params):
        xp = jnp if isinstance(fv.x, jnp.ndarray) else torch
        T = fv.val["temperature"][:, 0]
        return xp.stack([fv.x[:, 0] * T, fv.grad["velocity"][:, 0, 1]
                         + params["ct"]], 1)

    def one(fv, mat, params):
        return fv.x[:, 1] ** 2 + fv.val["pressure"][:, 0]

    fn = two if ncomp is None else one
    a = JAX.derived.project_to_nodes(pj, x, fn, ncomp=ncomp)
    b = TORCH.derived.project_to_nodes(pt, x, fn, ncomp=ncomp)
    assert b.shape == a.shape == ((pj.mesh.n_nodes, 2) if ncomp is None
                                  else (pj.mesh.n_nodes,))
    assert _rel(b, a) <= RTOL


def test_project_to_nodes_takes_a_tensor_and_params():
    """x as a tensor on the problem's device and a transient params dict
    (ct, hist): the same field as from host numpy."""
    pj, pt, x = deck("flow")
    pa = pj.base_params()
    pa["ct"] = jnp.asarray(20.0)
    pa["hist"] = jnp.asarray(-20.0 * x)
    pb = pt.base_params()
    pb["ct"] = torch.tensor(20.0, dtype=torch.float64)
    pb["hist"] = torch.as_tensor(-20.0 * x)

    def dot(fv, mat, params):
        return fv.dot["temperature"][:, 0] + fv.val["temperature"][:, 0]

    a = JAX.derived.project_to_nodes(pj, x, dot, params=pa)
    b = TORCH.derived.project_to_nodes(pt, torch.as_tensor(x), dot, params=pb)
    assert _rel(b, a) <= RTOL


@pytest.mark.parametrize("name,var", [("flow", "velocity"),
                                      ("flow", "temperature"),
                                      ("ale", "mesh_displacement")])
def test_residual_nodal_field(name, var):
    pj, pt, x = deck(name)
    a = JAX.derived.residual_nodal_field(pj, x, var)
    b = TORCH.derived.residual_nodal_field(pt, x, var)
    assert b.shape == (pj.mesh.n_nodes, pj.dofmap.var(var).ncomp)
    assert _rel(b, a) <= RTOL


def test_porous_entry_needs_a_saturation_model():
    _, pt, x = deck("flow")
    with pytest.raises(KeyError, match="saturation model"):
        TORCH.derived.derived_nodal_field(pt, x, "POROUS_SATURATION")


@pytest.mark.parametrize("name", [k for k in sd.SMALL
                                  if k.startswith("derived_")])
def test_goma_tpu_derived_decks(name):
    """goma_tpu's tests/test_derived.py decks (their own gates inside) in
    both packages: the same readings and fields within 1e-12."""
    a, b = sd.SMALL[name](JAX), sd.SMALL[name](TORCH)
    assert _rel(b["reading"], a["reading"]) <= RTOL
    assert _rel(b["x"], a["x"]) <= RTOL
