"""Fused Navier-Stokes assembly of the PyTorch port against goma_tpu on the
8x8 cavity at a random state (seeded numpy, handed to both packages):
``_assemble_fast`` (R, element J, row sums), ``_assemble_with_elem`` (CSR
values) and ``element_matvec``.

Tolerances: float64 rtol 1e-12 — the same formulas in the same dtype, only
the summation order of einsums and of the transpose-gather combine differs
(a few ulps, amplified by cancellation in R). The mixed case (float32
Jacobian) rtol 1e-5 on the float32 arrays — float32 has ~6e-8 unit
roundoff and the element contractions sum up to 9x22 terms with
cancellation."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu_torch.interop import params_from_numpy, state_from_numpy
from test_torch_host import JAX_PKG, TORCH_PKG, cavity, cpu
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)


def _transient_cavity(pkg, n):
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9")
    prob = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=True),
                              phys.Continuity(interp="Q1")],
                       {"rho": 1.3, "mu": 0.02}, **cpu(pkg))
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    prob.finalize()
    return prob


def _state(prob, seed):
    rng = np.random.default_rng(seed)
    n = prob.dofmap.n_dof
    params = {"ct": 0.0, "hist": np.zeros(n), "time": 0.0,
              "dirichlet_val": np.asarray(prob.dirichlet_vals)}
    if prob.equations[0][0].transient:
        params["ct"] = 7.5
        params["hist"] = rng.standard_normal(n)
    return rng.standard_normal(n), params


def _jax_params(pj, p):
    out = pj.base_params()
    out["ct"] = jnp.asarray(p["ct"])
    out["hist"] = jnp.asarray(p["hist"])
    return out


CASES = [("steady", None), ("transient", None), ("steady", "f32")]


@functools.lru_cache(maxsize=None)
def _assembled(kind, jac):
    build = (lambda pkg: cavity(pkg, 8)) if kind == "steady" else \
        (lambda pkg: _transient_cavity(pkg, 8))
    pj, pt = build(JAX_PKG), build(TORCH_PKG)
    if jac == "f32":
        pj.jacobian_dtype = jnp.float32
        pt.jacobian_dtype = torch.float32
    x, p = _state(pj, seed=11)
    pjp = _jax_params(pj, p)
    ptp = params_from_numpy(p, device="cpu")
    xt = state_from_numpy(x, device="cpu")
    return pj, pt, jnp.asarray(x), xt, pjp, ptp, (1e-5 if jac else 1e-12)


@pytest.fixture(params=CASES, ids=lambda c: "-".join((c[0], c[1] or "f64")))
def assembled(request):
    return _assembled(*request.param)


def _close(a_torch, b_jax, rtol, what):
    a = a_torch.detach().cpu().numpy()
    b = np.asarray(b_jax)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    scale = max(np.abs(b).max(), 1e-300)
    err = np.abs(a - b).max() / scale
    assert err <= rtol, f"{what}: max rel err {err:.3e} > {rtol:.0e}"


def test_assemble_fast_matches(assembled):
    pj, pt, xj, xt, pjp, ptp, rtol = assembled
    Rj, rsj, auxj = pj._assemble_fast(xj, pjp)
    Rt, rst, auxt = pt._assemble_fast(xt, ptp)
    _close(Rt, Rj, 1e-12, "R")  # the residual is float64 in every case
    _close(rst, rsj, rtol, "row sums")
    _close(auxt[0][0], auxj[0][0], rtol, "element J")


def test_assemble_fast_prep32_matches():
    """The switched-precision prep: the whole pass at the Jacobian dtype."""
    pj, pt, xj, xt, pjp, ptp, rtol = _assembled("steady", "f32")
    Rj, rsj, _ = pj._assemble_fast(xj, pjp, rdt=jnp.float32)
    Rt, rst, _ = pt._assemble_fast(xt, ptp, rdt=torch.float32)
    _close(Rt, Rj, 1e-5, "R (f32)")
    _close(rst, rsj, 1e-5, "row sums (f32)")


def test_assemble_with_elem_vals_match(assembled):
    pj, pt, xj, xt, pjp, ptp, rtol = assembled
    Rj, valsj, _ = pj._assemble_with_elem(xj, pjp)
    Rt, valst, _ = pt._assemble_with_elem(xt, ptp)
    _close(Rt, Rj, 1e-12, "R")
    _close(valst, valsj, rtol, "CSR values")


def test_element_matvec_matches(assembled):
    pj, pt, xj, xt, pjp, ptp, rtol = assembled
    _, rsj, auxj = pj._assemble_fast(xj, pjp)
    _, rst, auxt = pt._assemble_fast(xt, ptp)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(pj.dofmap.n_dof)
    jdt = np.float32 if pt.jacobian_dtype is not None else np.float64
    scale = 1.0 / np.sqrt(np.asarray(rsj))
    yj = pj.element_matvec(None, auxj, jnp.asarray(scale, jdt),
                           jnp.asarray(scale * v, jdt))
    jdt_t = auxt[0][0].dtype
    yt = pt.element_matvec(None, auxt, torch.as_tensor(scale, dtype=jdt_t),
                           torch.as_tensor(scale * v, dtype=jdt_t))
    _close(yt, yj, rtol, "element matvec")


def test_ell_operator_and_row_sums_match(assembled):
    """The port's ELL matvec and |A| row sums on the assembled CSR values
    against goma_tpu's (tolerance as above: gathers summed in another
    order)."""
    from goma_tpu.fem.sparsity import EllOperator as JEll
    from goma_tpu.fem.sparsity import row_sums_ell as j_row_sums
    from goma_tpu_torch.fem.sparsity import EllOperator as TEll
    from goma_tpu_torch.fem.sparsity import row_sums_ell as t_row_sums

    pj, pt, xj, xt, pjp, ptp, rtol = assembled
    _, valsj, _ = pj._assemble_with_elem(xj, pjp)
    _, valst, _ = pt._assemble_with_elem(xt, ptp)
    ej, et = JEll(pj.pattern), TEll(pt.pattern, device="cpu")
    v = np.random.default_rng(9).standard_normal(pj.dofmap.n_dof)
    _close(et.matvec(valst, torch.as_tensor(v, dtype=valst.dtype)),
           ej.matvec(valsj, jnp.asarray(v, valsj.dtype)), rtol, "ELL matvec")
    _close(t_row_sums(valst, et.tables["pos"]),
           j_row_sums(valsj, ej.tables["pos"]), rtol, "ELL row sums")
