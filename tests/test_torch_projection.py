"""The projection (pressure-correction) split of the PyTorch port against
goma_tpu's: ``physics/projection_ns.py``'s ``UStar`` and
``PressureIncrement`` (R and the CSR values at seeded states and external
fields) and ``solvers/projection.py``'s ``ProjectionSolver`` (the
projection cavity of ``scripts/split_decks.py`` cut to 6 x 6 on host
``direct`` and ``tpu_direct``, and goma_tpu's tests/test_projection.py
Poiseuille start-up), built on the CPU in float64 (the port in one torch
thread).

Tolerances: R and the CSR values within 1e-12 of each array's max (goma_tpu's
jitted ``assemble``); the runs' u and p within 1e-10 of max |x|, the same
Newton counts every step; goma_tpu's analytic gates (4e-3 at t = 0.2, 2e-3
at the steady parabola) on the port's Poiseuille run.
"""

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


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _swirl(fv, mat, params):
    """A body force of position (a deck's callable)."""
    xp = jnp if isinstance(fv.x, jnp.ndarray) else torch
    return xp.stack([fv.x[:, 1] ** 2, -fv.x[:, 0]], 1)


def _problem(P, eq, body_force):
    import importlib

    pns = importlib.import_module(f"{P.pkg}.physics.projection_ns")
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9", xlim=(0, 1.5))
    mat = {"rho": 1.3, "mu": 0.2}
    if body_force is not None:
        mat["body_force"] = body_force
    if eq == "ustar":
        prob = P.Problem(mesh, [pns.UStar(dim=2)], mat,
                         external_fields=("u_old", "v_old", "p_old"), **P.kw)
        prob.add_dirichlet("top", "ustar", 0, 1.0)
    else:
        prob = P.Problem(mesh, [pns.PressureIncrement()], mat,
                         external_fields=("us", "vs"), **P.kw)
        prob.add_dirichlet("left", "pphi", 0, 0.0)
    prob.finalize()
    return prob


def _state(P, prob, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(prob.dofmap.n_dof)
    ext = {f"ext_{n}": rng.standard_normal(prob.mesh.n_nodes)
           for n in prob.external_fields}
    params = prob.base_params(**{k: P.arr(v) for k, v in ext.items()})
    params["dt"] = P.arr(np.float64(0.05))
    return x, params


@pytest.mark.parametrize("eq,body_force", [
    ("ustar", None), ("ustar", (0.7, -2.0)), ("ustar", _swirl),
    ("pphi", None)])
def test_assembled_system_matches(eq, body_force):
    """R and the CSR values of ``UStar`` (lagged advection and pressure,
    no, a constant and a callable body force) and ``PressureIncrement`` at
    a seeded state and seeded external fields."""
    out = []
    for P in (JAX, TORCH):
        prob = _problem(P, eq, body_force)
        x, params = _state(P, prob, 3)
        R, vals = prob.assemble(P.arr(x), params)
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.abs(Rj).max() > 0 and np.abs(Vj).max() > 0
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


def _cavity_run(P, kind):
    opts = None if kind == "direct" else P.NewtonOptions(
        max_iter=sd.PROJ_MAX_ITER, tol_residual=1e-9,
        linear_solver="tpu_direct", ndlu_leaf_max=192, ndlu_refine=1)
    ps = sd.projection_cavity(P, 6, opts)
    res, counts = sd.run_projection(P, ps, steps=3, dt=sd.PROJ_DT)
    return res, counts


@pytest.mark.parametrize("kind", ["direct", "tpu_direct"])
def test_projection_cavity_steps(kind):
    """Three steps of the projection cavity (6 x 6) on host ``direct``
    (ProjectionSolver's default) and ``tpu_direct``: the same Newton counts
    a step and u, p within 1e-10 of max |x|."""
    (rj, cj), (rt, ct) = _cavity_run(JAX, kind), _cavity_run(TORCH, kind)
    assert ct == cj
    assert rt.t == pytest.approx(rj.t, abs=1e-15)
    xj = np.concatenate([rj.u.ravel(), rj.p])
    xt = np.concatenate([rt.u.ravel(), rt.p])
    assert np.abs(rj.u).max() > 0.5
    assert _rel(xt, xj) <= 1e-10


def test_projection_poiseuille():
    """goma_tpu's tests/test_projection.py start-up in both packages: its
    analytic gates (4e-3 at t = 0.2, 2e-3 at the steady parabola, |v| <
    2e-3) inside the deck, on each package's run; the same Newton count and
    u, p within 1e-10 of max |x| after both legs."""
    oj, ot = sd.projection_poiseuille(JAX), sd.projection_poiseuille(TORCH)
    assert ot["newton"] == oj["newton"]
    assert _rel(ot["x"], oj["x"]) <= 1e-10
    assert ot["reading"][0] < 4e-3
