"""The PyTorch port's Newton solver with goma_tpu's other preconditioners
and linear solvers, against goma_tpu on the CPU in float64, on the 8x8
Re=100 lid-driven cavity (``tol_residual=1e-8``, x = 0) and the 4x4
buoyant deck:

- every option below: goma_tpu's preconditioner kind, goma_tpu's Newton
  iteration count, x within 1e-10, and goma_tpu's linear iterations per
  step EXACTLY (readings: equal on every step; the port's unpadded Vanka
  apply rounds like goma_tpu's padded one closely enough), except:
  ``pcd`` within 20 per step (its dense Ap inverse is applied in float32,
  whose product XLA and torch round differently; goma_tpu's own counts
  move by up to 18 under a 1e-7 relative perturbation of Fp; readings
  [129, 159, 127, 107, 132] against [128, 143, 129, 107, 131]) and
  ``coarse_solve="inv"`` within 2 (a float32 explicit coarse inverse in
  both, whose rounding moves with the BLAS thread count: readings [43,
  61, 55, 44, 54] in eight torch threads, [42, 62, 55, 41, 54] in one,
  against [42, 60, 55, 43, 55]);
- ``bicgstab``: goma_tpu runs ``_linsolve_bicgstab`` under ``jax.jit``, so
  its lag test and the Newton state it factors from are frozen at trace
  time: every call refactors from the first state's Jacobian. The port
  keeps ``precond_lag``'s lagged factor, so it is held against goma_tpu's
  own code run eagerly (unjitted): the first solve hits ``linear_maxiter``
  (600) in both, later solves within 3 (BiCGStab moves by up to 3 under a
  1e-15 perturbation of the smoother; readings [600, 47, 42, 34, 38]
  against [600, 45, 40, 35, 39]); goma_tpu as it runs reads [600, 54, 55,
  52, 55], 5 Newton iterations as both here;
- ``row_scaling=False`` on the host ``direct`` rung (the full prep with
  R unscaled): equal iterations, x within 1e-10;
- ``NewtonSolver(problem)`` picks goma_tpu's kind: ``twolevel`` on the
  cavity, ``block_jacobi`` on a Q1-only scalar deck (nc = n);
- the port runs in one torch thread here (``one_torch_thread``), as the
  other multi-deck files do: beside other test workers its small
  contractions lose more to thread hand-offs than they gain;
- the buoyant deck on bench.py's third rung (``twolevel``,
  ``smooth_sweeps=1``, restart 160, tol 1e-6): equal Newton iterations,
  linear iterations within 1 per step (readings one fewer from the second
  step on: the Hessenberg least squares is an LU solve in the port and
  Gauss-Jordan in goma_tpu, and this deck's hydrostatic pressure head
  makes the step sensitive to that rounding), x within 1e-5 + 1e-6 |x|;
- ``reset_lagged`` drops a two-level factor.
"""

import numpy as np
import pytest

from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_host import JAX_PKG, TORCH_PKG, buoyant, cavity
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(tol_residual=1e-8)


@pytest.fixture(scope="module")
def pair():
    return cavity(JAX_PKG, 8), cavity(TORCH_PKG, 8)


def run(pair, kw, coarse_solve=None, eager_bicgstab=False):
    pj, pt = pair
    sj, st = JSolver(pj, JOptions(**kw)), NewtonSolver(pt, NewtonOptions(**kw))
    if coarse_solve:
        sj.precond.coarse_solve = st.precond.coarse_solve = coarse_solve
    if eager_bicgstab:
        sj._solve_bicgstab = sj._linsolve_bicgstab
    rj = sj.solve(np.zeros(pj.dofmap.n_dof), pj.base_params())
    rt = st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params())
    assert st._precond_kind == sj._precond_kind
    return rj, rt


@pytest.mark.parametrize("kw,coarse_solve,lin_tol", [
    ({}, None, 0),  # auto -> twolevel, Vanka smoother
    (dict(precond="twolevel", smoother="bj"), None, 0),
    (dict(precond="block_jacobi"), None, 0),
    (dict(precond="fieldsplit"), None, 0),
    (dict(precond="pcd"), None, 20),
    (dict(linear_solver="direct"), None, 0),
    (dict(precond_dtype="bf16"), None, 0),
    (dict(precond_dtype="bf16-coarse"), None, 0),
    ({}, "inv", 2),
    (dict(linear_solver="direct", row_scaling=False), None, 0),
    (dict(precond="twolevel", row_scaling=False), None, 0),
], ids=["auto", "twolevel_bj", "block_jacobi", "fieldsplit", "pcd",
        "direct", "bf16", "bf16_coarse", "coarse_inv", "direct_unscaled",
        "twolevel_unscaled"])
def test_newton_options_match_goma_tpu(pair, kw, coarse_solve, lin_tol):
    rj, rt = run(pair, dict(TOL, **kw), coarse_solve)
    assert rj.converged and rt.converged, (rt.summary(), rj.summary())
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    assert len(rt.linear_iters) == len(rj.linear_iters)
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= lin_tol, (rt.linear_iters, rj.linear_iters)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-10)


def test_bicgstab_matches_goma_tpu(pair):
    kw = dict(TOL, linear_solver="bicgstab")
    rj, rt = run(pair, kw, eager_bicgstab=True)
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    assert rt.linear_iters[0] == rj.linear_iters[0] == 600  # linear_maxiter
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= 3, (rt.linear_iters, rj.linear_iters)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-10)


def test_default_options_pick_goma_tpus_preconditioner(pair):
    """NewtonSolver(problem) with no options is NewtonOptions(): two-level
    on the cavity (nc = 243 of n = 659), block Jacobi on a Q1-only scalar
    deck (every dof is coarse)."""
    pj, pt = pair
    assert NewtonSolver(pt)._precond_kind == JSolver(pj)._precond_kind == "twolevel"
    assert NewtonSolver(pt).opts == NewtonOptions()

    def heat(pkg):
        mesh_m, fem, phys = pkg
        kw = {"device": "cpu"} if pkg is TORCH_PKG else {}
        prob = fem.Problem(mesh_m.rectangle_mesh(4, 4, elem="QUAD4"),
                           [phys.Energy(interp="Q1", transient=False)],
                           {"k": 1.0, "rho": 1.0, "Cp": 1.0}, **kw)
        prob.add_dirichlet("left", "temperature", 0, 1.0)
        prob.finalize()
        return prob

    assert (NewtonSolver(heat(TORCH_PKG))._precond_kind
            == JSolver(heat(JAX_PKG))._precond_kind == "block_jacobi")


def test_buoyant_third_rung_matches_goma_tpu():
    kw = dict(max_iter=15, tol_residual=1e-6, linear_tol=1e-4,
              precond="twolevel", smooth_sweeps=1, gmres_restart=160,
              linear_maxiter=1000)
    rj, rt = run((buoyant(JAX_PKG, 4), buoyant(TORCH_PKG, 4)), kw)
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters, (rt.summary(), rj.summary())
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= 1, (rt.linear_iters, rj.linear_iters)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6, atol=1e-5)


def test_reset_lagged_drops_the_two_level_factor(pair):
    pt = pair[1]
    st = NewtonSolver(pt, NewtonOptions(**TOL))
    st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params())
    assert st._fac_cache is not None and st.n_factor >= 1
    st.reset_lagged()
    assert st._fac_cache is None and st._fac_base_its is None
