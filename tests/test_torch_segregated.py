"""The segregated (multi-matrix) drivers of the PyTorch port against
goma_tpu's (``solvers/segregated.py``): goma_tpu's
tests/test_segregated_subcycle.py cases and
test_more_physics.py::test_segregated_natural_convection
(``scripts/split_decks.py``'s decks) and the three-matrix buoyant cavity
of ``chip_smoke.py`` phase 64 cut to 6 x 6 on host ``direct``, each in both
packages on the CPU in float64 (the port in one torch thread); the two
``ValueError``s of ``SegregatedTransientSolver``.

Tolerances: the same step and outer-iteration counts; x within 1e-10 of
max |x| (the Picard iterates of both packages differ by the sub-solves'
rounding, about 1e-11 of max |x| at the end).
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
X_RTOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", ["subcycled_fine_dt", "subcycle_stiff_species",
                                  "segregated_natural_convection"])
def test_goma_tpu_segregated_decks(name):
    """Each deck's own gate in both packages (the subcycled trajectory
    against the fine-dt transient run, the subcycling gain, the segregated
    against the monolithic solution), the same step or outer-iteration
    count (``newton``) and x within 1e-10 of max |x|."""
    a, b = sd.SMALL[name](JAX), sd.SMALL[name](TORCH)
    assert b["newton"] == a["newton"]
    assert _rel(b["x"], a["x"]) <= X_RTOL


def test_subcycle_errors_raise():
    """Full sweeps with per-matrix subcycling, and a subcycle count below 1
    (goma_tpu's ValueErrors, segregated.py:124-129), in the port; the deck
    checks both messages in both packages."""
    from goma_tpu_torch.solvers.segregated import (SegregatedTransientSolver,
                                                   SubProblem)

    assert sd.SMALL["subcycle_sweeps_raise"](TORCH)["reading"] == [2.0]
    prob = sd._heat_problem(TORCH)[1]
    with pytest.raises(ValueError, match="not supported"):
        SegregatedTransientSolver(
            [SubProblem("T", prob, lambda x: {}, subcycle_count=2)],
            dt=0.1, t_end=0.2, subcycles=2)
    with pytest.raises(ValueError, match="expected to be > 0"):
        SegregatedTransientSolver(
            [SubProblem("T", prob, lambda x: {}, subcycle_count=0)],
            dt=0.1, t_end=0.2)


def _buoyant(P):
    solver, probs, _ = sd.segregated_cavity(P, 6, P.NewtonOptions(
        max_iter=sd.SEG_MAX_ITER, tol_residual=1e-9, linear_solver="direct"))
    res, counts = sd.run_segregated(solver)
    return probs, res, counts


def test_buoyant_cavity_three_matrices():
    """The three-matrix buoyant cavity (6 x 6, relaxation ``SEG_RELAX``) on
    host ``direct``: converged in the same outer iterations with the same
    Newton count of every sub-solve, each matrix's x within 1e-10 of its
    max; T and u at every node within 1e-6 of the coupled deck's solution
    (bench.py's one-matrix deck)."""
    (pj, rj, cj), (pt, rt, ct) = _buoyant(JAX), _buoyant(TORCH)
    assert rj.converged and rt.converged
    assert rt.outer_iters == rj.outer_iters and ct == cj
    for k in rj.x:
        assert _rel(rt.x[k], rj.x[k]) <= X_RTOL, k
    cp = sd.coupled_cavity(TORCH, 6)
    rc = TORCH.NewtonSolver(cp, TORCH.NewtonOptions(
        max_iter=15, tol_residual=1e-10, linear_solver="direct")).solve(
        np.zeros(cp.dofmap.n_dof), cp.base_params())
    for a, b in zip(sd.coupled_fields(pt, rt.x), sd.coupled_fields(cp, rc.x)):
        assert _rel(a, b) <= 1e-6
