"""Segregated (split-operator) solves (counterpart of
``goma_tpu/solvers/segregated.py``).

Parity: reference ``src/rf_solve_segregated.c:185 solve_problem_segregated``
— when the unknowns are split into multiple matrices, each subproblem is
Newton-solved in sequence, iterating to self-consistency (the
Problem_Graph/pg->imtrx machinery, ``include/mm_as_structs.h:921``).

Here each subproblem is its own ``Problem`` on the shared mesh; coupling
fields travel as external nodal fields (fv.ext), and a Picard loop iterates
the sequence until the inter-field updates stall. The projection-method
split (u*, p* of src/mm_fill_split.c) can be expressed in the same frame.
Every sub-solve runs on its sub-problem's device; the solution vectors and
the exported fields between the solves are host numpy, as in goma_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver


@dataclass
class SubProblem:
    name: str
    problem: object  # finalized Problem
    # export(x) -> dict of external-field arrays {name: (n_nodes,)} published
    # to the other subproblems
    export: Callable
    newton_options: NewtonOptions | None = None
    # per-matrix time subcycling (reference pg->matrix_subcycle_count /
    # delta_t_fraction, src/rf_solve_segregated.c:478): this sub-problem
    # advances through ``subcycle_count`` sub-steps of dt/subcycle_count
    # within each global time step, carrying its own sub-step history
    # (pg->sub_step_solutions)
    subcycle_count: int = 1


@dataclass
class SegregatedResult:
    x: dict  # name -> solution vector
    converged: bool
    outer_iters: int
    history: list


def _ext_params(prob, shared):
    """``prob.base_params`` with every external field of ``prob`` taken
    from the published fields ``shared``."""
    return prob.base_params(**{f"ext_{n}": shared[n]
                               for n in prob.external_fields})


class SegregatedSolver:
    def __init__(self, subproblems: list[SubProblem], max_outer: int = 30,
                 tol: float = 1e-8, relax: float = 1.0):
        self.subs = subproblems
        self.max_outer = max_outer
        self.tol = tol
        self.relax = relax
        self._solvers = {
            s.name: NewtonSolver(s.problem, s.newton_options) for s in subproblems
        }

    def solve(self, x0: dict, params: dict | None = None) -> SegregatedResult:
        xs = {k: np.array(v, copy=True) for k, v in x0.items()}
        shared: dict[str, np.ndarray] = {}
        for s in self.subs:
            shared.update(s.export(xs[s.name]))
        history = []
        converged = False
        it = 0
        for it in range(self.max_outer):
            delta = 0.0
            for s in self.subs:
                p = _ext_params(s.problem, shared)
                if params:
                    for k, v in params.items():
                        p[k] = v
                res = self._solvers[s.name].solve(xs[s.name], p)
                if not res.converged:
                    history.append((s.name, it, "newton failed"))
                x_new = (1 - self.relax) * xs[s.name] + self.relax * res.x
                delta = max(
                    delta,
                    float(np.max(np.abs(x_new - xs[s.name]))
                          / max(1e-30, float(np.max(np.abs(x_new))))),
                )
                xs[s.name] = x_new
                shared.update(s.export(xs[s.name]))
            history.append(("outer", it, delta))
            if delta < self.tol:
                converged = True
                break
        return SegregatedResult(x=xs, converged=converged, outer_iters=it + 1,
                                history=history)


@dataclass
class SegregatedTransientResult:
    x: dict            # name -> final solution vector
    xdot: dict         # name -> final time derivative
    t: float
    steps: int
    history: list


class SegregatedTransientSolver:
    """theta-scheme transient integration of a segregated split — the
    time-loop half of ``solve_problem_segregated``
    (src/rf_solve_segregated.c:1378): each global step runs ``subcycles``
    full sweeps over the sub-problems (upd->SegregatedSubcycles), and any
    sub-problem with ``subcycle_count`` k > 1 instead advances through k
    sub-steps of dt/k carrying its own sub-step history
    (pg->matrix_subcycle_count / pg->delta_t_fraction /
    pg->sub_step_solutions, rf_solve_segregated.c:465-510,1495). Coupled
    fields are refreshed through each sub-problem's ``export`` after every
    solve. As in the reference, full subcycling (subcycles > 1) cannot be
    combined with per-matrix time subcycling."""

    def __init__(self, subproblems: list[SubProblem], dt: float, t_end: float,
                 theta: float = 0.0, subcycles: int = 1, t0: float = 0.0):
        if subcycles > 1 and any(s.subcycle_count > 1 for s in subproblems):
            raise ValueError(
                "Full Subcycling is not supported with time subcycling of "
                "matrices (rf_solve_segregated.c:483)")
        if any(s.subcycle_count < 1 for s in subproblems):
            raise ValueError("Subcycle count expected to be > 0")
        self.subs = subproblems
        self.dt = dt
        self.t_end = t_end
        self.theta = theta
        self.subcycles = subcycles
        self.t0 = t0
        self._solvers = {
            s.name: NewtonSolver(s.problem, s.newton_options) for s in subproblems
        }

    def run(self, x0: dict, params: dict | None = None) -> SegregatedTransientResult:
        xs = {k: np.array(v, dtype=float, copy=True) for k, v in x0.items()}
        xdots = {k: np.zeros_like(v) for k, v in xs.items()}
        shared: dict[str, np.ndarray] = {}
        for s in self.subs:
            shared.update(s.export(xs[s.name]))
        history = []
        t = self.t0
        nstep = 0
        while t < self.t_end - 1e-14:
            dt = min(self.dt, self.t_end - t)
            # first step bootstraps with backward Euler (no xdot history)
            theta = 0.0 if nstep == 0 else self.theta
            # step-start history: repeated sweeps re-iterate the SAME step
            # to self-consistency against this snapshot
            x_step = {k_: v.copy() for k_, v in xs.items()}
            xdot_step = {k_: v.copy() for k_, v in xdots.items()}
            for sweep in range(self.subcycles):
                for s in self.subs:
                    prob = s.problem
                    k = s.subcycle_count
                    sub_dt = dt / k
                    x_old = x_step[s.name]
                    xdot_old = xdot_step[s.name]
                    x_guess = xs[s.name]  # best iterate from earlier sweeps
                    for ss in range(k):
                        ct = (1.0 + 2.0 * theta) / sub_dt
                        hist = -ct * x_old - 2.0 * theta * xdot_old
                        p = _ext_params(prob, shared)
                        if params:
                            p.update(params)
                        on = {"dtype": prob.dtype, "device": prob.device}
                        p["ct"] = torch.as_tensor(ct, **on)
                        p["hist"] = torch.as_tensor(hist, **on)
                        p["time"] = torch.as_tensor(t + (ss + 1) * sub_dt, **on)
                        res = self._solvers[s.name].solve(x_guess, p)
                        if not res.converged:
                            history.append((s.name, nstep, ss, "newton failed"))
                        x_new = np.asarray(res.x, dtype=float)
                        xdot_old = ct * x_new + hist
                        x_old = x_new
                        x_guess = x_new
                    xs[s.name] = x_old
                    xdots[s.name] = xdot_old
                    shared.update(s.export(xs[s.name]))
            t += dt
            nstep += 1
            history.append(("step", nstep, t))
        return SegregatedTransientResult(x=xs, xdot=xdots, t=t, steps=nstep,
                                         history=history)
