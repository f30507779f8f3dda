"""Transient driver: theta-method time integration with predictor-corrector
adaptive time stepping (counterpart of ``goma_tpu/solvers/transient.py``).

Parity: reference ``src/rf_solve.c:290 solve_problem`` — solution-vector
rotation (x, x_old, xdot, xdot_old), explicit predictor
(``predict_solution:2728``), theta-method corrector (theta=0 backward Euler,
0.5 Crank-Nicolson; ``include/mm_as_structs.h:1121-1124``), adaptive dt from
the predictor-corrector error norm (``src/rf_util.c:470 time_step_control``),
and the soft-failure ladder: a failed/non-finite Newton solve halves dt and
retries from the old state (``src/rf_solve.c:1956-2100``).

Time derivative closure: xdot = (1+2*theta)/dt * (x - x_old) - 2*theta*xdot_old,
injected into the assembly as qdot = ct*x + hist with
ct = (1+2*theta)/dt, hist = -ct*x_old - 2*theta*xdot_old.

The step loop runs on the host in numpy, as in goma_tpu: once per step
``hist`` goes to the Problem's device at its dtype and ``ct`` and the time
become 0-d tensors there; each Newton solve runs on the device.

``quality_guard=True`` (goma_tpu's ALE guard, the reference's
negative-element-volume ladder): after each converged Newton solve the min
detJ of the displaced mesh is read once (``post/quality.py``, one device
reduction and one host read); min detJ <= 0 counts as a failed step,
halving dt and retrying with the same failure accounting.

``variable_stats=True`` with ``verbose=True``: after each accepted Newton
solve, the min / max / mean / L2 of every solution variable
(``post/stats.py``, the reference's per-step ``variable_stats``) to
standard error, as goma_tpu prints them.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonResult, NewtonSolver

@dataclass
class TimeOptions:
    dt0: float = 1e-2
    t_end: float = 1.0
    theta: float = 0.0  # 0 = BE, 0.5 = CN (reference convention)
    max_steps: int = 10_000
    # predictor-corrector error control (reference eps on "Time step error")
    eps_time: float = 1e-2
    rel_tol: float = 1e-3
    abs_tol: float = 1e-6
    growth_cap: float = 1.5  # reference TIME_STEP_GROWTH_CAP
    shrink_floor: float = 0.5
    min_dt: float = 1e-12
    max_dt: float = np.inf
    max_failures: int = 12
    second_order_predictor: bool = True
    adapt: bool = True
    # first step uses backward Euler: there is no consistent xdot history yet
    # (the reference reconstructs old time derivatives on restart rather than
    # trusting zeros; BE bootstrap is the equivalent safeguard)
    bootstrap_be: bool = True
    # element-quality check after each converged Newton solve (ALE): a
    # tangled element (min detJ <= 0) fails the step
    quality_guard: bool = False
    # print a per-step line (the reference's transient console output)
    verbose: bool = False
    # with verbose: per-variable statistics each accepted step
    # (post/stats.py, the reference's variable_stats)
    variable_stats: bool = False


@dataclass
class StepRecord:
    t: float
    dt: float
    newton_iters: int
    err_time: float
    converged: bool


@dataclass
class TransientResult:
    x: np.ndarray
    xdot: np.ndarray
    t: float
    steps: list
    n_failures: int


class TransientSolver:
    def __init__(self, problem, newton_options: NewtonOptions | None = None,
                 time_options: TimeOptions | None = None):
        self.problem = problem
        self.newton = NewtonSolver(problem, newton_options)
        self.topts = time_options or TimeOptions()
        self._quality_fn = None

    def _predict(self, x_old, xdot_old, xdot_older, dt, dt_old):
        if self.topts.second_order_predictor and dt_old > 0:
            # variable-step second-order explicit predictor
            # (reference predict_solution uses Adams-Bashforth-style extrapolation)
            r = dt / dt_old
            return x_old + dt * ((1 + 0.5 * r) * xdot_old - 0.5 * r * xdot_older)
        return x_old + dt * xdot_old

    def run(self, x0, params, t0: float = 0.0, callback: Callable | None = None,
            xdot0=None) -> TransientResult:
        """``xdot0``: initial time derivative for warm restarts (reference
        stores/reconstructs old time derivatives on restart,
        src/rf_solve.c)."""
        to = self.topts
        prob = self.problem
        put = lambda a: torch.as_tensor(a, dtype=prob.dtype,  # noqa: E731
                                        device=prob.device)
        n = prob.dofmap.n_dof
        x_old = np.asarray(x0, dtype=float).copy()
        xdot_old = np.zeros(n) if xdot0 is None else np.asarray(xdot0, dtype=float).copy()
        xdot_older = np.zeros(n)
        t = t0
        dt = to.dt0
        dt_old = 0.0
        steps: list[StepRecord] = []
        failures = 0

        while t < to.t_end - 1e-14 and len(steps) < to.max_steps:
            dt = min(dt, to.t_end - t, to.max_dt)
            theta = 0.0 if (to.bootstrap_be and not steps) else to.theta
            ct = (1.0 + 2.0 * theta) / dt
            hist = -ct * x_old - 2.0 * theta * xdot_old
            x_pred = self._predict(x_old, xdot_old, xdot_older, dt, dt_old)

            p = dict(params)
            p["ct"] = put(ct)
            p["hist"] = put(hist)
            p["time"] = put(t + dt)

            res: NewtonResult = self.newton.solve(x_pred, p)
            ok = res.converged and np.all(np.isfinite(res.x))
            if to.verbose:
                l2 = res.res_norms[-1][1] if res.res_norms else float("nan")
                print(
                    f"[transient] t={t:.5g} dt={dt:.3g} newton={res.iters} "
                    f"conv={res.converged} |R|2={l2:.3e} "
                    f"finite={bool(np.all(np.isfinite(res.x)))}",
                    file=sys.stderr, flush=True,
                )
                if ok and to.variable_stats:
                    from goma_tpu_torch.post.stats import (format_stats,
                                                           variable_stats)

                    print(format_stats(variable_stats(prob, res.x)),
                          file=sys.stderr, flush=True)
            if ok and to.quality_guard:
                if self._quality_fn is None:
                    from goma_tpu_torch.post.quality import make_quality_fn

                    self._quality_fn = make_quality_fn(prob)
                # one host read of the three 0-d results
                mn = torch.stack(self._quality_fn(res.x)).tolist()[0]
                ok = mn > 0.0
                if to.verbose and not ok:
                    print(f"[transient]   quality reject: min detJ = {mn:.3e}",
                          file=sys.stderr, flush=True)
            if not ok:
                failures += 1
                if failures > to.max_failures or dt * 0.5 < to.min_dt:
                    raise RuntimeError(
                        f"transient solve failed at t={t}: dt underflow after "
                        f"{failures} failures"
                    )
                dt *= 0.5  # reference: halve dt and retry (rf_solve.c:1956)
                # refactor-on-reject: factors lagged along the diverging
                # trajectory are a bad basis for the halved-dt retry
                self.newton.reset_lagged()
                continue

            x_new = res.x
            # predictor-corrector local error (time_step_control analog)
            w = to.abs_tol + to.rel_tol * np.abs(x_new)
            err = np.linalg.norm((x_new - x_pred) / w) / np.sqrt(n)
            if to.adapt and err > 1.0 and dt * 0.5 >= to.min_dt and len(steps) > 0:
                failures += 1
                if failures <= to.max_failures:
                    dt *= 0.5
                    self.newton.reset_lagged()
                    continue

            # accept
            xdot_new = ct * x_new + hist
            t += dt
            steps.append(StepRecord(t, dt, res.iters, float(err), True))
            if callback is not None:
                callback(t, x_new, xdot_new, res)
            xdot_older = xdot_old
            xdot_old = xdot_new
            x_old = x_new
            dt_old = dt
            failures = 0
            if to.adapt:
                fac = np.sqrt(to.eps_time / max(err, 1e-14))
                fac = np.clip(fac, to.shrink_floor, to.growth_cap)
                dt = float(np.clip(dt * fac, to.min_dt, to.max_dt))

        return TransientResult(x=x_old, xdot=xdot_old, t=t, steps=steps, n_failures=failures)
