"""Parameter continuation: zeroth/first order and pseudo-arclength
(counterpart of ``goma_tpu/continuation/conti.py``).

Parity: reference ``src/ac_conti.c:104 continue_problem`` (zeroth/first-order
continuation with adaptive parameter step), ``src/ac_hunt.c:91 hunt_problem``
(multi-parameter sweeps), and LOCA's arclength bordering
(``src/loca_lib.c:74 con_lib``, ``src/loca_bord.c``).

The parameter enters the residual through the ``params`` dict, so the
sensitivity dR/dlambda is one ``torch.func.jvp`` of the residual
(``Problem._residual_only``) through the params leaf ``make_params`` builds
from a 0-d tensor (``_dR_dlam``). A ``make_params`` that is not traceable
takes a central difference instead; ``_dR_dlam.routes`` counts the route
each call took. The bordered arclength solve reuses the Newton solver's
linear stack (two solves + a 2x2 Schur), as goma_tpu does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver

# the message torch.func raises when a function reads a dual tensor's
# storage (a conversion to numpy inside make_params)
_NO_STORAGE = "doesn't have storage"


@dataclass
class ContinuationStep:
    lam: float
    x: np.ndarray
    newton_iters: int
    converged: bool


def _scalar(problem, v):
    """``v`` as a 0-d tensor on the problem's device and dtype."""
    return torch.as_tensor(v, dtype=problem.dtype, device=problem.device)


def _device(problem, x):
    """A host or device vector as a tensor on the problem's device."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=problem.dtype, device=problem.device)


def _float_leaves(p):
    return tuple(v for v in p.values()
                 if torch.is_tensor(v) and v.is_floating_point())


def _dR_dlam(problem, x, make_params, lam, eps=1e-7):
    """dR/dlam at (x, lam) on the problem's device (a tensor): the
    ``torch.func.jvp`` of the residual through the params ``make_params``
    builds from a 0-d tensor (exact to roundoff), or, where ``make_params``
    is not traceable, a central difference. Not traceable means: torch.func
    raised its no-storage error (a numpy conversion of the parameter), or
    the tangent reached no floating-point leaf of the params (a ``float()``
    or ``.item()`` drops it without an error). Each call adds one to
    ``_dR_dlam.routes["jvp"]`` or ``["central_difference"]``."""
    from torch.func import jvp

    x = _device(problem, x)

    def f(lam_t):
        return problem._residual_only(x, make_params(lam_t))

    def with_leaves(lam_t):
        p = make_params(lam_t)
        return problem._residual_only(x, p), _float_leaves(p)

    lam_t = _scalar(problem, lam)
    try:
        _, (dr, dleaves) = jvp(with_leaves, (lam_t,), (torch.ones_like(lam_t),))
        traced = bool(sum(torch.count_nonzero(d) for d in dleaves) > 0)
    except RuntimeError as e:
        if _NO_STORAGE not in str(e):
            raise
        traced = False
    if traced:
        _dR_dlam.routes["jvp"] += 1
        return dr
    _dR_dlam.routes["central_difference"] += 1
    return (f(_scalar(problem, lam + eps)) - f(_scalar(problem, lam - eps))) / (2 * eps)


_dR_dlam.routes = {"jvp": 0, "central_difference": 0}


def _linsolver(problem, solver):
    """linsolve(vals, rhs) -> host float64 solution of J x = rhs: the host
    direct solve on the ``direct`` rung, else goma_tpu's ``_solve_gmres``
    (the Newton solver's lagged factor when one is cached)."""
    from goma_tpu_torch.solvers.linear import direct_solve_host

    def linsolve(vals, rhs):
        if solver.opts.linear_solver == "direct":
            return np.asarray(direct_solve_host(
                problem.pattern, _host(vals), _host(rhs)))
        rhs = torch.as_tensor(rhs, dtype=problem.dtype, device=problem.device)
        return _host(solver._solve_gmres(vals, rhs).x)

    return linsolve


def _host(v):
    """A tensor or array as host float64 numpy."""
    if torch.is_tensor(v):
        v = v.detach().to("cpu")
    return np.asarray(v, dtype=np.float64)


def continue_problem(
    problem,
    make_params: Callable[[float], dict],
    lam_start: float,
    lam_end: float,
    dlam0: float,
    x0,
    newton_options: NewtonOptions | None = None,
    first_order: bool = True,
    max_steps: int = 200,
    min_dlam: float = 1e-10,
    growth: float = 1.5,
    step_bounds: Callable[[float], tuple[float, float]] | None = None,
) -> list[ContinuationStep]:
    """March the solution from lam_start to lam_end with adaptive d(lambda).

    ``make_params(lam) -> params`` builds the full parameter dict (including
    Dirichlet values if they depend on lambda); it gets a Python float, or
    a 0-d tensor when the sensitivity is taken. First-order predictor uses
    x' = -J^{-1} dR/dlam (reference: first-order continuation).
    ``step_bounds(lam) -> (dmin, dmax)`` clamps |dlam| at the current point
    (reference: per-hunting-condition Delta_s_min/max, ``src/ac_hunt.c``);
    halving below dmin aborts, like the reference's step-size floor.
    """
    solver = NewtonSolver(problem, newton_options)
    linsolve = _linsolver(problem, solver)

    steps: list[ContinuationStep] = []
    lam = lam_start
    dlam = dlam0
    direction = np.sign(lam_end - lam_start) or 1.0
    dlam = abs(dlam) * direction
    x = np.asarray(x0, dtype=float)

    res = solver.solve(x, make_params(lam))
    if not res.converged:
        raise RuntimeError("continuation: initial solve failed")
    x = res.x
    steps.append(ContinuationStep(lam, x.copy(), res.iters, True))

    while (lam_end - lam) * direction > 1e-14 and len(steps) < max_steps:
        dmin = min_dlam
        if step_bounds is not None:
            dmin, dmax = step_bounds(lam)
            dlam = direction * min(max(abs(dlam), dmin), dmax)
        dlam = direction * min(abs(dlam), abs(lam_end - lam))
        # predictor: x' = -J^{-1} dR/dlam (first order), else reuse x
        if first_order:
            _, vals = problem.assemble(_device(problem, x), make_params(lam))
            dr = _dR_dlam(problem, x, make_params, lam)
            x_pred = x - linsolve(vals, dr) * dlam
        else:
            x_pred = x

        res = solver.solve(x_pred, make_params(lam + dlam))
        if res.converged and np.all(np.isfinite(res.x)):
            lam = lam + dlam
            x = res.x
            steps.append(ContinuationStep(lam, x.copy(), res.iters, True))
            if res.iters <= 3:
                dlam *= growth
        else:
            dlam *= 0.5
            if abs(dlam) < max(min_dlam, dmin):
                raise RuntimeError(f"continuation stalled at lam={lam}")
    return steps


@dataclass
class ArcStep:
    lam: float
    x: np.ndarray
    newton_iters: int


def arclength_continue(
    problem,
    make_params: Callable[[float], dict],
    lam0: float,
    x0,
    ds0: float,
    n_steps: int,
    newton_options: NewtonOptions | None = None,
    max_newton: int = 12,
    lam_scale: float = 1.0,
) -> list[ArcStep]:
    """Pseudo-arclength continuation (tracks solution branches around folds).

    Bordered Newton on (x, lam) with constraint
       N = t_x . (x - x_pred) + t_lam (lam - lam_pred) = 0
    solved by the two-solve bordering algorithm (reference: LOCA
    ``src/loca_bord.c`` arc-length algorithm).
    """
    opts = newton_options or NewtonOptions()
    solver = NewtonSolver(problem, opts)
    linsolve = _linsolver(problem, solver)

    # converge the start point
    res = solver.solve(np.asarray(x0), make_params(lam0))
    if not res.converged:
        raise RuntimeError("arclength: initial solve failed")
    x = res.x
    lam = lam0

    # initial tangent: (dx/dlam, 1) normalized
    R, vals = problem.assemble(_device(problem, x), make_params(lam))
    dr = _dR_dlam(problem, x, make_params, lam)
    dxdl = -linsolve(vals, dr)
    t_x = dxdl
    t_l = 1.0
    nrm = np.sqrt(np.dot(t_x, t_x) + (lam_scale * t_l) ** 2)
    t_x, t_l = t_x / nrm, t_l / nrm

    out = [ArcStep(lam, x.copy(), res.iters)]
    ds = ds0
    for _ in range(n_steps):
        x_pred = x + ds * t_x
        lam_pred = lam + ds * t_l
        xc, lc = x_pred.copy(), float(lam_pred)
        ok = False
        for it in range(max_newton):
            params = make_params(lc)
            R, vals = problem.assemble(_device(problem, xc), params)
            Rn = _host(R)
            N = np.dot(t_x, xc - x_pred) + lam_scale**2 * t_l * (lc - lam_pred)
            if np.linalg.norm(Rn) < opts.tol_residual * 100 and abs(N) < 1e-10:
                ok = True
                break
            dr = _dR_dlam(problem, xc, make_params, lc)
            w1 = linsolve(vals, Rn)  # J w1 = R
            w2 = linsolve(vals, dr)  # J w2 = dR/dlam
            # bordered update: dlam = -(N - t_x.w1) / (t_lam*ls^2 - t_x.w2)
            denom = lam_scale**2 * t_l - np.dot(t_x, w2)
            dlam = -(N - np.dot(t_x, w1)) / denom
            dx = -w1 - dlam * w2
            xc = xc + dx
            lc = lc + dlam
            if not np.all(np.isfinite(xc)):
                break
        if not ok:
            ds *= 0.5
            if abs(ds) < 1e-12:
                raise RuntimeError("arclength stalled")
            continue
        # new tangent from secant
        dx_sec = xc - x
        dl_sec = lc - lam
        nrm = np.sqrt(np.dot(dx_sec, dx_sec) + (lam_scale * dl_sec) ** 2)
        t_x, t_l = dx_sec / nrm, dl_sec / nrm
        x, lam = xc, lc
        out.append(ArcStep(lam, x.copy(), it + 1))
        if it <= 3:
            ds = min(ds * 1.3, ds0 * 4)
    return out
