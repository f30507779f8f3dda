"""Hunting: staged multi-parameter sweeps (counterpart of
``goma_tpu/continuation/hunting.py``).

Parity: reference ``src/ac_hunt.c:91 hunt_problem`` — march several
parameters together from start to end values with a shared adaptive step,
re-converging at each stage. Built on ``continue_problem`` with a single
normalized sweep coordinate s in [0, 1] mapped onto every hunted parameter.

Per-parameter step scheduling follows the reference's hunting conditions
(``src/ac_hunt.c:391-500``): each condition carries its own Delta_s0 /
Delta_s_min / Delta_s_max *in parameter units* plus a ramp mode (specified /
linear-over-n-steps / logarithmic); they are converted to bounds on the
shared coordinate (``dhunt_par`` in the reference) and the controller step is
clamped to the tightest of them, re-evaluated at the current point for
logarithmic paths. ``make_params`` builds each hunted leaf as a 0-d tensor
on the problem's device, from s (a float, or a 0-d tensor for the
sensitivity).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from goma_tpu_torch.continuation.conti import (ContinuationStep, _scalar,
                                               continue_problem)
from goma_tpu_torch.solvers.newton import NewtonOptions


@dataclass
class HuntSpec:
    key: str  # params leaf
    start: float
    end: float
    log: bool = False  # geometric path (reference: ramp == 2, logarithmic)
    # per-parameter step controls in PARAMETER units (reference
    # hDelta_s0/hDelta_s_min/hDelta_s_max); None ds0 = ramp mode 1
    # (spread linearly over the driver's max_steps)
    ds0: float | None = None
    ds_min: float = 0.0
    ds_max: float = math.inf

    def value(self, s):
        if self.log:
            return self.start * (self.end / self.start) ** s
        return self.start + (self.end - self.start) * s

    def to_s(self, d_param: float, s: float) -> float:
        """Convert a parameter-units step magnitude to shared-coordinate
        units at sweep position s (reference ``src/ac_hunt.c:491-500``:
        dhunt_par = log10(1 + d/|lam|)/log10(end/start) on log paths,
        d/|end-start| on linear ones)."""
        if not math.isfinite(d_param):
            return math.inf
        if self.log:
            lam = abs(self.value(s))
            return math.log10(1.0 + d_param / lam) / abs(
                math.log10(self.end / self.start))
        return d_param / abs(self.end - self.start)


def hunt_problem(
    problem,
    specs: list[HuntSpec],
    x0,
    ds0: float | None = 0.25,
    newton_options: NewtonOptions | None = None,
    base_params: dict | None = None,
    max_steps: int = 200,
    **kw,
) -> list[ContinuationStep]:
    """Sweep all hunted parameters from their start to end values.

    The shared-coordinate step obeys every spec's (ds_min, ds_max) window;
    the initial step is the tightest of the per-spec ds0 (reference: the
    clamped hDelta_s0), falling back to ``ds0`` / a linear ramp over
    ``max_steps`` when unspecified.
    """

    def make_params(s):
        p = problem.base_params() if base_params is None else dict(base_params)
        for spec in specs:
            p[spec.key] = _scalar(problem, spec.value(s))
        return p

    def step_bounds(s):
        dmin = max((sp.to_s(sp.ds_min, s) for sp in specs), default=0.0)
        dmax = min((sp.to_s(sp.ds_max, s) for sp in specs), default=math.inf)
        return dmin, min(dmax, 1.0)

    s0_candidates = [sp.to_s(sp.ds0, 0.0) for sp in specs if sp.ds0 is not None]
    if ds0 is None:
        ds0 = 1.0 / max(max_steps - 1, 1)  # reference ramp mode 1
    if s0_candidates:
        ds0 = min([ds0] + s0_candidates)
    dmin0, dmax0 = step_bounds(0.0)
    if dmin0 > dmax0:
        raise ValueError(
            f"hunting: incompatible step windows (min {dmin0} > max {dmax0} "
            f"in sweep units)")
    ds0 = min(max(ds0, dmin0), dmax0)

    return continue_problem(
        problem, make_params, 0.0, 1.0, ds0, x0, newton_options,
        max_steps=max_steps, step_bounds=step_bounds, **kw
    )


def detect_folds(arc_steps) -> list[int]:
    """Indices where the continuation parameter reverses along an arclength
    branch (turning points). Reference: LOCA turning-point detection."""
    lams = np.array([s.lam for s in arc_steps])
    d = np.diff(lams)
    out = []
    for i in range(1, len(d)):
        if d[i - 1] * d[i] < 0:
            out.append(i)
    return out
