"""Augmenting conditions: extra scalar constraints + unknown parameters,
solved by bordered Newton (counterpart of
``goma_tpu/continuation/augmenting.py``).

Parity: reference ``src/mm_augc_util.c`` (AC_FLUX / AC_VOLUME / AC_POSITION /
AC_LGRM types, ``std_aug_cond:1832``) and the bordering Schur solve inside
Newton (``src/mm_sol_nonlinear.c:1523-1724``). The reference hand-codes
dR/dp and dg/dx per AC type; here both come from AD (``torch.func.jvp``
through the params leaf, ``torch.func.grad`` of the constraint), so an AC
is just:

    AugmentingCondition(key="lid_speed", g=lambda x, params: flux(x) - 1.0)

with ``key`` naming the scalar params leaf the AC unknown controls and ``g``
a torch function of the state tensor (on the problem's device) returning a
0-d tensor.

Bordered update (same algebra as the reference's Schur complement), the
small n_AC x n_AC system solved on the host in float64:
    [J  B][dx]   [-R]        W_j = J^-1 B_j,  w0 = J^-1 R
    [C  D][dp] = [-g]   =>   S = D - C W^T,   dp = S^-1 (C w0 - g),
                             dx = -w0 - W^T dp
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from goma_tpu_torch.continuation.conti import (_device, _host, _linsolver,
                                               _scalar)
from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver


@dataclass
class AugmentingCondition:
    key: str  # scalar leaf of params controlled by this AC's unknown
    g: Callable  # g(x, params) -> 0-d tensor constraint residual (traceable)
    p0: float = 0.0


@dataclass
class AugmentedResult:
    x: np.ndarray
    p: np.ndarray
    converged: bool
    iters: int
    res_norms: list


class AugmentedNewtonSolver:
    """Newton on (x, p) with n_AC bordering columns/rows."""

    def __init__(self, problem, acs: list[AugmentingCondition],
                 options: NewtonOptions | None = None):
        self.problem = problem
        self.acs = acs
        self.solver = NewtonSolver(problem, options)
        self.opts = self.solver.opts
        self._linsolve = _linsolver(problem, self.solver)

    def _params_with(self, params, p):
        q = dict(params)
        for ac, pi in zip(self.acs, p):
            q[ac.key] = _scalar(self.problem, pi)
        return q

    def solve(self, x0, params) -> AugmentedResult:
        from torch.func import grad, jvp

        prob = self.problem
        nac = len(self.acs)
        x = np.asarray(x0, dtype=float)
        p = np.array([ac.p0 for ac in self.acs], dtype=float)
        res_norms: list[float] = []
        converged = False
        it = 0

        def params_with_pj(j, v):
            """params with AC j's leaf set to (possibly dual) v."""
            q = dict(params)
            for k, (ac, pi) in enumerate(zip(self.acs, p)):
                q[ac.key] = v if k == j else _scalar(prob, pi)
            return q

        for it in range(self.opts.max_iter):
            pp = self._params_with(params, p)
            xj = _device(prob, x)
            R, vals = prob.assemble(xj, pp)
            Rn = _host(R)
            gvals = np.array([float(ac.g(xj, pp)) for ac in self.acs])
            rnorm = float(np.sqrt(np.dot(Rn, Rn) + np.dot(gvals, gvals)))
            res_norms.append(rnorm)
            if rnorm < self.opts.tol_residual:
                converged = True
                break

            w0 = self._linsolve(vals, Rn)
            W = np.zeros((nac, x.shape[0]))
            C = np.zeros((nac, x.shape[0]))
            D = np.zeros((nac, nac))
            one = _scalar(prob, 1.0)
            for j in range(nac):
                _, Bj = jvp(lambda v: prob._residual_only(xj, params_with_pj(j, v)),
                            (_scalar(prob, p[j]),), (one,))
                W[j] = self._linsolve(vals, Bj)
            for i, ac in enumerate(self.acs):
                C[i] = _host(grad(lambda xx: ac.g(xx, pp))(xj))
                for j in range(nac):
                    _, dg = jvp(lambda v: ac.g(xj, params_with_pj(j, v)),
                                (_scalar(prob, p[j]),), (one,))
                    D[i, j] = float(dg)

            S = D - C @ W.T
            dp = np.linalg.solve(S, C @ w0 - gvals)
            dx = -w0 - W.T @ dp
            x = x + self.opts.damp * dx
            p = p + self.opts.damp * dp
        return AugmentedResult(x=x, p=p, converged=converged, iters=it,
                               res_norms=res_norms)
