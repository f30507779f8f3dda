"""Numerical-Jacobian self-check (counterpart of
``goma_tpu/utils/numjac.py``).

Parity: the reference's de-facto kernel test harness ``src/mm_numjac.c``
(``numerical_jacobian:716``, run via ``goma -d -1/-2``): finite-difference
the residual, compare each matrix entry against the analytic Jacobian with
scaled-error classification. Here the "analytic" Jacobian is the AD one
(``Problem.assemble``), the finite differences central ones of
``Problem.residual``, so this tool guards against non-differentiable
kernels (where AD silently produces wrong/NaN derivatives: ``torch.where``
branches, norms at zero, clips).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class JacCheckResult:
    n_checked: int
    n_bad: int
    worst_abs: float
    worst_rel: float
    bad_entries: list  # (row, col, ad, fd)

    @property
    def ok(self) -> bool:
        return self.n_bad == 0

    def report(self) -> str:
        lines = [
            f"numerical jacobian check: {self.n_checked} entries, "
            f"{self.n_bad} mismatches, worst |ad-fd| = {self.worst_abs:.3e}, "
            f"worst rel = {self.worst_rel:.3e}"
        ]
        for r, c, ad, fd in self.bad_entries[:20]:
            lines.append(f"  J[{r},{c}]: AD={ad:.8e}  FD={fd:.8e}")
        return "\n".join(lines)


def numerical_jacobian_check(
    problem,
    x,
    params,
    columns=None,
    n_columns: int = 20,
    h: float = 1e-7,
    abs_tol: float = 1e-5,
    rel_tol: float = 1e-4,
    seed: int = 0,
) -> JacCheckResult:
    """Compare AD Jacobian columns against central finite differences.

    Error classification follows the reference's scaled test: an entry is
    flagged when |ad-fd| > abs_tol + rel_tol * max(|ad|, |fd|). ``x`` is
    host numpy (or array-like); the assemblies run on the Problem's
    device and come back to the host."""
    x = np.asarray(x, dtype=float)
    n = problem.dofmap.n_dof
    if columns is None:
        rng = np.random.RandomState(seed)
        columns = rng.choice(n, size=min(n_columns, n), replace=False)

    def put(a):
        return torch.as_tensor(a, dtype=problem.dtype, device=problem.device)

    def resid(a):
        return problem.residual(put(a), params).cpu().numpy()

    _, vals = problem.assemble(put(x), params)
    pat = problem.pattern
    vals = vals.cpu().numpy()

    bad = []
    worst_abs = worst_rel = 0.0
    checked = 0
    for j in columns:
        xp = x.copy()
        xp[j] += h
        xm = x.copy()
        xm[j] -= h
        fd = (resid(xp) - resid(xm)) / (2 * h)
        # AD column j: entries of vals where pattern col == j
        mask = pat.indices == j
        ad_col = np.zeros(n)
        ad_col[pat.rows[mask]] = vals[mask]
        err = np.abs(ad_col - fd)
        scale = abs_tol + rel_tol * np.maximum(np.abs(ad_col), np.abs(fd))
        bad_rows = np.where(err > scale)[0]
        checked += n
        for r in bad_rows:
            bad.append((int(r), int(j), float(ad_col[r]), float(fd[r])))
        if err.size:
            worst_abs = max(worst_abs, float(err.max()))
            rel = err / np.maximum(np.maximum(np.abs(ad_col), np.abs(fd)), 1e-30)
            sig = err > abs_tol
            if np.any(sig):
                worst_rel = max(worst_rel, float(rel[sig].max()))
    return JacCheckResult(checked, len(bad), worst_abs, worst_rel, bad)
