"""Point location in the isoparametric map (counterpart of the host
element location of ``goma_tpu/post/particles.py``, host numpy, copied).

Cut to ``_invert_map``, which the overset coupling sets of
``Problem.add_overset`` locate their points with; goma_tpu's
``FieldSampler`` and particle traces are a later slice (see ROADMAP).
"""

from __future__ import annotations

import numpy as np

from goma_tpu_torch.elements import eval_basis, geom_interp


def _invert_map(et, X, pt, tol=1e-10, maxit=30):
    """Newton inversion of the isoparametric map; returns (xi, inside)."""
    dim = et.dim
    gi = geom_interp(et)
    xi = np.full(dim, 0.0 if et.family in ("quad", "hex", "bar") else 1.0 / 3.0)
    for _ in range(maxit):
        N, dN = eval_basis(et.family, gi, xi[None, :])
        r = N[0] @ X - pt
        if np.linalg.norm(r) < tol:
            break
        J = dN[0].T @ X  # (dim_ref, dim_x): J[d,k]
        try:
            dxi = np.linalg.solve(J @ J.T, J @ r)
        except np.linalg.LinAlgError:
            return xi, False
        xi = xi - dxi
        if np.max(np.abs(xi)) > 3.0:
            return xi, False
    eps = 1e-8
    if et.family in ("quad", "hex", "bar"):
        inside = np.all(np.abs(xi) <= 1 + eps)
    else:
        inside = np.all(xi >= -eps) and xi.sum() <= 1 + eps
    return xi, bool(inside and np.linalg.norm(N[0] @ X - pt) < 1e-8)
