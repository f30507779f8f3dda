"""Small dense linear algebra (counterpart of ``goma_tpu/utils/la.py``)."""

from __future__ import annotations

import torch


def lstsq_small(H, b):
    """Least squares min||H y - b|| for a small tall H (m1, m) via the
    normal equations, regularized for rank deficiency (unexecuted GMRES
    columns are zero). Normal equations square the conditioning, so the
    small solve always runs in float64 and casts back."""
    in_dtype = H.dtype
    H = H.to(torch.float64)
    b = b.to(torch.float64)
    m = H.shape[1]
    G = H.T @ H
    scale = torch.trace(G) / m + 1e-300
    G = G + (1e-14 * scale) * torch.eye(m, dtype=G.dtype, device=G.device)
    rhs = H.T @ b
    return torch.linalg.solve(G, rhs).to(in_dtype)


def det_and_inv(J):
    """Batched determinant and inverse of (..., d, d), d in {1, 2, 3}, in
    closed form (cofactors), as goma_tpu writes them: differentiable under
    ``torch.func`` and free of library calls."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        return det, (1.0 / det)[..., None, None]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        idet = 1.0 / det
        inv = torch.stack([torch.stack([e * idet, -b * idet], dim=-1),
                           torch.stack([-c * idet, a * idet], dim=-1)], dim=-2)
        return det, inv
    if d == 3:
        a00, a01, a02 = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
        a10, a11, a12 = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
        a20, a21, a22 = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a12 * a20 - a10 * a22
        c02 = a10 * a21 - a11 * a20
        det = a00 * c00 + a01 * c01 + a02 * c02
        idet = 1.0 / det
        c10 = a02 * a21 - a01 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a01 * a20 - a00 * a21
        c20 = a01 * a12 - a02 * a11
        c21 = a02 * a10 - a00 * a12
        c22 = a00 * a11 - a01 * a10
        inv = torch.stack([
            torch.stack([c00 * idet, c10 * idet, c20 * idet], dim=-1),
            torch.stack([c01 * idet, c11 * idet, c21 * idet], dim=-1),
            torch.stack([c02 * idet, c12 * idet, c22 * idet], dim=-1),
        ], dim=-2)
        return det, inv
    raise ValueError(d)
