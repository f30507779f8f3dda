"""Small dense linear algebra (counterpart of ``goma_tpu/utils/la.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gj_inv(A):
    """Batched Gauss-Jordan inverse with partial pivoting of (..., k, k),
    in goma_tpu's one-hot algebra step for step (so its rounding, and the
    first-maximum pivot choice of ``argmax``, are goma_tpu's). k <= 3 takes
    the closed form. No library call and no host sync: a singular block
    gives inf/nan entries, which the callers zero."""
    k = A.shape[-1]
    if k <= 3:
        return det_and_inv(A)[1]
    dtype, dev = A.dtype, A.device
    eye = torch.eye(k, dtype=dtype, device=dev).expand(*A.shape[:-2], k, k)
    M = torch.cat([A, eye], dim=-1)  # (..., k, 2k)
    rk = torch.arange(k, device=dev)
    r2k = torch.arange(2 * k, device=dev)
    for i in range(k):
        ei = (rk == i).to(dtype)
        ci = (r2k == i).to(dtype)
        # partial pivot among rows >= i
        col = torch.einsum("j,...kj->...k", ci, M)
        cand = torch.where(rk >= i, torch.abs(col), -1.0)
        ep = F.one_hot(torch.argmax(cand, dim=-1), k).to(dtype)
        row_i = torch.einsum("k,...kj->...j", ei, M)
        row_p = torch.einsum("...k,...kj->...j", ep, M)
        # swap rows i <-> p
        M = (M + ei[:, None] * (row_p - row_i)[..., None, :]
             + ep[..., :, None] * (row_i - row_p)[..., None, :])
        piv = torch.einsum("j,...j->...", ci, row_p)
        piv = torch.where(torch.abs(piv) > 1e-300, piv, 1.0)
        rowi_n = row_p / piv[..., None]
        M = M + ei[:, None] * (rowi_n - row_p)[..., None, :]
        f = torch.einsum("j,...kj->...k", ci, M) * (1.0 - ei)
        M = M - f[..., None] * rowi_n[..., None, :]
    return M[..., :, k:]


def _schur_glue(A, B, C, D, inv):
    """inv([[A, B], [C, D]]) from inv(A) and inv(S), S = D - C inv(A) B."""
    Ai = inv(A)
    AiB = Ai @ B
    Si = inv(D - C @ AiB)
    CAi = C @ Ai
    return torch.cat([torch.cat([Ai + AiB @ (Si @ CAi), -(AiB @ Si)], dim=1),
                      torch.cat([-(Si @ CAi), Si], dim=1)], dim=0)


def blocked_inv(M, max_block: int = 8192):
    """Dense inverse by recursive 2x2 block (Schur-complement) splits at a
    128-aligned midpoint, leaves up to ``max_block`` rows inverted by
    ``torch.linalg.inv_ex`` (no error check, so no host sync; a singular
    leaf gives non-finite entries). goma_tpu's split points."""
    n = M.shape[0]
    if n <= max_block:
        return torch.linalg.inv_ex(M).inverse
    k = min(((n + 1) // 2 + 127) // 128 * 128, n - 1)
    return _schur_glue(M[:k, :k], M[:k, k:], M[k:, :k], M[k:, k:],
                       lambda X: blocked_inv(X, max_block))


def saddle_split_inv(M, k, max_block: int = 8192):
    """Dense inverse of a saddle-point matrix [[A, B], [C, D]] whose first
    split is pinned to the elliptic/saddle boundary ``k`` (A elliptic, D
    the zero-diagonal block): A's principal minors are safe for further
    unpivoted splits and S = D - C A^-1 B is dense and well conditioned."""
    n = M.shape[0]
    if k <= 0 or k >= n:
        return blocked_inv(M, max_block)
    return _schur_glue(M[:k, :k], M[:k, k:], M[k:, :k], M[k:, k:],
                       lambda X: blocked_inv(X, max_block))


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
