"""Restarted GMRES (counterpart of ``goma_tpu/solvers/linear.py``).

Right-preconditioned GMRES with vectorized classical Gram-Schmidt plus one
reorthogonalization pass (CGS2: two (m+1, n) matrix-vector products per
Arnoldi step), Givens rotations accumulated in a dense (m+1, m+1) ``Q``, and
an early exit inside the cycle once the running residual estimate
``|Q[j+1, 0] beta|`` reaches the target. ``cnt`` counts the Arnoldi steps
taken, exactly as goma_tpu's device loop counts them; the Newton loop
counts linear iterations from it.

goma_tpu runs the cycle as one device program (``lax.fori_loop`` with a
``lax.cond`` skip). Here the loop is on the host and reads the estimate
back after every step: one device sync per Arnoldi step, a later
optimization target (a CUDA graph or a batched-check variant).

The first read of a call is one sync for ``||b||``, the first residual
norm, the tolerance when it is a device tensor, and any ``extra`` tensors
the caller lets ride on it (the pipelined Newton loop's residual norms,
as goma_tpu's ``_linsolve_gmres`` folds its ``extra_fetch`` into the first
cycle's fetch).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from goma_tpu_torch.utils.la import lstsq_small


@dataclass
class LinearResult:
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool
    # from the call's first read: ||b||, the tolerance as used, and the
    # values of the ``extra`` tensors (flattened, float64)
    bnorm: float = 0.0
    tol: float = 0.0
    extra: list = field(default_factory=list)


def identity_precond(r):
    return r


def read_scalars(tensors) -> list:
    """One host read of the values of ``tensors`` (any shapes, flattened in
    order) as Python floats; float32 values widen to float64 exactly."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).tolist()


def gmres(matvec, b, precond=None, x0=None, tol=1e-8, atol=0.0, restart=40,
          maxiter=200, extra=()):
    """Right-preconditioned restarted GMRES. ``matvec``/``precond`` are
    callables on vectors of b's dtype and device; ``tol`` a float or a 0-d
    tensor; ``extra`` tensors read back with ``||b||`` in the first sync
    (``LinearResult.extra``). Returns LinearResult."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    if precond is None:
        precond = identity_precond
    if x0 is None:
        x0 = torch.zeros_like(b)
    m = restart

    r = b - matvec(x0)
    beta_t = torch.linalg.norm(r)
    tol_dev = torch.is_tensor(tol)
    got = read_scalars([torch.linalg.norm(b), beta_t]
                       + ([tol] if tol_dev else []) + list(extra))
    bnorm, rn = got[0], got[1]
    if tol_dev:
        tol = got[2]
    extra_vals = got[3 if tol_dev else 2:]
    target = max(tol * bnorm, atol)

    def arnoldi_cycle(x, r, beta_t, beta):
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        V[0] = r / (beta_t if beta > 0 else 1.0)
        Q = torch.eye(m + 1, dtype=dtype, device=dev)
        done = beta <= target
        cnt = 0
        for j in range(m):
            if done:
                break
            w = matvec(precond(V[j]))
            # CGS2 against the first j+1 basis vectors
            Vj = V[:j + 1]
            h = Vj @ w
            w = w - Vj.T @ h
            h2 = Vj @ w
            w = w - Vj.T @ h2
            h = h + h2
            wn = torch.linalg.norm(w)
            H[:j + 1, j] = h
            H[j + 1, j] = wn
            V[j + 1] = w / torch.where(wn > 1e-30, wn, torch.ones_like(wn))
            hr = Q @ H[:, j]
            a0, a1 = hr[j], hr[j + 1]
            rr = torch.sqrt(a0 * a0 + a1 * a1)
            ok = rr > 1e-30
            rr_safe = torch.where(ok, rr, torch.ones_like(rr))
            c_ = torch.where(ok, a0 / rr_safe, torch.ones_like(rr))
            s_ = torch.where(ok, a1 / rr_safe, torch.zeros_like(rr))
            qj, qj1 = Q[j].clone(), Q[j + 1].clone()
            Q[j] = c_ * qj + s_ * qj1
            Q[j + 1] = -s_ * qj + c_ * qj1
            cnt += 1
            done = float(torch.abs(Q[j + 1, 0] * beta_t)) <= target
        # least squares min || beta e1 - H y || (unexecuted columns are zero;
        # the regularized solve returns y = 0 there)
        e1 = torch.zeros(m + 1, dtype=dtype, device=dev)
        e1[0] = beta_t
        y = lstsq_small(H, e1)
        return x + precond(V[:m].T @ y), cnt

    x = x0
    it = 0
    while rn > target and it < maxiter:
        x, cnt = arnoldi_cycle(x, r, beta_t, rn)
        r = b - matvec(x)
        beta_t = torch.linalg.norm(r)
        rn = float(beta_t)
        it += cnt
        if cnt == 0:  # the cycle found the target met: nothing can improve
            break
    return LinearResult(x=x, iters=it, resnorm=rn, converged=rn <= target,
                        bnorm=bnorm, tol=tol, extra=extra_vals)
