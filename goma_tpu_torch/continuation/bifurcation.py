"""Bifurcation (singular-point) tracking: turning points (folds),
pitchforks, and Hopf points (counterpart of
``goma_tpu/continuation/bifurcation.py``).

Parity: reference LOCA bordering algorithms (``src/loca_bord.c`` —
turning-point, pitchfork, and Hopf tracking, driven through
``src/ac_loca_interface.c do_loca``). The reference hand-codes the
second-derivative (J v)_x action by finite differences of the Jacobian and
solves the Hopf complex systems through ARPACK/LAPACK helpers
(``src/loca_eigen_cayley.F``); here every derivative action — G_lam, the
Hessian actions, and the mass-matrix action M v = dR/d(xdot) v — is an exact
(possibly nested) ``torch.func.jvp`` of the residual
(``Problem._residual_only``) on the problem's device, and the Hopf complex
bordered solves use a host complex sparse LU (SciPy), each crossing between
device and host explicit and in float64.

Moore-Spence extended system for a fold at (x*, lam*):

    G(x, lam)      = 0      (equilibrium)
    J(x, lam) v    = 0      (singular Jacobian, null vector v)
    c . v - 1      = 0      (normalization)

solved by Newton with block elimination — four J-solves per iteration
(a = J^-1 G, b = J^-1 G_lam, and two for the null-vector row), the same
bordering structure the reference uses, so the only large solves are with
the standard Jacobian and any of the framework's linear solvers applies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from goma_tpu_torch.continuation.conti import (_device, _host, _linsolver,
                                               _scalar)
from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver


@dataclass
class FoldResult:
    x: np.ndarray
    lam: float
    null_vector: np.ndarray
    iters: int
    converged: bool
    res_norms: list


def _jvp(f, primal, tangent):
    from torch.func import jvp

    return jvp(f, (primal,), (tangent,))[1]


def _make_ops(problem, make_params):
    """The residual and its derivative actions of the extended system, on
    device tensors (``lam`` a 0-d tensor)."""

    def res(x, lam):
        return problem._residual_only(x, make_params(lam))

    def Jv(x, lam, v):
        return _jvp(lambda xx: res(xx, lam), x, v)

    def G_lam(x, lam):
        return _jvp(lambda lv: res(x, lv), lam, torch.ones_like(lam))

    def Hx_v(x, lam, v, dx):
        # (J v)_x dx: second derivative of G, exact nested jvp
        return _jvp(lambda xx: Jv(xx, lam, v), x, dx)

    def Hlam_v(x, lam, v):
        return _jvp(lambda lv: Jv(x, lv, v), lam, torch.ones_like(lam))

    return res, Jv, G_lam, Hx_v, Hlam_v


def fold_track(
    problem,
    make_params: Callable[[float], dict],
    lam0: float,
    x0,
    newton_options: NewtonOptions | None = None,
    max_iter: int = 20,
    tol: float = 1e-8,
    v0=None,
) -> FoldResult:
    """Converge onto the turning point nearest (x0, lam0).

    ``make_params(lam)`` must be traceable in lam (a 0-d tensor: the usual
    params builder). Start from a converged (or near-converged) point on the
    branch close to the fold — e.g. the last step before ``detect_folds``
    fires in an arclength run.
    """
    opts = newton_options or NewtonOptions(linear_solver="direct")
    solver = NewtonSolver(problem, opts)
    linsolve = _linsolver(problem, solver)
    res_f, Jv_f, Glam_f, Hxv_f, Hlamv_f = _make_ops(problem, make_params)

    x = _device(problem, np.asarray(x0, dtype=float))
    lam = _scalar(problem, lam0)
    n = x.shape[0]

    # null-vector seed: inverse iteration with the (near-singular) Jacobian
    _, vals = problem.assemble(x, make_params(lam))
    if v0 is None:
        rng = np.random.RandomState(0)
        v = linsolve(vals, rng.standard_normal(n))
    else:
        v = np.asarray(v0, dtype=float)
    v = v / np.linalg.norm(v)
    c = v.copy()  # fixed normalization vector

    norms = []
    converged = False
    it = 0
    best = (np.inf, None)
    for it in range(max_iter):
        params = make_params(lam)
        Rg = _host(res_f(x, lam))
        S = _host(Jv_f(x, lam, _device(problem, v)))
        N = float(np.dot(c, v) - 1.0)
        rnorm = max(np.abs(Rg).max(), np.abs(S).max(), abs(N))
        norms.append(rnorm)
        if rnorm < best[0]:
            best = (rnorm, (_host(x).copy(), float(lam), v.copy()))
        if rnorm < tol:
            converged = True
            break
        # AT the fold J is exactly singular: once the iterates are converged
        # to solver precision the bordered solves turn to noise — stop at the
        # best iterate instead of wandering
        if best[0] < np.inf and rnorm > 100.0 * best[0]:
            break

        _, vals = problem.assemble(x, params)
        gl = _host(Glam_f(x, lam))
        a = linsolve(vals, Rg)       # J a = G
        b = linsolve(vals, gl)       # J b = G_lam
        vj = _device(problem, v)
        Hxa = _host(Hxv_f(x, lam, vj, _device(problem, a)))
        Hxb = _host(Hxv_f(x, lam, vj, _device(problem, b)))
        Hl = _host(Hlamv_f(x, lam, vj))
        # dv = p + dlam q with J p = -S + Hx a, J q = Hx b - Hlam
        p = linsolve(vals, -S + Hxa)
        q = linsolve(vals, Hxb - Hl)
        cq = np.dot(c, q)
        if abs(cq) < 1e-300:
            break
        dlam = -(N + np.dot(c, p)) / cq
        dx = -a - dlam * b
        dv = p + dlam * q
        x = x + _device(problem, dx)
        v = v + dv
        lam = lam + _scalar(problem, dlam)
        if not (np.all(np.isfinite(_host(x))) and np.isfinite(float(lam))):
            break

    if best[1] is not None:
        xb, lb, vb = best[1]
        return FoldResult(x=xb, lam=lb, null_vector=vb, iters=it,
                          converged=best[0] < tol, res_norms=norms)
    return FoldResult(
        x=_host(x), lam=float(lam), null_vector=v,
        iters=it, converged=converged, res_norms=norms,
    )


# --------------------------------------------------------------- pitchfork
@dataclass
class PitchforkResult:
    x: np.ndarray
    lam: float
    sigma: float
    null_vector: np.ndarray
    iters: int
    converged: bool
    res_norms: list


def pitchfork_track(
    problem,
    make_params: Callable[[float], dict],
    lam0: float,
    x0,
    psi,
    newton_options: NewtonOptions | None = None,
    max_iter: int = 25,
    tol: float = 1e-8,
    v0=None,
) -> PitchforkResult:
    """Converge onto a pitchfork point (reference: LOCA pitchfork bordering,
    src/loca_bord.c). Moore-Spence pitchfork system, unknowns (x, v, sigma,
    lam):

        G(x, lam) + sigma psi = 0      (sigma unfolds the symmetric branch)
        J(x, lam) v           = 0
        psi . x               = 0      (solution stays symmetric)
        c . v - 1             = 0

    ``psi`` is the (anti)symmetry-breaking direction. Six J-solves per
    Newton iteration (block elimination), each through the host direct
    solve as in goma_tpu (``newton_options`` is accepted and unused there
    too).
    """
    from goma_tpu_torch.solvers.linear import direct_solve_host

    def linsolve(vals, rhs):
        return np.asarray(direct_solve_host(problem.pattern, _host(vals),
                                            _host(rhs)))

    res_f, Jv_f, Glam_f, Hxv_f, Hlamv_f = _make_ops(problem, make_params)

    x = _device(problem, np.asarray(x0, dtype=float))
    lam = _scalar(problem, lam0)
    sigma = 0.0
    psi = np.asarray(psi, dtype=float)
    psi = psi / np.linalg.norm(psi)

    _, vals = problem.assemble(x, make_params(lam))
    if v0 is None:
        v = linsolve(vals, psi)  # inverse iteration seeded with psi
        if not np.all(np.isfinite(v)):
            v = psi.copy()
    else:
        v = np.asarray(v0, dtype=float)
    v = v / np.linalg.norm(v)
    c = v.copy()

    norms = []
    converged = False
    it = 0
    best = (np.inf, None)
    for it in range(max_iter):
        params = make_params(lam)
        Rg = _host(res_f(x, lam)) + sigma * psi
        vj = _device(problem, v)
        S = _host(Jv_f(x, lam, vj))
        Nsym = float(np.dot(psi, _host(x)))
        Nnorm = float(np.dot(c, v) - 1.0)
        rnorm = max(np.abs(Rg).max(), np.abs(S).max(), abs(Nsym), abs(Nnorm))
        norms.append(rnorm)
        if rnorm < best[0]:
            best = (rnorm, (_host(x).copy(), float(lam), float(sigma), v.copy()))
        if rnorm < tol:
            converged = True
            break
        if best[0] < np.inf and rnorm > 100.0 * best[0]:
            break

        _, vals = problem.assemble(x, params)
        gl = _host(Glam_f(x, lam))
        a = linsolve(vals, Rg)      # J a = G + sigma psi
        b = linsolve(vals, gl)      # J b = G_lam
        e = linsolve(vals, psi)     # J e = psi
        Hxa = _host(Hxv_f(x, lam, vj, _device(problem, a)))
        Hxb = _host(Hxv_f(x, lam, vj, _device(problem, b)))
        Hxe = _host(Hxv_f(x, lam, vj, _device(problem, e)))
        Hl = _host(Hlamv_f(x, lam, vj))
        p = linsolve(vals, -S + Hxa)       # dv = p + dlam q + dsig r
        q = linsolve(vals, Hxb - Hl)
        rv = linsolve(vals, Hxe)
        # dx = -a - dlam b - dsig e; constraints:
        #   psi.dx = -Nsym ;  c.dv = -Nnorm
        A2 = np.array([
            [np.dot(psi, b), np.dot(psi, e)],
            [np.dot(c, q), np.dot(c, rv)],
        ])
        rhs2 = np.array([Nsym - np.dot(psi, a), -Nnorm - np.dot(c, p)])
        try:
            dlam, dsig = np.linalg.solve(A2, rhs2)
        except np.linalg.LinAlgError:
            break
        dx = -a - dlam * b - dsig * e
        dv = p + dlam * q + dsig * rv
        x = x + _device(problem, dx)
        v = v + dv
        lam = lam + _scalar(problem, dlam)
        sigma = sigma + float(dsig)
        if not (np.all(np.isfinite(_host(x))) and np.isfinite(float(lam))):
            break

    if best[1] is not None:
        xb, lb, sb, vb = best[1]
        return PitchforkResult(x=xb, lam=lb, sigma=sb, null_vector=vb, iters=it,
                               converged=best[0] < tol, res_norms=norms)
    return PitchforkResult(x=_host(x), lam=float(lam), sigma=float(sigma),
                           null_vector=v, iters=it, converged=converged,
                           res_norms=norms)


# -------------------------------------------------------------------- Hopf
@dataclass
class HopfResult:
    x: np.ndarray
    lam: float
    omega: float
    eigvec: np.ndarray  # complex (n,)
    iters: int
    converged: bool
    res_norms: list


def hopf_track(
    problem,
    make_params: Callable[[float], dict],
    lam0: float,
    omega0: float,
    x0,
    w0=None,
    max_iter: int = 30,
    tol: float = 1e-8,
) -> HopfResult:
    """Converge onto a Hopf point (reference: LOCA Hopf bordering,
    src/loca_bord.c + complex eigensolves src/loca_eigen_cayley.F).

    Extended system in complex form, unknowns (x, w, omega, lam):

        G(x, lam)                      = 0
        C w := (J + i omega M) w       = 0       (M = dR/d(xdot))
        phi . w - 1                    = 0       (complex normalization)

    Newton with block elimination: two real J-solves + three complex
    C-solves per iteration (host complex sparse LU), all derivative actions
    exact jvp on the device; a complex vector's action is its real and
    imaginary parts', each a real float64 vector sent to the device.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    dtype = problem.dtype
    zeros_h = torch.zeros(np.asarray(x0).shape[0], dtype=dtype,
                          device=problem.device)

    def res(x, lam, hist):
        p = make_params(lam)
        p["hist"] = hist
        return problem._residual_only(x, p)

    def Jv_f(x, lam, v):
        return _jvp(lambda xx: res(xx, lam, zeros_h), x, v)

    def Mv_f(x, lam, v):
        # M v = dR/d(xdot) v: qdot = ct x + hist -> differentiate along hist
        return _jvp(lambda h: res(x, lam, h), zeros_h, v)

    def Glam_f(x, lam):
        return _jvp(lambda lv: res(x, lv, zeros_h), lam, torch.ones_like(lam))

    def Jv_x_f(x, lam, v, dx):
        return _jvp(lambda xx: Jv_f(xx, lam, v), x, dx)

    def Mv_x_f(x, lam, v, dx):
        return _jvp(lambda xx: Mv_f(xx, lam, v), x, dx)

    def Jv_lam_f(x, lam, v):
        return _jvp(lambda lv: Jv_f(x, lv, v), lam, torch.ones_like(lam))

    def Mv_lam_f(x, lam, v):
        return _jvp(lambda lv: Mv_f(x, lv, v), lam, torch.ones_like(lam))

    def assemble_JM(x, lam):
        """CSR values of J and M (M = A(ct=1) - A(ct=0), the stability.py
        identity, src parity: ac_stability.c mass-matrix assembly), host
        float64."""
        p0 = make_params(lam)
        p0["ct"] = _scalar(problem, 0.0)
        _, vJ = problem.assemble(x, p0)
        p1 = make_params(lam)
        p1["ct"] = _scalar(problem, 1.0)
        _, vJM = problem.assemble(x, p1)
        vJ = _host(vJ)
        return vJ, _host(vJM) - vJ

    pat = problem.pattern

    def csr(valsc):
        return sp.csr_matrix((valsc, pat.indices, pat.indptr), shape=(pat.n, pat.n))

    x = _device(problem, np.asarray(x0, dtype=float))
    lam = _scalar(problem, lam0)
    omega = float(omega0)
    n = x.shape[0]

    vJ, vM = assemble_JM(x, lam)
    C = (csr(vJ) + 1j * omega * csr(vM)).tocsc()
    lu = spla.splu(C)
    if w0 is None:
        rng = np.random.RandomState(0)
        w = lu.solve(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    else:
        w = np.asarray(w0, dtype=complex)
    w = w / np.linalg.norm(w)
    phi = w.copy()  # fixed complex normalization vector

    def cjvp(fun_re, v):
        """Apply a real-linear device operator to a complex host vector."""
        return (_host(fun_re(_device(problem, np.real(v))))
                + 1j * _host(fun_re(_device(problem, np.imag(v)))))

    norms = []
    converged = False
    best = (np.inf, None)
    it = 0
    for it in range(max_iter):
        Rg = _host(res(x, lam, zeros_h))
        Jw = cjvp(lambda vr: Jv_f(x, lam, vr), w)
        Mw = cjvp(lambda vr: Mv_f(x, lam, vr), w)
        Cw = Jw + 1j * omega * Mw
        Nc = np.dot(phi.conj(), w) - 1.0
        rnorm = max(np.abs(Rg).max(), np.abs(Cw).max(), abs(Nc))
        norms.append(rnorm)
        if rnorm < best[0]:
            best = (rnorm, (_host(x).copy(), float(lam), omega, w.copy()))
        if rnorm < tol:
            converged = True
            break
        if best[0] < np.inf and rnorm > 100.0 * best[0]:
            break

        vJ, vM = assemble_JM(x, lam)
        Jmat = csr(vJ)
        Mmat = csr(vM)
        luJ = spla.splu(Jmat.tocsc())
        C = (Jmat + 1j * omega * Mmat).tocsc()
        lu = spla.splu(C)

        gl = _host(Glam_f(x, lam))
        a = luJ.solve(Rg)          # J a = G
        b = luJ.solve(gl)          # J b = G_lam
        aj = _device(problem, a)
        bj = _device(problem, b)

        # (Cw)_x dx and (Cw)_lam actions (exact, complex = re + i im parts)
        def Cw_x(dxj):
            return (cjvp(lambda vr: Jv_x_f(x, lam, vr, dxj), w)
                    + 1j * omega * cjvp(lambda vr: Mv_x_f(x, lam, vr, dxj), w))

        Cw_a = Cw_x(aj)
        Cw_b = Cw_x(bj)
        Cw_l = (cjvp(lambda vr: Jv_lam_f(x, lam, vr), w)
                + 1j * omega * cjvp(lambda vr: Mv_lam_f(x, lam, vr), w))
        # dw = p + dlam q + domega r, complex solves with C
        p = lu.solve(-Cw + Cw_a)
        q = lu.solve(Cw_b - Cw_l)
        rv = lu.solve(-1j * Mw)
        # complex constraint phi* . dw = -Nc -> 2x2 real system in (dlam, domega)
        pq = np.dot(phi.conj(), q)
        pr = np.dot(phi.conj(), rv)
        pp = np.dot(phi.conj(), p)
        A2 = np.array([[np.real(pq), np.real(pr)], [np.imag(pq), np.imag(pr)]])
        rhs2 = -np.array([np.real(Nc + pp), np.imag(Nc + pp)])
        try:
            dlam, domega = np.linalg.solve(A2, rhs2)
        except np.linalg.LinAlgError:
            break
        dx = -a - dlam * b
        dw = p + dlam * q + domega * rv
        x = x + _device(problem, dx)
        w = w + dw
        lam = lam + _scalar(problem, dlam)
        omega = omega + float(domega)
        if not (np.all(np.isfinite(_host(x))) and np.isfinite(float(lam))
                and np.isfinite(omega)):
            break

    if best[1] is not None:
        xb, lb, ob, wb = best[1]
        return HopfResult(x=xb, lam=lb, omega=ob, eigvec=wb, iters=it,
                          converged=best[0] < tol, res_norms=norms)
    return HopfResult(x=_host(x), lam=float(lam), omega=omega, eigvec=w,
                      iters=it, converged=converged, res_norms=norms)
