"""Population-balance moment equations, QMOM with N = 2 (counterpart of
``goma_tpu/physics/population.py``).

Parity: reference ``src/mm_fill_population.c``: transported moments M_k,
k = 0..3, of the particle size distribution closed by quadrature (the
adaptive Wheeler inversion, :205), with growth and nucleation sources at
the recovered abscissas,

    dM_k/dt + u.grad M_k = sum_j w_j [ k G(L_j) L_j^{k-1} ] + B0 L0^k.

The two-node Jacobi eigenproblem is solved in closed form; the adaptive
inversion's degeneracy ladder is a set of ``torch.where`` selects (whose
tangent takes only the selected branch's). goma_tpu's 1e-300 floors are
1e-300 in float64 and the smallest normal number in float32 (where 1e-300
rounds to 0), as in ``kinetics.py``.
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.fluid import advective_velocity
from goma_tpu_torch.physics.materials import _floor, _tiny

MOM_VAR = "moments"


def wheeler_n2(m):
    """Wheeler inversion for N=2 nodes from moments (m0..m3).
    Returns (weights (..., 2), abscissas (..., 2)), batched over leading
    axes."""
    small = _tiny(m.dtype)
    m0 = _floor(m[..., 0], small)
    s1 = m[..., 1] / m0
    s2 = m[..., 2] / m0
    s3 = m[..., 3] / m0
    # central moments
    c2 = _floor(s2 - s1**2, small)
    c3 = s3 - 3 * s1 * s2 + 2 * s1**3
    # Jacobi matrix [[a0, sqrt(b1)], [sqrt(b1), a1]]
    a0 = s1
    b1 = c2
    a1 = c3 / c2 + s1
    tr = a0 + a1
    det = a0 * a1 - b1
    disc = torch.sqrt(_floor(tr**2 / 4 - det, 0.0))
    L1 = tr / 2 - disc
    L2 = tr / 2 + disc
    # weights w_i = m0 v0i^2, eigenvector for L: (sqrt(b1), L - a0)
    sb = torch.sqrt(b1)

    def w_of(L):
        v0, v1 = sb, L - a0
        return m0 * v0**2 / _floor(v0**2 + v1**2, small)

    return torch.stack([w_of(L1), w_of(L2)], -1), torch.stack([L1, L2], -1)


def adaptive_wheeler_n2(m, rmin=(0.0, 1e-6), eabs: float = 1e-4):
    """Adaptive Wheeler inversion for up to N = 2 nodes (the reference's
    MAX_MOMENTS = 4 cap), ``adaptive_wheeler``
    (``src/mm_fill_population.c:205``) with its degeneracy ladder as
    ``where`` selects:

    - ``m0 <= 0``: one zero node/weight;
    - ``m0 < rmin[0]``: a single node (w0 = m0, L0 = m1/m0);
    - unrealizable set (Wheeler ``b1 < 0``): the Wright log-normal moment
      correction (``moment_correction_wright``), then re-invert;
    - degenerate recursion (``sig[2][2] <= 0``), ``minw/maxw <= rmin[1]``
      or ``|L2 - L1| <= eabs``: a single node.

    Returns (weights (..., 2), nodes (..., 2), n_out (...,) int32); a
    collapsed set has w = (m0, 0), L = (m1/m0, 0).
    """
    m = torch.as_tensor(m)
    small = _tiny(m.dtype)

    def invert(mm):
        m0 = _floor(mm[..., 0], small)
        a0 = mm[..., 1] / m0
        # Wheeler sigma recursion, k = 2 row (N = 2), b0 = 0
        sig2_2 = mm[..., 2] - a0 * mm[..., 1]
        sig2_3 = mm[..., 3] - a0 * mm[..., 2]
        a1 = sig2_3 / torch.where(torch.abs(sig2_2) > small, sig2_2,
                                  torch.full_like(sig2_2, small)) - a0
        b1 = sig2_2 / m0
        return a0, a1, b1, sig2_2

    a0, a1, b1, sig22 = invert(m)
    # unrealizable (b1 < 0): Wright correction then re-invert
    unreal = b1 < 0.0
    m_use = torch.where(unreal[..., None], moment_correction_wright(m), m)
    a0, a1, b1, sig22 = invert(m_use)

    # 2-node eigen solve of [[a0, -sqrt(b1)], [-sqrt(b1), a1]]
    b1c = _floor(b1, 0.0)
    tr = a0 + a1
    disc = torch.sqrt(_floor(0.25 * (a0 - a1) ** 2 + b1c, 0.0))
    L1 = 0.5 * tr - disc
    L2 = 0.5 * tr + disc
    sb = torch.sqrt(b1c)
    m0 = _floor(m_use[..., 0], small)

    def w_of(L):
        v0, v1 = sb, L - a0
        return m0 * v0**2 / _floor(v0**2 + v1**2, small)

    w1, w2 = w_of(L1), w_of(L2)

    # adaptivity ladder -> collapse to n = 1
    minw = torch.minimum(w1, w2)
    maxw = torch.maximum(w1, w2)
    sep = torch.abs(L2 - L1)  # maxmab = 1 for n = 2 in the reference
    collapse = ((m_use[..., 0] < rmin[0]) | (sig22 <= 0.0)
                | (minw / _floor(maxw, small) <= rmin[1]) | (sep <= eabs))
    zero = m[..., 0] <= small
    n_out = torch.where(zero | collapse, 1, 2).to(torch.int32)
    Lmean = m_use[..., 1] / m0
    z0 = torch.zeros_like(w1)
    w_out = torch.stack([
        torch.where(zero, z0, torch.where(collapse, m_use[..., 0], w1)),
        torch.where(zero | collapse, z0, w2)], dim=-1)
    L_out = torch.stack([
        torch.where(zero, z0, torch.where(collapse, Lmean, L1)),
        torch.where(zero | collapse, z0, L2)], dim=-1)
    return w_out, L_out, n_out


class MomentEquations(Equation):
    """Four transported moments (N=2 QMOM) with growth G(L) and nucleation.

    growth: callable G(L) -> growth rate (a tensor function); nucleation
    rate B0 at size L0. ``adaptive=True`` closes the sources with the
    reference's adaptive Wheeler (node reduction + Wright correction,
    ``src/mm_fill_population.c:205``) instead of the plain inversion.
    """

    def __init__(self, growth=None, nucleation_rate: float = 0.0,
                 L0: float = 0.0, interp: str = "Q1", transient: bool = True,
                 supg: float = 0.5, adaptive: bool = False):
        super().__init__(MOM_VAR, 4, interp)
        self.growth = growth
        self.B0 = nucleation_rate
        self.L0 = L0
        self.transient = transient
        self.supg = supg
        self.adaptive = adaptive

    def residual(self, fv, mat, params):
        M = fv.val[MOM_VAR]  # (nq, 4)
        gM = fv.grad[MOM_VAR]  # (nq, 4, dim)
        if "velocity" in fv.val:
            u = advective_velocity(fv)
            adv = torch.einsum("qk,qck->qc", u, gM)
        else:
            u = torch.zeros_like(fv.x)
            adv = torch.zeros_like(M)
        r = adv
        if self.transient:
            r = r + fv.dot[MOM_VAR]

        # quadrature closure source
        if self.growth is not None or self.B0 != 0.0:
            if self.adaptive:
                w, L, _ = adaptive_wheeler_n2(M)  # (nq, 2)
            else:
                w, L = wheeler_n2(M)  # (nq, 2)
            src = torch.zeros_like(M)
            ks = torch.arange(4.0, dtype=M.dtype, device=M.device)
            if self.growth is not None:
                G = self.growth(L)  # (nq, 2)
                Lsafe = _floor(L, _tiny(L.dtype))
                # k G(L_j) L_j^{k-1}
                src = src + torch.einsum(
                    "k,qj,qkj->qk", ks, w * G,
                    Lsafe[:, None, :] ** _floor(ks - 1.0, 0.0)[None, :, None])
            if self.B0 != 0.0:
                src = src + self.B0 * (self.L0 ** ks)[None, :]
            r = r - src

        phi = fv.phi[MOM_VAR]
        if self.supg > 0 and "velocity" in fv.val:
            u2 = torch.sum(u * u, dim=1)
            tau = (self.supg * fv.h_elem * torch.sqrt(u2 + 1e-30)
                   / (2.0 * u2 + 1e-12))
            w_t = phi + tau[:, None] * torch.einsum("qk,qik->qi", u,
                                                    fv.gphi[MOM_VAR])
        else:
            w_t = phi
        return torch.einsum("qc,qi->qci", r, w_t)


def lognormal_moments(m, i: int = 1, j: int = 3, n_moments: int = 4):
    """Moments of the log-normal distribution fitted through (m0, m_i,
    m_j) (reference ``moments_set_lognormal``, src/mm_fill_population.c:55):
    mu and sigma^2 from two moment ratios, then M_k = m0 exp(k mu + k^2
    sigma^2 / 2). Batched over leading axes."""
    small = _tiny(m.dtype)
    m0 = _floor(m[..., 0], small)
    ri = torch.log(_floor(m[..., i], small) / m0)
    rj = torch.log(_floor(m[..., j], small) / m0)
    mu = (j / (i * j - i * i)) * ri + (i / (i * j - j * j)) * rj
    sig2 = ((2.0 / (j * j)) * rj - (2.0 / (i * j)) * ri) / (1.0 - i / j)
    sig2 = _floor(sig2, 0.0)
    ks = torch.arange(float(n_moments), dtype=m.dtype, device=m.device)
    return m0[..., None] * torch.exp(ks * mu[..., None]
                                     + 0.5 * ks**2 * sig2[..., None])


def moment_correction_wright(m, n_moments: int = 4):
    """Wright log-normal moment correction (reference
    ``moment_correction_wright:78``, after Marchisio & Fox 2013): the
    average of the log-normal reconstructions through (m0, m1, m3) and
    (m0, m2, m3)."""
    return 0.5 * (lognormal_moments(m, 1, 3, n_moments)
                  + lognormal_moments(m, 2, 3, n_moments))
