"""Time-harmonic electromagnetics: the vector curl-curl wave equation
(counterpart of ``goma_tpu/physics/em.py``).

Parity: reference ``src/mm_fill_em.c`` (``assemble_emwave:75`` nodal E/H
formulation, ``assemble_ewave_curlcurl:856``) and the absorbing boundary
terms of ``src/mm_em_bc.c``. Complex fields are carried as coupled
real/imaginary variables (reference EM_E1_REAL.., ``include/rf_fem_const.h``
EM block).

E-field form, e^{+i omega t} convention:

    curl(1/mu curl E) - omega^2 eps_c E = -i omega J_s,  eps_c = eps - i sigma/omega

- ``EMWave``/``EMWaveH``: nodal (Q1/Q2) vector elements with the grad-div
  gauge, int (1/mu) curl E . curl phi + alpha div E div phi - omega^2 eps_c
  E . phi; the H form carries 1/eps_c inside the curl term.
- ``EMWaveEdge``: Nedelec (N1) edge elements, the curl-conforming space,
  no gauge; the covariant map and the curls come from
  ``fem.fields.eval_fieldvars``, the edge signs from the assembler.
- ``EMAbsorbingBC``/``EMAbsorbingBCH``: first-order Silver-Mueller faces,
  n x curl E = -i k n x (n x E), weak term (k/mu) (i E_t) . phi_t.
"""

from __future__ import annotations

import math

import torch

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.physics.materials import as_field, prop

E_RE, E_IM = "em_e_real", "em_e_imag"
H_RE, H_IM = "em_h_real", "em_h_imag"
EDGE_RE, EDGE_IM = "em_edge_real", "em_edge_imag"


def _sqrt(v):
    return torch.sqrt(v) if torch.is_tensor(v) else math.sqrt(v)


def _trace(g):
    return torch.diagonal(g, dim1=1, dim2=2).sum(-1)


def _curl(gE, dim):
    """curl from the gradient gE[q, a, k] = dE_a/dx_k: in 2D the scalar
    curl_z = dEy/dx - dEx/dy as (nq, 1); in 3D (nq, 3)."""
    if dim == 2:
        return (gE[:, 1, 0] - gE[:, 0, 1])[:, None]
    cx = gE[:, 2, 1] - gE[:, 1, 2]
    cy = gE[:, 0, 2] - gE[:, 2, 0]
    cz = gE[:, 1, 0] - gE[:, 0, 1]
    return torch.stack([cx, cy, cz], dim=1)


def _curl_basis(gphi, dim):
    """curl(phi_i e_a) of the vector basis, component a, scalar basis i:
    2D -> (nq, 2, nbf, 1); 3D -> (nq, 3, nbf, 3)."""
    if dim == 2:
        # curl_z(phi e_x) = -dphi/dy ; curl_z(phi e_y) = +dphi/dx
        cb = torch.stack([-gphi[:, :, 1], gphi[:, :, 0]], dim=1)
        return cb[..., None]
    z = torch.zeros_like(gphi[:, :, 0])
    cx = torch.stack([z, gphi[:, :, 2], -gphi[:, :, 1]], dim=-1)
    cy = torch.stack([-gphi[:, :, 2], z, gphi[:, :, 0]], dim=-1)
    cz = torch.stack([gphi[:, :, 1], -gphi[:, :, 0], z], dim=-1)
    return torch.stack([cx, cy, cz], dim=1)


class EMWave(Equation):
    """One real part of the complex curl-curl equation (nodal E).

    part: "real" | "imag". Material keys: ``mu_m``, ``eps``, ``sigma_em``
    (couples the parts) and the optional source currents ``J_re``/``J_im``
    (callables or constants, entering as -i omega J).
    """

    def __init__(self, part: str, omega: float, dim: int = 2,
                 interp: str = "Q2", alpha: float = 1.0):
        super().__init__(E_RE if part == "real" else E_IM, dim, interp)
        self.part = part
        self.omega = omega
        self.dim = dim
        self.alpha = alpha

    def residual(self, fv, mat, params):
        d = self.dim
        nq = fv.x.shape[0]
        w = self.omega
        mu_m = prop(mat, "mu_m", fv, params, 1.0)
        eps = prop(mat, "eps", fv, params, 1.0)
        sig = prop(mat, "sigma_em", fv, params, 0.0)

        E_s = fv.val[self.var]
        E_o = fv.val[E_IM if self.part == "real" else E_RE]
        g_s = fv.grad[self.var]
        curl_s = _curl(g_s, d)
        div_s = _trace(g_s)
        phi = fv.phi[self.var]
        gphi = fv.gphi[self.var]
        curl_b = _curl_basis(gphi, d)  # (nq, d, nbf, ncurl)

        c = torch.einsum("qc,qanc->qan", curl_s, curl_b) / mu_m
        c = c + self.alpha * torch.einsum("q,qna->qan", div_s, gphi)
        # -w^2 (eps - i sigma/w)(E_re + i E_im): real -w^2 eps E_re - w
        # sigma E_im, imaginary -w^2 eps E_im + w sigma E_re
        if self.part == "real":
            react = -(w * w) * eps * E_s - w * sig * E_o
        else:
            react = -(w * w) * eps * E_s + w * sig * E_o
        c = c + torch.einsum("qa,qn->qan", react, phi)

        # -i w (J_re + i J_im): real +w J_im, imaginary -w J_re
        Js = mat.get("J_im" if self.part == "real" else "J_re", None)
        if Js is not None:
            Jv = Js(fv, mat, params) if callable(Js) else as_field(
                Js, (nq, d), fv.x)
            sgn = w if self.part == "real" else -w
            c = c - sgn * torch.einsum("qa,qn->qan", Jv, phi)
        return c


class EMWaveH(Equation):
    """One real part of the complex H-field curl-curl equation (reference
    R_EM_H1..H3, ``assemble_emwave:75``):

        curl(1/eps_c curl H) - omega^2 mu H = curl(J/eps_c)

    1/eps_c = (eps + i sigma/omega)/|eps_c|^2 couples the parts inside the
    curl and gauge terms. Free-current source ``Jc_re``/``Jc_im`` shaped
    like the curl (scalar in 2D, 3-vector in 3D), weakly int (1/eps_c) J .
    curl(phi).
    """

    def __init__(self, part: str, omega: float, dim: int = 2,
                 interp: str = "Q2", alpha: float = 1.0):
        super().__init__(H_RE if part == "real" else H_IM, dim, interp)
        self.part = part
        self.omega = omega
        self.dim = dim
        self.alpha = alpha

    def residual(self, fv, mat, params):
        d = self.dim
        w = self.omega
        mu_m = prop(mat, "mu_m", fv, params, 1.0)
        eps = prop(mat, "eps", fv, params, 1.0)
        sig = prop(mat, "sigma_em", fv, params, 0.0)

        # 1/eps_c = a + i b; (a + ib)(X_re + i X_im): the own part's
        # coefficient a, the other's -/+ b
        s = sig / w
        den = eps * eps + s * s
        a, b = eps / den, s / den
        ob = -b if self.part == "real" else b

        other = H_IM if self.part == "real" else H_RE
        g_s, g_o = fv.grad[self.var], fv.grad[other]
        curl_s, curl_o = _curl(g_s, d), _curl(g_o, d)
        div_s, div_o = _trace(g_s), _trace(g_o)
        phi = fv.phi[self.var]
        gphi = fv.gphi[self.var]
        curl_b = _curl_basis(gphi, d)

        c = torch.einsum("qc,qanc->qan", a * curl_s + ob * curl_o, curl_b)
        c = c + self.alpha * torch.einsum(
            "q,qna->qan", a * div_s + ob * div_o, gphi)
        c = c - (w * w) * mu_m * torch.einsum("qa,qn->qan",
                                              fv.val[self.var], phi)

        J_re, J_im = mat.get("Jc_re", None), mat.get("Jc_im", None)
        if J_re is not None or J_im is not None:
            shape = curl_s.shape

            def _ev(Jx):
                if Jx is None:
                    return torch.zeros_like(curl_s)
                v = Jx(fv, mat, params) if callable(Jx) else torch.as_tensor(
                    Jx, dtype=curl_s.dtype, device=curl_s.device)
                return torch.atleast_1d(v).expand(shape)

            Jr, Ji = _ev(J_re), _ev(J_im)
            Jpart = a * Jr + ob * Ji if self.part == "real" \
                else a * Ji - ob * Jr
            c = c - torch.einsum("qc,qanc->qan", Jpart, curl_b)
        return c


class EMAbsorbingBCH(FaceKernel):
    """First-order absorbing boundary of :class:`EMWaveH` (dual of
    :class:`EMAbsorbingBC` under mu <-> eps): weak term (k/eps) (i H_t) .
    phi_t with the lossless k = omega sqrt(mu eps)."""

    def __init__(self, part: str, omega: float, dim: int = 2):
        super().__init__(H_RE if part == "real" else H_IM, dim)
        self.part = part
        self.omega = omega
        self.dim = dim

    def residual(self, sfv, mat, params):
        mu_m = prop(mat, "mu_m", sfv, params, 1.0)
        eps = prop(mat, "eps", sfv, params, 1.0)
        k = self.omega * _sqrt(mu_m * eps)
        H_o = sfv.val[H_IM if self.part == "real" else H_RE]
        n = sfv.normal
        Ht = H_o - torch.einsum("qa,qa->q", n, H_o)[:, None] * n
        sgn = -1.0 if self.part == "real" else 1.0
        return sgn * (k / eps) * torch.einsum("qa,qn->qan", Ht,
                                              sfv.phi[self.var])


class EMWaveEdge(Equation):
    """Nedelec edge-element (H(curl)-conforming) curl-curl equation
    (reference I_N1 path of ``src/mm_fill_em.c``):

        int (1/mu) curl E curl phi - omega^2 eps_c E . phi  dV = int f . phi

    The dof is the tangential circulation on each element edge. part:
    "real" | "imag"; without the other part's variable the sigma coupling
    is dropped. PEC (n x E = 0) is a Dirichlet on the boundary edges'
    circulations. ``J_re``/``J_im`` enter as in :class:`EMWave`.
    """

    def __init__(self, part: str, omega: float, dim: int = 2):
        super().__init__(EDGE_RE if part == "real" else EDGE_IM, 1, "N1")
        self.part = part
        self.omega = omega
        self.dim = dim

    def residual(self, fv, mat, params):
        w = self.omega
        mu_m = prop(mat, "mu_m", fv, params, 1.0)
        eps = prop(mat, "eps", fv, params, 1.0)
        sig = prop(mat, "sigma_em", fv, params, 0.0)

        E = fv.val[self.var]          # (nq, dim)
        curl = fv.curl[self.var]      # (nq,) 2D | (nq, 3) 3D
        phi = fv.phi[self.var]        # (nq, nbf, dim)
        cphi = fv.curl_phi[self.var]  # (nq, nbf) | (nq, nbf, 3)

        if self.dim == 3:
            c = torch.einsum("qk,qnk->qn", curl, cphi) / mu_m
        else:
            c = cphi * (curl / mu_m)[:, None]

        E_o = fv.val.get(EDGE_IM if self.part == "real" else EDGE_RE)
        react = -(w * w) * eps * E
        if E_o is not None:
            react = react + (-1.0 if self.part == "real" else 1.0) * w * sig * E_o
        c = c + torch.einsum("qk,qnk->qn", react, phi)

        Js = mat.get("J_im" if self.part == "real" else "J_re", None)
        if Js is not None:
            Jv = Js(fv, mat, params) if callable(Js) else as_field(
                Js, E.shape, E)
            sgn = w if self.part == "real" else -w
            c = c - sgn * torch.einsum("qk,qnk->qn", Jv, phi)
        return c[:, None, :]  # (nq, ncomp=1, nbf)


class EMAbsorbingBC(FaceKernel):
    """First-order absorbing (Silver-Mueller) boundary of :class:`EMWave`:
    the real equation gets -(k/mu) E_t^imag, the imaginary +(k/mu)
    E_t^real, E_t = E - (n.E) n, k = omega sqrt(mu eps)."""

    def __init__(self, part: str, omega: float, dim: int = 2):
        super().__init__(E_RE if part == "real" else E_IM, dim)
        self.part = part
        self.omega = omega
        self.dim = dim

    def residual(self, sfv, mat, params):
        mu_m = prop(mat, "mu_m", sfv, params, 1.0)
        eps = prop(mat, "eps", sfv, params, 1.0)
        k = self.omega * _sqrt(mu_m * eps)
        E_o = sfv.val[E_IM if self.part == "real" else E_RE]
        n = sfv.normal
        Et = E_o - torch.einsum("qa,qa->q", n, E_o)[:, None] * n
        sgn = -1.0 if self.part == "real" else 1.0
        return sgn * (k / mu_m) * torch.einsum("qa,qn->qan", Et,
                                               sfv.phi[self.var])
