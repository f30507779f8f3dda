"""Suspension two-phase machinery (counterpart of
``goma_tpu/physics/suspension.py``): the anisotropic (q-tensor) migration
flux, the particle-phase momentum and its drag on the fluid, and the solved
vorticity direction.

Parity: reference HYDRODYNAMIC_QTENSOR mass flux
(``hydro_qtensor_flux_new``, ``src/mm_qtensor_model.c:1394``), the
Buyevich particle momentum (``assemble_pmomentum``,
``src/mm_fill_pthings.c:154``) and ``assemble_vorticity_direction``
(``src/mm_qtensor_model.c:671``).

- ``QTensorHydroSpecies`` left-multiplies the Phillips flux of
  :class:`HydroSpecies` (its ``particle_flux``, shared) by the flow-frame
  tensor Q = V Q_loc V^T computed pointwise from the velocity.
- The middle eigenvector of the rate-of-strain tensor is a
  ``torch.autograd.Function`` whose tangent is goma_tpu's custom JVP:
  first-order perturbation theory with the spectral gap regularised by
  1e-12, finite at a degenerate spectrum where ``eigh``'s own derivative
  is NaN. Its vmap rule is generated, so it runs under the element
  ``vmap(jacfwd)``.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.fluid import _as_nq
from goma_tpu_torch.physics.materials import _tiny, prop
from goma_tpu_torch.physics.species_flux import HydroSpecies


def flow_frame_qtensor(fv, weights, eps: float = 1e-12):
    """Anisotropy tensor Q (nq, dim, dim) in the local flow frame.

    weights = (l_flow, l_grad, l_vort); 2D uses (l_flow, l_grad) in-plane.
    AD-safe at u = 0 (blends smoothly to the isotropic mean weight)."""
    u = fv.val["velocity"]
    nq, dim = u.shape
    l1, l2, l3 = weights
    umag2 = torch.sum(u * u, dim=1)
    w = umag2 / (umag2 + eps)  # 0 at stagnation -> blend to isotropic
    e1 = u / torch.sqrt(umag2 + eps)[:, None]
    eye = torch.eye(dim, dtype=u.dtype, device=u.device)[None]
    if dim == 2:
        e2 = torch.stack([-e1[:, 1], e1[:, 0]], dim=1)
        Q = (l1 * torch.einsum("qa,qb->qab", e1, e1)
             + l2 * torch.einsum("qa,qb->qab", e2, e2))
        iso = 0.5 * (l1 + l2)
    else:
        gu = fv.grad["velocity"]
        vort = torch.stack(
            [gu[:, 2, 1] - gu[:, 1, 2], gu[:, 0, 2] - gu[:, 2, 0],
             gu[:, 1, 0] - gu[:, 0, 1]], dim=1)
        # orthogonalize the vorticity direction against the flow direction
        vort = vort - torch.einsum("qa,qa->q", vort, e1)[:, None] * e1
        vmag2 = torch.sum(vort * vort, dim=1)
        wv = vmag2 / (vmag2 + eps)
        e3 = vort / torch.sqrt(vmag2 + eps)[:, None]
        P11 = torch.einsum("qa,qb->qab", e1, e1)
        P33 = wv[:, None, None] * torch.einsum("qa,qb->qab", e3, e3)
        P22 = eye - P11 - P33
        Q = l1 * P11 + l2 * P22 + l3 * P33
        iso = (l1 + l2 + l3) / 3.0
    return w[:, None, None] * Q + (1.0 - w)[:, None, None] * iso * eye


class QTensorHydroSpecies(HydroSpecies):
    """Phillips migration flux with q-tensor anisotropy: N -> Q . N_iso
    (reference hydro_qtensor_flux_new applies V Q V^T to each flux term)."""

    def __init__(self, *args, qweights=(1.0, 0.8, 0.5), **kw):
        super().__init__(*args, **kw)
        self.qweights = qweights

    def residual(self, fv, mat, params):
        N = torch.einsum("qab,qb->qa", flow_frame_qtensor(fv, self.qweights),
                         self.particle_flux(fv, mat, params))
        return self.weak_form(fv, N)


class ParticleMomentum(Equation):
    """Particle-phase momentum (two-fluid suspension, Buyevich model;
    reference assemble_pmomentum, src/mm_fill_pthings.c:154):

        R_a = phi_i [ C rho_p (vdot_p + v_p . grad v_p) - C drho g
                      - beta(C) (u_f - v_p) ]
              + grad(phi_i) : mu_p (grad v_p + grad v_p^T)

    with C the particle volume fraction (species component ``svar_comp``,
    or constant ``C0``), beta(C) = 9/2 mu_f C / a^2 the Stokes drag
    density, drho = rho_p - rho_f. Variable name: ``pvelocity``.
    """

    def __init__(self, dim: int, interp: str = "Q2", rho_p: float = 1.0,
                 mu_p: float = 0.0, a_rad: float = 1.0, mu_f: float = 1.0,
                 del_rho: float = 0.0, gravity=None, C0: float | None = None,
                 svar: str = "species", svar_comp: int = 0,
                 transient: bool = True, convection: bool = True):
        super().__init__("pvelocity", dim, interp)
        self.dim = dim
        self.rho_p, self.mu_p = rho_p, mu_p
        self.mu_f, self.a2 = mu_f, a_rad * a_rad
        self.del_rho = del_rho
        self.gravity = (None if gravity is None
                        else np.asarray(gravity, dtype=np.float64))
        self.C0, self.svar, self.svar_comp = C0, svar, svar_comp
        self.transient = transient
        self.convection = convection

    def _conc(self, fv):
        if self.C0 is not None:
            return torch.full((fv.x.shape[0],), float(self.C0),
                              dtype=fv.x.dtype, device=fv.x.device)
        return fv.val[self.svar][:, self.svar_comp]

    def drag_beta(self, fv):
        """Stokes drag density beta(C) = 4.5 mu_f C / a^2."""
        return 4.5 * self.mu_f * self._conc(fv) / self.a2

    def residual(self, fv, mat, params):
        v = fv.val["pvelocity"]
        gv = fv.grad["pvelocity"]
        C = self._conc(fv)
        inert = torch.zeros_like(v)
        if self.transient:
            inert = inert + fv.dot["pvelocity"]
        if self.convection:
            inert = inert + torch.einsum("qk,qak->qa", v, gv)
        body = (C * self.rho_p)[:, None] * inert
        if self.gravity is not None:
            g = torch.as_tensor(self.gravity, dtype=v.dtype, device=v.device)
            body = body - (C * self.del_rho)[:, None] * g[None, :]
        beta = self.drag_beta(fv)
        uf = fv.val["velocity"] if "velocity" in fv.val else torch.zeros_like(v)
        body = body - beta[:, None] * (uf - v)
        contrib = torch.einsum("qa,qi->qai", body, fv.phi["pvelocity"])
        if self.mu_p > 0.0:
            tau = self.mu_p * (gv + gv.transpose(1, 2))
            contrib = contrib + torch.einsum("qak,qik->qai", tau,
                                             fv.gphi["pvelocity"])
        return contrib


def particle_drag_force(pmom: ParticleMomentum):
    """Fluid-momentum body-force closure for two-way coupling: acceleration
    +beta (v_p - u_f) / rho_f on the carrier fluid (equal and opposite to
    the particle drag). Use as materials['body_force']."""

    def f(fv, mat, params):
        nq = fv.x.shape[0]
        rho = _as_nq(prop(mat, "rho", fv, params, 1.0), nq, fv.x)
        beta = pmom.drag_beta(fv)
        return beta[:, None] * (fv.val["pvelocity"]
                                - fv.val["velocity"]) / rho[:, None]

    return f


class _MiddleEigvec(torch.autograd.Function):
    """Middle eigenvector of symmetric 3x3 matrices (..., 3, 3) -> (..., 3),
    the middle column of an ascending ``eigh``. Tangent (goma_tpu's custom
    JVP): dv = sum_{j != 1} v_j (v_j^T dE v) (lam_1 - lam_j) /
    ((lam_1 - lam_j)^2 + 1e-12); the cotangent is its transpose."""

    generate_vmap_rule = True

    @staticmethod
    def forward(E):
        lam, V = torch.linalg.eigh(E)
        return V[..., :, 1], lam, V

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, lam, V = output
        ctx.mark_non_differentiable(lam, V)
        ctx.save_for_forward(lam, V)
        ctx.save_for_backward(lam, V)

    @staticmethod
    def _inv_gap(lam):
        gap = lam[..., 1:2] - lam
        inv = gap / (gap * gap + 1e-12)
        keep = torch.tensor([1.0, 0.0, 1.0], dtype=lam.dtype, device=lam.device)
        return inv * keep

    @staticmethod
    def jvp(ctx, dE):
        lam, V = ctx.saved_tensors
        v = V[..., :, 1]
        num = torch.einsum("...ji,...jk,...k->...i", V, dE, v)
        dv = torch.einsum("...ij,...j->...i", V, num * _MiddleEigvec._inv_gap(lam))
        return dv, None, None

    @staticmethod
    def backward(ctx, gv, _glam, _gV):
        lam, V = ctx.saved_tensors
        v = V[..., :, 1]
        w = torch.einsum("...ij,...j->...i", V,
                         _MiddleEigvec._inv_gap(lam)
                         * torch.einsum("...ji,...j->...i", V, gv))
        return w[..., :, None] * v[..., None, :]


def _middle_eigvec(E):
    """Middle eigenvector of symmetric 3x3 matrices (ascending ``eigh``).

    The reference computes J_vd_v by finite differences because the
    analytic eigenvector derivative is "intractable"
    (``src/mm_qtensor_model.c:825``). Here the derivative is first-order
    eigenvector perturbation theory with a regularized spectral gap, so it
    stays finite at the degenerate zero-shear state where plain ``eigh``
    AD gives NaN."""
    return _MiddleEigvec.apply(E)[0]


class VorticityDirection(Equation):
    """Solved vorticity-direction equations R_VORT_DIR1..3 (reference
    ``assemble_vorticity_direction``, ``src/mm_qtensor_model.c:671``): L2
    projection of the eigenvector of the MIDDLE eigenvalue of the
    rate-of-strain tensor gamma_dot = grad u + grad u^T,

        R_(a,i) = int phi_i (vd_a - v_hat_a(gamma_dot))

    a batched 3x3 ``eigh`` (ascending eigenvalues -> index 1) with the sign
    fixed by a lexicographic bias (the reference's ``bias_eigenvector_to``
    against e_1). The solved field feeds q = I - vd vd^T / 2."""

    def __init__(self, interp: str = "Q1", var: str = "vort_dir"):
        super().__init__(var, 3, interp)

    @staticmethod
    def vort_dir(fv):
        """Middle eigenvector of gamma_dot embedded in 3x3, sign-biased."""
        g = fv.grad["velocity"]  # (nq, d, d)
        d = g.shape[1]
        gd = g + g.transpose(1, 2)
        E = torch.nn.functional.pad(gd, (0, 3 - d, 0, 3 - d))
        v = _middle_eigvec(E)
        s = torch.sign(v[:, 0] + 1e-3 * v[:, 1] + 1e-6 * v[:, 2]
                       + _tiny(v.dtype))
        return v * s[:, None]

    def residual(self, fv, mat, params):
        vd = fv.val[self.var][:, :3]
        vhat = self.vort_dir(fv)
        phi = fv.phi[self.var]
        return (vd - vhat)[:, :, None] * phi[:, None, :]


def qtensor_from_vort_dir(fv, var: str = "vort_dir"):
    """q = I - vd vd^T / 2 from the SOLVED vorticity direction (reference
    ``assemble_qtensor`` quadrature-point q, ``src/mm_qtensor_model.c:202``)
    -- (nq, 3, 3)."""
    vd = fv.val[var][:, :3]
    eye = torch.eye(3, dtype=vd.dtype, device=vd.device)
    return eye[None, :, :] - 0.5 * torch.einsum("qa,qb->qab", vd, vd)
