"""Free-surface boundary conditions: capillary traction + kinematic
(counterpart of ``goma_tpu/bc/free_surface.py``).

Parity: reference CAPILLARY family applied in ``src/bc_integ.c:84
apply_integrated_bc`` with the surface-divergence weak form of surface
tension, and the KINEMATIC BC that closes the ALE mesh motion at a material
surface (``src/mm_ns_bc.c`` velo-normal/kinematic kernels).

The capillary term uses the surface-divergence theorem: the traction
sigma*kappa*n + grad_s(sigma) enters the momentum weak form as

    int_G sigma (I - n n^T) : grad(phi_i e_a) dG  ( + contact-line endpoint
    terms, supplied separately )

which needs no curvature. KinematicBC enforces n . (u - d_dot) = 0 on the
mesh-displacement equation by a penalty along the normal.

Each kernel returns the surface integrand (nq_f, ncomp, nbf); the
assembler contracts it with ``sfv.wdA`` and differentiates the face
residual with ``torch.func.jacfwd``.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.physics.materials import prop


def _per_qp(v, nq, like, ncomp=None):
    """A scalar, vector or per-point value broadcast to (nq,) or
    (nq, ncomp) at ``like``'s dtype and device."""
    if not torch.is_tensor(v):
        v = torch.as_tensor(np.asarray(v, dtype=np.float64), device=like.device)
    return v.to(like.dtype).expand((nq,) if ncomp is None else (nq, ncomp))


class CapillaryBC(FaceKernel):
    """Surface tension + external pressure on the momentum equation.

    material/params keys: ``sigma`` (surface tension, scalar or callable
    for Marangoni sigma(T)), ``p_ext`` external pressure (default 0).
    """

    def __init__(self, dim: int, sigma=None, p_ext: float = 0.0):
        super().__init__("velocity", dim)
        self.dim = dim
        self.sigma = sigma
        self.p_ext = p_ext

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        sigma = (self.sigma if self.sigma is not None
                 else prop(mat, "sigma", sfv, params))
        if callable(sigma):
            sigma = sigma(sfv, mat, params)
        sigma = _per_qp(sigma, nq, sfv.x)
        n = sfv.normal  # (nq, dim)
        gphi = sfv.gphi["velocity"]  # (nq, nbf, dim)
        phi = sfv.phi["velocity"]
        # sigma (I - n n^T) : grad(phi_i e_a) = sigma (gphi[i,a] - n_a (n.gphi_i))
        ndotg = torch.einsum("qk,qik->qi", n, gphi)
        cap = sigma[:, None, None] * (
            gphi.transpose(1, 2) - torch.einsum("qa,qi->qai", n, ndotg))
        # the boundary term is -phi (sigma_in . n); the jump condition
        # sigma_in . n = -p_ext n + sigma kappa n gives + p_ext phi n_a here
        # (the sigma kappa part is `cap`, by the surface-divergence theorem)
        pext = self.p_ext * torch.einsum("qa,qi->qai", n, phi)
        return cap + pext


class KinematicBC(FaceKernel):
    """Material-surface closure for the ALE mesh equation:
    penalty * phi_i n_a * (n.(u - d_dot) - leak) added to mesh-displacement
    rows. ``leak`` (KIN_LEAK, reference ``src/mm_ns_bc.c kin_bc_leak``) is
    the normal mass-loss velocity m_dot/rho through the surface; scalar or
    callable(sfv, mat, params) -> (nq,)."""

    def __init__(self, dim: int, penalty: float = 1e6, leak=0.0):
        super().__init__(MESH_VAR, dim)
        self.dim = dim
        self.penalty = penalty
        self.leak = leak

    def residual(self, sfv, mat, params):
        n = sfv.normal
        u = sfv.val["velocity"] if "velocity" in sfv.val else 0.0 * sfv.x
        ddot = sfv.dot[MESH_VAR]
        un = torch.einsum("qk,qk->q", n, u - ddot)
        if self.leak is not None:
            lk = (self.leak(sfv, mat, params) if callable(self.leak)
                  else self.leak)
            un = un - lk
        phi = sfv.phi[MESH_VAR]
        return self.penalty * torch.einsum("q,qa,qi->qai", un, n, phi)


class NormalFlux(FaceKernel):
    """Generic weak Neumann flux  -int phi_i q_n  on a scalar equation
    (reference: the *_FLUX BC family in bc_integ)."""

    def __init__(self, var: str, flux, ncomp: int = 1):
        super().__init__(var, ncomp)
        self.flux = flux

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        q = self.flux(sfv, mat, params) if callable(self.flux) else self.flux
        q = _per_qp(q, nq, sfv.x, self.ncomp)
        return -torch.einsum("qc,qi->qci", q, sfv.phi[self.var])


class Traction(FaceKernel):
    """Imposed traction vector t on the momentum equation: -int phi_i t_a."""

    def __init__(self, dim: int, traction):
        super().__init__("velocity", dim)
        self.dim = dim
        self.traction = traction

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        t = (self.traction(sfv, mat, params) if callable(self.traction)
             else self.traction)
        t = _per_qp(t, nq, sfv.x, self.dim)
        return -torch.einsum("qa,qi->qai", t, sfv.phi["velocity"])


class SurfaceViscosity(FaceKernel):
    """CAPILLARY_SHEAR_VISC (``src/mm_fill_shell.c:3109
    apply_surface_viscosity``): Boussinesq-Scriven surface-viscous extra
    stress on a capillary boundary,

        tau_s = (kappa_s - mu_s) tr(G) P + mu_s (G + G^T),
        G = P grad(u) P,  P = I - n n^T

    entering the momentum weak form as + ramp int tau_s : P grad(phi e_a) P
    (use together with CapillaryBC). The textbook dissipative form, as in
    goma_tpu. ``time_start``/``time_full`` ramp the effect in
    (params["time"])."""

    def __init__(self, dim: int, mu_s: float, kappa_s: float = 0.0,
                 time_start: float = 0.0, time_full: float = 0.0):
        super().__init__("velocity", dim)
        self.dim = dim
        self.mu_s = mu_s
        self.kappa_s = kappa_s
        self.time_start = time_start
        self.time_full = time_full

    def residual(self, sfv, mat, params):
        n = sfv.normal
        eye = torch.eye(self.dim, dtype=n.dtype, device=n.device)
        P = eye[None] - torch.einsum("qa,qb->qab", n, n)
        gu = sfv.grad["velocity"]  # (nq, a, k) = du_a/dx_k
        G = torch.einsum("qap,qpk,qkb->qab", P, gu, P)
        trG = torch.diagonal(G, dim1=1, dim2=2).sum(dim=1)
        tau = ((self.kappa_s - self.mu_s) * trG[:, None, None] * P
               + self.mu_s * (G + G.transpose(1, 2)))
        e = torch.einsum("qgk,qik->qig", P, sfv.gphi["velocity"])
        ramp = 1.0
        if self.time_full > self.time_start:
            t = params.get("time", self.time_full)
            ramp = torch.clamp((t - self.time_start)
                               / (self.time_full - self.time_start), 0.0, 1.0)
        return ramp * torch.einsum("qpg,qpa,qig->qai", tau, P, e)
