"""Normal-mode (3D-of-2D) linear stability equations (counterpart of
``goma_tpu/physics/normal_mode.py``).

Parity: the reference's LSA_3D_OF_2D machinery (``src/ac_stability.c``
wavenumber loop :468, ``src/ac_stability_util.c do_LSA_mods:84`` — trig
0/1-factored basis functions assembled in two passes per wavenumber).

Instead of mutating basis tables and double-assembling, the z-periodic
perturbation

    (u_hat, v_hat, p_hat, T_hat) ~ f(x, y) cos(beta z),  w_hat ~ sin(beta z)

is governed by REAL 2D equations with explicit beta terms (the cos/sin
factors integrate out), discretized with the standard machinery on the
generic AD path: the base flow enters as frozen external nodal fields
(values + gradients at qps) and ``beta = params["beta"]`` is a params leaf,
so a wavenumber sweep reuses one Problem. The growth-rate eigenproblem
J z = sigma M z then rides the ordinary stability path
(``continuation/stability.py``).

Scope: fixed-mesh problems (momentum + continuity + energy with Boussinesq
coupling); the deforming-mesh variant is ``physics/normal_mode_ale.py``.

Variables: nm_velocity (in-plane, 2), nm_w (1), nm_pressure (1),
nm_temperature (1). Base fields (external): "u0", "v0" (+ "T0" if thermal).
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.materials import prop

NM_U, NM_W, NM_P, NM_T = "nm_velocity", "nm_w", "nm_pressure", "nm_temperature"


def _base_vel(fv):
    u0 = torch.stack([fv.ext["u0"], fv.ext["v0"]], dim=1)  # (nq, 2)
    gu0 = torch.stack([fv.ext_grad["u0"], fv.ext_grad["v0"]], dim=1)  # (nq,2,2)
    return u0, gu0


class NormalModeMomentum(Equation):
    """In-plane perturbation momentum (cos mode):

    rho (du_hat/dt + u0.grad u_hat + u_hat.grad u0)
        = - grad p_hat + mu (lap u_hat - beta^2 u_hat) + rho alpha_g T_hat

    weak form with the gradient (Laplacian) viscous term and the pressure
    integrated by parts. ``buoyancy`` material key: (2,) vector alpha*g for
    Boussinesq coupling to nm_temperature."""

    def __init__(self, interp: str = "Q2"):
        super().__init__(NM_U, 2, interp)

    def residual(self, fv, mat, params):
        beta = params["beta"]
        rho = prop(mat, "rho", fv, params, 1.0)
        mu = prop(mat, "mu", fv, params)
        u0, gu0 = _base_vel(fv)
        u = fv.val[NM_U]
        gu = fv.grad[NM_U]  # (nq, 2, 2)
        p = fv.val[NM_P][:, 0]
        phi = fv.phi[NM_U]
        gphi = fv.gphi[NM_U]

        inert = fv.dot[NM_U] + torch.einsum("qk,qak->qa", u0, gu) \
            + torch.einsum("qk,qak->qa", u, gu0)
        b = mat.get("buoyancy", None)
        if b is not None:
            T = fv.val[NM_T][:, 0]
            inert = inert - T[:, None] * torch.as_tensor(
                b, dtype=T.dtype, device=T.device)[None, :]
        c = torch.einsum("qa,qi->qai", rho * inert, phi)
        c = c + mu * torch.einsum("qak,qik->qai", gu, gphi)
        c = c + mu * beta**2 * torch.einsum("qa,qi->qai", u, phi)
        c = c - torch.einsum("q,qia->qai", p, gphi)
        return c


class NormalModeW(Equation):
    """z-velocity perturbation (sin mode):

    rho (dw_hat/dt + u0.grad w_hat) = beta p_hat + mu (lap w_hat - beta^2 w_hat)
    """

    def __init__(self, interp: str = "Q2"):
        super().__init__(NM_W, 1, interp)

    def residual(self, fv, mat, params):
        beta = params["beta"]
        rho = prop(mat, "rho", fv, params, 1.0)
        mu = prop(mat, "mu", fv, params)
        u0, _ = _base_vel(fv)
        w = fv.val[NM_W][:, 0]
        gw = fv.grad[NM_W][:, 0, :]
        p = fv.val[NM_P][:, 0]
        phi = fv.phi[NM_W]
        gphi = fv.gphi[NM_W]
        c = rho * (fv.dot[NM_W][:, 0] + torch.einsum("qk,qk->q", u0, gw)
                   )[:, None] * phi
        c = c + mu * torch.einsum("qk,qik->qi", gw, gphi)
        c = c + mu * beta**2 * (w[:, None] * phi)
        c = c - beta * p[:, None] * phi
        return c[:, None, :]


class NormalModeContinuity(Equation):
    """div u_hat + beta w_hat = 0 (the cos factor of the 3D divergence)."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(NM_P, 1, interp)

    def residual(self, fv, mat, params):
        beta = params["beta"]
        div = (torch.diagonal(fv.grad[NM_U], dim1=1, dim2=2).sum(-1)
               + beta * fv.val[NM_W][:, 0])
        psi = fv.phi[NM_P]
        return (div[:, None] * psi)[:, None, :]


class NormalModeEnergy(Equation):
    """Temperature perturbation (cos mode):

    rho Cp (dT_hat/dt + u0.grad T_hat + u_hat.grad T0)
        = k (lap T_hat - beta^2 T_hat)

    Base temperature gradient from external field "T0"."""

    def __init__(self, interp: str = "Q2", advect_base: bool = True):
        super().__init__(NM_T, 1, interp)
        self.advect_base = advect_base

    def residual(self, fv, mat, params):
        beta = params["beta"]
        rho = prop(mat, "rho", fv, params, 1.0)
        Cp = prop(mat, "Cp", fv, params, 1.0)
        k = prop(mat, "k", fv, params)
        T = fv.val[NM_T][:, 0]
        gT = fv.grad[NM_T][:, 0, :]
        phi = fv.phi[NM_T]
        gphi = fv.gphi[NM_T]
        adv = torch.zeros_like(T)
        if "u0" in fv.ext:
            u0, _ = _base_vel(fv)
            adv = adv + torch.einsum("qk,qk->q", u0, gT)
        if self.advect_base and NM_U in fv.val and "T0" in fv.ext:
            adv = adv + torch.einsum("qk,qk->q", fv.val[NM_U], fv.ext_grad["T0"])
        c = (rho * Cp) * (fv.dot[NM_T][:, 0] + adv)[:, None] * phi
        c = c + k * torch.einsum("qk,qik->qi", gT, gphi)
        c = c + k * beta**2 * (T[:, None] * phi)
        return c[:, None, :]
