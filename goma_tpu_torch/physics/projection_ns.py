"""Projection-method (pressure-correction) Navier-Stokes kernels
(counterpart of ``goma_tpu/physics/projection_ns.py``).

Parity: reference ``src/mm_fill_split.c`` — the segregated projection path
of ``rf_solve_segregated.c`` (``assemble_ustar:33``, ``assemble_pstar:199``,
``assemble_continuity_segregated:324``, ``assemble_momentum_segregated:412``):
an intermediate velocity u* with lagged pressure, a pressure-increment
Poisson solve, and the divergence-free correction.

u* and the increment are two small Problems sharing the mesh; the previous
step's fields enter as frozen external fields (values + gradients at qps),
dt as a parameter, so each substep is one linear solve. The correction is
a lumped-L2 nodal projection (``post.derived.project_to_nodes``) — see
``solvers/projection.py`` for the driver that chains them.
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.materials import as_field, prop

USTAR, PPHI = "ustar", "pphi"


class UStar(Equation):
    """Intermediate velocity: rho((u* - u_old)/dt + (u_old.grad) u*)
    + grad p_old - f = div(mu grad u*), lagged advection and pressure
    (reference assemble_ustar). External fields: u_old, v_old, p_old."""

    def __init__(self, dim: int = 2, interp: str = "Q2"):
        super().__init__(USTAR, dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        dt = params["dt"]
        rho = prop(mat, "rho", fv, params, 1.0)
        mu = prop(mat, "mu", fv, params)
        nq = fv.x.shape[0]
        u = fv.val[USTAR]
        gu = fv.grad[USTAR]
        u_old = torch.stack([fv.ext["u_old"], fv.ext["v_old"]], dim=1)
        gp_old = fv.ext_grad["p_old"]
        phi = fv.phi[USTAR]
        gphi = fv.gphi[USTAR]

        inert = (u - u_old) / dt + torch.einsum("qk,qak->qa", u_old, gu)
        f = mat.get("body_force", None)
        if f is not None:
            fval = f(fv, mat, params) if callable(f) else as_field(
                f, (nq, self.dim), u)
            inert = inert - fval
        c = torch.einsum("qa,qi->qai", rho * inert + gp_old, phi)
        c = c + mu * torch.einsum("qak,qik->qai", gu, gphi)
        return c


class PressureIncrement(Equation):
    """Pressure-increment Poisson (reference assemble_pstar):

        div( (dt/rho) grad dp ) = div u*   ->
        int (dt/rho) grad dp . grad psi + (div u*) psi = 0

    External fields: us, vs (the u* components); p_new = p_old + dp."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(PPHI, 1, interp)

    def residual(self, fv, mat, params):
        dt = params["dt"]
        rho = prop(mat, "rho", fv, params, 1.0)
        gp = fv.grad[PPHI][:, 0, :]
        div_us = fv.ext_grad["us"][:, 0] + fv.ext_grad["vs"][:, 1]
        psi = fv.phi[PPHI]
        gpsi = fv.gphi[PPHI]
        c = (dt / rho) * torch.einsum("qk,qik->qi", gp, gpsi)
        c = c + div_us[:, None] * psi
        return c[:, None, :]
