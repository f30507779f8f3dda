"""Interfacial matching conditions between discontinuous variables
(counterpart of ``goma_tpu/physics/interface.py``).

Parity: reference ``src/mm_interface.c`` (``interface_source:76-132``) and
the VL_EQUIL / Henry-law partitioning conditions: at a material interface
where a variable is discontinuous (``goma_tpu_torch.mesh.interface.
split_interface``), a surface exchange term ties the two sides together.
Flux continuity is automatic (equal and opposite contributions) and the
exchange law sets the jump. Each kernel returns both sides' integrands;
``Problem.add_interface_kernel`` integrates them with the A side's measure
and ``torch.func.jacfwd`` gives the cross-block Jacobian blocks.
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import InterfaceKernel


class InterfaceExchange(InterfaceKernel):
    """Surface exchange flux q_n = coeff * (u_a - K * u_b) leaving side A
    into side B (per component ``comp`` of ``var``, or all).

    - finite ``coeff``: contact resistance / mass-transfer coefficient
      (T_CONTACT_RESIS; with kinetic constants the VL_EQUIL_PRXN /
      IS_EQUIL_PRXN flavor, src/bc_integ.c:1180);
    - large ``coeff``: penalty enforcement of the partition equilibrium
      u_a = K u_b (Henry law / VL_EQUIL) with exact flux conservation.

    ``K`` may be callable(sa, sb, mat_a, mat_b, params) -> (nq,) or
    (nq, ncomp) (see :func:`flory_huggins_partition`)."""

    def __init__(self, var: str, coeff: float, K=1.0, ncomp: int = 1,
                 comp: int | None = None):
        super().__init__(var, ncomp)
        self.coeff = coeff
        self.K = K
        self.comp = comp

    def residual(self, sa, sb, mat_a, mat_b, params):
        ua = sa.val[self.var]  # (nq, ncomp)
        ub = sb.val[self.var]
        K = self.K(sa, sb, mat_a, mat_b, params) if callable(self.K) \
            else self.K
        K = torch.as_tensor(K, dtype=ua.dtype, device=ua.device)
        if K.ndim == 1:
            K = K[:, None]
        q = self.coeff * (ua - K * ub)
        if self.comp is not None:
            mask = torch.zeros((1, ua.shape[1]), dtype=ua.dtype,
                               device=ua.device)
            mask[0, self.comp] = 1.0
            q = q * mask
        ca = torch.einsum("qc,qi->qci", q, sa.phi[self.var])
        cb = -torch.einsum("qc,qi->qci", q, sb.phi[self.var])
        return ca, cb


def flory_huggins_partition(chi: float, n_poly: float, psat_over_P: float,
                            comp: int = 0, rho_ratio: float = 1.0):
    """VL_POLY (``src/mm_ns_bc.c`` ``flory_huggins``): the Flory-Huggins
    polymer-solution partition for :class:`InterfaceExchange`, with the
    solvent activity on side B (phi1 = u_b * rho_ratio)

        ln a1 = ln(phi1) + (1 - 1/n) (1 - phi1) + chi (1 - phi1)^2

    and the secant partition K(u_b) = a1(phi1) psat_over_P / u_b, so that
    u_a = K u_b is u_a = a1 psat/P."""

    def K(sa, sb, mat_a, mat_b, params):
        ub = sb.val["species"][:, comp]
        phi1 = torch.minimum(torch.maximum(ub * rho_ratio, ub.new_full((), 1e-12)),
                             ub.new_full((), 1.0 - 1e-12))
        ln_a1 = torch.log(phi1) + (1.0 - 1.0 / n_poly) * (1.0 - phi1) \
            + chi * (1.0 - phi1) ** 2
        a1 = torch.exp(ln_a1)
        return a1 * psat_over_P / torch.maximum(ub, ub.new_full((), 1e-30))

    return K


class InterfaceMatch(InterfaceKernel):
    """Cross-VARIABLE interface exchange: flux q = coeff (g_a(sa) - g_b(sb))
    leaving side A's ``var_a`` equation into side B's ``var_b`` equation
    (VP_EQUIL, ``src/mm_fill_porous.c:4379``, and POROUS_GAS, ``:4258``).
    ``g_a(sa, mat_a, params)`` / ``g_b(sb, mat_b, params)`` -> (nq,),
    defaulting to component ``comp_a`` / ``comp_b`` of each variable;
    ``scale_b`` multiplies the flux entering B's rows."""

    def __init__(self, var_a: str, var_b: str, coeff: float,
                 g_a=None, g_b=None, comp_a: int = 0, comp_b: int = 0,
                 scale_b: float = 1.0):
        super().__init__(var_a, 1)
        self.var_a, self.var_b = var_a, var_b
        self.coeff = coeff
        self.g_a, self.g_b = g_a, g_b
        self.comp_a, self.comp_b = comp_a, comp_b
        self.scale_b = scale_b

    def residual(self, sa, sb, mat_a, mat_b, params):
        ga = self.g_a(sa, mat_a, params) if self.g_a is not None \
            else sa.val[self.var_a][:, self.comp_a]
        gb = self.g_b(sb, mat_b, params) if self.g_b is not None \
            else sb.val[self.var_b][:, self.comp_b]
        q = self.coeff * (ga - gb)
        nca = sa.val[self.var_a].shape[1]
        ncb = sb.val[self.var_b].shape[1]
        # the one nonzero component of each side, built out of place
        ea = torch.zeros(nca, dtype=q.dtype, device=q.device)
        ea[self.comp_a] = 1.0
        eb = torch.zeros(ncb, dtype=q.dtype, device=q.device)
        eb[self.comp_b] = 1.0
        ca = torch.einsum("c,qi->qci", ea, q[:, None] * sa.phi[self.var_a])
        cb = torch.einsum("c,qi->qci", eb,
                          -self.scale_b * q[:, None] * sb.phi[self.var_b])
        return ca, cb


class MassFluxContinuity(InterfaceKernel):
    """VELO_NORMAL_DISC / KINEMATIC_DISC (``src/mm_ns_bc.c:1692
    fvelo_normal_disc_bc``): density-weighted normal mass-flux continuity
    at a discontinuous-velocity internal interface,

        rho_a (v_a . n) = rho_b (v_b . n),

    as a conservative penalty pair on both sides' velocity rows. Material
    key ``rho`` on each block."""

    def __init__(self, penalty: float = 1e6, var: str = "velocity",
                 dim: int = 2):
        super().__init__(var, dim)
        self.penalty = penalty
        self.dim = dim

    def residual(self, sa, sb, mat_a, mat_b, params):
        n = sa.normal
        rho_a = mat_a.get("rho", 1.0)
        rho_b = mat_b.get("rho", 1.0)
        s = rho_a * torch.einsum("qk,qk->q", sa.val[self.var], n) \
            - rho_b * torch.einsum("qk,qk->q", sb.val[self.var], n)
        ca = self.penalty * torch.einsum("q,qa,qi->qai", s, n,
                                         sa.phi[self.var])
        cb = -self.penalty * torch.einsum("q,qa,qi->qai", s, n,
                                          sb.phi[self.var])
        return ca, cb
