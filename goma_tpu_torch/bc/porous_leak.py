"""Porous-surface and leak boundary conditions (counterpart of
``goma_tpu/bc/porous_leak.py``).

Parity: the reference's porous/leak family:

- POROUS_FLUX (``src/bc_integ.c:1417`` -> ``src/mm_fill_porous.c:3855
  porous_mass_flux_surf_bc``): convective evaporative mass transfer out of
  a partially saturated porous medium, driven by the equilibrium gas-phase
  solvent density at the surface (Kelvin equation, ``src/mm_fill_porous.c
  :7038 load_gas_conc``), plus an optional forced-liquid extraction term
  above a sink pressure;
- LATENT_HEAT (``src/bc_integ.c:1603 lat_heat_bc`` ->
  ``src/mm_fill_species.c:7615``): the evaporative latent-heat sink on the
  energy equation, q_n = sum_w L_w * mdot_w;
- VNORM_LEAK (``include/rf_bc_const.h:864``; the kin_bc_leak family of
  ``src/mm_ns_bc.c``): the normal-velocity closure n.(v - vs) = sum_w
  mdot_w / rho through a permeable / evaporating wall, a weak penalty on
  the momentum rows;
- POR_LIQ_FLUX_FILL, POROUS_CONV and VN_POROUS (below).

Every Jacobian coupling (porous pressure, temperature, mesh position)
comes from forward-mode AD of these residuals.
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.physics.electro import on_comp
from goma_tpu_torch.physics.materials import as_field, prop
from goma_tpu_torch.physics.porous import POR_VAR


def kelvin_gas_density(p_liq, mat, params, T=None):
    """Equilibrium gas-phase solvent density over the porous meniscus
    (Kelvin equation; ``src/mm_fill_porous.c:7038 load_gas_conc``):

        rho_gv = (Mw / (R T)) * Psat * exp(-p_c * Mw / (rho_l R T)),
        p_c = -p_liq  (suction positive)

    Material keys (mirroring ``mp->u_porous_vapor_pressure[i_pl][0..4]``):
    ``vapor_Psat`` flat-interface vapor pressure, ``rho_liquid``,
    ``vapor_Mw`` solvent molecular weight, ``gas_R`` gas constant,
    ``vapor_T`` temperature (used when no energy equation supplies T).
    """
    Mw = mat["vapor_Mw"]
    R = mat["gas_R"]
    rho_l = mat.get("rho_liquid", 1.0)
    if T is None:
        T = mat["vapor_T"]
    Psat = mat["vapor_Psat"]
    rho_sat = Mw / (R * T) * Psat
    p_liq = torch.as_tensor(p_liq)
    pc = torch.maximum(-p_liq, p_liq.new_zeros(()))
    return rho_sat * torch.exp(-pc * Mw / (rho_l * R * T))


class PorousMassFlux(FaceKernel):
    """POROUS_FLUX (``src/mm_fill_porous.c:3855 porous_mass_flux_surf_bc``):
    weak flux on the porous liquid-pressure equation

        q_n = porosity * k_m * (rho_gv(p_liq[, T]) - Y_c)
            + porosity * k_m1 * (p_liq - p_0)   [only where p_liq >= p_0]

    with rho_gv the Kelvin-equation gas density (:func:`kelvin_gas_density`)
    (evaporation into a bath of solvent density ``Y_c``) and the second
    term forced-liquid extraction above the sink pressure ``p_0``. A
    ``temperature`` field, when present, feeds the Kelvin factor (the
    reference's R_POR_ENERGY branch).
    """

    def __init__(self, k_m: float, Y_c: float = 0.0, k_m1: float = 0.0,
                 p_0: float = 0.0, comp: int = 0, ncomp: int = 1):
        super().__init__(POR_VAR, ncomp)
        self.k_m, self.Y_c = k_m, Y_c
        self.k_m1, self.p_0 = k_m1, p_0
        self.comp = comp

    def residual(self, sfv, mat, params):
        p = sfv.val[POR_VAR][:, self.comp]
        phi_por = prop(mat, "porosity", sfv, params, 1.0)
        T = sfv.val["temperature"][:, 0] if "temperature" in sfv.val else None
        rho_gv = kelvin_gas_density(p, mat, params, T=T)
        q = phi_por * self.k_m * (rho_gv - self.Y_c)
        if self.k_m1:
            q = q + phi_por * self.k_m1 * torch.where(
                p >= self.p_0, p - self.p_0, 0.0)
        phi = sfv.phi[POR_VAR]
        # the outward (evaporative) flux enters the weak form with a +
        # sign, the convention of ConvectiveHeatFlux (QCONV)
        return on_comp(q[:, None] * phi, self.comp, self.ncomp)


class LatentHeatFlux(FaceKernel):
    """LATENT_HEAT (``src/bc_integ.c:1603 lat_heat_bc``,
    ``src/mm_fill_species.c:7615``): evaporative latent-heat sink on the
    energy equation,

        q_n = sum_w L_w * mdot_w

    ``fluxes``: list of (L_w, mdot_w) pairs; each mdot_w is a scalar or a
    callable(sfv, mat, params) -> (nq,) mass flux, e.g. the closure
    driving a YFLUX/POROUS_FLUX condition on the species/porous equation,
    so the energy and mass leaks agree (the reference ties them through
    the BC_Data_Int[1] cross reference)."""

    def __init__(self, fluxes):
        super().__init__("temperature", 1)
        self.fluxes = list(fluxes)

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        q = sfv.x.new_zeros((nq,))
        for L, mdot in self.fluxes:
            m = mdot(sfv, mat, params) if callable(mdot) else mdot
            q = q + L * as_field(m, (nq,), sfv.x)
        phi = sfv.phi["temperature"]
        # outward energy flux (evaporative cooling): + sign like QCONV
        return (q[:, None] * phi)[:, None, :]


class VNormLeak(FaceKernel):
    """VNORM_LEAK (``include/rf_bc_const.h:864``; the kin_bc_leak family
    of ``src/mm_fill_species.c``): the normal-velocity closure through an
    evaporating / permeable wall,

        penalty * (n.(u - xdot) - sum_w mdot_w / rho) n_a phi_i

    on the momentum rows. ``leak``: scalar or callable(sfv, mat, params)
    -> (nq,) net normal leak VELOCITY (mass flux / rho)."""

    def __init__(self, dim: int, leak=0.0, penalty: float = 1e6):
        super().__init__("velocity", dim)
        self.dim = dim
        self.leak = leak
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        n = sfv.normal
        u = sfv.val["velocity"]
        if MESH_VAR in sfv.dot:
            u = u - sfv.dot[MESH_VAR]
        un = torch.einsum("qk,qk->q", n, u)
        lk = self.leak(sfv, mat, params) if callable(self.leak) else self.leak
        mis = un - lk
        phi = sfv.phi["velocity"]
        return self.penalty * torch.einsum("q,qa,qi->qai", mis, n, phi)


class PorousLSWickingFlux(FaceKernel):
    """POR_LIQ_FLUX_FILL (``src/mm_fill_porous.c:10928 por_liq_flux_fill``):
    level-set-gated liquid wicking into a porous substrate at a
    fluid<->porous boundary,

        q = -perm_c (1 - H(F)) (p_liq - pc1) - tau dp_liq/dt

    The porous liquid pressure relaxes toward the capillary pickup
    pressure pc1 wherever the level set says liquid wets the boundary (the
    H(F) = 0 side), with the reference's tau damping. Register the fill
    field on the porous block (shared nodes / PassiveVar)."""

    def __init__(self, perm_c: float, pc1: float, tau: float = 0.0,
                 eps=None, var: str = "porous_pressure", comp: int = 0,
                 ncomp: int = 1, fill_var: str = "fill"):
        super().__init__(var, ncomp)
        self.perm_c, self.pc1, self.tau = perm_c, pc1, tau
        self.eps = eps
        self.comp = comp
        self.fill_var = fill_var

    def residual(self, sfv, mat, params):
        from goma_tpu_torch.physics.level_set import heaviside

        eps = self.eps if self.eps is not None else params["ls_eps"]
        H = heaviside(sfv.val[self.fill_var][:, 0], eps)
        p = sfv.val[self.var][:, self.comp]
        q = -self.perm_c * (1.0 - H) * (p - self.pc1) \
            - self.tau * sfv.dot[self.var][:, self.comp]
        phi = sfv.phi[self.var]
        # a weak flux into the porous liquid-pressure rows (the reference
        # adds func directly; this diffusion weak form takes -phi q_n)
        return on_comp(-q[:, None] * phi, self.comp, self.ncomp)


class PorousConvection(FaceKernel):
    """POROUS_CONV (``src/mm_fill_porous.c:3984 porous_convection_bc``):
    convective mass transfer from a deforming (Lagrangian, mesh-inertia)
    porous medium, the solid-phase convection velocity carrying solvent
    mass through the boundary:

        func = + n . vconv * rho          (POROUS_SATURATED)
        func = - n . vconv * rho_bulk     (unsaturated)

    weak on the porous liquid-pressure rows. ``vconv``: the material key
    ``solid_convection`` (callable(sfv, mat, params) -> (nq, dim) or a
    constant vector, the reference's ``get_convection_velocity``); the
    mesh velocity when absent and the mesh variable is transient, else
    zero. ``rho``/``rho_bulk``: material keys ``rho`` / ``bulk_density``
    (constant or callable)."""

    def __init__(self, saturated: bool = True, comp: int = 0,
                 ncomp: int = 1, var: str = POR_VAR):
        super().__init__(var, ncomp)
        self.saturated = saturated
        self.comp = comp

    def residual(self, sfv, mat, params):
        nq, dim = sfv.x.shape
        v = mat.get("solid_convection", None)
        if v is None:
            v = sfv.dot[MESH_VAR] if MESH_VAR in sfv.dot else \
                sfv.x.new_zeros((nq, dim))
        elif callable(v):
            v = v(sfv, mat, params)
        else:
            v = as_field(v, (nq, dim), sfv.x)
        vn = torch.einsum("qk,qk->q", v, sfv.normal)
        if self.saturated:
            func = prop(mat, "rho", sfv, params, 1.0) * vn
        else:
            rb = mat.get("bulk_density", 1.0)
            rb = rb(sfv, mat, params) if callable(rb) else rb
            func = -rb * vn
        phi = sfv.phi[self.var]
        return on_comp(func[:, None] * phi, self.comp, self.ncomp)


def porous_gas_gen_leak(dens_vap: float, var: str = POR_VAR, comp: int = 0):
    """VN_POROUS (``src/mm_fill_porous.c:4124 porous_normal_velocity_bc``):
    the fluid-side normal velocity generated by solvent vapor leaving an
    adjacent porous solid,

        n . v = n . j_rel / dens_vap,
        j_rel = -rho_l (k/mu_l) (grad p_liq - rho_l g)

    (the Darcy relative mass flux of liquid solvent, the reference's
    ``pmv->rel_mass_flux``). Returns a ``leak`` callable for
    :class:`VNormLeak` on the momentum rows; register the porous pressure
    on the fluid block (shared nodes / ``PassiveVar``). Material keys:
    ``k_over_mu`` (mobility k/mu_l), ``rho_liq``, optional ``gravity``."""

    def leak(sfv, mat, params):
        gp = sfv.grad[var][:, comp, :]
        kmu = prop(mat, "k_over_mu", sfv, params, 1.0)
        rho_l = mat.get("rho_liq", 1.0)
        drive = gp
        g = mat.get("gravity", None)
        if g is not None:
            drive = drive - rho_l * torch.as_tensor(
                g, dtype=sfv.x.dtype, device=sfv.x.device)[None, :]
        scalar = not torch.is_tensor(kmu) or kmu.dim() == 0
        j = -rho_l * kmu * drive if scalar else -rho_l * kmu[:, None] * drive
        return torch.einsum("qk,qk->q", j, sfv.normal) / dens_vap

    return leak
