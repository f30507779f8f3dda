"""Porous-media flow: saturated Darcy and unsaturated Richards equation
(counterpart of ``goma_tpu/physics/porous.py``).

Parity: reference ``src/mm_fill_porous.c`` (``assemble_porous_transport:106``,
property loading ``load_porous_properties:995``), the saturated /
unsaturated liquid-phase transport subset, with the van Genuchten / Mualem
closures from the standard formulas (the reference hand-codes the same
models and their derivatives in C).

Richards equation (pressure head form, liquid phase):
    phi * dS(p)/dt  -  div( k k_r(p)/mu * (grad p - rho g) ) = 0

dS/dp is ``torch.func.grad`` of the saturation, mapped over the
quadrature points inside the element residual, itself under the
assembly's ``vmap(jacfwd)``. The ``where``/clip guards are goma_tpu's:
they keep forward-mode AD free of 0 * inf, and a clip is a maximum then a
minimum (``jnp.clip``'s form: half the derivative at a bound, where
``torch.clamp`` gives all of it).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, vmap

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.materials import _clip, _floor, prop

POR_VAR = "porous_pressure"


def _const(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _ceil(a, hi: float):
    """min(a, hi) with jnp.minimum's derivative."""
    return torch.minimum(a, _const(hi, a))


class VanGenuchten:
    """S_eff(p) = [1 + (alpha |p|)^n]^(-m), m = 1-1/n for p < 0 (suction);
    Mualem relative permeability k_r = sqrt(S)[1-(1-S^(1/m))^m]^2."""

    def __init__(self, alpha: float, n: float, s_res: float = 0.0,
                 s_sat: float = 1.0, kr_min: float = 1e-6):
        # kr_min regularizes the dry limit (k_r, dS/dp -> 0 makes the system
        # singular; the role of the reference's porous cutoffs)
        self.alpha, self.n, self.m = alpha, n, 1.0 - 1.0 / n
        self.s_res, self.s_sat = s_res, s_sat
        self.kr_min = kr_min

    def _se(self, p):
        suction = torch.where(p < 0, -p, 0.0)
        return (1.0 + (self.alpha * suction) ** self.n) ** (-self.m)

    def saturation(self, p):
        return self.s_res + (self.s_sat - self.s_res) * self._se(p)

    def krel(self, p):
        # the saturated branch is exactly 1; the unsaturated branch is
        # evaluated at se clipped AWAY from 1, because (1 - se^(1/m))^m has
        # an infinite slope at se = 1: under forward-mode AD that is
        # 0 * inf = NaN for every p >= 0
        se = _clip(self._se(p), 1e-7, 1.0 - 1e-9)
        kr_unsat = torch.sqrt(se) * (
            1.0 - (1.0 - se ** (1.0 / self.m)) ** self.m) ** 2
        kr = torch.where(p < 0, kr_unsat, 1.0)
        return _floor(kr, self.kr_min)


class TwoPhasePorous(Equation):
    """Two-phase (liquid + gas) porous flow, components (p_liq, p_gas) of
    ``porous_pressure``. Reference: POROUS_TWO_PHASE media
    (``src/mm_fill_porous.c assemble_porous_transport:106``, the gas-phase
    branch).

    Liquid:  phi dS/dt - div( k k_rl/mu_l (grad p_l - rho_l g) ) = 0
    Gas:     phi d[(1-S) rho_g]/dt
             - div( rho_g k k_rg/mu_g (grad p_g - rho_g g) ) = 0

    with S = S(p_c), p_c = p_g - p_l (van Genuchten), Mualem relative
    permeabilities k_rl(S), k_rg = sqrt(1-Se)(1 - Se^(1/m))^(2m). The gas
    is ideal-compressible when ``compressible`` (rho_g = rho_g_ref
    p_g/p_ref), else of constant density.

    Material keys: permeability, porosity, mu_liquid, mu_gas, rho_liquid,
    rho_gas (reference density), p_ref, gravity_vec optional.
    """

    def __init__(self, model: VanGenuchten, interp: str = "Q1",
                 transient: bool = True, compressible: bool = False):
        super().__init__(POR_VAR, 2, interp)
        self.model = model
        self.transient = transient
        self.compressible = compressible

    def _sat_of_pc(self, pc):
        """S(p_c): suction p_c > 0 dries the medium (the same VG closure
        with p = -p_c)."""
        return self.model.saturation(-pc)

    def _krg(self, pc):
        m = self.model.m
        suction = torch.where(pc > 0, pc, 0.0)
        se = (1.0 + (self.model.alpha * suction) ** self.model.n) ** (-m)
        se = _clip(se, 1e-7, 1.0 - 1e-7)
        krg = torch.sqrt(1.0 - se) * (1.0 - se ** (1.0 / m)) ** (2.0 * m)
        return _floor(krg, self.model.kr_min)

    def residual(self, fv, mat, params):
        pl = fv.val[POR_VAR][:, 0]
        pg = fv.val[POR_VAR][:, 1]
        gpl = fv.grad[POR_VAR][:, 0, :]
        gpg = fv.grad[POR_VAR][:, 1, :]
        pc = pg - pl

        k = prop(mat, "permeability", fv, params, 1.0)
        phi_por = prop(mat, "porosity", fv, params, 1.0)
        mul = prop(mat, "mu_liquid", fv, params, 1.0)
        mug = prop(mat, "mu_gas", fv, params, 1.0)
        rho_l = prop(mat, "rho_liquid", fv, params, 1.0)
        rho_g_ref = prop(mat, "rho_gas", fv, params, 1.0)
        p_ref = mat.get("p_ref", 1.0)
        rho_g = rho_g_ref * pg / p_ref if self.compressible else \
            rho_g_ref * torch.ones_like(pg)

        krl = self.model.krel(-pc)
        krg = self._krg(pc)
        gvec = mat.get("gravity_vec", None)

        drive_l = gpl
        drive_g = gpg
        if gvec is not None:
            g = _const(gvec, pl)[None, :]
            drive_l = gpl - rho_l * g
            drive_g = gpg - rho_g[:, None] * g
        flux_l = (k * krl / mul)[:, None] * drive_l
        flux_g = (rho_g * k * krg / mug)[:, None] * drive_g

        phi_b = fv.phi[POR_VAR]
        gphi = fv.gphi[POR_VAR]
        rl = torch.einsum("qk,qik->qi", flux_l, gphi)
        rg = torch.einsum("qk,qik->qi", flux_g, gphi)
        if self.transient:
            dS = vmap(grad(self._sat_of_pc))(pc)
            pldot = fv.dot[POR_VAR][:, 0]
            pgdot = fv.dot[POR_VAR][:, 1]
            pcdot = pgdot - pldot
            S = self._sat_of_pc(pc)
            rl = rl + torch.einsum("q,qi->qi", phi_por * dS * pcdot, phi_b)
            # gas storage: phi d[(1-S) rho_g]/dt
            gas_dot = -dS * pcdot * rho_g
            if self.compressible:
                gas_dot = gas_dot + (1.0 - S) * rho_g_ref / p_ref * pgdot
            rg = rg + torch.einsum("q,qi->qi", phi_por * gas_dot, phi_b)
        return torch.stack([rl, rg], dim=1)


class PorousFlow(Equation):
    """Saturated (model=None) or unsaturated (model=VanGenuchten or
    TanhHystSaturation) flow.

    Material keys: ``permeability`` k, ``porosity`` phi, ``mu_liquid``,
    ``gravity_vec`` optional (dim,) with ``rho_liquid``.
    """

    def __init__(self, model: VanGenuchten | None = None, interp: str = "Q1",
                 transient: bool = True):
        super().__init__(POR_VAR, 1, interp)
        self.model = model
        self.transient = transient

    def residual(self, fv, mat, params):
        p = fv.val[POR_VAR][:, 0]
        gp = fv.grad[POR_VAR][:, 0, :]
        k = prop(mat, "permeability", fv, params, 1.0)
        mu = prop(mat, "mu_liquid", fv, params, 1.0)
        phi_por = prop(mat, "porosity", fv, params, 1.0)

        hyst = isinstance(self.model, TanhHystSaturation)
        if hyst:
            kr = self.model.krel_fv(p, fv)
        else:
            kr = self.model.krel(p) if self.model is not None else 1.0
        mob = k * kr / mu
        drive = gp
        gvec = mat.get("gravity_vec", None)
        if gvec is not None:
            rho = prop(mat, "rho_liquid", fv, params, 1.0)
            drive = gp - rho * _const(gvec, p)[None, :]
        scalar = not torch.is_tensor(mob) or mob.dim() == 0
        flux = (mob if scalar else mob[:, None]) * drive

        phi_b = fv.phi[POR_VAR]
        gphi = fv.gphi[POR_VAR]
        contrib = torch.einsum("qk,qik->qi", flux, gphi)
        if self.transient and self.model is not None:
            # phi * dS/dt = phi * S'(p) * pdot (AD gives S'(p) along the
            # active scanning curve of the hysteretic model)
            if hyst:
                dS = vmap(grad(lambda pp, cu, sw, pw: self.model.saturation_pc(
                    -pp, cu, sw, pw)))(
                    p, fv.ext["hyst_curve"], fv.ext["hyst_sat_switch"],
                    fv.ext["hyst_pc_switch"])
            else:
                dS = vmap(grad(self.model.saturation))(p)
            pdot = fv.dot[POR_VAR][:, 0]
            contrib = contrib + torch.einsum("q,qi->qi", phi_por * dS * pdot,
                                             phi_b)
        if "sink_linear" in mat and SINK_VAR in fv.val:
            # absorbing-particle sink (the reference's porous sink mass
            # coupling, its J_pm_sink_mass blocks by AD): liquid removed at
            # rate A
            if hyst:
                S = self.model.saturation_fv(p, fv)
            else:
                S = self.model.saturation(p) if self.model is not None else 1.0
            A = sink_absorption_rate(fv, mat, params, S)
            contrib = contrib + torch.einsum("q,qi->qi", A, phi_b)
        return contrib[:, None, :]


SINK_VAR = "sink_mass"


def sink_absorption_rate(fv, mat, params, saturation):
    """LINEAR porous-sink absorption rate (the reference's
    ``por_mass_source_model``, src/mm_fill_porous.c:11271):

        A = tau * k2 * (s_max - s) * S / s_max   (>= 0, gated on S >= S_on)

    Material key ``sink_linear`` = (tau, s_max, k2, S_on)."""
    tau, smax, k2, S_on = mat["sink_linear"]
    s = fv.val[SINK_VAR][:, 0]
    S = saturation if torch.is_tensor(saturation) else torch.full_like(
        s, saturation)
    gate = torch.where(S >= S_on, torch.full_like(S, tau), 0.0)
    return gate * k2 * (smax - s) * saturation / smax


class PorousSinkMass(Equation):
    """Absorbed-mass evolution (the reference's ``assemble_pore_sink_mass``,
    src/mm_fill_porous.c:734): s_dot = rho_liquid * A with A the absorption
    rate; the matching ``-A`` liquid sink enters ``PorousFlow`` through the
    ``sink_linear`` material key, so liquid + absorbed mass is conserved."""

    def __init__(self, model: VanGenuchten | None = None, interp: str = "Q1"):
        super().__init__(SINK_VAR, 1, interp)
        self.model = model

    def residual(self, fv, mat, params):
        rho = prop(mat, "rho_liquid", fv, params, 1.0)
        if self.model is not None and POR_VAR in fv.val:
            S = self.model.saturation(fv.val[POR_VAR][:, 0])
        else:
            S = torch.ones_like(fv.val[SINK_VAR][:, 0])
        A = sink_absorption_rate(fv, mat, params, S)
        r = fv.dot[SINK_VAR][:, 0] - rho * A
        return (r[:, None] * fv.phi[SINK_VAR])[:, None, :]


class TanhHystSaturation:
    """Hysteretic tanh saturation with scanning curves: the reference's
    TANH_HYST model (``src/mm_fill_porous.c:5773``) with its per-point
    reversal state (``rf_element_storage.c`` Sat_QP_tn / p_cap_QP /
    sat_curve_type) and the d(p_liq)/dt reversal criterion
    (``evaluate_sat_hyst_criterion``, mm_fill_porous.c:11210; the nodal
    variant rf_util.c:3982).

    As in goma_tpu the reversal state lives in three NODAL external fields
    (curve type 0 = wetting / 1 = draining, S at reversal, p_c at
    reversal), frozen within a time step, so the residual stays
    branch-free (one ``torch.where`` over the two curves) and AD gives
    dS/dp along the active scanning curve. Between accepted steps
    ``update_state`` applies the reference's switch rules on the host
    (numpy).

    The parameters mirror u_saturation[0..9]: (s_max, beta_w, alpha_w)
    wetting, (s_min, beta_d, alpha_d) draining, the initial curve, the
    switch-rate threshold.
    """

    EXT_FIELDS = ("hyst_curve", "hyst_sat_switch", "hyst_pc_switch")

    def __init__(self, s_max: float, beta_w: float, alpha_w: float,
                 s_min: float, beta_d: float, alpha_d: float,
                 draining_initial: bool = True,
                 switch_threshold: float = 0.0, kr_min: float = 1e-6,
                 mualem_m: float = 0.5):
        self.s_max, self.beta_w, self.alpha_w = s_max, beta_w, alpha_w
        self.s_min, self.beta_d, self.alpha_d = s_min, beta_d, alpha_d
        self.draining_initial = draining_initial
        self.switch_threshold = switch_threshold
        self.kr_min = kr_min
        self.mualem_m = mualem_m

    # ---------------------------------------------------------- curves
    def saturation_pc(self, pc, curve, sat_sw, pc_sw):
        """S(p_c) on the active scanning curve through the reversal point
        (mm_fill_porous.c:5823-5885, the con_a/con_b construction)."""
        pc = _floor(pc, 1e-5)
        pc_sw = _floor(pc_sw, 1e-5)
        td = torch.tanh(self.beta_d - self.alpha_d / pc)
        td_sw = torch.tanh(self.beta_d - self.alpha_d / pc_sw)
        # The anchoring denominators vanish when pc_sw sits in the curve's
        # degenerate region (pc_sw << alpha/beta, where tanh saturates),
        # for the inactive branch (a draining-initial wetting anchor at
        # pc_sw ~ 0) and for reversals at very low suction. goma_tpu clamps
        # them sign-safely: finite values and derivatives, a bounded
        # scanning-curve slope, an O(clamp) anchoring error where the
        # curves carry no information.
        den_d = _ceil(-1.0 + td_sw, -1e-2)
        con_b_d = (sat_sw - self.s_min) / den_d
        S_d = (self.s_min - con_b_d) + con_b_d * td
        tw = torch.tanh(self.beta_w - self.alpha_w / pc)
        tw_sw = torch.tanh(self.beta_w - self.alpha_w / pc_sw)
        den_w = _floor(tw_sw + 1.0, 1e-2)
        con_b_w = (sat_sw - self.s_max) / den_w
        S_w = (1.0 + con_b_w) + con_b_w * tw
        return _clip(torch.where(curve >= 0.5, S_d, S_w), 0.0, 1.0)

    def saturation_fv(self, p, fv):
        """S at the quadrature points; the Richards convention p_c = -p_liq
        (p_gas = 0)."""
        return self.saturation_pc(-p, fv.ext["hyst_curve"],
                                  fv.ext["hyst_sat_switch"],
                                  fv.ext["hyst_pc_switch"])

    def krel_fv(self, p, fv):
        """Mualem k_r on the effective saturation of the current state."""
        S = self.saturation_fv(p, fv)
        # clipped away from 1: (1 - se^(1/m))^m has an infinite slope at
        # se = 1 (see VanGenuchten.krel)
        se = _clip((S - self.s_min) / (self.s_max - self.s_min),
                   1e-7, 1.0 - 1e-9)
        m = self.mualem_m
        kr = torch.sqrt(se) * (1.0 - (1.0 - se ** (1.0 / m)) ** m) ** 2
        return _floor(kr, self.kr_min)

    # ----------------------------------------------------------- state
    def init_state(self, n_nodes: int) -> dict:
        """Main-curve initial state (rf_element_storage.c:352-370)."""
        if self.draining_initial:
            sat_sw = self.s_max
            pc_sw = 1e-12
        else:
            pc_sw = 1e12 * self.alpha_w
            sat_sw = self.s_max - (self.s_max - self.s_min) * 0.5 * (
                1.0 + np.tanh(self.beta_w - self.alpha_w / pc_sw))
        return {
            "hyst_curve": np.full(n_nodes, 1.0 if self.draining_initial else 0.0),
            "hyst_sat_switch": np.full(n_nodes, sat_sw),
            "hyst_pc_switch": np.full(n_nodes, pc_sw),
        }

    def update_state(self, state: dict, p_nodal, pdot_nodal) -> dict:
        """Apply the reversal rules after an accepted step
        (mm_fill_porous.c:11230-11265), on the host: dp_liq/dt > 0 means
        imbibing; switch the curve when the rate changes sign with a
        magnitude above the threshold, keeping (S, p_c) as the new
        reversal point."""
        p = _host(p_nodal)
        pdot = _host(pdot_nodal)
        pc = np.maximum(-p, 1e-5)
        curve = state["hyst_curve"].copy()
        ssw = state["hyst_sat_switch"].copy()
        pcsw = state["hyst_pc_switch"].copy()
        S_now = self.saturation_pc(*(torch.as_tensor(a, dtype=torch.float64)
                                     for a in (pc, curve, ssw, pcsw))).numpy()
        thr = self.switch_threshold
        to_wet = (pdot > 0) & (curve >= 0.5) & (np.abs(pdot) > thr) & (S_now <= 0.9999)
        to_dry = (pdot <= 0) & (curve < 0.5) & (np.abs(pdot) > thr)
        for mask, newc in ((to_wet, 0.0), (to_dry, 1.0)):
            curve[mask] = newc
            ssw[mask] = S_now[mask]
            pcsw[mask] = pc[mask]
        return {"hyst_curve": curve, "hyst_sat_switch": ssw,
                "hyst_pc_switch": pcsw}


def _host(a):
    """A host float64 numpy copy of a numpy array or a tensor."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=float)
