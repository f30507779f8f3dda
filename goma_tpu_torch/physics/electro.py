"""Electric potential and electrochemistry (counterpart of
``goma_tpu/physics/electro.py``).

Parity: reference ``src/mm_fill_potential.c`` (``assemble_potential:124``,
Butler-Volmer surface currents :966-1255) and the surface-kinetics fluxes
of ``src/mm_fill_species.c`` (Butler-Volmer :2075, HOR :2134, ORR :2195,
nickel plating :2652, alloy evaporation :4280, PEM water :2270/:2314).

Potential equation (electroneutral conductor): div(kappa grad V) = 0, with
electrode kinetics as integrated boundary fluxes (face kernels).
"""

from __future__ import annotations

import math

import torch

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.physics.materials import _floor, as_field, prop

POT_VAR = "voltage"
FARADAY = 96485.33212  # C/mol
GAS_R = 8.314462618


def on_comp(v, comp: int, ncomp: int):
    """(nq, ncomp, nbf) with ``v`` (nq, nbf) on row ``comp`` and zeros on
    the others (goma_tpu's ``zeros(...).at[:, comp, :].set(v)``, built out
    of place so it maps under ``torch.func.vmap``)."""
    z = torch.zeros_like(v)
    return torch.stack([v if c == comp else z for c in range(ncomp)], dim=1)


def _potential(sfv):
    return sfv.val[POT_VAR][:, 0] if POT_VAR in sfv.val else 0.0


def _exp(v):
    """exp of a tensor or of a python float (a term without the
    potential variable is a constant)."""
    return torch.exp(v) if torch.is_tensor(v) else math.exp(v)


class Potential(Equation):
    """div(kappa grad V) + source = 0. Material keys ``kappa`` and the
    optional ``current_source``."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(POT_VAR, 1, interp)

    def residual(self, fv, mat, params):
        gV = fv.grad[POT_VAR][:, 0, :]
        kappa = prop(mat, "kappa", fv, params, 1.0)
        if torch.is_tensor(kappa) and kappa.ndim > 0:
            kappa = kappa[:, None]
        contrib = torch.einsum("qk,qik->qi", kappa * gV, fv.gphi[POT_VAR])
        src = mat.get("current_source", None)
        if src is not None:
            s = src(fv, mat, params) if callable(src) else src
            contrib = contrib - torch.einsum(
                "q,qi->qi", as_field(s, gV.shape[:1], gV), fv.phi[POT_VAR])
        return contrib[:, None, :]


class ButlerVolmerBC(FaceKernel):
    """Electrode kinetics (BUTLER_VOLMER, src/mm_fill_potential.c:966):
    normal current density i = i0 [exp(aa F eta/RT) - exp(-ac F eta/RT)],
    eta = V_metal - V, a weak flux on the potential equation."""

    def __init__(self, i0: float, alpha_a: float, alpha_c: float,
                 V_metal: float, T: float = 298.15):
        super().__init__(POT_VAR, 1)
        self.i0, self.aa, self.ac = i0, alpha_a, alpha_c
        self.V_metal, self.T = V_metal, T

    def residual(self, sfv, mat, params):
        eta = self.V_metal - sfv.val[POT_VAR][:, 0]
        f = FARADAY / (GAS_R * self.T)
        i = self.i0 * (torch.exp(self.aa * f * eta)
                       - torch.exp(-self.ac * f * eta))
        # the current entering the electrolyte = -(kappa grad V . n)
        return -(i[:, None] * sfv.phi[POT_VAR])[:, None, :]


class HORFlux(FaceKernel):
    """Hydrogen oxidation, linearized Butler-Volmer (``mass_flux_surf_HOR``,
    src/mm_fill_species.c:2134):

        q = (ai0 H / (n R T)) (c/cref)^beta (alpha_a + alpha_c)(V - Phi - U0)

    + int phi q on the species equation; Phi the electrolyte potential
    variable when present (else 0)."""

    def __init__(self, ai0: float, H: float, n: float, alpha_a: float,
                 alpha_c: float, U0: float, beta: float, cref: float,
                 V: float, T: float = 298.15, comp: int = 0,
                 var: str = "species", ncomp: int = 1):
        super().__init__(var, ncomp)
        self.k = ai0 * H / (n * GAS_R * T)
        self.ac_sum = alpha_a + alpha_c
        self.U0, self.beta, self.cref, self.V = U0, beta, cref, V
        self.comp = comp

    def residual(self, sfv, mat, params):
        c = sfv.val[self.var][:, self.comp]
        q = self.k * (_floor(c, 1e-30) / self.cref) ** self.beta \
            * self.ac_sum * (self.V - _potential(sfv) - self.U0)
        return on_comp(q[:, None] * sfv.phi[self.var], self.comp, self.ncomp)


class ORRFlux(FaceKernel):
    """Oxygen reduction, cathodic Tafel (``mass_flux_surf_ORR``,
    src/mm_fill_species.c:2195):

        q = (ai0 H / (n F)) (c/cref)^beta exp(-alpha_c F (V - Phi - U0)/(R T))
    """

    def __init__(self, ai0: float, H: float, n: float, alpha_c: float,
                 U0: float, beta: float, cref: float, V: float,
                 T: float = 298.15, comp: int = 0, var: str = "species",
                 ncomp: int = 1):
        super().__init__(var, ncomp)
        self.k = ai0 * H / (n * FARADAY)
        self.f = alpha_c * FARADAY / (GAS_R * T)
        self.U0, self.beta, self.cref, self.V = U0, beta, cref, V
        self.comp = comp

    def residual(self, sfv, mat, params):
        c = sfv.val[self.var][:, self.comp]
        q = self.k * (_floor(c, 1e-30) / self.cref) ** self.beta \
            * _exp(-self.f * (self.V - _potential(sfv) - self.U0))
        return on_comp(q[:, None] * sfv.phi[self.var], self.comp, self.ncomp)


class NickelPlatingFlux(FaceKernel):
    """YFLUX_NI / CURRENT_NI (``src/mm_fill_species.c:2652
    mass_flux_surf_NI``): the fitted four-reaction nickel-electroplating
    kinetics

        H+    + e-  -> H2/2        (alpha_c 0.11, i00 0.289,    U00  0)
        H2O   + e-  -> H2/2 + OH-  (alpha_c 0.4,  i00 8.80e-9,  U00 -0.8280)
        NiOH+ + 2e- -> Ni + OH-    (alpha_c 0.33, i00 1.34,     U00 -0.3648)
        Ni2+  + 2e- -> Ni          (alpha_c 0.21, i00 1.07e-5,  U00 -0.2363)

    as coded in the reference. ``mode``: a species index (0 Ni2+, 2 H+, 3
    OH-, 4 NiOH+) applies that species' net outward flux on its rows;
    ``"current"`` the electron-weighted sum on the potential rows.
    ``c_total`` a constant or callable(sfv, mat, params) -> (nq,)."""

    F = 96487.0
    GAS_R = 8.314

    def __init__(self, mode, PHI_E: float, T: float, c_total=1.0,
                 idx=(0, 2, 3, 4), var: str = "species", ncomp: int = 1):
        if mode == "current":
            super().__init__(POT_VAR, 1)
        else:
            super().__init__(var, ncomp)
        self.mode = mode
        self.PHI_E = PHI_E
        self.T = T
        self.c_total = c_total
        self.i_ni, self.i_h, self.i_oh, self.i_nioh = idx
        self.species_var = var

    def _fluxes(self, sfv, mat, params):
        FRT = self.F / (self.GAS_R * self.T)
        Phi = _potential(sfv)
        ct = self.c_total(sfv, mat, params) if callable(self.c_total) \
            else self.c_total
        x = sfv.val[self.species_var]

        def dphi(n, U00):
            return n * FRT * (self.PHI_E - Phi - U00)

        d = dphi(1, 0.0)
        Q1 = (0.289 / (1 * self.F)) * _exp(-0.11 * d) \
            * ct * x[:, self.i_h] / 0.001
        d = dphi(1, -0.8280)
        Q2 = (8.80e-09 / (1 * self.F)) * _exp(-0.4 * d)
        d = dphi(2, -0.3648)
        Q3 = (1.34 / (2 * self.F)) * (ct / 0.001) * (
            _exp(-0.33 * d) * x[:, self.i_nioh]
            - _exp(0.67 * d) * x[:, self.i_oh])
        d = dphi(2, -0.2363)
        Q4 = (1.07e-05 / (2 * self.F)) * (
            _exp(-0.21 * d) * ct
            * x[:, self.i_ni] / 0.001
            - _exp(0.79 * d))
        return {self.i_h: Q1, self.i_oh: -Q2 - Q3, self.i_nioh: Q3,
                self.i_ni: Q4, "current": Q1 + Q2 + 2.0 * Q3 + 2.0 * Q4}

    def residual(self, sfv, mat, params):
        fl = self._fluxes(sfv, mat, params)
        phi = sfv.phi[self.var]
        if self.mode == "current":
            q = fl["current"]
            return (q[:, None] * phi)[:, None, :]
        return on_comp(fl[self.mode][:, None] * phi, self.mode, self.ncomp)


class AlloyEvapFlux(FaceKernel):
    """YFLUX_ALLOY (``src/mm_fill_species.c:4280 mass_flux_alloy_surf``):
    metal evaporation with a cubic-in-temperature transfer coefficient,
    n.j = exp[c0 + c1 dT - c2 dT^2 + c3 dT^3] (y - y_inf), dT = T - Tm."""

    def __init__(self, Tm: float, c0: float, c1: float, c2: float,
                 c3: float, y_inf: float, comp: int = 0,
                 var: str = "species", ncomp: int = 1):
        super().__init__(var, ncomp)
        self.Tm, self.c = Tm, (c0, c1, c2, c3)
        self.y_inf, self.comp = y_inf, comp

    def residual(self, sfv, mat, params):
        dT = sfv.val["temperature"][:, 0] - self.Tm
        c0, c1, c2, c3 = self.c
        k = torch.exp(c0 + c1 * dT - c2 * dT**2 + c3 * dT**3)
        q = k * (sfv.val[self.var][:, self.comp] - self.y_inf)
        return on_comp(q[:, None] * sfv.phi[self.var], self.comp, self.ncomp)


class CurrentSIC(FaceKernel):
    """CURRENT_SIC / CURRENT_USER_SIC (``src/mm_fill_potential.c:1702
    apply_potential_grad_bc``): pin the boundary current density,
    i_applied + perm (grad V . n) = 0, as a penalty on the voltage rows.
    ``i_app`` a constant or callable(sfv, mat, params) -> (nq,)."""

    def __init__(self, i_app, perm: float = None, penalty: float = 1e6):
        super().__init__(POT_VAR, 1)
        self.i_app = i_app
        self.perm = perm
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        perm = self.perm if self.perm is not None else \
            prop(mat, "permittivity", sfv, params, 1.0)
        gV = sfv.grad[POT_VAR][:, 0, :]
        ia = self.i_app(sfv, mat, params) if callable(self.i_app) \
            else as_field(self.i_app, (nq,), sfv.x)
        s = ia + perm * torch.einsum("qk,qk->q", gV, sfv.normal)
        return self.penalty * (s[:, None] * sfv.phi[POT_VAR])[:, None, :]


def surface_charge_constraint(charges, sigma: float, replace_comp: int):
    """SURFACE_CHARGE (``src/mm_fill_potential.c:917 surface_charge_surf``):
    the strong constraint sum_i z_i c_i = sigma on the species, for
    ``Problem.add_point_constraint(nodeset, "species", replace_comp, g)``."""
    zs = [float(z) for z in charges]

    def g(q, X0, params):
        z = torch.as_tensor(zs, dtype=q.dtype, device=q.device)
        return torch.dot(z, q[: z.shape[0]]) - sigma

    return g


def electrodeposition_velocity(PHI_E: float, T: float, Vmolar: float,
                               c_total=1.0, idx=(0, 2, 3, 4),
                               var: str = "species"):
    """KIN_ELECTRODEPOSITION / VNORM_ELECTRODEPOSITION
    (``src/mm_fill_species.c:8029/8243``): v_n = Vmolar (Q_Ni + Q_NiOH),
    the nickel-plating deposit rate, as a callable(sfv, mat, params)."""
    probe = NickelPlatingFlux(mode=0, PHI_E=PHI_E, T=T, c_total=c_total,
                              idx=idx, var=var)

    def v_n(sfv, mat, params):
        fl = probe._fluxes(sfv, mat, params)
        return Vmolar * (fl[probe.i_ni] + fl[probe.i_nioh])

    return v_n


class PEMWaterFlux(FaceKernel):
    """YFLUX_H2O_ANODE / YFLUX_H2O_CATHODE (``src/mm_fill_species.c:2270``,
    ``:2314``): PEM water transport by electro-osmotic drag (and product
    water at the cathode), as the reference writes it:

        anode:   q = -ai0 Ha sqrt(c/cref) (alpha_a+alpha_c)/2
                     (Phi + U0)/(R T) nd
        cathode: q = -(nd + 2) (ai0 Hc / (4 F)) (c/cref)
                     exp(-alpha_c F/(R T) (V - Phi - U0))

    on species component ``comp``; the rows get -q."""

    F = 96487.0
    GAS_R = 8.314

    def __init__(self, side: str, ai0: float, H: float, cref: float,
                 alpha_a: float, alpha_c: float, T: float, U0: float,
                 nd: float, V: float = 0.0, comp: int = 0,
                 var: str = "species", ncomp: int = 1):
        assert side in ("anode", "cathode")
        super().__init__(var, ncomp)
        self.side = side
        self.ai0, self.H, self.cref = ai0, H, cref
        self.alpha_a, self.alpha_c = alpha_a, alpha_c
        self.T, self.U0, self.nd, self.V = T, U0, nd, V
        self.comp = comp

    def residual(self, sfv, mat, params):
        Phi = _potential(sfv)
        c = sfv.val[self.var][:, self.comp]
        if self.side == "anode":
            cr = torch.sqrt(_floor(c, 1e-30) / self.cref)
            q = -self.ai0 * self.H * cr * 0.5 \
                * (self.alpha_a + self.alpha_c) \
                * (Phi + self.U0) / (self.GAS_R * self.T) * self.nd
        else:
            cr = _floor(c, 1e-10) / self.cref
            grp = self.alpha_c * self.F / (self.GAS_R * self.T) \
                * (self.V - Phi - self.U0)
            q = -(self.nd + 2.0) * (self.ai0 * self.H / (4.0 * self.F)) \
                * cr * _exp(-grp)
        return on_comp(-q[:, None] * sfv.phi[self.var], self.comp,
                       self.ncomp)
