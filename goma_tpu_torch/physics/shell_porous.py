"""Porous-shell equations: thin porous layers coupled to lubrication
(counterpart of ``goma_tpu/physics/shell_porous.py``).

Parity targets (the reference's behavior, re-derived for the AD assembly):

- ``assemble_porous_shell_closed`` (``src/mm_fill_shell.c:11117``):
  closed-cell saturation S, capillary imbibition against trapped-gas
  compression, through the through-thickness Darcy velocity of
  ``dPdz_function`` (``:10869``),

      dP/dz = (P_gas - P_lub - P_cap) / (S H),   v_z = -(k/mu) dP/dz
      P_gas = P0 nbar / (1 - S) + (Pref - Patm),  P_cap = 2 sigma cos(theta)/R
      k = phi r^2 / 8

  with R_S,i = phi_i (dS/dt - v_z / (phi H)) and the absorbed liquid as a
  sink in the lubrication balance (``LubPorousSink``, ``:11290``);
- ``assemble_porous_shell_open`` (``:11945``): the open-cell pore
  pressure with in-plane Darcy flow and exchange with the lubrication
  layer, S(P) a capillary retention curve;
- ``assemble_porous_shell_gasn`` (``:11650``): the trapped-gas inventory;
- ``assemble_porous_shell_saturation`` (``:13197``): stacked saturation
  layers exchanging liquid through capillary-pressure differences.

The retention slope S'(P) is ``vmap(grad(...))`` of the curve, a
``torch.func`` transform that nests inside the assembler's ``jacfwd``.
"""

from __future__ import annotations

import torch
from torch.func import grad, vmap

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.materials import _floor, prop
from goma_tpu_torch.physics.shell_film import _height

SAT_CLOSED = "shell_sat_closed"   # SHELL_SAT_CLOSED
P_OPEN = "shell_press_open"       # SHELL_PRESS_OPEN
SAT_GASN = "shell_sat_gasn"       # SHELL_SAT_GASN
LUB_VAR = "lub_pressure"          # shared with physics.lubrication


def closed_cell_vz(fv, mat, params):
    """Through-thickness imbibition velocity v_z of the closed-cell model
    (dPdz_function, mm_fill_shell.c:10869). Material keys: porosity,
    pore_radius (R), pore_height (H), mu, sigma, contact_angle_deg, P0,
    Pref/Patm, nbar (or the solved gas inventory ``shell_sat_gasn``), and
    the lubrication pressure (the solved ``lub_pressure`` or the material
    key). Returns (v_z, porosity, H)."""
    S = torch.clamp(fv.val[SAT_CLOSED][:, 0], 1e-4, 1.0 - 1e-6)
    phi_p = mat.get("porosity", 0.5)
    R = mat["pore_radius"]
    H = mat.get("pore_height", 1.0)
    mu = prop(mat, "mu", fv, params, 1.0)
    sigma = mat.get("sigma", 1.0)
    theta = torch.deg2rad(torch.as_tensor(mat.get("contact_angle_deg", 0.0),
                                          dtype=S.dtype, device=S.device))
    P0 = mat.get("P0", 1.0)
    # nbar = fv->sh_sat_gasn when the gas-dissolution equation is active
    # (mm_fill_shell.c:10967)
    if SAT_GASN in fv.val:
        nbar = fv.val[SAT_GASN][:, 0]
    else:
        nbar = mat.get("nbar", 1.0)
    dPrefatm = mat.get("Pref", 0.0) - mat.get("Patm", 0.0)
    if LUB_VAR in fv.val:
        plub = fv.val[LUB_VAR][:, 0]
    else:
        pl = mat.get("lub_pressure", 0.0)
        plub = pl(fv, mat, params) if callable(pl) else \
            torch.full_like(S, float(pl))
    k = phi_p * R ** 2 / 8.0
    Pcap = 2.0 * sigma * torch.cos(theta) / R
    Pgas = P0 * nbar / (1.0 - S) + dPrefatm
    dPdz = (Pgas - plub - Pcap) / (S * H)
    return -(k / mu) * dPdz, phi_p, H


class PorousShellClosed(Equation):
    """SHELL_SAT_CLOSED rows: R_S = phi_i (dS/dt - v_z/(phi_p H))."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(SAT_CLOSED, 1, interp)

    def residual(self, fv, mat, params):
        vz, phi_p, H = closed_cell_vz(fv, mat, params)
        c = (fv.dot[SAT_CLOSED][:, 0] - vz / (phi_p * H))[:, None] \
            * fv.phi[SAT_CLOSED]
        return c[:, None, :]


class LubPorousSink(Equation):
    """The closed-cell absorption as a sink in the lubrication mass
    balance (R_LUBP source, mm_fill_shell.c:11290): R_lub,i += -phi_i v_z.
    Add beside ReynoldsFilm on the same shell block."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(LUB_VAR, 1, interp)

    def residual(self, fv, mat, params):
        vz, _, _ = closed_cell_vz(fv, mat, params)
        return (-vz[:, None] * fv.phi[LUB_VAR])[:, None, :]


def linear_retention(S0=0.0, c=1.0, Smax=1.0):
    """Linear capillary retention S(P) = clip(S0 + c P, 1e-6, Smax)."""

    def S_of_P(P):
        return torch.clamp(S0 + c * P, 1e-6, Smax)

    return S_of_P


def van_genuchten_retention(alpha, n, S_res=0.0, S_sat=1.0):
    """Van Genuchten S(P) on the capillary suction Pc = -P (P < 0
    unsaturated): Se = (1 + (alpha Pc)^n)^(-m), m = 1 - 1/n."""
    m = 1.0 - 1.0 / n

    def S_of_P(P):
        pc = _floor(-P, 0.0)
        Se = (1.0 + (alpha * pc) ** n) ** (-m)
        return S_res + (S_sat - S_res) * Se

    return S_of_P


class PorousShellOpen(Equation):
    """SHELL_PRESS_OPEN rows (mm_fill_shell.c:11945): open-cell pore
    pressure with in-plane Darcy flow and the lubrication exchange,

      R_P,i = phi_i d/dt(H phi_p S(P)) + H k k_rel(S) (grad P - grav) .
              grad(phi_i) + phi_i (kappa/mu) (P - P_eff) / (2 S H)

    Material keys: porosity, permeability, krel (callable of S; default
    1), retention (callable S(P); default linear), gap (the layer height
    H), mu, kappa_cross (default 0), p_eff, grav (dim,)."""

    def __init__(self, interp: str = "Q1", transient: bool = True):
        super().__init__(P_OPEN, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        H = _height(mat, fv, params)
        phi_p = mat.get("porosity", 0.5)
        kperm = mat["permeability"]
        mu = prop(mat, "mu", fv, params, 1.0)
        S_of_P = mat.get("retention", linear_retention())
        krel = mat.get("krel", None)
        P = fv.val[P_OPEN][:, 0]
        pg = fv.grad[P_OPEN][:, 0, :]
        phi = fv.phi[P_OPEN]
        S = S_of_P(P)
        kr = krel(S) if krel is not None else torch.ones_like(S)
        grav = mat.get("grav", None)
        if grav is not None:
            pg = pg - torch.as_tensor(grav, dtype=P.dtype, device=P.device)[None, :]
        mob = H * (kperm / mu) * kr
        c = torch.einsum("q,qk,qik->qi", mob, pg, fv.gphi[P_OPEN])
        kx = mat.get("kappa_cross", 0.0)
        if kx:
            peff = mat.get("p_eff", 0.0)
            pe = peff(fv, mat, params) if callable(peff) else peff
            c = c + ((kx / mu) * (P - pe) / (2.0 * _floor(S, 1e-4) * H))[:, None] * phi
        if self.transient:
            # d/dt (H phi_p S(P)) = H phi_p S'(P) dP/dt
            dS = vmap(grad(S_of_P))(P)
            c = c + (H * phi_p * dS * fv.dot[P_OPEN][:, 0])[:, None] * phi
        return c[:, None, :]


class PorousShellGasN(Equation):
    """SHELL_SAT_GASN rows (``assemble_porous_shell_gasn``,
    ``src/mm_fill_shell.c:11650``): the trapped-gas inventory n of a
    closed-cell porous shell dissolving into the liquid by Henry's law,

        R_n,i = phi_i (dn/dt - flux),
        flux  = -Z/S (n/(1-S) - Patm/P0),   Z = RT D / (H^2 kH)

    with the reference's first-order Taylor extension outside S in
    [dS, 1-dS] (dS = 1e-2). Material keys: P0, Patm, henry, RT,
    gas_diffusivity, pore_height."""

    DS_CLAMP = 1e-2

    def __init__(self, interp: str = "Q1"):
        super().__init__(SAT_GASN, 1, interp)

    def residual(self, fv, mat, params):
        n = fv.val[SAT_GASN][:, 0]
        S = fv.val[SAT_CLOSED][:, 0]
        H = mat.get("pore_height", 1.0)
        P0 = mat.get("P0", 1.0)
        Patm = mat.get("Patm", 1.0)
        kH = mat.get("henry", 1.0)
        RT = mat.get("RT", 1.0)
        D = mat.get("gas_diffusivity", 1.0)
        Z = RT * D / (H * H * kH)
        Pbr = Patm / P0
        dS = self.DS_CLAMP

        def f(s):
            return -Z / s * (n / (1.0 - s) - Pbr)

        si = torch.clamp(S, dS, 1.0 - dS)
        fi = f(si)
        # d(fi)/dS at si (the reference's hand-coded fi_S)
        fi_S = Z / si ** 2 * (n / (1.0 - si) - Pbr) \
            - Z / si * n / (1.0 - si) ** 2
        inside = (S >= dS) & (S <= 1.0 - dS)
        flux = torch.where(inside, f(torch.where(inside, S, si)),
                           fi + (S - si) * fi_S)
        c = (fv.dot[SAT_GASN][:, 0] - flux)[:, None] * fv.phi[SAT_GASN]
        return c[:, None, :]


class PorousShellStackLayer(Equation):
    """One layer of the stacked-saturation family SHELL_SAT_1/2/3
    (assemble_porous_shell_saturation, mm_fill_shell.c:13197): Richards in
    saturation form on layer l with capillary-pressure-difference exchange
    to the adjacent layers,

      R_l,i = phi_i H_l phi_l dS_l/dt + H_l D_l(S_l) grad S_l . grad phi_i
              + phi_i sum_adj G (Pc_a(S_a) - Pc_l(S_l))

    Material keys (suffix _1/_2/_3 per layer): gap_l, porosity_l,
    diffusivity_l (callable of S or constant), pcap_l (callable Pc(S)),
    exchange_G (shared)."""

    def __init__(self, layer: int, n_layers: int, interp: str = "Q1",
                 transient: bool = True):
        super().__init__(f"shell_sat_{layer + 1}", 1, interp)
        self.layer = layer
        self.n_layers = n_layers
        self.transient = transient

    def residual(self, fv, mat, params):
        lv = self.layer + 1
        var = f"shell_sat_{lv}"
        H = mat.get(f"gap_{lv}", 1.0)
        phi_p = mat.get(f"porosity_{lv}", 0.5)
        D = mat.get(f"diffusivity_{lv}", 1.0)
        S = fv.val[var][:, 0]
        gS = fv.grad[var][:, 0, :]
        phi = fv.phi[var]
        Dv = D(S) if callable(D) else torch.full_like(S, float(D))
        c = torch.einsum("q,qk,qik->qi", H * Dv, gS, fv.gphi[var])
        G = mat.get("exchange_G", 0.0)
        if G:
            pc_l = mat.get(f"pcap_{lv}", lambda s: -s)
            for a in (self.layer - 1, self.layer + 1):
                if 0 <= a < self.n_layers:
                    Sa = fv.val[f"shell_sat_{a + 1}"][:, 0]
                    pc_a = mat.get(f"pcap_{a + 1}", lambda s: -s)
                    # outflow toward the layer of higher capillary suction
                    c = c + (G * (pc_a(Sa) - pc_l(S)))[:, None] * phi
        if self.transient:
            c = c + (H * phi_p * fv.dot[var][:, 0])[:, None] * phi
        return c[:, None, :]
