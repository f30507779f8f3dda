"""Energy, species and the other scalar transport equations (counterpart
of ``goma_tpu/physics/scalar_transport.py``).

Parity: ``src/mm_fill_energy.c:107 assemble_energy`` and
``src/mm_fill_species.c:191 assemble_mass_transport`` (Fickian flux, with
the FICKIAN_CHARGED electromigration term when the material has a
``charge`` and the block a ``voltage``). Weak forms:

  energy:  int phi rho Cp (Tdot + u.grad T) + grad phi . (k grad T) - phi H
  species: int phi (cdot_w + u.grad c_w) + grad phi . (D_w grad c_w
           + z_w u_w F c_w grad V) - phi S_w

and the auxiliary transport fields: the residence time (RESTIME), the
Beer-Lambert light intensities (LIGHTP/LIGHTM/LIGHTD), the thixotropic
bond structure (R_BOND_EVOLUTION), the projected shear rate (R_SHEAR_RATE)
and the Fresnel light jump at a refractive-index interface (an interface
kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import Equation, InterfaceKernel
from goma_tpu_torch.physics.fluid import _as_nq, advective_velocity
from goma_tpu_torch.physics.materials import _floor, as_field, prop, shear_rate


class Energy(Equation):
    def __init__(self, interp: str = "Q2", transient: bool = True,
                 convection: bool = True):
        super().__init__("temperature", 1, interp)
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        x = fv.x
        nq = x.shape[0]
        gT = fv.grad["temperature"][:, 0, :]  # (nq, dim)
        rho = _as_nq(prop(mat, "rho", fv, params, 1.0), nq, x)
        Cp = _as_nq(prop(mat, "Cp", fv, params, 1.0), nq, x)
        k = _as_nq(prop(mat, "k", fv, params, 1.0), nq, x)

        adv = torch.zeros(nq, dtype=x.dtype, device=x.device)
        if self.transient:
            adv = adv + fv.dot["temperature"][:, 0]
        if self.convection and "velocity" in fv.val:
            adv = adv + torch.einsum("qk,qk->q", advective_velocity(fv), gT)
        phi = fv.phi["temperature"]
        contrib = torch.einsum("q,qi->qi", rho * Cp * adv, phi)
        contrib = contrib + torch.einsum("q,qk,qik->qi", k, gT,
                                         fv.gphi["temperature"])
        H = mat.get("heat_source", None)
        if H is not None:
            Hval = _as_nq(H(fv, mat, params) if callable(H) else H, nq, x)
            contrib = contrib - torch.einsum("q,qi->qi", Hval, phi)
        return contrib[:, None, :]


class Species(Equation):
    """Multicomponent Fickian species transport (n_species components)."""

    def __init__(self, n_species: int, interp: str = "Q2",
                 transient: bool = True, convection: bool = True):
        super().__init__("species", n_species, interp)
        self.n_species = n_species
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        x = fv.x
        nq, ns = x.shape[0], self.n_species
        gc = fv.grad["species"]  # (nq, ns, dim)
        D = prop(mat, "diffusivity", fv, params, 1.0)
        D = torch.as_tensor(D, dtype=x.dtype, device=x.device)
        if D.ndim == 0:
            D = D.expand(ns)
        adv = torch.zeros((nq, ns), dtype=x.dtype, device=x.device)
        if self.transient:
            adv = adv + fv.dot["species"]
        if self.convection and "velocity" in fv.val:
            adv = adv + torch.einsum("qk,qwk->qw", advective_velocity(fv), gc)
        phi = fv.phi["species"]
        contrib = torch.einsum("qw,qi->qwi", adv, phi)
        contrib = contrib + torch.einsum("w,qwk,qik->qwi", D, gc,
                                         fv.gphi["species"])
        # electromigration (FICKIAN_CHARGED): J_w += -z_w u_w F c_w grad V,
        # weakly + z u F c grad V . grad phi. Material keys ``charge`` and
        # ``mobility`` (ns,) [mol s/kg]
        z = mat.get("charge", None)
        if z is not None and "voltage" in fv.val:
            from goma_tpu_torch.physics.electro import FARADAY

            z = as_field(np.asarray(z, dtype=np.float64), (ns,), x)
            um = as_field(np.asarray(mat["mobility"], dtype=np.float64),
                          (ns,), x)
            contrib = contrib + FARADAY * torch.einsum(
                "w,w,qw,qk,qik->qwi", z, um, fv.val["species"],
                fv.grad["voltage"][:, 0, :], fv.gphi["species"])
        S = mat.get("species_source", None)
        if S is not None:
            Sval = S(fv, mat, params) if callable(S) else torch.as_tensor(
                S, dtype=x.dtype, device=x.device).expand(nq, ns)
            contrib = contrib - torch.einsum("qw,qi->qwi", Sval, phi)
        return contrib


class ResidenceTime(Equation):
    """RESTIME (reference ``assemble_poynting`` residence-time branch,
    ``src/mm_fill_terms.c``, R_RESTIME): tau_dot + u . grad(tau) -
    div(D grad tau) = 1, so tau gains 1 per unit time along pathlines.
    SUPG-stabilized for the advection-dominated (D -> 0) limit."""

    def __init__(self, interp: str = "Q1", D: float = 0.0,
                 supg: float = 0.5, transient: bool = False):
        super().__init__("restime", 1, interp)
        self.D = D
        self.supg = supg
        self.transient = transient

    def residual(self, fv, mat, params):
        g = fv.grad["restime"][:, 0, :]
        u = advective_velocity(fv)
        r = torch.einsum("qk,qk->q", u, g) - 1.0
        if self.transient:
            r = r + fv.dot["restime"][:, 0]
        phi = fv.phi["restime"]
        gphi = fv.gphi["restime"]
        w = phi
        if self.supg > 0:
            u2 = torch.sum(u * u, dim=1)
            tau = self.supg * fv.h_elem * torch.sqrt(u2 + 1e-30) / (
                2.0 * u2 + 1e-12)
            w = phi + tau[:, None] * torch.einsum("qk,qik->qi", u, gphi)
        contrib = r[:, None] * w
        if self.D:
            contrib = contrib + self.D * torch.einsum("qk,qik->qi", g, gphi)
        return contrib[:, None, :]


class LightIntensity(Equation):
    """LIGHTP / LIGHTM / LIGHTD (reference ``assemble_poynting`` light
    branches, R_LIGHT_INTP/INTM/INTD): Beer-Lambert absorption s . grad(I)
    + beta I = 0 along the propagation direction s, SUPG-stabilized; the
    exact 1D solution is I0 exp(-beta s.x)."""

    def __init__(self, direction, beta: float, var: str = "light_intp",
                 interp: str = "Q1", supg: float = 0.5):
        super().__init__(var, 1, interp)
        d = np.asarray(direction, dtype=float)
        self.direction = d / np.linalg.norm(d)
        self.beta = beta
        self.supg = supg

    def residual(self, fv, mat, params):
        g = fv.grad[self.var][:, 0, :]
        I = fv.val[self.var][:, 0]  # noqa: E741
        s = torch.as_tensor(self.direction, dtype=fv.x.dtype,
                            device=fv.x.device)[: fv.x.shape[1]]
        r = torch.einsum("qk,k->q", g, s) + self.beta * I
        phi = fv.phi[self.var]
        w = phi
        if self.supg > 0:
            tau = self.supg * fv.h_elem / 2.0
            w = phi + tau[:, None] * torch.einsum("qik,k->qi",
                                                  fv.gphi[self.var], s)
        return (r[:, None] * w)[:, None, :]


class BondEvolution(Equation):
    """Thixotropic bond-structure evolution R_BOND_EVOLUTION (reference
    ``assemble_bond_evolution``, ``src/mm_std_models.c:5929``; Mujumdar et
    al. 2002):

        nn_t + u.grad(nn) = -k1 nn gd^a + k2 (n0 - nn) gd^b  (+ D diffusion)

    gd the shear-rate invariant; the homogeneous steady state is nn_eq =
    k2 gd^b n0 / (k1 gd^a + k2 gd^b)."""

    def __init__(self, k1: float, k2: float, n0: float, aexp: float = 1.0,
                 bexp: float = 1.0, diff: float = 0.0,
                 transient: bool = True, interp: str = "Q1",
                 var: str = "bond"):
        super().__init__(var, 1, interp)
        self.k1, self.k2, self.n0 = k1, k2, n0
        self.aexp, self.bexp, self.diff = aexp, bexp, diff
        self.transient = transient

    def residual(self, fv, mat, params):
        nn = fv.val[self.var][:, 0]
        gnn = fv.grad[self.var][:, 0, :]
        gd = shear_rate(fv) + 1e-14  # the reference's DBL_SMALL offset
        nn_pos = _floor(nn, 0.0)  # the reference clips negative structure
        r = self.k1 * nn_pos * gd ** self.aexp \
            - self.k2 * (self.n0 - nn_pos) * gd ** self.bexp
        if self.transient:
            r = r + fv.dot[self.var][:, 0]
        if "velocity" in fv.val:
            r = r + torch.einsum("qk,qk->q", advective_velocity(fv), gnn)
        out = r[:, None] * fv.phi[self.var]
        if self.diff:
            out = out + self.diff * torch.einsum(
                "qk,qik->qi", gnn, fv.gphi[self.var])
        return out[:, None, :]


class ShearRateProjection(Equation):
    """R_SHEAR_RATE (the reference's projected shear-rate variable,
    SHEAR_RATE in ``include/rf_fem_const.h``): gd = sqrt(2 D:D) as a solved
    nodal field, R_i = int phi_i (gd - gammadot(u))."""

    def __init__(self, interp: str = "Q1", var: str = "shear_rate_proj"):
        super().__init__(var, 1, interp)

    def residual(self, fv, mat, params):
        gd = fv.val[self.var][:, 0]
        return ((gd - shear_rate(fv))[:, None] * fv.phi[self.var])[:, None, :]


class LightFresnelJump(InterfaceKernel):
    """LIGHTP_JUMP / LIGHTM_JUMP (``src/mm_ns_bc.c:15932
    qside_light_jump``): the Fresnel intensity jump at a refractive-index
    interface, normal incidence,

        R = ((n - n_o)/(n + n_o))^2,   Y = (n_o/n)^2 (1 - R)
        I_f(downstream) - R I_b(downstream) - Y I_f(upstream) = 0

    as a penalty on side A's (downstream) ``var`` rows. ``other_var`` the
    opposite direction (left out when not registered). Material key
    ``refindex`` on both blocks."""

    def __init__(self, var: str = "light_intp", other_var: str = "light_intm",
                 penalty: float = 1e6):
        super().__init__(var, 1)
        self.other_var = other_var
        self.penalty = penalty

    def residual(self, sa, sb, mat_a, mat_b, params):
        n = mat_a["refindex"]
        no = mat_b["refindex"]
        R = ((n - no) / (n + no)) ** 2
        Y = (no / n) ** 2 * (1.0 - R)
        If_a = sa.val[self.var][:, 0]
        If_b = sb.val[self.var][:, 0]
        Ib_a = sa.val[self.other_var][:, 0] if self.other_var in sa.val \
            else 0.0
        s = If_a - R * Ib_a - Y * If_b
        ca = self.penalty * (s[:, None] * sa.phi[self.var])[:, None, :]
        phib = sb.phi[self.var]
        cb = phib.new_zeros((s.shape[0], 1, phib.shape[1]))
        return ca, cb
