"""Non-Fickian species flux models (counterpart of
``goma_tpu/physics/species_flux.py``): Stefan-Maxwell multicomponent
diffusion, generalized Fickian (a full diffusivity matrix), the
HYDRODYNAMIC shear-induced-migration suspension flux, and the species
boundary fluxes that go with them (KOH etching, the charged-Fickian
gradient pin, the suspension flux).

Parity: reference ``src/mm_fill_species.c`` mass-flux dispatch
(``get_continuous_species_terms:9117-9134``): ``Stefan_Maxwell_diff_flux``
(``:10439``), GENERALIZED_FICKIAN, and ``hydro_flux``
(``src/mm_std_models.c:3478``, the Phillips diffusive-flux model).

- Stefan-Maxwell solves its (ns x ns) coefficient system per quadrature
  point with a batched ``torch.linalg.solve`` (goma_tpu maps a dense
  solve over the points; the reference LU-factors each point).
- ``hydro_flux`` takes grad(shear rate) from a projected nodal field, as
  the reference takes fv->SH from its SHEAR_RATE equation; dmu/dY is
  ``torch.func.grad`` of the relative-viscosity closure, mapped over the
  points inside the element Jacobian's ``jacfwd``.
- Every Jacobian entry is forward-mode AD of these residuals.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.physics.electro import on_comp
from goma_tpu_torch.physics.fluid import advective_velocity
from goma_tpu_torch.physics.materials import _floor, as_field, prop


def _transport(eq, fv, gc, nq, ncomp):
    """phi (cdot + u.grad c) rows' coefficient (nq, ncomp) of a species
    equation with ``transient``/``convection`` flags."""
    adv = fv.x.new_zeros((nq, ncomp))
    if eq.transient:
        adv = adv + fv.dot["species"]
    if eq.convection and "velocity" in fv.val:
        adv = adv + torch.einsum("qk,qwk->qw", advective_velocity(fv), gc)
    return adv


def _source(fv, mat, params, nq, ncomp):
    S = mat.get("species_source", None)
    if S is None:
        return None
    return S(fv, mat, params) if callable(S) else as_field(S, (nq, ncomp),
                                                           fv.x)


class StefanMaxwellSpecies(Equation):
    """Multicomponent Stefan-Maxwell transport of ns-1 mole fractions (the
    last species eliminated by sum(x) = 1; reference n_species =
    Num_Species_Eqn + 1, src/mm_fill_species.c:10495).

    Per spatial direction the molar fluxes J solve A J = -grad x with
    A_ii = sum_{j!=i} x_j/(c D_ij), A_ij = -x_i/(c D_ij), the last row
    replaced by the closure sum_j J_j = 0. Weak form phi (xdot + u.grad x)
    - grad(phi) . J / c.
    """

    def __init__(self, n_species: int, D, c_total: float = 1.0,
                 interp: str = "Q1", transient: bool = True,
                 convection: bool = True):
        # n_species counts the solved components (= Num_Species_Eqn)
        super().__init__("species", n_species, interp)
        self.ns = n_species + 1
        D = np.asarray(D, dtype=np.float64)
        assert D.shape == (self.ns, self.ns), \
            "D must be (ns+1, ns+1) SM diffusivities"
        self.D = D
        self.c_total = c_total
        self.transient = transient
        self.convection = convection

    def _fluxes(self, x_full, gx_full):
        """x_full (nq, ns), gx_full (nq, ns, dim) -> molar fluxes (nq, ns,
        dim)."""
        ns = self.ns
        eye = np.eye(ns, dtype=bool)
        with np.errstate(divide="ignore"):
            invD = np.where(eye, 0.0, 1.0 / (self.c_total * self.D))
        invD = torch.as_tensor(invD, dtype=x_full.dtype, device=x_full.device)
        # A[q] = -x_i invD_ij + diag(sum_j invD_ij x_j - (-x_i invD_ii))
        A = -x_full[:, :, None] * invD[None]
        diag = torch.sum(invD[None] * x_full[:, None, :], dim=2) \
            - torch.diagonal(A, dim1=1, dim2=2)
        A = A + torch.diag_embed(diag)
        ones = torch.ones_like(x_full[:, None, :])
        A = torch.cat([A[:, :ns - 1, :], ones], dim=1)
        B = torch.cat([-gx_full[:, :ns - 1, :],
                       torch.zeros_like(gx_full[:, :1, :])], dim=1)
        return torch.linalg.solve(A, B)

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        nsv = self.ncomp
        x = fv.val["species"]  # (nq, nsv) solved mole fractions
        gx = fv.grad["species"]  # (nq, nsv, dim)
        x_full = torch.cat([x, 1.0 - torch.sum(x, dim=1, keepdim=True)], dim=1)
        gx_full = torch.cat([gx, -torch.sum(gx, dim=1, keepdim=True)], dim=1)
        J = self._fluxes(x_full, gx_full)  # (nq, ns, dim)

        adv = _transport(self, fv, gx, nq, nsv)
        phi = fv.phi["species"]
        contrib = torch.einsum("qw,qi->qwi", adv, phi)
        contrib = contrib - torch.einsum("qwk,qik->qwi",
                                         J[:, :nsv] / self.c_total,
                                         fv.gphi["species"])
        S = _source(fv, mat, params, nq, nsv)
        if S is not None:
            contrib = contrib - torch.einsum("qw,qi->qwi", S, phi)
        return contrib


class GeneralizedFickianSpecies(Equation):
    """Full diffusivity-matrix Fickian transport, J_w = -sum_v D_wv grad
    c_v (GENERALIZED_FICKIAN); ``D`` (ns, ns), possibly non-symmetric."""

    def __init__(self, n_species: int, D, interp: str = "Q1",
                 transient: bool = True, convection: bool = True):
        super().__init__("species", n_species, interp)
        self.n_species = n_species
        D = np.asarray(D)
        assert D.shape == (n_species, n_species)
        self.D = D
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        gc = fv.grad["species"]  # (nq, ns, dim)
        adv = _transport(self, fv, gc, nq, self.n_species)
        D = torch.as_tensor(self.D, dtype=gc.dtype, device=gc.device)
        J = -torch.einsum("wv,qvk->qwk", D, gc)
        phi = fv.phi["species"]
        contrib = torch.einsum("qw,qi->qwi", adv, phi)
        contrib = contrib - torch.einsum("qwk,qik->qwi", J, fv.gphi["species"])
        S = _source(fv, mat, params, nq, self.n_species)
        if S is not None:
            contrib = contrib - torch.einsum("qw,qi->qwi", S, phi)
        return contrib


class HydroSpecies(Equation):
    """Shear-induced particle migration, the Phillips diffusive-flux model
    (HYDRODYNAMIC, ``hydro_flux``, src/mm_std_models.c:3478):

        N = - Kc a^2 (Y^2 grad(gd) + Y gd grad Y)          (collision)
            - Kmu a^2 gd Y^2 (1/mu) (dmu/dY) grad Y        (viscosity)
            + Dg a^2 Y f(Y) (rho_p - rho_f) g / mu0        (settling)

    gd from the projected nodal field ``gd_var``; f(Y) = mu0/mu, mu(Y) =
    mu0 (1 - Y/maxpack)^nexp (floored as the reference's rel_mu_denom
    clamp). Weak form phi (Ydot + u.grad Y) - grad(phi) . N.
    """

    def __init__(self, Kc: float, Kmu: float, a_rad: float = 1.0,
                 mu0: float = 1.0, maxpack: float = 0.68, nexp: float = -1.82,
                 settling=None, gd_var: str = "shear_rate",
                 interp: str = "Q1", transient: bool = True,
                 convection: bool = True, floor: float = 1e-2):
        super().__init__("species", 1, interp)
        self.Kc, self.Kmu, self.a2 = Kc, Kmu, a_rad * a_rad
        self.mu0, self.maxpack, self.nexp = mu0, maxpack, nexp
        # settling: None or (Dg, del_rho, gravity vector)
        self.settling = settling
        self.gd_var = gd_var
        self.transient = transient
        self.convection = convection
        self.floor = floor

    def _rel_visc(self, Y):
        """Krieger-Dougherty relative viscosity, floored like the
        reference's rel_mu_denom <= 0 -> 0.01 clamp
        (src/mm_std_models.c:3612)."""
        return _floor(1.0 - Y / self.maxpack, self.floor) ** self.nexp

    def particle_flux(self, fv, mat, params):
        """The Phillips particle flux N (nq, dim) at an element's or a
        face's field state (shared with :class:`SuspensionFlux`)."""
        from torch.func import grad, vmap

        Y = fv.val["species"][:, 0]
        gY = fv.grad["species"][:, 0, :]
        gd = fv.val[self.gd_var][:, 0]
        ggd = fv.grad[self.gd_var][:, 0, :]

        mu_rel = self._rel_visc(Y)
        # (1/mu) dmu/dY does not depend on mu0
        dlnmu_dY = vmap(grad(self._rel_visc))(Y) / mu_rel

        N = -self.Kc * self.a2 * ((Y * Y)[:, None] * ggd
                                  + (Y * gd)[:, None] * gY)
        N = N - self.Kmu * self.a2 * (gd * Y * Y * dlnmu_dY)[:, None] * gY
        if self.settling is not None:
            Dg, del_rho, grav = self.settling
            grav = torch.as_tensor(np.asarray(grav, dtype=np.float64),
                                   dtype=Y.dtype, device=Y.device)
            hindrance = mu_rel ** (-1.0)
            N = N + (Dg * self.a2 * del_rho / self.mu0) * (
                Y * hindrance)[:, None] * grav[None, :]
        return N

    def residual(self, fv, mat, params):
        return self.weak_form(fv, self.particle_flux(fv, mat, params))

    def weak_form(self, fv, N):
        """phi (Ydot + u.grad Y) - grad(phi) . N, (nq, 1, nbf), for a
        particle flux N (nq, dim)."""
        nq = fv.x.shape[0]
        gY = fv.grad["species"][:, 0, :]
        adv = fv.x.new_zeros(nq)
        if self.transient:
            adv = adv + fv.dot["species"][:, 0]
        if self.convection and "velocity" in fv.val:
            adv = adv + torch.einsum("qk,qk->q", advective_velocity(fv), gY)
        contrib = adv[:, None] * fv.phi["species"]
        contrib = contrib - torch.einsum("qk,qik->qi", N, fv.gphi["species"])
        return contrib[:, None, :]


def koh_si_etch_rate_100(rho_H2O, rho_KOH, T):
    """Seidel et al. KOH/Si(100) wet-etch kinetics
    (``src/mm_std_models.c:6584 calc_KOH_Si_etch_rate_100``), as the
    reference writes it: rate = H(rho_KOH) k0 C_H2O^4 C_KOH^0.25
    exp(-Ea/kB T), smooth-gated over rho_KOH in [1e-6, 1e-4] g/cm^3, in
    cm/s."""
    k_B, E_a, k0 = 8.6173305e-5, 0.595, 2480.0
    MW_H2O, MW_KOH = 18.01528, 56.1056
    C_H2O = rho_H2O * 1000.0 / MW_H2O
    C_KOH = _floor(rho_KOH, 1e-30) * 1000.0 / MW_KOH
    lo, hi = 1.0e-6, 1.0e-4
    alpha = 0.5 * (hi - lo)
    z = (rho_KOH - (hi - alpha)) / alpha
    one = torch.ones_like(rho_KOH)
    H = torch.where(rho_KOH >= hi, one,
                    torch.where(rho_KOH <= lo, torch.zeros_like(one),
                                0.5 * (1.0 + z + torch.sin(math.pi * z)
                                       / math.pi)))
    rate = H * k0 * C_H2O**4 * C_KOH**0.25 * math.exp(-E_a / (k_B * T))
    return rate / 1.0e4 / 3600.0


class KOHSiEtchFlux(FaceKernel):
    """YFLUX_ETCH (``src/mm_fill_species.c:4115 mass_flux_surf_etch``): KOH
    wet-etching species fluxes on a Si(100) surface, the reference's
    species order (0 H2O, 1 KOH/OH-, 2 H2, 3 silicon hydroxyl byproducts)
    and stoichiometry q_w = STOICH_w (rho_Si/MW_Si) MW_w R. ``T`` the
    process temperature (K)."""

    RHO_SI, MW_SI = 2.3290, 28.0855
    MWS = (18.01528, 17.008, 2.0 * 1.00794,
           28.0855 + 2.0 * 15.9994 + 2.0 * 17.008)
    STOICH = (2.0, 2.0, -2.0, -1.0)

    def __init__(self, comp: int, T: float, var: str = "species",
                 ncomp: int = 4):
        super().__init__(var, ncomp)
        self.comp = comp
        self.T = T

    def residual(self, sfv, mat, params):
        c = sfv.val[self.var]
        R = koh_si_etch_rate_100(c[:, 0], c[:, 1], self.T)
        q = self.STOICH[self.comp] * self.RHO_SI / self.MW_SI \
            * self.MWS[self.comp] * R
        return on_comp(q[:, None] * sfv.phi[self.var], self.comp, self.ncomp)


class ChargedSurfaceGradient(FaceKernel):
    """FICK_CHRGD_SURF_GRAD (``src/mm_fill_species.c:12579
    fickian_charged_gradient_bc``): pin the normal charged-Fickian flux,
    n . (-D grad c - D z c (F/(R T)) grad V) = value, as a penalty on the
    species rows. Material key ``diffusivity``."""

    F = 96487.0
    GAS_R = 8.314

    def __init__(self, value: float, z: float, T: float = 298.15,
                 comp: int = 0, var: str = "species", ncomp: int = 1,
                 penalty: float = 1e4, pot_var: str = "voltage"):
        super().__init__(var, ncomp)
        self.value, self.z, self.T = value, z, T
        self.comp = comp
        self.penalty = penalty
        self.pot_var = pot_var

    def residual(self, sfv, mat, params):
        D = prop(mat, "diffusivity", sfv, params, 1.0)
        gc = sfv.grad[self.var][:, self.comp, :]
        c = sfv.val[self.var][:, self.comp]
        n = sfv.normal
        flux = -D * torch.einsum("qk,qk->q", gc, n)
        if self.pot_var in sfv.val:
            gV = sfv.grad[self.pot_var][:, 0, :]
            flux = flux - D * self.z * c * self.F / (self.GAS_R * self.T) \
                * torch.einsum("qk,qk->q", gV, n)
        s = flux - self.value
        return on_comp(self.penalty * s[:, None] * sfv.phi[self.var],
                       self.comp, self.ncomp)


class SuspensionFlux(FaceKernel):
    """YFLUX_SUS (``src/mm_fill_species.c:6706 sus_mass_flux_surf_bc``):
    the weak suspension particle flux q_n = rho n . N_hydro on the species
    rows, N_hydro :meth:`HydroSpecies.particle_flux` (one closure for the
    condition and the volume transport). Needs the shear-rate field
    ``hydro.gd_var`` on the face's block (solved or a ``PassiveVar``)."""

    def __init__(self, hydro: HydroSpecies, rho: float = 1.0,
                 var: str = "species", ncomp: int = 1, comp: int = 0):
        super().__init__(var, ncomp)
        self.hydro = hydro
        self.rho = rho
        self.comp = comp

    def residual(self, sfv, mat, params):
        N = self.hydro.particle_flux(sfv, mat, params)
        qn = self.rho * torch.einsum("qk,qk->q", N, sfv.normal)
        # outward particle flux: + sign
        return on_comp(qn[:, None] * sfv.phi[self.var], self.comp, self.ncomp)
