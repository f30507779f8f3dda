"""Free-surface thin-film (shell) flow, film particles and shell energy
(counterpart of ``goma_tpu/physics/shell_film.py``).

Parity targets (the reference's behavior, re-derived for the AD assembly):

- ``assemble_film`` (``src/mm_fill_shell.c:8491``), SHELL_FILMP /
  SHELL_FILMH:

    R_P,i = phi_i dH/dt - q . grad(phi_i) + phi_i (EvapRate + flux_src)
    R_H,i = -sigma grad(H) . grad(phi_i) + phi_i P

  with the Reynolds flux q = -(H^3/(3 mu)) pg - beta_slip H^2 pg and
  pg = grad(P) - grad(Pi(H)) - grav (``calculate_lub_q_v``,
  ``src/mm_shell_util.c:4738-5110``);
- the disjoining pressure models ONE_TERM / TWO_TERM and the CONC_POWER
  evaporation (``src/mm_std_models_shell.c:1038-1300``);
- ``assemble_film_particles`` (``src/mm_fill_shell.c:10188``):
    R_C,i = phi_i H dC/dt + (q . grad C) phi_i + D H grad C . grad phi_i
            - phi_i C EvapRate
- ``assemble_shell_energy`` (``src/mm_fill_shell.c:7133``):
    R_T,i = rho Cp (H dT/dt + q . grad T) w_i + H k grad T . grad phi_i
            + phi_i ht (T - T_amb)
- ``assemble_shell_species`` (``src/mm_fill_shell.c:8095``).

The disjoining pressure's Pi'(H) is ``vmap(grad(...))`` of the model, a
``torch.func`` transform that nests inside the assembler's ``jacfwd``.
"""

from __future__ import annotations

import torch
from torch.func import grad, vmap

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.materials import _floor, as_field, prop

FILMP = "film_pressure"  # SHELL_FILMP
FILMH = "film_height"    # SHELL_FILMH
PARTC = "film_conc"      # SHELL_PARTC
SH_TEMP = "shell_temperature"  # SHELL_TEMPERATURE
SH_CONC = "shell_species"  # shell R_MASS rows


# ----------------------------------------------------- disjoining pressure
def disjoining_two_term(angle_deg, nexp, mexp, h_star, factor=1.0,
                        sigma_key="sigma"):
    """TWO_TERM disjoining pressure Pi(H) (mm_std_models_shell.c:1203): an
    attractive/repulsive power-law pair calibrated to an equilibrium
    contact angle. Returns a callable Pi(H, mat)."""

    def pi_of_h(H, mat):
        sigma = mat.get(sigma_key, mat.get("sigma", 1.0))
        cosA = torch.cos(torch.deg2rad(torch.as_tensor(
            angle_deg, dtype=H.dtype, device=H.device)))
        B = (sigma / h_star) * (nexp - 1.0) * (mexp - 1.0) * (1.0 - cosA) \
            / (factor * (nexp - 1.0) - (mexp - 1.0))
        r = h_star / _floor(H, 1e-12)
        return B * (r ** nexp - factor * r ** mexp)

    return pi_of_h


def disjoining_one_term(B, nexp, h_star):
    """ONE_TERM model Pi(H) = B (H*/H)^n (mm_std_models_shell.c:1261)."""

    def pi_of_h(H, mat):
        return B * (h_star / _floor(H, 1e-12)) ** nexp

    return pi_of_h


def conc_power_evap(E0, nexp, CMax):
    """CONC_POWER film evaporation (mm_std_models_shell.c:1060): solvent
    evaporation shutting off as the particle concentration approaches
    maximum packing, E = E0 (1 - C/CMax)^n for 0 < C < 0.95 CMax, E0 for
    C <= 0, else 0. Returns a callable E(fv, mat, params) reading
    film_conc."""

    def evap(fv, mat, params):
        if PARTC in fv.val:
            C = fv.val[PARTC][:, 0]
        else:
            C = torch.zeros_like(fv.x[:, 0])
        live = (C > 0.0) & (C < 0.95 * CMax)
        base = E0 * _floor(1.0 - C / CMax, 0.0) ** nexp
        return torch.where(live, base, torch.where(
            C <= 0.0, torch.full_like(C, E0), torch.zeros_like(C)))

    return evap


def _film_q(fv, mat, params):
    """The Reynolds film flux q (free surface, one wall): the Newtonian
    flow-rate branch of calculate_lub_q_v for R_SHELL_FILMP
    (mm_shell_util.c:4960-5110, k_turb = 3). Returns (q, H)."""
    H = fv.val[FILMH][:, 0]
    pg = fv.grad[FILMP][:, 0, :]
    mu = prop(mat, "mu", fv, params, 1.0)
    pi_fn = mat.get("disjoining", None)
    if pi_fn is not None:
        # grad(Pi(H)) = Pi'(H) grad(H)
        dpi = vmap(grad(lambda h: pi_fn(h, mat)))(H)
        pg = pg - dpi[:, None] * fv.grad[FILMH][:, 0, :]
    grav = mat.get("film_gravity", None)
    if grav is not None:
        pg = pg - torch.as_tensor(grav, dtype=H.dtype, device=H.device)[None, :]
    mu_q = mu if torch.is_tensor(mu) and mu.ndim else mu * torch.ones_like(H)
    q = -(H ** 3 / (3.0 * mu_q))[:, None] * pg
    beta = mat.get("beta_slip", 0.0)
    if beta:
        q = q - beta * (H ** 2)[:, None] * pg
    return q, H


def _rate(mat, key, fv, params, like):
    """A material rate (a callable, or a constant broadcast like ``like``)."""
    ev = mat.get(key, 0.0)
    return ev(fv, mat, params) if callable(ev) else torch.full_like(like, float(ev))


class FilmPressure(Equation):
    """SHELL_FILMP rows: film mass conservation (mm_fill_shell.c:8860).
    Material keys: mu, disjoining (callable Pi(H, mat), optional),
    film_gravity (dim,), beta_slip, evap (callable or constant),
    lub_source (callable, an extra flux)."""

    def __init__(self, interp: str = "Q1", transient: bool = True):
        super().__init__(FILMP, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        q, H = _film_q(fv, mat, params)
        phi = fv.phi[FILMP]
        c = -torch.einsum("qk,qik->qi", q, fv.gphi[FILMP])
        E = _rate(mat, "evap", fv, params, H)
        src = mat.get("lub_source", None)
        if src is not None:
            E = E + src(fv, mat, params)
        c = c + E[:, None] * phi
        if self.transient:
            c = c + fv.dot[FILMH][:, 0][:, None] * phi
        return c[:, None, :]


class FilmHeight(Equation):
    """SHELL_FILMH rows: the weak capillary pressure P = -sigma lap(H)
    (mm_fill_shell.c:8905). Material key: sigma."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(FILMH, 1, interp)

    def residual(self, fv, mat, params):
        sigma = prop(mat, "sigma", fv, params, 1.0)
        gH = fv.grad[FILMH][:, 0, :]
        P = fv.val[FILMP][:, 0]
        c = -sigma * torch.einsum("qk,qik->qi", gH, fv.gphi[FILMH]) \
            + P[:, None] * fv.phi[FILMH]
        return c[:, None, :]


class FilmParticles(Equation):
    """SHELL_PARTC rows: particle transport in the evaporating film
    (mm_fill_shell.c:10188). Material keys: D_partc, evap (shared with
    FilmPressure)."""

    def __init__(self, interp: str = "Q1", transient: bool = True):
        super().__init__(PARTC, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        q, H = _film_q(fv, mat, params)
        C = fv.val[PARTC][:, 0]
        gC = fv.grad[PARTC][:, 0, :]
        phi = fv.phi[PARTC]
        c = torch.einsum("qk,qk->q", q, gC)[:, None] * phi
        D = mat.get("D_partc", 0.0)
        if D:
            c = c + D * torch.einsum("q,qk,qik->qi", H, gC, fv.gphi[PARTC])
        E = _rate(mat, "evap", fv, params, H)
        c = c - (C * E)[:, None] * phi
        if self.transient:
            c = c + (H * fv.dot[PARTC][:, 0])[:, None] * phi
        return c[:, None, :]


def _height(mat, fv, params):
    """The film thickness H: ``mat["gap"]`` (callable or constant, default
    1)."""
    hfun = mat.get("gap", 1.0)
    return hfun(fv, mat, params) if callable(hfun) else \
        torch.full_like(fv.x[:, 0], float(hfun))


class ShellEnergy(Equation):
    """SHELL_TEMPERATURE rows: thermal energy in a lubrication film
    (mm_fill_shell.c:7133). Material keys: rho, Cp, k, gap (the film
    thickness H), lub_flux (callable q(fv, mat, params) -> (nq, dim),
    default 0: a conduction fin), ht_coeff / ht_tamb (ambient heat loss).
    ``supg`` weights the advective and transient terms with
    phi + tau v . grad(phi), v = q / H."""

    def __init__(self, interp: str = "Q1", transient: bool = False,
                 supg: float = 0.0):
        super().__init__(SH_TEMP, 1, interp)
        self.transient = transient
        self.supg = supg

    def residual(self, fv, mat, params):
        rho = prop(mat, "rho", fv, params, 1.0)
        Cp = prop(mat, "Cp", fv, params, 1.0)
        k = prop(mat, "k", fv, params, 1.0)
        H = _height(mat, fv, params)
        T = fv.val[SH_TEMP][:, 0]
        gT = fv.grad[SH_TEMP][:, 0, :]
        phi = fv.phi[SH_TEMP]
        gphi = fv.gphi[SH_TEMP]
        qf = mat.get("lub_flux", None)
        wt = phi
        if qf is not None:
            q = qf(fv, mat, params)  # volumetric film flux (nq, dim)
            if self.supg > 0:
                v = q / _floor(H, 1e-30)[:, None]
                v2 = torch.sum(v * v, dim=1)
                tau = self.supg * fv.h_elem / (2.0 * torch.sqrt(v2 + 1e-30))
                wt = phi + tau[:, None] * torch.einsum("qk,qik->qi", v, gphi)
            adv = torch.einsum("qk,qk->q", q, gT)
            c = (rho * Cp * adv)[:, None] * wt
        else:
            c = torch.zeros_like(phi)
        c = c + torch.einsum("q,qk,qik->qi", H * k, gT, gphi)
        ht = mat.get("ht_coeff", 0.0)
        if ht:
            c = c + (ht * (T - mat.get("ht_tamb", 0.0)))[:, None] * phi
        if self.transient:
            c = c + (rho * Cp * H * fv.dot[SH_TEMP][:, 0])[:, None] * wt
        return c[:, None, :]


class ShellSpecies(Equation):
    """Scalar species transport in a lubrication gap, gap-integrated with
    the concentration constant across the shell
    (``assemble_shell_species``, ``src/mm_fill_shell.c:8095``):

        R_c,i = H dc/dt phi_i + (q . grad c) phi_i
                + H D grad(c) . grad(phi_i) - s phi_i

    Material keys: ``D_shell`` (per species), ``gap``, ``lub_flux``
    (callable q, default 0), ``shell_species_source`` (constant or
    callable)."""

    def __init__(self, n_species: int = 1, interp: str = "Q1",
                 transient: bool = True):
        super().__init__(SH_CONC, n_species, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        H = _height(mat, fv, params)
        gC = fv.grad[SH_CONC]  # (nq, nw, dim)
        phi = fv.phi[SH_CONC]
        D = as_field(mat.get("D_shell", 1.0), (self.ncomp,), fv.x)
        c = torch.einsum("q,w,qwk,qik->qwi", H, D, gC, fv.gphi[SH_CONC])
        qf = mat.get("lub_flux", None)
        if qf is not None:
            c = c + torch.einsum("qk,qwk,qi->qwi", qf(fv, mat, params), gC, phi)
        s = mat.get("shell_species_source", None)
        if s is not None:
            sv = s(fv, mat, params) if callable(s) else torch.full(
                (nq, self.ncomp), float(s), dtype=fv.x.dtype, device=fv.x.device)
            c = c - torch.einsum("qw,qi->qwi", sv, phi)
        if self.transient:
            c = c + torch.einsum("q,qw,qi->qwi", H, fv.dot[SH_CONC], phi)
        return c
