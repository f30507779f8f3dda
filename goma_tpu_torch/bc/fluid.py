"""Named fluid / thermal / species boundary conditions (counterpart of
``goma_tpu/bc/fluid.py``).

Parity: the most-used cards of the reference's fluid-BC file
(``src/mm_ns_bc.c``: VELO_SLIP ``fvelo_slip_bc``, FLOW_PRESSURE /
FLOW_HYDROSTATIC ``fflow_*``, the level-set slip and no-penetration
conditions, the laser and vapor fluxes), the heat-flux family of
``src/bc_integ.c`` (QCONV, QRAD), species mass-transfer fluxes (YFLUX,
``mass_flux_surf_mtc``), and the contact-line endpoint forces of
``src/bc_special.c`` (CAP_ENDFORCE, CA) built on
``Problem.add_point_load``.

Every condition is a thin weak kernel whose Jacobian blocks come from
forward-mode AD of the face (or point) residual, as in goma_tpu.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.physics.electro import on_comp
from goma_tpu_torch.physics.level_set import (heaviside, laser_flux,
                                              vapor_cool)
from goma_tpu_torch.physics.materials import as_field, prop


def _wall_velocity(u_wall, sfv, mat, params, dim):
    """The wall velocity (a constant, an array or a callable) as
    (nq, dim)."""
    uw = u_wall(sfv, mat, params) if callable(u_wall) else u_wall
    return as_field(uw, (sfv.x.shape[0], dim), sfv.x)


def _tangential(du, n):
    """du with its component along n taken out."""
    return du - torch.einsum("qk,qk->q", n, du)[:, None] * n


def _unit_tangent(sfv):
    t = sfv.tangents[:, :, 0]
    return t / torch.linalg.norm(t, dim=1, keepdim=True)


def _relative_velocity(sfv):
    """v - xdot (the mesh velocity under ALE), or 0 x without velocity."""
    v = sfv.val["velocity"] if "velocity" in sfv.val else 0.0 * sfv.x
    if MESH_VAR in sfv.dot:
        v = v - sfv.dot[MESH_VAR]
    return v


class NavierSlip(FaceKernel):
    """VELO_SLIP (``src/mm_ns_bc.c fvelo_slip_bc``): Navier slip law
    t . sigma . n = -(1/beta) (u - u_wall) . t, entering the momentum weak
    form as + int phi (1/beta) (u - u_wall) dG, projected tangentially
    (``tangential_only=True``) or on all components (the raw card)."""

    def __init__(self, dim: int, beta: float, u_wall=0.0,
                 tangential_only: bool = True):
        super().__init__("velocity", dim)
        self.dim = dim
        self.beta = beta
        self.u_wall = u_wall
        self.tangential_only = tangential_only

    def residual(self, sfv, mat, params):
        du = sfv.val["velocity"] - _wall_velocity(self.u_wall, sfv, mat,
                                                  params, self.dim)
        if self.tangential_only:
            du = _tangential(du, sfv.normal)
        phi = sfv.phi["velocity"]
        return (1.0 / self.beta) * torch.einsum("qa,qi->qai", du, phi)


class FlowPressure(FaceKernel):
    """FLOW_PRESSURE / FLOW_HYDROSTATIC (``src/mm_ns_bc.c``): open boundary
    with imposed normal traction sigma.n = -P n, P = p0 + rho g.(x - x0).
    Weak momentum term: + int phi P n dG (the boundary term of the
    divergence-form momentum equation with sigma.n replaced)."""

    def __init__(self, dim: int, p0=0.0, rho: float = 0.0, g=None, x0=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.p0 = p0
        self.rho = rho
        self.g = np.zeros(dim) if g is None else np.asarray(g, dtype=float)
        self.x0 = np.zeros(dim) if x0 is None else np.asarray(x0, dtype=float)

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        p0 = self.p0(sfv, mat, params) if callable(self.p0) else self.p0
        P = as_field(p0, (nq,), sfv.x)
        if self.rho:
            x0 = torch.as_tensor(self.x0, dtype=sfv.x.dtype, device=sfv.x.device)
            g = torch.as_tensor(self.g, dtype=sfv.x.dtype, device=sfv.x.device)
            P = P + self.rho * torch.einsum("qk,k->q", sfv.x - x0, g)
        phi = sfv.phi["velocity"]
        return torch.einsum("q,qa,qi->qai", P, sfv.normal, phi)


class ConvectiveHeatFlux(FaceKernel):
    """QCONV (``src/bc_integ.c``): q_n = h (T - T_inf) out of the domain;
    weak energy term + int phi h (T - T_inf) dG."""

    def __init__(self, h: float, T_inf: float, var: str = "temperature"):
        super().__init__(var, 1)
        self.h = h
        self.T_inf = T_inf

    def residual(self, sfv, mat, params):
        T = sfv.val[self.var][:, 0]
        phi = sfv.phi[self.var]
        return (self.h * (T - self.T_inf))[:, None, None] * phi[:, None, :]


class RadiativeHeatFlux(FaceKernel):
    """QRAD (``src/bc_integ.c``): q_n = h (T - T_s) + eps*sigB*(T^4 - T_s^4)."""

    def __init__(self, h: float, T_s: float, eps: float = 0.0,
                 sigB: float = 5.670374419e-8, var: str = "temperature"):
        super().__init__(var, 1)
        self.h, self.T_s, self.eps, self.sigB = h, T_s, eps, sigB

    def residual(self, sfv, mat, params):
        T = sfv.val[self.var][:, 0]
        q = self.h * (T - self.T_s) + self.eps * self.sigB * (T**4 - self.T_s**4)
        return q[:, None, None] * sfv.phi[self.var][:, None, :]


class MassTransferFlux(FaceKernel):
    """YFLUX with a mass-transfer coefficient (``src/mm_ns_bc.c``
    ``mass_flux_surf_mtc``): q_n = k_mtc (c_i - c_inf) for species
    component ``comp``."""

    def __init__(self, k_mtc: float, c_inf: float, comp: int = 0,
                 var: str = "species", ncomp: int = 1):
        super().__init__(var, ncomp)
        self.k_mtc, self.c_inf, self.comp = k_mtc, c_inf, comp

    def residual(self, sfv, mat, params):
        c = sfv.val[self.var][:, self.comp]
        phi = sfv.phi[self.var]
        return on_comp((self.k_mtc * (c - self.c_inf))[:, None] * phi,
                       self.comp, self.ncomp)


def cap_end_force(direction, sigma):
    """CAP_ENDFORCE (``src/bc_special.c``): surface-tension endpoint force
    sigma * m at a contact-line node, m the unit vector pointing out of the
    free surface along its tangent. Returns an f for
    ``Problem.add_point_load(nodeset, "velocity", f)``; the weak form adds
    -phi . (sigma m) at the node."""
    m = np.asarray(direction, dtype=float)
    m = m / np.linalg.norm(m)

    def f(q, X0, params):
        s = sigma(params) if callable(sigma) else sigma
        return -s * torch.as_tensor(m, dtype=q.dtype, device=q.device)

    return f


def contact_angle_force(wall_tangent, wall_normal, theta, sigma):
    """CA (``src/bc_special.c`` contact-angle condition, weak endpoint form):
    the free-surface endpoint tension sigma * m(theta), m = cos(theta) t_w
    + sin(theta) n_w (t_w out of the wetted wall, n_w into the fluid); a
    point load on the momentum equation."""
    t_w = np.asarray(wall_tangent, dtype=float)
    t_w = t_w / np.linalg.norm(t_w)
    n_w = np.asarray(wall_normal, dtype=float)
    n_w = n_w / np.linalg.norm(n_w)

    def f(q, X0, params):
        th = theta(params) if callable(theta) else theta
        s = sigma(params) if callable(sigma) else sigma
        cos, sin = (torch.cos, torch.sin) if torch.is_tensor(th) else (
            math.cos, math.sin)
        m = (cos(th) * torch.as_tensor(t_w, dtype=q.dtype, device=q.device)
             + sin(th) * torch.as_tensor(n_w, dtype=q.dtype, device=q.device))
        return -s * m

    return f


class PowerLawSlip(FaceKernel):
    """VELO_SLIP_POWER / VELO_SLIP_POWER_CARD (``src/mm_ns_bc.c:3553
    fvelo_slip_power_bc``): n . sigma = -(1/beta) (t . (u - u_s))^m t.
    ``tangent`` fixes t (the CARD variant); omitted, t is the surface
    tangent (2D). m = 1 is :class:`NavierSlip`."""

    def __init__(self, dim: int, beta: float, m: float, u_wall=0.0,
                 tangent=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.beta = beta
        self.m = m
        self.u_wall = u_wall
        self.tangent = None if tangent is None else np.asarray(
            tangent, dtype=float)

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        du = sfv.val["velocity"] - _wall_velocity(self.u_wall, sfv, mat,
                                                  params, self.dim)
        if self.tangent is not None:
            t = as_field(self.tangent, (nq, self.dim), sfv.x)
        else:
            t = _unit_tangent(sfv)
        s = torch.einsum("qk,qk->q", t, du)
        # signed power |s|^(m-1) s: odd in s and AD-safe at s = 0 for m >= 1
        mag = torch.sqrt(s * s + 1e-30)
        tr = (1.0 / self.beta) * mag ** (self.m - 1.0) * s
        return torch.einsum("q,qk,qi->qki", tr, t, sfv.phi["velocity"])


class ElectrokineticSlip(FaceKernel):
    """VELO_SLIP_EK / VELO_STREAMING (``src/mm_ns_bc.c:2276
    fvelo_slip_electrokinetic_bc``): Helmholtz-Smoluchowski electroosmotic
    slip, t.u -> u_HS = -(eps_perm zeta / mu) (grad V . t), through the
    weak slip term (1/beta)(t.u - u_HS) with a small beta."""

    def __init__(self, dim: int, permittivity: float, zeta: float,
                 beta: float = 1e-6, potential_var: str = "voltage"):
        super().__init__("velocity", dim)
        self.dim = dim
        self.permittivity = permittivity
        self.zeta = zeta
        self.beta = beta
        self.potential_var = potential_var

    def residual(self, sfv, mat, params):
        t = _unit_tangent(sfv)
        gV = sfv.grad[self.potential_var][:, 0, :]
        mu = prop(mat, "mu", sfv, params)
        u_hs = -(self.permittivity * self.zeta / mu) * torch.einsum(
            "qk,qk->q", gV, t)
        s = torch.einsum("qk,qk->q", t, sfv.val["velocity"]) - u_hs
        return (1.0 / self.beta) * torch.einsum("q,qk,qi->qki", s, t,
                                                sfv.phi["velocity"])


class LevelSetSlip(FaceKernel):
    """VELO_SLIP_FILL / VELO_SLIP_LEVEL / VELO_SLIP_LS_HEAVISIDE /
    VELO_SLIP_ROT_FILL / VELO_SLIP_LEVEL_SIC (``src/mm_ns_bc.c:113
    fvelo_slip_level``): slip modulated by the level set,
    beta_eff = beta_wet H_eps(F) + beta_dry (1 - H_eps(F)), H_eps over
    half-width ``eps_ls``. ``tangential_only=False`` gives the _FILL
    variants."""

    def __init__(self, dim: int, beta_wet: float, beta_dry: float,
                 eps_ls: float, u_wall=0.0, ls_var: str = "fill",
                 tangential_only: bool = True):
        super().__init__("velocity", dim)
        self.dim = dim
        self.beta_wet = beta_wet
        self.beta_dry = beta_dry
        self.eps_ls = eps_ls
        self.u_wall = u_wall
        self.ls_var = ls_var
        self.tangential_only = tangential_only

    def residual(self, sfv, mat, params):
        du = sfv.val["velocity"] - _wall_velocity(self.u_wall, sfv, mat,
                                                  params, self.dim)
        if self.tangential_only:
            du = _tangential(du, sfv.normal)
        H = heaviside(sfv.val[self.ls_var][:, 0], self.eps_ls)
        beta_eff = self.beta_wet * H + self.beta_dry * (1.0 - H)
        return torch.einsum("qa,qi->qai", du / beta_eff[:, None],
                            sfv.phi["velocity"])


class LSNoPenetration(FaceKernel):
    """VELO_NORMAL_LS / _PETROV / _COLLOC and VELO_TANGENT_LS
    (``src/mm_ns_bc.c:355 fvelo_normal_bc`` "fake gas outlet", ``:845
    fvelo_tangential_ls_bc``): n.(v - xdot) = v_n (t.(v - xdot) = v_t with
    ``tangential``) weighted by a level-set gate: the full penalty on the
    liquid side, none in the gas (a free outlet for the gas), a smooth
    Heaviside of half-width ``length`` (shifted by ``shift``), and a
    leak-angle gate that opens the boundary where the interface meets it
    steeper than ``leak_angle_deg`` (cos_leak = cos(180 - angle), width
    sin(180 - angle) sin(10 deg)). ``liquid_negative``: F < 0 is the
    penalized liquid."""

    def __init__(self, dim: int, vnormal=0.0, length: float = 0.1,
                 shift: float = 0.0, leak_angle_deg: float = 135.0,
                 liquid_negative: bool = True, tangential: bool = False,
                 penalty: float = 1e6, ls_var: str = "fill"):
        super().__init__("velocity", dim)
        self.dim = dim
        self.vnormal = vnormal
        self.length = length
        self.shift = shift
        self.leak_angle_deg = leak_angle_deg
        self.liquid_negative = liquid_negative
        self.tangential = tangential
        self.penalty = penalty
        self.ls_var = ls_var

    def residual(self, sfv, mat, params):
        sgn = 1.0 if self.liquid_negative else -1.0
        F = sfv.val[self.ls_var][:, 0]
        Fp = F / self.length + sgn * self.shift
        H = heaviside(Fp, 1.0)
        pen_F = 1.0 - H if self.liquid_negative else H

        # leak-angle gate (fvelo_normal_bc)
        ang = math.radians(180.0 - self.leak_angle_deg)
        cos_leak = math.cos(ang)
        leak_w = math.sin(ang) * math.sin(math.radians(10.0))
        gF = sfv.grad[self.ls_var][:, 0, :]
        n_ls = gF / torch.sqrt(torch.sum(gF * gF, dim=1) + 1e-30)[:, None]
        dot = torch.einsum("qk,qk->q", sfv.normal, n_ls)
        Hleak = heaviside((dot - cos_leak) / leak_w, 1.0)
        open_ = 1.0 - Hleak * (dot > cos_leak - leak_w).to(F.dtype)
        gate = torch.where(
            torch.abs(Fp) < 1.0,
            torch.where(dot >= cos_leak + leak_w, torch.zeros_like(open_),
                        open_),
            torch.ones_like(open_))
        pen_F = pen_F * gate

        v = sfv.val["velocity"]
        if MESH_VAR in sfv.dot:
            v = v - sfv.dot[MESH_VAR]
        if self.tangential:
            if self.dim == 2:
                # reference tangent convention (calc_surf_tangent):
                # stangent[0] = (-n_y, n_x)
                n = sfv.normal
                d = torch.stack([-n[:, 1], n[:, 0]], dim=1)
            else:
                d = _unit_tangent(sfv)
        else:
            d = sfv.normal
        vn = self.vnormal(sfv, mat, params) if callable(self.vnormal) \
            else self.vnormal
        s = torch.einsum("qk,qk->q", d, v) - vn
        return self.penalty * torch.einsum("q,qa,qi->qai", pen_F * s, d,
                                           sfv.phi["velocity"])


class SlipHeating(FaceKernel):
    """Q_VELO_SLIP (``src/mm_ns_bc.c qside_directional`` family): the slip
    work (1/beta)|u_t - u_s|^2 enters the energy equation as an incoming
    surface heat flux."""

    def __init__(self, dim: int, beta: float, u_wall=0.0,
                 var: str = "temperature"):
        super().__init__(var, 1)
        self.dim = dim
        self.beta = beta
        self.u_wall = u_wall

    def residual(self, sfv, mat, params):
        du = sfv.val["velocity"] - _wall_velocity(self.u_wall, sfv, mat,
                                                  params, self.dim)
        dut = _tangential(du, sfv.normal)
        q = -(1.0 / self.beta) * torch.einsum("qk,qk->q", dut, dut)
        return q[:, None, None] * sfv.phi[self.var][:, None, :]


class QVaporFlux(FaceKernel):
    """Q_VAPOR (``src/bc_integ.c:1486`` -> ``calculate_vapor_cool``,
    ``src/mm_ns_bc.c:14609``): the Kanouff evaporative loss leaves through
    the boundary (positive weak term = outflux)."""

    def __init__(self, T_boil: float, T_scale: float = 1.0,
                 q_scale: float = 1.0, var: str = "temperature"):
        super().__init__(var, 1)
        self._q = vapor_cool(T_boil, T_scale, q_scale)

    def residual(self, sfv, mat, params):
        q = self._q(sfv.val[self.var][:, 0])
        return q[:, None, None] * sfv.phi[self.var][:, None, :]


class LaserWeldFlux(FaceKernel):
    """Q_LASER_WELD (``src/bc_integ.c:1482`` -> ``calculate_laser_flux``,
    ``src/mm_ns_bc.c:14757``): traveling-Gaussian beam heating of the
    surface, optionally with the |n . beam_dir| incidence factor and the
    evaporative loss (``T_boil``)."""

    def __init__(self, power: float, radius: float, center,
                 beam_velocity=None, absorptivity: float = 1.0,
                 e_concen: float = 0.4522, beam_dir=None,
                 T_boil: float = None, T_scale: float = 1.0,
                 q_scale: float = 1.0, var: str = "temperature"):
        super().__init__(var, 1)
        self._laser = laser_flux(power, radius, center, beam_velocity,
                                 absorptivity, e_concen)
        self.beam_dir = None if beam_dir is None else (
            np.asarray(beam_dir, dtype=float)
            / np.linalg.norm(beam_dir))
        self._vapor = None if T_boil is None else vapor_cool(
            T_boil, T_scale, q_scale)

    def residual(self, sfv, mat, params):
        q_in = self._laser(sfv.x, params.get("time", 0.0))
        if self.beam_dir is not None:
            inc = torch.abs(torch.einsum(
                "qk,k->q", sfv.normal,
                torch.as_tensor(self.beam_dir, dtype=sfv.x.dtype,
                                device=sfv.x.device)))
            q_in = q_in * inc
        q_out = -q_in
        if self._vapor is not None:
            q_out = q_out + self._vapor(sfv.val[self.var][:, 0])
        return q_out[:, None, None] * sfv.phi[self.var][:, None, :]


class SpeciesKinematicFlux(FaceKernel):
    """KINEMATIC_SPECIES (``src/mm_fill_species.c:3542
    kinematic_species_bc``): convective species flux across a moving
    interface, rho Y (v - xdot) . n - vnormal, on the species rows
    (``rho`` from the material, default 1)."""

    def __init__(self, comp: int = 0, vnormal: float = 0.0,
                 var: str = "species", ncomp: int = 1):
        super().__init__(var, ncomp)
        self.comp = comp
        self.vnormal = vnormal

    def residual(self, sfv, mat, params):
        rho = prop(mat, "rho", sfv, params, 1.0)
        Y = sfv.val[self.var][:, self.comp]
        un = torch.einsum("qk,qk->q", _relative_velocity(sfv), sfv.normal)
        q = rho * Y * un - self.vnormal
        return on_comp(q[:, None] * sfv.phi[self.var], self.comp, self.ncomp)


class LatentHeatInternal(FaceKernel):
    """LATENT_HEAT_INTERNAL (``src/mm_fill_species.c``
    ``lat_heat_internal_bc``, dispatched src/bc_integ.c:1609): latent heat
    at an internal moving surface, q_n = rho L n . (v - xdot), weakly on
    the energy rows."""

    def __init__(self, L_heat: float, var: str = "temperature"):
        super().__init__(var, 1)
        self.L_heat = L_heat

    def residual(self, sfv, mat, params):
        rho = prop(mat, "rho", sfv, params, 1.0)
        un = torch.einsum("qk,qk->q", _relative_velocity(sfv), sfv.normal)
        q = rho * self.L_heat * un
        return (q[:, None] * sfv.phi[self.var])[:, None, :]


class DvzdrZero(FaceKernel):
    """DVZDR_ZERO (``src/bc_colloc.c:693 dvzdr_zero_deriv_bc``): swirl
    symmetry n_wall . grad(v_theta) = 0 at a wall, a penalty on the
    swirl-momentum rows. ``nwall`` is the card's wall direction."""

    def __init__(self, nwall, var: str = "swirl", penalty: float = 1e6):
        super().__init__(var, 1)
        self.nwall = np.asarray(nwall, dtype=float)
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        gw = sfv.grad[self.var][:, 0, :]  # (nq, dim)
        nw = torch.as_tensor(self.nwall[:gw.shape[1]], dtype=sfv.x.dtype,
                             device=sfv.x.device)
        s = torch.einsum("qk,k->q", gw, nw)
        return self.penalty * (s[:, None] * sfv.phi[self.var])[:, None, :]


class AirFilmSlip(FaceKernel):
    """AIR_FILM / AIR_FILM_ROT (``src/mm_ns_bc.c:3760 fvelo_airfilm_bc``):
    gas-film shear between a web and a moving (or rotating) substrate,
    t = gas_mu (u - v_s) (gas_flow = 0) or gas_mu (u - v_s)(u + v_s) /
    gas_flow, v_s constant or the rigid rotation (omega, x0, y0), positive
    omega clockwise. gas_flow = 0 is :class:`NavierSlip` with beta =
    1/gas_mu on all components."""

    def __init__(self, dim: int, gas_mu: float, v_s=(0.0, 0.0),
                 gas_flow: float = 0.0, rotation=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.gas_mu = gas_mu
        self.v_s = np.asarray(v_s, dtype=float)
        self.gas_flow = gas_flow
        self.rotation = rotation  # (omega, x0, y0)

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        if self.rotation is not None:
            om, x0, y0 = self.rotation
            vs = torch.stack([om * (sfv.x[:, 1] - y0),
                              -om * (sfv.x[:, 0] - x0)], dim=1)
        else:
            vs = as_field(self.v_s[:self.dim], (nq, self.dim), sfv.x)
        u = sfv.val["velocity"]
        vrel = u - vs
        if self.gas_flow:
            vrel = vrel * (u + vs) / self.gas_flow
        return self.gas_mu * torch.einsum("qa,qi->qai", vrel,
                                          sfv.phi["velocity"])
