"""Material property models (counterpart of ``goma_tpu/physics/materials.py``).

Parity: the reference's property-model library (``src/mm_viscosity.c``:
Newtonian, power-law, Carreau, Bingham, WLF, suspension, bond;
``src/density.c``). A property in a material dict is a python scalar
(constant model) or a callable ``f(fv, mat, params)`` evaluated at
quadrature points; derivatives come from AD (``torch.func.jacfwd`` of the
element residual), so no dependence structs exist.

``shear_rate`` is goma_tpu's 2-D invariant sqrt(2 D:D) of the in-plane
velocity gradient, also in axisymmetric coordinates, where it leaves out
the hoop rate 2 (u_r/r)^2 (kept so for parity; see ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch


def prop(mat: dict, name: str, fv, params, default=None):
    """Evaluate a material property (scalar, or a callable model)."""
    v = mat.get(name, default)
    if v is None:
        raise KeyError(f"material property '{name}' missing")
    if callable(v):
        return v(fv, mat, params)
    return v


def as_field(v, shape, like):
    """``v`` (a python scalar, a numpy array or a tensor) at ``like``'s
    dtype and device, broadcast to ``shape`` (goma_tpu's
    ``jnp.broadcast_to(jnp.asarray(v), shape)``)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).expand(shape)


def shear_rate(fv, var: str = "velocity"):
    """Scalar shear rate sqrt(2 D:D), D = (grad u + grad u^T)/2."""
    g = fv.grad[var]  # (nq, dim, dim)
    D = 0.5 * (g + g.transpose(1, 2))
    return torch.sqrt(2.0 * torch.sum(D * D, dim=(1, 2)) + 1e-32)


def _floor(a, lo: float):
    """max(a, lo) with jnp.maximum's derivative (half to each side at a
    tie), which torch.maximum shares and torch.clamp does not."""
    return torch.maximum(a, torch.full((), lo, dtype=a.dtype, device=a.device))


def _tiny(dtype) -> float:
    """goma_tpu's 1e-300 floor where it is a number of ``dtype`` (float64);
    the smallest normal number of a narrower dtype, where 1e-300 rounds
    to 0."""
    return 1e-300 if dtype == torch.float64 else torch.finfo(dtype).tiny


def _clip(a, lo: float, hi: float):
    """jnp.clip's form, a maximum then a minimum: at a bound the derivative
    is half (goma_tpu's), where torch.clamp gives all of it."""
    return torch.minimum(_floor(a, lo),
                         torch.full((), hi, dtype=a.dtype, device=a.device))


class PowerLawViscosity:
    """mu = m * gamma_dot^(n-1). Reference: POWER_LAW model."""

    def __init__(self, m: float, n: float, gamma_min: float = 1e-8):
        self.m, self.n, self.gamma_min = m, n, gamma_min

    def __call__(self, fv, mat, params):
        gd = _floor(shear_rate(fv), self.gamma_min)
        return self.m * gd ** (self.n - 1.0)


class CarreauViscosity:
    """mu = mu_inf + (mu0-mu_inf) [1+(lam*gd)^a]^((n-1)/a). Reference: CARREAU."""

    def __init__(self, mu0, mu_inf, lam, n, a=2.0):
        self.mu0, self.mu_inf, self.lam, self.n, self.a = mu0, mu_inf, lam, n, a

    def __call__(self, fv, mat, params):
        gd = shear_rate(fv)
        return self.mu_inf + (self.mu0 - self.mu_inf) * (
            1.0 + (self.lam * gd) ** self.a) ** ((self.n - 1.0) / self.a)


class BinghamViscosity:
    """Regularized Bingham-Carreau-Yasuda (Papanastasiou regularization).
    Reference: BINGHAM model in ``src/mm_viscosity.c``."""

    def __init__(self, mu0, tau_y, F=1.0):
        self.mu0, self.tau_y, self.F = mu0, tau_y, F

    def __call__(self, fv, mat, params):
        gd = shear_rate(fv)
        return self.mu0 + self.tau_y * (1.0 - torch.exp(-self.F * gd)) / _floor(
            gd, 1e-12)


class CarreauWLFViscosity:
    """Carreau shear thinning x WLF temperature shift:
    a_T = exp(c1 (T_ref - T) / (c2 + T - T_ref)),
    mu = a_T [mu_inf + (mu0 - mu_inf)(1 + (a_T lam gd)^a)^((n-1)/a)].
    Reference: CARREAU_WLF / WLF models (src/mm_viscosity.c)."""

    def __init__(self, mu0, mu_inf, lam, n, c1, c2, T_ref,
                 a=2.0, tvar: str = "temperature"):
        self.mu0, self.mu_inf, self.lam, self.n, self.a = mu0, mu_inf, lam, n, a
        self.c1, self.c2, self.T_ref, self.tvar = c1, c2, T_ref, tvar

    def __call__(self, fv, mat, params):
        T = fv.val[self.tvar][:, 0]
        aT = torch.exp(self.c1 * (self.T_ref - T) / (self.c2 + T - self.T_ref))
        gd = shear_rate(fv)
        return aT * (self.mu_inf + (self.mu0 - self.mu_inf)
                     * (1.0 + (aT * self.lam * gd) ** self.a)
                     ** ((self.n - 1.0) / self.a))


class ArrheniusViscosity:
    """mu = mu0 exp(E (1/T - 1/T_ref)): thermal thinning (reference: the
    THERMAL/exponential temperature models in mm_viscosity.c)."""

    def __init__(self, mu0, E, T_ref, tvar: str = "temperature"):
        self.mu0, self.E, self.T_ref, self.tvar = mu0, E, T_ref, tvar

    def __call__(self, fv, mat, params):
        T = fv.val[self.tvar][:, 0]
        return self.mu0 * torch.exp(self.E * (1.0 / T - 1.0 / self.T_ref))


class SuspensionViscosity:
    """Krieger-Dougherty: mu = mu0 (1 - C/Cmax)^n with particle volume
    fraction C from a species field. Reference: SUSPENSION model
    (src/mm_viscosity.c suspension_viscosity) with n typically -1.82."""

    def __init__(self, mu0, Cmax, n=-1.82, svar: str = "species", comp: int = 0,
                 floor: float = 1e-3):
        self.mu0, self.Cmax, self.n = mu0, Cmax, n
        self.svar, self.comp, self.floor = svar, comp, floor

    def __call__(self, fv, mat, params):
        C = fv.val[self.svar][:, self.comp]
        return self.mu0 * _floor(1.0 - C / self.Cmax, self.floor) ** self.n


class FillerDensity:
    """Two-component density rho = rho_s C + rho_f (1 - C) (reference:
    SOLVENT_POLYMER / FILL density models, src/density.c)."""

    def __init__(self, rho_f, rho_s, svar: str = "species", comp: int = 0):
        self.rho_f, self.rho_s, self.svar, self.comp = rho_f, rho_s, svar, comp

    def __call__(self, fv, mat, params):
        C = fv.val[self.svar][:, self.comp]
        return self.rho_s * C + self.rho_f * (1.0 - C)


class BoussinesqBodyForce:
    """f = g * (1 - beta (T - T0)); multiplied by rho in the momentum kernel.
    Reference: BOUSSINESQ in ``momentum_source_term``
    (src/mm_fill_momentum.c). ``gravity`` is kept as numpy and put on the
    temperature's device and dtype once per pair, so one material dict
    serves the float64 residual and the float32 Jacobian alike."""

    def __init__(self, gravity, beta: float, T0: float = 0.0,
                 tvar: str = "temperature"):
        self.gravity = np.array(gravity, dtype=np.float64)
        self.beta, self.T0, self.tvar = beta, T0, tvar
        self._g = {}

    def __call__(self, fv, mat, params):
        T = fv.val[self.tvar][:, 0]
        key = (T.dtype, T.device)
        if key not in self._g:
            self._g[key] = torch.as_tensor(self.gravity, dtype=T.dtype,
                                           device=T.device)
        return self._g[key][None, :] * (1.0 - self.beta * (T - self.T0))[:, None]


class BondViscosity:
    """Structure-dependent thixotropic viscosity (reference
    ``bond_viscosity``, ``src/mm_viscosity.c:2770``, BOND model):

        mu = a_T [mu_inf + (mu0 - mu_inf) nn^A] + nn tau_y (1-e^(-a_T F gd))/(a_T gd)

    with nn the bond structure (a solved ``nvar`` field), an optional WLF
    temperature shift a_T, and a Papanastasiou-regularized yield
    contribution scaled by the structure."""

    def __init__(self, mu0, mu_inf, aexp=1.0, tau_y=0.0, fexp=1.0,
                 atexp=0.0, wlfc2=1.0, T_ref=0.0, nvar: str = "bond",
                 tvar: str = "temperature"):
        self.mu0, self.mu_inf, self.aexp = mu0, mu_inf, aexp
        self.tau_y, self.fexp = tau_y, fexp
        self.atexp, self.wlfc2, self.T_ref = atexp, wlfc2, T_ref
        self.nvar, self.tvar = nvar, tvar

    def __call__(self, fv, mat, params):
        nn = _floor(fv.val[self.nvar][:, 0], 0.0)
        aT = 1.0
        if self.atexp and self.tvar in fv.val:
            T = fv.val[self.tvar][:, 0]
            aT = torch.exp(self.atexp * (self.T_ref - T)
                           / (self.wlfc2 + T - self.T_ref))
        mu = aT * (self.mu_inf + (self.mu0 - self.mu_inf) * nn ** self.aexp)
        if self.tau_y:
            gd = shear_rate(fv)
            mu = mu + nn * self.tau_y * (1.0 - torch.exp(-aT * self.fexp * gd)) \
                / _floor(aT * gd, 1e-12)
        return mu
