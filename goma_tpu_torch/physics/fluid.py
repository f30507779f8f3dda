"""Incompressible fluid momentum + continuity (counterpart of
``goma_tpu/physics/fluid.py``), with the same constructor options and
defaults, so decks carry over unchanged.

Parity: reference ``src/mm_fill_momentum.c:98 assemble_momentum`` and
``src/mm_fill_continuity.c:113 assemble_continuity`` with the PSPG/SUPG
formulas of ``src/mm_fill_stabilization.c`` (Shakib tau). Weak forms:

  momentum:   R_ai = int phi_i rho (udot_a + u.grad u_a - f_a)
                   + grad(phi_i) : sigma_a   dOmega,
              sigma = -p I + mu (grad u + grad u^T) + sigma_ve (polymer)
  continuity: R_i = int psi_i (div u - s) dOmega  (+ PSPG)

The polymer stress sigma_ve sums the EVSS-F stress modes ``stress{m}``,
the log- and square-root-conformation modes (``physics/viscoelastic.py``)
and the DEVSS stabilization 2 mu_d (D(u) - sym G) with G the projected
velocity gradient.

In axisymmetric coordinates (``coord="cylindrical"``/``"swirling"``, q =
[z, r]) the momentum r rows gain the hoop stress sigma_tt / r (the polymer
``stress{m}_tt`` of ``AxisymHoopStress`` included) and, with a swirl field,
the centrifugal -rho w^2 / r; continuity gains u_r / r; ``SwirlMomentum``
is the azimuthal momentum of swirling flow.

The Q2/Q1 Galerkin block with constant rho/mu in cartesian coordinates is
assembled by the fused kernel in ``fem/fastns.py``; every other block (any
polymer or axisymmetric term included) runs ``residual`` through the
generic AD path.
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.materials import prop

def _as_nq(a, nq, like):
    """A property value as an (nq,) tensor at ``like``'s dtype and device:
    a python scalar is filled, a 0-d tensor broadcast, an (nq,) kept."""
    if not torch.is_tensor(a):
        return torch.full((nq,), float(a), dtype=like.dtype, device=like.device)
    if a.ndim == 0:
        return a.expand(nq)
    return a


def advective_velocity(fv, var: str = "velocity"):
    """ALE advective velocity u - d_dot(mesh): the convection seen at a
    mesh point (reference: the x_dot subtraction throughout mm_fill_*.c for
    ALE); ``u`` on a fixed mesh, zero for a pure-transport block with no
    flow field."""
    from goma_tpu_torch.fem.fields import MESH_VAR

    if var not in fv.val:
        return torch.zeros_like(fv.x)
    u = fv.val[var]
    if MESH_VAR in fv.dot:
        return u - fv.dot[MESH_VAR]
    return u


class Momentum(Equation):
    """Navier-Stokes momentum. ``transient`` includes rho*udot;
    ``convection`` the advective term; the material key ``body_force`` an
    (nq, dim) acceleration (callable) or constant vector; ``supg`` the
    streamline stabilization of the generic path. ``ve_stress_modes`` adds
    the polymer stress modes weakly (EVSS-F coupling), ``logconf_modes`` and
    ``sqrtconf_modes`` ((mode, lam, mu_p), ...) the conformation modes'
    stress, ``devss_mu`` the DEVSS stabilization."""

    def __init__(
        self,
        dim: int,
        interp: str = "Q2",
        transient: bool = True,
        convection: bool = True,
        ve_stress_modes: int = 0,
        devss_mu: float = 0.0,
        logconf_modes: tuple = (),
        sqrtconf_modes: tuple = (),
        supg: float = 0.0,
    ):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.transient = transient
        self.convection = convection
        self.ve_stress_modes = ve_stress_modes
        self.logconf_modes = tuple(logconf_modes)
        self.sqrtconf_modes = tuple(sqrtconf_modes)
        self.supg = supg
        self.devss_mu = devss_mu

    def residual(self, fv, mat, params):
        x = fv.x
        nq, dim = x.shape[0], self.dim
        gu = fv.grad["velocity"]  # (nq, dim, dim): gu[q,a,k] = du_a/dx_k
        p = fv.val["pressure"][:, 0]
        rho = _as_nq(prop(mat, "rho", fv, params, 1.0), nq, x)
        mu = _as_nq(prop(mat, "mu", fv, params), nq, x)
        phi = fv.phi["velocity"]  # (nq, nbf)
        gphi = fv.gphi["velocity"]  # (nq, nbf, dim)
        axisym = fv.coord in ("cylindrical", "swirling") and dim == 2

        inert = torch.zeros((nq, dim), dtype=x.dtype, device=x.device)
        if self.transient:
            inert = inert + fv.dot["velocity"]
        if self.convection:
            inert = inert + torch.einsum("qk,qak->qa", advective_velocity(fv), gu)
        if axisym and "swirl" in fv.val and self.convection:
            # centrifugal -rho w^2 / r in the r-momentum (reference: the
            # hq[2][1] curvature terms of assemble_momentum in SWIRLING)
            w = fv.val["swirl"][:, 0]
            inert = inert - torch.stack([torch.zeros_like(w), w * w / fv.r],
                                        dim=1)
        f = mat.get("body_force", None)
        if f is not None:
            fval = f(fv, mat, params) if callable(f) else torch.as_tensor(
                f, dtype=x.dtype, device=x.device).expand(nq, dim)
            inert = inert - fval
        contrib = torch.einsum("qa,qi->qai", rho[:, None] * inert, phi)

        # stress: sigma[q,a,k] = -p delta + mu (gu + gu^T)
        eye = torch.eye(dim, dtype=x.dtype, device=x.device)
        sigma = (mu[:, None, None] * (gu + gu.transpose(1, 2))
                 - p[:, None, None] * eye[None])
        for m in range(self.ve_stress_modes):
            sigma = sigma + _sym_expand(fv.val[f"stress{m}"], dim)
        if self.logconf_modes or self.sqrtconf_modes:
            from goma_tpu_torch.physics.viscoelastic import (
                logconf_stress_tensor, sqrtconf_stress_tensor)

            for m, lam_m, mup_m in self.logconf_modes:
                sigma = sigma + logconf_stress_tensor(fv, m, lam_m, mup_m)
            for m, lam_m, mup_m in self.sqrtconf_modes:
                sigma = sigma + sqrtconf_stress_tensor(fv, m, lam_m, mup_m)
        if self.devss_mu > 0.0 and "velocity_gradient" in fv.val:
            G = fv.val["velocity_gradient"].reshape(-1, dim, dim)
            Dg = 0.5 * (G + G.transpose(1, 2))
            Du = 0.5 * (gu + gu.transpose(1, 2))
            sigma = sigma + 2.0 * self.devss_mu * (Du - Dg)
        contrib = contrib + torch.einsum("qak,qik->qai", sigma, gphi)

        if axisym:
            # hoop stress sigma_tt = -p + 2 mu u_r / r: the theta-theta entry
            # of grad(v) for v = phi e_r is phi / r, so the weak form gains
            # int sigma_tt (phi / r) r dOmega on the r rows (reference: the
            # scale-factor terms of load_coordinate_scales inside
            # assemble_momentum); the polymer hoop stress of each mode comes
            # from its AxisymHoopStress companion
            sig_tt = -p + 2.0 * mu * fv.val["velocity"][:, 1] / fv.r
            for m in range(self.ve_stress_modes):
                tt = f"stress{m}_tt"
                if tt in fv.val:
                    sig_tt = sig_tt + fv.val[tt][:, 0]
            hoop = torch.einsum("q,qi->qi", sig_tt / fv.r, phi)
            contrib = contrib + torch.stack([torch.zeros_like(hoop), hoop],
                                            dim=1)

        if self.supg > 0.0:
            # streamline stabilization with the strong inertial + pressure
            # residual (Shakib-style tau, reference tau_momentum_shakib)
            u_adv = advective_velocity(fv)
            h = fv.h_elem
            unorm = torch.sqrt(torch.sum(u_adv * u_adv, dim=1) + 1e-30)
            tau = self.supg / torch.sqrt(
                (2.0 * rho * unorm / h) ** 2 + (4.0 * mu / h ** 2) ** 2 + 1e-30)
            rm = rho[:, None] * inert + fv.grad["pressure"][:, 0, :]
            wsup = torch.einsum("qk,qik->qi", u_adv, gphi)
            contrib = contrib + torch.einsum("q,qa,qi->qai", tau, rm, wsup)
        return contrib


def _sym_expand(s, dim):
    """(nq, ncomp symmetric) -> (nq, dim, dim)."""
    if dim == 2:
        s11, s12, s22 = s[:, 0], s[:, 1], s[:, 2]
        return torch.stack([torch.stack([s11, s12], dim=1),
                            torch.stack([s12, s22], dim=1)], dim=1)
    s11, s12, s22, s13, s23, s33 = [s[:, i] for i in range(6)]
    r0 = torch.stack([s11, s12, s13], dim=1)
    r1 = torch.stack([s12, s22, s23], dim=1)
    r2 = torch.stack([s13, s23, s33], dim=1)
    return torch.stack([r0, r1, r2], dim=1)


class Continuity(Equation):
    """div(u) = 0 tested with the pressure basis; material key
    ``mass_source`` a volumetric source; ``pspg`` the PSPG stabilization
    for equal-order pairs (reference ``calc_pspg``,
    ``src/mm_fill_stabilization.c:691``)."""

    def __init__(self, interp: str = "Q1", pspg: float = 0.0):
        super().__init__("pressure", 1, interp)
        self.pspg = pspg

    def residual(self, fv, mat, params):
        x = fv.x
        nq = x.shape[0]
        gu = fv.grad["velocity"]
        divu = torch.diagonal(gu, dim1=1, dim2=2).sum(dim=1)  # (nq,)
        if fv.coord in ("cylindrical", "swirling"):
            # div u = du_z/dz + (1/r) d(r u_r)/dr = the 2D div + u_r / r
            divu = divu + fv.val["velocity"][:, 1] / fv.r
        S = mat.get("mass_source", None)
        if S is not None:
            divu = divu - _as_nq(S(fv, mat, params) if callable(S) else S, nq, x)
        contrib = torch.einsum("q,qi->qi", divu, fv.phi["pressure"])[:, None, :]
        if self.pspg > 0.0:
            rho = _as_nq(prop(mat, "rho", fv, params, 1.0), nq, x)
            mu = _as_nq(prop(mat, "mu", fv, params), nq, x)
            u = fv.val["velocity"]
            h = fv.h_elem
            unorm = torch.sqrt(torch.sum(u * u, dim=1) + 1e-30)  # AD-safe at 0
            tau = self.pspg / torch.sqrt(
                (2.0 * rho * unorm / h) ** 2 + (4.0 * mu / h ** 2) ** 2 + 1e-30)
            # momentum strong residual approx: rho (u.grad u) + grad p
            rm = (rho[:, None] * torch.einsum("qk,qak->qa", u, gu)
                  + fv.grad["pressure"][:, 0, :])
            contrib = contrib + torch.einsum(
                "q,qa,qia->qi", tau / torch.clamp(rho, min=1e-30), rm,
                fv.gphi["pressure"])[:, None, :]
        return contrib


class SwirlMomentum(Equation):
    """Azimuthal (theta) momentum for axisymmetric SWIRLING flow: scalar
    swirl velocity w = v_theta(z, r) on a 2D (z, r) mesh.

    Weak form (test function phi e_theta, axisymmetric):

        int rho (wdot + u.grad w + u_r w / r) phi  r dOmega
      + int [ tau_tz dphi/dz + tau_tr (dphi/dr - phi/r) ]  r dOmega

    with the physical shear stresses tau_tz = mu dw/dz and
    tau_tr = mu (dw/dr - w/r). Reference: the VELOCITY3 swirl component of
    assemble_momentum in SWIRLING coordinates (src/mm_fill_momentum.c +
    the src/mm_fill_aux.c scale factors).
    """

    def __init__(self, interp: str = "Q2", transient: bool = True,
                 convection: bool = True):
        super().__init__("swirl", 1, interp)
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        if fv.coord != "swirling":
            raise ValueError("SwirlMomentum requires Problem(coord='swirling')")
        x = fv.x
        nq = x.shape[0]
        rho = _as_nq(prop(mat, "rho", fv, params, 1.0), nq, x)
        mu = _as_nq(prop(mat, "mu", fv, params), nq, x)
        w = fv.val["swirl"][:, 0]
        gw = fv.grad["swirl"][:, 0, :]  # (nq, 2): [dw/dz, dw/dr]
        r = fv.r
        phi = fv.phi["swirl"]
        gphi = fv.gphi["swirl"]  # (nq, nbf, 2)

        inert = torch.zeros((nq,), dtype=x.dtype, device=x.device)
        if self.transient:
            inert = inert + fv.dot["swirl"][:, 0]
        if self.convection and "velocity" in fv.val:
            u = advective_velocity(fv)
            inert = inert + torch.einsum("qk,qk->q", u, gw) + u[:, 1] * w / r
        contrib = torch.einsum("q,qi->qi", rho * inert, phi)
        tau_tz = mu * gw[:, 0]
        tau_tr = mu * (gw[:, 1] - w / r)
        contrib = contrib + torch.einsum("q,qi->qi", tau_tz, gphi[:, :, 0])
        contrib = contrib + torch.einsum("q,qi->qi", tau_tr,
                                         gphi[:, :, 1] - phi / r[:, None])
        return contrib[:, None, :]
