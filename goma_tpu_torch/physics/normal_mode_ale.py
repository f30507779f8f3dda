"""Deforming-mesh (free-surface) 3D-of-2D normal-mode stability
(counterpart of ``goma_tpu/physics/normal_mode_ale.py``).

Parity: the reference's LSA_3D_OF_2D machinery with MESH mode equations
(``src/ac_stability_util.c do_LSA_mods:84`` — trig-factored basis assembled
per wavenumber, including the mesh-displacement sensitivities that
hand-coded ``load_fv_mesh_derivs`` provides).

The REAL problem's AD Jacobian carries the in-plane part. For a z-periodic
perturbation of a 2D ALE base state,

    (u_hat, p_hat, T_hat, d_hat) ~ f(x, y) cos(beta z),  w_hat ~ sin(beta z)

the full 3D Jacobian splits as J(beta) = J0 + (beta terms): J0 is the plain
2D coupled Jacobian of the ALE problem itself — which the assembly already
produces EXACTLY by AD, including every mesh-position sensitivity, the
kinematic free-surface coupling, capillary in-plane curvature, and body
forces on the displaced domain. Only the z-derivative terms need new
kernels, and they are simple local products:

- :class:`MomentumZ`      (velocity rows):  + mu beta^2 u phi
                                            - mu beta (grad w) phi
- :class:`WMomentum`      (new var nm_w):   rho(w_t + u0.grad w) psi
                                            + mu grad w . grad psi
                                            - mu beta u . grad psi
                                            + 2 mu beta^2 w psi - beta p psi
- :class:`ContinuityZ`    (pressure rows):  + beta w q
- :class:`MeshZ`          (mesh rows):      + k beta^2 d phi
- :class:`ScalarZ`        (energy/species): + a beta^2 c phi
- :class:`CapillaryZNormal` (face, velocity): + sigma beta^2 (d.n)(n.phi)
  — the out-of-plane curvature of the perturbed surface (the in-plane part
  comes from AD of the 2D CapillaryBC w.r.t. mesh displacement). This is
  the ONLY first-order capillary mode term: the candidate w-test term
  -sigma beta eta (n.grad psi) cancels exactly against the surface-shift
  of the d(psi sin)/dz piece (goma_tpu's tests/test_normal_mode_ale.py
  holds the film-leveling dispersion to the exact Stokes one).

Usage: build the deck WITH these extra equations/kernels appended (they all
vanish at the base state w=0 once params carry the solved base), solve the
BASE on the plain 2D problem, ``embed_state`` it into the extended problem,
and sweep ``solve_stability(ext_prob, x_emb, params(beta=...))``.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.physics.fluid import _as_nq, advective_velocity
from goma_tpu_torch.physics.materials import prop

NM_W = "nm_w"


def _beta(params, dtype):
    return torch.as_tensor(params["beta"]).to(dtype)


class MomentumZ(Equation):
    """z-derivative stress terms of the in-plane momentum equation
    (cos mode): sigma_az d(phi_a)/dz with sigma_az = mu(du_a/dz + dw/dx_a)
    reduces to + mu beta^2 u phi - mu beta (grad w) phi."""

    def __init__(self, dim: int = 2, interp: str = "Q2"):
        super().__init__("velocity", dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        mu = _as_nq(prop(mat, "mu", fv, params), nq, fv.x)
        b = _beta(params, fv.x.dtype)
        u = fv.val["velocity"]
        phi = fv.phi["velocity"]
        out = (b * b) * torch.einsum("q,qa,qi->qai", mu, u, phi)
        if NM_W in fv.val:
            gw = fv.grad[NM_W][:, 0, :]  # (nq, dim)
            out = out - b * torch.einsum("q,qa,qi->qai", mu, gw, phi)
        return out


class WMomentum(Equation):
    """Out-of-plane (sin mode) momentum for w_hat, tested with psi sin:
    rho(w_t + u_adv.grad w) psi + mu grad w.grad psi - mu beta u.grad psi
    + 2 mu beta^2 w psi - beta p psi. The pressure term is sigma_zz's
    -p contribution; natural side/top BCs."""

    def __init__(self, interp: str = "Q2", transient: bool = True,
                 convection: bool = True):
        super().__init__(NM_W, 1, interp)
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        rho = _as_nq(prop(mat, "rho", fv, params, 1.0), nq, fv.x)
        mu = _as_nq(prop(mat, "mu", fv, params), nq, fv.x)
        b = _beta(params, fv.x.dtype)
        w = fv.val[NM_W][:, 0]
        gw = fv.grad[NM_W][:, 0, :]
        psi = fv.phi[NM_W]
        gpsi = fv.gphi[NM_W]
        inert = torch.zeros_like(w)
        if self.transient:
            inert = inert + fv.dot[NM_W][:, 0]
        if self.convection and "velocity" in fv.val:
            inert = inert + torch.einsum("qk,qk->q", advective_velocity(fv), gw)
        out = torch.einsum("q,qi->qi", rho * inert + 2.0 * mu * b * b * w, psi)
        out = out + torch.einsum("q,qk,qik->qi", mu, gw, gpsi)
        if "velocity" in fv.val:
            u = fv.val["velocity"]
            out = out - b * torch.einsum("q,qk,qik->qi", mu, u, gpsi)
        if "pressure" in fv.val:
            p = fv.val["pressure"][:, 0]
            out = out - b * torch.einsum("q,qi->qi", p, psi)
        return out[:, None, :]


class ContinuityZ(Equation):
    """dw/dz = beta w_hat cos: continuity rows gain + beta w q."""

    def __init__(self, interp: str = "Q1"):
        super().__init__("pressure", 1, interp)

    def residual(self, fv, mat, params):
        b = _beta(params, fv.x.dtype)
        w = fv.val[NM_W][:, 0]
        psi = fv.phi["pressure"]
        return (b * torch.einsum("q,qi->qi", w, psi))[:, None, :]


class MeshZ(Equation):
    """Keeps the interior mesh-smoothing operator elliptic in 3D:
    + stiffness beta^2 d phi on the mesh rows (reference-frame measure,
    matching EllipticMesh/LinearElasticMesh)."""

    measure = "reference"

    def __init__(self, dim: int = 2, interp: str = "Q2", stiffness: float = 1.0):
        super().__init__(MESH_VAR, dim, interp)
        self.dim = dim
        self.stiffness = stiffness

    def residual(self, fv, mat, params):
        b = _beta(params, fv.X0.dtype)
        d = fv.val[MESH_VAR]
        phi = fv.phi[MESH_VAR]
        return (self.stiffness * b * b) * torch.einsum("qa,qi->qai", d, phi)


class ScalarZ(Equation):
    """Diffusive z-term of a scalar transport equation (cos mode):
    + coeff beta^2 c phi (coeff = conductivity/diffusivity material key)."""

    def __init__(self, var: str, coeff_key: str, interp: str = "Q2"):
        super().__init__(var, 1, interp)
        self.coeff_key = coeff_key

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        a = _as_nq(prop(mat, self.coeff_key, fv, params), nq, fv.x)
        b = _beta(params, fv.x.dtype)
        c = fv.val[self.var][:, 0]
        phi = fv.phi[self.var]
        return ((b * b) * torch.einsum("q,q,qi->qi", a, c, phi))[:, None, :]


class CapillaryZNormal(FaceKernel):
    """Out-of-plane curvature of the perturbed free surface: the 3D weak
    capillary term sigma (I - nn):grad(phi) picks up, at first order in the
    surface displacement eta = d_hat.n, the in-plane-test contribution
    + sigma beta^2 eta (n.phi) (the z-curvature -d^2 eta/dz^2 restoring
    force; in-plane curvature linearization rides AD of CapillaryBC)."""

    def __init__(self, dim: int = 2, sigma=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.sigma = sigma

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        sig = self.sigma if self.sigma is not None else prop(mat, "sigma", sfv, params)
        if callable(sig):
            sig = sig(sfv, mat, params)
        sig = _as_nq(sig, nq, sfv.x)
        b = _beta(params, sfv.x.dtype)
        n = sfv.normal
        eta = torch.einsum("qk,qk->q", sfv.val[MESH_VAR], n)
        phi = sfv.phi["velocity"]
        return (b * b) * torch.einsum("q,qa,qi->qai", sig * eta, n, phi)


def zmode_equations(dim: int = 2, vel_interp: str = "Q2",
                    p_interp: str = "Q1", mesh: bool = True,
                    mesh_interp: str = "Q2",
                    scalars: tuple = ()) -> list:
    """The volume beta-correction equations to append to a 2D ALE deck.
    ``scalars``: tuples (var, coeff_key, interp) for energy/species."""
    eqs = [
        MomentumZ(dim, vel_interp),
        WMomentum(vel_interp),
        ContinuityZ(p_interp),
    ]
    if mesh:
        eqs.append(MeshZ(dim, mesh_interp))
    for var, key, itp in scalars:
        eqs.append(ScalarZ(var, key, itp))
    return eqs


def embed_state(src_prob, x_src, dst_prob):
    """Copy a solved state between problems on the same mesh by
    (variable, node, component); extended-problem extras stay zero.
    Nodal interpolations only (elemental P0/P1E dofs are copied when the
    block layouts match). Host numpy in and out."""
    x = np.zeros(dst_prob.dofmap.n_dof)
    xs = np.asarray(x_src)
    src_map = src_prob.dofmap.dof_of_node_svar
    dst_map = dst_prob.dofmap.dof_of_node_svar
    for v in src_prob.dofmap.vars:
        if v.name not in dst_prob.dofmap.svar_offset:
            continue
        for c in range(v.ncomp):
            s = src_map[:, src_prob.dofmap.svar(v.name, c)]
            d = dst_map[:, dst_prob.dofmap.svar(v.name, c)]
            ok = (s >= 0) & (d >= 0)
            x[d[ok]] = xs[s[ok]]
    # elemental dofs (beyond the node-major range): identical layouts only
    n_src_nodal = int(src_map.max()) + 1
    n_dst_nodal = int(dst_map.max()) + 1
    n_elem_src = src_prob.dofmap.n_dof - n_src_nodal
    if n_elem_src > 0 and dst_prob.dofmap.n_dof - n_dst_nodal == n_elem_src:
        x[n_dst_nodal:] = xs[n_src_nodal:]
    return x
