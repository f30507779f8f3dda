"""Stress-based traction boundary conditions (counterpart of
``goma_tpu/bc/traction.py``): Maxwell (electric) stress, fully developed
outflow, Coulomb friction, slope and strongly integrated force conditions.

Parity:
- ELEC_TRACTION / ELEC_TRACTION_SOLID (``src/mm_ns_bc.c:4443
  elec_surf_stress``): Maxwell stress Te = eps (E E - |E|^2/2 I),
  E = -grad V, contributes -int phi n.Te dG to the momentum (fluid) or
  mesh (solid) rows;
- FLOW_GRADV / FLOW_GRADV_T / FLOW_GRADV_SIC (``src/mm_ns_bc.c:6440
  flow_n_dot_T_gradv``, ``:6552 flow_n_dot_T_gradv_t``): a fully developed
  open boundary replacing the natural traction with n.T, T = -p I + mu
  grad(v) (or its transpose); the SIC variant as a penalty;
- FRICTION / FRICTION_RS / FRICTION_ACOUSTIC(_RS)
  (``src/mm_fill_solid.c:1910 friction_n_dot_f_bc``): Coulomb sliding
  friction on the tangential solid/mesh rows, with the acoustic reduction
  fac = (2/pi) asin(|v|/v_acoustic);
- SLOPE (``src/mm_fill_solid.c:1234``) and FORCE_SIC
  (``src/mm_fill_solid.c:1283``) as penalties.

Every Jacobian block (the reference's hand-coded d_func tails) comes from
forward-mode AD of these residuals.
"""

from __future__ import annotations

import math

import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.physics.materials import _clip, as_field, prop


def _unit(t):
    return t / torch.linalg.norm(t, dim=1, keepdim=True)


def _small_strain_stress(kernel, sfv, mat, params):
    """2 G eps + lam tr(eps) I of ``kernel.var`` at the face: the mesh
    keys (``mesh_shear_modulus``/``mesh_lambda``) for the mesh variable,
    ``lame_mu``/``lame_lambda`` otherwise."""
    if kernel.var == MESH_VAR:
        G = prop(mat, "mesh_shear_modulus", sfv, params, 1.0)
        lam = prop(mat, "mesh_lambda", sfv, params, 1.0)
    else:
        G = prop(mat, "lame_mu", sfv, params, 1.0)
        lam = prop(mat, "lame_lambda", sfv, params, 1.0)
    gd = sfv.grad[kernel.var]  # (nq, a, k)
    eps = 0.5 * (gd + gd.transpose(1, 2))
    tr = torch.diagonal(eps, dim1=1, dim2=2).sum(dim=1)
    eye = torch.eye(kernel.dim, dtype=gd.dtype, device=gd.device)[None]
    return 2.0 * G * eps + lam * tr[:, None, None] * eye


class ElecTraction(FaceKernel):
    """Maxwell-stress traction on a conductor/dielectric interface.

    Adds -int phi_a (n . Te)_a dG with Te = perm (E E - 0.5 |E|^2 I) and
    E = -grad(V) on this side of the interface (call from both sides with
    each material's permittivity for a dielectric/dielectric jump, as the
    reference does). ``var``: "velocity" for ELEC_TRACTION, the mesh/solid
    displacement for ELEC_TRACTION_SOLID.
    """

    def __init__(self, dim: int, permittivity=None, var: str = "velocity",
                 potential_var: str = "voltage", etm: float = 1.0):
        super().__init__(var, dim)
        self.dim = dim
        self.permittivity = permittivity
        self.potential_var = potential_var
        self.etm = etm

    def residual(self, sfv, mat, params):
        perm = self.permittivity
        if perm is None:
            perm = prop(mat, "permittivity", sfv, params, 1.0)
        E = -sfv.grad[self.potential_var][:, 0, :]  # (nq, dim)
        n = sfv.normal
        nE = torch.einsum("qk,qk->q", n, E)
        E2 = torch.einsum("qk,qk->q", E, E)
        nTe = perm * (nE[:, None] * E - 0.5 * E2[:, None] * n)
        phi = sfv.phi[self.var]
        return -self.etm * torch.einsum("qa,qi->qai", nTe, phi)


class FlowGradV(FaceKernel):
    """Fully developed outflow: replace the open-boundary traction with
    n.T, T = -p I + mu grad(v) (``transpose=False``, FLOW_GRADV) or
    -p I + mu grad(v)^T (FLOW_GRADV_T). ``p_datum=None`` uses the pressure
    field (the reference's iflag != -1); a float imposes that datum
    instead. ``penalty`` None applies the condition weakly
    (WEAK_INT_SURF); a float scales the same term as a strong penalty
    replacement (the SIC variant).
    """

    def __init__(self, dim: int, p_datum=None, transpose: bool = False,
                 penalty=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.p_datum = p_datum
        self.transpose = transpose
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        mu = prop(mat, "mu", sfv, params)
        if self.p_datum is None:
            press = sfv.val["pressure"][:, 0]
        else:
            pd = self.p_datum(sfv, mat, params) if callable(self.p_datum) \
                else self.p_datum
            press = as_field(pd, (nq,), sfv.x)
        gv = sfv.grad["velocity"]  # (nq, a, k) = dv_a/dx_k
        n = sfv.normal
        if self.transpose:
            # FLOW_GRADV_T: n_q mu dv_p/dx_q = mu (n . grad) v
            nT = mu * torch.einsum("qk,qak->qa", n, gv)
        else:
            # FLOW_GRADV: n_q mu grad_v[q][p] = n_q mu dv_q/dx_p (the
            # reference's grad_v[i][j] = dv_i/dx_j, mm_as_structs.h:1794):
            # with the symmetric-stress natural term it weakly enforces
            # mu dv_n/dx_t = 0, which leaves fully developed flow exact
            nT = mu * torch.einsum("qc,qca->qa", n, gv)
        nT = nT - press[:, None] * n
        phi = sfv.phi["velocity"]
        out = -torch.einsum("qa,qi->qai", nT, phi)
        if self.penalty is not None:
            out = self.penalty * out
        return out


class CoulombFriction(FaceKernel):
    """Coulomb sliding friction on the tangential rows of a solid/mesh
    displacement equation (small-strain stress at the face):

        t . TT . n = mu_f * fac * (n . TT . n) * (t . v)/|v|

    applied weakly as the natural tangential traction, its right-hand side
    computed from the current solution's normal stress (the reference
    replaces the rotated tangential row strongly; both reach the same
    traction balance). Pair with a normal Dirichlet/contact condition.
    ``var`` picks the displacement field; the stress uses the material
    keys of ``_small_strain_stress``. The sliding velocity is the
    variable's time derivative plus the optional ``slide_velocity``
    (constant/callable, for steady problems). ``acoustic_velocity``
    (constant or callable -> (nq,)) enables the FRICTION_ACOUSTIC
    reduction fac = (2/pi) asin(|v|/v_ac) for |v| < v_ac.
    """

    def __init__(self, dim: int, mu_f: float, var: str = MESH_VAR,
                 slide_velocity=None, acoustic_velocity=None):
        super().__init__(var, dim)
        self.dim = dim
        self.mu_f = mu_f
        self.slide_velocity = slide_velocity
        self.acoustic_velocity = acoustic_velocity

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        TT = _small_strain_stress(self, sfv, mat, params)
        n = sfv.normal
        nTT = torch.einsum("qk,qka->qa", n, TT)
        n_force = torch.einsum("qa,qa->q", nTT, n)

        v = sfv.dot[self.var]
        if self.slide_velocity is not None:
            sv = self.slide_velocity
            v = v + (sv(sfv, mat, params) if callable(sv)
                     else as_field(sv, (nq, self.dim), sfv.x))
        vmag = torch.sqrt(torch.einsum("qa,qa->q", v, v))
        # the reference drops the friction term at zero relative velocity
        moving = vmag > 1e-12
        safe = torch.where(moving, vmag, 1.0)
        mu_eff = torch.where(moving, torch.full_like(vmag, self.mu_f), 0.0)

        if self.acoustic_velocity is not None:
            av = self.acoustic_velocity
            vac = av(sfv, mat, params) if callable(av) else as_field(
                av, (nq,), sfv.x)
            ratio = _clip(vmag / torch.maximum(vac, vac.new_full((), 1e-30)),
                          0.0, 1.0)
            fac = torch.where(vac > vmag,
                              (2.0 / math.pi) * torch.arcsin(ratio), 1.0)
            mu_eff = mu_eff * fac

        phi = sfv.phi[self.var]
        out = 0.0
        for k in range(1 if self.dim == 2 else 2):
            t = _unit(sfv.tangents[:, :, k])
            t_velo = torch.einsum("qa,qa->q", t, v)
            # prescribed tangential traction g_t = mu_f fac (n.TT.n)(t.v)/|v|
            g_t = mu_eff * n_force * t_velo / safe
            out = out - torch.einsum("q,qa,qi->qai", g_t, t, phi)
        return out


class SlopeBC(FaceKernel):
    """SLOPE / SLOPEX / SLOPEY / SLOPEZ (``src/mm_fill_solid.c:1234
    slope_n_dot_n0_bc``): drive the deformed boundary parallel to the
    prescribed slope vector s, the condition n . s = 0 imposed on the mesh
    displacement rows (component ``comp`` = 0/1/2 for SLOPEX/Y/Z, or the
    normal-projected row for the rotated SLOPE card, ``comp=None``), as a
    penalty (the reference replaces the rotated row)."""

    def __init__(self, dim: int, slope, comp=None, var: str = MESH_VAR,
                 penalty: float = 1e4):
        super().__init__(var, dim)
        self.dim = dim
        self.slope = torch.as_tensor(slope, dtype=torch.float64)
        self.comp = comp
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        n = sfv.normal
        s = torch.einsum("qk,k->q", n, self.slope.to(n.dtype).to(n.device))
        phi = sfv.phi[self.var]
        if self.comp is None:
            d = n
        else:
            d = torch.stack([torch.ones_like(n[:, 0]) if c == self.comp
                             else torch.zeros_like(n[:, 0])
                             for c in range(n.shape[1])], dim=1)
        return self.penalty * torch.einsum("q,qa,qi->qai", s, d, phi)


class ForceSIC(FaceKernel):
    """FORCE_SIC / FORCE_USER_SIC (``src/mm_fill_solid.c:1283
    force_n_dot_f_bc`` with the sic flag): a strongly integrated force
    balance on a solid/mesh boundary, the computed small-strain traction
    equal to the prescribed (normal, tangential) force components:

        n.TT.n = f_n,   t_k.TT.n = f_t_k

    as penalties on the normal/tangent-projected displacement rows
    (``force`` = (f_n, f_t1[, f_t2]) constants or a callable -> (nq, dim)
    for the USER variant). The weak FORCE card is the plain Traction
    kernel; this variant pins the traction pointwise."""

    def __init__(self, dim: int, force, var: str = MESH_VAR,
                 penalty: float = 1e4):
        super().__init__(var, dim)
        self.dim = dim
        self.force = force
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        f = self.force(sfv, mat, params) if callable(self.force) else \
            as_field(self.force, (nq, self.dim), sfv.x)
        TT = _small_strain_stress(self, sfv, mat, params)
        n = sfv.normal
        nTT = torch.einsum("qk,qka->qa", n, TT)
        phi = sfv.phi[self.var]
        out = self.penalty * torch.einsum(
            "q,qa,qi->qai", torch.einsum("qa,qa->q", nTT, n) - f[:, 0], n, phi)
        for k in range(self.dim - 1):
            t = _unit(sfv.tangents[:, :, k])
            out = out + self.penalty * torch.einsum(
                "q,qa,qi->qai",
                torch.einsum("qa,qa->q", nTT, t) - f[:, 1 + k], t, phi)
        return out
