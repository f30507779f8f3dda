"""ALE mesh-motion equations (counterpart of
``goma_tpu/physics/mesh_motion.py``).

Parity: reference ``src/mm_fill_elliptic_mesh.c:63 assemble_elliptic_mesh``
(elliptic smoothing PDE) and the pseudo-solid ALE mesh equation
(``src/mm_fill_terms.c:109 assemble_mesh`` + ``belly_flop`` deformation
gradient, ``src/mm_fill_solid.c:77``). All three are total-Lagrangian:
integrals and gradients live in the *reference* configuration
(``fv.grad0`` / ``fv.wdetJ0``), so each sets ``measure = "reference"`` and
the assembler weights it by ``wdetJ0``.

The mesh-position sensitivities that the reference hand-codes through
``load_fv_mesh_derivs`` (src/load_field_variables.c:3754) arrive via AD:
every other equation's residual depends on x = X0 + d, so ``jacfwd``
produces the coupled Jacobian blocks. In axisymmetric coordinates the
pseudo-solid and linear-elastic equations gain their hoop terms, measured
on the reference configuration (r0 = X0[:, 1], guarded at the axis as
``fv.r`` is).
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.fem.fields import MESH_VAR, _guard_r
from goma_tpu_torch.physics.materials import prop
from goma_tpu_torch.utils.la import det_and_inv


class EllipticMesh(Equation):
    """Laplace smoothing of mesh displacement in the reference frame:
    int grad0(phi_i) : grad0(d)."""

    measure = "reference"

    def __init__(self, dim: int, interp: str = "Q2"):
        super().__init__(MESH_VAR, dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        gd = fv.grad0[MESH_VAR]  # (nq, dim, dim)
        gphi = fv.gphi0[MESH_VAR]  # (nq, nbf, dim)
        return torch.einsum("qak,qik->qai", gd, gphi)


class PseudoSolidMesh(Equation):
    """Compressible neo-Hookean pseudo-solid mesh equation (total
    Lagrangian): int grad0(phi) : P(F),  P = G (F - F^-T) + lam ln(det F) F^-T.

    Material keys: ``mesh_shear_modulus`` (G), ``mesh_lambda`` (lam).
    """

    measure = "reference"

    def __init__(self, dim: int, interp: str = "Q2"):
        super().__init__(MESH_VAR, dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        F = fv.F  # (nq, dim, dim)
        G = prop(mat, "mesh_shear_modulus", fv, params, 1.0)
        lam = prop(mat, "mesh_lambda", fv, params, 1.0)
        J, Finv = det_and_inv(F)
        axisym = fv.coord in ("cylindrical", "swirling") and F.shape[-1] == 2
        if axisym:
            # F_tt = r / r0 = 1 + d_r / r0; J3 = det(F2) F_tt, and P_tt
            # tests against phi / r0 on the r rows
            r0 = _guard_r(fv.X0[:, 1])
            Ftt = 1.0 + fv.val[MESH_VAR][:, 1] / r0
            J = J * Ftt
        FinvT = Finv.transpose(1, 2)
        P = G * (F - FinvT) + (lam * torch.log(J))[:, None, None] * FinvT
        out = torch.einsum("qak,qik->qai", P, fv.gphi0[MESH_VAR])
        if axisym:
            Ptt = G * (Ftt - 1.0 / Ftt) + lam * torch.log(J) / Ftt
            hoop = torch.einsum("q,qi->qi", Ptt / r0, fv.phi[MESH_VAR])
            out = out + torch.stack([torch.zeros_like(hoop), hoop], dim=1)
        return out


class LinearElasticMesh(Equation):
    """Small-strain linear elastic mesh motion (reference LINEAR model):
    int grad0(phi) : sigma,  sigma = 2 G eps(d) + lam tr(eps) I."""

    measure = "reference"

    def __init__(self, dim: int, interp: str = "Q2"):
        super().__init__(MESH_VAR, dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        G = prop(mat, "mesh_shear_modulus", fv, params, 1.0)
        lam = prop(mat, "mesh_lambda", fv, params, 1.0)
        gd = fv.grad0[MESH_VAR]
        eps = 0.5 * (gd + gd.transpose(1, 2))
        tr = torch.diagonal(eps, dim1=1, dim2=2).sum(dim=1)
        dim = eps.shape[-1]
        axisym = fv.coord in ("cylindrical", "swirling") and dim == 2
        if axisym:
            # the hoop strain eps_tt = d_r / r0 enters tr(eps) and adds the
            # sigma_tt (phi / r0) weak term on the r rows
            r0 = _guard_r(fv.X0[:, 1])
            eps_tt = fv.val[MESH_VAR][:, 1] / r0
            tr = tr + eps_tt
        eye = torch.eye(dim, dtype=gd.dtype, device=gd.device)
        sig = 2.0 * G * eps + lam * tr[:, None, None] * eye[None]
        out = torch.einsum("qak,qik->qai", sig, fv.gphi0[MESH_VAR])
        if axisym:
            sig_tt = 2.0 * G * eps_tt + lam * tr
            hoop = torch.einsum("q,qi->qi", sig_tt / r0, fv.phi[MESH_VAR])
            out = out + torch.stack([torch.zeros_like(hoop), hoop], dim=1)
        return out
