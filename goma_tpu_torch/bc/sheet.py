"""Tensioned-web (sheet) coating conditions and the shell-backed weak
mesh terms (counterpart of ``goma_tpu/bc/sheet.py``).

Parity targets:
- ``TENSION_SHEET`` (``sheet_tension``, ``src/mm_ns_bc.c:4579``): the
  membrane balance d/dS (T dY/dS) = n . Pi . n on the wall-normal mesh rows
  of a free web, assembled weakly as
  R_i = int [ T (dphi_i/dS)(dY/dS) + phi_i (n.Pi.n) ] dS, a penalty that
  dominates the mesh elasticity (the reference replaces the rows);
- ``SHEET_ENDSLOPE`` (``src/bc_special.c:222``): the natural end term of
  that operator, a point load T slope0 on the end node's mesh row
  (``add_sheet_end_slope``, through ``Problem.add_point_load``);
- SH_S11_WEAK/SH_S22_WEAK, SH_LUBP_SOLID, SH_SDET, SH_MESH2_WEAK and
  SHEAR_TO_SHELL (``src/mm_shell_bc.c``, ``src/mm_ns_bc.c:15431``).
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR


def _rows(row, comp, dim):
    """(nq, dim, nbf): ``row`` (nq, nbf) in component ``comp``, zeros in
    the others."""
    z = torch.zeros_like(row)
    return torch.stack([row if a == comp else z for a in range(dim)], dim=1)


class TensionSheet(FaceKernel):
    """TENSION_SHEET on a web side set (2D): the transverse (``normal_comp``)
    mesh displacement row carries the membrane balance. ``tension``: a
    constant or callable(sfv, mat, params) -> (nq,); ``load``: an extra
    normal traction, constant or callable; the fluid traction n.Pi.n joins
    when a velocity field is on the block (``include_fluid_stress``)."""

    def __init__(self, dim: int, tension, normal_comp: int = 1,
                 load=0.0, include_fluid_stress: bool = True,
                 penalty: float = 1e3):
        super().__init__(MESH_VAR, dim)
        self.dim = dim
        self.tension = tension
        self.nc = normal_comp
        self.load = load
        self.include_fluid_stress = include_fluid_stress
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        Tn = self.tension(sfv, mat, params) if callable(self.tension) else \
            torch.full_like(sfv.x[:, 0], float(self.tension))
        # the face tangent t (the outward normal turned by 90 degrees) on
        # the deformed geometry: dY/dS is its nc component, d()/dS = t . grad
        n = sfv.normal
        t = torch.stack([-n[:, 1], n[:, 0]], dim=1)
        dYdS = t[:, self.nc]
        dphidS = torch.einsum("qk,qik->qi", t, sfv.gphi[MESH_VAR])
        phi = sfv.phi[MESH_VAR]
        c = Tn[:, None] * dYdS[:, None] * dphidS
        HL = torch.zeros_like(sfv.x[:, 0])
        if self.include_fluid_stress and "velocity" in sfv.val:
            mu = mat.get("mu", 1.0)
            gu = sfv.grad["velocity"]
            p = sfv.val["pressure"][:, 0] if "pressure" in sfv.val else 0.0
            tau = mu * (gu + gu.transpose(1, 2))
            HL = HL + torch.einsum("qa,qab,qb->q", n, tau, n) - p
        ld = self.load(sfv, mat, params) if callable(self.load) else self.load
        c = self.penalty * (c - (HL + ld)[:, None] * phi)
        return _rows(c, self.nc, self.dim)


def add_sheet_end_slope(problem, nodeset, tension: float, slope0: float,
                        normal_comp: int = 1, sign: float = 1.0):
    """SHEET_ENDSLOPE: the natural end term T dY/dS of the
    integrated-by-parts TENSION_SHEET operator with the end slope pinned to
    the idler-roll tangent ``slope0`` (src/bc_special.c:222): the point
    load -sign T slope0 on the end node's transverse mesh row (sign +1 at
    the S-increasing end, -1 at the start)."""

    def f(q, X0, params):
        # over all mesh components; only the transverse row carries it
        e = (torch.arange(q.shape[0], device=q.device) == normal_comp).to(q.dtype)
        return e * (-sign * tension * slope0)

    problem.add_point_load(nodeset, MESH_VAR, f)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


class ShellTangentTraction(FaceKernel):
    """SH_S11_WEAK / SH_S22_WEAK (``src/mm_shell_bc.c:1520``): a weak
    traction projected on a shell tangent e (the first, S11, or the second,
    S22 in 3D), func = e . (tx, ty, tz), loading the tangent-direction mesh
    components."""

    def __init__(self, dim: int, traction, which: int = 0, var: str = None):
        super().__init__(var or MESH_VAR, dim)
        self.dim = dim
        self.traction = np.asarray(traction, dtype=float)
        self.which = which

    def residual(self, sfv, mat, params):
        t = _unit(sfv.tangents[:, :, min(self.which, sfv.tangents.shape[2] - 1)])
        T = torch.as_tensor(self.traction[: t.shape[1]], dtype=sfv.x.dtype,
                            device=sfv.x.device)
        s = torch.einsum("qk,k->q", t, T)
        return -torch.einsum("q,qa,qi->qai", s, t, sfv.phi[self.var])


class LubPressureLoad(FaceKernel):
    """SH_LUBP_SOLID / SH_LUBP_SOLID_RS (``src/mm_shell_bc.c``
    shell_lubr_solid_struct_bc): the lubrication pressure loading the
    adjoining structure as the normal traction -scale p_lub n on the
    displacement rows; the lub pressure reaches the loaded block through
    ``PassiveVar``."""

    def __init__(self, dim: int, scale: float = 1.0, var: str = None,
                 lub_var: str = "lub_pressure"):
        super().__init__(var or MESH_VAR, dim)
        self.dim = dim
        self.scale = scale
        self.lub_var = lub_var

    def residual(self, sfv, mat, params):
        p = sfv.val[self.lub_var][:, 0]
        return self.scale * torch.einsum("q,qa,qi->qai", p, sfv.normal,
                                         sfv.phi[self.var])


class SdetWeak(FaceKernel):
    """SH_SDET (``src/mm_shell_bc.c:3071``): the weak arc-length stiffness
    func = 1/2 detJ^2 on the first mesh rows of a shell-backed boundary,
    detJ the face's surface determinant (|dX/dxi| in 2D, |t0 x t1| in
    3D)."""

    def __init__(self, dim: int, factor: float = 1.0, var: str = None):
        super().__init__(var or MESH_VAR, dim)
        self.dim = dim
        self.factor = factor

    def residual(self, sfv, mat, params):
        T = sfv.tangents
        if T.shape[2] == 1:
            sdet = torch.linalg.vector_norm(T[:, :, 0], dim=1)
        else:
            sdet = torch.linalg.vector_norm(
                torch.linalg.cross(T[:, :, 0], T[:, :, 1], dim=1), dim=1)
        s = 0.5 * self.factor * sdet ** 2
        return _rows(s[:, None] * sfv.phi[self.var], 0, self.dim)


class ShMesh2Weak(FaceKernel):
    """SH_MESH2_WEAK (``src/mm_shell_bc.c:3139``): the weak prescribed-slope
    term func = -phi dy_ds on the second mesh rows."""

    def __init__(self, dim: int, dy_ds: float = 0.0, var: str = None):
        super().__init__(var or MESH_VAR, dim)
        self.dim = dim
        self.dy_ds = dy_ds

    def residual(self, sfv, mat, params):
        return _rows(-self.dy_ds * sfv.phi[self.var], 1, self.dim)


def bulk_shear_to_tension(scale: float = 1.0):
    """SHEAR_TO_SHELL (``src/mm_ns_bc.c:15431``): the bulk fluid shear
    t . Pi . n (Pi = -p I + mu (grad v + grad v^T)) loaded into the shell
    tension equation, through ``ShellGradBC("sh_tens",
    bulk_shear_to_tension(scale))`` on the bulk side set carrying the
    shell."""
    from goma_tpu_torch.physics.materials import prop

    def flux(sfv, mat, params):
        mu = prop(mat, "mu", sfv, params)
        gv = sfv.grad["velocity"]
        tau = mu * (gv + gv.transpose(1, 2))
        n = sfv.normal
        t = _unit(sfv.tangents[:, :, 0])
        Pin = torch.einsum("qab,qb->qa", tau, n)
        if "pressure" in sfv.val:
            Pin = Pin - sfv.val["pressure"][:, 0][:, None] * n
        return scale * torch.einsum("qa,qa->q", t, Pin)

    return flux
