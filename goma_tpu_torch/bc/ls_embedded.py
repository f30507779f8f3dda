"""Level-set wall conditions and the melt-front distinguishing condition
(counterpart of ``goma_tpu/bc/ls_embedded.py``).

Parity:

- ``LS_ATTACH`` (``src/bc_integ.c:549``; ``ls_attach_bc``,
  ``src/mm_ns_bc.c:308``): u.n - v_attach delta(F) (n_F . n_wall)^4 L = 0
  on the wall-normal momentum rows, L the face's length (the reference's
  2 sdet), as a penalty face kernel;
- ``LS_WALL_ANGLE`` (``src/bc_integ.c:555``; ``ls_wall_angle_bc``,
  ``src/mm_ns_bc.c:16273``): grad(F) . n_wall = cos(theta) on the fill
  rows;
- ``LS_CA_H`` (``src/bc_integ.c:1754``; ``boundary_curvature``,
  ``src/mm_fill_fill.c:3774``): the wall term of the curvature projection
  with a prescribed contact angle, +cos(CA);
- ``DISTNG / DXDISTNG / DYDISTNG / DZDISTNG`` (``src/bc_colloc.c:301``,
  ``fTmelting``): T - T_melt on a mesh-displacement row, through
  ``Problem.add_point_constraint`` (:func:`add_distng`).
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.physics.level_set import FILL_VAR, delta
from goma_tpu_torch.physics.materials import _floor


def _unit_floor(g):
    """g / max(|g|, 1e-30) (goma_tpu's ``jnp.maximum`` guard)."""
    return g / _floor(torch.linalg.norm(g, dim=1, keepdim=True), 1e-30)


class LSAttach(FaceKernel):
    """LS_ATTACH: penalty-strong u.n = v_attach delta(F) (n_F.n_w)^4 L on
    wall side sets; pulls the interface's contact line onto the wall."""

    def __init__(self, dim: int, v_attach: float, penalty: float = 1e6,
                 eps=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.v_attach = v_attach
        self.penalty = penalty
        self.eps = eps

    def residual(self, sfv, mat, params):
        eps = self.eps if self.eps is not None else params["ls_eps"]
        F = sfv.val[FILL_VAR][:, 0]
        nf = _unit_floor(sfv.grad[FILL_VAR][:, 0, :])
        nw = sfv.normal
        dot = torch.einsum("qk,qk->q", nf, nw)
        # the boundary length scale: the face measure summed over the face
        L = torch.sum(sfv.wdA) * torch.ones_like(F)
        un = torch.einsum("qk,qk->q", sfv.val["velocity"], nw)
        mis = un - self.v_attach * delta(F, eps) * dot ** 4 * L
        return self.penalty * torch.einsum("q,qa,qi->qai", mis, nw,
                                           sfv.phi["velocity"])


class LSWallAngle(FaceKernel):
    """LS_WALL_ANGLE: penalty-strong grad(F) . n_wall = cos(theta) on the
    fill rows (the raw gradient, exact for a signed-distance F;
    ``normalize`` divides by |grad F|)."""

    def __init__(self, angle_deg: float, penalty: float = 1e3,
                 normalize: bool = False):
        super().__init__(FILL_VAR, 1)
        self.cos_t = float(np.cos(np.deg2rad(angle_deg)))
        self.penalty = penalty
        self.normalize = normalize

    def residual(self, sfv, mat, params):
        gF = sfv.grad[FILL_VAR][:, 0, :]
        if self.normalize:
            gF = _unit_floor(gF)
        mis = torch.einsum("qk,qk->q", gF, sfv.normal) - self.cos_t
        return (self.penalty * mis[:, None] * sfv.phi[FILL_VAR])[:, None, :]


class LSCurvatureWallAngle(FaceKernel):
    """LS_CA_H: the wall term of the curvature projection with a
    prescribed contact angle, +cos(CA) in place of the natural
    -(n_F . n_wall) (register instead of ``LSCurvatureBoundary``)."""

    def __init__(self, angle_deg: float, var: str = "ls_curvature"):
        super().__init__(var, 1)
        self.var = var
        self.cos_ca = float(np.cos(np.deg2rad(angle_deg)))

    def residual(self, sfv, mat, params):
        c = self.cos_ca * torch.ones_like(sfv.val[self.var][:, 0])
        return (c[:, None] * sfv.phi[self.var])[:, None, :]


def melting_isotherm(T_melt: float, mesh_ncomp: int):
    """g(q, X, params) for the DISTNG family: q concatenates
    [mesh_displacement (mesh_ncomp,), temperature (1,)] at the node; the
    residual is T - T_melt (fTmelting, src/bc_colloc.c)."""

    def g(q, X, params):
        return q[mesh_ncomp] - T_melt

    return g


def add_distng(problem, nodes, T_melt: float, comp: int, dim: int):
    """DXDISTNG/DYDISTNG/DZDISTNG on ``nodes``: mesh-displacement row
    ``comp`` becomes T - T_melt = 0, so the mesh boundary tracks the
    melting isotherm (src/bc_colloc.c:301)."""
    problem.add_point_constraint(
        nodes, ["mesh_displacement", "temperature"], comp,
        melting_isotherm(T_melt, dim))
