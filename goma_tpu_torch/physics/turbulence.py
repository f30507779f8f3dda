"""Spalart-Allmaras RANS turbulence model (counterpart of
``goma_tpu/physics/turbulence.py``).

Parity: reference ``src/mm_fill_turbulent.c`` (``assemble_spalart_allmaras
:164``) with the wall distance of the k-d-tree helper
(``src/util/distance_helpers.cpp find_distances:106``), here an external
nodal field (``fv.ext["wall_distance"]``) computed on the host.

Standard SA (negative-branch-free, trip terms off):
  nu_t_dot + u.grad(nu_t) = cb1 S_tilde nu_t
      + (1/sigma)[ div((nu + nu_t) grad nu_t) + cb2 |grad nu_t|^2 ]
      - cw1 fw (nu_t/d)^2

The floors and the clip take ``jnp.maximum``'s and ``jnp.clip``'s
derivatives at a tie (half to each side; ``_floor``, ``_clip``): nu_t = 0
is a tie at every wall node and in a zero initial state.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.fluid import advective_velocity
from goma_tpu_torch.physics.materials import _clip, _floor

SA_VAR = "turb_nu"

CB1, CB2, SIGMA, KAPPA = 0.1355, 0.622, 2.0 / 3.0, 0.41
CW1 = CB1 / KAPPA**2 + (1 + CB2) / SIGMA
CW2, CW3, CV1 = 0.3, 2.0, 7.1


def fv1(chi):
    return chi**3 / (chi**3 + CV1**3)


class SATurbulentViscosity:
    """mu_eff = mu + rho * nu_t * fv1(chi) for the momentum equation."""

    def __init__(self, mu: float, rho: float = 1.0):
        self.mu, self.rho = mu, rho

    def __call__(self, fv, mat, params):
        nut = _floor(fv.val[SA_VAR][:, 0], 0.0)
        chi = self.rho * nut / self.mu
        return self.mu + self.rho * nut * fv1(chi)


class SpalartAllmaras(Equation):
    def __init__(self, nu: float, interp: str = "Q1", transient: bool = True,
                 supg: float = 0.5):
        super().__init__(SA_VAR, 1, interp)
        self.nu = nu
        self.transient = transient
        self.supg = supg

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        nut = fv.val[SA_VAR][:, 0]
        gnut = fv.grad[SA_VAR][:, 0, :]
        d = _floor(fv.ext["wall_distance"], 1e-10)

        # vorticity magnitude
        if "velocity" in fv.val:
            gu = fv.grad["velocity"]
            W = 0.5 * (gu - gu.transpose(1, 2))
            S = torch.sqrt(2.0 * torch.sum(W * W, dim=(1, 2)) + 1e-30)
            u = advective_velocity(fv)
        else:
            S = fv.x.new_zeros(nq)
            u = torch.zeros_like(fv.x)

        chi = nut / self.nu
        fv2 = 1.0 - chi / (1.0 + chi * fv1(chi))
        Stilde = S + nut / (KAPPA**2 * d**2) * fv2
        Stilde = torch.maximum(Stilde, 0.3 * S)  # standard robustness clip

        rr = _clip(nut / (_floor(Stilde, 1e-10) * KAPPA**2 * d**2), 0.0, 10.0)
        g = rr + CW2 * (rr**6 - rr)
        fw = g * ((1.0 + CW3**6) / (g**6 + CW3**6)) ** (1.0 / 6.0)

        adv = torch.einsum("qk,qk->q", u, gnut)
        if self.transient:
            adv = adv + fv.dot[SA_VAR][:, 0]
        prod = CB1 * Stilde * nut
        dest = CW1 * fw * (nut / d) ** 2
        cross = (CB2 / SIGMA) * torch.sum(gnut * gnut, dim=1)

        phi = fv.phi[SA_VAR]
        gphi = fv.gphi[SA_VAR]
        if self.supg > 0:
            u2 = torch.sum(u * u, dim=1)
            tau = (self.supg * fv.h_elem * torch.sqrt(u2 + 1e-30)
                   / (2.0 * u2 + 1e-12))
            w = phi + tau[:, None] * torch.einsum("qk,qik->qi", u, gphi)
        else:
            w = phi
        contrib = torch.einsum("q,qi->qi", adv - prod + dest - cross, w)
        # diffusion (Galerkin, no SUPG on the diffusive part)
        diff = ((self.nu + nut) / SIGMA)[:, None] * gnut
        contrib = contrib + torch.einsum("qk,qik->qi", diff, gphi)
        return contrib[:, None, :]


def wall_distance(mesh, wall_sidesets) -> np.ndarray:
    """Exact distance from every node to the wall side-set faces (host
    numpy; reference nanoflann k-d tree ``find_distances``). In 3D the
    distance to the faces' triangles is sampled on a barycentric grid and
    queried through scipy's ``cKDTree``."""
    from goma_tpu_torch.elements import element_type, faces as elem_faces

    segs = []
    for name in wall_sidesets:
        ss = mesh.sidesets[name]
        for e, f in zip(ss.elems, ss.faces):
            bi, le = mesh.global_elem_block(int(e))
            b = mesh.blocks[bi]
            et = element_type(b.elem_type)
            face = elem_faces(et.family)[int(f)]
            corners = b.conn[le, list(face.corner_nodes)]
            if mesh.dim == 2:
                segs.append(mesh.coords[corners[:2]])
            else:
                # triangulate the face fan-style
                c = mesh.coords[corners]
                for k in range(1, len(c) - 1):
                    segs.append(np.stack([c[0], c[k], c[k + 1]]))
    if mesh.dim == 2:
        segs = np.asarray(segs)  # (m, 2, 2)
        A, B = segs[:, 0], segs[:, 1]
        AB = B - A
        denom = np.maximum(np.sum(AB * AB, axis=1), 1e-30)
        P = mesh.coords
        AP = P[:, None, :] - A[None, :, :]
        t = np.clip(np.einsum("nmd,md->nm", AP, AB) / denom[None, :], 0, 1)
        proj = A[None] + t[:, :, None] * AB[None]
        return np.linalg.norm(P[:, None, :] - proj, axis=2).min(axis=1)
    tris = np.asarray(segs)  # (m, 3, 3)
    bary = []
    for a in np.linspace(0, 1, 5):
        for b in np.linspace(0, 1 - a, 5):
            bary.append([1 - a - b, a, b])
    bary = np.asarray([w for w in bary if w[0] >= -1e-12])
    pts = np.einsum("wk,mkd->mwd", bary, tris).reshape(-1, 3)
    from scipy.spatial import cKDTree

    return cKDTree(pts).query(mesh.coords)[0]
