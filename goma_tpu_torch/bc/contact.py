"""Contact boundary conditions (counterpart of ``goma_tpu/bc/contact.py``).

Parity: reference ``src/bc_contact.c`` (``apply_contact_bc:79``).
``RigidContactPenalty`` is penalty contact of a deforming boundary against
a rigid analytic obstacle (die, roller or floor contact in coating decks;
the reference's CONTACT_SURF family against GEOM surfaces): the traction
t = k <-g(x_cur)>_+ n_obs pushes the surface back along the obstacle's
gradient, and forward-mode AD gives the exact contact stiffness.
``halfspace`` builds a planar obstacle. The two-mesh overset contact is
``Problem.add_overset(solid=...)`` with ``physics.overset.OversetFSI``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, vmap

from goma_tpu_torch.fem.equations import FaceKernel


class RigidContactPenalty(FaceKernel):
    """Penalty contact against a rigid obstacle g(x) >= 0 (g < 0 is
    penetration). ``var`` is the displacement variable carrying the
    boundary (solid_displacement or mesh_displacement); the current
    position is x_cur = X + d. ``grad_g``: an optional analytic gradient,
    else ``torch.func.grad`` of ``g``. ``g`` and ``grad_g`` take one
    point (dim,) and are mapped over the quadrature points."""

    def __init__(self, dim: int, g, k: float, var: str = "solid_displacement",
                 grad_g=None):
        super().__init__(var, dim)
        self.dim = dim
        self.g = g
        self.k = k
        self.grad_g = grad_g

    def _gap(self, x_cur):
        return vmap(lambda p: torch.as_tensor(self.g(p), dtype=p.dtype))(x_cur)

    def residual(self, sfv, mat, params):
        d = sfv.val[self.var]  # (nq, dim)
        x_cur = sfv.x + d
        gval = self._gap(x_cur)  # (nq,)
        if self.grad_g is not None:
            gg = vmap(lambda p: torch.as_tensor(self.grad_g(p),
                                                dtype=p.dtype))(x_cur)
        else:
            gg = vmap(grad(lambda p: self.g(p)))(x_cur)
        nrm = gg / torch.linalg.norm(gg, dim=1, keepdim=True)
        pen = torch.maximum(-gval, gval.new_zeros(()))  # penetration depth
        t = (self.k * pen)[:, None] * nrm  # push-back traction
        phi = sfv.phi[self.var]
        return -torch.einsum("qa,qi->qai", t, phi)

    def contact_pressure(self, sfv, mat, params):
        """Traction magnitude at the face quadrature points (post-proc)."""
        gval = self._gap(sfv.x + sfv.val[self.var])
        return self.k * torch.maximum(-gval, gval.new_zeros(()))


def halfspace(normal, offset: float = 0.0):
    """g(x) = n.x - c: admissible where n.x >= c (floor/wall obstacles)."""
    nrm = np.asarray(normal, dtype=float)
    nrm = nrm / np.linalg.norm(nrm)

    def g(x):
        return torch.dot(torch.as_tensor(nrm, dtype=x.dtype, device=x.device),
                         x) - offset

    return g
