"""Curve (shell) element endpoint conditions (counterpart of
``goma_tpu/bc/shell_end.py``).

Parity: the reference applies end conditions to 1D shell equations through
bar-endpoint conditions, the SHELL_GRAD_* family (``src/mm_shell_bc.c``,
``include/rf_bc_const.h:1108-1121``) and the special end forces of
``src/bc_special.c:77``. As in goma_tpu, a bar's endpoints are ordinary
point "faces" of the face-kernel machinery (``elements.shapes._bar_faces``):
a side set over (bar element, endpoint) pairs, a one-point unit-weight rule
and the signed unit tangent as the outward conormal
(``fem.assembly.eval_surfacevars``), so these kernels are plain
:class:`FaceKernel` s.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.physics.materials import as_field


class EndpointFlux(FaceKernel):
    """Specified outward flux at a curve endpoint, R_i += phi_i g (the
    SHELL_GRAD_*_NOBC analog): for a conservation law assembled as
    int flux . grad phi, flux . conormal = g instead of the natural zero.
    ``g``: a constant or callable(sfv, mat, params) -> (nq, ncomp)."""

    def __init__(self, var: str, g, ncomp: int = 1):
        super().__init__(var, ncomp)
        self.g = g

    def residual(self, sfv, mat, params):
        g = self.g(sfv, mat, params) if callable(self.g) else self.g
        g = as_field(g, (sfv.x.shape[0], self.ncomp), sfv.x)
        return torch.einsum("qc,qn->qcn", g, sfv.phi[self.var])


class EndpointAdvectiveOutflow(FaceKernel):
    """The open-outflow closure of advection at a curve endpoint: the
    boundary term of the integrated-by-parts advective flux, + phi_i
    (u . n_out) c with the interior trace of c. ``velocity``:
    callable(sfv, mat, params) -> (nq, dim) or a material key holding a
    (dim,) constant."""

    def __init__(self, var: str, velocity="wall_velocity", ncomp: int = 1):
        super().__init__(var, ncomp)
        self.velocity = velocity

    def residual(self, sfv, mat, params):
        v = self.velocity
        if isinstance(v, str):
            v = mat[v]
        u = v(sfv, mat, params) if callable(v) else as_field(v, sfv.x.shape, sfv.x)
        un = torch.einsum("qk,qk->q", u, sfv.normal)  # outward speed
        return torch.einsum("q,qc,qn->qcn", un, sfv.val[self.var],
                            sfv.phi[self.var])


def shell_end_sidesets(mesh, block_index: int, prefix: str = "end"):
    """One side set per free endpoint of an open BAR-block chain (a corner
    node used by exactly one bar of the block), registered as
    ``{prefix}_0``, ``{prefix}_1``, ... in ``mesh.sidesets`` ordered by x
    (then y). Returns their names."""
    from goma_tpu_torch.mesh.mesh import SideSet

    blk = mesh.blocks[block_index]
    off = mesh.block_elem_offset(block_index)
    corners = blk.conn[:, :2]  # BAR2/BAR3 corner nodes
    nodes, counts = np.unique(corners, return_counts=True)
    free = set(nodes[counts == 1].tolist())
    found = []  # (coord key, global elem id, local face id)
    for le in range(blk.n_elem):
        for f in range(2):
            n = int(corners[le, f])
            if n in free:
                found.append((tuple(mesh.coords[n]), off + le, f))
    found.sort(key=lambda t: t[0])
    names = []
    for i, (_, e, f) in enumerate(found):
        name = f"{prefix}_{i}"
        mesh.sidesets[name] = SideSet(elems=np.array([e], dtype=np.int32),
                                      faces=np.array([f], dtype=np.int32))
        names.append(name)
    return names
