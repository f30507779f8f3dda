"""Named fluid boundary conditions (counterpart of
``goma_tpu/bc/fluid.py``), cut to ``FlowPressure``.

Parity: FLOW_PRESSURE / FLOW_HYDROSTATIC of the reference's fluid-BC file
(``src/mm_ns_bc.c``, ``fflow_*``): a thin weak kernel whose Jacobian
blocks come from forward-mode AD of the face residual. The rest of
goma_tpu's file (slip laws, heat and mass fluxes, contact-line forces) is
a later slice of the port (ROADMAP Queue 1 item 7d).
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.physics.materials import as_field


class FlowPressure(FaceKernel):
    """FLOW_PRESSURE / FLOW_HYDROSTATIC (``src/mm_ns_bc.c``): open boundary
    with imposed normal traction sigma.n = -P n, P = p0 + rho g.(x - x0).
    Weak momentum term: + int phi P n dG (the boundary term of the
    divergence-form momentum equation with sigma.n replaced)."""

    def __init__(self, dim: int, p0=0.0, rho: float = 0.0, g=None, x0=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.p0 = p0
        self.rho = rho
        self.g = np.zeros(dim) if g is None else np.asarray(g, dtype=float)
        self.x0 = np.zeros(dim) if x0 is None else np.asarray(x0, dtype=float)

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        p0 = self.p0(sfv, mat, params) if callable(self.p0) else self.p0
        P = as_field(p0, (nq,), sfv.x)
        if self.rho:
            x0 = torch.as_tensor(self.x0, dtype=sfv.x.dtype, device=sfv.x.device)
            g = torch.as_tensor(self.g, dtype=sfv.x.dtype, device=sfv.x.device)
            P = P + self.rho * torch.einsum("qk,k->q", sfv.x - x0, g)
        phi = sfv.phi["velocity"]
        return torch.einsum("q,qa,qi->qai", P, sfv.normal, phi)
