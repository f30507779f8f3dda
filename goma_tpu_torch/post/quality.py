"""Element quality metrics + soft-failure detection (counterpart of
``goma_tpu/post/quality.py``).

Parity: reference ``src/el_quality.c:81 element_quality`` (jacobian metric)
and the negative-element-volume / zero-detJ detection inside assembly
(``src/mm_fill.c:267-283``) that drives the transient dt-halving ladder.

``make_quality_fn`` returns one device reduction over every element of the
(ALE-displaced) mesh: three 0-d tensors, read by the caller in one host
transfer. ``TransientSolver`` calls it after each accepted Newton solve
(``TimeOptions.quality_guard``) and treats min detJ <= 0 as a failed step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.utils.la import det_and_inv


@dataclass
class QualityReport:
    min_detJ: float
    max_detJ: float
    jac_quality: float  # min over elements of (min detJ / max detJ) per elem
    ok: bool


def make_quality_fn(problem):
    """f(x) -> (min_detJ, max_detJ, jac_quality), 0-d tensors on the
    problem's device, over the (possibly ALE-displaced) mesh; ``x`` a host
    vector or a tensor. The coordinate and basis tables go to the device
    once, here."""
    dtype, dev = problem.dtype, problem.device
    blocks = []
    for bd, blk, tables in zip(problem.dofmap.blocks, problem.mesh.blocks,
                               problem.tables):
        Xref = torch.as_tensor(problem.mesh.coords[blk.conn], dtype=dtype,
                               device=dev)
        dNg = torch.as_tensor(tables.dNg, dtype=dtype, device=dev)
        mesh_dofs = None
        if bd.has(MESH_VAR):
            s = bd.slot(MESH_VAR)
            # (ne, ncomp, nbf) dof ids of the displacement
            g = bd.gather[:, s.start:s.start + s.size].reshape(-1, s.ncomp,
                                                               s.nbf)
            mesh_dofs = torch.as_tensor(g.astype(np.int64), device=dev)
        blocks.append((Xref, dNg, mesh_dofs))

    def f(x):
        x = torch.as_tensor(x, device=dev).to(dtype)
        mins, maxs, quals = [], [], []
        for Xref, dNg, mesh_dofs in blocks:
            Xc = Xref if mesh_dofs is None else Xref + x[mesh_dofs].transpose(1, 2)
            det, _ = det_and_inv(torch.einsum("qnd,enk->eqkd", dNg, Xc))
            mins.append(det.min())
            maxs.append(det.max())
            q_elem = det.min(dim=1).values / torch.clamp(det.max(dim=1).values,
                                                         min=1e-300)
            quals.append(q_elem.min())
        return (torch.stack(mins).min(), torch.stack(maxs).max(),
                torch.stack(quals).min())

    return f


def element_quality(problem, x, min_quality: float = 0.0) -> QualityReport:
    mn, mx, q = torch.stack(make_quality_fn(problem)(x)).tolist()
    return QualityReport(mn, mx, q, ok=(mn > 0.0 and q > min_quality))
