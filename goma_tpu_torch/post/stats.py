"""Per-variable solution statistics (counterpart of
``goma_tpu/post/stats.py``; host numpy, a copy).

Parity: reference ``variable_stats`` (``src/rf_solve.c:3370``) — min / max /
mean (and L2) of every solution variable printed per step for observability.
"""

from __future__ import annotations

import numpy as np


def variable_stats(problem, x) -> dict:
    """{var: {"comp": c, "min", "max", "mean", "l2"}} over active dofs.
    ``x``: a host array or a tensor (fetched to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    dofmap = problem.dofmap
    out = {}
    for v in dofmap.vars:
        for c in range(v.ncomp):
            d = dofmap.dof_of_node_svar[:, dofmap.svar(v.name, c)]
            vals = x[d[d >= 0]]
            # elemental (P0/P1E) dofs aren't node-mapped; pull from gathers
            if vals.size == 0:
                parts = []
                for bd in dofmap.blocks:
                    if bd.has(v.name):
                        s = bd.slot(v.name)
                        if s.interp in ("P0", "P1E"):
                            parts.append(
                                x[bd.gather[:, s.start + c * s.nbf]])
                vals = np.concatenate(parts) if parts else vals
            if vals.size == 0:
                continue
            key = v.name if v.ncomp == 1 else f"{v.name}[{c}]"
            out[key] = {
                "min": float(vals.min()),
                "max": float(vals.max()),
                "mean": float(vals.mean()),
                "l2": float(np.linalg.norm(vals)),
            }
    return out


def format_stats(stats: dict) -> str:
    lines = [f"{'variable':<22}{'min':>13}{'max':>13}{'mean':>13}{'L2':>13}"]
    for k, s in stats.items():
        lines.append(f"{k:<22}{s['min']:>13.5g}{s['max']:>13.5g}"
                     f"{s['mean']:>13.5g}{s['l2']:>13.5g}")
    return "\n".join(lines)
