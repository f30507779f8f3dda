#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 66 alone on the card (NDLU's pivoted front
LUs and GCRO-DR recycling), with what it needs of the earlier phases, and
the plain versions' CUDA graphs checked against eager calls.

    python3 scripts/pivoted_phases.py

Builds the three kernels; on the 64x64 cavity's tree, level by level,
holds each plain version (the front LU's and the substitution's, float32
and float64, lower and upper) replayed from its CUDA graph
(``chip_smoke.plain_call``) against an eager call, bit for bit, and prints
the eager, capture and replay times; then ``lu_shapes``,
``check_real_fronts`` and ``direct_tree_phase`` on that tree (timed), the
cavity's ``gmres+ndlu`` and ``tpu_direct`` solutions, phase 27's
two-level cavity, phase 45's cylinder and ``chip_smoke.pivoted_phases``.
Needs one CUDA device and nvcc (~1 min of command time on an H100).
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from goma_tpu_torch.solvers import NewtonSolver  # noqa: E402
from goma_tpu_torch.solvers.batched_lu import batched_lu_reference  # noqa: E402
from goma_tpu_torch.solvers.batched_trsv import batched_trsv_reference  # noqa: E402

t_all = time.perf_counter()
cs.log(cs.gpu_line())
cs.build_kernels()
dev = torch.device("cuda", 0)
prob = cs.cavity_problem(64, dev)
solver = NewtonSolver(prob, cs.cavity_opts())
nd = solver.precond
params = prob.base_params()
x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
vals = solver._scaled_vals(x0, params, solver._prepare_fast32(x0, params)[2])
# graph replay against eager, bit for bit, and their times
S = None
ve = nd.front_values(vals)
for li, lev in enumerate(nd.levels):
    F = nd.front(li, ve, S)
    A = F[:, :lev.smax, :lev.smax].contiguous()
    for dt in (torch.float32, torch.float64):
        Ad = A.to(dt)
        e, e_ms = cs.event_call(lambda: batched_lu_reference(Ad))
        t0 = time.perf_counter()
        g1, g1_ms = cs.plain_call(batched_lu_reference, Ad)
        cap_s = time.perf_counter() - t0
        g2, g2_ms = cs.plain_call(batched_lu_reference, Ad)
        cs.log(f"LU twin level {li} {dt}: eager {e_ms:.2f} ms, capture+replay "
               f"{cap_s * 1e3:.2f} ms, replay {g2_ms:.2f} ms; equal "
               f"{torch.equal(e, g1) and torch.equal(e, g2)}")
        if not (torch.equal(e, g1) and torch.equal(e, g2)):
            raise SystemExit("graph replay differs from the eager twin")
        lu = e
        for lower in (True, False):
            rhs = torch.randn(lev.nn, lev.smax, dtype=dt, device=dev)
            e, e_ms = cs.event_call(lambda: batched_trsv_reference(lu, rhs, lower))
            g, g_ms = cs.plain_call(batched_trsv_reference, lu, rhs, lower=lower)
            g, g_ms = cs.plain_call(batched_trsv_reference, lu, rhs, lower=lower)
            cs.log(f"trsv twin level {li} {dt} lower={lower}: eager {e_ms:.2f} "
                   f"ms, replay {g_ms:.2f} ms; equal {torch.equal(e, g)}")
            if not torch.equal(e, g):
                raise SystemExit("graph replay differs from the eager twin")
    _, S = nd.factor_level(li, F)
shapes = [(lev.nn, lev.smax) for lev in nd.levels]
t0 = time.perf_counter()
cs.lu_shapes(shapes, "cavity", time_twin=True)
cs.log(f"lu_shapes {time.perf_counter() - t0:.1f} s")
t0 = time.perf_counter()
cs.check_real_fronts(nd, vals, "x=0")
cs.log(f"check_real_fronts {time.perf_counter() - t0:.1f} s")
res = solver.solve(np.zeros(prob.dofmap.n_dof), params)
x = res.x
dsolver = NewtonSolver(prob, cs.direct_opts())
t0 = time.perf_counter()
cs.direct_tree_phase(prob, dsolver, "cavity tpu_direct")
cs.log(f"direct_tree_phase {time.perf_counter() - t0:.1f} s")
xd = dsolver.solve(np.zeros(prob.dofmap.n_dof), params).x
_, tl_lin = cs.twolevel_phase(prob, "cavity twolevel", "cavity", x,
                              cs.TWOLEVEL_X_TOL, relative=False)
og = cs.overset_phase(dev, "gmres+ndlu")
piv = cs.pivoted_phases(dev, prob, x, xd, (og.pop("prob"), og.pop("bi")),
                        (og["newton"], og["linear"]), tl_lin)
print({k: v["launches"] for k, v in piv.items()})
cs.log(f"pivoted_phases: {time.perf_counter() - t_all:.1f} s")
