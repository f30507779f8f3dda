#!/usr/bin/env python3
"""The 96x48 immersed cylinder (chip_smoke.py phase 45's deck) on the
``gmres+ndlu`` options (``chip_smoke.cavity_opts(tol=1e-9, max_iter=10)``),
once for each variant named. It splits a Newton or GMRES count that
differs from goma_tpu's CPU record between the card's hand kernels, the
torch ops of the NDLU factor and apply, and the rest of the Newton step.
The deck is Stokes (linear), so the first Newton step's residual is the
first preconditioned GMRES iteration's: ||R||_inf after it measures the
first float32 NDLU factor on the initial residual.

Variants:
  cpu                   everything on the CPU (the kernels' plain versions)
  cuda                  everything on the card through the hand kernels
  cuda-plain-lu         on the card, the front LU's plain version
                        (``batched_lu_reference``) in place of the kernel
  cuda-plain-lu-gather  the same and the front gather's plain version
  cuda-host-factor      on the card, but each NDLU factor is computed on
                        the CPU (plain versions) and moved to the card,
                        where the apply runs
  cuda-host-ndlu        on the card, but the NDLU factor and apply both run
                        on the CPU
  cuda-ndlu64           on the card through the kernels, the NDLU factor
                        in float64 (``ndlu_dtype="float64"``)
  cuda-factor64-apply32 on the card through the kernels: each factor (the
                        front LU and the inverses + Schur) computed by a
                        float64 NDLU of the same tree, rounded to float32
                        once and applied by the rung's float32 NDLU
  cuda-factor32-apply64 the float32 factor of the rung, widened to float64
                        and applied by a float64 NDLU of the same tree

Prints each variant's Newton history, ||R||_inf after the first step, the
kernel launches it made, the drag and the seconds; then one JSON line of
the same numbers.

    python3 scripts/overset_probe.py --variant cpu cuda cuda-plain-lu

Needs the kernels' build (nvcc, sm_90a) for the cuda variants; ``cpu``
runs at the full size, ~20 s on 8 cores.
"""

import argparse
import contextlib
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

VARIANTS = ("cpu", "cuda", "cuda-plain-lu", "cuda-plain-lu-gather",
            "cuda-host-factor", "cuda-host-ndlu", "cuda-ndlu64",
            "cuda-factor64-apply32", "cuda-factor32-apply64")


@contextlib.contextmanager
def plain_kernels(names):
    """Swap the front LU ("lu") and the front gather ("gather") named for
    their plain versions, on every device, while the block runs."""
    lu = importlib.import_module("goma_tpu_torch.solvers.batched_lu")
    fg = importlib.import_module("goma_tpu_torch.solvers.front_gather")
    saved = lu.batched_lu, fg.front_gather
    if "lu" in names:
        lu.batched_lu = lu.batched_lu_reference
    if "gather" in names:
        fg.front_gather = fg.front_gather_reference
    try:
        yield
    finally:
        lu.batched_lu, fg.front_gather = saved


class HostNDLU:
    """The NDLU preconditioner of a solver on the card with its factor
    computed on the CPU by ``nd_cpu`` (the same pattern, so the same tree)
    and applied by the card's ``nd_card``, or with ``nd_card=None`` on the
    CPU too."""

    def __init__(self, nd_cpu, nd_card):
        self.nd_cpu, self.nd_card = nd_cpu, nd_card

    def factor(self, vals):
        facs = self.nd_cpu.factor(vals.cpu())
        if self.nd_card is None:
            return facs
        dev = self.nd_card.device
        return [tuple(None if t is None else t.to(dev) for t in f)
                for f in facs]

    def solve(self, facs, b):
        if self.nd_card is None:
            return self.nd_cpu.solve(facs, b.cpu()).to(b.device)
        return self.nd_card.solve(facs, b)


class SplitNDLU:
    """The NDLU preconditioner with its factor from ``nd_factor`` and its
    apply by ``nd_apply`` (the same pattern and ordering, so the same
    tree, at another dtype): each factor's floating tensors are cast once
    to the apply's dtype."""

    def __init__(self, nd_factor, nd_apply):
        self.nd_factor, self.nd_apply = nd_factor, nd_apply

    def factor(self, vals):
        facs = self.nd_factor.factor(vals.to(self.nd_factor.dtype))
        dt = self.nd_apply.dtype
        return [tuple(t.to(dt) if t is not None and t.is_floating_point()
                      else t for t in f) for f in facs]

    def solve(self, facs, b):
        return self.nd_apply.solve(facs, b.to(self.nd_apply.dtype)).to(b.dtype)


def run_variant(name, cache):
    """One Newton solve of the deck under ``name``; returns its record."""
    import chip_smoke as cs
    from goma_tpu_torch.solvers import NewtonSolver
    from goma_tpu_torch.solvers.ndlu import NDLU, node_clusters
    from goma_tpu_torch.solvers.twolevel import _saddle_mask

    dev = torch.device("cpu" if name == "cpu" else "cuda")
    if dev.type not in cache:
        cache[dev.type] = cs.overset_problem(cs.OVS_NX, cs.OVS_NY, cs.OVS_NSEG,
                                             dev)[:2]
    prob, bi = cache[dev.type]
    opts = cs.cavity_opts(tol=1e-9, max_iter=10)
    if name == "cuda-ndlu64":
        opts = dataclasses.replace(opts, ndlu_dtype="float64")
    solver = NewtonSolver(prob, opts)
    if name in ("cuda-host-factor", "cuda-host-ndlu"):
        nd_cpu = NDLU(prob.pattern, leaf_max=opts.ndlu_leaf_max,
                      dtype=torch.float32, defer_dofs=_saddle_mask(prob),
                      invert=True, clusters=node_clusters(prob),
                      device=torch.device("cpu"))
        solver.precond = HostNDLU(
            nd_cpu, solver.precond if name == "cuda-host-factor" else None)
    if name in ("cuda-factor64-apply32", "cuda-factor32-apply64"):
        nd64 = NDLU(prob.pattern, leaf_max=opts.ndlu_leaf_max,
                    dtype=torch.float64, defer_dofs=_saddle_mask(prob),
                    invert=True, clusters=node_clusters(prob),
                    device=torch.device("cuda"))
        solver.precond = (SplitNDLU(nd64, solver.precond)
                          if name == "cuda-factor64-apply32"
                          else SplitNDLU(solver.precond, nd64))
    plain = {"cuda-plain-lu": ("lu",),
             "cuda-plain-lu-gather": ("lu", "gather")}.get(name, ())
    cs.reset_counts()
    t0 = time.perf_counter()
    with plain_kernels(plain):
        res = solver.solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
    sec = time.perf_counter() - t0
    ln, _ = cs.read_counts()
    rec = {"variant": name, "newton": int(res.iters),
           "linear": [int(v) for v in res.linear_iters],
           "converged": bool(res.converged),
           "r_inf": [float(r[2]) for r in res.res_norms],
           "launches": ln, "drag": cs.overset_drag(prob, res.x, bi),
           "seconds": sec}
    print(f"{name}:\n{res.summary()}")
    print(f"{name}: Newton {rec['newton']}, linear {rec['linear']}, "
          f"||R||_inf after step 1 {rec['r_inf'][1]:.4e}, launches {ln}, "
          f"drag {rec['drag']:.12f}, {sec:.1f} s", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    args = ap.parse_args()
    import chip_smoke as cs

    cache = {}
    recs = [run_variant(v, cache) for v in args.variant]
    if any(v != "cpu" for v in args.variant):
        print(cs.gpu_line())
    print(json.dumps({"overset_probe": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
