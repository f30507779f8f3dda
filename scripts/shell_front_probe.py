#!/usr/bin/env python3
"""The front LU on the fronts of the 64x64 drying film (chip_smoke.py phase
49's deck, ``gmres+ndlu`` tree) at its initial state, once with the
steady Jacobian (ct = 0, a system no run factors) and once with the first
Crank-Nicolson step's (ct = 1 / (theta dt)). For every level it prints
the float32 kernel and its plain version (``batched_lu_reference``)
against the float64 plain version, the float64 kernel against it, the
growth max|LU| / max|A|, the smallest pivot relative to the front's
largest entry, the front and column where the float32 kernel is farthest
from float64, and whether two kernel runs agree bit for bit; then one JSON
line of the same numbers.

    python3 scripts/shell_front_probe.py

Needs one CUDA device and the kernels' build (nvcc, sm_90a).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def level_report(A, batched_lu, batched_lu_reference):
    """The numbers of one level's fully-summed blocks ``A`` (nn, s, s)."""
    k32 = batched_lu(A)
    k32b = batched_lu(A)
    t32 = batched_lu_reference(A)
    t64 = batched_lu_reference(A.double())
    k64 = batched_lu(A.double())
    sc = t64.abs().amax(dim=(1, 2))  # per front
    err = lambda X: ((X.double() - t64).abs().amax(dim=(1, 2)) / sc)  # noqa: E731
    ek32, et32, ek64 = err(k32), err(t32), err(k64)
    piv = t64.diagonal(dim1=1, dim2=2).abs().amin(dim=1)
    amax = A.double().abs().amax(dim=(1, 2))
    worst = int(torch.argmax(ek32 / torch.clamp_min(et32, 2.0 ** -24)))
    col = int(torch.argmax((k32[worst].double() - t64[worst]).abs().amax(dim=0)))
    return {"kernel32_vs_64": float(ek32.max()), "plain32_vs_64": float(et32.max()),
            "kernel64_vs_64": float(ek64.max()),
            "ratio_worst_front": float((ek32 / torch.clamp_min(et32, 2.0 ** -24)).max()),
            "worst_front": worst, "worst_column": col,
            "growth": float((sc / amax).max()),
            "min_pivot_rel": float((piv / amax).min()),
            "repeatable": bool(torch.equal(k32, k32b))}


def main() -> int:
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor

    from goma_tpu_torch import cuda_build
    from goma_tpu_torch.solvers import NewtonSolver
    from goma_tpu_torch.solvers.batched_lu import batched_lu, batched_lu_reference
    from scripts import shell_decks

    if not torch.cuda.is_available():
        raise SystemExit("shell_front_probe: needs a CUDA device")
    t0 = time.perf_counter()
    print(f"card: {cs.gpu_line()}", flush=True)
    with ThreadPoolExecutor(1) as pool:
        list(pool.map(cs.timed_build, ("batched_lu",)))
    cuda_build.load("batched_lu")
    dev = torch.device("cuda", 0)
    prob, x0 = cs.shell_setup("film", dev, cs.SHELL_REF["film"])
    solver = NewtonSolver(prob, cs.cavity_opts(tol=1e-9, max_iter=12))
    nd = solver.precond
    xt = torch.as_tensor(x0, dtype=prob.dtype, device=dev)
    out = {}
    ct = 1.0 / (0.5 * shell_decks.FILM_DT)
    for case, c in (("steady", 0.0), ("first_step", ct)):
        params = prob.base_params()
        params["ct"] = torch.tensor(c, dtype=prob.dtype, device=dev)
        params["hist"] = -params["ct"] * xt  # xdot = 0 at x0
        vals = solver._scaled_vals(xt, params,
                                   solver._prepare_fast32(xt, params)[2])
        vals_ext = nd.front_values(vals)
        S, rows = None, []
        for li, lev in enumerate(nd.levels):
            F = nd.front(li, vals_ext, S)
            rep = level_report(F[:, :lev.smax, :lev.smax].contiguous(),
                               batched_lu, batched_lu_reference)
            rep["level"] = [int(lev.nn), int(lev.smax)]
            rows.append(rep)
            print(f"{case} level {li} (nn={lev.nn:3d}, s={lev.smax:3d}): "
                  f"float32 kernel vs float64 {rep['kernel32_vs_64']:.2e}, "
                  f"plain {rep['plain32_vs_64']:.2e} (worst front "
                  f"{rep['worst_front']}, {rep['ratio_worst_front']:.1f}x the "
                  f"plain version's there, column {rep['worst_column']}); "
                  f"float64 kernel {rep['kernel64_vs_64']:.2e}; growth "
                  f"{rep['growth']:.2e}, min pivot / max|A| "
                  f"{rep['min_pivot_rel']:.2e}; repeatable "
                  f"{rep['repeatable']}", flush=True)
            _, S = nd.factor_level(li, F)
        out[case] = rows
    print(f"shell_front_probe: {time.perf_counter() - t0:.1f} s", flush=True)
    print(cs.gpu_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
