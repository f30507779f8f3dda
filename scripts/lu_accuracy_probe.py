#!/usr/bin/env python3
"""The front LU's float32 accuracy and time, this checkout's ``batched_lu``
beside another source of the kernel (``--other path/to/batched_lu.cu``, one
with the float32 entry point ``batched_lu_f32`` of the version that
eliminated float32 fronts in float32), on the real fronts of the 128x128
edge cavity and the 160x32 nodal waveguide (``chip_smoke.py`` phases
51-52; both device rungs' trees at x = 0) and on random boosted fronts at
the cavity's and those two trees' level shapes.

For every level of the real fronts it prints, for each kernel, the float32
factor's distance from the float64 plain version (max over the level's
fronts, relative to max |LU|), the float32 plain version's distance, their
ratio (``chip_smoke.py`` requires <= ``ACC_RATIO``) and whether two
launches agree bit for bit; for every shape the median CUDA-event ms of
each kernel. Then one JSON line of the same numbers.

    python3 scripts/lu_accuracy_probe.py --other old/batched_lu.cu

Needs one CUDA device and nvcc (sm_90a).
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def load_other(src: Path):
    """The C entry points of ``src`` built into the port's build directory
    under another name (the port's own NVCC_FLAGS)."""
    from goma_tpu_torch import cuda_build

    so = cuda_build.BUILD / "libbatched_lu_other.so"
    cuda_build.BUILD.mkdir(exist_ok=True)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(src)], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(str(so))
    fn = lib.batched_lu_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def other_lu(A, pivot_tol=1e-8):
        out = torch.empty_like(A)
        err = fn(A.data_ptr(), out.data_ptr(), A.shape[0], A.shape[1],
                 pivot_tol, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"other kernel: cudaError {err}")
        return out

    return other_lu


def level_numbers(A, kernels, reference):
    """Distances from float64 of each kernel and of the float32 plain
    version on one level's fronts ``A`` (nn, s, s), float32."""
    t64 = reference(A.double())
    sc = t64.abs().max()
    dist = lambda X: float((X.double() - t64).abs().max() / sc)  # noqa: E731
    plain = dist(reference(A))
    out = {"plain": plain}
    for name, lu in kernels.items():
        a, b = lu(A), lu(A)
        out[name] = {"dist": dist(a), "ratio": dist(a) / plain,
                     "repeatable": bool(torch.equal(a, b))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another batched_lu.cu")
    args = ap.parse_args()
    import chip_smoke as cs
    from goma_tpu_torch import cuda_build
    from goma_tpu_torch.solvers import NewtonSolver
    from goma_tpu_torch.solvers.batched_lu import (batched_lu,
                                                   batched_lu_reference)

    if not torch.cuda.is_available():
        raise SystemExit("lu_accuracy_probe: needs a CUDA device")
    t0 = time.perf_counter()
    print(f"card: {cs.gpu_line()}", flush=True)
    cuda_build.load("batched_lu")
    kernels = {"this": batched_lu, "other": load_other(Path(args.other))}
    dev = torch.device("cuda", 0)
    rec = {"levels": {}, "times": {}}
    for deck in ("cavity", "waveguide"):
        prob = cs.em_setup(deck, dev)
        x0 = torch.zeros(prob.dofmap.n_dof, dtype=prob.dtype, device=dev)
        params = prob.base_params()
        for kind in ("gmres+ndlu", "tpu_direct"):
            direct = kind == "tpu_direct"
            solver = NewtonSolver(prob, (cs.direct_opts if direct
                                         else cs.cavity_opts)(tol=1e-9,
                                                              max_iter=8))
            if direct:
                vals = solver._prepare(x0, params)[1]
                nd = solver._direct_ndlu(vals)
            else:
                vals = solver._scaled_vals(
                    x0, params, solver._prepare_fast32(x0, params)[2])
                nd = solver.precond
            vals_ext = nd.front_values(vals)
            S, rows = None, []
            for li, lev in enumerate(nd.levels):
                F = nd.front(li, vals_ext, S)
                A = F[:, :lev.smax, :lev.smax].contiguous()
                r = level_numbers(A, kernels, batched_lu_reference)
                r["level"] = [int(lev.nn), int(lev.smax)]
                rows.append(r)
                print(f"{deck} {kind} level {li} (nn={lev.nn:3d}, "
                      f"s={lev.smax:3d}): plain {r['plain']:.2e}; this "
                      f"{r['this']['dist']:.2e} ({r['this']['ratio']:.2f}x, "
                      f"repeatable {r['this']['repeatable']}); other "
                      f"{r['other']['dist']:.2e} ({r['other']['ratio']:.2f}x)",
                      flush=True)
                _, S = nd.factor_level(li, F)
            rec["levels"][f"{deck} {kind}"] = rows
            shapes = [(lev.nn, lev.smax) for lev in nd.levels]
            rec["times"].setdefault(deck, shapes)
        del prob
    # the level shapes of the earlier trees (chip_smoke's records)
    rec["times"].update({
        "cavity 64x64": [(218, 154), (128, 190), (64, 74), (32, 84),
                         (16, 169), (8, 103), (4, 236), (2, 220), (1, 323)]})
    tms = {}
    for tree, shapes in rec["times"].items():
        tot = {"this": 0.0, "other": 0.0}
        for nn, m in shapes:
            A = torch.as_tensor(cs.boosted_fronts(nn, m, seed=m),
                                dtype=torch.float32, device=dev)
            for _ in range(2):  # in turns: this, other, this, other
                for name, lu in kernels.items():
                    tot[name] += cs.median_ms(lambda: lu(A), 10) / 2
        tms[tree] = tot
        print(f"{tree}: {len(shapes)} shapes, float32 ms (sum of per-shape "
              f"medians, two turns averaged) this {tot['this']:.3f}, other "
              f"{tot['other']:.3f}", flush=True)
    rec["times"] = tms
    print(f"lu_accuracy_probe: {time.perf_counter() - t0:.1f} s", flush=True)
    print(cs.gpu_line())
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
