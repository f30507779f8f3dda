#!/usr/bin/env python3
"""(GPU) The substitution kernel against ``torch.linalg.solve_triangular``
on single fronts, in a fresh process: device time per call by
torch.profiler (``chip_smoke.device_ms``, several sessions) and by CUDA-graph
replay (``chip_smoke.graph_ms``), for dense right-hand sides and for ones
whose leading or trailing rows are zero.

    python3 scripts/torch_trsv_library_probe.py [--m 323 437 512 604]
                                                [--sessions 4]

It tells a library time that a long run's profiler misreads from one the
library really takes: ``chip_smoke.py``'s substitution gate compares the two
by graph replay.
"""

import argparse
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[323, 437, 512, 604])
    ap.add_argument("--sessions", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_trsv_library_probe: needs a CUDA device")
    import chip_smoke as cs
    from goma_tpu_torch import cuda_build
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv

    cs.timed_build("batched_trsv")
    cuda_build.load("batched_trsv")
    print(f"{cs.gpu_line()}; torch {torch.__version__}", flush=True)

    def lib(lu, rhs, lower):
        return torch.linalg.solve_triangular(lu, rhs.unsqueeze(2),
                                             upper=not lower,
                                             unitriangular=lower)

    for m in args.m:
        g = torch.Generator(device="cuda").manual_seed(m)
        A = torch.randn(1, m, m, device="cuda", generator=g) / m ** 0.5
        A.diagonal(dim1=1, dim2=2).add_(4.0)
        b = torch.randn(1, m, device="cuda", generator=g)
        rhs = {"dense": b, "leading half zero": b.clone(),
               "trailing 90% zero": b.clone(), "zero": torch.zeros_like(b)}
        rhs["leading half zero"][:, :m // 2] = 0
        rhs["trailing 90% zero"][:, m // 10:] = 0
        for name, r in rhs.items():
            for lower in (True, False):
                k = [cs.device_ms(lambda: batched_trsv(A, r, lower), 5, 1,
                                  graph=True)[0]
                     for _ in range(args.sessions)]
                lb = [cs.device_ms(lambda: lib(A, r, lower), 5, graph=True)
                      for _ in range(args.sessions)]
                print(f"(1, {m}) {'lower' if lower else 'upper'}, {name} "
                      f"right-hand side: profiler ms kernel "
                      f"{min(k):.4f}-{max(k):.4f}, solve_triangular "
                      f"{min(v for v, _ in lb):.4f}-{max(v for v, _ in lb):.4f}"
                      f" ({lb[0][1]} kernels a call); graph replay kernel "
                      f"{cs.graph_ms(lambda: batched_trsv(A, r, lower)):.4f}, "
                      f"solve_triangular "
                      f"{cs.graph_ms(lambda: lib(A, r, lower)):.4f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
