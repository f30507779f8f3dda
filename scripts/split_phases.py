#!/usr/bin/env python3
"""Phases 63-65 of ``chip_smoke.py`` alone, on the card: phase 1's kernel
build, then ``chip_smoke.split_phases`` (the projection cavity and the
three-matrix buoyant cavity on both rungs, the small derived-field,
particle, projection and segregated decks on cuda and cpu; no child
process: the CPU halves run here), with the new trees' kernels timed
(``chip_smoke.split_tree``: the front LU's level shapes against its plain
version, ``lu_factor_ex`` and the bound, the gather against
``index_select``, the substitutions against ``solve_triangular``), which
``chip_smoke.py`` itself leaves out for time.

    python3 scripts/split_phases.py

Needs a CUDA device and nvcc, as ``chip_smoke.py`` does.
"""

import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

PATHS = ("projection gmres+ndlu", "projection tpu_direct",
         "segregated gmres+ndlu", "segregated tpu_direct")


def main() -> int:
    if not torch.cuda.is_available():
        print("split_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.log(f"card: {cs.gpu_line()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    cs.build_kernels()
    recs = cs.split_phases(torch.device("cuda", 0), timed=True)
    # each new tree's kernel times (float32, ms; the substitution's one
    # solve by CUDA events and device time) beside the plain version's, the
    # library call's and the bound, and each main path's launches
    for path, rec in zip(PATHS, recs):
        cs.log(f"{path}: launches {rec['launches']}")
        for tree, t in rec["trees"].items():
            if "lu_ms" in t:
                k, p, lib = t["lu_ms"][torch.float32]
                g = t["g_times"]
                cs.log(f"{path} {tree}: front LU kernel {k:.4f} ms, plain "
                       f"{p:.3f}, lu_factor_ex {lib:.4f}, bound "
                       f"{t['lu_bound'][0]:.4f} ({t['lu_bound'][1]}); gather "
                       f"kernel {g['kernel'][0]:.3f} ms, plain "
                       f"{g['plain'][0]:.3f}, index_select "
                       f"{g['index_select'][0]:.3f}, bound "
                       f"{t['g_bound'][0]:.3f}")
            if "ms" in t.get("trsv", {}):
                k, p, lib = t["trsv"]["ms"][torch.float32]
                dv = t["trsv"]["device_ms"]
                cs.log(f"{path} {tree}: substitution kernel {k:.3f} ms "
                       f"({dv['kernel']:.3f} device), plain {p:.3f}, "
                       f"solve_triangular {lib:.3f} "
                       f"({dv['solve_triangular']:.3f} device), bound "
                       f"{t['bound'][0]:.4f} ({t['bound'][1]})")
    cs.log(f"split_phases: {time.perf_counter() - t0:.1f} s")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
