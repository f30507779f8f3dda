#!/usr/bin/env python3
"""Phases 54-56 of ``chip_smoke.py`` alone, on the card: phase 1's kernel
build, then ``chip_smoke.solid_phases`` (the FSI column, the Richards slab
and the small solid and porous decks); ``--q3`` adds phase 45's and phase
48's ``gmres+ndlu`` rungs (the immersed cylinder's and the bearing's
counts against goma_tpu's).

    python3 scripts/solid_phases.py [--q3]

Needs a CUDA device and nvcc, as ``chip_smoke.py`` does.
"""

import argparse
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--q3", action="store_true",
                    help="also phase 45's and phase 48's gmres+ndlu rungs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solid_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.log(f"card: {cs.gpu_line()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    cs.build_kernels()
    dev = torch.device("cuda", 0)
    cs.solid_phases(dev)
    if args.q3:
        cs.overset_phase(dev, "gmres+ndlu")
        cs.bearing_phase(dev, "gmres+ndlu")
    cs.log(f"solid_phases: {time.perf_counter() - t0:.1f} s")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
