#!/usr/bin/env python3
"""Phases 60-62 of ``chip_smoke.py`` alone, on the card: phase 1's kernel
build, then ``chip_smoke.ls_phases`` (the laser melt pool, the wetting drop
and the small level-set and fluid-condition decks); with ``--phase44 N``
also phase 44 (the bifurcation and stability decks) N times.

    python3 scripts/ls_phases.py [--phase44 10] [--skip-ls]

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
    ap.add_argument("--phase44", type=int, default=0,
                    help="run phase 44 this many times after phases 60-62")
    ap.add_argument("--skip-ls", action="store_true",
                    help="run phase 44 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ls_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.log(f"card: {cs.gpu_line()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    dev = torch.device("cuda", 0)
    failed = 0
    if not args.skip_ls:
        cs.build_kernels()
        cs.ls_phases(dev)
    for k in range(args.phase44):
        try:
            cs.stability_phase(dev)
            cs.log(f"phase 44 run {k + 1}: passed")
        except RuntimeError as e:
            failed += 1
            cs.log(f"phase 44 run {k + 1}: FAILED: {e}")
    cs.log(f"ls_phases: {time.perf_counter() - t0:.1f} s, phase 44 failed "
           f"{failed} of {args.phase44} runs")
    print(cs.gpu_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
