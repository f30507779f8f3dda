#!/usr/bin/env python3
"""Phases 57-59 of ``chip_smoke.py`` alone, on the card: phase 1's kernel
build, then ``chip_smoke.closure_phases`` (the suspension channel, the
reacting wall channel and the small closure decks).

    python3 scripts/closure_phases.py

Needs a CUDA device and nvcc, as ``chip_smoke.py`` does.
"""

import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("closure_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.log(f"card: {cs.gpu_line()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    cs.build_kernels()
    cs.closure_phases(torch.device("cuda", 0))
    cs.log(f"closure_phases: {time.perf_counter() - t0:.1f} s")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
