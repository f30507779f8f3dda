#!/usr/bin/env python3
"""Where the port's front-LU kernel spends its time, phase by phase.

    python3 scripts/torch_lu_phases.py [--variant NAME ...]

Needs a CUDA device (H100) and nvcc. Builds an instrumented copy of
``goma_tpu_torch/csrc/batched_lu.cu`` into ``goma_tpu_torch/_build/``:
thread 0 of block 0 reads ``clock64()`` at each phase boundary of every
panel step (panel load, panel factor, panel store, U12 solve, trailing
update, cluster barrier, write-back) and the sums are read back after one
launch per float32 level shape of the 64x64 cavity and 48x48 buoyant
trees. Prints the cycles of each phase and the factor phase's cycles per
column. The instrumented build is for this breakdown only; its stores to
the counters slow it slightly.

Variants (text substitutions in the copy, each printed as its own table;
their results are wrong and only their cycles count):
  recip    one division per column step (l = v * (1 / piv))
  slot0    only slot 0 of each thread's panel rows is updated
  warp0    only warp 0 (the pivot rows) updates its panel rows
  nb16     float32 panel width 16 instead of 32
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from goma_tpu_torch import cuda_build  # noqa: E402

PHASES = ("load", "factor", "panel store", "U12", "trailing", "cluster sync",
          "write-back")
SHAPES = ((218, 154), (128, 190), (16, 169), (4, 236), (1, 323),
          (128, 256), (4, 345), (1, 437))
VARIANTS = {
    "recip": [("        if (ap < tau) piv = piv < T(0) ? -tau : tau;\n",
               "        if (ap < tau) piv = piv < T(0) ? -tau : tau;\n"
               "        const T rpiv = T(1) / piv;\n"),
              ("const T l = v[s][k] / piv;", "const T l = v[s][k] * rpiv;")],
    "slot0": [("          if (r > k && r < rows) {\n            const T l",
               "          if (s == 0 && r > k && r < rows) {\n            const T l")],
    "warp0": [("          if (r > k && r < rows) {\n            const T l",
               "          if (tid < 32 && r > k && r < rows) {\n            const T l")],
    "nb16": [("struct Cfg<float> {\n  static constexpr int NB = 32;",
              "struct Cfg<float> {\n  static constexpr int NB = 16;")],
}


def instrumented(variant):
    """The kernel source with phase counters (and the variant's edits)."""
    s = (cuda_build.CSRC / "batched_lu.cu").read_text()

    def put(anchor, code, before=False):
        nonlocal s
        if s.count(anchor) != 1:
            raise RuntimeError(f"anchor not unique in batched_lu.cu: {anchor!r}")
        s = s.replace(anchor, code + anchor if before else anchor + code)

    put("namespace {\n", "__device__ long long g_phase[8];\n"
        'extern "C" int read_phases(long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n}\n",
        before=True)
    put("  const T tau = pivot_tol * (mx > T(1e-30) ? mx : T(1e-30));\n",
        "  const bool kProf = blockIdx.x == 0 && tid == 0;\n"
        "  long long tick = clock64();\n"
        "#define PHASE(i) if (kProf) { const long long t = clock64(); "
        "g_phase[i] += t - tick; tick = t; }\n")
    put("    T v[kSlots][NB];\n", "    PHASE(0)\n", before=True)
    put("    // factored panel -> P", "    PHASE(1)\n", before=True)
    put("    // ---- 2. this CTA", "    PHASE(2)\n", before=True)
    put("        // A22 -= L21 U12", "        PHASE(3)\n", before=True)
    put("        __syncthreads();  // sU is rewritten by the next column block\n",
        "        PHASE(4)\n")
    put("    cluster.sync();\n", "    PHASE(5)\n")
    put("    __syncthreads();  // P is reloaded by the next panel\n",
        "    PHASE(6)\n")
    for old, new in VARIANTS.get(variant, []):
        if s.count(old) != 1:
            raise RuntimeError(f"variant {variant}: anchor not unique: {old!r}")
        s = s.replace(old, new)
    return s


def build(variant):
    cuda_build.BUILD.mkdir(exist_ok=True)
    src = cuda_build.BUILD / f"lu_phases_{variant}.cu"
    so = cuda_build.BUILD / f"liblu_phases_{variant}.so"
    src.write_text(instrumented(variant))
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_build.nvcc_path(), *flags, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(so))


def run(variant):
    lib = build(variant)
    fn = lib.batched_lu_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    counts = (ctypes.c_longlong * 8)()
    print(f"== variant {variant}: cycles of block 0 per launch, float32")
    for nn, m in SHAPES:
        rng = np.random.default_rng(m)
        A = rng.standard_normal((nn, m, m))
        A[:, np.arange(m), np.arange(m)] += 2.0 * m
        A = torch.as_tensor(A, dtype=torch.float32, device="cuda")
        out = torch.empty_like(A)
        lib.read_phases(counts)
        before = list(counts)
        err = fn(A.data_ptr(), out.data_ptr(), nn, m, 1e-8,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        lib.read_phases(counts)
        d = [a - b for a, b in zip(counts, before)][:len(PHASES)]
        tot = sum(d)
        print(f"({nn:3d},{m:3d}) total {tot} cycles; factor {d[1] / m:.0f} "
              "cycles a column; " + ", ".join(
                  f"{p} {x} ({100 * x / tot:.0f}%)" for p, x in zip(PHASES, d)),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", nargs="*", default=[],
                    choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip())
    for v in ["design"] + args.variant:
        run(v)


if __name__ == "__main__":
    main()
