#!/usr/bin/env python3
"""Where the port's front-substitution kernel spends its time, phase by phase.

    python3 scripts/torch_trsv_phases.py [--upper] [--timeline]
                                         [--variant NAME ...]

Needs a CUDA device (H100) and nvcc. Builds an instrumented copy of
``goma_tpu_torch/csrc/batched_trsv.cu`` into ``goma_tpu_torch/_build/``:
lane 0 of the solver, first loader and first updater warps of block 0 reads
``clock64()`` at each phase boundary of every block of the sweep, keeps the
sums in registers and adds them to a device array at the end; they are read
back after the second of two launches per float32 shape: the top fronts of
the 64x64 cavity and 48x48 buoyant trees, (1, 323) and (1, 437), and the
deepest cavity level (218, 154). Prints, for the solver warp (the dependent
chain), the cycles it waits for the updaters' row sums and the loaders'
tiles, sets a block up, spends in the in-warp solve (with the cycles per
step) and in the store and publish; for the first loader, waiting for a
free ring slot against loading and staging; for the first updater, loads
started and waiting for x against FMAs against the butterfly and publish.
``--timeline`` also prints, block by block, when the solver's wait and
solve ended and when the block's tiles and row sums were published (cycles
from the kernel's start), which shows who waits for whom. The instrumented
build is for this breakdown only; its clock reads slow it slightly. The
lower sweep unless ``--upper``.

Variants (text substitutions in the copy, each printed as its own table;
their results may be wrong and only their cycles count):
  nowait   the solver does not wait for row sums or tiles
  spin     the loaders and the updaters poll without backing off
  volatile the counters read and written with volatile accesses, without
           acquire and release (no ordering promised)
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

PHASES = ("solver: wait for row sums and tiles", "solver: block set-up",
          "solver: in-warp solve", "solver: store + publish",
          "loader: wait for a slot", "loader: load + stage",
          "updater: loads started + wait for x", "updater: FMAs",
          "updater: butterfly + publish")
SHAPES = ((1, 323), (1, 437), (218, 154))
VARIANTS = {
    "nowait": [("        if (ok) break;\n", "        break;\n")],
    "volatile": [("st.release.cta.shared.u32", "st.volatile.shared.u32"),
                 ("ld.acquire.cta.shared.u32", "ld.volatile.shared.u32")],
    "spin": [("while (ld_acquire(p) <= v) __nanosleep(kBackoffNs);",
              "while (ld_acquire(p) <= v) {\n  }")],
}


def instrumented(variant):
    """The kernel source with phase counters (and the variant's edits)."""
    s = (cuda_build.CSRC / "batched_trsv.cu").read_text()

    def put(anchor, code, before=False):
        nonlocal s
        if s.count(anchor) != 1:
            raise RuntimeError(f"anchor not unique in batched_trsv.cu: {anchor!r}")
        s = s.replace(anchor, code + anchor if before else anchor + code)

    put("namespace {\n", "__device__ long long g_phase[16];\n"
        "__device__ long long g_time[6 * 40];\n"
        'extern "C" int read_phases(long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n}\n"
        'extern "C" int read_times(long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, g_time, sizeof(g_time));\n}\n",
        before=True)
    # block 0's timeline: when each block's wait and solve ended, when its
    # tiles and its row sums were published
    stamp = ("      if (blockIdx.x == 0 && lane == 0) g_time[%s * 40 + K] = "
             "clock64();\n")
    put("        if (ok) break;\n      }\n", stamp % "0")
    put("      if (valid) s_x[t] = T(xfin);\n", stamp % "1", before=True)
    put("      publish(s_ready + below, K + 1, lane);\n", stamp % "(2 + below)")
    put("      publish(s_flag + K, 1, lane);\n", stamp % "5")
    put("  if (tid < 2 + kNear + nblk) s_done[tid] = 0;\n  __syncthreads();\n",
        "  if (blockIdx.x == 0 && tid == 0) g_time[39] = clock64();\n")
    put("  if (tid < 2 + kNear + nblk) s_done[tid] = 0;\n  __syncthreads();\n",
        "  const bool kProf = blockIdx.x == 0 && lane == 0 && "
        "(warp <= 1 || warp == 2 + kNear);\n"
        "  long long ph[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long tick = clock64();\n"
        "#define PHASE(i) if (kProf) { const long long t_ = clock64(); "
        "ph[i] += t_ - tick; tick = t_; }\n")
    # the sums stay in registers and are written once, after the sweep
    put("  // x goes out in one pass of the whole CTA",
        "  if (kProf) {\n#pragma unroll\n    for (int i = 0; i < 9; ++i)\n"
        "      if (ph[i]) atomicAdd(reinterpret_cast<unsigned long long*>("
        "&g_phase[i]), static_cast<unsigned long long>(ph[i]));\n  }\n",
        before=True)
    put("      A base = bfirst[0];\n", "      PHASE(0)\n", before=True)
    put("      const A* S = s_tile + (K % kSlots) * kSlot;\n",
        "      PHASE(1)\n", before=True)
    put("      if (valid) s_x[t] = T(xfin);\n", "      PHASE(2)\n", before=True)
    put("      publish(s_done, K + 1, lane);\n", "      PHASE(3)\n")
    put("      A* tile = s_tile + (K % kSlots) * kSlot + below * kTile;\n",
        "      PHASE(4)\n", before=True)
    put("      publish(s_ready + below, K + 1, lane);\n", "      PHASE(5)\n")
    put("        const A xj = A(s_x[J * kNB + lane]);\n", "        PHASE(6)\n",
        before=True)
    put("      // transposing butterfly", "      PHASE(7)\n", before=True)
    put("      publish(s_flag + K, 1, lane);\n", "      PHASE(8)\n")
    for old, new in VARIANTS.get(variant, []):
        if s.count(old) != 1:
            raise RuntimeError(f"variant {variant}: anchor not unique: {old!r}")
        s = s.replace(old, new)
    return s


def build(variant):
    cuda_build.BUILD.mkdir(exist_ok=True)
    src = cuda_build.BUILD / f"trsv_phases_{variant}.cu"
    so = cuda_build.BUILD / f"libtrsv_phases_{variant}.so"
    src.write_text(instrumented(variant))
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_build.nvcc_path(), *flags, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(so))


def run(variant, lower, timeline):
    lib = build(variant)
    fn = lib.batched_trsv_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    counts = (ctypes.c_longlong * 16)()
    print(f"== variant {variant}: cycles of block 0 per launch, float32, "
          f"{'lower' if lower else 'upper'} sweep")
    for nn, m in SHAPES:
        rng = np.random.default_rng(m)
        A = rng.standard_normal((nn, m, m)) / m
        A[:, np.arange(m), np.arange(m)] += 2.0
        lu = torch.as_tensor(A, dtype=torch.float32, device="cuda")
        b = torch.as_tensor(rng.standard_normal((nn, m)), dtype=torch.float32,
                            device="cuda")
        out = torch.empty_like(b)
        stream = torch.cuda.current_stream().cuda_stream
        # one launch to warm the caches, the second is read
        for _ in range(2):
            lib.read_phases(counts)
            before = list(counts)
            err = fn(lu.data_ptr(), b.data_ptr(), out.data_ptr(), nn, m,
                     int(lower), stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        lib.read_phases(counts)
        d = [a - b_ for a, b_ in zip(counts, before)][:len(PHASES)]
        chain = sum(d[:4])
        print(f"({nn:3d},{m:3d}) solver warp {chain} cycles = {chain / m:.1f} a "
              f"step; in-warp solve {d[2] / m:.1f} cycles a step", flush=True)
        for group in (PHASES[:4], PHASES[4:6], PHASES[6:]):
            tot = sum(d[PHASES.index(p)] for p in group) or 1
            print("    " + ", ".join(
                f"{p} {d[PHASES.index(p)]} ({100 * d[PHASES.index(p)] / tot:.0f}%)"
                for p in group), flush=True)
        if timeline:
            times = (ctypes.c_longlong * 240)()
            lib.read_times(times)
            t0 = times[39]
            print("    block: wait ended, solve ended | tiles published (diagonal,"
                  " +1, +2) | row sums published  (cycles from the start)")
            for K in range(-(-m // 32)):
                row = [times[i * 40 + K] - t0 for i in range(6)]
                print(f"    {K:2d}: {row[0]:6d} {row[1]:6d} | {row[2]:6d} "
                      f"{row[3]:6d} {row[4]:6d} | "
                      + (f"{row[5]:6d}" if K > 2 else "     -"), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--upper", action="store_true",
                    help="the upper (backward) sweep instead of the lower")
    ap.add_argument("--timeline", action="store_true",
                    help="also print block 0's timeline, block by block")
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
        run(v, lower=not args.upper, timeline=args.timeline)


if __name__ == "__main__":
    main()
