#!/usr/bin/env python3
"""What one call of the port's substitution wrapper costs the host.

    python3 scripts/torch_trsv_host.py [--root CHECKOUT]

Needs a CUDA device (H100) and nvcc. Imports ``goma_tpu_torch`` from
``--root`` (default: the checkout this script lies in), so that two
checkouts can be held against each other in one job (run it once per
checkout, in turns). On synthetic float32 fronts at the 9 level shapes of
the 64x64 cavity tree (lower sweep down the levels, upper sweep back up: the
18 calls of one NDLU solve) it prints

- the host time of one ``batched_trsv`` call (5 x 3000 calls of the
  (8, 103) level, whose kernel is shorter than the call, so the launch queue
  never fills), and of its parts: ``torch.empty_like``, the current stream's
  handle by ``torch.cuda.current_stream`` and by the raw getter, three
  ``data_ptr`` calls;
- for the 18 calls back to back: median CUDA-event time, the profiler's
  device time, and (events - device) / 18, the host time per call that the
  kernels do not hide.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

LEVELS = ((218, 154), (128, 190), (64, 74), (32, 84), (16, 169), (8, 103),
          (4, 236), (2, 220), (1, 323))


def host_us(fn, n=3000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose goma_tpu_torch is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, args.root)
    from goma_tpu_torch.solvers.batched_trsv import batched_trsv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    calls = []
    for nn, m in LEVELS:
        rng = np.random.default_rng(m)
        A = rng.standard_normal((nn, m, m)) / m
        A[:, np.arange(m), np.arange(m)] += 2.0
        calls.append((torch.as_tensor(A, dtype=torch.float32, device="cuda"),
                      torch.as_tensor(rng.standard_normal((nn, m)),
                                      dtype=torch.float32, device="cuda"), True))
    calls += [(lu, b, False) for lu, b, _ in reversed(calls)]

    def run():
        return [batched_trsv(lu, b, lo) for lu, b, lo in calls]

    run()
    torch.cuda.synchronize()
    lu, b, _ = calls[5]
    dev = lu.device
    call = [host_us(lambda: batched_trsv(lu, b, True)) for _ in range(5)]
    parts = {
        "empty_like": host_us(lambda: torch.empty_like(b)),
        "current_stream().cuda_stream":
            host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw stream getter":
            host_us(lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        "3 x data_ptr": host_us(lambda: (lu.data_ptr(), b.data_ptr(),
                                         b.data_ptr())),
    }
    ev = []
    for _ in range(30):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        run()
        t1.record()
        t1.synchronize()
        ev.append(t0.elapsed_time(t1))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # one profiler window per solve's calls; the profiler at times loses the
    # first kernel record of a window, so a guard kernel goes first; a window
    # that still lacks a record is left out, never scaled
    guard = torch.zeros(1, device="cuda")
    full, counts = [], []
    while len(full) < 5 and len(counts) < 13:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            guard.add_(1.0)
            guard.add_(1.0)
            run()
            torch.cuda.synchronize()
        seen = [e.device_time_total for e in prof.events()
                if e.device_type == DeviceType.CUDA and "trsv" in e.name]
        counts.append(len(seen))
        if len(seen) == len(calls):
            full.append(sum(seen) / 1000.0)
    if len(full) < 5:
        raise SystemExit(f"the profiler gave {len(full)} complete windows of "
                         f"{len(calls)} kernel records, saw {counts}")
    dv = sum(full) / len(full)
    ev_ms = statistics.median(ev)
    print(f"{card}; {args.root}")
    print("host us per batched_trsv call (5 x 3000 calls): "
          + ", ".join(f"{x:.2f}" for x in call) + "; parts: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(f"18 calls back to back: events {ev_ms:.3f} ms, device {dv:.3f} ms "
          f"({len(full)} of {len(counts)} profiler windows complete), "
          f"(events - device) / 18 = {(ev_ms - dv) / 18 * 1e3:.1f} us")


if __name__ == "__main__":
    main()
