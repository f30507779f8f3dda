"""Batched single-RHS triangular substitution against packed front LUs
(counterpart of ``goma_tpu/solvers/pallas_lu.py::batched_trsv``).

``batched_trsv(lu, b, lower)`` takes the packed L\\U of every front of a
batch, as ``batched_lu`` writes it (nn, m, m), and one right-hand side per
front (nn, m):

- ``lower=True``: y_k = b_k - sum_{j<k} L_kj y_j (unit-lower L);
- ``lower=False``: x_k = (b_k - sum_{j>k} U_kj x_j) / U_kk, k from m-1 down,
  dividing by the stored (boosted) pivots.

- For a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/batched_trsv.cu``, which replaces the TPU kernel
  ``goma_tpu/solvers/pallas_lu.py::_trsv_kernel``. On the H100 it is bound
  by latency: m dependent steps per front and about m^2/2 entries read.
  Its design: one CTA per front, the sweep cut into blocks of 32 rows; one
  warp solves each diagonal block in float64 registers, two steps per round
  of shuffle broadcasts (no block barrier), and also feeds the next two
  blocks' rows; three warps stage the tiles it needs into shared memory,
  and the other warps take the row sums against the columns three or more
  blocks back, read along the rows, ahead of the chain; the warps meet
  through release/acquire counters. Every sum is float64, for float32
  fronts too; a float64 front's solver sums are compensated (each rounding
  error carried beside the sum). :func:`_plan` gives the launch plan; a
  launch the card refuses raises.
- For a CPU tensor it runs :func:`batched_trsv_reference`, the plain
  PyTorch twin. Nothing on the CUDA path calls the twin.
  :func:`batched_trsv_blocked_reference` is plain PyTorch in the kernel's
  blocked order and precision (float64 sums, compensated for float64 fronts,
  near and far columns apart, reciprocal pivots), for the CPU tests;
  nothing on any path calls it.

``batched_trsv.launches`` counts kernel launches (and nothing else), so a
run can show that its substitutions went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from goma_tpu_torch import cuda_build

_FN = {torch.float32: "batched_trsv_f32", torch.float64: "batched_trsv_f64"}
_PLAN_FN = {torch.float32: "batched_trsv_plan_f32",
            torch.float64: "batched_trsv_plan_f64"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# mirrored from csrc/batched_trsv.cu: block width, float64 entries of one
# ring slot (three 32 x 33 tiles and 32 reciprocal pivots), ring depth, sync
# words, the largest m and the most shared memory a CTA can have
_NB = 32
_SLOT = 3 * _NB * (_NB + 1) + _NB
_SLOTS = 4
_SYNC = 4 + 32
MAX_M = 1024
MAX_SMEM = 232448

#: per dtype, the typed C entry point and the stream getter, resolved once
_ENTRY: dict = {}


def _plan(nn: int, m: int, dtype) -> tuple[int, int, int, int]:
    """The kernel's launch plan for nn fronts of size m: (cluster size,
    block width, threads per CTA, dynamic shared bytes per CTA).

    One CTA per front (cluster size 1: the chain runs in one warp, and the
    row sums already run ahead of it). Blocks of 32 rows. 192 threads (a
    solver, three loader and two updater warps) up to 8 blocks (m <= 256),
    320 threads (six updaters) beyond. Shared memory: per row a float64 row
    sum and x in the working dtype, both padded to whole blocks; a ring of 4
    slots of three float64 tiles; 36 sync words.
    ``csrc/batched_trsv.cu::make_plan`` computes the same; ``kernel_plan``
    reads it back from the library."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"batched_trsv: m={m} outside 1..{MAX_M}")
    mpad = -(-m // _NB) * _NB
    esize = torch.empty((), dtype=dtype).element_size()
    smem = 8 * mpad + 8 * _SLOTS * _SLOT + esize * mpad + 4 * _SYNC
    return 1, _NB, 192 if mpad <= 8 * _NB else 320, smem


def kernel_plan(nn: int, m: int, dtype) -> tuple[int, int, int, int, int]:
    """The library's own plan for (nn, m, dtype), as :func:`_plan`, and
    the number of such CTAs one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Needs the card."""
    fn = getattr(cuda_build.load("batched_trsv"), _PLAN_FN[dtype])
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(nn, m, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"batched_trsv plan query failed: cudaError {err}")
    return tuple(out)


def _current_stream(index: int) -> int:
    """The public route to a device index's current stream handle."""
    return torch.cuda.current_stream(index).cuda_stream


def _stream_getter():
    """The function that gives a device index's current stream handle:
    ``torch._C._cuda_getCurrentRawStream`` where this torch has it (a CUDA
    build does; it builds no ``torch.cuda.Stream`` object: 3 us less per
    call on the H100's host), else :func:`_current_stream`. Touches no
    device."""
    return getattr(torch._C, "_cuda_getCurrentRawStream", _current_stream)


def _kernel(dtype):
    """The C entry point for ``dtype`` and the stream getter: built,
    resolved and typed on first use, then taken from ``_ENTRY``."""
    entry = _ENTRY.get(dtype)
    if entry is None:
        fn = getattr(cuda_build.load("batched_trsv"), _FN[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        entry = _ENTRY[dtype] = (fn, _stream_getter())
    return entry


def batched_trsv_reference(lu, b, lower: bool = True):
    """Plain PyTorch twin: a Python loop over k of goma_tpu's row-dot step,
    batched over fronts."""
    m = lu.shape[-1]
    y = torch.zeros_like(b)
    for i in range(m):
        k = i if lower else m - 1 - i
        if lower:
            acc = torch.sum(lu[:, k, :k] * y[:, :k], dim=1)
        else:
            acc = torch.sum(lu[:, k, k + 1:] * y[:, k + 1:], dim=1)
        yk = b[:, k] - acc
        if not lower:
            yk = yk / lu[:, k, k]
        y[:, k] = yk
    return y


def _two_sum(a, b):
    """s = fl(a + b) and its rounding error: a + b = s + e exactly."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _two_prod(a, b):
    """p = fl(a * b) and its rounding error (Dekker's splitting; the kernel
    takes the error with one FMA)."""
    p = a * b

    def split(v):
        c = 134217729.0 * v  # 2^27 + 1
        hi = c - (c - v)
        return hi, v - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _mac_comp(hi, lo, a, b):
    """(hi, lo) += a * b, compensated: both rounding errors go to lo."""
    p, pe = _two_prod(a, b)
    hi, e = _two_sum(hi, p)
    return hi, lo + (e + pe)


def batched_trsv_blocked_reference(lu, b, lower: bool = True, block: int = 32,
                                   near: int = 2):
    """Plain PyTorch in the kernel's order and precision: the sweep in blocks
    of ``block`` rows (the last one ragged), every sum in float64. A block
    first takes its row sums against the far columns (those at least
    ``near`` + 1 blocks back, with x as the other warps see it: rounded to
    the working dtype), then against the ``near`` nearest blocks' columns
    (with the solver's unrounded float64 x), then the substitution inside
    the block; for float64 fronts those last two sums are compensated, a
    (hi, lo) pair per row, as the kernel's solver carries them. The upper
    sweep runs from the last block down and multiplies by the reciprocal of
    the stored pivot; float64 fronts add one Newton step on the quotient
    (the kernel fuses its two multiply-adds, this does not). The result is
    rounded to the working dtype once."""
    m = lu.shape[-1]
    newton = comp = lu.dtype == torch.float64
    # both sweeps in a logical index that counts from the end they start at
    M = (lu if lower else lu.flip(1, 2)).double()
    rhs = (b if lower else b.flip(1)).double()
    x = torch.zeros_like(rhs)      # as the solver carries it
    x_seen = torch.zeros_like(rhs)  # as it is published and written out
    for r0 in range(0, m, block):
        r1 = min(r0 + block, m)
        f1 = max(r0 - near * block, 0)
        far = rhs[:, r0:r1] - torch.einsum("nij,nj->ni", M[:, r0:r1, :f1],
                                           x_seen[:, :f1])
        if comp:
            acc, lo = far.clone(), torch.zeros_like(far)
            for j in range(f1, r0):
                acc, lo = _mac_comp(acc, lo, -M[:, r0:r1, j], x[:, j, None])
        else:
            acc = far - torch.einsum("nij,nj->ni", M[:, r0:r1, f1:r0],
                                     x[:, f1:r0])
        for k in range(r0, r1):
            xk = acc[:, k - r0] + lo[:, k - r0] if comp else acc[:, k - r0]
            if not lower:
                d = M[:, k, k]
                r = 1.0 / d
                v, xk = xk, xk * r
                if newton:
                    xk = xk + (v - d * xk) * r
            x[:, k] = xk
            if comp:
                acc[:, k + 1 - r0:], lo[:, k + 1 - r0:] = _mac_comp(
                    acc[:, k + 1 - r0:], lo[:, k + 1 - r0:],
                    -M[:, k + 1:r1, k], xk[:, None])
            else:
                acc[:, k + 1 - r0:] -= M[:, k + 1:r1, k] * xk[:, None]
        x_seen[:, r0:r1] = x[:, r0:r1].to(b.dtype).double()
    out = x_seen.to(b.dtype)
    return out if lower else out.flip(1)


def batched_trsv(lu, b, lower: bool = True):
    """Substitution of (nn, m) right-hand sides against (nn, m, m) packed
    LUs; returns (nn, m)."""
    if lu.ndim != 3 or lu.shape[1] != lu.shape[2] or b.shape != lu.shape[:2]:
        raise ValueError(f"batched_trsv: expected lu (nn, m, m) and b (nn, m), "
                         f"got {tuple(lu.shape)} and {tuple(b.shape)}")
    if lu.dtype not in _FN or b.dtype != lu.dtype:
        raise TypeError(f"batched_trsv: dtypes {lu.dtype}, {b.dtype} "
                        "(float32/float64, both the same)")
    dev = lu.device
    if dev != b.device:
        raise ValueError(f"batched_trsv: lu on {dev}, b on {b.device}")
    if dev.type == "cpu":
        return batched_trsv_reference(lu, b, lower)
    if dev.type != "cuda":
        raise ValueError(f"batched_trsv: unsupported device {dev}")
    if not (lu.is_contiguous() and b.is_contiguous()):
        raise ValueError("batched_trsv: inputs must be contiguous")
    nn, m, _ = lu.shape
    if m > MAX_M:
        raise ValueError(f"batched_trsv: m={m} > {MAX_M}")
    out = torch.empty_like(b)
    if nn == 0 or m == 0:
        return out
    fn, raw_stream = _kernel(lu.dtype)
    # the launch goes to the tensor's device: enter it only when another
    # device is current
    if dev.index == torch.cuda.current_device():
        err = fn(lu.data_ptr(), b.data_ptr(), out.data_ptr(), nn, m,
                 int(lower), raw_stream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(lu.data_ptr(), b.data_ptr(), out.data_ptr(), nn, m,
                     int(lower), raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"batched_trsv kernel launch failed: cudaError {err}")
    batched_trsv.launches += 1
    return out


batched_trsv.launches = 0
