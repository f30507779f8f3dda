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
  Its design answers correctness first: one CTA per front, one thread per
  row, a column sweep with one barrier per step, the finished entries in
  shared memory, the coefficients fetched ahead into registers,
  full-precision FMA (float32 fronts accumulate each row in float64, so the
  sequential sweep is at least as accurate as the twin's tree sums).
- For a CPU tensor it runs :func:`batched_trsv_reference`, the plain
  PyTorch twin. Nothing on the CUDA path calls the twin.

``batched_trsv.launches`` counts kernel launches (and nothing else), so a
run can show that its substitutions went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from goma_tpu_torch import cuda_build

_FN = {torch.float32: "batched_trsv_f32", torch.float64: "batched_trsv_f64"}
#: the kernel gives each row of a front its own thread
MAX_M = 1024


def _kernel(dtype):
    """The C entry point for ``dtype`` (builds the library on first use)."""
    fn = getattr(cuda_build.load("batched_trsv"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def batched_trsv(lu, b, lower: bool = True):
    """Substitution of (nn, m) right-hand sides against (nn, m, m) packed
    LUs; returns (nn, m)."""
    if lu.ndim != 3 or lu.shape[1] != lu.shape[2] or b.shape != lu.shape[:2]:
        raise ValueError(f"batched_trsv: expected lu (nn, m, m) and b (nn, m), "
                         f"got {tuple(lu.shape)} and {tuple(b.shape)}")
    if lu.dtype not in _FN or b.dtype != lu.dtype:
        raise TypeError(f"batched_trsv: dtypes {lu.dtype}, {b.dtype} "
                        "(float32/float64, both the same)")
    if lu.device != b.device:
        raise ValueError(f"batched_trsv: lu on {lu.device}, b on {b.device}")
    if lu.device.type == "cpu":
        return batched_trsv_reference(lu, b, lower)
    if lu.device.type != "cuda":
        raise ValueError(f"batched_trsv: unsupported device {lu.device}")
    if not (lu.is_contiguous() and b.is_contiguous()):
        raise ValueError("batched_trsv: inputs must be contiguous")
    nn, m, _ = lu.shape
    if m > MAX_M:
        raise ValueError(f"batched_trsv: m={m} > {MAX_M}")
    out = torch.empty_like(b)
    if nn == 0 or m == 0:
        return out
    fn = _kernel(lu.dtype)
    with torch.cuda.device(lu.device):
        stream = torch.cuda.current_stream(lu.device).cuda_stream
        err = fn(lu.data_ptr(), b.data_ptr(), out.data_ptr(), nn, m,
                 int(lower), stream)
    if err != 0:
        raise RuntimeError(f"batched_trsv kernel launch failed: cudaError {err}")
    batched_trsv.launches += 1
    return out


batched_trsv.launches = 0
