"""Batched dense unpivoted front LU (counterpart of
``goma_tpu/solvers/pallas_lu.py``).

``batched_lu`` factors every front of a (nn, m, m) batch into packed
unit-lower L and upper U, without row swaps, with a GESP static pivot
boost: tau = pivot_tol * max(max|diag(A0)|, 1e-30) from the ORIGINAL
diagonal; a pivot with |piv| < tau becomes -tau (piv < 0) or +tau
(otherwise), and the diagonal stores the boosted pivot. Row order comes
from the caller's saddle-last (``defer_dofs``) ordering.

- For a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/batched_lu.cu``, which replaces the TPU kernel
  ``goma_tpu/solvers/pallas_lu.py::_lu_kernel``. On the H100 the kernel is
  bound by the chain of m dependent column steps of each front, and on the
  top levels by having 1-8 fronts for 132 SMs. Its design: a blocked
  right-looking LU, each panel of ``nb`` columns factored in registers and
  shared memory by every CTA of a thread-block cluster of ``C`` CTAs per
  front, the trailing update split over the cluster in register tiles of
  full-precision FMA, one cluster barrier per panel. The kernel computes
  in float64: a float32 batch is promoted, factored and its packed LU
  rounded to float32 once, so the float32 factor is the float64 one's
  rounding (a float32 elimination in any update order lands 2x farther
  from it on fronts whose entries grow 100-700x). :func:`_plan` gives the
  launch plan; a launch the card refuses raises.
- For a CPU tensor it runs :func:`batched_lu_reference`, the plain PyTorch
  twin. Nothing on the CUDA path calls the twin; it is what the CPU tests
  hold against goma_tpu and what the GPU kernel is checked against.

``batched_lu.launches`` counts kernel launches (and nothing else), so a run
can show that its factorizations went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from goma_tpu_torch import cuda_build

_DTYPES = (torch.float32, torch.float64)
# mirrored from csrc/batched_lu.cu (float64 arithmetic for both dtypes):
# panel width, U12 columns staged at once, the card's SMs, the largest m
# and shared memory per CTA
_NB = 16
_UCOLS = 128
_SMS = 132
MAX_M = 1024
MAX_SMEM = 232448


def _plan(nn: int, m: int, dtype) -> tuple[int, int, int, int]:
    """The kernel's launch plan for nn fronts of size m of ``dtype`` (the
    same for float32 and float64: the kernel computes in float64): (cluster
    size C, panel width nb, threads per CTA, dynamic shared bytes per CTA).

    C is the largest of 16, 8, 4, 2 with nn * C <= 132 (so the clusters
    fill the SMs without a second wave), else 1, and 1 when the front is a
    single panel (m <= nb). Each thread holds two panel rows, except the
    first warp, which holds the nb pivot rows alone, so the block is the
    smallest of 128, 256, 512 threads with 2 * threads - 32 >= m (512
    threads up to m = 1024, the first warp then holding more). Shared
    memory: the panel (nb columns, odd leading dimension m | 1), the U12
    block (nb x 128), the panel's nb pivot rows, the boosted pivots, a
    reduction and a ready counter.
    ``csrc/batched_lu.cu::make_plan`` computes the same; ``kernel_plan``
    reads it back from the library."""
    if dtype not in _DTYPES:
        raise TypeError(f"batched_lu: dtype {dtype} (float32/float64 only)")
    nb = _NB
    threads = 128 if m <= 224 else (256 if m <= 480 else 512)
    cluster = 1
    if m > nb:
        cluster = next((c for c in (16, 8, 4, 2) if nn * c <= _SMS), 1)
    smem = 8 * (nb * ((m | 1) + _UCOLS + nb + 1) + 33)
    return cluster, nb, threads, smem


def kernel_plan(nn: int, m: int, dtype) -> tuple[int, int, int, int, int]:
    """The library's own plan for (nn, m, dtype), as :func:`_plan`, and
    the number of such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``). Needs the card."""
    if dtype not in _DTYPES:
        raise TypeError(f"batched_lu: dtype {dtype} (float32/float64 only)")
    fn = cuda_build.load("batched_lu").batched_lu_plan_f64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(nn, m, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"batched_lu plan query failed: cudaError {err}")
    return tuple(out)


def _kernel():
    """The C entry point (float64; builds the library on first use)."""
    fn = cuda_build.load("batched_lu").batched_lu_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_lu_reference(A, pivot_tol: float = 1e-8):
    """Plain PyTorch twin: a Python loop over k of the rank-1 updates,
    batched over fronts (goma_tpu's masked updates, written as slices)."""
    A = A.clone()
    nn, m, _ = A.shape
    dmax = torch.abs(torch.diagonal(A, dim1=1, dim2=2)).amax(dim=1)
    # a fill, not a copy from the host, so a CUDA graph can capture the twin
    tau = torch.full((), pivot_tol, dtype=A.dtype, device=A.device) * \
        torch.clamp(dmax, min=1e-30)
    for k in range(m):
        piv = A[:, k, k]
        piv = torch.where(torch.abs(piv) < tau,
                          torch.where(piv < 0, -tau, tau), piv)
        l = A[:, k + 1:, k] / piv[:, None]
        A[:, k + 1:, k + 1:] -= l[:, :, None] * A[:, k, None, k + 1:]
        A[:, k + 1:, k] = l
        A[:, k, k] = piv
    return A


def batched_lu(A, pivot_tol: float = 1e-8):
    """Unpivoted packed LU of a batch of square fronts, A: (nn, m, m)."""
    if A.device.type == "cpu":
        return batched_lu_reference(A, pivot_tol)
    if A.device.type != "cuda":
        raise ValueError(f"batched_lu: unsupported device {A.device}")
    if A.dtype not in _DTYPES:
        raise TypeError(f"batched_lu: dtype {A.dtype} (float32/float64 only)")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"batched_lu: expected (nn, m, m), got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("batched_lu: input must be contiguous")
    nn, m, _ = A.shape
    if m > MAX_M:
        raise ValueError(f"batched_lu: m = {m} > {MAX_M}")
    work = A.double()  # A itself when it is float64 (the kernel never writes it)
    out = torch.empty_like(work)
    fn = _kernel()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(work.data_ptr(), out.data_ptr(), nn, m, float(pivot_tol),
                 stream)
    if err != 0:
        raise RuntimeError(f"batched_lu kernel launch failed: cudaError {err}")
    batched_lu.launches += 1
    return out.to(A.dtype)


batched_lu.launches = 0
