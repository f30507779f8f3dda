"""Gather of CSR values into dense front slots (counterpart of
``scripts/attic/exp_front_gather.py::pallas_gather``, the TPU kernel that
goma_tpu's front-assembly experiment wrote as candidate "D").

``front_gather(v, g)`` returns ``out`` shaped like the int32 map ``g``
with ``out[i] = v[clip(g[i], 0, len(v) - 1)]``. ``NDLU.front`` calls it
with v = [0, CSR values] and g the level's dense slot map (CSR position + 1,
or 0 for an empty slot), so each front slot is one CSR entry or zero — the
same fronts as goma_tpu's compact scatter-set (``ndlu.py:605-607``), each
slot written once and no zero fill.

- For a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/front_gather.cu``: memory-bound (4 bytes of index read and one
  value written per slot, the values resident in L2), a grid-stride loop of
  16-byte index loads and vector stores, so ``g`` must be 16-byte aligned
  (any tensor of its own storage is; a slice may not be).
- For a CPU tensor it runs :func:`front_gather_reference`, the plain
  PyTorch version. Nothing on the CUDA path calls it.

``front_gather.launches`` counts kernel launches (and nothing else), so a
run can show that its front assembly went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from goma_tpu_torch import cuda_build

_FN = {torch.float32: "front_gather_f32", torch.float64: "front_gather_f64"}


def _kernel(dtype):
    """The C entry point for ``dtype`` (builds the library on first use)."""
    fn = getattr(cuda_build.load("front_gather"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def front_gather_reference(v, g):
    """Plain PyTorch version: an index with clipped positions."""
    return v[g.clamp(0, v.numel() - 1).long()]


def front_gather(v, g):
    """``v[clip(g, 0, len(v) - 1)]`` for 1-D float32/float64 ``v`` and an
    int32 map ``g`` of any shape; the result has ``g``'s shape."""
    if v.ndim != 1 or v.numel() == 0:
        raise ValueError(f"front_gather: v must be 1-D and non-empty, got "
                         f"{tuple(v.shape)}")
    if v.dtype not in _FN:
        raise TypeError(f"front_gather: v dtype {v.dtype} (float32/float64)")
    if g.dtype != torch.int32:
        raise TypeError(f"front_gather: g dtype {g.dtype} (int32)")
    if v.device != g.device:
        raise ValueError(f"front_gather: v on {v.device}, g on {g.device}")
    if not (v.is_contiguous() and g.is_contiguous()):
        raise ValueError("front_gather: inputs must be contiguous")
    if v.device.type == "cpu":
        return front_gather_reference(v, g)
    if v.device.type != "cuda":
        raise ValueError(f"front_gather: unsupported device {v.device}")
    out = torch.empty(g.shape, dtype=v.dtype, device=v.device)
    if g.numel() == 0:
        return out
    if (g.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("front_gather: g must be 16-byte aligned (the kernel "
                         "loads 4 indices at a time)")
    fn = _kernel(v.dtype)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(v.data_ptr(), v.numel(), g.data_ptr(), out.data_ptr(),
                 g.numel(), stream)
    if err != 0:
        raise RuntimeError(f"front_gather kernel launch failed: cudaError {err}")
    front_gather.launches += 1
    return out


front_gather.launches = 0
