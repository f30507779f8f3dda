"""Global numeric configuration of the PyTorch port.

The reference (Goma) is double precision everywhere, and so is the port by
default (the JAX package's x64 test setup). Lower-precision pieces are
explicit per-object dtypes (``Problem.jacobian_dtype``, the NDLU factor
dtype), never a global switch.

Every object that owns device tensors takes a ``device`` argument and
:func:`resolve_device` turns it into a ``torch.device``. ``None`` means the
card (``cuda``): the port runs there unless the caller asks for the CPU
with ``device="cpu"``, as the CPU tests do. There is no fallback: without
CUDA, ``None`` and ``"cuda"`` raise.
"""

from __future__ import annotations

import torch

_FP_DTYPE = torch.float64


def set_fp_dtype(dtype) -> None:
    global _FP_DTYPE
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"working dtype must be float32 or float64, got {dtype}")
    _FP_DTYPE = dtype


def fp_dtype() -> torch.dtype:
    """Working floating dtype (float64 unless set otherwise)."""
    return _FP_DTYPE


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; otherwise the device asked for. CUDA on a
    machine without it raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
