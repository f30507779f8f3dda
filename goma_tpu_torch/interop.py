"""Carry state across from goma_tpu: its parameter dicts, state vectors and
NDLU factors, fetched to numpy, become the port's tensors, so both packages can compute
on the same state (the port's counterpart of loading weights).
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch import config

_KEYS = ("ct", "hist", "dirichlet_val", "time")


def params_from_numpy(params: dict, device=None, dtype=torch.float64) -> dict:
    """A goma_tpu ``Problem.base_params()`` dict (values as numpy arrays or
    scalars) -> the port's params on ``device``. goma_tpu's device tables
    (``_tables``) are dropped: the port's Problem builds its own."""
    dev = config.resolve_device(device)
    return {k: torch.as_tensor(np.asarray(params[k]), dtype=dtype, device=dev)
            for k in _KEYS}


def state_from_numpy(x, device=None, dtype=torch.float64) -> torch.Tensor:
    """A state vector (numpy or array-like) -> a tensor on ``device``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=config.resolve_device(device))


def ndlu_factors_from_numpy(facs, device=None) -> list:
    """goma_tpu ``NDLU.factor`` output, fetched to numpy (per level
    ``(fwd, bwd, perm, X, Y)``) -> the port's per-level ``(fwd, bwd, X, Y)``
    tensors for ``NDLU.solve`` / ``solve_refined`` (empty boundary blocks
    become None, as the port's ``factor_level`` returns them). Only
    unpivoted levels carry over (``perm is None``: goma_tpu's front kernel),
    the factorization the port's substitution reads."""
    dev = config.resolve_device(device)

    def put(a):
        return torch.as_tensor(np.array(a), device=dev)

    out = []
    for li, (fwd, bwd, perm, X, Y) in enumerate(facs):
        if perm is not None:
            raise ValueError(f"level {li}: pivoted factor (perm is not None); "
                             "the port substitutes only unpivoted fronts")
        empty = np.asarray(X).size == 0
        out.append((put(fwd), put(bwd), None if empty else put(X),
                    None if empty else put(Y)))
    return out
