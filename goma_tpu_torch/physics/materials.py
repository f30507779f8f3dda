"""Material property access (counterpart of ``goma_tpu/physics/materials.py``).

A property in a material dict is a python scalar (constant model) or a
callable ``f(fv, mat, params)`` evaluated at quadrature points; derivatives
come from AD (``torch.func.jacfwd`` of the element residual). This slice
carries ``prop``, ``shear_rate`` and the Boussinesq body force; the other
property models (viscosity laws, densities) are a later slice.
"""

from __future__ import annotations

import numpy as np
import torch


def prop(mat: dict, name: str, fv, params, default=None):
    """Evaluate a material property (scalar, or a callable model)."""
    v = mat.get(name, default)
    if v is None:
        raise KeyError(f"material property '{name}' missing")
    if callable(v):
        return v(fv, mat, params)
    return v


def shear_rate(fv, var: str = "velocity"):
    """Scalar shear rate sqrt(2 D:D), D = (grad u + grad u^T)/2."""
    g = fv.grad[var]  # (nq, dim, dim)
    D = 0.5 * (g + g.transpose(1, 2))
    return torch.sqrt(2.0 * torch.sum(D * D, dim=(1, 2)) + 1e-32)


class BoussinesqBodyForce:
    """f = g * (1 - beta (T - T0)); multiplied by rho in the momentum kernel.
    Reference: BOUSSINESQ in ``momentum_source_term``
    (src/mm_fill_momentum.c). ``gravity`` is kept as numpy and put on the
    temperature's device and dtype once per pair, so one material dict
    serves the float64 residual and the float32 Jacobian alike."""

    def __init__(self, gravity, beta: float, T0: float = 0.0,
                 tvar: str = "temperature"):
        self.gravity = np.array(gravity, dtype=np.float64)
        self.beta, self.T0, self.tvar = beta, T0, tvar
        self._g = {}

    def __call__(self, fv, mat, params):
        T = fv.val[self.tvar][:, 0]
        key = (T.dtype, T.device)
        if key not in self._g:
            self._g[key] = torch.as_tensor(self.gravity, dtype=T.dtype,
                                           device=T.device)
        return self._g[key][None, :] * (1.0 - self.beta * (T - self.T0))[:, None]
