"""Equation base class (counterpart of ``goma_tpu/fem/equations.py``).

An Equation is bound to one variable (its Galerkin test space) and declares
the interpolation. ``residual`` returns the volume integrand per test
function, shape (nq, ncomp, nbf), which the assembler contracts with
``wdetJ``; the element Jacobian is ``torch.func.jacfwd`` of the whole
element residual (the reference's hand-coded ``lec->J`` sensitivities).
The Navier-Stokes Q2/Q1 Galerkin block skips this path: the assembler
recognizes it and runs the fused kernel of ``fem/fastns.py``.
"""

from __future__ import annotations


class Equation:
    var: str
    ncomp: int
    interp: str
    # "current" -> integrand scaled by wdetJ (deformed measure);
    # "reference" -> wdetJ0 (total-Lagrangian equations: mesh, solid)
    measure: str = "current"

    def __init__(self, var: str, ncomp: int, interp: str):
        self.var = var
        self.ncomp = ncomp
        self.interp = interp

    def check_slice(self) -> None:
        """Raise ``NotImplementedError`` for options outside the ported
        slice (called at ``Problem.finalize`` for generic blocks)."""

    def residual(self, fv, mat: dict, params: dict):
        """Volume integrand (nq, ncomp, nbf) of the generic path."""
        raise NotImplementedError
