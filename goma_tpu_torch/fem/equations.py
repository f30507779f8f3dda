"""Equation and face-kernel base classes (counterpart of
``goma_tpu/fem/equations.py``).

An Equation is bound to one variable (its Galerkin test space) and declares
the interpolation. ``residual`` returns the volume integrand per test
function, shape (nq, ncomp, nbf), which the assembler contracts with
``wdetJ``; the element Jacobian is ``torch.func.jacfwd`` of the whole
element residual (the reference's hand-coded ``lec->J`` sensitivities).
The Navier-Stokes Q2/Q1 Galerkin block skips this path: the assembler
recognizes it and runs the fused kernel of ``fem/fastns.py``.

A FaceKernel is a weak (integrated) boundary term on a side set; its
``residual`` returns the surface integrand (nq_f, ncomp, nbf), contracted
with the surface measure ``SurfaceVars.wdA``.
"""

from __future__ import annotations

from goma_tpu_torch.fem.fields import FieldVars


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


class FaceKernel:
    """Weak/integrated boundary term added on a side set.

    Parity: reference ``src/bc_integ.c:84 apply_integrated_bc`` — surface
    quadrature contributions into the parent element's equations. ``var``
    names the equation (test space) receiving the term.
    """

    var: str
    ncomp: int

    def __init__(self, var: str, ncomp: int):
        self.var = var
        self.ncomp = ncomp

    def residual(self, sfv: "SurfaceVars", mat: dict, params: dict):
        """Surface integrand (nq_f, ncomp, nbf), contracted with the
        surface measure weights."""
        raise NotImplementedError


class SurfaceVars(FieldVars):
    """FieldVars at face quadrature points, plus surface geometry.

    Attributes added: ``normal (nq, dim)`` outward unit normal,
    ``wdA (nq,)`` surface quadrature weight x surface Jacobian,
    ``tangents (nq, dim, dim-1)``.
    """

    def __init__(self):
        super().__init__()
        self.normal = None
        self.wdA = None
        self.tangents = None
