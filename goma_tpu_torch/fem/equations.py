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
with the surface measure ``SurfaceVars.wdA``. An EdgeKernel is the same on
the 3D curve where two side sets meet (contracted with the arc-length
measure), an InterfaceKernel a two-sided term over paired faces of two
blocks (contracted with the A side's ``wdA``).
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


class EdgeKernel:
    """Weak/integrated term on a 3D edge curve, the intersection of two
    side sets (reference ``src/bc_curve.c:74 apply_integrated_curve_bc``,
    e.g. VELO_TANGENT_EDGE ``src/mm_ns_bc.c:1819``). ``residual(efv, mat,
    params)`` returns the line integrand (nq_e, ncomp, nbf) contracted with
    the arc-length measure ``efv.wds``; ``efv`` is an ``EdgeVars``
    (``goma_tpu_torch.bc.edge``) with the edge tangent and both faces'
    outward normals."""

    var: str
    ncomp: int

    def __init__(self, var: str, ncomp: int):
        self.var = var
        self.ncomp = ncomp

    def residual(self, efv, mat: dict, params: dict):
        raise NotImplementedError


class InterfaceKernel:
    """Cross-block interface term over paired faces (reference
    ``src/mm_interface.c`` interfacial sources between discontinuous
    variables; the two-sided Jacobian coupling mirrors
    ``lec->J_stress_neighbor``). ``residual`` returns contributions to BOTH
    sides' ``var`` equations, each (nq, ncomp, nbf_side), integrated with
    the A-side surface measure. ``sa.normal`` points out of side A (into
    B)."""

    var: str
    ncomp: int

    def __init__(self, var: str, ncomp: int):
        self.var = var
        self.ncomp = ncomp

    def residual(self, sa: "SurfaceVars", sb: "SurfaceVars", mat_a: dict,
                 mat_b: dict, params: dict):
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


class PassiveVar(Equation):
    """Register an existing variable on a block without adding physics
    (identically zero residual): the variable's values, gradients and basis
    become available to this block's kernels (goma_tpu's replacement for
    the reference's shell<->bulk "friend element" gather,
    ``src/mm_shell_util.c:1330 load_neighbor_var_data``). A tiny ``reg``
    (~1e-8) pins the dofs of nodes whose rows carry no other equation."""

    def __init__(self, var: str, ncomp: int, interp: str, reg: float = 0.0):
        super().__init__(var, ncomp, interp)
        self.reg = reg

    def residual(self, fv, mat, params):
        c = 0.0 * fv.val[self.var][:, :, None] * fv.phi[self.var][:, None, :]
        if self.reg:
            c = c + self.reg * fv.val[self.var][:, :, None] \
                * fv.phi[self.var][:, None, :]
        return c
