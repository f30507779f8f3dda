"""Overset (fictitious-domain) fluid-structure coupling (counterpart of
``goma_tpu/physics/overset.py``).

Parity: reference ``src/bc_contact.c`` (``apply_contact_bc:79``), the
overlapping-grid contact method: Lagrange multipliers at the quadrature
points of a solid boundary tie the background-fluid velocity (interpolated
inside the fluid element each point lands in) to the boundary motion and
feed the reaction forces back to the fluid (LAGRANGE_NO_SLIP /
BAAIJENS_FLUID_SOLID), with the multipliers created as overlap augmenting
conditions (``src/mm_augc_util.c:2914 create_overlap_acs``).

As in goma_tpu the multipliers are ordinary P0 elemental dofs on an
immersed BAR block (``goma_tpu_torch.mesh.immersed``), the point location
is a host precomputation (centroid kd-tree + isoparametric inversion,
``Problem.add_overset``), and every coupling Jacobian block comes from one
``torch.func.jacfwd`` over the combined [bar dofs, fluid-element dofs]
vector of each quadrature point, summed into the CSR values.

Only the exterior of a closed immersed boundary is physical: the C0
background pressure cannot jump across the curve, so the fictitious
interior carries an artifact flow, as in the reference, where the
overlapping solid mesh owns that region. ``OversetNoSlip`` ties the fluid
to a prescribed boundary motion; ``OversetFSI`` couples it two ways to a
flexible solid (``Problem.add_overset(solid=...)``).
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation

LM_VAR = "lm"


class OversetLM(Equation):
    """Carrier equation for the Lagrange-multiplier variable on the
    immersed BAR block: one P0 multiplier vector per segment. Contributes
    nothing in the volume; the overset coupling fills the multiplier
    rows."""

    def __init__(self, dim: int):
        super().__init__(LM_VAR, dim, "P0")
        self.dim = dim

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        return fv.x.new_zeros((nq, self.ncomp, 1))


class OversetNoSlip:
    """LAGRANGE_NO_SLIP + BAAIJENS_FLUID_SOLID pair: at each immersed-curve
    quadrature point x_q,

        multiplier rows:     + w_q (u_f(x_q) - u_target(x_q, params))
        fluid velocity rows: + w_q lambda . phi_f(x_q)

    ``u_target(x (dim,), params) -> (dim,)`` is the prescribed boundary
    velocity (None: a stationary rigid wall)."""

    fluid_var = "velocity"

    def __init__(self, dim: int, u_target=None):
        self.dim = dim
        self.u_target = u_target

    def residual(self, ov, q_lam, params):
        """``ov``: the point's context (x, w, fluid values and bases);
        ``q_lam`` (dim,). Returns (r_lam (dim,), {var: (ncomp, nbf)})."""
        u_f = ov.vals[self.fluid_var]  # (dim,)
        if self.u_target is None:
            ut = torch.zeros_like(u_f)
        else:
            ut = torch.as_tensor(self.u_target(ov.x, params), dtype=u_f.dtype,
                                 device=u_f.device)
        r_lam = ov.w * (u_f - ut)
        phi = ov.phi[self.fluid_var]  # (nbf,)
        rf = {self.fluid_var: ov.w * q_lam[:, None] * phi[None, :]}
        return r_lam, rf


class OversetVars:
    """Fluid-side (and optionally solid-side) state at one immersed
    quadrature point."""

    def __init__(self):
        self.x = None  # (dim,)
        self.w = None  # scalar arc-length weight
        self.vals = {}  # fluid var -> (ncomp,)
        self.phi = {}  # fluid var -> (nbf,)
        self.vals_s = {}  # solid var -> (ncomp,)
        self.dots_s = {}  # solid var material time derivative -> (ncomp,)
        self.phi_s = {}  # solid var -> (nbf,)


class OversetFSI:
    """Two-way flexible-solid coupling (the BAAIJENS_SOLID_FLUID /
    BAAIJENS_FLUID_SOLID pair of src/bc_contact.c): at each immersed point,

        multiplier rows:   + w ( u_f(x_q) - d_dot_solid(x_q) )
        fluid rows:        + w lambda . phi_f     (reaction on the fluid)
        solid rows:        - w lambda . phi_s     (equal and opposite)

    Register with ``Problem.add_overset(..., solid=(solid_block, sideset))``
    where the bar block was built by ``attach_shell_block`` on that side
    set. ``solid_var``: the solid displacement variable whose material
    velocity the fluid must match."""

    fluid_var = "velocity"

    def __init__(self, dim: int, solid_var: str = "solid_displacement"):
        self.dim = dim
        self.solid_var = solid_var

    def residual(self, ov, q_lam, params):
        u_f = ov.vals[self.fluid_var]
        ddot = ov.dots_s[self.solid_var]  # (dim,) material velocity
        r_lam = ov.w * (u_f - ddot)
        phi_f = ov.phi[self.fluid_var]
        rf = {self.fluid_var: ov.w * q_lam[:, None] * phi_f[None, :]}
        phi_s = ov.phi_s[self.solid_var]
        rs = {self.solid_var: -ov.w * q_lam[:, None] * phi_s[None, :]}
        return r_lam, rf, rs
