"""Real-solid mechanics (TOTAL_ALE) and solid dynamics (counterpart of
``goma_tpu/physics/solid.py``).

Parity: reference ``src/mm_fill_rs.c`` (``assemble_real_solid:98``,
``solid_stress_tensor:824``), the TOTAL_ALE split where a *real solid*
displacement field carries the material stress while a separate
pseudo-solid mesh displacement smooths the grid, and the strain machinery
of ``src/mm_fill_solid.c`` (``belly_flop:77``). The stress follows
solid_stress_tensor:

    TT = lambda * volume_strain * I + 2 mu * strain
         - 2 mu * thermexp * (T - T_ref) * I        (thermoelastic)

with ``strain``/``volume_strain`` from the chosen constitutive model
(LINEAR small strain, or NONLINEAR Green-Lagrange / St. Venant-Kirchhoff).

As in goma_tpu, every sensitivity comes from forward-mode AD of the
residual (``torch.func.jacfwd`` in the assembly), and solid inertia is a
first-order velocity split (d_dot = v, rho v_dot = div P) integrated by the
theta scheme: for linear problems theta = 1/2 equals the reference's
Newmark (beta 1/4, gamma 1/2) path. The equations are total-Lagrangian
(``measure = "reference"``: ``fv.grad0``, ``fv.gphi0``, ``fv.wdetJ0``).

The TOTAL_ALE mesh<->solid tie (the mesh follows the solid at material
boundaries, the reference's KIN_DISPLACEMENT family) is a set of
multi-variable point constraints: see ``tie_mesh_to_solid``.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.physics.materials import as_field, prop

SOLID_VAR = "solid_displacement"


def _trace(a):
    return torch.diagonal(a, dim1=1, dim2=2).sum(dim=1)


class RealSolid(Equation):
    """Momentum balance of the real solid, total-Lagrangian weak form:

        int_O0 grad0(phi) : P  +  phi rho (v_dot - b)  dV0

    ``model``: 'linear' (engineering strain) or 'nonlinear'
    (Green-Lagrange strain E with second Piola S = lam tr(E) I + 2 mu E,
    first Piola P = F S). Material keys: ``lame_mu``, ``lame_lambda``,
    ``solid_rho``, optional ``solid_thermexp``/``solid_ref_temp`` (needs a
    temperature variable) and ``solid_body_force``.

    ``dynamic`` adds the inertia term tested against a solid velocity
    variable supplied by :class:`SolidKinematics`.
    """

    measure = "reference"

    def __init__(self, dim: int, interp: str = "Q2", model: str = "nonlinear",
                 dynamic: bool = False, var: str = SOLID_VAR,
                 vel_var: str = "solid_velocity"):
        super().__init__(var, dim, interp)
        self.dim = dim
        assert model in ("linear", "nonlinear")
        self.model = model
        self.dynamic = dynamic
        self.vel_var = vel_var

    def _thermal(self, fv, mat, params, mu):
        """The thermoelastic shift 2 mu a (T - T0) (nq,), or None."""
        if "temperature" not in fv.val or "solid_thermexp" not in mat:
            return None
        a = prop(mat, "solid_thermexp", fv, params)
        T0 = mat.get("solid_ref_temp", 0.0)
        return 2.0 * mu * a * (fv.val["temperature"][:, 0] - T0)

    def stress(self, fv, mat, params):
        """First Piola-Kirchhoff stress (nq, dim, dim)."""
        gd = fv.grad0[self.var]  # (nq, dim, dim): d d_a / d X0_k
        lam = prop(mat, "lame_lambda", fv, params, 1.0)
        mu = prop(mat, "lame_mu", fv, params, 1.0)
        eye = torch.eye(self.dim, dtype=gd.dtype, device=gd.device)[None]
        if self.model == "linear":
            eps = 0.5 * (gd + gd.transpose(1, 2))
            P = lam * _trace(eps)[:, None, None] * eye + 2.0 * mu * eps
            th = self._thermal(fv, mat, params, mu)
            return P if th is None else P - th[:, None, None] * eye
        F = eye + gd
        E = 0.5 * (torch.einsum("qka,qkb->qab", F, F) - eye)
        S = lam * _trace(E)[:, None, None] * eye + 2.0 * mu * E
        th = self._thermal(fv, mat, params, mu)
        if th is not None:
            S = S - th[:, None, None] * eye
        return torch.einsum("qak,qkb->qab", F, S)

    def residual(self, fv, mat, params):
        nq = fv.X0.shape[0]
        P = self.stress(fv, mat, params)
        gphi = fv.gphi0[self.var]  # (nq, nbf, dim)
        contrib = torch.einsum("qak,qik->qai", P, gphi)

        phi = fv.phi[self.var]
        if self.dynamic and self.vel_var in fv.dot:
            rho = prop(mat, "solid_rho", fv, params, 1.0)
            vdot = fv.dot[self.vel_var]  # (nq, dim)
            contrib = contrib + rho * torch.einsum("qa,qi->qai", vdot, phi)
        b = mat.get("solid_body_force", None)
        if b is not None:
            rho = prop(mat, "solid_rho", fv, params, 1.0)
            bval = b(fv, mat, params) if callable(b) else as_field(
                b, (nq, self.dim), fv.X0)
            contrib = contrib - rho * torch.einsum("qa,qi->qai", bval, phi)
        return contrib


class SolidKinematics(Equation):
    """d_dot = v tested with the velocity basis: int phi (d_dot - v) dV0.

    Together with RealSolid(dynamic=True) this forms the first-order system
    in place of the reference's Newmark-beta second-order integration."""

    measure = "reference"

    def __init__(self, dim: int, interp: str = "Q2",
                 var: str = "solid_velocity", disp_var: str = SOLID_VAR):
        super().__init__(var, dim, interp)
        self.dim = dim
        self.disp_var = disp_var

    def residual(self, fv, mat, params):
        ddot = fv.dot[self.disp_var]
        v = fv.val[self.var]
        phi = fv.phi[self.var]
        return torch.einsum("qa,qi->qai", ddot - v, phi)


class SolidTraction(FaceKernel):
    """Prescribed traction t on a boundary (the reference-configuration
    measure approximated by the current face measure, exact for small
    strain): -int phi t . e_a dA. ``traction``: (dim,) vector or
    callable(sfv) -> (nq, dim)."""

    def __init__(self, dim: int, traction, var: str = SOLID_VAR):
        super().__init__(var, dim)
        self.dim = dim
        self.traction = traction

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        t = self.traction
        tval = t(sfv, mat, params) if callable(t) else as_field(
            t, (nq, self.dim), sfv.x)
        phi = sfv.phi[self.var]
        return -torch.einsum("qa,qi->qai", tval, phi)


def tie_mesh_to_solid(problem, nodeset, dim: int,
                      mesh_var: str = "mesh_displacement",
                      solid_var: str = SOLID_VAR):
    """TOTAL_ALE tie: replace the mesh-equation rows on ``nodeset`` with the
    constraints d_mesh - d_solid = 0, so the grid follows the material at
    solid boundaries (the reference's KIN_DISPLACEMENT conditions of the
    TOTAL_ALE formulation, src/mm_fill_rs.c). Interior mesh nodes keep
    their smoothing equation."""
    for a in range(dim):
        def g(q, X0, params, a=a, dim=dim):
            # q = concat(mesh comps, solid comps)
            return q[a] - q[dim + a]

        problem.add_point_constraint(nodeset, [mesh_var, solid_var], a, g)


class FSIVelocityTie(FaceKernel):
    """FLUID_SOLID / FLUID_SOLID_RS side of the conforming fluid<->solid
    interface: the no-slip tie v = d_dot on the fluid momentum rows, as a
    penalty (the reference's row surgery in ``src/bc_colloc.c:537``). The
    solid velocity is the displacement's time derivative when ``solid_var``
    is registered on the fluid block (``PassiveVar``); absent (or steady)
    it ties v to zero."""

    def __init__(self, dim: int, solid_var: str = SOLID_VAR,
                 penalty: float = 1e6):
        super().__init__("velocity", dim)
        self.dim = dim
        self.solid_var = solid_var
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        v = sfv.val["velocity"]
        if self.solid_var in sfv.dot:
            v = v - sfv.dot[self.solid_var]
        phi = sfv.phi["velocity"]
        return self.penalty * torch.einsum("qa,qi->qai", v, phi)


def tie_fluid_solid(problem, interface_nodeset, dim: int,
                    solid_var: str = SOLID_VAR, v_wall=0.0):
    """Conforming fluid<->solid interface: SOLID_FLUID(_RS) +
    FLUID_SOLID(_RS) (``src/bc_colloc.c:537`` ``put_liquid_stress_in_solid``
    / ``put_liquid_stress_in_solid_ALE``). The fluid momentum rows at the
    shared interface nodes are injected into the solid displacement rows
    (the row sum is the interface traction balance), then REPLACED by the
    no-slip tie; the replacement comes after the injection, the order of
    the row surgery. The steady tie pins v = v_wall (a scalar or (dim,)
    constant); for a moving solid use the transient :class:`FSIVelocityTie`
    penalty on a separate side set instead (v = d_dot, no row
    replacement)."""
    vw = np.broadcast_to(np.asarray(v_wall, dtype=float), (dim,))
    for c in range(dim):
        problem.add_row_inject(interface_nodeset, "velocity", solid_var,
                               from_comp=c, to_comp=c, sign=1.0)
        problem.add_point_constraint(
            interface_nodeset, "velocity", c,
            (lambda c=c: lambda q, X0, params: q[c] - float(vw[c]))())


def von_mises_strain(fv, var: str = None, nonlinear: bool = False):
    """The reference's FAUX_PLASTICITY strain measure
    (``assemble_max_strain``, ``src/mm_fill_terms.c:11078``):
    vmE = (2/3) sqrt(3 II(E_dev)) = (2/3) sqrt(1.5 dev(E):dev(E)) of the
    (small or Green) strain of the displacement field ``var``.

    The ``1e-300`` under the root is goma_tpu's: a float64 floor that
    rounds to 0 in float32, where the root's derivative at zero strain is
    0 * inf = NaN in both packages."""
    from goma_tpu_torch.fem.fields import MESH_VAR

    v = var or (SOLID_VAR if SOLID_VAR in fv.grad else MESH_VAR)
    g = fv.grad[v]  # (nq, dim, dim)
    E = 0.5 * (g + g.transpose(1, 2))
    if nonlinear:
        E = E + 0.5 * torch.einsum("qka,qkb->qab", g, g)
    tr = _trace(E)
    d = g.shape[1]
    # the deviator in the FULL 3x3 sense (2D plane strain: E33 = 0, but the
    # trace split still uses /3, as calc_tensor_invariant)
    dev = E - (tr / 3.0)[:, None, None] * torch.eye(d, dtype=g.dtype,
                                                    device=g.device)
    dd = torch.einsum("qab,qab->q", dev, dev) + (tr / 3.0) ** 2 * (3 - d)
    return (2.0 / 3.0) * torch.sqrt(1.5 * dd + 1e-300)


class CurStrain(Equation):
    """R_CUR_STRAIN rows (``assemble_cur_strain``,
    ``src/mm_fill_terms.c:11278``): L2 projection of the current von Mises
    strain, R_i = phi_i (cs - vmE)."""

    def __init__(self, interp: str = "Q1", var: str = "cur_strain",
                 disp_var: str = None, nonlinear: bool = False):
        super().__init__(var, 1, interp)
        self.disp_var = disp_var
        self.nonlinear = nonlinear

    def residual(self, fv, mat, params):
        vm = von_mises_strain(fv, self.disp_var, self.nonlinear)
        phi = fv.phi[self.var]
        mis = fv.val[self.var][:, 0] - vm
        return (mis[:, None] * phi)[:, None, :]


class MaxStrain(Equation):
    """R_MAX_STRAIN rows (``assemble_max_strain``,
    ``src/mm_fill_terms.c:11078``): running maximum of the von Mises
    strain (the history variable of the FAUX_PLASTICITY modulus model),

        R_i = phi_i ( max(vmE, ms_old) - ms )

    ms_old is reconstructed as ms - dt * ms_dot: exact under backward Euler
    (the transient driver's xdot), first order otherwise. The maximum is
    ``torch.maximum``, whose derivative at a tie is half to each side, as
    ``jnp.maximum``'s."""

    def __init__(self, interp: str = "Q1", var: str = "max_strain",
                 disp_var: str = None, nonlinear: bool = False):
        super().__init__(var, 1, interp)
        self.disp_var = disp_var
        self.nonlinear = nonlinear

    def residual(self, fv, mat, params):
        vm = von_mises_strain(fv, self.disp_var, self.nonlinear)
        ms = fv.val[self.var][:, 0]
        dt = params.get("dt", 0.0)
        # a tensor dt (never 0-tested under vmap) gives ms_old = ms at 0
        ms_old = ms - dt * fv.dot[self.var][:, 0] if (
            torch.is_tensor(dt) or dt) else ms
        sel = torch.maximum(vm, ms_old)
        phi = fv.phi[self.var]
        return ((sel - ms)[:, None] * phi)[:, None, :]
