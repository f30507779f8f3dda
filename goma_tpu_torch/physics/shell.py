"""Shell equations on lower-dimension blocks: BAR curves in 2D meshes and
QUAD/TRI surfaces in 3D meshes (counterpart of
``goma_tpu/physics/shell.py``).

Parity: the reference shell family ``src/mm_fill_shell.c`` and its
shell-bulk "friend" coupling ``src/mm_shell_util.c``. As in goma_tpu, a
shell block is an ordinary block whose connectivity references the bulk's
boundary nodes, so a variable shared by the bulk and the shell couples
through the node-major dof map: the reference's cross-element gather
(``load_neighbor_var_data:1330``) is not needed. ``attach_shell_block``
builds such a block along a side set.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.physics.materials import as_field, prop


def _face_param_nodes(et, face_id: int):
    """Local nodes on a face with their face-chart coordinates (s[, t])."""
    from goma_tpu_torch.elements import faces as elem_faces
    from goma_tpu_torch.mesh.mesh import _ref_nodes

    face = elem_faces(et.family)[face_id]
    ref = _ref_nodes(et)
    p0, J = face.ref_origin, face.ref_jac
    out = []
    for i in range(et.n_nodes):
        d = ref[i] - p0
        coef, *_ = np.linalg.lstsq(J, d, rcond=None)
        if np.linalg.norm(d - J @ coef) < 1e-12:
            out.append((i, coef))
    return out


# shell element node layouts in the face chart, per (bulk family, n nodes)
_SHELL_TARGETS = {
    ("hex", 4): ("QUAD4", [(-1, -1), (1, -1), (1, 1), (-1, 1)]),
    ("hex", 8): ("QUAD8", [(-1, -1), (1, -1), (1, 1), (-1, 1),
                           (0, -1), (1, 0), (0, 1), (-1, 0)]),
    ("hex", 9): ("QUAD9", [(-1, -1), (1, -1), (1, 1), (-1, 1),
                           (0, -1), (1, 0), (0, 1), (-1, 0), (0, 0)]),
    ("tet", 3): ("TRI3", [(0, 0), (1, 0), (0, 1)]),
    ("tet", 6): ("TRI6", [(0, 0), (1, 0), (0, 1),
                          (0.5, 0), (0.5, 0.5), (0, 0.5)]),
}


def attach_shell_block(mesh, sideset: str, name: str = "shell") -> int:
    """Create a shell block along a side set's faces: BAR2/BAR3 on a 2D
    bulk, QUAD4/8/9 or TRI3/6 surface elements on a 3D bulk (reference
    BILINEAR/BIQUAD_SHELL, TRISHELL). The shell shares the bulk's boundary
    nodes. Returns the new block index."""
    from goma_tpu_torch.elements import element_type
    from goma_tpu_torch.mesh.mesh import Block, _face_all_nodes

    ss = mesh.sidesets[sideset]
    conn = []
    etname = None
    for e, f in zip(ss.elems, ss.faces):
        bi, le = mesh.global_elem_block(int(e))
        b = mesh.blocks[bi]
        et = element_type(b.elem_type)
        if et.dim == 2:
            nodes = _face_all_nodes(et, int(f))
            corners, mids = nodes[:2], nodes[2:]
            row = [b.conn[le, corners[0]], b.conn[le, corners[1]]]
            if mids:
                row.append(b.conn[le, mids[0]])
            etname = "BAR3" if mids else "BAR2"
        else:
            pn = _face_param_nodes(et, int(f))
            key = (et.family, len(pn))
            if key not in _SHELL_TARGETS:
                raise NotImplementedError(f"shell on {et.name} faces")
            etname, targets = _SHELL_TARGETS[key]
            row = []
            for tgt in targets:
                hit = min(pn, key=lambda ic: np.linalg.norm(ic[1] - np.asarray(tgt)))
                if np.linalg.norm(hit[1] - np.asarray(tgt)) > 1e-10:
                    raise RuntimeError("face chart mismatch building shell block")
                row.append(b.conn[le, hit[0]])
        conn.append(row)
    mesh.blocks.append(Block(name, etname, np.asarray(conn, dtype=np.int32)))
    return len(mesh.blocks) - 1


def _value(v, fv, mat, params, shape):
    """A material value (a constant, or a callable of (fv, mat, params))
    broadcast to ``shape`` at the field's dtype."""
    return as_field(v(fv, mat, params) if callable(v) else v, shape, fv.x)


class ShellConduction(Equation):
    """Surface conduction along the shell, int ks grad_s T . grad_s phi
    (Laplace-Beltrami weak form; reference shell energy,
    assemble_shell_energy). Surface gradients are tangent-plane vectors on
    curves and surfaces alike."""

    def __init__(self, ks: float, var: str = "temperature", interp: str = "Q2"):
        super().__init__(var, 1, interp)
        self.ks = ks

    def residual(self, fv, mat, params):
        gT = fv.grad[self.var][:, 0, :]
        gphi = fv.gphi[self.var]
        return (self.ks * torch.einsum("qk,qik->qi", gT, gphi))[:, None, :]


class SurfaceCharge(Equation):
    """R_SURF_CHARGE rows (``assemble_surface_charge``,
    ``src/mm_fill_shell.c:470``): surface charge qs transported along the
    shell by surface diffusion,

        R_i = phi_i dqs/dt + D_s grad_s qs . grad_s phi_i - phi_i src

    ``src`` (optional material key ``qs_source``, callable or constant) is
    the bulk normal-current drive n.J."""

    def __init__(self, surf_diff: float, var: str = "surface_charge",
                 interp: str = "Q1", transient: bool = True):
        super().__init__(var, 1, interp)
        self.Ds = surf_diff
        self.transient = transient

    def residual(self, fv, mat, params):
        gq = fv.grad[self.var][:, 0, :]
        gphi = fv.gphi[self.var]
        phi = fv.phi[self.var]
        c = self.Ds * torch.einsum("qk,qik->qi", gq, gphi)
        s = mat.get("qs_source", None)
        if s is not None:
            sv = s(fv, mat, params) if callable(s) else torch.full(
                (fv.x.shape[0],), float(s), dtype=fv.x.dtype, device=fv.x.device)
            c = c - sv[:, None] * phi
        if self.transient:
            c = c + fv.dot[self.var][:, 0][:, None] * phi
        return c[:, None, :]


class TensionedString(Equation):
    """Membrane/string deflection under transverse load, -T d2w/ds2 = q:
    int T grad_s w . grad_s phi - phi q (reference analog: structural
    shell tension, assemble_shell_tension)."""

    def __init__(self, tension: float, load, var: str = "shell_deflection",
                 interp: str = "Q2", transient: bool = False):
        super().__init__(var, 1, interp)
        self.T = tension
        self.load = load
        self.transient = transient

    def residual(self, fv, mat, params):
        gw = fv.grad[self.var][:, 0, :]
        gphi = fv.gphi[self.var]
        phi = fv.phi[self.var]
        q = _value(self.load, fv, mat, params, gw.shape[:1])
        c = self.T * torch.einsum("qk,qik->qi", gw, gphi) \
            - torch.einsum("q,qi->qi", q, phi)
        if self.transient:
            rho = prop(mat, "shell_rho", fv, params, 1.0)
            c = c + rho * torch.einsum("q,qi->qi", fv.dot[self.var][:, 0], phi)
        return c[:, None, :]


class ShellCurvature(Equation):
    """Structural-shell normal force balance (inextensible elastica),
    D K'' = K T + P, weak: -D ds(phi) ds(K) - (K T + P) phi (reference
    ``assemble_shell_structure``, src/mm_fill_shell.c:802). The pressure
    load P is the lubrication field when present (LUBP coupling), else the
    ``p_load`` material key."""

    def __init__(self, bend_stiffness: float, interp: str = "Q2"):
        super().__init__("sh_K", 1, interp)
        self.D = bend_stiffness

    def _p_load(self, fv, mat, params):
        if "lub_pressure" in fv.val:
            return fv.val["lub_pressure"][:, 0]
        return _value(mat.get("p_load", 0.0), fv, mat, params, fv.x.shape[:1])

    def residual(self, fv, mat, params):
        K = fv.val["sh_K"][:, 0]
        T = fv.val["sh_tens"][:, 0]
        dK = fv.grad_s["sh_K"][:, 0]
        P = self._p_load(fv, mat, params)
        phi = fv.phi["sh_K"]
        dphi = fv.dphi_ds["sh_K"]
        c = -self.D * dK[:, None] * dphi - (K * T + P)[:, None] * phi
        return c[:, None, :]


class ShellTension(Equation):
    """Structural-shell tangential balance ds(T) + D K ds(K) = 0 (reference
    R_SHELL_TENSION rows, src/mm_fill_shell.c:952)."""

    def __init__(self, bend_stiffness: float, interp: str = "Q2"):
        super().__init__("sh_tens", 1, interp)
        self.D = bend_stiffness

    def residual(self, fv, mat, params):
        K = fv.val["sh_K"][:, 0]
        dK = fv.grad_s["sh_K"][:, 0]
        dT = fv.grad_s["sh_tens"][:, 0]
        phi = fv.phi["sh_tens"]
        return ((dT + self.D * K * dK)[:, None] * phi)[:, None, :]


class BeamBending(Equation):
    """Euler-Bernoulli beam on a curve block with Hermite cubic (H3)
    elements, EI w'''' - T w'' = q, weak form int EI w'' phi'' + T w' phi'
    - q phi ds. The C1 basis (reference I_H3) carries value and arc-slope
    dofs per node: ncomp 2, comp 0 the value and comp 1 the slope, each
    constrained on its own for clamped or pinned supports."""

    def __init__(self, EI: float, load=0.0, tension: float = 0.0,
                 var: str = "beam_w"):
        super().__init__(var, 2, "H3")
        self.EI = EI
        self.load = load
        self.tension = tension

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        w2 = fv.d2s[self.var][:, 0]
        phi = fv.phi[self.var]  # (nq, 4)
        d2phi = fv.d2phi_ds2[self.var]
        q = _value(self.load, fv, mat, params, (nq,))
        c = self.EI * w2[:, None] * d2phi - q[:, None] * phi
        if self.tension:
            w1 = fv.grad_s[self.var][:, 0]
            c = c + self.tension * w1[:, None] * fv.dphi_ds[self.var]
        return c.reshape(nq, 2, 2)


class ShellSurfDivV(Equation):
    """R_SHELL_SURF_DIV_V rows (``src/mm_fill_shell.c:4456``): the surface
    divergence of the bulk velocity as a solved shell variable,

        R_i = int phi_i (gamma1 - div_s v),   div_s v = t . dv/ds

    on a curve shell, with the optional surface-diffusion smoothing
    ``surf_div_diff``. The bulk velocity reaches the shell block through
    ``PassiveVar("velocity", dim, interp)``."""

    def __init__(self, interp: str = "Q2", var: str = "surf_div_v",
                 vel_var: str = "velocity"):
        super().__init__(var, 1, interp)
        self.vel_var = vel_var

    def residual(self, fv, mat, params):
        g1 = fv.val[self.var][:, 0]
        div_s = torch.einsum("qa,qa->q", fv.tangent, fv.grad_s[self.vel_var])
        phi = fv.phi[self.var]
        c = (g1 - div_s)[:, None] * phi
        diff = mat.get("surf_div_diff", 0.0)
        if diff:
            c = c + diff * fv.grad_s[self.var][:, :1] * fv.dphi_ds[self.var]
        return c[:, None, :]


class Gamma1DerivBC(FaceKernel):
    """SH_GAMMA1_DERIV_SYMM (``src/mm_ns_bc.c:15582``): the end condition
    n . grad(gamma1) = -g on the surface-rheology projection variable (g =
    0: the symmetry closure), a penalty on the endpoint row."""

    def __init__(self, g: float = 0.0, var: str = "surf_div_v",
                 penalty: float = 1e4):
        super().__init__(var, 1)
        self.g = g
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        dgds = sfv.grad[self.var][:, 0, :]  # tangential gradient
        s = self.g + torch.einsum("qk,qk->q", sfv.normal, dgds)
        phi = sfv.phi[self.var]
        return self.penalty * s[:, None, None] * phi[:, None, :]


class ShellGradBC(FaceKernel):
    """The WEAK_SHELL_GRAD family (``src/bc_special.c:1429-1456``): a
    bulk-side boundary flux assembled into a shell equation's rows
    (SURFACE_ELECTRIC_FIELD, SURFACE_ACOUSTIC_VELOCITY, SURFACE_LUBRICATION,
    SURFACE_USER_SHELL). Applied on the bulk side set carrying the shell,
    whose parent element supplies full gradients; the shell variable joins
    the bulk block through ``PassiveVar``. ``flux(sfv, mat, params) ->
    (nq,)``; the electric closure is :func:`bulk_normal_current`."""

    def __init__(self, shell_var: str, flux, sign: float = 1.0):
        super().__init__(shell_var, 1)
        self.flux = flux
        self.sign = sign

    def residual(self, sfv, mat, params):
        q = self.flux(sfv, mat, params)
        phi = sfv.phi[self.var]
        return self.sign * (q[:, None] * phi)[:, None, :]


def bulk_normal_current(conductivity: float = 1.0, pot_var: str = "voltage"):
    """k n . grad(V) of the bulk at the shell (SURFACE_ELECTRIC_FIELD)."""
    def flux(sfv, mat, params):
        gV = sfv.grad[pot_var][:, 0, :]
        return conductivity * torch.einsum("qk,qk->q", gV, sfv.normal)

    return flux


class ShellCoordinates(Equation):
    """R_SHELL_X / R_SHELL_Y rows (``assemble_shell_coordinates``,
    ``src/mm_fill_shell.c:1638``): the inextensible 2D structural shell's
    coordinate equations, on the mesh rows of a bar shell (the reference's
    "const node space version"):

        x-rows: equal-arc-length node distribution, -int detJ dphi/dxi
        y-rows: curvature closure d2y/ds2 - K dx/ds = 0, scaled by
                ``penalty``

    K is the solved curvature ``curv_var`` or the material key
    ``shell_curvature`` (constant or callable)."""

    def __init__(self, interp: str = "Q1", curv_var: str = "sh_K",
                 penalty: float = 1e3):
        super().__init__(MESH_VAR, 2, interp)
        self.curv_var = curv_var
        self.penalty = penalty

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        t = fv.tangent
        detJ = fv.detJ
        dphi = fv.dphi_ds[self.var]
        phi = fv.phi[self.var]
        if self.curv_var in fv.val:
            K = fv.val[self.curv_var][:, 0]
        else:
            Kv = mat.get("shell_curvature", 0.0)
            K = Kv(fv, mat, params) if callable(Kv) else torch.full(
                (nq,), float(Kv), dtype=fv.x.dtype, device=fv.x.device)
        # the assembly integrates with w detJ, the reference with bare w:
        # the xi-form terms are divided by detJ once
        cx = -detJ[:, None] * dphi
        cy = -t[:, 1][:, None] * detJ[:, None] * dphi \
            - (K * t[:, 0])[:, None] * phi
        return torch.stack([cx, self.penalty * cy], dim=1)


class ShellSurfCurv(Equation):
    """R_SHELL_SURF_CURV rows (``src/mm_fill_shell.c:4896``): the surface
    curvature div_s(n) as a solved projection variable,

        R_i = phi_i (kv - t . d(n)/ds) + D3 (dkv/ds)(dphi_i/ds)

    with n the normal field ``normal_var`` (a ``PassiveVar`` or the solved
    normal); ``surf_diff`` is the reference's surfaceDiffusionCoeff3."""

    def __init__(self, interp: str = "Q2", var: str = "surf_curv",
                 normal_var: str = "normal", surf_diff: float = 0.0):
        super().__init__(var, 1, interp)
        self.normal_var = normal_var
        self.surf_diff = surf_diff

    def residual(self, fv, mat, params):
        kv = fv.val[self.var][:, 0]
        div_n = torch.einsum("qa,qa->q", fv.tangent, fv.grad_s[self.normal_var])
        phi = fv.phi[self.var]
        c = (kv - div_n)[:, None] * phi
        if self.surf_diff:
            c = c + self.surf_diff * fv.grad_s[self.var][:, :1] \
                * fv.dphi_ds[self.var]
        return c[:, None, :]


SH_J = "sh_J"


class ShellDiffusionFlux(Equation):
    """R_SHELL_DIFF_FLUX rows (``assemble_shell_diffusion``,
    ``src/mm_fill_shell.c:2132``): the Mullins surface-diffusion flux on a
    bar shell,

        R_i = int [ Js phi_i + Ds Gs Va Kd (dphi_i/ds) ] ds

    (strong form Js = d/ds(Ds Gs Va Kd); pair with
    :class:`ShellDiffKinematic`). ``curv_var`` is the curvature field.
    Material keys ``surf_diff_Ds``, ``surf_energy_Gs``, ``atomic_vol_Va``
    (each default 1)."""

    def __init__(self, interp: str = "Q1", curv_var: str = "surf_curv"):
        super().__init__(SH_J, 1, interp)
        self.curv_var = curv_var

    def residual(self, fv, mat, params):
        Js = fv.val[SH_J][:, 0]
        Kd = fv.val[self.curv_var][:, 0]
        D = mat.get("surf_diff_Ds", 1.0) * mat.get("surf_energy_Gs", 1.0) \
            * mat.get("atomic_vol_Va", 1.0)
        c = Js[:, None] * fv.phi[SH_J] + D * Kd[:, None] * fv.dphi_ds[SH_J]
        return c[:, None, :]


class ShellDiffKinematic(Equation):
    """SHELL_DIFF_KINEMATIC (``src/mm_fill_shell.c:5603``): the kinematic
    closure on the bulk mesh rows along a diffusing shell surface,

        penalty * ( n . xdot - sign * d(Js)/ds ) n_a phi_i

    Register on the bar-shell block carrying :class:`ShellDiffusionFlux`."""

    def __init__(self, interp: str = "Q1", sign: float = 1.0,
                 penalty: float = 1e4, flux_var: str = SH_J):
        super().__init__(MESH_VAR, 2, interp)
        self.sign = sign
        self.penalty = penalty
        self.flux_var = flux_var

    def residual(self, fv, mat, params):
        n = fv.normal
        xdot = fv.dot[MESH_VAR] if MESH_VAR in fv.dot else torch.zeros_like(fv.x)
        dJ = fv.grad_s[self.flux_var][:, 0]
        mis = torch.einsum("qk,qk->q", n, xdot) - self.sign * dJ
        phi = fv.phi[self.var]
        return self.penalty * torch.einsum("q,qa,qi->qai", mis, n, phi)


def tie_fluid_shell(problem, mesh, nodeset: str, sidesets,
                    curv_var: str = "sh_K", tens_var: str = "sh_tens",
                    scale: float = 1.0):
    """SH_FLUID_STRESS (``src/bc_colloc.c:559``,
    ``src/mm_fill_shell.c:3877``): the bulk momentum residual loaded onto
    the structural-shell rows at shared nodes,

        R[sh_K]    += scale * (n0 R[mom0] + n1 R[mom1])
        R[sh_tens] += scale * (t0 R[mom0] + t1 R[mom1])

    as weighted row injections with the nodal boundary normal and tangent
    (``bc.rotation.nodal_normals`` of ``sidesets``)."""
    from goma_tpu_torch.bc.rotation import nodal_normals

    normals = nodal_normals(mesh, sidesets)
    nodes = mesh.nodesets[nodeset] if isinstance(nodeset, str) else nodeset
    for node in np.asarray(nodes):
        n = normals[int(node)]
        t = np.array([-n[1], n[0]])
        for a in range(2):
            if abs(n[a]) > 1e-14:
                problem.add_row_inject([int(node)], "velocity", curv_var,
                                       from_comp=a, sign=scale * float(n[a]))
            if abs(t[a]) > 1e-14:
                problem.add_row_inject([int(node)], "velocity", tens_var,
                                       from_comp=a, sign=scale * float(t[a]))


class ShellNormal(Equation):
    """R_SHELL_NORMAL1-3 rows (``assemble_shell_normal``,
    ``src/mm_fill_shell.c:15954``): the L2 projection of the shell's
    geometric unit normal, R_(a,i) = int phi_i (n_a - n_geom_a), on bar
    shells in 2D (ncomp 2) and surface shells in 3D (ncomp 3)."""

    def __init__(self, dim: int, interp: str = "Q1",
                 var: str = "shell_normal"):
        super().__init__(var, dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        mis = fv.val[self.var] - fv.normal
        return torch.einsum("qa,qi->qai", mis, fv.phi[self.var])


class ShellAngle(Equation):
    """R_SHELL_ANGLE1(-2) rows (``assemble_shell_angle``,
    ``src/mm_fill_shell.c:4303``): the shell's orientation angles from the
    surface normal, ang0 = atan2(n_y, n_x) and in 3D ang1 = acos(n_z)."""

    def __init__(self, dim: int, interp: str = "Q1",
                 var: str = "shell_angle"):
        super().__init__(var, dim - 1, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        n = fv.normal
        a0 = torch.atan2(n[:, 1], n[:, 0])
        if self.ncomp == 1:
            ang = a0[:, None]
        else:
            ang = torch.stack([a0, torch.arccos(torch.clamp(n[:, 2], -1.0, 1.0))],
                              dim=1)
        mis = fv.val[self.var] - ang
        return torch.einsum("qa,qi->qai", mis, fv.phi[self.var])


class ShellCurvaturePair(Equation):
    """R_SHELL_CURVATURE + R_SHELL_CURVATURE2 rows
    (``assemble_shell_curvature``, ``src/mm_fill_shell.c:16126``): the two
    tangent-direction normal curvatures of a 3D surface shell,
    k_i = t_i . grad_s(n) . t_i with t_i the orthonormalized tangents,
    projected from the normal field ``normal_var``. ncomp 2: K, K2."""

    def __init__(self, interp: str = "Q1", var: str = "sh_K_pair",
                 normal_var: str = "shell_normal"):
        super().__init__(var, 2, interp)
        self.normal_var = normal_var

    def residual(self, fv, mat, params):
        t0 = fv.tangents[:, :, 0]
        t0 = t0 / torch.linalg.vector_norm(t0, dim=1, keepdim=True)
        t1r = fv.tangents[:, :, 1]
        t1r = t1r - torch.einsum("qk,qk->q", t1r, t0)[:, None] * t0
        t1 = t1r / torch.linalg.vector_norm(t1r, dim=1, keepdim=True)
        M = fv.grad[self.normal_var]  # (nq, comp, k) = d n_c / dx_k
        k0 = torch.einsum("qc,qck,qk->q", t0, M, t0)
        k1 = torch.einsum("qc,qck,qk->q", t1, M, t1)
        mis = fv.val[self.var] - torch.stack([k0, k1], dim=1)
        return torch.einsum("qa,qi->qai", mis, fv.phi[self.var])
