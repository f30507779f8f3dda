"""Level-set two-phase machinery (counterpart of
``goma_tpu/physics/level_set.py``).

Parity: reference ``src/mm_fill_fill.c`` (fill/advection equation,
``assemble_fill:124``) and ``src/mm_fill_ls.c`` — Heaviside/delta property
blending (``load_lsi:5305``, ``level_set_property:4390``), renormalization
(``huygens_renormalization:497``, facet construction ``find_facets:3364``),
and the diffuse-interface capillary force of
``src/mm_fill_ls_capillary_bcs.c`` (here the CSF volume form).

The fill equation and the CSF term are integrands of the generic AD path
(``torch.func.vmap(jacfwd)`` over a block's elements); property blending is
closure composition; renormalization runs on the host in numpy between
time steps (exact distance to the linearly interpolated zero contour — the
HUYGENS idea), as in goma_tpu.

Under ``jacfwd`` a ``torch.where`` passes on the tangent of the branch it
selects only, so a guard needs a finite value on both branches: the smooth
branches of ``heaviside`` and ``delta`` are finite for every ``z`` (sin and
cos), and the ``+1e-30`` under the square root of ``|grad F|`` keeps its
tangent finite where ``grad F = 0``.

The module carries all of goma_tpu's: the XFEM pressure enrichment (on
the node-anchored ``fv.q_nodal``/``fv.lnodes``), the CSF variants, the
solved curvature, normal and extension velocity, the embedded-interface
flux, Dirichlet, recoil, flow-pressure and latent-heat terms with their
closures, and the host ``apply_ls_adc`` (numpy, the draws of a numpy
``Generator`` in goma_tpu's order). Kanouff's fits threshold with
``_floor`` (``jnp.maximum``'s derivative at the tie); the laser's centre
is float64, as goma_tpu's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goma_tpu_torch.elements import (element_type, eval_basis, geom_interp,
                                     volume_rule)
from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.mesh.mesh import _face_all_nodes
from goma_tpu_torch.physics.electro import on_comp
from goma_tpu_torch.physics.fluid import advective_velocity
from goma_tpu_torch.physics.materials import _floor, prop

FILL_VAR = "fill"


def heaviside(F, eps):
    """Smoothed Heaviside with half-width eps (reference lsi->H)."""
    z = F / eps
    return torch.where(
        z < -1.0, 0.0,
        torch.where(z > 1.0, 1.0,
                    0.5 * (1.0 + z + torch.sin(math.pi * z) / math.pi)))


def delta(F, eps):
    """Smoothed Dirac delta, d(heaviside)/dF (reference lsi->delta)."""
    z = F / eps
    return torch.where(torch.abs(z) > 1.0, 0.0,
                       0.5 / eps * (1.0 + torch.cos(math.pi * z)))


def sharp_heaviside(F):
    """Exact step H(F) (goma_tpu pairs it with a subcell quadrature rule;
    AD sees a zero derivative through the step)."""
    return (F > 0.0).to(F.dtype)


class LevelSetProperty:
    """Two-phase property: value = minus + (plus - minus) * H_eps(F).
    ``eps`` defaults to params["ls_eps"]; ``eps="sharp"`` uses the exact step."""

    def __init__(self, minus, plus, eps=None):
        self.minus, self.plus, self.eps = minus, plus, eps

    def __call__(self, fv, mat, params):
        F = fv.val[FILL_VAR][:, 0]
        if self.eps == "sharp":
            H = sharp_heaviside(F)
        else:
            eps = self.eps if self.eps is not None else params["ls_eps"]
            H = heaviside(F, eps)
        return self.minus + (self.plus - self.minus) * H


class FillEquation(Equation):
    """Level-set advection Fdot + u.grad(F) = 0 with SUPG.

    ``var`` names the advected field — "fill" (default, the F/FILL card)
    or any phase-field name (the reference's multi-phase-field F1..F5
    fields, R_PHASE1..R_PHASE5)."""

    def __init__(self, interp: str = "Q1", supg: float = 0.5,
                 transient: bool = True, var: str = FILL_VAR):
        super().__init__(var, 1, interp)
        self.supg = supg
        self.transient = transient

    def residual(self, fv, mat, params):
        gF = fv.grad[self.var][:, 0, :]
        u = advective_velocity(fv)
        r = torch.einsum("qk,qk->q", u, gF)
        if self.transient:
            r = r + fv.dot[self.var][:, 0]
        phi = fv.phi[self.var]
        if self.supg > 0:
            gphi = fv.gphi[self.var]
            u2 = torch.sum(u * u, dim=1)
            tau = (self.supg * fv.h_elem * torch.sqrt(u2 + 1e-30)
                   / (2.0 * u2 + 1e-12))
            w = phi + tau[:, None] * torch.einsum("qk,qik->qi", u, gphi)
        else:
            w = phi
        return torch.einsum("q,qi->qi", r, w)[:, None, :]


class CSFSurfaceTension(Equation):
    """Continuum-surface-force capillary term added to the momentum equation:
    int sigma delta_eps(F) (I - n n^T) : grad(phi_i e_a),  n = grad F/|grad F|.

    The diffuse-interface analog of the sharp capillary BC; reference:
    LS momentum source (``src/mm_fill_terms.c:2085``) + ls capillary BCs.
    ``fill_var`` sources the tensor from one phase field instead of the
    level set (PF_CAPILLARY, ``src/mm_fill_terms.c:4854``).
    """

    def __init__(self, dim: int, sigma: float, interp: str = "Q2",
                 fill_var: str = None):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.sigma = sigma
        self.fill_var = fill_var or FILL_VAR

    def residual(self, fv, mat, params):
        F = fv.val[self.fill_var][:, 0]
        n, mag = _unit(fv.grad[self.fill_var][:, 0, :])
        dl = delta(F, params["ls_eps"]) * mag  # surface measure density
        return _csf(self.sigma, n, dl, fv.gphi["velocity"])


def _unit(g):
    """(g / |g|, |g|) with goma_tpu's 1e-30 under the square root."""
    mag = torch.sqrt(torch.sum(g * g, dim=1) + 1e-30)
    return g / mag[:, None], mag


def _band(F, gF, eps):
    """The interface measure density delta_eps(F) |grad F|."""
    return delta(F, eps) * torch.sqrt(torch.sum(gF * gF, dim=1) + 1e-30)


def _closure_or_const(v, fv, mat, params, like):
    """A callable ``(fv, mat, params) -> (nq,)`` evaluated, or a constant
    as a field like ``like``."""
    return v(fv, mat, params) if callable(v) else torch.full_like(
        like, float(v))


XFEM_P_VAR = "pressure_xfem"


def xfem_pressure_basis(fv, eps, var: str = XFEM_P_VAR):
    """Enriched pressure basis psi_i(x) = N_i(x) (H(F(x)) - H(F_i)) and its
    physical gradient (nq, nbf, dim), plus the enriched value/gradient of
    the current coefficients.

    The Moes "modified Heaviside" enrichment (reference XFEM
    ``load_xfem_for_elem``, src/mm_fill_ls.c:4604): psi vanishes at nodes
    and is identically zero on uncut elements, so the standard + enriched
    space reproduces c*H(F(x)) exactly (partition of unity)."""
    F = fv.val[FILL_VAR][:, 0]
    gF = fv.grad[FILL_VAR][:, 0, :]
    Hq = heaviside(F, eps)
    dHq = delta(F, eps)
    # level-set nodal values at the enrichment interp's local nodes
    Fn_all = fv.q_nodal[FILL_VAR][0]       # (nbf_fill,)
    lf = fv.lnodes[FILL_VAR]
    idx = [lf.index(k) for k in fv.lnodes[var]]   # static
    Fn = Fn_all[torch.tensor(idx, device=Fn_all.device)]
    Hn = heaviside(Fn, eps)                # (nbf_p,)
    Np = fv.phi[var]                       # (nq, nbf_p)
    gNp = fv.gphi[var]                     # (nq, nbf_p, dim)
    psi = Np * (Hq[:, None] - Hn[None, :])
    # grad psi = gN (H - H_i) + N dH gF
    gpsi = gNp * (Hq[:, None, None] - Hn[None, :, None]) + \
        Np[:, :, None] * dHq[:, None, None] * gF[:, None, :]
    b = fv.q_nodal[var][0]                 # (nbf_p,)
    p_enr = torch.einsum("qi,i->q", psi, b)
    gp_enr = torch.einsum("qik,i->qk", gpsi, b)
    return psi, gpsi, p_enr, gp_enr


class XFEMPressureContinuity(Equation):
    """Continuity rows tested with the enriched pressure basis (reference:
    the extended dofs assembled through load_xfem_for_elem,
    src/mm_fill_ls.c:4604):

        R_i = int psi_i div(u) + eps_reg int N_i b

    The tiny regularization keeps the (identically inactive) enrichment
    dofs of uncut elements invertible."""

    def __init__(self, interp: str = "Q1", eps_reg: float = 1e-8):
        super().__init__(XFEM_P_VAR, 1, interp)
        self.eps_reg = eps_reg

    def residual(self, fv, mat, params):
        psi, _, _, _ = xfem_pressure_basis(fv, params["ls_eps"])
        divu = torch.diagonal(fv.grad["velocity"], dim1=1, dim2=2).sum(-1)
        contrib = torch.einsum("q,qi->qi", divu, psi)
        b = fv.val[XFEM_P_VAR][:, 0]
        contrib = contrib + self.eps_reg * torch.einsum(
            "q,qi->qi", b, fv.phi[XFEM_P_VAR])
        return contrib[:, None, :]


class XFEMPressureMomentum(Equation):
    """The enriched pressure's contribution to the momentum equation:
    sigma_enr = -p_enr I tested against grad(phi_i e_a)."""

    def __init__(self, dim: int, interp: str = "Q2"):
        super().__init__("velocity", dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        _, _, p_enr, _ = xfem_pressure_basis(fv, params["ls_eps"])
        return -p_enr[:, None, None] * fv.gphi["velocity"].transpose(1, 2)


def _csf(sigma, n, dl, gphi):
    """The CSF tensor sigma delta |grad F| (I - n n^T) : grad(phi_i e_a)."""
    ndotg = torch.einsum("qk,qik->qi", n, gphi)
    return (sigma * dl)[:, None, None] * (
        gphi.transpose(1, 2) - torch.einsum("qa,qi->qai", n, ndotg))


def _interface_viscosity(fv, n, coeff):
    """coeff int dphi_i/dx_k (grad_s v)[a, k] on row (a, i), grad_s v =
    grad v - (grad v . n) n (reference grad_s_v)."""
    gv = fv.grad["velocity"]  # (nq, a, k) = dv_a/dx_k
    gsv = gv - torch.einsum("qck,qk,qp->qcp", gv, n, n)
    return coeff[:, None, None] * torch.einsum("qak,qik->qai", gsv,
                                               fv.gphi["velocity"])


class CSFHysing(Equation):
    """LS_CAP_HYSING (``src/mm_fill_ls_capillary_bcs.c:736
    assemble_cap_hysing``): the CSF capillary tensor plus Hysing's
    semi-implicit interface-viscosity stabilization

        + dt sigma delta scale int grad(phi) : grad_s v,

    with the current F (AD supplies the extra coupling); dt from
    ``params['dt']`` (0, the default, turns the term off)."""

    def __init__(self, dim: int, sigma: float, scale: float = 1.0,
                 interp: str = "Q2", fill_var: str = None):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.sigma = sigma
        self.scale = scale
        self.fill_var = fill_var or FILL_VAR

    def residual(self, fv, mat, params):
        F = fv.val[self.fill_var][:, 0]
        n, mag = _unit(fv.grad[self.fill_var][:, 0, :])
        dl = delta(F, params["ls_eps"]) * mag
        csf = _csf(self.sigma, n, dl, fv.gphi["velocity"])
        coeff = params.get("dt", 0.0) * self.sigma * self.scale * dl
        return csf + _interface_viscosity(fv, n, coeff)


class CSFDennerDiffusion(Equation):
    """LS_CAP_DENNER_DIFF (``src/mm_fill_ls_capillary_bcs.c:906
    assemble_cap_denner_diffusion``, ``_n`` variant with the solved normal):
    only the dt-scaled interface-viscosity term of :class:`CSFHysing`;
    pair it with :class:`CSFSurfaceTension`. ``use_solved_normal``
    projects with the solved normal field instead of grad F."""

    def __init__(self, dim: int, sigma: float, scale: float = 1.0,
                 interp: str = "Q2", fill_var: str = None,
                 use_solved_normal: bool = False):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.sigma = sigma
        self.scale = scale
        self.fill_var = fill_var or FILL_VAR
        self.use_solved_normal = use_solved_normal

    def residual(self, fv, mat, params):
        F = fv.val[self.fill_var][:, 0]
        n, mag = _unit(fv.grad[self.fill_var][:, 0, :])
        if self.use_solved_normal:
            n = _unit(fv.val[NORMAL_VAR][:, :self.dim])[0]
        dl = delta(F, params["ls_eps"]) * mag
        coeff = params.get("dt", 0.0) * self.sigma * self.scale * dl
        return _interface_viscosity(fv, n, coeff)


class CSFDivN(Equation):
    """LS_CAP_DIV_N (``src/mm_fill_ls_capillary_bcs.c:355
    assemble_div_n_source``): the point-force form of CSF from the solved
    normal field's divergence, + sigma (div n) delta |grad F| n . phi.
    ``surface_div`` (LS_CAP_DIV_S_N, ``assemble_div_s_n_source:554``) uses
    div_s n = div n - n.(grad n).n. Requires :class:`SolvedNormal`."""

    def __init__(self, dim: int, sigma: float, interp: str = "Q2",
                 fill_var: str = None, surface_div: bool = False):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.sigma = sigma
        self.fill_var = fill_var or FILL_VAR
        self.surface_div = surface_div

    def residual(self, fv, mat, params):
        F = fv.val[self.fill_var][:, 0]
        dl = _band(F, fv.grad[self.fill_var][:, 0, :], params["ls_eps"])
        nhat = _unit(fv.val[NORMAL_VAR][:, :self.dim])[0]
        gn = fv.grad[NORMAL_VAR][:, :self.dim, :]  # (nq, a, k) = dn_a/dx_k
        divn = torch.diagonal(gn, dim1=1, dim2=2).sum(-1)
        if self.surface_div:
            divn = divn - torch.einsum("qa,qak,qk->q", nhat, gn, nhat)
        coeff = self.sigma * divn * dl
        return torch.einsum("q,qa,qi->qai", coeff, nhat, fv.phi["velocity"])


class LSEmbeddedFlux(Equation):
    """Embedded-interface source on ``var`` rows,
    R_i -= int f delta_eps(F) |grad F| phi_i (reference LS_Q / LS_QRAD /
    LS_QLASER / LS_QVAPOR, ``src/mm_fill_terms.c:4759-4778``). ``flux``: a
    constant or a callable ``(fv, mat, params) -> (nq,)`` per-interface-area
    source (positive = into the domain)."""

    def __init__(self, var: str, flux, interp: str = "Q2"):
        super().__init__(var, 1, interp)
        self.flux = flux

    def residual(self, fv, mat, params):
        F = fv.val[FILL_VAR][:, 0]
        dl = _band(F, fv.grad[FILL_VAR][:, 0, :], params["ls_eps"])
        f = _closure_or_const(self.flux, fv, mat, params, F)
        return (-(f * dl)[:, None] * fv.phi[self.var])[:, None, :]


def qrad_flux(htc, Tref, emiss=0.0, sigma_sb=0.0):
    """LS_QRAD flux closure: -htc (T - Tref) - emiss sigma (T^4 - Tref^4)
    (reference ``assemble_qrad_source``, ``src/mm_fill_terms.c:6276``)."""
    def f(fv, mat, params):
        T = fv.val["temperature"][:, 0]
        return -(htc * (T - Tref)
                 + emiss * sigma_sb * (T ** 4 - Tref ** 4))
    return f


def _kanouff(th, lo, hi, T_scale):
    """A Kanouff fit at theta = max(T - T_boil, 0): the ``lo`` cubic up to
    170 T_scale, ``hi`` above, 0 where theta is 0."""
    def cubic(c):
        return c[0] + c[1] * th + c[2] * th ** 2 + c[3] * th ** 3
    val = torch.where(th <= 170.0 * T_scale, cubic(lo), cubic(hi))
    return torch.where(th > 0.0, val, torch.zeros_like(val))


def kanouff_recoil(T_boil, P_scale=1.0, T_scale=1.0):
    """Kanouff ablation-pressure curve fit (iron for T_boil > 2000 K, ice
    otherwise; reference ``assemble_precoil_source``,
    ``src/mm_fill_terms.c:8887-8920``): p(T) a cubic in theta =
    max(T - T_boil, 0), the iron fit switching sets at theta = 170 K."""
    atm = 1.0133e5
    if T_boil > 2000.0 * T_scale:
        lo = (0.0, 1.8272e-4 * atm, -1.9436e-6 * atm, 1.5732e-8 * atm)
        hi = (0.0, -5.7333e-4 * atm, 4.5500e-6 * atm, 2.3022e-9 * atm)
    else:
        lo = hi = (0.0, 3.294180e+03, -7.726940e+00, 5.480973e-01)
    s = 1.0 / T_scale
    lo, hi = ((c[0], c[1] * s, c[2] * s * s, c[3] * s ** 3) for c in (lo, hi))

    def p(T):
        return P_scale * _kanouff(_floor(T - T_boil, 0.0), lo, hi, T_scale)
    return p


class LSRecoilPressure(Equation):
    """LS_RECOIL_PRESSURE (reference ``assemble_precoil_source``,
    ``src/mm_fill_terms.c:8856``): vapor-recoil pressure along the
    interface normal on the momentum rows,
    R_(a,i) += int p(T) n_a delta_eps(F) |grad F| phi_i, n = grad F/|grad F|
    (toward the vapor side, F > 0). ``p_fn``: a callable p(T) (e.g.
    :func:`kanouff_recoil`) or a constant."""

    def __init__(self, dim: int, p_fn, interp: str = "Q2", sign=1.0):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.p_fn = p_fn
        self.sign = sign

    def residual(self, fv, mat, params):
        F = fv.val[FILL_VAR][:, 0]
        n, mag = _unit(fv.grad[FILL_VAR][:, 0, :])
        dl = delta(F, params["ls_eps"]) * mag
        if callable(self.p_fn):
            p = self.p_fn(fv.val["temperature"][:, 0])
        else:
            p = torch.full_like(F, float(self.p_fn))
        return self.sign * torch.einsum("q,qa,qi->qai", p * dl, n,
                                        fv.phi["velocity"])

# ---------------------------------------------------------- renormalization
# Marching-tetrahedra tables for 3D facet construction (reference
# ``find_facets``, src/mm_fill_ls.c:3364 — there per-element-type case
# dissection; here every 3D corner cell is decomposed into tets and ONE
# case table covers hex + tet blocks).
# Six-tet decomposition of a hex sharing the 0-6 diagonal:
_TET_OF_HEX = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                        [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]])
# tet edges: e01, e02, e03, e12, e13, e23
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
# case id = sum over positive vertices of 2^v -> up to two triangles of
# crossing-edge indices (-1 = unused). Complementary cases share triangles
# (orientation is irrelevant for distance queries).
_MT_TABLE = -np.ones((16, 2, 3), dtype=np.int64)
for _case, _tris in {
    1: [[0, 1, 2]], 2: [[0, 3, 4]], 4: [[1, 3, 5]], 8: [[2, 4, 5]],
    14: [[0, 1, 2]], 13: [[0, 3, 4]], 11: [[1, 3, 5]], 7: [[2, 4, 5]],
    3: [[1, 2, 4], [1, 4, 3]], 5: [[0, 2, 5], [0, 5, 3]],
    9: [[0, 1, 5], [0, 5, 4]], 6: [[0, 4, 5], [0, 5, 1]],
    10: [[0, 3, 5], [0, 5, 2]], 12: [[1, 3, 4], [1, 4, 2]],
}.items():
    for _k, _t in enumerate(_tris):
        _MT_TABLE[_case, _k] = _t


def _facets_3d(mesh, Fnode: np.ndarray) -> np.ndarray:
    """Zero-contour triangles (ntri, 3, 3) by marching tetrahedra over the
    corner tets of every 3D block (vectorized host numpy)."""
    out = []
    for b in mesh.blocks:
        et = element_type(b.elem_type)
        if et.dim != 3:
            continue
        if et.family == "hex":
            tets = b.conn[:, :8][:, _TET_OF_HEX].reshape(-1, 4)
        elif et.family == "tet":
            tets = b.conn[:, :4]
        else:
            continue
        f = Fnode[tets]                       # (nt, 4)
        case = ((f > 0.0) @ np.array([1, 2, 4, 8])).astype(np.int64)
        act = (case > 0) & (case < 15)
        if not act.any():
            continue
        tets, f, case = tets[act], f[act], case[act]
        X = mesh.coords[tets]                 # (nt, 4, 3)
        fi = f[:, _TET_EDGES[:, 0]]
        fj = f[:, _TET_EDGES[:, 1]]
        den = fi - fj
        t = np.clip(fi / np.where(np.abs(den) < 1e-300, 1.0, den), 0.0, 1.0)
        Pi = X[:, _TET_EDGES[:, 0]]
        Pj = X[:, _TET_EDGES[:, 1]]
        Pe = Pi + t[..., None] * (Pj - Pi)    # (nt, 6, 3) edge crossings
        tab = _MT_TABLE[case]                 # (nt, 2, 3)
        for k in range(2):
            idx = tab[:, k, :]
            ok = idx[:, 0] >= 0
            if ok.any():
                rows = np.nonzero(ok)[0]
                out.append(Pe[rows[:, None], idx[ok]])  # (nv, 3, 3)
    if not out:
        return np.zeros((0, 3, 3))
    tris = np.concatenate(out)
    # drop degenerate slivers (contour through a tet vertex/edge): they
    # carry no area and would poison point-triangle distance queries
    area2 = (np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]) ** 2
             ).sum(1)
    scale2 = ((tris.max(axis=(0, 1)) - tris.min(axis=(0, 1))) ** 2).sum()
    return tris[area2 > 1e-24 * max(scale2, 1e-300) ** 2]


def _dist_to_triangles(P: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Unsigned distance from points P (n, 3) to the closest of the
    triangles T (m, 3, 3), chunked over points to bound memory."""
    A, B, C = T[:, 0], T[:, 1], T[:, 2]
    AB, AC = B - A, C - A
    nvec = np.cross(AB, AC)
    nn = np.maximum((nvec * nvec).sum(1), 1e-300)
    d00 = (AB * AB).sum(1)
    d01 = (AB * AC).sum(1)
    d11 = (AC * AC).sum(1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-300)

    def seg_d2(p, S0, Sd, Sdd):
        tt = np.clip(np.einsum("cmd,md->cm", p[:, None, :] - S0[None], Sd)
                     / Sdd[None], 0.0, 1.0)
        diff = p[:, None, :] - (S0[None] + tt[..., None] * Sd[None])
        return (diff * diff).sum(-1)

    BC = C - B
    dAB = np.maximum(d00, 1e-300)
    dAC = np.maximum(d11, 1e-300)
    dBC = np.maximum((BC * BC).sum(1), 1e-300)
    m = T.shape[0]
    chunk = max(1, int(4.0e7 / max(m, 1)))
    dist = np.empty(P.shape[0])
    for s in range(0, P.shape[0], chunk):
        p = P[s:s + chunk]
        AP = p[:, None, :] - A[None]
        d20 = np.einsum("cmd,md->cm", AP, AB)
        d21 = np.einsum("cmd,md->cm", AP, AC)
        v = (d11 * d20 - d01 * d21) / denom
        w = (d00 * d21 - d01 * d20) / denom
        # degenerate triangles (nn ~ 0) must fall through to edge distances
        inside = (v >= 0.0) & (w >= 0.0) & (v + w <= 1.0) & (nn > 1e-30)
        dn2 = np.einsum("cmd,md->cm", AP, nvec) ** 2 / nn
        de2 = np.minimum(
            seg_d2(p, A, AB, dAB),
            np.minimum(seg_d2(p, A, AC, dAC), seg_d2(p, B, BC, dBC)))
        dist[s:s + chunk] = np.sqrt(np.where(inside, dn2, de2)).min(axis=1)
    return dist


def interface_facets(mesh, Fnode: np.ndarray):
    """Zero-contour facets from linear interpolation on element corners
    (host). 2D: (nseg, 2, 2) segment endpoints; 3D: (ntri, 3, 3) triangles
    via marching tetrahedra (reference ``find_facets``,
    src/mm_fill_ls.c:3364)."""
    if mesh.dim == 3:
        return _facets_3d(mesh, Fnode)
    segs = []
    for b in mesh.blocks:
        et = element_type(b.elem_type)
        if et.dim != 2:
            continue
        corners = b.conn[:, :3] if et.family == "tri" else b.conn[:, :4]
        for cell in corners:
            # split quad corners into triangles for robust contouring
            tris = [cell[:3], [cell[0], cell[2], cell[3]]] if len(cell) == 4 else [cell]
            for tri in tris:
                f = Fnode[list(tri)]
                x = mesh.coords[list(tri)]
                pts = []
                for i in range(3):
                    j = (i + 1) % 3
                    fi, fj = f[i], f[j]
                    if (fi > 0) != (fj > 0):
                        t = fi / (fi - fj)
                        pts.append(x[i] + t * (x[j] - x[i]))
                if len(pts) == 2:
                    segs.append(pts)
    return np.asarray(segs) if segs else np.zeros((0, 2, mesh.dim))


def renormalize(mesh, Fnode: np.ndarray) -> np.ndarray:
    """Exact signed distance to the piecewise-linear zero contour
    (reference HUYGENS renormalization; 2D segments or 3D marching-tet
    triangles)."""
    segs = interface_facets(mesh, Fnode)
    if segs.shape[0] == 0:
        return Fnode
    if mesh.dim == 3:
        return np.sign(Fnode) * _dist_to_triangles(mesh.coords, segs)
    P = mesh.coords  # (n, d)
    A = segs[:, 0]  # (m, d)
    B = segs[:, 1]
    AB = B - A
    denom = np.maximum(np.sum(AB * AB, axis=1), 1e-30)
    # distance from every node to every segment
    AP = P[:, None, :] - A[None, :, :]  # (n, m, d)
    t = np.clip(np.einsum("nmd,md->nm", AP, AB) / denom[None, :], 0.0, 1.0)
    proj = A[None, :, :] + t[:, :, None] * AB[None, :, :]
    dist = np.linalg.norm(P[:, None, :] - proj, axis=2).min(axis=1)
    return np.sign(Fnode) * dist


def _block_quadrature(mesh, b, quad_order):
    """(Ng, |detJ| (ne, nq), qwts) of one full-dimension block on its
    geometric basis, or None for a lower-dimension block."""
    et = element_type(b.elem_type)
    if et.dim != mesh.dim:
        return None
    qpts, qwts = volume_rule(et.family, quad_order)
    Ng, dNg = eval_basis(et.family, geom_interp(et), qpts)
    X = mesh.coords[b.conn]
    detJ = np.abs(np.linalg.det(np.einsum("qnd,enk->eqkd", dNg, X)))
    return Ng, detJ, qwts


def ls_volume(mesh, Fnode: np.ndarray, eps: float, quad_order: int = 3) -> float:
    """Host quadrature of the smoothed enclosed volume int H_eps(F) dOmega
    over all full-dimension blocks (geometric-basis interpolation of F)."""
    total = 0.0
    for b in mesh.blocks:
        q = _block_quadrature(mesh, b, quad_order)
        if q is None:
            continue
        Ng, detJ, qwts = q
        Fq = np.einsum("qn,en->eq", Ng, Fnode[b.conn])
        z = np.clip(Fq / eps, -1.0, 1.0)
        H = 0.5 * (1.0 + z + np.sin(np.pi * z) / np.pi)
        total += float(np.einsum("eq,q->", detJ * H, qwts))
    return total


def renormalize_mass(mesh, Fnode: np.ndarray, eps: float,
                     target_volume: float | None = None,
                     tol: float = 1e-12, max_iter: int = 60) -> np.ndarray:
    """Volume-preserving renormalization (reference HUYGENS_MASS_ITER,
    ``src/mm_input.c:2244-2380`` renorm-method card; the mass-correction
    iterations around ``huygens_renormalization``, src/mm_fill_ls.c:497):

    1. exact-distance renormalization (HUYGENS);
    2. constant shift c solved so the smoothed enclosed volume matches the
       pre-renorm volume (Newton on V(d + c) = V_target; dV/dc =
       int delta_eps > 0 makes this monotone), eliminating the secular mass
       drift of plain redistancing over long two-phase transients.
    """
    if target_volume is None:
        target_volume = ls_volume(mesh, Fnode, eps)
    d = renormalize(mesh, Fnode)
    c = 0.0
    for _ in range(max_iter):
        V = ls_volume(mesh, d + c, eps)
        err = V - target_volume
        if abs(err) <= tol * max(abs(target_volume), 1e-30):
            break
        # dV/dc = int delta_eps(d + c)
        dV = 0.0
        for b in mesh.blocks:
            q = _block_quadrature(mesh, b, 3)
            if q is None:
                continue
            Ng, detJ, qwts = q
            Fq = np.einsum("qn,en->eq", Ng, (d + c)[b.conn])
            z = Fq / eps
            dl = np.where(np.abs(z) > 1.0, 0.0,
                          0.5 / eps * (1.0 + np.cos(np.pi * z)))
            dV += float(np.einsum("eq,q->", detJ * dl, qwts))
        if dV <= 0.0:
            break
        c -= err / dV
    return d + c


class LSCurvature(Equation):
    """Level-set curvature as a solved auxiliary variable (reference
    ``assemble_curvature``, src/mm_fill_terms.c:1307): kappa = div(n_hat)
    in the integrated-by-parts weak form int kappa psi + int n_hat .
    grad(psi) = 0 (the boundary term is :class:`LSCurvatureBoundary`)."""

    def __init__(self, interp: str = "Q1", var: str = "ls_curvature"):
        super().__init__(var, 1, interp)

    def residual(self, fv, mat, params):
        nhat = _unit(fv.grad[FILL_VAR][:, 0, :])[0]
        kap = fv.val[self.var][:, 0]
        c = kap[:, None] * fv.phi[self.var] + torch.einsum(
            "qk,qik->qi", nhat, fv.gphi[self.var])
        return c[:, None, :]


class LSCurvatureBoundary(FaceKernel):
    """The boundary term of the integrated-by-parts curvature equation,
    - (n_hat . n_wall) psi on domain walls (reference: the surface assembly
    of assemble_curvature)."""

    def __init__(self, var: str = "ls_curvature"):
        super().__init__(var, 1)

    def residual(self, sfv, mat, params):
        nhat = _unit(sfv.grad[FILL_VAR][:, 0, :])[0]
        nn = torch.einsum("qk,qk->q", nhat, sfv.normal)
        return (-nn[:, None] * sfv.phi[self.var])[:, None, :]


def vapor_cool(T_boil, T_scale=1.0, q_scale=1.0):
    """Kanouff evaporation-energy-loss curve fit (iron for
    T_boil > 2000 T_scale, ice otherwise; reference
    ``calculate_vapor_cool``, ``src/mm_ns_bc.c:14609``): q(T) >= 0, the
    energy lost to vaporization per unit area, zero below boiling."""
    s = 1.0 / T_scale
    if T_boil > 2000.0 * T_scale:
        lo = (0.0, 8.14373e5 * s, -2.24831e3 * s * s, 2.71683e1 * s**3)
        hi = (-3.1036e8, 3.2724e6 * s, -1.8084e3 * s * s, 2.7284e0 * s**3)
    else:
        lo = hi = (0.0, 3.442e7 * s, 7.7214e4 * s * s, 3.4523e3 * s**3)

    def q(T):
        return q_scale * _kanouff(_floor(T - T_boil, 0.0), lo, hi, T_scale)

    return q


def qvapor_flux(T_boil, T_scale=1.0, q_scale=1.0):
    """LS_QVAPOR closure for :class:`LSEmbeddedFlux`: evaporative loss at
    the embedded interface (reference ``assemble_qvapor_source``,
    ``src/mm_fill_terms.c:6124``)."""
    qv = vapor_cool(T_boil, T_scale, q_scale)

    def f(fv, mat, params):
        return -qv(fv.val["temperature"][:, 0])

    return f


def laser_flux(power, radius, center, beam_velocity=None,
               absorptivity=1.0, e_concen=0.4522, t_cutoff=None):
    """Traveling-Gaussian laser flux (reference ``calculate_laser_flux``,
    ``src/mm_ns_bc.c:14757``):
    q(x, t) = a P 2 R_eff exp(-R_eff (|x - c(t)| / w)^2), R_eff =
    -ln(1 - e_concen), c(t) = center + beam_velocity t, optional pulse
    cutoff. Returns ``f(x, t) -> (nq,)``. The centre and velocity are
    float64, as goma_tpu's."""
    c0 = np.asarray(center, dtype=np.float64)
    v = None if beam_velocity is None else np.asarray(beam_velocity,
                                                      dtype=np.float64)
    R_eff = -np.log(1.0 - e_concen)

    def f(x, t):
        c = torch.as_tensor(c0, device=x.device)
        if v is not None:
            c = c + torch.as_tensor(v, device=x.device) * t
        r2 = torch.sum((x - c[None, :x.shape[1]]) ** 2, dim=1)
        q = absorptivity * power * 2.0 * R_eff * torch.exp(
            -R_eff * r2 / radius**2)
        if t_cutoff is not None:
            q = q * (torch.as_tensor(t) <= t_cutoff).to(q.dtype)
        return q

    return f


def qlaser_flux(power, radius, center, **kw):
    """LS_QLASER closure for :class:`LSEmbeddedFlux` (reference
    ``assemble_qlaser_source``, ``src/mm_fill_terms.c:4766``): laser
    heating at the embedded interface (positive = into the domain)."""
    lf = laser_flux(power, radius, center, **kw)

    def f(fv, mat, params):
        return lf(fv.x, params.get("time", 0.0))

    return f


class LSEmbeddedDirichlet(Equation):
    """LS_U / LS_V / LS_W / LS_T / LS_Y (reference ``src/mm_fill_terms.c``
    ``assemble_uvw_source`` / ``assemble_t_source`` / ``assemble_y_source``,
    :4680-4758): embedded Dirichlet on ``var`` at the zero contour as a
    penalty over the diffuse band,
    R_i += pen delta_eps(F) |grad F| (u_comp - value) phi_i. ``value``: a
    constant or a callable ``(fv, mat, params) -> (nq,)``."""

    def __init__(self, var: str, value, comp: int = 0, ncomp: int = 1,
                 penalty: float = 1e6, interp: str = "Q2"):
        super().__init__(var, ncomp, interp)
        self.value = value
        self.comp = comp
        self.penalty = penalty

    def residual(self, fv, mat, params):
        F = fv.val[FILL_VAR][:, 0]
        dl = _band(F, fv.grad[FILL_VAR][:, 0, :], params["ls_eps"])
        v = _closure_or_const(self.value, fv, mat, params, F)
        u = fv.val[self.var][:, self.comp]
        term = (self.penalty * dl * (u - v))[:, None] * fv.phi[self.var]
        return on_comp(term, self.comp, self.ncomp)


NORMAL_VAR = "ls_normal"


class SolvedNormal(Equation):
    """Solved normal-field equations R_NORMAL1..3 (reference
    ``assemble_normals``, ``src/mm_fill_terms.c:1876``):
    R_(a,i) = int phi_i (n_a - grad_a F / |grad F|)."""

    def __init__(self, dim: int, interp: str = "Q1", var: str = NORMAL_VAR,
                 fill_var: str = FILL_VAR):
        super().__init__(var, dim, interp)
        self.dim = dim
        self.fill_var = fill_var

    def residual(self, fv, mat, params):
        nhat = _unit(fv.grad[self.fill_var][:, 0, :])[0]
        n = fv.val[self.var][:, :self.dim]
        return (n - nhat[:, :self.dim])[:, :, None] * fv.phi[self.var][:, None, :]


EXT_V_VAR = "ext_velocity"


class ExtensionVelocity(Equation):
    """Extension-velocity equation R_EXT_VELOCITY (reference
    ``assemble_extension_velocity``, ``src/mm_fill_ls.c:8046``):
    grad(F) . grad(v_ext) = 0 tested with the signed Petrov-Galerkin
    weight w_i = S phi_i + tau grad(F).grad(phi_i), S = 2 H_eps(F) - 1,
    tau = h_elem / 2."""

    def __init__(self, interp: str = "Q1", var: str = EXT_V_VAR):
        super().__init__(var, 1, interp)

    def residual(self, fv, mat, params):
        F = fv.val[FILL_VAR][:, 0]
        gF = fv.grad[FILL_VAR][:, 0, :]
        r = torch.einsum("qk,qk->q", gF, fv.grad[self.var][:, 0, :])
        S = 2.0 * heaviside(F, params["ls_eps"]) - 1.0
        tau = 0.5 * fv.h_elem
        w = S[:, None] * fv.phi[self.var] + tau[:, None] * torch.einsum(
            "qk,qik->qi", gF, fv.gphi[self.var])
        return (r[:, None] * w)[:, None, :]


class LSExtVKinematic(Equation):
    """LS_EXTV_KINEMATIC / LS_EXTV_KIN_LEAK (reference
    ``assemble_extv_kinematic``, ``src/mm_fill_terms.c:7067``): pin the
    extension velocity to the interfacial normal speed through the band
    source on the EXT_V rows,
    R_i = -int 2 delta_eps(F) |grad F| (sign vnorm - coeff (tau v_ext_dot
    + v_ext)) phi_i. ``vnorm``: None -> u.n; a callable ``(fv, mat,
    params) -> (nq,)`` otherwise (``include_fluid`` adds u.n to it)."""

    def __init__(self, vnorm=None, sign: float = 1.0, coeff: float = 1.0,
                 tau: float = 0.0, include_fluid: bool = False,
                 interp: str = "Q1", var: str = EXT_V_VAR):
        super().__init__(var, 1, interp)
        self.vnorm = vnorm
        self.sign = sign
        self.coeff = coeff
        self.tau = tau
        self.include_fluid = include_fluid

    def _vnorm(self, fv, mat, params, n):
        if self.vnorm is None:
            u = fv.val["velocity"]
            return torch.einsum("qk,qk->q", u[:, :n.shape[1]], n)
        v = self.vnorm(fv, mat, params)
        if self.include_fluid:
            u = fv.val["velocity"]
            v = v + torch.einsum("qk,qk->q", u[:, :n.shape[1]], n)
        return v

    def _coeff(self, fv, n):
        return self.coeff

    def residual(self, fv, mat, params):
        F = fv.val[FILL_VAR][:, 0]
        n, mag = _unit(fv.grad[FILL_VAR][:, 0, :])
        vn = self._vnorm(fv, mat, params, n)
        v = fv.val[self.var][:, 0]
        vdot = fv.dot[self.var][:, 0] if self.tau else 0.0
        src = 2.0 * delta(F, params["ls_eps"]) * mag * (
            self.sign * vn - self._coeff(fv, n) * (self.tau * vdot + v))
        # the reference adds the pin to R; R = 0 here, so it is negated to
        # keep d(src)/d(v_ext) positive on the band
        return (-src[:, None] * fv.phi[self.var])[:, None, :]


class LSExtVLatent(LSExtVKinematic):
    """LS_EXTV_LATENT (reference ``assemble_extv_kinematic``,
    ``src/mm_fill_terms.c:7215``): vnorm = L_coeff (T - T_ref), coeff =
    dt_avg grad(T).n, sign = -1, ``tau`` the relaxation time of the
    v_ext_dot damping."""

    def __init__(self, L_coeff: float, T_ref: float, dt_avg: float = 1.0,
                 tau: float = 0.0, interp: str = "Q1", var: str = EXT_V_VAR):
        super().__init__(vnorm=None, sign=-1.0, coeff=1.0, tau=tau,
                         interp=interp, var=var)
        self.L_coeff = L_coeff
        self.T_ref = T_ref
        self.dt_avg = dt_avg

    def _vnorm(self, fv, mat, params, n):
        return self.L_coeff * (fv.val["temperature"][:, 0] - self.T_ref)

    def _coeff(self, fv, n):
        gT = fv.grad["temperature"][:, 0, :]
        return self.dt_avg * torch.einsum("qk,qk->q", gT, n)


class FillExtV(Equation):
    """Level-set advection by the extension velocity (reference
    ``assemble_fill_ext_v``, ``src/mm_fill_fill.c:1421``):
    F_t + v_ext |grad F| = 0 with the GLS weight w_i = phi_i + tau v_ext
    n.grad(phi_i), tau = 1/sqrt((2/dt)^2 + (2 |v_ext|/h)^2); dt from
    ``params['dt']`` (absent or 0: no time term in tau)."""

    def __init__(self, interp: str = "Q1", transient: bool = True,
                 var: str = FILL_VAR, ext_var: str = EXT_V_VAR):
        super().__init__(var, 1, interp)
        self.transient = transient
        self.ext_var = ext_var

    def residual(self, fv, mat, params):
        n, mag = _unit(fv.grad[self.var][:, 0, :])
        v = fv.val[self.ext_var][:, 0]
        r = v * mag
        if self.transient:
            r = r + fv.dot[self.var][:, 0]
        dt = params.get("dt", 0.0)
        inv_dt2 = (2.0 / dt) ** 2 if dt else 0.0
        tau = 1.0 / torch.sqrt(inv_dt2 + (2.0 * v / fv.h_elem) ** 2 + 1e-30)
        w = fv.phi[self.var] + (tau * v)[:, None] * torch.einsum(
            "qk,qik->qi", n, fv.gphi[self.var])
        return (r[:, None] * w)[:, None, :]


class LSFlowPressure(Equation):
    """LS_FLOW_PRESSURE (reference ``src/mm_fill_terms.c``): a prescribed
    pressure P on the embedded interface as the diffuse surface force
    R_u,i -= int P n_ls delta_eps(F) |grad F| phi_i (at rest, the jump
    p(+) - p(-) = P across the zero contour)."""

    def __init__(self, dim: int, p0=0.0, interp: str = "Q2"):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.p0 = p0

    def residual(self, fv, mat, params):
        F = fv.val[FILL_VAR][:, 0]
        n_ls, mag = _unit(fv.grad[FILL_VAR][:, 0, :])
        P = _closure_or_const(self.p0, fv, mat, params, F)
        dl = delta(F, params["ls_eps"]) * mag
        return -torch.einsum("q,qa,qi->qai", P * dl, n_ls, fv.phi["velocity"])


def apply_ls_adc(mesh, F, sideset: str, capture_angle_deg: float,
                 capture_distance: float, capture_rate: float, dt: float,
                 rng=None):
    """LS_ADC / LS_ADC_OLD (``src/mm_fill_ls.c:10620 resolve_ls_adc_old``):
    stochastic air-to-droplet contact, a host operation between steps.
    For each side-set face of an interface-crossing element whose face is
    not yet wetted (uniform F sign, none ~0), a capture probability:

        alignment gate: |n_face . n_ls| >= |cos(capture_angle)|
        near (d < capture_distance):  P = rate * face_area * dt   (cap 1)
        far:   P = rate * sqrt(elem_area) * dt * exp(1 - (d/d_c)^2)

    with d the least |F| over the face's nodes. On a draw <= P every
    interface-crossing side-set face pulls its nodes to F = start_sign * d
    (the reference's apply_adc_to_ss switch). Returns (F_new, event). The
    draws come from ``rng`` (a numpy Generator), in goma_tpu's order."""
    rng = np.random.default_rng() if rng is None else rng
    et = element_type(mesh.blocks[0].elem_type)
    ss = mesh.sidesets[sideset]
    F = np.asarray(F, dtype=float)

    def elem_nodes(e):
        bi, le = mesh.global_elem_block(int(e))
        return mesh.blocks[bi].conn[le]

    event = False
    switch_value = 0.0
    faces = []
    for e, f in zip(ss.elems, ss.faces):
        en = elem_nodes(e)
        fn = [en[k] for k in _face_all_nodes(et, int(f))]
        Fe = F[en]
        faces.append((en, fn, Fe.min() < 0.0 < Fe.max()))

    for en, fn, crossing in faces:
        if event or not crossing:
            continue
        Ff = F[fn]
        if np.any(np.abs(Ff) < 1e-12) or Ff.max() * Ff.min() < 0.0:
            continue  # face already wetted / touching
        # face normal against the LS normal (a least-squares fit of F over
        # the element's nodes)
        X = mesh.coords[en]
        A = np.column_stack([X - X.mean(axis=0), np.ones(len(en))])
        g = np.linalg.lstsq(A, F[en], rcond=None)[0][:mesh.dim]
        nls = g / max(np.linalg.norm(g), 1e-30)
        Xf = mesh.coords[fn]
        t = Xf[1] - Xf[0]
        nf = np.array([t[1], -t[0]]) if mesh.dim == 2 else np.cross(
            t, Xf[2] - Xf[0])
        nf = nf / max(np.linalg.norm(nf), 1e-30)
        if abs(nf @ nls) < abs(np.cos(np.deg2rad(capture_angle_deg))):
            continue
        d = np.abs(Ff).min()
        face_area = np.linalg.norm(Xf[1] - Xf[0])
        elem_area = face_area**2
        if d < capture_distance:
            P = min(capture_rate * face_area * dt, 1.0)
        else:
            P = capture_rate * np.sqrt(elem_area) * dt * np.exp(
                1.0 - (d / capture_distance) ** 2)
        if P > 0.0 and rng.random() <= P:
            event = True
            switch_value = d

    if event:
        F = F.copy()
        start_sign = 0.0
        for en, fn, crossing in faces:
            if not crossing:
                continue
            if start_sign == 0.0:
                start_sign = np.sign(F[fn[0]]) or 1.0
            F[fn] = start_sign * switch_value
    return F, event


class LSLatentHeat(Equation):
    """LS_LATENT_HEAT (``src/mm_fill_terms.c``
    ``assemble_ls_latent_heat_source``, dispatch :4777): latent heat at the
    moving interface as a band energy source s = rho L v_n delta(F)
    |grad F|, v_n = u . n_ls."""

    def __init__(self, L_heat: float, interp: str = "Q1",
                 var: str = "temperature", fill_var: str = None):
        super().__init__(var, 1, interp)
        self.L_heat = L_heat
        self.fill_var = fill_var or FILL_VAR

    def residual(self, fv, mat, params):
        F = fv.val[self.fill_var][:, 0]
        n_ls, mag = _unit(fv.grad[self.fill_var][:, 0, :])
        dl = delta(F, params["ls_eps"]) * mag
        rho = prop(mat, "rho", fv, params, 1.0)
        u = fv.val["velocity"] if "velocity" in fv.val else 0.0 * fv.x
        vn = torch.einsum("qk,qk->q", u, n_ls)
        s = rho * self.L_heat * vn * dl
        return (-s[:, None] * fv.phi[self.var])[:, None, :]
