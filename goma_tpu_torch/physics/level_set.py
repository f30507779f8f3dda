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

Cut to this slice: ``LevelSetProperty``, ``FillEquation``,
``CSFSurfaceTension`` and the host helpers. Every other class and closure
of goma_tpu's module (the XFEM pair, the CSF variants, the curvature
equations, the embedded-interface, extension-velocity, recoil, flow-pressure
and latent-heat terms, their flux closures, ``apply_ls_adc``) exists under
its name and raises ``NotImplementedError`` (later slices, see ROADMAP).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goma_tpu_torch.elements import (element_type, eval_basis, geom_interp,
                                     volume_rule)
from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.fluid import advective_velocity

_LATER = "later slice of the port, see ROADMAP"

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
        eps = params["ls_eps"]
        F = fv.val[self.fill_var][:, 0]
        gF = fv.grad[self.fill_var][:, 0, :]
        mag = torch.sqrt(torch.sum(gF * gF, dim=1) + 1e-30)
        n = gF / mag[:, None]
        dl = delta(F, eps) * mag  # surface measure density
        gphi = fv.gphi["velocity"]  # (nq, nbf, dim)
        ndotg = torch.einsum("qk,qik->qi", n, gphi)
        return (self.sigma * dl)[:, None, None] * (
            gphi.transpose(1, 2) - torch.einsum("qa,qi->qai", n, ndotg))


def _refused(name: str, needs: str):
    """A class of goma_tpu's module that this slice does not carry: it
    keeps goma_tpu's name and raises at construction."""
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} ({needs}): {_LATER}")

    return type(name, (), {"__init__": __init__, "__doc__":
                           f"goma_tpu's ``{name}`` ({needs}): a later slice."})


def _refused_fn(name: str, needs: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} ({needs}): {_LATER}")

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"goma_tpu's ``{name}`` ({needs}): a later slice."
    return fn


_XFEM = "XFEM enrichment, needs the node-anchored field values"
XFEMPressureContinuity = _refused("XFEMPressureContinuity", _XFEM)
XFEMPressureMomentum = _refused("XFEMPressureMomentum", _XFEM)
xfem_pressure_basis = _refused_fn("xfem_pressure_basis", _XFEM)
CSFHysing = _refused("CSFHysing", "CSF variant")
CSFDennerDiffusion = _refused("CSFDennerDiffusion", "CSF variant")
CSFDivN = _refused("CSFDivN", "CSF variant")
LSCurvature = _refused("LSCurvature", "solved curvature")
LSCurvatureBoundary = _refused("LSCurvatureBoundary",
                               "solved curvature, a face kernel")
LSEmbeddedFlux = _refused("LSEmbeddedFlux", "embedded-interface source")
LSEmbeddedDirichlet = _refused("LSEmbeddedDirichlet",
                               "embedded-interface condition")
qrad_flux = _refused_fn("qrad_flux", "embedded-interface flux closure")
vapor_cool = _refused_fn("vapor_cool", "embedded-interface flux closure")
qvapor_flux = _refused_fn("qvapor_flux", "embedded-interface flux closure")
laser_flux = _refused_fn("laser_flux", "embedded-interface flux closure")
qlaser_flux = _refused_fn("qlaser_flux", "embedded-interface flux closure")
kanouff_recoil = _refused_fn("kanouff_recoil", "recoil pressure closure")
LSRecoilPressure = _refused("LSRecoilPressure", "recoil pressure")
SolvedNormal = _refused("SolvedNormal", "extension velocity")
ExtensionVelocity = _refused("ExtensionVelocity", "extension velocity")
LSExtVKinematic = _refused("LSExtVKinematic", "extension velocity")
LSExtVLatent = _refused("LSExtVLatent", "extension velocity")
FillExtV = _refused("FillExtV", "extension velocity")
LSFlowPressure = _refused("LSFlowPressure", "level-set flow pressure")
LSLatentHeat = _refused("LSLatentHeat", "latent heat")
apply_ls_adc = _refused_fn("apply_ls_adc", "level-set capture on a side set")


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
