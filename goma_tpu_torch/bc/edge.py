"""3D edge (curve) boundary conditions: integrated terms on sideset
intersections (counterpart of ``goma_tpu/bc/edge.py``).

Parity: reference ``src/bc_curve.c`` (``apply_integrated_curve_bc:74``):
a "curve" is the set of element edges where two side sets meet (e.g. the
contact line where a free surface meets a die face). The reference walks
elements' edge lists built in rf_pre_proc; here the intersection, the 1D
quadrature along each reference edge, and the local frame (edge tangent +
both faces' outward normals) are precomputed on host, and the kernels are
mapped over edges like face kernels, with ``torch.func.jacfwd`` supplying
the Jacobians the reference hand-codes (``Problem.add_edge_kernel``). The
host construction is goma_tpu's, copied.

Kernels: :class:`VeloTangentEdge` (VELO_TANGENT_EDGE,
``src/mm_ns_bc.c:1819 fvelo_tangent_edge_bc``), :class:`VeloNormalEdge`
(VELO_NORMAL_EDGE), :class:`EdgeTraction` (line loads / contact-line
forces, the 3D CAP_ENDFORCE analog), :class:`CAEdge` (CA_EDGE /
CA_EDGE_INT static contact angle, ``src/mm_ns_bc.c:9748 fapply_CA``) and
:class:`VarCAEdge` (VAR_CA_EDGE velocity-dependent contact angle,
``src/mm_ns_bc.c:9843 fapply_var_CA``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch.elements import element_type, eval_basis, faces as elem_faces, geom_interp
from goma_tpu_torch.fem.equations import EdgeKernel
from goma_tpu_torch.physics.materials import _clip


@dataclass
class EdgeSet:
    """Edges (element, refA, refB edge) of one block where two sidesets
    meet, with stacked per-edge basis tables."""

    block_index: int
    kernels: list
    edge_elems: np.ndarray          # (ne_edges,) local element ids
    etabs: dict                     # stacked tables (ne_edges, nq, ...)
    ewts: np.ndarray                # (nq_e,) 1D rule weights
    name: str = ""


class EdgeVars:
    """Fields along one element edge at the 1D quadrature points.

    x (nq, 3); wds (nq,) arc-length weights; tangent (nq, 3) unit edge
    tangent; normal_a / normal_b (nq, 3) the two faces' outward normals;
    val/grad/dot/phi/gphi dicts as in FieldVars."""

    def __init__(self):
        self.val = {}
        self.grad = {}
        self.dot = {}
        self.phi = {}
        self.gphi = {}
        self.x = None
        self.wds = None
        self.tangent = None
        self.normal_a = None
        self.normal_b = None
        self.dim = 3


def build_edge_sets(problem, sideset_a: str, sideset_b: str, kernels,
                    quad_order: int | None = None) -> list[EdgeSet]:
    """Find the element edges shared by two sidesets and precompute tables.

    An edge belongs to the curve when ONE element has a face in set A and a
    face in set B sharing exactly two corner nodes (reference: the
    edge-of-element lists of rf_pre_proc consumed by bc_curve.c)."""
    from goma_tpu_torch.elements.quadrature import gauss_1d

    mesh = problem.mesh
    ssa, ssb = mesh.sidesets[sideset_a], mesh.sidesets[sideset_b]
    qo = quad_order or problem.quad_order
    # (elem -> faces) maps
    fa: dict[int, list[int]] = {}
    for e, f in zip(ssa.elems, ssa.faces):
        fa.setdefault(int(e), []).append(int(f))
    out: list[EdgeSet] = []
    per_block: dict[int, list] = {}
    for e, f in zip(ssb.elems, ssb.faces):
        e = int(e)
        if e not in fa:
            continue
        bi, le = mesh.global_elem_block(e)
        et = element_type(mesh.blocks[bi].elem_type)
        if et.dim != 3:
            raise NotImplementedError("edge (curve) BCs are 3D-only; in 2D "
                                      "the analog is a point (bc_special)")
        faces = elem_faces(et.family)
        for f_a in fa[e]:
            shared = tuple(sorted(set(faces[f_a].corner_nodes)
                                  & set(faces[int(f)].corner_nodes)))
            if len(shared) == 2:
                per_block.setdefault(bi, []).append((le, f_a, int(f), shared))

    spts, swts = gauss_1d(qo)  # on [-1, 1]
    for bi, lst in per_block.items():
        # drop duplicate (elem, edge) pairs (two face pairs can share an edge)
        seen = set()
        uniq = []
        for le, f_a, f_b, shared in lst:
            key = (le, shared)
            if key not in seen:
                seen.add(key)
                uniq.append((le, f_a, f_b, shared))
        blk = mesh.blocks[bi]
        bd = problem.dofmap.blocks[bi]
        et = element_type(blk.elem_type)
        gi = geom_interp(et)
        from goma_tpu_torch.mesh.mesh import _ref_nodes

        ref = _ref_nodes(et)
        interps = {s.interp for s in bd.slots if s.interp != "N1"}
        Ngs, dNgs, tjacs, nra, nrb = [], [], [], [], []
        Ni = {i: [] for i in interps}
        dNi = {i: [] for i in interps}
        elems = []
        for le, f_a, f_b, shared in uniq:
            p0, p1 = ref[shared[0]], ref[shared[1]]
            # straight reference edge: param s in [-1,1]
            epts = 0.5 * (1 - spts[:, None]) * p0[None] + \
                0.5 * (1 + spts[:, None]) * p1[None]
            Ng, dNg = eval_basis(et.family, gi, epts)
            Ngs.append(Ng)
            dNgs.append(dNg)
            tjacs.append(0.5 * (p1 - p0))  # d(ref)/ds
            # outward reference normals of the two faces
            for f_idx, acc in ((f_a, nra), (f_b, nrb)):
                J = elem_faces(et.family)[f_idx].ref_jac  # (3, 2)
                nr = np.cross(J[:, 0], J[:, 1])
                acc.append(nr / np.linalg.norm(nr))
            for itp in interps:
                N, dN = eval_basis(et.family, itp, epts)
                Ni[itp].append(N)
                dNi[itp].append(dN)
            elems.append(le)
        etabs = {
            "Ng": np.stack(Ngs), "dNg": np.stack(dNgs),
            "tjac": np.stack(tjacs), "nra": np.stack(nra), "nrb": np.stack(nrb),
        }
        for itp in interps:
            etabs[f"N:{itp}"] = np.stack(Ni[itp])
            etabs[f"dN:{itp}"] = np.stack(dNi[itp])
        out.append(EdgeSet(bi, list(kernels), np.asarray(elems, dtype=np.int64),
                           etabs, swts, name=f"{sideset_a}&{sideset_b}"))
    if not out:
        raise ValueError(
            f"sidesets {sideset_a!r} and {sideset_b!r} share no element edges")
    return out


def eval_edgevars(q_e, qdot_e, X_e, etab, ewts, slots, dtype) -> EdgeVars:
    """EdgeVars for one element edge (mapped over edges)."""
    from goma_tpu_torch.fem.fields import MESH_VAR, _unpack
    from goma_tpu_torch.utils.la import det_and_inv

    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)
    Xc = X_e + u[MESH_VAR].T if MESH_VAR in u else X_e
    Ng, dNg = etab["Ng"], etab["dNg"]
    Jmat = torch.einsum("qnd,nk->qkd", dNg, Xc)  # (nq, 3, 3)
    detJ, invJ = det_and_inv(Jmat)

    fv = EdgeVars()
    fv.x = torch.einsum("qn,nk->qk", Ng, Xc)
    tvec = torch.einsum("qkd,d->qk", Jmat, etab["tjac"])
    mag = torch.linalg.vector_norm(tvec, dim=1)
    fv.tangent = tvec / mag[:, None]
    fv.wds = ewts * mag

    def phys_normal(nr):
        # covariant transform of a reference face normal
        n = torch.einsum("qdk,d->qk", invJ, nr)
        return n / torch.linalg.vector_norm(n, dim=1, keepdim=True)

    fv.normal_a = phys_normal(etab["nra"])
    fv.normal_b = phys_normal(etab["nrb"])

    gphi_cache = {}
    for s in slots:
        if s.interp == "N1":
            continue  # no trace of an edge (Nedelec) variable
        Niq = etab[f"N:{s.interp}"]
        dNiq = etab[f"dN:{s.interp}"]
        if s.interp not in gphi_cache:
            gphi_cache[s.interp] = torch.einsum("qnd,qdk->qnk", dNiq, invJ)
        gp = gphi_cache[s.interp]
        fv.phi[s.var] = Niq
        fv.gphi[s.var] = gp
        fv.val[s.var] = torch.einsum("qn,cn->qc", Niq, u[s.var])
        fv.grad[s.var] = torch.einsum("qnk,cn->qck", gp, u[s.var])
        fv.dot[s.var] = torch.einsum("qn,cn->qc", Niq, udot[s.var])
    return fv


def _value(v, efv, mat, params):
    """A kernel's prescribed value: a number, or callable(efv, mat,
    params)."""
    return v(efv, mat, params) if callable(v) else v


# -------------------------------------------------------------- kernels
class VeloTangentEdge(EdgeKernel):
    """VELO_TANGENT_EDGE (``src/mm_ns_bc.c:1819 fvelo_tangent_edge_bc``):
    the along-edge velocity t_edge . (u - v_s) = V on the contact curve, as
    a weak penalty on the momentum equation:
    ``penalty * (t.(u - v_s) - V) t_a phi_i``."""

    def __init__(self, dim: int = 3, value=0.0, v_s=0.0, penalty: float = 1e6):
        super().__init__("velocity", dim)
        self.value = value
        self.v_s = v_s
        self.penalty = penalty

    def residual(self, efv, mat, params):
        t = efv.tangent
        u = efv.val["velocity"]
        vs = torch.as_tensor(self.v_s, dtype=u.dtype, device=u.device)
        mis = (torch.einsum("qk,qk->q", t, u - vs.expand(u.shape))
               - _value(self.value, efv, mat, params))
        phi = efv.phi["velocity"]
        return self.penalty * torch.einsum("q,qa,qi->qai", mis, t, phi)


class VeloNormalEdge(EdgeKernel):
    """VELO_NORMAL_EDGE: no penetration through face A along the curve,
    weak penalty ``penalty * (n_a . u - V) n_a phi``."""

    def __init__(self, dim: int = 3, value=0.0, penalty: float = 1e6):
        super().__init__("velocity", dim)
        self.value = value
        self.penalty = penalty

    def residual(self, efv, mat, params):
        n = efv.normal_a
        u = efv.val["velocity"]
        mis = (torch.einsum("qk,qk->q", n, u)
               - _value(self.value, efv, mat, params))
        phi = efv.phi["velocity"]
        return self.penalty * torch.einsum("q,qa,qi->qai", mis, n, phi)


class CAEdge(EdgeKernel):
    """CA_EDGE / CA_EDGE_INT (``src/bc_curve.c:790,308``;
    ``src/mm_ns_bc.c:9748 fapply_CA``): static contact angle between the
    free surface (side set A, carrying the mesh motion) and the solid
    surface (side set B) along the 3D contact curve, as the weak penalty

        penalty * (n_fs . n_ss - cos(theta)) * n_fs_a * phi_i

    on the mesh-displacement rows (``var="velocity"``: the CA_MOMENTUM_BC
    flavor, ``src/bc_special.c:642``). Both normals are evaluated on the
    displaced configuration, so AD gives the mesh sensitivities the
    reference hand-codes. ``theta`` in radians: a number, a params name, or
    callable(efv, mat, params)."""

    def __init__(self, theta, dim: int = 3, penalty: float = 1e6,
                 var: str | None = None):
        from goma_tpu_torch.fem.fields import MESH_VAR

        super().__init__(var or MESH_VAR, dim)
        self.theta = theta
        self.penalty = penalty

    def _theta(self, efv, mat, params):
        th = self.theta
        if isinstance(th, str):
            return params[th]
        return _value(th, efv, mat, params)

    def _cos_theta(self, efv, mat, params):
        return torch.cos(torch.as_tensor(self._theta(efv, mat, params),
                                         dtype=efv.x.dtype, device=efv.x.device))

    def residual(self, efv, mat, params):
        nfs, nss = efv.normal_a, efv.normal_b
        mis = (torch.einsum("qk,qk->q", nfs, nss)
               - self._cos_theta(efv, mat, params))
        phi = efv.phi[self.var]
        return self.penalty * torch.einsum("q,qa,qi->qai", mis, nfs, phi)


def contact_line_normal(efv):
    """In-wall contact-line normal n_cl = +-(n_ss x t_edge), signed so
    n_cl . n_fs > 0 (``src/mm_fill_aux.c:2157 calc_CL_normal``)."""
    ncl = torch.linalg.cross(efv.normal_b, efv.tangent, dim=1)
    ncl = ncl / torch.linalg.vector_norm(ncl, dim=1, keepdim=True)
    sgn = torch.sign(torch.einsum("qk,qk->q", ncl, efv.normal_a))
    return ncl * sgn[:, None]


class VarCAEdge(CAEdge):
    """VAR_CA_EDGE (``src/mm_ns_bc.c:9843 fapply_var_CA``;
    ``src/bc_curve.c:369``): velocity-dependent contact angle along the 3D
    contact curve,

        cos(theta) = cos(theta_s) - cT * Ca,
        Ca = mu * n_cl . (v_web - xdot) / sigma,

    with n_cl the in-wall contact-line normal and xdot the mesh velocity;
    clamped to the [1 deg, 179 deg] window like the reference. ``mu`` /
    ``sigma`` default to the material's ``mu``/``sigma``."""

    def __init__(self, theta_s: float, cT: float, v_web=(0.0, 0.0, 0.0),
                 mu=None, sigma=None, dim: int = 3, penalty: float = 1e6):
        super().__init__(theta_s, dim=dim, penalty=penalty)
        self.cT = cT
        self.v_web = np.asarray(v_web, dtype=float)
        self.mu = mu
        self.sigma = sigma

    def _cos_theta(self, efv, mat, params):
        from goma_tpu_torch.fem.fields import MESH_VAR
        from goma_tpu_torch.physics.materials import prop

        mu = self.mu if self.mu is not None else prop(mat, "mu", efv, params, 1.0)
        sigma = (self.sigma if self.sigma is not None
                 else prop(mat, "sigma", efv, params, 1.0))
        ncl = contact_line_normal(efv)
        vw = torch.as_tensor(self.v_web, dtype=efv.x.dtype,
                             device=efv.x.device)[None, :]
        if MESH_VAR in efv.dot:
            vw = vw - efv.dot[MESH_VAR]
        Ca = mu * torch.einsum("qk,qk->q", ncl, vw) / sigma
        th = self.theta
        if isinstance(th, str):
            th = params[th]
        cos_ca = torch.cos(torch.as_tensor(th, dtype=Ca.dtype,
                                           device=Ca.device)) - self.cT * Ca
        return _clip(cos_ca, float(np.cos(np.deg2rad(179.0))),
                     float(np.cos(np.deg2rad(1.0))))


class MovingCAEdge(CAEdge):
    """MOVING_CA (``src/mm_ns_bc.c:10206 fapply_moving_CA``;
    ``src/bc_special.c:656``): dynamic contact angle keyed to the
    contact-line speed relative to the wall,

        theta = theta_s + (theta_adv - theta_s) * tanh(scaling * v_rel),
        v_rel = (xdot - v_wall) . n_fs,

    angles in radians. ``theta_rec`` is accepted for card parity and, as
    in the reference, unused."""

    def __init__(self, theta_s: float, theta_adv: float, scaling: float,
                 theta_rec: float | None = None, v_wall=(0.0, 0.0, 0.0),
                 dim: int = 3, penalty: float = 1e6, var: str | None = None):
        super().__init__(theta_s, dim=dim, penalty=penalty, var=var)
        self.theta_adv = theta_adv
        self.scaling = scaling
        self.theta_rec = theta_rec  # unused, matching fapply_moving_CA
        self.v_wall = np.asarray(v_wall, dtype=float)

    def _cos_theta(self, efv, mat, params):
        from goma_tpu_torch.fem.fields import MESH_VAR

        th_s = self.theta
        if isinstance(th_s, str):
            th_s = params[th_s]
        vw = torch.as_tensor(self.v_wall[: efv.x.shape[1]], dtype=efv.x.dtype,
                             device=efv.x.device)
        xdot = efv.dot[MESH_VAR] if MESH_VAR in efv.dot else \
            torch.zeros_like(efv.x)
        v_rel = torch.einsum("qk,qk->q", xdot - vw[None, :], efv.normal_a)
        th = th_s + (self.theta_adv - th_s) * torch.tanh(self.scaling * v_rel)
        return torch.cos(th)


class EdgeTraction(EdgeKernel):
    """Line load along the curve: -int phi f ds (3D contact-line force; the
    CAP_ENDFORCE analog of bc_special.c in 3D). ``force``: (ncomp,) vector,
    callable(efv, mat, params) -> (nq, ncomp), or a scalar."""

    def __init__(self, var: str, ncomp: int, force):
        super().__init__(var, ncomp)
        self.force = force

    def residual(self, efv, mat, params):
        nq = efv.x.shape[0]
        f = torch.as_tensor(_value(self.force, efv, mat, params),
                            dtype=efv.x.dtype, device=efv.x.device)
        f = f.expand(nq, self.ncomp)
        return -torch.einsum("qc,qi->qci", f, efv.phi[self.var])


class CAEdgeOrFix(CAEdge):
    """CA_EDGE_OR_FIX / CA_OR_FIX (``src/bc_curve.c:874``): the static
    angle while the contact line stays on the admissible side of a feature
    edge, pinning at the feature once it reaches it (signed distance
    d = (x - x_feat) . f_dir), blended smoothly over ``gate_width``:

        mis = g pin_scale d + (1 - g) (n_fs . n_ss - cos theta),
        g = (1 + tanh(d / gate_width)) / 2."""

    def __init__(self, theta, feature_point, feature_dir, dim: int = 3,
                 penalty: float = 1e6, pin_scale: float = 1.0,
                 gate_width: float = 5e-3):
        super().__init__(theta, dim, penalty)
        self.xf = np.asarray(feature_point, dtype=float)
        self.fdir = np.asarray(feature_dir, dtype=float)
        self.fdir = self.fdir / np.linalg.norm(self.fdir)
        self.pin_scale = pin_scale
        self.gate_width = gate_width

    def residual(self, efv, mat, params):
        nfs, nss = efv.normal_a, efv.normal_b
        ca = (torch.einsum("qk,qk->q", nfs, nss)
              - self._cos_theta(efv, mat, params))
        kw = {"dtype": efv.x.dtype, "device": efv.x.device}
        d = torch.einsum("qk,k->q", efv.x - torch.as_tensor(self.xf, **kw),
                         torch.as_tensor(self.fdir, **kw))
        g = 0.5 * (1.0 + torch.tanh(d / self.gate_width))
        mis = g * self.pin_scale * d + (1.0 - g) * ca
        phi = efv.phi[self.var]
        return self.penalty * torch.einsum("q,qa,qi->qai", mis, nfs, phi)
