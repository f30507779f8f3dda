"""Per-element field-variable evaluation at quadrature points (counterpart
of ``goma_tpu/fem/fields.py``).

Everything is evaluated for all quadrature points of ONE element at once
(leading axis = qp); the assembler maps the function over a block's
elements with ``torch.func.vmap`` and differentiates it with
``torch.func.jacfwd``, so the element Jacobian is exact forward-mode AD of
the residual, as in goma_tpu.

ALE: with a mesh-displacement variable in the block the coordinates are
``X_ref + d``, with ``d`` part of the differentiated unknowns, so
``jacfwd`` of the residual carries every mesh sensitivity exactly (the
reference hand-codes them in ``load_fv_mesh_derivs``); the reference
configuration (``X0``, ``wdetJ0``, ``gphi0``, ``grad0``) and the
deformation gradient ``F`` come with it.

Axisymmetric coordinates (``coord="cylindrical"``/``"swirling"``, q =
[z, r]) multiply ``wdetJ`` (and ``wdetJ0`` under ALE) by the guarded
radius ``fv.r``; frozen external nodal fields (``ext_e``) are interpolated
with the geometric basis into ``fv.ext``/``fv.ext_grad``.

Lower-dimension (shell) blocks share the bulk's boundary nodes, so a
variable shared with the bulk couples through the node-major dof map. BAR
blocks embedded in a 2D mesh (the immersed curves of the overset coupling,
the curve shells) evaluate through ``eval_curvevars``: arc-length measure,
unit tangent and normal, tangential gradients, and the Hermite cubic (H3)
slot with its second arc-length derivatives. QUAD/TRI blocks embedded in 3D
(surface shells) evaluate through ``eval_surfvars``: surface gradients
``J_s G^-1 dN`` and the measure ``sqrt(det G)``.

H(curl) edge (Nedelec, N1) slots carry one tangential circulation per
element edge (on the edge's midside node). Their reference vector basis
maps covariantly, ``N_phys = N_ref . J^-1``; the curl is ``curl_ref /
detJ`` in 2D (a scalar) and ``J . curl_ref / detJ`` in 3D (a vector).
``fv.val``/``fv.dot`` of an N1 variable are vectors (nq, dim), ``fv.phi``
its vector test functions (nq, nbf, dim), ``fv.curl``/``fv.curl_phi`` the
curls ((nq,) and (nq, nbf) in 2D; (nq, 3) and (nq, nbf, 3) in 3D); it has
no ``grad``. The element's edge orientation signs are applied by the
assembler, outside this function.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from goma_tpu_torch.elements import (element_type, eval_basis, geom_interp,
                                     interp_local_nodes, volume_rule)
from goma_tpu_torch.elements.shapes import eval_hermite_bar, eval_nedelec
from goma_tpu_torch.fem.dofmap import LocalSlot
from goma_tpu_torch.utils.la import det_and_inv

MESH_VAR = "mesh_displacement"


@dataclass
class BlockTables:
    """Static (host numpy) basis tables for one block's volume quadrature."""

    elem_type: str
    dim: int
    nq: int
    qwts: np.ndarray  # (nq,)
    Ng: np.ndarray  # (nq, n_geom_nodes) geometric basis
    dNg: np.ndarray  # (nq, n_geom_nodes, dim)
    N: dict[str, np.ndarray]  # interp -> (nq, nbf)
    dN: dict[str, np.ndarray]  # interp -> (nq, nbf, dim) (reference coords)
    # Hermite (H3) raw xi-tables: interp -> (N, dN, d2N), each (nq, 4)
    H3: dict[str, tuple] = field(default_factory=dict)
    # H(curl) edge (N1) tables: interp -> (nq, nbf, dim) reference vector
    # basis, and its reference curl (nq, nbf) in 2D, (nq, nbf, 3) in 3D
    Nvec: dict[str, np.ndarray] = field(default_factory=dict)
    Ncurl: dict[str, np.ndarray] = field(default_factory=dict)
    _on: dict = field(default_factory=dict, repr=False)

    def on(self, dtype, device) -> dict:
        """The tables as tensors at ``dtype`` on ``device`` (made once per
        pair): ``qwts``, ``Ng``, ``dNg``, ``N:<interp>``/``dN:<interp>``,
        the Hermite ``H3N:``/``H3dN:``/``H3d2N:<interp>`` and the Nedelec
        ``Nvec:``/``Ncurl:<interp>``."""
        key = (dtype, torch.device(device))
        if key not in self._on:
            arrs = {"qwts": self.qwts, "Ng": self.Ng, "dNg": self.dNg}
            for itp in self.N:
                arrs[f"N:{itp}"] = self.N[itp]
                arrs[f"dN:{itp}"] = self.dN[itp]
            for itp in self.Nvec:
                arrs[f"Nvec:{itp}"] = self.Nvec[itp]
                arrs[f"Ncurl:{itp}"] = self.Ncurl[itp]
            for itp, (Nh, dNh, d2Nh) in self.H3.items():
                arrs[f"H3N:{itp}"], arrs[f"H3dN:{itp}"] = Nh, dNh
                arrs[f"H3d2N:{itp}"] = d2Nh
            self._on[key] = {k: torch.as_tensor(np.ascontiguousarray(a),
                                                dtype=dtype, device=device)
                             for k, a in arrs.items()}
        return self._on[key]


def build_block_tables(elem_type_name: str, interps: set[str],
                       quad_order: int) -> BlockTables:
    et = element_type(elem_type_name)
    qpts, qwts = volume_rule(et.family, quad_order)
    gi = geom_interp(et)
    Ng, dNg = eval_basis(et.family, gi, qpts)
    N, dN, H3, Nvec, Ncurl = {}, {}, {}, {}, {}
    for itp in sorted(interps | {gi}):
        if itp == "N1":
            Nvec[itp], Ncurl[itp] = eval_nedelec(et.family, qpts)
            continue
        if itp == "H3":
            if et.family != "bar":
                raise ValueError("I_H3 Hermite interpolation is bar-only")
            H3[itp] = eval_hermite_bar(qpts)
            continue
        N[itp], dN[itp] = eval_basis(et.family, itp, qpts)
    return BlockTables(elem_type_name, et.dim, qpts.shape[0], qwts, Ng, dNg,
                       N, dN, H3, Nvec, Ncurl)


class FieldVars:
    """Field values/gradients/time-derivatives at all quadrature points of
    one element (leading qp axis; mapped over elements).

    Attributes:
      x        (nq, dim)        position
      detJ     (nq,)
      wdetJ    (nq,)            quadrature weight x detJ
      val[v]   (nq, ncomp)
      grad[v]  (nq, ncomp, dim)
      dot[v]   (nq, ncomp)      time derivative
      phi[v]   (nq, nbf)        basis of v's interpolation
      gphi[v]  (nq, nbf, dim)   physical gradient of basis
      h_elem   (nq,)            element size measure (for SUPG/PSPG tau)

    When a mesh-displacement variable is active (ALE), the reference
    configuration (total-Lagrangian mesh equations; the reference's
    ``belly_flop`` deformation gradient, src/mm_fill_solid.c:77):
      X0       (nq, dim)        undisplaced position
      wdetJ0   (nq,)            reference measure
      gphi0[v] (nq, nbf, dim)   basis gradient w.r.t. reference coords
      grad0[v] (nq, ncomp, dim) field gradient w.r.t. reference coords
      F        (nq, dim, dim)   deformation gradient dx/dX0

    Without mesh motion the reference configuration is the current one:
    ``X0``, ``wdetJ0``, ``gphi0`` and ``grad0`` alias their current
    counterparts and ``F`` stays None, as in goma_tpu.

    Coordinate system (reference ``load_coordinate_scales``,
    src/mm_fill_aux.c:127): ``coord`` is "cartesian", "cylindrical" or
    "swirling"; the last two are axisymmetric with q = [z, r], h3 = r, and
      r        (nq,)            radial coordinate, 1 where |r| < 1e-30
    External (frozen) nodal fields (reference External_Field_Variables,
    include/mm_as_structs.h:1046):
      ext[name]      (nq,)
      ext_grad[name] (nq, dim)
    H(curl) edge (N1) variables (see the module docstring):
      curl[v]        (nq,) 2D | (nq, 3) 3D
      curl_phi[v]    (nq, nbf) 2D | (nq, nbf, 3) 3D
    Node-anchored values (XFEM enrichment, reference ``load_xfem_for_elem``
    src/mm_fill_ls.c:4604):
      q_nodal[v]     (ncomp, nbf) the element's raw dofs of v
      lnodes[v]      tuple of v's element-local node ids (not for P0/P1E)
    """

    def __init__(self):
        self.val: dict[str, Any] = {}
        self.grad: dict[str, Any] = {}
        self.dot: dict[str, Any] = {}
        self.phi: dict[str, Any] = {}
        self.gphi: dict[str, Any] = {}
        self.x = None
        self.detJ = None
        self.wdetJ = None
        self.h_elem = None
        self.dim = None
        self.invJ = None
        self.coord = "cartesian"
        self.r = None
        self.X0 = None
        self.wdetJ0 = None
        self.gphi0: dict[str, Any] = {}
        self.grad0: dict[str, Any] = {}
        self.F = None
        self.ext: dict[str, Any] = {}
        self.ext_grad: dict[str, Any] = {}
        self.curl: dict[str, Any] = {}
        self.curl_phi: dict[str, Any] = {}
        self.q_nodal: dict[str, Any] = {}
        self.lnodes: dict[str, tuple] = {}


def _unpack(q_e, slots: list[LocalSlot]):
    return {s.var: q_e[s.start:s.start + s.size].reshape(s.ncomp, s.nbf)
            for s in slots}


def _guard_r(r):
    """The radius with the reference's r = 0 kludge
    (src/mm_fill_aux.c:211-228): 1 where |r| < 1e-30. ``where`` selects on
    r itself, so no 1/0 reaches the forward derivative of a hoop term."""
    return torch.where(torch.abs(r) < 1e-30, torch.ones_like(r), r)


def eval_fieldvars(q_e, qdot_e, X_e, tables: BlockTables,
                   slots: list[LocalSlot], dtype, ext_e=None,
                   ext_names: tuple[str, ...] = (),
                   coord: str = "cartesian") -> FieldVars:
    """FieldVars of one element: local dofs ``q_e``/``qdot_e`` (n_ldof,),
    node coordinates ``X_e`` (n_geom_nodes, dim), tables at ``dtype``;
    ``ext_e`` (n_geom_nodes, len(ext_names)) the element's external nodal
    fields, ``coord`` the coordinate system."""
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)
    tb = tables.on(dtype, q_e.device)
    ale = MESH_VAR in u
    # ALE: displaced coordinates carry dofs -> AD sees mesh sensitivities
    Xc = X_e + u[MESH_VAR].T if ale else X_e

    # isoparametric map: Jmat[q,k,d] = dx_k/dxi_d; invJ[q,d,k] = dxi_d/dx_k
    Jmat = torch.einsum("qnd,nk->qkd", tb["dNg"], Xc)
    detJ, invJ = det_and_inv(Jmat)

    fv = FieldVars()
    fv.dim = tables.dim
    fv.invJ = invJ
    fv.x = torch.einsum("qn,nk->qk", tb["Ng"], Xc)
    fv.detJ = detJ
    fv.wdetJ = tb["qwts"] * detJ
    fv.h_elem = 2.0 * torch.abs(detJ) ** (1.0 / tables.dim)
    axisym = coord in ("cylindrical", "swirling")
    if axisym:
        # dV = r dr dz (h3 = r)
        fv.coord = coord
        fv.r = _guard_r(fv.x[:, 1])
        fv.wdetJ = fv.wdetJ * fv.r
    if ale:
        Jmat0 = torch.einsum("qnd,nk->qkd", tb["dNg"], X_e)
        detJ0, invJ0 = det_and_inv(Jmat0)
        fv.X0 = torch.einsum("qn,nk->qk", tb["Ng"], X_e)
        fv.wdetJ0 = tb["qwts"] * detJ0
        if axisym:
            # the reference measure carries the undisplaced radius
            fv.wdetJ0 = fv.wdetJ0 * _guard_r(fv.X0[:, 1])
        # F[k,m] = dx_k/dxi_d dxi_d/dX0_m
        fv.F = torch.einsum("qkd,qdm->qkm", Jmat, invJ0)
    else:
        fv.X0 = fv.x
        fv.wdetJ0 = fv.wdetJ

    gphi_cache: dict[str, Any] = {}
    gphi0_cache: dict[str, Any] = {}
    for s in slots:
        if s.interp == "N1":
            _nedelec_slot(fv, s, u, udot, tb, Jmat, detJ, invJ)
            continue
        Ni, dNi = tb[f"N:{s.interp}"], tb[f"dN:{s.interp}"]
        if s.interp not in gphi_cache:
            gphi_cache[s.interp] = torch.einsum("qnd,qdk->qnk", dNi, invJ)
        gp = gphi_cache[s.interp]
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gp
        fv.val[s.var] = torch.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = torch.einsum("qnk,cn->qck", gp, u[s.var])
        fv.dot[s.var] = torch.einsum("qn,cn->qc", Ni, udot[s.var])
        fv.q_nodal[s.var] = u[s.var]
        if s.interp not in ("P0", "P1E"):
            fv.lnodes[s.var] = tuple(interp_local_nodes(
                element_type(tables.elem_type).family, s.interp))
        if ale:
            if s.interp not in gphi0_cache:
                gphi0_cache[s.interp] = torch.einsum("qnd,qdk->qnk", dNi, invJ0)
            fv.gphi0[s.var] = gphi0_cache[s.interp]
            fv.grad0[s.var] = torch.einsum("qnk,cn->qck", fv.gphi0[s.var],
                                           u[s.var])
        else:
            fv.gphi0[s.var] = gp
            fv.grad0[s.var] = fv.grad[s.var]

    if ext_names:
        # frozen external nodal fields, interpolated with the geometric basis
        gphi_g = torch.einsum("qnd,qdk->qnk", tb["dNg"], invJ)
        for k, name in enumerate(ext_names):
            e = ext_e[:, k]  # (n_geom_nodes,)
            fv.ext[name] = torch.einsum("qn,n->q", tb["Ng"], e)
            fv.ext_grad[name] = torch.einsum("qnk,n->qk", gphi_g, e)
    return fv


def _nedelec_slot(fv, s, u, udot, tb, Jmat, detJ, invJ):
    """An N1 slot of ``eval_fieldvars``: the covariant (Piola) map of the
    reference vector basis, N_phys[q,i,k] = N_ref[q,i,d] invJ[q,d,k], and
    the curl, curl_ref / detJ in 2D, J . curl_ref / detJ in 3D."""
    Nv, Cv = tb[f"Nvec:{s.interp}"], tb[f"Ncurl:{s.interp}"]
    Nphys = torch.einsum("qid,qdk->qik", Nv, invJ)
    if fv.dim == 3:
        Cphys = torch.einsum("qkd,qid->qik", Jmat, Cv) / detJ[:, None, None]
    else:
        Cphys = Cv / detJ[:, None]
    c = u[s.var][0]  # (nbf,) edge circulations
    fv.phi[s.var] = Nphys
    fv.curl_phi[s.var] = Cphys
    fv.val[s.var] = torch.einsum("qik,i->qk", Nphys, c)
    if fv.dim == 3:
        fv.curl[s.var] = torch.einsum("qik,i->qk", Cphys, c)
    else:
        fv.curl[s.var] = torch.einsum("qi,i->q", Cphys, c)
    fv.dot[s.var] = torch.einsum("qik,i->qk", Nphys, udot[s.var][0])


class CurveVars(FieldVars):
    """FieldVars for shell elements (reference dimension below the space
    dimension): BAR blocks embedded in a 2D mesh and QUAD/TRI blocks
    embedded in 3D (goma_tpu's ``CurveVars``; reference shell machinery
    ``src/mm_fill_shell.c``).

    Extra attributes:
      tangent  (nq, dim)  unit tangent along a curve
      tangents (nq, 3, 2) the tangent map J_s of a surface shell
      normal   (nq, dim)  unit normal (a curve's tangent rotated -90 deg; a
                          surface's t_xi x t_eta normalized)
      wds      (nq,)      arc-length / area quadrature weight (``wdetJ``
                          aliases it)
      dphi_ds[v] (nq, nbf) arc-length derivative of the basis (curves)
      grad_s[v] (nq, ncomp) arc-length derivative of the fields (curves)
      d2phi_ds2[v], d2s[v]  second arc-length derivatives (Hermite H3)
    """

    def __init__(self):
        super().__init__()
        self.tangent = None
        self.tangents = None
        self.normal = None
        self.wds = None
        self.dphi_ds: dict[str, Any] = {}
        self.grad_s: dict[str, Any] = {}
        self.curvature = None
        self.d2s: dict[str, Any] = {}
        self.d2phi_ds2: dict[str, Any] = {}


def eval_surfvars(q_e, qdot_e, X_e, tables: BlockTables, slots, dtype,
                  ext_e=None, ext_names: tuple[str, ...] = ()) -> CurveVars:
    """Field evaluation on a QUAD/TRI shell element embedded in 3D
    (reference BILINEAR/BIQUAD_SHELL, TRISHELL, src/el_elm_info.c).
    Gradients are surface gradients (tangent-plane 3-vectors): grad_s u =
    J_s G^-1 du/dxi with J_s the (3, 2) tangent map and G = J_s^T J_s the
    first fundamental form; ``wdetJ`` integrates with sqrt(det G) dA."""
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)
    tb = tables.on(dtype, q_e.device)
    Xc = X_e + u[MESH_VAR].T if MESH_VAR in u else X_e

    fv = CurveVars()
    fv.dim = Xc.shape[1]
    Js = torch.einsum("qnd,nk->qkd", tb["dNg"], Xc)  # (nq, 3, 2)
    G = torch.einsum("qkd,qke->qde", Js, Js)  # (nq, 2, 2) metric
    detG = G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] * G[:, 1, 0]
    inv00 = G[:, 1, 1] / detG
    inv11 = G[:, 0, 0] / detG
    inv01 = -G[:, 0, 1] / detG
    Ginv = torch.stack([torch.stack([inv00, inv01], dim=1),
                        torch.stack([inv01, inv11], dim=1)], dim=1)
    dA = torch.sqrt(torch.clamp_min(detG, 1e-300))
    fv.wds = tb["qwts"] * dA
    fv.wdetJ = fv.wds
    fv.detJ = dA
    fv.tangents = Js
    cr = torch.linalg.cross(Js[:, :, 0], Js[:, :, 1], dim=1)
    fv.normal = cr / torch.linalg.vector_norm(cr, dim=1, keepdim=True)
    fv.x = torch.einsum("qn,nk->qk", tb["Ng"], Xc)
    fv.h_elem = torch.sqrt(torch.sum(fv.wds)) * torch.ones_like(dA)

    proj = torch.einsum("qkd,qde->qke", Js, Ginv)  # J_s G^-1
    for s in slots:
        Ni = tb[f"N:{s.interp}"]
        gphi = torch.einsum("qke,qne->qnk", proj, tb[f"dN:{s.interp}"])
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gphi
        fv.val[s.var] = torch.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = torch.einsum("qnk,cn->qck", gphi, u[s.var])
        fv.dot[s.var] = torch.einsum("qn,cn->qc", Ni, udot[s.var])
    if ext_names:
        gphi_g = torch.einsum("qke,qne->qnk", proj, tb["dNg"])
        for k, name in enumerate(ext_names):
            e = ext_e[:, k]
            fv.ext[name] = torch.einsum("qn,n->q", tb["Ng"], e)
            fv.ext_grad[name] = torch.einsum("qnk,n->qk", gphi_g, e)
    return fv


def eval_curvevars(q_e, qdot_e, X_e, tables: BlockTables, slots, dtype,
                   ext_e=None, ext_names: tuple[str, ...] = ()) -> CurveVars:
    """Field evaluation on a BAR element embedded in 2D: gradients are
    tangential, ``(dphi/ds) t``. A Hermite cubic (H3) slot carries dofs
    [v1, v2, s1, s2] with s the physical arc-length slope: its slope basis
    scales by ds/dxi, its derivatives divide by it."""
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)
    tb = tables.on(dtype, q_e.device)
    Xc = X_e + u[MESH_VAR].T if MESH_VAR in u else X_e

    fv = CurveVars()
    fv.dim = Xc.shape[1]
    dxds_ref = torch.einsum("qn,nk->qk", tb["dNg"][:, :, 0], Xc)  # dx/dxi
    mag = torch.sqrt(torch.sum(dxds_ref**2, dim=1) + 1e-300)
    fv.tangent = dxds_ref / mag[:, None]
    fv.normal = torch.stack([fv.tangent[:, 1], -fv.tangent[:, 0]], dim=1)
    fv.wds = tb["qwts"] * mag
    fv.wdetJ = fv.wds  # the volume measure, so generic kernels integrate
    fv.x = torch.einsum("qn,nk->qk", tb["Ng"], Xc)
    fv.detJ = mag
    fv.h_elem = torch.sum(fv.wds)  # element length
    for s in slots:
        if s.interp == "H3":
            Nh, dNh, d2Nh = (tb[f"{k}:{s.interp}"] for k in ("H3N", "H3dN",
                                                             "H3d2N"))
            ones = torch.ones_like(mag)[:, None]
            sc = torch.cat([ones, ones, mag[:, None], mag[:, None]], dim=1)
            phi = Nh * sc
            dphi = dNh * sc / mag[:, None]
            d2phi = d2Nh * sc / (mag**2)[:, None]
            c = u[s.var].reshape(-1)  # [v1, v2, s1, s2]
            fv.phi[s.var] = phi
            fv.dphi_ds[s.var] = dphi
            fv.d2phi_ds2[s.var] = d2phi
            fv.gphi[s.var] = dphi[:, :, None] * fv.tangent[:, None, :]
            fv.val[s.var] = torch.einsum("qn,n->q", phi, c)[:, None]
            fv.grad_s[s.var] = torch.einsum("qn,n->q", dphi, c)[:, None]
            fv.d2s[s.var] = torch.einsum("qn,n->q", d2phi, c)[:, None]
            fv.grad[s.var] = fv.grad_s[s.var][:, :, None] * fv.tangent[:, None, :]
            fv.dot[s.var] = torch.einsum("qn,n->q", phi,
                                         udot[s.var].reshape(-1))[:, None]
            continue
        Ni = tb[f"N:{s.interp}"]
        dphi = tb[f"dN:{s.interp}"][:, :, 0] / mag[:, None]
        fv.phi[s.var] = Ni
        fv.dphi_ds[s.var] = dphi
        fv.gphi[s.var] = dphi[:, :, None] * fv.tangent[:, None, :]
        fv.val[s.var] = torch.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad_s[s.var] = torch.einsum("qn,cn->qc", dphi, u[s.var])
        fv.grad[s.var] = fv.grad_s[s.var][:, :, None] * fv.tangent[:, None, :]
        fv.dot[s.var] = torch.einsum("qn,cn->qc", Ni, udot[s.var])
    if ext_names:
        dphi_g = tb["dNg"][:, :, 0] / mag[:, None]
        for k, name in enumerate(ext_names):
            e = ext_e[:, k]
            fv.ext[name] = torch.einsum("qn,n->q", tb["Ng"], e)
            ds = torch.einsum("qn,n->q", dphi_g, e)
            fv.ext_grad[name] = ds[:, None] * fv.tangent
    return fv
