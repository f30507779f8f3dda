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

BAR blocks embedded in a 2D mesh (the immersed curves of the overset
coupling) evaluate through ``eval_curvevars``: arc-length measure, unit
tangent and normal, tangential gradients. Cut to this slice: Lagrange
interpolations; the N1 (Nedelec) and H3 (Hermite) tables raise
``NotImplementedError`` here, and ``Problem.finalize`` refuses surface
blocks in 3D (``eval_surfvars``, a later slice, see ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from goma_tpu_torch.elements import (element_type, eval_basis, geom_interp,
                                     volume_rule)
from goma_tpu_torch.fem.dofmap import LocalSlot
from goma_tpu_torch.utils.la import det_and_inv

MESH_VAR = "mesh_displacement"
_LATER = "later slice of the port, see ROADMAP"


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
    _on: dict = field(default_factory=dict, repr=False)

    def on(self, dtype, device) -> dict:
        """The tables as tensors at ``dtype`` on ``device`` (made once per
        pair): ``qwts``, ``Ng``, ``dNg`` and ``N:<interp>``/``dN:<interp>``."""
        key = (dtype, torch.device(device))
        if key not in self._on:
            arrs = {"qwts": self.qwts, "Ng": self.Ng, "dNg": self.dNg}
            for itp in self.N:
                arrs[f"N:{itp}"] = self.N[itp]
                arrs[f"dN:{itp}"] = self.dN[itp]
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
    N, dN = {}, {}
    for itp in sorted(interps | {gi}):
        if itp in ("N1", "H3"):
            raise NotImplementedError(f"interpolation {itp}: {_LATER}")
        N[itp], dN[itp] = eval_basis(et.family, itp, qpts)
    return BlockTables(elem_type_name, et.dim, qpts.shape[0], qwts, Ng, dNg,
                       N, dN)


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
    (goma_tpu's node-anchored ``q_nodal``/``lnodes`` and the Nedelec
    attributes belong to branches this slice does not carry.)
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
        Ni, dNi = tb[f"N:{s.interp}"], tb[f"dN:{s.interp}"]
        if s.interp not in gphi_cache:
            gphi_cache[s.interp] = torch.einsum("qnd,qdk->qnk", dNi, invJ)
        gp = gphi_cache[s.interp]
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gp
        fv.val[s.var] = torch.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = torch.einsum("qnk,cn->qck", gp, u[s.var])
        fv.dot[s.var] = torch.einsum("qn,cn->qc", Ni, udot[s.var])
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


class CurveVars(FieldVars):
    """FieldVars for curve elements (reference dimension below the space
    dimension): BAR blocks embedded in a 2D mesh (goma_tpu's
    ``CurveVars``; reference shell machinery ``src/mm_fill_shell.c``).

    Extra attributes:
      tangent  (nq, dim)  unit tangent along the curve
      normal   (nq, dim)  unit normal (tangent rotated -90 deg)
      wds      (nq,)      arc-length quadrature weight (``wdetJ`` aliases it)
      dphi_ds[v] (nq, nbf) arc-length derivative of the basis
      grad_s[v] (nq, ncomp) arc-length derivative of the fields
    """

    def __init__(self):
        super().__init__()
        self.tangent = None
        self.normal = None
        self.wds = None
        self.dphi_ds: dict[str, Any] = {}
        self.grad_s: dict[str, Any] = {}
        self.curvature = None


def eval_curvevars(q_e, qdot_e, X_e, tables: BlockTables, slots, dtype,
                   ext_e=None, ext_names: tuple[str, ...] = ()) -> CurveVars:
    """Field evaluation on a BAR element embedded in 2D (goma_tpu's
    ``eval_curvevars`` without its Hermite branch, whose tables this slice
    refuses): gradients are tangential, ``(dphi/ds) t``."""
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
