"""Global residual + Jacobian assembly (counterpart of
``goma_tpu/fem/assembly.py``), cut to the slices the BASELINE decks run
(cavity, buoyant convection, viscoelastic channel, level-set bubble, ALE
slot coater) and the axisymmetric die deck.

Two element paths, chosen per block at ``finalize``:

- the Navier-Stokes Q2/Q1 Galerkin block that ``fem/fastns.py`` recognizes
  runs its fused kernel: per-element residuals and hand-derived Jacobians;
- every other block runs the generic path: the equations' integrands
  (``Equation.residual``) on the quadrature-point fields of
  ``fem/fields.py``, the element Jacobian by forward-mode AD,
  ``torch.func.vmap(torch.func.jacfwd(...))`` over the block's elements.

Integrated boundary conditions (reference ``src/bc_integ.c:84``) are face
kernels (``add_face_kernel``): per side set and block, ``vmap(jacfwd(...))``
of the face residual over the set's faces, with per-face basis tables
(``eval_surfacevars``: the planar-face branch, on the displaced
coordinates under ALE). Their element Jacobians (``faceJ``) enter the CSR
values, the row sums and the element matvec beside the blocks' (``blockJ``).

Axisymmetric coordinates (``coord="cylindrical"``/``"swirling"``) weight
volume and face integrals by r; external fields
(``Problem(external_fields=...)``) are per-node arrays
``params["ext_<name>"]``, gathered per element and mapped with the element
dofs, never closed over.

Per-element results are combined into global arrays by GATHERS through
precomputed transpose-gather maps — ``tg`` for dof-indexed vectors (R, row
sums, the element matvec) and ``nnztg`` for CSR values, each over the
block parts followed by the face parts, in goma_tpu's order. A gather + sum
is deterministic on the GPU; a scatter-add would need atomics, whose
summation order changes from run to run.

Strong conditions are row surgery on the assembled system, in goma_tpu's
order: row injection (``add_row_inject``: R[to] += s R[from], with the
pattern widened so the to-row holds the from-row's columns), point loads
(``add_point_load``: a nodal term added to rows), rotation
(``add_rotation``/``add_rotated_dirichlet``: the rows of a vector variable
rotated into normal-tangent frames, a frame row replaced by a constraint
n.u = g), point constraints (``add_point_constraint``: a row replaced by
g(q, X0, params) = 0) and Dirichlet (``R = x - x_bc``, identity rows; a
value may be parametric, f(coords, params), evaluated at assembly). Every
write is out of place (``index_put``); sums into rows that may repeat go
through host-built gather plans (``fem.sparsity.add_plan``), never an
atomic scatter. Periodicity (``add_periodic``) aliases node pairs in the
dofmap, so the pair shares its dofs and adds no rows.

Coupling sets (goma_tpu's interface, overset and edge sets) add terms
that span two elements or lie on a curve: paired faces of two blocks
(``add_interface_kernel``), immersed-curve quadrature points each paired
with the background element it lands in (``add_overset``: P0 Lagrange
multipliers on a BAR block), and the 3D edges where two side sets meet
(``add_edge_kernel``). Each set has one shape: a host-built combined
gather, a residual per row, ``vmap(jacfwd(...))`` over the combined local
dofs, and a sum into R and the CSR values through host-built gather plans
(``fem.sparsity.add_plan``/``add_at``; no atomics). The pattern holds
their couplings; they are not in the element matvec's aux, so a deck with
one takes the CSR (ELL) operator, as in goma_tpu.

Shell blocks (reference dimension below the mesh's) share the bulk's
boundary nodes: BAR blocks evaluate through ``fem.fields.eval_curvevars``
(Lagrange and Hermite H3 slots) and QUAD/TRI blocks in a 3D mesh through
``fem.fields.eval_surfvars``. A bar's endpoints are its point faces: a
face kernel there sees a unit point measure, the signed unit tangent as
its outward conormal and tangential gradients (``eval_surfacevars``'
``psign`` branch).

H(curl) edge (Nedelec, N1) blocks: a mesh whose element edges oppose the
global low-to-high orientation carries per-element signs
(``dofmap.edge_signs``, (ne, nl)); the element residual conjugates the
local dofs, history and residual by them (``q_e * s``, ``hist_e * s``,
``r * s``), so ``jacfwd`` gives S J S and every consumer of the element
Jacobian (CSR values, row sums, ``element_matvec``, the mixed-precision
prep) sees the signed arrays. N1 slots have no face trace: face, interface,
edge and overset sets leave them out, as goma_tpu does.

The public entry points are goma_tpu's: ``assemble(x, params) -> (R,
vals)``, ``residual(x, params) -> R`` (the residual-only pass) and
``bc_dup_report()``.
"""

from __future__ import annotations

import inspect
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from goma_tpu_torch import config
from goma_tpu_torch.fem import fastns
from goma_tpu_torch.fem.dofmap import DofMap, build_dofmap
from goma_tpu_torch.elements import (element_type, eval_basis, face_rule,
                                     geom_interp)
from goma_tpu_torch.elements import faces as elem_faces
from goma_tpu_torch.fem.equations import Equation, FaceKernel, SurfaceVars
from goma_tpu_torch.fem.fields import (MESH_VAR, BlockTables, _guard_r,
                                       _unpack, build_block_tables,
                                       eval_curvevars, eval_fieldvars,
                                       eval_surfvars)
from goma_tpu_torch.fem.sparsity import (CSRPattern, add_at, add_plan,
                                         build_pattern, nnz_map_for_gather)
from goma_tpu_torch.fem.sparsity import transpose_gather as _transpose_gather
from goma_tpu_torch.mesh.mesh import Mesh
from goma_tpu_torch.utils.la import det_and_inv

def eval_surfacevars(q_e, qdot_e, X_e, ftab, fwts, slots, dim,
                     dtype, coord: str = "cartesian") -> SurfaceVars:
    """FieldVars at the quadrature points of one face of one element.

    ``ftab`` holds the face's basis tables: "Ng"/"dNg" geometric, per
    interpolation "N:<interp>"/"dN:<interp>", and "refjac" (dim, dim-1),
    the face's tangent map in the element's reference coordinates. Under
    ALE the coordinates are displaced (``X_e + d``), so AD sees the normal's
    and the measure's mesh sensitivities. With an axisymmetric ``coord``
    ``wdA`` carries the raw r = x[:, 1] (dA = r ds: a face on the axis gets
    zero area), while ``fv.r`` is the guarded radius, as in goma_tpu.

    A bar's endpoint ("psign" in ``ftab``, the +-1 of its end) is a point
    face: unit point measure, the signed unit tangent of the curve as the
    outward conormal, tangential gradients (``invJ`` (nq, 1, dim) = t_hat
    / |dX/dxi|); the reference's SHELL_GRAD_* endpoint conditions,
    src/mm_shell_bc.c. Slots without face tables (Hermite H3) are left
    out there.
    """
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)
    Xc = X_e + u[MESH_VAR].T if MESH_VAR in u else X_e

    Jmat = torch.einsum("qnd,nk->qkd", ftab["dNg"], Xc)
    if "psign" in ftab:
        return _endpoint_vars(u, udot, Xc, Jmat, ftab, fwts, slots, dim,
                              coord)
    detJ, invJ = det_and_inv(Jmat)
    T = torch.einsum("qkd,dm->qkm", Jmat, ftab["refjac"])

    fv = SurfaceVars()
    fv.dim = dim
    fv.invJ = invJ
    fv.tangents = T
    if dim == 2:
        t = T[:, :, 0]
        mag = torch.linalg.vector_norm(t, dim=1)
        fv.normal = torch.stack([t[:, 1], -t[:, 0]], dim=1) / mag[:, None]
    else:
        cr = torch.linalg.cross(T[:, :, 0], T[:, :, 1], dim=1)
        mag = torch.linalg.vector_norm(cr, dim=1)
        fv.normal = cr / mag[:, None]
    fv.wdA = fwts * mag
    fv.x = torch.einsum("qn,nk->qk", ftab["Ng"], Xc)
    fv.detJ = detJ
    fv.h_elem = 2.0 * torch.abs(fv.detJ) ** (1.0 / dim)
    if coord in ("cylindrical", "swirling"):
        fv.coord = coord
        fv.r = _guard_r(fv.x[:, 1])
        fv.wdA = fv.wdA * fv.x[:, 1]

    gphi_cache = {}
    for s in slots:
        Ni, dNi = ftab[f"N:{s.interp}"], ftab[f"dN:{s.interp}"]
        if s.interp not in gphi_cache:
            gphi_cache[s.interp] = torch.einsum("qnd,qdk->qnk", dNi, invJ)
        gp = gphi_cache[s.interp]
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gp
        fv.val[s.var] = torch.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = torch.einsum("qnk,cn->qck", gp, u[s.var])
        fv.dot[s.var] = torch.einsum("qn,cn->qc", Ni, udot[s.var])
    return fv


def _endpoint_vars(u, udot, Xc, Jmat, ftab, fwts, slots, dim, coord):
    """``eval_surfacevars`` at a bar's endpoint (see there)."""
    tvec = Jmat[:, :, 0]  # dX/dxi (nq = 1, dim)
    arclen = torch.sqrt(torch.sum(tvec**2, dim=1) + 1e-300)
    that = tvec / arclen[:, None]
    fv = SurfaceVars()
    fv.dim = dim
    fv.normal = ftab["psign"] * that
    fv.wdA = fwts
    fv.detJ = arclen
    fv.h_elem = arclen
    fv.tangents = that[:, :, None]
    fv.invJ = (that / arclen[:, None])[:, None, :]  # (nq, 1, dim)
    fv.x = torch.einsum("qn,nk->qk", ftab["Ng"], Xc)
    if coord in ("cylindrical", "swirling"):
        fv.coord = coord
        fv.r = _guard_r(fv.x[:, 1])
        fv.wdA = fv.wdA * fv.x[:, 1]
    gphi_cache = {}
    for s in slots:
        if f"N:{s.interp}" not in ftab:
            continue
        Ni, dNi = ftab[f"N:{s.interp}"], ftab[f"dN:{s.interp}"]
        if s.interp not in gphi_cache:
            gphi_cache[s.interp] = torch.einsum("qnd,qdk->qnk", dNi, fv.invJ)
        gp = gphi_cache[s.interp]
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gp
        fv.val[s.var] = torch.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = torch.einsum("qnk,cn->qck", gp, u[s.var])
        fv.dot[s.var] = torch.einsum("qn,cn->qc", Ni, udot[s.var])
    return fv


@dataclass
class _FaceSet:
    """The faces of one side set in one block, with their kernels."""

    block_index: int
    kernels: list[FaceKernel]
    face_elems: np.ndarray  # (nf,) local element ids within the block
    ftabs: dict[str, np.ndarray]  # stacked per-face tables (nf, ...)
    fwts: np.ndarray  # (nqf,)
    name: str = ""


@dataclass
class _IfcSet:
    """Paired-face interface set (cross-block coupling)."""

    block_a: int
    block_b: int
    kernels: list
    elems_a: np.ndarray  # (np,)
    elems_b: np.ndarray
    ftabs_a: dict[str, np.ndarray]
    ftabs_b: dict[str, np.ndarray]
    fwts: np.ndarray
    gather_ab: np.ndarray  # (np, nla + nlb) combined dof gather
    nla: int


@dataclass
class _OvsSet:
    """Overset (fictitious-domain) coupling set: one row per immersed-curve
    quadrature point, pairing the bar element carrying the Lagrange
    multiplier with the background element that holds the point
    (reference ``src/bc_contact.c`` overlapping-grid contact)."""

    bar_block: int
    fluid_block: int
    kernels: list
    gather: np.ndarray  # (nr, nlb + nlf [+ nls]) combined dof gather
    nlb: int
    xq: np.ndarray  # (nr, dim) physical points
    wq: np.ndarray  # (nr,) arc-length quadrature weights
    Nf: dict[str, np.ndarray]  # fluid interp -> (nr, nbf) basis at the point
    # optional solid side (two-way FSI): parent-element basis at the points
    solid_block: int = -1
    Ns: dict[str, np.ndarray] | None = None  # solid interp -> (nr, nbf)


def _cast_floats(params: dict, dtype) -> dict:
    return {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in params.items()}



def _contract(w, contrib, like):
    """sum_q w_q contrib[q] flattened, at ``like``'s dtype. A term computed
    past the prep's dtype (a float64 closure in a float32 prep) is
    contracted at its own dtype and rounded once, as goma_tpu's promoting
    ``jnp.einsum`` and its scatter-add into the element vector do."""
    if contrib.dtype != w.dtype:
        w = w.to(contrib.dtype)
    return torch.einsum("q,qcn->cn", w, contrib).reshape(-1).to(like.dtype)

class Problem:
    """A finite-element problem on a mesh, with its tensors on ``device``
    (``None``: the card; the CPU only when asked for, ``device="cpu"``).
    Usage mirrors goma_tpu:

        prob = Problem(mesh, [Momentum(dim=2), Continuity()], {"rho": 1.0,
                       "mu": 0.01})
        prob.add_dirichlet("top", "velocity", 0, 1.0)
        prob.finalize()
        R, vals = prob.assemble(x, prob.base_params())
    """

    def __init__(
        self,
        mesh: Mesh,
        equations,
        materials=None,
        quad_order: int = 3,
        dtype=None,
        external_fields: tuple[str, ...] = (),
        coord: str = "cartesian",
        device=None,
    ):
        if coord not in ("cartesian", "cylindrical", "swirling"):
            raise ValueError(f"unknown coordinate system {coord!r}")
        self.coord = coord
        self.external_fields = tuple(external_fields)
        self.mesh = mesh
        if equations and isinstance(equations[0], Equation):
            equations = [list(equations) for _ in mesh.blocks]
        self.equations: list[list[Equation]] = equations
        if materials is None:
            materials = {}
        if isinstance(materials, dict):
            materials = [materials for _ in mesh.blocks]
        self.materials: list[dict] = materials
        self.quad_order = quad_order
        self._dtype = dtype
        self.device = config.resolve_device(device)
        self._dirichlet: list[tuple[str, str, int, Any]] = []
        self._face_sets: list[tuple[str, FaceKernel]] = []
        self._rot_specs: list = []
        self._rot_constraints: list = []
        self._point_specs: list = []
        self._periodic_specs: list = []
        self._point_load_specs: list = []
        self._inject_specs: list = []
        self._inject = None
        self._edge_specs: list = []
        self._ifc_specs: list = []
        self._ovs_specs: list = []
        # optional lower-precision Jacobian (mixed-precision Newton-Krylov);
        # None = same as working dtype
        self.jacobian_dtype = None

    @property
    def dtype(self):
        return self._dtype or config.fp_dtype()

    # ------------------------------------------------------------- specs
    def add_dirichlet(self, nodeset: str, var: str, comp: int, value):
        """Strong Dirichlet on a node set. ``value``: scalar, callable
        f(coords (n, dim)) -> (n,) evaluated once at ``finalize``, or
        parametric f(coords, params) evaluated at every assembly on the
        coordinates as a tensor (reference: update_parameterAC BC path,
        src/ac_update_parameter.c)."""
        self._dirichlet.append((nodeset, var, comp, value))

    def add_face_kernel(self, sideset: str, kernel: FaceKernel):
        """Integrated boundary term on a side set (reference
        ``apply_integrated_bc``, src/bc_integ.c:84)."""
        self._face_sets.append((sideset, kernel))

    def add_interface_kernel(self, pairs, kernel):
        """Cross-block interface term over the paired faces ``pairs``
        (``goma_tpu_torch.mesh.interface.find_interface_faces`` /
        ``split_interface`` / ``interior_face_pairs``); reference
        interfacial sources between discontinuous variables,
        src/mm_interface.c."""
        self._ifc_specs.append((pairs, kernel))

    def add_edge_kernel(self, sideset_a: str, sideset_b: str, kernel):
        """Integrated condition on the 3D curve where two side sets meet
        (reference ``bc_curve.c apply_integrated_curve_bc``, e.g.
        VELO_TANGENT_EDGE); ``kernel`` an EdgeKernel (``bc/edge.py``)."""
        self._edge_specs.append((sideset_a, sideset_b, kernel))

    def add_rotation(self, sidesets, var: str):
        """Rotate the nodal equations of ``var`` into normal-tangent frames
        on the given sideset(s) (reference: auto-rotation,
        src/bc/rotate_coordinates.c:707)."""
        if isinstance(sidesets, str):
            sidesets = (sidesets,)
        self._rot_specs.append((tuple(sidesets), var))

    def add_rotated_dirichlet(self, sidesets, var: str, direction: str = "normal",
                              value=0.0):
        """Replace the rotated equation in ``direction`` ("normal",
        "tangent", "tangent2") with the strong constraint q.x = value, where
        q is the corresponding frame row (e.g. n.u = 0 slip).
        Implies rotation of var on those sidesets."""
        if isinstance(sidesets, str):
            sidesets = (sidesets,)
        d = {"normal": 0, "tangent": 1, "tangent2": 2}[direction]
        self._rot_constraints.append((tuple(sidesets), var, d, value))

    def add_point_constraint(self, nodeset, var: str, replace_comp: int, g):
        """Collocated nodal constraint g(q, X0, params)=0 replacing the
        ``replace_comp`` equation row of ``var`` at each node (reference
        bc_colloc.c; geometry helpers in goma_tpu_torch.bc.pointwise)."""
        self._point_specs.append((nodeset, var, replace_comp, g))

    def add_row_inject(self, nodeset, from_var: str, to_var: str,
                       from_comp: int = 0, to_comp: int = 0,
                       sign: float = 1.0):
        """Add ``sign`` times the assembled residual/Jacobian row of
        ``from_var`` into the row of ``to_var`` at each node of ``nodeset``
        — the reference's cross-equation row moves
        (``src/mm_shell_bc.c:1743 put_lub_flux_in_film``,
        ``src/bc_colloc.c put_liquid_stress_in_solid``). Injection happens
        before rotations/point constraints/Dirichlet; the Newton solver
        then uses the CSR (ELL) operator, not the element matvec."""
        self._inject_specs.append(
            (nodeset, from_var, to_var, from_comp, to_comp, sign))

    def add_overset(self, bar_block, fluid_block, kernel, quad_order=None,
                    solid=None):
        """Overset (fictitious-domain) coupling between an immersed BAR
        block carrying the P0 multiplier ``lm`` (``physics.overset``) and a
        background block: at every quadrature point of the curve the
        background element holding it is located on the host (kd-tree +
        isoparametric inversion) and the kernel ties the background field
        there to the boundary motion (reference ``src/bc_contact.c:79``,
        ``src/mm_augc_util.c:2914``). ``quad_order=1`` collocates one
        constraint at each segment midpoint; higher orders (default: the
        problem's) enforce segment averages.

        ``solid=(solid_block, sideset)`` makes the coupling TWO-WAY (the
        BAAIJENS_SOLID_FLUID pair, ``physics.overset.OversetFSI``): the bar
        block must have been built by ``attach_shell_block(mesh, sideset)``
        so bar element i is face i of the side set; the solid parent
        element's dofs join the combined gather, and the kernel may return
        a third contribution dict for the solid rows."""
        self._ovs_specs.append((bar_block, fluid_block, kernel, quad_order,
                                solid))

    def add_periodic(self, nodeset_a: str, nodeset_b: str, translation=None,
                     tol: float = 1e-8):
        """PERIODIC_BC (reference ``include/rf_bc_const.h`` PERIODIC_BC):
        identify every node of ``nodeset_b`` with its image in
        ``nodeset_a`` under ``x_b = x_a + translation``. The paired nodes
        SHARE dofs, so periodicity is exact, conservative, and adds no
        constraint rows or sparsity. ``translation`` (dim,) defaults to the
        mean offset between the two sets. Pairs are matched by nearest
        image point; a mismatch beyond ``tol`` (relative to the mesh
        extent) raises."""
        self._periodic_specs.append((nodeset_a, nodeset_b, translation, tol))

    def _periodic_alias(self):
        """Root-node map from the registered periodic identifications
        (union-find so doubly-periodic corners chain correctly)."""
        if not self._periodic_specs:
            return None
        from scipy.spatial import cKDTree

        mesh = self.mesh
        root = np.arange(mesh.n_nodes, dtype=np.int64)

        def find(i):
            while root[i] != i:
                root[i] = root[root[i]]
                i = root[i]
            return i

        scale = float(np.max(np.ptp(mesh.coords, axis=0)))
        for ns_a, ns_b, tr, tol in self._periodic_specs:
            a = np.asarray(mesh.nodesets[ns_a], dtype=np.int64)
            b = np.asarray(mesh.nodesets[ns_b], dtype=np.int64)
            if a.size != b.size:
                raise ValueError(
                    f"periodic sets '{ns_a}' ({a.size}) and '{ns_b}' "
                    f"({b.size}) differ in size")
            ca, cb = mesh.coords[a], mesh.coords[b]
            t = (np.mean(cb, axis=0) - np.mean(ca, axis=0)
                 if tr is None else np.asarray(tr, dtype=float))
            d, j = cKDTree(cb).query(ca + t[None, :])
            if np.max(d) > tol * max(scale, 1.0) or \
                    len(np.unique(j)) != a.size:
                raise ValueError(
                    f"periodic match '{ns_a}'->'{ns_b}' failed: max image "
                    f"distance {np.max(d):.3e} (tol {tol * max(scale, 1.0):.1e})"
                    " or non-bijective pairing; pass an explicit translation")
            for m, s in zip(a, b[j]):
                rm, rs = find(int(m)), find(int(s))
                if rm != rs:
                    root[max(rm, rs)] = min(rm, rs)
        for i in range(mesh.n_nodes):
            find(i)
        return root

    def add_point_load(self, nodeset, var: str, f, source_vars=None):
        """Additive weak nodal term (reference "special" BCs,
        ``src/bc_special.c:77``): ``f(q, X0, params) -> (ncomp(var),)`` is
        ADDED to the residual rows of ``var`` at each node of the set, with
        its row Jacobian from AD. ``q`` concatenates the components of
        ``source_vars`` (default ``[var]``) at the node."""
        self._point_load_specs.append((nodeset, var, source_vars, f))

    def bc_dup_report(self) -> str:
        """Human-readable table of every BC duplicate/conflict resolution
        made at finalize — the analog of the reference's ``-bc_dup``
        diagnostic file (``src/mm_bc_conflict.c`` writes bc_dup.txt listing
        which condition was kept/discarded at each contested node)."""
        log = getattr(self, "bc_dup_log", [])
        if not log:
            return "bc_dup: no duplicate boundary conditions detected"
        lines = [f"bc_dup: {len(log)} resolution(s)",
                 "  row      node   kept -> dropped   [rule]"]
        for e in log:
            node = e.get("node", "-")
            lines.append(f"  {e['row']:<8} {node:<6} {e['kept']} -> "
                         f"{e['dropped']}   [{e['rule']}]")
        return "\n".join(lines)

    # ------------------------------------------------------------- finalize
    def finalize(self):
        """Build the dofmap, the coupling sets, the CSR pattern, the face
        and edge sets, the strong conditions and the device tables. Called
        again after the mesh moved (an overset curve's new position), it
        rebuilds them all."""
        mesh = self.mesh
        block_vars = [
            [(eq.var, eq.ncomp, eq.interp) for eq in eqs] for eqs in self.equations
        ]
        self.dofmap: DofMap = build_dofmap(
            mesh, block_vars, node_alias=self._periodic_alias())
        # fused fast-path recognition (fem/fastns.py); every other block
        # takes the generic AD path
        self._fast_meta = {}
        for bi, bd in enumerate(self.dofmap.blocks):
            m = fastns.match_ns_q2q1(self, bi)
            if m is not None:
                self._fast_meta[bi] = m
                continue
            if (element_type(bd.elem_type).dim < mesh.dim
                    and self.coord != "cartesian"):
                raise NotImplementedError(
                    "shell/curve blocks are not supported in axisymmetric "
                    "coordinates yet")
            for eq in self.equations[bi]:
                eq.check_slice()
        self.tables: list[BlockTables] = [
            build_block_tables(blk.elem_type, {s.interp for s in bd.slots},
                               self.quad_order)
            for bd, blk in zip(self.dofmap.blocks, mesh.blocks)]
        gathers = [b.gather for b in self.dofmap.blocks]
        # interface (paired-face) and overset sets add cross-element
        # couplings to the graph
        self.ifc_sets: list[_IfcSet] = self._build_interface_sets()
        self.ovs_sets: list[_OvsSet] = self._build_overset_sets()
        self.pattern: CSRPattern = self._build_pattern_with_inject(
            gathers + [s.gather_ab for s in self.ifc_sets]
            + [s.gather for s in self.ovs_sets])
        self._nnz_maps = [nnz_map_for_gather(self.pattern, g) for g in gathers]
        self._ifc_nnz = [nnz_map_for_gather(self.pattern, s.gather_ab)
                         for s in self.ifc_sets]
        self._ovs_nnz = [nnz_map_for_gather(self.pattern, s.gather)
                         for s in self.ovs_sets]

        # face sets: the registered kernels grouped by side set (in the
        # order of first registration), split by block
        bysset: dict[str, list[FaceKernel]] = {}
        for name, k in self._face_sets:
            bysset.setdefault(name, []).append(k)
        self.face_sets: list[_FaceSet] = []
        for name, kernels in bysset.items():
            self.face_sets.extend(self._build_face_set(name, kernels))
        # 3D edge-curve sets (bc_curve.c): the registered kernels grouped by
        # side-set pair, the intersections found on the host
        bypair: dict[tuple[str, str], list] = {}
        for sa, sb, k in self._edge_specs:
            bypair.setdefault((sa, sb), []).append(k)
        self.edge_sets = []
        if bypair:
            from goma_tpu_torch.bc.edge import build_edge_sets

            for (sa, sb), kernels in bypair.items():
                self.edge_sets.extend(build_edge_sets(self, sa, sb, kernels))

        # Dirichlet arrays. Duplicate resolution keeps the FIRST spec in the
        # deck, with a warning when a later spec carries a conflicting value
        # (the reference's dup rule, src/mm_bc_conflict.c:832-851); a
        # parametric value (f(coords, params)) is a NaN placeholder here,
        # takes part in the precedence only and is evaluated at assembly
        self.bc_dup_log: list[dict] = []
        dofs, vals = [], []
        param_specs = []  # (spec slice start, dofs, coords, fn) before dedup
        for nodeset, var, comp, value in self._dirichlet:
            if nodeset.startswith("sideset:"):
                nodes = mesh.sideset_nodes(nodeset.split(":", 1)[1])
            else:
                nodes = mesh.nodesets[nodeset]
            d = self.dofmap.dof_of_node_svar[nodes, self.dofmap.svar(var, comp)]
            ok = d >= 0
            d = d[ok]
            x = mesh.coords[nodes[ok]]
            if callable(value) and len(inspect.signature(value).parameters) >= 2:
                start = sum(a.shape[0] for a in dofs)
                param_specs.append((start, d.astype(np.int64), x, value))
                v = np.full(d.shape, np.nan)
            else:
                v = value(x) if callable(value) else np.full(d.shape, float(value))
            dofs.append(d)
            vals.append(np.asarray(v, dtype=np.float64))
        self._param_dirichlet: list[tuple[np.ndarray, np.ndarray, Any]] = []
        if dofs:
            dd = np.concatenate(dofs).astype(np.int64)
            vv = np.concatenate(vals)
            uniq, first = np.unique(dd, return_index=True)
            keep_mask = np.zeros(dd.shape[0], dtype=bool)
            keep_mask[first] = True
            owner_val = vv[first][np.searchsorted(uniq, dd)]
            conf = (
                ~keep_mask
                & np.isfinite(vv)
                & np.isfinite(owner_val)
                & (np.abs(vv - owner_val)
                   > 1e-8 * np.maximum(1.0, np.maximum(np.abs(vv), np.abs(owner_val))))
            )
            if conf.any():
                warnings.warn(
                    f"{int(conf.sum())} Dirichlet entries conflict with an "
                    "earlier spec at the same dof; first spec takes "
                    "precedence (mm_bc_conflict.c dup rule)",
                    stacklevel=2,
                )
            for r in dd[~keep_mask]:
                self.bc_dup_log.append({
                    "row": int(r), "kept": "DIRICHLET (first spec)",
                    "dropped": "DIRICHLET (later spec)",
                    "rule": "first occurrence kept "
                            "(mm_bc_conflict.c:832)"})
            self.dirichlet_dofs = dd[keep_mask]
            self.dirichlet_vals = np.nan_to_num(vv[keep_mask])
            # parametric specs keep only the entries they own
            for start, d, x, fn in param_specs:
                own = keep_mask[start:start + d.shape[0]]
                if own.any():
                    self._param_dirichlet.append((d[own], x[own], fn))
        else:
            self.dirichlet_dofs = np.empty(0, dtype=np.int64)
            self.dirichlet_vals = np.empty(0, dtype=np.float64)
        dmask = np.zeros(self.dofmap.n_dof, dtype=bool)
        dmask[self.dirichlet_dofs] = True
        self._dir_mask = dmask
        self._dir_nnz_keep = (~dmask[self.pattern.rows]).astype(np.float64)
        self._dir_diag_pos = self.pattern.diag[self.dirichlet_dofs]

        # rotated conditions, then collocated point constraints (which
        # yield to the rotated constraint rows), then additive point loads
        from goma_tpu_torch.bc.pointwise import (build_point_constraints,
                                                 build_point_loads)
        from goma_tpu_torch.bc.rotation import build_rotation

        self._rotation = build_rotation(self, self._rot_specs,
                                        self._rot_constraints)
        self._point_sets = build_point_constraints(self, self._point_specs)
        self._point_loads = build_point_loads(self, self._point_load_specs)

        # transpose-gather map: for every dof, the positions of its
        # contributions in the concatenated (blocks..., faces...)
        # element-local vectors (pad -> the trailing zero slot)
        face_g = [gathers[fs.block_index][fs.face_elems]
                  for fs in self.face_sets]
        flat = np.concatenate([g.ravel() for g in gathers + face_g]
                              ).astype(np.int64)
        self._tgather_pos = _transpose_gather(flat, self.dofmap.n_dof)
        # the same for CSR values: per nnz entry, the positions of its
        # contributions in the concatenated element- and face-Jacobian
        # arrays
        face_n = [self._nnz_maps[fs.block_index][fs.face_elems]
                  for fs in self.face_sets]
        flatn = np.concatenate([m.ravel() for m in self._nnz_maps + face_n])
        self._nnz_tgather = _transpose_gather(flatn, self.pattern.nnz)

        self._fast_static: dict[int, dict] = {}
        self._build_tables()

    def _build_pattern_with_inject(self, gathers) -> CSRPattern:
        """The CSR pattern of the blocks' gathers, widened for the row
        injections (``add_row_inject``) so each to-row holds every column of
        its from-row plus the mutual (to, from) and (from, to) entries; sets
        ``_inject`` (rows, CSR positions and signs of each pair) or None.
        Chained injections (a to-row that is also a from-row) raise."""
        mesh, dm = self.mesh, self.dofmap
        inj_pairs: list[tuple[int, int, float]] = []
        for (nodeset, fvar, tvar, fc, tc, sg) in self._inject_specs:
            nodes = mesh.nodesets[nodeset] if isinstance(nodeset, str) \
                else np.asarray(nodeset)
            for node in np.sort(np.asarray(nodes)):
                fr = int(dm.dof_of_node_svar[node, dm.svar(fvar, fc)])
                tr = int(dm.dof_of_node_svar[node, dm.svar(tvar, tc)])
                if fr < 0 or tr < 0:
                    continue
                inj_pairs.append((fr, tr, float(sg)))
        self._inject = None
        if not inj_pairs:
            return build_pattern(dm.n_dof, gathers)
        if {p[0] for p in inj_pairs} & {p[1] for p in inj_pairs}:
            raise NotImplementedError(
                "chained row injections (a to-row is also a from-row) "
                "are not supported")
        pat0 = build_pattern(dm.n_dof, gathers)
        n64 = np.int64(dm.n_dof)
        keys = []
        for fr, tr, _ in inj_pairs:
            cols = pat0.indices[pat0.indptr[fr]:pat0.indptr[fr + 1]]
            keys.append(np.int64(tr) * n64 + cols.astype(np.int64))
            keys.append(np.array([np.int64(tr) * n64 + fr,
                                  np.int64(fr) * n64 + tr]))
        pat = build_pattern(dm.n_dof, gathers, extra_keys=np.concatenate(keys))
        fp_l, tp_l, ps_l = [], [], []
        for fr, tr, sg in inj_pairs:
            p0, p1 = int(pat.indptr[fr]), int(pat.indptr[fr + 1])
            cols = pat.indices[p0:p1]
            tp = pat.find(np.full(cols.shape, tr), cols)
            if np.any(tp < 0):
                raise RuntimeError("row-inject target entries missing")
            fp_l.append(np.arange(p0, p1, dtype=np.int64))
            tp_l.append(tp)
            ps_l.append(np.full(cols.shape, sg))
        self._inject = {
            "from_rows": np.array([p[0] for p in inj_pairs]),
            "to_rows": np.array([p[1] for p in inj_pairs]),
            "sign_rows": np.array([p[2] for p in inj_pairs]),
            "from_pos": np.concatenate(fp_l),
            "to_pos": np.concatenate(tp_l),
            "sign_pos": np.concatenate(ps_l),
        }
        return pat

    def _build_face_set(self, sideset_name: str,
                        kernels: list[FaceKernel]) -> list[_FaceSet]:
        """One _FaceSet per block the side set touches: the faces' local
        element ids and their basis tables at the face quadrature points
        (geometric and per interpolation, plus each face's reference tangent
        map), host numpy."""
        mesh = self.mesh
        ss = mesh.sidesets[sideset_name]
        per_block: dict[int, list[tuple[int, int]]] = {}
        for e, f in zip(ss.elems, ss.faces):
            bi, le = mesh.global_elem_block(int(e))
            per_block.setdefault(bi, []).append((le, int(f)))
        out = []
        for bi, lst in per_block.items():
            blk = mesh.blocks[bi]
            bd = self.dofmap.blocks[bi]
            et = element_type(blk.elem_type)
            gi = geom_interp(et)
            fpts, fwts = face_rule(et.family, self.quad_order)
            all_faces = elem_faces(et.family)
            # edge (N1) slots have no scalar face trace; Hermite (H3)
            # traces would need the per-element arc-length slope scaling:
            # both left out, as in goma_tpu
            interps = {s.interp for s in bd.slots
                       if s.interp not in ("N1", "H3")}
            Ngs, dNgs, refjacs = [], [], []
            Ni: dict[str, list] = {i: [] for i in interps}
            dNi: dict[str, list] = {i: [] for i in interps}
            for _, f in lst:
                face = all_faces[f]
                epts = face.ref_map(fpts)
                Ng, dNg = eval_basis(et.family, gi, epts)
                Ngs.append(Ng)
                dNgs.append(dNg)
                refjacs.append(face.ref_jac)
                for itp in interps:
                    N, dN = eval_basis(et.family, itp, epts)
                    Ni[itp].append(N)
                    dNi[itp].append(dN)
            ftabs = {"Ng": np.stack(Ngs), "dNg": np.stack(dNgs),
                     "refjac": np.stack(refjacs)}
            if et.family == "bar":
                # outward sign of the endpoint conormal (+-xi end)
                ftabs["psign"] = np.array(
                    [[[all_faces[f].ref_origin[0]]] for _, f in lst])
            for itp in interps:
                ftabs[f"N:{itp}"] = np.stack(Ni[itp])
                ftabs[f"dN:{itp}"] = np.stack(dNi[itp])
            out.append(_FaceSet(
                block_index=bi, kernels=kernels,
                face_elems=np.array([le for le, _ in lst], dtype=np.int64),
                ftabs=ftabs, fwts=fwts, name=sideset_name))
        return out

    def _build_interface_sets(self) -> list[_IfcSet]:
        """Per registered pairing: the A side's face quadrature tables, the
        B side's basis tables at the MATCHING reference points (host Newton
        inversion of B's face map at A's physical points) and the combined
        (nla + nlb) dof gather whose ``jacfwd`` gives the cross-block
        Jacobian blocks. Host numpy, goma_tpu's construction."""
        out = []
        bykey: dict[int, tuple] = {}
        for pairs, k in self._ifc_specs:
            bykey.setdefault(id(pairs), (pairs, []))[1].append(k)
        mesh = self.mesh
        for pairs, kernels in bykey.values():
            ba, bb = pairs.block_a, pairs.block_b
            blk_a, blk_b = mesh.blocks[ba], mesh.blocks[bb]
            bd_a, bd_b = self.dofmap.blocks[ba], self.dofmap.blocks[bb]
            et_a, et_b = element_type(blk_a.elem_type), element_type(blk_b.elem_type)
            gi_a, gi_b = geom_interp(et_a), geom_interp(et_b)
            fpts, fwts = face_rule(et_a.family, self.quad_order)
            faces_a = elem_faces(et_a.family)
            faces_b = elem_faces(et_b.family)
            interps_a = {s.interp for s in bd_a.slots if s.interp != "N1"}
            interps_b = {s.interp for s in bd_b.slots if s.interp != "N1"}
            ta = {"Ng": [], "dNg": [], "refjac": []}
            tb = {"Ng": [], "dNg": [], "refjac": []}
            Na = {i: [] for i in interps_a}
            dNa = {i: [] for i in interps_a}
            Nb = {i: [] for i in interps_b}
            dNb = {i: [] for i in interps_b}
            for la, fa, lb, fb in zip(pairs.elems_a, pairs.faces_a,
                                      pairs.elems_b, pairs.faces_b):
                face_a = faces_a[int(fa)]
                epts_a = face_a.ref_map(fpts)
                Ng_a, dNg_a = eval_basis(et_a.family, gi_a, epts_a)
                xq = Ng_a @ mesh.coords[blk_a.conn[int(la)]]  # (nq, dim)
                # invert B's face map at each physical point (host Newton)
                face_b = faces_b[int(fb)]
                Xb = mesh.coords[blk_b.conn[int(lb)]]
                s_ref = np.zeros((fpts.shape[0], face_b.ref_jac.shape[1]))
                for _ in range(30):
                    Ng_b, dNg_b = eval_basis(et_b.family, gi_b,
                                             face_b.ref_map(s_ref))
                    dxds = np.einsum("qnd,df,nk->qkf", dNg_b,
                                     face_b.ref_jac, Xb)
                    r = Ng_b @ Xb - xq
                    JtJ = np.einsum("qkf,qkg->qfg", dxds, dxds)
                    Jtr = np.einsum("qkf,qk->qf", dxds, r)
                    ds = np.linalg.solve(JtJ, Jtr[:, :, None])[:, :, 0]
                    s_ref = s_ref - ds
                    if np.abs(ds).max() < 1e-13:
                        break
                epts_b = face_b.ref_map(s_ref)
                Ng_b, dNg_b = eval_basis(et_b.family, gi_b, epts_b)
                if np.abs(Ng_b @ Xb - xq).max() > 1e-8:
                    raise RuntimeError("interface faces are not conforming")
                for tab, vals in ((ta, (Ng_a, dNg_a, face_a.ref_jac)),
                                  (tb, (Ng_b, dNg_b, face_b.ref_jac))):
                    for key, v in zip(("Ng", "dNg", "refjac"), vals):
                        tab[key].append(v)
                for et, epts, N_, dN_ in ((et_a, epts_a, Na, dNa),
                                          (et_b, epts_b, Nb, dNb)):
                    for itp in N_:
                        N, dN = eval_basis(et.family, itp, epts)
                        N_[itp].append(N)
                        dN_[itp].append(dN)
            ftabs_a = {k: np.stack(v) for k, v in ta.items()}
            ftabs_b = {k: np.stack(v) for k, v in tb.items()}
            for itp in interps_a:
                ftabs_a[f"N:{itp}"] = np.stack(Na[itp])
                ftabs_a[f"dN:{itp}"] = np.stack(dNa[itp])
            for itp in interps_b:
                ftabs_b[f"N:{itp}"] = np.stack(Nb[itp])
                ftabs_b[f"dN:{itp}"] = np.stack(dNb[itp])
            ga = bd_a.gather[pairs.elems_a]
            gb = bd_b.gather[pairs.elems_b]
            out.append(_IfcSet(
                block_a=ba, block_b=bb, kernels=kernels,
                elems_a=np.asarray(pairs.elems_a),
                elems_b=np.asarray(pairs.elems_b),
                ftabs_a=ftabs_a, ftabs_b=ftabs_b, fwts=fwts,
                gather_ab=np.concatenate([ga, gb], axis=1), nla=ga.shape[1]))
        return out

    def _build_overset_sets(self) -> list[_OvsSet]:
        """Host precomputation of the overset couplings: the immersed
        curve's quadrature points and arc weights from the BAR geometry,
        the background element holding each point (centroid kd-tree +
        isoparametric Newton inversion, the host analog of the reference's
        point search in src/bc_contact.c), the background basis at the
        landed reference point, and the combined [bar, fluid] dof gather;
        with a solid side, the point inverted into its solid parent element
        too, that element's basis there and its dofs appended to the
        gather. Host numpy, goma_tpu's construction."""
        if not self._ovs_specs:
            return []
        from scipy.spatial import cKDTree

        from goma_tpu_torch.elements import volume_rule
        from goma_tpu_torch.post.particles import _invert_map

        mesh = self.mesh
        name2bi = {b.name: i for i, b in enumerate(mesh.blocks)}
        bykey: dict[tuple, list] = {}
        for bb, fb, k, qo, solid in self._ovs_specs:
            bb = name2bi[bb] if isinstance(bb, str) else int(bb)
            fb = name2bi[fb] if isinstance(fb, str) else int(fb)
            bykey.setdefault((bb, fb, qo, solid), []).append(k)
        out = []
        for (bb, fb, qo, solid), kernels in bykey.items():
            blk_b, blk_f = mesh.blocks[bb], mesh.blocks[fb]
            bd_b, bd_f = self.dofmap.blocks[bb], self.dofmap.blocks[fb]
            et_b, et_f = element_type(blk_b.elem_type), element_type(blk_f.elem_type)
            if et_b.family != "bar":
                raise ValueError("overset multiplier block must be a BAR block")
            qpts, qwts = volume_rule("bar", qo or self.quad_order)
            Ng, dNg = eval_basis("bar", geom_interp(et_b), qpts)
            interps_f = sorted({s.interp for s in bd_f.slots
                                if s.interp != "N1"})
            cents = mesh.coords[blk_f.conn].mean(axis=1)
            tree = cKDTree(cents)
            # the optional solid side: bar element i is side-set face i
            sb, interps_s = -1, []
            if solid is not None:
                sb, ssname = solid
                sb = name2bi[sb] if isinstance(sb, str) else int(sb)
                ss = mesh.sidesets[ssname]
                if len(ss.elems) != blk_b.n_elem:
                    raise ValueError(
                        "overset solid coupling: bar block must be the shell "
                        "block attached to the given sideset (one bar element "
                        "per face)")
                blk_s, bd_s = mesh.blocks[sb], self.dofmap.blocks[sb]
                et_s = element_type(blk_s.elem_type)
                interps_s = sorted({s.interp for s in bd_s.slots
                                    if s.interp != "N1"})
            rows_g, xs, ws = [], [], []
            Nfs: dict[str, list] = {i: [] for i in interps_f}
            Nss: dict[str, list] = {i: [] for i in interps_s}
            for le in range(blk_b.n_elem):
                Xb = mesh.coords[blk_b.conn[le]]
                xq = Ng @ Xb  # (nq, dim)
                tang = np.einsum("qn,nk->qk", dNg[:, :, 0], Xb)
                wq = qwts * np.linalg.norm(tang, axis=1)
                _, cand = tree.query(xq, k=min(8, cents.shape[0]))
                cand = np.atleast_2d(cand)
                for iq in range(qpts.shape[0]):
                    fe = -1
                    for ge in cand[iq]:
                        xi, ok = _invert_map(et_f, mesh.coords[blk_f.conn[ge]],
                                             xq[iq])
                        if ok:
                            fe = int(ge)
                            break
                    if fe < 0:
                        raise RuntimeError(
                            f"overset point {xq[iq]} lies outside the "
                            f"background block '{blk_f.name}'")
                    row = [bd_b.gather[le], bd_f.gather[fe]]
                    if solid is not None:
                        se = int(mesh.global_elem_block(int(ss.elems[le]))[1])
                        xi_s, ok = _invert_map(et_s,
                                               mesh.coords[blk_s.conn[se]],
                                               xq[iq])
                        if not ok:
                            raise RuntimeError(
                                "overset point does not invert into its "
                                "solid parent element")
                        for itp in interps_s:
                            N, _ = eval_basis(et_s.family, itp, xi_s[None, :])
                            Nss[itp].append(N[0])
                        row.append(bd_s.gather[se])
                    rows_g.append(np.concatenate(row))
                    xs.append(xq[iq])
                    ws.append(wq[iq])
                    for itp in interps_f:
                        N, _ = eval_basis(et_f.family, itp, xi[None, :])
                        Nfs[itp].append(N[0])
            out.append(_OvsSet(
                bar_block=bb, fluid_block=fb, kernels=kernels,
                gather=np.stack(rows_g).astype(np.int32), nlb=bd_b.n_ldof,
                xq=np.stack(xs), wq=np.asarray(ws),
                Nf={i: np.stack(v) for i, v in Nfs.items()},
                solid_block=sb,
                Ns={i: np.stack(v) for i, v in Nss.items()} if interps_s
                else None))
        return out

    def _build_tables(self):
        """Static tables as tensors on ``self.device``."""
        dt = self.dtype
        dev = self.device

        def put(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        T = {}
        for bi, (bd, blk) in enumerate(zip(self.dofmap.blocks, self.mesh.blocks)):
            T[f"g{bi}"] = put(bd.gather.astype(np.int64))
            if bi not in self._fast_meta:
                # generic block: element node coordinates and connectivity
                # (the external fields' gather)
                T[f"x{bi}"] = put(self.mesh.coords[blk.conn], dt)
                T[f"c{bi}"] = put(blk.conn.astype(np.int64))
                if bd.edge_signs is not None:
                    T[f"sg{bi}"] = put(bd.edge_signs, dt)
                continue
            tabs, static = fastns.build_tables(self, bi)
            self._fast_static[bi] = static
            for k, a in tabs.items():
                T[f"{k}{bi}"] = put(a, dt)
                if dt == torch.float64:
                    # pre-cast f32 copy for the mixed-precision Jacobian
                    T[f"{k}32:{bi}"] = put(a, torch.float32)
            ng = fastns.build_node_gather(self, bi)
            if ng is not None:
                T[f"fns:gnode{bi}"] = put(ng[0])
                T[f"fns:gp{bi}"] = put(ng[1])
        for j, fs in enumerate(self.face_sets):
            bd = self.dofmap.blocks[fs.block_index]
            blk = self.mesh.blocks[fs.block_index]
            T[f"fg{j}"] = put(bd.gather[fs.face_elems].astype(np.int64))
            T[f"fx{j}"] = put(self.mesh.coords[blk.conn[fs.face_elems]], dt)
            for k, v in fs.ftabs.items():
                T[f"ft{j}:{k}"] = put(v, dt)
            T[f"fw{j}"] = put(fs.fwts, dt)
        # coupling sets: geometry, bases, and per set the gather plans of its
        # rows into R (key ":r") and of its Jacobian into the values (":v")
        coords = self.mesh.coords

        def plans(key, gather, nmap):
            for tag, tgt in (("r", gather), ("v", nmap)):
                uniq, pos = add_plan(tgt)
                T[f"{key}:{tag}u"], T[f"{key}:{tag}p"] = put(uniq), put(pos)

        for j, es in enumerate(self.edge_sets):
            bd = self.dofmap.blocks[es.block_index]
            blk = self.mesh.blocks[es.block_index]
            T[f"eg{j}"] = put(bd.gather[es.edge_elems].astype(np.int64))
            T[f"ex{j}"] = put(coords[blk.conn[es.edge_elems]], dt)
            for k, v in es.etabs.items():
                T[f"et{j}:{k}"] = put(v, dt)
            plans(f"e{j}", bd.gather[es.edge_elems],
                  self._nnz_maps[es.block_index][es.edge_elems])
        for j, st in enumerate(self.ifc_sets):
            T[f"ig{j}"] = put(st.gather_ab.astype(np.int64))
            T[f"ixa{j}"] = put(coords[self.mesh.blocks[st.block_a].conn[st.elems_a]], dt)
            T[f"ixb{j}"] = put(coords[self.mesh.blocks[st.block_b].conn[st.elems_b]], dt)
            for k, v in st.ftabs_a.items():
                T[f"ita{j}:{k}"] = put(v, dt)
            for k, v in st.ftabs_b.items():
                T[f"itb{j}:{k}"] = put(v, dt)
            plans(f"i{j}", st.gather_ab, self._ifc_nnz[j])
        for j, st in enumerate(self.ovs_sets):
            T[f"og{j}"] = put(st.gather.astype(np.int64))
            T[f"ox{j}"] = put(st.xq, dt)
            T[f"ow{j}"] = put(st.wq, dt)
            for k, v in st.Nf.items():
                T[f"oN{j}:{k}"] = put(v, dt)
            for k, v in (st.Ns or {}).items():
                T[f"oNs{j}:{k}"] = put(v, dt)
            plans(f"o{j}", st.gather, self._ovs_nnz[j])
        T["tg"] = put(self._tgather_pos)
        T["nnztg"] = put(self._nnz_tgather)
        T["dirmask"] = put(self._dir_mask)
        T["dirdofs"] = put(self.dirichlet_dofs.astype(np.int64))
        T["dirkeep"] = put(self._dir_nnz_keep, dt)
        T["dirdiag"] = put(self._dir_diag_pos.astype(np.int64))
        for k, (d, xc, _) in enumerate(self._param_dirichlet):
            T[f"pd{k}:dofs"] = put(d)
            T[f"pd{k}:coords"] = put(xc, dt)
        rd = self._rotation
        if rd is not None:
            T["rQ"] = put(rd.Q, dt)
            T["rpos"] = put(rd.pos.astype(np.int64))
            T["rnode"] = put(rd.entry_node.astype(np.int64))
            T["rdofs"] = put(rd.dofs.astype(np.int64))
            if rd.con_rows.size:
                T["rcrow"] = put(rd.con_rows)
                T["rcoef"] = put(rd.con_coeff, dt)
                T["rcdofs"] = put(rd.con_dofs)
                T["rczero"] = put(np.concatenate(rd.con_row_mask_pos))
                T["rcepos"] = put(rd.con_entry_pos)
                T["rcval"] = put(rd.con_value, dt)
        for k, pc in enumerate(self._point_sets):
            T[f"pc{k}:rows"] = put(pc.rows)
            T[f"pc{k}:dofs"] = put(pc.dofs.astype(np.int64))
            T[f"pc{k}:coords"] = put(pc.coords, dt)
            T[f"pc{k}:epos"] = put(pc.entry_pos.astype(np.int64))
            T[f"pc{k}:zero"] = put(pc.zero_pos.astype(np.int64))
        for k, pl in enumerate(self._point_loads):
            T[f"pld{k}:rows"] = put(pl.rows)
            T[f"pld{k}:dofs"] = put(pl.dofs.astype(np.int64))
            T[f"pld{k}:coords"] = put(pl.coords, dt)
            for key, tgt in (("r", pl.rows), ("e", pl.entry_pos)):
                uniq, pos = add_plan(tgt)
                T[f"pld{k}:{key}u"], T[f"pld{k}:{key}p"] = put(uniq), put(pos)
        inj = self._inject
        if inj is not None:
            for key, tgt in (("r", inj["to_rows"]), ("e", inj["to_pos"])):
                uniq, pos = add_plan(tgt)
                T[f"inj:{key}u"], T[f"inj:{key}p"] = put(uniq), put(pos)
            T["inj:from_rows"] = put(inj["from_rows"].astype(np.int64))
            T["inj:sign_rows"] = put(inj["sign_rows"], dt)
            T["inj:from_pos"] = put(inj["from_pos"])
            T["inj:sign_pos"] = put(inj["sign_pos"], dt)
        self._tables = T

    def base_params(self, **extra) -> dict:
        """Default parameters on the problem's device: steady state,
        registered Dirichlet values, a per-node ``ext_<name>`` array for
        each external field (zero unless given in ``extra``, numpy or
        tensor). (goma_tpu also carries its device tables
        here as ``_tables``; the port keeps them on the Problem.)"""
        dt, dev = self.dtype, self.device
        p = {
            "ct": torch.zeros((), dtype=dt, device=dev),  # d(qdot)/d(q)
            "hist": torch.zeros(self.dofmap.n_dof, dtype=dt, device=dev),
            "dirichlet_val": torch.as_tensor(self.dirichlet_vals, dtype=dt,
                                             device=dev),
            "time": torch.zeros((), dtype=dt, device=dev),
        }
        for name in self.external_fields:
            p[f"ext_{name}"] = torch.zeros(self.mesh.n_nodes, dtype=dt,
                                           device=dev)
        # external fields may come in as host numpy (per-node arrays)
        p.update({k: torch.as_tensor(v, dtype=dt, device=dev)
                  if k.startswith("ext_") else v for k, v in extra.items()})
        return p

    def set_nodal_field(self, x, var: str, comp: int, values) -> np.ndarray:
        """Write per-node values (array over all mesh nodes, or callable of
        coords) into the solution vector for (var, comp). Host numpy in and
        out, as in goma_tpu; returns a copy."""
        x = np.array(x, copy=True)
        dofs = self.dofmap.dof_of_node_svar[:, self.dofmap.svar(var, comp)]
        ok = dofs >= 0
        v = values(self.mesh.coords) if callable(values) else np.asarray(values)
        if np.ndim(v) == 0:
            v = np.full(self.mesh.coords.shape[0], float(v))
        x[dofs[ok]] = v[ok]
        return x

    def get_nodal_field(self, x, var: str, comp: int = 0, fill=np.nan) -> np.ndarray:
        """Per-node values of (var, comp) of a host vector; inactive nodes
        get ``fill``."""
        dofs = self.dofmap.dof_of_node_svar[:, self.dofmap.svar(var, comp)]
        out = np.full(self.mesh.coords.shape[0], fill)
        ok = dofs >= 0
        out[ok] = np.asarray(x)[dofs[ok]]
        return out

    # ------------------------------------------------------------- assembly
    def _apply_inject(self, R, vals):
        """Cross-equation row injection (``add_row_inject``): R[to] +=
        s R[from] and the matching CSR row entries. Runs on the raw
        assembled system, before point loads, rotation, point constraints
        and Dirichlet."""
        if self._inject is None:
            return R, vals
        T = self._tables
        R = add_at(R, T["inj:ru"], T["inj:rp"],
                   T["inj:sign_rows"].to(R.dtype) * R[T["inj:from_rows"]])
        if vals is not None:
            vals = add_at(vals, T["inj:eu"], T["inj:ep"],
                          T["inj:sign_pos"].to(vals.dtype)
                          * vals[T["inj:from_pos"]])
        return R, vals

    def _apply_rotation(self, x, R, vals):
        """Rotate the assembled rows into their normal-tangent frames and
        install the constraint rows n.u = g."""
        rd = self._rotation
        if rd is None:
            return R, vals
        T = self._tables
        dofs = T["rdofs"]
        Q = T["rQ"].to(R.dtype)
        R = R.index_put((dofs,), torch.einsum("nij,nj->ni", Q, R[dofs]))
        if vals is not None:
            pos = T["rpos"]
            Qv = T["rQ"].to(vals.dtype)[T["rnode"]]
            vals = vals.index_put((pos,), torch.einsum("kij,kj->ki", Qv,
                                                       vals[pos]))
        if rd.con_rows.size:
            ccoef = T["rcoef"].to(R.dtype)
            Rcon = (torch.einsum("ni,ni->n", ccoef, x[T["rcdofs"]].to(R.dtype))
                    - T["rcval"].to(R.dtype))
            R = R.index_put((T["rcrow"],), Rcon)
            if vals is not None:
                vals = vals.index_put((T["rczero"],), vals.new_zeros(()))
                vals = vals.index_put((T["rcepos"],),
                                      T["rcoef"].to(vals.dtype))
        return R, vals

    def _apply_dirichlet(self, x, R, vals, params):
        """Dirichlet rows: R = x - x_bc (parametric values evaluated here
        on the coordinates as tensors), identity rows in ``vals``."""
        T = self._tables
        if self.dirichlet_dofs.size:
            xv = torch.zeros_like(R)
            xv[T["dirdofs"]] = params["dirichlet_val"].to(R.dtype)
            for k, (d, _, fn) in enumerate(self._param_dirichlet):
                v = torch.as_tensor(fn(T[f"pd{k}:coords"].to(R.dtype), params),
                                    dtype=R.dtype, device=R.device)
                xv[T[f"pd{k}:dofs"]] = v.expand(d.shape[0])
            R = torch.where(T["dirmask"], x.to(R.dtype) - xv, R)
            if vals is not None:
                vals = vals * T["dirkeep"].to(vals.dtype)
                vals[T["dirdiag"]] = 1.0
        return R, vals

    def _row_surgery(self, x, R, vals, params):
        """Every strong condition on the assembled (R, vals), in goma_tpu's
        order: injection, point loads, rotation, point constraints,
        Dirichlet. Returns (R, vals, pc_dg, pl_dfs), the point-constraint
        and point-load row Jacobians the element matvec reads."""
        from goma_tpu_torch.bc.pointwise import (apply_point_constraints,
                                                 apply_point_loads)

        T = self._tables
        R, vals = self._apply_inject(R, vals)
        R, vals, pl_dfs = apply_point_loads(self, self._point_loads, x, R,
                                            vals, params, T)
        R, vals = self._apply_rotation(x, R, vals)
        R, vals, pc_dg = apply_point_constraints(self, self._point_sets, x,
                                                 R, vals, params, T)
        R, vals = self._apply_dirichlet(x, R, vals, params)
        return R, vals, tuple(pc_dg), tuple(pl_dfs)

    def _elem_residual_fn(self, bi: int, dtype=None):
        """The generic element residual of block ``bi`` at ``dtype``:
        ``elem_res(q_e, hist_e, X_e, ext_e, sgn_e, params) -> (r, r)`` for
        ONE element (local dofs, history, node coordinates, external fields
        at the nodes, the edge orientation signs or 1.0), the residual
        doubled as the aux output of ``jacfwd(..., has_aux=True)``. The
        signs conjugate the local dofs, the history and the residual
        (Nedelec orientation; ``_signs`` gives them). Each equation's
        integrand is contracted with its measure, and ``r`` is built out of
        place in slot order (an in-place add into a fresh tensor does not
        map under ``torch.func.vmap``)."""
        bd = self.dofmap.blocks[bi]
        tables = self.tables[bi]
        eqs = self.equations[bi]
        mat = self.materials[bi]
        dtype = dtype or self.dtype
        ext_names, coord = self.external_fields, self.coord
        # shell blocks: a BAR evaluates on the curve, a QUAD/TRI in 3D on
        # the surface
        edim = element_type(bd.elem_type).dim
        shell = None
        if edim < self.mesh.dim:
            shell = eval_curvevars if edim == 1 else eval_surfvars

        def elem_res(q_e, hist_e, X_e, ext_e, sgn_e, params):
            q_e = q_e * sgn_e
            qdot_e = params["ct"] * q_e + hist_e * sgn_e
            if shell is not None:
                fv = shell(q_e, qdot_e, X_e, tables, bd.slots, dtype, ext_e,
                           ext_names)
            else:
                fv = eval_fieldvars(q_e, qdot_e, X_e, tables, bd.slots, dtype,
                                    ext_e, ext_names, coord)
            acc = {}
            for eq in eqs:
                contrib = eq.residual(fv, mat, params)  # (nq, ncomp, nbf)
                w = fv.wdetJ0 if eq.measure == "reference" else fv.wdetJ
                a = _contract(w, contrib, q_e)
                acc[eq.var] = acc[eq.var] + a if eq.var in acc else a
            r = torch.cat([acc[s.var] if s.var in acc   # slots in start order
                           else q_e.new_zeros(s.size) for s in bd.slots]
                          or [q_e.new_zeros(0)]) * sgn_e
            return r, r

        return elem_res

    def _signs(self, T, bi, dtype):
        """(signs, their vmap axis) of block ``bi`` for ``elem_res``: the
        per-element edge signs (ne, nl) at ``dtype`` mapped over elements,
        or 1.0 unmapped for a consistently oriented block."""
        if self.dofmap.blocks[bi].edge_signs is None:
            return 1.0, None
        return T[f"sg{bi}"].to(dtype), 0

    def _face_residual_fn(self, j: int, dtype=None):
        """The residual of ONE face of face set ``j`` at ``dtype``:
        ``face_res(q_e, hist_e, X_e, ftab, params) -> (r, r)`` over the
        parent element's local dofs, every kernel's surface integrand
        contracted with ``wdA``, built out of place in slot order as
        ``elem_res`` is."""
        fs = self.face_sets[j]
        bd = self.dofmap.blocks[fs.block_index]
        mat = self.materials[fs.block_index]
        dtype = dtype or self.dtype
        dim = self.mesh.dim
        fwts = self._tables[f"fw{j}"].to(dtype)

        def face_res(q_e, hist_e, X_e, ftab, params):
            qdot_e = params["ct"] * q_e + hist_e
            sfv = eval_surfacevars(q_e, qdot_e, X_e, ftab, fwts, bd.slots,
                                   dim, dtype, self.coord)
            acc = {}
            for k in fs.kernels:
                contrib = k.residual(sfv, mat, params)  # (nqf, ncomp, nbf)
                a = _contract(sfv.wdA, contrib, q_e)
                acc[k.var] = acc[k.var] + a if k.var in acc else a
            r = torch.cat([acc[s.var] if s.var in acc
                           else q_e.new_zeros(s.size) for s in bd.slots])
            return r, r

        return face_res

    @staticmethod
    def _slot_cat(slots, acc, like):
        """The local vector of ``slots`` (in start order): each slot's
        accumulated contribution in ``acc``, zeros elsewhere (built out of
        place, so it maps under ``torch.func.vmap``)."""
        return [acc[s.var] if s.var in acc else like.new_zeros(s.size)
                for s in slots]

    def _edge_residual_fn(self, j: int):
        """The residual of ONE element edge of edge set ``j`` (bc_curve.c):
        ``edge_res(q_e, hist_e, X_e, etab, params) -> (r, r)`` over the
        element's local dofs, each kernel's line integrand contracted with
        the arc-length measure."""
        from goma_tpu_torch.bc.edge import eval_edgevars

        es = self.edge_sets[j]
        bd = self.dofmap.blocks[es.block_index]
        mat = self.materials[es.block_index]
        dtype = self.dtype
        ewts = torch.as_tensor(es.ewts, dtype=dtype, device=self.device)

        def edge_res(q_e, hist_e, X_e, etab, params):
            qdot_e = params["ct"] * q_e + hist_e
            efv = eval_edgevars(q_e, qdot_e, X_e, etab, ewts, bd.slots, dtype)
            acc = {}
            for k in es.kernels:
                contrib = k.residual(efv, mat, params)  # (nq_e, ncomp, nbf)
                a = torch.einsum("q,qcn->cn", efv.wds, contrib).reshape(-1)
                acc[k.var] = acc[k.var] + a if k.var in acc else a
            r = torch.cat(self._slot_cat(bd.slots, acc, q_e))
            return r, r

        return edge_res

    def _ifc_residual_fn(self, j: int):
        """The residual of ONE face pair of interface set ``j`` over the
        COMBINED local dofs (nla + nlb): ``jacfwd`` of it gives the
        two-sided Jacobian with the cross-block blocks (the reference's
        ``lec->J_stress_neighbor``). A kernel's ``var_a``/``var_b`` (when
        set) name a different equation on each side."""
        st = self.ifc_sets[j]
        bd_a = self.dofmap.blocks[st.block_a]
        bd_b = self.dofmap.blocks[st.block_b]
        mat_a = self.materials[st.block_a]
        mat_b = self.materials[st.block_b]
        dtype, dim, nla = self.dtype, self.mesh.dim, st.nla
        fwts = torch.as_tensor(st.fwts, dtype=dtype, device=self.device)

        def ifc_res(q_ab, hist_ab, Xa_e, Xb_e, fta, ftb, params):
            qa, qb = q_ab[:nla], q_ab[nla:]
            ha, hb = hist_ab[:nla], hist_ab[nla:]
            sa = eval_surfacevars(qa, params["ct"] * qa + ha, Xa_e, fta, fwts,
                                  bd_a.slots, dim, dtype, self.coord)
            sb = eval_surfacevars(qb, params["ct"] * qb + hb, Xb_e, ftb, fwts,
                                  bd_b.slots, dim, dtype, self.coord)
            acc_a, acc_b = {}, {}
            for k in st.kernels:
                ca, cb = k.residual(sa, sb, mat_a, mat_b, params)
                for acc, var, c in ((acc_a, getattr(k, "var_a", None) or k.var, ca),
                                    (acc_b, getattr(k, "var_b", None) or k.var, cb)):
                    a = torch.einsum("q,qcn->cn", sa.wdA, c).reshape(-1)
                    acc[var] = acc[var] + a if var in acc else a
            r = torch.cat(self._slot_cat(bd_a.slots, acc_a, q_ab)
                          + self._slot_cat(bd_b.slots, acc_b, q_ab))
            return r, r

        return ifc_res

    def _ovs_residual_fn(self, j: int):
        """The residual of ONE quadrature point of overset set ``j`` over the
        combined [bar, fluid (, solid)] local dofs: ``jacfwd`` of it gives
        the multiplier/velocity (and solid) coupling blocks (the
        reference's hand-coded bAC/cAC/dAC arrays). The solid side sees
        its values, its material rates (``params["ct"] q + hist``) and its
        basis at the point."""
        from goma_tpu_torch.physics.overset import LM_VAR, OversetVars

        st = self.ovs_sets[j]
        bd_b = self.dofmap.blocks[st.bar_block]
        bd_f = self.dofmap.blocks[st.fluid_block]
        bd_s = self.dofmap.blocks[st.solid_block] if st.Ns is not None \
            else None
        nlb = st.nlb
        nlbf = nlb + bd_f.n_ldof
        lam = bd_b.slot(LM_VAR)

        def row_res(q, h, xp, wp, Nf, Ns, params):
            qf = q[nlb:nlbf]
            ov = OversetVars()
            ov.x = xp
            ov.w = wp
            for sl in bd_f.slots:
                if sl.interp == "N1":
                    continue
                N = Nf[sl.interp]  # (nbf,)
                qv = qf[sl.start:sl.start + sl.size].reshape(sl.ncomp, sl.nbf)
                ov.vals[sl.var] = qv @ N
                ov.phi[sl.var] = N
            if bd_s is not None:
                qs = q[nlbf:]
                qsdot = params["ct"] * qs + h[nlbf:]
                for sl in bd_s.slots:
                    if sl.interp == "N1":
                        continue
                    N = Ns[sl.interp]
                    cut = slice(sl.start, sl.start + sl.size)
                    ov.vals_s[sl.var] = qs[cut].reshape(sl.ncomp, sl.nbf) @ N
                    ov.dots_s[sl.var] = qsdot[cut].reshape(sl.ncomp, sl.nbf) @ N
                    ov.phi_s[sl.var] = N
            q_lam = q[lam.start:lam.start + lam.size].reshape(lam.ncomp)
            acc_b, acc_f, acc_s = {}, {}, {}
            for k in st.kernels:
                parts = k.residual(ov, q_lam, params)
                r_lam, rf = parts[0], parts[1]
                rs = parts[2] if len(parts) > 2 and bd_s is not None else {}
                for acc, var, c in ([(acc_b, LM_VAR, r_lam)]
                                    + [(acc_f, v, c) for v, c in rf.items()]
                                    + [(acc_s, v, c) for v, c in rs.items()]):
                    c = c.reshape(-1)
                    acc[var] = acc[var] + c if var in acc else c
            r = torch.cat(self._slot_cat(bd_b.slots, acc_b, q)
                          + self._slot_cat(bd_f.slots, acc_f, q)
                          + (self._slot_cat(bd_s.slots, acc_s, q)
                             if bd_s is not None else []))
            return r, r

        return row_res

    def _coupling_parts(self, x, hist, params, T, with_jac=True):
        """Every coupling set's (key, r (rows, nl), J (rows, nl, nl) or
        None), in goma_tpu's order: edge sets, interface sets, overset
        sets; at the problem dtype, ``vmap(jacfwd(...))`` over the rows."""
        from torch.func import jacfwd, vmap

        def run(fn, args, axes):
            if with_jac:
                J, r = vmap(jacfwd(fn, argnums=0, has_aux=True),
                            in_dims=axes)(*args)
                return r, J
            return vmap(fn, in_dims=axes)(*args)[0], None

        parts = []
        for j, es in enumerate(self.edge_sets):
            g = T[f"eg{j}"]
            etabs = {k: T[f"et{j}:{k}"] for k in es.etabs}
            parts.append((f"e{j}", *run(self._edge_residual_fn(j), (
                x[g], hist[g], T[f"ex{j}"], etabs, params), (0, 0, 0, 0, None))))
        for j, st in enumerate(self.ifc_sets):
            g = T[f"ig{j}"]
            fta = {k: T[f"ita{j}:{k}"] for k in st.ftabs_a}
            ftb = {k: T[f"itb{j}:{k}"] for k in st.ftabs_b}
            parts.append((f"i{j}", *run(self._ifc_residual_fn(j), (
                x[g], hist[g], T[f"ixa{j}"], T[f"ixb{j}"], fta, ftb, params),
                (0, 0, 0, 0, 0, 0, None))))
        for j, st in enumerate(self.ovs_sets):
            g = T[f"og{j}"]
            Nf = {k: T[f"oN{j}:{k}"] for k in st.Nf}
            Ns = {k: T[f"oNs{j}:{k}"] for k in (st.Ns or {})}
            parts.append((f"o{j}", *run(self._ovs_residual_fn(j), (
                x[g], hist[g], T[f"ox{j}"], T[f"ow{j}"], Nf, Ns, params),
                (0, 0, 0, 0, 0, 0, None))))
        return parts

    def _add_coupling(self, x, params, T, R, vals):
        """R and (when not None) the CSR values with every coupling set's
        contributions added through their gather plans."""
        if not (self.edge_sets or self.ifc_sets or self.ovs_sets):
            return R, vals
        hist = params["hist"].to(self.dtype)
        for key, r, J in self._coupling_parts(x, hist, params, T,
                                              with_jac=vals is not None):
            R = add_at(R, T[f"{key}:ru"], T[f"{key}:rp"], r)
            if vals is not None:
                vals = add_at(vals, T[f"{key}:vu"], T[f"{key}:vp"], J)
        return R, vals

    def _elem_rj_parts(self, x, params, T, rdt=None, jdt=None):
        """Per-block and per-face-set residual vectors (at ``rdt`` or the
        problem dtype), element Jacobians of the blocks (``blockJ``) and of
        the face sets (``faceJ``, both at ``jdt``, by default
        ``jacobian_dtype``) and element-level absolute row sums (None for
        generic blocks and face sets). With
        ``rdt == jacobian_dtype`` the residual and Jacobian come out of ONE
        fused or ``jacfwd`` call (the switched-precision Newton prep). A
        mixed-precision generic block differentiates a second element
        residual built at the Jacobian dtype, with params, x, history and
        coordinates cast — not a cast of the full-precision Jacobian; face
        sets likewise. Returns (r_parts, blockJ, faceJ, rs_parts), the
        residual and row-sum parts in (blocks..., faces...) order."""
        dtype = rdt if rdt is not None else self.dtype
        jdt = jdt or self.jacobian_dtype or self.dtype
        if dtype != self.dtype:
            params = _cast_floats(params, dtype)
        mixed = jdt != dtype
        x = x.to(dtype)
        hist = params["hist"].to(dtype)
        if mixed:
            params_j = _cast_floats(params, jdt)
            xj = x.to(jdt)
            histj = hist.to(jdt)
        r_parts, blockJ, rs_parts = [], [], []
        for bi in range(len(self.dofmap.blocks)):
            g = T[f"g{bi}"]
            if bi not in self._fast_meta:
                r, J = self._generic_rj(bi, T, g, x, hist, params, dtype,
                                        (xj, histj, params_j, jdt)
                                        if mixed else None)
                r_parts.append(r)
                blockJ.append(J)
                rs_parts.append(None)
                continue
            meta = self._fast_meta[bi]
            static = self._fast_static[bi]
            gn = T.get(f"fns:gnode{bi}")
            if gn is not None:
                gp = T[f"fns:gp{bi}"]
                gat = lambda v: fastns.node_gather(v, gn, gp)  # noqa: E731
            else:
                gat = lambda v: v[g]  # noqa: E731
            if mixed:
                r, _ = fastns.ns_q2q1_rj(
                    gat(x), gat(hist), fastns.select_tables(T, bi, dtype),
                    meta, static, params["ct"], dtype, with_jac=False)
                _, J, rs = fastns.ns_q2q1_rj(
                    gat(xj), gat(histj), fastns.select_tables(T, bi, jdt),
                    meta, static, params_j["ct"], jdt, with_rs=True)
            else:
                r, J, rs = fastns.ns_q2q1_rj(
                    gat(x), gat(hist), fastns.select_tables(T, bi, dtype),
                    meta, static, params["ct"], dtype, with_rs=True)
            r_parts.append(r)
            blockJ.append(J)
            rs_parts.append(rs)
        faceJ = []
        for j in range(len(self.face_sets)):
            r, J = self._face_rj(j, T, x, hist, params, dtype,
                                 (xj, histj, params_j, jdt) if mixed else None)
            r_parts.append(r)
            faceJ.append(J)
            rs_parts.append(None)
        return r_parts, blockJ, faceJ, rs_parts

    def _coords(self, T, bi, dtype):
        """Block ``bi``'s element node coordinates at ``dtype``."""
        return T[f"x{bi}"].to(dtype)

    def _ext_gather(self, params, conn):
        """The external fields at each element's nodes, (ne, n_geom_nodes,
        n_ext): an empty last axis without external fields."""
        if self.external_fields:
            ext = torch.stack([params[f"ext_{n}"]
                               for n in self.external_fields], dim=-1)
            return ext[conn]
        return torch.zeros((conn.shape[0], conn.shape[1], 0),
                           dtype=self.dtype, device=conn.device)

    def _generic_rj(self, bi, T, g, x, hist, params, dtype, mixed):
        """(r (ne, nl), J (ne, nl, nl)) of a generic block: ``vmap`` over
        the elements of ``jacfwd`` of the element residual. ``mixed``:
        (x, hist, params, dtype) of a separate Jacobian pass, or None."""
        from torch.func import jacfwd, vmap

        if g.shape[1] == 0:
            # a block that carries no dof (a shell's bulk with no equation)
            jdt = dtype if mixed is None else mixed[3]
            return (x.new_zeros((g.shape[0], 0)),
                    torch.zeros((g.shape[0], 0, 0), dtype=jdt, device=x.device))
        elem_res = self._elem_residual_fn(bi, dtype)
        Xref = self._coords(T, bi, dtype)
        ext = self._ext_gather(params, T[f"c{bi}"]).to(dtype)
        sg, sax = self._signs(T, bi, dtype)
        axes = (0, 0, 0, 0, sax, None)
        if mixed is None:
            J, r = vmap(jacfwd(elem_res, argnums=0, has_aux=True),
                        in_dims=axes)(x[g], hist[g], Xref, ext, sg, params)
            return r, J
        r, _ = vmap(elem_res, in_dims=axes)(x[g], hist[g], Xref, ext, sg,
                                            params)
        xj, histj, params_j, jdt = mixed
        J, _ = vmap(jacfwd(self._elem_residual_fn(bi, jdt), argnums=0,
                           has_aux=True), in_dims=axes)(
            xj[g], histj[g], self._coords(T, bi, jdt), ext.to(jdt),
            self._signs(T, bi, jdt)[0], params_j)
        return r, J

    def _face_rj(self, j, T, x, hist, params, dtype, mixed):
        """(r (nf, nl), J (nf, nl, nl)) of face set ``j``, as
        ``_generic_rj`` for a block."""
        from torch.func import jacfwd, vmap

        fs = self.face_sets[j]
        g = T[f"fg{j}"]
        axes = (0, 0, 0, 0, None)

        def geom(dt):
            return (T[f"fx{j}"].to(dt),
                    {k: T[f"ft{j}:{k}"].to(dt) for k in fs.ftabs})

        Xf, ftabs = geom(dtype)
        face_res = self._face_residual_fn(j, dtype)
        if mixed is None:
            J, r = vmap(jacfwd(face_res, argnums=0, has_aux=True),
                        in_dims=axes)(x[g], hist[g], Xf, ftabs, params)
            return r, J
        r, _ = vmap(face_res, in_dims=axes)(x[g], hist[g], Xf, ftabs, params)
        xj, histj, params_j, jdt = mixed
        J, _ = vmap(jacfwd(self._face_residual_fn(j, jdt), argnums=0,
                           has_aux=True), in_dims=axes)(
            xj[g], histj[g], *geom(jdt), params_j)
        return r, J

    def _assemble_with_elem(self, x, params):
        """Residual, CSR values (at ``jacobian_dtype``) and the operator's
        pieces that power the matrix-free ``element_matvec``: ``aux =
        (blockJ, faceJ, pc_dg, pl_dfs)``, the element and face Jacobians
        and the point-constraint and point-load row Jacobians."""
        T = self._tables
        dtype = self.dtype
        jdt = self.jacobian_dtype or dtype
        x = x.to(dtype)
        r_parts, blockJ, faceJ, _ = self._elem_rj_parts(x, params, T)
        R = _combine(r_parts, T["tg"], dtype)
        vals = _combine(blockJ + faceJ, T["nnztg"], jdt)
        # the coupling sets are not in the aux (their decks take the CSR
        # operator, see NewtonSolver)
        R, vals = self._add_coupling(x, params, T, R, vals)
        R, vals, pc_dg, pl_dfs = self._row_surgery(x, R, vals, params)
        return R, vals, (tuple(blockJ), tuple(faceJ), pc_dg, pl_dfs)

    def _assemble(self, x, params):
        """(R, vals): the global residual and CSR Jacobian values, both at
        the problem dtype (``jacobian_dtype`` is not read, as in goma_tpu),
        with every strong condition's row surgery (``_row_surgery``)."""
        T = self._tables
        dtype = self.dtype
        x = x.to(dtype)
        r_parts, blockJ, faceJ, _ = self._elem_rj_parts(x, params, T,
                                                        jdt=dtype)
        R = _combine(r_parts, T["tg"], dtype)
        vals = _combine(blockJ + faceJ, T["nnztg"], dtype)
        R, vals = self._add_coupling(x, params, T, R, vals)
        R, vals, _, _ = self._row_surgery(x, R, vals, params)
        return R, vals

    def _residual_only(self, x, params):
        """The global residual alone, at the problem dtype: the fused block
        without its Jacobian (``fastns.ns_q2q1_rj(..., with_jac=False)``),
        the generic blocks and face sets without ``jacfwd``, then the same
        row surgery as ``_assemble``."""
        from torch.func import vmap

        T = self._tables
        dtype = self.dtype
        x = x.to(dtype)
        hist = params["hist"].to(dtype)
        axes = (0, 0, 0, 0, None)
        parts = []
        for bi in range(len(self.dofmap.blocks)):
            g = T[f"g{bi}"]
            if bi in self._fast_meta:
                gn = T.get(f"fns:gnode{bi}")
                if gn is not None:
                    gp = T[f"fns:gp{bi}"]
                    gat = lambda v: fastns.node_gather(v, gn, gp)  # noqa: E731
                else:
                    gat = lambda v: v[g]  # noqa: E731
                r, _ = fastns.ns_q2q1_rj(
                    gat(x), gat(hist), fastns.select_tables(T, bi, dtype),
                    self._fast_meta[bi], self._fast_static[bi], params["ct"],
                    dtype, with_jac=False)
            else:
                ext = self._ext_gather(params, T[f"c{bi}"]).to(dtype)
                sg, sax = self._signs(T, bi, dtype)
                r, _ = vmap(self._elem_residual_fn(bi, dtype),
                            in_dims=(0, 0, 0, 0, sax, None))(
                    x[g], hist[g], self._coords(T, bi, dtype), ext, sg, params)
            parts.append(r)
        for j, fs in enumerate(self.face_sets):
            g = T[f"fg{j}"]
            ftabs = {k: T[f"ft{j}:{k}"].to(dtype) for k in fs.ftabs}
            r, _ = vmap(self._face_residual_fn(j, dtype), in_dims=axes)(
                x[g], hist[g], T[f"fx{j}"].to(dtype), ftabs, params)
            parts.append(r)
        R = _combine(parts, T["tg"], dtype)
        R, _ = self._add_coupling(x, params, T, R, None)
        R, _, _, _ = self._row_surgery(x, R, None, params)
        return R

    # the public entry points (goma_tpu jits them; here they run eagerly)
    def assemble(self, x, params):
        """(R, vals) at state ``x``: the residual and CSR values with every
        strong condition applied, both at the problem dtype."""
        return self._assemble(x, params)

    def residual(self, x, params):
        """The residual alone (no Jacobian is formed)."""
        return self._residual_only(x, params)

    def _assemble_fast(self, x, params, rdt=None):
        """Vals-free assembly for the iterative path: residual, element
        Jacobians, and element-level absolute row sums — no global CSR
        values. The row sums

            rs[i] = sum_e sum_j |J_e[i_loc, j]|

        upper-bound the assembled row sums (exact where contributions to a
        shared entry agree in sign) and serve the reference's row-sum
        scaling (src/sl_matrix_util.c:442). Fast blocks hand them back with
        the kernel; generic blocks and face sets re-read their (ne, nl, nl)
        Jacobians. The row surgery is mirrored on rs as goma_tpu mirrors
        it: point-load rows add sum |df|, rotated rows take |Q| rs, a
        rotated constraint row sum |coef|, a point-constraint row sum |dg|,
        a Dirichlet row 1. Row injection is not applied (an injected deck
        takes the full prep). Returns (R, rs, aux) with aux = (blockJ,
        faceJ, pc_dg, pl_dfs)."""
        from goma_tpu_torch.bc.pointwise import (apply_point_constraints,
                                                 apply_point_loads)

        T = self._tables
        dtype = rdt if rdt is not None else self.dtype
        jdt = self.jacobian_dtype or self.dtype
        if dtype != self.dtype:
            params = _cast_floats(params, dtype)
        x = x.to(dtype)
        r_parts, blockJ, faceJ, rs_el = self._elem_rj_parts(x, params, T,
                                                            rdt=rdt)
        rs_el = [torch.sum(torch.abs(J), dim=2) if s is None else s
                 for J, s in zip(blockJ + faceJ, rs_el)]
        R = _combine(r_parts, T["tg"], dtype)
        rs = _combine(rs_el, T["tg"], jdt)

        R, _, pl_dfs = apply_point_loads(self, self._point_loads, x, R, None,
                                         params, T)
        for k, df in enumerate(pl_dfs):
            rs = add_at(rs, T[f"pld{k}:ru"], T[f"pld{k}:rp"],
                        torch.sum(torch.abs(df), dim=2))
        R, _ = self._apply_rotation(x, R, None)
        rd = self._rotation
        if rd is not None:
            dofs = T["rdofs"]
            rs = rs.index_put((dofs,), torch.einsum(
                "nij,nj->ni", torch.abs(T["rQ"].to(R.dtype)).to(jdt), rs[dofs]))
            if rd.con_rows.size:
                rs = rs.index_put((T["rcrow"],), torch.sum(
                    torch.abs(T["rcoef"].to(R.dtype)), dim=1).to(jdt))
        R, _, pc_dg = apply_point_constraints(self, self._point_sets, x, R,
                                              None, params, T)
        for k, dg in enumerate(pc_dg):
            rs = rs.index_put((T[f"pc{k}:rows"],),
                              torch.sum(torch.abs(dg), dim=1).to(jdt))
        R, _ = self._apply_dirichlet(x, R, None, params)
        if self.dirichlet_dofs.size:
            rs = torch.where(T["dirmask"], torch.ones((), dtype=jdt,
                                                      device=rs.device), rs)
        return R, rs, (tuple(blockJ), tuple(faceJ), tuple(pc_dg),
                       tuple(pl_dfs))

    def element_matvec(self, T, aux, scale, v):
        """Matrix-free y = A@v from the stored element Jacobians,
        reproducing the surgered, scaled CSR operator; the per-element and
        per-face products are combined through the transpose gather.
        ``aux = (blockJ, faceJ, pc_dg, pl_dfs)``."""
        T = T if T is not None else self._tables
        blockJ, faceJ, pc_dg, pl_dfs = aux
        parts = []
        for bi in range(len(self.dofmap.blocks)):
            gn = T.get(f"fns:gnode{bi}")
            if gn is not None:
                q = fastns.node_gather(v, gn, T[f"fns:gp{bi}"])
            else:
                q = v[T[f"g{bi}"]]  # (ne, nl)
            parts.append(torch.bmm(blockJ[bi], q.unsqueeze(2)).squeeze(2))
        for j in range(len(self.face_sets)):
            q = v[T[f"fg{j}"]]
            parts.append(torch.bmm(faceJ[j], q.unsqueeze(2)).squeeze(2))
        y = _combine(parts, T["tg"], v.dtype)
        return self._matvec_post(T, pc_dg, scale, v, y, pl_dfs)

    def _matvec_post(self, T, pc_dg, scale, v, y, pl_dfs=()):
        """The row surgery on a product, in ``_row_surgery``'s order: the
        point-load rows (before rotation: they are physical contributions
        the rotation then turns), the rotated rows and their constraint
        rows, the point-constraint rows, the Dirichlet identity rows; then
        the row scale. A point-constraint row's product is taken in the
        promoted dtype of its row Jacobian and ``v``, as goma_tpu takes
        it."""
        for k, df in enumerate(pl_dfs):
            contrib = torch.einsum("nlc,nc->nl", df.to(v.dtype),
                                   v[T[f"pld{k}:dofs"]])
            y = add_at(y, T[f"pld{k}:ru"], T[f"pld{k}:rp"], contrib)
        rd = self._rotation
        if rd is not None:
            dofs = T["rdofs"]
            y = y.index_put((dofs,), torch.einsum(
                "nij,nj->ni", T["rQ"].to(v.dtype), y[dofs]))
            if rd.con_rows.size:
                y = y.index_put((T["rcrow"],), torch.einsum(
                    "ni,ni->n", T["rcoef"].to(v.dtype), v[T["rcdofs"]]))
        for k, dg in enumerate(pc_dg):
            ct = torch.promote_types(dg.dtype, v.dtype)
            row = torch.einsum("ni,ni->n", dg.to(ct),
                               v[T[f"pc{k}:dofs"]].to(ct))
            y = y.index_put((T[f"pc{k}:rows"],), row.to(y.dtype))
        if self.dirichlet_dofs.size:
            y = torch.where(T["dirmask"], v, y)
        if scale is not None:
            y = y * scale
        return y


def _combine(parts, tg, dtype):
    """Sum per-element contributions into a global array by gathering
    through a transpose-gather map (deterministic: no scatter-add)."""
    flat = torch.cat([p.reshape(-1).to(dtype) for p in parts]
                     + [torch.zeros(1, dtype=dtype, device=tg.device)])
    return torch.sum(flat[tg], dim=1)
