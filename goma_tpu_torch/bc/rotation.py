"""Rotated boundary conditions: normal-tangent equation frames at boundary
nodes (counterpart of ``goma_tpu/bc/rotation.py``).

Parity: reference ``src/bc/rotate_coordinates.c`` (auto-rotation with
averaged nodal normals, ``setup_rotated_bc_nodes:707``), ``src/bc/rotate.c``
(legacy ROT cards) and ``src/util/goma_normal.c``. Used for e.g. velocity
slip on curved walls (u.n = 0 with tangential momentum retained) and strong
kinematic mesh BCs.

Rotation is a precomputed linear transformation of assembled rows: for each
rotated node the ncomp=dim rows of the chosen variable share an identical
CSR column set (they couple to the same elements), so row rotation is a
gather, a small matmul and a write-back on the flat CSR values. The rotated
"normal" (or tangent) equation can then be replaced by a constraint row
n.u = g, as Dirichlet surgery replaces a row.

Normals are averaged adjacent-face normals on the undeformed mesh (a fixed
frame). Everything here is host numpy, a copy of goma_tpu's; the Problem
puts the tables on its device (``Problem._build_tables``: ``rQ``,
``rdofs``, ``rpos``, ``rnode`` and the constraint rows ``rcrow``,
``rcoef``, ``rcdofs``, ``rczero``, ``rcepos``, ``rcval``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from goma_tpu_torch.elements import element_type, eval_basis, face_rule, faces as elem_faces, geom_interp
from goma_tpu_torch.mesh.mesh import Mesh


def nodal_normals(mesh: Mesh, sidesets) -> dict[int, np.ndarray]:
    """Averaged outward unit normal per node on the given side sets."""
    acc: dict[int, np.ndarray] = {}
    for name in sidesets:
        ss = mesh.sidesets[name]
        for e, f in zip(ss.elems, ss.faces):
            bi, le = mesh.global_elem_block(int(e))
            b = mesh.blocks[bi]
            et = element_type(b.elem_type)
            face = elem_faces(et.family)[int(f)]
            fpts, fwts = face_rule(et.family, 2)
            epts = face.ref_map(fpts)
            Ng, dNg = eval_basis(et.family, geom_interp(et), epts)
            X = mesh.coords[b.conn[le]]
            Jm = np.einsum("qnd,nk->qkd", dNg, X)
            T = np.einsum("qkd,dm->qkm", Jm, face.ref_jac)
            if mesh.dim == 2:
                t = T[:, :, 0]
                nrm = np.stack([t[:, 1], -t[:, 0]], axis=1)
            else:
                nrm = np.cross(T[:, :, 0], T[:, :, 1])
            area_n = (nrm * fwts[:, None]).sum(axis=0)
            from goma_tpu_torch.mesh.mesh import _face_all_nodes

            for ln in _face_all_nodes(et, int(f)):
                node = int(b.conn[le, ln])
                acc[node] = acc.get(node, 0.0) + area_n
    return {n: v / np.linalg.norm(v) for n, v in acc.items()}


def frame_from_normal(n: np.ndarray) -> np.ndarray:
    """Rotation matrix with rows [n, t1(, t2)]. 2D: t = (-ny, nx); 3D: t1
    from the least-aligned axis (reference: crit-angle coordinate selection
    in rotate_util), t2 = n x t1."""
    d = n.shape[0]
    if d == 2:
        return np.stack([n, np.array([-n[1], n[0]])])
    e = np.zeros(3)
    e[np.argmin(np.abs(n))] = 1.0
    t1 = np.cross(n, e)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    return np.stack([n, t1, t2])


@dataclass
class RotationData:
    """Precomputed device arrays for rotated-row application."""

    # row rotation
    pos: np.ndarray  # (K, dim) aligned nnz positions across the node's rows
    entry_node: np.ndarray  # (K,) index into Q for each aligned column slot
    dofs: np.ndarray  # (n_rot, dim) dof ids per rotated node
    Q: np.ndarray  # (n_rot, dim, dim)
    # constraint replacement rows: for each (node, direction) constraint
    con_rows: np.ndarray  # (n_con,) dof id whose row is replaced
    con_row_mask_pos: list  # per constraint: nnz positions of that row
    con_entry_pos: np.ndarray  # (n_con, dim) positions of (row, node dofs)
    con_coeff: np.ndarray  # (n_con, dim) Q[direction] coefficients
    con_dofs: np.ndarray  # (n_con, dim) the node's dofs (columns of constraint)
    con_value: np.ndarray  # (n_con,)


def build_rotation(problem, specs, constraints) -> RotationData | None:
    """specs: list of (sidesets tuple, var). constraints: list of
    (sidesets tuple, var, direction index, value)."""
    if not specs and not constraints:
        return None
    mesh = problem.mesh
    dofmap = problem.dofmap
    pat = problem.pattern
    dim = mesh.dim

    # gather rotated nodes per var
    node_var: dict[tuple[int, str], np.ndarray] = {}
    allspecs = [(tuple(s), v) for s, v in specs] + [
        (tuple(s), v) for s, v, _, _ in constraints
    ]
    normals_cache: dict[tuple, dict[int, np.ndarray]] = {}
    rot_nodes: dict[str, dict[int, np.ndarray]] = {}
    for ssets, var in allspecs:
        if ssets not in normals_cache:
            normals_cache[ssets] = nodal_normals(mesh, ssets)
        d = rot_nodes.setdefault(var, {})
        d.update(normals_cache[ssets])

    pos_list, node_idx_list, dofs_list, Q_list = [], [], [], []
    node_slot: dict[tuple[str, int], int] = {}
    for var, nd in rot_nodes.items():
        for node, nrm in sorted(nd.items()):
            dofs = np.array(
                [dofmap.dof_of_node_svar[node, dofmap.svar(var, c)] for c in range(dim)]
            )
            if np.any(dofs < 0):
                continue
            # aligned rows: all dim rows must share identical columns
            cols0 = pat.indices[pat.indptr[dofs[0]] : pat.indptr[dofs[0] + 1]]
            ok = True
            starts = []
            for dd in dofs:
                c = pat.indices[pat.indptr[dd] : pat.indptr[dd + 1]]
                if c.shape != cols0.shape or not np.array_equal(c, cols0):
                    ok = False
                    break
                starts.append(pat.indptr[dd])
            if not ok:
                raise RuntimeError(
                    f"rotation: rows of {var} at node {node} have differing sparsity"
                )
            L = cols0.shape[0]
            slot = len(Q_list)
            node_slot[(var, node)] = slot
            Q_list.append(frame_from_normal(nrm))
            dofs_list.append(dofs)
            p = np.stack([np.arange(s, s + L) for s in starts], axis=1)  # (L, dim)
            pos_list.append(p)
            node_idx_list.append(np.full(L, slot))

    if not Q_list:
        return None
    pos = np.concatenate(pos_list, axis=0)
    entry_node = np.concatenate(node_idx_list)
    dofs_arr = np.stack(dofs_list)
    Q = np.stack(Q_list)

    # constraints: the FIRST-registered spec wins per (var, node, direction)
    # — the reference's BC duplicate rule (src/mm_bc_conflict.c:832
    # "defaulting to 1st occurence"). A constraint whose target row already
    # carries a Dirichlet spec is shifted to the next free coordinate
    # direction, or dropped — DIRICHLET precedence with rotated-condition
    # displacement (mm_bc_conflict.c:806,866 "move this condition to the
    # next coordinate direction, if available").
    import warnings

    dmask = getattr(problem, "_dir_mask", None)
    duplog = getattr(problem, "bc_dup_log", None)
    con_map: dict[tuple, tuple] = {}
    for ssets, var, direction, value in constraints:
        nrm_map = normals_cache[tuple(ssets)]
        for node in sorted(nrm_map):
            key = (var, node)
            if key not in node_slot:
                continue
            slot = node_slot[key]
            dnode = dofs_list[slot]
            dshift = direction
            if dmask is not None:
                while dshift < dim and dmask[int(dnode[dshift])]:
                    dshift += 1
                if dshift >= dim:
                    warnings.warn(
                        f"rotated constraint on {var} at node {node} dropped: "
                        "all coordinate rows carry Dirichlet specs "
                        "(DIRICHLET precedence)", stacklevel=2)
                    if duplog is not None:
                        duplog.append({
                            "row": int(dnode[direction]), "node": int(node),
                            "kept": "DIRICHLET",
                            "dropped": f"rotated constraint ({var})",
                            "rule": "DIRICHLET precedence, no free row "
                                    "(mm_bc_conflict.c:806)"})
                    continue
                if dshift != direction:
                    warnings.warn(
                        f"rotated constraint on {var} at node {node} moved "
                        f"from row {direction} to {dshift} (displaced by a "
                        "Dirichlet spec)", stacklevel=2)
                    if duplog is not None:
                        # the constraint is MOVED, not dropped — record it as
                        # a displacement (the reference moves the condition to
                        # the next coordinate direction, mm_bc_conflict.c:866)
                        duplog.append({
                            "row": int(dnode[direction]), "node": int(node),
                            "action": "moved",
                            "kept": f"rotated constraint ({var}) "
                                    f"moved to row {dshift}",
                            "dropped": "(none; row ceded to DIRICHLET)",
                            "rule": "rotated condition displaced to next "
                                    "coordinate (mm_bc_conflict.c:866)"})
            prev = con_map.get((var, node, dshift))
            if prev is not None:
                # distinguish identical re-specification from a real conflict
                # (the reference tags exact duplicates IDENTICAL at
                # mm_bc_conflict.c:832 and conflicting claims take the first)
                pv = prev[1]
                pv_f = pv(mesh.coords[node]) if callable(pv) else float(pv)
                nv_f = value(mesh.coords[node]) if callable(value) else float(value)
                identical = prev[3] == direction and pv_f == nv_f
                if not identical:
                    warnings.warn(
                        f"duplicate rotated constraint on {var} at node "
                        f"{node} (dir {direction}) discarded; first strong "
                        "claim wins (mm_bc_conflict.c dup rule)", stacklevel=2)
                if duplog is not None:
                    duplog.append({
                        "row": int(dnode[dshift]), "node": int(node),
                        "action": "identical" if identical else "dropped",
                        "kept": "rotated constraint (first spec)",
                        "dropped": f"rotated constraint ({var}, dir "
                                   f"{direction})"
                                   + (" [identical value]" if identical else ""),
                        "rule": ("IDENTICAL duplicate (mm_bc_conflict.c:832)"
                                 if identical else
                                 "first strong claim kept "
                                 "(mm_bc_conflict.c:1000)")})
            con_map.setdefault((var, node, dshift), (slot, value, node, direction))

    con_rows, con_entry_pos, con_coeff, con_dofs, con_val, con_mask = [], [], [], [], [], []
    for (var, node, rowdir), (slot, value, _, direction) in sorted(
        con_map.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])
    ):
        dofs = dofs_list[slot]
        row = int(dofs[rowdir])  # possibly Dirichlet-displaced row
        q = Q_list[slot][direction]  # constraint keeps its own frame row
        epos = np.array([pat.find(np.array([row]), np.array([d]))[0] for d in dofs])
        if np.any(epos < 0):
            raise RuntimeError("constraint entries missing from pattern")
        con_rows.append(row)
        con_entry_pos.append(epos)
        con_coeff.append(q)
        con_dofs.append(dofs)
        v = value(mesh.coords[node]) if callable(value) else float(value)
        con_val.append(v)
        con_mask.append(np.arange(pat.indptr[row], pat.indptr[row + 1]))

    return RotationData(
        pos=pos,
        entry_node=entry_node,
        dofs=dofs_arr,
        Q=Q,
        con_rows=np.array(con_rows, dtype=np.int64),
        con_row_mask_pos=con_mask,
        con_entry_pos=np.array(con_entry_pos, dtype=np.int64).reshape(-1, dim)
        if con_rows
        else np.zeros((0, dim), dtype=np.int64),
        con_coeff=np.array(con_coeff).reshape(-1, dim) if con_rows else np.zeros((0, dim)),
        con_dofs=np.array(con_dofs, dtype=np.int64).reshape(-1, dim)
        if con_rows
        else np.zeros((0, dim), dtype=np.int64),
        con_value=np.array(con_val),
    )
