"""Material-interface utilities: face pairing and node splitting for
discontinuous interfacial variables (counterpart of
``goma_tpu/mesh/interface.py``, host numpy, copied).

Parity: the reference supports variables that are discontinuous at material
boundaries (per-material dofs at shared nodes, ``src/rf_setup_problem.c:514``)
with interfacial matching conditions (``src/mm_interface.c:76
interface_source``, VL_EQUIL/Henry-law partitioning, surface-discontinuity
fluxes). TPU-first: the discontinuity is made *topological* on the host —
interface nodes are duplicated for one side's block — and the matching
conditions become cross-block interface kernels assembled over paired faces
(which also provides the reference's neighbor-element Jacobian coupling
structure, ``lec->J_stress_neighbor``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from goma_tpu_torch.elements import element_type, faces as elem_faces
from goma_tpu_torch.mesh.mesh import Mesh, _face_all_nodes


@dataclass
class InterfacePairs:
    """Aligned face pairs along a two-block interface."""

    block_a: int
    block_b: int
    elems_a: np.ndarray  # (np,) local element ids in block_a
    faces_a: np.ndarray
    elems_b: np.ndarray
    faces_b: np.ndarray


def find_interface_faces(mesh: Mesh, bi_a: int, bi_b: int) -> InterfacePairs:
    """Pair faces of block a with coincident faces of block b (conforming
    meshes; matched by the set of corner nodes, or by face centroid after a
    node split)."""

    def face_keys(bi):
        b = mesh.blocks[bi]
        et = element_type(b.elem_type)
        nf = len(elem_faces(et.family))
        out = {}
        for f in range(nf):
            ln = list(_face_all_nodes(et, f))
            nodes = b.conn[:, ln]  # (ne, nfn)
            cents = mesh.coords[nodes].mean(axis=1)
            for le in range(b.n_elem):
                key = tuple(np.round(cents[le], 10))
                out.setdefault(key, []).append((le, f))
        return out

    ka = face_keys(bi_a)
    kb = face_keys(bi_b)
    ea, fa, eb, fb = [], [], [], []
    for key, lst_a in ka.items():
        if key in kb:
            for (la, ffa), (lb, ffb) in zip(lst_a, kb[key]):
                ea.append(la)
                fa.append(ffa)
                eb.append(lb)
                fb.append(ffb)
    return InterfacePairs(
        bi_a, bi_b,
        np.asarray(ea, dtype=np.int64), np.asarray(fa, dtype=np.int64),
        np.asarray(eb, dtype=np.int64), np.asarray(fb, dtype=np.int64),
    )


def split_interface(mesh: Mesh, pairs: InterfacePairs):
    """Duplicate the interface nodes for block_b (every reference to them in
    block_b's connectivity switches to fresh node ids at the same
    coordinates), making nodal variables discontinuous across the interface.
    Returns (orig_nodes, new_nodes). Run find_interface_faces FIRST."""
    b = mesh.blocks[pairs.block_b]
    et = element_type(b.elem_type)
    shared = set()
    for le, f in zip(pairs.elems_b, pairs.faces_b):
        ln = list(_face_all_nodes(et, int(f)))
        shared.update(b.conn[int(le), ln].tolist())
    orig = np.array(sorted(shared), dtype=np.int64)
    new = np.arange(mesh.n_nodes, mesh.n_nodes + orig.shape[0], dtype=np.int64)
    mesh.coords = np.concatenate([mesh.coords, mesh.coords[orig]], axis=0)
    lookup = {int(o): int(n) for o, n in zip(orig, new)}
    conn = b.conn.copy()
    flat = conn.ravel()
    for i, v in enumerate(flat):
        if int(v) in lookup:
            flat[i] = lookup[int(v)]
    b.conn = flat.reshape(conn.shape).astype(conn.dtype)
    return orig, new


def interior_face_pairs(mesh: Mesh, bi: int) -> InterfacePairs:
    """All interior (element-to-element) face pairs WITHIN one block, for
    discontinuous-Galerkin face terms (reference: the neighbor-element stress
    coupling of ``assemble_surface_stress``, src/mm_fill_stress.c:5017, via
    ``exo_conn.c build_elem_elem``). Each shared face appears once, A being
    the lower element id."""
    b = mesh.blocks[bi]
    et = element_type(b.elem_type)
    nf = len(elem_faces(et.family))
    seen: dict = {}
    ea, fa, eb, fb = [], [], [], []
    for f in range(nf):
        ln = list(_face_all_nodes(et, f))
        corners = b.conn[:, ln]
        for le in range(b.n_elem):
            key = tuple(sorted(corners[le].tolist()))
            if key in seen:
                la, ffa = seen.pop(key)
                ea.append(la)
                fa.append(ffa)
                eb.append(le)
                fb.append(f)
            else:
                seen[key] = (le, f)
    return InterfacePairs(
        bi, bi,
        np.asarray(ea, dtype=np.int64), np.asarray(fa, dtype=np.int64),
        np.asarray(eb, dtype=np.int64), np.asarray(fb, dtype=np.int64),
    )
