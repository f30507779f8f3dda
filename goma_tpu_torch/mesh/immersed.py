"""Immersed-boundary (overset) curve blocks (counterpart of
``goma_tpu/mesh/immersed.py``, host numpy, copied).

Parity: the reference's overlapping-grid contact machinery keeps a solid
mesh on top of a background fluid mesh (``src/bc_contact.c``); the immersed
curve here plays the solid-boundary role — an independent BAR block whose
nodes are NOT shared with the background block. Lagrange-multiplier coupling
to the background mesh is built by ``Problem.add_overset`` from the curve's
quadrature points.
"""

from __future__ import annotations

import numpy as np

from goma_tpu_torch.mesh.mesh import Block, Mesh


def polyline_block(mesh: Mesh, pts: np.ndarray, name: str = "immersed",
                   closed: bool = False) -> int:
    """Append a BAR2 chain through ``pts`` (n, dim) as a new block with its
    own (new) nodes, overlapping the existing mesh. Returns the block index.
    Also registers nodeset ``name`` with the new nodes."""
    pts = np.asarray(pts, dtype=float)
    n0 = mesh.n_nodes
    npt = pts.shape[0]
    mesh.coords = np.concatenate([mesh.coords, pts], axis=0)
    ids = n0 + np.arange(npt, dtype=np.int32)
    seg = np.stack([ids[:-1], ids[1:]], axis=1)
    if closed:
        seg = np.concatenate([seg, np.array([[ids[-1], ids[0]]], dtype=np.int32)])
    mesh.blocks.append(Block(name=name, elem_type="BAR2", conn=seg.astype(np.int32)))
    mesh.nodesets[name] = ids
    return len(mesh.blocks) - 1


def circle_block(mesh: Mesh, center, radius: float, n: int = 32,
                 name: str = "immersed") -> int:
    """Closed immersed circle (rigid-particle boundary)."""
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    c = np.asarray(center, dtype=float)
    pts = c[None, :] + radius * np.stack([np.cos(th), np.sin(th)], axis=1)
    return polyline_block(mesh, pts, name=name, closed=True)


def merge_mesh(mesh: Mesh, other: Mesh, prefix: str = "m2") -> int:
    """Append all blocks of ``other`` (with their own, unshared nodes) to
    ``mesh`` — the overlapping-mesh setup of the reference's overset contact.
    Node/side sets arrive as ``prefix:name``. Returns the block index of
    ``other``'s first block."""
    n0 = mesh.n_nodes
    e0 = mesh.n_elem
    first = len(mesh.blocks)
    mesh.coords = np.concatenate([mesh.coords, other.coords], axis=0)
    for b in other.blocks:
        mesh.blocks.append(Block(f"{prefix}:{b.name}", b.elem_type,
                                 (b.conn + n0).astype(np.int32), b.material))
    for name, nodes in other.nodesets.items():
        mesh.nodesets[f"{prefix}:{name}"] = (np.asarray(nodes) + n0).astype(
            np.int32)
    from goma_tpu_torch.mesh.mesh import SideSet

    for name, ss in other.sidesets.items():
        mesh.sidesets[f"{prefix}:{name}"] = SideSet(
            (np.asarray(ss.elems) + e0).astype(np.int32),
            np.asarray(ss.faces).astype(np.int32))
    return first
