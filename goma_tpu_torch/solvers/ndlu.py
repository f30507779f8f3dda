"""Nested-dissection multifrontal LU (counterpart of
``goma_tpu/solvers/ndlu.py``): the lagged, selectively inverted
preconditioner of the GMRES path and the exact direct solver of the
``tpu_direct`` path.

- **Host symbolic phase** (once per sparsity pattern, a verbatim copy of
  goma_tpu's): recursive graph bisection builds a nested-dissection
  separator tree; each tree node owns its separator dofs, and its *front*
  is [own | boundary]. Levels are processed deepest-first.
- **Device numeric phase**: per level, the hand-written front-gather kernel
  (``solvers/front_gather``) writes every front slot from the CSR values
  through a dense per-slot map, one-hot matmuls extend-add the children's
  Schur complements, the hand-written front-LU kernel factors the
  fully-summed blocks (``solvers/batched_lu``), and batched products form
  the Schur update.
  - ``invert=True``: triangular solves against the identity invert L and U
    once, so every apply is batched matvecs (a Krylov wrapper absorbs the
    inverse-apply rounding).
  - ``invert=False``: the packed LU is kept, and every apply is an exact
    substitution through the hand-written kernel ``solvers/batched_trsv``;
    ``solve_refined`` adds iterative refinement against the fresh operator.

Static pivoting (SuperLU_DIST GESP-style): no pivoting across the
own/boundary split; tiny pivots are boosted to tau*max|diag|.

Front LU routes (``front_lu``): the hand kernel on every level with
1 < s <= 1000 (``"auto"``, ``"pallas"``), and goma_tpu's pivoted library
route on every other level, or on every level (``"lax"``): partial
pivoting (``torch.linalg.lu_factor_ex``), blocked into ``lu_block`` x
``lu_block`` diagonal panels with the GESP boost per panel, or one plain
pivoted LU with the boost after it. A pivoted level's factors carry the
row permutation, which the substitution applies to the right-hand side.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch import config
from goma_tpu_torch.fem.sparsity import CSRPattern

_FRONT_LU = ("auto", "pallas", "lax")


# ------------------------------------------------------------------ symbolic
@dataclass
class _Level:
    depth: int
    nn: int
    smax: int
    bmax: int
    own_w: np.ndarray   # (nn, smax) int32 dof ids; pad -> n (dummy slot)
    bnd_w: np.ndarray   # (nn, bmax) int32 dof ids; pad -> n+1
    # compact (front-linear-position, source) pairs for the CSR entries;
    # NDLU.__init__ builds the dense per-slot gather map from them
    a_lin: np.ndarray   # int32 into nn*f*f
    a_src: np.ndarray   # int32 into vals
    # child Schur extend-add as PERMUTED DENSE BLOCKS: the child's Schur
    # complement is dense on its boundary, so extend-add is
    # F[q] += P S_child P^T with P the (f, cb) one-hot placing child
    # boundary slots into the parent front — two MXU matmuls instead of an
    # arbitrary (nn, f, f) gather (measured 10-40x cheaper on v5e: XLA
    # lowers arbitrary gathers element-by-element, ~600 ms for a 23M-slot
    # map vs <25 ms for the matmuls)
    c0_pos: np.ndarray | None  # (nn, cb) parent-front slot of child-0
    #                            boundary element i; pad -> f (one-hot 0)
    c0_idx: np.ndarray | None  # (nn,) child-0 lvl_pos in child level
    c1_pos: np.ndarray | None
    c1_idx: np.ndarray | None
    cb: int             # child-level bmax (0 = no children anywhere)
    pad_node: np.ndarray  # identity-pad own slots
    pad_slot: np.ndarray


def _bisect(xadj, adjncy, n):
    """0/1 bisection of a subgraph (native multilevel FM; BFS fallback)."""
    from goma_tpu_torch.native import bisect_partition

    w = np.ones(adjncy.shape[0], dtype=np.int64)
    return bisect_partition(xadj.astype(np.int64), adjncy.astype(np.int64), w)


def zero_diag_defer_mask(pattern: CSRPattern, vals,
                         tol: float = 1e-12) -> np.ndarray:
    """(n,) bool mask of rows whose diagonal is (near-)zero relative to the
    row max — saddle/multiplier rows that must be ordered LAST within each
    frontal block so the blocked panel LU never factors a structurally
    singular leading sub-block (cf. the reference routing such systems to
    full-pivoting UMFPACK, ``src/sl_umf.c``)."""
    import scipy.sparse as sp

    v = np.asarray(vals, dtype=np.float64)
    A = sp.csr_matrix((v, pattern.indices, pattern.indptr),
                      shape=(pattern.n, pattern.n))
    d = np.abs(A.diagonal())
    rowmax = np.abs(A).max(axis=1).toarray().ravel()
    return d <= tol * np.maximum(rowmax, 1e-300)


def node_clusters(problem) -> np.ndarray:
    """(n_dof,) cluster ids grouping every mesh node's dofs (velocity +
    pressure + scalars at that node) into one atomic unit for the ND
    bisection; elemental (P0/P1E) dofs stay singletons. See
    :func:`build_nd_tree` ``clusters``."""
    dm = problem.dofmap
    n = dm.n_dof
    cl = np.arange(n, dtype=np.int64)
    cnt = np.asarray(dm.node_dof_count)
    start = np.asarray(dm.node_dof_start)
    live = np.flatnonzero(cnt > 0)
    idx = np.concatenate([start[i] + np.arange(cnt[i]) for i in live]) \
        if live.size else np.empty(0, np.int64)
    cl[idx] = n + np.repeat(live, cnt[live])
    return cl


def build_nd_tree(pattern: CSRPattern, leaf_max: int = 96, debug: bool = False,
                  defer_dofs: np.ndarray | None = None,
                  clusters: np.ndarray | None = None):
    """Host symbolic analysis: separator tree + per-level gather plans.

    ``defer_dofs`` (bool (n,)): dofs ordered last within each tree node's
    own block (stable), so the unpivoted front LU (and goma_tpu's
    panel-restricted pivoting) factors the elliptic sub-block before any
    zero-diagonal saddle row.

    ``clusters`` (int (n,)): atomic dof groups — bisection and separators
    operate on the CLUSTER graph, so all dofs of a cluster land in the
    same tree node. Passing the mesh-node clustering keeps every saddle
    (pressure) dof in the same front as its own node's conjugate momentum
    rows, the structural guarantee that the defer-ordered unpivoted front
    elimination fills the saddle diagonals before they pivot (the per-deck
    leaf_max tuning this replaces: docs/PERFORMANCE.md r2 notes)."""
    import time as _time

    import scipy.sparse as sp

    _t = {"t0": _time.perf_counter()}

    def _mark(name):
        if debug:
            now = _time.perf_counter()
            print(f"ndlu symbolic [{name}]: {now - _t['t0']:.2f}s")
            _t["t0"] = now

    n = pattern.n
    A = sp.csr_matrix((np.ones(pattern.nnz, dtype=np.int8), pattern.indices,
                       pattern.indptr), shape=(n, n))
    G = (A + A.T).tocsr()
    G.setdiag(0)
    G.eliminate_zeros()

    if clusters is not None:
        # condense the dof graph to the cluster graph, run the IDENTICAL
        # tree construction on it, and expand own/boundary sets back to
        # dofs at the end (the recursion below sees cluster vertex ids)
        cl = np.asarray(clusters, dtype=np.int64)
        _, cl = np.unique(cl, return_inverse=True)  # densify ids
        ncl = int(cl.max()) + 1
        Pm = sp.csr_matrix((np.ones(n, np.int8), (cl, np.arange(n))),
                           shape=(ncl, n))
        Gc = (Pm @ G @ Pm.T).tocsr()
        Gc.setdiag(0)
        Gc.eliminate_zeros()
        order = np.argsort(cl, kind="stable")
        cstart = np.searchsorted(cl[order], np.arange(ncl + 1))
        dofs_of_cluster = [order[cstart[i]:cstart[i + 1]] for i in range(ncl)]
        csize = np.diff(cstart)
        G_work, n_work = Gc, ncl
    else:
        G_work, n_work = G, n
        csize = np.ones(n, dtype=np.int64)

    own_of, parent, depth = [], [], []  # per tree node

    mark = np.full(n_work, -1, dtype=np.int64)  # global -> local id scratch

    def _subgraph(verts: np.ndarray):
        """CSR of G_work restricted to `verts` (vectorized; ~6x faster than
        scipy's double fancy-index)."""
        k = verts.shape[0]
        mark[verts] = np.arange(k)
        start = G_work.indptr[verts]
        cnt = G_work.indptr[verts + 1] - start
        total = int(cnt.sum())
        # flat positions of all rows' entries: repeat each row start, add
        # a within-row ramp
        off = np.repeat(start - np.concatenate(([0], np.cumsum(cnt)[:-1])),
                        cnt)
        pos = off + np.arange(total)
        loc = mark[G_work.indices[pos]]
        keep = loc >= 0
        row_of = np.repeat(np.arange(k), cnt)[keep]
        indptr = np.concatenate(
            ([0], np.cumsum(np.bincount(row_of, minlength=k))))
        mark[verts] = -1
        return indptr.astype(np.int64), loc[keep].astype(np.int64)

    def rec(verts: np.ndarray, par: int, d: int) -> None:
        if int(csize[verts].sum()) <= leaf_max:
            own_of.append(verts)
            parent.append(par)
            depth.append(d)
            return
        sub_indptr, sub_indices = _subgraph(verts)
        part = _bisect(sub_indptr, sub_indices, verts.shape[0])
        m0 = part == 0
        if m0.all() or not m0.any():
            own_of.append(verts)
            parent.append(par)
            depth.append(d)
            return
        # vertex separator: smaller of the two edge-cut boundaries
        src = np.repeat(np.arange(verts.shape[0]), np.diff(sub_indptr))
        cross = part[src] != part[sub_indices]
        b0 = np.unique(src[cross & m0[src]])
        b1 = np.unique(src[cross & ~m0[src]])
        sep = b0 if b0.shape[0] <= b1.shape[0] else b1
        sep_mask = np.zeros(verts.shape[0], dtype=bool)
        sep_mask[sep] = True
        me = len(own_of)
        own_of.append(verts[sep_mask])
        parent.append(par)
        depth.append(d)
        c0 = verts[m0 & ~sep_mask]
        c1 = verts[~m0 & ~sep_mask]
        if c0.shape[0]:
            rec(c0, me, d + 1)
        if c1.shape[0]:
            rec(c1, me, d + 1)

    rec(np.arange(n_work, dtype=np.int32), -1, 0)
    _mark("recursion")
    n_nodes = len(own_of)
    if clusters is not None:
        # expand cluster vertex sets back to dof sets; everything below
        # (boundaries, entry assignment) runs on the dof graph G
        own_of = [
            np.concatenate([dofs_of_cluster[c] for c in verts]).astype(
                np.int64)
            if verts.shape[0] else np.empty(0, np.int64)
            for verts in own_of
        ]
    if defer_dofs is not None:
        # elliptic-first / saddle-last inside every own block: with blocked
        # panel LU the leading panels then always pivot on rows that carry a
        # (possibly Schur-filled) nonzero diagonal
        for t in range(n_nodes):
            own = own_of[t]
            if own.shape[0] > 1:
                own_of[t] = own[np.argsort(defer_dofs[own], kind="stable")]
    depth = np.asarray(depth)
    parent = np.asarray(parent)

    owner = np.empty(n, dtype=np.int32)
    pos_in_own = np.empty(n, dtype=np.int32)
    for t, own in enumerate(own_of):
        owner[own] = t
        pos_in_own[own] = np.arange(own.shape[0], dtype=np.int32)

    # proper-ancestor matrix (n_nodes small: <= a few thousand)
    anc = np.zeros((n_nodes, n_nodes), dtype=bool)
    for t in range(n_nodes):
        p = parent[t]
        while p >= 0:
            anc[t, p] = True
            p = parent[p]

    children: list[list[int]] = [[] for _ in range(n_nodes)]
    for t in range(n_nodes):
        if parent[t] >= 0:
            children[parent[t]].append(t)

    # bottom-up boundaries: B(t) = (N(own t) ∪ B(children)) ∩ ancestors(t)
    bnd_of: list[np.ndarray] = [None] * n_nodes
    for t in sorted(range(n_nodes), key=lambda q: -depth[q]):
        own = own_of[t]
        nbr = [G.indices[G.indptr[v]:G.indptr[v + 1]] for v in own]
        cand = [np.concatenate(nbr)] if nbr else [np.empty(0, np.int32)]
        for c in children[t]:
            cand.append(bnd_of[c])
        cand = np.unique(np.concatenate(cand)).astype(np.int32)
        keep = anc[t, owner[cand]]
        bnd_of[t] = cand[keep]

    _mark("boundaries")
    # level grouping by depth; per-node (level, index-in-level)
    max_d = int(depth.max())
    level_nodes = [np.where(depth == d)[0] for d in range(max_d + 1)]
    lvl_pos = np.empty(n_nodes, dtype=np.int32)
    for d, ids in enumerate(level_nodes):
        lvl_pos[ids] = np.arange(ids.shape[0], dtype=np.int32)

    smax = [max((own_of[t].shape[0] for t in ids), default=1) or 1
            for ids in level_nodes]
    bmax = [max((bnd_of[t].shape[0] for t in ids), default=0)
            for ids in level_nodes]
    smax = [max(s, 1) for s in smax]

    # (node, dof) -> boundary-slot lookup table
    bkeys, bvals = [], []
    for t in range(n_nodes):
        b = bnd_of[t]
        if b.shape[0]:
            bkeys.append(t * np.int64(n) + b.astype(np.int64))
            bvals.append(np.arange(b.shape[0], dtype=np.int32))
    bkeys = np.concatenate(bkeys) if bkeys else np.empty(0, np.int64)
    bvals = np.concatenate(bvals) if bvals else np.empty(0, np.int32)
    order = np.argsort(bkeys)
    bkeys, bvals = bkeys[order], bvals[order]

    def bnd_pos(ts, dofs):
        k = ts.astype(np.int64) * n + dofs.astype(np.int64)
        p = np.searchsorted(bkeys, k)
        p = np.clip(p, 0, max(bkeys.shape[0] - 1, 0))
        if bkeys.shape[0] == 0 or not np.all(bkeys[p] == k):
            raise RuntimeError("ndlu: boundary lookup miss (broken separator tree)")
        return bvals[p]

    _mark("lookups")
    # assign CSR entries to the deeper endpoint's node, vectorized
    ri, ci = pattern.rows, pattern.indices
    oi, oj = owner[ri], owner[ci]
    di, dj = depth[oi], depth[oj]
    if not np.all((di != dj) | (oi == oj)):
        raise RuntimeError("ndlu: entry between separated parts (bad separator)")
    t_ent = np.where(di >= dj, oi, oj).astype(np.int32)
    d_ent = depth[t_ent]
    s_ent = np.asarray(smax)[d_ent]
    own_i = owner[ri] == t_ent
    own_j = owner[ci] == t_ent
    r_ent = np.where(own_i, pos_in_own[ri], 0)
    c_ent = np.where(own_j, pos_in_own[ci], 0)
    if np.any(~own_i):
        r_ent[~own_i] = s_ent[~own_i] + bnd_pos(t_ent[~own_i], ri[~own_i])
    if np.any(~own_j):
        c_ent[~own_j] = s_ent[~own_j] + bnd_pos(t_ent[~own_j], ci[~own_j])

    _mark("entries")
    levels: list[_Level] = []
    for d in range(max_d, -1, -1):  # deepest first (elimination order)
        ids = level_nodes[d]
        nn = ids.shape[0]
        s, b = smax[d], bmax[d]
        f = s + b
        own_w = np.empty((nn, s), dtype=np.int32)
        own_w.fill(n)
        bnd_w = np.empty((nn, b), dtype=np.int32)
        bnd_w.fill(n + 1)
        pad_node, pad_slot = [], []
        for q, t in enumerate(ids):
            o, bb = own_of[t], bnd_of[t]
            own_w[q, :o.shape[0]] = o
            if bb.shape[0]:
                bnd_w[q, :bb.shape[0]] = bb
            if o.shape[0] < s:
                pad_node.append(np.full(s - o.shape[0], q, np.int32))
                pad_slot.append(np.arange(o.shape[0], s, dtype=np.int32))
        pad_node = np.concatenate(pad_node) if pad_node else np.empty(0, np.int32)
        pad_slot = np.concatenate(pad_slot) if pad_slot else np.empty(0, np.int32)

        # COMPACT (lin, src) pairs only — NDLU.__init__ expands them into
        # the dense per-slot gather map. Sentinel convention: map value 0 is
        # the dummy, real sources are stored +1 (the source array gets a
        # zero prepended, NDLU.front_values).
        if nn * f * f + 1 >= np.iinfo(np.int32).max:
            raise RuntimeError("ndlu: level front array exceeds int32 "
                               "indexing; raise leaf_max")
        sel = d_ent == d
        a_lin = ((lvl_pos[t_ent[sel]].astype(np.int64) * f
                  + r_ent[sel]) * f + c_ent[sel]).astype(np.int32)
        a_src = np.flatnonzero(sel).astype(np.int32)

        c0_pos = c0_idx = c1_pos = c1_idx = None
        cb = 0
        if d < max_d:
            cids = level_nodes[d + 1]
            cb = bmax[d + 1]
            c0_pos = np.full((nn, cb), f, dtype=np.int32)
            c1_pos = np.full((nn, cb), f, dtype=np.int32)
            c0_idx = np.zeros(nn, dtype=np.int32)
            c1_idx = np.zeros(nn, dtype=np.int32)
            for c in cids:
                bc = bnd_of[c]
                k = bc.shape[0]
                t = parent[c]
                q = int(lvl_pos[t])
                which = 0 if children[t][0] == c else 1
                (c0_idx if which == 0 else c1_idx)[q] = int(lvl_pos[c])
                if not k:
                    continue  # empty boundary: all-pad row, zero one-hot
                mine = owner[bc] == t
                fp = np.where(mine, pos_in_own[bc], 0).astype(np.int64)
                if np.any(~mine):
                    fp[~mine] = s + bnd_pos(np.full((~mine).sum(), t), bc[~mine])
                (c0_pos if which == 0 else c1_pos)[q, :k] = fp

        levels.append(_Level(d, nn, s, b, own_w, bnd_w, a_lin, a_src,
                             c0_pos, c0_idx, c1_pos, c1_idx, cb,
                             pad_node, pad_slot))
    _mark("levels")
    return levels



# ------------------------------------------------------------------ numeric
def _scatter_plan(idx: np.ndarray, n: int):
    """For an (nn, k) dof-index table with pads >= n: the real dofs it
    touches (unique, sorted) and an (n_unique, c) map of their positions in
    ``idx.ravel()`` (pad -> idx.size, a zero slot), so a scatter-add into
    those dofs becomes a gather + row sum (deterministic on the GPU)."""
    flat = idx.ravel().astype(np.int64)
    real = np.flatnonzero(flat < n)
    dofs = flat[real]
    order = np.argsort(dofs, kind="stable")
    ud, start, counts = np.unique(dofs[order], return_index=True,
                                  return_counts=True)
    c = int(counts.max()) if counts.size else 1
    pos = np.full((ud.shape[0], c), flat.shape[0], dtype=np.int64)
    for j in range(c):
        sel = counts > j
        pos[sel, j] = real[order[start[sel] + j]]
    return ud, pos


class NDLU:
    """Device multifrontal LU for a fixed :class:`CSRPattern`:
    ``factor(vals)`` -> per-level factors, ``solve(facs, b)`` applies the
    inverse through the tree (batched matvecs against explicit inverses
    with ``invert=True``, substitution with ``invert=False``),
    ``solve_refined`` wraps ``solve`` in iterative refinement.

    ``device``: ``None`` is the card (``config.resolve_device``).

    ``front_lu``: "auto" and "pallas" factor every level with
    1 < s <= 1000 with ``solvers.batched_lu`` — the CUDA kernel for a CUDA
    tensor, its plain twin for a CPU tensor — so the CPU tests and the GPU
    run one algorithm, and every other level by the pivoted route; "lax"
    takes the pivoted route on every level. goma_tpu's "auto" is "lax" off
    a TPU; the port's stays on the kernel. The unpivoted kernel needs
    ``defer_dofs`` ordering on saddle systems (see
    ``zero_diag_defer_mask`` and ``twolevel._saddle_mask``).

    ``lu_block``: the pivoted route's panel width: pivoting is restricted
    to ``lu_block`` x ``lu_block`` diagonal panels and a level with
    s > ``lu_block`` is factored identity-padded to a whole number of
    panels (m = ceil(s / lu_block) lu_block); ``None`` is one plain
    pivoted LU per front.
    """

    def __init__(self, pattern: CSRPattern, leaf_max: int = 96,
                 dtype=torch.float32, pivot_tol: float = 1e-8,
                 lu_block: int | None = 128,
                 defer_dofs: np.ndarray | None = None,
                 front_lu: str = "auto", invert: bool = False,
                 clusters: np.ndarray | None = None, device=None):
        if front_lu not in _FRONT_LU:
            raise ValueError(f"NDLU(front_lu={front_lu!r}): one of {_FRONT_LU}")
        self.pattern = pattern
        self.dtype = dtype
        self.pivot_tol = pivot_tol
        self.lu_block = lu_block
        #: "auto" | "pallas" (the kernel where 1 < s <= 1000) | "lax"
        self.front_lu = front_lu
        self.invert = invert
        #: ``solve`` calls so far (each runs the substitution kernel twice
        #: per kernel level when ``invert=False``)
        self.n_solve = 0
        #: the pivoted route's LUs (one a front, or a panel of one) that
        #: met an exact zero pivot (``lu_factor_ex``'s ``info`` > 0; the
        #: boost then sets it): a 0-d device tensor, read by the caller
        self.zero_pivots = 0
        self.device = config.resolve_device(device)
        self.levels = build_nd_tree(pattern, leaf_max=leaf_max,
                                    defer_dofs=defer_dofs,
                                    clusters=clusters)
        self.n = n = pattern.n
        dev = self.device

        def put(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        def onehot(pos, f):
            # (nn, f, cb) placement: P[q, pos[q, i], i] = 1; pad slots
            # (pos == f) fall off the end -> all-zero column; built on the
            # device from the (nn, cb) positions
            nn, cb = pos.shape
            P = torch.zeros((nn, f + 1, cb), dtype=dtype, device=dev)
            qq = torch.arange(nn, device=dev).repeat_interleave(cb)
            ii = torch.arange(cb, device=dev).repeat(nn)
            P[qq, put(pos.ravel()), ii] = 1.0
            return P[:, :f, :].contiguous()

        self.tabs = []
        for lev in self.levels:
            f = lev.smax + lev.bmax
            # dense per-slot source map of the level's fronts: CSR position
            # + 1, or 0 (the zero that ``front_values`` prepends)
            gmap = np.zeros(lev.nn * f * f, np.int32)
            gmap[lev.a_lin] = lev.a_src + 1
            p0 = p1 = i0 = i1 = None
            if lev.c0_pos is not None and lev.cb:
                p0 = onehot(lev.c0_pos, f)
                p1 = onehot(lev.c1_pos, f)
                i0 = put(lev.c0_idx)
                i1 = put(lev.c1_idx)
            own_flat = lev.own_w.ravel()
            own_sel = np.flatnonzero(own_flat < n)
            bnd_dofs, bnd_pos = _scatter_plan(lev.bnd_w, n)
            self.tabs.append(dict(
                own_w=put(lev.own_w), bnd_w=put(lev.bnd_w),
                own_sel=put(own_sel), own_dofs=put(own_flat[own_sel]),
                bnd_dofs=put(bnd_dofs), bnd_pos=put(bnd_pos),
                gmap=put(gmap, torch.int32),
                p0=p0, p1=p1, i0=i0, i1=i1,
                pad_node=put(lev.pad_node), pad_slot=put(lev.pad_slot),
            ))

    def front_values(self, vals):
        """The gather source of ``front``: [0, CSR values] at the factor
        dtype, built once per factorization."""
        v = vals.to(self.dtype)
        return torch.cat([v.new_zeros(1), v])

    def front(self, li: int, vals_ext, S_prev=None):
        """Assembled fronts (nn, f, f) of level ``li`` (deepest first): every
        slot gathered from ``vals_ext`` (``front_values``) through the
        level's slot map by the front-gather kernel, the children's Schur
        complements ``S_prev`` by one-hot extend-add, identity on pad own
        slots."""
        return self.extend_add(li, self.gather(li, vals_ext), S_prev)

    def gather(self, li: int, vals_ext):
        """Level ``li``'s fronts (nn, f, f) with the CSR values only: every
        slot gathered from ``vals_ext`` by the front-gather kernel."""
        from goma_tpu_torch.solvers.front_gather import front_gather

        lev, tb = self.levels[li], self.tabs[li]
        if vals_ext.shape != (self.pattern.nnz + 1,):
            raise ValueError("NDLU.front takes front_values(vals), "
                             f"(nnz + 1,), got {tuple(vals_ext.shape)}")
        f = lev.smax + lev.bmax
        return front_gather(vals_ext, tb["gmap"]).view(lev.nn, f, f)

    def extend_add(self, li: int, F, S_prev=None):
        """``F`` (from ``gather``) plus the children's Schur complements
        ``S_prev`` (one-hot extend-add) and identity on pad own slots."""
        lev, tb = self.levels[li], self.tabs[li]
        if S_prev is not None and tb["p0"] is not None:
            for P, idx in ((tb["p0"], tb["i0"]), (tb["p1"], tb["i1"])):
                F = F + P @ S_prev[idx] @ P.transpose(1, 2)
        if lev.pad_node.shape[0]:
            pn, ps = tb["pad_node"], tb["pad_slot"]
            F[pn, ps, ps] = F[pn, ps, ps] + 1.0
        return F

    def factor(self, vals):
        """Per-level factors (fwd, bwd, perm, X, Y) of the equilibrated CSR
        values ``vals``: fwd = L^-1, bwd = U^-1 with ``invert=True``, both
        the packed LU with ``invert=False``; perm the row permutation of a
        pivoted level (None on a kernel level); X = A21 U^-1, Y = L^-1 P A12
        (None on a level with no boundary)."""
        facs = []
        S_prev = None
        vals_ext = self.front_values(vals)
        for li in range(len(self.levels)):
            fac, S_prev = self.factor_level(li, self.front(li, vals_ext, S_prev))
            facs.append(fac)
        return facs

    def factor_level(self, li: int, F):
        """Factor level ``li``'s assembled fronts ``F`` (from ``front``):
        returns ((fwd, bwd, perm, X, Y), S) with S the Schur complements
        that the parent level extend-adds."""
        return self.factor_rest(li, F, *self.factor_front(li, F))

    def factor_front(self, li: int, F):
        """(packed LU (nn, m, m), row permutation (nn, m) or None) of level
        ``li``'s fully-summed blocks: the front-LU kernel where the route
        takes it (perm None, m = s), else the pivoted route (m = s, or the
        ``lu_block``-padded size)."""
        from goma_tpu_torch.solvers.batched_lu import batched_lu

        s = self.levels[li].smax
        A11 = F[:, :s, :s]
        if self.front_lu != "lax" and 1 < s <= 1000:
            return batched_lu(A11.contiguous(), pivot_tol=self.pivot_tol), None
        if self.lu_block and s > self.lu_block:
            return self._block_lu(A11)
        lu, perm = self._lu(A11)
        return self._boost(lu), perm

    def _lu(self, A):
        """Partial-pivoting LU of a batch (nn, k, k): (packed LU, the row
        permutation perm with A[perm] = L U), LAPACK's sequential swaps
        turned into the permutation ``lax.linalg.lu`` returns. An exact zero
        pivot is left unscaled, as LAPACK's getrf leaves it, and counted
        into ``zero_pivots``."""
        lu, piv, info = torch.linalg.lu_factor_ex(A, pivot=True)
        self.zero_pivots = self.zero_pivots + (info > 0).sum()
        P, _, _ = torch.lu_unpack(lu, piv, unpack_data=False)
        # A = P L U: row i of L U is row perm[i] of A, where P[perm[i], i] = 1
        return lu, P.argmax(dim=-2)

    def _boost(self, lu):
        """GESP static-pivot boost on the packed LU's diagonal: a pivot
        below tau = pivot_tol max(max|diag|, 1e-30) becomes -tau (negative)
        or +tau."""
        dg = torch.diagonal(lu, dim1=1, dim2=2)
        mx = dg.abs().amax(dim=1, keepdim=True)
        tau = self.pivot_tol * torch.clamp(mx, min=1e-30)
        fix = torch.where(dg.abs() < tau, torch.where(dg < 0, -tau, tau), dg)
        out = lu.clone()
        torch.diagonal(out, dim1=1, dim2=2).copy_(fix)
        return out

    def _block_lu(self, A11):
        """Blocked right-looking LU, pivoting restricted to the diagonal
        panels (goma_tpu's ``_block_lu``). Returns (packed LU (nn, m, m),
        row permutation (nn, m)) with m = ceil(s / bs) bs; padded slots are
        identity rows and columns."""
        bs = self.lu_block
        nn, s, _ = A11.shape
        nb = -(-s // bs)
        m = nb * bs
        A = A11.new_zeros((nn, m, m))
        A[:, :s, :s] = A11
        ar = torch.arange(s, m, device=A.device)
        A[:, ar, ar] = 1.0
        perms = []
        for k in range(nb):
            r0, r1 = k * bs, (k + 1) * bs
            lu_d, perm_d = self._lu(A[:, r0:r1, r0:r1])
            lu_d = self._boost(lu_d)
            # permute the whole row slab (the L columns already computed
            # too), write the packed diagonal LU, eliminate the right panel
            slab = torch.gather(A[:, r0:r1, :], 1,
                                perm_d[:, :, None].expand(nn, bs, m))
            slab[:, :, r0:r1] = lu_d
            if r1 < m:
                U12 = torch.linalg.solve_triangular(
                    lu_d, slab[:, :, r1:], upper=False, unitriangular=True)
                slab[:, :, r1:] = U12
            A[:, r0:r1, :] = slab
            if r1 < m:
                L21 = torch.linalg.solve_triangular(
                    lu_d, A[:, r1:, r0:r1], upper=True, left=False)
                A[:, r1:, r0:r1] = L21
                A[:, r1:, r1:] -= L21 @ U12
            perms.append(perm_d + r0)
        return A, torch.cat(perms, dim=1)

    def factor_rest(self, li: int, F, lu, perm=None):
        """The rest of ``factor_level`` after the front LU ``lu`` (row
        permutation ``perm``, None for the kernel's): the inverses
        (``invert=True``), X and Y, and the Schur complements. A padded LU
        (m > s) sees A12 and A21 padded with zero rows and columns."""
        lev = self.levels[li]
        s, m = lev.smax, lu.shape[-1]
        if self.invert:
            # invert ONCE so every later apply is a batched matvec
            eye = torch.eye(m, dtype=self.dtype,
                            device=self.device).expand(lev.nn, m, m)
            fwd = torch.linalg.solve_triangular(lu, eye, upper=False,
                                                unitriangular=True)
            bwd = torch.linalg.solve_triangular(lu, eye, upper=True)
        else:
            fwd = bwd = lu  # substitution path (exact triangular solves)
        if lev.bmax:
            A12, A21 = F[:, :s, s:], F[:, s:, :s]
            if m != s:  # identity-padded rows/cols contribute zeros
                A12 = torch.cat([A12, A12.new_zeros((lev.nn, m - s, lev.bmax))],
                                dim=1)
                A21 = torch.cat([A21, A21.new_zeros((lev.nn, lev.bmax, m - s))],
                                dim=2)
            if perm is not None:
                A12 = torch.gather(A12, 1, perm[:, :, None].expand(-1, -1, lev.bmax))
            if self.invert:
                Y = fwd @ A12   # L^-1 P A12
                X = A21 @ bwd   # A21 U^-1
            else:
                Y = torch.linalg.solve_triangular(lu, A12, upper=False,
                                                  unitriangular=True)
                X = torch.linalg.solve_triangular(lu, A21, upper=True,
                                                  left=False)
            S = F[:, s:, s:] - X @ Y
        else:
            X = Y = None
            S = torch.zeros((lev.nn, 0, 0), dtype=self.dtype,
                            device=self.device)
        return (fwd, bwd, perm, X, Y), S

    @staticmethod
    def _segment(v, m):
        """Own segments (nn, s) zero-extended to the factor's m columns."""
        if m == v.shape[1]:
            return v
        return torch.cat([v, v.new_zeros((v.shape[0], m - v.shape[1]))], dim=1)

    def solve(self, facs, b, trace: list | None = None):
        """x = A^-1 b through the tree: a forward sweep (deepest level
        first) and a backward sweep, batched matvecs against the inverses
        (``invert=True``) or substitutions against the packed LUs
        (``invert=False``: the kernel on kernel levels, ``solve_triangular``
        on pivoted ones). A pivoted level permutes its right-hand side.
        Returns x at the factor dtype. ``trace``: a list that receives
        (lu, rhs, lower) of every kernel substitution, in order."""
        from goma_tpu_torch.solvers.batched_trsv import batched_trsv

        self.n_solve += 1
        n = self.n
        w = torch.zeros(n + 2, dtype=self.dtype, device=self.device)
        w[:n] = b.to(self.dtype)
        for lev, tb, (fwd, bwd, perm, X, Y) in zip(self.levels, self.tabs, facs):
            bs = self._segment(w[tb["own_w"]], fwd.shape[-1])
            if perm is not None:
                bs = torch.gather(bs, 1, perm)
            if self.invert:
                y = torch.bmm(fwd, bs.unsqueeze(2)).squeeze(2)
            elif perm is None:
                if trace is not None:
                    trace.append((fwd, bs, True))
                y = batched_trsv(fwd, bs, lower=True)
            else:
                y = torch.linalg.solve_triangular(
                    fwd, bs.unsqueeze(2), upper=False,
                    unitriangular=True).squeeze(2)
            w[tb["own_dofs"]] = y[:, :lev.smax].reshape(-1)[tb["own_sel"]]
            if lev.bmax:
                c = torch.bmm(X, y.unsqueeze(2)).reshape(-1)
                c = torch.cat([c, c.new_zeros(1)])
                w[tb["bnd_dofs"]] -= torch.sum(c[tb["bnd_pos"]], dim=1)
        for lev, tb, (fwd, bwd, perm, X, Y) in zip(
                reversed(self.levels), reversed(self.tabs), reversed(facs)):
            y = self._segment(w[tb["own_w"]], bwd.shape[-1])
            if lev.bmax:
                y = y - torch.bmm(Y, w[tb["bnd_w"]].unsqueeze(2)).squeeze(2)
            if self.invert:
                x = torch.bmm(bwd, y.unsqueeze(2)).squeeze(2)
            elif perm is None:
                if trace is not None:
                    trace.append((bwd, y, False))
                x = batched_trsv(bwd, y, lower=False)
            else:
                x = torch.linalg.solve_triangular(
                    bwd, y.unsqueeze(2), upper=True).squeeze(2)
            w[tb["own_dofs"]] = x[:, :lev.smax].reshape(-1)[tb["own_sel"]]
        return w[:n]

    def solve_refined(self, facs, b, matvec, refine: int = 2,
                      rel_tol: float = 0.0, max_refine: int = 8,
                      return_rel: bool = False, sweep=None):
        """x = A^-1 b with iterative-refinement sweeps; ``matvec`` applies
        the SAME (equilibrated) operator the factorization saw, at its
        native (possibly higher) precision.

        ``refine`` fixed sweeps are always taken; if ``rel_tol > 0``,
        refinement continues (up to ``max_refine`` in all) until
        ||b - A x|| <= rel_tol * ||b||, and stops early when a sweep fails
        to cut the residual below 0.9x the last one (a lagged factor
        against a fresh operator stalls there; the caller decides whether
        to refactor).

        ``return_rel``: also return the measured ||b - A x|| / ||b|| of the
        RETURNED iterate, or None when the loop exited without measuring
        it (the caller recomputes it if needed).

        ``sweep``: optional step ``(facs, b, x) -> (x_new, rn)`` computing
        ``r = b - A x; rn = ||r||; x_new = x + solve(facs, r)``; the math is
        that of the path through ``matvec``."""
        x = self.solve(facs, b).to(b.dtype)
        bnorm = None
        prev_rn = None
        rel = None
        for it in range(max_refine):
            if sweep is not None:
                x_new, rn_d = sweep(facs, b, x)
            else:
                r = b - matvec(x)
                rn_d = None
            if it >= refine:
                if rel_tol <= 0.0:
                    break
                if bnorm is None:
                    bnorm = float(torch.linalg.norm(b))
                if rn_d is None:
                    rn_d = torch.linalg.norm(r)
                rn = float(rn_d)
                rel = rn / (bnorm + 1e-300)  # residual of the CURRENT x
                if not np.isfinite(rn) or rn <= rel_tol * (bnorm + 1e-300):
                    break
                if prev_rn is not None and rn >= 0.9 * prev_rn:
                    break  # refinement stalled or diverging
                prev_rn = rn
            x = (x_new if sweep is not None
                 else x + self.solve(facs, r).to(b.dtype))
            rel = None  # x moved past the last measurement
        return (x, rel) if return_rel else x
