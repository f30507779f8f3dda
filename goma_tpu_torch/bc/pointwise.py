"""Pointwise (collocated) nodal constraints and additive nodal loads
(counterpart of ``goma_tpu/bc/pointwise.py``).

Parity: reference ``src/bc_colloc.c:73 apply_point_colloc_bc`` — BCs enforced
at boundary nodes by replacing one equation row with a pointwise constraint,
including the geometry family (PLANE ``fplane:855``, FILLET, SPLINE) that
pins ALE mesh nodes to analytic surfaces — and the "special" BCs of
``src/bc_special.c:77``, which add a nodal term to rows instead.

A constraint is g(q, X0, params) = 0 where q are the variable's components
at the node and X0 the undeformed coordinates; the row's Jacobian entries
come from ``torch.func.jacfwd`` of g, mapped over the nodes of the set with
``torch.func.vmap``, as the generic element assembly maps its elements.
``g`` (and a load's ``f``) is written on torch tensors and must not write
into its arguments.

The host builders are goma_tpu's; the Problem puts each set's index
tables on its device (``Problem._build_tables``: ``pc{k}:*`` and
``pld{k}:*``). A point load's rows and CSR positions may repeat (two nodes
of a periodic deck share a root's dofs), so its sums go through a
host-built gather plan (``fem.sparsity.add_plan``), deterministic on the
GPU, where goma_tpu scatter-adds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from goma_tpu_torch.fem.sparsity import add_at


@dataclass
class PointConstraintSet:
    g: Callable  # g(q (ncomp,), X0 (dim,), params) -> scalar
    rows: np.ndarray  # (n,) replaced dof rows
    dofs: np.ndarray  # (n, ncomp) the node's variable dofs
    coords: np.ndarray  # (n, dim)
    entry_pos: np.ndarray  # (n, ncomp) CSR positions of (row, dofs)
    zero_pos: np.ndarray  # flat positions of all row entries (to clear)


def build_point_constraints(problem, specs) -> list[PointConstraintSet]:
    """specs: list of (nodeset, var, replace_comp, g).

    ``var`` may be a list of variable names for multi-variable constraints
    (e.g. the TOTAL_ALE mesh<->solid tie): q passed to g is then the
    concatenation of all listed variables' components at the node, and the
    replaced row is component ``replace_comp`` of the *first* variable.

    Duplicate resolution (reference ``src/mm_bc_conflict.c``): a row may be
    claimed by at most one strong condition. DIRICHLET specs take
    precedence over everything (``:806``); among the remaining strong
    claims — rotated constraints (built first) and collocated point
    constraints, in registration order — the FIRST one is kept and later
    ones discarded (``:1000`` "The first one is kept, while the second one
    is discarded"). Every resolution is appended to ``problem.bc_dup_log``
    (the analog of the reference's ``-bc_dup`` diagnostic file)."""
    import warnings

    out = []
    pat = problem.pattern
    dofmap = problem.dofmap
    mesh = problem.mesh
    log = getattr(problem, "bc_dup_log", None)
    claimed: dict[int, str] = {}
    rot = getattr(problem, "_rotation", None)
    if rot is not None and rot.con_rows.size:
        for r in rot.con_rows:
            claimed[int(r)] = "rotated constraint"
    for si, (nodeset, var, comp, g) in enumerate(specs):
        nodes = mesh.nodesets[nodeset] if isinstance(nodeset, str) else np.asarray(nodeset)
        vlist = [var] if isinstance(var, str) else list(var)
        ncomps = [dofmap.var(v).ncomp for v in vlist]
        rows, dofs, coords, epos, zpos = [], [], [], [], []
        for node in np.sort(nodes):
            dd = np.concatenate([
                np.array([dofmap.dof_of_node_svar[node, dofmap.svar(v, c)]
                          for c in range(nc)])
                for v, nc in zip(vlist, ncomps)
            ])
            if np.any(dd < 0):
                continue
            ncomp = dd.shape[0]
            row = int(dd[comp])
            if problem._dir_mask[row]:
                # DIRICHLET precedence: a Dirichlet spec on this dof swamps
                # the collocated condition (mm_bc_conflict.c:806 "first give
                # all DIRICHLET Conditions Precedence")
                if log is not None:
                    log.append({"row": row, "node": int(node),
                                "kept": "DIRICHLET",
                                "dropped": f"point constraint #{si} ({var})",
                                "rule": "DIRICHLET precedence "
                                        "(mm_bc_conflict.c:806)"})
                continue
            prior = claimed.get(row)
            if prior is not None:
                # first strong claim wins (mm_bc_conflict.c:1000)
                if log is not None:
                    log.append({"row": row, "node": int(node),
                                "kept": prior,
                                "dropped": f"point constraint #{si} ({var})",
                                "rule": "first strong claim kept "
                                        "(mm_bc_conflict.c:1000)"})
                warnings.warn(
                    f"point constraint #{si} on {var} at node {int(node)} "
                    f"discarded: row already claimed by {prior} (first "
                    "strong claim wins, mm_bc_conflict.c dup rule)",
                    stacklevel=2)
                continue
            claimed[row] = f"point constraint #{si} ({var})"
            p = pat.find(np.full(ncomp, row), dd)
            if np.any(p < 0):
                raise RuntimeError("point constraint entries missing from pattern")
            rows.append(row)
            dofs.append(dd)
            coords.append(mesh.coords[node])
            epos.append(p)
            zpos.append(np.arange(pat.indptr[row], pat.indptr[row + 1]))
        if not rows:
            continue
        out.append(
            PointConstraintSet(
                g=g,
                rows=np.array(rows, dtype=np.int64),
                dofs=np.stack(dofs),
                coords=np.stack(coords),
                entry_pos=np.stack(epos),
                zero_pos=np.concatenate(zpos),
            )
        )
    return out


def apply_point_constraints(problem, sets, x, R, vals, params, T):
    """Replace each constraint row: R_row = g, and (``vals`` given) the
    row's CSR entries by dg. Returns (R, vals, dgs), ``dgs`` the per-set
    row Jacobians (n, ncomp) of the matrix-free operator."""
    from torch.func import jacfwd, vmap

    dgs = []
    for k, pc in enumerate(sets):
        q = x[T[f"pc{k}:dofs"]]  # (n, ncomp)
        X0 = T[f"pc{k}:coords"]

        def g1(qi, Xi, pc=pc):
            return pc.g(qi, Xi, params)

        gv = vmap(g1)(q, X0)  # (n,)
        dg = vmap(jacfwd(g1, argnums=0))(q, X0)  # (n, ncomp)
        dgs.append(dg)
        R = R.index_put((T[f"pc{k}:rows"],), gv.to(R.dtype))
        if vals is not None:
            vals = vals.index_put((T[f"pc{k}:zero"],), vals.new_zeros(()))
            vals = vals.index_put((T[f"pc{k}:epos"],), dg.to(vals.dtype))
    return R, vals, dgs


@dataclass
class PointLoadSet:
    """Additive nodal (weak point) terms — the reference's "special" BCs
    applied at single nodes (``src/bc_special.c:77 apply_special_bc``:
    contact-line forces, CAP_ENDFORCE surface-tension endpoint terms). Unlike
    point *constraints* these ADD to the residual rows and Jacobian instead
    of replacing them."""

    f: Callable  # f(q (ncomp_src,), X0 (dim,), params) -> (nload,)
    rows: np.ndarray  # (n, nload) target dof rows
    dofs: np.ndarray  # (n, ncomp_src) node-local source dofs
    coords: np.ndarray  # (n, dim)
    entry_pos: np.ndarray  # (n, nload, ncomp_src) CSR positions


def build_point_loads(problem, specs) -> list[PointLoadSet]:
    """specs: list of (nodeset, target_var, source_vars, f).

    ``f(q, X0, params) -> (ncomp(target_var),)`` is added to the target
    variable's residual rows at each node of the set; ``q`` concatenates the
    components of ``source_vars`` (default: just the target variable) at the
    node, and the row Jacobian comes from jacfwd of f."""
    out = []
    pat = problem.pattern
    dofmap = problem.dofmap
    mesh = problem.mesh
    for nodeset, tvar, svars, f in specs:
        nodes = mesh.nodesets[nodeset] if isinstance(nodeset, str) else np.asarray(nodeset)
        svars = [tvar] if svars is None else list(svars)
        nct = dofmap.var(tvar).ncomp
        ncs = [dofmap.var(v).ncomp for v in svars]
        rows, dofs, coords, epos = [], [], [], []
        for node in np.sort(np.asarray(nodes)):
            rr = np.array([dofmap.dof_of_node_svar[node, dofmap.svar(tvar, c)]
                           for c in range(nct)])
            dd = np.concatenate([
                np.array([dofmap.dof_of_node_svar[node, dofmap.svar(v, c)]
                          for c in range(nc)])
                for v, nc in zip(svars, ncs)
            ])
            if np.any(rr < 0) or np.any(dd < 0):
                continue
            p = pat.find(np.repeat(rr, dd.shape[0]), np.tile(dd, rr.shape[0]))
            if np.any(p < 0):
                raise RuntimeError("point load entries missing from pattern")
            rows.append(rr)
            dofs.append(dd)
            coords.append(mesh.coords[node])
            epos.append(p.reshape(nct, dd.shape[0]))
        if not rows:
            continue
        out.append(PointLoadSet(
            f=f,
            rows=np.stack(rows).astype(np.int64),
            dofs=np.stack(dofs),
            coords=np.stack(coords),
            entry_pos=np.stack(epos),
        ))
    return out


def apply_point_loads(problem, sets, x, R, vals, params, T):
    """Add point-load residual terms (and, when ``vals`` is given, their row
    Jacobians). Returns (R, vals, dfs) with dfs the per-set (n, nload, ncomp)
    derivative tensors for the matrix-free operator."""
    from torch.func import jacfwd, vmap

    dfs = []
    for k, pl in enumerate(sets):
        q = x[T[f"pld{k}:dofs"]]
        X0 = T[f"pld{k}:coords"]

        def f1(qi, Xi, pl=pl):
            return pl.f(qi, Xi, params)

        fv = vmap(f1)(q, X0)  # (n, nload)
        R = add_at(R, T[f"pld{k}:ru"], T[f"pld{k}:rp"], fv)
        df = vmap(jacfwd(f1, argnums=0))(q, X0)  # (n, nload, ncomp)
        dfs.append(df)
        if vals is not None:
            vals = add_at(vals, T[f"pld{k}:eu"], T[f"pld{k}:ep"], df)
    return R, vals, dfs


# ------------------------------------------------------- geometry functions
def _const(v: np.ndarray, like: torch.Tensor, cache: dict) -> torch.Tensor:
    """``v`` as a tensor at ``like``'s dtype and device, made once per pair."""
    key = (like.dtype, like.device)
    if key not in cache:
        cache[key] = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return cache[key]


def plane(normal, offset):
    """g = n.x - c = 0 (reference fplane). Constrains mesh nodes to a plane;
    use with var='mesh_displacement': x = X0 + d."""
    nrm = np.asarray(normal, dtype=float)
    cache: dict = {}

    def g(d, X0, params):
        x = X0 + d
        return torch.sum(_const(nrm, x, cache) * x) - offset

    return g


def surface(fun):
    """g = fun(x) with x = X0 + d (reference GEOM/SPLINE user surface)."""

    def g(d, X0, params):
        return fun(X0 + d)

    return g


def roll(center, radius):
    """ROLL_FLUID / FEATURE_ROLLON geometry (``src/bc_colloc.c`` froll
    family): pin displaced mesh nodes to a roll (circle/cylinder) surface,
    g = |x + d - c| - R. The FEATURE_ROLLON use gates the same surface at
    a feature; combine with a nodeset restricted to the rolled-on span."""
    c = np.asarray(center, dtype=float)
    R = float(radius)
    cache: dict = {}

    def g(d, X0, params):
        dim = X0.shape[0]
        x = X0 + d[:dim]
        return torch.linalg.vector_norm(x - _const(c[:dim], x, cache)) - R

    return g


def moving_plane(normal, offset0, rate):
    """MOVING_PLANE_ETCH (``src/bc_colloc.c`` moving plane family): a plane
    receding at the etch rate, g = n.(x + d) - (offset0 + rate * t)."""
    nv = np.asarray(normal, dtype=float)
    cache: dict = {}

    def g(d, X0, params):
        dim = X0.shape[0]
        x = X0 + d[:dim]
        t = params.get("time", 0.0)
        return torch.sum(_const(nv[:dim], x, cache) * x) - (offset0 + rate * t)

    return g
