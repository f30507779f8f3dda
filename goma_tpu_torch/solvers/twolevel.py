"""Two-level (p-multigrid) preconditioner: Q2 -> Q1 coarsening with an
exact dense coarse solve on the device (counterpart of
``goma_tpu/solvers/twolevel.py``).

- Restriction/prolongation P is the nodal embedding of the Q1/P1 subspace
  (corner-node dofs) into the full mixed space, built once on the host;
  P z_c is a gather (``cids``, pad sentinel ``nc``) and P^T r a transpose
  gather (``rpos``), each with <= 2^dim weights per fine dof.
- The Galerkin coarse operator A_c = P^T A P is rebuilt from the CSR
  values every factorization: the per-nnz expansion (``ac_rep``, ``ac_w``)
  is summed into the sparse coarse pattern and densified. The expansion is
  sorted by coarse entry once on the host (stable, so each entry keeps
  goma_tpu's order of summands) and reduced by ``torch.segment_reduce``
  over fixed offsets: no atomics, so the sum is the same on every run (a
  float ``index_add_`` on CUDA is not), and on the CPU it sums in
  goma_tpu's ``segment_sum`` order.
- Coarse solve: ``"lu"`` (``torch.linalg.lu_factor_ex``/``lu_solve``, the
  default on every device) or ``"inv"`` (goma_tpu's TPU choice: a float32
  saddle-split explicit inverse, one matvec per apply).
- Smoother: Vanka (element-block additive Schwarz) or node-block Jacobi.

The coarse space holds the full saddle-point structure (velocity Q1 +
pressure Q1 + elemental dofs), so the coarse solve is a true mixed solve.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.elements import element_type, eval_basis, interp_local_nodes
from goma_tpu_torch.fem.sparsity import transpose_gather as _transpose_gather
from goma_tpu_torch.solvers.linear import BlockJacobi, Vanka, _ext
from goma_tpu_torch.utils.la import saddle_split_inv

QUAD_TO_LIN = {"Q2": "Q1", "P2": "P1"}


def _saddle_mask(problem, saddle_vars=("pressure", "lm")) -> np.ndarray:
    """Boolean (n_dof,) mask of dofs belonging to saddle-point (zero-diagonal
    Lagrange-multiplier-like) variables. Used to order the coarse space so
    the Schur-split block inverse pivots on the elliptic block first."""
    dofmap = problem.dofmap
    mask = np.zeros(dofmap.n_dof, dtype=bool)
    for name in saddle_vars:
        if name not in dofmap.svar_offset:
            continue
        v = dofmap.var(name)
        for c in range(v.ncomp):
            d = dofmap.dof_of_node_svar[:, dofmap.svar(name, c)]
            mask[d[d >= 0]] = True
        for bd in dofmap.blocks:
            for s in bd.slots:
                if s.var == name and s.interp in ("P0", "P1E"):
                    mask[bd.gather[:, s.start : s.start + s.size].ravel()] = True
    return mask


def _fine_to_coarse_weights(problem, saddle_vars=("pressure", "lm")):
    """Per fine dof: coarse dof ids + interpolation weights. For nodal
    slots with quadratic interpolation the coarse space is the linear
    (corner-node) sub-interpolation; linear/elemental slots inject. Coarse
    dofs are ordered elliptic first, saddle last (``_saddle_mask``).
    Returns (nc, cids, wts, n_elliptic); ``cids`` pads with ``nc``."""
    from goma_tpu_torch.mesh.mesh import _ref_nodes

    dofmap = problem.dofmap
    n = dofmap.n_dof
    is_coarse = np.zeros(n, dtype=bool)
    # (fine dof, coarse dof, weight) triples, deduped at the end (elements
    # sharing a fine dof repeat the same weights)
    tri_d, tri_c, tri_w = [], [], []
    for bd, blk in zip(dofmap.blocks, problem.mesh.blocks):
        et = element_type(blk.elem_type)
        ref = _ref_nodes(et)
        for s in bd.slots:
            if s.interp in ("P0", "P1E") or s.interp not in QUAD_TO_LIN:
                sl = bd.gather[:, s.start : s.start + s.size].ravel()
                is_coarse[sl] = True
                tri_d.append(sl.astype(np.int64))
                tri_c.append(sl.astype(np.int64))
                tri_w.append(np.ones(sl.shape[0]))
                continue
            lin = QUAD_TO_LIN[s.interp]
            ln_f = list(interp_local_nodes(et.family, s.interp))
            ln_c = list(interp_local_nodes(et.family, lin))
            # linear basis at the fine interpolation nodes
            W, _ = eval_basis(et.family, lin, ref[ln_f])  # (nbf_f, nbf_c)
            ii, jj = np.nonzero(np.abs(W) > 1e-14)
            for c in range(s.ncomp):
                cols = bd.gather[:, s.start + c * s.nbf : s.start + (c + 1) * s.nbf]
                ccols = cols[:, [ln_f.index(k) for k in ln_c]]
                is_coarse[ccols.ravel()] = True
                ne = cols.shape[0]
                tri_d.append(cols[:, ii].ravel().astype(np.int64))
                tri_c.append(ccols[:, jj].ravel().astype(np.int64))
                tri_w.append(np.broadcast_to(W[ii, jj], (ne, ii.shape[0])).ravel())
    # elliptic first, saddle last: the blocked coarse inverse splits
    # unpivoted, which is stable only while every leading block is elliptic
    saddle = _saddle_mask(problem, saddle_vars)
    cdofs = np.where(is_coarse)[0]
    order = np.argsort(saddle[cdofs], kind="stable")
    n_elliptic = int((~saddle[cdofs]).sum())
    coarse_id = np.full(n, -1, dtype=np.int64)
    coarse_id[cdofs[order]] = np.arange(cdofs.shape[0])
    nc = int(is_coarse.sum())
    td = np.concatenate(tri_d)
    tc = np.concatenate(tri_c)
    tw = np.concatenate(tri_w)
    _, first = np.unique(td * np.int64(n) + tc, return_index=True)
    td, tc, tw = td[first], tc[first], tw[first]
    order = np.argsort(td, kind="stable")
    td, tc, tw = td[order], tc[order], tw[order]
    st = np.searchsorted(td, np.arange(n))
    en = np.searchsorted(td, np.arange(n) + 1)
    kmax = max(int((en - st).max()), 1)
    # pad with the out-of-range sentinel nc, not 0: a 0 pad would make
    # coarse dof 0 collect every pad slot in the transpose-gather map
    cids = np.full((n, kmax), nc, dtype=np.int64)
    wts = np.zeros((n, kmax))
    for k in range(kmax):
        sel = st + k < en
        cids[sel, k] = coarse_id[tc[(st + k)[sel]]]
        wts[sel, k] = tw[(st + k)[sel]]
    return nc, cids, wts, n_elliptic


def coarse_dof_count(problem) -> tuple[int, int]:
    """(nc, n): the size of the Q1/P1 coarse space against the full dof
    count, without the transfer weights (the ``precond="auto"`` probe)."""
    dofmap = problem.dofmap
    n = dofmap.n_dof
    is_coarse = np.zeros(n, dtype=bool)
    for bd, blk in zip(dofmap.blocks, problem.mesh.blocks):
        et = element_type(blk.elem_type)
        for s in bd.slots:
            if s.interp not in QUAD_TO_LIN:
                is_coarse[bd.gather[:, s.start : s.start + s.size].ravel()] = True
                continue
            ln_f = list(interp_local_nodes(et.family, s.interp))
            ln_c = list(interp_local_nodes(et.family, QUAD_TO_LIN[s.interp]))
            for c in range(s.ncomp):
                cols = bd.gather[:, s.start + c * s.nbf : s.start + (c + 1) * s.nbf]
                is_coarse[cols[:, [ln_f.index(k) for k in ln_c]].ravel()] = True
    return int(is_coarse.sum()), n


class TwoLevel:
    """V(pre, post)-cycle two-level preconditioner with an exact dense
    coarse solve."""

    #: optional bfloat16 storage of the smoother inverses (set on
    #: ``self.bj``) and of the dense coarse inverse (``coarse_solve="inv"``);
    #: the applies upcast to the vector's dtype
    store_dtype = None

    def __init__(self, problem, smooth_damp: float = 0.7, pre_sweeps: int = 1,
                 post_sweeps: int = 1, coarse_solve: str | None = None,
                 smoother: str = "bj"):
        self.device = dev = problem.device
        if smoother == "vanka":
            # constraint-aware: overset multiplier rows join Schwarz blocks
            # with their coupled dofs (the port's Problem has no such sets)
            extras = [s.gather for s in getattr(problem, "ovs_sets", [])]
            self.bj = Vanka(problem.pattern, problem.dofmap, problem=problem,
                            extra_gathers=extras or None)
        else:
            self.bj = BlockJacobi(problem.pattern, problem.dofmap, device=dev)
        self.smoother = smoother
        self.n = problem.pattern.n
        self.smooth_damp = smooth_damp
        self.pre_sweeps = pre_sweeps
        self.post_sweeps = post_sweeps
        # goma_tpu takes "inv" on a TPU only; "lu" on the card and the CPU
        self.coarse_solve = coarse_solve or "lu"
        if self.coarse_solve not in ("lu", "inv"):
            raise ValueError(f"coarse_solve={self.coarse_solve!r}")
        # refinement sweeps of the "inv" coarse apply (two dense matvecs
        # each); the float32 saddle-split inverse alone suffices
        self.refine_steps = 0
        # saddle-diagonal stabilization of the equal-order Galerkin coarse,
        # relative to the mean elliptic |diagonal| (see factor)
        self.coarse_reg = 1e-6

        nc, cids, wts, n_ell = _fine_to_coarse_weights(problem)
        self.nc = nc
        self.n_elliptic = n_ell
        if nc * nc > 2**31 - 1:
            raise ValueError("coarse space too large for dense two-level")
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                        device=dev)
        tables = dict(self.bj.tables)
        tables["cids"] = put(cids)
        tables["wts"] = put(wts)
        # per-nnz expansion of A_c = P^T A P into the sparse coarse pattern,
        # sorted by coarse entry (stable) for the segment reduction
        pat = problem.pattern
        k = cids.shape[1]
        r = pat.rows.astype(np.int64)
        c = pat.indices.astype(np.int64)
        flat = (cids[r][:, :, None] * nc + cids[c][:, None, :]).reshape(-1)
        w = (wts[r][:, :, None] * wts[c][:, None, :]).reshape(-1)
        keep = np.abs(w) > 1e-14
        flat = flat[keep]
        ckeys, ac_idx = np.unique(flat, return_inverse=True)
        order = np.argsort(ac_idx, kind="stable")
        self._c_nnz = ckeys.shape[0]
        tables["ac_w"] = put(w[keep][order])
        tables["ac_rep"] = put(np.repeat(np.arange(pat.nnz), k * k)[keep][order])
        tables["ac_off"] = put(np.searchsorted(ac_idx[order],
                                               np.arange(self._c_nnz + 1)))
        tables["c_rows"] = put(ckeys // nc)
        tables["c_cols"] = put(ckeys % nc)
        # scatter-free restriction: per coarse dof, the positions of its
        # fine contributions in the flattened (n * kmax) weighted array
        tables["rpos"] = put(_transpose_gather(cids.reshape(-1), nc))
        self.tables = tables

    # ------------------------------------------------------------- transfer
    def restrict(self, r, tb=None):
        """r_c = P^T r (transpose gather)."""
        tb = tb or self.tables
        contrib = (tb["wts"].to(r.dtype) * r[:, None]).reshape(-1)
        return torch.sum(_ext(contrib)[tb["rpos"]], dim=1)

    def prolong(self, zc, tb=None):
        """z = P z_c (the pad sentinel nc reads the appended zero)."""
        tb = tb or self.tables
        return torch.sum(tb["wts"].to(zc.dtype) * _ext(zc)[tb["cids"]], dim=1)

    # ---------------------------------------------------------------- cycle
    def coarse_matrix(self, vals, tb=None):
        """The dense Galerkin coarse matrix A_c = P^T A P with the
        saddle-diagonal shift, at the dtype of ``vals``."""
        tb = tb or self.tables
        ac_vals = tb["ac_w"].to(vals.dtype) * vals[tb["ac_rep"]]
        cvals = torch.segment_reduce(ac_vals, "sum", offsets=tb["ac_off"],
                                     unsafe=True)
        Ac = vals.new_zeros((self.nc, self.nc))
        Ac[tb["c_rows"], tb["c_cols"]] = cvals
        if self.coarse_reg and self.n_elliptic < self.nc:
            # the restricted space is equal-order (Q1/Q1) and not inf-sup
            # stable: a tiny negative saddle-diagonal shift ([A B^T; B -eps
            # I]) bounds its checkerboard pressure mode away from zero
            dm = (torch.mean(torch.abs(torch.diagonal(Ac)[: self.n_elliptic]))
                  if self.n_elliptic else vals.new_ones(()))
            idx = torch.arange(self.n_elliptic, self.nc, device=vals.device)
            Ac[idx, idx] += -self.coarse_reg * dm
        return Ac

    def factor_coarse(self, Ac):
        if self.coarse_solve == "inv":
            # split at the elliptic/saddle boundary, float32 (goma_tpu's)
            inv32 = saddle_split_inv(Ac.to(torch.float32), self.n_elliptic)
            if self.store_dtype is not None:
                inv32 = inv32.to(self.store_dtype)
            return (inv32, Ac)
        LU, piv, _ = torch.linalg.lu_factor_ex(Ac)
        return (LU, piv)

    def factor(self, vals, matvec, tb=None):
        tb = tb or self.tables
        Binv = self.bj.factor(vals, tb)
        return (Binv, self.factor_coarse(self.coarse_matrix(vals, tb)), matvec)

    def _coarse_apply(self, coarse, rc):
        if self.coarse_solve == "inv":
            inv32, Ac = coarse
            inv32 = inv32.to(torch.float32)
            z = (inv32 @ rc.to(torch.float32)).to(rc.dtype)
            for _ in range(self.refine_steps):
                r2 = rc - Ac @ z
                z = z + (inv32 @ r2.to(torch.float32)).to(rc.dtype)
            return z
        LU, piv = coarse
        return torch.linalg.lu_solve(LU, piv, rc.to(LU.dtype)[:, None])[:, 0]

    def apply(self, fac, r, tb=None):
        tb = tb or self.tables
        Binv, coarse, matvec = fac
        # the first pre-sweep starts from z = 0: no matvec(0)
        z = self.smooth_damp * self.bj.apply(Binv, r, tb)
        for _ in range(self.pre_sweeps - 1):
            z = z + self.smooth_damp * self.bj.apply(Binv, r - matvec(z), tb)
        rc = self.restrict(r - matvec(z), tb)
        z = z + self.prolong(self._coarse_apply(coarse, rc).to(r.dtype), tb)
        for _ in range(self.post_sweeps):
            z = z + self.smooth_damp * self.bj.apply(Binv, r - matvec(z), tb)
        return z
