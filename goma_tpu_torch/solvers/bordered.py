"""Bordered Newton: designated dofs solved as augmenting conditions
(counterpart of ``goma_tpu/solvers/bordered.py``).

Parity: the reference's overlap AC variant of overset contact,
``src/mm_augc_util.c:2914 create_overlap_acs``, creates one augmenting
condition per overlap multiplier component, and the Newton loop solves
them by BORDERING the base matrix (``src/mm_sol_nonlinear.c:1523-1724``):
k + 1 base solves build the Schur complement of the multiplier block. Here,
as in goma_tpu, the same monolithic (R, J) the Problem assembles is split
at a dof mask, so AD already provides every coupling block the reference
hand-codes (bAC/cAC/dAC):

    [J_bb  B][dx]   [-R_b]     w0  = J_bb^-1 R_b,  W_j = J_bb^-1 B_j
    [C     D][dl] = [-R_l]  => S   = D - C W
                               dl  = -S^-1 (R_l - C w0)
                               dx  = -(w0 - W dl)   [signs: x <- x + dx]

The base block (multiplier rows and columns deleted) is elliptic, so it
factors with the multifrontal NDLU (``invert=False``: every base solve runs
the substitution kernel twice per level) with no saddle deferral, or with
the host SuperLU (``base_solver="direct"``). goma_tpu maps its one solve
over the k + 1 right-hand sides; here each column is one ``NDLU.solve``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BorderedResult:
    x: np.ndarray
    converged: bool
    iters: int
    res_norms: list


def multiplier_dof_mask(problem, var: str = "lm") -> np.ndarray:
    """(n_dof,) bool mask of the overset multiplier dofs (the ``lm``
    elemental variable of the bar block)."""
    dofmap = problem.dofmap
    mask = np.zeros(dofmap.n_dof, dtype=bool)
    for bd in dofmap.blocks:
        for s in bd.slots:
            if s.var == var:
                mask[bd.gather[:, s.start:s.start + s.size].ravel()] = True
    return mask


class BorderedNewtonSolver:
    """Newton with the masked dofs bordered out of the base solve.

    ``border``: bool (n_dof,) mask (e.g. :func:`multiplier_dof_mask`). The
    base solve is the multifrontal LU on the Problem's device (``ndlu``,
    float32 factors, two refinement sweeps against the assembled values)
    or the host SuperLU (``direct``). Meant for modest border counts: k + 1
    base-solve columns an iteration, like the reference's overlap ACs."""

    def __init__(self, problem, border: np.ndarray, options=None,
                 base_solver: str = "ndlu", leaf_max: int = 96):
        from goma_tpu_torch.fem.sparsity import CSRPattern
        from goma_tpu_torch.solvers.newton import NewtonOptions

        self.problem = problem
        self.opts = options or NewtonOptions()
        self.base_solver = base_solver
        self.device = problem.device
        pat = problem.pattern
        self.border = np.asarray(border, dtype=bool)
        self.base_ids = np.flatnonzero(~self.border)
        self.lam_ids = np.flatnonzero(self.border)
        nb, k = self.base_ids.shape[0], self.lam_ids.shape[0]
        self.k = k
        if k == 0:
            raise ValueError("bordered solve with an empty border mask")

        # split the CSR pattern once: entry classes by (row, col) membership
        new_id = np.full(pat.n, -1, dtype=np.int64)
        new_id[self.base_ids] = np.arange(nb)
        lam_id = np.full(pat.n, -1, dtype=np.int64)
        lam_id[self.lam_ids] = np.arange(k)
        r_b = new_id[pat.rows] >= 0
        c_b = new_id[pat.indices] >= 0
        self.sel_bb = np.flatnonzero(r_b & c_b)
        self.sel_B = np.flatnonzero(r_b & ~c_b)  # base rows, border cols
        self.sel_C = np.flatnonzero(~r_b & c_b)
        self.sel_D = np.flatnonzero(~r_b & ~c_b)
        # the base block's sub-pattern (its entries keep their row-major
        # order, so the kept values are vals[sel_bb])
        rows_bb = new_id[pat.rows[self.sel_bb]]
        cols_bb = new_id[pat.indices[self.sel_bb]].astype(np.int32)
        indptr = np.concatenate(([0], np.cumsum(np.bincount(
            rows_bb, minlength=nb)))).astype(np.int64)
        keys = rows_bb * nb + cols_bb
        diag = np.searchsorted(keys, np.arange(nb, dtype=np.int64) * nb
                               + np.arange(nb))
        self.sub_pattern = CSRPattern(
            n=nb, indptr=indptr, indices=cols_bb,
            rows=rows_bb.astype(np.int32), keys=keys,
            diag=diag.astype(np.int64))
        # the positions of B (nb, k), C (k, nb) and D (k, k) entries
        self.B_rc = (new_id[pat.rows[self.sel_B]], lam_id[pat.indices[self.sel_B]])
        self.C_rc = (lam_id[pat.rows[self.sel_C]], new_id[pat.indices[self.sel_C]])
        self.D_rc = (lam_id[pat.rows[self.sel_D]], lam_id[pat.indices[self.sel_D]])
        self._t = {name: torch.as_tensor(a, device=self.device) for name, a in (
            ("bb", self.sel_bb), ("B", self.sel_B), ("C", self.sel_C),
            ("D", self.sel_D), ("Br", self.B_rc[0]), ("Bc", self.B_rc[1]),
            ("Cr", self.C_rc[0]), ("Cc", self.C_rc[1]), ("Dr", self.D_rc[0]),
            ("Dc", self.D_rc[1]), ("base", self.base_ids),
            ("lam", self.lam_ids))}
        self._ndlu = None
        self._ell = None
        if base_solver == "ndlu":
            from goma_tpu_torch.fem.sparsity import EllOperator
            from goma_tpu_torch.solvers.ndlu import NDLU

            self._ndlu = NDLU(self.sub_pattern, leaf_max=leaf_max,
                              dtype=torch.float32, device=self.device)
            self._ell = EllOperator(self.sub_pattern, device=self.device)

    def _base_solve(self, vals_bb, rhs_cols):
        """J_bb^-1 applied to each column of ``rhs_cols`` (nb, m)."""
        if self._ndlu is not None:
            nd = self._ndlu
            fac = nd.factor(vals_bb)
            cols = []
            for j in range(rhs_cols.shape[1]):
                b = rhs_cols[:, j]
                sol = nd.solve(fac, b).to(vals_bb.dtype)
                # two refinement sweeps against the assembled-precision
                # operator
                for _ in range(2):
                    sol = sol + nd.solve(
                        fac, b - self._ell.matvec(vals_bb, sol)).to(vals_bb.dtype)
                cols.append(sol)
            return torch.stack(cols, dim=1)
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        sub = self.sub_pattern
        A = sp.csr_matrix((vals_bb.cpu().numpy().astype(np.float64),
                           sub.indices, sub.indptr), shape=(sub.n, sub.n))
        sol = spla.splu(A.tocsc()).solve(
            rhs_cols.cpu().numpy().astype(np.float64))
        return torch.as_tensor(sol, dtype=vals_bb.dtype, device=vals_bb.device)

    def solve(self, x0, params) -> BorderedResult:
        opts = self.opts
        prob = self.problem
        t = self._t
        x = torch.as_tensor(np.asarray(x0), dtype=prob.dtype, device=self.device)
        nb, k = self.base_ids.shape[0], self.k
        res_norms = []
        converged = False
        it = 0
        for it in range(opts.max_iter):
            R, vals = prob._assemble(x, params)
            l2 = float(torch.linalg.vector_norm(R))
            linf = float(torch.max(torch.abs(R)))
            res_norms.append((l2, linf))
            if linf < opts.tol_residual:
                converged = True
                break
            # every (row, col) is one pattern entry: plain assignments
            B = vals.new_zeros((nb, k))
            B[t["Br"], t["Bc"]] = vals[t["B"]]
            C = vals.new_zeros((k, nb))
            C[t["Cr"], t["Cc"]] = vals[t["C"]]
            D = vals.new_zeros((k, k))
            D[t["Dr"], t["Dc"]] = vals[t["D"]]
            Rb, Rl = R[t["base"]], R[t["lam"]]
            # k + 1 base solves: [w0 | W] = J_bb^-1 [Rb | B]
            sol = self._base_solve(vals[t["bb"]], torch.cat([Rb[:, None], B], dim=1))
            w0, W = sol[:, 0], sol[:, 1:]
            S = D - C @ W
            dl = -torch.linalg.solve(S.to(torch.float64),
                                     (Rl - C @ w0).to(torch.float64))
            dx_b = -(w0 + W @ dl.to(w0.dtype))
            x = x.index_put((t["base"],), x[t["base"]] + opts.damp * dx_b.to(x.dtype))
            x = x.index_put((t["lam"],), x[t["lam"]] + opts.damp * dl.to(x.dtype))
        return BorderedResult(x=x.cpu().numpy(), converged=converged,
                              iters=it, res_norms=res_norms)
