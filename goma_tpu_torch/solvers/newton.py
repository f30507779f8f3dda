"""Damped full-Newton nonlinear solver (counterpart of
``goma_tpu/solvers/newton.py``) with goma_tpu's linear solvers and
preconditioners, and its GCRO-DR recycling (``recycle_k > 0``).

Per iteration: assemble, take the row-sum-scaled norms, test convergence,
solve the symmetrically equilibrated system (DAD) z = D R, and update
x <- x - lambda D z. Eisenstat-Walker forcing sets each Krylov tolerance;
``prep32_tol`` runs the far-from-solution preps entirely at the Jacobian
dtype.

- ``gmres``/``bicgstab``: the vals-free fast prep (R, element Jacobians
  and element row sums, ``Problem._assemble_fast``); operator the element
  matvec; a lagged preconditioner factored from the equilibrated CSR values
  only when it (re)factors: ``precond`` ``ndlu`` (the selectively inverted
  multifrontal LU), ``twolevel`` (Vanka or block-Jacobi smoother, dense
  Galerkin coarse solve), ``block_jacobi``, ``vanka``, ``fieldsplit``,
  ``pcd``, or ``auto`` (two-level when the Q1/P1 coarse space is a real
  reduction and small enough, else block Jacobi). ``precond_dtype``
  ``bf16``/``bf16-coarse`` store factors in bfloat16.
- ``tpu_direct``: assembled-vals prep (``Problem._assemble_with_elem``,
  ELL row sums) and a lagged NDLU(invert=False): exact substitution
  through the ``batched_trsv`` kernel plus iterative refinement against
  the fresh operator, refactoring once when the lagged factor misses the
  residual guard.
- ``direct``: the plain full-precision prep (``Problem._assemble``) and
  the host SuperLU solve (``direct_solve_host``); a ``LinearSolveError``
  ends the Newton solve unconverged, so the transient driver halves dt.
- ``row_scaling=False``: the full prep with R unscaled and a scale of
  ones (no fast prep), so the sequential loop runs.
- ``recycle_k > 0`` (``gmres``): GCRO-DR. Each solve re-orthonormalizes the
  recycled space U against its operator (C = A M U, ``_dr_setup``), runs
  deflated cycles (``linear.gmres_dr_cycle``) and harvests the k smallest
  harmonic Ritz vectors of its last cycle on the host (``_dr_harvest``,
  SciPy) as the next solve's U; ``reset_lagged`` drops U, and a
  ``TransientSolver`` carries it across time steps.
- a Problem with a row injection (``add_row_inject``) or a coupling set
  (``add_interface_kernel``, ``add_overset``, ``add_edge_kernel``): the
  element matvec's aux holds neither, so ``gmres``/``bicgstab`` take the
  full prep on the plain ``_assemble`` values and the ELL matvec of them,
  ``tpu_direct`` factors the plain ``_assemble`` values, and the
  sequential loop runs, as in goma_tpu.

``solve`` routes as goma_tpu routes: ``gmres`` with ``tol_update == 0`` on
the fast prep runs the pipelined loop (``_solve_pipelined``), everything
else the sequential loop (``_solve_sequential``). The pipelined loop
dispatches the prep, the Eisenstat-Walker tolerance (computed on the
device, ``_eta_device``) and the first GMRES cycle with no host read
between them, and reads the prep's norms in the first cycle's one sync; it
yields the same norm sequence and the same linear iterations as the
sequential loop. On a converged iteration its speculative solve is thrown
away (``n_discarded``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch.fem.sparsity import EllOperator, row_sums_ell
from goma_tpu_torch.solvers.linear import (LinearResult, LinearSolveError,
                                           bicgstab, direct_solve_host, gmres,
                                           gmres_dr_cycle, read_scalars)


@dataclass
class NewtonOptions:
    """goma_tpu's options, every field and default kept so decks carry
    over."""

    max_iter: int = 15
    # convergence on the row-scaled residual, like the reference's Epsilon[0]
    tol_residual: float = 1e-10
    # also require correction-norm convergence when > 0 (Epsilon[2] analog)
    tol_update: float = 0.0
    damp: float = 1.0
    # reference damping ladder (src/mm_sol_nonlinear.c:1998-2040): see
    # NewtonSolver._select_damp; off with the defaults
    damp_factor1: float | None = None  # None -> use ``damp``
    damp_factor2: float = -1.0
    damp_factor3: float = -1.0
    custom_tol1: float = -1.0
    custom_tol2: float = -1.0
    custom_tol3: float = -1.0
    row_scaling: bool = True
    linear_solver: str = "gmres"  # gmres | bicgstab | direct | tpu_direct
    ndlu_leaf_max: int = 96
    ndlu_refine: int = 1
    # atomic mesh-node clustering of the ND bisection: every saddle
    # (pressure) dof shares a front with its node's momentum rows
    ndlu_cluster: bool = True
    ndlu_dtype: str = "float32"  # factorization precision
    ndlu_lag: bool = True
    ndlu_max_refine: int = 8
    # auto: two-level p-multigrid when the problem has a genuinely smaller
    # Q1/P1 coarse space that fits a dense coarse solve, else block-Jacobi
    precond: str = "auto"  # auto | block_jacobi | fieldsplit | pcd | twolevel | ndlu
    fieldsplit_mu: float | None = None
    fieldsplit_rho: float | None = None
    fieldsplit_sweeps: int = 2
    # None: 1.0 for vanka (weighted overlap already averages), 0.7 for bj
    smooth_damp: float | None = None
    smooth_sweeps: int = 2
    # post-smoothing sweeps of the two-level cycle; None -> smooth_sweeps
    smooth_post_sweeps: int | None = None
    # two-level smoother: "bj" node-block Jacobi | "vanka" element-block
    # additive Schwarz
    smoother: str = "vanka"
    linear_tol: float = 1e-10
    gmres_restart: int = 120
    linear_maxiter: int = 600
    full_history: bool = True
    # inexact-Newton forcing: "ew" = Eisenstat-Walker choice 2,
    # eta_k = 0.5 (|R_k|/|R_{k-1}|)^1.5 clipped to [linear_tol, 0.1];
    # "fixed" always uses linear_tol
    forcing: str = "ew"  # ew | fixed
    ew_eta_floor: float = 0.0
    # "tighten": eta <- min(eta_ew, 0.5 tol/||R||); "standard": eta <-
    # max(eta_ew, 0.5 tol/||R||) (the classic oversolving safeguard)
    ew_endgame: str = "tighten"  # tighten | standard
    # preconditioner factor storage: "f32" (the factor dtype), "bf16"
    # (smoother inverses and the dense coarse inverse in bfloat16) or
    # "bf16-coarse" (the coarse inverse only); applies upcast to the
    # Krylov dtype
    precond_dtype: str = "f32"
    # lagged preconditioner: reuse the factor across Newton iterations
    # until the Krylov count grows past the staleness threshold over its
    # post-factor baseline; the Krylov OPERATOR is always fresh
    precond_lag: bool = True
    # staleness threshold; None -> 45 for "ndlu", else 2*gmres_restart.
    # Also fires MID-SOLVE: the solve refactors and continues from its
    # current iterate
    precond_stale_its: int | None = None
    # GCRO-DR: harmonic-Ritz vectors carried between the GMRES solves of a
    # Newton (and transient) sequence; 0 disables
    recycle_k: int = 0
    # switched-precision prep: while the row-scaled ||R||_2 stays ABOVE
    # this threshold the whole prep runs at the Jacobian dtype; the endgame
    # re-preps at full precision. 0 disables.
    prep32_tol: float = 0.0


@dataclass
class NewtonResult:
    x: np.ndarray
    converged: bool
    iters: int
    res_norms: list  # per-iter (L1, L2, Linf) of scaled residual
    update_norms: list
    linear_iters: list
    assembly_time: float = 0.0
    solve_time: float = 0.0

    def summary(self) -> str:
        lines = ["  it      ||R||_1      ||R||_2    ||R||_inf   lin.its"]
        for i, (l1, l2, li) in enumerate(self.res_norms):
            lin = self.linear_iters[i] if i < len(self.linear_iters) else "-"
            lines.append(f"  {i:2d}  {l1:11.4e}  {l2:11.4e}  {li:11.4e}   {lin}")
        return "\n".join(lines)


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class NewtonSolver:
    def __init__(self, problem, options: NewtonOptions | None = None):
        self.problem = problem
        self.opts = options or NewtonOptions()
        self.device = problem.device
        opts = self.opts
        kind = opts.precond
        if kind == "auto":
            # two-level pays off only when the Q1/P1 coarse space is both a
            # real reduction and small enough for a dense coarse solve
            from goma_tpu_torch.solvers.twolevel import coarse_dof_count

            nc, n = coarse_dof_count(problem)
            kind = "twolevel" if nc <= 0.8 * n and nc <= 16000 else "block_jacobi"
            if getattr(problem, "ovs_sets", None):
                # multiplier saddles need the constraint-aware Schwarz blocks
                kind = "vanka"
        self._precond_kind = kind
        self._direct = opts.linear_solver == "tpu_direct"
        self._host_direct = opts.linear_solver == "direct"
        pat = problem.pattern
        # the direct rungs' Newton solves read no preconditioner, so none
        # is built here; ``_solve_gmres`` (the continuation layer's solves)
        # builds the one ``precond`` names at its first call, as goma_tpu
        # builds it up front
        self.precond = (None if self._direct or self._host_direct
                        else self._build_precond(kind))
        # a row injection and the coupling sets (interface, overset, edge)
        # are not in the element matvec's aux: such a deck assembles the
        # plain CSR values (``_assemble``) and its Krylov operator is the
        # ELL matvec of them, as in goma_tpu; rotation, point constraints
        # and point loads stay on the element matvec
        elem_capable = (getattr(problem, "_inject", None) is None
                        and not getattr(problem, "ifc_sets", None)
                        and not getattr(problem, "ovs_sets", None)
                        and not getattr(problem, "edge_sets", None))
        self._use_elem_mv = elem_capable and not (self._direct
                                                  or self._host_direct)
        # tpu_direct assembles through the element path for the Jacobian
        # dtype (its aux is dropped: refinement matvecs through the ELL)
        self._elem_asm_only = elem_capable and self._direct
        # the vals-free fast prep (gmres/bicgstab with row scaling on the
        # element matvec); every other path takes the full prep, whose row
        # sums come from the ELL gather
        self._fast_prep = (self._use_elem_mv and opts.row_scaling
                           and opts.linear_solver in ("gmres", "bicgstab"))
        self._ell = None if self._fast_prep else EllOperator(pat, device=self.device)
        self._rows = torch.as_tensor(pat.rows.astype(np.int64), device=self.device)
        self._cols = torch.as_tensor(pat.indices.astype(np.int64), device=self.device)
        self._n = problem.dofmap.n_dof
        self._jdt = problem.jacobian_dtype or problem.dtype
        self._cur_x = None
        self._cur_params = None
        self._cur_ct = 0.0
        self._fac_cache = None
        self._fac_base_its = None
        #: fresh preconditioner factorizations so far (an NDLU one runs the
        #: front-LU kernel once per ND level)
        self.n_factor = 0
        self._ndlu = None  # lazy tpu_direct multifrontal LU
        self._ndlu_fac = None  # lagged tpu_direct factors (opts.ndlu_lag)
        #: fresh tpu_direct factorizations so far
        self._ndlu_nfactor = 0
        #: per tpu_direct solve: (refinement sweeps, i.e. residual
        #: evaluations each with a substitution, the relative residual of
        #: the step, whether its factor was fresh)
        self.direct_log = []
        #: speculative GMRES solves the pipelined loop threw away (on a
        #: converged iteration, or before the prep32 endgame re-prep)
        self.n_discarded = 0
        # GCRO-DR recycled space (a (k, n) device tensor) and the seconds
        # of every host harvest so far
        self._recycle_U = None
        self.harvest_s = []

    def _build_precond(self, kind):
        """The preconditioner ``kind`` names, on the Problem's device, with
        ``precond_dtype``'s factor storage."""
        pre = self._make_precond(kind)
        if self.opts.precond_dtype in ("bf16", "bf16-coarse"):
            pre.store_dtype = torch.bfloat16
            if self.opts.precond_dtype == "bf16" and hasattr(pre, "bj"):
                pre.bj.store_dtype = torch.bfloat16
        return pre

    def _make_precond(self, kind):
        problem, opts = self.problem, self.opts
        if kind == "vanka":
            from goma_tpu_torch.solvers.linear import Vanka

            extras = [s.gather for s in getattr(problem, "ovs_sets", [])]
            return Vanka(problem.pattern, problem.dofmap, problem=problem,
                         extra_gathers=extras or None)
        if kind == "fieldsplit":
            from goma_tpu_torch.solvers.linear import FieldSplit

            return FieldSplit(problem, mu=opts.fieldsplit_mu,
                              u_sweeps=opts.fieldsplit_sweeps)
        if kind == "pcd":
            from goma_tpu_torch.solvers.pcd import PCDFieldSplit

            mat = problem.materials[0] if problem.materials else {}
            mu, rho = opts.fieldsplit_mu, opts.fieldsplit_rho
            if mu is None:
                mu = mat.get("mu") if isinstance(mat.get("mu"), (int, float)) else 1.0
            if rho is None:
                rho = mat.get("rho") if isinstance(mat.get("rho"), (int, float)) else 1.0
            return PCDFieldSplit(problem, mu=mu, rho=rho,
                                 u_sweeps=opts.fieldsplit_sweeps)
        if kind == "twolevel":
            from goma_tpu_torch.solvers.twolevel import TwoLevel

            damp = opts.smooth_damp
            if damp is None:
                damp = 1.0 if opts.smoother == "vanka" else 0.7
            post = (opts.smooth_sweeps if opts.smooth_post_sweeps is None
                    else opts.smooth_post_sweeps)
            return TwoLevel(problem, smooth_damp=damp,
                            pre_sweeps=opts.smooth_sweeps, post_sweeps=post,
                            smoother=opts.smoother)
        if kind == "ndlu":
            # near-exact preconditioner: the multifrontal LU, selectively
            # inverted (applies are batched matvecs; GMRES wraps the apply)
            from goma_tpu_torch.solvers.ndlu import NDLU, node_clusters
            from goma_tpu_torch.solvers.twolevel import _saddle_mask

            return NDLU(problem.pattern, leaf_max=opts.ndlu_leaf_max,
                        dtype=_DTYPES[opts.ndlu_dtype],
                        defer_dofs=_saddle_mask(problem), invert=True,
                        clusters=node_clusters(problem)
                        if opts.ndlu_cluster else None,
                        device=self.device)
        from goma_tpu_torch.solvers.linear import BlockJacobi

        return BlockJacobi(problem.pattern, problem.dofmap, device=self.device)

    def reset_lagged(self):
        """Drop the lagged factors (preconditioner and tpu_direct NDLU) and
        the recycled space."""
        self._fac_cache = None
        self._fac_base_its = None
        self._ndlu_fac = None
        self._recycle_U = None

    # ------------------------------------------------------------ prep
    @staticmethod
    def _norms(Rn):
        """Residual norms (L1, L2, Linf) of the (row-scaled) residual in
        f32, max-scaled so the sum of squares cannot overflow."""
        Rn32 = Rn.to(torch.float32)
        mx = torch.max(torch.abs(Rn32))
        sc = torch.where(mx > 0, mx, torch.ones_like(mx))
        return torch.stack([torch.sum(torch.abs(Rn32 / sc)) * sc,
                            torch.linalg.norm(Rn32 / sc) * sc, mx])

    @classmethod
    def _row_scaled(cls, R, rs):
        """Norms of the row-sum-scaled residual R / rs and the symmetric
        equilibration scale 1/sqrt(rs) (rs <= 0 counts as 1)."""
        rs = torch.where(rs > 0, rs, torch.ones_like(rs))
        return cls._norms(R / rs), 1.0 / torch.sqrt(rs)

    def _prepare_fast(self, x, params):
        """Vals-free prep: (R, norms, scale, aux). Row sums come from the
        element Jacobians (Problem._assemble_fast)."""
        R, rs, aux = self.problem._assemble_fast(x, params)
        return (R, *self._row_scaled(R, rs), aux)

    def _prepare_fast32(self, x, params):
        """Switched-precision prep (opts.prep32_tol): the whole pass,
        residual included, at the Jacobian dtype."""
        R, rs, aux = self.problem._assemble_fast(x, params, rdt=self._jdt)
        return (R, *self._row_scaled(R, rs), aux)

    def _prepare(self, x, params):
        """The full prep (goma_tpu's ``_prepare``): (R, vals, norms, scale,
        aux). gmres/bicgstab assemble with the element Jacobians (their
        operator, ``aux``), ``tpu_direct`` likewise for the Jacobian dtype
        (aux unused); the host ``direct`` rung and a deck with a row
        injection take the plain full-precision ``_assemble`` (aux None:
        the operator is the ELL matvec of the values). With row scaling the
        row sums come from the ELL gather and the values are symmetrically
        equilibrated; without, R is unscaled and the scale is ones."""
        aux = None
        if self._use_elem_mv:
            R, vals, aux = self.problem._assemble_with_elem(x, params)
        elif self._elem_asm_only:
            R, vals, _ = self.problem._assemble_with_elem(x, params)
        else:
            R, vals = self.problem._assemble(x, params)
        if not self.opts.row_scaling:
            return (R, vals, self._norms(R),
                    torch.ones(self._n, dtype=vals.dtype, device=vals.device), aux)
        norms, scale = self._row_scaled(R, row_sums_ell(vals, self._ell.tables["pos"]))
        return R, self._equilibrate(vals, scale), norms, scale, aux

    def _equilibrate(self, vals, scale):
        """(DAD) values: vals[ij] * scale[i] * scale[j] at the vals dtype."""
        return vals * (scale[self._rows] * scale[self._cols]).to(vals.dtype)

    def _scaled_vals(self, x, params, scale):
        """Global CSR values, symmetrically equilibrated with the fast-prep
        scale — built only when the preconditioner (re)factors."""
        _, vals, _ = self.problem._assemble_with_elem(x, params)
        return self._equilibrate(vals, scale)

    # ------------------------------------------------------------ linear
    def _factor_num(self, vals):
        """Numeric preconditioner state for ``_apply_precond_mv``."""
        self.n_factor += 1
        kind = self._precond_kind
        if kind == "twolevel":
            Binv, coarse, _ = self.precond.factor(vals, None)
            return (Binv, coarse)
        if kind == "fieldsplit":
            Binv, _ = self.precond.factor(vals, None)
            return (Binv,)
        if kind == "pcd":
            # state-dependent: the convection of Fp at the current x
            xp = self._cur_x
            if xp is None:
                xp = torch.zeros(self._n, dtype=vals.dtype, device=vals.device)
            return self.precond.factor(vals, xp, self._cur_ct)
        return (self.precond.factor(vals),)

    def _apply_precond_mv(self, mv, fac_num, r):
        kind = self._precond_kind
        if kind in ("twolevel", "fieldsplit", "pcd"):
            return self.precond.apply((*fac_num, mv), r)
        if kind == "ndlu":
            return self.precond.solve(fac_num[0], r).to(r.dtype)
        return self.precond.apply(fac_num[0], r)

    def _matvec(self, scale, aux, vals=None):
        """The Krylov operator: the element matvec of the equilibrated
        system, the scale on both sides (the DAD of the CSR values); where
        the element matvec is off (a row injection) or no aux is given,
        the ELL matvec of the equilibrated values ``vals``."""
        if self._use_elem_mv and aux is not None:
            prob = self.problem
            return lambda v: prob.element_matvec(None, aux, scale, scale * v)
        return lambda v: self._ell.matvec(vals, v)

    def _factor_fresh(self, vals, scale):
        """Factor the preconditioner afresh and make it the lagged one,
        from the prep's values or (fast prep, ``vals`` None) the
        equilibrated CSR values at the current Newton state."""
        if vals is None:
            vals = self._scaled_vals(self._cur_x, self._cur_params, scale)
        fac = self._factor_num(vals)
        self._fac_cache = fac
        self._fac_base_its = None
        return fac

    def _gmres_cycle(self, scale, aux, fac_num, x, b, tol, extra=(),
                     vals=None):
        """One restarted-GMRES call of ``gmres_restart`` steps (the restart
        loop lives in _linsolve_gmres)."""
        mv = self._matvec(scale, aux, vals)
        M = lambda r: self._apply_precond_mv(mv, fac_num, r)  # noqa: E731
        return gmres(mv, b, precond=M, tol=tol, restart=self.opts.gmres_restart,
                     maxiter=self.opts.gmres_restart, x0=x, extra=extra)

    # ------------------------------------------------- GCRO-DR recycling
    @staticmethod
    def _dr_setup(mv, M, U):
        """Re-orthonormalize the recycled space against the current operator
        ``mv`` and preconditioner ``M``: (C, U) with C = A M U made
        orthonormal by a QR and U scaled to match (U R^-1); where R has a
        diagonal below 1e-12 of its largest (near-dependent harvested
        columns) the identity is added to R first."""
        AMU = torch.stack([mv(M(u)) for u in U])  # (k, n)
        Qc, Rc = torch.linalg.qr(AMU.T)  # (n, k), (k, k)
        d = torch.abs(torch.diagonal(Rc))
        ok = torch.all(d > 1e-12 * torch.max(d))
        Rc = Rc + (~ok).to(Rc.dtype) * torch.eye(Rc.shape[0], dtype=Rc.dtype,
                                                 device=Rc.device)
        return Qc.T, torch.linalg.solve_triangular(Rc.T, U, upper=False)

    def _dr_harvest(self, U, C, V, H, B, cnt):
        """Between-solves harvest (host dense math, goma_tpu's): the k
        smallest harmonic Ritz vectors of the composite space W = [U, V_m],
        using A M W = [C, V_{m+1}] G~ with G~ = [[I, B], [0, H]]: the pencil
        (G~^T G~) g = theta (G~^T Phi) g, Phi = [C V_{m+1}]^T W, solved by
        ``scipy.linalg.eig`` (Parks et al. 2006, Alg. 2). Returns the new
        (k, n) device U, or None when the cycle was too short (fewer than
        k + 2 steps) or the pencil gave no k finite values."""
        import scipy.linalg as sla

        k = self.opts.recycle_k
        m = int(cnt)
        if m < k + 2:
            return None  # cycle too short to harvest anything useful
        ku = U.shape[0] if U is not None else 0
        if ku:
            CU, VU = (C @ U.T).cpu().numpy(), (V @ U.T).cpu().numpy()
        Hh = H.cpu().numpy()[:m + 1, :m]
        Bh = B.cpu().numpy()[:, :m] if ku else np.zeros((0, m))
        Gt = np.zeros((ku + m + 1, ku + m))
        Gt[:ku, :ku] = np.eye(ku)
        Gt[:ku, ku:] = Bh
        Gt[ku:, ku:] = Hh
        Phi = np.zeros((ku + m + 1, ku + m))
        if ku:
            Phi[:ku, :ku] = CU
            Phi[ku:, :ku] = VU[:m + 1]
        Phi[ku:ku + m, ku:] = np.eye(m)
        try:
            w, vecs = sla.eig(Gt.T @ Gt, Gt.T @ Phi)
        except (np.linalg.LinAlgError, ValueError):
            return None
        finite = np.isfinite(w)
        if finite.sum() < k:
            return None
        vv = vecs[:, finite][:, np.argsort(np.abs(w[finite]))]
        # real basis from the leading columns: a complex pair gives its
        # real and imaginary parts (its conjugate twin is skipped)
        cols, seen, i = [], 0, 0
        while seen < k and i < vv.shape[1]:
            c = vv[:, i]
            if np.abs(c.imag).max() > 1e-13 * max(1.0, np.abs(c.real).max()):
                cols += [c.real, c.imag]
                seen += 2
                i += 2
            else:
                cols.append(c.real)
                seen += 1
                i += 1
        Gq, _ = np.linalg.qr(np.stack(cols[:k], axis=1))  # (ku + m, k)
        if not np.all(np.isfinite(Gq)):
            return None
        g_v = np.zeros((V.shape[0] - 1, k))
        g_v[:m] = Gq[ku:]
        # U_new = W g with W = [U; V_m] (rows)
        Un = torch.as_tensor(g_v, dtype=V.dtype, device=V.device).T @ V[:-1]
        if ku:
            Un = Un + torch.as_tensor(Gq[:ku], dtype=V.dtype,
                                      device=V.device).T @ U
        return Un.to(V.dtype)

    def _stale_its(self) -> int:
        """Krylov-iteration growth over the post-factor baseline that marks
        a lagged preconditioner factor stale (opts.precond_stale_its)."""
        if self.opts.precond_stale_its is not None:
            return int(self.opts.precond_stale_its)
        if self._precond_kind == "ndlu":
            return 45
        return 2 * self.opts.gmres_restart

    def _linsolve_gmres(self, R, scale, aux, tol=None, extra=None, vals=None):
        """Solve (DAD) z = D R by restarted GMRES; dx = D z. ``tol`` is a
        float or a 0-d device tensor (``_eta_device``); ``vals`` the prep's
        values (None on the fast prep: built when a factor needs them).
        ``||b||``, the tolerance and the ``extra`` tensors are read in the
        first cycle's first sync (the first cycle always runs); with
        ``extra`` given the return is ``(LinearResult, extra values)``."""
        opts = self.opts
        lagged = opts.precond_lag and self._fac_cache is not None
        fac = self._fac_cache if lagged else self._factor_fresh(vals, scale)
        # symmetric equilibration: solve (DAD) z = D R, then dx = D z
        b = (scale.to(R.dtype) * R).to(vals.dtype if vals is not None
                                       else self._jdt)
        z = torch.zeros_like(b)
        if tol is None:
            tol = opts.linear_tol
        target = None
        extra_vals = None
        it = 0
        rn = np.inf
        stale = self._stale_its()
        base = self._fac_base_its if lagged else None
        it_refac = 0
        kdr = opts.recycle_k
        if kdr > 0:
            # GCRO-DR: refresh the recycled space against this operator,
            # run deflated cycles, harvest for the next solve (no mid-solve
            # refactor, as in goma_tpu)
            mv = self._matvec(scale, aux, vals)
            M = lambda r: self._apply_precond_mv(mv, fac, r)  # noqa: E731
            U = self._recycle_U
            if U is not None and U.shape[0] == kdr:
                C, U = self._dr_setup(mv, M, U)
            else:
                U = C = b.new_zeros((0, b.shape[0]))
            V = H = Bm = None
            cnt = 0
        while (target is None or rn > target) and it < opts.linear_maxiter:
            if kdr == 0 and lagged and it >= (base or 0) + stale:
                # the lagged factor can't carry THIS solve's tolerance:
                # refactor mid-solve and continue from the current iterate
                fac = self._factor_fresh(vals, scale)
                lagged = False
                it_refac = it
            prev = rn
            ex = (extra or ()) if target is None else ()
            if kdr > 0:
                lr, V, H, Bm = gmres_dr_cycle(mv, M, b, z, U, C,
                                              opts.gmres_restart, tol, ex)
            else:
                lr = self._gmres_cycle(scale, aux, fac, z, b, tol, ex, vals)
            z, rn, cnt = lr.x, lr.resnorm, lr.iters
            if target is None:
                tol, extra_vals = lr.tol, lr.extra
                target = max(tol * lr.bnorm, 1e-300)
                if lr.bnorm == 0.0:
                    # zero right-hand side: z = 0 is the exact solution
                    out = LinearResult(x=scale * torch.zeros_like(b), iters=0,
                                       resnorm=0.0, converged=True)
                    return (out, extra_vals) if extra is not None else out
            cnt = max(cnt, 1)
            it += cnt
            if not np.isfinite(rn):
                break
            if rn >= 0.999 * prev:
                break  # stagnation
        if kdr > 0 and V is not None and np.isfinite(rn):
            t0 = time.perf_counter()
            Un = self._dr_harvest(U if U.shape[0] else None, C, V, H, Bm, cnt)
            self.harvest_s.append(time.perf_counter() - t0)
            if Un is not None:
                self._recycle_U = Un
        if target is None:  # the loop never ran (linear_maxiter <= 0)
            got = read_scalars([torch.linalg.norm(b), torch.as_tensor(
                tol, dtype=torch.float64, device=b.device)] + list(extra or ()))
            extra_vals = got[2:]
            target = max(got[1] * got[0], 1e-300)
        if opts.precond_lag:
            # staleness policy: drop the cached factor once the iteration
            # count degrades past the threshold over its baseline. After a
            # mid-solve refactor the baseline counts only post-refactor its.
            if self._fac_base_its is None:
                self._fac_base_its = it - it_refac
            elif (it >= self._fac_base_its + self._stale_its()
                  or not np.isfinite(rn)):
                self._fac_cache = None
        out = LinearResult(x=scale * z, iters=it, resnorm=rn,
                           converged=rn <= target)
        return (out, extra_vals) if extra is not None else out

    def _solve_gmres(self, vals, R, scale=None, aux=None, tol=None):
        """goma_tpu's ``_solve_gmres(vals, R, scale, aux, tol)``, the entry
        the continuation layer solves through: ``scale`` None means ones,
        ``aux`` None the ELL matvec of ``vals``. The solve takes the lagged
        factor when one is cached (built from the Newton solve's
        equilibrated values) and factors ``vals`` as given otherwise, as
        goma_tpu does; a direct rung, which keeps no preconditioner, builds
        the one ``precond`` names at its first call."""
        if scale is None:
            scale = torch.ones(self._n, dtype=R.dtype, device=R.device)
        if aux is None and self._ell is None:
            self._ell = EllOperator(self.problem.pattern, device=self.device)
        if self.precond is None:
            self.precond = self._build_precond(self._precond_kind)
        return self._linsolve_gmres(R, scale, aux, tol=tol, vals=vals)

    def _linsolve_bicgstab(self, R, scale, aux, tol=None, vals=None):
        """Solve (DAD) z = D R by right-preconditioned BiCGStab with the
        lagged preconditioner (refactored only when none is cached: the
        staleness policy is GMRES's, as in goma_tpu); dx = D z."""
        opts = self.opts
        fac = (self._fac_cache if opts.precond_lag and self._fac_cache is not None
               else self._factor_fresh(vals, scale))
        mv = self._matvec(scale, aux, vals)
        b = (scale.to(R.dtype) * R).to(vals.dtype if vals is not None
                                       else self._jdt)
        lr = bicgstab(mv, b, precond=lambda r: self._apply_precond_mv(mv, fac, r),
                      tol=opts.linear_tol if tol is None else tol,
                      maxiter=opts.linear_maxiter)
        return LinearResult(x=scale * lr.x, iters=lr.iters, resnorm=lr.resnorm,
                            converged=lr.converged)

    def _linsolve_host_direct(self, R, vals, scale):
        """The host ``direct`` step: (DAD) z = D R by SuperLU on the host,
        dx = D z; None on a ``LinearSolveError`` (the Newton loop then
        stops unconverged)."""
        s_h = scale.cpu().numpy().astype(np.float64)
        try:
            z = direct_solve_host(self.problem.pattern, vals.cpu().numpy(),
                                  s_h * R.cpu().numpy().astype(np.float64))
        except LinearSolveError:
            return None
        return torch.as_tensor(s_h * z, dtype=R.dtype, device=R.device)

    def _direct_ndlu(self, vals):
        """The tpu_direct multifrontal LU, built on first use from the first
        iteration's equilibrated values: value-based saddle detection puts
        the zero-diagonal rows last in every front."""
        from goma_tpu_torch.solvers.ndlu import (NDLU, node_clusters,
                                                 zero_diag_defer_mask)

        if self._ndlu is None:
            opts = self.opts
            self._ndlu = NDLU(
                self.problem.pattern, leaf_max=opts.ndlu_leaf_max,
                dtype=_DTYPES[opts.ndlu_dtype],
                defer_dofs=zero_diag_defer_mask(self.problem.pattern,
                                                vals.cpu().numpy()),
                clusters=node_clusters(self.problem)
                if opts.ndlu_cluster else None,
                device=self.device)
        return self._ndlu

    def _linsolve_direct(self, R, vals, scale):
        """The tpu_direct step: dx = D z with (DAD) z = D R solved by the
        lagged NDLU(invert=False) plus iterative refinement against the
        fresh operator, one refactor when a lagged factor misses the guard.
        Returns dx, or None when even a fresh factor leaves a relative
        residual above the guard (the Newton loop then stops unconverged)."""
        opts = self.opts
        nd = self._direct_ndlu(vals)
        bD = scale * R
        rel_tol = max(1e-5, opts.linear_tol)
        ell = self._ell
        n_sweeps = [0]

        def sweep(facs, b, x):
            n_sweeps[0] += 1
            r = b - ell.matvec(vals, x)
            return x + nd.solve(facs, r).to(b.dtype), torch.linalg.norm(r)

        def _try(fac):
            # refine to 0.5x the guard: where a fixed count lands varies
            # with rounding; solve_refined hands back the residual it
            # measured for the returned iterate when it has one
            n_sweeps[0] = 0
            z, rel = nd.solve_refined(fac, bD, None, refine=opts.ndlu_refine,
                                      rel_tol=0.5 * rel_tol,
                                      max_refine=opts.ndlu_max_refine,
                                      return_rel=True, sweep=sweep)
            if rel is None:
                rel = float(torch.linalg.norm(bD - ell.matvec(vals, z))
                            / (torch.linalg.norm(bD) + 1e-300))
            return z, rel, n_sweeps[0]

        fresh = not (opts.ndlu_lag and self._ndlu_fac is not None)
        if fresh:
            self._ndlu_nfactor += 1
        fac = nd.factor(vals) if fresh else self._ndlu_fac
        z, rel, sweeps = _try(fac)
        if (not np.isfinite(rel) or rel > rel_tol) and not fresh:
            # a stale factor cannot carry refinement to tolerance on this
            # Jacobian: refactor and retry once
            fac = nd.factor(vals)
            fresh = True
            self._ndlu_nfactor += 1
            z, rel, sweeps = _try(fac)
        if opts.ndlu_lag:
            self._ndlu_fac = fac
        self.direct_log.append((sweeps, rel, fresh))
        # singular/rank-deficient guard: the refined solve must leave a
        # small relative residual (the float32-factor refinement floor, or
        # the configured linear_tol when that is looser)
        if not np.isfinite(rel) or rel > rel_tol:
            return None
        return (scale * z).to(R.dtype)

    def _select_damp(self, norm_inf: float) -> float:
        """Per-iteration relaxation factor: the reference's damp_factor1-3
        ladder keyed on ||R||_inf (src/mm_sol_nonlinear.c:1998-2040)."""
        opts = self.opts
        d1 = opts.damp if opts.damp_factor1 is None else opts.damp_factor1
        d2, d3 = opts.damp_factor2, opts.damp_factor3
        in01 = lambda v: 0.0 <= v <= 1.0  # noqa: E731
        if in01(d1) and in01(d2) and in01(d3):
            if norm_inf > opts.custom_tol3:
                df = d3
            elif norm_inf > opts.custom_tol2:
                df = d2
            elif norm_inf > opts.custom_tol1:
                df = d1
            else:
                df = 1.0
        else:
            df = d1
        if df <= 1.0e-6:
            df = d1
        return df

    def _eta(self, l2: float, prev_l2: float | None) -> float:
        """Eisenstat-Walker forcing (choice 2) with the floor and endgame
        clamps of NewtonOptions."""
        opts = self.opts
        eta = opts.linear_tol
        if opts.forcing != "ew":
            return eta
        if prev_l2 is None:
            eta = max(opts.linear_tol, 1e-2)
        elif prev_l2 > 0:
            eta = min(0.1, max(opts.linear_tol, 0.5 * (l2 / prev_l2) ** 1.5))
        if opts.ew_eta_floor > 0:
            eta = max(eta, opts.ew_eta_floor)
        if l2 > 0 and opts.tol_residual > 0:
            need = 0.5 * opts.tol_residual / l2
            if opts.ew_endgame == "standard":
                eta = min(0.1, max(eta, min(need, 0.1)))
                eta = max(eta, opts.linear_tol)
            else:
                eta = max(opts.linear_tol, min(eta, max(need, opts.linear_tol)))
        return eta

    def _eta_device(self, l2, prev_l2):
        """The forcing of ``_eta`` on 0-d device tensors, in float64, so the
        pipelined loop can chain prep -> eta -> first GMRES cycle without a
        host read; ``prev_l2 < 0`` is the first-iteration sentinel. Equal to
        ``_eta(l2, prev_l2)`` for every input, ``prev_l2 == 0`` included
        (``linear_tol`` before the floor and endgame clamps; goma_tpu's
        ``_eta_device`` clamps ``prev_l2`` to 1e-300 there and returns 0.1),
        and ``l2 == 0``, where the endgame clamps do not apply."""
        o = self.opts
        lt = o.linear_tol
        l2 = l2.to(torch.float64)
        prev_l2 = prev_l2.to(torch.float64)
        eta = torch.full_like(l2, lt)
        if o.forcing != "ew":
            return eta
        one = torch.ones_like(l2)
        ratio = l2 / torch.where(prev_l2 > 0, prev_l2, one)
        ew = torch.clamp(torch.clamp(0.5 * ratio ** 1.5, min=lt), max=0.1)
        eta = torch.where(prev_l2 < 0, torch.full_like(l2, max(lt, 1e-2)),
                          torch.where(prev_l2 > 0, ew, eta))
        if o.ew_eta_floor > 0:
            eta = torch.clamp(eta, min=o.ew_eta_floor)
        if o.tol_residual > 0:
            # tensor / tensor: a Python scalar over a tensor is computed as
            # scalar * (1 / tensor), an ulp off the host's division
            need = (torch.full_like(l2, 0.5 * o.tol_residual)
                    / torch.where(l2 > 0, l2, one))
            if o.ew_endgame == "standard":
                end = torch.clamp(torch.maximum(eta, torch.clamp(need, max=0.1)),
                                  max=0.1)
                end = torch.clamp(end, min=lt)
            else:
                end = torch.clamp(torch.minimum(eta, torch.clamp(need, min=lt)),
                                  min=lt)
            eta = torch.where(l2 > 0, end, eta)
        return eta

    # ------------------------------------------------------------ solve
    def solve(self, x0, params) -> NewtonResult:
        """Newton from ``x0`` (array or tensor) with ``params`` from
        ``problem.base_params()``, routed as goma_tpu routes: ``gmres`` with
        ``tol_update == 0`` on the fast prep runs ``_solve_pipelined``,
        everything else ``_solve_sequential``."""
        opts = self.opts
        if (self._fast_prep and opts.linear_solver == "gmres"
                and opts.tol_update == 0):
            return self._solve_pipelined(x0, params)
        return self._solve_sequential(x0, params)

    def _set_state(self, x, params):
        """The current Newton state, read by a (re)factor: the CSR values
        of the fast prep and PCD's convection (x and the time-derivative
        coefficient ``ct``)."""
        self._cur_x = x
        self._cur_params = params
        self._cur_ct = params.get("ct", 0.0) if isinstance(params, dict) else 0.0

    def _state(self, x0):
        prob = self.problem
        return torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0) else x0,
                               dtype=prob.dtype, device=self.device)

    def _solve_pipelined(self, x0, params) -> NewtonResult:
        """goma_tpu's ``_solve_pipelined``, line for line: the prep, the
        device-side forcing tolerance and the first GMRES cycle are
        dispatched with no host read between them, and the prep's norms
        ride on the first cycle's one read. A quadratic-convergence
        predictor (expected ||R||_2 ~ 10 ||R_prev||_2^2) decides per
        iteration whether to SPECULATE (dispatch the solve before the norms
        are known) and, under prep32, whether to prep at full precision
        directly. Convergence and the prep32 endgame still follow the
        norms as read, so a wrong guess costs time only: a wrong
        "sequential" one extra read, a wrong "speculate" a whole solve that
        is thrown away (counted in ``n_discarded``). The prep32 endgame
        re-prep falls back to the sequential order for that one iteration.
        Same norm sequence, forcing and linear iterations as
        ``_solve_sequential``.

        Buckets: ``assembly_time`` counts the preps' host dispatch only;
        every read of the prep's norms is charged to ``solve_time``, in
        both branches, since on a speculating iteration it is the first
        GMRES cycle's own read and cannot be told apart from it."""
        opts = self.opts
        prob = self.problem
        x = self._state(x0)
        res_norms, upd_norms, lin_iters = [], [], []
        converged = False
        t_asm = t_slv = 0.0
        it = 0
        prev_l2_dev = None
        sentinel = torch.full((), -1.0, dtype=torch.float64, device=self.device)
        tol = opts.tol_residual
        prep32 = opts.prep32_tol > 0 and self._jdt != prob.dtype
        boundary = max(opts.prep32_tol, 2.0 * tol)
        for it in range(opts.max_iter):
            self._set_state(x, params)
            exp_l2 = np.inf if not res_norms else 10.0 * res_norms[-1][1] ** 2
            cur32 = prep32 and exp_l2 >= boundary
            speculate = exp_l2 >= tol and (not prep32 or exp_l2 >= boundary)
            t0 = time.perf_counter()
            if cur32:
                R, norms, scale, aux = self._prepare_fast32(x, params)
            else:
                R, norms, scale, aux = self._prepare_fast(x, params)
            t_asm += time.perf_counter() - t0
            t0 = time.perf_counter()
            prev = sentinel if prev_l2_dev is None else prev_l2_dev
            eta = self._eta_device(norms[1], prev)
            if speculate:
                lr, (l1, l2, li) = self._linsolve_gmres(R, scale, aux, tol=eta,
                                                         extra=[norms])
            else:
                lr = None
                l1, l2, li = read_scalars([norms])
            if not cur32 and prep32 and (l2 < boundary or li < tol):
                # endgame confirmed and this prep is already full precision
                prep32 = False
            if cur32 and (l2 < boundary or li < tol):
                # endgame: re-prep THIS iteration at full precision and run
                # the rest of the iteration in sequential order
                self.n_discarded += lr is not None
                t_slv += time.perf_counter() - t0
                prep32 = False
                t0 = time.perf_counter()
                R, norms, scale, aux = self._prepare_fast(x, params)
                t_asm += time.perf_counter() - t0
                t0 = time.perf_counter()
                l1, l2, li = read_scalars([norms])
                res_norms.append((l1, l2, li))
                if l2 < tol and li < tol:
                    converged = True
                    t_slv += time.perf_counter() - t0
                    break
                eta = self._eta_device(norms[1], prev)
                lr = self._linsolve_gmres(R, scale, aux, tol=eta)
            else:
                res_norms.append((l1, l2, li))
                if l2 < tol and li < tol:
                    converged = True
                    self.n_discarded += lr is not None
                    t_slv += time.perf_counter() - t0
                    break
                if lr is None:  # the predictor said stop, Newton goes on
                    lr = self._linsolve_gmres(R, scale, aux, tol=eta)
            prev_l2_dev = norms[1]
            lin_iters.append(lr.iters)
            t_slv += time.perf_counter() - t0
            x = x - self._select_damp(li) * lr.x.to(x.dtype)
            if opts.full_history:
                # kept on the device; read once after the loop
                upd_norms.append(torch.linalg.norm(lr.x))
        return NewtonResult(
            x=x.cpu().numpy(),
            converged=converged,
            iters=it,
            res_norms=res_norms,
            update_norms=torch.stack(upd_norms).tolist() if upd_norms else [],
            linear_iters=lin_iters,
            assembly_time=t_asm,
            solve_time=t_slv,
        )

    def _solve_sequential(self, x0, params) -> NewtonResult:
        """The sequential Newton loop: prep, read the norms, test
        convergence, then solve. ``assembly_time`` covers the preps and
        their norm reads; ``solve_time`` the linear solves (factorizations
        included) and updates."""
        opts = self.opts
        prob = self.problem
        x = self._state(x0)
        res_norms, upd_norms, lin_iters = [], [], []
        converged = False
        t_asm = t_slv = 0.0
        it = 0
        prev_l2 = None
        # opts.linear_solver may be switched after construction (goma_tpu's
        # tests switch a segregated driver's sub-solvers to direct): the
        # prep and the linear solve are gated on it per solve, as goma_tpu
        # gates them
        fast = self._fast_prep and opts.linear_solver in ("gmres", "bicgstab")
        host_direct = opts.linear_solver == "direct"
        direct = opts.linear_solver == "tpu_direct"
        if not fast and self._ell is None:
            self._ell = EllOperator(prob.pattern, device=self.device)
        prep32 = fast and opts.prep32_tol > 0 and self._jdt != prob.dtype
        boundary = max(opts.prep32_tol, 2.0 * opts.tol_residual)
        vals = aux = None
        for it in range(opts.max_iter):
            self._set_state(x, params)
            t0 = time.perf_counter()
            if not fast:
                R, vals, norms, scale, aux = self._prepare(x, params)
            elif prep32:
                R, norms, scale, aux = self._prepare_fast32(x, params)
            else:
                R, norms, scale, aux = self._prepare_fast(x, params)
            l1, l2, li = norms.tolist()
            if prep32 and (l2 < boundary or li < opts.tol_residual):
                # endgame: re-prep THIS iteration at full precision and stay
                # there; convergence is only declared from those norms
                prep32 = False
                R, norms, scale, aux = self._prepare_fast(x, params)
                l1, l2, li = norms.tolist()
            t_asm += time.perf_counter() - t0
            res_norms.append((l1, l2, li))
            if l2 < opts.tol_residual and li < opts.tol_residual:
                converged = True
                break
            eta = self._eta(l2, prev_l2)
            prev_l2 = l2
            t0 = time.perf_counter()
            if host_direct or direct:
                dx = (self._linsolve_host_direct(R, vals, scale)
                      if host_direct
                      else self._linsolve_direct(R, vals, scale))
                if dx is None:
                    # a failed direct solve (singular matrix, or the refined
                    # solve missed its residual guard): stop unconverged
                    t_slv += time.perf_counter() - t0
                    break
                lin_iters.append(1)
            else:
                solve = (self._linsolve_gmres if opts.linear_solver == "gmres"
                         else self._linsolve_bicgstab)
                lr = solve(R, scale, aux, tol=eta, vals=vals)
                dx = lr.x
                lin_iters.append(lr.iters)
            x = x - self._select_damp(li) * dx.to(x.dtype)
            if opts.tol_update > 0 or opts.full_history:
                # kept on the device; read once after the loop unless the
                # update-norm test needs it now
                upd_norms.append(torch.linalg.norm(dx))
            t_slv += time.perf_counter() - t0
            if opts.tol_update > 0 and float(upd_norms[-1]) < opts.tol_update:
                # correction-norm convergence (reference Epsilon[2] path)
                t0 = time.perf_counter()
                norms = (self._prepare_fast(x, params)[1] if fast
                         else self._prepare(x, params)[2])
                res_norms.append(tuple(norms.tolist()))
                t_asm += time.perf_counter() - t0
                converged = True
                it += 1
                break
        return NewtonResult(
            x=x.cpu().numpy(),
            converged=converged,
            iters=it,
            res_norms=res_norms,
            update_norms=torch.stack(upd_norms).tolist() if upd_norms else [],
            linear_iters=lin_iters,
            assembly_time=t_asm,
            solve_time=t_slv,
        )
