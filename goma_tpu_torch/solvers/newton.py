"""Damped full-Newton nonlinear solver (counterpart of
``goma_tpu/solvers/newton.py``), cut to two linear-solver paths.

``linear_solver="gmres"`` (with ``precond="ndlu"``): per iteration, assemble
R, element Jacobians and element row sums (``Problem._assemble_fast``), take
the row-sum-scaled norms, test convergence, solve the symmetrically
equilibrated system (DAD) z = D R with GMRES (operator: the element matvec;
preconditioner: a lagged, selectively inverted NDLU of the equilibrated CSR
values, built only when a (re)factor needs them), and update
x <- x - lambda D z. Eisenstat-Walker forcing sets each linear tolerance;
``prep32_tol`` runs the far-from-solution preps entirely at the Jacobian
dtype.

``linear_solver="tpu_direct"``: per iteration, assemble R and the CSR
values (``Problem._assemble_with_elem``), equilibrate them with the ELL row
sums, and solve (DAD) z = D R with a lagged NDLU(invert=False): exact
substitution through the ``batched_trsv`` kernel plus iterative refinement
against the fresh operator, refactoring once when the lagged factor misses
the residual guard.

goma_tpu routes this configuration to ``_solve_pipelined``, which hides
remote-TPU round trips and yields the same norm sequence; the port runs
the sequential loop, and the pipelined one is a later slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch.fem.sparsity import EllOperator, row_sums_ell
from goma_tpu_torch.solvers.linear import LinearResult, gmres

_LATER = "later slice of the port, see ROADMAP"


@dataclass
class NewtonOptions:
    """goma_tpu's options, every field and default kept so decks carry
    over. Values outside the ported slice raise at construction (see
    :func:`check_slice`); the fields that only steer unported paths (the
    other preconditioners and Krylov methods) are accepted and unused."""

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
    linear_solver: str = "gmres"  # gmres | tpu_direct (bicgstab | direct: later)
    ndlu_leaf_max: int = 96
    ndlu_refine: int = 1
    # atomic mesh-node clustering of the ND bisection: every saddle
    # (pressure) dof shares a front with its node's momentum rows
    ndlu_cluster: bool = True
    ndlu_dtype: str = "float32"  # factorization precision
    ndlu_lag: bool = True
    ndlu_max_refine: int = 8
    # gmres needs "ndlu" (auto | block_jacobi | ...: later); tpu_direct
    # reads no preconditioner and accepts any value
    precond: str = "auto"
    fieldsplit_mu: float | None = None
    fieldsplit_rho: float | None = None
    fieldsplit_sweeps: int = 2
    smooth_damp: float | None = None
    smooth_sweeps: int = 2
    smooth_post_sweeps: int | None = None
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
    precond_dtype: str = "f32"
    # lagged preconditioner: reuse the factor across Newton iterations
    # until the Krylov count grows past the staleness threshold over its
    # post-factor baseline; the Krylov OPERATOR is always fresh
    precond_lag: bool = True
    # staleness threshold; None -> 45 for "ndlu". Also fires MID-SOLVE:
    # the solve refactors and continues from its current iterate
    precond_stale_its: int | None = None
    recycle_k: int = 0
    # switched-precision prep: while the row-scaled ||R||_2 stays ABOVE
    # this threshold the whole prep runs at the Jacobian dtype; the endgame
    # re-preps at full precision. 0 disables.
    prep32_tol: float = 0.0

    def __post_init__(self):
        check_slice(self)


def check_slice(opts: NewtonOptions) -> None:
    """Raise NotImplementedError for options outside the ported slice."""
    if opts.linear_solver not in ("gmres", "tpu_direct"):
        raise NotImplementedError(
            f"linear_solver={opts.linear_solver!r}: {_LATER}")
    if opts.linear_solver == "gmres" and opts.precond != "ndlu":
        raise NotImplementedError(f"precond={opts.precond!r}: {_LATER}")
    if opts.recycle_k > 0:
        raise NotImplementedError(f"recycle_k > 0 (GCRO-DR): {_LATER}")
    if opts.precond_dtype != "f32":
        raise NotImplementedError(
            f"precond_dtype={opts.precond_dtype!r}: {_LATER}")
    if not opts.row_scaling:
        raise NotImplementedError(f"row_scaling=False (unscaled prep): {_LATER}")


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
        self.opts = options or NewtonOptions(precond="ndlu")
        check_slice(self.opts)
        self.device = problem.device
        from goma_tpu_torch.solvers.ndlu import NDLU, node_clusters
        from goma_tpu_torch.solvers.twolevel import _saddle_mask

        self._direct = self.opts.linear_solver == "tpu_direct"
        pat = problem.pattern
        if self._direct:
            # tpu_direct reads no preconditioner, so none is built (goma_tpu
            # builds the TwoLevel or BlockJacobi that precond="auto" names
            # and never applies it). The refinement operator is the CSR (ELL)
            # matvec of the assembled values, and the multifrontal LU is
            # built lazily from the first iteration's values (_linsolve_direct)
            self.precond = None
            self._ell = EllOperator(pat, device=self.device)
        else:
            # near-exact preconditioner: the multifrontal LU, selectively
            # inverted (applies are batched matvecs; GMRES wraps the apply)
            self.precond = NDLU(pat,
                                leaf_max=self.opts.ndlu_leaf_max,
                                dtype=_DTYPES[self.opts.ndlu_dtype],
                                defer_dofs=_saddle_mask(problem),
                                invert=True,
                                clusters=node_clusters(problem)
                                if self.opts.ndlu_cluster else None,
                                device=self.device)
        self._rows = torch.as_tensor(pat.rows.astype(np.int64), device=self.device)
        self._cols = torch.as_tensor(pat.indices.astype(np.int64), device=self.device)
        self._n = problem.dofmap.n_dof
        self._jdt = problem.jacobian_dtype or problem.dtype
        self._cur_x = None
        self._cur_params = None
        self._fac_cache = None
        self._fac_base_its = None
        #: fresh preconditioner factorizations so far (each one runs the
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

    def reset_lagged(self):
        """Drop the lagged factors (preconditioner and tpu_direct NDLU)."""
        self._fac_cache = None
        self._fac_base_its = None
        self._ndlu_fac = None

    # ------------------------------------------------------------ prep
    @staticmethod
    def _norms(R, rs):
        """Row-sum-scaled residual norms (L1, L2, Linf) in f32, max-scaled
        so the sum of squares cannot overflow, plus the symmetric
        equilibration scale 1/sqrt(rs)."""
        rs = torch.where(rs > 0, rs, torch.ones_like(rs))
        Rn32 = (R / rs).to(torch.float32)
        mx = torch.max(torch.abs(Rn32))
        sc = torch.where(mx > 0, mx, torch.ones_like(mx))
        norms = torch.stack([torch.sum(torch.abs(Rn32 / sc)) * sc,
                             torch.linalg.norm(Rn32 / sc) * sc, mx])
        return norms, 1.0 / torch.sqrt(rs)

    def _prepare_fast(self, x, params):
        """Vals-free prep: (R, norms, scale, aux). Row sums come from the
        element Jacobians (Problem._assemble_fast)."""
        R, rs, aux = self.problem._assemble_fast(x, params)
        norms, scale = self._norms(R, rs)
        return R, norms, scale, aux

    def _prepare_fast32(self, x, params):
        """Switched-precision prep (opts.prep32_tol): the whole pass,
        residual included, at the Jacobian dtype."""
        R, rs, aux = self.problem._assemble_fast(x, params, rdt=self._jdt)
        norms, scale = self._norms(R, rs)
        return R, norms, scale, aux

    def _prepare_direct(self, x, params):
        """Assembled-vals prep of the direct path: (R, vals, norms, scale)
        with the CSR values at the Jacobian dtype, row sums from the ELL
        gather, and the values symmetrically equilibrated."""
        R, vals, _ = self.problem._assemble_with_elem(x, params)
        rs = row_sums_ell(vals, self._ell.tables["pos"])
        norms, scale = self._norms(R, rs)
        return R, self._equilibrate(vals, scale), norms, scale

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
        self.n_factor += 1
        return (self.precond.factor(vals),)

    def _apply_precond_mv(self, fac_num, r):
        return self.precond.solve(fac_num[0], r).to(r.dtype)

    def _gmres_cycle(self, scale, aux, fac_num, x, b, tol):
        """One restarted-GMRES call of ``gmres_restart`` steps (the restart
        loop lives in _linsolve_gmres)."""
        prob = self.problem
        mv = lambda v: prob.element_matvec(None, aux, scale, scale * v)  # noqa: E731
        M = lambda r: self._apply_precond_mv(fac_num, r)  # noqa: E731
        lr = gmres(mv, b, precond=M, tol=tol, restart=self.opts.gmres_restart,
                   maxiter=self.opts.gmres_restart, x0=x)
        return lr.x, lr.resnorm, lr.iters

    def _stale_its(self) -> int:
        """Krylov-iteration growth over the post-factor baseline that marks
        a lagged preconditioner factor stale (opts.precond_stale_its)."""
        if self.opts.precond_stale_its is not None:
            return int(self.opts.precond_stale_its)
        return 45

    def _linsolve_gmres(self, R, scale, aux, tol=None):
        opts = self.opts
        lagged = opts.precond_lag and self._fac_cache is not None
        if lagged:
            fac = self._fac_cache
        else:
            fac = self._factor_num(self._scaled_vals(self._cur_x,
                                                     self._cur_params, scale))
            self._fac_cache = fac
            self._fac_base_its = None
        # symmetric equilibration: solve (DAD) z = D R, then dx = D z
        b = (scale.to(R.dtype) * R).to(self._jdt)
        z = torch.zeros_like(b)
        if tol is None:
            tol = opts.linear_tol
        bnorm = float(torch.linalg.norm(b))
        if bnorm == 0.0:
            # zero right-hand side: z = 0 is the exact solution
            return LinearResult(x=scale * z, iters=0, resnorm=0.0,
                                converged=True)
        target = max(tol * bnorm, 1e-300)
        it = 0
        rn = np.inf
        stale = self._stale_its()
        base = self._fac_base_its if lagged else None
        it_refac = 0
        while rn > target and it < opts.linear_maxiter:
            if lagged and it >= (base or 0) + stale:
                # the lagged factor can't carry THIS solve's tolerance:
                # refactor mid-solve and continue from the current iterate
                fac = self._factor_num(self._scaled_vals(
                    self._cur_x, self._cur_params, scale))
                self._fac_cache = fac
                self._fac_base_its = None
                lagged = False
                it_refac = it
            prev = rn
            z, rn, cnt = self._gmres_cycle(scale, aux, fac, z, b, tol)
            it += max(cnt, 1)
            if not np.isfinite(rn):
                break
            if rn >= 0.999 * prev:
                break  # stagnation
        if opts.precond_lag:
            # staleness policy: drop the cached factor once the iteration
            # count degrades past the threshold over its baseline. After a
            # mid-solve refactor the baseline counts only post-refactor its.
            if self._fac_base_its is None:
                self._fac_base_its = it - it_refac
            elif (it >= self._fac_base_its + self._stale_its()
                  or not np.isfinite(rn)):
                self._fac_cache = None
        return LinearResult(x=scale * z, iters=it, resnorm=rn,
                            converged=rn <= target)

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

    # ------------------------------------------------------------ solve
    def solve(self, x0, params) -> NewtonResult:
        """Newton from ``x0`` (array or tensor) with ``params`` from
        ``problem.base_params()``. ``assembly_time`` covers the preps and
        their norm reads; ``solve_time`` the linear solves (factorizations
        included) and updates."""
        opts = self.opts
        prob = self.problem
        x = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0) else x0,
                            dtype=prob.dtype, device=self.device)
        res_norms, upd_norms, lin_iters = [], [], []
        converged = False
        t_asm = t_slv = 0.0
        it = 0
        prev_l2 = None
        direct = self._direct
        prep32 = (not direct and opts.prep32_tol > 0
                  and self._jdt != prob.dtype)
        boundary = max(opts.prep32_tol, 2.0 * opts.tol_residual)
        for it in range(opts.max_iter):
            self._cur_x = x
            self._cur_params = params
            t0 = time.perf_counter()
            if direct:
                R, vals, norms, scale = self._prepare_direct(x, params)
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
            if direct:
                dx = self._linsolve_direct(R, vals, scale)
                if dx is None:
                    # the refined solve missed its residual guard: stop
                    # unconverged (direct-path semantics)
                    t_slv += time.perf_counter() - t0
                    break
                lin_iters.append(1)
            else:
                lr = self._linsolve_gmres(R, scale, aux, tol=eta)
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
                if direct:
                    norms = self._prepare_direct(x, params)[2]
                else:
                    norms = self._prepare_fast(x, params)[1]
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
