"""Linear solvers and preconditioners (counterpart of
``goma_tpu/solvers/linear.py``): the node-block-Jacobi and element-block
Vanka preconditioners, the pressure-mass field split, restarted GMRES,
right-preconditioned BiCGStab, one GCRO-DR cycle (``gmres_dr_cycle``, the
recycled GMRES of ``NewtonOptions.recycle_k``) and the host SuperLU direct
solve.

GMRES: right-preconditioned, vectorized classical Gram-Schmidt plus one
reorthogonalization pass (CGS2: two (m+1, n) matrix-vector products per
Arnoldi step), Givens rotations accumulated in a dense (m+1, m+1) ``Q``, and
an early exit inside the cycle once the running residual estimate
``|Q[j+1, 0] beta|`` reaches the target. ``cnt`` counts the Arnoldi steps
taken, exactly as goma_tpu's device loop counts them; the Newton loop
counts linear iterations from it.

goma_tpu runs the cycle as one device program (``lax.fori_loop`` with a
``lax.cond`` skip). Here the loop is on the host and reads the estimate
back after every step: one device sync per Arnoldi step, a later
optimization target (a CUDA graph or a batched-check variant). BiCGStab
is a host loop too, one sync per iteration for its stopping test.

The first read of a GMRES call is one sync for ``||b||``, the first
residual norm, the tolerance when it is a device tensor, and any ``extra``
tensors the caller lets ride on it (the pipelined Newton loop's residual
norms, as goma_tpu's ``_linsolve_gmres`` folds its ``extra_fetch`` into
the first cycle's fetch).

The preconditioners build their position tables on the host (numpy) and
keep them as tensors on the device they are given; ``factor`` gathers the
CSR values into dense blocks and inverts them with the batched
Gauss-Jordan ``gj_inv``, ``apply`` is a gather, one batched matvec in the
vector's dtype (``store_dtype`` factors, e.g. bfloat16, are upcast first)
and a gather-sum. goma_tpu's padded node-slot Vanka layout is not ported:
the port applies the same operator in the unpadded form.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from goma_tpu_torch import config
from goma_tpu_torch.fem.sparsity import transpose_gather as _transpose_gather
from goma_tpu_torch.fem.sparsity import CSRPattern
from goma_tpu_torch.utils.la import gj_inv, lstsq_small


def _ext(v):
    """``v`` with one zero appended (the pad slot of the gather tables)."""
    return torch.cat([v, v.new_zeros(1)])


# ---------------------------------------------------------------- precond
class BlockJacobi:
    """Node-block Jacobi preconditioner: each node's contiguous dofs form
    one dense block gathered from the CSR values through ``block_pos`` (the
    nnz pad slot reads 0) and inverted by ``gj_inv``; elemental dofs get
    1x1 blocks. Reference analog: block-diagonal Jacobi preconditioning in
    Aztec (``src/sl_util.c:380``)."""

    #: optional storage dtype of the factored inverses (torch.bfloat16);
    #: the apply upcasts to the vector's dtype. None keeps the factor dtype.
    store_dtype = None

    def __init__(self, pattern: CSRPattern, dofmap, device=None):
        self.device = config.resolve_device(device)
        mask = dofmap.node_dof_count > 0
        starts = [dofmap.node_dof_start[mask].astype(np.int64)]
        counts = [dofmap.node_dof_count[mask].astype(np.int64)]
        n_elem_dof = dofmap.n_dof - dofmap.n_node_dof
        if n_elem_dof > 0:  # elemental dofs -> 1x1 blocks
            starts.append(np.arange(dofmap.n_node_dof, dofmap.n_dof,
                                    dtype=np.int64))
            counts.append(np.ones(n_elem_dof, dtype=np.int64))
        starts = np.concatenate(starts)
        counts = np.concatenate(counts)
        kmax = int(counts.max())
        nb = starts.shape[0]
        ii = np.arange(kmax)
        valid = ii[None, :] < counts[:, None]
        dof_ids = np.where(valid, starts[:, None] + ii[None, :], -1)
        rows = np.repeat(dof_ids[:, :, None], kmax, axis=2)
        cols = np.repeat(dof_ids[:, None, :], kmax, axis=1)
        ok = (rows >= 0) & (cols >= 0)
        pos = np.full((nb, kmax, kmax), pattern.nnz, dtype=np.int64)
        p = pattern.find(rows[ok], cols[ok])
        pos[ok] = np.where(p >= 0, p, pattern.nnz)
        self.nb, self.kmax = nb, kmax
        self.n = pattern.n
        eye = np.broadcast_to(np.eye(kmax, dtype=bool), (nb, kmax, kmax))
        pad_diag = eye & ~(valid[:, :, None] & valid[:, None, :])
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                        device=self.device)
        self.tables = {
            "block_pos": put(pos),
            "dof_ids": put(np.where(valid, dof_ids, self.n)),
            "valid": put(valid),
            "pad_diag": put(pad_diag),
        }

    def factor(self, vals, tb=None):
        tb = tb or self.tables
        A = _ext(vals)[tb["block_pos"]]  # (nb, kmax, kmax)
        A = torch.where(tb["pad_diag"], 1.0, A)
        # saddle-point guard: a constraint row (pressure in continuity) has
        # a zero diagonal and may sit in a block whose partners are
        # Dirichlet identity rows; shift near-zero diagonals by 1
        eye = torch.eye(A.shape[-1], dtype=torch.bool, device=A.device)
        fix = torch.abs(torch.diagonal(A, dim1=1, dim2=2)) < 1e-10
        A = A + (fix[:, :, None] & eye[None]).to(A.dtype)
        Binv = gj_inv(A)
        Binv = torch.where(torch.isfinite(Binv), Binv, 0.0)
        if self.store_dtype is not None:
            Binv = Binv.to(self.store_dtype)
        return Binv

    def apply(self, Binv, r, tb=None):
        tb = tb or self.tables
        rb = _ext(r)[tb["dof_ids"]]  # (nb, kmax)
        yb = torch.bmm(Binv.to(r.dtype), rb.unsqueeze(2)).squeeze(2)
        yb = torch.where(tb["valid"], yb, 0.0)
        # node dofs are unique per block: the add sets each entry once
        out = r.new_zeros(self.n + 1).index_add_(0, tb["dof_ids"].reshape(-1),
                                                 yb.reshape(-1))
        return out[: self.n]


class Vanka:
    """Element-block additive Schwarz ("Vanka") smoother: coupled local
    solves over each element's full dof set (pressure included), the
    element matrices gathered from the CSR values and inverted as one
    batched ``gj_inv``; apply is gather + batched matvec + overlap weights
    1/count + a scatter-free combine (``dpos``: per dof, the positions of
    its contributions in the concatenated per-block products).

    ``extra_gathers``: additional (ne, nl) coupled-dof groups added as
    Schwarz blocks (overset multiplier rows with the dofs they constrain);
    a zero diagonal there gets a unit entry only when its row or column is
    dead. goma_tpu's padded node-slot layout (``padded=True`` where the
    Problem offers it) is not ported: ``problem`` is accepted for the
    signature and the same operator is applied unpadded."""

    store_dtype = None  # see BlockJacobi.store_dtype
    padded = False

    def __init__(self, pattern, dofmap, key_prefix: str = "vk", problem=None,
                 extra_gathers=None, device=None):
        if device is None and problem is not None:
            device = problem.device
        self.device = config.resolve_device(device)
        self.n = pattern.n
        gathers = [bd.gather for bd in dofmap.blocks] + \
            [np.asarray(g) for g in (extra_gathers or [])]
        self._n_std = len(dofmap.blocks)
        self.nb = len(gathers)
        self.pfx = key_prefix
        count = np.zeros(pattern.n + 1, dtype=np.float64)
        for g in gathers:
            np.add.at(count, g.ravel(), 1.0)
        wts = 1.0 / np.maximum(count, 1.0)
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                        device=self.device)
        tables = {}
        flat_dofs = []
        for bi, gg in enumerate(gathers):
            g = gg.astype(np.int64)  # (ne, nl)
            ne, nl = g.shape
            rows = np.repeat(g, nl, axis=1).ravel()
            cols = np.tile(g, (1, nl)).ravel()
            pos = pattern.find(rows, cols).reshape(ne, nl, nl)
            tables[f"{key_prefix}:pos{bi}"] = put(
                np.where(pos >= 0, pos, pattern.nnz))
            tables[f"{key_prefix}:g{bi}"] = put(g)
            tables[f"{key_prefix}:w{bi}"] = put(wts[g])
            flat_dofs.append(g.ravel())
        tables[f"{key_prefix}:dpos"] = put(
            _transpose_gather(np.concatenate(flat_dofs), self.n))
        self.tables = tables

    def factor(self, vals, tb=None):
        tb = tb or self.tables
        vals_ext = _ext(vals)
        invs = []
        for bi in range(self.nb):
            Ae = vals_ext[tb[f"{self.pfx}:pos{bi}"]]  # (ne, nl, nl)
            eye = torch.eye(Ae.shape[-1], dtype=vals.dtype, device=vals.device)
            diag = torch.diagonal(Ae, dim1=1, dim2=2)
            if bi < self._n_std:
                # standard element blocks: regularize every zero diagonal
                # (the gentler diag-shifted local solves keep the float32
                # two-level cycle stable)
                fix = (torch.abs(diag) < 1e-12).to(vals.dtype)[:, :, None] \
                    * eye[None]
            else:
                # constraint blocks: a unit entry only where the zero
                # diagonal's row or column is dead
                rowsum = torch.sum(torch.abs(Ae), dim=2) - torch.abs(diag)
                colsum = torch.sum(torch.abs(Ae), dim=1) - torch.abs(diag)
                fix = ((torch.abs(diag) < 1e-12)
                       & ((rowsum < 1e-12) | (colsum < 1e-12))
                       ).to(vals.dtype)[:, :, None] * eye[None]
            Aei = gj_inv(Ae + fix)
            Aei = torch.where(torch.isfinite(Aei), Aei, 0.0)
            if self.store_dtype is not None:
                Aei = Aei.to(self.store_dtype)
            invs.append(Aei)
        return tuple(invs)

    def apply(self, fac, r, tb=None):
        tb = tb or self.tables
        r_ext = _ext(r)
        parts = []
        for bi in range(self.nb):
            rb = r_ext[tb[f"{self.pfx}:g{bi}"]]  # (ne, nl)
            zb = torch.bmm(fac[bi].to(r.dtype), rb.unsqueeze(2)).squeeze(2)
            parts.append((zb * tb[f"{self.pfx}:w{bi}"].to(r.dtype)).reshape(-1))
        flat = torch.cat(parts + [r.new_zeros(1)])
        return torch.sum(flat[tb[f"{self.pfx}:dpos"]], dim=1)


@dataclass
class LinearResult:
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool
    # from the call's first read: ||b||, the tolerance as used, and the
    # values of the ``extra`` tensors (flattened, float64)
    bnorm: float = 0.0
    tol: float = 0.0
    extra: list = field(default_factory=list)


def identity_precond(r):
    return r


class FieldSplit:
    """Block lower-triangular field split for saddle-point systems:

        z_u = A_hat^-1 r_u                 (node-block-Jacobi sweeps)
        z_p = S_hat^-1 (r_p - A_pu z_u)

    with S_hat ~ -(1/mu) M_p, the row-sum-lumped pressure mass on the
    undeformed mesh (the Cahouet-Chabard pressure-mass Schur
    approximation; reference ``src/sl_petsc_pcd.c:115``). The mass is
    built on the host from the port's ``elements`` copies."""

    def __init__(self, problem, pressure_var: str = "pressure",
                 mu: float | None = None, u_sweeps: int = 2):
        from goma_tpu_torch.elements import (element_type, eval_basis,
                                             geom_interp, interp_local_nodes,
                                             volume_rule)

        pattern = problem.pattern
        dofmap = problem.dofmap
        self.device = problem.device
        self.bj = BlockJacobi(pattern, dofmap, device=self.device)
        self.n = pattern.n
        self.u_sweeps = u_sweeps
        pmask = np.zeros(pattern.n, dtype=bool)
        if any(v.name == pressure_var for v in dofmap.vars):
            d = dofmap.dof_of_node_svar[:, dofmap.svar(pressure_var)]
            pmask[d[d >= 0]] = True
        self.pmask = torch.as_tensor(pmask, device=self.device)
        Mp = np.zeros(pattern.n)
        for bd, blk in zip(dofmap.blocks, problem.mesh.blocks):
            try:
                s = bd.slot(pressure_var)
            except KeyError:
                continue
            if s.interp in ("P0", "P1E"):
                continue
            et = element_type(blk.elem_type)
            qpts, qwts = volume_rule(et.family, problem.quad_order)
            _, dNg = eval_basis(et.family, geom_interp(et), qpts)
            Np, _ = eval_basis(et.family, s.interp, qpts)
            X = problem.mesh.coords[blk.conn]
            J = np.einsum("qnd,enk->eqdk", dNg, X)
            detJ = np.abs(np.linalg.det(J))
            lumped = np.einsum("eq,q,qi->ei", detJ, qwts, Np)  # row sums
            ln = list(interp_local_nodes(et.family, s.interp))
            dofs = dofmap.dof_of_node_svar[blk.conn[:, ln],
                                           dofmap.svar(pressure_var)]
            np.add.at(Mp, dofs.ravel(), lumped.ravel())
        mu_val = mu if mu is not None else 1.0
        inv_shat = np.where(Mp > 0, mu_val / np.maximum(Mp, 1e-300), 0.0)
        self.inv_shat = torch.as_tensor(inv_shat, device=self.device)

    def factor(self, vals, matvec):
        return (self.bj.factor(vals), matvec)

    def apply(self, fac, r):
        Binv, matvec = fac
        pm = self.pmask
        r_u = torch.where(pm, 0.0, r)
        # u block: block-Jacobi-preconditioned Richardson sweeps on A_uu
        z = torch.where(pm, 0.0, self.bj.apply(Binv, r_u))
        for _ in range(self.u_sweeps - 1):
            resid = r_u - torch.where(pm, 0.0, matvec(z))
            z = z + torch.where(pm, 0.0, self.bj.apply(Binv, resid))
        # pressure block: S_hat^-1 (r_p - A_pu z_u)
        r_p = torch.where(pm, r - matvec(z), 0.0)
        z_p = self.inv_shat * r_p
        return z + torch.where(pm, z_p, 0.0)


def read_scalars(tensors) -> list:
    """One host read of the values of ``tensors`` (any shapes, flattened in
    order) as Python floats; float32 values widen to float64 exactly."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).tolist()


def gmres(matvec, b, precond=None, x0=None, tol=1e-8, atol=0.0, restart=40,
          maxiter=200, extra=()):
    """Right-preconditioned restarted GMRES. ``matvec``/``precond`` are
    callables on vectors of b's dtype and device; ``tol`` a float or a 0-d
    tensor; ``extra`` tensors read back with ``||b||`` in the first sync
    (``LinearResult.extra``). Returns LinearResult."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    if precond is None:
        precond = identity_precond
    if x0 is None:
        x0 = torch.zeros_like(b)
    m = restart

    r = b - matvec(x0)
    beta_t = torch.linalg.norm(r)
    tol_dev = torch.is_tensor(tol)
    got = read_scalars([torch.linalg.norm(b), beta_t]
                       + ([tol] if tol_dev else []) + list(extra))
    bnorm, rn = got[0], got[1]
    if tol_dev:
        tol = got[2]
    extra_vals = got[3 if tol_dev else 2:]
    target = max(tol * bnorm, atol)

    def arnoldi_cycle(x, r, beta_t, beta):
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        V[0] = r / (beta_t if beta > 0 else 1.0)
        Q = torch.eye(m + 1, dtype=dtype, device=dev)
        done = beta <= target
        cnt = 0
        for j in range(m):
            if done:
                break
            w = matvec(precond(V[j]))
            # CGS2 against the first j+1 basis vectors
            Vj = V[:j + 1]
            h = Vj @ w
            w = w - Vj.T @ h
            h2 = Vj @ w
            w = w - Vj.T @ h2
            h = h + h2
            wn = torch.linalg.norm(w)
            H[:j + 1, j] = h
            H[j + 1, j] = wn
            V[j + 1] = w / torch.where(wn > 1e-30, wn, torch.ones_like(wn))
            hr = Q @ H[:, j]
            a0, a1 = hr[j], hr[j + 1]
            rr = torch.sqrt(a0 * a0 + a1 * a1)
            ok = rr > 1e-30
            rr_safe = torch.where(ok, rr, torch.ones_like(rr))
            c_ = torch.where(ok, a0 / rr_safe, torch.ones_like(rr))
            s_ = torch.where(ok, a1 / rr_safe, torch.zeros_like(rr))
            qj, qj1 = Q[j].clone(), Q[j + 1].clone()
            Q[j] = c_ * qj + s_ * qj1
            Q[j + 1] = -s_ * qj + c_ * qj1
            cnt += 1
            done = float(torch.abs(Q[j + 1, 0] * beta_t)) <= target
        # least squares min || beta e1 - H y || (unexecuted columns are zero;
        # the regularized solve returns y = 0 there)
        e1 = torch.zeros(m + 1, dtype=dtype, device=dev)
        e1[0] = beta_t
        y = lstsq_small(H, e1)
        return x + precond(V[:m].T @ y), cnt

    x = x0
    it = 0
    while rn > target and it < maxiter:
        x, cnt = arnoldi_cycle(x, r, beta_t, rn)
        r = b - matvec(x)
        beta_t = torch.linalg.norm(r)
        rn = float(beta_t)
        it += cnt
        if cnt == 0:  # the cycle found the target met: nothing can improve
            break
    return LinearResult(x=x, iters=it, resnorm=rn, converged=rn <= target,
                        bnorm=bnorm, tol=tol, extra=extra_vals)


def gmres_dr_cycle(matvec, precond, b, x0, U, C, restart, tol, extra=()):
    """One GCRO-DR (recycled, deflated GMRES) cycle, goma_tpu's
    ``gmres_dr_cycle``: minimize the residual over range(M U) +
    K_m((I - C C^T) A M, r0), with C = A M U orthonormal (Parks, de Sturler
    et al., SIAM J. Sci. Comput. 28, 2006).

    ``U``, ``C`` are (k, n) row-major; k = 0 arrays (shape (0, n)) give a
    plain deflation-free cycle. The Arnoldi steps are ``gmres``'s (CGS2,
    Givens rotations in a dense ``Q``), each step's new vector first
    projected off C, whose coefficients fill B; the cycle stops at the first
    step whose residual estimate reaches ``tol * ||b||``, read back after
    every step. The first read also takes ``||b||``, ``tol`` when it is a
    device tensor and the ``extra`` tensors. Returns (LinearResult, V, H,
    B): the result's ``x`` is x0 + M (V_m y + U (C^T r0 - B y)), ``iters``
    the steps taken (``cnt``), ``resnorm`` the true ||b - A x||; V
    (m+1, n), H (m+1, m) and B (k, m) feed the harvest between solves."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    m = restart
    k = U.shape[0]

    r = b - matvec(x0)
    c0 = C @ r if k else None
    rp = r - C.T @ c0 if k else r
    beta_t = torch.linalg.norm(rp)
    tol_dev = torch.is_tensor(tol)
    got = read_scalars([torch.linalg.norm(b), beta_t]
                       + ([tol] if tol_dev else []) + list(extra))
    bnorm, beta = got[0], got[1]
    if tol_dev:
        tol = got[2]
    extra_vals = got[3 if tol_dev else 2:]
    target = tol * bnorm

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    B = torch.zeros((k, m), dtype=dtype, device=dev)
    V[0] = rp / (beta_t if beta > 0 else 1.0)
    Q = torch.eye(m + 1, dtype=dtype, device=dev)
    done = beta <= target
    cnt = 0
    for j in range(m):
        if done:
            break
        w = matvec(precond(V[j]))
        if k:
            bj = C @ w
            w = w - C.T @ bj
            B[:, j] = bj
        Vj = V[:j + 1]
        h = Vj @ w
        w = w - Vj.T @ h
        h2 = Vj @ w
        w = w - Vj.T @ h2
        h = h + h2
        wn = torch.linalg.norm(w)
        H[:j + 1, j] = h
        H[j + 1, j] = wn
        V[j + 1] = w / torch.where(wn > 1e-30, wn, torch.ones_like(wn))
        hr = Q @ H[:, j]
        a0, a1 = hr[j], hr[j + 1]
        rr = torch.sqrt(a0 * a0 + a1 * a1)
        ok = rr > 1e-30
        rr_safe = torch.where(ok, rr, torch.ones_like(rr))
        c_ = torch.where(ok, a0 / rr_safe, torch.ones_like(rr))
        s_ = torch.where(ok, a1 / rr_safe, torch.zeros_like(rr))
        qj, qj1 = Q[j].clone(), Q[j + 1].clone()
        Q[j] = c_ * qj + s_ * qj1
        Q[j + 1] = -s_ * qj + c_ * qj1
        cnt += 1
        done = float(torch.abs(Q[j + 1, 0] * beta_t)) <= target
    e1 = torch.zeros(m + 1, dtype=dtype, device=dev)
    e1[0] = beta_t
    y = lstsq_small(H, e1)
    z = V[:m].T @ y
    if k:
        z = z + U.T @ (c0 - B @ y)
    x_new = x0 + precond(z)
    rn = float(torch.linalg.norm(b - matvec(x_new)))
    return (LinearResult(x=x_new, iters=cnt, resnorm=rn, converged=rn <= target,
                         bnorm=bnorm, tol=tol, extra=extra_vals), V, H, B)


def bicgstab(matvec, b, precond=None, x0=None, tol=1e-8, atol=0.0,
             maxiter=500):
    """Right-preconditioned BiCGStab (reference: the AZ_bicgstab option),
    goma_tpu's recurrence and zero-divisor guards (a zero divisor becomes
    1e-300, which is 0 in float32, as in goma_tpu). A host loop: the
    stopping test ``||r|| > max(tol ||b||, atol)`` is taken on the device
    in b's dtype and read once per iteration."""
    if precond is None:
        precond = identity_precond
    if x0 is None:
        x0 = torch.zeros_like(b)
    target = torch.clamp(tol * torch.linalg.norm(b), min=atol)

    def guard(d):
        return torch.where(d != 0, d, 1e-300)

    x = x0
    r = b - matvec(x0)
    rhat = r
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    it = 0
    while it < maxiter and bool(torch.linalg.norm(r) > target):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_new / guard(torch.dot(rhat, v))
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        omega = torch.dot(t, s) / guard(torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        it += 1
    rn = float(torch.linalg.norm(r))
    return LinearResult(x=x, iters=it, resnorm=rn,
                        converged=rn <= float(target))


# ------------------------------------------------------- host direct solve
class LinearSolveError(RuntimeError):
    """A direct solve met a singular or numerically rank-deficient matrix
    (or returned a non-finite solution). The reference treats a failed
    linear solve as a hard Newton failure (``src/mm_sol_nonlinear.c``
    err < 0; the transient ladder then halves dt)."""


def direct_solve_host(pattern: CSRPattern, vals, R):
    """Serial sparse LU on the host (scipy SuperLU), the analog of the
    reference's UMFPACK escape hatch (``src/sl_umf.c``). ``vals``/``R``:
    numpy arrays (or CPU tensors). Raises :class:`LinearSolveError` on a
    singular matrix, a non-finite solution, or a relative residual above
    1e-6 (SuperLU can factor a numerically singular matrix silently)."""
    import warnings

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = sp.csr_matrix(
        (np.asarray(vals), np.asarray(pattern.indices),
         np.asarray(pattern.indptr)), shape=(pattern.n, pattern.n))
    b = np.asarray(R)
    with warnings.catch_warnings():
        warnings.simplefilter("error", spla.MatrixRankWarning)
        try:
            x = spla.spsolve(A, b)
        except spla.MatrixRankWarning as e:
            raise LinearSolveError(f"direct solve: singular matrix ({e})") from e
    if not np.all(np.isfinite(x)):
        raise LinearSolveError("direct solve returned non-finite solution")
    bn = np.linalg.norm(b)
    if bn > 0.0:
        rel = np.linalg.norm(A @ x - b) / bn
        if rel > 1e-6:
            raise LinearSolveError(
                f"direct solve: residual {rel:.2e} of ||b|| — singular or "
                "numerically rank-deficient matrix")
    return x
