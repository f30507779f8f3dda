"""Lagrangian particle tracing through the FEM velocity field
(counterpart of ``goma_tpu/post/particles.py``, host numpy, copied).

Parity: reference ``src/ac_particles.c`` (``initialize_particles:192``,
``compute_particles:1278``) — massless tracers (RK4) and inertial particles
(``INERTIAL_TRACER_IMPLICIT``, ``src/ac_particles.c:4205``: Stokes drag with
Reynolds-number correction, gravity, pressure-gradient force, drag-implicit
time stepping).

Implementation: host-side element location (centroid KD-tree candidates +
Newton inversion of the isoparametric map, ``_invert_map``, which the
overset coupling sets of ``Problem.add_overset`` also locate their points
with), field evaluation with the element basis, time stepping vectorized
over particles with numpy. A solution ``x`` may be a host array or a
tensor on any device; it is read back to the host once per call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch.elements import element_type, eval_basis, geom_interp


def _host(x) -> np.ndarray:
    """A solution vector as host numpy (one read back of a tensor)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FieldSampler:
    """Evaluate nodal fields of a solution at arbitrary physical points."""

    def __init__(self, problem, n_candidates: int = 8, blocks=None):
        """``blocks``: optional block indices to search (default: all bulk
        blocks of full dimension — lower-dimensional shell/immersed-curve
        blocks have no volume to locate points in)."""
        from scipy.spatial import cKDTree

        self.problem = problem
        mesh = problem.mesh
        if blocks is None:
            blocks = [bi for bi, b in enumerate(mesh.blocks)
                      if element_type(b.elem_type).dim == mesh.dim]
        cents = []
        self._blocks = {}
        bi_of, le_of = [], []
        for bi in blocks:
            b = mesh.blocks[bi]
            cents.append(mesh.coords[b.conn].mean(axis=1))
            self._blocks[bi] = b
            bi_of.append(np.full(b.n_elem, bi))
            le_of.append(np.arange(b.n_elem))
        self._cent = np.concatenate(cents, axis=0)
        self._tree = cKDTree(self._cent)
        self._block_of = np.concatenate(bi_of)
        self._local_of = np.concatenate(le_of)
        self.k = n_candidates

    def locate(self, pts: np.ndarray):
        """Find (block, local elem, ref coords) per point; inside flag."""
        mesh = self.problem.mesh
        npts = pts.shape[0]
        _, cand = self._tree.query(pts, k=min(self.k, self._cent.shape[0]))
        if cand.ndim == 1:
            cand = cand[:, None]
        out_b = np.full(npts, -1, dtype=int)
        out_e = np.zeros(npts, dtype=int)
        out_xi = np.zeros((npts, mesh.dim))
        for p in range(npts):
            for ge in cand[p]:
                bi = self._block_of[ge]
                le = self._local_of[ge]
                b = self._blocks[bi]
                et = element_type(b.elem_type)
                X = mesh.coords[b.conn[le]]
                xi, ok = _invert_map(et, X, pts[p])
                if ok:
                    out_b[p], out_e[p], out_xi[p] = bi, le, xi
                    break
        return out_b, out_e, out_xi

    def sample(self, x, var: str, pts: np.ndarray, comp: int | None = None):
        """Values of a solution variable at physical points (NaN outside)."""
        prob = self.problem
        v = prob.dofmap.var(var)
        ncomp = v.ncomp
        bs, es, xis = self.locate(pts)
        out = np.full((pts.shape[0], ncomp), np.nan)
        x = _host(x)
        for p in range(pts.shape[0]):
            if bs[p] < 0:
                continue
            bd = prob.dofmap.blocks[bs[p]]
            if not bd.has(var):
                continue  # located in a block without this variable -> NaN
            s = bd.slot(var)
            et = element_type(bd.elem_type)
            N, _ = eval_basis(et.family, s.interp, xis[p][None, :])
            qe = x[bd.gather[es[p], s.start : s.start + s.size]].reshape(s.ncomp, s.nbf)
            out[p] = (qe @ N[0])
        if comp is not None:
            return out[:, comp]
        return out

    def sample_grad(self, x, var: str, pts: np.ndarray):
        """Physical gradient d(var)/dx of a solution variable at points:
        (npts, ncomp, dim), NaN outside the mesh."""
        prob = self.problem
        dim = prob.mesh.dim
        v = prob.dofmap.var(var)
        bs, es, xis = self.locate(pts)
        out = np.full((pts.shape[0], v.ncomp, dim), np.nan)
        x = _host(x)
        mesh = prob.mesh
        for p in range(pts.shape[0]):
            if bs[p] < 0:
                continue
            bd = prob.dofmap.blocks[bs[p]]
            if not bd.has(var):
                continue
            s = bd.slot(var)
            et = element_type(bd.elem_type)
            blk = self._blocks.get(bs[p], mesh.blocks[bs[p]])
            X = mesh.coords[blk.conn[es[p]]]
            _, dNg = eval_basis(et.family, geom_interp(et), xis[p][None, :])
            J = dNg[0].T @ X  # (dim_ref, dim_x)
            _, dN = eval_basis(et.family, s.interp, xis[p][None, :])
            g = np.linalg.solve(J, dN[0].T).T  # (nbf, dim) physical grads
            qe = x[bd.gather[es[p], s.start : s.start + s.size]].reshape(s.ncomp, s.nbf)
            out[p] = qe @ g
        return out


def _invert_map(et, X, pt, tol=1e-10, maxit=30):
    """Newton inversion of the isoparametric map; returns (xi, inside)."""
    dim = et.dim
    gi = geom_interp(et)
    xi = np.full(dim, 0.0 if et.family in ("quad", "hex", "bar") else 1.0 / 3.0)
    for _ in range(maxit):
        N, dN = eval_basis(et.family, gi, xi[None, :])
        r = N[0] @ X - pt
        if np.linalg.norm(r) < tol:
            break
        J = dN[0].T @ X  # (dim_ref, dim_x): J[d,k]
        try:
            dxi = np.linalg.solve(J @ J.T, J @ r)
        except np.linalg.LinAlgError:
            return xi, False
        xi = xi - dxi
        if np.max(np.abs(xi)) > 3.0:
            return xi, False
    eps = 1e-8
    if et.family in ("quad", "hex", "bar"):
        inside = np.all(np.abs(xi) <= 1 + eps)
    else:
        inside = np.all(xi >= -eps) and xi.sum() <= 1 + eps
    return xi, bool(inside and np.linalg.norm(N[0] @ X - pt) < 1e-8)


@dataclass
class ParticleTrace:
    times: np.ndarray  # (nt,)
    positions: np.ndarray  # (nt, np, dim)
    alive: np.ndarray  # (np,) particles still inside at the end


def trace_particles(
    problem,
    x,
    starts: np.ndarray,
    t_end: float,
    dt: float,
    var: str = "velocity",
    save_every: int = 1,
) -> ParticleTrace:
    """RK4 tracer integration through a steady velocity solution. Particles
    leaving the domain freeze in place (alive=False)."""
    sampler = FieldSampler(problem)
    x = _host(x)
    pts = np.array(starts, dtype=float)
    alive = np.ones(pts.shape[0], dtype=bool)
    times = [0.0]
    hist = [pts.copy()]

    def vel(q):
        v = sampler.sample(x, var, q)
        bad = np.any(np.isnan(v), axis=1)
        v[bad] = 0.0
        return v, ~bad

    nt = int(round(t_end / dt))
    t = 0.0
    for it in range(nt):
        k1, ok1 = vel(pts)
        k2, ok2 = vel(pts + 0.5 * dt * k1)
        k3, ok3 = vel(pts + 0.5 * dt * k2)
        k4, ok4 = vel(pts + dt * k3)
        step = dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        ok = ok1 & ok2 & ok3 & ok4 & alive
        pts[ok] += step[ok]
        alive &= ok
        t += dt
        if (it + 1) % save_every == 0:
            times.append(t)
            hist.append(pts.copy())
    return ParticleTrace(np.asarray(times), np.stack(hist), alive)


@dataclass
class InertialTrace(ParticleTrace):
    velocities: np.ndarray  # (nt, np, dim)


def trace_inertial_particles(
    problem,
    x,
    starts: np.ndarray,
    t_end: float,
    dt: float,
    radius: float,
    rho_p: float,
    mu: float,
    rho_f: float = 0.0,
    gravity=None,
    v0: np.ndarray | None = None,
    var: str = "velocity",
    pressure_var: str = "pressure",
    save_every: int = 1,
) -> InertialTrace:
    """Inertial particle dynamics through a steady flow solution.

    Reference parity (``INERTIAL_TRACER_IMPLICIT``,
    ``src/ac_particles.c:4205,3300-3310``):

    - Stokes drag ``C = 6 pi mu a`` with the finite-Re correction
      ``1 + 3/16 Re_p`` (Re_p <= 0.1) else ``1 + 0.0565 Re_p^0.525``,
      ``Re_p = rho_f |u - v| 2a / mu`` (the reference computes Re_p with the
      particle density in one spot; we use the conventional fluid density);
    - gravity force ``m g`` (m = rho_p * 4/3 pi a^3);
    - pressure-gradient force ``-V grad P``;
    - time stepping implicit in the (linear) drag term — the reference runs
      a full Newton per particle incl. field re-evaluation; one drag-implicit
      Euler step reproduces it to O(dt) with unconditional drag stability.

    Particles leaving the domain freeze (alive=False).
    """
    sampler = FieldSampler(problem)
    x = _host(x)
    dim = problem.mesh.dim
    pts = np.array(starts, dtype=float)
    npart = pts.shape[0]
    vol = 4.0 / 3.0 * np.pi * radius**3
    m = rho_p * vol
    if gravity is None:
        gravity = np.zeros(dim)
    g = np.broadcast_to(np.asarray(gravity, dtype=float), (dim,))
    vp = np.zeros((npart, dim)) if v0 is None else np.array(v0, dtype=float)
    alive = np.ones(npart, dtype=bool)
    has_p = any(v.name == pressure_var for v in problem.dofmap.vars)

    times = [0.0]
    hist = [pts.copy()]
    vhist = [vp.copy()]
    nt = int(round(t_end / dt))
    t = 0.0
    for it in range(nt):
        uf = sampler.sample(x, var, pts)
        ok = ~np.any(np.isnan(uf), axis=1) & alive
        uf = np.where(np.isnan(uf), 0.0, uf)
        if has_p:
            gp = sampler.sample_grad(x, pressure_var, pts)[:, 0, :]
            gp = np.where(np.isnan(gp), 0.0, gp)
        else:
            gp = np.zeros_like(pts)
        rel = np.linalg.norm(uf - vp, axis=1)
        Re_p = rho_f * rel * 2.0 * radius / mu
        corr = np.where(Re_p <= 0.1, 1.0 + 3.0 / 16.0 * Re_p,
                        1.0 + 0.0565 * np.maximum(Re_p, 1e-300) ** 0.525)
        C = 6.0 * np.pi * mu * radius * corr  # (np,)
        # drag-implicit Euler:  v' = (v + dt/m (C u_f + F_ext)) / (1 + dt C/m)
        F = C[:, None] * uf - vol * gp + m * g[None, :]
        v_new = (vp + dt / m * F) / (1.0 + dt * C / m)[:, None]
        pts[ok] += dt * v_new[ok]
        vp[ok] = v_new[ok]
        alive &= ok
        t += dt
        if (it + 1) % save_every == 0:
            times.append(t)
            hist.append(pts.copy())
            vhist.append(vp.copy())
    return InertialTrace(np.asarray(times), np.stack(hist), alive,
                         np.stack(vhist))
