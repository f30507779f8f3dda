"""Segregated projection (pressure-correction) transient driver
(counterpart of ``goma_tpu/solvers/projection.py``).

Parity: the projection-method path of the reference's segregated driver
(``src/rf_solve_segregated.c solve_problem_segregated:185`` with the
``mm_fill_split.c`` u*/p* kernels; design notes docs/segregated_notes.org).

Each step: (1) solve the intermediate-velocity Problem (lagged advection and
pressure -> linear, one Newton iteration), (2) solve the pressure-increment
Poisson, (3) correct u = u* - (dt/rho) grad(dp) by lumped-L2 nodal
projection and re-impose the velocity boundary values, p += dp. Both
Problems live on ``device``; the nodal fields between the solves are host
numpy, as in goma_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch.fem import Problem
from goma_tpu_torch.physics.projection_ns import (PPHI, USTAR,
                                                  PressureIncrement, UStar)
from goma_tpu_torch.post.derived import project_to_nodes
from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonSolver


@dataclass
class ProjectionResult:
    t: float
    u: np.ndarray  # (n_nodes, 2)
    p: np.ndarray  # (n_nodes,)


class ProjectionSolver:
    """``bc_velocity(prob)`` registers Dirichlet BCs on the ``ustar``
    variable; ``bc_pressure(prob)`` on ``pphi`` (pin at least one dof unless
    an open boundary sets it). ``device``: the two Problems' device (the
    card unless asked for the CPU)."""

    def __init__(self, mesh, mat, bc_velocity, bc_pressure,
                 interp=("Q2", "Q1"), newton_options=None, quad_order: int = 3,
                 device=None):
        self.mesh = mesh
        self.mat = dict(mat)
        self.prob_u = Problem(mesh, [UStar(dim=2, interp=interp[0])], self.mat,
                              external_fields=("u_old", "v_old", "p_old"),
                              quad_order=quad_order, device=device)
        bc_velocity(self.prob_u)
        self.prob_u.finalize()
        self.prob_p = Problem(mesh, [PressureIncrement(interp=interp[1])],
                              self.mat, external_fields=("us", "vs"),
                              quad_order=quad_order, device=device)
        bc_pressure(self.prob_p)
        self.prob_p.finalize()
        self.opts = newton_options or NewtonOptions(
            max_iter=3, tol_residual=1e-10, linear_solver="direct")
        self.solver_u = NewtonSolver(self.prob_u, self.opts)
        self.solver_p = NewtonSolver(self.prob_p, self.opts)

    def step(self, u, p, dt: float):
        """One projection step from nodal fields u (n_nodes, 2), p (n_nodes,).
        Returns (u_new, p_new)."""
        pu, pp = self.prob_u, self.prob_p
        dtj = torch.tensor(dt, dtype=pu.dtype, device=pu.device)
        rho = self.mat.get("rho", 1.0)

        params_u = pu.base_params(dt=dtj, ext_u_old=u[:, 0],
                                  ext_v_old=u[:, 1], ext_p_old=p)
        x0 = pu.set_nodal_field(np.zeros(pu.dofmap.n_dof), USTAR, 0, u[:, 0])
        x0 = pu.set_nodal_field(x0, USTAR, 1, u[:, 1])
        res_u = self.solver_u.solve(x0, params_u)
        if not res_u.converged:
            raise RuntimeError("projection: u* solve failed")
        us = pu.get_nodal_field(res_u.x, USTAR, 0)
        vs = pu.get_nodal_field(res_u.x, USTAR, 1)

        params_p = pp.base_params(dt=dtj, ext_us=np.nan_to_num(us),
                                  ext_vs=np.nan_to_num(vs))
        res_p = self.solver_p.solve(np.zeros(pp.dofmap.n_dof), params_p)
        if not res_p.converged:
            raise RuntimeError("projection: pressure-increment solve failed")

        gdp = project_to_nodes(
            pp, res_p.x, lambda fv, mat, prm: fv.grad[PPHI][:, 0, :],
            params=params_p)
        # all-node increment (Q1 pressure leaves higher-order nodes empty;
        # the external-field interpolation needs every geometric node)
        dp = project_to_nodes(
            pp, res_p.x, lambda fv, mat, prm: fv.val[PPHI][:, 0],
            params=params_p, ncomp=1)
        u_new = np.stack([np.nan_to_num(us), np.nan_to_num(vs)], axis=1) \
            - dt / rho * gdp
        # re-impose the velocity boundary values (reference: BCs applied to
        # the end-of-step velocity, assemble_momentum_segregated)
        xb = pu.set_nodal_field(res_u.x, USTAR, 0, u_new[:, 0])
        xb = pu.set_nodal_field(xb, USTAR, 1, u_new[:, 1])
        xb[pu.dirichlet_dofs] = pu.dirichlet_vals
        u_new = np.stack([pu.get_nodal_field(xb, USTAR, 0),
                          pu.get_nodal_field(xb, USTAR, 1)], axis=1)
        p_new = p + dp
        return u_new, p_new

    def run(self, u0, p0, dt: float, n_steps: int):
        u, p = np.array(u0, dtype=float), np.array(p0, dtype=float)
        t = 0.0
        for _ in range(n_steps):
            u, p = self.step(u, p, dt)
            t += dt
        return ProjectionResult(t=t, u=u, p=p)
