"""Post-processing: side-set flux/force integrals, volume integrals and the
stream function by an auxiliary solve (counterpart of
``goma_tpu/post/postproc.py``).

Parity: reference ``src/mm_flux.c`` (``evaluate_flux:114`` side-set
integrals, ``evaluate_volume_integral:4113``) and ``src/mm_post_proc.c``
(``post_process_nodal:4216``, the stream function by an auxiliary solve).

Each integral is a function ``f(x, params)`` that maps the face or element
function over a side set's faces or a block's elements with
``torch.func.vmap``, on the same ``eval_surfacevars``/``eval_fieldvars``
the assembler uses (r-weighted in axisymmetric coordinates), and returns a
0-d tensor, or a (k,) tensor for a vector integrand. goma_tpu jits it; here
it runs eagerly, with the gathers and tables put on the problem's device
once, when the function is built.

``flux_sensitivity`` is the jvp of the residual and of the flux through a
params leaf, with a host direct solve between them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from goma_tpu_torch.fem.assembly import Problem, eval_surfacevars
from goma_tpu_torch.fem.fields import eval_fieldvars
from goma_tpu_torch.physics.materials import prop


def _weighted_sum(w, g):
    """sum_q w_q g_q for an (nq,) or (nq, k) integrand."""
    return torch.sum(w * g) if g.ndim == 1 else torch.einsum("q,qk->k", w, g)


def _on(problem, a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=problem.device)


def sideset_integral(problem: Problem, sideset: str, integrand: Callable):
    """f(x, params) -> the integral of ``integrand(sfv, mat, params)``
    ((nq,) or (nq, k)) over a side set. Examples: heat flux ``-k n.grad T``,
    force ``sigma.n``, flow rate ``u.n``. Reference: evaluate_flux
    (src/mm_flux.c:114)."""
    from torch.func import vmap

    dtype, dim = problem.dtype, problem.mesh.dim
    parts = []
    for fs in problem._build_face_set(sideset, kernels=[]):
        blk = problem.mesh.blocks[fs.block_index]
        parts.append((
            problem.dofmap.blocks[fs.block_index].slots,
            problem.materials[fs.block_index],
            _on(problem, problem.dofmap.blocks[fs.block_index]
                .gather[fs.face_elems].astype(np.int64)),
            _on(problem, problem.mesh.coords[blk.conn[fs.face_elems]], dtype),
            {k: _on(problem, v, dtype) for k, v in fs.ftabs.items()},
            _on(problem, fs.fwts, dtype)))

    def f(x, params):
        x = torch.as_tensor(x, dtype=dtype, device=problem.device)
        hist = params["hist"]
        total = None
        for slots, mat, gather, Xref, ftabs, fwts in parts:
            def one_face(q_e, h_e, X_e, ftab):
                qdot_e = params["ct"] * q_e + h_e
                sfv = eval_surfacevars(q_e, qdot_e, X_e, ftab, fwts, slots,
                                       dim, dtype, problem.coord)
                return _weighted_sum(sfv.wdA, integrand(sfv, mat, params))

            s = torch.sum(vmap(one_face)(x[gather], hist[gather], Xref,
                                         ftabs), dim=0)
            total = s if total is None else total + s
        return total

    return f


def volume_integral(problem: Problem, integrand: Callable, blocks=None):
    """f(x, params) -> the integral of ``integrand(fv, mat, params)`` over
    the (current, possibly displaced) volume of ``blocks`` (all by
    default). Reference: evaluate_volume_integral (src/mm_flux.c:4113)."""
    from torch.func import vmap

    dtype = problem.dtype
    idxs = range(len(problem.mesh.blocks)) if blocks is None else blocks
    parts = []
    for bi in idxs:
        blk = problem.mesh.blocks[bi]
        parts.append((
            problem.dofmap.blocks[bi].slots, problem.materials[bi],
            problem.tables[bi],
            _on(problem, problem.dofmap.blocks[bi].gather.astype(np.int64)),
            _on(problem, problem.mesh.coords[blk.conn], dtype),
            _on(problem, blk.conn.astype(np.int64))))

    def f(x, params):
        x = torch.as_tensor(x, dtype=dtype, device=problem.device)
        hist = params["hist"]
        total = None
        for slots, mat, tables, gather, Xref, conn in parts:
            def one_elem(q_e, h_e, X_e, ext_e):
                qdot_e = params["ct"] * q_e + h_e
                fv = eval_fieldvars(q_e, qdot_e, X_e, tables, slots, dtype,
                                    ext_e, problem.external_fields,
                                    problem.coord)
                return _weighted_sum(fv.wdetJ, integrand(fv, mat, params))

            ext = problem._ext_gather(params, conn).to(dtype)
            s = torch.sum(vmap(one_elem)(x[gather], hist[gather], Xref, ext),
                          dim=0)
            total = s if total is None else total + s
        return total

    return f


def flux_sensitivity(problem, flux_fn, x, params, wrt: str):
    """Total sensitivity dF/dp of a flux/volume integral F = f(x(p), p) with
    respect to a scalar parameter ``params[wrt]`` (BC value, material
    constant, ...), as host numpy.

    Reference parity: ``evaluate_flux_sens`` (``src/mm_flux.c:5792``) — there
    via stored solution sensitivities (``soln_sens``,
    ``src/mm_sol_nonlinear.c:3119``); here via AD:

        dF/dp = (dF/dx) . w + dF/dp|_x,   J w = -dR/dp   (adjoint-free jvp)

    dR/dp is the continuation layer's ``_dR_dlam`` (``torch.func.jvp`` of
    the residual through ``params[wrt]``, its route counted there).
    ``flux_fn`` is a function f(x, params) -> scalar/vector (e.g. the output
    of :func:`sideset_integral` / :func:`volume_integral`). The linear solve
    is the host direct path (sensitivities are a post-processing step).
    """
    from torch.func import jvp

    from goma_tpu_torch.continuation.conti import _dR_dlam, _host
    from goma_tpu_torch.solvers.linear import direct_solve_host

    dtype, dev = problem.dtype, problem.device
    x = torch.as_tensor(x, dtype=dtype, device=dev)
    p0 = torch.as_tensor(params[wrt], dtype=dtype, device=dev)
    if p0.ndim != 0:
        raise ValueError(f"flux_sensitivity: params[{wrt!r}] must be scalar")

    def with_p(pv):
        pr = dict(params)
        pr[wrt] = pv
        return pr

    dRdp = _dR_dlam(problem, x, with_p, p0)
    _, vals = problem._assemble(x, params)
    w = direct_solve_host(problem.pattern, _host(vals), -_host(dRdp))
    _, dF = jvp(lambda xv, pv: flux_fn(xv, with_p(pv)), (x, p0),
                (torch.as_tensor(w, dtype=dtype, device=dev),
                 torch.ones_like(p0)))
    return _host(dF)


# ------------------------------------------------------------ derived fields
def traction_integrand(comp: int | None = None):
    """sigma.n on a face for Newtonian flow: (nq, dim), or (nq,) for one
    component. n is the domain's outward normal, so the integral is the
    force exerted ON the fluid BY the boundary; negate it for the force the
    fluid exerts on the wall (reference FORCE_X/FORCE_Y flux cards)."""

    def f(sfv, mat, params):
        mu = prop(mat, "mu", sfv, params)
        gu = sfv.grad["velocity"]
        p = sfv.val["pressure"][:, 0]
        eye = torch.eye(gu.shape[-1], dtype=gu.dtype, device=gu.device)
        sig = mu * (gu + gu.transpose(1, 2)) - p[:, None, None] * eye[None]
        t = torch.einsum("qak,qk->qa", sig, sfv.normal)
        return t if comp is None else t[:, comp]

    return f


def flow_rate(sfv, mat, params):
    """u . n over a face (volumetric flow through the side set)."""
    return torch.einsum("qk,qk->q", sfv.val["velocity"], sfv.normal)


def heat_flux(sfv, mat, params):
    """-k n . grad T over a face."""
    k = prop(mat, "k", sfv, params, 1.0)
    gT = sfv.grad["temperature"][:, 0, :]
    return -k * torch.einsum("qk,qk->q", gT, sfv.normal)


def stream_function(problem: Problem, x,
                    walls=("left", "right", "top", "bottom"), psi_ref=0.0):
    """Stream function psi of a 2D velocity solution: solve
    -lap(psi) = omega with psi = psi_ref on the given wall node sets, as an
    auxiliary Energy problem whose heat source reads the velocity as
    external fields (reference: the stream-function post variable,
    src/mm_post_proc.c). Runs on the problem's device with goma_tpu's
    Newton options; returns per-node psi (host numpy)."""
    from goma_tpu_torch.physics import Energy
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver

    assert problem.mesh.dim == 2
    ux = problem.get_nodal_field(x, "velocity", 0, fill=0.0)
    uy = problem.get_nodal_field(x, "velocity", 1, fill=0.0)

    def vorticity_source(fv, mat, params):
        # -lap psi = omega: the Energy kernel solves -div(k grad T) = H
        return fv.ext_grad["uy"][:, 0] - fv.ext_grad["ux"][:, 1]

    q2 = any(s.interp in ("Q2", "P2") for b in problem.dofmap.blocks
             for s in b.slots)
    aux = Problem(problem.mesh,
                  [Energy(interp="Q2" if q2 else "Q1", transient=False,
                          convection=False)],
                  {"k": 1.0, "heat_source": vorticity_source},
                  external_fields=("ux", "uy"), device=problem.device)
    for w in walls:
        aux.add_dirichlet(w, "temperature", 0, psi_ref)
    aux.finalize()
    params = aux.base_params(ext_ux=ux, ext_uy=uy)
    res = NewtonSolver(
        aux, NewtonOptions(max_iter=3, tol_residual=1e-10, linear_tol=1e-11,
                           linear_maxiter=2000)
    ).solve(np.zeros(aux.dofmap.n_dof), params)
    return aux.get_nodal_field(res.x, "temperature")
