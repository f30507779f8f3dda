"""Derived nodal post-processing fields (counterpart of
``goma_tpu/post/derived.py``).

Parity: reference ``src/mm_post_proc.c`` (``post_process_nodal:4216``) — the
"Post Processing Specifications" catalog of derived fields projected onto
nodes with a global L2 projection. Here the projection is lumped (row-sum
mass) and evaluated through the same quadrature tables the assembly uses;
each catalog entry is a small function of FieldVars, so user decks extend
the catalog by passing their own callable.

Catalog names follow the reference's cards (docs/problem_description_file/
post_processing_specifications): STREAM, VORTICITY/CURL_V,
SHEAR_RATE/MEAN_SHEAR, DIV_VELOCITY, PRESSURE_NODAL, STRESS_TENSOR,
VON_MISES_STRESS, ENERGY_FLUX/CONDUCTION_VECTORS, ELECTRIC_FIELD(_MAG),
DARCY_VELOCITY, SPEED, KINETIC_ENERGY, DENSITY, VISCOSITY,
DIFFUSION_VECTORS, STRAIN_TENSOR, FIRST/SEC_INVAR_STRAIN,
POROUS_SATURATION, CAPILLARY_PRESSURE, REL_LIQ_PERM, and the residual maps
NS_RESIDUALS / MM_RESIDUALS (``residual_nodal_field``).

goma_tpu evaluates each block under ``vmap`` and sums the element
contributions on the host (``np.add.at``); the port evaluates and sums on
the problem's device (``index_add_``) and reads the nodal result back once
per call.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from goma_tpu_torch.fem.fields import eval_fieldvars
from goma_tpu_torch.physics.fluid import _as_nq
from goma_tpu_torch.physics.materials import prop, shear_rate


def _on_device(problem, x):
    """``x`` (host array or tensor) as a tensor at the problem's dtype on
    its device."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=problem.dtype, device=problem.device)


def project_to_nodes(problem, x, qp_fn: Callable, params=None,
                     ncomp: int | None = None) -> np.ndarray:
    """Lumped L2 projection of ``qp_fn(fv, mat, params) -> (nq,) | (nq, k)``
    onto the geometric nodes. Returns (n_nodes,) or (n_nodes, k), host
    numpy."""
    from torch.func import vmap

    if params is None:
        params = problem.base_params()
    mesh = problem.mesh
    dofmap = problem.dofmap
    dtype, dev = problem.dtype, problem.device
    x = _on_device(problem, x)
    hist = params["hist"]
    num = None
    den = torch.zeros(mesh.n_nodes, dtype=dtype, device=dev)
    for bi, (bd, blk) in enumerate(zip(dofmap.blocks, mesh.blocks)):
        tables = problem.tables[bi]
        mat = problem.materials[bi]
        gather = torch.as_tensor(bd.gather.astype(np.int64), device=dev)
        Xref = torch.as_tensor(mesh.coords[blk.conn], dtype=dtype, device=dev)
        conn = torch.as_tensor(blk.conn.astype(np.int64), device=dev)
        ext = problem._ext_gather(params, conn)
        Ng = tables.on(dtype, dev)["Ng"]

        def one_elem(q_e, h_e, X_e, ext_e):
            qdot_e = params["ct"] * q_e + h_e
            fv = eval_fieldvars(q_e, qdot_e, X_e, tables, bd.slots, dtype,
                                ext_e, problem.external_fields)
            g = qp_fn(fv, mat, params)
            if not torch.is_tensor(g):
                g = torch.as_tensor(g, dtype=dtype, device=dev)
            if g.ndim == 1:
                g = g[:, None]
            return (torch.einsum("q,qi,qk->ik", fv.wdetJ, Ng, g),
                    torch.einsum("q,qi->i", fv.wdetJ, Ng))

        nums, dens = vmap(one_elem)(x[gather], hist[gather], Xref, ext)
        k = nums.shape[-1]
        if num is None:
            num = torch.zeros((mesh.n_nodes, k), dtype=nums.dtype, device=dev)
        flat = conn.reshape(-1)
        num.index_add_(0, flat, nums.reshape(-1, k))
        den.index_add_(0, flat, dens.reshape(-1))
    out = num / torch.clamp(den, min=1e-300)[:, None]
    out = out.cpu().numpy()
    if ncomp == 1 or out.shape[1] == 1:
        return out[:, 0]
    return out


# ------------------------------------------------------------- the catalog
def _trace(a):
    """Trace over the last two axes (``jnp.trace(a, axis1=1, axis2=2)``)."""
    return torch.diagonal(a, dim1=1, dim2=2).sum(-1)


def _upper(t, d):
    """The upper-triangle components (i <= j) of (nq, d, d), stacked."""
    return torch.stack([t[:, i, j] for i in range(d) for j in range(i, d)],
                       dim=1)


def _vorticity(fv, mat, params):
    gu = fv.grad["velocity"]
    if fv.dim == 2:
        return gu[:, 1, 0] - gu[:, 0, 1]
    return torch.stack(
        [gu[:, 2, 1] - gu[:, 1, 2], gu[:, 0, 2] - gu[:, 2, 0],
         gu[:, 1, 0] - gu[:, 0, 1]], dim=1)


def _shear_rate(fv, mat, params):
    return shear_rate(fv)


def _div_velocity(fv, mat, params):
    return _trace(fv.grad["velocity"])


def _pressure(fv, mat, params):
    return fv.val["pressure"][:, 0]


def _viscous_stress(fv, mat, params):
    gu = fv.grad["velocity"]
    nq = fv.x.shape[0]
    mu = _as_nq(prop(mat, "mu", fv, params, 1.0), nq, gu)
    tau = mu[:, None, None] * (gu + gu.transpose(1, 2))
    return _upper(tau, fv.dim)


def _von_mises(fv, mat, params):
    """Solid von Mises stress from the small-strain stress of the first
    RealSolid-style material keys (lame_mu/lame_lambda)."""
    gd = fv.grad0.get("solid_displacement", fv.grad.get("solid_displacement"))
    lam = prop(mat, "lame_lambda", fv, params, 1.0)
    mu = prop(mat, "lame_mu", fv, params, 1.0)
    eps = 0.5 * (gd + gd.transpose(1, 2))
    tr = _trace(eps)
    d = eps.shape[-1]
    eye = torch.eye(d, dtype=gd.dtype, device=gd.device)[None]
    sig = lam * tr[:, None, None] * eye + 2.0 * mu * eps
    s = sig - _trace(sig)[:, None, None] / 3.0 * eye
    return torch.sqrt(1.5 * torch.sum(s * s, dim=(1, 2)))


def _energy_flux(fv, mat, params):
    gT = fv.grad["temperature"][:, 0, :]
    k = _as_nq(prop(mat, "k", fv, params, 1.0), fv.x.shape[0], gT)
    return -k[:, None] * gT


def _electric_field(fv, mat, params):
    return -fv.grad["voltage"][:, 0, :]


def _darcy_velocity(fv, mat, params):
    gp = fv.grad["porous_pressure"][:, 0, :]
    nq = fv.x.shape[0]
    kop = _as_nq(prop(mat, "permeability", fv, params, 1.0), nq, gp)
    muf = _as_nq(prop(mat, "mu", fv, params, 1.0), nq, gp)
    return -(kop / muf)[:, None] * gp


def _ls_normal(fv, mat, params):
    # unit level-set normal grad(F)/|grad(F)| (reference assemble_normals,
    # src/mm_fill_terms.c:1876, as a lumped projection)
    gF = fv.grad["fill"][:, 0, :]
    return gF / torch.sqrt(torch.sum(gF * gF, dim=1) + 1e-30)[:, None]


def _speed(fv, mat, params):
    u = fv.val["velocity"]
    return torch.sqrt(torch.sum(u * u, dim=1))


def _kinetic_energy(fv, mat, params):
    u = fv.val["velocity"]
    rho = _as_nq(prop(mat, "rho", fv, params, 1.0), fv.x.shape[0], u)
    return 0.5 * rho * torch.sum(u * u, dim=1)


def _density(fv, mat, params):
    return _as_nq(prop(mat, "rho", fv, params, 1.0), fv.x.shape[0], fv.x)


def _viscosity(fv, mat, params):
    """Local (possibly shear-thinning) viscosity (reference's
    POLYMER_VISCOSITY/DENSITY-style material-property map)."""
    return _as_nq(prop(mat, "mu", fv, params, 1.0), fv.x.shape[0], fv.x)


def _electric_field_mag(fv, mat, params):
    E = -fv.grad["voltage"][:, 0, :]
    return torch.sqrt(torch.sum(E * E, dim=1))


def _diffusion_vectors(fv, mat, params):
    """-D grad(c) for every species, flattened (nq, ns*dim) (reference
    DIFFUSION_VECTORS)."""
    gc = fv.grad["species"]  # (nq, ns, dim)
    D = _as_nq(prop(mat, "diffusivity", fv, params, 1.0), gc.shape[0], gc)
    flux = -D[:, None, None] * gc
    return flux.reshape(gc.shape[0], -1)


def _mesh_grad(fv):
    return fv.grad0.get("mesh_displacement", fv.grad.get("mesh_displacement"))


def _strain_tensor(fv, mat, params):
    """Small-strain tensor of the mesh displacement (reference
    STRAIN_TENSOR), upper-triangle components."""
    gd = _mesh_grad(fv)
    eps = 0.5 * (gd + gd.transpose(1, 2))
    return _upper(eps, eps.shape[-1])


def _first_invar_strain(fv, mat, params):
    return _trace(_mesh_grad(fv))


def _sec_invar_strain(fv, mat, params):
    gd = _mesh_grad(fv)
    eps = 0.5 * (gd + gd.transpose(1, 2))
    tr = _trace(eps)
    return 0.5 * (tr * tr - _trace(eps @ eps))


CATALOG: dict[str, Callable] = {
    "VORTICITY": _vorticity,
    "CURL_V": _vorticity,
    "SHEAR_RATE": _shear_rate,
    "MEAN_SHEAR": _shear_rate,
    "DIV_VELOCITY": _div_velocity,
    "PRESSURE_NODAL": _pressure,
    "STRESS_TENSOR": _viscous_stress,
    "VON_MISES_STRESS": _von_mises,
    "ENERGY_FLUX": _energy_flux,
    "CONDUCTION_VECTORS": _energy_flux,
    "ELECTRIC_FIELD": _electric_field,
    "ELECTRIC_FIELD_MAG": _electric_field_mag,
    "LS_NORMAL": _ls_normal,
    "DARCY_VELOCITY": _darcy_velocity,
    "SPEED": _speed,
    "KINETIC_ENERGY": _kinetic_energy,
    "DENSITY": _density,
    "VISCOSITY": _viscosity,
    "DIFFUSION_VECTORS": _diffusion_vectors,
    "STRAIN_TENSOR": _strain_tensor,
    "FIRST_INVAR_STRAIN": _first_invar_strain,
    "SEC_INVAR_STRAIN": _sec_invar_strain,
}

#: porous catalog entries need the PorousFlow equation's saturation model
_POROUS = ("POROUS_SATURATION", "CAPILLARY_PRESSURE", "REL_LIQ_PERM")


def _porous_fn(problem, name):
    model = None
    eqs = problem.equations
    flat = [e for blk in eqs for e in (blk if isinstance(blk, (list, tuple))
                                       else [blk])]
    for eq in flat:
        if getattr(eq, "model", None) is not None and hasattr(
                eq.model, "saturation"):
            model = eq.model
            break
    if model is None:
        raise KeyError(f"{name}: no porous equation with a saturation model")

    def fn(fv, mat, params):
        p = fv.val["porous_pressure"][:, 0]
        if name == "POROUS_SATURATION":
            return model.saturation(p)
        if name == "CAPILLARY_PRESSURE":
            return -p  # pc = -p_liq (reference convention, suction positive)
        return model.krel(p)

    return fn


def residual_nodal_field(problem, x, var: str, params=None) -> np.ndarray:
    """Nodal residual components of one variable's equation (reference
    NS_RESIDUALS / MM_RESIDUALS, ``src/mm_post_proc.c``). Returns
    (n_nodes, ncomp) with zeros at nodes where the variable is inactive."""
    if params is None:
        params = problem.base_params()
    R, _ = problem._assemble(_on_device(problem, x), params)
    R = R.cpu().numpy()
    dofmap = problem.dofmap
    v = dofmap.var(var)
    out = np.zeros((problem.mesh.n_nodes, v.ncomp))
    for c in range(v.ncomp):
        d = dofmap.dof_of_node_svar[:, dofmap.svar(var, c)]
        act = d >= 0
        out[act, c] = R[d[act]]
    return out


def derived_nodal_field(problem, x, name_or_fn, params=None) -> np.ndarray:
    """Nodal values of a catalog (or custom) derived field.
    ``STREAM`` routes to post.stream_function; ``NS_RESIDUALS`` /
    ``MM_RESIDUALS`` to :func:`residual_nodal_field`; porous entries pull
    the saturation model off the problem's PorousFlow equation."""
    if name_or_fn == "STREAM":
        from goma_tpu_torch.post.postproc import stream_function

        return stream_function(problem, x)
    if name_or_fn == "NS_RESIDUALS":
        return residual_nodal_field(problem, x, "velocity", params)
    if name_or_fn == "MM_RESIDUALS":
        return residual_nodal_field(problem, x, "mesh_displacement", params)
    if isinstance(name_or_fn, str) and name_or_fn in _POROUS:
        return project_to_nodes(problem, x, _porous_fn(problem, name_or_fn),
                                params=params)
    fn = CATALOG[name_or_fn] if isinstance(name_or_fn, str) else name_or_fn
    return project_to_nodes(problem, x, fn, params=params)
