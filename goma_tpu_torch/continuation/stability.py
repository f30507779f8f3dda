"""Linear stability analysis (LSA): generalized eigensolve at a steady state
(counterpart of ``goma_tpu/continuation/stability.py``).

Parity: reference ``src/ac_stability.c:88 solve_stability_problem`` — assemble
Jacobian J and mass matrix M, solve J z = mu M z by shift-invert (the
"eggroll" Arnoldi solver ``src/sl_eggrollwrap.c:69`` / ARPACK Cayley
``src/loca_eigen_cayley.F``).

The mass matrix needs no separate assembly code: the time scheme enters the
residual as qdot = ct*x + hist, linear in ct, so

    M = dR/d(qdot) = A(ct=1) - A(ct=0)

with A the assembled Jacobian values — two assemblies, zero new kernels.
(Dirichlet rows are identity in both, so their M rows vanish, exactly the
reference's "no mass on BC rows".)

Perturbations x0 + z e^{sigma t} satisfy (J + sigma M) z = 0; we report
growth rates sigma = -mu for eigenvalues mu of J z = mu M z nearest the
shift (stable iff all Re(sigma) < 0). ``solve_stability`` runs SciPy's
shift-invert Arnoldi on the host (the serial validation path, like the
reference's eggroll); ``solve_stability_device`` keeps the Arnoldi basis on
the problem's device and solves the inner systems with the port's GMRES.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch.continuation.conti import _device, _host, _scalar


@dataclass
class StabilityResult:
    growth_rates: np.ndarray  # complex, sorted by descending real part
    modes: np.ndarray  # (n_dof, k)
    stable: bool


def mass_and_jacobian(problem, x, params):
    """Returns (J_vals, M_vals) CSR value arrays at state x (host float64)."""
    p0 = dict(params)
    p0["ct"] = _scalar(problem, 0.0)
    _, J = problem.assemble(_device(problem, x), p0)
    p1 = dict(params)
    p1["ct"] = _scalar(problem, 1.0)
    _, A1 = problem.assemble(_device(problem, x), p1)
    J = _host(J)
    return J, _host(A1) - J


def solve_stability(problem, x, params, n_modes: int = 6, shift: float = 0.0,
                    purify_tol: float = 1e-6) -> StabilityResult:
    """Leading eigenmodes of the linearized dynamics at steady state x.

    Eigenpairs are *purified*: with a singular mass matrix (quasi-static
    mesh/pressure/constraint rows carry no mass) shift-invert Arnoldi
    returns spurious "infinite" modes folded numerically onto the shift
    (the reference wards these off with its Cayley transform,
    ``src/loca_eigen_cayley.F``). A true pair satisfies
    ||(J - mu M) z|| << ||J z|| + |mu| ||M z||; spurious pairs sit at
    O(1) and are dropped. Oversampling (2k+4 Krylov pairs requested)
    keeps n_modes genuine pairs available after the filter."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    Jv, Mv = mass_and_jacobian(problem, x, params)
    pat = problem.pattern
    J = sp.csr_matrix((Jv, pat.indices, pat.indptr), shape=(pat.n, pat.n))
    M = sp.csr_matrix((Mv, pat.indices, pat.indptr), shape=(pat.n, pat.n))
    # J z = mu M z, shift-invert near mu = -shift (growth sigma = -mu near shift)
    k = min(2 * n_modes + 4, pat.n - 2)
    mu, z = spla.eigs(J, k=k, M=M, sigma=-shift, which="LM")
    # purification: generalized residual per pair
    Jz = J @ z
    Mz = M @ z
    num = np.linalg.norm(Jz - Mz * mu[None, :], axis=0)
    den = np.linalg.norm(Jz, axis=0) + np.abs(mu) * np.linalg.norm(Mz, axis=0)
    good = num <= purify_tol * np.maximum(den, 1e-300)
    if good.sum() == 0:
        good = num <= 10 * num.min()  # keep the least-bad rather than none
    mu, z = mu[good], z[:, good]
    sigma = -mu
    order = np.argsort(-sigma.real)[:n_modes]
    sigma = sigma[order]
    z = z[:, order]
    return StabilityResult(growth_rates=sigma, modes=z, stable=bool(np.all(sigma.real < 0)))


def solve_stability_device(problem, x, params, n_modes: int = 6,
                           shift: float = 0.0, m: int | None = None,
                           inner_tol: float = 1e-9, inner_maxiter: int = 600,
                           gmres_restart: int = 120,
                           seed: int = 0) -> StabilityResult:
    """Shift-invert Arnoldi on the problem's device.

    The reference delegates this to serial eggroll or ARPACK+Cayley
    (src/sl_eggrollwrap.c:69, src/loca_eigen_cayley.F); here the inner
    (J - mu0 M)^-1 solves use the port's block-Jacobi-preconditioned GMRES
    on the ELL operator, and the Arnoldi basis lives on the device (CGS2
    orthogonalization as float64 matmuls). The small Hessenberg
    eigenproblem is solved on the host.
    """
    from goma_tpu_torch.fem.sparsity import EllOperator
    from goma_tpu_torch.solvers.linear import BlockJacobi, gmres

    Jv, Mv = mass_and_jacobian(problem, x, params)
    dtype, dev = problem.dtype, problem.device
    mu0 = -shift
    Cv = torch.as_tensor(Jv - mu0 * Mv, dtype=dtype, device=dev)
    Mvj = torch.as_tensor(Mv, dtype=dtype, device=dev)
    pat = problem.pattern
    n = pat.n
    ell = EllOperator(pat, device=dev)
    pre = BlockJacobi(pat, problem.dofmap, device=dev)
    fac = pre.factor(Cv)

    def op(v):
        lr = gmres(lambda u: ell.matvec(Cv, u), ell.matvec(Mvj, v),
                   precond=lambda r: pre.apply(fac, r), tol=inner_tol,
                   restart=gmres_restart, maxiter=inner_maxiter)
        return lr.x

    if m is None:
        m = max(4 * n_modes + 8, n_modes + 12)
    m = min(m, n - 1)
    rng = np.random.RandomState(seed)
    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    v0 = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
    V[0] = v0 / torch.linalg.norm(v0)
    H = np.zeros((m + 1, m))

    for j in range(m):
        w = op(V[j])
        mask = (torch.arange(m + 1, device=dev) <= j).to(dtype)
        h = (V @ w) * mask
        w = w - V.T @ h
        h2 = (V @ w) * mask
        w = w - V.T @ h2
        h = _host(h + h2)
        wn = float(torch.linalg.norm(w))
        H[: m + 1, j] = h
        H[j + 1, j] = wn
        if wn < 1e-13:
            m = j + 1
            break
        V[j + 1] = w / wn

    theta, Y = np.linalg.eig(H[:m, :m])
    keep = np.argsort(-np.abs(theta))[:n_modes]
    theta = theta[keep]
    Y = Y[:, keep]
    mu = mu0 + 1.0 / theta
    sigma = -mu
    Vh = _host(V[:m])
    modes = (Vh.T @ Y)
    order = np.argsort(-sigma.real)
    sigma = sigma[order]
    modes = modes[:, order]
    return StabilityResult(growth_rates=sigma, modes=modes,
                           stable=bool(np.all(sigma.real < 0)))


def solve_stability_3d_of_2d(base_problem, base_x, betas, mat=None,
                             thermal=False, n_modes=3, shift=0.5,
                             side_bcs=None, base_params=None):
    """3D-of-2D normal-mode sweep driver (reference ``solve_stability_problem``
    wavenumber loop, src/ac_stability.c:468): extracts the base flow
    (velocity [+ temperature]) from a SOLVED 2D problem, builds the
    normal-mode perturbation problem on the same mesh and device with the
    base fields frozen as externals, and returns [(beta, leading growth
    rate, result)]. One problem serves every wavenumber (beta is a params
    leaf).

    ``side_bcs(prob)``: callback registering the perturbation BCs (PEC-style
    walls etc.); defaults to homogeneous Dirichlet of the in-plane velocity
    and temperature on every nodeset of the mesh named left/right/top/bottom.
    """
    from goma_tpu_torch.fem import Problem
    from goma_tpu_torch.physics.normal_mode import (NM_T, NM_U,
                                                    NormalModeContinuity,
                                                    NormalModeEnergy,
                                                    NormalModeMomentum,
                                                    NormalModeW)

    mesh = base_problem.mesh
    mat = dict(mat if mat is not None else base_problem.materials[0])
    eqs = [NormalModeMomentum(), NormalModeW(), NormalModeContinuity()]
    ext = ["u0", "v0"]
    if thermal:
        eqs.append(NormalModeEnergy())
        ext.append("T0")
    prob = Problem(mesh, eqs, mat, external_fields=tuple(ext),
                   dtype=base_problem._dtype, device=base_problem.device)
    if side_bcs is not None:
        side_bcs(prob)
    else:
        for ns in ("left", "right", "top", "bottom"):
            if ns in mesh.nodesets:
                prob.add_dirichlet(ns, NM_U, 0, 0.0)
                prob.add_dirichlet(ns, NM_U, 1, 0.0)
                if thermal:
                    prob.add_dirichlet(ns, NM_T, 0, 0.0)
    prob.finalize()

    u0 = np.nan_to_num(base_problem.get_nodal_field(base_x, "velocity", 0))
    v0 = np.nan_to_num(base_problem.get_nodal_field(base_x, "velocity", 1))
    extras = {"ext_u0": u0, "ext_v0": v0}
    if thermal:
        extras["ext_T0"] = np.nan_to_num(
            base_problem.get_nodal_field(base_x, "temperature", 0))
    if base_params is not None:
        extras.update(base_params)

    out = []
    x0 = np.zeros(prob.dofmap.n_dof)
    for b in betas:
        p = prob.base_params(beta=_scalar(prob, b), **extras)
        r = solve_stability(prob, x0, p, n_modes=n_modes, shift=shift)
        out.append((float(b), float(r.growth_rates.real.max()), r))
    return out


def solve_stability_3d_of_2d_ale(ext_prob, base_prob, base_x, betas,
                                 n_modes: int = 4, shift: float = 0.0,
                                 params_extra: dict | None = None):
    """Deforming-mesh (free-surface) 3D-of-2D normal-mode sweep.

    Parity: the reference's LSA_3D_OF_2D with mesh mode equations
    (``src/ac_stability_util.c do_LSA_mods``). ``ext_prob`` is the SAME
    deck as ``base_prob`` plus the z-mode additions
    (``goma_tpu_torch.physics.zmode_equations`` + ``CapillaryZNormal`` on
    the free-surface sidesets); ``base_x`` is the solved 2D base state. The
    base rides over via :func:`goma_tpu_torch.physics.embed_state`; J(beta)
    is then the extended problem's AD Jacobian — every mesh-position
    sensitivity, kinematic/capillary coupling and displaced-domain body
    force included — plus the explicit beta-correction kernels.

    Returns [(beta, leading growth rate, StabilityResult), ...].
    """
    from goma_tpu_torch.physics.normal_mode_ale import embed_state

    x_emb = embed_state(base_prob, base_x, ext_prob)
    out = []
    for b in betas:
        p = ext_prob.base_params(beta=_scalar(ext_prob, b),
                                 **(params_extra or {}))
        r = solve_stability(ext_prob, x_emb, p, n_modes=n_modes, shift=shift)
        out.append((float(b), float(r.growth_rates.real.max()), r))
    return out
