"""Linear stability of the PyTorch port against goma_tpu: the mass matrix
and shift-invert eigensolves of ``continuation/stability.py``, the
normal-mode (3D-of-2D) equations of ``physics/normal_mode.py`` and the
deforming-mesh z-mode equations of ``physics/normal_mode_ale.py``, each deck
built in both packages on the CPU in float64 (the port in one torch thread).

Restated from goma_tpu's own tests (tests/test_continuation.py's heat
spectrum, host and device Arnoldi; tests/test_normal_mode.py;
tests/test_normal_mode_ale.py; tests/test_examples.py's Rayleigh-Benard
sweep of examples/rayleigh_benard_3d_stability.py), each with goma_tpu's
own checks against the exact spectra and dispersions, and: the J and M
CSR values within 1e-12 of goma_tpu's (``mass_and_jacobian``), and every
leading growth rate within 1e-6 relative of goma_tpu's (both eigensolves
converge to ~1e-10; the bound leaves room for the Krylov start vectors,
which differ between two ARPACK runs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.continuation as jcont
import goma_tpu.continuation.stability as jstab
import goma_tpu.physics as jphys
import goma_tpu_torch.continuation as tcont
import goma_tpu_torch.continuation.stability as tstab
import goma_tpu_torch.physics as tphys
from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import JAX_PKG, TORCH_PKG, cpu

SIG_RTOL = 1e-6
PI2 = np.pi**2


def _scalar(prob, pkg, v):
    if pkg is TORCH_PKG:
        return torch.as_tensor(v, dtype=prob.dtype, device=prob.device)
    return jnp.asarray(v, dtype=prob.dtype)


def _cont(pkg):
    return tcont if pkg is TORCH_PKG else jcont


def _close(st, sj):
    st, sj = np.sort(np.asarray(st).real), np.sort(np.asarray(sj).real)
    assert st.shape == sj.shape
    assert np.all(np.abs(st - sj) <= SIG_RTOL * np.abs(sj)), (st, sj)


def heat(pkg, normal_mode=False):
    mesh_m, fem, phys = pkg
    eq = (phys.NormalModeEnergy(interp="Q2") if normal_mode
          else phys.Energy(interp="Q2", transient=True, convection=False))
    prob = fem.Problem(mesh_m.rectangle_mesh(8, 8, elem="QUAD9"), [eq],
                       {"rho": 1.0, "Cp": 1.0, "k": 1.0}, **cpu(pkg))
    var = "nm_temperature" if normal_mode else "temperature"
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, var, 0, 0.0)
    prob.finalize()
    return prob


def test_mass_and_jacobian_match_goma_tpu():
    pj, pt = heat(JAX_PKG), heat(TORCH_PKG)
    x = np.random.default_rng(21).standard_normal(pt.dofmap.n_dof)
    for a, b in zip(tstab.mass_and_jacobian(pt, x, pt.base_params()),
                    jstab.mass_and_jacobian(pj, x, pj.base_params())):
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
    assert np.abs(b).max() > 0


@pytest.mark.parametrize("solver", ["host", "device"])
def test_lsa_heat_spectrum(solver):
    out = []
    for pkg in (JAX_PKG, TORCH_PKG):
        prob = heat(pkg)
        mod = tstab if pkg is TORCH_PKG else jstab
        fn = mod.solve_stability if solver == "host" else mod.solve_stability_device
        res = fn(prob, np.zeros(prob.dofmap.n_dof), prob.base_params(),
                 n_modes=4, shift=-2 * PI2)
        sig = np.sort(-res.growth_rates.real)
        np.testing.assert_allclose(sig[:4], np.array([2, 5, 5, 8]) * PI2, rtol=2e-3)
        assert res.stable
        out.append(res.growth_rates)
    _close(out[1], out[0])


def test_normal_mode_heat_spectrum():
    beta = 1.5
    out = []
    for pkg in (JAX_PKG, TORCH_PKG):
        prob = heat(pkg, normal_mode=True)
        params = prob.base_params(beta=_scalar(prob, pkg, beta))
        res = _cont(pkg).solve_stability(prob, np.zeros(prob.dofmap.n_dof), params,
                                         n_modes=4, shift=-(2 * PI2 + beta**2))
        np.testing.assert_allclose(np.sort(-res.growth_rates.real),
                                   np.array([2, 5, 5, 8]) * PI2 + beta**2, rtol=2e-3)
        out.append(res.growth_rates)
    _close(out[1], out[0])


def rb(pkg, Ra, n=6):
    """examples/rayleigh_benard_3d_stability.py::build (tests/
    test_normal_mode.py's _rb_growth deck): the conduction state, Pr = 1,
    free-slip horizontal walls; returns (problem, params at beta = 0)."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(3, n, elem="QUAD9", xlim=(0, 0.5), ylim=(0, 1))
    prob = fem.Problem(mesh, [phys.NormalModeMomentum(), phys.NormalModeW(),
                              phys.NormalModeContinuity(), phys.NormalModeEnergy()],
                       {"rho": 1.0, "mu": 1.0, "k": 1.0, "Cp": 1.0,
                        "buoyancy": (0.0, Ra)},
                       external_fields=("u0", "v0", "T0"), **cpu(pkg))
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "nm_velocity", 1, 0.0)
        prob.add_dirichlet(ns, "nm_temperature", 0, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "nm_velocity", 0, 0.0)
    prob.finalize()
    z = np.zeros(mesh.n_nodes)
    params = prob.base_params(beta=_scalar(prob, pkg, 0.0), ext_u0=z, ext_v0=z,
                              ext_T0=1.0 - mesh.coords[:, 1])
    return prob, params


def rb_sweep(pkg, Ra, betas, n_modes=2):
    prob, params = rb(pkg, Ra)
    out = []
    for b in betas:
        p = dict(params)
        p["beta"] = _scalar(prob, pkg, b)
        r = _cont(pkg).solve_stability(prob, np.zeros(prob.dofmap.n_dof), p,
                                       n_modes=n_modes, shift=0.5)
        out.append(float(r.growth_rates.real.max()))
    return out


def test_rayleigh_benard_critical():
    beta_c = np.pi / np.sqrt(2.0)
    sj = [rb_sweep(JAX_PKG, Ra, [beta_c], n_modes=3)[0] for Ra in (600.0, 720.0)]
    st = [rb_sweep(TORCH_PKG, Ra, [beta_c], n_modes=3)[0] for Ra in (600.0, 720.0)]
    _close(st, sj)
    s_lo, s_hi = st
    assert s_lo < 0 < s_hi
    Ra_est = 600.0 - s_lo * (720.0 - 600.0) / (s_hi - s_lo)
    assert abs(Ra_est - 27 * np.pi**4 / 4) / (27 * np.pi**4 / 4) < 0.02


def test_example_rb_stability_sweep():
    """tests/test_examples.py::test_example_rb_stability_sweep in both
    packages: at Ra = 700 the band around beta_c grows, its flanks decay."""
    betas = (1.2, 2.221, 3.6)
    sj, st = rb_sweep(JAX_PKG, 700.0, betas), rb_sweep(TORCH_PKG, 700.0, betas)
    _close(st, sj)
    assert st[1] > 0 and st[0] < 0 and st[2] < 0


def couette_base(pkg):
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(3, 8, elem="QUAD9", xlim=(0, 0.5), ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    base = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=False),
                              phys.Continuity(interp="Q1")],
                       {"rho": 1.0, "mu": 0.1}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        base.add_dirichlet(ns, "velocity", 0, lambda c: c[:, 1])
        base.add_dirichlet(ns, "velocity", 1, 0.0)
    base.add_dirichlet("pin", "pressure", 0, 0.0)
    base.finalize()
    return base


def test_3d_of_2d_driver_plane_couette():
    out = []
    for pkg, Opts, Solver in ((JAX_PKG, JOptions, JSolver),
                              (TORCH_PKG, NewtonOptions, NewtonSolver)):
        base = couette_base(pkg)
        res = Solver(base, Opts(max_iter=8, tol_residual=1e-10,
                                linear_solver="direct")).solve(
            np.zeros(base.dofmap.n_dof), base.base_params())
        assert res.converged
        sweep = _cont(pkg).solve_stability_3d_of_2d(
            base, res.x, betas=(0.5, 2.0), mat={"rho": 1.0, "mu": 0.1},
            n_modes=3, shift=0.0)
        out.append([s for _, s, _ in sweep])
    _close(out[1], out[0])
    s05, s2 = out[1]
    assert s05 < 0 and s2 < 0 and s2 < s05


H, MU, SIG = 1.0, 1.0, 1.0


def s_exact(beta, g=0.0, rho=0.0):
    q = beta * H
    drive = SIG * beta**2 + rho * g
    return -(drive / (2 * MU * beta)) * (
        np.sinh(q) * np.cosh(q) - q) / (np.cosh(q) ** 2 + q**2)


def film(pkg, rho, g=0.0, ny=12, zmode=True):
    """tests/test_normal_mode_ale.py's film_problem (examples/
    film_stability.py's deck): a viscous film on a no-slip floor with a
    free capillary top, ALE, plus the z-mode equations."""
    import goma_tpu.bc as jbc
    import goma_tpu_torch.bc as tbc

    mesh_m, fem, phys = pkg
    bc = tbc if pkg is TORCH_PKG else jbc
    mesh = mesh_m.rectangle_mesh(2, ny, elem="QUAD9", xlim=(0, 0.25), ylim=(0, H))
    eqs = [phys.Momentum(dim=2, interp="Q2", transient=True),
           phys.Continuity(interp="Q1"), phys.EllipticMesh(dim=2, interp="Q2")]
    if zmode:
        eqs += phys.zmode_equations(dim=2)
    mat = {"rho": rho, "mu": MU, "sigma": SIG}
    if g:
        mat["body_force"] = np.array([0.0, -g])
    prob = fem.Problem(mesh, eqs, mat, **cpu(pkg))
    for c in (0, 1):
        prob.add_dirichlet("bottom", "velocity", c, 0.0)
        prob.add_dirichlet("bottom", "mesh_displacement", c, 0.0)
    if zmode:
        prob.add_dirichlet("bottom", "nm_w", 0, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "mesh_displacement", 0, 0.0)
    prob.add_face_kernel("top", bc.CapillaryBC(dim=2))
    prob.add_face_kernel("top", bc.KinematicBC(dim=2))
    if zmode:
        prob.add_face_kernel("top", phys.CapillaryZNormal(dim=2))
    prob.finalize()
    return prob


def test_capillary_film_leveling_dispersion():
    out = []
    for pkg in (JAX_PKG, TORCH_PKG):
        prob = film(pkg, rho=1e-6)
        x0 = np.zeros(prob.dofmap.n_dof)
        sig = []
        for b in (0.4, 1.5):
            se = s_exact(b)
            r = _cont(pkg).solve_stability(
                prob, x0, prob.base_params(beta=_scalar(prob, pkg, b)),
                n_modes=4, shift=se)
            s = r.growth_rates.real.max()
            assert abs(s - se) < 1e-3 * abs(se), (b, s, se)
            sig.append(s)
        out.append(sig)
    _close(out[1], out[0])


def test_gravity_capillary_film_dispersion():
    """examples/film_stability.py's path (``solve_stability_3d_of_2d_ale``:
    the hydrostatic ALE base solved on the plain deck, embedded into the
    z-mode deck)."""
    rho, b = 0.01, 0.4
    g = SIG * b**2 / rho
    se = s_exact(b, g=g, rho=rho)
    out = []
    for pkg, Opts, Solver in ((JAX_PKG, JOptions, JSolver),
                              (TORCH_PKG, NewtonOptions, NewtonSolver)):
        base = film(pkg, rho, g=g, zmode=False)
        res = Solver(base, Opts(max_iter=5, tol_residual=1e-11,
                                linear_solver="direct")).solve(
            np.zeros(base.dofmap.n_dof), base.base_params())
        assert res.converged
        p = base.get_nodal_field(res.x, "pressure")
        nodes = np.where(~np.isnan(p))[0]
        np.testing.assert_allclose(
            p[nodes], rho * g * (H - base.mesh.coords[nodes, 1]), atol=1e-8)
        ext = film(pkg, rho, g=g, zmode=True)
        (_, s, _), = _cont(pkg).solve_stability_3d_of_2d_ale(
            ext, base, res.x, [b], n_modes=4, shift=se)
        assert abs(s - se) < 0.02 * abs(se) and abs(s / s_exact(b) - 2.0) < 0.05
        out.append(s)
    _close(out[1:], out[:1])


def test_embed_state_matches_goma_tpu():
    bj, bt = film(JAX_PKG, 0.01, zmode=False), film(TORCH_PKG, 0.01, zmode=False)
    ej, et = film(JAX_PKG, 0.01), film(TORCH_PKG, 0.01)
    x = np.random.default_rng(22).standard_normal(bt.dofmap.n_dof)
    np.testing.assert_array_equal(tphys.embed_state(bt, x, et),
                                  jphys.embed_state(bj, x, ej))
