"""The viscoelastic slice of the PyTorch port (``physics/viscoelastic.py``
and the polymer terms of ``Momentum``) against goma_tpu, on seeded random
states and on whole Newton solves.

- Element residuals and Jacobians (generic AD assembly) of the full VE block
  (momentum with polymer stress and DEVSS, continuity, one stress mode, the
  velocity-gradient projection) on a 2x2 mesh at a seeded random state, for
  the models oldroyd_b, giesekus, ptt, ptt_linear, log-conformation (also
  at the degenerate point Psi = c I, where the eigenbasis is undefined and
  only the double-``where`` guards keep the derivative finite) and
  sqrt-conformation. float64: 1e-12 relative to each variable's rows' max
  (same integrands in the same dtype; einsum and AD summation order differ
  by a few ulps). The float32 Jacobian at the degenerate point: 1e-5
  (goma_tpu, with x64 on, promotes parts of its integrands to float64; the
  port stays in float32).
- CSR values of bench.bench_viscoelastic's deck at 8x4 (666 dof), float64
  1e-12 and the float32 Jacobian 1e-5, as test_torch_generic_assembly.
- Newton on that deck from x = 0 with bench.py's options on both solver
  paths (float32 Jacobian and factor). ``gmres+ndlu``: the same Newton count
  (4), linear iterations within +-1 of goma_tpu's ([1, 4, 11, 13]),
  ||R||_2 within rel 1e-3 while above 1e-6 (readings <= 2e-6: float32
  element Jacobians that differ by rounding feed each inexact step), both
  below 1e-8, x within 1e-8 (reading 3e-10). ``tpu_direct``, goma_tpu's NDLU
  given the unpivoted front LU as in test_torch_tpu_direct: the same Newton
  count (3), every linear count 1, ||R||_2 within rel 1e-3 while above 1e-6,
  x within 1e-8 (reading 1.3e-10).
- goma_tpu's simple-shear decks (tests/test_viscoelastic.py) through
  ``precond="ndlu"`` in both packages (the port refuses "auto", and
  "direct"): both converge to 1e-10, x within 1e-7 of each other (both
  stop at a row-scaled ||R|| below 1e-10 after inexact steps, reading
  2.8e-8), and the port's stress holds goma_tpu's analytic checks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu.solvers import ndlu as jndlu
from goma_tpu_torch.interop import params_from_numpy
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_host import JAX_PKG, TORCH_PKG, cpu, viscoelastic
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

# bench.bench_viscoelastic("gmres_ndlu") and ("tpu_direct")
GMRES = dict(max_iter=25, tol_residual=1e-8, linear_tol=1e-4, precond="ndlu",
             linear_solver="gmres", gmres_restart=60, linear_maxiter=240,
             ndlu_leaf_max=192, ew_eta_floor=1e-3, ew_endgame="standard")
DIRECT = dict(max_iter=25, tol_residual=1e-8, linear_solver="tpu_direct",
              ndlu_leaf_max=192)
LAM, MU_P = 0.7, 1.3


def _block(pkg, case):
    """The VE block with one stress formulation, 2x2 QUAD9, every term on
    (inertia, transient, SUPG, DEVSS, a body force)."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(2, 2, elem="QUAD9")
    if case.startswith("logconf"):
        stress = phys.LogConformationStress(0, lam=LAM, mu_p=MU_P)
        mom = phys.Momentum(dim=2, logconf_modes=((0, LAM, MU_P),),
                            devss_mu=MU_P)
    elif case == "sqrtconf":
        stress = phys.SqrtConformationStress(0, lam=LAM, mu_p=MU_P,
                                             model="ptt", eps_ptt=0.1)
        mom = phys.Momentum(dim=2, sqrtconf_modes=((0, LAM, MU_P),),
                            devss_mu=MU_P)
    else:
        stress = phys.VEStress(0, dim=2, lam=LAM, mu_p=MU_P, model=case,
                               alpha=0.3, eps_ptt=0.2)
        mom = phys.Momentum(dim=2, ve_stress_modes=1, devss_mu=MU_P)
    prob = fem.Problem(mesh, [mom, phys.Continuity(), stress,
                              phys.VelocityGradientProjection(dim=2)],
                       {"rho": 0.9, "mu": 0.5, "body_force": np.array([2.0, 0.0])},
                       **cpu(pkg))
    prob.add_dirichlet("left", "velocity", 0, 1.0)
    prob.finalize()
    return prob


def _state(pj, case, seed=3):
    rng = np.random.default_rng(seed)
    n = pj.dofmap.n_dof
    x = rng.standard_normal(n)
    if case.startswith("logconf_degenerate"):
        # Psi = 0.4 I at every node, so at every quadrature point
        dm = pj.dofmap
        for c, v in enumerate((0.4, 0.0, 0.4)):
            d = dm.dof_of_node_svar[:, dm.svar("logconf0", c)]
            x[d[d >= 0]] = v
    return x, {"ct": 3.0, "hist": rng.standard_normal(n), "time": 0.0,
               "dirichlet_val": np.asarray(pj.dirichlet_vals)}


@pytest.mark.parametrize("case", ["oldroyd_b", "giesekus", "ptt", "ptt_linear",
                                  "logconf", "logconf_degenerate",
                                  "logconf_degenerate_f32", "sqrtconf"])
def test_ve_element_residual_and_jacobian_match(case):
    pj, pt = _block(JAX_PKG, case), _block(TORCH_PKG, case)
    assert not pt._fast_meta  # polymer terms take the generic path
    f32 = case.endswith("_f32")
    if f32:
        pj.jacobian_dtype = jnp.float32
        pt.jacobian_dtype = torch.float32
    x, p = _state(pj, case)
    jp = pj.base_params()
    jp["ct"], jp["hist"] = jnp.asarray(p["ct"]), jnp.asarray(p["hist"])
    rj, Jj = jax.jit(lambda xx, pp: pj._elem_rj_parts(xx, pp, pj._tables)[:2])(
        jnp.asarray(x), jp)
    rt, Jt, _, _ = pt._elem_rj_parts(torch.as_tensor(x),
                                     params_from_numpy(p, device="cpu"),
                                     pt._tables)
    rj, Jj = np.asarray(rj[0]), np.asarray(Jj[0])
    rt, Jt = rt[0].numpy(), Jt[0].numpy()
    assert Jt.dtype == (np.float32 if f32 else np.float64)
    assert np.isfinite(Jt).all() and np.isfinite(rt).all()
    for s in pt.dofmap.blocks[0].slots:  # each variable's rows apart
        rows = slice(s.start, s.start + s.size)
        for a, b, tol in ((rt, rj, 1e-12), (Jt, Jj, 1e-5 if f32 else 1e-12)):
            err = np.abs(a[:, rows] - b[:, rows]).max()
            assert err <= tol * np.abs(b[:, rows]).max(), (s.var, err)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_closed_forms_at_the_degenerate_point(dtype):
    """The 2x2 closed forms and their forward derivatives at A = c I (and
    x = 0), in each dtype, against goma_tpu's: finite, and equal within
    1e-12 (float64) / 1e-6 (float32) of each array's max. The eigen guard
    scales with the eps of the traced dtype: an off-diagonal 1e-8 (a
    discriminant of 1e-16) is degenerate in float32 (eps^2 ~ 1.4e-14) and
    resolved in float64; also a generic point."""
    from torch.func import jacfwd

    from goma_tpu.physics import viscoelastic as jv
    from goma_tpu_torch.physics import viscoelastic as tv

    def forms(mod, xp):
        def f(a):  # a = (a11, a12, a22, x)
            A = xp.stack([xp.stack([a[0], a[1]]), xp.stack([a[1], a[2]])])[None]
            w, R = mod._eig2_sym(A)
            return xp.concatenate([mod._expm2_sym(A, -1.0).reshape(-1),
                                   w.reshape(-1), R.reshape(-1),
                                   mod._x_over_sinh(a[3:])])
        return f

    tol = 1e-12 if dtype == "float64" else 1e-6
    for a in ([0.4, 0.0, 0.4, 0.0], [0.4, 0.3, -0.2, 0.7]):
        a_np = np.asarray(a, dtype=dtype)
        at = torch.as_tensor(a_np)
        got = (forms(tv, torch)(at), jacfwd(forms(tv, torch))(at))
        want = (forms(jv, jnp)(jnp.asarray(a_np)),
                jax.jacfwd(forms(jv, jnp))(jnp.asarray(a_np)))
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == np.dtype(dtype) and np.isfinite(g).all()
            assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0)
    A = np.array([[[0.4, 1e-8], [1e-8, 0.4]]])  # disc^2 = 1e-16
    w32 = tv._eig2_sym(torch.as_tensor(A, dtype=torch.float32))[0]
    w64 = tv._eig2_sym(torch.as_tensor(A, dtype=torch.float64))[0]
    assert w32[0, 1] == w32[0, 0]
    assert abs(float(w64[0, 1] - w64[0, 0]) - 2e-8) <= 1e-15


@functools.lru_cache(maxsize=None)
def _deck_pair(transient=False):
    return viscoelastic(JAX_PKG, 4, transient), viscoelastic(TORCH_PKG, 4, transient)


@pytest.mark.parametrize("mixed", [False, True])
def test_ve_deck_csr_values_match(mixed):
    pj, pt = _deck_pair()
    assert pt.dofmap.n_dof == 666
    x = 0.1 * np.random.default_rng(7).standard_normal(pj.dofmap.n_dof)
    if mixed:
        pj.jacobian_dtype, pt.jacobian_dtype = jnp.float32, torch.float32
        try:
            Rj, vj, _ = jax.jit(pj._assemble_with_elem)(jnp.asarray(x),
                                                        pj.base_params())
            Rt, vt, _ = pt._assemble_with_elem(torch.as_tensor(x),
                                               pt.base_params())
        finally:
            pj.jacobian_dtype = pt.jacobian_dtype = None
    else:
        Rj, vj = pj._assemble_jit(jnp.asarray(x), pj.base_params())
        Rt, vt = pt._assemble(torch.as_tensor(x), pt.base_params())
    Rj, vj = np.asarray(Rj), np.asarray(vj)
    assert vt.dtype == (torch.float32 if mixed else torch.float64)
    assert np.abs(Rt.numpy() - Rj).max() <= 1e-12 * np.abs(Rj).max()
    assert np.abs(vt.numpy() - vj).max() <= (1e-5 if mixed else 1e-12) * np.abs(vj).max()


def _newton(kw):
    pj, pt = _deck_pair()
    pj.jacobian_dtype, pt.jacobian_dtype = jnp.float32, torch.float32
    x0 = np.zeros(pj.dofmap.n_dof)
    try:
        sj = JSolver(pj, JOptions(**kw))
        params = pj.base_params()
        if kw["linear_solver"] == "tpu_direct":
            # goma_tpu's NDLU with the unpivoted front LU the port runs, as
            # goma_tpu builds it lazily (test_torch_tpu_direct)
            vals = sj._prep(jnp.asarray(x0), params, sj._ntab["ell"])[1]
            sj._ndlu = jndlu.NDLU(
                pj.pattern, leaf_max=kw["ndlu_leaf_max"], dtype=jnp.float32,
                front_lu="pallas",
                defer_dofs=jndlu.zero_diag_defer_mask(pj.pattern,
                                                      jax.device_get(vals)),
                clusters=jndlu.node_clusters(pj))
        else:
            sj.precond.front_lu = "pallas"
        rj = sj.solve(x0, params)
        rt = NewtonSolver(pt, NewtonOptions(**kw)).solve(x0, pt.base_params())
    finally:
        pj.jacobian_dtype = pt.jacobian_dtype = None
    return rj, rt


@pytest.mark.parametrize("path", ["gmres+ndlu", "tpu_direct"])
def test_ve_newton_matches_goma_tpu(path):
    rj, rt = _newton(GMRES if path == "gmres+ndlu" else DIRECT)
    info = (rt.summary(), rj.summary())
    assert rj.converged and rt.converged, info
    assert rt.iters == rj.iters == (4 if path == "gmres+ndlu" else 3), info
    assert len(rt.linear_iters) == len(rj.linear_iters)
    if path == "tpu_direct":
        assert rt.linear_iters == rj.linear_iters == [1] * rt.iters
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= 1, info
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > 1e-6:
            assert abs(l2t - l2j) <= 1e-3 * l2j, info
    assert rt.res_norms[-1][1] < 1e-8 and rj.res_norms[-1][1] < 1e-8
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)


def _shear_deck(pkg, case):
    """goma_tpu's simple-shear decks (tests/test_viscoelastic.py): 4x4
    QUAD9, Couette u = (V y, 0) on every wall, and its initial state."""
    mesh_m, fem, phys = pkg
    lam, mu_p, V = 0.5, 1.0, (1.0 if case in ("oldroyd_b", "logconf", "sqrtconf")
                              else 2.0)
    mesh = mesh_m.rectangle_mesh(4, 4, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    if case == "logconf":
        mom = phys.Momentum(dim=2, interp="Q2", transient=False,
                            logconf_modes=((0, lam, mu_p),), devss_mu=mu_p)
        extra = [phys.LogConformationStress(0, lam=lam, mu_p=mu_p, interp="Q1",
                                            transient=False),
                 phys.VelocityGradientProjection(dim=2, interp="Q1")]
    elif case == "sqrtconf":
        mom = phys.Momentum(dim=2, interp="Q2", transient=False,
                            sqrtconf_modes=((0, lam, mu_p),))
        extra = [phys.SqrtConformationStress(0, lam=lam, mu_p=mu_p, interp="Q1",
                                             transient=False)]
    else:
        model, alpha, eps = {"oldroyd_b": ("oldroyd_b", 0.0, 0.0),
                             "giesekus": ("giesekus", 0.3, 0.0),
                             "ptt": ("ptt", 0.0, 0.2)}[case]
        mom = phys.Momentum(dim=2, interp="Q2", transient=False,
                            ve_stress_modes=1, devss_mu=mu_p)
        extra = [phys.VEStress(0, dim=2, lam=lam, mu_p=mu_p, model=model,
                               alpha=alpha, eps_ptt=eps, interp="Q1",
                               transient=False),
                 phys.VelocityGradientProjection(dim=2, interp="Q1")]
    prob = fem.Problem(mesh, [mom, phys.Continuity(interp="Q1")] + extra,
                       {"rho": 0.0, "mu": 0.5}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, lambda c: V * c[:, 1])
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    dm = prob.dofmap

    def put(var, comp, f):
        d = dm.dof_of_node_svar[:, dm.svar(var, comp)]
        ok = d >= 0
        x0[d[ok]] = f(mesh.coords[ok]) if callable(f) else f

    W = lam * V
    if case == "ptt":
        put("velocity", 0, lambda c: V * c[:, 1])
        put("stress0", 1, mu_p * V)
    elif case == "logconf":
        put("velocity", 0, lambda c: V * c[:, 1])
        c_ex = np.array([[1 + 2 * W ** 2, W], [W, 1.0]])
        w, v = np.linalg.eigh(c_ex)
        psi = v @ np.diag(np.log(w)) @ v.T
        for comp, (a, b) in enumerate(((0, 0), (0, 1), (1, 1))):
            put("logconf0", comp, psi[a, b])
    elif case == "sqrtconf":
        put("bconf0", 0, 1.0)  # b = I: b = 0 is singular through b^-1
        put("bconf0", 2, 1.0)
    return prob, x0, lam, mu_p, V


@pytest.mark.parametrize("case", ["oldroyd_b", "giesekus", "ptt", "logconf",
                                  "sqrtconf"])
def test_simple_shear_decks_match_goma_tpu(case):
    kw = dict(max_iter=20, tol_residual=1e-10, linear_tol=1e-11,
              precond="ndlu", gmres_restart=100, linear_maxiter=3000)
    pj, x0, lam, mu_p, V = _shear_deck(JAX_PKG, case)
    pt, _, _, _, _ = _shear_deck(TORCH_PKG, case)
    rj = JSolver(pj, JOptions(**kw)).solve(x0, pj.base_params())
    rt = NewtonSolver(pt, NewtonOptions(**kw)).solve(x0, pt.base_params())
    assert rj.converged and rt.converged, (rt.summary(), rj.summary())
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-7)
    var = {"logconf": "logconf0", "sqrtconf": "bconf0"}.get(case, "stress0")
    s11, s12, s22 = (pj.get_nodal_field(rt.x, var, c) for c in range(3))
    gd = V
    if case == "oldroyd_b":
        np.testing.assert_allclose(np.nanmean(s12), mu_p * gd, rtol=1e-6)
        np.testing.assert_allclose(np.nanmean(s11), 2 * lam * mu_p * gd ** 2,
                                   rtol=1e-6)
        assert np.nanmax(np.abs(s22)) < 1e-6 and np.nanstd(s11) < 1e-6
    elif case == "giesekus":
        s12m = np.nanmean(s12)
        assert 0 < s12m < mu_p * V  # shear thinning
        assert np.nanmean(s11) - np.nanmean(s22) > 0 and np.nanmean(s22) < 0
    elif case == "ptt":
        # thinner than the Oldroyd-B limit mu_p V
        assert np.nanmean(s12) < mu_p * V
    else:
        W = lam * V
        c_ex = np.array([[1 + 2 * W ** 2, W], [W, 1.0]])
        m = ~np.isnan(s11)
        B = np.stack([np.stack([s11[m], s12[m]], -1),
                      np.stack([s12[m], s22[m]], -1)], -2)
        if case == "logconf":
            w, v = np.linalg.eigh(B)
            c = np.einsum("qij,qj,qkj->qik", v, np.exp(w), v)
        else:
            c = np.einsum("qik,qjk->qij", B, B)
        np.testing.assert_allclose(c, np.broadcast_to(c_ex, c.shape), atol=1e-6)
