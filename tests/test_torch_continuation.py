"""Continuation, augmenting conditions, hunting, fold/pitchfork/Hopf
tracking and flux sensitivity of the PyTorch port against goma_tpu, each
deck built in both packages on the CPU in float64 (the port in one torch
thread), from the same inputs.

Restated from goma_tpu's own tests (tests/test_continuation.py,
tests/test_bifurcation2.py, tests/test_pointwise.py::test_hunting_and_folds,
tests/test_flux_sens_particles.py), each with goma_tpu's own checks and:

- continuation and hunting on the host ``direct`` rung: the same accepted
  lambda sequence (equal floats: the step control is host arithmetic on
  equal Newton counts) and Newton counts, each step's x within 1e-10
  (1 + |x|) (both solve by SuperLU in float64);
- arclength: the same steps and Newton counts, lambda and x within 1e-8
  (its bordered updates divide by t_x . w2, which amplifies roundoff near
  the fold);
- the augmenting condition: the same Newton count, p and x within 1e-10;
- fold tracking: lambda within 1e-6 of goma_tpu's (the acceptance bound)
  and within 0.02 of 6.808; pitchfork lambda within 1e-3 of pi^2; Hopf
  b* = 1 + a^2 and omega = a within 1e-8, and each within 1e-8 of
  goma_tpu's;
- flux sensitivity within 1e-8 relative of goma_tpu's;
- ``_dR_dlam`` on the lid-speed cavity (a parametric Dirichlet value) and
  on Bratu (a params leaf in a material function) within 1e-10 relative
  of goma_tpu's jvp, by the exact route; the central difference only for a
  ``make_params`` that is not traceable;
- the 8x8 lid-driven cavity continued in lid speed U 1 -> 2 on the main
  path's ``gmres+ndlu`` options (float32 Jacobian and factor; goma_tpu's
  front LU in its Pallas kernel, interpret mode): the same lambda sequence,
  Newton counts and predictor linear iterations, the final state within
  1e-5 (the mixed-precision allowance of tests/test_torch_newton.py's main
  path options, 1e-6 a solve, with four inexact float32 solves behind it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.continuation as jcont
import goma_tpu.continuation.conti as jconti
import goma_tpu_torch.continuation as tcont
import goma_tpu_torch.continuation.conti as tconti
from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import JAX_PKG, TORCH_PKG, cpu
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

X_TOL = 1e-10
DIRECT = dict(linear_solver="direct")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _xdiff(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def _xp(pkg):
    return torch if pkg is TORCH_PKG else jnp


def _scalar(prob, pkg, v):
    if pkg is TORCH_PKG:
        return torch.as_tensor(v, dtype=prob.dtype, device=prob.device)
    return jnp.asarray(v, dtype=prob.dtype)


def bratu(pkg, n, k_param=False):
    """-k lap T = lam e^T on the unit square, T = 0 on the boundary
    (tests/test_continuation.py's deck); ``k_param``: k = params["kk"]."""
    mesh_m, fem, phys = pkg
    xp = _xp(pkg)

    def source(fv, mat, params):
        return params["lam"] * xp.exp(fv.val["temperature"][:, 0])

    k = (lambda fv, mat, params: params["kk"]) if k_param else 1.0
    prob = fem.Problem(mesh_m.rectangle_mesh(n, n, elem="QUAD9"),
                       [phys.Energy(interp="Q2", transient=False,
                                    convection=False)],
                       {"k": k, "heat_source": source}, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    return prob


def lid_cavity(pkg, n, mu=0.01):
    """__graft_entry__._cavity_problem(n) with mu 0.01 and the lid's u the
    parametric Dirichlet value params["U"] (Re = 100 U)."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    mesh.nodesets["lid"] = top[(xt > xt.min()) & (xt < xt.max())]
    prob = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=False),
                              phys.Continuity(interp="Q1")],
                       {"rho": 1.0, "mu": mu}, **cpu(pkg))
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("lid", "velocity", 0, lambda c, p: p["U"])
    prob.add_dirichlet("lid", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


def maker(prob, pkg, key="lam", **fixed):
    def make_params(v):
        extra = {k: _scalar(prob, pkg, w) for k, w in fixed.items()}
        return prob.base_params(**{key: _scalar(prob, pkg, v)}, **extra)
    return make_params


def both(build, *args, **kw):
    return build(JAX_PKG, *args, **kw), build(TORCH_PKG, *args, **kw)


def _same_steps(sj, st, lam_tol=0.0, x_tol=X_TOL):
    assert len(st) == len(sj)
    for a, b in zip(st, sj):
        assert abs(a.lam - b.lam) <= lam_tol, ([s.lam for s in st], [s.lam for s in sj])
        assert a.newton_iters == b.newton_iters
        assert _xdiff(a.x, b.x) <= x_tol


def test_bratu_continuation_and_arclength():
    pj, pt = both(bratu, 6)
    opts = dict(DIRECT, max_iter=10, tol_residual=1e-10)
    sj = jcont.continue_problem(pj, maker(pj, JAX_PKG), 0.0, 5.0, 1.0,
                                np.zeros(pj.dofmap.n_dof), JOptions(**opts))
    st = tcont.continue_problem(pt, maker(pt, TORCH_PKG), 0.0, 5.0, 1.0,
                                np.zeros(pt.dofmap.n_dof), NewtonOptions(**opts))
    _same_steps(sj, st)
    assert st[-1].lam == pytest.approx(5.0)
    aopts = dict(DIRECT, max_iter=12, tol_residual=1e-9)
    aj = jcont.arclength_continue(pj, maker(pj, JAX_PKG), 5.0, sj[-1].x, ds0=1.0,
                                  n_steps=25, newton_options=JOptions(**aopts),
                                  lam_scale=5.0)
    at = tcont.arclength_continue(pt, maker(pt, TORCH_PKG), 5.0, st[-1].x,
                                  ds0=1.0, n_steps=25,
                                  newton_options=NewtonOptions(**aopts),
                                  lam_scale=5.0)
    _same_steps(aj, at, lam_tol=1e-8, x_tol=1e-8)
    lams = np.array([s.lam for s in at])
    assert 6.5 < lams.max() < 7.1 and lams[-1] < lams.max() - 0.3


def test_augmenting_condition_matches_goma_tpu():
    out = []
    for pkg in (JAX_PKG, TORCH_PKG):
        cont = jcont if pkg is JAX_PKG else tcont
        Opts = JOptions if pkg is JAX_PKG else NewtonOptions
        prob = bratu(pkg, 5)
        mesh = prob.mesh
        centre = np.argmin(np.sum((mesh.coords - 0.5) ** 2, axis=1))
        dof = int(prob.dofmap.dof_of_node_svar[centre, prob.dofmap.svar("temperature")])
        ac = cont.AugmentingCondition(key="lam", g=lambda x, params: x[dof] - 0.3,
                                      p0=1.0)
        res = cont.AugmentedNewtonSolver(
            prob, [ac], Opts(max_iter=15, tol_residual=1e-10, **DIRECT)).solve(
            np.zeros(prob.dofmap.n_dof), maker(prob, pkg)(1.0))
        assert res.converged, res.res_norms
        assert abs(res.x[dof] - 0.3) < 1e-10
        out.append(res)
    rj, rt = out
    assert rt.iters == rj.iters
    assert abs(rt.p[0] - rj.p[0]) <= X_TOL * (1 + abs(rj.p[0]))
    assert _xdiff(rt.x, rj.x) <= X_TOL


def _hunt(pkg, prob, specs, ds0, bp, opts):
    cont = jcont if pkg is JAX_PKG else tcont
    Opts = JOptions if pkg is JAX_PKG else NewtonOptions
    specs = [cont.HuntSpec(*a, **k) for a, k in specs]
    return cont.hunt_problem(prob, specs, np.zeros(prob.dofmap.n_dof), ds0=ds0,
                             newton_options=Opts(**opts), base_params=bp)


def test_hunting_multi_parameter():
    pj, pt = both(bratu, 6, k_param=True)
    specs = [(("lam", 0.5, 4.0), {"ds_max": 0.7}), (("kk", 1.0, 4.0), {"log": True})]
    opts = dict(DIRECT, max_iter=12, tol_residual=1e-10)
    sj, st = (_hunt(pkg, p, specs, 0.5, maker(p, pkg, kk=1.0)(0.5), opts)
              for pkg, p in ((JAX_PKG, pj), (TORCH_PKG, pt)))
    _same_steps(sj, st)
    assert st[-1].lam == pytest.approx(1.0)
    assert np.max(np.diff(0.5 + 3.5 * np.array([s.lam for s in st]))) <= 0.7 + 1e-9


def test_hunting_and_folds():
    pj, pt = both(bratu, 5)
    opts = dict(DIRECT, max_iter=10, tol_residual=1e-10)
    sj, st = (_hunt(pkg, p, [(("lam", 0.5, 5.0), {})], 0.3, None, opts)
              for pkg, p in ((JAX_PKG, pj), (TORCH_PKG, pt)))
    _same_steps(sj, st)
    assert all(s.converged for s in st)
    aopts = dict(DIRECT, max_iter=12, tol_residual=1e-9)
    aj = jcont.arclength_continue(pj, maker(pj, JAX_PKG), 5.0, sj[-1].x, ds0=1.0,
                                  n_steps=22, newton_options=JOptions(**aopts),
                                  lam_scale=5.0)
    at = tcont.arclength_continue(pt, maker(pt, TORCH_PKG), 5.0, st[-1].x,
                                  ds0=1.0, n_steps=22,
                                  newton_options=NewtonOptions(**aopts),
                                  lam_scale=5.0)
    _same_steps(aj, at, lam_tol=1e-8, x_tol=1e-8)
    folds = tcont.detect_folds(at)
    assert folds == jcont.detect_folds(aj) and len(folds) >= 1
    assert 6.4 < at[folds[0]].lam < 7.2


def test_fold_tracking_moore_spence():
    from goma_tpu.continuation.bifurcation import fold_track as jfold
    from goma_tpu_torch.continuation.bifurcation import fold_track

    pj, pt = both(bratu, 6)
    opts = dict(DIRECT, max_iter=12, tol_residual=1e-10)
    sj = jcont.continue_problem(pj, maker(pj, JAX_PKG), 0.0, 6.0, 1.0,
                                np.zeros(pj.dofmap.n_dof), JOptions(**opts))
    st = tcont.continue_problem(pt, maker(pt, TORCH_PKG), 0.0, 6.0, 1.0,
                                np.zeros(pt.dofmap.n_dof), NewtonOptions(**opts))
    _same_steps(sj, st)
    fj = jfold(pj, maker(pj, JAX_PKG), 6.0, sj[-1].x, JOptions(**DIRECT), tol=1e-8)
    ft = fold_track(pt, maker(pt, TORCH_PKG), 6.0, st[-1].x,
                    NewtonOptions(**DIRECT), tol=1e-8)
    assert ft.converged and fj.converged, (ft.res_norms, fj.res_norms)
    assert abs(ft.lam - fj.lam) <= 1e-6 and abs(ft.lam - 6.808) <= 0.02
    assert ft.iters == fj.iters
    # the Jacobian is singular at the fold: J v ~ 0 with |v| = O(1)
    from torch.func import jvp

    Jv = jvp(lambda xx: pt.residual(xx, maker(pt, TORCH_PKG)(ft.lam)),
             (torch.as_tensor(ft.x),), (torch.as_tensor(ft.null_vector),))[1]
    assert float(Jv.abs().max()) < 1e-6 and np.linalg.norm(ft.null_vector) > 0.5


def pitchfork_deck(pkg):
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(10, 1, elem="QUAD9")

    def source(fv, mat, params):
        c = fv.val["species"]
        return params["lam"] * c - c**3

    prob = fem.Problem(mesh, [phys.Species(1, interp="Q2", transient=False,
                                           convection=False)],
                       {"diffusivity": 1.0, "species_source": source}, **cpu(pkg))
    prob.add_dirichlet("left", "species", 0, 0.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.finalize()
    return prob


def test_pitchfork_track_cubic_reaction():
    from goma_tpu.continuation.bifurcation import pitchfork_track as jpf
    from goma_tpu_torch.continuation.bifurcation import pitchfork_track

    out = []
    for pkg, fn in ((JAX_PKG, jpf), (TORCH_PKG, pitchfork_track)):
        prob = pitchfork_deck(pkg)
        psi = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0,
                                   lambda X: np.sin(np.pi * X[:, 0]))
        res = fn(prob, maker(prob, pkg), lam0=9.3, x0=np.zeros(prob.dofmap.n_dof),
                 psi=psi)
        assert res.converged, res.res_norms
        out.append(res)
    rj, rt = out
    np.testing.assert_allclose(rt.lam, np.pi**2, rtol=1e-3)
    assert abs(rt.lam - rj.lam) <= 1e-10 * rj.lam and rt.iters == rj.iters
    assert abs(rt.sigma) < 1e-8
    np.testing.assert_allclose(rt.x, 0.0, atol=1e-8)


def brusselator(pkg, a):
    mesh_m, fem, phys = pkg
    xp = _xp(pkg)

    def source(fv, mat, params):
        u = fv.val["species"][:, 0]
        v = fv.val["species"][:, 1]
        b = params["b"]
        return xp.stack([a - (b + 1.0) * u + u * u * v, b * u - u * u * v], 1)

    diff = (torch.tensor([0.02, 0.05], dtype=torch.float64) if pkg is TORCH_PKG
            else jnp.array([0.02, 0.05]))
    prob = fem.Problem(mesh_m.rectangle_mesh(3, 3, elem="QUAD4"),
                       [phys.Species(2, interp="Q1", transient=True,
                                     convection=False)],
                       {"diffusivity": diff, "species_source": source}, **cpu(pkg))
    prob.finalize()
    return prob


def test_hopf_track_brusselator():
    from goma_tpu.continuation.bifurcation import hopf_track as jhopf
    from goma_tpu_torch.continuation.bifurcation import hopf_track

    a = 1.3
    b0 = 1.0 + a * a + 0.25
    out = []
    for pkg, fn in ((JAX_PKG, jhopf), (TORCH_PKG, hopf_track)):
        prob = brusselator(pkg, a)
        x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "species", 0, a)
        x0 = prob.set_nodal_field(x0, "species", 1, b0 / a)
        res = fn(prob, maker(prob, pkg, key="b"), lam0=b0, omega0=1.15 * a,
                 x0=x0, tol=1e-9)
        assert res.converged, res.res_norms
        out.append(res)
    rj, rt = out
    np.testing.assert_allclose(rt.lam, 1.0 + a * a, rtol=1e-8)
    np.testing.assert_allclose(abs(rt.omega), a, rtol=1e-8)
    assert abs(rt.lam - rj.lam) <= 1e-8 and abs(abs(rt.omega) - abs(rj.omega)) <= 1e-8
    assert rt.iters == rj.iters


def heat_source_deck(pkg, n, nonlinear):
    """tests/test_flux_sens_particles.py's decks: -k lap T = p, T = 0 on the
    boundary; ``nonlinear``: k = p^2 + 0.5."""
    mesh_m, fem, phys = pkg
    k = (lambda fv, mat, params: params["p"] ** 2 + 0.5) if nonlinear else 1.0
    prob = fem.Problem(mesh_m.rectangle_mesh(n, n, elem="QUAD9"),
                       [phys.Energy(interp="Q2", transient=False, convection=False)],
                       {"k": k, "heat_source": lambda fv, mat, params: params["p"]},
                       **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    return prob


@pytest.mark.parametrize("nonlinear", [False, True])
def test_flux_sensitivity_matches_goma_tpu(nonlinear):
    """Both cases of tests/test_flux_sens_particles.py: the linear source
    (dF/dp = F/p exactly) and k = p^2 + 0.5 (against a central difference
    of re-solved fluxes, rtol 1e-5); the port within 1e-8 relative of
    goma_tpu, by the exact route."""
    import goma_tpu.post as jpost
    import goma_tpu.post.postproc as jpp
    import goma_tpu_torch.post as tpost
    import goma_tpu_torch.post.postproc as tpp

    n, p0 = (6, 1.3) if nonlinear else (8, 2.5)
    out = {}
    for pkg, post, pp, Opts, Solver in (
            (JAX_PKG, jpost, jpp, JOptions, JSolver),
            (TORCH_PKG, tpost, tpp, NewtonOptions, NewtonSolver)):
        prob = heat_source_deck(pkg, n, nonlinear)

        def solve_flux(pv):
            params = maker(prob, pkg, key="p")(pv)
            res = Solver(prob, Opts(max_iter=8, **DIRECT)).solve(
                np.zeros(prob.dofmap.n_dof), params)
            assert res.converged
            F = post.sideset_integral(prob, "top", post.heat_flux)
            xs = (torch.as_tensor(res.x) if pkg is TORCH_PKG
                  else jnp.asarray(res.x))
            return res, params, F, float(F(xs, params))

        res, params, F, F0 = solve_flux(p0)
        routes = dict(tconti._dR_dlam.routes)
        dF = float(pp.flux_sensitivity(prob, F, res.x, params, "p"))
        if pkg is TORCH_PKG:
            assert tconti._dR_dlam.routes["jvp"] == routes["jvp"] + 1
            assert (tconti._dR_dlam.routes["central_difference"]
                    == routes["central_difference"])
        if nonlinear:
            h = 1e-5
            Fp, Fm = solve_flux(p0 + h)[3], solve_flux(p0 - h)[3]
            np.testing.assert_allclose(dF, (Fp - Fm) / (2 * h), rtol=1e-5)
        else:
            assert abs(F0) > 1e-3
            np.testing.assert_allclose(dF, F0 / p0, rtol=1e-8)
        out[pkg is TORCH_PKG] = dF
    assert abs(out[True] - out[False]) <= 1e-8 * abs(out[False])


@pytest.mark.parametrize("deck", ["cavity", "bratu"])
def test_dR_dlam_matches_goma_tpu_jvp(deck):
    if deck == "cavity":
        pj, pt = both(lid_cavity, 4)
        key, lam = "U", 1.7
    else:
        pj, pt = both(bratu, 5)
        key, lam = "lam", 2.3
    x = np.random.default_rng(12).standard_normal(pt.dofmap.n_dof)
    dj = np.asarray(jconti._dR_dlam(pj, x, maker(pj, JAX_PKG, key=key), lam))
    routes = dict(tconti._dR_dlam.routes)
    dt = tconti._dR_dlam(pt, x, maker(pt, TORCH_PKG, key=key), lam)
    assert tconti._dR_dlam.routes["jvp"] == routes["jvp"] + 1
    assert tconti._dR_dlam.routes["central_difference"] == routes["central_difference"]
    assert np.abs(_np(dt) - dj).max() <= 1e-10 * np.abs(dj).max()
    assert np.abs(dj).max() > 0


@pytest.mark.parametrize("how", ["float", "item", "numpy"])
def test_dR_dlam_central_difference_only_when_not_traceable(how):
    """A ``make_params`` that drops the parameter's tangent (``float``,
    ``.item()``) or converts it to numpy (torch.func's no-storage error)
    takes the central difference, within 1e-6 of the exact jvp; a
    traceable one (the test above) never does."""
    pt = lid_cavity(TORCH_PKG, 4)
    conv = {"float": float, "item": lambda v: v.item() if torch.is_tensor(v) else v,
            "numpy": lambda v: np.asarray(v).item()}[how]

    def opaque(v):
        return pt.base_params(U=torch.tensor(conv(v), dtype=torch.float64))

    x = np.random.default_rng(13).standard_normal(pt.dofmap.n_dof)
    exact = _np(tconti._dR_dlam(pt, x, maker(pt, TORCH_PKG, key="U"), 1.7))
    routes = dict(tconti._dR_dlam.routes)
    cd = _np(tconti._dR_dlam(pt, x, opaque, 1.7))
    assert tconti._dR_dlam.routes["central_difference"] == routes["central_difference"] + 1
    assert tconti._dR_dlam.routes["jvp"] == routes["jvp"]
    assert np.abs(cd - exact).max() <= 1e-6 * np.abs(exact).max()


def test_cavity_lid_speed_continuation_gmres_ndlu():
    """U 1 -> 2 (Re 100 -> 200), dlam0 0.5, first order, from x = 0, on the
    main path's options; the predictor solves' linear iterations read by
    wrapping each package's predictor entry (the first solve after
    ``_dR_dlam``)."""
    kw = dict(max_iter=20, tol_residual=1e-6, linear_tol=1e-4, precond="ndlu",
              linear_solver="gmres", gmres_restart=60, linear_maxiter=240,
              ndlu_leaf_max=192, prep32_tol=3e-6)
    mp = pytest.MonkeyPatch()
    pred = {True: [], False: []}
    armed = {True: False, False: False}

    def arm(mod, torch_side):
        orig = mod._dR_dlam

        def wrapped(*a, **k):
            armed[torch_side] = True
            return orig(*a, **k)
        if torch_side:
            wrapped.routes = orig.routes
        mp.setattr(mod, "_dR_dlam", wrapped)

    def record(cls, name, torch_side):
        orig = getattr(cls, name)

        def wrapped(self, *a, **k):
            out = orig(self, *a, **k)
            if armed[torch_side]:
                armed[torch_side] = False
                pred[torch_side].append(int(out.iters))
            return out
        mp.setattr(cls, name, wrapped)

    class PallasSolver(JSolver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.precond.front_lu = "pallas"

    try:
        arm(jconti, False)
        arm(tconti, True)
        record(JSolver, "_linsolve_gmres", False)
        record(NewtonSolver, "_solve_gmres", True)
        mp.setattr(jconti, "NewtonSolver", PallasSolver)
        pj, pt = both(lid_cavity, 8)
        pj.jacobian_dtype = jnp.float32
        pt.jacobian_dtype = torch.float32
        sj = jcont.continue_problem(pj, maker(pj, JAX_PKG, key="U"), 1.0, 2.0,
                                    0.5, np.zeros(pj.dofmap.n_dof), JOptions(**kw))
        st = tcont.continue_problem(pt, maker(pt, TORCH_PKG, key="U"), 1.0, 2.0,
                                    0.5, np.zeros(pt.dofmap.n_dof),
                                    NewtonOptions(**kw))
    finally:
        mp.undo()
    assert [s.lam for s in st] == [s.lam for s in sj]
    assert [s.newton_iters for s in st] == [s.newton_iters for s in sj]
    assert pred[True] == pred[False] and len(pred[True]) == len(st) - 1
    assert _xdiff(st[-1].x, sj[-1].x) <= 1e-5
    assert st[-1].lam == 2.0
