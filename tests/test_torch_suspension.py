"""Suspensions, population balances and turbulence of the PyTorch port
against goma_tpu: ``physics/suspension.py`` (the q-tensor migration flux,
the particle momentum and its drag, the solved vorticity direction and its
middle-eigenvector derivative), ``physics/population.py`` (QMOM with the
plain and the adaptive Wheeler inversion) and ``physics/turbulence.py``
(Spalart-Allmaras). Decks come from ``scripts/closure_decks.py``, written
once for both packages, built on the CPU in float64 (the port in one torch
thread).

Tolerances: R and the CSR values of ``assemble`` (goma_tpu's jitted one)
within 1e-12 of each array's max at seeded states; tangents within 1e-12
with the same NaN entries; goma_tpu's test decks on the host ``direct``
rung with the same Newton count and x within 1e-10 (1 + |x|); the 8x4
suspension channel's first three steps on bench.py's two device rungs with
the same Newton and linear counts and x within 1e-8 (1 + |x|).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.physics.population as j_pop
import goma_tpu.physics.suspension as j_susp
import goma_tpu.physics.turbulence as j_turb
import goma_tpu.solvers as j_solvers
import goma_tpu_torch.physics.population as t_pop
import goma_tpu_torch.physics.suspension as t_susp
import goma_tpu_torch.physics.turbulence as t_turb
import goma_tpu_torch.solvers as t_solvers
from scripts import closure_decks as cd
from scripts.em_decks import _project
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_overset import bench_opts

JAX = cd.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = cd.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same(a, b, tol=RTOL, finer=False):
    """The same NaN entries (with ``finer``: NaN only where goma_tpu's
    ``b`` is), and the entries finite in both within ``tol`` of their
    max."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    if finer:
        assert not (np.isnan(a) & ~np.isnan(b)).any()
    else:
        assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = np.isfinite(b) & np.isfinite(a)
    if ok.any():
        assert np.abs(a[ok] - b[ok]).max() <= tol * max(np.abs(b[ok]).max(),
                                                        1e-300)


# ----------------------------------------------------------- element cases
def _channel(P):
    return cd.suspension(P, 4, 2)[0]


def _qtensor_3d(P):
    """Momentum + Continuity + q-tensor migration + projected shear rate in
    3D (the vorticity frame of ``flow_frame_qtensor``)."""
    ph = P.phys
    mesh = P.mesh.box_mesh(2, 1, 1, elem="HEX27")
    prob = P.Problem(mesh, [
        ph.Momentum(3, interp="Q2"), ph.Continuity(interp="Q1"),
        P.susp.QTensorHydroSpecies(Kc=0.4, Kmu=0.6, interp="Q2",
                                   settling=(0.5, 0.3, (0.0, 0.0, -1.0))),
        P.acoustic.ProjectionEquation("shear_rate", 1,
                                      cd._shear_rate_source(P), interp="Q1")],
        {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.finalize()
    return prob


def _vorticity(P):
    """A projected velocity field with its solved vorticity direction."""
    xp = P.xp
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD9")
    prob = P.Problem(mesh, [
        _project(P, "velocity", lambda x: xp.stack([x[:, 1], x[:, 0]], 1), 2),
        P.susp.VorticityDirection(interp="Q2")], {}, **P.kw)
    prob.finalize()
    return prob


def _moments(P, adaptive):
    """QMOM moments advected by a projected velocity with SUPG, L-dependent
    growth and nucleation."""
    xp = P.xp
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD4")
    prob = P.Problem(mesh, [
        _project(P, "velocity", lambda x: xp.stack([1.0 + x[:, 1],
                                                    0.5 * x[:, 0]], 1), 2),
        P.pop.MomentEquations(growth=lambda L: 0.5 + 0.2 * L,
                              nucleation_rate=0.3, L0=0.4, supg=0.5,
                              adaptive=adaptive)], {}, **P.kw)
    prob.finalize()
    return prob


def _rans(P):
    return cd.rans_channel(P, 4, 2)[0]


ELEMENT_CASES = {
    "suspension_channel": _channel,
    "two_way_drag": lambda P: cd.two_way_problem(P)[0],
    "qtensor_3d": _qtensor_3d,
    "vorticity_direction": _vorticity,
    "moments_plain": lambda P: _moments(P, False),
    "moments_adaptive": lambda P: _moments(P, True),
    "rans": _rans,
}


@functools.lru_cache(maxsize=None)
def _pair(case):
    return ELEMENT_CASES[case](JAX), ELEMENT_CASES[case](TORCH)


def _state(prob, seed, unrealizable=False):
    """A seeded state with positive volume fractions and shear rates,
    realizable moment sets (two random delta peaks a node; with
    ``unrealizable`` a fifth of them made unrealizable), nu_t >= 0 and exactly 0 on some nodes; ct = 2 and a
    seeded history."""
    rng = np.random.default_rng(seed)
    n = prob.mesh.n_nodes
    x = 0.1 * rng.standard_normal(prob.dofmap.n_dof)
    fields = prob.dofmap.svar_offset
    if "species" in fields:
        x = prob.set_nodal_field(x, "species", 0, 0.25 + 0.2 * rng.random(n))
    if "shear_rate" in fields:
        x = prob.set_nodal_field(x, "shear_rate", 0, 0.5 + rng.random(n))
    if "moments" in fields:
        w = rng.random((n, 2)) + 0.1
        L = rng.random((n, 2)) * 2.0 + 0.1
        m = np.stack([(w * L**k).sum(1) for k in range(4)], 1)
        if unrealizable:
            m[::5, 2] *= 0.5  # m2 m0 < m1^2
        for k in range(4):
            x = prob.set_nodal_field(x, "moments", k, m[:, k])
    if "turb_nu" in fields:
        nut = 0.02 * rng.random(n)
        nut[::3] = 0.0
        x = prob.set_nodal_field(x, "turb_nu", 0, nut)
    return x


@pytest.mark.parametrize("case", list(ELEMENT_CASES))
def test_assembled_system_matches(case):
    """R and the CSR values of ``assemble`` at a seeded state (x, ct = 2 and
    a seeded history) within 1e-12 of goma_tpu's jitted assembly: the
    suspension channel (q-tensor Phillips flux, Krieger-Dougherty
    viscosity, projected shear rate) in 2D and 3D, the two-way particle
    drag, the solved vorticity direction (the middle eigenvector's custom
    tangent under ``vmap(jacfwd)``), the plain and the adaptive QMOM
    closures with growth, nucleation and SUPG (the adaptive one with the
    Wright correction at unrealizable points), and the RANS channel with nu_t exactly 0 on some
    nodes (the floor's and the clip's tie derivatives)."""
    out = []
    for P, prob in zip((JAX, TORCH), _pair(case)):
        x = _state(prob, 3, unrealizable=case == "moments_adaptive")
        params = prob.base_params()
        if "wall_distance" in getattr(prob, "external_fields", ()):
            params = prob.base_params(ext_wall_distance=P.arr(
                t_turb.wall_distance(prob.mesh, ["top", "bottom"])))
        params["ct"] = P.arr(np.float64(2.0))
        params["hist"] = P.arr(0.05 * np.random.default_rng(4).standard_normal(
            prob.dofmap.n_dof))
        R, vals = prob.assemble(P.arr(x), params)
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.isfinite(Rj).all() and np.isfinite(Vj).all()
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


# -------------------------------------------------- the middle eigenvector
@pytest.mark.parametrize("where", ["zero", "simple_shear", "random"])
def test_middle_eigvec_tangent(where):
    """The middle eigenvector's value and tangent (goma_tpu's custom JVP:
    perturbation theory with the gap regularised by 1e-12) equal
    goma_tpu's at E = 0 (triply degenerate: the tangent is 0, where
    ``eigh``'s own derivative is NaN), at 2D simple shear (eigenvalues
    -gd, 0, gd: the vorticity axis e_z) and at a random symmetric E; and
    its cotangent is the tangent's transpose."""
    rng = np.random.default_rng(2)
    E = {"zero": np.zeros((3, 3)),
         "simple_shear": 2.0 * np.array([[0, 1, 0], [1, 0, 0], [0, 0, 0.]]),
         "random": (lambda a: a + a.T)(rng.standard_normal((3, 3)))}[where]
    dE = (lambda a: a + a.T)(rng.standard_normal((3, 3)))
    vj, tj = jax.jvp(j_susp._middle_eigvec, (jnp.asarray(E),),
                     (jnp.asarray(dE),))
    vt, tt = torch.func.jvp(t_susp._middle_eigvec, (torch.tensor(E),),
                            (torch.tensor(dE),))
    assert np.abs(_np(vt) - _np(vj)).max() <= 1e-15
    assert np.abs(_np(tt) - _np(tj)).max() <= RTOL * max(1.0, np.abs(
        _np(tj)).max())
    if where == "zero":
        assert not np.any(_np(tt))
        plain = torch.func.jvp(lambda e: torch.linalg.eigh(e)[1][:, 1],
                               (torch.tensor(E),), (torch.tensor(dE),))[1]
        assert torch.isnan(plain).any()
    if where == "simple_shear":
        assert np.allclose(np.abs(_np(vt)), [0, 0, 1])
    g = rng.standard_normal(3)
    Et = torch.tensor(E, requires_grad=True)
    (ct,) = torch.autograd.grad(t_susp._middle_eigvec(Et) @ torch.tensor(g),
                                Et)
    assert abs(float((ct * torch.tensor(dE)).sum()) - float(g @ _np(tt))) \
        <= 1e-12 * max(1.0, abs(float(g @ _np(tt))))


def test_flow_frame_qtensor_matches():
    """tests/test_suspension.py's frame checks in both packages: Q along
    the flow and isotropic at a stagnation point (2D), the flow /
    gradient / vorticity frame of simple shear (3D)."""
    for P in (JAX, TORCH):
        fv = types.SimpleNamespace(x=P.arr(np.zeros((3, 2))), val={
            "velocity": P.arr([[2.0, 0.0], [0.0, -3.0], [0.0, 0.0]])})
        Q = _np(P.susp.flow_frame_qtensor(fv, (1.0, 0.5, 0.5)))
        assert np.allclose(Q[0], np.diag([1.0, 0.5]), atol=1e-9)
        assert np.allclose(Q[1], np.diag([0.5, 1.0]), atol=1e-9)
        assert np.allclose(Q[2], 0.75 * np.eye(2), atol=1e-9)
        gu = np.zeros((1, 3, 3))
        gu[0, 0, 1] = 1.0
        fv = types.SimpleNamespace(x=P.arr(np.zeros((1, 3))), val={
            "velocity": P.arr([[1.0, 0.0, 0.0]])}, grad={"velocity": P.arr(gu)})
        Q = _np(P.susp.flow_frame_qtensor(fv, (1.0, 0.8, 0.5)))[0]
        assert np.allclose(Q, np.diag([1.0, 0.8, 0.5]), atol=1e-9)


# ------------------------------------------------------------ population
MOMENT_EDGES = {
    "m0_zero": np.zeros(4),
    "unrealizable": np.array([1.0, 2.0, 3.0, 30.0]),
    "collapsed": np.array([2.0 * 1.5**k for k in range(4)]),
    "two_peaks": np.array([sum(w * L**k for w, L in ((0.3, 1.0), (0.7, 3.0)))
                           for k in range(4)]),
}


@pytest.mark.parametrize("edge", list(MOMENT_EDGES))
def test_adaptive_wheeler_tangent(edge):
    """``adaptive_wheeler_n2``'s weights and nodes and their Jacobians
    (``jacfwd``) at m0 = 0, at an unrealizable set (b1 < 0: the Wright
    correction), at a collapsed single node and at two peaks equal
    goma_tpu's, NaN entries included: ``torch.where``'s tangent takes the
    selected branch's only, as ``jnp.where``'s. The plain inversion the
    same where it is defined."""
    m = MOMENT_EDGES[edge]
    outs = []
    for mod, arr, jac in ((j_pop, jnp.asarray, jax.jacfwd),
                          (t_pop, torch.tensor, torch.func.jacfwd)):
        w, L, n = mod.adaptive_wheeler_n2(arr(m))
        Jw = jac(lambda v, mod=mod: mod.adaptive_wheeler_n2(v)[0])(arr(m))
        JL = jac(lambda v, mod=mod: mod.adaptive_wheeler_n2(v)[1])(arr(m))
        wp, Lp = mod.wheeler_n2(arr(m))
        outs.append([_np(a) for a in (w, L, n, Jw, JL, wp, Lp)])
    for a, b in zip(outs[1], outs[0]):
        _same(a, b)
    if edge != "m0_zero":
        assert np.isfinite(outs[1][3]).all() and np.isfinite(outs[1][4]).all()


def test_moment_source_power_zero():
    """The growth source's L_j^(k-1) at k = 0 (``population.py:186-193``):
    JAX's tangent of L**0 at L = 0 is NaN; with Lsafe = max(L, 1e-300) it
    is 0 in both packages (in float32 the port's floor is the smallest
    normal number, where goma_tpu's 1e-300 rounds to 0). The residual's
    Jacobian at a node L = 0 (moments of deltas at 0 and 2) equals
    goma_tpu's; at the zero moment set goma_tpu's is NaN everywhere (its
    quotient rule divides by m0^2 = (1e-300)^2, which underflows) and the
    port's only where it is NaN too, equal where both are finite. In
    float32 the port's inversions of the zero set are finite, goma_tpu's
    NaN."""
    ks = np.arange(4.0)
    assert np.isnan(float(jax.jvp(lambda L: L ** 0.0, (jnp.float64(0.0),),
                                  (jnp.float64(1.0),))[1]))
    tj = jax.jvp(lambda L: jnp.maximum(L, 1e-300) ** jnp.maximum(ks - 1, 0),
                 (jnp.float64(0.0),), (jnp.float64(1.0),))[1]
    for dt in (torch.float64, torch.float32):
        tt = torch.func.jvp(
            lambda L: t_pop._floor(L, t_pop._tiny(dt)) ** torch.tensor(
                np.maximum(ks - 1, 0), dtype=dt),
            (torch.tensor(0.0, dtype=dt),), (torch.tensor(1.0, dtype=dt),))[1]
        assert _np(tt)[0] == 0.0 and np.isfinite(_np(tt)).all()
    assert _np(tj)[0] == 0.0
    delta0 = np.array([0.3 + 0.7 * (k == 0) + 0.7 * 2.0**k * (k > 0)
                       for k in range(4)])
    for m, finer in ((np.stack([delta0, delta0]), False),
                     (np.zeros((2, 4)), True)):
        out = []
        for mod, arr, jac in ((j_pop, jnp.asarray, jax.jacfwd),
                              (t_pop, torch.tensor, torch.func.jacfwd)):
            eq = mod.MomentEquations(growth=lambda L: 0.5 + 0.2 * L,
                                     nucleation_rate=0.1, L0=0.5, supg=0.0,
                                     transient=False)

            def r(M, eq=eq, arr=arr):
                fv = types.SimpleNamespace(
                    x=arr(np.zeros((2, 2))), val={"moments": M},
                    grad={"moments": arr(np.zeros((2, 4, 2)))},
                    phi={"moments": arr(np.full((2, 4), 0.25))}, dim=2)
                return eq.residual(fv, {}, {})
            out.append(_np(jac(r)(arr(m))))
        _same(out[1], out[0], finer=finer)
    wj, Lj = j_pop.wheeler_n2(jnp.zeros(4, dtype=jnp.float32))
    assert np.isnan(_np(wj)).all()
    w, L = t_pop.wheeler_n2(torch.zeros(4, dtype=torch.float32))
    w2, L2, _ = t_pop.adaptive_wheeler_n2(torch.zeros(4, dtype=torch.float32))
    assert all(torch.isfinite(a).all() for a in (w, L, w2, L2))


def test_lognormal_wright_match():
    """``lognormal_moments`` and ``moment_correction_wright`` on a batch
    of sets equal goma_tpu's."""
    m = np.stack(list(MOMENT_EDGES.values())[1:])
    for i, j in ((1, 3), (2, 3), (1, 2)):
        _same(t_pop.lognormal_moments(torch.tensor(m), i, j),
              j_pop.lognormal_moments(jnp.asarray(m), i, j))
    _same(t_pop.moment_correction_wright(torch.tensor(m)),
          j_pop.moment_correction_wright(jnp.asarray(m)))


# ------------------------------------------------------------ turbulence
def test_sa_ties_at_zero():
    """Spalart-Allmaras at nu_t = 0 with no flow (S = 0): max(S~, 0.3 S)
    is a tie, clip(r, 0, 10) sits on its bound and
    ``SATurbulentViscosity``'s floor is a tie; the ported floors and clip
    take ``jnp.maximum``'s and ``jnp.clip``'s derivatives there (half to
    each side). Both Jacobians equal goma_tpu's."""
    out = []
    for mod, arr, jac in ((j_turb, jnp.asarray, jax.jacfwd),
                          (t_turb, torch.tensor, torch.func.jacfwd)):
        eq = mod.SpalartAllmaras(nu=1e-2, supg=0.0, transient=False)
        mu = mod.SATurbulentViscosity(mu=0.3)

        def fv(nut, arr=arr):
            return types.SimpleNamespace(
                x=arr(np.zeros((2, 2))), dim=2,
                val={"turb_nu": nut[:, None]},
                grad={"turb_nu": arr(np.zeros((2, 1, 2)))},
                ext={"wall_distance": arr([0.5, 0.2])},
                phi={"turb_nu": arr(np.full((2, 4), 0.25))},
                gphi={"turb_nu": arr(np.ones((2, 4, 2)))})

        nut0 = arr(np.zeros(2))
        out.append([_np(jac(lambda n: eq.residual(fv(n), {}, {}))(nut0)),
                    _np(jac(lambda n: mu(fv(n), {}, {}))(nut0))])
    for a, b in zip(out[1], out[0]):
        assert np.isfinite(a).all()
        _same(a, b)


def test_wall_distance_matches():
    """``wall_distance`` (host numpy) in 2D and 3D equals goma_tpu's."""
    for mk in (lambda m: m.rectangle_mesh(5, 3, elem="QUAD9"),
               lambda m: m.box_mesh(2, 2, 1, elem="HEX8")):
        dj = j_turb.wall_distance(mk(JAX.mesh), ["bottom", "top"])
        dt = t_turb.wall_distance(mk(TORCH.mesh), ["bottom", "top"])
        assert np.array_equal(dj, dt)


# ----------------------------------------------------------------- decks
CLOSURE_SMALL = ("particle_settling", "two_way_drag", "adaptive_closure",
                 "moments_growth", "sa_decay", "vorticity_direction", "rans")


@pytest.mark.parametrize("deck", CLOSURE_SMALL)
def test_closure_decks_match(deck):
    """goma_tpu's tests/test_suspension.py decks (settling, the two-way
    drag's numerical-Jacobian check), test_adaptive_wheeler.py's closure
    deck, test_more_physics.py's moment cascade, test_physics_breadth.py's
    SA decay (to ``closure_decks.SA_T_END``), test_solved_aux_fields.py's
    vorticity direction and the 32x16 RANS channel, each with its own
    gate, in both packages on the host ``direct`` rung (the transient ones
    under the transient driver): the same Newton count and x (or R)
    within 1e-10 (1 + |x|)."""
    oj = cd.SMALL[deck](JAX)
    ot = cd.SMALL[deck](TORCH)
    assert ot["newton"] == oj["newton"]
    assert np.max(np.abs(ot["x"] - oj["x"]) / (1.0 + np.abs(oj["x"]))) <= 1e-10


@functools.lru_cache(maxsize=None)
def _suspension_84():
    """The 8x4 suspension channel in both packages, built once for both
    rungs."""
    return cd.suspension(JAX, 8, 4), cd.suspension(TORCH, 8, 4)


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_suspension_device_rungs(kind):
    """The 8x4 suspension channel of phase 57, its first three
    backward-Euler steps (dt 1) on bench.py's two device rungs
    (``_cavity_opts(kind, tol=1e-9, max_iter=12)``) under the transient
    driver: goma_tpu's Newton count a step and ND levels, x within 1e-8
    (1 + |x|)."""
    out = []
    for P, S, (prob, x0) in zip((JAX, TORCH), (j_solvers, t_solvers),
                                _suspension_84()):
        ts = P.TransientSolver(prob, bench_opts(
            S.NewtonOptions, kind, max_iter=cd.SUSP_MAX_ITER),
            cd.suspension_time(P, 3))
        r = ts.run(x0, prob.base_params())
        nd = ts.newton.precond if kind == "gmres+ndlu" else ts.newton._ndlu
        out.append(([(s.newton_iters, s.converged) for s in r.steps],
                    [(int(lv.nn), int(lv.smax)) for lv in nd.levels],
                    np.asarray(r.x)))
    (sj, lj, xj), (st, lt, xt) = out
    assert sj == st and len(st) == 3 and all(c for _, c in st)
    assert lj == lt
    assert np.max(np.abs(xt - xj) / (1.0 + np.abs(xj))) <= 1e-8
