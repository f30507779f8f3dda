"""Porous media of the PyTorch port against goma_tpu: ``physics/porous.py``
(van Genuchten and hysteretic saturation, Richards and two-phase flow,
the absorbing sink) and ``bc/porous_leak.py``, with the interop of the
saturation models and the hysteresis state. Each deck is built in both
packages on the CPU in float64 (the port in one torch thread) from
``scripts/solid_decks.py``, written once for both.

Tolerances: R and the CSR values of ``assemble`` (goma_tpu's jitted one)
within 1e-12 of each array's max at seeded states; the closures and their
forward-mode derivatives at the AD guards' edges within 1e-14 (the same
operations); goma_tpu's test decks on the host ``direct`` rung with the
same Newton count and x within 1e-10 (1 + |x|); the 8x8 Richards slab on
bench.py's two device rungs with the same step records and x within
1e-8 (1 + |x|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.physics.porous as j_por
import goma_tpu_torch.physics.porous as t_por
from goma_tpu_torch.interop import (materials_from_goma, params_from_numpy,
                                    porous_model_from_goma)
from scripts import solid_decks as sd
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_overset import bench_opts
from test_torch_solid import JAX, TORCH, _np, _rel, _state

RTOL = 1e-12
HYST = dict(s_max=0.95, beta_w=1.2, alpha_w=2.0, s_min=0.08, beta_d=1.0,
            alpha_d=3.0)


# ----------------------------------------------------------- element cases
def _richards_vg(P):
    """Transient unsaturated flow with gravity and the absorbing sink."""
    por = P.porous
    vg = por.VanGenuchten(alpha=1.3, n=1.8, s_res=0.1, s_sat=0.95)
    mesh = P.mesh.rectangle_mesh(2, 3, elem="QUAD9")
    prob = P.Problem(mesh, [por.PorousFlow(model=vg, interp="Q2"),
                            por.PorousSinkMass(model=vg, interp="Q2")],
                     {"permeability": 0.7, "porosity": 0.35, "mu_liquid": 1.2,
                      "rho_liquid": 1.1, "gravity_vec": (0.0, -1.0),
                      "sink_linear": (1.5, 0.6, 0.8, 0.3)}, **P.kw)
    prob.finalize()
    return prob


def _saturated(P):
    """Steady saturated Darcy flow (no model) with the sink gated on S = 1."""
    por = P.porous
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD4")
    prob = P.Problem(mesh, [por.PorousFlow(interp="Q1", transient=False),
                            por.PorousSinkMass(interp="Q1")],
                     {"permeability": 2.0, "mu_liquid": 0.5,
                      "sink_linear": (1.0, 0.5, 2.0, 0.0)}, **P.kw)
    prob.finalize()
    return prob


def _hysteretic(P):
    """Richards flow on the hysteretic tanh curves, the state (curve,
    reversal S and p_c) as external fields."""
    m = P.porous.TanhHystSaturation(**HYST, switch_threshold=0.5)
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD4")
    prob = P.Problem(mesh, [P.porous.PorousFlow(model=m, interp="Q1")],
                     {"permeability": 1e-2, "mu_liquid": 1.0,
                      "porosity": 0.3, "rho_liquid": 1.0,
                      "gravity_vec": (0.0, -2.0)},
                     external_fields=list(m.EXT_FIELDS), **P.kw)
    prob.finalize()
    return prob


def _two_phase(P, compressible):
    vg = P.porous.VanGenuchten(alpha=2.0, n=2.0, s_res=0.05)
    mesh = P.mesh.rectangle_mesh(2, 3, elem="QUAD4")
    prob = P.Problem(mesh, [P.porous.TwoPhasePorous(
        vg, transient=True, compressible=compressible)],
        {**sd.TWO_PHASE_MAT, "p_ref": 1.3}, **P.kw)
    prob.finalize()
    return prob


def _leak_faces(P):
    """Every porous/leak face kernel: POROUS_FLUX (Kelvin density with a
    temperature field, extraction), POROUS_CONV (saturated with a constant
    convection velocity, unsaturated with a callable bulk density),
    POR_LIQ_FLUX_FILL, LATENT_HEAT (constant and callable fluxes) and
    VNORM_LEAK with the VN_POROUS leak, on a fluid block that carries the
    porous pressure, the fill and the temperature."""
    xp, lk, ph = P.xp, P.leak, P.phys
    vg = P.porous.VanGenuchten(alpha=1.0, n=2.0)
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    mat = {"rho": 1.0, "mu": 1.0, "k": 1.0, "Cp": 1.0, "permeability": 0.5,
           "mu_liquid": 1.0, "porosity": 0.4, "vapor_Psat": 1.3,
           "vapor_Mw": 0.9, "gas_R": 1.1, "vapor_T": 1.2, "rho_liquid": 1.0,
           "k_over_mu": 0.7, "rho_liq": 1.2, "gravity": (0.0, -1.0),
           "solid_convection": (0.3, -0.2),
           "bulk_density": lambda s, m, p: 1.0 + s.x[:, 0]}
    prob = P.Problem(mesh, [ph.Momentum(dim=2, interp="Q2", transient=False),
                            ph.Continuity(interp="Q1"),
                            P.porous.PorousFlow(model=vg, interp="Q2"),
                            ph.Energy(interp="Q2", transient=False,
                                      convection=False),
                            P.eqs.PassiveVar("fill", 1, "Q2")], mat, **P.kw)
    prob.add_face_kernel("top", lk.PorousMassFlux(0.8, Y_c=0.1, k_m1=0.5,
                                                  p_0=-0.05))
    prob.add_face_kernel("top", lk.PorousConvection(saturated=True))
    prob.add_face_kernel("bottom", lk.PorousConvection(saturated=False))
    prob.add_face_kernel("right", lk.PorousLSWickingFlux(
        perm_c=3.0, pc1=0.4, tau=0.2, eps=0.3))
    prob.add_face_kernel("top", lk.LatentHeatFlux(
        [(2.0, 0.3), (1.5, lambda s, m, p: xp.exp(s.val["porous_pressure"][:, 0]))]))
    prob.add_face_kernel("left", lk.VNormLeak(
        dim=2, leak=lk.porous_gas_gen_leak(0.8), penalty=30.0))
    prob.add_face_kernel("bottom", lk.VNormLeak(dim=2, leak=0.1, penalty=5.0))
    prob.finalize()
    return prob


ELEMENT_CASES = {
    "richards_vg": _richards_vg,
    "saturated": _saturated,
    "hysteretic": _hysteretic,
    "two_phase": lambda P: _two_phase(P, False),
    "two_phase_compressible": lambda P: _two_phase(P, True),
    "leak_faces": _leak_faces,
}


def _hyst_state(n, seed):
    """A seeded hysteresis state: curves of both kinds, reversal points
    spanning the anchoring clamps' regions."""
    rng = np.random.default_rng(seed)
    return {"hyst_curve": (rng.random(n) > 0.5).astype(float),
            "hyst_sat_switch": rng.uniform(0.1, 0.95, n),
            "hyst_pc_switch": rng.uniform(0.0, 6.0, n)}


@functools.lru_cache(maxsize=None)
def _pair(case):
    return ELEMENT_CASES[case](JAX), ELEMENT_CASES[case](TORCH)


@pytest.mark.parametrize("case", list(ELEMENT_CASES))
def test_assembled_system_matches(case):
    """R and the CSR values of ``assemble`` at a seeded state (x, ct = 2
    and a seeded history; suctions on both sides of p = 0) within 1e-12 of
    goma_tpu's jitted assembly: Richards flow (van Genuchten, saturated,
    hysteretic with a seeded reversal state), the sink, two-phase flow
    (incompressible and compressible gas) and every porous/leak face
    kernel."""
    out = []
    for P, prob in zip((JAX, TORCH), _pair(case)):
        x, params = _state(prob, P, 7, scale=0.6)
        if case == "hysteretic":
            x = x - 2.0
            params.update({f"ext_{k}": P.arr(v) for k, v in _hyst_state(
                prob.mesh.n_nodes, 8).items()})
        R, vals = prob.assemble(P.arr(x), params)
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.isfinite(Rt).all() and np.isfinite(Vt).all()
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


# ------------------------------------------------------------ AD edges
def _jvp_both(fj, ft, *args):
    """Values and forward-mode derivatives (d/d of the first argument,
    elementwise) of the same closure in goma_tpu (``jax.jvp``) and the
    port (``torch.func.jvp``)."""
    aj = [jnp.asarray(a) for a in args]
    at = [torch.as_tensor(a) for a in args]
    vj, dj = jax.jvp(lambda p: fj(p, *aj[1:]), (aj[0],),
                     (jnp.ones_like(aj[0]),))
    vt, dt = torch.func.jvp(lambda p: ft(p, *at[1:]), (at[0],),
                            (torch.ones_like(at[0]),))
    return [np.asarray(vj), np.asarray(dj)], [_np(vt), _np(dt)]


def _same(j, t):
    for a, b in zip(t, j):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = np.isfinite(b)
        assert np.abs(a[ok] - b[ok]).max() <= 1e-14 * max(
            np.abs(b[ok]).max(), 1.0)


# the suction edges: p = 0 exactly (the where branch), tiny suctions whose
# se lands on the 1 - 1e-9 / 1 - 1e-7 clip bounds, a dry suction whose k_r
# sits on kr_min, and wet pressures
P_EDGE = np.array([0.0, -0.0, -1e-12, -1e-8, -3e-5, -1e-3, -0.4, -40.0,
                   1e-9, 0.7])


def test_van_genuchten_edges():
    """``VanGenuchten.saturation``/``krel`` and ``TwoPhasePorous._krg`` at
    the guards' edges: p = 0, suctions whose se sits on the clip bounds
    (1 - 1e-9, 1 - 1e-7, 1e-7), the kr_min floor. Values and forward-mode
    derivatives equal goma_tpu's (``torch.where``'s tangent takes only the
    selected branch's, as ``jnp.where``'s), all finite."""
    vj = j_por.VanGenuchten(alpha=2.0, n=1.6, s_res=0.05)
    vt = t_por.VanGenuchten(alpha=2.0, n=1.6, s_res=0.05)
    for name in ("saturation", "krel"):
        j, t = _jvp_both(getattr(vj, name), getattr(vt, name), P_EDGE)
        _same(j, t)
        assert all(np.isfinite(a).all() for a in t)
    tj = j_por.TwoPhasePorous(vj)
    tt = t_por.TwoPhasePorous(vt)
    j, t = _jvp_both(tj._krg, tt._krg, -P_EDGE)
    _same(j, t)
    # the dS/dp the residual nests (torch.func.grad under vmap)
    dj = np.asarray(jax.vmap(jax.grad(vj.saturation))(jnp.asarray(P_EDGE)))
    dt = _np(torch.func.vmap(torch.func.grad(vt.saturation))(
        torch.as_tensor(P_EDGE)))
    assert np.abs(dt - dj).max() <= 1e-14 * np.abs(dj).max()


def test_clip_derivative_at_bounds():
    """The port's clip is ``jnp.clip``'s form, a maximum then a minimum:
    at a bound its derivative is half, goma_tpu's; ``torch.clamp`` would
    give 1 there (the reason the port does not use it)."""
    x = np.array([1e-7, 0.5, 1.0 - 1e-9, 2.0, -1.0])
    j, t = _jvp_both(lambda a: jnp.clip(a, 1e-7, 1.0 - 1e-9),
                     lambda a: t_por._clip(a, 1e-7, 1.0 - 1e-9), x)
    _same(j, t)
    assert list(t[1]) == [0.5, 1.0, 0.5, 0.0, 0.0]
    clamp = torch.func.jvp(lambda a: torch.clamp(a, 1e-7, 1.0 - 1e-9),
                           (torch.as_tensor(x),),
                           (torch.ones(len(x), dtype=torch.float64),))[1]
    assert clamp[0] == 1.0


def test_hysteretic_curves_edges():
    """``TanhHystSaturation.saturation_pc`` and ``krel_fv`` on both curves
    at p_c on and below its 1e-5 floor, reversal points inside the
    anchoring clamps (p_c,sw ~ 0 and at 1e-5) and outside them: values and
    forward-mode derivatives (p_c and the reversal saturation) equal
    goma_tpu's and finite."""
    mj, mt = j_por.TanhHystSaturation(**HYST), t_por.TanhHystSaturation(**HYST)
    pc = np.array([1e-5, 1e-5, 0.0, 1e-7, 0.3, 2.0, 9.0, 1e-5])
    curve = np.array([1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.5, 0.49])
    ssw = np.array([0.9, 0.2, 0.5, 0.95, 0.3, 0.6, 0.4, 0.7])
    pcsw = np.array([1e-5, 0.0, 1e-12, 3.0, 0.8, 1e-5, 5.0, 2.0])
    j, t = _jvp_both(mj.saturation_pc, mt.saturation_pc, pc, curve, ssw, pcsw)
    _same(j, t)
    j, t = _jvp_both(lambda s, p, c, q: mj.saturation_pc(p, c, s, q),
                     lambda s, p, c, q: mt.saturation_pc(p, c, s, q),
                     ssw, pc, curve, pcsw)
    _same(j, t)
    assert all(np.isfinite(a).all() for a in t)

    class FV:
        pass

    for m, arr, jvp in ((mj, jnp.asarray, jax.jvp),
                        (mt, torch.as_tensor, torch.func.jvp)):
        fv = FV()
        fv.ext = {"hyst_curve": arr(curve), "hyst_sat_switch": arr(ssw),
                  "hyst_pc_switch": arr(pcsw)}
        p = arr(-pc)
        out = jvp(lambda pp: m.krel_fv(pp, fv), (p,), (p * 0 + 1,))
        (j if m is mj else t).append([np.asarray(out[0]), _np(out[1])])
    _same(j[-1], t[-1])


# ----------------------------------------------------------------- decks
@pytest.mark.parametrize("deck", list(sd.POROUS_SMALL))
def test_porous_decks_match(deck):
    """goma_tpu's tests/test_porous_sink.py, tests/test_porous_twophase.py,
    tests/test_hysteresis.py, the porous and leak decks of
    tests/test_ca_edge_porous.py and
    tests/test_lub_film_junction.py::test_porous_ls_wicking_flux, each with
    its own gate, in both packages (host ``direct``; the transient ones
    under the transient driver, the hysteretic column stepped by hand with
    ``update_state`` between steps): the same Newton count (or steps) and
    x within 1e-10 (1 + |x|)."""
    oj = sd.SMALL[deck](JAX)
    ot = sd.SMALL[deck](TORCH)
    assert ot["newton"] == oj["newton"]
    assert np.max(np.abs(ot["x"] - oj["x"]) / (1.0 + np.abs(oj["x"]))) <= 1e-10


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_richards_device_rungs(kind):
    """The Richards slab of phase 55 at 8x8 (Celia et al.'s soil, head
    -1000 cm, -75 cm on top), ``RICHARDS_STEPS`` backward-Euler steps of
    ``RICHARDS_DT`` without adaptation on bench.py's two device rungs
    (``_cavity_opts(kind, tol=1e-9, max_iter=RICHARDS_MAX_ITER)`` inside
    the transient driver): goma_tpu's step records (t, dt, Newton
    iterations), failures, ND levels and wetting front, x and the head
    down the wetted top within 1e-8 (1 + |x|)."""
    out = []
    for P in (JAX, TORCH):
        prob, x0 = sd.richards(P, 8)
        ts = P.TransientSolver(prob, bench_opts(P.NewtonOptions, kind,
                                                max_iter=sd.RICHARDS_MAX_ITER),
                               sd.richards_time(P))
        res = ts.run(x0, prob.base_params())
        nd = ts.newton.precond if kind == "gmres+ndlu" else ts.newton._ndlu
        out.append((sd.step_records(res), res.n_failures, _np(res.x),
                    [(int(lv.nn), int(lv.smax)) for lv in nd.levels],
                    sd.front_depth(prob, res.x),
                    np.asarray(sd.profile(prob, res.x))))
    (sj, fj, xj, lj, dj, pj), (st, ft, xt, lt, dt, pt) = out
    assert len(st) == sd.RICHARDS_STEPS and all(s[3] for s in st)
    assert (st, ft, lt, dt) == (sj, fj, lj, dj)
    assert np.max(np.abs(xt - xj) / (1.0 + np.abs(xj))) <= 1e-8
    assert np.max(np.abs(pt - pj) / (1.0 + np.abs(pj))) <= 1e-8


# --------------------------------------------------------------- interop
def test_porous_state_carried_across():
    """``interop``: goma_tpu's saturation models rebuilt in the port
    (``porous_model_from_goma``, by class name and attributes), its
    material arrays passed as numpy (``materials_from_goma``: gravity, a
    constant body force, the sink's tuple) and the hysteresis state carried
    as ``ext_`` fields (``params_from_numpy``): the hysteretic deck's R and
    CSR values on goma_tpu's objects and state equal the port's own within
    1e-12."""
    mj = j_por.TanhHystSaturation(**HYST, switch_threshold=0.5,
                                  draining_initial=False)
    mt = porous_model_from_goma(mj)
    assert type(mt) is t_por.TanhHystSaturation
    assert vars(mt) == vars(mj)
    vj = j_por.VanGenuchten(0.0335, 2.0, s_res=0.27, kr_min=1e-8)
    assert vars(porous_model_from_goma(vj)) == vars(vj)
    assert porous_model_from_goma(None) is None
    mat = materials_from_goma({"gravity_vec": (0, -1.0), "permeability": 2.0,
                               "solid_body_force": jnp.asarray([0.1, 0.2]),
                               "sink_linear": (1.0, 0.5, 2.0, 0.0)})
    np.testing.assert_array_equal(mat["gravity_vec"], [0.0, -1.0])
    np.testing.assert_array_equal(mat["solid_body_force"], [0.1, 0.2])
    assert mat["sink_linear"].dtype == np.float64
    with pytest.raises(NotImplementedError):
        materials_from_goma({"solid_body_force": lambda fv, m, p: 0.0})

    pj, pt = _pair("hysteretic")
    state = _hyst_state(pj.mesh.n_nodes, 9)
    x = np.random.default_rng(10).uniform(-3.0, -0.5, pj.dofmap.n_dof)
    params_j = pj.base_params(**{f"ext_{k}": jnp.asarray(v)
                                 for k, v in state.items()})
    params_t = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in params_j.items() if k != "_tables"}),
        device="cpu")
    assert {f"ext_{k}" for k in mt.EXT_FIELDS} <= set(params_t)
    Rj, Vj = pj.assemble(jnp.asarray(x), params_j)
    Rt, Vt = pt.assemble(torch.as_tensor(x), params_t)
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL
