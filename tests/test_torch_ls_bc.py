"""The level-set terms of the PyTorch port against goma_tpu: the rest of
``physics/level_set.py`` (the XFEM pressure enrichment on the
node-anchored ``fv.q_nodal``/``fv.lnodes``, the CSF variants, the solved
curvature, normal and extension velocity, the embedded flux, Dirichlet,
recoil, flow-pressure and latent-heat terms with their closures) and
goma_tpu's XFEM bubble deck, built on the CPU in float64 (the port in one
torch thread). The two decks of ``scripts/ls_decks.py`` are held in
tests/test_torch_melt_pool.py and tests/test_torch_wetting_drop.py.

Tolerances: R and the CSR values of ``assemble`` (goma_tpu's jitted one)
within 1e-12 of each array's max at seeded states; the float32 prep's
residual and element Jacobians within 1e-5 (the standing mixed-precision
allowance); the closures and the XFEM basis within 1e-13; the deck as
``test_torch_fluid_bc.decks_match``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.physics.level_set as j_ls
import goma_tpu_torch.physics.level_set as t_ls
from scripts import ls_decks as ld
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_fluid_bc import decks_match

JAX = ld.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = ld.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ----------------------------------------------------------- element cases
T_BOIL = 2500.0  # the iron fits: both cubic sets within the seeded range


def _csf_xfem(P):
    """Navier-Stokes with the XFEM pressure pair, the fill equation, the
    solved normal and curvature, every CSF variant (Hysing with dt, Denner
    with the solved normal, div n and div_s n), the recoil pressure (iron
    fit), the flow pressure (a callable) and an embedded Dirichlet on a
    velocity component; curvature boundary terms on the walls."""
    ls = P.ls
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    eqs = [P.phys.Momentum(dim=2, interp="Q2", transient=True),
           P.phys.Continuity(interp="Q1"),
           P.phys.Energy(interp="Q2", transient=True),
           ls.XFEMPressureContinuity(interp="Q1"),
           ls.XFEMPressureMomentum(dim=2),
           ls.FillEquation(interp="Q2", supg=0.5, transient=True),
           ls.SolvedNormal(dim=2, interp="Q1"),
           ls.LSCurvature(interp="Q1"),
           ls.CSFHysing(dim=2, sigma=0.7, scale=1.3),
           ls.CSFDennerDiffusion(dim=2, sigma=0.4, scale=2.0,
                                 use_solved_normal=True),
           ls.CSFDennerDiffusion(dim=2, sigma=0.3),
           ls.CSFDivN(dim=2, sigma=0.5),
           ls.CSFDivN(dim=2, sigma=0.2, surface_div=True),
           ls.LSRecoilPressure(dim=2, p_fn=ls.kanouff_recoil(
               T_BOIL, P_scale=1e-6)),
           ls.LSRecoilPressure(dim=2, p_fn=0.8, sign=-1.0),
           ls.LSFlowPressure(dim=2, p0=lambda fv, m, p: 0.3 + fv.x[:, 0]),
           ls.LSEmbeddedDirichlet("velocity", 0.2, comp=1, ncomp=2,
                                  penalty=5.0)]
    prob = P.Problem(mesh, eqs, {"rho": ls.LevelSetProperty(1.0, 0.2),
                                 "mu": ls.LevelSetProperty(1.0, 0.1),
                                 "k": 1.0, "Cp": 1.0}, **P.kw)
    for ss in ("left", "right", "top"):
        prob.add_face_kernel(ss, ls.LSCurvatureBoundary())
    prob.finalize()
    return prob


def _embedded(P):
    """The energy equation with every embedded flux: constant, QRAD with
    radiation, the vapor loss (ice fit, T_scale), the travelling laser with
    a pulse cutoff, the latent heat (with a solved velocity), and an
    embedded temperature Dirichlet with a callable value."""
    ls = P.ls
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    eqs = [P.phys.Energy(interp="Q2", transient=True),
           P.eqs.PassiveVar("velocity", 2, "Q2"),
           ls.FillEquation(interp="Q2", supg=0.0, transient=True),
           ls.LSEmbeddedFlux("temperature", 1.5),
           ls.LSEmbeddedFlux("temperature", ls.qrad_flux(
               2.0, 0.9, emiss=0.5, sigma_sb=0.1)),
           ls.LSEmbeddedFlux("temperature", ls.qvapor_flux(
               1.1, T_scale=0.01, q_scale=1e-6)),
           ls.LSEmbeddedFlux("temperature", ls.qlaser_flux(
               3.0, 0.4, (0.5, 0.5), beam_velocity=(0.2, -0.1),
               t_cutoff=0.3)),
           ls.LSLatentHeat(2.5, interp="Q2"),
           ls.LSEmbeddedDirichlet("temperature", lambda fv, m, p: fv.x[:, 1],
                                  penalty=3.0)]
    prob = P.Problem(mesh, eqs, {"rho": ls.LevelSetProperty(2.0, 0.5),
                                 "k": 1.0, "Cp": 1.0}, **P.kw)
    prob.finalize()
    return prob


def _extension(P):
    """The extension velocity with every pin (u.n, a callable with the
    fluid added and a relaxation time, the latent pin) and the fill
    equation advected by it."""
    ls = P.ls
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    eqs = [P.eqs.PassiveVar("velocity", 2, "Q2"),
           P.eqs.PassiveVar("temperature", 1, "Q2"),
           ls.FillExtV(interp="Q2"),
           ls.ExtensionVelocity(interp="Q2"),
           ls.LSExtVKinematic(interp="Q2"),
           ls.LSExtVKinematic(vnorm=lambda fv, m, p: 0.3 * fv.x[:, 1],
                              sign=-1.0, coeff=0.7, tau=0.2,
                              include_fluid=True, interp="Q2"),
           ls.LSExtVLatent(L_coeff=0.6, T_ref=0.4, dt_avg=1.5, tau=0.1,
                           interp="Q2")]
    prob = P.Problem(mesh, eqs, {}, **P.kw)
    prob.finalize()
    return prob


ELEMENT_CASES = {"csf_xfem": _csf_xfem, "embedded": _embedded,
                 "extension": _extension}


@functools.lru_cache(maxsize=None)
def _pair(case):
    """The case's problem in both packages, built once per module."""
    return ELEMENT_CASES[case](JAX), ELEMENT_CASES[case](TORCH)


def _state(prob, P, seed):
    """A seeded state: small random dofs, F a tilted line through the
    domain (so the band cuts the elements), T spread over both Kanouff
    sets, unit-ish normals; params with ct = 2, a seeded history, ls_eps
    0.4, time 0.2 and dt 0.05."""
    rng = np.random.default_rng(seed)
    n = prob.dofmap.n_dof
    x = 0.05 * rng.standard_normal(n)
    c = prob.mesh.coords
    names = {s.var for b in prob.dofmap.blocks for s in b.slots}
    x = prob.set_nodal_field(x, "fill", 0, 0.6 * (c[:, 0] - 0.45)
                             + 0.8 * (c[:, 1] - 0.55)
                             + 0.02 * rng.standard_normal(len(c)))
    if "temperature" in names:
        x = prob.set_nodal_field(x, "temperature", 0, T_BOIL + rng.uniform(
            -100.0, 400.0, len(c)) if prob.equations[0][0].var == "velocity"
            else 1.0 + 0.5 * rng.standard_normal(len(c)))
    if "ls_normal" in names:
        for k, v in enumerate((0.6, 0.8)):
            x = prob.set_nodal_field(x, "ls_normal", k, v + 0.05
                                     * rng.standard_normal(len(c)))
    params = prob.base_params()
    params["ct"] = P.arr(np.float64(2.0))
    params["hist"] = P.arr(0.05 * rng.standard_normal(n))
    for k, v in (("ls_eps", 0.4), ("time", 0.2), ("dt", 0.05)):
        params[k] = P.arr(np.float64(v))
    return x, params


def _assemble(P, prob, x, params):
    """R and CSR values; goma_tpu's jitted with dt a constant of the trace
    (``FillExtV`` tests ``if dt`` in Python)."""
    if P is JAX:
        dt = float(params["dt"])
        p = {k: v for k, v in params.items() if k != "dt"}
        return jax.jit(lambda x, p: prob._assemble(x, {**p, "dt": dt}))(
            P.arr(x), p)
    return prob.assemble(P.arr(x), params)


@pytest.mark.parametrize("case", list(ELEMENT_CASES))
def test_assembled_system_matches(case):
    """R and the CSR values at a seeded state within 1e-12 of goma_tpu's
    jitted assembly: every level-set class and closure of the slice, with
    their time, dt and property couplings."""
    out = []
    for P, prob in zip((JAX, TORCH), _pair(case)):
        x, params = _state(prob, P, 3)
        R, vals = _assemble(P, prob, x, params)
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.isfinite(Rt).all() and np.isfinite(Vt).all()
    assert np.abs(Rj).max() > 0 and np.abs(Vj).max() > 0
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


def test_float32_prep_matches():
    """The switched-precision prep (jacobian_dtype float32, the residual at
    float32 too) of the embedded terms: the residual, row sums and element
    Jacobians within 1e-5 of goma_tpu's. The laser's float64 centre
    promotes its term past the prep's dtype in both packages; it is rounded
    once into the element vector."""
    out = []
    for P, prob, dt in zip((JAX, TORCH), _pair("embedded"),
                           (jnp.float32, torch.float32)):
        x, params = _state(prob, P, 5)
        params = {k: v for k, v in params.items() if k != "dt"}
        prob.jacobian_dtype = dt
        try:
            R, rs, aux = prob._assemble_fast(P.arr(x), params, rdt=dt)
        finally:
            prob.jacobian_dtype = None
        out.append([_np(R), _np(rs), _np(aux[0][0])])
    for a, b in zip(out[1], out[0]):
        assert a.dtype == np.float32 and b.dtype == np.float32
        assert _rel(a, b) <= 1e-5


# ------------------------------------------------------------ closures
def test_kanouff_fits_and_ties():
    """``kanouff_recoil`` and ``vapor_cool`` (both fits, T_scale and the
    scales) at temperatures across both coefficient sets, and their
    forward tangents at the boiling point itself (theta = 0: the tie of
    ``jnp.maximum``, half the slope) and at the switch (theta = 170
    T_scale), within 1e-13 of goma_tpu's; ``laser_flux`` with a moving
    beam and a cutoff on either side of it."""
    T = np.array([250.0, 300.0, 310.0, 400.0, 469.9, 470.0, 470.1, 900.0])
    for T_boil, Ts in ((300.0, 1.0), (2500.0, 1.0), (3.0, 0.01)):
        Tv = T_boil + (T - 300.0) * Ts
        for name, kw in (("kanouff_recoil", {"P_scale": 2e-3}),
                         ("vapor_cool", {"q_scale": 1e-5})):
            fj = getattr(j_ls, name)(T_boil, T_scale=Ts, **kw)
            ft = getattr(t_ls, name)(T_boil, T_scale=Ts, **kw)
            vj, tj = jax.jvp(fj, (jnp.asarray(Tv),), (jnp.ones(len(Tv)),))
            vt, tt = torch.func.jvp(ft, (torch.as_tensor(Tv),),
                                    (torch.ones(len(Tv), dtype=torch.float64),))
            assert _rel(vt, vj) <= 1e-13 and _rel(tt, tj) <= 1e-13
            assert np.abs(_np(vj)).max() > 0
    x = np.random.default_rng(2).uniform(0.0, 1.0, (7, 2))
    for t in (0.1, 0.5):
        kw = dict(beam_velocity=(0.3, -0.2), absorptivity=0.7, e_concen=0.5,
                  t_cutoff=0.3)
        qj = j_ls.laser_flux(2.0, 0.25, (0.4, 0.6), **kw)(jnp.asarray(x), t)
        qt = t_ls.laser_flux(2.0, 0.25, (0.4, 0.6), **kw)(torch.as_tensor(x), t)
        assert _rel(qt, qj) <= 1e-13 if t < 0.3 else np.abs(_np(qt)).max() == 0


def test_xfem_basis_reproduces_smoothed_step():
    """goma_tpu's partition-of-unity check on the port's element fields:
    with the enrichment coefficients c and the standard pressure c H(F_i),
    the enriched plus standard pressure is c H_eps(F(x)) at the quadrature
    points; psi, its gradient and the enriched value and gradient equal
    goma_tpu's within 1e-13, and the node-anchored ``q_nodal``/``lnodes``
    are goma_tpu's."""
    from goma_tpu.fem.fields import eval_fieldvars as j_eval
    from goma_tpu_torch.fem.fields import eval_fieldvars as t_eval

    pj, pt = _pair("csf_xfem")
    bd = pt.dofmap.blocks[0]
    rng = np.random.RandomState(0)
    c, eps = 2.3, 0.2
    for le in (0, 3, 5):
        q = 0.1 * rng.randn(bd.n_ldof)
        sF, sB = bd.slot("fill"), bd.slot("pressure_xfem")
        Fn = rng.randn(sF.nbf) * 0.3
        q[sF.start:sF.start + sF.size] = Fn
        q[sB.start:sB.start + sB.size] = c
        X_e = pt.mesh.coords[pt.mesh.blocks[0].conn[le]]
        outs = []
        for ev, prob, arr, ls in ((j_eval, pj, jnp.asarray, j_ls),
                                  (t_eval, pt, torch.as_tensor, t_ls)):
            fv = ev(arr(q), arr(0.0 * q), arr(X_e), prob.tables[0],
                    prob.dofmap.blocks[0].slots, prob.dtype)
            outs.append((fv, [_np(a) for a in ls.xfem_pressure_basis(fv, eps)]))
        (fj, aj), (ft, at) = outs
        assert ft.lnodes == fj.lnodes
        for v in fj.q_nodal:
            assert np.array_equal(_np(ft.q_nodal[v]), _np(fj.q_nodal[v]))
        for a, b in zip(at, aj):
            assert _rel(a, b) <= 1e-13
        lf, lp = ft.lnodes["fill"], ft.lnodes["pressure_xfem"]
        Hn = _np(t_ls.heaviside(torch.as_tensor(Fn[[lf.index(k) for k in lp]]),
                                eps))
        p_std = _np(ft.phi["pressure"]) @ (c * Hn)
        Fq = ft.val["fill"][:, 0]
        assert np.abs(at[2] + p_std - c * _np(t_ls.heaviside(Fq, eps))).max() \
            <= 1e-12


def test_xfem_bubble_deck_matches():
    """goma_tpu's tests/test_ls_round2.py::test_xfem_static_bubble_pressure_
    jump (the enriched pressure's Laplace jump within 5% and its spurious
    currents below half the plain ones) in both packages."""
    decks_match("xfem_bubble")
