"""Axisymmetric and swirling coordinates, external fields, the property
models and the flux/volume post-processing of the PyTorch port against
goma_tpu, float64, at seeded states handed to both packages (numpy in,
arrays compared), the port in one torch thread.

- Each deck (the 6x4 axisymmetric die of examples/axisym_die_swirl.py;
  tests/test_axisym.py's Poiseuille pipe, Couette swirl, annulus conduction
  and elastic-mesh dilation; tests/test_axisym_ve.py's Oldroyd-B pipe;
  a cylindrical pseudo-solid ALE deck; the power-law channel of
  tests/test_more_physics.py; an Energy deck whose conductivity and source
  read an external field): the element residuals and Jacobians, the
  assembled R and the CSR values at a seeded state within 1e-11 of each
  array's max (the same integrands in the same dtype, differing in
  summation order only; readings <= 1e-15 at 4e-16 for the die), then
  Newton on the host ``direct`` rung from the deck's start: equal
  iteration counts, ||R||_2 within rel 1e-6 while above 1e-9 (both
  packages take the norms in float32, summed in another order: a reading
  of 1.2e-7 on the power-law channel; below 1e-9 both are at their
  roundoff floor), x within 1e-9 (1 + |x|).
- The die's float32 Jacobian (the main paths'): the ``tpu_direct`` prep's
  scaled CSR values within 1e-5 of goma_tpu's (test_torch_generic_assembly's
  mixed-precision tolerance: goma_tpu promotes parts of its float32
  integrands to float64; reading 3.7e-7, the unscaled values 3.2e-7).
- The 6x4 die on ``gmres+ndlu`` and ``tpu_direct`` with chip_smoke.py's
  phase 30/31 options (float32 Jacobian and NDLU factor, goma_tpu's front
  LU unpivoted as the port's): equal Newton iterations, linear iterations
  within +-1, ||R||_2 within rel 1e-2 while above 1e-6 (each inexact
  float32 step carries float32 rounding into the next residual), both
  below 1e-9 at the end, x within 1e-7 (1 + |x|).
- ``volume_integral`` and ``sideset_integral`` (r-weighted; the axis face
  has zero area because ``wdA`` takes the raw r) with ``heat_flux``,
  ``flow_rate`` and ``traction_integrand``: rel 1e-12.
- ``AxisymHoopStress`` with the Giesekus, PTT and linear-PTT closures,
  SUPG and the time derivative: element residuals and Jacobians, 1e-11
  (each variable's rows apart).
- Each property model on a seeded synthetic quadrature-point state: value
  and forward derivative with respect to the velocity gradient, rel 1e-13.
- ``stream_function`` of a seeded velocity field on a 4x4 cavity (the
  auxiliary Energy problem reads the velocity as external fields): psi
  within 1e-9 of max |psi|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.physics.materials as jmat
import goma_tpu.post.postproc as jpost
import goma_tpu_torch.physics.materials as tmat
import goma_tpu_torch.post.postproc as tpost
from goma_tpu.solvers import NewtonOptions as JOptions
from goma_tpu.solvers import NewtonSolver as JSolver
from goma_tpu.solvers import ndlu as jndlu
from goma_tpu_torch.interop import params_from_numpy
from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import JAX_PKG, TORCH_PKG, cpu
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

RTOL = 1e-11
MESH = "mesh_displacement"
# chip_smoke.py's phase 30 and 31 options
DIE_GMRES = dict(max_iter=12, tol_residual=1e-9, linear_solver="gmres",
                 precond="ndlu", linear_tol=1e-4, gmres_restart=60,
                 linear_maxiter=240, ndlu_leaf_max=192)
DIE_DIRECT = dict(max_iter=12, tol_residual=1e-9, linear_solver="tpu_direct",
                  ndlu_leaf_max=192, ndlu_refine=1)


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def die(pkg, nz=6, nr=4):
    """examples/axisym_die_swirl.py::run's deck at nz x nr: Momentum,
    SwirlMomentum, Continuity and Energy, coord="swirling", its Dirichlet
    specs in its order (the hot wall's temperature and the cold inlet's
    meet at one corner node, where the first spec wins with a warning)."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(nz, nr, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, 1.0))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = fem.Problem(
        mesh,
        [phys.Momentum(dim=2, interp="Q2", transient=False),
         phys.SwirlMomentum(interp="Q2", transient=False),
         phys.Continuity(interp="Q1"),
         phys.Energy(interp="Q2", transient=False)],
        {"rho": 1.0, "mu": 0.1, "k": 1.0, "Cp": 1.0, "body_force": (4.0, 0.0)},
        coord="swirling", **cpu(pkg))
    prob.add_dirichlet("top", "velocity", 0, 0.0)
    prob.add_dirichlet("top", "swirl", 0, 0.5)
    prob.add_dirichlet("top", "temperature", 0, 1.0)
    prob.add_dirichlet("bottom", "velocity", 1, 0.0)
    prob.add_dirichlet("bottom", "swirl", 0, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    with pytest.warns(UserWarning, match="conflict"):
        prob.finalize()
    return prob


def _ext_k(fv, mat, params):
    """A conductivity read from the external field "f" (operators only,
    so the same callable runs on jax and torch arrays)."""
    return 1.0 + 0.2 * fv.ext["f"] ** 2


def _ext_source(fv, mat, params):
    return fv.ext["f"] + 0.5 * fv.ext_grad["f"][:, 0] - fv.ext_grad["f"][:, 1]


def deck(pkg, case):
    """(Problem, initial state) of each small deck."""
    mesh_m, fem, phys = pkg
    rect = mesh_m.rectangle_mesh
    if case == "pipe":  # tests/test_axisym.py: Poiseuille pipe
        mesh = rect(4, 8, elem="QUAD9", xlim=(0, 1), ylim=(0, 1.0))
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        prob = fem.Problem(
            mesh, [phys.Momentum(dim=2, interp="Q2", transient=False),
                   phys.Continuity(interp="Q1")],
            {"rho": 1.0, "mu": 0.5, "body_force": (4.0, 0.0)},
            coord="cylindrical", **cpu(pkg))
        prob.add_dirichlet("top", "velocity", 0, 0.0)
        for ns in ("top", "bottom", "left", "right"):
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
    elif case == "couette":  # tests/test_axisym.py: circular Couette swirl
        mesh = rect(2, 24, elem="QUAD9", xlim=(0, 0.2), ylim=(1.0, 2.0))
        prob = fem.Problem(mesh, [phys.SwirlMomentum(interp="Q2",
                                                     transient=False)],
                           {"rho": 1.0, "mu": 1.0}, coord="swirling",
                           **cpu(pkg))
        prob.add_dirichlet("bottom", "swirl", 0, 3.0)
        prob.add_dirichlet("top", "swirl", 0, 0.5)
    elif case == "annulus":  # tests/test_axisym.py: annulus conduction
        mesh = rect(2, 16, elem="QUAD9", xlim=(0, 0.3), ylim=(1.0, 2.0))
        prob = fem.Problem(mesh, [phys.Energy(interp="Q2", transient=False,
                                              convection=False)],
                           {"k": 2.0}, coord="cylindrical", **cpu(pkg))
        prob.add_dirichlet("bottom", "temperature", 0, 0.0)
        prob.add_dirichlet("top", "temperature", 0, 1.0)
    elif case in ("dilation", "pseudo_solid"):
        # tests/test_axisym.py's linear-elastic dilation d_r = alpha r; the
        # pseudo-solid deck moves the same mesh under transient flow (ALE)
        mesh = rect(5, 5, elem="QUAD9", xlim=(0, 1), ylim=(0.5, 1.5))
        if case == "dilation":
            eqs = [phys.LinearElasticMesh(dim=2, interp="Q2")]
        else:
            mesh = rect(3, 3, elem="QUAD9", xlim=(0, 1), ylim=(0.5, 1.5))
            eqs = [phys.Momentum(dim=2, transient=False), phys.Continuity(),
                   phys.PseudoSolidMesh(dim=2, interp="Q2")]
        prob = fem.Problem(mesh, eqs,
                           {"rho": 0.7, "mu": 0.3, "mesh_shear_modulus": 1.0,
                            "mesh_lambda": 2.0},
                           coord="cylindrical", **cpu(pkg))
        for ns in ("left", "right", "top", "bottom"):
            prob.add_dirichlet(ns, MESH, 0, 0.0)
            prob.add_dirichlet(ns, MESH, 1, lambda X: 0.1 * X[:, 1])
        if case == "pseudo_solid":
            prob.add_dirichlet("left", "velocity", 0, 1.0)
            for ns in ("top", "bottom"):
                prob.add_dirichlet(ns, "velocity", 0, 0.0)
            for ns in ("left", "top", "bottom"):
                prob.add_dirichlet(ns, "velocity", 1, 0.0)
    elif case == "ve_pipe":  # tests/test_axisym_ve.py: Oldroyd-B pipe
        G, mu_p, lam = 4.0, 0.5, 0.2
        mesh = rect(3, 10, elem="QUAD9", xlim=(0, 1), ylim=(0, 1.0))
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        prob = fem.Problem(
            mesh,
            [phys.Momentum(dim=2, interp="Q2", transient=False,
                           convection=False, ve_stress_modes=1, devss_mu=mu_p),
             phys.Continuity(interp="Q1"),
             phys.VEStress(0, dim=2, lam=lam, mu_p=mu_p, interp="Q2",
                           transient=False, supg=0.0),
             phys.AxisymHoopStress(0, lam=lam, mu_p=mu_p, interp="Q2",
                                   transient=False, supg=0.0),
             phys.VelocityGradientProjection(dim=2, interp="Q1")],
            {"rho": 1.0, "mu": 0.5, "body_force": (G, 0.0)},
            coord="cylindrical", **cpu(pkg))
        prof = lambda c: G * (1.0 - c[:, 1] ** 2) / 4.0  # noqa: E731
        for ns in ("top", "left", "right"):
            prob.add_dirichlet(ns, "velocity", 0, prof)
        for ns in ("top", "bottom", "left", "right"):
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
    elif case == "power_law":  # tests/test_more_physics.py: power-law channel
        m_c, n_c, G, H = 1.0, 0.6, 2.0, 1.0
        mesh = rect(4, 24, elem="QUAD9", xlim=(0, 0.25), ylim=(0, H))
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        mats = jmat if pkg is JAX_PKG else tmat
        prob = fem.Problem(
            mesh, [phys.Momentum(dim=2, transient=False, convection=False),
                   phys.Continuity()],
            {"rho": 1.0, "mu": mats.PowerLawViscosity(m=m_c, n=n_c),
             "body_force": np.array([G, 0.0])}, **cpu(pkg))

        def uex(c):
            r = (n_c / (n_c + 1.0)) * (G / m_c) ** (1.0 / n_c)
            return r * ((H / 2) ** ((n_c + 1) / n_c)
                        - np.abs(c[:, 1] - H / 2) ** ((n_c + 1) / n_c))

        for ns in ("top", "bottom"):
            prob.add_dirichlet(ns, "velocity", 0, 0.0)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        for ns in ("left", "right"):
            prob.add_dirichlet(ns, "velocity", 0, uex)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
        prob.finalize()
        return prob, prob.set_nodal_field(np.zeros(prob.dofmap.n_dof),
                                          "velocity", 0, uex)
    else:  # "ext": conductivity and heat source read an external field
        mesh = rect(4, 4, elem="QUAD9", xlim=(0, 1), ylim=(0, 1))
        prob = fem.Problem(mesh, [phys.Energy(interp="Q2", transient=False,
                                              convection=False)],
                           {"k": _ext_k, "heat_source": _ext_source},
                           external_fields=("f",), **cpu(pkg))
        prob.add_dirichlet("left", "temperature", 0, 1.0)
        prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.finalize()
    return prob, np.zeros(prob.dofmap.n_dof)


def _ext_f(prob):
    """A seeded per-node external field."""
    c = prob.mesh.coords
    return np.sin(2.0 * c[:, 0]) + c[:, 1] ** 2


def _params(pj, pt, ext=None):
    """Steady-state params of both packages; with ``ext`` as the external
    field "f": goma_tpu's dict fetched to numpy and carried across
    (``params_from_numpy``), and the port's own ``base_params(ext_f=...)``
    from the same numpy array, which must agree."""
    if ext is None:
        return pj.base_params(), pt.base_params()
    pjp = pj.base_params(ext_f=jnp.asarray(ext))
    ptp = params_from_numpy({k: np.array(v) for k, v in pjp.items()
                             if k != "_tables"}, device="cpu")
    own = pt.base_params(ext_f=ext)
    assert sorted(own) == sorted(ptp)
    assert all(torch.equal(own[k], ptp[k]) for k in own)
    return pjp, ptp


def _same_newton(rt, rj, floor, norm_rtol, x_tol, lin_tol=0):
    info = (rt.summary(), rj.summary())
    assert rj.converged and rt.converged, info
    assert rt.iters == rj.iters, info
    assert len(rt.linear_iters) == len(rj.linear_iters), info
    for a, b in zip(rt.linear_iters, rj.linear_iters):
        assert abs(a - b) <= lin_tol, info
    for (_, l2t, _), (_, l2j, _) in zip(rt.res_norms, rj.res_norms):
        if l2j > floor:
            assert abs(l2t - l2j) <= norm_rtol * l2j, info
    assert np.max(np.abs(rt.x - rj.x) / (1.0 + np.abs(rj.x))) <= x_tol, info


@pytest.mark.parametrize("case", ["pipe", "couette", "annulus", "dilation",
                                  "pseudo_solid", "ve_pipe", "power_law",
                                  "ext"])
def test_axisym_deck_matches_goma_tpu(case):
    (pj, x0), (pt, _) = deck(JAX_PKG, case), deck(TORCH_PKG, case)
    assert not pt._fast_meta  # the generic AD path
    pjp, ptp = _params(pj, pt, _ext_f(pj) if case == "ext" else None)
    x = x0 + 0.1 * np.random.default_rng(7).standard_normal(x0.shape)
    if case in ("dilation", "pseudo_solid"):  # keep every element untangled
        for c in (0, 1):
            d = pj.dofmap.dof_of_node_svar[:, pj.dofmap.svar(MESH, c)]
            x[d[d >= 0]] = 0.02 * np.random.default_rng(c).standard_normal(
                int((d >= 0).sum()))
    rj, Jj = jax.jit(lambda xx, p: pj._elem_rj_parts(xx, p, pj._tables)[:2])(
        jnp.asarray(x), pjp)
    xt = torch.as_tensor(x)
    rt, Jt, _, _ = pt._elem_rj_parts(xt, ptp, pt._tables)
    assert np.isfinite(Jt[0].numpy()).all()
    assert _rel(rt[0], rj[0]) <= RTOL and _rel(Jt[0], Jj[0]) <= RTOL
    opts = dict(max_iter=20, tol_residual=1e-9, linear_solver="direct")
    sj = JSolver(pj, JOptions(**opts))
    st = NewtonSolver(pt, NewtonOptions(**opts))
    _same_newton(st.solve(x0, ptp), sj.solve(x0, pjp), floor=1e-9,
                 norm_rtol=1e-6, x_tol=1e-9)
    # each Newton prep at the seeded state (its compiled function reused):
    # R, the symmetrically row-sum-scaled CSR values and the scale
    Rj, vj, _, scj, _ = sj._prep(jnp.asarray(x), pjp, sj._ntab["ell"])
    Rt, vt, _, sct, _ = st._prepare(xt, ptp)
    for a, b, name in ((Rt, Rj, "R"), (vt, vj, "vals"), (sct, scj, "scale")):
        assert _rel(a, b) <= RTOL, name


def test_axisym_hoop_stress_models_match_goma_tpu():
    """``AxisymHoopStress`` with each closure but Oldroyd-B (the VE pipe's)
    and SUPG, transient, on goma_tpu's FD-check deck of
    tests/test_axisym_ve.py grown to three modes (Giesekus, PTT, linear
    PTT, each with its in-plane ``VEStress``): element residuals and
    Jacobians at a seeded state with ct = 3."""
    closures = (("giesekus", dict(alpha=0.3)), ("ptt", dict(eps_ptt=0.2)),
                ("ptt_linear", dict(eps_ptt=0.2)))

    def build(pkg):
        mesh_m, fem, phys = pkg
        mesh = mesh_m.rectangle_mesh(2, 3, elem="QUAD9", xlim=(0, 1),
                                     ylim=(0.2, 1.0))
        eqs = [phys.Momentum(dim=2, interp="Q2", ve_stress_modes=3),
               phys.Continuity(interp="Q1")]
        for m, (model, kw) in enumerate(closures):
            eqs += [phys.VEStress(m, dim=2, lam=0.3, mu_p=0.8, model=model,
                                  interp="Q1", **kw),
                    phys.AxisymHoopStress(m, lam=0.3, mu_p=0.8, model=model,
                                          interp="Q1", **kw)]
        prob = fem.Problem(mesh, eqs, {"rho": 1.0, "mu": 0.5},
                           coord="cylindrical", **cpu(pkg))
        prob.finalize()
        return prob

    pj, pt = build(JAX_PKG), build(TORCH_PKG)
    rng = np.random.default_rng(13)
    n = pj.dofmap.n_dof
    x, p = 0.2 * rng.standard_normal(n), {
        "ct": 3.0, "hist": rng.standard_normal(n), "time": 0.0,
        "dirichlet_val": np.asarray(pj.dirichlet_vals)}
    pjp = pj.base_params(ct=jnp.asarray(p["ct"]), hist=jnp.asarray(p["hist"]))
    rj, Jj = jax.jit(lambda xx, pp: pj._elem_rj_parts(xx, pp, pj._tables)[:2])(
        jnp.asarray(x), pjp)
    rt, Jt, _, _ = pt._elem_rj_parts(torch.as_tensor(x),
                                     params_from_numpy(p, device="cpu"),
                                     pt._tables)
    assert np.isfinite(Jt[0].numpy()).all()
    for sl in pt.dofmap.blocks[0].slots:  # each variable's rows apart
        rows = slice(sl.start, sl.start + sl.size)
        assert _rel(rt[0][:, rows], rj[0][:, rows]) <= RTOL, sl.var
        assert _rel(Jt[0][:, rows], Jj[0][:, rows]) <= RTOL, sl.var


@functools.lru_cache(maxsize=None)
def _die_pair():
    return die(JAX_PKG), die(TORCH_PKG)


def test_die_arrays_match_goma_tpu():
    """The 6x4 die in float64: element residuals and Jacobians, R and the
    CSR values (its float32 Jacobian is held in the tpu_direct case of
    ``test_die_newton_matches_goma_tpu``)."""
    pj, pt = _die_pair()
    x = np.random.default_rng(11).standard_normal(pj.dofmap.n_dof)

    @jax.jit
    def both(xx, p):
        r, J = pj._elem_rj_parts(xx, p, pj._tables)[:2]
        return r, J, pj._assemble(xx, p)

    rj, Jj, (Rj, vj) = both(jnp.asarray(x), pj.base_params())
    xt = torch.as_tensor(x)
    rt, Jt, _, _ = pt._elem_rj_parts(xt, pt.base_params(), pt._tables)
    Rt, vt = pt._assemble(xt, pt.base_params())
    for a, b, name in ((rt[0], rj[0], "r"), (Jt[0], Jj[0], "J"),
                       (Rt, Rj, "R"), (vt, vj, "vals")):
        assert _rel(a, b) <= RTOL, name


@pytest.mark.parametrize("rung", ["gmres_ndlu", "tpu_direct"])
def test_die_newton_matches_goma_tpu(rung):
    pj, pt = _die_pair()
    kw = DIE_GMRES if rung == "gmres_ndlu" else DIE_DIRECT
    pj.jacobian_dtype, pt.jacobian_dtype = jnp.float32, torch.float32
    x0 = np.zeros(pj.dofmap.n_dof)
    try:
        sj = JSolver(pj, JOptions(**kw))
        if rung == "tpu_direct":
            # goma_tpu's lazy NDLU, built as it builds it, with the
            # unpivoted front LU the port runs (test_torch_tpu_direct)
            vals = sj._prep(jnp.asarray(x0), pj.base_params(),
                            sj._ntab["ell"])[1]
            sj._ndlu = jndlu.NDLU(
                pj.pattern, leaf_max=sj.opts.ndlu_leaf_max, dtype=jnp.float32,
                front_lu="pallas",
                defer_dofs=jndlu.zero_diag_defer_mask(pj.pattern,
                                                      jax.device_get(vals)),
                clusters=jndlu.node_clusters(pj))
        else:
            sj.precond.front_lu = "pallas"
        rj = sj.solve(x0, pj.base_params())
        st = NewtonSolver(pt, NewtonOptions(**kw))
        rt = st.solve(x0, pt.base_params())
        if rung == "tpu_direct":
            # the full prep at a seeded state (goma_tpu's compiled one
            # reused): R, and the float32 CSR values the rung factors
            x = np.random.default_rng(11).standard_normal(pj.dofmap.n_dof)
            Rj, vj = sj._prep(jnp.asarray(x), pj.base_params(),
                              sj._ntab["ell"])[:2]
            Rt, vt = st._prepare(torch.as_tensor(x), pt.base_params())[:2]
            assert vt.dtype == torch.float32
            assert _rel(Rt, Rj) <= RTOL and _rel(vt, vj) <= 1e-5
    finally:
        pj.jacobian_dtype = pt.jacobian_dtype = None
    _same_newton(rt, rj, floor=1e-6, norm_rtol=1e-2, x_tol=1e-7, lin_tol=1)
    assert rt.res_norms[-1][1] < 1e-9 and rj.res_norms[-1][1] < 1e-9


def test_integrals_match_goma_tpu():
    """r-weighted volume and side-set integrals on the annulus deck (the
    per-radian volume and areas exact), and heat flux, flow rate and
    traction over the die's faces, the axis face included (zero area)."""
    (pj, _), (pt, _) = deck(JAX_PKG, "annulus"), deck(TORCH_PKG, "annulus")
    x = np.random.default_rng(3).standard_normal(pj.dofmap.n_dof)
    pjp, ptp = _params(pj, pt)
    one = lambda fv, mat, p: fv.detJ / fv.detJ  # noqa: E731
    vol = tpost.volume_integral(pt, one)(x, ptp)
    # per-radian volume of the annulus: 0.3 (R2^2 - R1^2) / 2
    assert abs(float(vol) - 0.45) <= 1e-12
    assert _rel(vol, jpost.volume_integral(pj, one)(x, pjp)) <= 1e-12
    for ss, area in (("top", 0.6), ("bottom", 0.3)):  # r L on r = 2 and 1
        assert abs(float(tpost.sideset_integral(pt, ss, one)(x, ptp))
                   - area) <= 1e-12, ss
        qj = jpost.sideset_integral(pj, ss, jpost.heat_flux)(x, pjp)
        qt = tpost.sideset_integral(pt, ss, tpost.heat_flux)(x, ptp)
        assert _rel(qt, qj) <= 1e-12, ss
    pj, pt = _die_pair()
    x = np.random.default_rng(4).standard_normal(pj.dofmap.n_dof)
    pjp, ptp = _params(pj, pt)
    for ss, fj, ft in (("top", jpost.heat_flux, tpost.heat_flux),
                       ("right", jpost.flow_rate, tpost.flow_rate),
                       ("right", jpost.traction_integrand(),
                        tpost.traction_integrand())):
        vj = jpost.sideset_integral(pj, ss, fj)(x, pjp)
        vt = tpost.sideset_integral(pt, ss, ft)(x, ptp)
        assert _rel(vt, vj) <= 1e-12, (ss, ft)
    # the axis r = 0: wdA takes the raw r, so the face has zero area
    for ft in (tpost.heat_flux, tpost.flow_rate, tpost.traction_integrand(1)):
        vt = tpost.sideset_integral(pt, "bottom", ft)(x, ptp)
        assert np.abs(vt.numpy()).max() == 0.0
    uz = lambda fv, mat, p: fv.val["velocity"][:, 0]  # noqa: E731
    assert _rel(tpost.volume_integral(pt, uz)(x, ptp),
                jpost.volume_integral(pj, uz)(x, pjp)) <= 1e-12


MODELS = {
    "PowerLawViscosity": dict(m=3.0, n=0.5),
    "CarreauViscosity": dict(mu0=10.0, mu_inf=1.0, lam=0.5, n=0.3),
    "BinghamViscosity": dict(mu0=1.0, tau_y=4.0, F=2.0),
    "CarreauWLFViscosity": dict(mu0=10.0, mu_inf=1.0, lam=0.5, n=0.3,
                                c1=10.0, c2=50.0, T_ref=350.0),
    "ArrheniusViscosity": dict(mu0=2.0, E=1000.0, T_ref=350.0),
    "SuspensionViscosity": dict(mu0=1.0, Cmax=0.68),
    "FillerDensity": dict(rho_f=1.0, rho_s=2.5),
    "BondViscosity": dict(mu0=5.0, mu_inf=0.5, aexp=1.5, tau_y=2.0,
                          fexp=1.2, atexp=3.0, wlfc2=80.0, T_ref=380.0),
}


class _FV:
    """A synthetic quadrature-point state (tests/test_more_physics.py's,
    at five seeded points): velocity gradient, temperature, species and
    bond structure."""

    def __init__(self, grad, val):
        self.grad = {"velocity": grad}
        self.val = val


@pytest.mark.parametrize("name", sorted(MODELS))
def test_property_model_matches_goma_tpu(name):
    rng = np.random.default_rng(len(name))
    G = rng.standard_normal((5, 2, 2))
    G[0] = [[0.0, 2.0], [0.0, 0.0]]  # the simple shear of test_more_physics
    vals = {"temperature": 400.0 + 20.0 * rng.standard_normal((5, 1)),
            "species": rng.uniform(0.05, 0.5, (5, 1)),
            "bond": rng.uniform(0.1, 0.9, (5, 1))}
    mj = getattr(jmat, name)(**MODELS[name])
    mt = getattr(tmat, name)(**MODELS[name])

    def fj(g):
        return mj(_FV(g, {k: jnp.asarray(v) for k, v in vals.items()}), {}, {})

    def ft(g):
        return mt(_FV(g, {k: torch.as_tensor(v) for k, v in vals.items()}),
                  {}, {})

    assert _rel(ft(torch.as_tensor(G)), fj(jnp.asarray(G))) <= 1e-13
    dj = jax.jacfwd(fj)(jnp.asarray(G))
    dt = torch.func.jacfwd(ft)(torch.as_tensor(G))
    assert np.isfinite(dt.numpy()).all()
    if name in ("ArrheniusViscosity", "SuspensionViscosity", "FillerDensity"):
        assert np.abs(np.asarray(dj)).max() == 0.0  # no shear dependence
    assert np.abs(dt.numpy() - np.asarray(dj)).max() <= 1e-13 * max(
        np.abs(np.asarray(dj)).max(), 1.0)


def test_stream_function_matches_goma_tpu():
    from test_torch_host import cavity

    pj, pt = cavity(JAX_PKG, 4), cavity(TORCH_PKG, 4)
    x = np.random.default_rng(9).standard_normal(pj.dofmap.n_dof)
    psi_j = jpost.stream_function(pj, x)
    psi_t = tpost.stream_function(pt, x)
    assert psi_t.shape == psi_j.shape
    assert np.isfinite(psi_t).all() and np.abs(psi_j).max() > 1e-3
    assert _rel(psi_t, psi_j) <= 1e-9
