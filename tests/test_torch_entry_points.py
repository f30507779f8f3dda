"""The port's public Problem entry points and the tools built on them,
against goma_tpu on the CPU in float64 (the port in one torch thread):

- ``Problem.residual`` (the residual-only pass: the fused block without its
  Jacobian, the generic blocks and face sets without ``jacfwd``) equals
  ``Problem.assemble``'s R and the vals-free prep's R within 1e-12 of
  max |R|, and goma_tpu's ``residual`` within 1e-12, at x = 0 and at a
  seeded state, on the 8x8 cavity (fused block), the 4x4 buoyant deck
  (generic block), the 4x4 tilted cavity (fused block, rotated rows) and
  the 8x2 slot coater (face sets, ALE, a transient history);
- ``utils.numjac.numerical_jacobian_check`` (AD against central finite
  differences of ``residual``): ``ok`` with goma_tpu's entry count on
  tests/test_numjac_new_kernels.py::test_numjac_sqrtconf's deck and on the
  tilted cavity, and the same flagged entries as goma_tpu's on a deck
  whose Jacobian is deliberately wrong (a residual term AD cannot see);
- ``utils.matrix_dump``: ``dump_matrix``/``load_matrix`` round-trip the
  assembled CSR system, equal to goma_tpu's dump within 1e-12;
- ``post.stats``: ``variable_stats`` and ``format_stats`` of a seeded state
  of the buoyant deck equal goma_tpu's (dict within 1e-12, the same text);
- every name goma_tpu's package ``__init__``s export that the port has
  ported imports from the port's package of the same name.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goma_tpu.utils.numjac import numerical_jacobian_check as j_numjac
from goma_tpu_torch.utils.numjac import numerical_jacobian_check
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_bc_rows import _rel, tilted_cavity
from test_torch_host import JAX_PKG, TORCH_PKG, buoyant, cavity, cpu

RTOL = 1e-12


def _slot(pkg):
    if pkg is JAX_PKG:
        import examples.slot_coater as jsc

        prob, _, x0 = jsc.build(nx=8, ny=2)
    else:
        from test_torch_slot_coater import slot_coater

        prob, _, x0 = slot_coater(8, 2)
    return prob, x0


DECKS = {
    "cavity 8x8": lambda pkg: (cavity(pkg, 8), None),
    "buoyant 4x4": lambda pkg: (buoyant(pkg, 4), None),
    "tilted cavity 4x4": lambda pkg: (tilted_cavity(pkg, 4), None),
    "slot coater 8x2": _slot,
}


@pytest.mark.parametrize("deck", list(DECKS))
def test_residual_is_assemble_r(deck):
    (pj, x0), (pt, _) = DECKS[deck](JAX_PKG), DECKS[deck](TORCH_PKG)
    assert (0 in pt._fast_meta) == ("cavity" in deck)
    n = pt.dofmap.n_dof
    base = np.zeros(n) if x0 is None else x0
    rng = np.random.default_rng(40)
    hist = 0.1 * rng.standard_normal(n)
    ct = 2.0 if deck == "slot coater 8x2" else 0.0
    pjp = pj.base_params(ct=jnp.asarray(ct), hist=jnp.asarray(hist))
    ptp = pt.base_params(ct=torch.tensor(ct, dtype=torch.float64),
                         hist=torch.as_tensor(hist))
    for x in (base, base + 1e-2 * rng.standard_normal(n)):
        xt = torch.as_tensor(x)
        r = pt.residual(xt, ptp)
        R, _ = pt.assemble(xt, ptp)
        Rf, _, _ = pt._assemble_fast(xt, ptp)
        scale = max(float(torch.abs(R).max()), 1e-300)
        assert float(torch.abs(r - R).max()) <= RTOL * scale
        assert float(torch.abs(r - Rf).max()) <= RTOL * scale
        assert _rel(r, pj.residual(jnp.asarray(x), pjp)) <= RTOL


def _sqrtconf(pkg):
    mesh_m, fem, phys = pkg
    lam, mu_p = 0.4, 1.0
    mesh = mesh_m.rectangle_mesh(3, 3, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = fem.Problem(mesh, [
        phys.Momentum(dim=2, interp="Q2", transient=False,
                      sqrtconf_modes=((0, lam, mu_p),)),
        phys.Continuity(interp="Q1"),
        phys.SqrtConformationStress(0, lam=lam, mu_p=mu_p, model="ptt_linear",
                                    eps_ptt=0.1, interp="Q1", transient=False),
    ], {"rho": 1.0, "mu": 0.5}, **cpu(pkg))
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x = 0.05 * np.random.RandomState(3).randn(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "bconf0", 0, 1.0)
    return prob, prob.set_nodal_field(x, "bconf0", 2, 1.0)


def test_numjac_sqrtconf_and_tilted_cavity():
    """tests/test_numjac_new_kernels.py::test_numjac_sqrtconf (16 columns)
    and the tilted cavity's rotated and constraint rows (24 columns): the
    check passes in both packages over the same entries."""
    for build, cols in ((_sqrtconf, 16),
                        (lambda pkg: (tilted_cavity(pkg, 4), None), 24)):
        (pj, x), (pt, _) = build(JAX_PKG), build(TORCH_PKG)
        if x is None:
            x = 0.1 * np.random.default_rng(41).standard_normal(pt.dofmap.n_dof)
        cj = j_numjac(pj, x, pj.base_params(), n_columns=cols)
        ct = numerical_jacobian_check(pt, x, pt.base_params(), n_columns=cols)
        assert cj.ok and ct.ok, ct.report()
        assert ct.n_checked == cj.n_checked == cols * pt.dofmap.n_dof
        assert ct.worst_abs < 1e-5


def test_numjac_flags_a_jacobian_ad_cannot_see():
    """A heat source that reads T through ``detach`` (``stop_gradient`` in
    goma_tpu): AD drops its derivative, the finite differences keep it, and
    both packages flag the same entries."""
    import jax

    def deck(pkg):
        mesh_m, fem, phys = pkg
        stop = jax.lax.stop_gradient if pkg is JAX_PKG else torch.Tensor.detach
        src = lambda fv, mat, p: 3.0 * stop(fv.val["temperature"][:, 0]) ** 2  # noqa: E731
        mesh = mesh_m.rectangle_mesh(3, 3, elem="QUAD9")
        prob = fem.Problem(mesh, [phys.Energy(transient=False, convection=False)],
                           {"k": 1.0, "heat_source": src}, **cpu(pkg))
        prob.finalize()
        return prob

    pj, pt = deck(JAX_PKG), deck(TORCH_PKG)
    x = 0.5 + 0.1 * np.random.default_rng(42).standard_normal(pt.dofmap.n_dof)
    cj = j_numjac(pj, x, pj.base_params(), n_columns=6)
    ct = numerical_jacobian_check(pt, x, pt.base_params(), n_columns=6)
    assert not ct.ok and ct.n_bad == cj.n_bad > 0
    assert [e[:2] for e in ct.bad_entries] == [e[:2] for e in cj.bad_entries]
    assert "mismatches" in ct.report()


def test_dump_and_load_matrix(tmp_path):
    from goma_tpu.utils.matrix_dump import dump_matrix as j_dump
    from goma_tpu_torch.utils.matrix_dump import dump_matrix, load_matrix

    pj, pt = tilted_cavity(JAX_PKG, 4), tilted_cavity(TORCH_PKG, 4)
    x = 0.1 * np.random.default_rng(43).standard_normal(pt.dofmap.n_dof)
    path = dump_matrix(pt, x, pt.base_params(), str(tmp_path / "t.npz"))
    A, R = load_matrix(path)
    Rt, vt = pt.assemble(torch.as_tensor(x), pt.base_params())
    assert A.shape == (pt.dofmap.n_dof,) * 2
    np.testing.assert_array_equal(A.indptr, pt.pattern.indptr)
    np.testing.assert_array_equal(A.data, vt.numpy())
    np.testing.assert_array_equal(R, Rt.numpy())
    Aj, Rj = load_matrix(j_dump(pj, x, pj.base_params(), str(tmp_path / "j.npz")))
    assert _rel(A.toarray(), Aj.toarray()) <= RTOL and _rel(R, Rj) <= RTOL


def test_variable_stats_match_goma_tpu():
    from goma_tpu.post.stats import format_stats as j_format
    from goma_tpu.post.stats import variable_stats as j_stats
    from goma_tpu_torch.post import format_stats, variable_stats

    pj, pt = buoyant(JAX_PKG, 4), buoyant(TORCH_PKG, 4)
    x = np.random.default_rng(44).standard_normal(pt.dofmap.n_dof)
    sj, st = j_stats(pj, x), variable_stats(pt, torch.as_tensor(x))
    assert list(st) == list(sj) == ["velocity[0]", "velocity[1]", "pressure",
                                    "temperature", "species"]
    for k in sj:
        for q in ("min", "max", "mean", "l2"):
            assert abs(st[k][q] - sj[k][q]) <= RTOL * max(1.0, abs(sj[k][q]))
    assert format_stats(st) == j_format(sj)


EXPORTS = {
    "solvers": ["BlockJacobi", "bicgstab", "direct_solve_host", "gmres",
                "NewtonOptions", "NewtonResult", "NewtonSolver",
                "ProjectionResult", "ProjectionSolver"],
    "fem": ["Problem", "DofMap", "build_dofmap", "Equation", "FaceKernel",
            "SurfaceVars", "FieldVars", "build_pattern"],
    "mesh": ["Block", "Mesh", "SideSet", "box_mesh", "rectangle_mesh",
             "circle_block", "polyline_block"],
    "physics": ["InterfaceExchange", "OversetLM", "OversetNoSlip",
                "stress_var", "NormalModeContinuity", "NormalModeEnergy",
                "NormalModeMomentum", "NormalModeW", "CapillaryZNormal",
                "ContinuityZ", "MeshZ", "MomentumZ", "ScalarZ", "WMomentum",
                "embed_state", "zmode_equations",
                # the shell, film, porous-shell and lubrication layer
                "LubricationCurvature", "ReynoldsFilm", "ReynoldsFilmPowerLaw",
                "ShellAngle", "ShellConduction", "ShellCoordinates",
                "ShellCurvaturePair", "ShellDiffKinematic",
                "ShellDiffusionFlux", "ShellNormal", "ShellSurfCurv",
                "SurfaceCharge", "TensionedString", "attach_shell_block",
                "tie_fluid_shell", "FilmHeight", "FilmParticles",
                "FilmPressure", "ShellEnergy", "ShellSpecies",
                "LubPorousSink", "PorousShellClosed", "PorousShellGasN",
                "PorousShellOpen", "PorousShellStackLayer",
                # EM, acoustics, electrochemistry, non-Fickian species flux
                # and the scalar transport fields
                "EMAbsorbingBC", "EMAbsorbingBCH", "EMWave", "EMWaveEdge",
                "EMWaveH", "AcousticHelmholtz", "ProjectionEquation",
                "SommerfeldBC", "ButlerVolmerBC", "HORFlux", "ORRFlux",
                "Potential", "GeneralizedFickianSpecies", "HydroSpecies",
                "StefanMaxwellSpecies", "BondEvolution", "LightIntensity",
                "ResidenceTime",
                # solids and porous media
                "RealSolid", "SolidKinematics", "SolidTraction",
                "tie_mesh_to_solid", "PorousFlow", "TanhHystSaturation",
                "TwoPhasePorous", "VanGenuchten",
                # closures: suspensions, kinetics, surface chemistry, moments
                # and turbulence
                "ParticleMomentum", "QTensorHydroSpecies",
                "VorticityDirection", "flow_frame_qtensor",
                "particle_drag_force", "qtensor_from_vort_dir",
                "SATurbulentViscosity", "SpalartAllmaras", "wall_distance",
                "MomentEquations", "wheeler_n2", "ReactionNetwork",
                "SurfaceMechanism", "placid", "surface_kinetics_flux",
                # the level-set terms
                "XFEMPressureContinuity", "XFEMPressureMomentum",
                "LSEmbeddedFlux", "LSEmbeddedDirichlet", "LSRecoilPressure",
                "SolvedNormal", "ExtensionVelocity", "LSExtVKinematic",
                "LSExtVLatent", "FillExtV", "LSFlowPressure",
                "kanouff_recoil", "qrad_flux"],
    "continuation": ["ArcStep", "ContinuationStep", "arclength_continue",
                     "continue_problem", "AugmentedNewtonSolver",
                     "AugmentedResult", "AugmentingCondition",
                     "StabilityResult", "mass_and_jacobian", "solve_stability",
                     "solve_stability_3d_of_2d", "solve_stability_3d_of_2d_ale",
                     "HuntSpec", "detect_folds", "hunt_problem", "FoldResult",
                     "fold_track"],
    "post": ["variable_stats", "format_stats", "flow_rate", "heat_flux",
             "sideset_integral", "stream_function", "traction_integrand",
             "volume_integral"],
    "bc": ["CapillaryBC", "KinematicBC", "NormalFlux", "Traction",
           "EndpointAdvectiveOutflow", "EndpointFlux", "shell_end_sidesets",
           "LatentHeatFlux", "PorousMassFlux", "VNormLeak",
           "kelvin_gas_density", "FlowPressure", "CoulombFriction",
           "ElecTraction", "FlowGradV", "ForceSIC", "SlopeBC",
           # the fluid, surface-domain and level-set wall conditions
           "AirFilmSlip", "ConvectiveHeatFlux", "ElectrokineticSlip",
           "LaserWeldFlux", "LatentHeatInternal", "DvzdrZero",
           "LevelSetSlip", "LSNoPenetration", "MassTransferFlux",
           "NavierSlip", "PowerLawSlip", "QVaporFlux", "RadiativeHeatFlux",
           "SlipHeating", "SpeciesKinematicFlux", "cap_end_force",
           "contact_angle_force", "SDCStefanFlow", "SDCStefanVolumeFlow",
           "SurfDomainMassFlux"],
    "utils": ["det_and_inv"],
}


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_package_exports(pkg):
    """Each name imports from both packages' ``__init__`` (ROADMAP Queue 3:
    a deck moved from ``goma_tpu`` to ``goma_tpu_torch`` by renaming the
    package imports)."""
    jm = importlib.import_module(f"goma_tpu.{pkg}")
    tm = importlib.import_module(f"goma_tpu_torch.{pkg}")
    for name in EXPORTS[pkg]:
        assert getattr(jm, name).__name__ == getattr(tm, name).__name__ == name
