"""The fluid, thermal, species and level-set wall conditions of the PyTorch
port against goma_tpu: ``bc/fluid.py`` (slip laws, heat and mass fluxes,
the level-set slip and no-penetration gates, slip heating, the vapor and
laser fluxes, the kinematic species and latent-heat fluxes, DVZDR_ZERO,
the air film, the contact-line point forces), ``bc/surface_domain.py``
and ``bc/ls_embedded.py``, each built on the CPU in float64 (the port in
one torch thread).

Tolerances: R and the CSR values of ``assemble`` (goma_tpu's jitted one)
within 1e-12 of each array's max at seeded states; goma_tpu's tests'
decks (``scripts/ls_decks.SMALL``) on the host ``direct`` rung with the
same Newton count, the readings within 1e-10 relative and x (or R) within
1e-10 (1 + |x|); ``apply_ls_adc`` with the same numpy ``Generator`` seed
bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import ls_decks as ld
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

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
def _fluid_walls(P):
    """Navier-Stokes + energy + species + potential + fill on one block,
    every fluid-side face kernel of bc/fluid.py on its walls (slip laws
    with constant and callable wall speeds, the level-set slip and both
    no-penetration gates, the heat and mass fluxes, slip heating, vapor
    loss, the laser with incidence and vapor loss, the kinematic species
    and latent-heat fluxes, the air film both ways) and the level-set wall
    conditions of bc/ls_embedded.py; the contact-line point forces."""
    b, lse, xp = P.bc, P.lse, P.xp
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    mesh.nodesets["corner"] = np.array([0], dtype=np.int32)
    eqs = [P.phys.Momentum(dim=2, interp="Q2", transient=True),
           P.phys.Continuity(interp="Q1"),
           P.phys.Energy(interp="Q2", transient=True),
           P.phys.Species(2, interp="Q2", transient=True),
           P.phys.Potential(interp="Q2"),
           P.ls.FillEquation(interp="Q2", transient=True),
           P.ls.LSCurvature(interp="Q1")]
    prob = P.Problem(mesh, eqs, {"rho": 1.3, "mu": 0.7, "k": 1.0, "Cp": 1.0,
                                 "diffusivity": np.array([1.0, 0.5]),
                                 "kappa": 1.0}, **P.kw)
    uw = lambda s, m, p: xp.stack([0.2 + s.x[:, 0], 0.1 * s.x[:, 1]], 1)  # noqa: E731
    faces = {
        "bottom": [b.NavierSlip(2, 0.5, u_wall=uw),
                   b.NavierSlip(2, 2.0, u_wall=(0.3, 0.1),
                                tangential_only=False),
                   b.PowerLawSlip(2, 1.5, 1.7, u_wall=0.1),
                   b.PowerLawSlip(2, 0.8, 2.0, tangent=(1.0, 0.2)),
                   b.ElectrokineticSlip(2, 2.0, -0.25, beta=0.3),
                   b.SlipHeating(2, 0.9, u_wall=(0.2, 0.0)),
                   b.ConvectiveHeatFlux(3.0, 0.4),
                   b.RadiativeHeatFlux(1.5, 0.5, eps=0.3, sigB=0.2),
                   lse.LSWallAngle(70.0, penalty=5.0),
                   lse.LSWallAngle(50.0, penalty=2.0, normalize=True),
                   lse.LSCurvatureWallAngle(110.0)],
        "top": [b.LevelSetSlip(2, 1.0, 0.05, 0.3, u_wall=uw),
                b.LevelSetSlip(2, 0.5, 0.2, 0.2, tangential_only=False),
                b.LSNoPenetration(2, length=0.5, leak_angle_deg=100.0,
                                  penalty=10.0),
                b.LSNoPenetration(2, vnormal=0.3, length=0.3, shift=0.2,
                                  liquid_negative=False, tangential=True,
                                  penalty=7.0),
                b.QVaporFlux(1.0, T_scale=0.01, q_scale=1e-6),
                b.LaserWeldFlux(2.0, 0.4, (0.5, 1.0), beam_velocity=(0.1, 0.0),
                                beam_dir=(0.3, -1.0), T_boil=1.2,
                                T_scale=0.01, q_scale=1e-6),
                b.MassTransferFlux(1.2, 0.3, comp=1, ncomp=2)],
        "left": [b.SpeciesKinematicFlux(comp=0, vnormal=0.1, ncomp=2),
                 b.LatentHeatInternal(2.5),
                 b.AirFilmSlip(2, 3.0, v_s=(0.2, 0.0)),
                 lse.LSAttach(2, 0.7, penalty=3.0),
                 lse.LSAttach(2, 0.4, penalty=2.0, eps=0.3)],
        "right": [b.AirFilmSlip(2, 2.0, gas_flow=0.5,
                                rotation=(2.0, 0.5, -1.0)),
                  b.FlowPressure(2, p0=0.4),
                  P.ls.LSCurvatureBoundary()],
    }
    for ss, ks in faces.items():
        for k in ks:
            prob.add_face_kernel(ss, k)
    prob.add_point_load("corner", "velocity", b.cap_end_force((1.0, 1.0),
                                                              0.7))
    prob.add_point_load("corner", "velocity", b.contact_angle_force(
        (1.0, 0.0), (0.0, 1.0), 0.9, lambda p: 0.5))
    prob.finalize()
    return prob


def _swirl_wall(P):
    """DVZDR_ZERO on the swirl momentum of an axisymmetric annulus."""
    mesh = P.mesh.rectangle_mesh(2, 3, elem="QUAD9", xlim=(0, 1),
                                 ylim=(1, 2))
    prob = P.Problem(mesh, [P.phys.Momentum(dim=2, interp="Q2",
                                            transient=False),
                            P.phys.Continuity(interp="Q1"),
                            P.fluid.SwirlMomentum(interp="Q2")],
                     {"rho": 1.0, "mu": 1.0}, coord="swirling", **P.kw)
    prob.add_face_kernel("top", P.bc.DvzdrZero((0.0, 1.0), penalty=4.0))
    prob.add_face_kernel("left", P.bc.DvzdrZero((1.0, 0.3), penalty=2.0))
    prob.finalize()
    return prob


def _surface_domain(P):
    """The two-block strip with the surface-domain mass flux (two-sided and
    one-sided) and a Stefan-flow pair on a Navier-Stokes wall."""
    mesh, prob, _, _ = ld._strip_problem(P, 3, (1.0, 2.0), 1.7, 0.3)
    pairs = P.interface.find_interface_faces(mesh, 0, 1)
    prob.add_interface_kernel(pairs, P.sdom.SurfDomainMassFlux(
        mtc=0.6, Y_c=0.1, two_sided=False))
    prob.finalize()
    return prob


def _stefan(P):
    """SDC_STEFANFLOW (molar) and SDC_KIN_SFV (volume) with rates of the
    state on a Navier-Stokes wall."""
    xp = P.xp
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Momentum(2, interp="Q2", transient=True),
                            P.phys.Continuity(interp="Q1")],
                     {"rho": 1.4, "mu": 1.0}, **P.kw)

    def rates(sfv, mat, params):
        u = sfv.val["velocity"]
        return xp.stack([0.3 + u[:, 0] ** 2, 0.1 * u[:, 1] + sfv.x[:, 0]], 1)

    prob.add_face_kernel("bottom", P.sdom.SDCStefanFlow(2, [0.8, 1.5], rates,
                                                        penalty=20.0))
    prob.add_face_kernel("top", P.sdom.SDCStefanVolumeFlow(2, [0.2, 0.4],
                                                           rates, penalty=7.0))
    prob.finalize()
    return prob


def _distng(P):
    """DYDISTNG on the top of a conducting ALE block."""
    mesh = P.mesh.rectangle_mesh(3, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Energy(interp="Q2", transient=False,
                                          convection=False),
                            P.phys.EllipticMesh(2)],
                     {"rho": 1.0, "Cp": 1.0, "k": 1.0, "lame_mu": 1.0,
                      "lame_lambda": 1.0}, **P.kw)
    P.lse.add_distng(prob, mesh.nodesets["top"], 0.8, comp=1, dim=2)
    prob.finalize()
    return prob


ELEMENT_CASES = {"fluid_walls": _fluid_walls, "swirl_wall": _swirl_wall,
                 "surface_domain": _surface_domain, "stefan": _stefan,
                 "distng": _distng}


@functools.lru_cache(maxsize=None)
def _pair(case):
    """The case's problem in both packages, built once per module."""
    return ELEMENT_CASES[case](JAX), ELEMENT_CASES[case](TORCH)


@pytest.mark.parametrize("case", list(ELEMENT_CASES))
def test_assembled_system_matches(case):
    """R and the CSR values of ``assemble`` at a seeded state (x with a
    tilted fill line, ct = 2, a seeded history, ls_eps 0.4, time 0.3)
    within 1e-12 of goma_tpu's jitted assembly."""
    out = []
    for P, prob in zip((JAX, TORCH), _pair(case)):
        rng = np.random.default_rng(7)
        x = 0.1 * rng.standard_normal(prob.dofmap.n_dof)
        c = prob.mesh.coords
        if any(s.var == "fill" for bd in prob.dofmap.blocks for s in bd.slots):
            x = prob.set_nodal_field(x, "fill", 0, 0.5 * (c[:, 0] - 0.4)
                                     - 0.9 * (c[:, 1] - 0.6))
        params = prob.base_params()
        params["ct"] = P.arr(np.float64(2.0))
        params["hist"] = P.arr(0.1 * rng.standard_normal(prob.dofmap.n_dof))
        params["ls_eps"] = P.arr(np.float64(0.4))
        params["time"] = P.arr(np.float64(0.3))
        R, vals = prob.assemble(P.arr(x), params)
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.isfinite(Rt).all() and np.isfinite(Vt).all()
    assert np.abs(Rj).max() > 0
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


# ----------------------------------------------------------------- decks
FLUID_SMALL = ("distng_stefan", "surfdomain_mass_flux", "sdc_stefan_flow", "sdc_numjac",
               "power_law_slip", "electrokinetic_slip", "level_set_slip",
               "slip_heating", "qvapor_slab", "laser_weld",
               "latent_heat_internal", "species_kinematic", "air_film_slip")


def decks_match(deck):
    """goma_tpu's test deck ``deck`` of ``ls_decks.SMALL`` in both packages:
    its own gate in each, the same Newton count, the readings within 1e-10
    relative, x (or R) within 1e-10 (1 + |x|)."""
    oj = ld.SMALL[deck](JAX)
    ot = ld.SMALL[deck](TORCH)
    assert ot["newton"] == oj["newton"]
    r = np.asarray(oj["reading"])
    assert np.all(np.abs(np.subtract(ot["reading"], r))
                  <= 1e-10 * np.maximum(np.abs(r), 1e-300) + 1e-14)
    assert np.max(np.abs(ot["x"] - oj["x"]) / (1.0 + np.abs(oj["x"]))) <= 1e-10


@pytest.mark.parametrize("deck", FLUID_SMALL)
def test_fluid_decks_match(deck):
    """goma_tpu's tests/test_bc_catalog3.py slip, vapor, laser decks,
    test_surface_domain.py's three decks,
    test_ls_embedded_bc.py's Stefan front, test_acoustic_bc.py's latent
    heat, test_electrode_ni.py's kinematic species and test_bc_traction.py's
    air film: see ``decks_match``."""
    decks_match(deck)


def test_ls_adc_same_draws():
    """``apply_ls_adc`` (tests/test_ls_velo_bc.py::test_ls_adc_capture_and_
    gates with ``default_rng(7)``): the same capture, the same F bit for
    bit and the generator left in the same state in both packages."""
    oj = ld.SMALL["ls_adc"](JAX)
    ot = ld.SMALL["ls_adc"](TORCH)
    assert ot["reading"] == oj["reading"]
    assert np.array_equal(ot["x"], oj["x"])
