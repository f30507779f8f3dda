"""Acoustics, the electric potential and electrode kinetics, the
non-Fickian species fluxes and the scalar transport fields of the PyTorch
port against goma_tpu: every class of ``physics/acoustic.py``,
``physics/electro.py`` and ``physics/species_flux.py``, the charged
(electromigration) term of ``Species`` and the five equations appended to
``physics/scalar_transport.py`` on small decks of their own (R and the CSR
values at a seeded state, with a seeded history and ct for the transient
terms), and goma_tpu's tests' decks of these modules on their own solvers
(tests/test_acoustic_bc.py, test_electrode_ni.py, test_species_flux.py,
test_solved_aux_fields.py, test_bc_catalog2.py, test_bc_catalog3.py,
test_bc_catalog4.py, test_bc_machinery_audit.py, test_more_physics.py,
test_physics_breadth.py, test_interface.py, test_shell_rheo.py; the decks
are ``scripts/em_decks.py``'s, written once for both packages). CPU,
float64, the port in one torch thread.

Tolerances: R and the CSR values within 1e-10 of each array's max (the
same operations summed in another order; the readings are ~1e-15); the
decks' Newton counts equal and x (or the residual a deck reads) within
1e-9 (1 + |x|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import em_decks
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)

JAX = em_decks.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = em_decks.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-10


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def system_parity(build, fields, seed=0, ct=0.0, extra=None):
    """``build(P) -> problem`` (finalized) in both packages; R and the CSR
    values of ``assemble`` at a state with each (var, comp, lo, hi) of
    ``fields`` uniform in [lo, hi] at every node, a seeded history, ``ct``
    and the ``extra`` params (name -> float)."""
    out = []
    for P in (JAX, TORCH):
        prob = build(P)
        rng = np.random.default_rng(seed)
        x = np.zeros(prob.dofmap.n_dof)
        for var, comp, lo, hi in fields:
            x = prob.set_nodal_field(
                x, var, comp, lo + (hi - lo) * rng.random(prob.mesh.n_nodes))
        hist = np.random.default_rng(seed + 1).standard_normal(prob.dofmap.n_dof)
        params = prob.base_params(**{k: P.arr(v) for k, v in
                                     (extra or {}).items()})
        params.update(ct=P.arr(ct), hist=P.arr(hist))
        R, vals = prob.assemble(P.arr(x), params)  # goma_tpu's jit
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.abs(Rj).max() > 0 and np.abs(Vj).max() > 0
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL, (_rel(Rt, Rj),
                                                            _rel(Vt, Vj))


def _mesh(P, nx=3, ny=2, elem="QUAD9"):
    """A rectangle whose interior nodes are moved off the affine map."""
    mesh = P.mesh.rectangle_mesh(nx, ny, elem=elem)
    c = mesh.coords
    c[:, 0] += 0.03 * np.sin(np.pi * c[:, 0]) * np.sin(2.0 * c[:, 1] + 0.4)
    c[:, 1] += 0.02 * np.sin(np.pi * c[:, 1]) * np.cos(3.0 * c[:, 0])
    return mesh


def _passive_u(P, interp="Q2"):
    return P.eqs.PassiveVar("velocity", 2, interp)


# ----------------------------------------------------------- acoustics
def _acoustic(P):
    ac = P.acoustic
    prob = P.Problem(_mesh(P), [ac.AcousticHelmholtz("real", 2.5),
                                ac.AcousticHelmholtz("imag", 2.5)], {}, **P.kw)
    for part in ("real", "imag"):
        prob.add_face_kernel("right", ac.SommerfeldBC(part, 2.5))
        prob.add_face_kernel("left", ac.AcousticVelocityBC(
            part, lambda sfv, mat, params: 0.3 + sfv.x[:, 1] ** 2))
        prob.add_face_kernel("top", ac.AcousticVelocityBC(part, 0.2))
    prob.finalize()
    return prob


def _projection(P):
    xp = P.xp

    def src(fv, mat, params):
        return xp.stack([xp.sin(fv.x[:, 0]) * fv.val["species"][:, 0],
                         xp.cos(fv.x[:, 1])], 1)

    prob = P.Problem(_mesh(P), [
        P.acoustic.ProjectionEquation("gd", 2, src, interp="Q1"),
        P.phys.Species(1, interp="Q2", transient=False, convection=False)],
        {}, **P.kw)
    prob.finalize()
    return prob


def _radiation(P):
    ac, ls = P.acoustic, P.level_set
    prob = P.Problem(_mesh(P, 4, 2), [
        P.phys.Momentum(dim=2, interp="Q2", transient=False),
        P.phys.Continuity(interp="Q1"),
        ls.FillEquation(interp="Q2", supg=0.0, transient=False),
        ac.AcousticHelmholtz("real", 1.0), ac.AcousticHelmholtz("imag", 1.0),
        ac.LSAcousticRadiation(dim=2, omega=3.0, ars_jump=0.8,
                               grad_jump=0.6)],
        {"rho": 1.0, "mu": 1.0, "acoustic_k": 1.7, "acoustic_R": 0.9}, **P.kw)
    prob.finalize()
    return prob


# ----------------------------------------------------- electrochemistry
def _potential(P):
    el = P.electro
    mat = {"kappa": lambda fv, mat, params:
           1.0 + 0.3 * fv.val["voltage"][:, 0] ** 2,
           "current_source": lambda fv, mat, params: P.xp.sin(fv.x[:, 0]),
           "permittivity": 1.7}
    prob = P.Problem(_mesh(P), [el.Potential(interp="Q2")], mat, **P.kw)
    prob.add_face_kernel("right", el.ButlerVolmerBC(2.0, 0.5, 0.4, 0.01))
    prob.add_face_kernel("top", el.CurrentSIC(
        lambda sfv, mat, params: 0.2 * sfv.x[:, 0], penalty=10.0))
    prob.add_face_kernel("bottom", el.CurrentSIC(0.3, perm=1.1, penalty=5.0))
    prob.finalize()
    return prob


def _kinetics(P):
    el = P.electro
    prob = P.Problem(_mesh(P), [
        P.phys.Species(3, interp="Q2", transient=False, convection=False),
        el.Potential(interp="Q1")], {"diffusivity": 0.5}, **P.kw)
    prob.add_face_kernel("left", el.HORFlux(
        1.2, 0.8, 2.0, 0.5, 0.5, 0.01, 0.5, 0.4, 0.02, comp=0, ncomp=3))
    prob.add_face_kernel("right", el.ORRFlux(
        1.1, 0.9, 4.0, 0.5, 0.02, 1.0, 0.4, 0.03, comp=1, ncomp=3))
    prob.add_face_kernel("top", el.HORFlux(
        0.7, 0.6, 2.0, 0.4, 0.6, 0.0, 1.0, 0.5, 0.01, comp=2, ncomp=3))
    prob.finalize()
    return prob


def _nickel(P):
    el = P.electro
    ct = lambda sfv, mat, params: 50.0 + 5.0 * sfv.x[:, 1]  # noqa: E731
    prob = P.Problem(_mesh(P), [
        P.phys.Species(5, interp="Q2", transient=False, convection=False),
        el.Potential(interp="Q2")], {"diffusivity": 0.1}, **P.kw)
    for mode in (0, 2, 3, 4):
        prob.add_face_kernel("right", el.NickelPlatingFlux(
            mode=mode, PHI_E=-0.3, T=298.15, c_total=ct, ncomp=5))
    prob.add_face_kernel("right", el.NickelPlatingFlux(
        mode="current", PHI_E=-0.3, T=298.15, c_total=55.0, ncomp=5))
    prob.finalize()
    return prob


def _alloy_pem(P):
    el = P.electro
    prob = P.Problem(_mesh(P), [
        P.phys.Species(2, interp="Q2", transient=False, convection=False),
        P.phys.Energy(interp="Q2", transient=False, convection=False),
        el.Potential(interp="Q1")],
        {"diffusivity": 0.4, "rho": 1.0, "Cp": 1.0, "k": 1.0}, **P.kw)
    prob.add_face_kernel("top", el.AlloyEvapFlux(1.0, -2.0, 1.3, 0.4, 0.05,
                                                 0.1, comp=1, ncomp=2))
    prob.add_face_kernel("right", el.PEMWaterFlux(
        "anode", 1.2e3, 1e-3, 4e-5, 0.5, 0.5, 353.0, 0.0, 1.2, comp=0,
        ncomp=2))
    prob.add_face_kernel("left", el.PEMWaterFlux(
        "cathode", 1.2e3, 1e-3, 4e-5, 0.5, 0.5, 353.0, 0.0, 1.2, V=0.7,
        comp=1, ncomp=2))
    prob.finalize()
    return prob


def _charged(P):
    prob = P.Problem(_mesh(P), [
        P.phys.Species(2, interp="Q2", transient=True, convection=False),
        P.electro.Potential(interp="Q2")],
        {"diffusivity": 0.5, "charge": (1.0, -2.0),
         "mobility": (0.01, 0.02)}, **P.kw)
    prob.add_face_kernel("right", P.flux.ChargedSurfaceGradient(
        value=0.01, z=2.0, comp=1, ncomp=2, penalty=1e3))
    prob.finalize()
    return prob


def _surface_constraint(P):
    prob = P.Problem(_mesh(P), [P.phys.Species(
        2, interp="Q2", transient=False, convection=False)],
        {"diffusivity": 1.0}, **P.kw)
    prob.add_point_constraint("right", "species", 1,
                              P.electro.surface_charge_constraint(
                                  (1.0, -2.0), 0.05, 1))
    prob.finalize()
    return prob


# --------------------------------------------------- species flux models
_SM3 = [[0.0, 1.0, 2.0], [1.0, 0.0, 0.5], [2.0, 0.5, 0.0]]


def _stefan_maxwell(P):
    xp = P.xp
    prob = P.Problem(_mesh(P), [
        P.flux.StefanMaxwellSpecies(2, D=_SM3, c_total=1.5, interp="Q2"),
        _passive_u(P)],
        {"species_source": lambda fv, mat, params: xp.stack(
            [xp.sin(fv.x[:, 0]), fv.val["species"][:, 0] ** 2], 1)}, **P.kw)
    prob.finalize()
    return prob


def _generalized_fickian(P):
    prob = P.Problem(_mesh(P), [
        P.flux.GeneralizedFickianSpecies(2, D=[[1.0, 0.3], [0.1, 0.5]],
                                         interp="Q2"), _passive_u(P)],
        {"species_source": (0.2, -0.1)}, **P.kw)
    prob.finalize()
    return prob


def _hydro(P):
    hydro = P.flux.HydroSpecies(Kc=0.41, Kmu=0.62, a_rad=0.8, mu0=1.3,
                                settling=(0.5, 0.3, (0.0, -1.0)),
                                interp="Q2")
    prob = P.Problem(_mesh(P), [
        hydro, P.eqs.PassiveVar("shear_rate", 1, "Q1"), _passive_u(P)], {},
        **P.kw)
    prob.add_face_kernel("right", P.flux.SuspensionFlux(hydro, rho=1.3))
    prob.finalize()
    return prob


def _koh(P):
    prob = P.Problem(_mesh(P), [P.phys.Species(
        4, interp="Q2", transient=False, convection=False)],
        {"diffusivity": 1.0}, **P.kw)
    for comp in range(4):
        prob.add_face_kernel("right", P.flux.KOHSiEtchFlux(comp, 353.0))
    prob.finalize()
    return prob


# ------------------------------------------------ scalar transport fields
def _scalar_fields(P):
    sc = P.scalar
    prob = P.Problem(_mesh(P), [
        _passive_u(P),
        sc.ResidenceTime(interp="Q2", D=0.1, supg=0.5, transient=True),
        sc.LightIntensity(direction=(1.0, 0.5), beta=1.5, var="light_intp",
                          interp="Q2", supg=0.2),
        sc.LightIntensity(direction=(-1.0, 0.0), beta=0.7, var="light_intm",
                          interp="Q1", supg=0.0),
        sc.BondEvolution(1.5, 0.8, 1.0, aexp=1.2, bexp=0.7, diff=0.05,
                         interp="Q2"),
        sc.ShearRateProjection(interp="Q1")], {}, **P.kw)
    prob.finalize()
    return prob


def _fresnel(P):
    """Two blocks of a 4x2 QUAD9 mesh (x < 0.5 and x > 0.5) with
    refractive indices 1.5 and 1.0, both light directions, the Fresnel
    jump on the shared faces."""
    import importlib

    mi = importlib.import_module(f"{P.pkg}.mesh.interface")
    mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD9")
    conn = mesh.blocks[0].conn
    left = mesh.coords[conn].mean(axis=1)[:, 0] < 0.5
    mesh.blocks = [P.mesh.Block("A", "QUAD9", conn[left]),
                   P.mesh.Block("B", "QUAD9", conn[~left])]
    sc = P.scalar

    def eqs():
        return [sc.LightIntensity((1.0, 0.0), 1.2, var="light_intp"),
                sc.LightIntensity((-1.0, 0.0), 0.8, var="light_intm")]

    prob = P.Problem(mesh, [eqs(), eqs()], [{"refindex": 1.5},
                                            {"refindex": 1.0}], **P.kw)
    pairs = mi.find_interface_faces(mesh, 0, 1)
    prob.add_interface_kernel(pairs, sc.LightFresnelJump(penalty=50.0))
    prob.add_interface_kernel(pairs, sc.LightFresnelJump(
        var="light_intm", other_var="light_intp", penalty=20.0))
    prob.finalize()
    return prob


SYSTEMS = {
    "acoustic_faces": (_acoustic, [("acoustic_preal", 0, -1, 1),
                                   ("acoustic_pimag", 0, -1, 1)], {}),
    "projection": (_projection, [("gd", 0, -1, 1), ("gd", 1, -1, 1),
                                 ("species", 0, 0, 1)], {}),
    "ls_acoustic_radiation": (_radiation, [
        ("velocity", 0, -1, 1), ("velocity", 1, -1, 1), ("pressure", 0, -1, 1),
        ("fill", 0, -0.3, 0.3), ("acoustic_preal", 0, -1, 1),
        ("acoustic_pimag", 0, -1, 1)], {"ls_eps": 0.2}),
    "potential_faces": (_potential, [("voltage", 0, -0.02, 0.02)], {}),
    "hor_orr": (_kinetics, [("species", 0, 0.1, 1), ("species", 1, 0.1, 1),
                            ("species", 2, 0.1, 1),
                            ("voltage", 0, -0.05, 0.05)], {}),
    "nickel_plating": (_nickel, [("species", c, 1e-4, 0.05) for c in range(5)]
                       + [("voltage", 0, -0.05, 0.05)], {}),
    "alloy_pem": (_alloy_pem, [("species", 0, 1e-5, 4e-5),
                               ("species", 1, 1e-5, 4e-5),
                               ("temperature", 0, 1.0, 1.6),
                               ("voltage", 0, 0.0, 0.2)], {}),
    "charged_species": (_charged, [("species", 0, 0.1, 1),
                                   ("species", 1, 0.1, 1),
                                   ("voltage", 0, -1, 1)], {}),
    "surface_charge_constraint": (_surface_constraint, [
        ("species", 0, 0, 1), ("species", 1, 0, 1)], {}),
    "stefan_maxwell": (_stefan_maxwell, [
        ("species", 0, 0.2, 0.4), ("species", 1, 0.2, 0.4),
        ("velocity", 0, -1, 1), ("velocity", 1, -1, 1)], {}),
    "generalized_fickian": (_generalized_fickian, [
        ("species", 0, 0, 1), ("species", 1, 0, 1), ("velocity", 0, -1, 1),
        ("velocity", 1, -1, 1)], {}),
    "hydro_suspension": (_hydro, [("species", 0, 0.1, 0.6),
                                  ("shear_rate", 0, 0.5, 2.0),
                                  ("velocity", 0, -1, 1),
                                  ("velocity", 1, -1, 1)], {}),
    "koh_etch": (_koh, [("species", 0, 0.8, 1.0), ("species", 1, 5e-7, 2e-4),
                        ("species", 2, 0, 1e-4), ("species", 3, 0, 1e-4)], {}),
    "scalar_fields": (_scalar_fields, [
        ("velocity", 0, -1, 1), ("velocity", 1, -1, 1), ("restime", 0, 0, 2),
        ("light_intp", 0, 0, 3), ("light_intm", 0, 0, 3), ("bond", 0, -0.1, 1),
        ("shear_rate_proj", 0, 0, 2)], {}),
    "fresnel_jump": (_fresnel, [("light_intp", 0, 0, 3),
                                ("light_intm", 0, 0, 3)], {}),
}


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_electro_systems_match(system):
    """Every class of the slice's acoustic, electrochemical, species-flux
    and scalar-transport modules on a small deck of its own (callable and
    constant material keys, face kernels on their sides, the
    level-set radiation force with its gradient jump, the charged-species
    term, the Stefan-Maxwell pointwise solve and the Phillips flux's
    ``grad`` inside the element Jacobian, the Fresnel interface jump): R
    and the CSR values at a seeded state, history and ct = 1.3 within
    1e-10 of goma_tpu's."""
    build, fields, extra = SYSTEMS[system]
    system_parity(build, fields, seed=13, ct=1.3, extra=extra)


@pytest.mark.parametrize("deck", list(em_decks.ELECTRO_SMALL))
def test_electro_decks_match(deck):
    """goma_tpu's tests' decks of the slice (``em_decks.ELECTRO_SMALL``),
    each with its own gate, in both packages on their own solvers: the
    same Newton count and the solution (or the residual, the closure or the
    pointwise fluxes a deck reads) within 1e-9 (1 + |x|)."""
    oj = em_decks.SMALL[deck](JAX)
    ot = em_decks.SMALL[deck](TORCH)
    assert ot["newton"] == oj["newton"]
    assert ot["x"].shape == oj["x"].shape
    assert np.max(np.abs(ot["x"] - oj["x"]) / (1.0 + np.abs(oj["x"]))) <= 1e-9
