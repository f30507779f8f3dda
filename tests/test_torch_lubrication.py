"""The lubrication, thin-film and porous-shell layers of the PyTorch port
against goma_tpu: ``physics/lubrication.py``, ``physics/shell_film.py`` and
``physics/shell_porous.py`` (every equation class, face kernel, junction
tie and material model) and the 8x8 drying film on both device rungs, each
deck built in both packages on the CPU in float64 (the port in one torch
thread). Decks and material callables are written once for both packages
(``scripts/shell_decks.py``'s namespaces).

The integrands differentiate inside the element Jacobian (``torch.func``
in the port, ``jax`` in goma_tpu): the squeeze term dh/dt is a ``jvp`` in
``params["time"]``, grad h a ``jacfwd`` in the position, Pi'(H), Krl'(S),
rho_g'(P) and S'(P) a ``vmap(grad)``; the decks make each of them nonzero.

Tolerances: residuals and CSR values within 1e-12 of each array's max
(the same operations, summed in another order); model values within
1e-14 relative; the film's Newton counts equal and x within 1e-8
(1 + |x|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.physics.shell_film as j_film
import goma_tpu.physics.shell_porous as j_porous
import goma_tpu_torch.physics.shell_film as t_film
import goma_tpu_torch.physics.shell_porous as t_porous
from scripts import shell_decks
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_shell import JAX, TORCH, _rel, system_parity

RTOL = 1e-12


# ------------------------------------------------------------- lubrication
def _line(P, nx=4, curved=True, ny=2, L=1.5):
    mesh = P.mesh.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, L))
    if curved:
        c = mesh.coords
        c[:, 1] += 0.1 * np.sin(np.pi * c[:, 0] / L) * (1 - c[:, 1])
    return mesh, P.phys.attach_shell_block(mesh, "bottom", "shell")


def _gap_xt(P):
    """h(x, t) = 0.2 + 0.05 x - 0.3 t x^2: the squeeze term depends on x."""
    return lambda fv, mat, p: 0.2 + 0.05 * fv.x[:, 0] - 0.3 * p["time"] * fv.x[:, 0] ** 2


def _reynolds(P, transient=True):
    mesh, bi = _line(P)
    xp = P.xp
    mat = {"gap": _gap_xt(P),
           "mu_lub": lambda fv, m, p: 0.1 + 0.05 * fv.val["lub_pressure"][:, 0] ** 2,
           "wall_velocity": lambda fv, m, p: xp.stack(
               [1.0 + 0.2 * fv.x[:, 1], 0.3 * fv.x[:, 0]], 1)}
    return P.Problem(mesh, [[], [P.lub.ReynoldsFilm(interp="Q2",
                                                    transient=transient)]],
                     [{}, mat], **P.kw)


def _tfmp(P):
    mesh, bi = _line(P)
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="tf")
    gap = _gap_xt(P)
    prob = P.Problem(mesh, [[], [P.lub.TFMPMass(interp="Q2", supg=0.5),
                                 P.lub.TFMPBound(interp="Q2")]],
                     [{}, {"gap": gap, "mu_l": 1.3, "mu_g": 0.4, "D_tfmp": 0.02,
                           "wall_velocity": np.array([0.7, 0.1]),
                           "rho_g": lambda Pg: 0.8 * Pg + 0.1 * Pg ** 2}], **P.kw)
    prob.add_face_kernel(ends[1], P.lub.TFMPFreeFlux("liquid"))
    prob.add_face_kernel(ends[1], P.lub.TFMPFreeFlux("gas"))
    prob.add_face_kernel(ends[0], P.lub.TFMPAvgPlateVelo())
    prob.add_face_kernel(ends[1], P.lub.TFMPAvgPlateVelo(
        v_avg=lambda s, m, p: 0.5 * s.x))
    return prob


def _power_law(P):
    mesh, bi = _line(P)
    return P.Problem(mesh, [[], [P.lub.ReynoldsFilmPowerLaw(interp="Q2",
                                                            transient=True)]],
                     [{}, {"gap": _gap_xt(P), "m_lub": 1.7, "n_exp": 0.6,
                           "wall_velocity": np.array([0.5, 0.2])}], **P.kw)


def _lub_plane(P):
    """A 2D lubrication plane carrying the lub pressure, the level set and
    its curvature, with the side-wall resistance gated by the level set."""
    mesh = P.mesh.rectangle_mesh(3, 3, elem="QUAD4")
    xp = P.xp
    mat = {"curv_relax": 0.3, "curv_diff": 0.1, "ls_alpha": 0.25,
           "lub_velocity": lambda fv, m, p: xp.stack(
               [0.5 + fv.x[:, 1], -0.3 + 0.0 * fv.x[:, 0]], 1),
           "gap": lambda fv, m, p: 0.1 + 0.02 * fv.x[:, 0], "mu_lub": 0.5,
           "wall_velocity": np.array([1.0, 0.0])}
    prob = P.Problem(mesh, [P.lub.LubricationCurvature(interp="Q1",
                                                       transient=True),
                            P.eqs.PassiveVar("fill", 1, "Q1"),
                            P.lub.ReynoldsFilm(interp="Q1")], mat, **P.kw)
    prob.add_face_kernel("top", P.lub.ShellLubWall(pwr_index=0.7, fudge=1.2))
    prob.add_face_kernel("bottom", P.lub.ShellLubWall(fill_var="none"))
    return prob


def _junction(P):
    mesh = P.mesh.rectangle_mesh(4, 1, elem="QUAD9", xlim=(0, 1), ylim=(0, 0.05))
    ss = mesh.sidesets["bottom"]
    xc = np.array([mesh.coords[mesh.blocks[0].conn[e]][:, 0].mean()
                   for e in ss.elems])
    left = xc < 0.5
    mesh.sidesets["bot_lub"] = P.mesh.SideSet(elems=ss.elems[left],
                                              faces=ss.faces[left])
    mesh.sidesets["bot_film"] = P.mesh.SideSet(elems=ss.elems[~left],
                                               faces=ss.faces[~left])
    bl = P.phys.attach_shell_block(mesh, "bot_lub", "lub")
    bf = P.phys.attach_shell_block(mesh, "bot_film", "film")
    eqs = [[], [], []]
    eqs[bl] = [P.lub.ReynoldsFilm(interp="Q2")]
    eqs[bf] = [P.film.FilmPressure(interp="Q2", transient=False),
               P.film.FilmHeight(interp="Q2")]
    prob = P.Problem(mesh, eqs, [{}, {"gap": 0.4, "mu_lub": 1.0},
                                 {"mu": 1.0, "sigma": 1.0}], **P.kw)
    ends = P.shell_end.shell_end_sidesets(mesh, bf, prefix="f")
    prob.add_face_kernel(ends[-1], P.lub.ShellFlowDeveloped(penalty=1e3))
    mesh.nodesets["junction"] = np.intersect1d(
        np.unique(mesh.blocks[bl].conn), np.unique(mesh.blocks[bf].conn)
    ).astype(np.int32)
    P.lub.tie_lub_film(prob, "junction")
    return prob


def _lub_end(P, var):
    """VELO_NORMAL_LUB (``var="velocity"``) and LUB_KINEMATIC (the mesh
    displacement, with its rate) at the lubrication shell's far end."""
    mesh, bi = _line(P, nx=3, curved=False, ny=2, L=1.0)
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="le")
    shell = [P.lub.ReynoldsFilm(interp="Q2"), P.eqs.PassiveVar(var, 2, "Q2")]
    prob = P.Problem(mesh, [[P.eqs.PassiveVar(var, 2, "Q2")], shell],
                     [{}, {"gap": lambda fv, m, p: 0.3 + 0.1 * fv.x[:, 0],
                           "mu_lub": 0.8, "wall_velocity": np.array([0.4, 0.0])}],
                     **P.kw)
    prob.add_face_kernel(ends[1], P.lub.LubEndKinematic(
        dim=2, var=var, lubflux=lambda s, m, p: 0.01 * s.x[:, 0], penalty=1e3))
    prob.add_face_kernel(ends[0], P.lub.LubEndKinematic(dim=2, var=var,
                                                        penalty=1e2))
    return prob


LUB_DECKS = {
    "reynolds_squeeze": (_reynolds, [("lub_pressure", 0, 0, 1)], 0.0, 0.4),
    "tfmp": (_tfmp, [("tfmp_sat", 0, 0.2, 0.8), ("tfmp_pres", 0, 0.5, 1.5)],
             2.0, 0.3),
    "power_law": (_power_law, [("lub_pressure", 0, 0, 1)], 0.0, 0.2),
    "lub_plane": (_lub_plane, [("lub_curv", 0, -1, 1), ("fill", 0, -0.4, 0.4),
                               ("lub_pressure", 0, 0, 1)], 1.5, 0.0),
    "junction": (_junction, [("lub_pressure", 0, 0, 1),
                             ("film_pressure", 0, 0, 1),
                             ("film_height", 0, 0.3, 0.5)], 0.0, 0.0),
    "velo_normal_lub": (lambda P: _lub_end(P, "velocity"),
                        [("lub_pressure", 0, 0, 1), ("velocity", 0, -1, 1),
                         ("velocity", 1, -1, 1)], 0.0, 0.0),
    "lub_kinematic": (lambda P: _lub_end(P, "mesh_displacement"),
                      [("lub_pressure", 0, 0, 1),
                       ("mesh_displacement", 0, -0.02, 0.02),
                       ("mesh_displacement", 1, -0.02, 0.02)], 2.0, 0.0),
}


@pytest.mark.parametrize("deck", list(LUB_DECKS))
def test_lubrication_matches(deck):
    """ReynoldsFilm (a gap in x and t, a pressure-dependent viscosity, a
    callable wall velocity), the TFMP pair with SUPG and its free-flux and
    plate-velocity ends, the power-law film, the level-set curvature with
    the gated side wall, the lubrication-film junction (row injection and
    point constraint) and the end-kinematic conditions: R and the CSR
    values at a seeded state, history, ct and time."""
    build, fields, ct, time = LUB_DECKS[deck]
    system_parity(build, fields, seed=21, ct=ct, time=time)


def test_squeeze_term_matches():
    """The squeeze term alone: R of the transient ReynoldsFilm minus the
    steady one at the same state, a gap that depends on time (dh/dt =
    -0.3 x^2, a ``jvp`` in ``params["time"]``), nonzero and equal to
    goma_tpu's."""
    out = []
    for P in (JAX, TORCH):
        R = []
        for transient in (True, False):
            prob = _reynolds(P, transient)
            prob.finalize()
            x = np.linspace(0.0, 1.0, prob.dofmap.n_dof)
            params = prob.base_params()
            params["time"] = P.arr(0.4)
            R.append(np.asarray(shell_decks._np(prob.residual(P.arr(x), params))))
        out.append(R[0] - R[1])
    assert np.abs(out[0]).max() > 1e-3
    assert _rel(out[1], out[0]) <= RTOL


# -------------------------------------------------------------------- film
def _film_line(P):
    mesh, bi = _line(P, nx=4)
    xp = P.xp
    mat = {"mu": lambda fv, m, p: 1.0 + 0.1 * fv.val["film_conc"][:, 0],
           "sigma": 0.8, "D_partc": 0.03,
           "disjoining": P.film.disjoining_two_term(40.0, 3.0, 2.0, 0.05),
           "film_gravity": np.array([0.1, -0.2]), "beta_slip": 0.05,
           "evap": P.film.conc_power_evap(0.05, 1.5, 0.6),
           "lub_source": lambda fv, m, p: 0.01 * xp.sin(fv.x[:, 0])}
    return P.Problem(mesh, [[], [P.film.FilmPressure(interp="Q2"),
                                 P.film.FilmHeight(interp="Q2"),
                                 P.film.FilmParticles(interp="Q2")]],
                     [{}, mat], **P.kw)


def _film_surface(P):
    mesh = P.mesh.box_mesh(2, 2, 1, elem="HEX27", zlim=(-0.05, 0.0))
    c = mesh.coords
    c[:, 2] += 0.1 * np.sin(c[:, 0] + 2 * c[:, 1]) * (c[:, 2] + 0.05) * 20.0
    P.phys.attach_shell_block(mesh, "top", "film")
    mat = {"mu": 1.0, "sigma": 1.0, "D_partc": 1e-2,
           "disjoining": P.film.disjoining_one_term(0.02, 3.0, 0.1),
           "film_gravity": np.array([0.0, 0.1, -1.0]),
           "evap": P.film.conc_power_evap(0.05, 1.0, 0.6)}
    return P.Problem(mesh, [[], [P.film.FilmPressure(interp="Q2"),
                                 P.film.FilmHeight(interp="Q2"),
                                 P.film.FilmParticles(interp="Q2")]],
                     [{}, mat], **P.kw)


def _energy_species(P):
    mesh, bi = _line(P, nx=4)
    xp = P.xp

    def flux(fv, m, p):
        h = 0.2 + 0.05 * fv.x[:, 0]
        gp = fv.grad["shell_species"][:, 0, :]
        return xp.stack([-h ** 3 * gp[:, 0] + 0.5 * h, -h ** 3 * gp[:, 1]], 1)

    mat = {"rho": 1.2, "Cp": 0.9,
           "k": lambda fv, m, p: 1.0 + 0.2 * fv.val["shell_temperature"][:, 0],
           "gap": lambda fv, m, p: 0.2 + 0.05 * fv.x[:, 0], "lub_flux": flux,
           "ht_coeff": 0.3, "ht_tamb": 0.1, "D_shell": np.array([0.5, 0.2]),
           "shell_species_source": lambda fv, m, p: xp.stack(
               [fv.x[:, 0], 1.0 + 0.0 * fv.x[:, 0]], 1)}
    return P.Problem(mesh, [[], [P.film.ShellEnergy(interp="Q2", transient=True,
                                                    supg=1.0),
                                 P.film.ShellSpecies(n_species=2, interp="Q2")]],
                     [{}, mat], **P.kw)


def _energy_plain(P):
    mesh, bi = _line(P, nx=3)
    return P.Problem(mesh, [[], [P.film.ShellEnergy(interp="Q2", transient=True),
                                 P.film.ShellSpecies(interp="Q2",
                                                     transient=False)]],
                     [{}, {"k": 0.7, "gap": 0.3, "shell_species_source": 0.4}],
                     **P.kw)


FILM_DECKS = {
    "film_line": (_film_line, [("film_pressure", 0, -1, 1),
                               ("film_height", 0, 0.04, 0.2),
                               ("film_conc", 0, 0.0, 0.65)], 2.0),
    "film_surface": (_film_surface, [("film_pressure", 0, -1, 1),
                                     ("film_height", 0, 0.5, 1.5),
                                     ("film_conc", 0, 0.1, 0.3)], 3.0),
    "energy_species": (_energy_species, [("shell_temperature", 0, 0, 1),
                                         ("shell_species", 0, 0, 1),
                                         ("shell_species", 1, 0, 1)], 1.5),
    "energy_plain": (_energy_plain, [("shell_temperature", 0, 0, 1),
                                     ("shell_species", 0, 0, 1)], 1.5),
}


@pytest.mark.parametrize("deck", list(FILM_DECKS))
def test_film_equations_match(deck):
    """FilmPressure / FilmHeight / FilmParticles (two-term and one-term
    disjoining pressure, gravity, slip, evaporation across its live, dry
    and packed branches, a film source) on a curved bar shell and a curved
    surface shell, ShellEnergy (SUPG, transient, a state-dependent
    conductivity, the ambient loss) and ShellSpecies (two species, a
    source): R and the CSR values at a seeded state."""
    build, fields, ct = FILM_DECKS[deck]
    system_parity(build, fields, seed=31, ct=ct)


def test_film_models_match():
    """The disjoining-pressure, evaporation and retention factories: values
    and derivatives against goma_tpu's on seeded inputs (the dry, live and
    packed evaporation branches, suction on both sides of P = 0)."""
    rng = np.random.default_rng(7)
    H = np.concatenate([[0.05, 1e-13], rng.uniform(0.01, 0.5, 30)])
    C = np.concatenate([[0.0, -0.1, 0.57, 0.7], rng.uniform(0.0, 0.6, 20)])
    Pr = np.concatenate([[0.0], rng.uniform(-3.0, 2.0, 20)])
    mat = {"sigma": 0.7}
    jfv = type("F", (), {"val": {"film_conc": jnp.asarray(C)[:, None]},
                         "x": jnp.zeros((C.size, 2))})
    tfv = type("F", (), {"val": {"film_conc": torch.as_tensor(C)[:, None]},
                         "x": torch.zeros((C.size, 2), dtype=torch.float64)})
    pairs = [
        (j_film.disjoining_two_term(50.0, 3.0, 2.0, 0.05, factor=0.8)(jnp.asarray(H), mat),
         t_film.disjoining_two_term(50.0, 3.0, 2.0, 0.05, factor=0.8)(torch.as_tensor(H), mat)),
        (j_film.disjoining_one_term(0.3, 3.0, 0.05)(jnp.asarray(H), mat),
         t_film.disjoining_one_term(0.3, 3.0, 0.05)(torch.as_tensor(H), mat)),
        (j_film.conc_power_evap(0.05, 1.5, 0.6)(jfv, mat, {}),
         t_film.conc_power_evap(0.05, 1.5, 0.6)(tfv, mat, {})),
    ]
    for jm, tm in ((j_porous.linear_retention(0.2, 0.3, 0.9),
                    t_porous.linear_retention(0.2, 0.3, 0.9)),
                   (j_porous.van_genuchten_retention(1.3, 2.5, 0.1, 0.95),
                    t_porous.van_genuchten_retention(1.3, 2.5, 0.1, 0.95))):
        pairs.append((jm(jnp.asarray(Pr)), tm(torch.as_tensor(Pr))))
        pairs.append((jax.vmap(jax.grad(jm))(jnp.asarray(Pr)),
                      torch.func.vmap(torch.func.grad(tm))(torch.as_tensor(Pr))))
    jpi = j_film.disjoining_two_term(50.0, 3.0, 2.0, 0.05)
    tpi = t_film.disjoining_two_term(50.0, 3.0, 2.0, 0.05)
    pairs.append((jax.vmap(jax.grad(lambda h: jpi(h, mat)))(jnp.asarray(H[2:])),
                  torch.func.vmap(torch.func.grad(lambda h: tpi(h, mat)))(
                      torch.as_tensor(H[2:]))))
    for jv, tv in pairs:
        assert _rel(tv, jv) <= 1e-14


# ------------------------------------------------------------ porous shells
def _porous_closed(P):
    mesh, bi = _line(P, nx=4)
    mat = dict(shell_decks.MAT_GASN)
    del mat["lub_pressure"]
    mat.update(gap=0.3, mu_lub=1.0, Pref=0.3)
    return P.Problem(mesh, [[], [P.porous.PorousShellClosed(interp="Q2"),
                                 P.porous.PorousShellGasN(interp="Q2"),
                                 P.lub.ReynoldsFilm(interp="Q2"),
                                 P.porous.LubPorousSink(interp="Q2")]],
                     [{}, mat], **P.kw)


def _porous_closed_material(P):
    mesh, bi = _line(P, nx=3)
    mat = dict(shell_decks.MAT_CLOSED)
    mat["lub_pressure"] = lambda fv, m, p: 0.4 + 0.1 * fv.x[:, 0]
    return P.Problem(mesh, [[], [P.porous.PorousShellClosed(interp="Q2")]],
                     [{}, mat], **P.kw)


def _porous_open(P):
    mesh, bi = _line(P, nx=4)
    mat = {"porosity": 0.4, "permeability": 0.02, "mu": 1.1,
           "gap": lambda fv, m, p: 1.0 + 0.2 * fv.x[:, 0],
           "retention": P.porous.van_genuchten_retention(1.3, 2.5, 0.1, 0.95),
           "krel": lambda S: S ** 2, "kappa_cross": 0.3,
           "p_eff": lambda fv, m, p: 0.2 * fv.x[:, 0],
           "grav": np.array([0.0, -0.5])}
    return P.Problem(mesh, [[], [P.porous.PorousShellOpen(interp="Q2")]],
                     [{}, mat], **P.kw)


def _porous_stack(P):
    mesh, bi = _line(P, nx=3)
    mat = {"gap_1": 1.0, "porosity_1": 0.5, "diffusivity_1": lambda S: 0.1 + S,
           "gap_2": 2.0, "porosity_2": 0.25, "diffusivity_2": 0.05,
           "gap_3": 0.5, "porosity_3": 0.3, "exchange_G": 5.0,
           "pcap_1": lambda s: 1.0 - s, "pcap_2": lambda s: (1.0 - s) ** 2}
    return P.Problem(mesh, [[], [P.porous.PorousShellStackLayer(k, 3, interp="Q2")
                                 for k in range(3)]], [{}, mat], **P.kw)


POROUS_DECKS = {
    # S spans the clamps of the closed-cell model and of GASN's Taylor
    # extension (dS = 1e-2)
    "closed_gasn_sink": (_porous_closed, [("shell_sat_closed", 0, -0.005, 0.995),
                                          ("shell_sat_gasn", 0, 0.5, 1.5),
                                          ("lub_pressure", 0, 0, 1)], 2.0),
    "closed_material": (_porous_closed_material,
                        [("shell_sat_closed", 0, 0.05, 0.9)], 2.0),
    "open": (_porous_open, [("shell_press_open", 0, -2.0, 1.0)], 2.0),
    "stack": (_porous_stack, [("shell_sat_1", 0, 0.1, 0.9),
                              ("shell_sat_2", 0, 0.1, 0.9),
                              ("shell_sat_3", 0, 0.1, 0.9)], 2.0),
}


@pytest.mark.parametrize("deck", list(POROUS_DECKS))
def test_porous_shell_matches(deck):
    """PorousShellClosed with the gas inventory (GASN, both sides of its
    clamp) and the lubrication sink, the closed cell on a material
    lubrication pressure, PorousShellOpen (van Genuchten retention, krel,
    the cross exchange, gravity, transient) and a three-layer stack: R and
    the CSR values at a seeded state."""
    build, fields, ct = POROUS_DECKS[deck]
    system_parity(build, fields, seed=41, ct=ct)


# --------------------------------------------------------------------- film
@pytest.fixture(scope="module")
def film8():
    return shell_decks.film(JAX, 8), shell_decks.film(TORCH, 8)


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_film_device_rungs(kind, film8):
    """The 8x8 drying film: five Crank-Nicolson steps of dt = 0.02/lambda
    on bench.py's two device rungs (``_cavity_opts(kind, tol=1e-9,
    max_iter=12)``, float64 Jacobian): goma_tpu's Newton count of every
    step, x within 1e-8 (1 + |x|), the amplitude's leveling decay within
    5% (tests/test_shell_film.py's gate)."""
    from test_torch_overset import bench_opts

    (pj, _, x0), (pt, _, _) = film8
    out = []
    for P, prob in ((JAX, pj), (TORCH, pt)):
        ts = P.TransientSolver(prob, bench_opts(P.NewtonOptions, kind,
                                                max_iter=12),
                               shell_decks.film_time_options(P))
        out.append(ts.run(x0, prob.base_params()))
    rj, rt = out
    assert all(s.converged for s in rj.steps + rt.steps)
    assert [s.newton_iters for s in rt.steps] == [s.newton_iters for s in rj.steps]
    assert np.max(np.abs(rt.x - rj.x) / (1.0 + np.abs(rj.x))) <= 1e-8
    rd = shell_decks.film_readings(pt, rt.x, rt.t)
    assert abs(rd["amplitude"] / rd["exact"] - 1) <= 0.05
