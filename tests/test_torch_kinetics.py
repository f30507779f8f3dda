"""Gas and surface kinetics of the PyTorch port against goma_tpu:
``physics/kinetics.py`` (``ReactionNetwork``, ``Nasa7``), its own copy of
the Chemkin-II parser ``physics/chemkin.py`` and the PLACID surface
solver ``physics/placid.py`` (``SurfaceMechanism``, ``placid``,
``surface_kinetics_flux``), with ``interop``'s translations. Decks come
from ``scripts/closure_decks.py``, written once for both packages, built
on the CPU in float64 (the port in one torch thread).

Tolerances: the parsed networks' arrays exactly; sources and their
Jacobians within 1e-12 of each array's max; R and the CSR values of
``assemble`` and the face Jacobians within 1e-12; float32 preps within the
standing mixed-precision allowance of 1e-5; goma_tpu's test decks on host
``direct`` with the same Newton count and x within 1e-10 (1 + |x|); the
8x4 reacting channel on bench.py's two device rungs with the same Newton
and linear counts and x within 1e-8 (1 + |x|).
"""

import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.solvers as j_solvers
import goma_tpu_torch.interop as interop
import goma_tpu_torch.solvers as t_solvers
from scripts import closure_decks as cd
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_overset import bench_opts

JAX = cd.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = cd.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-12
jpl = importlib.import_module("goma_tpu.physics.placid")
tpl = importlib.import_module("goma_tpu_torch.physics.placid")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _fv(P, c, T=None):
    """A field-value stand-in: species (nq, ns) and a temperature."""
    val = {"species": P.arr(np.asarray(c, dtype=np.float64))}
    if T is not None:
        val["temperature"] = P.arr(np.asarray(T, dtype=np.float64)[:, None])
    return types.SimpleNamespace(val=val)


# ------------------------------------------------------------- chemkin
def _nasa_line(name, Tlo, Thi, Tmid, a_high, a_low):
    """tests/test_chemkin.py's fixed-column NASA-7 record."""
    l1 = f"{name:<18}{'':6}{'':20}G{Tlo:10.2f}{Thi:10.2f}{Tmid:8.2f}{'':6}1"
    f = list(a_high) + list(a_low)
    l2 = "".join(f"{v: 15.8E}" for v in f[0:5]) + "    2"
    l3 = "".join(f"{v: 15.8E}" for v in f[5:10]) + "    3"
    l4 = "".join(f"{v: 15.8E}" for v in f[10:14]) + "                   4"
    return "\n".join([l1, l2, l3, l4])


_Z5 = [0.0] * 5
_THERMO_AB = ("SPECIES\nA B\nEND\nTHERMO\n"
              + _nasa_line("A", 200.0, 3000.0, 1000.0, _Z5 + [100.0, 2.0],
                           _Z5 + [100.0, 2.0]) + "\n"
              + _nasa_line("B", 200.0, 3000.0, 1000.0, _Z5 + [-50.0, 3.5],
                           _Z5 + [-50.0, 3.5])
              + "\nEND\nREACTIONS JOULES/MOLE\nA = B  7.0  0.0  0.0\nEND\n")
_THERMO_2B = ("SPECIES\nA B\nEND\nTHERMO\n" + "\n".join(
    _nasa_line(n, 200.0, 3000.0, 1000.0, _Z5 + [0.0, 0.0], _Z5 + [0.0, 0.0])
    for n in ("A", "B"))
    + "\nEND\nREACTIONS JOULES/MOLE\nA = 2B  1.0  0.0  0.0\nEND\n")
_THERMO_REV = ("SPECIES\nA B\nEND\nTHERMO\n" + "\n".join(
    _nasa_line(n, 200.0, 3000.0, 1000.0, _Z5 + [0.0, 1.0], _Z5 + [0.0, 1.0])
    for n in ("A", "B"))
    + "\nEND\nREACTIONS JOULES/MOLE\n"
      "A = B  1.0  0.0  0.0\nREV / 4.0 0.0 0.0 /\nEND\n")
_PLOG = ("SPECIES\nA B\nEND\nREACTIONS JOULES/MOLE\nA => B  1.0  0.0  0.0\n"
         "PLOG / 1.0   10.0  0.0  0.0 /\nPLOG / 100.0 1000.0 0.0 0.0 /\nEND\n")

# each case of tests/test_chemkin.py: (text, keyword arguments)
CHEMKIN = {
    "builds_network": ("""
ELEMENTS
H O
END
SPECIES
H2 O2 H2O
END
REACTIONS CAL/MOLE
2H2 + O2 => 2H2O   1.0E13  0.0  40000.0
H2 + O2 = H2O + O2   2.0E10  0.5  1000.0  ! reversible: needs K_eq
END
""", {"K_eq": {1: 10.0}}),
    "source_terms": ("SPECIES\nA B C\nEND\nREACTIONS JOULES/MOLE\n"
                     "A + B => C  2.0  0.0  0.0\nEND\n", {"T_ref": 1.0}),
    "third_body": ("SPECIES\nA B AR H2O\nEND\nREACTIONS JOULES/MOLE\n"
                   "A + M => B + M  3.0  0.0  0.0\n"
                   "H2O/6.0/ AR/0.5/\nEND\n", {"T_ref": 1.0}),
    "lindemann": ("SPECIES\nA B\nEND\nREACTIONS JOULES/MOLE\n"
                  "A (+M) => B (+M)  10.0  0.0  0.0\n"
                  "LOW / 4.0 0.0 0.0 /\nEND\n", {"T_ref": 300.0}),
    "troe": ("SPECIES\nA B\nEND\nREACTIONS JOULES/MOLE\n"
             "A (+M) <=> B (+M)  1.0e3  0.0  0.0\nLOW / 5.0e2 0.0 0.0 /\n"
             "TROE / 0.6 100.0 2000.0 /\nEND\n",
             {"K_eq": {0: 1e30}, "T_ref": 1200.0}),
    "sri_collider": ("SPECIES\nA B AR\nEND\nREACTIONS JOULES/MOLE\n"
                     "A (+AR) => B (+AR)  2.0e3  0.0  0.0\n"
                     "LOW / 1.0e3 0.0 0.0 /\nSRI / 0.5 300.0 1000.0 /\nEND\n",
                     {"T_ref": 800.0}),
    "rev_duplicate": ("SPECIES\nA B\nEND\nREACTIONS JOULES/MOLE\n"
                      "A = B  5.0  0.0  0.0\nREV / 2.0 0.0 0.0 /\nDUPLICATE\n"
                      "A = B  1.0  0.0  0.0\nREV / 0.5 0.0 0.0 /\nDUP\nEND\n",
                      {"T_ref": 1.0}),
    "plog_mid": (_PLOG, {"T_ref": 1.0, "pressure": 10.0}),
    "plog_low": (_PLOG, {"T_ref": 1.0, "pressure": 0.01}),
    "thermo_kc": (_THERMO_AB, {"T_ref": 500.0, "units": "si"}),
    "thermo_dnu_si": (_THERMO_2B, {"T_ref": 400.0, "units": "si"}),
    "thermo_dnu_cgs": (_THERMO_2B, {"T_ref": 400.0, "units": "cgs"}),
    "rev_over_thermo": (_THERMO_REV, {"T_ref": 1.0}),
    "keq_over_rev": (_THERMO_REV, {"K_eq": {0: 0.5}, "T_ref": 1.0}),
    "jacobian_troe": ("SPECIES\nA B C\nEND\nREACTIONS JOULES/MOLE\n"
                      "A + B (+M) <=> C (+M)  1.0e2  0.2  500.0\n"
                      "LOW / 50.0 0.0 100.0 /\nTROE / 0.7 200.0 1500.0 /\nEND\n",
                      {"K_eq": {0: 3.0}}),
    "closure_deck": (cd.REACT_MECH, {"dH": cd.REACT_DH}),
}

_NET_ARRAYS = ("nu", "A", "Ea", "beta", "orders", "rev_orders", "dH")
_NET_LISTS = ("K_eq", "third_body", "falloff", "rev_arrhenius", "plog")


@pytest.mark.parametrize("case", list(CHEMKIN))
def test_chemkin_parity(case):
    """The same Chemkin text (every mechanism of tests/test_chemkin.py and
    the reacting deck's) gives the same species list and network arrays,
    and the same ``species_source`` and ``heat_source`` with their
    Jacobians at a seeded state (rates at T_ref, or at a seeded
    temperature field), in both packages."""
    text, kw = CHEMKIN[case]
    nets = [P.chemkin.parse_chemkin(text, **kw) for P in (JAX, TORCH)]
    (nj, sj), (nt, st) = nets
    assert sj == st
    for k in _NET_ARRAYS:
        assert np.array_equal(getattr(nj, k), getattr(nt, k)), k
    for k in _NET_LISTS:
        assert getattr(nj, k) == getattr(nt, k), k
    assert (nj.T_ref, nj.pressure, nj.units) == (nt.T_ref, nt.pressure,
                                                 nt.units)
    for th_j, th_t in zip(nj.thermo or [], nt.thermo or []):
        assert np.array_equal(th_j.a_low, th_t.a_low)
        assert np.array_equal(th_j.a_high, th_t.a_high)
        assert (th_j.T_mid, th_j.T_low, th_j.T_high) == (
            th_t.T_mid, th_t.T_low, th_t.T_high)
    rng = np.random.default_rng(11)
    ns = len(sj)
    c = 0.2 + rng.random((5, ns))
    T = None if nj.T_ref is not None else 600.0 + 300.0 * rng.random(5)
    out = []
    for P, net, jac in ((JAX, nj, jax.jacfwd), (TORCH, nt, torch.func.jacfwd)):
        def src(cc, P=P, net=net):
            fv = _fv(P, np.zeros((5, ns)), T)
            fv.val["species"] = cc
            return net.species_source(fv, {}, {}), net.heat_source(fv, {}, {})
        cc = P.arr(c)
        S, Q = src(cc)
        JS = jac(lambda v: src(v)[0])(cc)
        out.append((S, Q, JS))
    for a, b in zip(out[1], out[0]):
        assert np.isfinite(_np(a)).all()
        assert _rel(a, b) <= RTOL


def test_chemkin_rejections_match():
    """tests/test_chemkin.py::test_parse_chemkin_rejects_unsupported: the
    same texts raise the same errors in both packages."""
    bad = ["SPECIES\nA B\nEND\nREACTIONS\nA = B 1.0 0.0 0.0\nEND",
           "SPECIES\nA B\nEND\nREACTIONS\nA => B 1.0 0.0 0.0\n"
           "LOW / 1.0 0.0 0.0 /\nEND",
           "SPECIES\nA B\nEND\nREACTIONS\nA => B 1.0 0.0 0.0\n"
           "FORD / A 1.5 /\nEND",
           "SPECIES\nA\nEND\nREACTIONS\nA => Z 1.0 0.0 0.0\nEND",
           "SPECIES\nA B\nEND\nREACTIONS\nA (+M) => B (+M) 1.0 0.0 0.0\nEND",
           "SPECIES\nA B\nEND\nREACTIONS\nLOW / 1.0 0.0 0.0 /\nEND"]
    for text in bad:
        msgs = []
        for P in (JAX, TORCH):
            with pytest.raises(ValueError) as e:
                P.chemkin.parse_chemkin(text)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_read_chemkin_file(tmp_path):
    """``read_chemkin`` reads the same network from a file."""
    f = tmp_path / "mech.inp"
    f.write_text(cd.REACT_MECH)
    nj, _ = JAX.chemkin.read_chemkin(str(f))
    nt, _ = TORCH.chemkin.read_chemkin(str(f))
    assert np.array_equal(nj.nu, nt.nu) and nj.falloff == nt.falloff


# ------------------------------------------------------------ kinetics
def _probe(P):
    """The 4x2 Species(2) + Energy probe: a reversible network with heat
    release; B at exactly 0 everywhere in the state ``_probe_state``."""
    net = P.kin.ReactionNetwork(nu=[[-1, 1]], A=[5.0], Ea=[2000.0],
                                K_eq=[3.0], dH=[-4.0])
    mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.Species(n_species=2, interp="Q2"),
                            P.phys.Energy(interp="Q2")],
                     {"diffusivity": np.array([1.0, 0.5]), "k": 1.0,
                      "species_source": net.species_source,
                      "heat_source": net.heat_source}, **P.kw)
    prob.finalize()
    return prob


def _probe_state(prob):
    rng = np.random.default_rng(7)
    n = prob.mesh.n_nodes
    x = np.zeros(prob.dofmap.n_dof)
    x = prob.set_nodal_field(x, "species", 0, 0.5 + 0.5 * rng.random(n))
    x = prob.set_nodal_field(x, "species", 1, 0.0)
    return prob.set_nodal_field(x, "temperature", 0,
                                300.0 + 50.0 * rng.random(n))


@functools.lru_cache(maxsize=None)
def _probe_pair():
    return _probe(JAX), _probe(TORCH)


def _prep(P, prob, x, dtype):
    """R and the element Jacobians of the prep at ``dtype`` (the
    switched-precision prep: residual and Jacobian both at ``dtype``)."""
    params = prob.base_params()
    params["ct"] = P.arr(np.float64(2.0))
    prob.jacobian_dtype = getattr(P.xp, dtype)
    try:
        if P is JAX:
            R, _, aux = jax.jit(lambda xx, pp: prob._assemble_fast(
                xx, pp, rdt=getattr(jnp, dtype)))(P.arr(x), params)
        else:
            R, _, aux = prob._assemble_fast(P.arr(x), params,
                                            rdt=getattr(torch, dtype))
    finally:
        prob.jacobian_dtype = None
    return _np(R).astype(np.float64), _np(aux[0][0]).astype(np.float64)


def test_float32_zero_concentration_guard():
    """The reference's fault (``kinetics.py:226``): in float32 its 1e-300
    floor under the log rounds to 0, so a species at exactly 0 gives
    log(0) * (order 0) = NaN in goma_tpu's switched-precision prep. The
    port floors at the smallest normal float32 there: its float32 prep is
    finite and within 1e-5 of goma_tpu's float64 prep, and its float64
    prep equals goma_tpu's within 1e-12."""
    pj, pt = _probe_pair()
    x = _probe_state(pj)
    Rj32, Jj32 = _prep(JAX, pj, x, "float32")
    assert np.isnan(Rj32).any() and np.isnan(Jj32).any()
    Rj64, Jj64 = _prep(JAX, pj, x, "float64")
    Rt64, Jt64 = _prep(TORCH, pt, x, "float64")
    Rt32, Jt32 = _prep(TORCH, pt, x, "float32")
    assert np.isfinite(Rj64).all() and np.isfinite(Jj64).all()
    assert _rel(Rt64, Rj64) <= RTOL and _rel(Jt64, Jj64) <= RTOL
    assert np.isfinite(Rt32).all() and np.isfinite(Jt32).all()
    assert _rel(Rt32, Rj64) <= 1e-5 and _rel(Jt32, Jj64) <= 1e-5


def test_zero_concentration_tie_tangent():
    """``max(c, 0)`` at c = 0 (``kinetics.py:219``): half the derivative,
    as ``jnp.maximum``; the species source's Jacobian at an exact zero
    equals goma_tpu's, in float64."""
    text, kw = CHEMKIN["jacobian_troe"]
    c = np.array([[0.4, 0.0, 0.2], [0.0, 0.3, 0.0]])
    T = np.array([700.0, 650.0])
    out = []
    for P, jac in ((JAX, jax.jacfwd), (TORCH, torch.func.jacfwd)):
        net, _ = P.chemkin.parse_chemkin(text, **kw)

        def src(cc, P=P, net=net):
            fv = _fv(P, c, T)
            fv.val["species"] = cc
            return net.species_source(fv, {}, {})
        out.append(_np(jac(src)(P.arr(c))))
    assert np.isfinite(out[1]).all()
    assert _rel(out[1], out[0]) <= RTOL


# -------------------------------------------------------------- PLACID
def _wall_state(n=12, seed=0, zero=False):
    rng = np.random.default_rng(seed)
    X = np.stack([0.3 + 0.7 * rng.random(n), 0.02 + 0.3 * rng.random(n)], 1)
    if zero:
        X[0, 1] = 0.0
    return X, 300.0 + 80.0 * rng.random(n)


def _flux_jac(P, X, T, jac, vmap, dtype="float64"):
    """The reacting deck's wall flux closure and its Jacobian with respect
    to the species and the temperature, as the face prep takes it: ``vmap``
    over faces (two points a face) of ``jacfwd``."""
    fl = P.placid.surface_kinetics_flux(
        cd.wall_mech(P), species_ids=[0, 1], pressure=cd.REACT_PRESSURE,
        mode=P.placid.SFLUX_RESIDUAL)
    dt = getattr(P.xp, dtype)

    def f(y, t):
        return fl(types.SimpleNamespace(val={"species": y,
                                             "temperature": t}), {}, {})

    y = P.arr(X.reshape(-1, 2, 2)).astype(dt) if P is JAX else \
        P.arr(X.reshape(-1, 2, 2)).to(dt)
    t = P.arr(T.reshape(-1, 2, 1)).astype(dt) if P is JAX else \
        P.arr(T.reshape(-1, 2, 1)).to(dt)
    q = vmap(f)(y, t)
    Jy, Jt = vmap(jac(f, argnums=(0, 1)))(y, t)
    return [_np(a).astype(np.float64) for a in (q, Jy, Jt)]


def test_placid_face_jacobian_matches():
    """The wall flux of the reacting deck and its face Jacobian (through
    the masked iterations under ``vmap(jacfwd)``) within 1e-12 of
    goma_tpu's (through its ``while_loop``) in float64, from goma_tpu's
    uniform start, where the first iteration's argmax is an exact tie."""
    X, T = _wall_state()
    oj = _flux_jac(JAX, X, T, jax.jacfwd, jax.vmap)
    ot = _flux_jac(TORCH, X, T, torch.func.jacfwd, torch.func.vmap)
    for a, b in zip(ot, oj):
        assert np.isfinite(b).all() and _rel(a, b) <= RTOL


def test_placid_float32_prep():
    """In a float32 prep goma_tpu forms the gas concentrations in float32
    and iterates in float64; the port the same, returning float32: the
    flux and its Jacobian within 1e-5 of goma_tpu's float32 run."""
    X, T = _wall_state(seed=1)
    oj = _flux_jac(JAX, X, T, jax.jacfwd, jax.vmap, "float32")
    ot = _flux_jac(TORCH, X, T, torch.func.jacfwd, torch.func.vmap,
                   "float32")
    for a, b in zip(ot, oj):
        assert np.isfinite(a).all() and _rel(a, b) <= 1e-5


def test_placid_zero_gas_fraction():
    """A wall point where a gas fraction is exactly 0 (the reacting deck's
    B at the inlet): goma_tpu's face Jacobian there is NaN (its nested
    tangent of log(max(c, 1e-300)) divides 0 by (1e-300)^2, which
    underflows to 0) and only there; the port's is finite, and equals
    goma_tpu's at every other point within 1e-12."""
    X, T = _wall_state(zero=True)
    oj = _flux_jac(JAX, X, T, jax.jacfwd, jax.vmap)
    ot = _flux_jac(TORCH, X, T, torch.func.jacfwd, torch.func.vmap)
    Jy_j = oj[1]  # (face, point, species, point, species)
    assert np.isnan(Jy_j[0, 0]).all()
    assert np.isfinite(Jy_j[0, 1]).all() and np.isfinite(Jy_j[1:]).all()
    for a, b in zip(ot, oj):
        assert np.isfinite(a).all()
        ok = np.isfinite(b)
        assert np.abs(a[ok] - b[ok]).max() <= RTOL * np.abs(b[ok]).max()


def test_placid_masked_run_equals_plain():
    """Under ``vmap(jacfwd)`` the port runs as many masked iterations as
    its primal solve of the same points needed: the iterates equal a
    plain run's (the loop stopping when every point is done), point for
    point."""
    X, T = _wall_state(n=10, seed=3)
    mech = cd.wall_mech(TORCH)
    z_plain, sd_plain, conv, trips = cd.wall_placid(TORCH, X, T)
    assert conv.all() and int(trips.min()) >= 2

    def f(x):
        z, sd, _, it = tpl.placid_points(
            mech, tpl.SFLUX_RESIDUAL, tpl.BULK_DEPOSITION, 1.0, x,
            TORCH.arr(T), TORCH.arr(np.full(len(T), cd.REACT_PRESSURE)),
            TORCH.arr(np.full((len(T), mech.dim), 0.25)))
        return z, sd

    z, sd = torch.func.vmap(f)(TORCH.arr(X)[None].expand(3, -1, -1))
    assert _rel(z[1], z_plain) <= 1e-14 and _rel(sd[2], sd_plain) <= 1e-14


def test_placid_single_point_matches():
    """``placid`` on one point in every mode and bulk form against
    goma_tpu's: the Langmuir mechanism (initialize, transient) and the
    deposition mechanism (residual, Jacobian with etch rows, transient): z within 1e-12 relative, sdot (a
    difference of rates near balance) within 1e-12 of max(1, max |sdot|)."""
    lang = dict(nu=[[-1, -1, 1], [1, 1, -1]], A=[2.0, 0.5], n_gas=1,
                phases=[("site", 2)], sden0=[3.0])
    dep = dict(nu=[[-1, -1, 1, 0, 0], [1, 1, -1, 0, 0], [0, 1, -1, 1, 0],
                   [0, 1, -1, 0, 1]], A=[5.0, 0.5, 0.3, 0.9], n_gas=1,
               phases=[("site", 2), ("bulk", 2)], sden0=[2.0])
    for spec, mode, bulk in ((lang, 1, 1), (lang, 4, 1), (dep, 2, 1),
                             (dep, 3, 2), (dep, 4, 1)):
        outs = []
        for m in (jpl, tpl):
            mech = m.SurfaceMechanism(**spec)
            arr = jnp.asarray if m is jpl else (
                lambda a: torch.as_tensor(np.asarray(a, np.float64)))
            z, sd, conv = m.placid(mech, mode, bulk, 0.5, arr([0.3]), 320.0,
                                   101325.0, arr(np.full(mech.dim, 0.5)))
            outs.append((_np(z), _np(sd), bool(conv)))
        (zj, sj, cj), (zt, st, ct) = outs
        assert cj == ct and _rel(zt, zj) <= RTOL
        # sdot is a difference of rates near balance: absolute
        assert np.abs(st - sj).max() <= RTOL * max(1.0, np.abs(sj).max())


# --------------------------------------------------- the reacting deck
@functools.lru_cache(maxsize=None)
def _reacting_pair():
    return cd.reacting(JAX, 4, 2)[0], cd.reacting(TORCH, 4, 2)[0]


def test_reacting_system_matches():
    """R and the CSR values of ``assemble`` of the 4x2 reacting channel
    (the Chemkin network's sources, the PLACID wall flux, the heated wall)
    at a seeded state with every wall gas fraction positive, within 1e-12
    of goma_tpu's jitted assembly."""
    pj, pt = _reacting_pair()
    rng = np.random.default_rng(5)
    n = pj.mesh.n_nodes
    x = 0.05 * rng.standard_normal(pj.dofmap.n_dof)
    x = pj.set_nodal_field(x, "species", 0, 0.5 + 0.5 * rng.random(n))
    x = pj.set_nodal_field(x, "species", 1, 0.05 + 0.3 * rng.random(n))
    x = pj.set_nodal_field(x, "temperature", 0, 300.0 + 60.0 * rng.random(n))
    out = []
    for P, prob in ((JAX, pj), (TORCH, pt)):
        R, vals = prob.assemble(P.arr(x), prob.base_params())
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.isfinite(Rt).all() and np.isfinite(Vt).all()
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


@functools.lru_cache(maxsize=None)
def _reacting_84():
    """The 8x4 reacting channel in both packages and its start, built once
    for both rungs (goma_tpu's jitted prep compiles once)."""
    pj, x0 = cd.reacting(JAX, 8, 4)
    return pj, cd.reacting(TORCH, 8, 4)[0], x0


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_reacting_device_rungs(kind):
    """The 8x4 reacting channel of phase 58 on bench.py's two device rungs
    (``_cavity_opts(kind, tol=1e-9, max_iter=12)``; the float32 early prep
    on ``gmres+ndlu``): goma_tpu's Newton and linear counts and ND levels,
    x within 1e-8 (1 + |x|)."""
    pj, pt, x0 = _reacting_84()
    sj = j_solvers.NewtonSolver(pj, bench_opts(
        j_solvers.NewtonOptions, kind, max_iter=cd.REACT_MAX_ITER))
    st = t_solvers.NewtonSolver(pt, bench_opts(
        t_solvers.NewtonOptions, kind, max_iter=cd.REACT_MAX_ITER))
    rj = sj.solve(x0, pj.base_params())
    rt = st.solve(x0, pt.base_params())
    assert rj.converged and rt.converged, (rj.summary(), rt.summary())
    assert (rt.iters, rt.linear_iters) == (rj.iters, rj.linear_iters)
    ndj = sj.precond if kind == "gmres+ndlu" else sj._ndlu
    ndt = st.precond if kind == "gmres+ndlu" else st._ndlu
    assert [(lv.nn, lv.smax) for lv in ndt.levels] == \
        [(int(lv.nn), int(lv.smax)) for lv in ndj.levels]
    assert np.max(np.abs(rt.x - rj.x) / (1.0 + np.abs(rj.x))) <= 1e-8
    for k, v in cd.reacting_outputs(pt, rt.x).items():
        assert abs(v - cd.reacting_outputs(pj, rj.x)[k]) <= 1e-8 * abs(v)


KINETICS_SMALL = ("reaction_diffusion", "reversible_equilibrium", "exothermic",
                  "placid_langmuir", "placid_deposition")


@pytest.mark.parametrize("deck", KINETICS_SMALL)
def test_kinetics_decks_match(deck):
    """goma_tpu's tests/test_kinetics.py decks and tests/test_placid.py's
    Langmuir, batch, deposition and flux-closure cases, each with its own
    gate, in both packages (host ``direct``): the same Newton count and x
    within 1e-10 (1 + |x|)."""
    oj = cd.SMALL[deck](JAX)
    ot = cd.SMALL[deck](TORCH)
    assert ot["newton"] == oj["newton"]
    assert np.max(np.abs(ot["x"] - oj["x"]) / (1.0 + np.abs(oj["x"]))) <= 1e-10


# -------------------------------------------------------------- interop
def test_interop_translates_closures():
    """``materials_from_goma`` takes a goma_tpu network's bound
    ``species_source`` and ``heat_source`` (the network rebuilt, NASA-7
    thermo included) and ``SATurbulentViscosity``;
    ``surface_mechanism_from_goma`` rebuilds a ``SurfaceMechanism``: each
    computes what goma_tpu's does."""
    import goma_tpu.physics.turbulence as jturb

    text, kw = CHEMKIN["thermo_kc"]
    nj, _ = JAX.chemkin.parse_chemkin(text, **kw)
    mech_j = JAX.placid.SurfaceMechanism(**cd.WALL_MECH)
    mat = interop.materials_from_goma({
        "species_source": nj.species_source, "heat_source": nj.heat_source,
        "mu": jturb.SATurbulentViscosity(mu=0.3, rho=1.2), "k": 2.0})
    assert mat["k"] == 2.0
    c = np.array([[0.2, 0.5], [0.3, 0.1]])
    for key in ("species_source", "heat_source"):
        a = getattr(nj, key)(_fv(JAX, c), {}, {})
        b = mat[key](_fv(TORCH, c), {}, {})
        assert _rel(b, a) <= RTOL
    fvj = types.SimpleNamespace(val={"turb_nu": jnp.asarray([[0.0], [0.4]])})
    fvt = types.SimpleNamespace(val={"turb_nu": TORCH.arr([[0.0], [0.4]])})
    assert _rel(mat["mu"](fvt, {}, {}),
                jturb.SATurbulentViscosity(mu=0.3, rho=1.2)(fvj, {}, {})) <= RTOL
    mech_t = interop.surface_mechanism_from_goma(mech_j)
    X, T = _wall_state(n=4, seed=9)
    zj = jax.vmap(lambda xg, t: jpl.placid(
        mech_j, 2, 1, 1.0, xg, t, cd.REACT_PRESSURE, jnp.full(4, 0.25))[0])(
        jnp.asarray(X), jnp.asarray(T))
    zt = tpl.placid_points(mech_t, 2, 1, 1.0, TORCH.arr(X), TORCH.arr(T),
                           TORCH.arr(np.full(4, cd.REACT_PRESSURE)),
                           TORCH.arr(np.full((4, 4), 0.25)))[0]
    assert _rel(zt, zj) <= RTOL
    with pytest.raises(NotImplementedError):
        interop.materials_from_goma({"mu": lambda fv, m, p: 1.0})
