"""Particle tracing of the PyTorch port against goma_tpu's
(``post/particles.py``): ``FieldSampler.locate``, ``sample`` and
``sample_grad``, the massless (RK4) and inertial traces, on the same
seeded states in both packages (host numpy in both; the port's x may be a
tensor, read back once); and goma_tpu's particle tests' decks
(``scripts/split_decks.py``) in both.

Tolerance: 1e-12 of each array's max |value| (the same numpy operations on
the same inputs; only the basis tables may round differently).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import split_decks as sd
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

JAX = sd.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = sd.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    ok = np.isfinite(b)
    assert np.array_equal(ok, np.isfinite(a))
    return float(np.abs(a[ok] - b[ok]).max(initial=0.0)
                 / max(np.abs(b[ok]).max(initial=0.0), 1e-300))


def _flow(P, elem):
    """A swirling, pressure-carrying state on a distorted [0, 1]^2 mesh."""
    mesh = P.mesh.rectangle_mesh(5, 4, elem=elem)
    c = mesh.coords
    mesh.coords = c + 0.04 * np.stack(
        [np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]),
         np.sin(2 * np.pi * c[:, 0]) * c[:, 1] * (1 - c[:, 1])], 1)
    prob = P.Problem(mesh, [P.phys.Momentum(2, interp="Q2" if elem == "QUAD9"
                                            else "Q1", transient=False),
                            P.phys.Continuity(interp="Q1")],
                     {"rho": 1.0, "mu": 1.0}, **P.kw)
    prob.finalize()
    x = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity", 0,
                             lambda X: np.sin(np.pi * X[:, 1]) * X[:, 0])
    x = prob.set_nodal_field(x, "velocity", 1,
                             lambda X: -np.cos(np.pi * X[:, 0]) * X[:, 1])
    x = prob.set_nodal_field(x, "pressure", 0,
                             lambda X: 3.0 * X[:, 0] ** 2 - X[:, 1])
    return prob, x


@functools.lru_cache(maxsize=None)
def pair(elem):
    return _flow(JAX, elem), _flow(TORCH, elem)


def _points(n=40, seed=11):
    """Seeded points, some outside the mesh."""
    return np.random.default_rng(seed).uniform(-0.1, 1.1, (n, 2))


@pytest.mark.parametrize("elem", ["QUAD9", "QUAD4"])
def test_locate(elem):
    (pj, _), (pt, _) = pair(elem)
    pts = _points()
    bj, ej, xj = JAX.particles.FieldSampler(pj).locate(pts)
    bt, et, xt = TORCH.particles.FieldSampler(pt).locate(pts)
    assert np.array_equal(bt, bj) and np.array_equal(et, ej)
    assert (bj < 0).any() and (bj >= 0).any()
    assert _rel(xt, xj) <= RTOL


@pytest.mark.parametrize("elem", ["QUAD9", "QUAD4"])
@pytest.mark.parametrize("var,comp", [("velocity", None), ("velocity", 1),
                                      ("pressure", 0)])
def test_sample(elem, var, comp):
    (pj, xj), (pt, xt) = pair(elem)
    pts = _points()
    a = JAX.particles.FieldSampler(pj).sample(xj, var, pts, comp=comp)
    b = TORCH.particles.FieldSampler(pt).sample(xt, var, pts, comp=comp)
    assert _rel(b, a) <= RTOL


@pytest.mark.parametrize("elem", ["QUAD9", "QUAD4"])
@pytest.mark.parametrize("var", ["velocity", "pressure"])
def test_sample_grad(elem, var):
    (pj, xj), (pt, xt) = pair(elem)
    pts = _points()
    a = JAX.particles.FieldSampler(pj).sample_grad(xj, var, pts)
    b = TORCH.particles.FieldSampler(pt).sample_grad(torch.as_tensor(xt),
                                                     var, pts)
    assert b.shape == (pts.shape[0], pj.dofmap.var(var).ncomp, 2)
    assert _rel(b, a) <= RTOL


def test_trace_particles():
    """RK4 tracers, some leaving the mesh; the port given x as a tensor."""
    (pj, xj), (pt, xt) = pair("QUAD9")
    starts = np.random.default_rng(5).uniform(0.05, 0.95, (8, 2))
    a = JAX.particles.trace_particles(pj, xj, starts, 0.6, 0.02,
                                      save_every=3)
    b = TORCH.particles.trace_particles(pt, torch.as_tensor(xt), starts, 0.6,
                                        0.02, save_every=3)
    assert np.array_equal(b.alive, a.alive) and not a.alive.all()
    assert _rel(b.times, a.times) <= RTOL
    assert _rel(b.positions, a.positions) <= RTOL


def test_trace_inertial_particles():
    """Inertial particles with drag (both Re_p branches), gravity and the
    pressure-gradient force, an initial velocity."""
    (pj, xj), (pt, xt) = pair("QUAD9")
    starts = np.random.default_rng(6).uniform(0.2, 0.8, (6, 2))
    v0 = np.random.default_rng(7).standard_normal((6, 2))
    kw = dict(t_end=0.3, dt=0.01, radius=0.05, rho_p=3.0, mu=0.02,
              rho_f=1.0, gravity=(0.0, -2.0), v0=v0, save_every=2)
    a = JAX.particles.trace_inertial_particles(pj, xj, starts, **kw)
    b = TORCH.particles.trace_inertial_particles(pt, xt, starts, **kw)
    assert np.array_equal(b.alive, a.alive)
    assert _rel(b.positions, a.positions) <= RTOL
    assert _rel(b.velocities, a.velocities) <= RTOL


@pytest.mark.parametrize("name", ["particle_rigid_rotation", "particle_leaves",
                                  "inertial_terminal", "inertial_buoyancy"])
def test_goma_tpu_particle_decks(name):
    """goma_tpu's tests/test_tools.py and test_flux_sens_particles.py
    particle decks (their own gates inside) in both packages."""
    a, b = sd.SMALL[name](JAX), sd.SMALL[name](TORCH)
    assert _rel(b["reading"], a["reading"]) <= RTOL
    assert _rel(b["x"], a["x"]) <= RTOL
