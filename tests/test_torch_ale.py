"""ALE pieces of the PyTorch port against goma_tpu, float64, at seeded
random states handed to both packages (numpy in, arrays compared):

- ``eval_fieldvars`` with a mesh-displacement variable (x, wdetJ, X0,
  wdetJ0, F, gphi0, grad0 on every element of a displaced 2x2 QUAD9 mesh)
  and the element residual and Jacobian of a transient Momentum +
  Continuity block with each mesh equation (``EllipticMesh``,
  ``PseudoSolidMesh``, ``LinearElasticMesh``): rel 1e-10 of each array's
  max (each variable's rows apart for the element arrays; the same
  integrands in the same dtype, differing in summation order only);
- ``advective_velocity`` on the moving mesh: u - d_dot as goma_tpu's,
  rel 1e-12, and away from u by the mesh velocity;
- ``eval_surfacevars`` (normal, wdA, x, values, gradients, time
  derivatives on each face) and the face residual and Jacobian of each of
  ``bc/free_surface.py``'s five kernels on the top side set of a displaced
  4x2 mesh: rel 1e-10;
- ``make_quality_fn`` (min and max detJ, jacobian quality) on a displaced
  mesh and on one with a tangled element (min detJ < 0): rel 1e-12, and
  ``element_quality``'s ``ok`` flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.bc.free_surface as jbc
import goma_tpu.fem.assembly as jasm
import goma_tpu.fem.fields as jfields
import goma_tpu.physics.fluid as jfluid
import goma_tpu.post.quality as jquality
import goma_tpu_torch.bc as tbc
import goma_tpu_torch.fem.assembly as tasm
import goma_tpu_torch.fem.fields as tfields
import goma_tpu_torch.physics.fluid as tfluid
import goma_tpu_torch.post.quality as tquality
from goma_tpu_torch.interop import params_from_numpy
from test_torch_host import JAX_PKG, TORCH_PKG, cpu
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

MESH_EQS = ("EllipticMesh", "PseudoSolidMesh", "LinearElasticMesh")
RTOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _ale_deck(pkg, mesh_eq, nx=2, ny=2, face_kernel=None):
    """A transient Momentum + Continuity + ``mesh_eq`` block on an nx x ny
    QUAD9 mesh, with ``face_kernel`` on the top side set."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(nx, ny, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, 1.0))
    prob = fem.Problem(
        mesh, [phys.Momentum(dim=2, transient=True), phys.Continuity(),
               getattr(phys, mesh_eq)(2)],
        {"rho": 0.7, "mu": 0.3, "sigma": 0.7, "mesh_shear_modulus": 1.3,
         "mesh_lambda": 0.6}, **cpu(pkg))
    if face_kernel is not None:
        prob.add_face_kernel("top", face_kernel)
    prob.add_dirichlet("bottom", "mesh_displacement", 1, 0.0)
    prob.finalize()
    return prob


def _state(prob, seed, disp=0.03):
    """Seeded x (velocity, pressure ~1, displacements ~``disp``), history
    and params with ct = 3 and time 0.5."""
    rng = np.random.default_rng(seed)
    n = prob.dofmap.n_dof
    x = rng.standard_normal(n)
    for c in (0, 1):
        d = prob.dofmap.dof_of_node_svar[:, prob.dofmap.svar("mesh_displacement", c)]
        x[d[d >= 0]] = disp * rng.standard_normal(int((d >= 0).sum()))
    return x, {"ct": 3.0, "hist": rng.standard_normal(n), "time": 0.5,
               "dirichlet_val": np.asarray(prob.dirichlet_vals)}


def _jax_params(pj, p):
    out = pj.base_params()
    out["ct"], out["hist"] = jnp.asarray(p["ct"]), jnp.asarray(p["hist"])
    out["time"] = jnp.asarray(p["time"])
    return out


def _fieldvars(pj, pt, x, p):
    """Both packages' FieldVars of every element at (x, p): lists."""
    bd, tab = pj.dofmap.blocks[0], pj.tables[0]
    X = pj.mesh.coords[pj.mesh.blocks[0].conn]
    q, qdot = x[bd.gather], p["ct"] * x[bd.gather] + p["hist"][bd.gather]
    fj = [jfields.eval_fieldvars(jnp.asarray(q[e]), jnp.asarray(qdot[e]),
                                 jnp.asarray(X[e]), tab, bd.slots, jnp.float64)
          for e in range(q.shape[0])]
    ft = [tfields.eval_fieldvars(torch.as_tensor(q[e]), torch.as_tensor(qdot[e]),
                                 torch.as_tensor(X[e]), pt.tables[0],
                                 pt.dofmap.blocks[0].slots, torch.float64)
          for e in range(q.shape[0])]
    return fj, ft


def test_ale_fieldvars_match():
    pj, pt = (_ale_deck(pkg, "EllipticMesh") for pkg in (JAX_PKG, TORCH_PKG))
    x, p = _state(pj, seed=3)
    fj, ft = _fieldvars(pj, pt, x, p)
    for a, b in zip(ft, fj):
        assert a.F is not None and b.F is not None
        for k in ("x", "wdetJ", "X0", "wdetJ0", "F", "detJ"):
            assert _rel(getattr(a, k), getattr(b, k)) <= RTOL, k
        for v in b.grad0:
            assert _rel(a.gphi0[v], b.gphi0[v]) <= RTOL, v
            assert _rel(a.grad0[v], b.grad0[v]) <= RTOL, v
            assert _rel(a.grad[v], b.grad[v]) <= RTOL, v
        # the reference configuration differs from the displaced one
        assert np.abs(np.asarray(a.X0) - np.asarray(a.x)).max() > 1e-3


@pytest.mark.parametrize("mesh_eq", MESH_EQS)
def test_ale_element_residual_and_jacobian_match(mesh_eq):
    pj, pt = (_ale_deck(pkg, mesh_eq) for pkg in (JAX_PKG, TORCH_PKG))
    assert not pt._fast_meta
    x, p = _state(pj, seed=5)
    rj, Jj = jax.jit(lambda xx, pp: pj._elem_rj_parts(xx, pp, pj._tables)[:2])(
        jnp.asarray(x), _jax_params(pj, p))
    rt, Jt, _, _ = pt._elem_rj_parts(torch.as_tensor(x),
                                     params_from_numpy(p, device="cpu"),
                                     pt._tables)
    rj, Jj, rt, Jt = (np.asarray(rj[0]), np.asarray(Jj[0]), rt[0].numpy(),
                      Jt[0].numpy())
    assert np.isfinite(Jt).all()
    for s in pt.dofmap.blocks[0].slots:  # each variable's rows apart
        rows = slice(s.start, s.start + s.size)
        assert _rel(rt[:, rows], rj[:, rows]) <= RTOL, s.var
        assert _rel(Jt[:, rows], Jj[:, rows]) <= RTOL, s.var


def test_advective_velocity_subtracts_mesh_velocity():
    pj, pt = (_ale_deck(pkg, "EllipticMesh") for pkg in (JAX_PKG, TORCH_PKG))
    x, p = _state(pj, seed=7)
    fj, ft = _fieldvars(pj, pt, x, p)
    for a, b in zip(ft, fj):
        got = tfluid.advective_velocity(a)
        assert _rel(got, jfluid.advective_velocity(b)) <= 1e-12
        ddot = np.asarray(a.dot["mesh_displacement"])
        np.testing.assert_allclose(np.asarray(a.val["velocity"]) - np.asarray(got),
                                   ddot, rtol=0, atol=1e-14)
        assert np.abs(ddot).max() > 0.1  # the mesh moves


def _flux(sfv, mat, params):
    return 2.0 * sfv.val["velocity"][:, 0:1] - 0.4


FACE_KERNELS = {
    "CapillaryBC": lambda m: m.CapillaryBC(dim=2, p_ext=0.3),
    "KinematicBC": lambda m: m.KinematicBC(dim=2, penalty=10.0, leak=0.1),
    "NormalFlux": lambda m: m.NormalFlux("pressure", _flux),
    "Traction": lambda m: m.Traction(dim=2, traction=[0.3, -0.2]),
    "SurfaceViscosity": lambda m: m.SurfaceViscosity(
        dim=2, mu_s=0.2, kappa_s=0.1, time_start=0.0, time_full=1.0),
}


def _face_decks(name):
    return (_ale_deck(JAX_PKG, "EllipticMesh", 4, 2, FACE_KERNELS[name](jbc)),
            _ale_deck(TORCH_PKG, "EllipticMesh", 4, 2, FACE_KERNELS[name](tbc)))


def test_surfacevars_match():
    pj, pt = _face_decks("CapillaryBC")
    x, p = _state(pj, seed=9)
    fsj, fst = pj.face_sets[0], pt.face_sets[0]
    np.testing.assert_array_equal(fst.face_elems, fsj.face_elems)
    bd = pj.dofmap.blocks[0]
    X = pj.mesh.coords[pj.mesh.blocks[0].conn[fsj.face_elems]]
    g = bd.gather[fsj.face_elems]
    q, qdot = x[g], p["ct"] * x[g] + p["hist"][g]
    for i in range(g.shape[0]):
        sj = jasm.eval_surfacevars(
            jnp.asarray(q[i]), jnp.asarray(qdot[i]), jnp.asarray(X[i]),
            {k: jnp.asarray(v[i]) for k, v in fsj.ftabs.items()},
            jnp.asarray(fsj.fwts), bd.slots, 2, jnp.float64)
        st = tasm.eval_surfacevars(
            torch.as_tensor(q[i]), torch.as_tensor(qdot[i]), torch.as_tensor(X[i]),
            {k: torch.as_tensor(v[i]) for k, v in fst.ftabs.items()},
            torch.as_tensor(fst.fwts), pt.dofmap.blocks[0].slots, 2,
            torch.float64)
        for k in ("normal", "wdA", "x", "tangents", "h_elem"):
            assert _rel(getattr(st, k), getattr(sj, k)) <= RTOL, k
        for v in sj.val:
            for k in ("val", "grad", "dot", "gphi"):
                assert _rel(getattr(st, k)[v], getattr(sj, k)[v]) <= RTOL, (k, v)
        # the top faces' outward normal points up
        assert np.asarray(st.normal)[:, 1].min() > 0.5


@pytest.mark.parametrize("name", list(FACE_KERNELS))
def test_free_surface_face_residual_and_jacobian_match(name):
    pj, pt = _face_decks(name)
    x, p = _state(pj, seed=11)
    rj, _, fJj, _ = jax.jit(lambda xx, pp: pj._elem_rj_parts(xx, pp, pj._tables))(
        jnp.asarray(x), _jax_params(pj, p))
    rt, _, fJt, _ = pt._elem_rj_parts(torch.as_tensor(x),
                                      params_from_numpy(p, device="cpu"),
                                      pt._tables)
    assert len(rt) == len(rj) == 2 and len(fJt) == len(fJj) == 1
    r_face, J_face = rt[1].numpy(), fJt[0].numpy()
    assert np.abs(r_face).max() > 0 and np.isfinite(J_face).all()
    assert _rel(r_face, rj[1]) <= RTOL
    assert _rel(J_face, fJj[0]) <= RTOL


def _tangle(prob, x, elem=0):
    """Move one element's interior (centre) node past a corner: that
    element's map folds (detJ < 0 at some quadrature points)."""
    conn = prob.mesh.blocks[0].conn[elem]
    centre, corner = conn[8], conn[2]
    d = prob.mesh.coords[corner] - prob.mesh.coords[centre]
    for c in (0, 1):
        dof = prob.dofmap.dof_of_node_svar[centre, prob.dofmap.svar("mesh_displacement", c)]
        x[dof] = 1.6 * d[c]
    return x


@pytest.mark.parametrize("tangled", [False, True])
def test_quality_matches(tangled):
    pj, pt = (_ale_deck(pkg, "EllipticMesh", 4, 2) for pkg in (JAX_PKG, TORCH_PKG))
    x, _ = _state(pj, seed=13, disp=0.02)
    if tangled:
        x = _tangle(pj, x)
    want = [float(v) for v in jquality.make_quality_fn(pj)(jnp.asarray(x))]
    got = tquality.make_quality_fn(pt)(x)
    assert all(torch.is_tensor(v) and v.ndim == 0 for v in got)
    for a, b in zip(got, want):
        assert abs(float(a) - b) <= 1e-12 * max(abs(b), 1e-300)
    rep = tquality.element_quality(pt, x)
    assert (rep.min_detJ < 0) == tangled and rep.ok == (not tangled)
    assert rep.ok == jquality.element_quality(pj, jnp.asarray(x)).ok
