"""The H(curl) edge elements and the electromagnetics of the PyTorch port
against goma_tpu: the Nedelec (N1) tables, the N1 branch of
``eval_fieldvars`` on perturbed QUAD9 and HEX27 elements, every class of
``physics/em.py`` element by element, a signed (TRI6) edge block's arrays
through every consumer of its element Jacobians, goma_tpu's
tests/test_em.py and tests/test_em_edge.py decks on their host ``direct``
solver, and the edge cavity and the nodal waveguide of ``chip_smoke.py``
phases 51-52 at a cut size on bench.py's two device rungs. Each deck is
built in both packages on the CPU in float64 (the port in one torch
thread) from ``scripts/em_decks.py``, written once for both.

Tolerances: the tables equal; field values, curls and test functions
within 1e-12 of each array's max; element residuals and Jacobians, R and
the CSR values within 1e-10 (the same operations, summed in another
order; the readings are ~1e-15); the decks' Newton counts equal and x
within 1e-9 (1 + |x|) on the host rung; on the device rungs (float32
factors) the Newton and linear counts and the ND tree equal and x within
1e-8 (1 + |x|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.fem.fields as j_fields
import goma_tpu.solvers as j_solvers
import goma_tpu_torch.fem.fields as t_fields
import goma_tpu_torch.solvers as t_solvers
from scripts import em_decks
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

JAX = em_decks.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = em_decks.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
FIELD_TOL = 1e-12
RTOL = 1e-10


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _perturbed(P, elem):
    """A mesh whose elements are not affine: 3x3 QUAD9/TRI6 on the unit
    square or 2x2x2 HEX27 on the unit cube, every node moved by a smooth
    seeded field."""
    if elem == "HEX27":
        mesh = P.mesh.box_mesh(2, 2, 2, elem=elem)
    else:
        mesh = P.mesh.rectangle_mesh(3, 3, elem=elem)
    c = mesh.coords
    rng = np.random.default_rng(5)
    a = 0.04 * rng.standard_normal((c.shape[1], 3))
    for k in range(c.shape[1]):
        c[:, k] += a[k, 0] * np.sin(3 * c[:, (k + 1) % c.shape[1]] + a[k, 1]) \
            * np.cos(2 * c[:, k] + a[k, 2])
    return mesh


def _edge_problem(P, elem, mat=None):
    """Both parts of ``EMWaveEdge`` on a perturbed mesh, PEC on "left"."""
    dim = 3 if elem == "HEX27" else 2
    em = P.em
    mat = mat or {"mu_m": 1.3, "eps": 0.9, "sigma_em": 0.5,
                  "J_re": em_decks.edge_materials(P.xp)["J_re"]
                  if dim == 2 else (0.2, -0.1, 0.4)}
    prob = P.Problem(_perturbed(P, elem),
                     [em.EMWaveEdge("real", 6.0, dim=dim),
                      em.EMWaveEdge("imag", 6.0, dim=dim)], mat, **P.kw)
    prob.add_dirichlet("left", em.EDGE_RE, 0, 0.0)
    prob.finalize()
    return prob


def _seeded(prob, seed):
    return np.random.default_rng(seed).standard_normal(prob.dofmap.n_dof)


# ------------------------------------------------------------- N1 tables
@pytest.mark.parametrize("elem", ["QUAD9", "TRI6", "HEX27"])
def test_nedelec_tables_equal(elem):
    """``build_block_tables`` with an N1 slot: the reference vector basis
    and its curl at the volume quadrature points, equal to goma_tpu's."""
    tj = j_fields.build_block_tables(elem, {"N1"}, 3)
    tt = t_fields.build_block_tables(elem, {"N1"}, 3)
    np.testing.assert_array_equal(tt.Nvec["N1"], tj.Nvec["N1"])
    np.testing.assert_array_equal(tt.Ncurl["N1"], tj.Ncurl["N1"])
    np.testing.assert_array_equal(tt.qwts, tj.qwts)


@pytest.mark.parametrize("elem", ["QUAD9", "HEX27"])
def test_eval_fieldvars_nedelec_matches(elem):
    """The N1 branch of ``eval_fieldvars`` on every element of a perturbed
    (non-affine) mesh: the covariant test functions, the values, the rates,
    the curls (2D scalar, 3D vector: J . curl_ref / detJ) and their
    test-function curls, within 1e-12 of goma_tpu's."""
    pj, pt = _edge_problem(JAX, elem), _edge_problem(TORCH, elem)
    bd = pt.dofmap.blocks[0]
    x = _seeded(pt, 1)
    xd = _seeded(pt, 2)
    X = pt.mesh.coords[pt.mesh.blocks[0].conn]
    g = bd.gather

    def jfv(q, qd, Xe):
        fv = j_fields.eval_fieldvars(q, qd, Xe, pj.tables[0],
                                     pj.dofmap.blocks[0].slots, jnp.float64)
        return {k: (getattr(fv, k) if k in ("detJ",) else {
            v: getattr(fv, k)[v] for v in (JAX.em.EDGE_RE, JAX.em.EDGE_IM)})
            for k in ("val", "dot", "phi", "curl", "curl_phi", "detJ")}

    out_j = jax.jit(jax.vmap(jfv))(jnp.asarray(x[g]), jnp.asarray(xd[g]),
                                   jnp.asarray(X))
    for e in range(g.shape[0]):
        fv = t_fields.eval_fieldvars(
            torch.as_tensor(x[g[e]]), torch.as_tensor(xd[g[e]]),
            torch.as_tensor(X[e]), pt.tables[0], bd.slots, torch.float64)
        assert _rel(fv.detJ, out_j["detJ"][e]) <= FIELD_TOL
        for k in ("val", "dot", "phi", "curl", "curl_phi"):
            for v in (TORCH.em.EDGE_RE, TORCH.em.EDGE_IM):
                assert _rel(getattr(fv, k)[v], out_j[k][v][e]) <= FIELD_TOL, (
                    e, k, v)
    assert fv.curl[TORCH.em.EDGE_RE].shape == ((fv.x.shape[0], 3) if elem ==
                                               "HEX27" else (fv.x.shape[0],))


# ------------------------------------------------------ element residuals
def _element_rj(prob, pkg):
    """Every element's (r, J) of block 0 through the package's own element
    residual and ``jacfwd`` (goma_tpu's jitted), at a seeded state and
    history, ct = 1.5."""
    x = _seeded(prob, 3)
    hist = _seeded(prob, 4)
    bd = prob.dofmap.blocks[0]
    g = bd.gather
    X = prob.mesh.coords[prob.mesh.blocks[0].conn]
    sg = bd.edge_signs
    if pkg is JAX:
        params = prob.base_params()
        params["ct"] = jnp.asarray(1.5)
        ext = jnp.zeros((g.shape[0], X.shape[1], 0))
        fn = jax.jacfwd(prob._elem_residual_fn(0), argnums=0, has_aux=True)
        J, r = jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, 0, None if sg is None
                                             else 0, None)))(
            jnp.asarray(x[g]), jnp.asarray(hist[g]), jnp.asarray(X), ext,
            1.0 if sg is None else jnp.asarray(sg), params)
        return np.asarray(r), np.asarray(J)
    from torch.func import jacfwd, vmap

    params = prob.base_params()
    params["ct"] = torch.tensor(1.5, dtype=torch.float64)
    ext = torch.zeros((g.shape[0], X.shape[1], 0), dtype=torch.float64)
    J, r = vmap(jacfwd(prob._elem_residual_fn(0), argnums=0, has_aux=True),
                in_dims=(0, 0, 0, 0, None if sg is None else 0, None))(
        torch.as_tensor(x[g]), torch.as_tensor(hist[g]), torch.as_tensor(X),
        ext, 1.0 if sg is None else torch.as_tensor(sg), params)
    return r.numpy(), J.numpy()


def _nodal(P, cls, dim):
    em = P.em
    E = em.EMWave if cls == "EMWave" else em.EMWaveH
    if dim == 3:
        mesh = P.mesh.box_mesh(2, 2, 1, elem="HEX27")
    else:
        mesh = _perturbed(P, "QUAD9")
    xp = P.xp

    def src(fv, mat, params):
        s = xp.sin(3.0 * fv.x[:, 0]) * xp.cos(2.0 * fv.x[:, 1])
        return xp.stack([s, 0.5 * s, -s][:dim], 1)

    def curl_src(fv, mat, params):
        return xp.cos(2.0 * fv.x[:, 0])[:, None]

    mat = {"mu_m": 1.2, "eps": 0.8, "sigma_em": 0.7}
    if cls == "EMWave":
        mat.update(J_re=src, J_im=(0.3, -0.2, 0.1)[:dim])
    elif dim == 2:
        mat.update(Jc_re=curl_src, Jc_im=0.4)
    else:
        mat.update(Jc_re=(0.3, 0.1, -0.2))
    prob = P.Problem(mesh, [E("real", omega=4.0, dim=dim, alpha=0.7),
                            E("imag", omega=4.0, dim=dim, alpha=0.7)], mat,
                     **P.kw)
    prob.finalize()
    return prob


EM_CLASSES = {
    "EMWave_2d": lambda P: _nodal(P, "EMWave", 2),
    "EMWave_3d": lambda P: _nodal(P, "EMWave", 3),
    "EMWaveH_2d": lambda P: _nodal(P, "EMWaveH", 2),
    "EMWaveH_3d": lambda P: _nodal(P, "EMWaveH", 3),
    "EMWaveEdge_quad": lambda P: _edge_problem(P, "QUAD9"),
    "EMWaveEdge_tri": lambda P: _edge_problem(P, "TRI6"),
    "EMWaveEdge_hex": lambda P: _edge_problem(P, "HEX27"),
    "EMWaveEdge_lossless": lambda P: P.Problem(
        _perturbed(P, "QUAD9"), [P.em.EMWaveEdge("real", 2.0)],
        {"eps": 1.1, "J_im": (0.5, -0.3)}, **P.kw),
}


@pytest.mark.parametrize("cls", list(EM_CLASSES))
def test_em_element_matches(cls):
    """Every volume class of ``physics/em.py`` (nodal E and H forms in 2D
    and 3D with sources, the edge form on QUAD9, TRI6 (edge signs) and
    HEX27 with both parts, and the single-part lossless edge form):
    each element's residual and Jacobian within 1e-10 of goma_tpu's."""
    out = []
    for P in (JAX, TORCH):
        prob = EM_CLASSES[cls](P)
        if not hasattr(prob, "dofmap"):
            prob.finalize()
        out.append(_element_rj(prob, P))
    (rj, Jj), (rt, Jt) = out
    assert np.abs(Jj).max() > 0
    assert _rel(rt, rj) <= RTOL and _rel(Jt, Jj) <= RTOL


@pytest.mark.parametrize("kernel", ["EMAbsorbingBC", "EMAbsorbingBCH"])
def test_em_absorbing_faces_match(kernel):
    """The Silver-Mueller faces (E and H) on the right side of a perturbed
    QUAD9 mesh with both parts of the nodal equation: R and the CSR values
    at a seeded state within 1e-10 of goma_tpu's."""
    out = []
    for P in (JAX, TORCH):
        em = P.em
        E = em.EMWave if kernel == "EMAbsorbingBC" else em.EMWaveH
        prob = P.Problem(_perturbed(P, "QUAD9"),
                         [E("real", 3.0, dim=2), E("imag", 3.0, dim=2)],
                         {"mu_m": 1.4, "eps": 0.9}, **P.kw)
        for part in ("real", "imag"):
            prob.add_face_kernel("right", getattr(em, kernel)(part, 3.0, dim=2))
        prob.finalize()
        R, vals = prob.assemble(P.arr(_seeded(prob, 6)), prob.base_params())
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


# ----------------------------------------------------------- signed block
@pytest.fixture(scope="module")
def signed_pair():
    pj, pt = _edge_problem(JAX, "TRI6"), _edge_problem(TORCH, "TRI6")
    assert pt.dofmap.blocks[0].edge_signs is not None
    return pj, pt


def test_signed_block_system_matches(signed_pair):
    """A TRI6 edge block whose structured split opposes the global edge
    orientation (per-element signs): the signs, R and the CSR values of
    ``assemble``, and R of ``residual`` (the residual-only pass) within
    1e-10 of goma_tpu's."""
    pj, pt = signed_pair
    np.testing.assert_array_equal(pt.dofmap.blocks[0].edge_signs,
                                  pj.dofmap.blocks[0].edge_signs)
    x = _seeded(pt, 7)
    Rj, Vj = pj.assemble(jnp.asarray(x), pj.base_params())
    Rt, Vt = pt.assemble(torch.as_tensor(x), pt.base_params())
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL
    assert _rel(pt.residual(torch.as_tensor(x), pt.base_params()), Rj) <= RTOL


@pytest.mark.parametrize("jdt", ["float64", "float32"])
def test_signed_block_consumers_match(signed_pair, jdt):
    """Every consumer of a signed block's element Jacobians sees S J S: the
    element Jacobians and row sums of ``_assemble_fast`` (at the float32
    Jacobian dtype too, the prep ``prep32_tol`` switches to) against
    goma_tpu's, and the port's ``element_matvec`` against its own CSR
    values (row-scaled, Dirichlet rows identity)."""
    pj, pt = signed_pair
    x = _seeded(pt, 8)
    pj.jacobian_dtype = getattr(jnp, jdt)
    pt.jacobian_dtype = getattr(torch, jdt)
    try:
        Rj, rsj, auxj = pj._assemble_fast(jnp.asarray(x), pj.base_params())
        Rt, rst, auxt = pt._assemble_fast(torch.as_tensor(x), pt.base_params())
        tol = RTOL if jdt == "float64" else 1e-6
        assert _rel(Rt, Rj) <= RTOL
        assert _rel(rst, rsj) <= tol
        assert _rel(auxt[0][0], auxj[0][0]) <= tol
        v = torch.as_tensor(_seeded(pt, 9), dtype=getattr(torch, jdt))
        scale = 1.0 / rst
        y = pt.element_matvec(None, auxt, scale, v)
        _, vals = pt._assemble(torch.as_tensor(x), pt.base_params())
        A = torch.sparse_csr_tensor(
            torch.as_tensor(pt.pattern.indptr, dtype=torch.int64),
            torch.as_tensor(pt.pattern.indices, dtype=torch.int64),
            vals, size=(pt.dofmap.n_dof,) * 2)
        y_csr = (A @ v.double()) * scale.double()
        assert _rel(y, y_csr) <= (1e-12 if jdt == "float64" else 1e-5)
    finally:
        pj.jacobian_dtype = pt.jacobian_dtype = None


# ----------------------------------------------------------------- decks
@pytest.mark.parametrize("deck", list(em_decks.EM_SMALL))
def test_em_decks_match(deck):
    """goma_tpu's tests/test_em.py (plane waves and lossy decay, E and H
    forms, Silver-Mueller faces), tests/test_em_edge.py (the constant
    patch, the TE(1,1) mode on QUAD9 and on signed TRI6, the 3D HEX27
    manufactured field), the H far-field row sum of
    tests/test_bc_machinery_audit.py and the edge form's finite-difference
    Jacobian check of tests/test_numjac_new_kernels.py, each with its own
    gate, in both packages on the host ``direct`` rung: the same Newton
    count and x (or R) within 1e-9 (1 + |x|)."""
    oj = em_decks.SMALL[deck](JAX)
    ot = em_decks.SMALL[deck](TORCH)
    assert ot["newton"] == oj["newton"]
    assert np.max(np.abs(ot["x"] - oj["x"]) / (1.0 + np.abs(oj["x"]))) <= 1e-9


RUNG_DECKS = {"cavity": lambda P: em_decks.edge_cavity(P, 16),
              "waveguide": lambda P: em_decks.waveguide(P, 20, 4)}


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
@pytest.mark.parametrize("deck", list(RUNG_DECKS))
def test_em_device_rungs(deck, kind):
    """The edge cavity (16x16) and the nodal waveguide (20x4) of phases
    51-52 from x = 0 on bench.py's two device rungs
    (``_cavity_opts(kind, tol=1e-9, max_iter=8)``, float64 Jacobian):
    goma_tpu's Newton and linear counts and ND levels, x within 1e-8
    (1 + |x|)."""
    from test_torch_overset import bench_opts

    pj, pt = RUNG_DECKS[deck](JAX), RUNG_DECKS[deck](TORCH)
    assert (pt.dofmap.n_dof, pt.pattern.nnz) == (pj.dofmap.n_dof,
                                                 pj.pattern.nnz)
    sj = j_solvers.NewtonSolver(pj, bench_opts(j_solvers.NewtonOptions, kind,
                                               max_iter=8))
    st = t_solvers.NewtonSolver(pt, bench_opts(t_solvers.NewtonOptions, kind,
                                               max_iter=8))
    x0 = np.zeros(pt.dofmap.n_dof)
    rj = sj.solve(x0, pj.base_params())
    rt = st.solve(x0, pt.base_params())
    assert rj.converged and rt.converged, (rj.summary(), rt.summary())
    assert (rt.iters, rt.linear_iters) == (rj.iters, rj.linear_iters)
    ndj = sj.precond if kind == "gmres+ndlu" else sj._ndlu
    ndt = st.precond if kind == "gmres+ndlu" else st._ndlu
    assert [(lv.nn, lv.smax) for lv in ndt.levels] == \
        [(int(lv.nn), int(lv.smax)) for lv in ndj.levels]
    assert np.max(np.abs(rt.x - rj.x) / (1.0 + np.abs(rj.x))) <= 1e-8
