"""The shell layer of the PyTorch port against goma_tpu: surface-shell and
Hermite field evaluation, bar-endpoint faces, the shell equations
(``physics/shell.py``), the shell-end and sheet conditions
(``bc/shell_end.py``, ``bc/sheet.py``) and the 8x8 thermal slider bearing
on both device rungs, each deck built in both packages on the CPU in
float64 (the port in one torch thread). The decks and their material
callables are ``scripts/shell_decks.py``'s, written once for both
packages.

Tolerances: host tables (shell connectivity) equal; field evaluations,
residuals and CSR values within 1e-12 of each array's max (the same
operations, summed in another order); the bearing's Newton and linear
counts equal and x within 1e-8 (1 + |x|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.bc.sheet as j_sheet
import goma_tpu.bc.shell_end as j_shell_end
import goma_tpu.fem as jfem
import goma_tpu.fem.equations as j_eqs
import goma_tpu.fem.fields as j_fields
import goma_tpu.mesh as jmesh
import goma_tpu.physics as jphys
import goma_tpu.solvers as j_solvers
import goma_tpu.solvers.transient as j_transient
import goma_tpu_torch.bc.sheet as t_sheet
import goma_tpu_torch.bc.shell_end as t_shell_end
import goma_tpu_torch.fem as tfem
import goma_tpu_torch.fem.equations as t_eqs
import goma_tpu_torch.fem.fields as t_fields
import goma_tpu_torch.mesh as tmesh
import goma_tpu_torch.physics as tphys
import goma_tpu_torch.solvers as t_solvers
import goma_tpu_torch.solvers.transient as t_transient
from scripts import shell_decks
from test_torch_ale import one_torch_thread  # noqa: F401  (autouse)
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)

JAX = shell_decks.namespace(jmesh, jfem, jphys, j_eqs, j_fields, j_shell_end,
                            j_sheet, j_solvers, j_transient, jnp, jnp.asarray)
TORCH = shell_decks.namespace(
    tmesh, tfem, tphys, t_eqs, t_fields, t_shell_end, t_sheet, t_solvers,
    t_transient, torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")
RTOL = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def seeded_state(prob, fields, seed):
    """x with each (var, comp, lo, hi) of ``fields`` uniform in [lo, hi]
    at every node (numpy seeded)."""
    rng = np.random.default_rng(seed)
    x = np.zeros(prob.dofmap.n_dof)
    for var, comp, lo, hi in fields:
        x = prob.set_nodal_field(x, var, comp,
                                 lo + (hi - lo) * rng.random(prob.mesh.n_nodes))
    return x


def system_parity(build, fields, seed=0, ct=0.0, time=0.0):
    """``build(P) -> problem`` in both packages; R and the CSR values of
    ``_assemble`` at a seeded state (``fields``), a seeded history, ``ct``
    and ``time``, port against goma_tpu."""
    out = []
    for P in (JAX, TORCH):
        prob = build(P)
        if not hasattr(prob, "dofmap"):
            prob.finalize()
        x = seeded_state(prob, fields, seed)
        hist = np.random.default_rng(seed + 1).standard_normal(prob.dofmap.n_dof)
        params = prob.base_params()
        params.update(ct=P.arr(ct), hist=P.arr(hist), time=P.arr(time))
        R, vals = prob.assemble(P.arr(x), params)  # goma_tpu's jit
        out.append((_np(R), _np(vals)))
    (Rj, Vj), (Rt, Vt) = out
    assert np.abs(Rj).max() > 0 and np.abs(Vj).max() > 0
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL, (_rel(Rt, Rj),
                                                            _rel(Vt, Vj))
    return out


# ------------------------------------------------------------ shell blocks
@pytest.mark.parametrize("elem", ["QUAD4", "QUAD9", "HEX8", "HEX20", "HEX27",
                                  "TET4", "TET10"])
def test_attach_shell_block_equal(elem):
    """``attach_shell_block``: BAR2/BAR3 on 2D faces, QUAD4/8/9 and TRI3/6
    on 3D faces, the same element type and connectivity as goma_tpu's."""
    out = []
    for P in (JAX, TORCH):
        if elem.startswith("QUAD"):
            mesh = P.mesh.rectangle_mesh(3, 2, elem=elem)
            ss = "bottom"
        else:
            mesh = P.mesh.box_mesh(2, 2, 1, elem=elem)
            ss = "top"
        bi = P.phys.attach_shell_block(mesh, ss, "shell")
        out.append((mesh.blocks[bi].elem_type, mesh.blocks[bi].conn))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])


def _surface_deck(P, elem):
    """A curved 3D surface shell: the top face of a 2x2x1 box, its z
    bumped, with a Q2 (or P2) temperature, a Q1 vector and an external
    field."""
    mesh = P.mesh.box_mesh(2, 2, 1, elem=elem)
    c = mesh.coords
    c[:, 2] += 0.15 * np.sin(2.0 * c[:, 0] + 1.0) * np.cos(1.5 * c[:, 1]) * c[:, 2]
    bi = P.phys.attach_shell_block(mesh, "top", "lid")
    itp, lin = ("Q2", "Q1") if elem == "HEX27" else ("P2", "P1")
    prob = P.Problem(mesh, [[], [P.shell.ShellConduction(1.0, interp=itp),
                                 P.eqs.PassiveVar("velocity", 3, lin)]],
                     [{}, {}], external_fields=("tamb",), **P.kw)
    prob.finalize()
    return prob, bi


@pytest.mark.parametrize("elem", ["HEX27", "TET10"])
def test_eval_surfvars_matches(elem):
    """``eval_surfvars`` on a curved QUAD9 (TRI6) shell element in 3D, array
    for array: position, measure, tangent map, normal, element size,
    bases, surface gradients, values, rates and an external field."""
    fvs = []
    for P, f, arr in ((JAX, j_fields, jnp.asarray), (TORCH, t_fields,
                                                     TORCH.arr)):
        prob, bi = _surface_deck(P, elem)
        bd, blk = prob.dofmap.blocks[bi], prob.mesh.blocks[bi]
        r = np.random.default_rng(3)
        q = r.standard_normal(bd.n_ldof)
        qd = r.standard_normal(bd.n_ldof)
        ext = r.standard_normal((blk.conn.shape[1], 1))
        X = prob.mesh.coords[blk.conn[1]]
        dt = jnp.float64 if P is JAX else torch.float64
        fvs.append(f.eval_surfvars(arr(q), arr(qd), arr(X), prob.tables[bi],
                                   bd.slots, dt, arr(ext), ("tamb",)))
    fj, ft = fvs
    for name in ("x", "wdetJ", "detJ", "normal", "tangents", "h_elem"):
        assert _rel(getattr(ft, name), getattr(fj, name)) <= RTOL, name
    for d in ("phi", "gphi", "val", "grad", "dot", "ext", "ext_grad"):
        for k in getattr(fj, d):
            assert _rel(getattr(ft, d)[k], getattr(fj, d)[k]) <= RTOL, (d, k)


def _beam_deck(P, tension=0.7):
    mesh = P.mesh.rectangle_mesh(4, 1, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 0.1))
    c = mesh.coords
    c[:, 1] += 0.1 * np.sin(c[:, 0])  # a curved beam: ds/dxi varies
    bi = P.phys.attach_shell_block(mesh, "bottom", "beam")
    blk = mesh.blocks[bi]
    blk.elem_type = "BAR2"
    blk.conn = blk.conn[:, :2].copy()
    xp = P.xp
    load = lambda fv, mat, params: 1.5 + 0.3 * xp.sin(fv.x[:, 0])  # noqa: E731
    prob = P.Problem(mesh, [[], [P.shell.BeamBending(EI=2.0, load=load,
                                                     tension=tension),
                                 P.eqs.PassiveVar("temperature", 1, "Q1")]],
                     [{}, {}], **P.kw)
    prob.finalize()
    return prob, bi


def test_hermite_curvevars_matches():
    """The Hermite (H3) branch of ``eval_curvevars`` on a curved BAR2
    element, array for array: the slope basis scaled by ds/dxi, its first
    and second arc-length derivatives, values and slopes."""
    fvs = []
    for P, f in ((JAX, j_fields), (TORCH, t_fields)):
        prob, bi = _beam_deck(P)
        bd, blk = prob.dofmap.blocks[bi], prob.mesh.blocks[bi]
        r = np.random.default_rng(5)
        q, qd = r.standard_normal(bd.n_ldof), r.standard_normal(bd.n_ldof)
        dt = jnp.float64 if P is JAX else torch.float64
        fvs.append(f.eval_curvevars(P.arr(q), P.arr(qd),
                                    P.arr(prob.mesh.coords[blk.conn[2]]),
                                    prob.tables[bi], bd.slots, dt))
    fj, ft = fvs
    for name in ("x", "wdetJ", "tangent", "normal", "h_elem"):
        assert _rel(getattr(ft, name), getattr(fj, name)) <= RTOL, name
    for d in ("phi", "gphi", "val", "grad", "dot", "dphi_ds", "grad_s",
              "d2phi_ds2", "d2s"):
        for k in getattr(fj, d):
            assert _rel(getattr(ft, d)[k], getattr(fj, d)[k]) <= RTOL, (d, k)


def test_beam_bending_system_matches():
    """BeamBending on H3 slots (with tension and a callable load) on a
    curved bar chain: R and the CSR values at a seeded state."""
    system_parity(lambda P: _beam_deck(P)[0],
                  [("beam_w", 0, -0.1, 0.1), ("beam_w", 1, -0.2, 0.2),
                   ("temperature", 0, 0.0, 1.0)])


# ------------------------------------------------------------ curve shells
def _curve_mesh(P, nx=4, curved=True):
    mesh = P.mesh.rectangle_mesh(nx, 2, elem="QUAD9", xlim=(0, 1.5))
    if curved:
        c = mesh.coords
        c[:, 1] += 0.12 * np.sin(np.pi * c[:, 0] / 1.5) * (1 - c[:, 1])
    return mesh, P.phys.attach_shell_block(mesh, "bottom", "shell")


def _structure(P):
    mesh, bi = _curve_mesh(P)
    xp = P.xp
    mat = {"p_load": lambda fv, m, p: 1.0 + 0.5 * fv.x[:, 0],
           "qs_source": lambda fv, m, p: xp.cos(fv.x[:, 0]),
           "shell_rho": 1.3}
    load = lambda fv, m, p: 0.4 + fv.x[:, 0] ** 2  # noqa: E731
    return P.Problem(mesh, [[], [
        P.shell.ShellCurvature(bend_stiffness=2.0, interp="Q2"),
        P.shell.ShellTension(bend_stiffness=2.0, interp="Q2"),
        P.shell.TensionedString(3.0, load, interp="Q2", transient=True),
        P.shell.SurfaceCharge(0.2, interp="Q2", transient=True)]],
        [{}, mat], **P.kw)


def _rheo(P):
    mesh, bi = _curve_mesh(P)
    ends = P.shell_end.shell_end_sidesets(mesh, bi, prefix="rheo_end")
    prob = P.Problem(mesh, [[], [
        P.shell.ShellSurfDivV(interp="Q2"),
        P.eqs.PassiveVar("velocity", 2, "Q2"),
        P.shell.ShellSurfCurv(interp="Q2", surf_diff=0.3),
        P.eqs.PassiveVar("normal", 2, "Q2"),
        P.shell.ShellDiffusionFlux(interp="Q2")]],
        [{}, {"surf_div_diff": 0.05, "surf_diff_Ds": 0.7,
              "surf_energy_Gs": 1.1}], **P.kw)
    prob.add_face_kernel(ends[0], P.shell.Gamma1DerivBC(g=0.3, penalty=1e3))
    prob.add_face_kernel(ends[1], P.shell.Gamma1DerivBC(g=-0.2, penalty=1e3))
    return prob


def _coords(P, material=False):
    mesh, bi = _curve_mesh(P)
    eqs = [P.shell.ShellCoordinates(interp="Q2", penalty=50.0),
           P.shell.ShellDiffKinematic(interp="Q2", penalty=20.0),
           P.eqs.PassiveVar("sh_J", 1, "Q2")]
    mat = {}
    if material:
        mat["shell_curvature"] = lambda fv, m, p: 0.5 + fv.x[:, 0]
    else:
        eqs.append(P.eqs.PassiveVar("sh_K", 1, "Q2"))
    return P.Problem(mesh, [[], eqs], [{}, mat], **P.kw)


def _normal_angle_2d(P):
    mesh, bi = _curve_mesh(P)
    return P.Problem(mesh, [[], [P.shell.ShellNormal(2, interp="Q2"),
                                 P.shell.ShellAngle(2, interp="Q2")]],
                     [{}, {}], **P.kw)


def _cylinder_shell(P):
    mesh = shell_decks._cylinder_surface_mesh(P, 8, 2, 1.0, 1.0)
    return P.Problem(mesh, [P.shell.ShellConduction(0.8, interp="Q1"),
                            P.shell.ShellNormal(3, interp="Q1"),
                            P.shell.ShellAngle(3, interp="Q1"),
                            P.shell.ShellCurvaturePair(interp="Q1"),
                            P.shell.SurfaceCharge(0.3, interp="Q1",
                                                  transient=True)],
                     {}, **P.kw)


def _shell_grad(P):
    mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD4", xlim=(0, 1.5))
    P.phys.attach_shell_block(mesh, "bottom", "shell")
    eqs = [[P.eqs.PassiveVar("voltage", 1, "Q1"),
            P.eqs.PassiveVar("velocity", 2, "Q1"),
            P.eqs.PassiveVar("pressure", 1, "Q1"),
            P.eqs.PassiveVar("surface_charge", 1, "Q1", reg=1e-8),
            P.eqs.PassiveVar("sh_tens", 1, "Q1", reg=1e-8)],
           [P.shell.SurfaceCharge(0.5, interp="Q1", transient=False),
            P.eqs.PassiveVar("sh_tens", 1, "Q1", reg=1e-8)]]
    prob = P.Problem(mesh, eqs, [{"mu": 1.3}, {}], **P.kw)
    prob.add_face_kernel("bottom", P.shell.ShellGradBC(
        "surface_charge", P.shell.bulk_normal_current(2.0)))
    prob.add_face_kernel("bottom", P.shell.ShellGradBC(
        "sh_tens", P.sheet.bulk_shear_to_tension(0.8), sign=-1.0))
    return prob


def _tie_fluid(P):
    mesh, bi = _curve_mesh(P, curved=True)
    eqs = [[P.phys.Momentum(dim=2, interp="Q2", transient=False),
            P.phys.Continuity(interp="Q1")],
           [P.shell.ShellCurvature(bend_stiffness=1.5, interp="Q2"),
            P.shell.ShellTension(bend_stiffness=1.5, interp="Q2")]]
    prob = P.Problem(mesh, eqs, [{"rho": 1.0, "mu": 1.0}, {"p_load": 0.3}],
                     **P.kw)
    P.shell.tie_fluid_shell(prob, mesh, "bottom", ["bottom"], scale=0.7)
    return prob


def _endpoints(P):
    mesh, bi = _curve_mesh(P)
    P.shell_end.shell_end_sidesets(mesh, bi, prefix="e")
    xp = P.xp
    prob = P.Problem(mesh, [[], [P.shell.ShellConduction(1.2, interp="Q2")]],
                     [{}, {"wall_velocity": np.array([0.6, -0.2])}], **P.kw)
    prob.add_face_kernel("e_0", P.shell_end.EndpointFlux(
        "temperature", lambda s, m, p: 0.3 + s.x[:, :1] ** 2))
    prob.add_face_kernel("e_0", P.shell_end.EndpointAdvectiveOutflow(
        "temperature"))
    prob.add_face_kernel("e_1", P.shell_end.EndpointFlux("temperature", -0.4))
    prob.add_face_kernel("e_1", P.shell_end.EndpointAdvectiveOutflow(
        "temperature", velocity=lambda s, m, p: xp.stack(
            [1.0 + s.x[:, 1], s.x[:, 0]], 1)))
    return prob


SH = ("sh_K", "sh_tens")
CURVE_DECKS = {
    "structure": (_structure, [("sh_K", 0, -0.5, 0.5), ("sh_tens", 0, 0.5, 1.5),
                               ("shell_deflection", 0, -0.1, 0.1),
                               ("surface_charge", 0, 0.5, 1.5)], 2.0),
    "surface_rheology": (_rheo, [("surf_div_v", 0, -1, 1),
                                 ("velocity", 0, -1, 1), ("velocity", 1, -1, 1),
                                 ("surf_curv", 0, -1, 1), ("normal", 0, -1, 1),
                                 ("normal", 1, -1, 1), ("sh_J", 0, -1, 1)], 0.0),
    "coordinates": (_coords, [("mesh_displacement", 0, -0.02, 0.02),
                              ("mesh_displacement", 1, -0.02, 0.02),
                              ("sh_J", 0, -1, 1), ("sh_K", 0, -1, 1)], 1.5),
    "coordinates_material": (lambda P: _coords(P, True),
                             [("mesh_displacement", 0, -0.02, 0.02),
                              ("mesh_displacement", 1, -0.02, 0.02),
                              ("sh_J", 0, -1, 1)], 1.5),
    "normal_angle_2d": (_normal_angle_2d, [("shell_normal", 0, -1, 1),
                                           ("shell_normal", 1, -1, 1),
                                           ("shell_angle", 0, -1, 1)], 0.0),
    "surface_3d": (_cylinder_shell, [("temperature", 0, 0, 1),
                                     ("shell_normal", 0, -1, 1),
                                     ("shell_normal", 1, -1, 1),
                                     ("shell_normal", 2, -1, 1),
                                     ("shell_angle", 0, -1, 1),
                                     ("shell_angle", 1, -1, 1),
                                     ("sh_K_pair", 0, -1, 1),
                                     ("sh_K_pair", 1, -1, 1),
                                     ("surface_charge", 0, 0, 1)], 3.0),
    "shell_grad_bc": (_shell_grad, [("voltage", 0, -1, 1),
                                    ("velocity", 0, -1, 1),
                                    ("velocity", 1, -1, 1),
                                    ("pressure", 0, -1, 1),
                                    ("surface_charge", 0, 0, 1),
                                    ("sh_tens", 0, 0, 1)], 0.0),
    "tie_fluid_shell": (_tie_fluid, [("velocity", 0, -1, 1),
                                     ("velocity", 1, -1, 1),
                                     ("pressure", 0, -1, 1),
                                     ("sh_K", 0, -1, 1), ("sh_tens", 0, 0, 1)],
                        0.0),
    "endpoints": (_endpoints, [("temperature", 0, 0, 1)], 0.0),
}


@pytest.mark.parametrize("deck", list(CURVE_DECKS))
def test_shell_equations_match(deck):
    """Every shell equation class and shell face kernel on a small deck of
    its own (curved bar shells in 2D, a cylinder surface in 3D; the
    bar-endpoint faces with their signed conormal): R and the CSR values
    at a seeded state, with a seeded history and ct for the transient
    terms, and the row injections of ``tie_fluid_shell``."""
    build, fields, ct = CURVE_DECKS[deck]
    system_parity(build, fields, seed=11, ct=ct)


def test_shell_end_sidesets_equal():
    """``shell_end_sidesets``: the free endpoints of an open chain, ordered
    by x, the same (element, face) pairs as goma_tpu's."""
    out = []
    for P in (JAX, TORCH):
        mesh, bi = _curve_mesh(P)
        names = P.shell_end.shell_end_sidesets(mesh, bi, prefix="e")
        out.append([(n, int(mesh.sidesets[n].elems[0]),
                     int(mesh.sidesets[n].faces[0])) for n in names])
    assert out[1] == out[0] and len(out[0]) == 2


# -------------------------------------------------------------------- sheet
def _sheet_2d(P):
    mesh = P.mesh.rectangle_mesh(4, 2, elem="QUAD9")
    prob = P.Problem(mesh, [P.phys.EllipticMesh(2),
                            P.eqs.PassiveVar("velocity", 2, "Q2"),
                            P.eqs.PassiveVar("pressure", 1, "Q1"),
                            P.eqs.PassiveVar("lub_pressure", 1, "Q2")],
                     {"lame_mu": 1.0, "lame_lambda": 1.0, "mu": 0.9}, **P.kw)
    # every kernel on one side set: one face set (goma_tpu compiles each)
    for k in (P.sheet.TensionSheet(2, tension=lambda s, m, p: 2.0 + s.x[:, 0],
                                   normal_comp=1, penalty=10.0,
                                   load=lambda s, m, p: 0.1 * s.x[:, 0]),
              P.sheet.TensionSheet(2, tension=1.5, normal_comp=0, load=0.3,
                                   include_fluid_stress=False),
              P.sheet.ShellTangentTraction(dim=2, traction=(0.4, -0.7)),
              P.sheet.LubPressureLoad(dim=2, scale=0.6),
              P.sheet.SdetWeak(dim=2, factor=0.8),
              P.sheet.ShMesh2Weak(dim=2, dy_ds=1.1)):
        prob.add_face_kernel("bottom", k)
    mesh.nodesets["web_r"] = np.array([int(np.argmax(
        mesh.coords[:, 0] - mesh.coords[:, 1]))], dtype=np.int64)
    P.sheet.add_sheet_end_slope(prob, "web_r", 2.0, 0.05, sign=-1.0)
    return prob


def _sheet_3d(P):
    mesh = P.mesh.box_mesh(2, 2, 1, elem="HEX8")
    prob = P.Problem(mesh, [P.phys.LinearElasticMesh(dim=3, interp="Q1"),
                            P.eqs.PassiveVar("lub_pressure", 1, "Q1")],
                     {"mesh_shear_modulus": 1.0, "mesh_lambda": 1.0}, **P.kw)
    for k in (P.sheet.ShellTangentTraction(dim=3, traction=(0.4, -0.7, 0.2),
                                           which=1),
              P.sheet.LubPressureLoad(dim=3, scale=0.6),
              P.sheet.SdetWeak(dim=3, factor=0.8),
              P.sheet.ShMesh2Weak(dim=3, dy_ds=1.1)):
        prob.add_face_kernel("top", k)
    return prob


@pytest.mark.parametrize("deck", ["2d", "3d"])
def test_sheet_conditions_match(deck):
    """TENSION_SHEET (callable tension and load, the fluid traction n.Pi.n),
    SHEET_ENDSLOPE (a point load), SH_S11/S22_WEAK, SH_LUBP_SOLID, SH_SDET
    and SH_MESH2_WEAK on displaced meshes: R and the CSR values at a
    seeded state."""
    md = [("mesh_displacement", c, -0.03, 0.03) for c in range(3 if deck == "3d" else 2)]
    if deck == "2d":
        system_parity(_sheet_2d, md + [("velocity", 0, -1, 1),
                                       ("velocity", 1, -1, 1),
                                       ("pressure", 0, -1, 1),
                                       ("lub_pressure", 0, 0, 1)])
    else:
        system_parity(_sheet_3d, md + [("lub_pressure", 0, 0, 1)])


# ------------------------------------------------------------------ bearing
@pytest.fixture(scope="module")
def bearing8():
    return shell_decks.bearing(JAX, 8)[0], shell_decks.bearing(TORCH, 8)[0]


def test_bearing_host_tables_equal(bearing8):
    """The 8x8 thermal slider bearing (Reynolds + shell energy with SUPG on
    a QUAD9 surface shell over a HEX27 bulk with no equation): the same
    dofmap (most bulk nodes carry no dof), gathers and CSR pattern."""
    pj, pt = bearing8
    assert (pt.dofmap.n_dof, pt.pattern.nnz) == (pj.dofmap.n_dof, pj.pattern.nnz)
    np.testing.assert_array_equal(pt.dofmap.dof_of_node_svar,
                                  pj.dofmap.dof_of_node_svar)
    for bt, bj in zip(pt.dofmap.blocks, pj.dofmap.blocks):
        np.testing.assert_array_equal(bt.gather, bj.gather)
    np.testing.assert_array_equal(pt.pattern.indptr, pj.pattern.indptr)
    np.testing.assert_array_equal(pt.pattern.indices, pj.pattern.indices)


def test_bearing_system_matches(bearing8):
    """The 8x8 bearing's R and CSR values at a seeded state (the
    temperature-dependent viscosity, the film flux in the energy equation
    and its SUPG weight all differentiated by AD)."""
    pj, pt = bearing8
    x = seeded_state(pt, [("lub_pressure", 0, 0, 200),
                          ("shell_temperature", 0, 0.7, 1.0)], 4)
    Rj, Vj = pj.assemble(jnp.asarray(x), pj.base_params())
    Rt, Vt = pt.assemble(TORCH.arr(x), pt.base_params())
    assert _rel(Rt, Rj) <= RTOL and _rel(Vt, Vj) <= RTOL


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_bearing_device_rungs(kind, bearing8):
    """The 8x8 bearing from x = 0 on bench.py's two device rungs
    (``_cavity_opts(kind, tol=1e-9, max_iter=12)``, float64 Jacobian):
    goma_tpu's Newton and linear counts and ND levels, x within 1e-8
    (1 + |x|)."""
    from test_torch_overset import bench_opts

    pj, pt = bearing8
    jopts = bench_opts(j_solvers.NewtonOptions, kind, max_iter=12)
    topts = bench_opts(t_solvers.NewtonOptions, kind, max_iter=12)
    sj = j_solvers.NewtonSolver(pj, jopts)
    st = t_solvers.NewtonSolver(pt, topts)
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
