"""Host layer of the PyTorch port (goma_tpu_torch) against goma_tpu: the
mesh, dofmap, CSR pattern and nested-dissection levels are integer/host
numpy data built by copied code and the same C++ sources, so they must be
EQUAL (no tolerance) on the 8x8 lid-driven cavity. Also: the port imports
and builds a Problem with jax blocked, and out-of-slice features raise."""

import fcntl
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import goma_tpu.fem
import goma_tpu.mesh
import goma_tpu.physics
import goma_tpu_torch.fem
import goma_tpu_torch.mesh
import goma_tpu_torch.physics
from goma_tpu.solvers import ndlu as jndlu
from goma_tpu.solvers.twolevel import _saddle_mask as j_saddle
from goma_tpu_torch.solvers import ndlu as tndlu
from goma_tpu_torch.solvers.twolevel import _saddle_mask as t_saddle

REPO = Path(__file__).resolve().parents[1]
# goma_tpu's native libraries with goma_tpu's own g++ flags
# (goma_tpu/native/__init__.py: _compile, _lib, _graph_lib)
GOMA_NATIVE = (("meshprep", ()), ("graph", ("-pthread",)), ("refassembly", ()))


def prebuild_goma_tpu_native():
    """Build goma_tpu's native libraries into ``goma_tpu/native/_build/``
    before any test runs. goma_tpu compiles a missing library in place, so
    a parallel test worker could load a half-written file and fall back to
    numpy (another ND tree) or raise. Here each library is built under a
    private name and renamed into place, one process at a time (a file
    lock), and only when it is missing or older than its source; goma_tpu
    then always finds a whole file. Runs when this module is collected,
    which every test worker does before it runs any test."""
    native = REPO / "goma_tpu" / "native"
    build = native / "_build"
    build.mkdir(exist_ok=True)
    with open(build / ".prebuild.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for name, extra in GOMA_NATIVE:
            src, so = native / f"{name}.cpp", build / f"lib{name}.so"
            if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
                continue
            tmp = build / f".lib{name}.so.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", "-O3", "-march=native", "-shared",
                                "-fPIC", *extra, str(src), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, so)
            except (OSError, subprocess.SubprocessError) as e:
                tmp.unlink(missing_ok=True)
                warnings.warn(f"goma_tpu native prebuild of {name} failed: {e}")


prebuild_goma_tpu_native()
JAX_PKG = (goma_tpu.mesh, goma_tpu.fem, goma_tpu.physics)
TORCH_PKG = (goma_tpu_torch.mesh, goma_tpu_torch.fem, goma_tpu_torch.physics)


def cpu(pkg) -> dict:
    """Keyword arguments that put a port object on the CPU (the port's
    default device is the card); none for goma_tpu."""
    return {"device": "cpu"} if pkg is TORCH_PKG else {}


def cavity(pkg, n, Re=100.0, finalize=True):
    """__graft_entry__._cavity_problem, built from either package."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    top = mesh.nodesets["top"]
    xt = mesh.coords[top, 0]
    mesh.nodesets["lid"] = top[(xt > xt.min()) & (xt < xt.max())]
    prob = fem.Problem(mesh, [phys.Momentum(dim=2, interp="Q2", transient=False),
                              phys.Continuity(interp="Q1")],
                       {"rho": 1.0, "mu": 1.0 / Re}, **cpu(pkg))
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("lid", "velocity", 0, 1.0)
    prob.add_dirichlet("lid", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    if finalize:
        prob.finalize()
    return prob


def buoyant(pkg, n, Ra=1e4, Pr=0.71, transient=False, extra_mat=None):
    """bench.bench_buoyant's deck (BASELINE config #2: momentum + continuity
    + energy + species, Boussinesq body force, heated left wall), built from
    either package and finalized."""
    mesh_m, fem, phys = pkg
    mesh = mesh_m.rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    mat = {"rho": 1.0, "mu": Pr, "k": 1.0, "Cp": 1.0, "diffusivity": 1.0,
           "body_force": phys.materials.BoussinesqBodyForce(
               [0.0, Ra * Pr], beta=-1.0, T0=0.5)}
    mat.update(extra_mat or {})
    prob = fem.Problem(
        mesh, [phys.Momentum(dim=2, transient=transient), phys.Continuity(),
               phys.Energy(interp="Q2", transient=transient),
               phys.Species(n_species=1, interp="Q2", transient=transient)],
        mat, **cpu(pkg))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


def viscoelastic(pkg, n, transient=False):
    """bench.bench_viscoelastic's deck (BASELINE config #4: the EVSS-F/DEVSS
    Oldroyd-B channel, Wi ~ 1.5) on a (2n)x(n) QUAD9 mesh of [0, 2] x [0, 1]:
    u, v on Q2; p, the 3 stress and 4 velocity-gradient components on Q1;
    the Newtonian profile imposed at inflow and outflow. ``transient``
    switches the time derivative on in Momentum and VEStress (their
    defaults), for the start-up run. Built from either package, finalized."""
    mesh_m, fem, phys = pkg
    lam, mu_p, mu_s, G, H = 1.0, 1.0, 0.5, 2.0, 1.0
    mesh = mesh_m.rectangle_mesh(2 * n, n, elem="QUAD9", xlim=(0, 2.0),
                                 ylim=(0, H))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = fem.Problem(
        mesh,
        [phys.Momentum(dim=2, transient=transient, convection=False,
                       ve_stress_modes=1, devss_mu=mu_p),
         phys.Continuity(),
         phys.VEStress(0, dim=2, lam=lam, mu_p=mu_p, model="oldroyd_b",
                       interp="Q1", transient=transient),
         phys.VelocityGradientProjection(dim=2, interp="Q1")],
        {"rho": 0.0, "mu": mu_s, "body_force": np.array([G, 0.0])}, **cpu(pkg))
    uex = lambda c: G / (2 * (mu_p + mu_s)) * c[:, 1] * (H - c[:, 1])  # noqa: E731
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, uex)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path in one thread: the small batched contractions of
    ``vmap(jacfwd)`` lose more to thread hand-offs than they gain, most of
    all beside other test workers: six workers on an 8-core host, each
    with torch's default pool of one thread per core, ran a test 25 times
    as long as it runs alone, and 1.7 times in one thread each. Every port
    test module imports this fixture."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def one_nd_bisection():
    """goma_tpu's nested-dissection bisection runs through the port's native
    build of the same ``meshprep.cpp`` while a module's tests run, so both
    packages cut the same tree. goma_tpu's own loader writes its library in
    place, and a parallel worker can load it half-written and fall back to
    a BFS bisection (another tree); the port's build is atomic. Test modules
    that build a goma_tpu ND tree import this fixture."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jndlu, "_bisect", tndlu._bisect)
        yield


@pytest.fixture(scope="module")
def pair():
    return cavity(JAX_PKG, 8), cavity(TORCH_PKG, 8)


def test_mesh_and_dofmap_equal(pair):
    pj, pt = pair
    np.testing.assert_array_equal(pt.mesh.coords, pj.mesh.coords)
    for bj, bt in zip(pj.mesh.blocks, pt.mesh.blocks):
        np.testing.assert_array_equal(bt.conn, bj.conn)
    assert sorted(pt.mesh.nodesets) == sorted(pj.mesh.nodesets)
    for k in pj.mesh.nodesets:
        np.testing.assert_array_equal(pt.mesh.nodesets[k], pj.mesh.nodesets[k])
    dj, dt = pj.dofmap, pt.dofmap
    assert dt.n_dof == dj.n_dof
    np.testing.assert_array_equal(dt.dof_of_node_svar, dj.dof_of_node_svar)
    for bj, bt in zip(dj.blocks, dt.blocks):
        np.testing.assert_array_equal(bt.gather, bj.gather)
    np.testing.assert_array_equal(pt.dirichlet_dofs, pj.dirichlet_dofs)
    np.testing.assert_array_equal(pt.dirichlet_vals, pj.dirichlet_vals)


def test_csr_pattern_equal(pair):
    pj, pt = pair
    np.testing.assert_array_equal(pt.pattern.indptr, pj.pattern.indptr)
    np.testing.assert_array_equal(pt.pattern.indices, pj.pattern.indices)
    np.testing.assert_array_equal(pt.pattern.diag, pj.pattern.diag)


@pytest.mark.parametrize("leaf_max", [96, 192])
def test_nd_levels_equal(pair, leaf_max):
    """The ND tree the main path factors (saddle deferral + node clusters):
    same levels, front sizes and assembly plans in both packages."""
    pj, pt = pair
    lj = jndlu.build_nd_tree(pj.pattern, leaf_max=leaf_max,
                             defer_dofs=j_saddle(pj),
                             clusters=jndlu.node_clusters(pj))
    lt = tndlu.build_nd_tree(pt.pattern, leaf_max=leaf_max,
                             defer_dofs=t_saddle(pt),
                             clusters=tndlu.node_clusters(pt))
    assert len(lt) == len(lj) > 1
    for a, b in zip(lj, lt):
        assert (b.nn, b.smax, b.bmax, b.cb) == (a.nn, a.smax, a.bmax, a.cb)
        for k in ("a_lin", "a_src", "own_w", "bnd_w", "pad_node", "pad_slot",
                  "c0_pos", "c0_idx", "c1_pos", "c1_idx"):
            va, vb = getattr(a, k), getattr(b, k)
            if va is None:
                assert vb is None, k
            else:
                np.testing.assert_array_equal(vb, va, err_msg=k)


def test_port_imports_and_builds_without_jax():
    """goma_tpu_torch never imports jax: with jax blocked in sys.modules the
    package imports and builds (and assembles) the cavity Problem (fused
    kernel), a buoyant, a viscoelastic and a two-phase level-set Problem
    (generic AD path), a TransientSolver, runs the pipelined loop's
    ``_eta_device``, and builds and finalizes the ALE slot coater deck
    (tests/test_torch_slot_coater.py's ``slot_coater``, read from its
    source: that module imports jax) with its quality-guarded
    TransientSolver, then assembles it and reads its element quality; then
    a cavity with rotated wall constraints and an x-periodic one, through
    ``assemble`` and ``residual``; then it imports the continuation layer
    and assembles the Jacobian and mass matrix of a normal-mode deck; then
    it builds and assembles the immersed-cylinder overset deck (a BAR
    multiplier block) and builds its bordered solver; last it imports every
    module of the package, and projects a vorticity and samples a velocity
    through the derived-field and particle modules."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        import goma_tpu_torch
        from goma_tpu_torch.mesh import rectangle_mesh
        from goma_tpu_torch.fem import Problem
        from goma_tpu_torch.physics import Momentum, Continuity
        from goma_tpu_torch.solvers import NewtonSolver, NewtonOptions
        mesh = rectangle_mesh(4, 4, elem="QUAD9")
        prob = Problem(mesh, [Momentum(dim=2, transient=False),
                              Continuity()], {"rho": 1.0, "mu": 0.1},
                       device="cpu")
        prob.add_dirichlet("top", "velocity", 0, 1.0)
        prob.finalize()
        R, rs, aux = prob._assemble_fast(
            torch.zeros(prob.dofmap.n_dof, dtype=torch.float64),
            prob.base_params())
        NewtonSolver(prob, NewtonOptions(precond="ndlu"))
        # the buoyant deck takes the generic AD path
        from goma_tpu_torch.physics import Energy, Species
        from goma_tpu_torch.physics.materials import BoussinesqBodyForce
        bprob = Problem(mesh, [Momentum(dim=2, transient=False), Continuity(),
                               Energy(transient=False),
                               Species(n_species=1, transient=False)],
                        {"rho": 1.0, "mu": 0.71, "body_force":
                         BoussinesqBodyForce([0.0, 7100.0], beta=-1.0, T0=0.5)},
                        device="cpu")
        bprob.add_dirichlet("left", "temperature", 0, 1.0)
        bprob.finalize()
        assert not bprob._fast_meta
        R, vals = bprob._assemble(
            torch.zeros(bprob.dofmap.n_dof, dtype=torch.float64),
            bprob.base_params())
        assert bool(torch.isfinite(vals).all()) and vals.shape[0] == bprob.pattern.nnz
        # the viscoelastic deck and the transient driver
        from goma_tpu_torch.physics import VEStress, VelocityGradientProjection
        from goma_tpu_torch.solvers.transient import TimeOptions, TransientSolver
        vprob = Problem(mesh, [Momentum(dim=2, convection=False,
                                        ve_stress_modes=1, devss_mu=1.0),
                               Continuity(), VEStress(0, dim=2, lam=1.0, mu_p=1.0),
                               VelocityGradientProjection(dim=2)],
                        {"rho": 0.0, "mu": 0.5}, device="cpu")
        vprob.add_dirichlet("top", "velocity", 0, 1.0)
        vprob.finalize()
        R, vals = vprob._assemble(
            torch.zeros(vprob.dofmap.n_dof, dtype=torch.float64),
            vprob.base_params())
        assert bool(torch.isfinite(vals).all()) and vals.shape[0] == vprob.pattern.nnz
        TransientSolver(vprob, NewtonOptions(precond="ndlu"),
                        TimeOptions(dt0=0.1, t_end=0.1))
        # the two-phase level-set deck, and the pipelined loop's device eta
        import numpy as np
        from goma_tpu_torch.physics import CSFSurfaceTension, FillEquation
        lprob = Problem(mesh, [Momentum(dim=2), Continuity(),
                               CSFSurfaceTension(dim=2, sigma=1.0),
                               FillEquation(interp="Q2", supg=0.0)],
                        {"rho": 1.0, "mu": 1.0}, device="cpu")
        lprob.add_dirichlet("top", "velocity", 0, 0.0)
        lprob.finalize()
        x = lprob.set_nodal_field(np.zeros(lprob.dofmap.n_dof), "fill", 0,
                                  np.linalg.norm(mesh.coords, axis=1) - 0.5)
        lp = lprob.base_params(ls_eps=torch.tensor(0.2, dtype=torch.float64))
        R, vals = lprob._assemble(torch.as_tensor(x), lp)
        assert bool(torch.isfinite(vals).all()) and vals.shape[0] == lprob.pattern.nnz
        ls = NewtonSolver(lprob, NewtonOptions(precond="ndlu"))
        eta = ls._eta_device(torch.tensor(1e-3, dtype=torch.float64),
                             torch.tensor(-1.0))
        assert float(eta) == ls._eta(1e-3, None)
        # the ALE slot coater: mesh motion, face kernels, quality guard
        import ast
        src = open("tests/test_torch_slot_coater.py").read()
        fn = next(n for n in ast.parse(src).body
                  if isinstance(n, ast.FunctionDef) and n.name == "slot_coater")
        ns = {"np": np}
        exec(compile(ast.Module([fn], []), "slot_coater", "exec"), ns)
        sprob, sts, sx0 = ns["slot_coater"](8, 2)
        assert sts.topts.quality_guard and len(sprob.face_sets) == 1
        R, vals = sprob._assemble(torch.as_tensor(sx0), sprob.base_params())
        assert bool(torch.isfinite(vals).all()) and vals.shape[0] == sprob.pattern.nnz
        from goma_tpu_torch.post.quality import element_quality
        assert element_quality(sprob, sx0).ok
        # rotated wall conditions and periodicity, through the public
        # entry points
        rprob = Problem(mesh, [Momentum(dim=2, transient=False),
                               Continuity()], {"rho": 1.0, "mu": 0.1},
                        device="cpu")
        rprob.add_rotated_dirichlet(("left", "right", "bottom"), "velocity",
                                    "normal", 0.0)
        rprob.add_rotated_dirichlet("top", "velocity", "tangent", -1.0)
        rprob.finalize()
        assert rprob._rotation.con_rows.size > 0
        xr = torch.zeros(rprob.dofmap.n_dof, dtype=torch.float64)
        R, vals = rprob.assemble(xr, rprob.base_params())
        assert torch.equal(rprob.residual(xr, rprob.base_params()), R)
        pprob = Problem(mesh, [Momentum(dim=2, transient=False),
                               Continuity()], {"rho": 1.0, "mu": 0.1},
                        device="cpu")
        pprob.add_periodic("left", "right")
        pprob.add_dirichlet("top", "velocity", 0, 1.0)
        pprob.finalize()
        assert pprob.dofmap.node_alias is not None
        R, vals = pprob.assemble(
            torch.zeros(pprob.dofmap.n_dof, dtype=torch.float64),
            pprob.base_params())
        assert bool(torch.isfinite(vals).all()) and vals.shape[0] == pprob.pattern.nnz
        # the continuation layer and a normal-mode (3D-of-2D) deck
        import goma_tpu_torch.continuation
        from goma_tpu_torch.physics import (NormalModeContinuity,
                                            NormalModeMomentum, NormalModeW)
        nprob = Problem(mesh, [NormalModeMomentum(), NormalModeW(),
                               NormalModeContinuity()],
                        {"rho": 1.0, "mu": 1.0},
                        external_fields=("u0", "v0"), device="cpu")
        nprob.add_dirichlet("top", "nm_velocity", 0, 0.0)
        nprob.finalize()
        J, M = goma_tpu_torch.continuation.mass_and_jacobian(
            nprob, np.zeros(nprob.dofmap.n_dof),
            nprob.base_params(beta=torch.tensor(1.5, dtype=torch.float64)))
        assert np.isfinite(J).all() and np.abs(M).max() > 0
        # the overset immersed cylinder (BAR block of P0 multipliers)
        from goma_tpu_torch.mesh import circle_block
        from goma_tpu_torch.physics import OversetLM, OversetNoSlip
        from goma_tpu_torch.solvers.bordered import (BorderedNewtonSolver,
                                                     multiplier_dof_mask)
        omesh = rectangle_mesh(6, 3, elem="QUAD9", xlim=(0, 2.0))
        omesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        obi = circle_block(omesh, (0.8, 0.5), 0.2, n=8, name="cylinder")
        oprob = Problem(omesh, [[Momentum(dim=2, transient=False,
                                          convection=False), Continuity()],
                                [OversetLM(dim=2)]],
                        [{"rho": 1.0, "mu": 1.0}, {}], device="cpu")
        oprob.add_dirichlet("left", "velocity", 0, 1.0)
        oprob.add_dirichlet("pin", "pressure", 0, 0.0)
        oprob.add_overset(obi, 0, OversetNoSlip(dim=2))
        oprob.finalize()
        assert len(oprob.ovs_sets) == 1
        R, vals = oprob.assemble(
            torch.zeros(oprob.dofmap.n_dof, dtype=torch.float64),
            oprob.base_params())
        assert bool(torch.isfinite(vals).all()) and vals.shape[0] == oprob.pattern.nnz
        BorderedNewtonSolver(oprob, multiplier_dof_mask(oprob))
        # every module of the port imports
        import importlib, pkgutil
        for m in pkgutil.walk_packages(goma_tpu_torch.__path__,
                                       "goma_tpu_torch."):
            importlib.import_module(m.name)
        assert "goma_tpu_torch.bc.catalog_map" in sys.modules
        # the derived fields, particles and split solvers
        import numpy as np
        from goma_tpu_torch.physics.projection_ns import (PressureIncrement,
                                                          UStar)
        from goma_tpu_torch.post.derived import derived_nodal_field
        from goma_tpu_torch.post.particles import FieldSampler
        from goma_tpu_torch.solvers import ProjectionSolver
        from goma_tpu_torch.solvers.segregated import (
            SegregatedSolver, SegregatedTransientSolver, SubProblem)
        xc = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "velocity",
                                  0, lambda X: X[:, 1])
        assert np.allclose(derived_nodal_field(prob, xc, "VORTICITY"), -1.0)
        assert np.allclose(FieldSampler(prob).sample(
            xc, "velocity", np.array([[0.5, 0.25]]), comp=0), 0.25)
        assert not any(m == "jax" or m.startswith(("jax.", "goma_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok", prob.dofmap.n_dof)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("name", ["graph", "meshprep"])
def test_native_sources_are_the_ports_own(name):
    """The port compiles its own copy of each C++ source, inside
    goma_tpu_torch/ (not goma_tpu's file by path), and the copy is
    identical to goma_tpu's, so both packages build the same CSR pattern
    and nested-dissection tree."""
    from goma_tpu_torch import native

    pkg = Path(goma_tpu_torch.fem.__file__).resolve().parents[1]
    src = native._SRC / f"{name}.cpp"
    assert src.resolve().is_relative_to(pkg)
    assert src.read_bytes() == (REPO / "goma_tpu" / "native"
                                / f"{name}.cpp").read_bytes()
    so = native._compile(name, ("-pthread",) if name == "graph" else ())
    assert so is not None and so.resolve().is_relative_to(pkg)


@pytest.mark.parametrize("kw", [
    {"precond": "ndlu", "recycle_k": 4},
])
def test_newton_options_outside_slice_raise(kw):
    """GCRO-DR recycling, the last Newton option once outside the port, is
    ported: the options build, and on the 8x8 cavity (float64, leaf 96,
    the lagged NDLU preconditioner, whose lagged solves take enough steps
    to harvest a space) the port's Newton solve takes goma_tpu's Newton
    count, each solve's linear iterations within 1 of goma_tpu's and x
    within 1e-8 (goma_tpu's NDLU pinned to its kernel's route, as the
    port's). tests/test_torch_recycle.py holds the cycle and the harvest
    against goma_tpu."""
    import jax.numpy as jnp

    from goma_tpu.solvers import NewtonOptions as JOptions
    from goma_tpu.solvers import NewtonSolver as JSolver
    from goma_tpu_torch.solvers import NewtonOptions, NewtonSolver

    opts = dict(kw, linear_solver="gmres", max_iter=20, linear_tol=1e-4,
                gmres_restart=60, linear_maxiter=240, ndlu_dtype="float64",
                ndlu_leaf_max=96, tol_residual=1e-9)
    assert NewtonOptions(**opts).recycle_k == kw["recycle_k"]
    pj, pt = cavity(JAX_PKG, 8), cavity(TORCH_PKG, 8)
    sj = JSolver(pj, JOptions(**opts))
    sj.precond.front_lu = "pallas"
    rj = sj.solve(jnp.zeros(pj.dofmap.n_dof), pj.base_params())
    st = NewtonSolver(pt, NewtonOptions(**opts))
    rt = st.solve(np.zeros(pt.dofmap.n_dof), pt.base_params())
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    assert len(rt.linear_iters) == len(rj.linear_iters)
    assert all(abs(a - b) <= 1 for a, b in zip(rt.linear_iters, rj.linear_iters))
    assert st._recycle_U is not None and st._recycle_U.shape[0] == kw["recycle_k"]
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-8)


@pytest.mark.parametrize("feature", ["edge", "interface", "overset_solid",
                                     "shell3d", "nedelec"])
def test_problem_outside_slice_raises(feature):
    """Problem features once outside the port's slices, each refused
    before its slice and ported since: edge and interface kernels, surface
    (shell) blocks in a 3D mesh, Nedelec (N1, edge-signed) blocks and the
    two-way overset coupling to a solid (``add_overset(solid=...)``). On a
    small deck of each (for N1 both parts of ``EMWaveEdge`` on a TRI6 mesh,
    whose elements carry edge signs; for the solid coupling the elastic
    wall of tests/test_overset.py), ``finalize`` builds the set (or the
    block's tables) and R at a seeded state is goma_tpu's within 1e-10
    (tests/test_torch_interface.py, tests/test_torch_shell.py,
    tests/test_torch_em.py and tests/test_torch_solid.py hold every kernel
    against goma_tpu)."""
    mesh_m, fem, phys = TORCH_PKG
    import torch
    if feature == "overset_solid":
        import jax.numpy as jnp

        from scripts import solid_decks as sd

        pj = sd.overset_fsi_wall_problem(sd.namespace("goma_tpu", jnp,
                                                      jnp.asarray))
        pt = sd.overset_fsi_wall_problem(sd.namespace(
            "goma_tpu_torch", torch, torch.as_tensor, device="cpu"))
        assert pt.ovs_sets[0].Ns is not None
        x = np.random.default_rng(6).standard_normal(pt.dofmap.n_dof)
        Rj = np.asarray(pj.residual(jnp.asarray(x), pj.base_params()))
        Rt = pt.residual(torch.as_tensor(x), pt.base_params()).numpy()
        assert np.abs(Rt - Rj).max() <= 1e-10 * np.abs(Rj).max()
        return

    import goma_tpu.bc.edge as jedge
    import goma_tpu.mesh.interface as jmi
    import goma_tpu_torch.bc.edge as tedge
    import goma_tpu_torch.mesh.interface as tmi

    R = []
    for pkg, edge, mi in ((JAX_PKG, jedge, jmi), (TORCH_PKG, tedge, tmi)):
        mesh_m, fem, phys = pkg
        if feature == "shell3d":
            mesh = mesh_m.box_mesh(1, 1, 1, elem="HEX8")
            quad = mesh.sidesets["top"]
            conn = mesh.blocks[0].conn[quad.elems][:, [4, 5, 6, 7]]
            mesh.blocks.append(mesh_m.Block("shell", "QUAD4",
                                            conn.astype(np.int32)))
            prob = fem.Problem(mesh, [[phys.Energy(interp="Q1")],
                                      [phys.Energy(interp="Q1")]], {"k": 1.0},
                               **cpu(pkg))
        elif feature == "nedelec":
            mesh = mesh_m.rectangle_mesh(2, 2, elem="TRI6")
            prob = fem.Problem(mesh, [phys.EMWaveEdge("real", 2.0),
                                      phys.EMWaveEdge("imag", 2.0)],
                               {"sigma_em": 0.3, "J_im": (0.4, -0.2)},
                               **cpu(pkg))
            prob.add_dirichlet("left", "em_edge_real", 0, 0.0)
        elif feature == "edge":
            mesh = mesh_m.box_mesh(1, 1, 1, elem="HEX27")
            prob = fem.Problem(mesh, [phys.Energy(interp="Q2")], {"k": 1.0},
                               **cpu(pkg))
            prob.add_edge_kernel("top", "right", edge.EdgeTraction(
                "temperature", 1, 2.0))
        else:
            mesh = mesh_m.rectangle_mesh(2, 1, elem="QUAD9")
            prob = fem.Problem(mesh, [phys.Energy(interp="P0")], {"k": 1.0},
                               **cpu(pkg))
            prob.add_interface_kernel(mi.interior_face_pairs(mesh, 0),
                                      phys.InterfaceExchange("temperature",
                                                             coeff=3.0))
        prob.finalize()
        if feature == "nedelec":
            assert prob.dofmap.blocks[0].edge_signs is not None
        x = np.random.default_rng(2).standard_normal(prob.dofmap.n_dof)
        if pkg is TORCH_PKG:
            R.append(prob.residual(torch.as_tensor(x), prob.base_params()).numpy())
        else:
            R.append(np.asarray(prob.residual(x, prob.base_params())))
    assert np.abs(R[1] - R[0]).max() <= 1e-10 * np.abs(R[0]).max()


def test_slot_coater_rotation_matches_goma_tpu():
    """The 16x4 slot coater deck with its free surface's mesh equations
    rotated into normal-tangent frames (``add_rotation("free",
    "mesh_displacement")``, then finalized again) in both packages: the same
    rotation tables, and at x0 plus a seeded perturbation R and the CSR
    values within 1e-10 of goma_tpu's (the deck's test bound in
    tests/test_torch_slot_coater.py), float64."""
    import examples.slot_coater as jsc
    import jax.numpy as jnp
    import torch
    from test_torch_slot_coater import slot_coater

    pj, _, x0 = jsc.build(nx=16, ny=4)
    pt, _, _ = slot_coater(16, 4)
    for p in (pj, pt):
        p.add_rotation("free", "mesh_displacement")
        p.finalize()
    for k in ("pos", "entry_node", "dofs"):
        np.testing.assert_array_equal(getattr(pt._rotation, k),
                                      getattr(pj._rotation, k))
    np.testing.assert_allclose(pt._rotation.Q, pj._rotation.Q, rtol=0,
                               atol=1e-15)
    x = x0 + 1e-3 * np.random.default_rng(8).standard_normal(x0.shape)
    Rj, vj = pj.assemble(jnp.asarray(x), pj.base_params())
    Rt, vt = pt.assemble(torch.as_tensor(x), pt.base_params())
    for a, b in ((Rt, Rj), (vt, vj)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("name,args", [
    ("DGStressUpwind", (0, 1.0)),
    ("DGStressInflow", (0, 1.0, [0.5, 0.2, 0.1])),
    ("OversetFSI", (2,)),
])
def test_viscoelastic_pieces_outside_slice_raise(name, args):
    """goma_tpu's pieces under their names, each refused before its slice
    and ported since: the discontinuous-stress kernels and the two-way
    overset solid coupling (``OversetFSI``). Each one's integrand on the
    same random face (or immersed-point) states equals goma_tpu's to 1e-14
    relative (tests/test_torch_interface.py and tests/test_torch_solid.py
    hold their decks against goma_tpu)."""
    import jax.numpy as jnp
    import torch

    import goma_tpu.physics.overset as jov
    import goma_tpu.physics.viscoelastic as jve
    import goma_tpu_torch.physics.overset as tov
    import goma_tpu_torch.physics.viscoelastic as tve

    rng = np.random.default_rng(4)
    if name == "OversetFSI":
        st = {k: rng.standard_normal(n) for k, n in (
            ("x", 2), ("u", 2), ("d", 2), ("pf", 9), ("ps", 9), ("lam", 2))}
        w = float(rng.uniform(0.1, 1.0))
        out = []
        for ov_m, arr in ((jov, jnp.asarray), (tov, torch.as_tensor)):
            ov = ov_m.OversetVars()
            ov.x, ov.w = arr(st["x"]), w
            ov.vals["velocity"], ov.phi["velocity"] = arr(st["u"]), arr(st["pf"])
            ov.dots_s["solid_displacement"] = arr(st["d"])
            ov.phi_s["solid_displacement"] = arr(st["ps"])
            r_lam, rf, rs = ov_m.OversetFSI(*args).residual(ov, arr(st["lam"]),
                                                            {})
            out.append([np.asarray(r_lam), np.asarray(rf["velocity"]),
                        np.asarray(rs["solid_displacement"])])
        for a, b in zip(out[1], out[0]):
            assert np.abs(a - b).max() <= 1e-14 * np.abs(b).max()
        return
    nq, nb = 3, 3
    arrs = {"v": rng.standard_normal((nq, 2)), "n": rng.standard_normal((nq, 2)),
            "sa": rng.standard_normal((nq, 3)), "sb": rng.standard_normal((nq, 3)),
            "pa": rng.standard_normal((nq, nb)), "pb": rng.standard_normal((nq, nb))}

    class Face:
        pass

    out = []
    for ve, arr in ((jve, jnp.asarray), (tve, torch.as_tensor)):
        faces = []
        for side in "ab":
            f = Face()
            f.val = {"velocity": arr(arrs["v"]), "stress0": arr(arrs["s" + side])}
            f.phi = {"stress0": arr(arrs["p" + side])}
            f.normal = arr(arrs["n"])
            faces.append(f)
        k = getattr(ve, name)(*args)
        if name == "DGStressUpwind":
            out.append([np.asarray(c) for c in k.residual(*faces, {}, {}, {})])
        else:
            out.append([np.asarray(k.residual(faces[0], {}, {}))])
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14 * np.abs(b).max())


def test_flux_sensitivity_outside_slice_raises():
    """goma_tpu's ``flux_sensitivity`` is in the port under its name (it
    refused a call until continuation was ported): dF/dmu of the lid's
    x-traction on the 4x4 Re = 100 cavity at a seeded state, float64,
    within 1e-8 relative of goma_tpu's."""
    import jax.numpy as jnp
    import torch

    import goma_tpu.post as jpost
    import goma_tpu.post.postproc as jpp
    import goma_tpu_torch.post as tpost
    from goma_tpu_torch.post import postproc

    assert jpp.flux_sensitivity.__name__ == postproc.flux_sensitivity.__name__
    pj, pt = cavity(JAX_PKG, 4), cavity(TORCH_PKG, 4)
    for p in (pj, pt):
        p.materials[0]["mu"] = (lambda fv, mat, params: params["mu"])
    x = np.random.default_rng(45).standard_normal(pt.dofmap.n_dof)
    fj = jpp.flux_sensitivity(
        pj, jpost.sideset_integral(pj, "top", jpost.traction_integrand(0)), x,
        pj.base_params(mu=jnp.asarray(0.01)), "mu")
    ft = postproc.flux_sensitivity(
        pt, tpost.sideset_integral(pt, "top", tpost.traction_integrand(0)), x,
        pt.base_params(mu=torch.tensor(0.01, dtype=torch.float64)), "mu")
    assert abs(float(ft) - float(fj)) <= 1e-8 * abs(float(fj))
    assert abs(float(fj)) > 0


LS_PIECES = {
    "XFEMPressureContinuity": ("eq", ()),
    "XFEMPressureMomentum": ("eq", (2,)),
    "LSEmbeddedFlux": ("eq", ("temperature", 1.3)),
    "LSEmbeddedDirichlet": ("eq", ("velocity", 0.4, 1, 2, 50.0)),
    "LSRecoilPressure": ("eq", (2, 0.7)),
    "SolvedNormal": ("eq", (2,)),
    "ExtensionVelocity": ("eq", ()),
    "LSExtVKinematic": ("eq", ()),
    "LSExtVLatent": ("eq", (0.6, 0.3, 1.5, 0.2)),
    "FillExtV": ("eq", ()),
    "LSFlowPressure": ("eq", (2, 0.9)),
    "kanouff_recoil": ("fn", (1.2, 1e-3, 0.01)),
    "qrad_flux": ("closure", (2.0, 0.5, 0.3, 0.1)),
}


def _ls_fields(arr, rng):
    """One element's synthetic fields at 4 quadrature points: fill, its
    Q1 enrichment, velocity, temperature, extension velocity, normal."""
    nq, n9, n4 = 4, 9, 4

    class FV:
        pass

    fv = FV()
    vals = {"fill": 1, "velocity": 2, "temperature": 1, "ext_velocity": 1,
            "ls_normal": 2, "pressure_xfem": 1}
    nbf = {"fill": n9, "velocity": n9, "temperature": n9, "ext_velocity": n4,
           "ls_normal": n4, "pressure_xfem": n4}
    fv.val, fv.grad, fv.dot, fv.phi, fv.gphi, fv.q_nodal = ({}, {}, {}, {},
                                                            {}, {})
    for v, nc in vals.items():
        fv.val[v] = arr(0.3 * rng.standard_normal((nq, nc)))
        fv.grad[v] = arr(rng.standard_normal((nq, nc, 2)))
        fv.dot[v] = arr(rng.standard_normal((nq, nc)))
        fv.phi[v] = arr(rng.uniform(0.0, 1.0, (nq, nbf[v])))
        fv.gphi[v] = arr(rng.standard_normal((nq, nbf[v], 2)))
        fv.q_nodal[v] = arr(0.3 * rng.standard_normal((nc, nbf[v])))
    fv.lnodes = {"fill": tuple(range(9)), "pressure_xfem": (0, 1, 2, 3)}
    fv.x = arr(rng.uniform(0.0, 1.0, (nq, 2)))
    fv.h_elem = arr(rng.uniform(0.1, 0.3, nq))
    return fv


@pytest.mark.parametrize("name", list(LS_PIECES))
def test_level_set_pieces_outside_slice_raise(name):
    """goma_tpu's level-set exports that an earlier slice refused are in
    the port under their names and compute goma_tpu's: each class's
    integrand on the same synthetic element fields (random values,
    gradients, rates, bases and nodal coefficients at four quadrature
    points; params with ls_eps, time and dt) and each closure's values
    within 1e-14 relative of goma_tpu's (tests/test_torch_ls_bc.py holds
    their assembled systems against goma_tpu's)."""
    import jax.numpy as jnp
    import torch

    kind, args = LS_PIECES[name]
    obj = getattr(goma_tpu_torch.physics, name)
    assert getattr(goma_tpu.physics, name).__name__ == obj.__name__ == name
    out = []
    for pkg, arr in ((goma_tpu.physics, jnp.asarray),
                     (goma_tpu_torch.physics, torch.as_tensor)):
        rng = np.random.default_rng(11)
        fv = _ls_fields(arr, rng)
        params = {"ls_eps": 0.5, "time": 0.2, "dt": 0.05}
        f = getattr(pkg, name)(*args)
        if kind == "eq":
            out.append(np.asarray(f.residual(fv, {}, params)))
        elif kind == "closure":
            out.append(np.asarray(f(fv, {}, params)))
        else:
            out.append(np.asarray(f(arr(np.linspace(1.0, 5.0, 9)))))
    assert out[1].shape == out[0].shape
    assert np.abs(out[0]).max() > 0
    assert np.abs(out[1] - out[0]).max() <= 1e-14 * np.abs(out[0]).max()


def test_dirichlet_first_spec_wins_with_warning():
    """The lid over the FULL top edge conflicts with the walls at the two
    corners: the first spec (walls, added first) keeps them, with a warning,
    in both packages."""
    def build(pkg):
        mesh_m, fem, phys = pkg
        mesh = mesh_m.rectangle_mesh(3, 3, elem="QUAD9")
        prob = fem.Problem(mesh, [phys.Momentum(dim=2, transient=False),
                                  phys.Continuity()], {"rho": 1.0, "mu": 1.0},
                           **cpu(pkg))
        for ns in ("left", "right"):
            prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet("top", "velocity", 0, 1.0)
        with pytest.warns(UserWarning, match="first spec"):
            prob.finalize()
        return prob

    pj, pt = build(JAX_PKG), build(TORCH_PKG)
    np.testing.assert_array_equal(pt.dirichlet_dofs, pj.dirichlet_dofs)
    np.testing.assert_array_equal(pt.dirichlet_vals, pj.dirichlet_vals)
    assert len(pt.bc_dup_log) == len(pj.bc_dup_log) == 2


def test_device_default_is_the_card():
    """With ``device`` omitted, the port's entry points put their tensors on
    ``cuda``; without CUDA they raise (no CPU fallback)."""
    import torch

    from goma_tpu_torch import interop
    from goma_tpu_torch.fem.sparsity import EllOperator, build_pattern
    from goma_tpu_torch.solvers.ndlu import NDLU

    mesh_m, fem, phys = TORCH_PKG
    pat = build_pattern(4, [])
    makers = {
        "Problem": lambda: fem.Problem(mesh_m.rectangle_mesh(1, 1, elem="QUAD9"),
                                       [phys.Energy()]).device,
        "NDLU": lambda: NDLU(pat).device,
        "EllOperator": lambda: EllOperator(pat).tables["pos"].device,
        "state_from_numpy": lambda: interop.state_from_numpy([1.0]).device,
        "params_from_numpy": lambda: interop.params_from_numpy(
            {"ct": 0.0, "hist": [0.0], "dirichlet_val": [], "time": 0.0})["ct"].device,
        "ndlu_factors_from_numpy": lambda: interop.ndlu_factors_from_numpy(
            [(np.eye(2), np.eye(2), None, np.eye(2), np.eye(2))])[0][0].device,
    }
    for name, make in makers.items():
        if torch.cuda.is_available():
            assert make().type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
