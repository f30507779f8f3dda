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
    kernel) and a buoyant Problem (generic AD path)."""
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
    {"precond": "auto"}, {"precond": "twolevel"},
    {"precond": "ndlu", "linear_solver": "direct"},
    {"precond": "ndlu", "linear_solver": "bicgstab"},
    {"precond": "ndlu", "recycle_k": 4},
    {"precond": "ndlu", "precond_dtype": "bf16"},
])
def test_newton_options_outside_slice_raise(kw):
    from goma_tpu_torch.solvers import NewtonOptions

    with pytest.raises(NotImplementedError):
        NewtonOptions(**kw)


@pytest.mark.parametrize("feature", ["face", "periodic", "coord", "ve"])
def test_problem_outside_slice_raises(feature):
    mesh_m, fem, phys = TORCH_PKG
    mesh = mesh_m.rectangle_mesh(2, 2, elem="QUAD9")
    eqs = [phys.Momentum(dim=2, ve_stress_modes=1 if feature == "ve" else 0),
           phys.Continuity()]
    prob = fem.Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0},
                       coord="cylindrical" if feature == "coord" else "cartesian",
                       device="cpu")
    if feature == "face":
        prob.add_face_kernel("top", object())
    if feature == "periodic":
        prob.add_periodic("left", "right")
    with pytest.raises(NotImplementedError):
        prob.finalize()


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
