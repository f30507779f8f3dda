"""The port's boundary-condition catalog and the level-set decks of
goma_tpu's tests: ``goma_tpu_torch/bc/catalog_map.py`` (the parity map
over the reference's 653 named BC constants, its constructs named by
their ``goma_tpu_torch`` paths), the package exports of the slice,
``interop.materials_from_goma`` with ``LevelSetProperty``, and goma_tpu's
level-set test decks (``scripts/ls_decks.SMALL``) in both packages on the
CPU in float64 (the port in one torch thread).

Tolerances: the map row for row equal (constructs and notes with the
package renamed); the decks on the host ``direct`` rung with the same
Newton count, the readings within 1e-10 relative and x (or R) within
1e-10 (1 + |x|); a translated level-set property within 1e-15.
"""

import importlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.bc.catalog_map as j_cat
import goma_tpu_torch.bc.catalog_map as t_cat
from test_torch_fluid_bc import decks_match
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]

# the rows whose construct is goma_tpu's deck reader
# (goma_tpu_torch.input.deck, ROADMAP Queue 1 item 9): they resolve once
# it is ported
WAITING_FOR_DECK = (
    "GD_CIRC_BC", "GD_CONST_BC", "GD_INVERSE_BC", "GD_LINEAR_BC",
    "GD_PARAB_BC", "GD_PARAB_OFFSET_BC", "GD_POLYN_BC", "GD_TABLE_BC",
    "GD_TIME_BC", "TABLE_BC", "TABLE_WICS_BC", "TABLE_WICV_BC")


def _renamed(text):
    return text.replace("goma_tpu.", "goma_tpu_torch.")


def test_bc_parity_rows_match():
    """Every one of the 653 rows of goma_tpu's ``bc_parity()``: the same
    name and status, the construct and note with goma_tpu's module paths
    renamed to the port's; the same summary and audit sample."""
    tj, tt = j_cat.bc_parity(), t_cat.bc_parity()
    assert len(tt) == len(tj) == 653 and list(tt) == list(tj)
    for name, (status, construct, note) in tj.items():
        assert tt[name] == (status, _renamed(construct), _renamed(note)), name
    assert t_cat.summary() == j_cat.summary()
    assert t_cat.audited_rows() == j_cat.audited_rows()


def test_ref_bc_desc_is_goma_tpus():
    """The port's own copy of the reference's BC_Desc snapshot equals
    goma_tpu's, card for card."""
    ours = json.loads((REPO / "goma_tpu_torch/bc/_ref_bc_desc.json").read_text())
    theirs = json.loads((REPO / "goma_tpu/bc/_ref_bc_desc.json").read_text())
    assert ours == theirs == t_cat.REF_BC_DESC


def _resolve(dotted):
    """Import the longest importable module prefix, then getattr the rest."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


def test_constructs_resolve_in_the_port():
    """Every kernel and machinery construct the map names resolves in
    ``goma_tpu_torch`` (``Problem.*`` methods on the port's Problem), but
    the rows of ``WAITING_FOR_DECK``, and those rows do not: the list is
    exact, so it cannot grow unseen."""
    from goma_tpu_torch.fem import Problem

    missing = []
    for name, (status, construct, _) in sorted(t_cat.bc_parity().items()):
        if status not in ("kernel", "machinery") or not construct:
            continue
        assert construct.startswith(("goma_tpu_torch.", "Problem.")), name
        if construct.startswith("Problem."):
            assert hasattr(Problem, construct.split(".", 1)[1]), name
            continue
        try:
            _resolve(construct)
        except (ImportError, AttributeError):
            missing.append(name)
    assert tuple(missing) == WAITING_FOR_DECK


@pytest.mark.parametrize("module", [
    "bc", "physics", "bc.fluid", "bc.surface_domain", "bc.ls_embedded",
    "bc.catalog_map", "physics.level_set"])
def test_exports_match(module):
    """Every public name goma_tpu's module defines or exports (but its
    array module) exists in the port's, a class or function under the same
    ``__name__``."""
    import inspect

    jm = importlib.import_module(f"goma_tpu.{module}")
    tm = importlib.import_module(f"goma_tpu_torch.{module}")
    for name in dir(jm):
        obj = getattr(jm, name)
        if name.startswith("_") or inspect.ismodule(obj) \
                or name == "annotations":
            continue
        assert hasattr(tm, name), (module, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert getattr(tm, name).__name__ == obj.__name__, (module, name)


def test_interop_level_set_property():
    """``materials_from_goma`` rebuilds goma_tpu's ``LevelSetProperty``
    with eps None (``ls_eps``), a number and "sharp"; each evaluates to
    goma_tpu's on the same fields."""
    import goma_tpu.physics.level_set as jls
    from goma_tpu_torch.interop import materials_from_goma

    mat = {"rho": jls.LevelSetProperty(1.0, 0.1),
           "mu": jls.LevelSetProperty(1.5, 0.05, eps=0.3),
           "k": jls.LevelSetProperty(2.0, 0.5, eps="sharp")}
    tmat = materials_from_goma(mat)
    rng = np.random.default_rng(3)
    F, g = rng.uniform(-0.5, 0.5, 6), rng.standard_normal((6, 2, 2))

    class FV:
        pass

    for key in mat:
        vals = []
        for m, arr in ((mat, jnp.asarray), (tmat, torch.as_tensor)):
            fv = FV()
            fv.val = {"fill": arr(F[:, None])}
            fv.grad = {"velocity": arr(g)}
            vals.append(np.asarray(m[key](fv, m, {"ls_eps": 0.2})))
        assert type(tmat[key]).__module__ == "goma_tpu_torch.physics.level_set"
        assert np.abs(vals[1] - vals[0]).max() <= 1e-15 * np.abs(vals[0]).max()


LS_SMALL = ("ls_wall_angle", "ls_ca_h", "ls_attach", "ls_q_source",
            "ls_qrad", "ls_recoil", "csf_div_n", "csf_div_s_n", "csf_hysing",
            "csf_denner", "csf_denner_normal", "ls_latent_heat",
            "extv_callable", "extv_kinematic", "extv_latent", "fill_ext_v",
            "ls_curvature_circle", "ls_embedded_dirichlet",
            "ls_flow_pressure")


@pytest.mark.parametrize("deck", LS_SMALL)
def test_level_set_decks_match(deck):
    """goma_tpu's tests/test_ls_embedded_bc.py, test_ls_cap_variants.py,
    test_ext_velocity.py, test_level_set.py's curvature circle and test_bc_catalog3.py's embedded
    Dirichlet and flow-pressure decks, each with its own gate, in both
    packages (see ``test_torch_fluid_bc.decks_match``)."""
    decks_match(deck)
