"""The laser melt pool of ``scripts/ls_decks.py`` (``chip_smoke.py``
phase 60) at 12x6 in the PyTorch port against goma_tpu, and goma_tpu's
level-set gated wall decks (tests/test_ls_velo_bc.py), on the CPU in
float64 (the port in one torch thread).

Tolerances: three backward-Euler steps on bench.py's two device rungs:
the same Newton count a step on ``tpu_direct`` and within one on
``gmres+ndlu`` (float32 factors of preps that differ at 1e-7), the same ND
levels, x within 1e-8 (1 + |x|), the readings within 1e-8; the decks as
``test_torch_fluid_bc.decks_match``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goma_tpu.solvers as j_solvers
import goma_tpu_torch.solvers as t_solvers
from scripts import ls_decks as ld
from test_torch_fluid_bc import decks_match
from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_overset import bench_opts

JAX = ld.namespace("goma_tpu", jnp, jnp.asarray)
TORCH = ld.namespace(
    "goma_tpu_torch", torch,
    lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64), device="cpu")


@functools.lru_cache(maxsize=None)
def deck_pair(deck):
    """The 12x6 deck in both packages, built once for both rungs."""
    build = ld.melt_pool if deck == "melt" else ld.wetting_drop
    return build(JAX, 12, 6), build(TORCH, 12, 6)


def check_rungs(deck, kind):
    """The 12x6 ``deck``'s first three backward-Euler steps on ``kind``
    (``_cavity_opts(kind, tol=1e-9, max_iter=12)``) in both packages:
    goma_tpu's Newton count a step on ``tpu_direct`` (within one on
    ``gmres+ndlu``), its ND levels, x within 1e-8 (1 + |x|) and the
    readings within 1e-8."""
    time_opts = ld.melt_time if deck == "melt" else ld.drop_time
    outputs = ld.melt_outputs if deck == "melt" else ld.drop_outputs
    out = []
    for P, S, (prob, x0, params) in zip((JAX, TORCH), (j_solvers, t_solvers),
                                        deck_pair(deck)):
        ts = P.TransientSolver(prob, bench_opts(
            S.NewtonOptions, kind, max_iter=ld.MELT_MAX_ITER),
            time_opts(P, 3))
        r = ts.run(x0, params)
        nd = ts.newton.precond if kind == "gmres+ndlu" else ts.newton._ndlu
        out.append(([(s.newton_iters, s.converged) for s in r.steps],
                    [(int(lv.nn), int(lv.smax)) for lv in nd.levels],
                    np.asarray(r.x), outputs(P, prob, r.x)))
    (sj, lj, xj, oj), (st, lt, xt, ot) = out
    assert len(st) == len(sj) == 3 and all(c for _, c in st + sj)
    slack = 1 if kind == "gmres+ndlu" else 0
    assert all(abs(a - b) <= slack for (a, _), (b, _) in zip(st, sj)), (st, sj)
    assert lj == lt
    assert np.max(np.abs(xt - xj) / (1.0 + np.abs(xj))) <= 1e-8
    for k, v in oj.items():
        assert abs(ot[k] - v) <= 1e-8 * max(abs(v), 1.0), (k, ot[k], v)


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_melt_pool_device_rungs(kind):
    """The 12x6 melt pool of phase 60 (the embedded laser, vapor-loss,
    recoil and latent-heat terms, Hysing's CSF, level-set slip and
    gas-outlet walls): see ``check_rungs``."""
    check_rungs("melt", kind)


@pytest.mark.parametrize("deck", ["velo_normal_ls", "velo_tangent_ls"])
def test_gated_wall_decks_match(deck):
    """goma_tpu's tests/test_ls_velo_bc.py decks (the liquid-closed,
    gas-open and leak-angle gates of VELO_NORMAL_LS, the VELO_TANGENT_LS
    Couette), each with its own gate, in both packages."""
    decks_match(deck)
