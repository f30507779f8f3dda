#!/usr/bin/env python3
"""Why the periodic channel's first GMRES solve stagnates (``chip_smoke.py``
phase 36): the port on the CPU, the x-periodic Poiseuille channel of
``chip_smoke.periodic_problem`` at (2n) x n.

1. One Newton solve from x = 0 with phase 36's options (``cavity_opts``)
   for each pair of Jacobian dtype (the Krylov operator) and NDLU factor
   dtype: Newton and GMRES iterations.
2. At x = 0, float64 Jacobian and factor: the equilibrated CSR matrix A's
   smallest singular direction by inverse iteration through the exact
   float64 NDLU solve, |A^-1| and the norm estimate sqrt(|A|_1 |A|_inf),
   and how much of that direction lies in the pressure dofs and how
   constant it is there.

    python3 scripts/periodic_gmres_probe.py [--n 32]

Host memory stays under ~2 GB at n = 32; a run takes about a minute.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import norm as spnorm

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from goma_tpu_torch.solvers import NewtonSolver  # noqa: E402


def newton_counts(n):
    for jac, fac in ((torch.float32, "float32"), (torch.float32, "float64"),
                     (None, "float32"), (None, "float64")):
        p = cs.periodic_problem(2 * n, n, "cpu")
        p.jacobian_dtype = jac
        opts = cs.cavity_opts()
        opts.ndlu_dtype = fac
        r = NewtonSolver(p, opts).solve(np.zeros(p.dofmap.n_dof), p.base_params())
        print(f"Jacobian {jac or torch.float64}, factor {fac}: Newton "
              f"{r.iters}, GMRES {r.linear_iters}", flush=True)


def near_null_mode(n, steps=30):
    p = cs.periodic_problem(2 * n, n, "cpu")
    p.jacobian_dtype = None
    opts = cs.cavity_opts()
    opts.ndlu_dtype = "float64"
    s = NewtonSolver(p, opts)
    x0 = torch.zeros(p.dofmap.n_dof, dtype=torch.float64)
    params = p.base_params()
    _, _, scale, _ = s._prepare_fast(x0, params)
    vals = s._scaled_vals(x0, params, scale)
    fac = s.precond.factor(vals)
    pat = p.pattern
    A = sp.csr_matrix((vals.numpy(), pat.indices, pat.indptr),
                      shape=(pat.n, pat.n))
    z = np.random.default_rng(1).standard_normal(pat.n)
    z /= np.linalg.norm(z)
    for _ in range(steps):
        w = s.precond.solve(fac, torch.as_tensor(z)).numpy()
        inv_norm = np.linalg.norm(w)
        z = w / inv_norm
    a_norm = np.sqrt(spnorm(A, 1) * spnorm(A, np.inf))
    dm = p.dofmap
    pd = np.unique(dm.dof_of_node_svar[:, dm.svar("pressure")])
    pd = pd[pd >= 0]
    zp = z[pd]
    print(f"{2 * n}x{n}: |A^-1| ~ {inv_norm:.3e}, |A| ~ {a_norm:.3f}, "
          f"cond ~ {inv_norm * a_norm:.2e}; the mode's share in the pressure "
          f"dofs {np.linalg.norm(zp) ** 2:.6f}, there mean {zp.mean():.3e} "
          f"std {zp.std():.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32)
    args = ap.parse_args()
    newton_counts(args.n)
    near_null_mode(args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
