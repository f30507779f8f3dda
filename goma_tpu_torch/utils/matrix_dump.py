"""Jacobian / residual dump for offline analysis (counterpart of
``goma_tpu/utils/matrix_dump.py``).

Parity: reference ``src/sl_matrix_dump.c`` ("Number of Jacobian File Dumps"
card) — writes the assembled CSR system to a file for debugging with
external tools.
"""

from __future__ import annotations

import numpy as np
import torch


def dump_matrix(problem, x, params, path: str):
    """Assemble at state x and save (CSR pattern + values + residual) to an
    ``.npz``; reload with ``load_matrix`` or scipy."""
    R, vals = problem.assemble(
        torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        dtype=problem.dtype, device=problem.device), params)
    pat = problem.pattern
    np.savez_compressed(
        path,
        indptr=pat.indptr, indices=pat.indices,
        vals=vals.cpu().numpy(), residual=R.cpu().numpy(),
        n=pat.n,
    )
    return path


def load_matrix(path: str):
    """Returns (scipy CSR matrix, residual)."""
    import scipy.sparse as sp

    z = np.load(path)
    A = sp.csr_matrix((z["vals"], z["indices"], z["indptr"]),
                      shape=(int(z["n"]),) * 2)
    return A, z["residual"]
