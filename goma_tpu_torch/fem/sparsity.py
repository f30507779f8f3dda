"""CSR sparsity pattern, precomputed scatter maps, sparse ops.

Counterpart of ``goma_tpu/fem/sparsity.py``. The host part (``CSRPattern``,
``build_pattern``, ``nnz_map_for_gather``) is a verbatim copy: the pattern is
the union of per-block element dof cross-products, built once on the host.
The device part is torch: an ELL (padded-row) operator and its row sums,
both pure gathers, so the results are deterministic on the GPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from goma_tpu_torch import config

@dataclass
class CSRPattern:
    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32 column ids, sorted within rows
    rows: np.ndarray  # (nnz,) int32 row ids
    keys: np.ndarray  # (nnz,) int64 sorted row*n+col keys (for lookups)
    diag: np.ndarray  # (n,) int64 position of diagonal entry

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def find(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Positions of (row, col) entries; -1 where absent."""
        from goma_tpu_torch.native import searchsorted_native

        k = rows.astype(np.int64) * self.n + cols.astype(np.int64)
        pos = searchsorted_native(self.keys, k)
        pos = np.clip(pos, 0, self.nnz - 1)
        ok = self.keys[pos] == k
        return np.where(ok, pos, -1)


def build_pattern(n_dof: int, gathers: list[np.ndarray],
                  extra_keys: np.ndarray = None) -> CSRPattern:
    """Union of element-local dense couplings over all blocks + full diagonal.
    The sort+unique over all element key cross-products runs in parallel C++
    (goma_tpu_torch.native.sort_unique)."""
    from goma_tpu_torch.native import sort_unique

    keys_parts = [np.arange(n_dof, dtype=np.int64) * n_dof + np.arange(n_dof)]
    if extra_keys is not None and extra_keys.size:
        keys_parts.append(np.asarray(extra_keys, dtype=np.int64).ravel())
    for g in gathers:
        g64 = g.astype(np.int64)
        ne, nl = g64.shape
        rows = np.repeat(g64, nl, axis=1)  # (ne, nl*nl)
        cols = np.tile(g64, (1, nl))
        keys_parts.append((rows * n_dof + cols).ravel())
    keys = sort_unique(np.concatenate(keys_parts))
    rows = (keys // n_dof).astype(np.int32)
    cols = (keys % n_dof).astype(np.int32)
    indptr = np.zeros(n_dof + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    diag_keys = np.arange(n_dof, dtype=np.int64) * (n_dof + 1)
    diag = np.searchsorted(keys, diag_keys)
    return CSRPattern(n=n_dof, indptr=indptr, indices=cols, rows=rows, keys=keys, diag=diag)


def nnz_map_for_gather(pat: CSRPattern, gather: np.ndarray) -> np.ndarray:
    """(ne, nl, nl) destination positions for a block's local Jacobians."""
    ne, nl = gather.shape
    rows = np.repeat(gather, nl, axis=1).ravel()
    cols = np.tile(gather, (1, nl)).ravel()
    pos = pat.find(rows, cols)
    if np.any(pos < 0):
        raise RuntimeError("local Jacobian entry missing from pattern")
    return pos.reshape(ne, nl, nl).astype(np.int64)


def transpose_gather(flat: np.ndarray, n: int) -> np.ndarray:
    """(n, m) positions in ``flat`` of each target id 0..n-1 (m = the most
    contributions any target has); pad -> len(flat), the zero slot."""
    L = flat.shape[0]
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    starts = np.searchsorted(sorted_ids, np.arange(n))
    ends = np.searchsorted(sorted_ids, np.arange(n) + 1)
    m = max(int((ends - starts).max()), 1) if L else 1
    pos = np.full((n, m), L, dtype=np.int64)
    for k in range(m):
        sel = starts + k < ends
        pos[sel, k] = order[(starts + k)[sel]]
    return pos


def add_plan(targets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host plan of a scatter-add into ``targets`` (flattened; they may
    repeat): the distinct targets and, per distinct target, the positions
    of its contributions in the flattened contribution array (pad -> its
    length). :func:`add_at` then sums by a gather, in a fixed order, where
    goma_tpu's ``.at[targets].add`` scatters."""
    t = np.asarray(targets, dtype=np.int64).ravel()
    uniq, inv = np.unique(t, return_inverse=True)
    return uniq, transpose_gather(inv.ravel(), uniq.shape[0])


def add_at(a, uniq, pos, contrib):
    """``a`` with the contributions added at the targets of an
    :func:`add_plan` (``uniq``, ``pos`` as tensors on ``a``'s device), out
    of place and deterministic: no atomics."""
    flat = torch.cat([contrib.reshape(-1).to(a.dtype), a.new_zeros(1)])
    return a.index_put((uniq,), a[uniq] + torch.sum(flat[pos], dim=1))


# ------------------------------------------------------------- device ops
class EllOperator:
    """Padded-row (ELL) sparse matvec: y = sum_k vals[pos[:, k]] *
    x[cols[:, k]], pure gather + elementwise + row sum (no scatter, so no
    atomics on the GPU). Pad slots point at position nnz, which holds 0.
    ``device=None`` is the card (:func:`config.resolve_device`)."""

    def __init__(self, pat: CSRPattern, device=None):
        device = config.resolve_device(device)
        n = pat.n
        deg = np.diff(pat.indptr)
        K = int(deg.max())
        pos = np.full((n, K), pat.nnz, dtype=np.int64)  # pad -> zero slot
        cols = np.zeros((n, K), dtype=np.int64)  # pad col 0 (value 0 anyway)
        idx = np.repeat(np.arange(n), deg)
        offs = np.arange(pat.nnz) - np.repeat(pat.indptr[:-1], deg)
        pos[idx, offs] = np.arange(pat.nnz)
        cols[idx, offs] = pat.indices
        self.K = K
        self.n = n
        self.tables = {"pos": torch.as_tensor(pos, device=device),
                       "cols": torch.as_tensor(cols, device=device)}

    def matvec(self, vals, x):
        tb = self.tables
        vals_ext = torch.cat([vals, vals.new_zeros(1)])
        return torch.sum(vals_ext[tb["pos"]] * x[tb["cols"]], dim=1)


def row_sums_ell(vals, pos):
    """Row sums of |A| via the ELL gather map (``EllOperator.tables["pos"]``,
    pad slot -> nnz, value 0) — scatter-free."""
    ve = torch.cat([vals, vals.new_zeros(1)])[pos]
    return torch.sum(torch.abs(ve), dim=1)
