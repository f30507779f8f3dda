"""Host-native (C++) graph kernels for the port's setup phase.

The C++ sources ``graph.cpp`` and ``meshprep.cpp`` beside this module are
the port's own copies of the JAX package's (``goma_tpu/native/``), compiled
with g++ into ``goma_tpu_torch/native/_build/`` and bound with ctypes.
Identical sources mean both packages build the same CSR pattern and the
same nested-dissection tree, which the NDLU parity tests check. Nothing
here imports or reads ``goma_tpu``.

If compilation fails the numpy fallbacks are used, exactly as in
``goma_tpu.native``: same results for ``sort_unique``/``searchsorted``, a
coarser (BFS) bisection for ``bisect_partition``. This is host-side
preprocessing, never a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent
_BUILD = Path(__file__).resolve().parent / "_build"
_LIBS: dict[str, ctypes.CDLL | None] = {}


def _compile(name: str, extra_flags: tuple = ()) -> Path | None:
    src = _SRC / f"{name}.cpp"
    so = _BUILD / f"lib{name}.so"
    if not src.exists():
        return None
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    _BUILD.mkdir(exist_ok=True)
    # build under a private name, then rename: concurrent test workers may
    # compile the same library at once
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", *extra_flags,
             str(src), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _lib(name: str, extra_flags: tuple = ()):
    if name not in _LIBS:
        so = _compile(name, extra_flags)
        _LIBS[name] = ctypes.CDLL(str(so)) if so is not None else None
        lib = _LIBS[name]
        if lib is not None and name == "meshprep":
            lib.bisect_partition.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
        if lib is not None and name == "graph":
            lib.sort_unique_i64.restype = ctypes.c_int64
            lib.sort_unique_i64.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int]
            lib.searchsorted_i64.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    return _LIBS[name]


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _bfs_partition(xadj, adjncy, nparts: int) -> np.ndarray:
    """numpy fallback: single-level greedy BFS growing (no refinement) —
    ``goma_tpu.native.kway_partition`` without its native library."""
    n = xadj.shape[0] - 1
    out = np.empty(n, dtype=np.int32)
    target = n / nparts
    out[:] = nparts - 1
    taken = np.zeros(n, dtype=bool)
    for p in range(nparts - 1):
        rest = np.where(~taken)[0]
        if rest.size == 0:
            break
        frontier = [int(rest[0])]
        taken[rest[0]] = True
        out[rest[0]] = p
        w = 1
        while frontier and w < target:
            v = frontier.pop(0)
            for u in adjncy[xadj[v]:xadj[v + 1]]:
                if not taken[u] and w < target:
                    taken[u] = True
                    out[u] = p
                    w += 1
                    frontier.append(int(u))
        if w < target:
            extra = np.where(~taken)[0][: int(target - w)]
            taken[extra] = True
            out[extra] = p
    return out


def bisect_partition(xadj: np.ndarray, adjncy: np.ndarray,
                     adjwgt: np.ndarray) -> np.ndarray:
    """Multilevel 2-way partition with FM refinement (the nested-dissection
    separator kernel of solvers/ndlu)."""
    n = xadj.shape[0] - 1
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    adjwgt = np.ascontiguousarray(adjwgt, dtype=np.int64)
    lib = _lib("meshprep")
    if lib is None:
        return _bfs_partition(xadj, adjncy, 2)
    out = np.empty(n, dtype=np.int32)
    lib.bisect_partition(_i64p(xadj), _i64p(adjncy), _i64p(adjwgt), n,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def sort_unique(keys: np.ndarray) -> np.ndarray:
    """Sorted unique int64 keys (parallel C++ when available)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _lib("graph", ("-pthread",))
    if lib is None:
        return np.unique(keys)
    buf = keys.copy()
    m = lib.sort_unique_i64(_i64p(buf), buf.shape[0], 0)
    return buf[:m]


def searchsorted_native(sorted_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Parallel lower_bound lookup (falls back to np.searchsorted)."""
    lib = _lib("graph", ("-pthread",))
    q = np.ascontiguousarray(queries, dtype=np.int64)
    if lib is None:
        return np.searchsorted(sorted_keys, q)
    s = np.ascontiguousarray(sorted_keys, dtype=np.int64)
    out = np.empty(q.shape[0], dtype=np.int64)
    lib.searchsorted_i64(_i64p(s), s.shape[0], _i64p(q), q.shape[0],
                         _i64p(out), 0)
    return out
