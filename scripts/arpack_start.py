"""A fixed start vector for ARPACK.

``scipy.sparse.linalg.eigs`` called without ``v0`` starts its Arnoldi
process from a random vector: SciPy >= 1.15 draws it from a generator
seeded by the operating system, older SciPy from Fortran ARPACK's
process-wide seed, which advances with every call. Where the wanted
eigenvalues lie in an unconverged cluster (no pair passes
``solve_stability``'s purification, so its least-bad fallback picks among
them), the start vector decides the pick. ``fixed_start`` gives every
``eigs`` call made inside it, by any package, the start vector
``default_rng(seed).uniform(-1, 1, n)``, so goma_tpu's record and the
port's run start from the same vector.
"""

from __future__ import annotations

import contextlib

import numpy as np


def start_vector(n: int, seed: int) -> np.ndarray:
    """The start vector of an n-dimensional problem."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, n)


@contextlib.contextmanager
def fixed_start(seed: int = 0):
    """Within the block, ``scipy.sparse.linalg.eigs`` calls without ``v0``
    start from ``start_vector(n, seed)``."""
    import scipy.sparse.linalg as spla

    orig = spla.eigs

    def eigs(A, *args, v0=None, **kwargs):
        if v0 is None and len(args) < 5:
            v0 = start_vector(A.shape[0], seed)
        return orig(A, *args, v0=v0, **kwargs)

    spla.eigs = eigs
    try:
        yield
    finally:
        spla.eigs = orig
