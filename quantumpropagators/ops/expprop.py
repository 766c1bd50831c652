"""Dense matrix-exponential propagation (debug / small-system oracle).

The analogue of reference ``src/expprop.jl``: form ``U = f(H·dt)`` by
dense matrix functions and apply it.  Used as the cross-check oracle for
all polynomial kernels and as a practical propagator for small systems
(≲ a few hundred dimensions) where a dense matmul is one small kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.scipy.linalg as jsl

from .operators import apply, to_dense

__all__ = ["expprop_matrix", "expprop_apply"]


def expprop_matrix(op, dt: float, func: Optional[Callable] = None):
    """Compute the dense step matrix ``U = func(H·dt)``.

    The default ``func`` is the Schrödinger time evolution
    ``U = exp(-i H dt)`` (reference ``src/expprop.jl:41-49``).  A custom
    ``func`` receives the dense matrix ``H·dt`` and must return a
    matrix (e.g. use an eigendecomposition-based matrix function).
    """
    H = to_dense(op)
    M = H * dt
    if func is None:
        return jsl.expm(-1j * M)
    return func(M)


def expprop_apply(op, psi, dt: float, func: Optional[Callable] = None, U=None):
    """Evaluate ``psi' = func(H·dt) psi`` (default ``exp(-i H dt) psi``).

    Pass a precomputed ``U`` (from :func:`expprop_matrix`) to amortize
    the matrix function over many applications.
    """
    if U is None:
        U = expprop_matrix(op, dt, func)
    return apply(U, psi)
