"""Shared double-float plumbing for the Krylov-method propagators.

Newton and expv carry their state and interval operators in compensated
double-float (:mod:`..ops.dd_linalg`) when float64 is off (``precision=
"dd"``, or ``"auto"`` without ``jax_enable_x64``) — the reference's
complex128 semantics (``test/test_newton.jl:20`` holds every method to
1e-10) without float64 arrays."""

from __future__ import annotations

import jax
import numpy as np

__all__ = [
    "resolve_dd_precision",
    "build_dd_terms",
    "state_to_cdd",
    "interval_terms_dd",
]


def resolve_dd_precision(precision: str) -> str:
    """``'auto'`` → ``'dd'`` exactly when ``jax_enable_x64`` is off;
    explicit ``'dd'``/``'native'`` pass through."""
    if precision not in ("auto", "dd", "native"):
        raise ValueError(f"unknown precision={precision!r}")
    if precision == "auto":
        return "native" if jax.config.jax_enable_x64 else "dd"
    return precision


def build_dd_terms(op_proto, host_terms=None) -> tuple:
    """dd-split every term of a prototype interval Operator ONCE at
    init (host-side): term data never changes across steps or control
    updates (the coeffs-as-data invariant, SURVEY §7.1).

    ``host_terms`` (the ``dd_operator_terms`` propagator kwarg): host
    f64 matrices (scipy/numpy), one per generator term in order.  With
    x64 off the generator's device operator data has already
    been rounded to f32 at construction — double-float built from it is
    capped at ~6e-8 operator accuracy.  Supplying the f64 sources here
    restores the full dd entry precision (~2⁻⁴⁸), which the 1e-10
    contract configs need."""
    from ..models.generators import Operator
    from ..ops.dd_linalg import cdd_op_from_matrix
    from ..ops.operators import to_scipy_sparse

    if host_terms is not None:
        terms = list(host_terms)
        n_expect = (
            len(op_proto.ops) if isinstance(op_proto, Operator) else 1
        )
        if len(terms) != n_expect:
            raise ValueError(
                f"dd_operator_terms has {len(terms)} terms; the "
                f"generator has {n_expect}"
            )
        return tuple(cdd_op_from_matrix(t) for t in terms)
    terms = op_proto.ops if isinstance(op_proto, Operator) else [op_proto]
    return tuple(cdd_op_from_matrix(to_scipy_sparse(t)) for t in terms)


def state_to_cdd(state):
    from ..ops.df64 import cdd_from_c128

    return cdd_from_c128(np.asarray(state).astype(np.complex128))


def interval_terms_dd(dd_terms, coeffs):
    """The interval operator as a :class:`~..ops.dd_linalg.TermsDDOp`:
    only the dd coefficient planes change per interval."""
    from ..ops.dd_linalg import TermsDDOp
    from ..ops.newton import _split_c128_planes

    coeffs = np.asarray(coeffs)
    n = dd_terms[0].shape[0] if dd_terms[0].shape else 0
    return TermsDDOp(
        terms=dd_terms,
        coeffs4=_split_c128_planes(coeffs.astype(np.complex128)),
        shape=(n, n),
    )
