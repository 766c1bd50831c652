"""Krylov ``expv``: apply ``exp(-i dt H)`` through a single Arnoldi
factorization, without forming the propagator matrix.

The analogue of the reference's ExponentialUtilities backend
(``ext/QuantumPropagatorsExponentialUtilitiesExt.jl:74-210``): build an
``m``-dimensional Krylov subspace, exponentiate the small Hessenberg
matrix on the host, and combine ``Ψ' = β · Q† exp(-i dt Hess) e₁``.

Modes (mirroring the reference's ``:happy_breakdown`` vs
``:error_estimate``): with ``tol=None`` a fixed Krylov dimension ``m``
is used (stopping early only on happy breakdown); with a tolerance, the
generalized-residual error estimate ``β·|dt·h_{m+1,m}·[exp]_{m,1}|`` is
evaluated and ``m`` is doubled until it passes.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from .arnoldi import arnoldi

__all__ = ["expv_apply", "expv_apply_dd"]


def _combine(q, weights):
    return jnp.tensordot(jnp.asarray(weights).astype(q.dtype), q, axes=(0, 0))


@jax.jit
def _combine_dd(q4, W4):
    """Jitted dd combine ``β·Σᵢ wᵢ qᵢ`` (module-level: a per-call inner
    ``jax.jit`` would recompile every step)."""
    from .df64 import CDD, DD
    from .dd_linalg import cdd_combine

    basis = CDD(DD(q4.re.hi, q4.re.lo), DD(q4.im.hi, q4.im.lo))
    w = CDD(DD(W4[0], W4[1]), DD(W4[2], W4[3]))
    return cdd_combine(basis, w)


def expv_apply(
    op,
    psi,
    dt: float,
    *,
    m: int = 30,
    func=None,
    tol: Optional[float] = None,
    m_max: int = 120,
    norm_min: float = 1e-15,
):
    """Evaluate ``func(H·dt)|psi⟩`` (default ``exp(-i H dt)``) in one
    Krylov subspace.

    ``m`` is the (initial) Krylov dimension; with ``tol`` given, the
    dimension doubles until the standard Krylov error estimate drops
    below ``tol`` (capped at ``m_max``).
    """
    if func is None:
        func = lambda M: scipy.linalg.expm(-1j * M)
    beta = float(jnp.sqrt(jnp.real(jnp.vdot(psi, psi))))
    if beta == 0.0:
        return psi
    v = psi / beta
    N = psi.shape[-1]
    m = min(m, N)
    while True:
        Hess_dev, q, m_eff = arnoldi(op, v, m, dt, extended=True, norm_min=norm_min)
        Hess = np.asarray(Hess_dev)
        Hm = Hess[:m_eff, :m_eff]
        E = func(Hm)
        err = None
        happy = m_eff < m
        if not happy and tol is not None and m_eff >= 1:
            h_next = abs(Hess[m_eff, m_eff - 1]) if m_eff < Hess.shape[0] else 0.0
            err = beta * h_next * abs(E[m_eff - 1, 0])
            if err > tol and m < min(m_max, N):
                m = min(2 * m, m_max, N)
                continue
        weights = beta * E[:, 0]
        return _combine(q[:m_eff], weights)


def expv_apply_dd(
    op,
    psi,
    dt: float,
    *,
    m: int = 30,
    func=None,
    tol: Optional[float] = None,
    m_max: int = 120,
    norm_min: float = 1e-12,
):
    """Krylov ``expv`` in double-float: the reference-accuracy
    path for BASELINE config 3 ("Arnoldi expm-Krylov") — a dd Arnoldi
    factorization (:func:`~.dd_linalg.arnoldi_dd`), host ``expm`` of
    the small Hessenberg in complex128, and a dd linear combination of
    the basis.  Same mode semantics as :func:`expv_apply`
    (happy-breakdown / error-estimate; reference
    ``ext/QuantumPropagatorsExponentialUtilitiesExt.jl:74-210``).

    ``op``: dd operator or host matrix; ``psi``: host complex128 vector
    or :class:`~.df64.CDD`.  Returns a :class:`~.df64.CDD`."""
    import jax

    from .df64 import CDD, DD, cdd_from_c128, dd_mul
    from .dd_linalg import (
        CDDOp,
        DenseDDOp,
        TermsDDOp,
        arnoldi_dd,
        cdd_combine,
        cdd_norm,
        cdd_op_from_matrix,
        dd_div,
    )
    from .newton import _split_c128_planes

    if func is None:
        func = lambda M: scipy.linalg.expm(-1j * M)
    if not isinstance(op, (DenseDDOp, CDDOp, TermsDDOp)) and not callable(op):
        op = cdd_op_from_matrix(op)
    if not isinstance(psi, CDD):
        psi = cdd_from_c128(np.asarray(psi, dtype=np.complex128))
    nrm0 = cdd_norm(psi)
    beta = float(np.float64(nrm0.hi) + np.float64(nrm0.lo))
    if beta == 0.0:
        return psi
    inv0 = dd_div(DD(jnp.float32(1.0), jnp.float32(0.0)), nrm0)
    v = CDD(dd_mul(psi.re, inv0), dd_mul(psi.im, inv0))
    N = psi.re.hi.shape[-1]
    m = min(m, N)

    while True:
        Hess, q, m_eff = arnoldi_dd(op, v, m, dt, norm_min=norm_min)
        Hm = Hess[:m_eff, :m_eff]
        E = func(Hm)
        happy = m_eff < m
        if not happy and tol is not None and m_eff >= 1:
            h_next = (
                abs(Hess[m_eff, m_eff - 1]) if m_eff < Hess.shape[0]
                else 0.0
            )
            err = beta * h_next * abs(E[m_eff - 1, 0])
            if err > tol and m < min(m_max, N):
                m = min(2 * m, m_max, N)
                continue
        weights = beta * E[:, 0]
        q_rows = CDD(
            DD(q.re.hi[:m_eff], q.re.lo[:m_eff]),
            DD(q.im.hi[:m_eff], q.im.lo[:m_eff]),
        )
        return _combine_dd(q_rows, _split_c128_planes(weights))
