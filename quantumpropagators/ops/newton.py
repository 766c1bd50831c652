"""Newton-with-restarted-Arnoldi propagation kernel.

Evaluates ``Ψ ← f(H·dt) Ψ`` for an arbitrary analytic ``f`` (default
``exp(-i z)``, i.e. Schrödinger evolution; works for non-Hermitian H /
Liouvillians) via restarted Arnoldi with Newton-polynomial interpolation
at Leja-ordered Ritz points — the algorithm of reference
``src/newton.jl``.

Work split (SURVEY §3.2, §7.4.4): the O(N)-sized work per restart —
``m_max`` matvecs + Gram-Schmidt (CGS2) inside :func:`..arnoldi.arnoldi`,
plus the rank-(m+1) state updates — runs jitted on device; the O(m²)
scalar bookkeeping (Hessenberg eigenvalues, greedy Leja ordering,
divided differences, small polynomial recurrences) stays on the host in
complex128.  The data-dependent restart loop is host-driven: restart
granularity is coarse (hundreds of matvecs per restart), so host control
flow costs nothing while keeping every shape static.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .arnoldi import arnoldi, diagonalize_hessenberg_matrix

__all__ = [
    "newton_apply",
    "newton_apply_dd",
    "extend_leja",
    "extend_newton_coeffs",
    "NewtonInfo",
]


def _default_func(z):
    return np.exp(-1j * z)


def extend_leja(leja: np.ndarray, newpoints: np.ndarray, n_use: int) -> np.ndarray:
    """Append ``n_use`` points from ``newpoints`` to the Leja sequence.

    Greedy max-product selection: each added point maximizes
    ``Πⱼ |z - lejaⱼ|^(1/(n+n_use))`` over the remaining candidates (the
    damped exponent prevents overflow; reference
    ``src/newton.jl:97-148``).  If the sequence is empty it is seeded
    with the candidate of largest magnitude.  Returns the extended
    (copied) sequence.
    """
    leja = np.asarray(leja, dtype=np.complex128)
    pts = np.array(newpoints, dtype=np.complex128)
    n = len(leja)
    out = list(leja)
    take = n_use
    if n == 0:
        i0 = int(np.argmax(np.abs(pts)))
        out.append(pts[i0])
        pts = np.delete(pts, i0)
        take -= 1
    exponent = 1.0 / (n + n_use)
    for _ in range(take):
        # product over existing Leja points, damped to avoid overflow
        dists = np.abs(pts[:, None] - np.asarray(out)[None, :]) ** exponent
        p = np.prod(dists, axis=1)
        i_max = int(np.argmax(p))
        out.append(pts[i_max])
        pts = np.delete(pts, i_max)
    return np.asarray(out, dtype=np.complex128)


def extend_newton_coeffs(
    a: np.ndarray,
    leja: np.ndarray,
    func: Callable,
    n_leja: int,
    radius: float,
) -> np.ndarray:
    """Extend Newton divided-difference coefficients of ``func`` at the
    (radius-normalized) Leja points from ``len(a)`` to ``n_leja``
    (reference ``src/newton.jl:176-214``).

    The divided differences are accumulated with each factor normalized
    by ``radius`` to keep magnitudes bounded; underflow of the product
    (|d| ≤ 1e-200) raises, as in the reference.
    """
    a = list(np.asarray(a, dtype=np.complex128))
    n_a = len(a)
    if radius <= 0:
        raise ValueError("radius must be positive")
    n0 = n_a
    if n_a == 0:
        a.append(np.complex128(func(leja[0])))
        n0 = 1
    for k in range(n0, n_leja):
        d = np.complex128(1.0)
        pn = np.complex128(0.0)
        for n in range(1, k):
            d = d * (leja[k] - leja[n - 1]) / radius
            pn = pn + a[n] * d
        d = d * (leja[k] - leja[k - 1]) / radius
        if abs(d) <= 1e-200:
            raise FloatingPointError("Divided differences too small")
        a.append((np.complex128(func(leja[k])) - a[0] - pn) / d)
    return np.asarray(a, dtype=np.complex128)


@jax.jit
def _accumulate(Psi, q, P):
    """``Psi + Σᵢ P[i] q[i]`` as one rank-k update (device)."""
    return Psi + jnp.tensordot(P.astype(q.dtype), q, axes=(0, 0))


@jax.jit
def _norm(x):
    return jnp.sqrt(jnp.real(jnp.vdot(x, x)))


class NewtonInfo:
    """Diagnostics from a :func:`newton_apply` call (the inspectable
    fields of the reference's ``NewtonWrk``)."""

    def __init__(self):
        self.restarts = 0
        self.n_leja = 0
        self.n_a = 0
        self.radius = 0.0
        self.matvecs = 0


def newton_apply(
    op,
    psi,
    dt: float,
    *,
    func: Optional[Callable] = None,
    m_max: int = 10,
    norm_min: float = 1e-14,
    relerr: float = 1e-12,
    max_restarts: int = 50,
    info: Optional[NewtonInfo] = None,
):
    """Evaluate ``f(H·dt)|psi⟩`` by restarted Arnoldi + Newton
    interpolation (reference ``src/newton.jl:246-385``).

    Per restart ``s``: an ``m``-step Arnoldi factorization of ``H·dt``
    from the current residual vector; Ritz values of all leading
    sub-blocks are appended to a global Leja sequence; Newton
    divided-difference coefficients of ``f`` are extended; the Newton
    polynomial is evaluated *in the small extended Hessenberg matrix* to
    give the Krylov-basis coordinates ``P`` of this restart's correction
    ``ΔΨ = Σ Pᵢ qᵢ``; the next residual is the last Newton basis
    polynomial applied to the start vector.  Converged when
    ``β·|a_last| / (1 + ‖Ψ‖) < relerr``.
    """
    if func is None:
        func = _default_func
    if info is None:
        info = NewtonInfo()
    N = psi.shape[-1]
    if m_max <= 2:
        raise ValueError("Newton propagation requires m_max > 2")
    if m_max >= N:
        m_max = N - 1
        if m_max <= 2:
            raise ValueError("Newton propagation requires state dimension > 2")
    dt = float(dt)
    if dt == 0.0:
        raise ValueError("dt must be nonzero")

    leja = np.zeros((0,), dtype=np.complex128)
    a = np.zeros((0,), dtype=np.complex128)
    radius = 0.0

    beta = float(_norm(psi))
    v = psi / beta
    Psi = None
    m = m_max
    s = 0
    while True:
        Hess_dev, q, m_eff = arnoldi(
            op, v, m, dt, extended=True, norm_min=norm_min
        )
        info.matvecs += m
        m = m_eff
        Hess = np.asarray(Hess_dev, dtype=np.complex128)
        if m == 1 and s == 0:
            # v is an eigenvector: f(H)Ψ = f(λ)Ψ
            lam = beta * Hess[0, 0]
            result = jnp.asarray(func(lam), dtype=q.dtype) * psi
            info.restarts = s
            info.radius = radius
            return result

        ritz = diagonalize_hessenberg_matrix(Hess, m, accumulate=True)
        if s == 0:
            radius = 1.2 * float(np.max(np.abs(ritz)))

        n_s = len(leja)
        leja = extend_leja(leja, ritz, m)
        n_leja = len(leja)
        a = extend_newton_coeffs(a, leja, func, n_leja, radius)
        assert len(a) == n_leja

        # Evaluate the Newton polynomial in the (m+1)x(m+1) extended
        # Hessenberg matrix (host, small dense)
        Hm = Hess[: m + 1, : m + 1]
        R = np.zeros(m + 1, dtype=np.complex128)
        P = np.zeros(m + 1, dtype=np.complex128)
        R[0] = beta
        P[:] = a[n_s] * R
        for k in range(1, m):
            z = leja[n_s + k - 1]
            R = (Hm @ R - z * R) / radius
            P += a[n_s + k] * R

        delta_coords = jnp.asarray(P[:m], dtype=q.dtype)
        if s == 0:
            Psi = jnp.tensordot(delta_coords.astype(q.dtype), q[:m], axes=(0, 0))
        else:
            Psi = _accumulate(Psi, q[:m], delta_coords)

        # Next restart vector: last Newton basis polynomial applied to v
        R = (Hm @ R - leja[n_s + m - 1] * R) / radius
        beta = float(np.linalg.norm(R))
        if beta <= norm_min:
            break  # residual vanished: expansion is exact
        R = R / beta
        v = jnp.tensordot(jnp.asarray(R, dtype=q.dtype), q[: m + 1], axes=(0, 0))

        psi_relerr = beta * abs(a[n_leja - 1]) / (1.0 + float(_norm(Psi)))
        if psi_relerr < relerr:
            break
        s += 1
        if s > max_restarts:
            raise RuntimeError(
                f"Newton propagation did not converge within {max_restarts} restarts"
            )

    info.restarts = s
    info.n_leja = len(leja)
    info.n_a = len(a)
    info.radius = radius
    return Psi


# ---------------------------------------------------------------------------
# double-float (df64) Newton: reference accuracy without float64
# ---------------------------------------------------------------------------
#
# Same restart algorithm as :func:`newton_apply`, with every O(N)
# device operation in compensated double-float (:mod:`.dd_linalg`):
# the Arnoldi matvec + CGS2 dots, the rank-(m+1) state updates, and the
# state norms.  The O(m²) Leja/divided-difference bookkeeping stays
# host-side complex128 (identical code path).  Two compiled dispatches
# per restart — one Arnoldi call, one update call — so restarts are
# batched, not per-matvec host-driven (VERDICT r4 item 4).


@partial(jax.jit, static_argnames=("m",))
def _newton_update_dd(q, P4, R4, Psi, m: int):
    """Device-side restart tail in dd: ``Psi += Σ Pᵢ qᵢ``, next restart
    vector ``v = Σ Rᵢ qᵢ`` (R pre-normalized on host), ``‖Psi‖``.

    ``P4``/``R4`` are ``(4, m)`` / ``(4, m+1)`` dd-split complex weight
    planes (re_hi, re_lo, im_hi, im_lo)."""
    from .df64 import CDD, DD
    from .dd_linalg import cdd_combine, cdd_norm

    def wts(W4):
        return CDD(DD(W4[0], W4[1]), DD(W4[2], W4[3]))

    def rows(basis, k):
        return CDD(
            DD(basis.re.hi[:k], basis.re.lo[:k]),
            DD(basis.im.hi[:k], basis.im.lo[:k]),
        )

    from .df64 import cdd_add

    delta = cdd_combine(rows(q, m), wts(P4))
    Psi = cdd_add(Psi, delta)
    v = cdd_combine(rows(q, m + 1), wts(R4))
    nrm = cdd_norm(Psi)
    return Psi, v, nrm.hi, nrm.lo


def _split_c128_planes(w):
    """Host complex128 vector → (4, n) f32 dd planes."""
    w = np.asarray(w, dtype=np.complex128)
    out = np.zeros((4, len(w)), dtype=np.float32)
    for i, part in enumerate((w.real, w.imag)):
        hi = part.astype(np.float32)
        out[2 * i] = hi
        out[2 * i + 1] = (part - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(out)


def newton_apply_dd(
    op,
    psi,
    dt: float,
    *,
    func: Optional[Callable] = None,
    m_max: int = 10,
    norm_min: float = 1e-12,
    relerr: float = 1e-12,
    max_restarts: int = 50,
    info: Optional[NewtonInfo] = None,
):
    """Evaluate ``f(H·dt)|psi⟩`` by restarted Arnoldi + Newton
    interpolation **in double-float**: the path without float64 arrays to the
    reference's 1e-10 contract (``test/test_newton.jl:20``) without
    float64 hardware.

    ``op`` is a dd operator (:class:`~.dd_linalg.DenseDDOp` /
    :class:`~.dd_linalg.CDDOp`, or any host matrix — converted via
    :func:`~.dd_linalg.cdd_op_from_matrix`); ``psi`` a host complex128
    vector or a :class:`~.df64.CDD`.  Returns a :class:`~.df64.CDD`
    (``cdd_to_c128`` recovers the f64 state).  Algorithm: reference
    ``src/newton.jl:246-385``."""
    from .df64 import CDD, DD, cdd_from_c128, dd_mul
    from .dd_linalg import (
        CDDOp,
        DenseDDOp,
        TermsDDOp,
        apply_cdd_op,
        arnoldi_dd,
        cdd_norm,
        cdd_op_from_matrix,
        dd_div,
    )

    if func is None:
        func = _default_func
    if info is None:
        info = NewtonInfo()
    if not isinstance(op, (DenseDDOp, CDDOp, TermsDDOp)) and not callable(op):
        op = cdd_op_from_matrix(op)
    if not isinstance(psi, CDD):
        psi = cdd_from_c128(np.asarray(psi, dtype=np.complex128))
    N = psi.re.hi.shape[-1]
    if m_max <= 2:
        raise ValueError("Newton propagation requires m_max > 2")
    if m_max >= N:
        m_max = N - 1
        if m_max <= 2:
            raise ValueError("Newton propagation requires state dimension > 2")
    dt = float(dt)
    if dt == 0.0:
        raise ValueError("dt must be nonzero")

    leja = np.zeros((0,), dtype=np.complex128)
    a = np.zeros((0,), dtype=np.complex128)
    radius = 0.0

    nrm0 = cdd_norm(psi)
    beta = float(np.float64(nrm0.hi) + np.float64(nrm0.lo))
    inv0 = dd_div(DD(jnp.float32(1.0), jnp.float32(0.0)), nrm0)
    v = CDD(dd_mul(psi.re, inv0), dd_mul(psi.im, inv0))
    z32 = jnp.zeros((N,), jnp.float32)
    Psi = CDD(DD(z32, z32), DD(z32, z32))
    m = m_max
    s = 0
    while True:
        Hess, q, m_eff = arnoldi_dd(op, v, m, dt, norm_min=norm_min)
        info.matvecs += m
        m = m_eff
        if m == 1 and s == 0:
            # v is an eigenvector: f(H)Ψ = f(λ)Ψ
            lam = beta * Hess[0, 0]
            w = np.complex128(func(lam))
            wr = _split_c128_planes(np.array([w]))
            wc = CDD(DD(wr[0, 0], wr[1, 0]), DD(wr[2, 0], wr[3, 0]))
            from .df64 import cdd_scale

            info.restarts = s
            info.radius = radius
            return cdd_scale(psi, wc)

        ritz = diagonalize_hessenberg_matrix(Hess, m, accumulate=True)
        if s == 0:
            radius = 1.2 * float(np.max(np.abs(ritz)))

        n_s = len(leja)
        leja = extend_leja(leja, ritz, m)
        n_leja = len(leja)
        a = extend_newton_coeffs(a, leja, func, n_leja, radius)

        Hm = Hess[: m + 1, : m + 1]
        R = np.zeros(m + 1, dtype=np.complex128)
        P = np.zeros(m + 1, dtype=np.complex128)
        R[0] = beta
        P[:] = a[n_s] * R
        for k in range(1, m):
            z = leja[n_s + k - 1]
            R = (Hm @ R - z * R) / radius
            P += a[n_s + k] * R

        # next restart vector coordinates (host-normalized)
        R = (Hm @ R - leja[n_s + m - 1] * R) / radius
        beta_next = float(np.linalg.norm(R))
        Rn = R / beta_next if beta_next > 0 else R

        Psi, v, nh, nl = _newton_update_dd(
            q,
            _split_c128_planes(P[:m]),
            _split_c128_planes(Rn),
            Psi,
            m,
        )
        norm_Psi = float(np.float64(nh) + np.float64(nl))
        beta = beta_next
        if beta <= norm_min:
            break  # residual vanished: expansion is exact
        psi_relerr = beta * abs(a[n_leja - 1]) / (1.0 + norm_Psi)
        if psi_relerr < relerr:
            break
        s += 1
        if s > max_restarts:
            raise RuntimeError(
                f"Newton propagation did not converge within "
                f"{max_restarts} restarts"
            )

    info.restarts = s
    info.n_leja = len(leja)
    info.n_a = len(a)
    info.radius = radius
    return Psi
