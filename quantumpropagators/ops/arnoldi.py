"""Arnoldi iteration and Hessenberg utilities.

Builds the Krylov factorization ``H·dt ≈ Q† Hess Q`` from a starting
state, the workhorse under Newton propagation and spectral-range
estimation (reference ``src/arnoldi.jl``).

Design: the reference's modified Gram-Schmidt (sequential
dots, ``src/arnoldi.jl:84-87``) is replaced by *classical* Gram-Schmidt
with reorthogonalization (CGS2) — each orthogonalization is two batched
``(m+1, N) @ (N,)`` products that map onto dense matrix units and, under sharding,
onto a single ``psum`` per pass, instead of ``j`` sequential reductions.
CGS2 has the same numerical orthogonality guarantees as MGS.  The
iteration count ``m`` is static; Krylov breakdown is handled by masking
and reported as ``m_eff`` for the host.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .operators import apply

__all__ = ["arnoldi", "diagonalize_hessenberg_matrix"]


@partial(jax.jit, static_argnames=("m", "extended"))
def _arnoldi_impl(op, psi, m: int, dt, norm_min, extended: bool):
    N = psi.shape[-1]
    cdtype = jnp.result_type(psi.dtype, jnp.complex64)
    rdtype = jnp.finfo(cdtype).dtype
    q = jnp.zeros((m + 1, N), dtype=cdtype)
    nrm0 = jnp.sqrt(jnp.real(jnp.vdot(psi, psi)))
    q = q.at[0].set(psi.astype(cdtype))
    Hess = jnp.zeros((m + 1, m + 1), dtype=cdtype)
    dt = jnp.asarray(dt, dtype=rdtype)

    def body(j, state):
        q, Hess, m_eff, done = state
        w = apply(op, q[j])
        mask = (jnp.arange(m + 1) <= j).astype(cdtype)
        hcol = jnp.zeros((m + 1,), dtype=cdtype)
        # CGS2: two passes of classical Gram-Schmidt
        for _ in range(2):
            proj = mask * (jnp.conj(q) @ w)
            w = w - proj @ q
            hcol = hcol + proj
        h = jnp.sqrt(jnp.real(jnp.vdot(w, w)))
        breakdown = h < norm_min
        # column j of Hess: dt * hcol, plus subdiagonal dt * h
        col = dt * hcol
        col = col.at[j + 1].set(jnp.asarray(dt * h, dtype=cdtype))
        Hess = jnp.where(done, Hess, Hess.at[:, j].set(col))
        w_normed = jnp.where(h > 0, w / jnp.maximum(h, norm_min), w)
        q = jnp.where(done | breakdown, q, q.at[j + 1].set(w_normed))
        # breakdown at step j (0-based) => Krylov dim = j+1
        m_eff = jnp.where(done, m_eff, jnp.where(breakdown, j + 1, m))
        done = done | breakdown
        return (q, Hess, m_eff, done)

    state = (q, Hess, jnp.asarray(m, jnp.int32), jnp.asarray(False))
    q, Hess, m_eff, done = jax.lax.fori_loop(0, m, body, state)
    if not extended:
        # zero the (m, m-1) subdiagonal element and the extra vector to
        # match the non-extended reference factorization
        Hess = Hess.at[m, m - 1].set(0.0) if m >= 1 else Hess
    return Hess, q, m_eff


def arnoldi(op, psi, m: int, dt: float = 1.0, *, extended: bool = True,
            norm_min: float = 1e-15):
    """Compute the (extended) Arnoldi factorization of ``H·dt`` from ``psi``.

    Returns ``(Hess, q, m_eff)``: an ``(m+1, m+1)`` Hessenberg matrix of
    ``H·dt`` (the extended bottom row populated iff ``extended``), the
    ``(m+1, N)`` orthonormal Krylov basis (``q[0]`` is ``psi``
    normalized by assumption of the caller), and the effective Krylov
    dimension ``m_eff ≤ m`` (< m iff the Krylov space was exhausted,
    e.g. ``psi`` an eigenstate → ``m_eff = 1``; reference
    ``src/arnoldi.jl:60-100``).

    ``psi`` must be normalized (as in all reference call sites).
    """
    Hess, q, m_eff = _arnoldi_impl(
        op, psi, int(m), float(dt), float(norm_min), bool(extended)
    )
    return Hess, q, int(m_eff)


def diagonalize_hessenberg_matrix(Hess, m: int, *, accumulate: bool = False):
    """Eigenvalues of the leading ``m×m`` block of ``Hess`` (host-side).

    With ``accumulate=True``, concatenates the eigenvalues of all leading
    sub-blocks of size 1..m (reference ``src/arnoldi.jl:143-170``) —
    used by Newton to gather candidate Leja points across orders.
    ``m ≤ 60`` always (SURVEY §3.2): this is host LAPACK work, never
    device-critical.
    """
    H = np.asarray(Hess)[:m, :m]
    js = range(1, m + 1) if accumulate else [m]
    out = []
    for j in js:
        if j == 1:
            out.append(np.array([H[0, 0]]))
        elif j == 2:
            a, b = H[0, 0], H[0, 1]
            c, d = H[1, 0], H[1, 1]
            s = np.sqrt(a ** 2 + 4 * b * c - 2 * a * d + d ** 2 + 0j)
            out.append(np.array([0.5 * (a + d - s), 0.5 * (a + d + s)]))
        else:
            out.append(np.linalg.eigvals(H[:j, :j]))
    return np.concatenate(out).astype(np.complex128)
