"""Chebyshev polynomial propagation kernel.

Evaluates ``Ψ ← exp(-i H dt) Ψ`` by a Chebyshev expansion of the
normalized Hamiltonian, following the algorithm of reference
``src/cheby.jl``: coefficients ``a_k = (2 - δ_k0) · J_k(Δ·dt/2)``
truncated below ``limit`` (``src/cheby.jl:25-39``), three-vector
recurrence ``v₂ = c (H v₁ − β v₁) + v₀`` with ``β = Δ/2 + E_min`` and
``c = ∓2i/Δ`` (sign selects forward/backward), and a final global phase
``exp(-i β dt)`` (``src/cheby.jl:150-213``).

Realization: the recurrence is a ``lax.scan`` over a
statically-sized coefficient array; the "workspace" (v₀, v₁, Φ) is the
scan carry, so XLA double-buffers it in place — the functional analogue
of the reference's pointer-rotating ``ChebyWrk``.  Coefficients are
computed host-side (tiny Bessel series, once per ``(Δ, dt)``), and the
coefficient count is *static*, optionally padded so small spectral-range
changes don't force recompilation (SURVEY §7.4.5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import jv as _besselj

from .operators import apply

__all__ = ["cheby_coeffs", "n_cheby_coeffs", "ChebyWorkspace", "cheby_apply"]


def cheby_coeffs(delta: float, dt: float, limit: float = 1e-12) -> np.ndarray:
    """Chebyshev coefficients for ``exp(-i H dt)`` with spectral radius
    ``delta``.

    Returns ``[J₀(α), 2J₁(α), 2J₂(α), ...]`` with ``α = |Δ·dt/2|``,
    including the first coefficient whose magnitude drops to ``limit``
    or below (matching the truncation loop of reference
    ``src/cheby.jl:25-39``; the pinned count for Δ·dt/2 ≈ 250 is 267-268
    coefficients, ``test/test_cheby.jl:36``).
    """
    alpha = abs(0.5 * float(delta) * float(dt))
    # Generous upper bound: |J_k(α)| decays superexponentially for
    # k ≳ α; α + 40·log10(1/limit) is far past the 1e-12 tail.
    chunk = max(64, int(alpha + 1.5 * max(1.0, np.log10(1.0 / max(limit, 1e-300))) * 40))
    k = 0
    coeffs = [float(_besselj(0, alpha))]
    eps = abs(coeffs[0])
    n = 1
    while eps > limit:
        ks = np.arange(n, n + chunk)
        vals = 2.0 * _besselj(ks, alpha)
        below = np.nonzero(np.abs(vals) <= limit)[0]
        if below.size:
            stop = int(below[0]) + 1
            coeffs.extend(vals[:stop].tolist())
            eps = abs(vals[stop - 1])
            n += stop
            break
        coeffs.extend(vals.tolist())
        eps = abs(vals[-1])
        n += chunk
    return np.asarray(coeffs, dtype=np.float64)


def n_cheby_coeffs(delta: float, dt: float, limit: float = 1e-12) -> int:
    return len(cheby_coeffs(delta, dt, limit))


@dataclass(frozen=True)
class ChebyWorkspace:
    """Static per-``(Δ, E_min, dt)`` data for Chebyshev propagation.

    The functional analogue of the reference's ``ChebyWrk``
    (``src/cheby.jl:87-124``): holds the truncated coefficient array and
    normalization parameters.  No state buffers — those live in the scan
    carry.  ``pad_to`` rounds the coefficient count up (zero-padding) so
    that re-initializations with slightly different spectral ranges hit
    the same compiled step.
    """

    coeffs: Any  # (n_coeffs,) float array (possibly zero-padded)
    n_coeffs: int
    delta: float
    e_min: float
    dt: float
    limit: float = 1e-12

    @classmethod
    def create(
        cls,
        delta: float,
        e_min: float,
        dt: float,
        *,
        limit: float = 1e-12,
        pad_to: int = 1,
        dtype=None,
    ) -> "ChebyWorkspace":
        a = cheby_coeffs(delta, dt, limit)
        n = len(a)
        if pad_to > 1:
            padded = ((n + pad_to - 1) // pad_to) * pad_to
            a = np.pad(a, (0, padded - n))
        if dtype is not None:
            a = a.astype(dtype)
        return cls(
            coeffs=jnp.asarray(a),
            n_coeffs=n,
            delta=float(delta),
            e_min=float(e_min),
            dt=float(dt),
            limit=float(limit),
        )


def cheby_apply(
    op,
    psi,
    coeffs,
    delta,
    e_min,
    dt,
    *,
    forward: bool = True,
    check_normalization: bool = False,
    apply_fn=None,
):
    """Evaluate ``exp(-i H dt) |psi⟩`` via the Chebyshev recurrence.

    ``op`` is any operator implementing the ``apply`` protocol (pytree —
    may be traced), ``coeffs`` a statically-shaped coefficient array.
    ``delta``/``e_min``/``dt`` may be host floats or traced scalars;
    ``dt`` is the *signed* time step and the static ``forward`` flag
    must match its sign (it selects ``c = ∓2i/Δ``; reference
    ``src/cheby.jl:158-162``).  ``|dt|`` must match the step the
    coefficients were computed for.

    With ``check_normalization=True``, additionally returns the maximum
    over the recurrence of ``|⟨v₁, H_norm v₁⟩| / ‖v₁‖²`` — the host can
    assert it ≤ 1 + limit to detect a spectral envelope violation
    (reference ``src/cheby.jl:194-200``).
    """
    if apply_fn is None:
        apply_fn = apply
    cdtype = jnp.result_type(psi.dtype, jnp.complex64)
    psi = psi.astype(cdtype)
    beta = (delta / 2.0) + e_min
    sign = -1.0 if forward else 1.0
    c = jnp.asarray(sign * 2.0j, dtype=cdtype) / delta
    a = coeffs.astype(jnp.finfo(cdtype).dtype if coeffs.dtype.kind == "f" else cdtype)

    v0 = psi
    phi = a[0] * v0
    v1 = c * (apply_fn(op, v0) - beta * v0)
    phi = phi + a[1] * v1
    c2 = 2.0 * c

    def body(carry, ak):
        v0, v1, phi, max_norm = carry
        hv = c2 * (apply_fn(op, v1) - beta * v1)
        if check_normalization:
            map_norm = jnp.abs(jnp.vdot(v1, hv)) / (
                2.0 * jnp.real(jnp.vdot(v1, v1))
            )
            max_norm = jnp.maximum(max_norm, map_norm)
        v2 = hv + v0
        phi = phi + ak * v2
        return (v1, v2, phi, max_norm), None

    init = (v0, v1, phi, jnp.zeros((), dtype=jnp.real(c).dtype))
    (v0, v1, phi, max_norm), _ = jax.lax.scan(body, init, a[2:])

    phase = jnp.exp(jnp.asarray(-1j, dtype=cdtype) * beta * dt)
    result = phase * phi
    if check_normalization:
        return result, max_norm
    return result
