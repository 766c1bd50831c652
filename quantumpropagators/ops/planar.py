"""Planar (re, im) float32 fast path for the Chebyshev hot loop.

A complex64 array is stored interleaved; every time the grouped
matvec (:class:`...models.lattice.GroupedSiteSum`) contracts a *real*
group operator against a complex state it must first materialize
``jnp.real(psi)`` / ``jnp.imag(psi)`` — a full strided deinterleave pass
over HBM per plane per group, and a re-interleave on the way out.  At
2^24 that roughly doubles the memory traffic of a Chebyshev iteration.

This module keeps the state as a pair of contiguous f32 planes
``(re, im)`` through the *entire* recurrence instead.  The structure of
the Chebyshev step makes this natural (reference ``src/cheby.jl:150-213``
for the algorithm):

- ``H`` is real in the benchmark family (diagonal + real site groups),
  so ``H v`` acts on each plane independently;
- the recurrence scalar ``c₂ = ∓4i/Δ`` is *purely imaginary*, so
  ``c₂·u`` is a plane swap with one real scale:
  ``(re, im) ← (∓s·u_im, ±s·u_re)``;
- coefficients ``a_k`` are real.

The only genuinely complex operation is the final global phase
``exp(-iβdt)``, applied once.  No complex arithmetic — and no
interleave/deinterleave — appears anywhere in the scanned loop.

``apply_planar(op, re, im)`` is the planar analogue of the ``apply``
protocol for *real-linear* operators (real diagonal, real site groups,
real dense blocks, real-coefficient :class:`Operator` sums).  Complex
operators fall back to forming the complex state (correct, slower).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .operators import CSROperator, DIAOperator, DiagonalOperator, apply

# float32 contractions at full precision: GPUs otherwise may run
# them in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["apply_planar", "cheby_apply_planar", "is_real_linear"]


def _is_real(x) -> bool:
    return jnp.asarray(x).dtype.kind == "f"


def is_real_linear(op) -> bool:
    """True if ``op`` maps real states to real states (so it acts on the
    re/im planes independently)."""
    from ..models.generators import Operator, ScaledOperator
    from ..models.lattice import GroupedSiteSum, SiteOperatorSum

    if isinstance(op, (jnp.ndarray, np.ndarray)):
        return op.dtype.kind == "f"
    if isinstance(op, DiagonalOperator):
        return _is_real(op.diag)
    if isinstance(op, (CSROperator, DIAOperator)):
        return _is_real(op.data)
    if isinstance(op, GroupedSiteSum):
        return all(_is_real(A) for A in op.group_mats)
    if isinstance(op, SiteOperatorSum):
        return _is_real(op.site_mats)
    if isinstance(op, ScaledOperator):
        return (
            np.asarray(op.coeff).dtype.kind in "if"
        ) and is_real_linear(op.operator)
    if isinstance(op, Operator):
        coeffs_real = jnp.asarray(op.coeffs).dtype.kind in "if"
        return coeffs_real and all(is_real_linear(o) for o in op.ops)
    return False


def apply_planar(op, re, im):
    """``(re', im') = op @ (re + i·im)`` for real-linear ``op``, applied
    per-plane with no complex intermediates.

    Falls back to the complex ``apply`` protocol (with an interleave /
    deinterleave round trip) for operators that are not real-linear.
    """
    from ..models.generators import Operator, ScaledOperator
    from ..models.lattice import GroupedSiteSum, SiteOperatorSum

    if isinstance(op, (jnp.ndarray, np.ndarray)) and op.dtype.kind == "f":
        A = jnp.asarray(op)
        return (
            jnp.matmul(re, A.T, precision=_HIGHEST),
            jnp.matmul(im, A.T, precision=_HIGHEST),
        )
    if isinstance(op, DiagonalOperator) and _is_real(op.diag):
        return op.diag * re, op.diag * im
    if isinstance(op, GroupedSiteSum) and all(
        _is_real(A) for A in op.group_mats
    ):
        return _grouped_planar(op, re), _grouped_planar(op, im)
    if isinstance(op, SiteOperatorSum) and _is_real(op.site_mats):
        return op.apply(re), op.apply(im)
    if isinstance(op, (CSROperator, DIAOperator)) and _is_real(op.data):
        return op.apply(re), op.apply(im)
    if isinstance(op, ScaledOperator) and is_real_linear(op):
        r, i = apply_planar(op.operator, re, im)
        return op.coeff * r, op.coeff * i
    if isinstance(op, Operator) and is_real_linear(op):
        off = op.drift_offset
        out_r = out_i = None
        for k, term_op in enumerate(op.ops):
            tr, ti = apply_planar(term_op, re, im)
            if k >= off:
                c = op.coeffs[k - off]
                tr, ti = c * tr, c * ti
            out_r = tr if out_r is None else out_r + tr
            out_i = ti if out_i is None else out_i + ti
        return out_r, out_i
    # generic fallback: complex round trip
    out = apply(op, jax.lax.complex(re, im))
    return jnp.real(out), jnp.imag(out)


def _grouped_planar(op, plane):
    """One real plane through a :class:`GroupedSiteSum` (sum of per-group
    matmuls)."""
    N = int(np.prod(op.dims))
    lead = plane.shape[:-1]
    out = None
    pre = 1
    for g, A in enumerate(op.group_mats):
        F = op.dims[g]
        post = N // (pre * F)
        resh = plane.reshape(lead + (pre, F, post))
        term = jnp.einsum(
            "ab,...xbz->...xaz", A.astype(plane.dtype), resh,
            precision=_HIGHEST,
        )
        term = term.reshape(lead + (N,))
        out = term if out is None else out + term
        pre *= F
    if out is None:
        out = jnp.zeros_like(plane)
    return out


def cheby_apply_planar(
    op,
    re,
    im,
    coeffs,
    delta,
    e_min,
    dt,
    *,
    forward: bool = True,
    apply_planar_fn=None,
):
    """Chebyshev step ``exp(-i H dt)`` on planar f32 state ``(re, im)``.

    Mathematically identical to :func:`..cheby.cheby_apply` (reference
    algorithm ``src/cheby.jl:150-213``) for real-linear ``op``; returns
    the propagated ``(re, im)`` planes.  All scan-loop arithmetic is
    real f32 — see module docstring.
    """
    if apply_planar_fn is None:
        apply_planar_fn = apply_planar
    rdtype = re.dtype
    beta = jnp.asarray(delta / 2.0 + e_min, dtype=rdtype)
    # c = sign*2i/Δ with sign = -1 forward: c·u = s·(i·u),
    # s = sign*2/Δ → (c·u)_re = -s·u_im, (c·u)_im = s·u_re
    sign = -1.0 if forward else 1.0
    s = jnp.asarray(sign * 2.0, dtype=rdtype) / delta
    a = coeffs.astype(rdtype)

    v0r, v0i = re, im
    phi_r = a[0] * v0r
    phi_i = a[0] * v0i
    ur, ui = apply_planar_fn(op, v0r, v0i)
    ur = ur - beta * v0r
    ui = ui - beta * v0i
    v1r = -s * ui
    v1i = s * ur
    phi_r = phi_r + a[1] * v1r
    phi_i = phi_i + a[1] * v1i
    s2 = 2.0 * s

    def body(carry, ak):
        v0r, v0i, v1r, v1i, phi_r, phi_i = carry
        ur, ui = apply_planar_fn(op, v1r, v1i)
        ur = ur - beta * v1r
        ui = ui - beta * v1i
        v2r = -s2 * ui + v0r
        v2i = s2 * ur + v0i
        phi_r = phi_r + ak * v2r
        phi_i = phi_i + ak * v2i
        return (v1r, v1i, v2r, v2i, phi_r, phi_i), None

    init = (v0r, v0i, v1r, v1i, phi_r, phi_i)
    (_, _, _, _, phi_r, phi_i), _ = jax.lax.scan(body, init, a[2:])

    # final global phase exp(-i β dt) — the only complex scalar
    ang = -float(dt) * beta
    pr, pi = jnp.cos(ang), jnp.sin(ang)
    out_r = pr * phi_r - pi * phi_i
    out_i = pr * phi_i + pi * phi_r
    return out_r, out_i
