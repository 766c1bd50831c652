"""Double-float ("df64") arithmetic: ~1e-15 relative precision from f32
pairs, for runs without float64 arrays (``jax_enable_x64`` off).

The reference is complex128 end-to-end with kernel tests at 1e-10
(``test/test_cheby.jl:8``).  A complex64 Chebyshev propagation accumulates ~1e-5..1e-4
error over 10^5 matvecs — far off the reference tolerance.  This module
provides the classic error-free-transformation toolbox (Dekker/Knuth
two-sum / split / two-product, no FMA required) vectorized over arrays,
a complex double-float layer, and a Chebyshev kernel for Hamiltonians
of the structured form

``H = D + Σ_k c_k · Π_k``   (diagonal + weighted bit-flip permutations)

which covers the transverse-field Ising chain/lattice benchmark family:
permutations are *exact* data movement and the diagonal product /
axpy / scaling are genuine df64 operations, so the only rounding is the
df64 epsilon (~2^-48 ≈ 4e-15) per operation.

Layout: a df64 array is a ``(hi, lo)`` pair of f32 arrays; a complex
df64 state is ``((re_hi, re_lo), (im_hi, im_lo))``.

Caveat: error-free transformations require IEEE f32 adds/mults without
fused contraction.  XLA's ``--xla_allow_excess_precision`` may break
them on some backends — ``validate_df64()`` runs a runtime self-check.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DD",
    "dd_from_f64",
    "dd_to_f64",
    "two_sum",
    "dd_add",
    "dd_sub",
    "dd_mul",
    "dd_scale",
    "CDD",
    "cdd_from_c128",
    "cdd_to_c128",
    "cdd_add",
    "cdd_scale",
    "cheby_apply_dd",
    "validate_df64",
]

_SPLIT = np.float32(4097.0)  # 2^12 + 1 (f32 has 24-bit mantissa)


class DD(NamedTuple):
    """A double-float array: value = hi + lo."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def dd_from_f64(x) -> DD:
    """Split float64 host data into (hi, lo) f32 pairs."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DD(jnp.asarray(hi), jnp.asarray(lo))


def dd_to_f64(x: DD) -> np.ndarray:
    return np.asarray(x.hi, dtype=np.float64) + np.asarray(x.lo, dtype=np.float64)


def _b(x):
    """Optimization barrier: forces the value to be materialized with
    f32 rounding.  Without it, XLA's algebraic simplifier / fast-math
    rewrites cancel the error-free-transformation expressions under
    ``jit`` (verified: eager two_sum is exact, un-barriered jitted
    two_sum loses the error term entirely)."""
    return jax.lax.optimization_barrier(x)


def two_sum(a, b):
    """Error-free sum: a + b = s + err exactly."""
    s = _b(a + b)
    bb = _b(s - a)
    err = _b(a - _b(s - bb)) + _b(b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = _b(a + b)
    err = _b(b - _b(s - a))
    return s, err


def _split(a):
    """Dekker split: a = a_hi + a_lo with 12-bit mantissas each."""
    t = _b(_SPLIT * a)
    a_hi = _b(t - _b(t - a))
    a_lo = _b(a - a_hi)
    return a_hi, a_lo


def _two_prod(a, b):
    """Error-free product: a*b = p + err exactly (no FMA needed)."""
    p = _b(a * b)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = _b(
        _b(_b(_b(a_hi * b_hi) - p) + _b(a_hi * b_lo) + _b(a_lo * b_hi))
        + _b(a_lo * b_lo)
    )
    return p, err


def dd_add(x: DD, y: DD) -> DD:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    # renormalize with the FULL two_sum: the 3-op quick_two_sum variant
    # is miscompiled by XLA when one operand chain contains scalar
    # broadcasts (verified empirically; the 6-op branch-free two_sum is
    # robust)
    hi, lo = two_sum(s, e)
    return DD(hi, lo)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_mul(x: DD, y: DD) -> DD:
    p, e = _two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    hi, lo = two_sum(p, e)  # see dd_add for why not quick_two_sum
    return DD(hi, lo)


def dd_scale(x: DD, s: DD) -> DD:
    """Multiply a df64 array by a df64 scalar."""
    return dd_mul(x, s)


class CDD(NamedTuple):
    """Complex double-float array."""

    re: DD
    im: DD


def cdd_from_c128(z) -> CDD:
    z = np.asarray(z, dtype=np.complex128)
    return CDD(dd_from_f64(z.real), dd_from_f64(z.imag))


def cdd_to_c128(z: CDD) -> np.ndarray:
    return dd_to_f64(z.re) + 1j * dd_to_f64(z.im)


def cdd_add(x: CDD, y: CDD) -> CDD:
    return CDD(dd_add(x.re, y.re), dd_add(x.im, y.im))


def cdd_scale(x: CDD, s: CDD) -> CDD:
    """(a+bi)(c+di) with df64 components."""
    re = dd_sub(dd_mul(x.re, s.re), dd_mul(x.im, s.im))
    im = dd_add(dd_mul(x.re, s.im), dd_mul(x.im, s.re))
    return CDD(re, im)


def _cdd_real_scale(x: CDD, s: DD) -> CDD:
    return CDD(dd_mul(x.re, s), dd_mul(x.im, s))


def _dd_const(v: float) -> DD:
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return DD(jnp.float32(hi), jnp.float32(lo))


def _gather_cdd(x: CDD, idx) -> CDD:
    return CDD(
        DD(x.re.hi[idx], x.re.lo[idx]), DD(x.im.hi[idx], x.im.lo[idx])
    )


def _flip_dd(x: DD, L: int, k: int) -> DD:
    """Exact bit-flip permutation of a df64 array: site ``k`` (0 = MSB).

    Expressed as an axis reversal over a 3D view — pure data movement
    (exact, a contiguous copy when the trailing dim is large)."""
    pre, post = 2 ** k, 2 ** (L - 1 - k)

    def f(a):
        return jnp.flip(a.reshape(pre, 2, post), axis=1).reshape(-1)

    return DD(f(x.hi), f(x.lo))


def _flip_apply(psi: CDD, L: int, flip_coeffs, diag: DD, *, use_gather=None) -> CDD:
    """``H psi`` for ``H = diag + Σ_k c_k X_k`` (bit-flip permutations),
    all in df64.  ``flip_coeffs`` is a host tuple of floats (one per
    site; site 0 = MSB); zero coefficients are skipped statically.

    Bit flips are EXACT data movement; by default they are realized as
    axis reversals (``jnp.flip``).  Set ``use_gather=True`` to use an
    index-gather instead.
    """
    N = 2 ** L
    # diagonal part: elementwise df64 product (real diag × complex psi)
    out = CDD(dd_mul(psi.re, diag), dd_mul(psi.im, diag))
    if use_gather:
        idx = jnp.arange(N, dtype=jnp.uint32)
    for k in range(L):
        c = float(flip_coeffs[k])
        if c == 0.0:
            continue
        if use_gather:
            flipped = _gather_cdd(psi, idx ^ np.uint32(1 << (L - 1 - k)))
        else:
            flipped = CDD(_flip_dd(psi.re, L, k), _flip_dd(psi.im, L, k))
        term = _cdd_real_scale(flipped, _dd_const(c))
        out = cdd_add(out, term)
    return out


@partial(
    jax.jit,
    static_argnames=("delta", "e_min", "dt", "L", "flip_coeffs", "forward"),
)
def _cheby_dd_impl(psi, diag, coeffs_hi, coeffs_lo, delta, e_min, dt, L,
                   flip_coeffs, forward):
    """df64 Chebyshev recurrence (structured flip Hamiltonian)."""
    n_coeffs = coeffs_hi.shape[0]
    beta = _dd_const(float(delta) / 2.0 + float(e_min))
    # c = ∓ 2i/Δ  → multiplication by i·s with s = ∓2/Δ real
    s_val = (-2.0 if forward else 2.0) / float(delta)

    def h_norm(v: CDD, scale: float) -> CDD:
        """scale·i·(H v − β v); scale real."""
        hv = _flip_apply(v, L, flip_coeffs, diag)
        w = CDD(
            dd_sub(hv.re, dd_mul(v.re, beta)),
            dd_sub(hv.im, dd_mul(v.im, beta)),
        )
        # multiply by i*scale: (a+bi)*i*s = -b*s + a*s i
        s = _dd_const(scale)
        return CDD(dd_mul(dd_neg(w.im), s), dd_mul(w.re, s))

    def ak(i):
        return DD(coeffs_hi[i], coeffs_lo[i])

    v0 = psi
    phi = _cdd_real_scale(v0, ak(0))
    v1 = h_norm(v0, s_val)
    phi = cdd_add(phi, _cdd_real_scale(v1, ak(1)))

    def body(carry, a_pair):
        v0, v1, phi = carry
        a_hi, a_lo = a_pair
        v2 = h_norm(v1, 2.0 * s_val)
        v2 = cdd_add(v2, v0)
        phi = cdd_add(phi, _cdd_real_scale(v2, DD(a_hi, a_lo)))
        return (v1, v2, phi), None

    (v0, v1, phi), _ = jax.lax.scan(
        body, (v0, v1, phi), (coeffs_hi[2:], coeffs_lo[2:])
    )

    # global phase exp(-i β dt), computed on host in f64.  The phase
    # multiply goes through the x64-guarded helper: XLA CPU constant-
    # folds the dd product's EFTs for in-graph constant phases (see
    # df64_sparse._phase_scale — the β≠0 latent-bug fix)
    from .df64_sparse import _phase_scale

    ph = np.exp(-1j * (float(delta) / 2.0 + float(e_min)) * float(dt))
    return _phase_scale(phi, ph)


def _split_f64(v: float):
    hi = np.float32(v)
    return hi, np.float32(np.float64(v) - np.float64(hi))


def cheby_apply_dd(
    psi: CDD,
    diag: DD,
    flip_coeffs,
    coeffs,
    delta: float,
    e_min: float,
    dt: float,
    *,
    L: int,
):
    """Evaluate ``exp(-i H dt)|psi⟩`` in df64 for
    ``H = diag + Σ_k flip_coeffs[k]·X_k`` (e.g. transverse-field Ising).

    ``coeffs`` are the float64 Chebyshev coefficients (host); ``psi`` a
    :class:`CDD` state.  Expected accuracy ~1e-13 per step — the
    float32-array path to the reference's 1e-10 tolerances.
    """
    coeffs = np.asarray(coeffs, dtype=np.float64)
    c_hi = coeffs.astype(np.float32)
    c_lo = (coeffs - c_hi.astype(np.float64)).astype(np.float32)
    return _cheby_dd_impl(
        psi,
        diag,
        jnp.asarray(c_hi),
        jnp.asarray(c_lo),
        float(delta),
        float(e_min),
        float(dt),
        int(L),
        tuple(float(c) for c in flip_coeffs),
        dt > 0,
    )


def validate_df64() -> bool:
    """Runtime self-check that error-free transformations survive the
    backend's compiler (excess-precision fusion can break them)."""
    a = jnp.float32(1.0 + 2 ** -20)
    b = jnp.float32(2 ** -30)
    s, e = jax.jit(two_sum)(a, b)
    exact = np.float64(np.float32(1.0 + 2 ** -20)) + np.float64(np.float32(2 ** -30))
    got = np.float64(s) + np.float64(e)
    if got != exact:
        return False
    x = jnp.float32(1.0 + 2 ** -12)
    y = jnp.float32(1.0 + 2 ** -13)
    p, e = jax.jit(_two_prod)(x, y)
    exact = np.float64(np.float32(1.0 + 2 ** -12)) * np.float64(
        np.float32(1.0 + 2 ** -13)
    )
    return (np.float64(p) + np.float64(e)) == exact
