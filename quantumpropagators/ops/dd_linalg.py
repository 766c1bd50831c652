"""Double-float (df64) linear algebra for the Krylov methods without
float64 arrays: compensated dot/norm reductions, dd operator applies,
and a dd Arnoldi iteration.

The Chebyshev recurrence has its dd form in :mod:`.df64`; Newton/expv
need dd inner products and matvecs as well.  This module supplies them:

- ``dd_sum`` — compensated pairwise reduction whose value lane stays
  error-free through every level (two_sum cascades), with an optional
  mesh axis: the cross-device stage ``all_gather``s the per-shard
  ``(hi, lo)`` partials (two f32 scalars per device) and reduces them
  in dd — a ``psum`` of the hi planes alone would round at 2⁻²⁴ and
  destroy the double-float invariant.
- ``cdd_dot`` / ``cdd_norm`` — the ⟨x|y⟩ and ‖x‖ every Krylov kernel
  needs (reference MGS dots ``src/arnoldi.jl:84-97``, Newton
  convergence ``src/newton.jl:271,361,370``).
- ``DenseDDOp`` — a complex dense operator as four f32 planes with an
  error-free row contraction (the transmon/optomech scale; sparse
  operators ride :class:`~.df64_sparse.BSRdd` via :class:`CDDOp`).
- ``arnoldi_dd`` — CGS2 Arnoldi with dd inner products and a dd-
  orthonormalized basis, one jitted call per restart (static ``m``),
  breakdown masked.  With ``axis_name`` it runs unchanged inside
  ``shard_map``: matvec halo exchange + dd-gathered reductions.

Accuracy: each primitive rounds at ~2⁻⁴⁸ relative, so an m≤60 Arnoldi
factorization carries ~1e-13 — inside the reference's 1e-10 contract
(``test/test_newton.jl:20``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .df64 import (
    CDD,
    DD,
    _b,
    _two_prod,
    cdd_add,
    dd_add,
    dd_mul,
    dd_neg,
    dd_sub,
    two_sum,
)
from .df64_sparse import _tree_sum_dd, dd_split_np
from .operators import _register_pytree

__all__ = [
    "dd_sum",
    "dd_div",
    "dd_sqrt",
    "cdd_dot",
    "cdd_norm_sq",
    "cdd_norm",
    "cdd_combine",
    "DenseDDOp",
    "CDDOp",
    "TermsDDOp",
    "dense_dd_from_numpy",
    "cdd_op_from_matrix",
    "apply_cdd_op",
    "arnoldi_dd",
    "cdd_to_device_complex",
]


def cdd_to_device_complex(x):
    """Merge a CDD state to the backend's widest complex dtype (c128
    with x64 on, else a c64 *view* — the dd planes stay authoritative
    in that case)."""
    if jax.config.jax_enable_x64:
        return (x.re.hi.astype(jnp.float64) + x.re.lo) + 1j * (
            x.im.hi.astype(jnp.float64) + x.im.lo
        )
    return jax.lax.complex(x.re.hi + x.re.lo, x.im.hi + x.im.lo)


# ---------------------------------------------------------------------------
# scalar / reduction primitives
# ---------------------------------------------------------------------------


def dd_sum(x: DD, axis=-1, axis_name: Optional[str] = None) -> DD:
    """Compensated sum of a df64 array along ``axis``.

    The value lane goes through error-free two_sum at every tree level;
    the compensation lane accumulates with ~2⁻⁴⁸-relative rounding.
    With ``axis_name`` (inside ``shard_map``) the per-shard partial is
    combined across the mesh by gathering the (hi, lo) scalar pairs and
    reducing them in dd — exact where a plain ``psum`` would not be."""
    ph, pe = _tree_sum_dd(x.hi, x.lo, axis)
    if axis_name is not None:
        # (n_dev, ...) partials; reduce over the device axis in dd
        gh = jax.lax.all_gather(ph, axis_name)
        ge = jax.lax.all_gather(pe, axis_name)
        ph, pe = _tree_sum_dd(
            jnp.moveaxis(gh, 0, -1), jnp.moveaxis(ge, 0, -1), -1
        )
    hi, lo = two_sum(ph, pe)
    return DD(hi, lo)


def dd_div(x: DD, y: DD) -> DD:
    """df64 division (classic two-step long division)."""
    q1 = _b(x.hi / y.hi)
    r = dd_sub(x, dd_mul(DD(q1, jnp.zeros_like(q1)), y))
    q2 = _b((r.hi + r.lo) / y.hi)
    hi, lo = two_sum(q1, q2)
    return DD(hi, lo)


def dd_sqrt(x: DD) -> DD:
    """df64 square root via one Newton correction of the f32 root.

    ``s = √hi``; ``s' = s + (x − s²)/(2s)`` — quadratic convergence
    from the f32 approximation lands at the dd epsilon.  Guarded for
    ``x = 0`` (returns 0)."""
    s = _b(jnp.sqrt(x.hi))
    safe = jnp.where(s > 0, s, jnp.float32(1.0))
    s2 = dd_mul(DD(safe, jnp.zeros_like(safe)), DD(safe, jnp.zeros_like(safe)))
    r = dd_sub(x, s2)
    corr = _b((r.hi + r.lo) / (2.0 * safe))
    hi, lo = two_sum(safe, corr)
    zero = jnp.zeros_like(hi)
    return DD(jnp.where(s > 0, hi, zero), jnp.where(s > 0, lo, zero))


def _dd_bcast_mul(a: DD, x: DD) -> DD:
    """dd product with broadcasting (scalar·array etc.)."""
    return dd_mul(a, x)


def cdd_dot(x: CDD, y: CDD, axis_name: Optional[str] = None) -> CDD:
    """``⟨x|y⟩ = Σ conj(x)·y`` in df64 (scalar CDD).

    The reductions all share the compensated tree of :func:`dd_sum`;
    under sharding each of the four real reductions gathers its dd
    partials across ``axis_name``."""
    rr = dd_sum(dd_mul(x.re, y.re), axis_name=axis_name)
    ii = dd_sum(dd_mul(x.im, y.im), axis_name=axis_name)
    ri = dd_sum(dd_mul(x.re, y.im), axis_name=axis_name)
    ir = dd_sum(dd_mul(x.im, y.re), axis_name=axis_name)
    return CDD(dd_add(rr, ii), dd_sub(ri, ir))


def cdd_norm_sq(x: CDD, axis_name: Optional[str] = None) -> DD:
    rr = dd_sum(dd_mul(x.re, x.re), axis_name=axis_name)
    ii = dd_sum(dd_mul(x.im, x.im), axis_name=axis_name)
    return dd_add(rr, ii)


def cdd_norm(x: CDD, axis_name: Optional[str] = None) -> DD:
    return dd_sqrt(cdd_norm_sq(x, axis_name=axis_name))


def cdd_combine(q: CDD, w: CDD) -> CDD:
    """``Σᵢ wᵢ qᵢ`` — a dd linear combination of basis vectors.

    ``q`` planes are ``(m, N)``, ``w`` planes ``(m,)`` (complex dd
    weights); returns the ``(N,)`` combination via the compensated
    tree over the basis axis."""

    def col(a: DD) -> DD:
        return DD(a.hi[:, None], a.lo[:, None])

    wr, wi = col(w.re), col(w.im)
    re = dd_sub(dd_mul(wr, q.re), dd_mul(wi, q.im))
    im = dd_add(dd_mul(wr, q.im), dd_mul(wi, q.re))

    def reduce0(a: DD) -> DD:
        ph, pe = _tree_sum_dd(a.hi, a.lo, 0)
        hi, lo = two_sum(ph, pe)
        return DD(hi, lo)

    return CDD(reduce0(re), reduce0(im))


# ---------------------------------------------------------------------------
# dd operators
# ---------------------------------------------------------------------------


def _dense_real_matvec_dd(Ah, Al, x: DD) -> DD:
    """``A·x`` for a real dense dd matrix: error-free hi·hi row
    products, f32 cross terms (≤2⁻²⁴ of value scale), compensated row
    reduction — same scheme as the blocked-ELL kernel
    (:func:`~.df64_sparse.bsr_blocks_apply_dd`)."""
    p, e = _two_prod(Ah, x.hi[None, :])
    e = _b(e + _b(Ah * x.lo[None, :])) + _b(Al * x.hi[None, :])
    ph, pe = _tree_sum_dd(p, e, -1)
    hi, lo = two_sum(ph, pe)
    return DD(hi, lo)


@dataclass(frozen=True)
class DenseDDOp:
    """Complex dense operator as four f32 planes (re/im × hi/lo).

    The dd operator for the dense-regime Krylov configs (driven
    transmon ladder N≈10–4096, reference BASELINE config 2); entries
    carry full f64 precision across the plane pairs."""

    re_hi: Any
    re_lo: Any
    im_hi: Any = None
    im_lo: Any = None
    shape: tuple = ()

    @property
    def is_complex(self):
        return self.im_hi is not None


_register_pytree(
    DenseDDOp, ("re_hi", "re_lo", "im_hi", "im_lo"), ("shape",)
)


def dense_dd_from_numpy(A) -> DenseDDOp:
    A = np.asarray(A)
    re_h, re_l = dd_split_np(A.real.astype(np.float64))
    if np.iscomplexobj(A) and np.abs(A.imag).max() > 0:
        im_h, im_l = dd_split_np(A.imag.astype(np.float64))
    else:
        im_h = im_l = None
    return DenseDDOp(re_h, re_l, im_h, im_l, tuple(A.shape))


@dataclass(frozen=True)
class CDDOp:
    """A complex operator as a (real_part, imag_part) pair of real dd
    operators (each a :class:`~.df64_sparse.BSRdd`,
    …): ``(Ar + i·Ai)(xr + i·xi)``
    via four real dd applies.  ``im`` may be ``None`` for real
    operators (the optomech/transmon family)."""

    re: Any
    im: Any = None
    shape: tuple = ()


_register_pytree(CDDOp, ("re", "im"), ("shape",))


def cdd_op_from_matrix(A, *, sparse: Optional[bool] = None,
                       block_size: Optional[int] = None):
    """Build the best dd operator for a host matrix: dense planes for
    small systems, blocked-ELL (BSRdd) pairs for sparse ones."""
    import scipy.sparse as sp

    if sparse is None:
        sparse = sp.issparse(A) and min(A.shape) > 256
    if not sparse:
        Ad = A.toarray() if sp.issparse(A) else np.asarray(A)
        return dense_dd_from_numpy(Ad)
    from .df64_sparse import bsr_dd_from_scipy

    A = sp.csr_matrix(A)
    re = bsr_dd_from_scipy(sp.csr_matrix(A.real), block_size=block_size)
    im = None
    has_imag = (
        A.nnz > 0
        and np.iscomplexobj(A.data)
        and np.abs(A.data.imag).max() > 0
    )
    if has_imag:
        im = bsr_dd_from_scipy(
            sp.csr_matrix(A.imag), block_size=block_size
        )
    return CDDOp(re, im, tuple(A.shape))


@dataclass(frozen=True)
class TermsDDOp:
    """``Ĥ₀ + Σₗ cₗĤₗ`` as dd term operators + dd coefficient planes —
    the dd analogue of the coeffs-as-data ``Operator``
    (``src/generators.jl:111-125``): per-interval control updates touch
    only ``coeffs4`` (a traced ``(4, n_amp)`` array), never the term
    data, so the PWC Krylov propagators hit one compiled executable per
    ``(m, dt)`` across every step and every OC iteration.

    ``terms``: tuple of dd operators (leading ``len(terms) − n_amp``
    are drift, coefficient 1); ``coeffs4``: dd-split complex
    coefficients ``(re_hi, re_lo, im_hi, im_lo) × n_amp``."""

    terms: Any
    coeffs4: Any
    shape: tuple = ()


_register_pytree(TermsDDOp, ("terms", "coeffs4"), ("shape",))


def _apply_real_dd(op, x: DD) -> DD:
    """Dispatch a REAL dd operator apply."""
    from .df64_sparse import BSRdd, bsr_apply_dd

    if isinstance(op, BSRdd):
        return bsr_apply_dd(op, x)
    raise TypeError(f"not a real dd operator: {type(op)}")


def apply_cdd_op(op, v: CDD) -> CDD:
    """``op @ v`` in df64 for any dd operator container."""
    if isinstance(op, TermsDDOp):
        from .df64 import cdd_scale

        n_amp = op.coeffs4.shape[1]
        n_drift = len(op.terms) - n_amp
        out = None
        for i, t in enumerate(op.terms):
            y = apply_cdd_op(t, v)
            if i >= n_drift:
                j = i - n_drift
                c = CDD(
                    DD(op.coeffs4[0, j], op.coeffs4[1, j]),
                    DD(op.coeffs4[2, j], op.coeffs4[3, j]),
                )
                y = cdd_scale(y, c)
            out = y if out is None else cdd_add(out, y)
        return out
    if isinstance(op, DenseDDOp):
        rr = _dense_real_matvec_dd(op.re_hi, op.re_lo, v.re)
        ri = _dense_real_matvec_dd(op.re_hi, op.re_lo, v.im)
        if not op.is_complex:
            return CDD(rr, ri)
        ir = _dense_real_matvec_dd(op.im_hi, op.im_lo, v.re)
        ii = _dense_real_matvec_dd(op.im_hi, op.im_lo, v.im)
        return CDD(dd_sub(rr, ii), dd_add(ri, ir))
    if isinstance(op, CDDOp):
        rr = _apply_real_dd(op.re, v.re)
        ri = _apply_real_dd(op.re, v.im)
        if op.im is None:
            return CDD(rr, ri)
        ir = _apply_real_dd(op.im, v.re)
        ii = _apply_real_dd(op.im, v.im)
        return CDD(dd_sub(rr, ii), dd_add(ri, ir))
    if callable(op):
        return op(v)
    return _apply_real_dd(op, v)  # bare real dd operator


# ---------------------------------------------------------------------------
# dd Arnoldi (CGS2)
# ---------------------------------------------------------------------------


def _where_dd(cond, a: DD, b: DD) -> DD:
    return DD(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))


def _where_cdd(cond, a: CDD, b: CDD) -> CDD:
    return CDD(_where_dd(cond, a.re, b.re), _where_dd(cond, a.im, b.im))


def _cdd_zeros(shape):
    z = jnp.zeros(shape, jnp.float32)
    return CDD(DD(z, z), DD(z, z))


def _basis_dots_dd(q: CDD, w: CDD, mask, axis_name=None) -> CDD:
    """``projᵢ = ⟨qᵢ|w⟩`` for all basis rows at once: dd products of
    the ``(m+1, N)`` planes against the broadcast ``(N,)`` state, one
    compensated tree per component — the CGS2 batched reduction that
    replaces the reference's j sequential MGS dots
    (``src/arnoldi.jl:84-87``)."""

    def row(x: DD) -> DD:
        return DD(x.hi[None, :], x.lo[None, :])

    rr = dd_sum(dd_mul(q.re, row(w.re)), axis_name=axis_name)
    ii = dd_sum(dd_mul(q.im, row(w.im)), axis_name=axis_name)
    ri = dd_sum(dd_mul(q.re, row(w.im)), axis_name=axis_name)
    ir = dd_sum(dd_mul(q.im, row(w.re)), axis_name=axis_name)
    re = dd_add(rr, ii)
    im = dd_sub(ri, ir)
    mask = mask.astype(jnp.float32)
    return CDD(
        DD(re.hi * mask, re.lo * mask), DD(im.hi * mask, im.lo * mask)
    )


def _project_out_dd(q: CDD, proj: CDD, w: CDD) -> CDD:
    """``w − Σᵢ projᵢ qᵢ`` in dd (proj masked upstream)."""
    delta = cdd_combine(q, proj)
    return CDD(dd_sub(w.re, delta.re), dd_sub(w.im, delta.im))


@partial(jax.jit, static_argnames=("m", "dt", "norm_min", "axis_name"))
def _arnoldi_dd_impl(op, psi, m: int, dt, norm_min, axis_name=None):
    N = psi.re.hi.shape[-1]
    q = _cdd_zeros((m + 1, N))

    def set_row(basis: CDD, j, v: CDD) -> CDD:
        return CDD(
            DD(basis.re.hi.at[j].set(v.re.hi),
               basis.re.lo.at[j].set(v.re.lo)),
            DD(basis.im.hi.at[j].set(v.im.hi),
               basis.im.lo.at[j].set(v.im.lo)),
        )

    q = set_row(q, 0, psi)
    hz = jnp.zeros((m + 1, m + 1), jnp.float32)
    Hess = CDD(DD(hz, hz), DD(hz, hz))
    dt_dd = DD(
        jnp.asarray(np.float32(dt)),
        jnp.asarray(np.float32(np.float64(dt) - np.float32(dt))),
    )

    def get_row(basis: CDD, j) -> CDD:
        return CDD(
            DD(basis.re.hi[j], basis.re.lo[j]),
            DD(basis.im.hi[j], basis.im.lo[j]),
        )

    def body(j, state):
        q, Hess, m_eff, done = state
        w = apply_cdd_op(op, get_row(q, j))
        mask = jnp.arange(m + 1) <= j
        hcol = _cdd_zeros((m + 1,))
        for _ in range(2):  # CGS2
            proj = _basis_dots_dd(q, w, mask, axis_name)
            w = _project_out_dd(q, proj, w)
            hcol = cdd_add(hcol, proj)
        h = dd_sqrt(cdd_norm_sq(w, axis_name=axis_name))
        breakdown = h.hi < norm_min
        one = DD(jnp.float32(1.0), jnp.float32(0.0))
        inv = dd_div(one, _where_dd(h.hi > 0, h, one))
        w_normed = CDD(dd_mul(w.re, inv), dd_mul(w.im, inv))
        # column j of Hess: dt·hcol plus subdiagonal dt·h
        col = CDD(dd_mul(hcol.re, dt_dd), dd_mul(hcol.im, dt_dd))
        sub = dd_mul(h, dt_dd)
        col = CDD(
            DD(col.re.hi.at[j + 1].set(sub.hi),
               col.re.lo.at[j + 1].set(sub.lo)),
            col.im,
        )

        def set_col(H: CDD, j, c: CDD) -> CDD:
            return CDD(
                DD(H.re.hi.at[:, j].set(c.re.hi),
                   H.re.lo.at[:, j].set(c.re.lo)),
                DD(H.im.hi.at[:, j].set(c.im.hi),
                   H.im.lo.at[:, j].set(c.im.lo)),
            )

        Hess = jax.tree.map(
            lambda new, old: jnp.where(done, old, new),
            set_col(Hess, j, col), Hess,
        )
        q_new = set_row(q, j + 1, w_normed)
        q = jax.tree.map(
            lambda new, old: jnp.where(done | breakdown, old, new),
            q_new, q,
        )
        m_eff = jnp.where(done, m_eff, jnp.where(breakdown, j + 1, m))
        done = done | breakdown
        return (q, Hess, m_eff, done)

    state = (q, Hess, jnp.asarray(m, jnp.int32), jnp.asarray(False))
    q, Hess, m_eff, done = jax.lax.fori_loop(0, m, body, state)
    return Hess, q, m_eff


def arnoldi_dd(op, psi: CDD, m: int, dt: float = 1.0, *,
               norm_min: float = 1e-12, axis_name: Optional[str] = None):
    """(Extended) Arnoldi factorization of ``H·dt`` in df64.

    ``psi`` must be dd-normalized.  Returns ``(Hess, q, m_eff)`` with
    ``Hess`` an ``(m+1, m+1)`` **host complex128** Hessenberg (the
    downstream Leja/eig bookkeeping is host-side anyway), ``q`` the
    ``(m+1, N)``-planed CDD Krylov basis on device, ``m_eff ≤ m``.

    With ``axis_name`` the function is being traced inside
    ``shard_map``: pass a shard-local ``op``/``psi`` and the dots
    gather dd partials across the mesh (returns the traced Hess planes
    instead of a host array)."""
    if callable(op) and not isinstance(op, (DenseDDOp, CDDOp)):
        # jax's Partial is a pytree: callables cross the jit boundary.
        # CAVEAT: the jit cache keys on the callable's identity — pass
        # a module-level function (or a dd operator container) from
        # hot loops; a fresh lambda per call retraces every call.
        op = jax.tree_util.Partial(op)
    if axis_name is not None:
        return _arnoldi_dd_impl(
            op, psi, int(m), float(dt), float(norm_min), axis_name
        )
    Hess, q, m_eff = _arnoldi_dd_impl(op, psi, int(m), float(dt),
                                      float(norm_min))
    H = (
        np.asarray(Hess.re.hi, np.float64) + np.asarray(Hess.re.lo,
                                                        np.float64)
    ) + 1j * (
        np.asarray(Hess.im.hi, np.float64) + np.asarray(Hess.im.lo,
                                                        np.float64)
    )
    return H, q, int(m_eff)
