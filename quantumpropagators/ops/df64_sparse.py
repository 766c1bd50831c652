"""df64 block-sparse apply: reference accuracy for UNSTRUCTURED
operators without float64 arrays.

:mod:`.df64` covers diagonal-plus-site-flip structure; everything else — optomech kron
chains (reference ``test/optomech.jl:1-45``), transmon ladders,
Liouvillian superoperators — needs a double-float SpMV over a general
sparsity layout.  This module provides it on the blocked-ELL (BSR)
layout of :class:`~.operators.BSROperator`:

- products are Dekker two-products (error-free, no FMA needed) of the
  hi planes plus the hi·lo cross terms;
- the contraction over (block column, in-block index) is a **pairwise
  two_sum tree**: the value lane stays error-free through every level,
  the compensation lane accumulates with ~2⁻⁴⁸-relative rounding —
  df64 accuracy at O(nnz·log) f32 ops, vectorized by XLA (one fused
  elementwise chain, NOT one pass per dd op — the round-1 XLA-dd path's
  mistake).

Real-valued operator entries (the optomech/transmon family; a complex
state is two independent real applies).  Works on every backend
(barriered EFTs; ``validate_df64()`` checks the backend).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .df64 import (
    DD,
    CDD,
    _b,
    two_sum,
    _two_prod,
    cdd_add,
    cdd_scale,
    _cdd_real_scale,
    _dd_const,
    _split_f64,
)
from .operators import _register_pytree

__all__ = [
    "dd_split_np",
    "bsr_dd_from_scipy",
    "bsr_apply_dd",
    "bsr_blocks_apply_dd",
    "cheby_apply_dd_bsr",
    "cheby_dd_recurrence",
    "BSRdd",
]


def dd_split_np(x64):
    """Host f64 array → (hi, lo) f32 jnp pair."""
    x64 = np.asarray(x64, dtype=np.float64)
    hi = x64.astype(np.float32)
    return jnp.asarray(hi), jnp.asarray((x64 - hi.astype(np.float64)).astype(np.float32))


class BSRdd:
    """Double-float blocked-ELL operator: hi/lo block planes + cols."""

    def __init__(self, blocks_hi, blocks_lo, cols, shape):
        self.blocks_hi = blocks_hi
        self.blocks_lo = blocks_lo
        self.cols = cols
        self.shape = tuple(shape)

    @property
    def block_size(self):
        return self.blocks_hi.shape[-1]

    @property
    def nnz(self):
        R, k, b, _ = self.blocks_hi.shape
        return R * k * b * b


_register_pytree(BSRdd, ("blocks_hi", "blocks_lo", "cols"), ("shape",))


def bsr_dd_from_scipy(A, block_size: int = None) -> BSRdd:
    """Split a scipy sparse matrix (real f64 entries) into a df64
    blocked-ELL operator (same zero-padded layout as
    :func:`~.operators.bsr_from_scipy`), keeping full f64 precision
    across the (hi, lo) planes.

    The logical dimension is padded up to a multiple of the block size;
    states must be zero-padded to ``padded_dim`` (the zero rows/columns
    keep the tail exactly zero through any propagation)."""
    import scipy.sparse as sp

    from .operators import choose_block_size

    A = sp.csr_matrix(A)
    if np.iscomplexobj(A.data) and np.abs(A.data.imag).max() > 0:
        raise ValueError(
            "bsr_dd_from_scipy supports real operator entries; "
            "propagate complex generators via their real/imaginary "
            "parts or the Liouvillian embedding"
        )
    A = sp.csr_matrix(A.real.astype(np.float64))
    N = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("BSRdd requires a square matrix")
    b = int(block_size) if block_size else choose_block_size(N)
    n_pad = -(-N // b) * b
    if n_pad != N:
        A = sp.bmat(
            [[A, sp.csr_matrix((N, n_pad - N))],
             [sp.csr_matrix((n_pad - N, N)),
              sp.csr_matrix((n_pad - N, n_pad - N))]],
            format="csr",
        )
    B = A.tobsr(blocksize=(b, b))
    B.sort_indices()
    R = n_pad // b
    degrees = np.diff(B.indptr)
    k = max(1, int(degrees.max()))
    blocks = np.zeros((R, k, b, b), dtype=np.float64)
    cols = np.zeros((R, k), dtype=np.int32)
    for r in range(R):
        lo, hi = B.indptr[r], B.indptr[r + 1]
        d = hi - lo
        blocks[r, :d] = B.data[lo:hi]
        cols[r, :d] = B.indices[lo:hi]
    bh, bl = dd_split_np(blocks)
    return BSRdd(bh, bl, jnp.asarray(cols), (n_pad, n_pad))


def _tree_sum_dd(p, e, axis=-1):
    """Compensated pairwise reduction of unnormalized (p, e) pairs along
    ``axis``: value lane via error-free two_sum at every level."""
    p = jnp.moveaxis(p, axis, -1)
    e = jnp.moveaxis(e, axis, -1)
    while p.shape[-1] > 1:
        n = p.shape[-1]
        if n % 2:
            p = jnp.concatenate([p, jnp.zeros_like(p[..., :1])], axis=-1)
            e = jnp.concatenate([e, jnp.zeros_like(e[..., :1])], axis=-1)
        s, err = two_sum(p[..., ::2], p[..., 1::2])
        e = _b(e[..., ::2] + e[..., 1::2]) + err
        p = s
    return p[..., 0], e[..., 0]


def bsr_blocks_apply_dd(blocks_hi, blocks_lo, cols, xb_h, xb_l) -> DD:
    """Core df64 blocked-ELL SpMV: ``blocks (R,k,b,b) · x[cols]`` with
    error-free hi·hi products and a compensated pairwise reduction.
    ``xb_h/xb_l`` are the dd state planes PRE-reshaped to ``(Rx, b)``
    block rows (``Rx`` may exceed ``R`` — the sharded banded path
    passes halo-extended rows with extended-local ``cols``)."""
    R, k = cols.shape
    b = blocks_hi.shape[-1]
    xg_h = xb_h[cols]  # (R, k, b)
    xg_l = xb_l[cols]
    p, e = _two_prod(blocks_hi, xg_h[:, :, None, :])
    e = _b(e + _b(blocks_hi * xg_l[:, :, None, :])) + _b(
        blocks_lo * xg_h[:, :, None, :]
    )
    # contract over (k, b_in): (R, k, b_out, b_in) -> (R, b_out)
    p = jnp.swapaxes(p, 1, 2).reshape(R, b, k * b)
    e = jnp.swapaxes(e, 1, 2).reshape(R, b, k * b)
    ph, pe = _tree_sum_dd(p, e)
    hi, lo = two_sum(ph, pe)
    return DD(hi.reshape(-1), lo.reshape(-1))


@jax.jit
def bsr_apply_dd(op: BSRdd, x: DD) -> DD:
    """``y = A·x`` in df64 over the blocked-ELL layout (real A)."""
    b = op.block_size
    return bsr_blocks_apply_dd(
        op.blocks_hi, op.blocks_lo, op.cols,
        x.hi.reshape(-1, b), x.lo.reshape(-1, b),
    )


def _cdd_apply_real(op, z: CDD) -> CDD:
    return CDD(bsr_apply_dd(op, z.re), bsr_apply_dd(op, z.im))


def cheby_dd_recurrence(apply_cdd, psi: CDD, coeffs_hi, coeffs_lo,
                        delta, e_min, dt, forward) -> CDD:
    """The df64 Chebyshev recurrence over an arbitrary CDD→CDD real
    matvec ``apply_cdd`` — shared between the single-device BSR path
    and the sharded banded-halo path (which calls it from inside
    ``shard_map``: the recurrence itself is elementwise/local, only
    the matvec communicates)."""
    beta = _dd_const(float(delta) / 2.0 + float(e_min))
    s_val = (-2.0 if forward else 2.0) / float(delta)

    def h_norm(v: CDD, scale: float) -> CDD:
        hv = apply_cdd(v)
        from .df64 import dd_mul, dd_neg, dd_sub

        w = CDD(
            dd_sub(hv.re, dd_mul(v.re, beta)),
            dd_sub(hv.im, dd_mul(v.im, beta)),
        )
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

    (_, _, phi), _ = jax.lax.scan(
        body, (v0, v1, phi), (coeffs_hi[2:], coeffs_lo[2:])
    )
    ph = np.exp(-1j * (float(delta) / 2.0 + float(e_min)) * float(dt))
    return _phase_scale(phi, ph)


def _phase_scale(phi: CDD, ph: complex) -> CDD:
    """Multiply a CDD state by the host-computed global phase.

    With x64 available the product runs in exact f64 (merge →
    multiply → resplit): XLA *CPU* constant-folds the dd product's
    error-free transformations when the phase is an in-graph constant
    (measured 1.2e-7 relative — a latent bug masked for four rounds
    because every kernel test used ``e_min = −bound`` ⇒ β = 0 ⇒
    phase ≡ 1).  Without x64 the dd product stands."""
    if jax.config.jax_enable_x64:
        zr = phi.re.hi.astype(jnp.float64) + phi.re.lo
        zi = phi.im.hi.astype(jnp.float64) + phi.im.lo
        wr = zr * np.float64(ph.real) - zi * np.float64(ph.imag)
        wi = zr * np.float64(ph.imag) + zi * np.float64(ph.real)
        rh = wr.astype(jnp.float32)
        ih = wi.astype(jnp.float32)
        return CDD(
            DD(rh, (wr - rh.astype(jnp.float64)).astype(jnp.float32)),
            DD(ih, (wi - ih.astype(jnp.float64)).astype(jnp.float32)),
        )
    phase = CDD(
        DD(*(jnp.float32(v) for v in _split_f64(ph.real))),
        DD(*(jnp.float32(v) for v in _split_f64(ph.imag))),
    )
    return cdd_scale(phi, phase)


@partial(
    jax.jit,
    static_argnames=("shape_n", "delta", "e_min", "dt", "forward"),
)
def _cheby_dd_bsr_impl(bh, bl, cols, shape_n, psi, coeffs_hi, coeffs_lo,
                       delta, e_min, dt, forward):
    op = BSRdd(bh, bl, cols, (shape_n, shape_n))
    return cheby_dd_recurrence(
        lambda v: _cdd_apply_real(op, v), psi, coeffs_hi, coeffs_lo,
        delta, e_min, dt, forward,
    )


def cheby_apply_dd_bsr(op: BSRdd, psi: CDD, coeffs, delta, e_min, dt) -> CDD:
    """``exp(-i H dt)|psi⟩`` in df64 over a general (real) BSR operator
    — the reference-accuracy on-chip path for unstructured Hamiltonians
    (optomech ``test/optomech.jl``, transmon ladders; BASELINE configs
    2–3).  ``coeffs`` are host f64 Chebyshev coefficients."""
    coeffs = np.asarray(coeffs, dtype=np.float64)
    c_hi = coeffs.astype(np.float32)
    c_lo = (coeffs - c_hi.astype(np.float64)).astype(np.float32)
    return _cheby_dd_bsr_impl(
        op.blocks_hi, op.blocks_lo, op.cols, int(op.shape[0]),
        psi, jnp.asarray(c_hi), jnp.asarray(c_lo),
        float(delta), float(e_min), float(dt), dt > 0,
    )
