"""Operator containers and the ``apply`` protocol.

The reference's kernels are generic over any operator type implementing a
BLAS-like duck interface (``mul!``/``axpy!``/``dot``; see reference
``src/cheby.jl:146-148``, ``src/arnoldi.jl:48-52``).  The
equivalent: operators are *pytrees* with a functional
``apply(op, psi) -> psi'`` contract, so they flow through ``jit`` /
``lax.scan`` / ``shard_map`` as ordinary arguments.  Static structure
(shapes, term count) lives in pytree aux data; numerical content (matrix
entries, sparse values, coefficients) are leaves.  Updating coefficients
therefore never triggers retracing or operator reassembly — the analogue
of the reference's coeffs-only ``evaluate!`` fast path
(``src/generators.jl:744-766``).

Operator types:

- plain ``jax.numpy`` / ``numpy`` 2D arrays (dense; XLA ``dot_general``)
- :class:`DiagonalOperator` — elementwise multiply
- :class:`CSROperator` — gather + segment-sum SpMV (sorted rows)
- :class:`StackedCSROperator` — several terms sharing one sparsity
  pattern; a coefficient contraction fuses all terms into ONE SpMV
- :class:`Operator` (in :mod:`..models.generators`) — lazy sum Σ cₗ Ĥₗ

States are arrays with the Hilbert dimension on the *last* axis; leading
axes are batch dimensions (the data-parallel axis).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# float32 contractions at full precision: GPUs otherwise may run
# them in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "DiagonalOperator",
    "CSROperator",
    "StackedCSROperator",
    "DIAOperator",
    "dia_from_scipy",
    "BSROperator",
    "bsr_from_scipy",
    "bsr_from_dense",
    "choose_block_size",
    "apply",
    "op_dot",
    "to_dense",
    "to_scipy_sparse",
    "op_shape",
    "csr_from_scipy",
    "csr_from_dense",
    "add_operators",
    "scale_operator",
    "is_operator",
]


def _register_pytree(cls, data_fields, meta_fields):
    """Register a dataclass as a JAX pytree with static metadata."""

    def flatten(obj):
        children = tuple(getattr(obj, f) for f in data_fields)
        aux = tuple(getattr(obj, f) for f in meta_fields)
        return children, aux

    def unflatten(aux, children):
        kwargs = dict(zip(data_fields, children))
        kwargs.update(dict(zip(meta_fields, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)


@dataclass(frozen=True)
class DiagonalOperator:
    """A diagonal operator; ``apply`` is an elementwise product."""

    diag: Any  # (N,) array

    @property
    def shape(self):
        return (self.diag.shape[-1], self.diag.shape[-1])

    def apply(self, psi):
        return self.diag * psi

    def to_dense(self):
        return jnp.diag(jnp.asarray(self.diag))


_register_pytree(DiagonalOperator, ("diag",), ())


@dataclass(frozen=True)
class CSROperator:
    """Sparse operator in CSR layout with explicit per-entry row ids.

    ``data[k]`` is the entry at ``(row[k], col[k])``, sorted by row
    (CSR order).  ``apply`` is the gather/segment-sum
    SpMV; ``indptr`` is carried for host-side conversions and the native
    assembly path.  The sparsity layout (``row``/``col``/``indptr``) is
    immutable; time dependence enters only through coefficients at the
    :class:`~quantumpropagators.models.generators.Operator` level.
    """

    data: Any  # (nnz,)
    col: Any  # (nnz,) int32
    row: Any  # (nnz,) int32
    indptr: Any  # (N+1,) int32
    shape: tuple = ()

    @property
    def nnz(self):
        return self.col.shape[-1]

    def apply(self, psi):
        n_rows = self.shape[0]

        def matvec(v):
            prod = self.data * v[self.col]
            return jax.ops.segment_sum(
                prod, self.row, num_segments=n_rows, indices_are_sorted=True
            )

        if psi.ndim == 1:
            return matvec(psi)
        # batched: flatten leading dims, vmap over them
        lead = psi.shape[:-1]
        flat = psi.reshape((-1, psi.shape[-1]))
        out = jax.vmap(matvec)(flat)
        return out.reshape(lead + (n_rows,))

    def to_dense(self):
        A = jnp.zeros(self.shape, dtype=jnp.result_type(self.data.dtype))
        return A.at[self.row, self.col].add(self.data)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (np.asarray(self.data), np.asarray(self.col), np.asarray(self.indptr)),
            shape=self.shape,
        )


_register_pytree(CSROperator, ("data", "col", "row", "indptr"), ("shape",))


@dataclass(frozen=True)
class StackedCSROperator:
    """``n_terms`` sparse operators sharing one sparsity pattern.

    ``data`` has shape ``(n_terms, nnz)``.  Applying with a coefficient
    vector contracts the coefficients into a single data vector first,
    so the whole time-dependent Hamiltonian costs ONE SpMV per matvec —
    the fused design from SURVEY §7.1 replacing the reference's per-term
    ``mul!`` loop (``src/generators.jl:634-645``).
    """

    data: Any  # (n_terms, nnz)
    col: Any
    row: Any
    indptr: Any
    shape: tuple = ()

    @property
    def n_terms(self):
        return self.data.shape[0]

    def combine(self, coeffs):
        """Contract term coefficients: returns a :class:`CSROperator`."""
        coeffs = jnp.asarray(coeffs, dtype=jnp.result_type(self.data, coeffs))
        merged = jnp.tensordot(coeffs, self.data, axes=(0, 0))
        return CSROperator(merged, self.col, self.row, self.indptr, self.shape)

    def apply(self, psi, coeffs=None):
        if coeffs is None:
            coeffs = jnp.ones((self.n_terms,), dtype=self.data.dtype)
        return self.combine(coeffs).apply(psi)

    def to_dense(self, coeffs=None):
        if coeffs is None:
            coeffs = jnp.ones((self.n_terms,), dtype=self.data.dtype)
        return self.combine(coeffs).to_dense()


_register_pytree(StackedCSROperator, ("data", "col", "row", "indptr"), ("shape",))


@dataclass(frozen=True)
class DIAOperator:
    """Sparse operator in DIAgonal storage: ``data[k]`` holds the
    diagonal at ``offsets[k]`` (``A[i, i+off]``, row-aligned).

    The layout for banded / kron-structured matrices
    (ladders, cavities, tight-binding): the matvec is a sum of
    *shifted elementwise multiplies* — contiguous slices, zero gathers,
    and XLA fuses all diagonals into a couple of vector passes.  This
    replaces the reference's CSC SpMV for banded systems.

    ``data`` has shape ``(n_diags, N)``; entry ``data[k, i]`` multiplies
    ``psi[i + offsets[k]]`` into row ``i`` (out-of-range tail entries
    must be zero, as produced by :func:`dia_from_scipy`).
    """

    data: Any  # (n_diags, N)
    offsets: tuple = ()  # static ints
    shape: tuple = ()

    def apply(self, psi):
        N = self.shape[0]
        out = None
        for k, off in enumerate(self.offsets):
            row = self.data[k]
            if off == 0:
                term = row * psi
            elif off > 0:
                # row i reads psi[i + off]: shift psi left, zero-pad tail
                shifted = jnp.concatenate(
                    [
                        psi[..., off:],
                        jnp.zeros(psi.shape[:-1] + (off,), dtype=psi.dtype),
                    ],
                    axis=-1,
                )
                term = row * shifted
            else:
                shifted = jnp.concatenate(
                    [
                        jnp.zeros(psi.shape[:-1] + (-off,), dtype=psi.dtype),
                        psi[..., :off],
                    ],
                    axis=-1,
                )
                term = row * shifted
            out = term if out is None else out + term
        if out is None:
            out = jnp.zeros_like(psi)
        return out

    def to_dense(self):
        N = self.shape[0]
        A = np.zeros(self.shape, dtype=np.complex128)
        data = np.asarray(self.data)
        for k, off in enumerate(self.offsets):
            for i in range(max(0, -off), min(N, N - off)):
                A[i, i + off] = data[k, i]
        return jnp.asarray(A)


_register_pytree(DIAOperator, ("data",), ("offsets", "shape"))


def dia_from_scipy(A, dtype=None) -> DIAOperator:
    """Build a :class:`DIAOperator` from any scipy sparse matrix
    (row-aligned diagonal storage; use for banded matrices — the
    number of stored diagonals should be small)."""
    import scipy.sparse as sp

    D = sp.dia_matrix(A)
    N = D.shape[0]
    if dtype is None:
        dtype = jnp.complex128 if D.dtype.kind == "c" else D.dtype
    offsets = tuple(int(o) for o in D.offsets)
    # scipy dia data is column-aligned: data[k, j] is A[j - off, j].
    # Re-align to rows: row_data[k, i] = A[i, i + off] = scipy[k, i + off]
    data = np.zeros((len(offsets), N), dtype=np.asarray(D.data).dtype)
    for k, off in enumerate(offsets):
        col_aligned = D.data[k]
        if off >= 0:
            data[k, : N - off] = col_aligned[off:N]
        else:
            data[k, -off:] = col_aligned[: N + off]
    return DIAOperator(
        data=jnp.asarray(data, dtype=dtype), offsets=offsets, shape=tuple(D.shape)
    )


@dataclass(frozen=True)
class BSROperator:
    """Block-sparse operator: dense ``(b, b)`` blocks in a padded
    blocked-ELL layout.

    A layout for *unstructured* sparse operators (optomech kron
    products, transmon ladders, Liouvillians): instead of ``nnz`` scalar
    gathers, each block-row gathers ``k`` *contiguous* length-``b``
    slices of the state and contracts a dense ``(b, k·b)`` tile with
    them — one batched ``dot_general``.  This is the BSR design from
    SURVEY §7.4.2; the reference relies on SparseArrays CSC
    (``src/cheby.jl:146-148`` generic ``mul!``).

    Layout: ``blocks[r, j]`` is the dense ``(b, b)`` block in block-row
    ``r`` at block-column ``cols[r, j]``; rows are padded to the maximum
    block-degree ``k`` with all-zero blocks pointing at block-column 0.
    ``N = R·b`` must be exact (build with :func:`bsr_from_scipy`, which
    zero-pads the matrix if needed).
    """

    blocks: Any  # (R, k, b, b)
    cols: Any  # (R, k) int32 block-column ids
    shape: tuple = ()  # (N, N) logical shape (pre-padding)
    block_size: int = 0  # static b

    @property
    def nnzb(self):
        return self.blocks.shape[0] * self.blocks.shape[1]

    @property
    def nnz(self):
        # dense-block entry count (the unit the Gnnz/s metric uses)
        return self.nnzb * self.block_size * self.block_size

    def apply(self, psi):
        b = self.block_size
        R = self.blocks.shape[0]
        n_pad = R * b
        N = self.shape[0]

        def matvec(v):
            if n_pad != N:
                v = jnp.concatenate(
                    [v, jnp.zeros((n_pad - N,), dtype=v.dtype)]
                )
            x = v.reshape(R, b)
            xg = x[self.cols]  # (R, k, b) contiguous block gathers
            # y[r, i] = sum_{j, l} blocks[r, j, i, l] * xg[r, j, l]
            y = jax.lax.dot_general(
                self.blocks,
                xg,
                dimension_numbers=(((1, 3), (1, 2)), ((0,), (0,))),
                preferred_element_type=jnp.result_type(
                    self.blocks.dtype, v.dtype
                ),
            )
            return y.reshape(n_pad)[:N]

        if psi.ndim == 1:
            return matvec(psi)
        lead = psi.shape[:-1]
        flat = psi.reshape((-1, psi.shape[-1]))
        out = jax.vmap(matvec)(flat)
        return out.reshape(lead + (N,))

    def to_scipy(self):
        import scipy.sparse as sp

        R, k, b, _ = self.blocks.shape
        blocks = np.asarray(self.blocks).reshape(R * k, b, b)
        cols = np.asarray(self.cols).reshape(-1)
        rows = np.repeat(np.arange(R, dtype=np.int64), k)
        keep = np.abs(blocks).max(axis=(1, 2)) > 0
        A = sp.bsr_matrix(
            (blocks[keep], cols[keep], np.concatenate([[0], np.cumsum(
                np.bincount(rows[keep], minlength=R))]).astype(np.int64)),
            shape=(R * b, R * b),
        ).tocsr()
        return A[: self.shape[0], : self.shape[1]].tocsr()

    def to_dense(self):
        return jnp.asarray(self.to_scipy().toarray())


_register_pytree(BSROperator, ("blocks", "cols"), ("shape", "block_size"))


def choose_block_size(N: int, max_b: int = 64) -> int:
    """Largest power-of-two divisor of ``N`` up to ``max_b`` (blocks
    should tile the matrix unit; 8–64 is the sweet spot)."""
    b = 1
    while b * 2 <= max_b and N % (b * 2) == 0:
        b *= 2
    return b


def bsr_from_scipy(A, block_size: int = None, dtype=None) -> BSROperator:
    """Build a :class:`BSROperator` from any scipy sparse matrix.

    The matrix is zero-padded up to a multiple of ``block_size`` when
    needed; block-rows are padded to the maximum block-degree with zero
    blocks (blocked-ELL).  For near-uniform sparsity (lattice kron
    operators, ladders) the padding overhead is negligible.
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    N, M = A.shape
    if N != M:
        raise ValueError("BSROperator requires a square matrix")
    if block_size is None:
        block_size = choose_block_size(N)
    b = int(block_size)
    n_pad = -(-N // b) * b
    if n_pad != N:
        A = sp.bmat(
            [[A, sp.csr_matrix((N, n_pad - N))],
             [sp.csr_matrix((n_pad - N, N)), sp.csr_matrix((n_pad - N, n_pad - N))]],
            format="csr",
        )
    B = A.tobsr(blocksize=(b, b))
    B.sort_indices()
    if dtype is None:
        dtype = jnp.complex128 if B.dtype.kind == "c" else B.dtype
    # canonicalize for the active backend: without this, f64 scipy input
    # on a non-x64 backend requests float64 from jnp.asarray and gets a
    # silent truncation WARNING (VERDICT r4 hygiene item)
    dtype = jax.dtypes.canonicalize_dtype(jnp.dtype(dtype))
    R = n_pad // b
    degrees = np.diff(B.indptr)
    k = max(1, int(degrees.max()))
    blocks = np.zeros((R, k, b, b), dtype=np.asarray(B.data).dtype)
    cols = np.zeros((R, k), dtype=np.int32)
    for r in range(R):
        lo, hi = B.indptr[r], B.indptr[r + 1]
        d = hi - lo
        blocks[r, :d] = B.data[lo:hi]
        cols[r, :d] = B.indices[lo:hi]
    return BSROperator(
        blocks=jnp.asarray(blocks, dtype=dtype),
        cols=jnp.asarray(cols),
        shape=(N, M),
        block_size=b,
    )


def bsr_from_dense(A, block_size: int = None, tol: float = 0.0) -> BSROperator:
    import scipy.sparse as sp

    A = np.asarray(A)
    if tol > 0:
        A = np.where(np.abs(A) > tol, A, 0)
    return bsr_from_scipy(sp.csr_matrix(A), block_size=block_size, dtype=A.dtype)


# --------------------------------------------------------------------------
# Generic functional interface
# --------------------------------------------------------------------------

def is_operator(obj) -> bool:
    """True if ``obj`` can act as a static operator on a state."""
    if isinstance(obj, (jnp.ndarray, np.ndarray)) and np.ndim(obj) == 2:
        return True
    return hasattr(obj, "apply") and hasattr(obj, "shape")


def apply(op, psi):
    """Apply a static operator to a state: ``psi' = op @ psi``.

    The single entry point every kernel (Chebyshev/Newton/Arnoldi) uses —
    the analogue of the reference's 3-arg ``mul!`` contract.  ``psi`` has
    the Hilbert dimension on its last axis.
    """
    if isinstance(op, (jnp.ndarray, np.ndarray)):
        if op.ndim != 2:
            raise ValueError(f"dense operator must be 2D, got shape {op.shape}")
        return jnp.einsum("ij,...j->...i", op, psi, precision=_HIGHEST)
    applier = getattr(op, "apply", None)
    if applier is not None:
        return applier(psi)
    raise TypeError(f"object of type {type(op)} does not implement `apply`")


def op_dot(x, op, y):
    """Expectation-style inner product ``⟨x| op |y⟩``.

    (analogue of the reference's 3-arg ``dot``,
    ``src/generators.jl:648-660``)
    """
    return jnp.vdot(x, apply(op, y))


def to_dense(op):
    """Materialize any operator as a dense ``jax.numpy`` matrix."""
    if isinstance(op, (jnp.ndarray, np.ndarray)):
        return jnp.asarray(op)
    fn = getattr(op, "to_dense", None)
    if fn is not None:
        return fn()
    raise TypeError(f"cannot densify operator of type {type(op)}")


def op_shape(op) -> tuple:
    if isinstance(op, (jnp.ndarray, np.ndarray)):
        return tuple(op.shape)
    return tuple(op.shape)


def to_scipy_sparse(op):
    """Convert any operator to a host ``scipy.sparse.csr_matrix``
    WITHOUT going through a dense ``(N, N)`` intermediate for sparse
    inputs.

    This is the assembly-side primitive that keeps Liouvillian
    construction sparse end-to-end (reference
    ``src/generators.jl:473-524`` keeps CSC sparsity through ``kron``);
    dense inputs are accepted for small systems only.
    """
    import scipy.sparse as sp

    if sp.issparse(op):
        return sp.csr_matrix(op)
    if isinstance(op, (CSROperator, BSROperator)):
        return op.to_scipy()
    if isinstance(op, DiagonalOperator):
        return sp.diags(np.asarray(op.diag)).tocsr()
    if isinstance(op, DIAOperator):
        N = op.shape[0]
        data = np.asarray(op.data)
        # row-aligned storage -> scipy dia_matrix wants column-aligned:
        # scipy's data[k, j] multiplies column j on diagonal off;
        # ours data[k, i] sits at (i, i+off).  Shift accordingly.
        mats = []
        for k, off in enumerate(op.offsets):
            d = data[k]
            if off >= 0:
                diag = d[: N - off] if off else d
            else:
                diag = d[-off:] if off else d
            mats.append(sp.diags(diag, off, shape=op.shape))
        return sum(mats[1:], mats[0].tocsr()) if mats else sp.csr_matrix(op.shape)
    if isinstance(op, StackedCSROperator):
        return sp.csr_matrix(
            (
                np.asarray(op.data).sum(axis=0),
                np.asarray(op.col),
                np.asarray(op.indptr),
            ),
            shape=op.shape,
        )
    if isinstance(op, (jnp.ndarray, np.ndarray)):
        return sp.csr_matrix(np.asarray(op))
    # last resort: ScaledOperator / unknown pytree operators
    scale = getattr(op, "coeff", None)
    inner = getattr(op, "operator", None)
    if scale is not None and inner is not None:
        return (complex(scale) * to_scipy_sparse(inner)).tocsr()
    return sp.csr_matrix(np.asarray(to_dense(op)))


# --------------------------------------------------------------------------
# Construction helpers (host-side)
# --------------------------------------------------------------------------

def csr_from_scipy(A, dtype=None) -> CSROperator:
    """Build a :class:`CSROperator` from any scipy sparse matrix."""
    A = A.tocsr()
    A.sum_duplicates()
    if dtype is None:
        dtype = jnp.complex128 if A.dtype.kind == "c" else A.dtype
    indptr = np.asarray(A.indptr, dtype=np.int32)
    row = np.repeat(
        np.arange(A.shape[0], dtype=np.int32), np.diff(indptr).astype(np.int64)
    )
    return CSROperator(
        data=jnp.asarray(A.data, dtype=dtype),
        col=jnp.asarray(A.indices, dtype=jnp.int32),
        row=jnp.asarray(row),
        indptr=jnp.asarray(indptr),
        shape=tuple(A.shape),
    )


def csr_from_dense(A, tol: float = 0.0) -> CSROperator:
    """Build a :class:`CSROperator` from a dense matrix, dropping entries
    with ``|a_ij| <= tol``."""
    import scipy.sparse as sp

    A = np.asarray(A)
    if tol > 0:
        A = np.where(np.abs(A) > tol, A, 0)
    return csr_from_scipy(sp.csr_matrix(A), dtype=A.dtype)


def add_operators(a, b):
    """Host-side structural sum of two static operators (used by the
    ``hamiltonian`` builder when merging terms with identical
    amplitudes; reference ``src/generators.jl:415-424``)."""
    if isinstance(a, (jnp.ndarray, np.ndarray)) and isinstance(
        b, (jnp.ndarray, np.ndarray)
    ):
        return jnp.asarray(a) + jnp.asarray(b)
    if isinstance(a, DiagonalOperator) and isinstance(b, DiagonalOperator):
        return DiagonalOperator(a.diag + b.diag)
    if isinstance(a, BSROperator) or isinstance(b, BSROperator):
        bs = a.block_size if isinstance(a, BSROperator) else b.block_size
        return bsr_from_scipy(
            to_scipy_sparse(a) + to_scipy_sparse(b), block_size=bs
        )
    if isinstance(a, CSROperator) or isinstance(b, CSROperator):
        return csr_from_scipy(to_scipy_sparse(a) + to_scipy_sparse(b))
    return to_dense(a) + to_dense(b)


def scale_operator(alpha, op):
    """Host-side structural scaling ``alpha * op``."""
    if isinstance(op, (jnp.ndarray, np.ndarray)):
        return alpha * jnp.asarray(op)
    if isinstance(op, DiagonalOperator):
        return DiagonalOperator(alpha * op.diag)
    if isinstance(op, CSROperator):
        return dataclasses.replace(op, data=alpha * op.data)
    if isinstance(op, BSROperator):
        return dataclasses.replace(op, blocks=alpha * op.blocks)
    if isinstance(op, DIAOperator):
        return dataclasses.replace(op, data=alpha * op.data)
    return alpha * to_dense(op)
