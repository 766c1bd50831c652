"""Structured lattice/spin-chain operators — the fast path.

The reference reaches large Hilbert spaces through generic sparse
matrices (SuiteSparse CSC SpMV).  A gather-based generic SpMV is
memory-bound and irregular; but the Hamiltonians that *have* 2^20+
dimensions are tensor-product structured (spin chains, lattices,
kron-built cavity systems — cf. reference ``test/optomech.jl``), and
their matvec is better expressed as bit-indexed tensor operations that
XLA fuses into a handful of dense passes over the state:

- Pauli-Z strings are *diagonal*: the entire ZZ+Z part of a spin-chain
  Hamiltonian collapses into ONE precomputed diagonal vector —
  one fused elementwise multiply regardless of the number of terms.
- A single-site operator ``Mᵢ`` is a 2×2 matmul over axis ``i`` of the
  state viewed as ``(2^i, 2, 2^(L-1-i))`` — a reshape + tiny einsum,
  no index gathers at all.

``apply`` for a transverse-field Ising chain at 2^20 is therefore
``L+1`` fused vector passes instead of a 22M-entry gather — and under
sharding, site operators on the high (device) bits become pure
``ppermute`` block exchanges (see
:mod:`quantumpropagators.parallel.sharded_chain`).

Operators here implement the same ``apply`` protocol as every other
operator type, so they compose with the :class:`...generators.Operator`
coefficient algebra and all propagators unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import default_complex_dtype
from ..ops.operators import DiagonalOperator, _register_pytree

# float32 contractions at full precision: GPUs otherwise may run
# them in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "SiteOperatorSum",
    "GroupedSiteSum",
    "zz_chain_diagonal",
    "z_chain_diagonal",
    "zz_bonds_diagonal",
    "transverse_field_ising",
    "transverse_field_ising_2d",
    "PAULI",
]

PAULI = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}


def _group_dims(L: int, group_bits: int = 10) -> tuple:
    """Split an ``L``-bit chain into contiguous groups of ≤ ``group_bits``
    bits, as evenly as possible, so no einsum axis is pathologically
    small whenever ``L`` allows."""
    if L <= group_bits:
        return (L,)
    d = -(-L // group_bits)  # ceil
    base, rem = divmod(L, d)
    return tuple([base + 1] * rem + [base] * (d - rem))


@dataclass(frozen=True)
class SiteOperatorSum:
    """``Σᵢ cᵢ · (𝟙 ⊗ … ⊗ Mᵢ ⊗ … ⊗ 𝟙)`` over an ``L``-site qubit chain.

    ``site_mats`` has shape ``(L, 2, 2)`` (per-site operator, already
    scaled by any per-site coefficient); sites with an all-zero matrix
    are skipped at trace time if ``active`` marks them inactive.
    Site 0 is the MOST significant bit of the state index
    (``kron(M_0, M_1, ...)`` convention).

    ``apply`` MATRICIZES: contiguous groups of ~``group_bits`` sites are
    summed (in-graph, loop-invariant → hoisted by XLA out of scans)
    into dense ``(2^k, 2^k)`` group operators, and the state is
    contracted group-by-group — ``d ≈ L/10`` dense matmuls instead of
    ``L`` per-site passes with degenerate axis sizes.  Cost:
    ``d · N · 2^group_bits`` FLOPs per matvec.
    """

    site_mats: Any  # (L, 2, 2)
    L: int = 0
    active: tuple = ()  # static tuple of bools; () means all active
    group_bits: int = 10

    @property
    def shape(self):
        return (2 ** self.L, 2 ** self.L)

    def _group_operator(self, start: int, nbits: int, dtype):
        """Dense ``(2^nbits, 2^nbits)`` sum of this group's site terms."""
        active = self.active if self.active else (True,) * self.L
        A = None
        for i_loc in range(nbits):
            i = start + i_loc
            if not active[i]:
                continue
            M = self.site_mats[i].astype(dtype)
            term = M
            if i_loc > 0:
                term = jnp.kron(jnp.eye(2 ** i_loc, dtype=dtype), term)
            if nbits - 1 - i_loc > 0:
                term = jnp.kron(
                    term, jnp.eye(2 ** (nbits - 1 - i_loc), dtype=dtype)
                )
            A = term if A is None else A + term
        return A

    def apply(self, psi):
        L = self.L
        N = 2 ** L
        lead = psi.shape[:-1]
        out = None
        start = 0
        for nbits in _group_dims(L, self.group_bits):
            A = self._group_operator(start, nbits, psi.dtype)
            if A is not None:
                pre = 2 ** start
                F = 2 ** nbits
                post = N // (pre * F)
                resh = psi.reshape(lead + (pre, F, post))
                term = jnp.einsum(
                    "ab,...xbz->...xaz", A, resh, precision=_HIGHEST
                )
                term = term.reshape(lead + (N,))
                out = term if out is None else out + term
            start += nbits
        if out is None:
            out = jnp.zeros_like(psi, shape=lead + (N,))
        return out

    def to_dense(self):
        L = self.L
        mats = np.asarray(self.site_mats)
        active = self.active if self.active else (True,) * L
        H = np.zeros((2 ** L, 2 ** L), dtype=np.complex128)
        for i in range(L):
            if not active[i]:
                continue
            term = np.array([[1.0]], dtype=np.complex128)
            for j in range(L):
                term = np.kron(term, mats[i] if j == i else np.eye(2))
            H += term
        return jnp.asarray(H)


_register_pytree(SiteOperatorSum, ("site_mats",), ("L", "active", "group_bits"))


@dataclass(frozen=True)
class GroupedSiteSum:
    """Matricized sum of single-site terms: per contiguous site group
    ``g``, a PRECOMPUTED dense ``(F_g, F_g)`` operator
    ``A_g = Σ_{i∈g} 𝟙⊗Mᵢ⊗𝟙``, applied as one dense matmul over that
    axis of the state.

    The production-speed form of :class:`SiteOperatorSum`: group
    operators are built once on the host (``SiteOperatorSum.grouped()``)
    so a scanned propagation pays ``d = len(dims)`` matmuls per matvec
    and nothing else (XLA does not always hoist in-graph kron chains out
    of ``lax.scan``).  Real-valued
    group operators applied to complex states contract the real and
    imaginary planes separately (two real matmuls instead of one
    complex one).
    """

    group_mats: tuple  # one (F_g, F_g) array per group
    dims: tuple = ()  # static (F_0, ..., F_{d-1}); prod = N

    @property
    def shape(self):
        N = int(np.prod(self.dims))
        return (N, N)

    def apply(self, psi):
        N = int(np.prod(self.dims))
        lead = psi.shape[:-1]
        out = None
        pre = 1
        for g, A in enumerate(self.group_mats):
            F = self.dims[g]
            post = N // (pre * F)
            resh = psi.reshape(lead + (pre, F, post))
            if A.dtype.kind == "f" and psi.dtype.kind == "c":
                tr = jnp.einsum(
                    "ab,...xbz->...xaz", A, jnp.real(resh), precision=_HIGHEST
                )
                ti = jnp.einsum(
                    "ab,...xbz->...xaz", A, jnp.imag(resh), precision=_HIGHEST
                )
                term = jax.lax.complex(tr, ti)
            else:
                term = jnp.einsum(
                    "ab,...xbz->...xaz", A.astype(psi.dtype), resh,
                    precision=_HIGHEST,
                )
            term = term.reshape(lead + (N,))
            out = term if out is None else out + term
            pre *= F
        if out is None:
            out = jnp.zeros_like(psi, shape=lead + (N,))
        return out

    def to_dense(self):
        N = int(np.prod(self.dims))
        H = np.zeros((N, N), dtype=np.complex128)
        pre = 1
        for g, A in enumerate(self.group_mats):
            F = self.dims[g]
            post = N // (pre * F)
            H += np.kron(
                np.kron(np.eye(pre), np.asarray(A, dtype=np.complex128)),
                np.eye(post),
            )
            pre *= F
        return jnp.asarray(H)


def _grouped_flatten(o):
    return (o.group_mats,), (o.dims,)


def _grouped_unflatten(aux, children):
    return GroupedSiteSum(group_mats=tuple(children[0]), dims=aux[0])


jax.tree_util.register_pytree_node(
    GroupedSiteSum, _grouped_flatten, _grouped_unflatten
)


def _site_sum_grouped(self: "SiteOperatorSum", group_bits: int = None):
    """Host-side conversion to :class:`GroupedSiteSum` (precomputed
    group operators)."""
    if group_bits is None:
        group_bits = self.group_bits
    L = self.L
    active = self.active if self.active else (True,) * L
    mats = np.asarray(self.site_mats)
    dtype = mats.dtype
    group_mats = []
    dims = []
    start = 0
    for nbits in _group_dims(L, group_bits):
        F = 2 ** nbits
        A = np.zeros((F, F), dtype=dtype)
        for i_loc in range(nbits):
            i = start + i_loc
            if not active[i]:
                continue
            term = np.kron(
                np.kron(np.eye(2 ** i_loc, dtype=dtype), mats[i]),
                np.eye(2 ** (nbits - 1 - i_loc), dtype=dtype),
            )
            A += term
        group_mats.append(jnp.asarray(A))
        dims.append(F)
        start += nbits
    return GroupedSiteSum(group_mats=tuple(group_mats), dims=tuple(dims))


SiteOperatorSum.grouped = _site_sum_grouped


def _spin(L: int, site: int, dtype=jnp.float32):
    """±1 value of ``σᶻ`` at ``site`` on each of the 2^L basis states
    (site 0 = most significant bit)."""
    idx = jnp.arange(2 ** L, dtype=jnp.uint32)
    bit = (idx >> np.uint32(L - 1 - site)) & 1
    return (1.0 - 2.0 * bit).astype(dtype)


def zz_chain_diagonal(L: int, J=1.0, *, periodic: bool = False, dtype=jnp.float32):
    """Diagonal of ``J Σᵢ σᶻᵢ σᶻᵢ₊₁`` as a length-2^L vector.

    ``J`` may be a scalar or a per-bond array of length ``L-1``
    (``L`` if periodic).  Built site-by-site: O(2^L) peak memory even
    at 2^24."""
    bonds = [(i, i + 1) for i in range(L - 1)]
    if periodic:
        bonds.append((L - 1, 0))
    return zz_bonds_diagonal(L, bonds, J, dtype=dtype)


def z_chain_diagonal(L: int, h=1.0, *, dtype=jnp.float32):
    """Diagonal of ``Σᵢ hᵢ σᶻᵢ`` as a length-2^L vector."""
    h = np.broadcast_to(np.asarray(h, dtype=np.float64), (L,))
    diag = jnp.zeros(2 ** L, dtype=dtype)
    for i in range(L):
        diag = diag + jnp.asarray(h[i], dtype=dtype) * _spin(L, i, dtype)
    return diag


def zz_bonds_diagonal(L: int, bonds, J=1.0, *, dtype=jnp.float32):
    """Diagonal of ``Σ_b J_b σᶻ_{i_b} σᶻ_{j_b}`` for an arbitrary bond
    list (any lattice/graph geometry) as a length-2^L vector.

    Memory-lean: works bond-by-bond on sign vectors, never forming the
    ``(L, 2^L)`` spin table."""
    J = np.broadcast_to(np.asarray(J, dtype=np.float64), (len(bonds),))
    diag = jnp.zeros(2 ** L, dtype=dtype)
    for (i, j), Jb in zip(bonds, J):
        diag = diag + jnp.asarray(Jb, dtype=dtype) * _spin(L, i, dtype) * _spin(
            L, j, dtype
        )
    return diag


def ising_diagonal_np(L: int, bonds, J=1.0, h=0.0) -> np.ndarray:
    """Host-side float64 diagonal ``Σ_b J_b σᶻᵢσᶻⱼ + Σᵢ hᵢ σᶻᵢ``.

    The df64 kernels (:mod:`...ops.df64`) need the diagonal at full f64
    precision *before* the hi/lo split; building it through jax with
    x64 off would quantize it.
    Site ``i`` is the MSB-first position, matching the jnp builders.
    """
    J = np.broadcast_to(np.asarray(J, dtype=np.float64), (len(bonds),))
    h = np.broadcast_to(np.asarray(h, dtype=np.float64), (L,))
    idx = np.arange(2 ** L)
    diag = np.zeros(2 ** L, dtype=np.float64)
    spin = lambda i: 1.0 - 2.0 * ((idx >> (L - 1 - i)) & 1)
    for (i, j), Jb in zip(bonds, J):
        diag += Jb * spin(i) * spin(j)
    for i in range(L):
        if h[i] != 0.0:
            diag += h[i] * spin(i)
    return diag


def chain_bonds(L: int, periodic: bool = False):
    """Nearest-neighbor bond list of a 1D chain."""
    bonds = [(i, i + 1) for i in range(L - 1)]
    if periodic and L > 2:
        bonds.append((L - 1, 0))
    return bonds


def lattice2d_bonds(Lx: int, Ly: int, periodic: bool = False):
    """Nearest-neighbor bond list of an ``Lx × Ly`` lattice (site
    ``(x, y)`` at chain position ``x·Ly + y``, as in
    :func:`transverse_field_ising_2d`)."""
    bonds = []
    for x in range(Lx):
        for y in range(Ly):
            s = x * Ly + y
            if x + 1 < Lx:
                bonds.append((s, (x + 1) * Ly + y))
            elif periodic and Lx > 2:
                bonds.append((s, y))
            if y + 1 < Ly:
                bonds.append((s, x * Ly + y + 1))
            elif periodic and Ly > 2:
                bonds.append((s, x * Ly))
    return bonds


def transverse_field_ising_2d(
    Lx: int,
    Ly: int,
    *,
    J: float = 1.0,
    g: float = 1.0,
    h: float = 0.0,
    periodic: bool = False,
    dtype=None,
):
    """2D transverse-field Ising on an ``Lx × Ly`` lattice
    (``H = J Σ_<ij> σᶻᵢσᶻⱼ + h Σ σᶻᵢ + g Σ σˣᵢ``), site ``(x,y)`` at
    chain position ``x·Ly + y``.

    Same structure as the chain — ALL Pauli-Z content (arbitrarily many
    bonds) still collapses into ONE diagonal vector and the transverse
    part into one :class:`SiteOperatorSum` — so the 2^24-dim 2D-lattice
    benchmark config (BASELINE.md) runs on the identical matricized /
    sharded machinery as the 1D chain.
    """
    if dtype is None:
        dtype = default_complex_dtype()
    L = Lx * Ly
    bonds = lattice2d_bonds(Lx, Ly, periodic=periodic)
    rdtype = jnp.finfo(dtype).dtype if dtype in (
        jnp.complex64,
        jnp.complex128,
    ) else jnp.dtype(dtype)
    diag = zz_bonds_diagonal(L, bonds, J, dtype=rdtype)
    if h != 0.0:
        diag = diag + z_chain_diagonal(L, h, dtype=rdtype)
    H_diag = DiagonalOperator(diag.astype(dtype))
    sx = np.asarray(PAULI["X"].real)
    site_mats = jnp.asarray(np.stack([g * sx for _ in range(L)]), dtype=dtype)
    H_x = SiteOperatorSum(site_mats, L=L)
    return H_diag, H_x


def transverse_field_ising(
    L: int,
    *,
    J: float = 1.0,
    g: float = 1.0,
    h: float = 0.0,
    periodic: bool = False,
    dtype=None,
):
    """Transverse-field Ising Hamiltonian
    ``H = J Σ σᶻᵢσᶻᵢ₊₁ + h Σ σᶻᵢ + g Σ σˣᵢ`` on ``L`` qubits.

    Returns ``(H_diag, H_x)``: a :class:`DiagonalOperator` holding the
    full ZZ+Z part (one fused multiply) and a :class:`SiteOperatorSum`
    holding the transverse part — the benchmark Hamiltonian family
    (BASELINE.md "1D spin chain"; 2^20-dim config).  Combine e.g. as
    ``hamiltonian(H_diag, (H_x, drive))`` for a driven chain, or
    ``Operator([H_diag, H_x], [g])`` for the static Hamiltonian.
    ``dtype`` defaults to :func:`~..config.default_complex_dtype`
    (complex128 under ``jax_enable_x64``).
    """
    if dtype is None:
        dtype = default_complex_dtype()
    rdtype = jnp.finfo(dtype).dtype
    diag = zz_chain_diagonal(L, J, periodic=periodic, dtype=rdtype)
    if h != 0.0:
        diag = diag + z_chain_diagonal(L, h, dtype=rdtype)
    H_diag = DiagonalOperator(diag.astype(dtype))
    sx = np.asarray(PAULI["X"].real)
    site_mats = jnp.asarray(np.stack([g * sx for _ in range(L)]), dtype=dtype)
    H_x = SiteOperatorSum(site_mats, L=L)
    return H_diag, H_x
