"""BSR block-sparse operator: correctness, algebra, propagation.

The BSR layout (dense blocks, blocked-ELL padding) is this
framework's answer to the reference's generic CSC SpMV for unstructured
operators (reference ``src/cheby.jl:146-148``; optomech model
``test/optomech.jl:1-45``; BASELINE config "optomech cavity CSR" and
the 2^24 "BSR block-partitioned" config).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import quantumpropagators as qp
from quantumpropagators.ops.operators import (
    BSROperator,
    add_operators,
    apply,
    bsr_from_dense,
    bsr_from_scipy,
    choose_block_size,
    csr_from_scipy,
    scale_operator,
    to_dense,
    to_scipy_sparse,
)

from test_optomech import build_optomech


def random_sparse(N, density, rng, hermitian=False):
    A = sp.random(
        N, N, density=density, random_state=np.random.RandomState(rng),
        dtype=float,
    ) + 1j * sp.random(
        N, N, density=density, random_state=np.random.RandomState(rng + 1),
        dtype=float,
    )
    A = A.tocsr()
    if hermitian:
        A = 0.5 * (A + A.conj().T)
    return A.tocsr()


@pytest.mark.parametrize("block_size", [2, 4, 8])
def test_bsr_matvec_matches_csr(block_size):
    rng = np.random.default_rng(0)
    N = 48
    A = random_sparse(N, 0.1, 5)
    op = bsr_from_scipy(A, block_size=block_size)
    v = jnp.asarray(rng.normal(size=N) + 1j * rng.normal(size=N))
    want = A @ np.asarray(v)
    got = np.asarray(apply(op, v))
    assert np.allclose(got, want, atol=1e-13)


def test_bsr_padding_nondivisible():
    """N not divisible by b: the matrix is zero-padded internally but
    the logical shape and apply stay N-dimensional."""
    rng = np.random.default_rng(1)
    N = 55  # optomech dimension: 5 * 11
    A = random_sparse(N, 0.15, 9)
    op = bsr_from_scipy(A, block_size=8)
    assert op.shape == (N, N)
    v = jnp.asarray(rng.normal(size=N) + 1j * rng.normal(size=N))
    assert np.allclose(np.asarray(apply(op, v)), A @ np.asarray(v), atol=1e-13)


def test_bsr_batched_states():
    rng = np.random.default_rng(2)
    N = 32
    A = random_sparse(N, 0.2, 3)
    op = bsr_from_scipy(A, block_size=4)
    V = rng.normal(size=(3, 5, N)) + 1j * rng.normal(size=(3, 5, N))
    got = np.asarray(apply(op, jnp.asarray(V)))
    want = np.einsum("ij,bkj->bki", A.toarray(), V)
    assert got.shape == (3, 5, N)
    assert np.allclose(got, want, atol=1e-12)


def test_bsr_algebra_and_conversions():
    A = random_sparse(24, 0.2, 7)
    B = random_sparse(24, 0.2, 11)
    opA = bsr_from_scipy(A, block_size=4)
    opB = csr_from_scipy(B)
    s = add_operators(opA, opB)
    assert isinstance(s, BSROperator)
    assert np.allclose(np.asarray(to_dense(s)), (A + B).toarray(), atol=1e-13)
    sc = scale_operator(2.5j, opA)
    assert isinstance(sc, BSROperator)
    assert np.allclose(
        np.asarray(to_dense(sc)), 2.5j * A.toarray(), atol=1e-13
    )
    assert np.allclose(
        to_scipy_sparse(opA).toarray(), A.toarray(), atol=1e-14
    )
    rt = bsr_from_dense(A.toarray(), block_size=4)
    assert np.allclose(np.asarray(to_dense(rt)), A.toarray(), atol=1e-14)


def test_choose_block_size():
    assert choose_block_size(2**20) == 64
    assert choose_block_size(48) == 16
    assert choose_block_size(55) == 1
    assert choose_block_size(2 * 3 * 8) == 16


def test_bsr_jit_and_grad():
    """BSROperator is a pytree: flows through jit and grad."""
    A = random_sparse(16, 0.3, 13, hermitian=True)
    op = bsr_from_scipy(A, block_size=4)
    v = jnp.asarray(np.random.default_rng(3).normal(size=16)).astype(complex)

    @jax.jit
    def energy(op, v):
        return jnp.real(jnp.vdot(v, apply(op, v)))

    e = energy(op, v)
    assert np.isclose(float(e), float(np.real(np.vdot(v, A @ np.asarray(v)))))
    g = jax.grad(lambda blocks: energy(
        BSROperator(blocks, op.cols, op.shape, op.block_size), v))(op.blocks)
    assert g.shape == op.blocks.shape


def test_optomech_propagation_bsr_vs_csr():
    """BASELINE optomech config on the BSR layout: cheby propagation
    matches the CSR path to 1e-10 (reference test_propagate.jl:158-162
    tolerance)."""
    H0, H_int = build_optomech()
    eps = lambda t: float(np.sin(2 * np.pi * t / 5.0) ** 2)
    gen_csr = qp.hamiltonian(csr_from_scipy(H0), (csr_from_scipy(H_int), eps))
    gen_bsr = qp.hamiltonian(
        bsr_from_scipy(H0, block_size=8),
        (bsr_from_scipy(H_int, block_size=8), eps),
    )
    N = H0.shape[0]
    psi0 = np.zeros(N, dtype=complex)
    psi0[0] = 1.0
    tlist = np.linspace(0, 5, 101)
    p_csr = qp.propagate(jnp.asarray(psi0), gen_csr, tlist, method="cheby")
    p_bsr = qp.propagate(jnp.asarray(psi0), gen_bsr, tlist, method="cheby")
    assert np.linalg.norm(np.asarray(p_csr) - np.asarray(p_bsr)) < 1e-10
