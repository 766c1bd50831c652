"""Operator algebra tests (mirrors reference
``test/test_operator_linalg.jl``): lazy Operator application /
expectation values / densification vs dense equivalents; CSR and
Diagonal operators; StackedCSR coefficient fusion."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest

from quantumpropagators import Operator, ScaledOperator, apply, op_dot, to_dense
from quantumpropagators.ops.operators import (
    CSROperator,
    DiagonalOperator,
    StackedCSROperator,
    csr_from_dense,
    csr_from_scipy,
)
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_dense_apply(rng):
    H = random_matrix(32, rng=rng)
    psi = random_state_vector(32, rng=rng)
    assert np.allclose(np.asarray(apply(jnp.asarray(H), jnp.asarray(psi))), H @ psi)


def test_csr_apply(rng):
    H = random_matrix(64, density=0.1, rng=rng)
    psi = random_state_vector(64, rng=rng)
    op = csr_from_dense(H)
    assert np.allclose(np.asarray(apply(op, jnp.asarray(psi))), H @ psi, atol=1e-12)
    assert np.allclose(np.asarray(to_dense(op)), H)


def test_csr_batched_apply(rng):
    H = random_matrix(32, density=0.2, rng=rng)
    op = csr_from_dense(H)
    batch = np.stack([random_state_vector(32, rng=rng) for _ in range(5)])
    out = np.asarray(apply(op, jnp.asarray(batch)))
    assert out.shape == (5, 32)
    assert np.allclose(out, batch @ H.T, atol=1e-12)


def test_diagonal_apply(rng):
    d = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    psi = random_state_vector(16, rng=rng)
    op = DiagonalOperator(jnp.asarray(d))
    assert np.allclose(np.asarray(apply(op, jnp.asarray(psi))), d * psi)
    assert np.allclose(np.asarray(to_dense(op)), np.diag(d))


def test_lazy_operator(rng):
    H0 = random_matrix(24, hermitian=True, rng=rng)
    H1 = random_matrix(24, hermitian=True, rng=rng)
    H2 = random_matrix(24, hermitian=True, rng=rng)
    psi = random_state_vector(24, rng=rng)
    c = np.array([0.3, -1.2])
    # drift offset: first op has implicit coefficient 1
    O = Operator([jnp.asarray(H0), jnp.asarray(H1), jnp.asarray(H2)], c)
    dense = H0 + c[0] * H1 + c[1] * H2
    assert np.allclose(np.asarray(apply(O, jnp.asarray(psi))), dense @ psi)
    assert np.allclose(np.asarray(to_dense(O)), dense)
    e = op_dot(jnp.asarray(psi), O, jnp.asarray(psi))
    assert complex(e) == pytest.approx(psi.conj() @ dense @ psi)


def test_operator_rejects_too_many_coeffs(rng):
    H = jnp.asarray(random_matrix(4, rng=rng))
    with pytest.raises(ValueError):
        Operator([H], np.array([1.0, 2.0]))


def test_scaled_operator(rng):
    H = random_matrix(16, rng=rng)
    psi = random_state_vector(16, rng=rng)
    S = ScaledOperator(2.5j, jnp.asarray(H))
    assert np.allclose(np.asarray(apply(S, jnp.asarray(psi))), 2.5j * H @ psi)
    # nested ScaledOperator collapses
    S2 = ScaledOperator(2.0, S)
    assert S2.coeff == 5.0j
    assert np.allclose(np.asarray(to_dense(S2)), 5.0j * H)


def test_stacked_csr(rng):
    import scipy.sparse as sp

    N = 48
    pattern = sp.random(N, N, density=0.1, random_state=np.random.RandomState(5))
    mask = np.asarray(pattern.todense()) != 0
    H1 = random_matrix(N, rng=rng) * mask
    H2 = random_matrix(N, rng=rng) * mask
    base = csr_from_dense(np.where(mask, 1.0 + 0j, 0))
    data = jnp.stack(
        [
            jnp.asarray(H1[np.asarray(base.row), np.asarray(base.col)]),
            jnp.asarray(H2[np.asarray(base.row), np.asarray(base.col)]),
        ]
    )
    stacked = StackedCSROperator(data, base.col, base.row, base.indptr, base.shape)
    coeffs = jnp.asarray([0.5, -2.0 + 1j])
    psi = random_state_vector(N, rng=rng)
    out = np.asarray(stacked.apply(jnp.asarray(psi), coeffs))
    dense = 0.5 * H1 + (-2.0 + 1j) * H2
    assert np.allclose(out, dense @ psi, atol=1e-12)


def test_operator_is_pytree(rng):
    """Operator flows through jit; coefficient updates do not retrace."""
    import jax

    H0 = jnp.asarray(random_matrix(8, rng=rng))
    H1 = jnp.asarray(random_matrix(8, rng=rng))
    psi = jnp.asarray(random_state_vector(8, rng=rng))
    traces = []

    @jax.jit
    def f(op, psi):
        traces.append(1)
        return apply(op, psi)

    out1 = f(Operator([H0, H1], jnp.asarray([1.0])), psi)
    out2 = f(Operator([H0, H1], jnp.asarray([2.0])), psi)
    assert len(traces) == 1  # same structure → no retrace
    assert not np.allclose(np.asarray(out1), np.asarray(out2))


def test_dia_operator(rng):
    import scipy.sparse as sp
    from quantumpropagators.ops.operators import DIAOperator, dia_from_scipy

    N = 128
    A = sp.diags(
        [
            (rng.standard_normal(N - 5) + 1j * rng.standard_normal(N - 5)),
            (rng.standard_normal(N) + 1j * rng.standard_normal(N)),
            (rng.standard_normal(N - 2) + 1j * rng.standard_normal(N - 2)),
        ],
        [-5, 0, 2],
        format="csr",
    )
    op = dia_from_scipy(A)
    assert op.offsets == (-5, 0, 2)
    psi = random_state_vector(N, rng=rng)
    assert np.allclose(np.asarray(apply(op, jnp.asarray(psi))), A @ psi, atol=1e-12)
    assert np.allclose(np.asarray(to_dense(op)), A.todense(), atol=1e-12)
    # batched
    batch = np.stack([random_state_vector(N, rng=rng) for _ in range(3)])
    out = np.asarray(apply(op, jnp.asarray(batch)))
    assert np.allclose(out, batch @ np.asarray(A.todense()).T, atol=1e-12)


def test_dia_optomech_cheby(rng):
    """Optomech-style kron operator in DIA format through a Chebyshev
    step (the gather-free generic-sparse path)."""
    import scipy.sparse as sp
    from scipy.linalg import expm
    from quantumpropagators.ops.cheby import cheby_apply, cheby_coeffs
    from quantumpropagators.ops.operators import dia_from_scipy

    sys.path  # noqa
    from tests.test_optomech import build_optomech

    H0, H_int = build_optomech()
    H = (H0 + 0.5 * H_int).tocsr()
    op = dia_from_scipy(H)
    assert len(op.offsets) <= 25  # kron structure → few diagonals
    N = H.shape[0]
    ev = np.linalg.eigvalsh(H.todense())
    e_min, delta = float(ev[0]), float(ev[-1] - ev[0])
    dt = 0.02
    psi = random_state_vector(N, rng=rng)
    a = jnp.asarray(cheby_coeffs(delta, dt))
    got = cheby_apply(op, jnp.asarray(psi), a, delta, e_min, dt)
    exact = expm(-1j * np.asarray(H.todense()) * dt) @ psi
    assert np.linalg.norm(np.asarray(got) - exact) < 1e-10
