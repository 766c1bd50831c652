"""Planar (re, im) Chebyshev fast path vs the complex kernel and expm.

Mirrors the kernel-vs-dense-oracle strategy of reference
``test/test_cheby.jl`` for the planar throughput path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import expm

import quantumpropagators as qp
from quantumpropagators.ops.cheby import cheby_apply, cheby_coeffs
from quantumpropagators.ops.planar import (
    apply_planar,
    cheby_apply_planar,
    is_real_linear,
)


@pytest.fixture(scope="module")
def tfim():
    L = 8
    H_diag, H_x = qp.transverse_field_ising(
        L, J=1.0, g=1.2, h=0.3, dtype=jnp.float64
    )
    op = qp.Operator([H_diag, H_x.grouped(4)], np.array([1.0]))
    bound = 1.0 * (L - 1) + 0.3 * L + 1.2 * L
    rng = np.random.default_rng(7)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    return op, psi, -bound, 2 * bound, L


def test_is_real_linear(tfim):
    op, _, _, _, _ = tfim
    assert is_real_linear(op)
    assert is_real_linear(op.ops[0])
    assert is_real_linear(op.ops[1])
    assert not is_real_linear(jnp.eye(4, dtype=jnp.complex128))
    assert is_real_linear(jnp.eye(4))


def test_apply_planar_matches_complex(tfim):
    op, psi, _, _, _ = tfim
    re = jnp.asarray(psi.real)
    im = jnp.asarray(psi.imag)
    out_r, out_i = apply_planar(op, re, im)
    ref = qp.apply(op, jnp.asarray(psi))
    np.testing.assert_allclose(np.asarray(out_r), np.asarray(ref.real), atol=1e-12)
    np.testing.assert_allclose(np.asarray(out_i), np.asarray(ref.imag), atol=1e-12)


def test_apply_planar_fallback_complex_operator():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    psi = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    out_r, out_i = apply_planar(
        jnp.asarray(A), jnp.asarray(psi.real), jnp.asarray(psi.imag)
    )
    ref = A @ psi
    np.testing.assert_allclose(np.asarray(out_r), ref.real, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out_i), ref.imag, atol=1e-12)


@pytest.mark.parametrize("forward", [True, False])
def test_cheby_planar_vs_expm(tfim, forward):
    op, psi, e_min, delta, _ = tfim
    dt = 0.1 if forward else -0.1
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))
    re, im = cheby_apply_planar(
        op,
        jnp.asarray(psi.real),
        jnp.asarray(psi.imag),
        coeffs,
        delta,
        e_min,
        dt,
        forward=forward,
    )
    out = np.asarray(re) + 1j * np.asarray(im)
    H = np.asarray(qp.to_dense(op))
    exact = expm(-1j * H * dt) @ psi
    assert np.linalg.norm(out - exact) < 1e-10


def test_cheby_planar_matches_complex_kernel(tfim):
    op, psi, e_min, delta, _ = tfim
    dt = 0.07
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))
    re, im = cheby_apply_planar(
        op, jnp.asarray(psi.real), jnp.asarray(psi.imag),
        coeffs, delta, e_min, dt,
    )
    ref = cheby_apply(op, jnp.asarray(psi), coeffs, delta, e_min, dt)
    out = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-12)


def test_cheby_planar_multi_step_norm(tfim):
    """20 planar steps preserve the norm and match 20 complex steps."""
    op, psi, e_min, delta, _ = tfim
    dt = 0.05
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))
    re = jnp.asarray(psi.real)
    im = jnp.asarray(psi.imag)
    z = jnp.asarray(psi)
    for _ in range(20):
        re, im = cheby_apply_planar(op, re, im, coeffs, delta, e_min, dt)
        z = cheby_apply(op, z, coeffs, delta, e_min, dt)
    out = np.asarray(re) + 1j * np.asarray(im)
    assert abs(np.linalg.norm(out) - 1.0) < 1e-11
    np.testing.assert_allclose(out, np.asarray(z), atol=1e-11)
