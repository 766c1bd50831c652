"""Double-float arithmetic and the df64 Chebyshev kernel.

These run on CPU (f32 ops with x64 available for reference values); the
same code path is the accuracy mode without x64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import expm

from quantumpropagators.models.lattice import PAULI
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.ops.df64 import (
    cdd_from_c128,
    cdd_to_c128,
    cheby_apply_dd,
    dd_add,
    dd_from_f64,
    dd_mul,
    dd_to_f64,
    validate_df64,
)
from quantumpropagators.utils.fixtures import random_state_vector


def test_validate_df64():
    assert validate_df64(), "error-free transformations broken on this backend"


def test_dd_roundtrip_and_arith():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000)
    y = rng.standard_normal(1000)
    dx, dy = dd_from_f64(x), dd_from_f64(y)
    assert np.max(np.abs(dd_to_f64(dx) - x)) < 1e-13
    s = dd_to_f64(dd_add(dx, dy))
    assert np.max(np.abs(s - (x + y))) < 1e-13
    p = dd_to_f64(dd_mul(dx, dy))
    assert np.max(np.abs(p - x * y)) < 1e-12


def test_cdd_roundtrip():
    rng = np.random.default_rng(2)
    z = rng.standard_normal(100) + 1j * rng.standard_normal(100)
    assert np.max(np.abs(cdd_to_c128(cdd_from_c128(z)) - z)) < 1e-13


def dense_tfim(L, J, g, h):
    I, X, Z = PAULI["I"], PAULI["X"], PAULI["Z"]

    def site(op, i):
        out = np.array([[1.0]], dtype=complex)
        for j in range(L):
            out = np.kron(out, op if j == i else I)
        return out

    H = np.zeros((2 ** L, 2 ** L), dtype=complex)
    for i in range(L - 1):
        H += J * site(Z, i) @ site(Z, i + 1)
    for i in range(L):
        H += h * site(Z, i) + g * site(X, i)
    return H


def test_df64_cheby_single_step():
    """df64 Chebyshev step must be ~1e-12 accurate — far beyond c64."""
    from quantumpropagators.models.lattice import (
        z_chain_diagonal,
        zz_chain_diagonal,
    )

    L, J, g, h = 8, 1.0, 1.2, 0.3
    N = 2 ** L
    H = dense_tfim(L, J, g, h)
    evals = np.linalg.eigvalsh(H)
    e_min, delta = float(evals[0]), float(evals[-1] - evals[0])
    dt = 0.2
    rng = np.random.default_rng(3)
    psi = random_state_vector(N, rng=rng)
    exact = expm(-1j * H * dt) @ psi

    diag64 = np.asarray(
        zz_chain_diagonal(L, J, dtype=jnp.float64)
    ) + np.asarray(z_chain_diagonal(L, h, dtype=jnp.float64))
    coeffs = cheby_coeffs(delta, dt)
    out = cheby_apply_dd(
        cdd_from_c128(psi),
        dd_from_f64(diag64),
        [g] * L,
        coeffs,
        delta,
        e_min,
        dt,
        L=L,
    )
    err = np.linalg.norm(cdd_to_c128(out) - exact)
    assert err < 1e-12, f"df64 error {err}"


def test_df64_cheby_many_steps_vs_c64():
    """Error growth over 50 steps: df64 stays ~1e-11; c64 visibly
    worse.  This is the accuracy case for the dd path."""
    from quantumpropagators.models.lattice import (
        transverse_field_ising,
        z_chain_diagonal,
        zz_chain_diagonal,
    )
    from quantumpropagators.models.generators import Operator
    from quantumpropagators.ops.cheby import cheby_apply

    L, J, g, h = 6, 1.0, 1.1, 0.2
    N = 2 ** L
    H = dense_tfim(L, J, g, h)
    evals = np.linalg.eigvalsh(H)
    e_min, delta = float(evals[0]), float(evals[-1] - evals[0])
    dt = 0.1
    steps = 50
    rng = np.random.default_rng(4)
    psi = random_state_vector(N, rng=rng)
    exact = expm(-1j * H * dt * steps) @ psi

    diag64 = np.asarray(zz_chain_diagonal(L, J, dtype=jnp.float64)) + np.asarray(
        z_chain_diagonal(L, h, dtype=jnp.float64)
    )
    coeffs = cheby_coeffs(delta, dt)
    v = cdd_from_c128(psi)
    for _ in range(steps):
        v = cheby_apply_dd(
            v, dd_from_f64(diag64), [g] * L, coeffs, delta, e_min, dt, L=L
        )
    err_dd = np.linalg.norm(cdd_to_c128(v) - exact)

    # c64 comparison
    H_diag, H_x = transverse_field_ising(L, J=J, g=g, h=h, dtype=jnp.complex64)
    op = Operator([H_diag, H_x], np.array([1.0], dtype=np.float32))
    u = jnp.asarray(psi, dtype=jnp.complex64)
    a32 = jnp.asarray(coeffs, dtype=jnp.float32)
    for _ in range(steps):
        u = cheby_apply(op, u, a32, delta, e_min, dt)
    err_c64 = np.linalg.norm(np.asarray(u, dtype=np.complex128) - exact)

    assert err_dd < 1e-10, f"df64 error {err_dd}"
    assert err_dd < err_c64 / 100, f"df64 {err_dd} vs c64 {err_c64}"
