"""Fused scan propagation vs the host-loop driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantumpropagators as qp
from quantumpropagators.fused import cheby_propagate_fused, make_fused_cheby_propagator
from quantumpropagators.models.generators import coeff_table
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector


@pytest.fixture
def problem():
    rng = np.random.default_rng(77)
    N = 16
    H0 = jnp.asarray(random_matrix(N, hermitian=True, spectral_radius=2, rng=rng))
    H1 = jnp.asarray(random_matrix(N, hermitian=True, spectral_radius=1, rng=rng))
    gen = qp.hamiltonian(H0, (H1, lambda t: np.sin(t)))
    tlist = np.linspace(0, 3, 61)
    psi0 = jnp.asarray(random_state_vector(N, rng=rng))
    return gen, tlist, psi0


def test_fused_matches_host_loop(problem):
    gen, tlist, psi0 = problem
    expected = qp.propagate(psi0, gen, tlist, method="cheby")
    psi_final, traj = cheby_propagate_fused(psi0, gen, tlist, store_states=True)
    assert np.linalg.norm(np.asarray(psi_final) - np.asarray(expected)) < 1e-12
    assert traj.shape == (len(tlist) - 1, 16)
    # trajectory matches storage from the host loop (skip initial state)
    storage = qp.propagate(psi0, gen, tlist, method="cheby", storage=True)
    assert np.allclose(np.asarray(traj).T, np.asarray(storage)[:, 1:], atol=1e-12)


def test_fused_observable(problem):
    gen, tlist, psi0 = problem
    rng = np.random.default_rng(3)
    O = jnp.asarray(random_matrix(16, hermitian=True, rng=rng))
    _psi, vals = cheby_propagate_fused(
        psi0, gen, tlist, observable_fn=lambda psi: jnp.vdot(psi, O @ psi).real
    )
    storage = qp.propagate(psi0, gen, tlist, method="cheby", observables=(O,), storage=True)
    assert np.allclose(np.asarray(vals), np.asarray(storage).real[1:], atol=1e-12)


def test_fused_backward(problem):
    gen, tlist, psi0 = problem
    fwd, _ = cheby_propagate_fused(psi0, gen, tlist)
    back, _ = cheby_propagate_fused(fwd, gen, tlist, backward=True)
    assert np.linalg.norm(np.asarray(back) - np.asarray(psi0)) < 1e-11


def test_reusable_propagator_no_retrace(problem):
    """Control updates must hit the same compiled executable."""
    gen, tlist, psi0 = problem
    fn = make_fused_cheby_propagator(psi0, gen, tlist)
    table1 = coeff_table(gen, tlist)
    out1, _ = fn(psi0, table1)
    compiled_before = _count_cheby_scan_compiles()
    out2, _ = fn(psi0, 0.5 * table1)
    assert _count_cheby_scan_compiles() == compiled_before
    assert np.linalg.norm(np.asarray(out1) - np.asarray(out2)) > 1e-8


def _count_cheby_scan_compiles():
    from quantumpropagators.fused import _fused_scan

    return _fused_scan._cache_size()


def test_propagate_fused_flag(problem):
    """propagate(..., fused=True) matches the host-loop driver for
    final state, state storage, and observable storage, both ways."""
    gen, tlist, psi0 = problem
    ref_final = qp.propagate(psi0, gen, tlist, method="cheby")
    got_final = qp.propagate(psi0, gen, tlist, method="cheby", fused=True)
    assert np.linalg.norm(np.asarray(got_final) - np.asarray(ref_final)) < 1e-12

    ref_st = qp.propagate(psi0, gen, tlist, method="cheby", storage=True)
    got_st = qp.propagate(psi0, gen, tlist, method="cheby", fused=True, storage=True)
    assert got_st.shape == ref_st.shape
    assert np.allclose(got_st, np.asarray(ref_st), atol=1e-12)

    rng = np.random.default_rng(1)
    O = jnp.asarray(random_matrix(16, hermitian=True, rng=rng))
    ref_obs = qp.propagate(
        psi0, gen, tlist, method="cheby", observables=(O,), storage=True
    )
    got_obs = qp.propagate(
        psi0, gen, tlist, method="cheby", fused=True, observables=(O,), storage=True
    )
    assert np.allclose(np.asarray(got_obs), np.asarray(ref_obs), atol=1e-12)

    # backward storage fills back-to-front identically
    psi_T = jnp.asarray(np.asarray(ref_st)[:, -1])
    ref_b = qp.propagate(psi_T, gen, tlist, method="cheby", backward=True, storage=True)
    got_b = qp.propagate(
        psi_T, gen, tlist, method="cheby", fused=True, backward=True, storage=True
    )
    assert np.allclose(np.asarray(got_b), np.asarray(ref_b), atol=1e-12)

    with pytest.raises(ValueError, match="callback"):
        qp.propagate(psi0, gen, tlist, method="cheby", fused=True,
                     callback=lambda p, o: None)
    with pytest.raises(ValueError, match="cheby"):
        qp.propagate(psi0, gen, tlist, method="newton", fused=True)


def test_fused_storage_memory_guard():
    """Storing all states above the host-memory limit must refuse with
    an actionable error, not OOM (VERDICT: 2^24 x 1000 steps = 128 TB)."""
    import numpy as np
    import jax.numpy as jnp
    import pytest
    import quantumpropagators as qp

    rng = np.random.default_rng(5)
    from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
    H0 = jnp.asarray(random_matrix(16, hermitian=True, spectral_radius=2, rng=rng))
    gen = qp.hamiltonian(H0, (H0, lambda t: np.sin(t)))
    psi0 = jnp.asarray(random_state_vector(16, rng=rng))
    tlist = np.linspace(0, 1.0, 11)
    with pytest.raises(ValueError, match="GiB"):
        qp.propagate(psi0, gen, tlist, method="cheby", fused=True,
                     storage=True, max_storage_bytes=100)
    # streaming observables stays fine under the same limit
    out = qp.propagate(psi0, gen, tlist, method="cheby", fused=True,
                       storage=True, max_storage_bytes=100,
                       observables=(lambda p: jnp.vdot(p, p).real,))
    assert out.shape == (11,)


# ---- static banded and general sparse operators ----
#
# The fused scan takes any operator with the ``apply`` protocol; these
# pin the BSR, folded-Operator and dense routes against ``expm``.


@pytest.fixture
def banded_problem():
    import scipy.sparse as sp

    rng = np.random.default_rng(91)
    N = 48
    A = sp.diags(
        [rng.normal(size=N - 2), rng.normal(size=N - 1),
         rng.normal(size=N), rng.normal(size=N - 1),
         rng.normal(size=N - 2)],
        [-2, -1, 0, 1, 2],
    ).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    psi0 = jnp.asarray(random_state_vector(N, rng=rng))
    tlist = np.linspace(0, 0.5, 11)
    return A, psi0, tlist


def _expm_final(A, psi0, tlist):
    import scipy.linalg

    U = scipy.linalg.expm(-1j * (tlist[-1] - tlist[0]) * A.toarray())
    return U @ np.asarray(psi0)


def test_static_banded_via_propagate(banded_problem):
    """propagate(fused=True) on a banded BSR operator matches expm."""
    from quantumpropagators.ops.operators import bsr_from_scipy

    A, psi0, tlist = banded_problem
    op = bsr_from_scipy(A, block_size=8)
    got = qp.propagate(psi0, op, tlist, method="cheby", fused=True)
    assert got.dtype == jnp.complex128
    want = _expm_final(A, psi0, tlist)
    assert np.abs(np.asarray(got) - want).max() < 1e-11


def test_static_operator_fold(banded_problem):
    """A static Operator (ops + scalar coeffs) propagates in the scan."""
    from quantumpropagators.models.generators import Operator
    from quantumpropagators.ops.operators import bsr_from_scipy

    A, psi0, tlist = banded_problem
    op1 = bsr_from_scipy(A, block_size=8)
    op2 = bsr_from_scipy(0.5 * A, block_size=8)
    gen = Operator([op1, op2], jnp.asarray([0.6, 0.8]))
    psi_final, _ = cheby_propagate_fused(psi0, gen, tlist)
    want = _expm_final(0.6 * A + 0.4 * A, psi0, tlist)
    assert np.abs(np.asarray(psi_final) - want).max() < 1e-11


def test_static_nonbanded_dense(banded_problem):
    """Far off-diagonal coupling as a dense complex128 operator."""
    A, psi0, tlist = banded_problem
    N = A.shape[0]
    A = A.tolil()
    A[0, N - 1] = A[N - 1, 0] = 0.4
    A = A.tocsr()
    psi_final, _ = cheby_propagate_fused(
        psi0, jnp.asarray(A.toarray(), dtype=jnp.complex128), tlist
    )
    want = _expm_final(A, psi0, tlist)
    assert np.abs(np.asarray(psi_final) - want).max() < 1e-11


def test_static_observables_stream(banded_problem):
    """Observables stream through the fused scan like the host loop."""
    A, psi0, tlist = banded_problem
    from quantumpropagators.ops.operators import bsr_from_scipy

    op = bsr_from_scipy(A, block_size=8)
    n_op = jnp.asarray(np.diag(np.arange(A.shape[0], dtype=float)))
    store = qp.propagate(
        psi0, op, tlist, method="cheby", fused=True,
        storage=True, observables=[n_op],
    )
    assert store.shape == (len(tlist),)
    ref = qp.propagate(
        psi0, op, tlist, method="cheby", storage=True,
        observables=[n_op],
    )
    assert np.allclose(np.asarray(store), np.asarray(ref), atol=1e-10)
