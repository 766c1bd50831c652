"""Data-parallel (batched) propagation.

The reference propagates one state at a time; a leading batch
axis over initial states (or control sets) is free parallelism
(SURVEY §2.8 "Data parallel").  All functional kernels operate on the
last axis, so batching is a shape change (or a ``vmap``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumpropagators.ops.cheby import cheby_apply, cheby_coeffs
from quantumpropagators.ops.operators import csr_from_dense
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(88)
    N = 64
    H = random_matrix(N, hermitian=True, spectral_radius=4.0, rng=rng)
    evals = np.linalg.eigvalsh(H)
    batch = np.stack([random_state_vector(N, rng=rng) for _ in range(5)])
    return H, evals, batch


def test_batched_cheby_dense(system):
    H, evals, batch = system
    dt = 0.3
    delta, e_min = evals[-1] - evals[0], evals[0]
    a = jnp.asarray(cheby_coeffs(delta, dt))
    out = cheby_apply(jnp.asarray(H), jnp.asarray(batch), a, delta, e_min, dt)
    assert out.shape == batch.shape
    for b in range(batch.shape[0]):
        single = cheby_apply(jnp.asarray(H), jnp.asarray(batch[b]), a, delta, e_min, dt)
        assert np.allclose(np.asarray(out[b]), np.asarray(single), atol=1e-12)


def test_batched_cheby_csr(system):
    H, evals, batch = system
    Hs = H * (np.abs(H) > 0.1)
    ev = np.linalg.eigvalsh(Hs)
    dt = 0.3
    delta, e_min = ev[-1] - ev[0], ev[0]
    a = jnp.asarray(cheby_coeffs(delta, dt))
    op = csr_from_dense(Hs)
    out = cheby_apply(op, jnp.asarray(batch), a, delta, e_min, dt)
    from scipy.linalg import expm

    U = expm(-1j * Hs * dt)
    assert np.allclose(np.asarray(out), batch @ U.T, atol=1e-10)


def test_vmap_over_control_sets(system):
    """vmap over coefficient tables: many control settings propagated
    in one compiled call (the optimal-control population-transfer
    sweep)."""
    from quantumpropagators.models.generators import Operator

    H, evals, batch = system
    rng = np.random.default_rng(9)
    H1 = random_matrix(64, hermitian=True, spectral_radius=1.0, rng=rng)
    dt = 0.2
    # spectral envelope over the control range [-2, 2]
    ev_lo = np.linalg.eigvalsh(H - 2 * H1)
    ev_hi = np.linalg.eigvalsh(H + 2 * H1)
    e_min = min(ev_lo[0], ev_hi[0]) - 1.0
    e_max = max(ev_lo[-1], ev_hi[-1]) + 1.0
    delta = e_max - e_min
    a = jnp.asarray(cheby_coeffs(delta, dt))
    psi0 = jnp.asarray(batch[0])

    def propagate_with_amp(amp):
        op = Operator([jnp.asarray(H), jnp.asarray(H1)], jnp.array([amp]))
        return cheby_apply(op, psi0, a, delta, e_min, dt)

    amps = jnp.linspace(-2, 2, 7)
    outs = jax.vmap(propagate_with_amp)(amps)
    assert outs.shape == (7, 64)
    for i, amp in enumerate(np.asarray(amps)):
        single = propagate_with_amp(float(amp))
        assert np.allclose(np.asarray(outs[i]), np.asarray(single), atol=1e-12)


def test_timings_counters(system):
    """enable_timings records sections and matvec counters (the
    reference's TimerOutputs behavior, test/test_timings.jl)."""
    import quantumpropagators as qp
    from quantumpropagators.utils.timings import (
        disable_timings,
        enable_timings,
        timings_enabled,
    )

    H, evals, batch = system
    gen = qp.hamiltonian(
        jnp.asarray(H), (jnp.asarray(H), lambda t: 0.1 * np.sin(t))
    )
    tlist = np.linspace(0, 1, 11)
    psi0 = jnp.asarray(batch[0])
    enable_timings()
    try:
        assert timings_enabled()
        prop = qp.init_prop(psi0, gen, tlist, method="cheby")
        while prop.prop_step() is not None:
            pass
        assert prop.timing_data.calls["prop_step"] == 10
        assert prop.timing_data.counters["matvec"] > 100
        assert prop.timing_data.times["prop_step"] > 0
        report = prop.timing_data.report()
        assert "prop_step" in report
    finally:
        disable_timings()
    # disabled: no recording
    prop2 = qp.init_prop(psi0, gen, tlist, method="cheby")
    prop2.prop_step()
    assert prop2.timing_data.calls == {}
