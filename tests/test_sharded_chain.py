"""Multi-chip sharding tests on a virtual 8-device CPU mesh.

The added-category tests from SURVEY §4: multi-chip results must match
single-chip bit-for-bit (same dtype, same reduction order per shard)
or at least to tight tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantumpropagators as qp
from quantumpropagators.models.lattice import transverse_field_ising
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.ops.operators import apply, to_dense
from quantumpropagators.parallel.mesh import chain_mesh, replicate, shard_vector
from quantumpropagators.parallel.sharded_chain import (
    make_sharded_cheby_step,
    operator_shard_spec,
    sharded_apply,
)
from quantumpropagators.utils.fixtures import random_state_vector


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return chain_mesh(8)


@pytest.fixture(scope="module")
def tfim_problem():
    L = 10
    H_diag, H_x = transverse_field_ising(L, J=1.0, g=1.2, h=0.3, dtype=jnp.complex128)
    op = qp.Operator([H_diag, H_x], np.array([1.0]))
    rng = np.random.default_rng(17)
    psi = jnp.asarray(random_state_vector(2 ** L, rng=rng))
    return L, op, psi


def test_sharded_apply_matches_local(mesh, tfim_problem):
    from jax.sharding import PartitionSpec as P

    L, op, psi = tfim_problem
    expected = apply(op, psi)

    spec = operator_shard_spec(op)
    f = jax.jit(
        jax.shard_map(
            lambda o, v: sharded_apply(o, v),
            mesh=mesh,
            in_specs=(spec, P("x")),
            out_specs=P("x"),
        )
    )
    got = f(op, shard_vector(mesh, psi))
    assert np.allclose(np.asarray(got), np.asarray(expected), atol=1e-13)


def test_sharded_cheby_step_matches_single_device(mesh, tfim_problem):
    L, op, psi = tfim_problem
    dense = np.asarray(to_dense(op))
    evals = np.linalg.eigvalsh(dense)
    e_min, e_max = float(evals[0]), float(evals[-1])
    delta = e_max - e_min
    dt = 0.1
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))

    from quantumpropagators.ops.cheby import cheby_apply

    expected = cheby_apply(op, psi, coeffs, delta, e_min, dt)

    step = make_sharded_cheby_step(mesh, op, delta=delta, e_min=e_min, dt=dt)
    got = step(op, shard_vector(mesh, psi), replicate(mesh, coeffs))
    assert np.allclose(np.asarray(got), np.asarray(expected), atol=1e-12)
    # and vs the dense ground truth
    from scipy.linalg import expm

    exact = expm(-1j * dense * dt) @ np.asarray(psi)
    assert np.linalg.norm(np.asarray(got) - exact) < 1e-10


def test_sharded_multi_step_propagation(mesh, tfim_problem):
    """1000-step sharded propagation stays unitary and matches the
    single-device propagation."""
    L, op, psi = tfim_problem
    dense = np.asarray(to_dense(op))
    evals = np.linalg.eigvalsh(dense)
    e_min, delta = float(evals[0]), float(evals[-1] - evals[0])
    dt = 0.05
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))
    step = make_sharded_cheby_step(mesh, op, delta=delta, e_min=e_min, dt=dt)
    v = shard_vector(mesh, psi)
    c = replicate(mesh, coeffs)
    n_steps = 50
    for _ in range(n_steps):
        v = step(op, v, c)
    from quantumpropagators.ops.cheby import cheby_apply

    u = psi
    for _ in range(n_steps):
        u = cheby_apply(op, u, coeffs, delta, e_min, dt)
    assert abs(float(jnp.linalg.norm(v)) - 1.0) < 1e-10
    assert np.linalg.norm(np.asarray(v) - np.asarray(u)) < 1e-10


def test_prepared_sharded_operator(mesh, tfim_problem):
    """ShardedSiteSum (precomputed local groups + device-bit ppermute)
    matches the per-site sharded path and single-device exactly."""
    from quantumpropagators.parallel.sharded_chain import prepare_sharded_operator

    L, op, psi = tfim_problem
    from quantumpropagators.ops.cheby import cheby_apply, cheby_coeffs

    dense = np.asarray(to_dense(op))
    evals = np.linalg.eigvalsh(dense)
    e_min, delta = float(evals[0]), float(evals[-1] - evals[0])
    dt = 0.1
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))
    expected = cheby_apply(op, psi, coeffs, delta, e_min, dt)

    op_sh = prepare_sharded_operator(op, 8, group_bits=4)
    step = make_sharded_cheby_step(mesh, op_sh, delta=delta, e_min=e_min, dt=dt)
    got = step(op_sh, shard_vector(mesh, psi), replicate(mesh, coeffs))
    assert np.allclose(np.asarray(got), np.asarray(expected), atol=1e-12)


def test_gspmd_transparent_sharding(mesh, tfim_problem):
    """Plain jitted cheby_apply on a GSPMD-sharded state (no shard_map)
    must also be correct — the zero-effort sharding path."""
    import jax

    L, op, psi = tfim_problem
    from quantumpropagators.ops.cheby import cheby_apply, cheby_coeffs

    dense = np.asarray(to_dense(op))
    evals = np.linalg.eigvalsh(dense)
    e_min, delta = float(evals[0]), float(evals[-1] - evals[0])
    dt = 0.1
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))
    expected = cheby_apply(op, psi, coeffs, delta, e_min, dt)
    # convert the site term to grouped (better GSPMD behavior) and shard
    from quantumpropagators import Operator

    op_g = Operator([op.ops[0], op.ops[1].grouped(4)], op.coeffs)
    psi_sharded = shard_vector(mesh, psi)

    @jax.jit
    def step(o, v, a):
        return cheby_apply(o, v, a, delta, e_min, dt)

    got = step(op_g, psi_sharded, coeffs)
    assert np.allclose(np.asarray(got), np.asarray(expected), atol=1e-12)


def test_gspmd_sharded_newton(mesh, tfim_problem):
    """Newton propagation on a GSPMD-sharded state: the device Krylov
    work (matvecs + CGS2 + rank-k updates) auto-parallelizes; the host
    Leja/divided-difference logic is unchanged."""
    from quantumpropagators import Operator
    from quantumpropagators.ops.newton import newton_apply

    L, op, psi = tfim_problem
    dense = np.asarray(to_dense(op))
    from scipy.linalg import expm

    dt = 0.15
    exact = expm(-1j * dense * dt) @ np.asarray(psi)
    op_g = Operator([op.ops[0], op.ops[1].grouped(4)], op.coeffs)
    psi_sharded = shard_vector(mesh, psi)
    got = newton_apply(op_g, psi_sharded, dt, m_max=30)
    assert np.linalg.norm(np.asarray(got) - exact) < 1e-10


@pytest.mark.parametrize("form", ["site_sum", "prepared"])
@pytest.mark.parametrize("field", ["uniform", "per_site"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_step_vs_one_device(n_devices, direction, field, form):
    """The sharded complex128 Chebyshev step on an ``n_devices`` mesh
    matches ``cheby_apply`` on one device to 1e-12: device-bit flips by
    ppermute exchange, the rest local; no reductions."""
    from quantumpropagators.models.lattice import SiteOperatorSum
    from quantumpropagators.ops.cheby import cheby_apply
    from quantumpropagators.parallel.sharded_chain import (
        prepare_sharded_operator,
    )

    L = 8
    H_diag, H_x = transverse_field_ising(L, J=1.0, g=1.2, h=0.3)
    if field == "per_site":
        gs = np.linspace(0.6, 1.4, L)
        sx = np.array([[0.0, 1.0], [1.0, 0.0]])
        H_x = SiteOperatorSum(jnp.asarray(gs[:, None, None] * sx), L=L)
    op = qp.Operator([H_diag, H_x], np.array([1.0]))
    bound = 1.0 * (L - 1) + 0.3 * L + 1.4 * L
    delta, e_min = 2 * bound, -bound
    forward = direction == "forward"
    dt = 0.07 if forward else -0.07
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))
    psi = jnp.asarray(random_state_vector(2 ** L,
                                          rng=np.random.default_rng(5)))
    expected = cheby_apply(op, psi, coeffs, delta, e_min, dt,
                           forward=forward)

    mesh = chain_mesh(n_devices)
    op_sh = prepare_sharded_operator(op, n_devices) if form == "prepared" \
        else op
    step = make_sharded_cheby_step(mesh, op_sh, delta=delta, e_min=e_min,
                                   dt=dt, forward=forward)
    got = step(op_sh, shard_vector(mesh, psi), replicate(mesh, coeffs))
    assert np.abs(np.asarray(got) - np.asarray(expected)).max() < 1e-12
    assert len({s.device for s in got.addressable_shards}) == n_devices
