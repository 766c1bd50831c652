"""df64 Krylov toolkit (ops/dd_linalg.py): compensated reductions, dd
operators, dd Arnoldi, and the dd Newton/expv kernels — the float64-free
path to the reference's 1e-10 Krylov contract
(``test/test_newton.jl:20``; VERDICT r4 item 1).

Everything here runs on f32 PLANES regardless of x64 being enabled:
the tests validate genuine double-float accuracy, not float64
fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

from quantumpropagators.ops.dd_linalg import (
    CDDOp,
    DenseDDOp,
    TermsDDOp,
    apply_cdd_op,
    arnoldi_dd,
    cdd_dot,
    cdd_norm,
    cdd_op_from_matrix,
    dd_div,
    dd_sqrt,
    dd_sum,
    dense_dd_from_numpy,
)
from quantumpropagators.ops.df64 import CDD, DD, cdd_from_c128, cdd_to_c128
from quantumpropagators.ops.expv import expv_apply_dd
from quantumpropagators.ops.newton import (
    NewtonInfo,
    _split_c128_planes,
    newton_apply_dd,
)


def _dd_f64(x: DD):
    return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)


def _cdd_f64(x: CDD):
    return _dd_f64(x.re) + 1j * _dd_f64(x.im)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_dd_sum_large_dynamic_range():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096) * np.exp(rng.normal(size=4096) * 4)
    xd = cdd_from_c128(x)
    got = float(_dd_f64(dd_sum(xd.re)))
    # compare against the f64 sum of the dd-ROUNDED inputs (dd carries
    # ~2^-48 per element; the original f64 x is not representable)
    want = np.sum(cdd_to_c128(xd).real)
    # a few dd ulps at the accumulator magnitude
    assert abs(got - want) / np.abs(x).sum() < 1e-14


def test_cdd_dot_and_norm():
    rng = np.random.default_rng(1)
    N = 2048
    x = rng.normal(size=N) + 1j * rng.normal(size=N)
    y = rng.normal(size=N) + 1j * rng.normal(size=N)
    xd, yd = cdd_from_c128(x), cdd_from_c128(y)
    x64, y64 = cdd_to_c128(xd), cdd_to_c128(yd)
    got = complex(_cdd_f64(CDD(*cdd_dot(xd, yd))))
    want = np.vdot(x64, y64)
    assert abs(got - want) / abs(want) < 1e-13
    got_n = float(_dd_f64(cdd_norm(xd)))
    assert abs(got_n - np.linalg.norm(x64)) / got_n < 1e-14


def test_dd_sqrt_div():
    for v in (2.0, 3.14159, 1e-6, 123456.789):
        x = DD(jnp.float32(v), jnp.float32(np.float64(v) - np.float32(v)))
        s = dd_sqrt(x)
        assert abs(float(_dd_f64(s)) - np.sqrt(np.float64(np.float32(v)) +
                   (np.float64(v) - np.float64(np.float32(v))))) < 1e-13 * max(1, v)
    a = DD(jnp.float32(1.0), jnp.float32(0.0))
    b = DD(jnp.float32(7.0), jnp.float32(0.0))
    q = dd_div(a, b)
    assert abs(float(_dd_f64(q)) - 1.0 / 7.0) < 1e-15


# ---------------------------------------------------------------------------
# dd operators
# ---------------------------------------------------------------------------


def test_dense_complex_apply():
    rng = np.random.default_rng(2)
    N = 96
    M = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    op = dense_dd_from_numpy(M)
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    vd = cdd_from_c128(v)
    got = _cdd_f64(apply_cdd_op(op, vd))
    want = M @ cdd_to_c128(vd)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


def test_cdd_op_sparse_complex_apply():
    rng = np.random.default_rng(3)
    N = 320
    A = sp.random(N, N, density=0.05, random_state=7)
    A = (A + 1j * sp.random(N, N, density=0.05, random_state=8)).tocsr()
    op = cdd_op_from_matrix(A, sparse=True, block_size=8)
    assert isinstance(op, CDDOp) and op.im is not None
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    vd = cdd_from_c128(v)
    got = _cdd_f64(apply_cdd_op(op, vd))[:N]
    want = A @ cdd_to_c128(vd)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / scale < 1e-12


def test_terms_op_zero_retrace_coeffs():
    rng = np.random.default_rng(4)
    N = 64
    H0 = rng.normal(size=(N, N))
    H1 = rng.normal(size=(N, N))
    terms = (dense_dd_from_numpy(H0), dense_dd_from_numpy(H1))
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    vd = cdd_from_c128(v)
    for c in (0.3, -1.7):
        op = TermsDDOp(
            terms=terms,
            coeffs4=_split_c128_planes(np.array([c], np.complex128)),
            shape=(N, N),
        )
        got = _cdd_f64(apply_cdd_op(op, vd))
        want = (H0 + c * H1) @ cdd_to_c128(vd)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


# ---------------------------------------------------------------------------
# dd Arnoldi
# ---------------------------------------------------------------------------


def test_arnoldi_dd_orthonormal_hessenberg():
    rng = np.random.default_rng(5)
    N, m = 128, 15
    M = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    H = M + M.conj().T
    op = dense_dd_from_numpy(H)
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    v /= np.linalg.norm(v)
    vd = cdd_from_c128(v)
    Hs, q, m_eff = arnoldi_dd(op, vd, m, 0.25)
    assert m_eff == m
    qq = np.stack([
        _cdd_f64(CDD(DD(q.re.hi[i], q.re.lo[i]), DD(q.im.hi[i], q.im.lo[i])))
        for i in range(m)
    ])
    orth = qq @ qq.conj().T - np.eye(m)
    assert np.abs(orth).max() < 1e-13
    Hrec = qq.conj() @ (0.25 * H @ qq.T)
    assert np.abs(Hrec - Hs[:m, :m]).max() / np.abs(Hs[:m, :m]).max() < 1e-12


def test_arnoldi_dd_breakdown_eigenvector():
    rng = np.random.default_rng(6)
    N = 48
    M = rng.normal(size=(N, N))
    H = M + M.T
    w, V = np.linalg.eigh(H)
    op = dense_dd_from_numpy(H)
    Hs, q, m_eff = arnoldi_dd(op, cdd_from_c128(V[:, 3] + 0j), 8, 0.5)
    assert m_eff == 1
    assert abs(Hs[0, 0] / 0.5 - w[3]) < 1e-11


# ---------------------------------------------------------------------------
# dd Newton: the reference's own test configurations at 1e-10
# (test/test_newton.jl:7-67, :70-127, :130-177), on f32 planes
# ---------------------------------------------------------------------------


def _random_spectral(N, rng, *, hermitian, radius=10.0):
    M = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    if hermitian:
        M = M + M.conj().T
        M *= radius / np.max(np.abs(np.linalg.eigvalsh(M)))
    else:
        M *= radius / np.max(np.abs(np.linalg.eigvals(M)))
    return M


def test_newton_dd_hermitian_1000():
    rng = np.random.default_rng(7)
    N = 1000
    H = _random_spectral(N, rng, hermitian=True)
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi /= np.linalg.norm(psi)
    info = NewtonInfo()
    out = newton_apply_dd(H, psi, 0.5, m_max=5, max_restarts=200,
                          relerr=1e-12, info=info)
    got = _cdd_f64(out)
    want = scipy.linalg.expm(-0.5j * H) @ cdd_to_c128(cdd_from_c128(psi))
    assert np.abs(got - want).max() < 1e-10
    assert info.restarts > 1  # m_max=5 forces restarting


def test_newton_dd_nonhermitian():
    rng = np.random.default_rng(8)
    N = 512
    A = _random_spectral(N, rng, hermitian=False)
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi /= np.linalg.norm(psi)
    out = newton_apply_dd(A, psi, 0.5, m_max=50, relerr=1e-12)
    got = _cdd_f64(out)
    want = scipy.linalg.expm(-0.5j * A) @ cdd_to_c128(cdd_from_c128(psi))
    assert np.abs(got - want).max() < 1e-10


def test_newton_dd_sparse_func_exp():
    """Sparse complex operator with func=exp(z) — the Liouvillian
    pattern (test/test_newton.jl:130-177)."""
    rng = np.random.default_rng(9)
    N = 256
    A = sp.random(N, N, density=0.2, random_state=10).toarray()
    A = A + 1j * sp.random(N, N, density=0.2, random_state=11).toarray()
    A = np.asarray(A)
    A *= 4.0 / np.max(np.abs(np.linalg.eigvals(A)))
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi /= np.linalg.norm(psi)
    out = newton_apply_dd(
        sp.csr_matrix(A), psi, 0.5, m_max=40,
        func=lambda z: np.exp(z), relerr=1e-12,
    )
    got = _cdd_f64(out)
    want = scipy.linalg.expm(0.5 * A) @ cdd_to_c128(cdd_from_c128(psi))
    assert np.abs(got - want).max() < 1e-10


def test_newton_dd_eigenvector_shortcircuit():
    rng = np.random.default_rng(10)
    N = 32
    M = rng.normal(size=(N, N))
    H = M + M.T
    w, V = np.linalg.eigh(H)
    out = newton_apply_dd(H, V[:, 5] + 0j, 0.7, m_max=6)
    got = _cdd_f64(out)
    want = np.exp(-0.7j * w[5]) * V[:, 5]
    assert np.abs(got - want).max() < 1e-11


# ---------------------------------------------------------------------------
# dd expv
# ---------------------------------------------------------------------------


def test_expv_dd_fixed_m():
    rng = np.random.default_rng(11)
    N = 400
    H = _random_spectral(N, rng, hermitian=True, radius=4.0)
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi /= np.linalg.norm(psi)
    out = expv_apply_dd(H, psi, 0.4, m=40)
    got = _cdd_f64(out)
    want = scipy.linalg.expm(-0.4j * H) @ cdd_to_c128(cdd_from_c128(psi))
    assert np.abs(got - want).max() < 1e-10


def test_expv_dd_error_estimate_mode():
    rng = np.random.default_rng(12)
    N = 300
    A = _random_spectral(N, rng, hermitian=False, radius=3.0)
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi /= np.linalg.norm(psi)
    out = expv_apply_dd(A, psi, 0.5, m=8, tol=1e-12, m_max=96)
    got = _cdd_f64(out)
    want = scipy.linalg.expm(-0.5j * A) @ cdd_to_c128(cdd_from_c128(psi))
    assert np.abs(got - want).max() < 1e-10


# ---------------------------------------------------------------------------
# propagator integration: precision='dd'
# ---------------------------------------------------------------------------


def test_newton_propagator_dd_vs_cheby():
    """Driven system: method='newton' at precision='dd' agrees with the
    Chebyshev propagator at 1e-10 (the optomech/transmon cross-method
    pattern, test/test_propagate.jl:153-163) — dd planes end to end."""
    import quantumpropagators as qp

    rng = np.random.default_rng(13)
    N = 64
    M0 = rng.normal(size=(N, N))
    M1 = rng.normal(size=(N, N))
    H0 = jnp.asarray(M0 + M0.T, dtype=complex)
    H1 = jnp.asarray(0.3 * (M1 + M1.T), dtype=complex)
    gen = qp.hamiltonian(H0, (H1, lambda t: np.sin(2 * t)))
    tlist = np.linspace(0, 0.5, 21)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    psi0 = jnp.asarray(psi0)
    ref = qp.propagate(psi0, gen, tlist, method="cheby")
    prop = qp.init_prop(psi0, gen, tlist, method="newton",
                        precision="dd", m_max=16)
    assert prop.precision == "dd"
    from quantumpropagators.propagate import propagate_propagator
    out = propagate_propagator(prop)
    got = _cdd_f64(prop.state_dd)
    assert np.abs(got - np.asarray(ref)).max() < 1e-10


def test_krylov_propagator_dd_vs_cheby():
    import quantumpropagators as qp

    rng = np.random.default_rng(14)
    N = 48
    M0 = rng.normal(size=(N, N))
    H0 = jnp.asarray(M0 + M0.T, dtype=complex)
    gen = qp.hamiltonian(H0)
    tlist = np.linspace(0, 0.4, 9)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    psi0 = jnp.asarray(psi0)
    ref = qp.propagate(psi0, gen, tlist, method="cheby")
    prop = qp.init_prop(psi0, gen, tlist, method="expv",
                        precision="dd", m_max=24)
    from quantumpropagators.propagate import propagate_propagator
    propagate_propagator(prop)
    got = _cdd_f64(prop.state_dd)
    assert np.abs(got - np.asarray(ref)).max() < 1e-10


# ---------------------------------------------------------------------------
# sharded dd reductions + Arnoldi on the 8-device mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    from quantumpropagators.parallel.mesh import chain_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return chain_mesh(8)


def test_sharded_cdd_dot(mesh):
    """Cross-device dd dot: per-shard compensated partials gathered and
    reduced in dd — matches f64 at the dd epsilon (a plain psum of the
    hi planes would round at 2^-24)."""
    from jax.sharding import PartitionSpec as P

    from quantumpropagators.parallel.mesh import STATE_AXIS, shard_vector

    rng = np.random.default_rng(15)
    N = 2048
    x = rng.normal(size=N) + 1j * rng.normal(size=N)
    y = rng.normal(size=N) + 1j * rng.normal(size=N)
    xd, yd = cdd_from_c128(x), cdd_from_c128(y)
    want = np.vdot(cdd_to_c128(xd), cdd_to_c128(yd))

    def fn(xrh, xrl, xih, xil, yrh, yrl, yih, yil):
        xs = CDD(DD(xrh, xrl), DD(xih, xil))
        ys = CDD(DD(yrh, yrl), DD(yih, yil))
        d = cdd_dot(xs, ys, axis_name=STATE_AXIS)
        return d.re.hi, d.re.lo, d.im.hi, d.im.lo

    parts = [xd.re.hi, xd.re.lo, xd.im.hi, xd.im.lo,
             yd.re.hi, yd.re.lo, yd.im.hi, yd.im.lo]
    out = jax.jit(
        jax.shard_map(
            fn, mesh=mesh, in_specs=(P(STATE_AXIS),) * 8,
            out_specs=(P(),) * 4, check_vma=False,
        )
    )(*[shard_vector(mesh, p) for p in parts])
    got = (np.float64(out[0]) + np.float64(out[1])) + 1j * (
        np.float64(out[2]) + np.float64(out[3])
    )
    assert abs(got - want) / abs(want) < 1e-13


def test_sharded_arnoldi_dd(mesh):
    """arnoldi_dd inside shard_map over a block-partitioned dd BSR
    operator: matvec = banded halo exchange, dots = dd-gathered
    reductions — the multi-chip Krylov building block."""
    from jax.sharding import PartitionSpec as P

    from quantumpropagators.parallel.mesh import STATE_AXIS, shard_vector
    from quantumpropagators.parallel.sharded_bsr import (
        PartitionedBSRdd,
        banded_bsr_apply_dd,
        partition_bsr_dd,
    )

    rng = np.random.default_rng(16)
    R, b = 32, 8
    N = R * b
    A = sp.diags(
        [rng.normal(size=N - 1), rng.normal(size=N),
         rng.normal(size=N - 1)], [-1, 0, 1],
    ).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    pb = partition_bsr_dd(A, 8, block_size=b)
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    v /= np.linalg.norm(v)
    vd = cdd_from_c128(v)
    m = 10

    meta = dict(
        halo_blocks=pb.halo_blocks,
        n_block_rows_local=pb.n_block_rows_local,
        n_devices=pb.n_devices,
        block_size=pb.block_size,
        shape=pb.shape,
    )
    spec = PartitionedBSRdd(
        blocks_hi=P(STATE_AXIS), blocks_lo=P(STATE_AXIS),
        cols=P(STATE_AXIS), **meta,
    )

    def fn(p, rh, rl, ih, il):
        p_local = PartitionedBSRdd(
            blocks_hi=p.blocks_hi[0], blocks_lo=p.blocks_lo[0],
            cols=p.cols[0], **meta,
        )

        def op(z):
            return CDD(
                banded_bsr_apply_dd(p_local, z.re),
                banded_bsr_apply_dd(p_local, z.im),
            )

        psi = CDD(DD(rh, rl), DD(ih, il))
        Hess, q, m_eff = arnoldi_dd(
            op, psi, m, 0.3, axis_name=STATE_AXIS
        )
        return (Hess.re.hi, Hess.re.lo, Hess.im.hi, Hess.im.lo,
                q.re.hi, q.re.lo, q.im.hi, q.im.lo)

    out = jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(spec,) + (P(STATE_AXIS),) * 4,
            out_specs=(P(),) * 4 + (P(None, STATE_AXIS),) * 4,
            check_vma=False,
        )
    )(pb, *[shard_vector(mesh, p)
            for p in (vd.re.hi, vd.re.lo, vd.im.hi, vd.im.lo)])
    Hs = (np.asarray(out[0], np.float64) + np.asarray(out[1], np.float64)
          ) + 1j * (np.asarray(out[2], np.float64) +
                    np.asarray(out[3], np.float64))
    qq = np.stack([
        (np.asarray(out[4][i], np.float64) + np.asarray(out[5][i], np.float64))
        + 1j * (np.asarray(out[6][i], np.float64) +
                np.asarray(out[7][i], np.float64))
        for i in range(m)
    ])
    orth = qq @ qq.conj().T - np.eye(m)
    assert np.abs(orth).max() < 1e-13
    Hrec = qq.conj() @ (0.3 * A.toarray() @ qq.T)
    assert np.abs(Hrec - Hs[:m, :m]).max() / np.abs(Hs[:m, :m]).max() < 1e-12


# ---------------------------------------------------------------------------
# fixed-Leja device-driven Newton (ops/newton_leja.py)
# ---------------------------------------------------------------------------


def test_newton_leja_plan_certified_error():
    from quantumpropagators.ops.newton_leja import newton_leja_plan

    plan = newton_leja_plan(-12.0, 12.0, 0.25, tol=1e-13)
    assert plan.sup_error < 1e-13
    # wider spectrum needs more nodes
    plan2 = newton_leja_plan(-48.0, 48.0, 0.25, tol=1e-13)
    assert len(plan2.points) > len(plan.points)


def test_newton_leja_propagate_driven_vs_oracle():
    """The whole driven propagation as ONE compiled scan matches the
    per-interval expm oracle at 1e-11 — the device-driven Newton
    replacing per-step host restarts (VERDICT r4 item 4)."""
    import quantumpropagators as qp
    from quantumpropagators.models.controls import discretize_on_midpoints
    from quantumpropagators.ops.newton_leja import newton_leja_propagate_dd

    rng = np.random.default_rng(22)
    N = 48
    M0 = rng.normal(size=(N, N))
    H0 = M0 + M0.T
    M1 = rng.normal(size=(N, N))
    H1 = 0.3 * (M1 + M1.T)
    ctrl = lambda t: np.sin(2 * t)
    gen = qp.hamiltonian(
        jnp.asarray(H0, dtype=complex), (jnp.asarray(H1, dtype=complex), ctrl)
    )
    tlist = np.linspace(0, 1.0, 41)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    out, _, plan = newton_leja_propagate_dd(
        jnp.asarray(psi0), gen, tlist, tol=1e-13
    )
    assert plan.sup_error < 1e-13
    got = _cdd_f64(out)
    vals = discretize_on_midpoints(ctrl, tlist)
    psi = psi0.copy()
    for n in range(len(tlist) - 1):
        Hn = H0 + vals[n] * H1
        psi = scipy.linalg.expm(
            -1j * (tlist[n + 1] - tlist[n]) * Hn
        ) @ psi
    assert np.abs(got - psi).max() < 1e-11


def test_newton_leja_backward_roundtrip():
    import quantumpropagators as qp
    from quantumpropagators.ops.newton_leja import newton_leja_propagate_dd

    rng = np.random.default_rng(23)
    N = 32
    M0 = rng.normal(size=(N, N))
    gen = qp.hamiltonian(jnp.asarray(M0 + M0.T, dtype=complex))
    tlist = np.linspace(0, 0.8, 17)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    fwd, _, _ = newton_leja_propagate_dd(jnp.asarray(psi0), gen, tlist)
    back, _, _ = newton_leja_propagate_dd(
        jnp.asarray(_cdd_f64(fwd)), gen, tlist, backward=True
    )
    assert np.abs(_cdd_f64(back) - psi0).max() < 1e-11


def test_newton_leja_via_propagate_fused():
    """method='newton_leja' through the public propagate API (fused),
    incl. observable streaming."""
    import quantumpropagators as qp

    rng = np.random.default_rng(24)
    N = 32
    M0 = rng.normal(size=(N, N))
    gen = qp.hamiltonian(jnp.asarray(M0 + M0.T, dtype=complex))
    tlist = np.linspace(0, 0.6, 13)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    psi0 = jnp.asarray(psi0)
    ref = qp.propagate(psi0, gen, tlist, method="cheby")
    got = qp.propagate(psi0, gen, tlist, method="newton_leja",
                       fused=True)
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() < 1e-10
    n_op = jnp.asarray(np.diag(np.arange(N, dtype=float)), dtype=complex)
    store = qp.propagate(psi0, gen, tlist, method="newton_leja",
                         fused=True, storage=True, observables=[n_op])
    ref_store = qp.propagate(psi0, gen, tlist, method="cheby",
                             storage=True, observables=[n_op])
    assert store.shape == (len(tlist),)
    assert np.allclose(np.asarray(store), np.asarray(ref_store),
                       atol=1e-9)


def test_newton_dd_backward_roundtrip():
    """Backward dd Newton exactly reverses forward (the reference's
    backward-reverses-forward contract, test/test_propagate.jl:53-69)
    — in dd planes, 1e-11."""
    import quantumpropagators as qp
    from quantumpropagators.propagate import propagate_propagator

    rng = np.random.default_rng(25)
    N = 40
    M0 = rng.normal(size=(N, N))
    gen = qp.hamiltonian(jnp.asarray(M0 + M0.T, dtype=complex))
    tlist = np.linspace(0, 0.5, 11)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    psi0 = jnp.asarray(psi0)
    fwd = qp.init_prop(psi0, gen, tlist, method="newton",
                       precision="dd", m_max=16)
    propagate_propagator(fwd)
    fwd_state = _cdd_f64(fwd.state_dd)
    bwd = qp.init_prop(jnp.asarray(fwd_state), gen, tlist,
                       method="newton", precision="dd", m_max=16,
                       backward=True)
    propagate_propagator(bwd)
    assert np.abs(_cdd_f64(bwd.state_dd) - np.asarray(psi0)).max() < 1e-11


def test_dd_propagator_reinit_resets_state():
    """reinit on a dd propagator re-splits the new state into dd
    planes (set_state override)."""
    import quantumpropagators as qp
    from quantumpropagators.propagate import propagate_propagator

    rng = np.random.default_rng(26)
    N = 24
    M0 = rng.normal(size=(N, N))
    gen = qp.hamiltonian(jnp.asarray(M0 + M0.T, dtype=complex))
    tlist = np.linspace(0, 0.3, 7)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    psi0 = jnp.asarray(psi0)
    prop = qp.init_prop(psi0, gen, tlist, method="expv",
                        precision="dd", m_max=16)
    propagate_propagator(prop)
    first = _cdd_f64(prop.state_dd)
    qp.reinit_prop(prop, psi0)
    assert np.abs(_cdd_f64(prop.state_dd) - np.asarray(psi0)).max() < 1e-15
    propagate_propagator(prop)
    assert np.abs(_cdd_f64(prop.state_dd) - first).max() < 1e-13


def test_cheby_propagator_stepwise_dd():
    """Step-wise dd Chebyshev (precision='dd' on the host-loop path):
    driven system vs the per-interval expm oracle at 1e-11 in dd
    planes — callbacks/storage users get the reference tier too."""
    import quantumpropagators as qp
    from quantumpropagators.models.controls import discretize_on_midpoints
    from quantumpropagators.propagate import propagate_propagator

    rng = np.random.default_rng(27)
    N = 40
    M0 = rng.normal(size=(N, N))
    H0 = M0 + M0.T
    M1 = rng.normal(size=(N, N))
    H1 = 0.25 * (M1 + M1.T)
    ctrl = lambda t: np.sin(3 * t)
    gen = qp.hamiltonian(
        jnp.asarray(H0, dtype=complex),
        (jnp.asarray(H1, dtype=complex), ctrl),
    )
    tlist = np.linspace(0, 0.5, 11)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    prop = qp.init_prop(jnp.asarray(psi0), gen, tlist, method="cheby",
                        precision="dd")
    assert prop.precision == "dd"
    propagate_propagator(prop)
    got = _cdd_f64(prop.state_dd)
    vals = discretize_on_midpoints(ctrl, tlist)
    psi = psi0.copy()
    for n in range(len(tlist) - 1):
        Hn = H0 + vals[n] * H1
        psi = scipy.linalg.expm(
            -1j * (tlist[n + 1] - tlist[n]) * Hn
        ) @ psi
    assert np.abs(got - psi).max() < 1e-11
