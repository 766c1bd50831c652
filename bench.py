"""Benchmark of the complex128 propagation paths on one NVIDIA GPU.

Runs the BASELINE configurations in one process and prints one JSON
line per configuration to stdout (diagnostics go to stderr)::

    python bench.py                      # all configurations
    python bench.py --config chain --L 20
    python bench.py --config lattice --lattice 4x6

Configurations: ``rabi`` (config 1, 100-step latency), ``transmon``
(config 2, Newton vs Chebyshev), ``newton`` (N=1024 sparse Hermitian,
restarted Arnoldi), ``optomech`` (config 3, BSR vs CSR apply and the
Krylov methods), ``chain`` and ``lattice`` (configs 4/5 family: the
transverse-field Ising model through the fused complex128 XLA scan).

Every line names the device (platform, ``device_kind``, count) and the
card's power limit.  Times are host-clock intervals that end in
``block_until_ready``, after a warm-up call that compiles.  The script
refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Published peak HBM bandwidth per device_kind (NVIDIA H100 SXM data
# sheet).  A device that is not listed has no roofline share.
PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

_DEVICE = {}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def emit(metric: str, value, unit: str, **extra):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **_DEVICE, "extra": extra}), flush=True)


def timed(fn, reps: int = 1):
    """Seconds per call of ``fn`` after one warm-up (compiling) call:
    ``(result, first_call_s, steady_s)``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    return out, first, (time.perf_counter() - t0) / reps


def bench_rabi():
    """Config 1: 100 steps of a driven two-level system, step-wise
    (one dispatch per step) and as one fused scan."""
    import jax.numpy as jnp

    import quantumpropagators as qp

    sz = jnp.asarray([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    sx = jnp.asarray([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    gen = qp.hamiltonian(0.5 * sz, (sx, lambda t: 0.5 * np.cos(0.2 * t)))
    n_steps = 100
    tlist = np.linspace(0.0, 0.1 * n_steps, n_steps + 1)
    psi0 = jnp.asarray([1.0, 0.0], dtype=complex)
    _, first, steady = timed(
        lambda: qp.propagate(psi0, gen, tlist, method="cheby"), reps=5)
    _, first_f, steady_f = timed(
        lambda: qp.propagate(psi0, gen, tlist, method="cheby", fused=True),
        reps=5)
    log(f"rabi: {n_steps / steady:.1f} steps/s step-wise, "
        f"{n_steps / steady_f:.1f} steps/s fused")
    emit("rabi_cheby_steps", n_steps / steady, "steps/s",
         n_steps=n_steps, fused_steps_per_s=n_steps / steady_f,
         first_call_s=first, fused_first_call_s=first_f)


def bench_transmon():
    """Config 2: driven transmon, N=10; Newton vs Chebyshev matvec
    counts and steps/s, each checked against ``expm``."""
    import jax.numpy as jnp

    import quantumpropagators as qp
    from chip_smoke import pwc_expm_reference, transmon_system
    from quantumpropagators.utils.timings import (
        disable_timings, enable_timings,
    )

    gen, tlist, psi0, H0, Hd, eps = transmon_system()
    ref = pwc_expm_reference(psi0, H0, Hd, eps, tlist)
    n_steps = len(tlist) - 1
    out = {}
    enable_timings()
    try:
        for method, kw in (("cheby", {}), ("newton", {"m_max": 8})):
            def run():
                prop = qp.init_prop(jnp.asarray(psi0), gen, tlist,
                                    method=method, **kw)
                while qp.prop_step(prop) is not None:
                    pass
                return prop

            timed(lambda: run().state)
            prop = run()  # counters of one clean propagation
            _, _, steady = timed(lambda: run().state)
            err = float(np.abs(np.asarray(prop.state) - ref).max())
            out[method] = dict(
                matvecs=int(prop.timing_data.counters.get("matvec", 0)),
                steps_per_s=n_steps / steady, err_vs_expm=err)
            log(f"transmon {method}: {out[method]}")
    finally:
        disable_timings()
    emit("transmon_newton_matvecs_per_100_steps", out["newton"]["matvecs"],
         "matvecs", cheby=out["cheby"], newton=out["newton"])


def bench_newton():
    """N=1024 sparse Hermitian with spectral radius 10 (reference
    ``test/test_newton.jl``), 20 restarted-Arnoldi Newton steps."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from scipy.linalg import expm

    from quantumpropagators.ops.newton import NewtonInfo, newton_apply
    from quantumpropagators.ops.operators import bsr_from_scipy

    N, dt, n_steps = 1024, 0.5, 20
    rng = np.random.default_rng(42)
    A = sp.random(N, N, density=0.01, random_state=rng,
                  data_rvs=rng.standard_normal)
    H = (0.5 * (A + A.T)).tocsr()
    H = H * (10.0 / np.abs(np.linalg.eigvalsh(H.toarray())).max())
    op = bsr_from_scipy(H, block_size=32)
    psi0 = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    psi0 /= np.linalg.norm(psi0)
    info = NewtonInfo()

    def run():
        psi = jnp.asarray(psi0)
        for _ in range(n_steps):
            psi = newton_apply(op, psi, dt, m_max=10, info=info)
        return psi

    timed(run)
    info = NewtonInfo()
    out = run()
    matvecs_per_step = info.matvecs / n_steps
    _, _, steady = timed(run)
    exact = np.linalg.matrix_power(expm(-1j * H.toarray() * dt), n_steps)
    err = float(np.abs(np.asarray(out) - exact @ psi0).max())
    log(f"newton: {n_steps / steady:.2f} steps/s, err {err:.2e}")
    emit("newton_restarted_arnoldi_steps", n_steps / steady, "steps/s",
         dim=N, n_steps=n_steps, matvecs_per_step=matvecs_per_step,
         err_vs_expm=err)


def bench_optomech():
    """Config 3: 55-dim optomech cavity.  BSR vs CSR apply throughput on
    a batch of complex128 states, and Chebyshev/Newton/expv against
    ``expm``."""
    import jax
    import jax.numpy as jnp

    import quantumpropagators as qp
    from chip_smoke import optomech_system, pwc_expm_reference
    from quantumpropagators.ops.operators import (
        apply, bsr_from_scipy, csr_from_scipy,
    )

    gen, tlist, psi0, H0, H_int, eps = optomech_system()
    Hs = (H0 + H_int).tocsr()
    batch, n_apply = 4096, 100
    rng = np.random.default_rng(0)
    states = jnp.asarray(rng.standard_normal((batch, Hs.shape[0]))
                         + 1j * rng.standard_normal((batch, Hs.shape[0])))
    rates = {}
    for name, op in (("bsr", bsr_from_scipy(Hs, block_size=8)),
                     ("csr", csr_from_scipy(Hs))):
        @jax.jit
        def run(op, v):
            return jax.lax.scan(lambda v, _: (apply(op, v), None), v, None,
                                length=n_apply)[0]

        _, _, steady = timed(lambda: run(op, states), reps=3)
        rates[name] = n_apply * batch * Hs.nnz / steady / 1e9
    ref = pwc_expm_reference(psi0, H0, H_int, eps, tlist)
    errs = {}
    for method, kw in (("cheby", {}), ("newton", {"m_max": 20}),
                       ("expv", {"m_max": 30})):
        psi = qp.propagate(jnp.asarray(psi0), gen, tlist, method=method, **kw)
        errs[method] = float(np.abs(np.asarray(psi) - ref).max())
    log(f"optomech: {rates}, errors {errs}")
    emit("optomech_bsr_apply_throughput", rates["bsr"], "Gnnz/s",
         csr_gnnz_per_s=rates["csr"], batch=batch, nnz=int(Hs.nnz),
         err_vs_expm=errs)


def bytes_per_order(n: int) -> int:
    """Bytes one Chebyshev order must move at the least, complex128:
    read v0, v1 and phi, write v2 and phi (16 B each), read the real
    diagonal (8 B).  Passes of the site operator beyond the first read
    of v1 are not counted, so this is a lower bound."""
    return n * (5 * 16 + 8)


def bench_tfim(L: int, label: str, build, n_steps: int):
    """The transverse-field Ising model through the fused complex128
    scan (``cheby_propagate_fused``), ``n_steps`` steps of dt=0.05."""
    import jax

    import quantumpropagators as qp
    from quantumpropagators.fused import cheby_propagate_fused

    H_diag, H_x, bound = build()
    op = qp.Operator([H_diag, H_x.grouped()], np.array([1.0]))
    n = 2 ** L
    psi0 = jax.random.normal(jax.random.key(1), (n,), dtype=complex)
    psi0 = psi0 / jax.numpy.linalg.norm(psi0)
    tlist = np.linspace(0.0, 0.05 * n_steps, n_steps + 1)
    prop = qp.init_prop(psi0, op, tlist, method="cheby",
                        specrange_method="manual", E_min=-bound,
                        E_max=bound)

    def run():
        return cheby_propagate_fused(psi0, op, tlist, workspace=prop.wrk)[0]

    psi, first, steady = timed(run, reps=3)
    orders = prop.wrk.coeffs.shape[0] - 1
    step_s = steady / n_steps
    gbps = bytes_per_order(n) * orders / step_s / 1e9
    peak = PEAK_HBM_BYTES_PER_S.get(_DEVICE["device"]["kind"])
    drift = abs(float(jax.numpy.linalg.norm(psi)) - 1.0)
    log(f"{label}: {1e3 * step_s:.3f} ms/step, {orders} orders, "
        f"{gbps:.1f} GB/s, norm drift {drift:.2e}")
    emit(f"tfim_{label}_cheby_step", 1e3 * step_s, "ms/step",
         n=n, n_steps=n_steps, orders_per_step=orders,
         ms_per_order=1e3 * step_s / orders,
         bytes_per_order_lower_bound=bytes_per_order(n),
         achieved_gb_per_s=gbps,
         hbm_roofline_share=None if peak is None else gbps * 1e9 / peak,
         first_call_s=first, norm_drift=drift)


def chain_builder(L: int):
    def build():
        import quantumpropagators as qp

        H_diag, H_x = qp.transverse_field_ising(L, J=1.0, g=1.2, h=0.3)
        return H_diag, H_x, 1.0 * (L - 1) + 0.3 * L + 1.2 * L

    return build


def lattice_builder(Lx: int, Ly: int):
    def build():
        import quantumpropagators as qp

        H_diag, H_x = qp.transverse_field_ising_2d(Lx, Ly, J=1.0, g=1.2,
                                                   h=0.3)
        L = Lx * Ly
        n_bonds = (Lx - 1) * Ly + Lx * (Ly - 1)
        return H_diag, H_x, 1.0 * n_bonds + 0.3 * L + 1.2 * L

    return build


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("rabi", "transmon", "newton",
                                         "optomech", "chain", "lattice"),
                    help="run one configuration (default: all)")
    ap.add_argument("--L", type=int, default=None,
                    help="chain length for --config chain (default 20 "
                         "and 24)")
    ap.add_argument("--lattice", default="4x6", help="Lx x Ly")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from chip_smoke import gpu_name_and_power
    from quantumpropagators.config import use_compile_cache

    use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX platform {dev.platform!r})")
    _DEVICE["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
    _DEVICE["gpu"] = gpu_name_and_power()
    log(f"device: {_DEVICE}")

    Lx, Ly = (int(v) for v in args.lattice.lower().split("x"))
    chains = [args.L] if args.L else [20, 24]
    runs = {
        "rabi": [bench_rabi],
        "transmon": [bench_transmon],
        "newton": [bench_newton],
        "optomech": [bench_optomech],
        "chain": [
            lambda L=L: bench_tfim(L, f"chain_2^{L}", chain_builder(L),
                                   args.steps)
            for L in chains
        ],
        "lattice": [
            lambda: bench_tfim(Lx * Ly, f"lattice_{Lx}x{Ly}",
                               lattice_builder(Lx, Ly), args.steps)
        ],
    }
    for name, fns in runs.items():
        if args.config in (None, name):
            for fn in fns:
                fn()


if __name__ == "__main__":
    main()
