"""Smoke test of the propagation main path on NVIDIA GPUs, in complex128.

Drives the public entry points (``propagate``, ``propagate(fused=True)``,
``init_prop``) at full size, checks every result against an independent
float64 reference, and prints one JSON line last::

    python chip_smoke.py           # one GPU: the phases below
    python chip_smoke.py --four    # four GPUs: the sharded path only

One GPU:

- ``cheby_step_2^20``: one Chebyshev step of a transverse-field Ising
  chain through ``propagate``, against the float64 NumPy Chebyshev
  oracle (gate 1e-10).
- ``chain_2^24``: the same chain at 2^24 over a 20-step grid, through
  ``propagate`` and ``propagate(fused=True)``; they agree to 1e-12, a
  forward-then-backward round trip returns to ``psi0`` to 1e-10, the
  norm drifts by at most 1e-12.
- ``transmon``/``optomech`` with ``newton`` and ``expv``: against
  ``scipy.linalg.expm`` of the piecewise-constant generator (1e-10),
  with ``precision="auto"`` resolving to ``native``.
- ``rabi``: 100 steps of a driven two-level system (latency case).

Four GPUs: the chain at 2^26 through the sharded Chebyshev step against
the same steps on one GPU (1e-12), and the banded block-sparse sharded
step at 2^24 rows against the float64 host oracle (1e-10).

Exits non-zero, before printing any result, when JAX finds no GPU or
this file is run outside the repository; exits non-zero when any gate
fails.  Diagnostics (dtype, error, compile and steady times, peak device
memory) are printed per phase; they are not benchmark results.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# transverse-field Ising chain of the benchmark family (bench.py)
J, G, H = 1.0, 1.2, 0.3
DT = 0.05


class Gate:
    """One checked quantity: ``value <= tol`` passes."""

    def __init__(self, name: str, value: float, tol: float):
        self.name, self.value, self.tol = name, float(value), float(tol)

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.tol)  # NaN fails

    def __str__(self):
        return (f"{self.name} {self.value:.3e} (tol {self.tol:.0e}) "
                f"{'ok' if self.ok else 'FAILED'}")


def _timed(fn):
    """``(result, seconds)`` of ``fn()``, waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _twice(fn):
    """Run ``fn`` cold, then warm: ``(result, first_s, steady_s)``.
    ``first_s - steady_s`` is the compilation (set-up) cost."""
    _, first = _timed(fn)
    out, steady = _timed(fn)
    return out, first, steady


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _maxabs(a, b) -> float:
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(jnp.asarray(a) - jnp.asarray(b))))


def _norm_drift(psi) -> float:
    import jax.numpy as jnp

    return abs(float(jnp.linalg.norm(psi)) - 1.0)


def _random_state(n: int, seed: int):
    """Normalized complex128 state, made on the default device."""
    import jax
    import jax.numpy as jnp

    psi = jax.random.normal(jax.random.key(seed), (n,), dtype=jnp.complex128)
    return psi / jnp.linalg.norm(psi)


def tfim(L: int, *, grouped: bool = True):
    """The chain through the public builders: ``(op, bound)``, with the
    analytic spectral bound ``|E| <= J(L-1) + |h|L + gL``."""
    import quantumpropagators as qp

    H_diag, H_x = qp.transverse_field_ising(L, J=J, g=G, h=H)
    op = qp.Operator([H_diag, H_x.grouped() if grouped else H_x],
                     np.array([1.0]))
    return op, J * (L - 1) + abs(H) * L + G * L


def _manual(bound: float) -> dict:
    return dict(specrange_method="manual", E_min=-bound, E_max=bound)


# ---- one GPU ---------------------------------------------------------------


def phase_cheby_step(L: int = 20, seed: int = 0) -> dict:
    """One Chebyshev step through ``propagate`` vs the float64 NumPy
    oracle of ``__graft_entry__`` (independent of the code under test)."""
    import quantumpropagators as qp
    from quantumpropagators.ops.cheby import cheby_coeffs

    from __graft_entry__ import _cheby_oracle_np, _tfim_matvec_np

    op, bound = tfim(L)
    psi0 = _random_state(2 ** L, seed)
    tlist = np.array([0.0, DT])
    psi1, first, steady = _twice(
        lambda: qp.propagate(psi0, op, tlist, method="cheby", **_manual(bound))
    )
    diag64 = np.asarray(op.ops[0].diag).real
    ref = _cheby_oracle_np(
        _tfim_matvec_np(diag64, G, L), np.asarray(psi0),
        cheby_coeffs(2 * bound, DT), 2 * bound, -bound, DT,
    )
    return dict(
        name=f"cheby_step_2^{L}", dtype=str(psi1.dtype),
        gates=[Gate("max|propagate - f64 oracle|",
                    np.abs(np.asarray(psi1) - ref).max(), 1e-10)],
        compile_s=first - steady, step_s=steady,
    )


def phase_chain(L: int = 24, n_steps: int = 20, seed: int = 1) -> dict:
    """``propagate`` and ``propagate(fused=True)`` over a grid: agreement,
    round trip and norm drift."""
    import quantumpropagators as qp

    op, bound = tfim(L)
    psi0 = _random_state(2 ** L, seed)
    tlist = np.linspace(0.0, n_steps * DT, n_steps + 1)
    kw = dict(method="cheby", **_manual(bound))
    psi_s, first_s, steady_s = _twice(
        lambda: qp.propagate(psi0, op, tlist, **kw)
    )
    psi_f, first_f, steady_f = _twice(
        lambda: qp.propagate(psi0, op, tlist, fused=True, **kw)
    )
    back = qp.propagate(psi_f, op, tlist, fused=True, backward=True, **kw)
    return dict(
        name=f"chain_2^{L}", dtype=f"{psi_s.dtype}/{psi_f.dtype}",
        gates=[
            Gate("max|propagate - fused|", _maxabs(psi_s, psi_f), 1e-12),
            Gate("max|round trip - psi0|", _maxabs(back, psi0), 1e-10),
            Gate("norm drift",
                 max(_norm_drift(psi_s), _norm_drift(psi_f)), 1e-12),
        ],
        compile_s=first_s - steady_s,
        step_s=steady_s / n_steps,
        extra=f"fused: compile {first_f - steady_f:.3f} s, "
              f"{1e3 * steady_f / n_steps:.3f} ms/step",
    )


def transmon_system():
    """BASELINE config 2: driven transmon ladder, N=10 levels (as in
    bench.py), in DIA storage."""
    import scipy.sparse as sp

    import quantumpropagators as qp

    N = 10
    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).tocsr()
    n_op = (a.T @ a).tocsr()
    H0 = (6.0 * n_op - 0.1 * (n_op @ (n_op - sp.identity(N)))).tocsr()
    Hd = (a + a.T).tocsr()
    eps = lambda t: 0.3 * float(np.cos(5.8 * t))
    gen = qp.hamiltonian(qp.dia_from_scipy(H0), (qp.dia_from_scipy(Hd), eps))
    psi0 = np.zeros(N, complex)
    psi0[0] = 1.0
    return gen, np.linspace(0.0, 10.0, 101), psi0, H0, Hd, eps


def optomech_system():
    """BASELINE config 3: 55-dim optomechanical cavity in CSR storage
    (reference ``test/optomech.jl``)."""
    import scipy.sparse as sp

    import quantumpropagators as qp

    def destroy(n):
        return sp.diags(np.sqrt(np.arange(1, n + 1)).astype(complex), 1)

    N_cav, N_mech = 4, 10
    a = sp.kron(destroy(N_cav), sp.identity(N_mech + 1), format="csr")
    b = sp.kron(sp.identity(N_cav + 1), destroy(N_mech), format="csr")
    at, bt = a.T.tocsr(), b.T.tocsr()
    H0 = (10.0 * (at @ a) + 2.0 * (a + at) + 10.0 * (bt @ b)).tocsr()
    H_int = (-1.0 * ((bt + b) @ (at @ a))).tocsr()
    eps = lambda t: float(np.sin(2 * np.pi * t / 5.0) ** 2)
    gen = qp.hamiltonian(qp.csr_from_scipy(H0), (qp.csr_from_scipy(H_int), eps))
    psi0 = np.zeros(H0.shape[0], complex)
    psi0[0] = 1.0
    return gen, np.linspace(0.0, 5.0, 251), psi0, H0, H_int, eps


def pwc_expm_reference(psi0, H0, H1, eps, tlist):
    """Host float64 ``Π expm(-i (H0 + eps(t_mid) H1) dt)`` psi0."""
    from scipy.linalg import expm

    import quantumpropagators as qp

    psi = np.asarray(psi0, dtype=np.complex128)
    H0d, H1d = H0.toarray(), H1.toarray()
    for n in range(len(tlist) - 1):
        Hn = H0d + eps(qp.t_mid(tlist, n)) * H1d
        psi = expm(-1j * (tlist[n + 1] - tlist[n]) * Hn) @ psi
    return psi


def phase_krylov(system: str, method: str) -> dict:
    """Newton or expv through ``propagate`` with ``precision="auto"``
    vs ``expm`` of the piecewise-constant generator."""
    import jax.numpy as jnp

    import quantumpropagators as qp

    build = {"transmon": transmon_system, "optomech": optomech_system}
    gen, tlist, psi0, H0, H1, eps = build[system]()
    m_max = {"newton": 20, "expv": 30}[method]
    seen = set()

    def run():
        return qp.propagate(
            jnp.asarray(psi0), gen, tlist, method=method, m_max=m_max,
            callback=lambda prop, _obs: seen.add(prop.precision),
        )

    psi, first, steady = _twice(run)
    ref = pwc_expm_reference(psi0, H0, H1, eps, tlist)
    n_steps = len(tlist) - 1
    return dict(
        name=f"{system}_{method}", dtype=str(psi.dtype),
        gates=[
            Gate("max|propagate - expm|",
                 np.abs(np.asarray(psi) - ref).max(), 1e-10),
            Gate("precision resolved to native (0 = yes)",
                 0.0 if seen == {"native"} else 1.0, 0.0),
        ],
        compile_s=first - steady, step_s=steady / n_steps,
        extra=f"precision={sorted(seen)}",
    )


def phase_rabi(n_steps: int = 100) -> dict:
    """BASELINE config 1: driven two-level system, ``n_steps`` steps
    through ``propagate`` (latency: one dispatch per step)."""
    import scipy.sparse as sp

    import jax.numpy as jnp

    import quantumpropagators as qp

    sz = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    eps = lambda t: 0.5 * float(np.cos(0.2 * t))
    H0, H1 = 0.5 * sz, sx
    gen = qp.hamiltonian(jnp.asarray(H0), (jnp.asarray(H1), eps))
    tlist = np.linspace(0.0, 0.1 * n_steps, n_steps + 1)
    psi0 = np.array([1.0, 0.0], dtype=complex)
    psi, first, steady = _twice(
        lambda: qp.propagate(jnp.asarray(psi0), gen, tlist, method="cheby")
    )
    ref = pwc_expm_reference(
        psi0, sp.csr_matrix(H0), sp.csr_matrix(H1), eps, tlist
    )
    return dict(
        name="rabi", dtype=str(psi.dtype),
        gates=[Gate("max|propagate - expm|",
                    np.abs(np.asarray(psi) - ref).max(), 1e-10)],
        compile_s=first - steady, step_s=steady / n_steps,
        extra=f"{n_steps / steady:.1f} steps/s",
    )


def one_gpu_phases(seed: int = 0):
    return [
        lambda: phase_cheby_step(20, seed),
        lambda: phase_chain(24, 20, seed + 1),
        lambda: phase_krylov("transmon", "newton"),
        lambda: phase_krylov("transmon", "expv"),
        lambda: phase_krylov("optomech", "newton"),
        lambda: phase_krylov("optomech", "expv"),
        lambda: phase_rabi(100),
    ]


# ---- four GPUs ---------------------------------------------------------------


def _sharding_gates(out, n_dev: int) -> list:
    """The result spans ``n_dev`` devices and each holds only its shard."""
    shards = out.addressable_shards
    devices = {s.device for s in shards}
    n = out.shape[0]
    wrong = sum(s.data.shape[0] != n // n_dev for s in shards)
    return [
        Gate("devices missing from the output sharding",
             n_dev - len(devices), 0),
        Gate("shards not of size N/devices", wrong, 0),
    ]


def phase_sharded_chain(L: int = 26, n_dev: int = 4, n_steps: int = 3,
                        seed: int = 2) -> dict:
    """``make_sharded_cheby_step`` over ``chain_mesh(n_dev)`` vs the same
    steps of ``cheby_apply`` on one device."""
    import jax

    from quantumpropagators.ops.cheby import cheby_apply, cheby_coeffs
    from quantumpropagators.parallel.mesh import (
        chain_mesh, replicate, shard_vector,
    )
    from quantumpropagators.parallel.sharded_chain import (
        make_sharded_cheby_step, prepare_sharded_operator,
    )

    mesh = chain_mesh(n_dev)
    op, bound = tfim(L, grouped=False)
    delta, e_min = 2 * bound, -bound
    coeffs = jax.numpy.asarray(cheby_coeffs(delta, DT))
    psi0 = _random_state(2 ** L, seed)

    import quantumpropagators as qp

    op_1 = qp.Operator([op.ops[0], op.ops[1].grouped()], op.coeffs)
    single = jax.jit(lambda o, v: cheby_apply(o, v, coeffs, delta, e_min, DT))

    def run_single():
        v = psi0
        for _ in range(n_steps):
            v = single(op_1, v)
        return v

    ref, first_1, steady_1 = _twice(run_single)

    op_sh = prepare_sharded_operator(op, n_dev)
    step = make_sharded_cheby_step(mesh, op_sh, delta=delta, e_min=e_min,
                                   dt=DT)
    v0 = shard_vector(mesh, psi0)
    c = replicate(mesh, coeffs)

    def run_sharded():
        v = v0
        for _ in range(n_steps):
            v = step(op_sh, v, c)
        return v

    out, first, steady = _twice(run_sharded)
    return dict(
        name=f"sharded_chain_2^{L}_x{n_dev}", dtype=str(out.dtype),
        gates=[Gate("max|sharded - one device|", _maxabs(out, ref), 1e-12)]
        + _sharding_gates(out, n_dev),
        compile_s=first - steady, step_s=steady / n_steps,
        extra=f"one device: {1e3 * steady_1 / n_steps:.3f} ms/step",
    )


def banded_bsr(rows: int, b: int, seed: int):
    """Config-5 shape: a real symmetric block-tridiagonal operator with
    dense random ``(b, b)`` blocks, as a :class:`BSROperator` (host
    arrays) and the same matrix in scipy BSR form for the oracle."""
    import scipy.sparse as sp

    from quantumpropagators.ops.operators import BSROperator

    R = rows // b
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((R, b, b), dtype=np.float32).astype(np.float64)
    D = 0.5 * (D + D.transpose(0, 2, 1))
    U = rng.standard_normal((R - 1, b, b), dtype=np.float32).astype(
        np.float64)  # block (r, r+1); block (r+1, r) is its transpose
    blocks = np.zeros((R, 3, b, b))
    blocks[1:, 0] = U.transpose(0, 2, 1)
    blocks[:, 1] = D
    blocks[:-1, 2] = U
    r = np.arange(R)
    cols = np.stack([r - 1, r, r + 1], axis=1)
    cols[0, 0], cols[-1, 2] = 0, R - 1  # zero blocks: any in-range column
    op = BSROperator(blocks=blocks, cols=cols.astype(np.int32),
                     shape=(rows, rows), block_size=b)
    keep = np.ones((R, 3), bool)
    keep[0, 0] = keep[-1, 2] = False
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    A = sp.bsr_matrix((blocks[keep], cols[keep], indptr),
                      shape=(rows, rows))
    return op, A


def phase_sharded_bsr(rows_per_dev: int = 2 ** 22, b: int = 8,
                      n_dev: int = 4, seed: int = 3) -> dict:
    """``make_sharded_bsr_cheby_step`` (banded halo exchange) vs the
    float64 host Chebyshev oracle."""
    import jax.numpy as jnp

    from quantumpropagators.ops.cheby import cheby_coeffs
    from quantumpropagators.parallel.mesh import (
        chain_mesh, replicate, shard_vector,
    )
    from quantumpropagators.parallel.sharded_bsr import (
        make_sharded_bsr_cheby_step, partition_bsr,
    )

    from __graft_entry__ import _cheby_oracle_np

    rows = rows_per_dev * n_dev
    op, A = banded_bsr(rows, b, seed)
    bound = float(abs(A).sum(axis=1).max())
    delta, e_min = 2 * bound, -bound
    coeffs = cheby_coeffs(delta, DT)
    mesh = chain_mesh(n_dev)
    pbsr = partition_bsr(op, n_dev)
    step = make_sharded_bsr_cheby_step(mesh, pbsr, delta=delta, e_min=e_min,
                                       dt=DT)
    psi0 = _random_state(rows, seed)
    v0 = shard_vector(mesh, psi0)
    c = replicate(mesh, jnp.asarray(coeffs))
    out, first, steady = _twice(lambda: step(pbsr, v0, c))
    ref = _cheby_oracle_np(lambda v: A @ v.real + 1j * (A @ v.imag),
                           np.asarray(psi0), coeffs, delta, e_min, DT)
    return dict(
        name=f"sharded_bsr_{rows}rows_b{b}_x{n_dev}", dtype=str(out.dtype),
        gates=[Gate("max|sharded BSR - f64 oracle|",
                    np.abs(np.asarray(out) - ref).max(), 1e-10),
               Gate("halo blocks < 0 (not banded)",
                    0 if pbsr.halo_blocks >= 0 else 1, 0)]
        + _sharding_gates(out, n_dev),
        compile_s=first - steady, step_s=steady,
    )


def four_gpu_phases(seed: int = 0):
    return [
        lambda: phase_sharded_chain(26, 4, 3, seed + 2),
        lambda: phase_sharded_bsr(2 ** 22, 8, 4, seed + 3),
    ]


# ---- driver ----------------------------------------------------------------


def gpu_name_and_power() -> str:
    """The card's name and power limit, read by a child process that
    does not use JAX."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return res.stdout.strip() or f"nvidia-smi failed: {res.stderr.strip()}"


def run_phases(phases, devices) -> bool:
    """Run each phase, print its diagnostics, return whether all gates
    passed.  A phase that raises counts as failed."""
    ok = True
    for phase in phases:
        try:
            res = phase()
        except Exception:
            traceback.print_exc()
            print("phase FAILED with an exception", flush=True)
            ok = False
            continue
        peaks = [_peak_bytes(d) for d in devices]
        peak_txt = ", ".join(
            "n/a" if p is None else f"{p / 2**30:.3f} GiB" for p in peaks
        )
        print(f"[{res['name']}] dtype {res['dtype']}; "
              f"compile {res['compile_s']:.3f} s; "
              f"steady {1e3 * res['step_s']:.3f} ms/step; "
              f"peak device memory {peak_txt}", flush=True)
        if res.get("extra"):
            print(f"  {res['extra']}", flush=True)
        for gate in res["gates"]:
            print(f"  {gate}", flush=True)
            ok &= gate.ok
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (REPO / "quantumpropagators" / "__init__.py").is_file():
        print(f"chip_smoke: the quantumpropagators package is not next to "
              f"{Path(__file__).name}; run it from the repository",
              file=sys.stderr)
        return 2

    import jax

    jax.config.update("jax_enable_x64", True)
    from quantumpropagators.config import use_compile_cache

    cache = use_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); refusing to run on the CPU",
              file=sys.stderr)
        return 1
    n_need = 4 if args.four else 1
    if len(devices) < n_need:
        print(f"chip_smoke: {n_need} GPUs needed, {len(devices)} found",
              file=sys.stderr)
        return 1
    devices = devices[:n_need]

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"{len(devices)} device(s) used; compile cache {cache}",
          flush=True)
    phases = four_gpu_phases(args.seed) if args.four else one_gpu_phases(
        args.seed)
    t0 = time.perf_counter()
    ok = run_phases(phases, devices)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
