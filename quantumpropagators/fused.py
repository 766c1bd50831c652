"""Fully-fused device-side propagation.

The generic :func:`~quantumpropagators.propagate` driver steps the time
grid from the host (needed for arbitrary callbacks/observables).  For
production workloads — long time grids, optimal-control inner loops,
benchmarking — the whole propagation should be ONE compiled XLA
computation: a ``lax.scan`` over the per-interval coefficient table,
with observables evaluated in-scan into a preallocated output array
(the device-side realization of the reference's
``propagate``+``Storage`` pipeline, ``src/propagate.jl:322-337``).

Zero retracing across control updates: the coefficient table is a
traced array argument (SURVEY §7.1's coefficient-table design), so an
optimal-control loop calls the same executable with new tables.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .models.generators import Generator, Operator, coeff_table
from .ops.cheby import ChebyWorkspace, cheby_apply

__all__ = ["cheby_propagate_fused", "make_fused_cheby_propagator"]


@partial(
    jax.jit,
    static_argnames=("forward", "observable_fn", "store_states", "apply_fn"),
)
def _fused_scan(
    ops_operator,
    coeffs_table,
    psi0,
    cheby_coeffs,
    delta,
    e_min,
    dt,
    forward,
    observable_fn,
    store_states,
    apply_fn,
):
    def step(psi, table_row):
        op = Operator(ops_operator.ops, table_row)
        psi = cheby_apply(
            op,
            psi,
            cheby_coeffs,
            delta,
            e_min,
            dt,
            forward=forward,
            apply_fn=apply_fn,
        )
        if observable_fn is not None:
            out = observable_fn(psi)
        elif store_states:
            out = psi
        else:
            out = None
        return psi, out

    return jax.lax.scan(step, psi0, coeffs_table)


def cheby_propagate_fused(
    psi0,
    generator,
    tlist,
    *,
    workspace: Optional[ChebyWorkspace] = None,
    coeffs_table=None,
    observable_fn: Optional[Callable] = None,
    store_states: bool = False,
    backward: bool = False,
    apply_fn=None,
    **cheby_kwargs,
):
    """Propagate ``psi0`` over all of ``tlist`` in one compiled scan.

    ``observable_fn(psi) -> pytree`` is evaluated after every step
    (in-scan); with ``store_states=True`` the full trajectory
    ``(nt-1, N)`` is returned instead.  Returns ``(psi_final, outputs)``
    where ``outputs`` is stacked over steps (or ``None``).

    ``workspace`` defaults to building a :class:`ChebyPropagator`-style
    workspace via spectral-range estimation; pass one explicitly to
    skip that (e.g. with analytic bounds).
    """
    tlist = np.asarray(tlist, dtype=np.float64)
    if isinstance(generator, tuple):
        from .models.generators import hamiltonian

        generator = hamiltonian(*generator, check=False)
    if workspace is None:
        from .propagators.cheby import ChebyPropagator

        prop = ChebyPropagator(psi0, generator, tlist, **cheby_kwargs)
        workspace = prop.wrk
    if coeffs_table is None:
        coeffs_table = coeff_table(generator, tlist)
    if backward:
        coeffs_table = coeffs_table[::-1]
    if isinstance(generator, Generator):
        ops = generator.ops
    elif isinstance(generator, Operator):
        ops = generator.ops
        coeffs_table = jnp.broadcast_to(
            jnp.asarray(generator.coeffs)[None, :],
            (len(tlist) - 1, len(generator.coeffs)),
        )
    else:
        ops = [generator]
        coeffs_table = jnp.zeros((len(tlist) - 1, 0))
    # keep the scan dtype-stable: tables/coefficients in the state's
    # real dtype (an f64 control table must not promote a c64 state)
    rdtype = jnp.finfo(psi0.dtype).dtype
    coeffs_table = jnp.asarray(coeffs_table, dtype=rdtype)
    cheby_coeff_arr = jnp.asarray(workspace.coeffs, dtype=rdtype)
    dt = workspace.dt if not backward else -workspace.dt
    op_holder = Operator(list(ops), jnp.zeros((coeffs_table.shape[1],)))
    psi_final, outputs = _fused_scan(
        op_holder,
        coeffs_table,
        psi0,
        cheby_coeff_arr,
        workspace.delta,
        workspace.e_min,
        dt,
        not backward,
        observable_fn,
        store_states,
        apply_fn,
    )
    return psi_final, outputs


def make_fused_cheby_propagator(
    psi0,
    generator,
    tlist,
    *,
    observable_fn: Optional[Callable] = None,
    store_states: bool = False,
    **cheby_kwargs,
):
    """Build a reusable fused propagation function for optimal control:
    ``fn(psi0, coeffs_table) -> (psi_final, outputs)`` hitting one
    compiled executable for every control update."""
    tlist = np.asarray(tlist, dtype=np.float64)
    if isinstance(generator, tuple):
        from .models.generators import hamiltonian

        generator = hamiltonian(*generator, check=False)
    from .propagators.cheby import ChebyPropagator

    prop = ChebyPropagator(psi0, generator, tlist, **cheby_kwargs)
    ws = prop.wrk
    if isinstance(generator, Generator):
        ops = list(generator.ops)
    elif isinstance(generator, Operator):
        ops = list(generator.ops)
    else:
        ops = [generator]

    def fn(psi0, coeffs_table):
        op_holder = Operator(ops, jnp.zeros((coeffs_table.shape[1],)))
        return _fused_scan(
            op_holder,
            coeffs_table,
            psi0,
            ws.coeffs,
            ws.delta,
            ws.e_min,
            ws.dt,
            True,
            observable_fn,
            store_states,
            None,
        )

    return fn
