"""Sharded application of structured chain operators under ``shard_map``.

The state ``Ψ`` (dim ``2^L``) is row-sharded into ``P = 2^p`` contiguous
blocks over the 1D device mesh — i.e. the top ``p`` bits of the basis
index select the device.  Consequences (the chain analogue of the
halo-exchange design in SURVEY §7.2):

- *Diagonal* operators (all Pauli-Z strings) act entirely locally on
  the shard: zero communication.
- A single-site operator on a LOW bit (``site ≥ p``) acts within the
  local block: zero communication.
- A single-site operator on a HIGH bit (``site < p``) mixes each block
  with exactly one *partner* block (device rank XOR a single bit):
  one ``ppermute`` pairwise exchange + an axpy.  For a spin chain, the
  per-matvec communication volume is therefore ``p`` block exchanges —
  each one pairwise transfer between two devices (all-to-all NVLink
  within a host, so any device order serves).

The Chebyshev recurrence needs **no reductions** (SURVEY §5
"long-context"), so a full sharded Chebyshev step is pure
``ppermute``+compute, ideal for XLA's async collective overlap.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from dataclasses import dataclass

from ..models.generators import Operator, ScaledOperator
from ..models.lattice import GroupedSiteSum, SiteOperatorSum
from ..ops.cheby import cheby_apply
from ..ops.operators import DiagonalOperator, _register_pytree
from .mesh import STATE_AXIS

__all__ = [
    "sharded_apply",
    "make_sharded_cheby_step",
    "operator_shard_spec",
    "ShardedSiteSum",
    "prepare_sharded_operator",
]


@dataclass(frozen=True)
class ShardedSiteSum:
    """A :class:`SiteOperatorSum` pre-split for an ``2^p``-device mesh:
    the top ``p`` (device-index) sites as per-site ``(p, 2, 2)``
    matrices (applied as pairwise ``ppermute`` block exchanges) and the
    remaining sites as a precomputed local :class:`GroupedSiteSum`
    (applied as dense matmuls on the local block).  Built host-side by
    :func:`prepare_sharded_operator`."""

    device_mats: Any  # (p, 2, 2)
    local: GroupedSiteSum
    p: int = 0
    L: int = 0
    device_active: tuple = ()

    @property
    def shape(self):
        return (2 ** self.L, 2 ** self.L)


_register_pytree(
    ShardedSiteSum,
    ("device_mats", "local"),
    ("p", "L", "device_active"),
)


def prepare_sharded_operator(op, n_devices: int, *, group_bits: int = None):
    """Recursively convert :class:`SiteOperatorSum` terms inside ``op``
    into :class:`ShardedSiteSum` for an ``n_devices`` mesh (host-side,
    once per propagation)."""
    p = int(np.log2(n_devices))
    if 2 ** p != n_devices:
        raise ValueError("device count must be a power of two")

    def _conv(term):
        if isinstance(term, SiteOperatorSum):
            active = term.active if term.active else (True,) * term.L
            local = SiteOperatorSum(
                term.site_mats[p:],
                L=term.L - p,
                active=tuple(active[p:]),
                group_bits=term.group_bits,
            ).grouped(group_bits)
            return ShardedSiteSum(
                device_mats=term.site_mats[:p],
                local=local,
                p=p,
                L=term.L,
                device_active=tuple(active[:p]),
            )
        if isinstance(term, Operator):
            o = object.__new__(Operator)
            o.ops = [_conv(t) for t in term.ops]
            o.coeffs = term.coeffs
            return o
        if isinstance(term, ScaledOperator):
            return ScaledOperator(term.coeff, _conv(term.operator))
        return term

    return _conv(op)


def _axis_size(axis_name: str) -> int:
    return jax.lax.axis_size(axis_name)


def sharded_apply(op, psi_local, *, axis_name: str = STATE_AXIS):
    """Apply ``op`` to a block-sharded state from inside ``shard_map``.

    ``psi_local`` is this device's contiguous block of the state.
    Supported operator terms: :class:`DiagonalOperator` (with its
    ``diag`` sharded like the state), :class:`SiteOperatorSum`
    (replicated ``(L,2,2)`` site matrices), and
    :class:`Operator`/:class:`ScaledOperator` combinations thereof.
    """
    if isinstance(op, DiagonalOperator):
        return op.diag * psi_local  # diag is pre-sharded to the local block
    if isinstance(op, ShardedSiteSum):
        out = op.local.apply(psi_local)
        return _device_bit_terms(
            op.device_mats, op.device_active, op.p, psi_local, out, axis_name
        )
    if isinstance(op, SiteOperatorSum):
        return _sharded_site_sum(op, psi_local, axis_name)
    if isinstance(op, ScaledOperator):
        return op.coeff * sharded_apply(op.operator, psi_local, axis_name=axis_name)
    if isinstance(op, Operator):
        off = op.drift_offset
        out = None
        for i, term in enumerate(op.ops):
            y = sharded_apply(term, psi_local, axis_name=axis_name)
            if i >= off:
                y = op.coeffs[i - off] * y
            out = y if out is None else out + y
        return out
    raise TypeError(
        f"sharded_apply does not support operator type {type(op)}; "
        "use DiagonalOperator / SiteOperatorSum / Operator of those"
    )


def _device_bit_terms(device_mats, device_active, p, psi_local, out, axis_name):
    """Add the device-index-bit site terms: one pairwise ``ppermute``
    block exchange per active device bit."""
    n_dev = _axis_size(axis_name)
    rank = jax.lax.axis_index(axis_name)
    active = device_active if device_active else (True,) * p
    for b in range(p):
        if not active[b]:
            continue
        mask = 1 << (p - 1 - b)
        perm = [(s, s ^ mask) for s in range(n_dev)]
        recv = jax.lax.ppermute(psi_local, axis_name, perm)
        v = (rank >> (p - 1 - b)) & 1  # this device's value of bit b
        M = device_mats[b].astype(psi_local.dtype)
        diag_c = jnp.where(v == 0, M[0, 0], M[1, 1])
        off_c = jnp.where(v == 0, M[0, 1], M[1, 0])
        out = out + diag_c * psi_local + off_c * recv
    return out


def _sharded_site_sum(op: SiteOperatorSum, psi_local, axis_name: str):
    n_dev = _axis_size(axis_name)
    p = int(np.log2(n_dev))
    assert 2 ** p == n_dev, "device count must be a power of two"
    L = op.L
    L_local = L - p
    active = op.active if op.active else (True,) * L

    # Local sites (low bits): a SiteOperatorSum on the local block.
    local_op = SiteOperatorSum(
        op.site_mats[p:], L=L_local, active=tuple(active[p:])
    )
    out = local_op.apply(psi_local)
    return _device_bit_terms(
        op.site_mats[:p], tuple(active[:p]), p, psi_local, out, axis_name
    )


def operator_shard_spec(op):
    """PartitionSpec pytree for ``op`` as a ``shard_map`` input:
    diagonals sharded like the state, everything else replicated."""

    def leaf_spec(path_leaf):
        return P()

    # Build the spec with the same pytree structure
    def _spec(term):
        if isinstance(term, DiagonalOperator):
            return DiagonalOperator(P(STATE_AXIS))
        if isinstance(term, ShardedSiteSum):
            return ShardedSiteSum(
                device_mats=P(),
                local=GroupedSiteSum(
                    group_mats=tuple(P() for _ in term.local.group_mats),
                    dims=term.local.dims,
                ),
                p=term.p,
                L=term.L,
                device_active=term.device_active,
            )
        if isinstance(term, SiteOperatorSum):
            return SiteOperatorSum(
                P(), L=term.L, active=term.active, group_bits=term.group_bits
            )
        if isinstance(term, ScaledOperator):
            return ScaledOperator(P(), _spec(term.operator))
        if isinstance(term, Operator):
            inner = [_spec(t) for t in term.ops]
            o = object.__new__(Operator)
            o.ops = inner
            o.coeffs = P()
            return o
        raise TypeError(f"unsupported sharded operator type {type(term)}")

    return _spec(op)


def make_sharded_cheby_step(
    mesh: Mesh,
    op_example,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
):
    """Build a jitted, fully sharded Chebyshev step.

    Returns ``step(op, psi, coeffs) -> psi`` where ``psi`` is sharded
    over the mesh state axis and ``op`` is an operator pytree laid out
    per :func:`operator_shard_spec`.  The whole polynomial recurrence —
    ``n_coeffs`` sharded matvecs with their ``ppermute`` exchanges —
    compiles to a single XLA executable with no host round trips.
    """
    op_spec = operator_shard_spec(op_example)

    def _step(op, psi_local, coeffs):
        return cheby_apply(
            op,
            psi_local,
            coeffs,
            delta,
            e_min,
            dt,
            forward=forward,
            apply_fn=partial(sharded_apply, axis_name=STATE_AXIS),
        )

    sharded = jax.shard_map(
        _step,
        mesh=mesh,
        in_specs=(op_spec, P(STATE_AXIS), P()),
        out_specs=P(STATE_AXIS),
    )
    return jax.jit(sharded)
