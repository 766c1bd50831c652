"""Distributed block-sparse (BSR) SpMV over the device mesh.

The BSR analogue of :mod:`.sharded_csr` (SURVEY §7.4.2, BASELINE
config 5 "BSR block-partitioned ... with halo overlap"): the state is
sharded by BLOCK-rows, each device owns its slab of dense ``(b, b)``
blocks in blocked-ELL layout, and applies it with one batched
``dot_general`` over contiguous block gathers — never a scalar
gather.

Communication strategies:

- :func:`make_banded_bsr_apply` — when every nonzero block is within
  ``wb`` block-rows of the local slab (lattice/kron operators after
  ordering), two ``ppermute`` edge exchanges of ``wb·b`` state entries
  per matvec, independent of ``N`` — weak-scaling.
- :func:`make_allgather_bsr_apply` — arbitrary block sparsity; one
  ``all_gather`` of the state per matvec.

Block-column ids are pre-remapped on the host at partition time so the
device kernel is static-shaped; slabs are padded to the max per-device
block-degree so ``shard_map`` sees uniform blocks.  Reference
parallelism contrast: the reference is single-process Julia
(``src/cheby.jl:146-148`` generic ``mul!``); this module is the
distribution layer it does not have.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.operators import BSROperator, bsr_from_scipy, _register_pytree
from .mesh import STATE_AXIS

__all__ = [
    "PartitionedBSR",
    "partition_bsr",
    "make_banded_bsr_apply",
    "make_allgather_bsr_apply",
    "banded_bsr_apply",
    "allgather_bsr_apply",
    "make_sharded_bsr_cheby_step",
    "DistributedBSR",
    "PartitionedBSRdd",
    "partition_bsr_dd",
    "banded_bsr_apply_dd",
    "allgather_bsr_apply_dd",
    "make_sharded_bsr_cheby_step_dd",
]


@dataclass(frozen=True)
class PartitionedBSR:
    """Block-row-partitioned blocked-ELL slabs, stacked over devices.

    ``blocks``: ``(P, R_local, k, b, b)``; ``cols``: ``(P, R_local, k)``
    int32.  For ``halo_blocks >= 0`` (banded mode) cols are
    extended-local block ids in ``[0, R_local + 2·halo_blocks)``; for
    ``halo_blocks < 0`` (all-gather mode) cols are GLOBAL block ids.
    """

    blocks: Any
    cols: Any
    halo_blocks: int = 0
    n_block_rows_local: int = 0
    n_devices: int = 0
    block_size: int = 0
    shape: tuple = ()


_register_pytree(
    PartitionedBSR,
    ("blocks", "cols"),
    ("halo_blocks", "n_block_rows_local", "n_devices", "block_size", "shape"),
)


def _partition_cols(nz, cols, n_devices, mode):
    """Shared block-row partition layout: from the nonzero mask ``nz``
    ``(R, k)`` and block-column ids ``cols``, compute the per-device
    remapped column ids and the halo width.

    Returns ``(slab_cols int32 (P, Rl, k), halo, Rl)`` — ``halo >= 0``
    means banded mode with extended-local ids in
    ``[0, Rl + 2·halo)``; ``halo == -1`` means all-gather mode with
    global ids."""
    R, k = cols.shape
    if R % n_devices:
        raise ValueError(
            f"{R} block-rows not divisible by {n_devices} devices"
        )
    Rl = R // n_devices
    lo = (np.arange(R) // Rl)[:, None] * Rl
    wb = int(
        max(
            (np.maximum(lo - cols, 0) * nz).max(initial=0),
            (np.maximum(cols - (lo + Rl - 1), 0) * nz).max(initial=0),
        )
    )
    banded_ok = wb <= Rl
    if mode == "banded" and not banded_ok:
        raise ValueError(
            f"block halo {wb} exceeds slab size {Rl}; use mode="
            "'allgather' or fewer devices"
        )
    use_banded = mode == "banded" or (mode == "auto" and banded_ok)
    slab_cols = cols.reshape(n_devices, Rl, k).astype(np.int64)
    if use_banded:
        for d in range(n_devices):
            ext = slab_cols[d] - (d * Rl - wb)
            # padding (zero) blocks may carry col 0 anywhere in the
            # grid -- point them at a guaranteed-local block instead
            ext = np.where(nz.reshape(n_devices, Rl, k)[d], ext, wb)
            slab_cols[d] = ext
        halo = wb
    else:
        halo = -1
    return slab_cols.astype(np.int32), halo, Rl


def partition_bsr(
    A, n_devices: int, block_size: int = None, *, mode: str = "auto"
) -> PartitionedBSR:
    """Partition a matrix into per-device BSR block-row slabs.

    ``mode``: ``'banded'`` (halo exchange; requires all nonzero blocks
    within one slab of the diagonal), ``'allgather'``, or ``'auto'``
    (banded when the measured block-halo fits, else all-gather).
    """
    if isinstance(A, BSROperator):
        op = A
    else:
        op = bsr_from_scipy(A, block_size=block_size)
    blocks = np.asarray(op.blocks)
    cols = np.asarray(op.cols)
    R, k, b, _ = blocks.shape
    if op.shape[0] != R * b:
        raise ValueError(
            "partition_bsr requires a block-aligned operator "
            f"(logical dim {op.shape[0]} != {R}x{b}); pad the matrix "
            "to a multiple of the block size first"
        )
    nz = np.abs(blocks).max(axis=(2, 3)) > 0  # (R, k) real entries
    slab_cols, halo, Rl = _partition_cols(nz, cols, n_devices, mode)
    slab_blocks = blocks.reshape(n_devices, Rl, k, b, b)
    return PartitionedBSR(
        blocks=jnp.asarray(slab_blocks),
        cols=jnp.asarray(slab_cols),
        halo_blocks=halo,
        n_block_rows_local=Rl,
        n_devices=n_devices,
        block_size=b,
        shape=op.shape,
    )


def _bsr_slab_matvec(blocks, cols, x_blocks):
    """blocks (Rl, k, b, b) · x_blocks[cols] -> (Rl, b)."""
    xg = x_blocks[cols]  # (Rl, k, b)
    return jax.lax.dot_general(
        blocks,
        xg,
        dimension_numbers=(((1, 3), (1, 2)), ((0,), (0,))),
        preferred_element_type=jnp.result_type(blocks.dtype, x_blocks.dtype),
    )


def banded_bsr_apply(pbsr: PartitionedBSR, psi_local, *, axis_name=STATE_AXIS):
    """Block SpMV from inside ``shard_map`` with nearest-neighbor halo
    exchange: two edge ``ppermute``s of ``halo_blocks·b`` entries."""
    b = pbsr.block_size
    Rl = pbsr.n_block_rows_local
    wb = pbsr.halo_blocks
    n_dev = pbsr.n_devices
    x = psi_local.reshape(Rl, b)
    if wb > 0:
        w = wb * b
        right_perm = [(s, (s + 1) % n_dev) for s in range(n_dev)]
        left_perm = [(s, (s - 1) % n_dev) for s in range(n_dev)]
        left_halo = jax.lax.ppermute(psi_local[-w:], axis_name, right_perm)
        right_halo = jax.lax.ppermute(psi_local[:w], axis_name, left_perm)
        x = jnp.concatenate(
            [left_halo.reshape(wb, b), x, right_halo.reshape(wb, b)]
        )
    y = _bsr_slab_matvec(pbsr.blocks, pbsr.cols, x)
    return y.reshape(Rl * b)


def allgather_bsr_apply(pbsr: PartitionedBSR, psi_local, *, axis_name=STATE_AXIS):
    """Block SpMV from inside ``shard_map`` over the full gathered
    state (arbitrary block sparsity)."""
    b = pbsr.block_size
    psi_full = jax.lax.all_gather(psi_local, axis_name, tiled=True)
    x = psi_full.reshape(-1, b)
    y = _bsr_slab_matvec(pbsr.blocks, pbsr.cols, x)
    return y.reshape(pbsr.n_block_rows_local * b)


def _make_apply(mesh: Mesh, pbsr: PartitionedBSR, inner):
    meta = dict(
        halo_blocks=pbsr.halo_blocks,
        n_block_rows_local=pbsr.n_block_rows_local,
        n_devices=pbsr.n_devices,
        block_size=pbsr.block_size,
        shape=pbsr.shape,
    )
    spec = PartitionedBSR(blocks=P(STATE_AXIS), cols=P(STATE_AXIS), **meta)

    def _fn(pb, v):
        pb_local = PartitionedBSR(
            blocks=pb.blocks[0], cols=pb.cols[0], **meta
        )
        return inner(pb_local, v)

    return jax.jit(
        jax.shard_map(
            _fn, mesh=mesh, in_specs=(spec, P(STATE_AXIS)),
            out_specs=P(STATE_AXIS),
        )
    )


def make_banded_bsr_apply(mesh: Mesh, pbsr: PartitionedBSR):
    """Jitted distributed block SpMV ``(pbsr, psi) -> H psi`` (halo)."""
    if pbsr.halo_blocks < 0:
        raise ValueError("pbsr was partitioned in all-gather mode")
    return _make_apply(mesh, pbsr, banded_bsr_apply)


def make_allgather_bsr_apply(mesh: Mesh, pbsr: PartitionedBSR):
    """Jitted distributed block SpMV (all-gather fallback)."""
    if pbsr.halo_blocks >= 0:
        raise ValueError("pbsr was partitioned in banded mode")
    return _make_apply(mesh, pbsr, allgather_bsr_apply)


def _inner_for(pbsr: PartitionedBSR):
    return banded_bsr_apply if pbsr.halo_blocks >= 0 else allgather_bsr_apply


def make_sharded_bsr_cheby_step(
    mesh: Mesh,
    pbsr: PartitionedBSR,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
):
    """Full Chebyshev step ``exp(-i H dt)`` over a block-partitioned BSR
    operator, entirely under ``shard_map`` (BASELINE config 5 composed
    with propagation, not just raw SpMV).

    Returns ``step(pbsr, psi, coeffs) -> psi`` where ``psi`` is the
    global state sharded ``P(x)`` and ``coeffs`` the replicated
    Chebyshev coefficients.  Each polynomial order costs one distributed
    block SpMV (two edge ``ppermute``s in banded mode); the recurrence
    itself needs no reductions (SURVEY §5)."""
    from ..ops.cheby import cheby_apply

    inner = _inner_for(pbsr)
    meta = dict(
        halo_blocks=pbsr.halo_blocks,
        n_block_rows_local=pbsr.n_block_rows_local,
        n_devices=pbsr.n_devices,
        block_size=pbsr.block_size,
        shape=pbsr.shape,
    )
    spec = PartitionedBSR(blocks=P(STATE_AXIS), cols=P(STATE_AXIS), **meta)

    def _step(pb, psi_local, coeffs):
        pb_local = PartitionedBSR(
            blocks=pb.blocks[0], cols=pb.cols[0], **meta
        )
        return cheby_apply(
            pb_local,
            psi_local,
            coeffs,
            delta,
            e_min,
            dt,
            forward=forward,
            apply_fn=lambda o, v: inner(o, v),
        )

    return jax.jit(
        jax.shard_map(
            _step,
            mesh=mesh,
            in_specs=(spec, P(STATE_AXIS), P()),
            out_specs=P(STATE_AXIS),
        )
    )


@dataclass(frozen=True)
class DistributedBSR:
    """Operator-protocol wrapper around a partitioned BSR matrix.

    Implements the framework's ``apply``/``shape`` operator contract
    (the analogue of the reference's duck-typed ``mul!`` operand,
    ``src/cheby.jl:146-148``) with a distributed ``shard_map`` SpMV, so
    *any* kernel — Newton's restarted Arnoldi, ``specrange``, ``expv``
    — composes with BSR block partitioning unchanged: matvecs are block
    halo exchanges, inner products GSPMD ``psum`` reductions.  A
    registered pytree (``pbsr`` data, ``mesh`` static), so it traces
    through the jitted kernels like any other operator."""

    mesh: Mesh
    pbsr: PartitionedBSR

    @property
    def shape(self):
        return self.pbsr.shape

    def apply(self, psi):
        pbsr = self.pbsr
        inner = _inner_for(pbsr)
        meta = dict(
            halo_blocks=pbsr.halo_blocks,
            n_block_rows_local=pbsr.n_block_rows_local,
            n_devices=pbsr.n_devices,
            block_size=pbsr.block_size,
            shape=pbsr.shape,
        )
        spec = PartitionedBSR(
            blocks=P(STATE_AXIS), cols=P(STATE_AXIS), **meta
        )

        def _fn(pb, v):
            pb_local = PartitionedBSR(
                blocks=pb.blocks[0], cols=pb.cols[0], **meta
            )
            return inner(pb_local, v)

        return jax.shard_map(
            _fn,
            mesh=self.mesh,
            in_specs=(spec, P(STATE_AXIS)),
            out_specs=P(STATE_AXIS),
        )(pbsr, psi)


_register_pytree(DistributedBSR, ("pbsr",), ("mesh",))


# ---- double-float (df64) distributed BSR: reference accuracy --------
#
# The multi-chip realization of BASELINE config 5 at the accuracy the
# reference demands of every config (1e-10, test/test_cheby.jl:8): the
# banded halo exchange carries BOTH dd planes of the state (hi + lo —
# the halo is 2·wb·b entries per side regardless of shard size, so the
# extra lo plane costs nothing at scale), and the shard-local block
# apply is the compensated df64 kernel of ops/df64_sparse.py.  This is
# the regime where the >=80% weak-scaling target is reachable: exchange
# volume is O(wb·b) per matvec vs O(N_local) compute.


@dataclass(frozen=True)
class PartitionedBSRdd:
    """Block-row-partitioned df64 blocked-ELL slabs over devices.

    ``blocks_hi/blocks_lo``: ``(P, R_local, k, b, b)`` f32 planes of
    the f64 operator entries; ``cols``: ``(P, R_local, k)`` int32 —
    extended-local block ids (banded, ``halo_blocks >= 0``) or global
    ids (all-gather, ``halo_blocks < 0``)."""

    blocks_hi: Any
    blocks_lo: Any
    cols: Any
    halo_blocks: int = 0
    n_block_rows_local: int = 0
    n_devices: int = 0
    block_size: int = 0
    shape: tuple = ()


_register_pytree(
    PartitionedBSRdd,
    ("blocks_hi", "blocks_lo", "cols"),
    ("halo_blocks", "n_block_rows_local", "n_devices", "block_size", "shape"),
)


def _pbdd_meta(pb: PartitionedBSRdd) -> dict:
    return dict(
        halo_blocks=pb.halo_blocks,
        n_block_rows_local=pb.n_block_rows_local,
        n_devices=pb.n_devices,
        block_size=pb.block_size,
        shape=pb.shape,
    )


def partition_bsr_dd(
    A, n_devices: int, block_size: int = None, *, mode: str = "auto"
) -> PartitionedBSRdd:
    """Partition a real-f64 scipy matrix (or a prebuilt
    :class:`~..ops.df64_sparse.BSRdd`) into per-device df64 BSR
    slabs — full f64 operator precision preserved across the (hi, lo)
    block planes."""
    from ..ops.df64_sparse import BSRdd, bsr_dd_from_scipy

    if isinstance(A, BSRdd):
        op = A
    else:
        op = bsr_dd_from_scipy(A, block_size=block_size)
    bh = np.asarray(op.blocks_hi)
    bl = np.asarray(op.blocks_lo)
    cols = np.asarray(op.cols)
    R, k, b, _ = bh.shape
    nz = (np.abs(bh) + np.abs(bl)).max(axis=(2, 3)) > 0
    slab_cols, halo, Rl = _partition_cols(nz, cols, n_devices, mode)
    return PartitionedBSRdd(
        blocks_hi=jnp.asarray(bh.reshape(n_devices, Rl, k, b, b)),
        blocks_lo=jnp.asarray(bl.reshape(n_devices, Rl, k, b, b)),
        cols=jnp.asarray(slab_cols),
        halo_blocks=halo,
        n_block_rows_local=Rl,
        n_devices=n_devices,
        block_size=b,
        shape=op.shape,
    )


def _halo_extend(v_local, w, n_dev, axis_name):
    """Edge halo exchange of ``w`` entries per side: returns the
    extended-local vector ``[left_halo | v_local | right_halo]``."""
    right_perm = [(s, (s + 1) % n_dev) for s in range(n_dev)]
    left_perm = [(s, (s - 1) % n_dev) for s in range(n_dev)]
    left_halo = jax.lax.ppermute(v_local[-w:], axis_name, right_perm)
    right_halo = jax.lax.ppermute(v_local[:w], axis_name, left_perm)
    return jnp.concatenate([left_halo, v_local, right_halo])


def banded_bsr_apply_dd(pb: PartitionedBSRdd, x, *, axis_name=STATE_AXIS):
    """df64 block SpMV from inside ``shard_map``: nearest-neighbor halo
    exchange of BOTH dd state planes (``2·wb·b`` entries per plane per
    matvec — shard-size-independent), then the compensated shard-local
    blocked-ELL apply (:func:`~..ops.df64_sparse.bsr_blocks_apply_dd`).

    ``x`` is a :class:`~..ops.df64.DD` of the local ``(Rl·b,)`` planes.
    """
    from ..ops.df64 import DD
    from ..ops.df64_sparse import bsr_blocks_apply_dd

    b = pb.block_size
    Rl = pb.n_block_rows_local
    wb = pb.halo_blocks
    xh, xl = x.hi, x.lo
    if wb > 0:
        w = wb * b
        xh = _halo_extend(xh, w, pb.n_devices, axis_name)
        xl = _halo_extend(xl, w, pb.n_devices, axis_name)
    return bsr_blocks_apply_dd(
        pb.blocks_hi, pb.blocks_lo, pb.cols,
        xh.reshape(-1, b), xl.reshape(-1, b),
    )


def allgather_bsr_apply_dd(pb: PartitionedBSRdd, x, *, axis_name=STATE_AXIS):
    """df64 block SpMV over the fully gathered dd state (arbitrary
    block sparsity fallback)."""
    from ..ops.df64_sparse import bsr_blocks_apply_dd

    b = pb.block_size
    xh = jax.lax.all_gather(x.hi, axis_name, tiled=True)
    xl = jax.lax.all_gather(x.lo, axis_name, tiled=True)
    return bsr_blocks_apply_dd(
        pb.blocks_hi, pb.blocks_lo, pb.cols,
        xh.reshape(-1, b), xl.reshape(-1, b),
    )


def make_sharded_bsr_cheby_step_dd(
    mesh: Mesh,
    pbdd: PartitionedBSRdd,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
):
    """Reference-accuracy multi-chip BSR Chebyshev step: the full df64
    recurrence ``exp(-i H dt)`` under ``shard_map`` over a
    block-partitioned dd operator — BASELINE config 5 AT the accuracy
    BASELINE requires of every config ("matching Julia reference states
    to 1e-10"; reference tolerance ``test/test_cheby.jl:8``).

    Returns ``step(pbdd, state4, coeffs_h, coeffs_l) -> state4`` where
    ``state4 = (re_hi, re_lo, im_hi, im_lo)`` are global ``(N,)`` f32
    planes sharded ``P(x)`` and ``coeffs_h/coeffs_l`` the replicated
    dd-split Chebyshev coefficients.  Each polynomial order costs one
    banded halo exchange (``2·wb·b`` entries × 2 dd planes × 2 sides,
    shard-size-independent) — the weak-scaling regime, at reference
    accuracy."""
    from ..ops.df64 import CDD, DD
    from ..ops.df64_sparse import cheby_dd_recurrence

    inner = (
        banded_bsr_apply_dd if pbdd.halo_blocks >= 0
        else allgather_bsr_apply_dd
    )
    meta = _pbdd_meta(pbdd)
    spec = PartitionedBSRdd(
        blocks_hi=P(STATE_AXIS), blocks_lo=P(STATE_AXIS),
        cols=P(STATE_AXIS), **meta,
    )

    def _step(pb, rh, rl, ih, il, c_h, c_l):
        pb_local = PartitionedBSRdd(
            blocks_hi=pb.blocks_hi[0], blocks_lo=pb.blocks_lo[0],
            cols=pb.cols[0], **meta,
        )
        psi = CDD(DD(rh, rl), DD(ih, il))
        out = cheby_dd_recurrence(
            lambda v: CDD(
                inner(pb_local, v.re), inner(pb_local, v.im)
            ),
            psi, c_h, c_l, delta, e_min, dt, forward,
        )
        return out.re.hi, out.re.lo, out.im.hi, out.im.lo

    sharded = jax.shard_map(
        _step,
        mesh=mesh,
        in_specs=(spec,) + (P(STATE_AXIS),) * 4 + (P(), P()),
        out_specs=(P(STATE_AXIS),) * 4,
    )

    @jax.jit
    def step(pbdd, state4, coeffs_h, coeffs_l):
        rh, rl, ih, il = state4
        return sharded(pbdd, rh, rl, ih, il, coeffs_h, coeffs_l)

    return step
