"""Device mesh helpers.

The distribution model (SURVEY §7.2): a 1D mesh over all devices, the state vector row-sharded over the mesh axis ``"x"``, and
operators either replicated (small structural data) or sharded to match
the state (diagonals, CSR row blocks).  GSPMD spans the links within and
between hosts transparently, so multi-host runs reuse the exact same code after
``jax.distributed.initialize``.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["chain_mesh", "shard_vector", "replicate", "STATE_AXIS"]

STATE_AXIS = "x"


def chain_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1D mesh over ``n_devices`` (default: all visible devices) with
    the state-sharding axis :data:`STATE_AXIS`."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (STATE_AXIS,))


def shard_vector(mesh: Mesh, x, axis: int = 0):
    """Place ``x`` sharded along ``axis`` over the mesh's state axis."""
    ndim = np.ndim(x)
    spec = [None] * ndim
    spec[axis] = STATE_AXIS
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def replicate(mesh: Mesh, x):
    """Place ``x`` fully replicated on every device of the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))
