"""Multi-host runtime and checkpoint/resume.

The reference is single-process (SURVEY §2.8); for multi-host runs this
module provides the equivalents it lacks:

- :func:`initialize_multihost` — ``jax.distributed.initialize`` wrapper;
  after it, the same mesh/shard_map code spans all hosts (GSPMD covers
  links within and between hosts).
- :func:`save_checkpoint` / :func:`load_checkpoint` — durable snapshots
  of a propagation: (state shards, interval index, parameter arrays),
  the minimal resumable-propagator state required by the reference's
  contract (``src/interfaces/propagator.jl:282-334``) made durable.
  Uses orbax when available, with a numpy fallback.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import jax
import numpy as np

__all__ = [
    "initialize_multihost",
    "save_checkpoint",
    "load_checkpoint",
    "propagator_checkpoint_state",
    "restore_propagator",
]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host JAX runtime.

    With no arguments, relies on the cluster environment (a cluster scheduler
    metadata / SLURM / GKE set the variables automatically).  Must run
    before any device computation on every host.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def propagator_checkpoint_state(propagator) -> dict:
    """Extract the durable state of a propagator: everything needed to
    resume (state, grid position, control parameters)."""
    params = {}
    if propagator.parameters is not None:
        for i, c in enumerate(propagator.parameters):
            params[str(i)] = np.asarray(propagator.parameters[c])
    return {
        "state": np.asarray(propagator.state),
        "t": float(propagator.t),
        "n": int(getattr(propagator, "n", 0)),
        "backward": bool(propagator.backward),
        "parameters": params,
    }


def restore_propagator(propagator, ckpt: dict):
    """Restore a propagator from :func:`propagator_checkpoint_state`
    output (the durable analogue of ``set_state!`` + ``set_t!``)."""
    import jax.numpy as jnp

    propagator.set_state(jnp.asarray(ckpt["state"]))
    propagator.set_t(float(ckpt["t"]))
    if ckpt.get("parameters") and propagator.parameters is not None:
        for i, c in enumerate(propagator.parameters):
            key = str(i)
            if key in ckpt["parameters"]:
                propagator.parameters[c] = np.asarray(ckpt["parameters"][key])
    return propagator


def save_checkpoint(path, tree: dict) -> None:
    """Save a pytree-of-arrays checkpoint (orbax if importable, else a
    numpy archive).  On multi-host runs, call from every process; only
    process 0 writes the host-replicated data."""
    path = Path(path)
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(path.absolute(), tree, force=True)
        return
    except Exception:
        pass
    if jax.process_index() == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        flat = {}

        def _flatten(prefix, obj):
            if isinstance(obj, dict):
                for k, v in obj.items():
                    _flatten(f"{prefix}/{k}" if prefix else str(k), v)
            else:
                flat[prefix] = np.asarray(obj)

        _flatten("", tree)
        np.savez(str(path) + ".npz", **flat)
        meta = {k: None for k in flat}
        with open(str(path) + ".json", "w") as f:
            json.dump(sorted(meta), f)


def load_checkpoint(path) -> dict:
    """Load a checkpoint written by :func:`save_checkpoint`."""
    path = Path(path)
    try:
        import orbax.checkpoint as ocp

        if path.exists() and path.is_dir():
            ckptr = ocp.PyTreeCheckpointer()
            return ckptr.restore(path.absolute())
    except Exception:
        pass
    data = np.load(str(path) + ".npz", allow_pickle=False)
    tree: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree
