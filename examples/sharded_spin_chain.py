"""Multi-chip propagation of a 2^L spin chain.

Runs a fully sharded complex128 Chebyshev propagation over every
visible device (the same code on several GPUs and on virtual CPU
devices):

``XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
  JAX_PLATFORMS=cpu python examples/sharded_spin_chain.py``
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from quantumpropagators import Operator
from quantumpropagators.models.lattice import transverse_field_ising
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.parallel.mesh import chain_mesh, replicate, shard_vector
from quantumpropagators.parallel.sharded_chain import (
    make_sharded_cheby_step,
    prepare_sharded_operator,
)


def main():
    n_dev = len(jax.devices())
    L = 14
    J, g, h = 1.0, 1.2, 0.3
    print(f"{n_dev} devices, L={L} (dim {2**L})")

    H_diag, H_x = transverse_field_ising(L, J=J, g=g, h=h)
    op = Operator([H_diag, H_x], np.array([1.0]))
    op_sharded = prepare_sharded_operator(op, n_dev)

    bound = J * (L - 1) + abs(h) * L + g * L
    e_min, delta = -bound, 2 * bound
    dt = 0.05
    coeffs = jnp.asarray(cheby_coeffs(delta, dt))

    mesh = chain_mesh(n_dev)
    step = make_sharded_cheby_step(mesh, op_sharded, delta=delta, e_min=e_min, dt=dt)

    rng = np.random.default_rng(0)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi = jnp.asarray(psi / np.linalg.norm(psi))
    v = shard_vector(mesh, psi)
    c = replicate(mesh, coeffs)

    for k in range(100):
        v = step(op_sharded, v, c)
    nrm = float(jnp.linalg.norm(v))
    print(f"100 steps done; ‖Ψ‖ = {nrm:.8f} (unitarity check)")


if __name__ == "__main__":
    main()
